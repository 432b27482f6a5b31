"""The MNIST MLP as an `nn.Module` (port of `pytorch_ddp_mnist_tpu/models/mlp.py`).

    Linear(784, 128) -> ReLU -> Dropout(0.2) -> Linear(128, 128) -> ReLU
        -> Linear(128, 10, bias=False)

Weights keep the JAX package's (fan_in, fan_out) layout, so the forward
pass (`mlp_apply`) is `x @ w` and a params tree `{"fc1": {"w", "b"}, "fc2": {"w", "b"},
"fc3": {"w"}}` carries over between the packages unchanged. Only the
reference `.pt` state_dict (train/checkpoint.py) uses torch Linear's
(out, in) layout.

Init follows torch.nn.Linear: weight and bias from U(-1/sqrt(fan_in),
+1/sqrt(fan_in)). `MLP.from_seed(seed)` (what the CLI and the bench use)
draws them as the JAX package's `init_mlp(jax.random.key(seed))` does, bit
for bit (`init_params`); `MLP(generator)` draws them from a
`torch.Generator` instead, other weights for the same seed.
`from_jax_params` loads a JAX params tree. `dims` widens the two hidden
layers (the zoo's scaled `mlp`, models/zoo.py); the default is the
reference model.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

# (in_features, hidden, hidden, classes) — the reference MLP.
MLP_DIMS = (784, 128, 128, 10)
DROPOUT_RATE = 0.2

Params = Dict[str, Dict[str, torch.Tensor]]


class Dense(nn.Module):
    """One layer's parameters: w stored (fan_in, fan_out) and an optional
    bias. `mlp_apply` computes x @ w (+ b)."""

    def __init__(self, fan_in: int, fan_out: int, *, bias: bool,
                 generator: torch.Generator | None = None):
        super().__init__()
        bound = 1.0 / math.sqrt(fan_in)
        self.w = nn.Parameter(
            torch.empty(fan_in, fan_out).uniform_(-bound, bound,
                                                  generator=generator))
        self.b = (nn.Parameter(
            torch.empty(fan_out).uniform_(-bound, bound, generator=generator))
                  if bias else None)


class MLP(nn.Module):
    """The reference 784-128-128-10 MLP (or its widths `dims`): dropout 0.2
    after fc1 only, no bias on fc3. Parameters are float32 on CPU until
    moved with `.to()`."""

    def __init__(self, generator: torch.Generator | None = None,
                 dims=MLP_DIMS):
        super().__init__()
        d0, d1, d2, d3 = dims
        self.dims = tuple(dims)
        self.fc1 = Dense(d0, d1, bias=True, generator=generator)
        self.fc2 = Dense(d1, d2, bias=True, generator=generator)
        self.fc3 = Dense(d2, d3, bias=False, generator=generator)

    @classmethod
    def from_seed(cls, seed: int, dims=MLP_DIMS) -> "MLP":
        """The model `init_mlp(jax.random.key(seed), dims=dims)` gives in
        the JAX package, bit for bit (see `init_params`)."""
        model = cls(dims=dims)
        params = model.params()
        with torch.no_grad():
            for name, layer in init_params(seed, dims).items():
                for k, t in layer.items():
                    params[name][k].copy_(t)
        return model

    def forward(self, x: torch.Tensor, train: bool = False,
                dropout_mask: torch.Tensor | None = None,
                keep: torch.Tensor | None = None) -> torch.Tensor:
        """(B, 784) -> (B, 10) logits: `mlp_apply` on this module's
        parameters (which see for `train`, `dropout_mask` and `keep`)."""
        return mlp_apply(self.params(), x, train=train,
                         dropout_mask=dropout_mask, keep=keep)

    def params(self) -> Params:
        """The JAX-layout params tree; its tensors ARE this module's
        parameters (no copy)."""
        out = {}
        for name in ("fc1", "fc2", "fc3"):
            layer = getattr(self, name)
            out[name] = {"w": layer.w}
            if layer.b is not None:
                out[name]["b"] = layer.b
        return out


def mlp_apply(params: Params, x: torch.Tensor, *, train: bool = False,
              dropout_mask: torch.Tensor | None = None,
              keep: torch.Tensor | None = None) -> torch.Tensor:
    """Forward pass of a params tree (port of the JAX package's
    `mlp_apply`): (B, 784) -> (B, 10) logits. The compute dtype follows x
    (float32 or bfloat16); the params are cast to it.

    In train mode exactly one of two dropout forms is given, each as the
    JAX package writes it, so that the two round alike in bf16:
      * `keep`, the (B, 128) bool draw of the keyed form (JAX's
        `dropout_key`): kept units are `h / keep_rate` in x's dtype,
        `where(keep, h / dt(0.8), 0)`. In bf16, dt(0.8) is 0.80078125, so
        this is not `h * 1.25`;
      * `dropout_mask`, a streamed {0, 1} mask: `h * (mask * dt(1.25))`
        (1/0.8 = 1.25 is exact in both dtypes)."""
    dt = x.dtype
    fc1, fc2, fc3 = params["fc1"], params["fc2"], params["fc3"]
    h = torch.relu(x @ fc1["w"].to(dt) + fc1["b"].to(dt))
    if train:
        if (keep is None) == (dropout_mask is None):
            raise ValueError("train=True requires exactly one of "
                             "dropout_mask / keep")
        rate = 1.0 - DROPOUT_RATE
        # the constants are made on the device by fill kernels (no
        # host-to-device copy, so a captured step can make them), with the
        # bits of torch.tensor(v, dtype=dt)
        if dropout_mask is not None:
            scale = torch.full((), 1.0 / rate, dtype=dt, device=h.device)
            h = h * (dropout_mask.to(dt) * scale)
        else:
            h = torch.where(keep, h / torch.full((), rate, dtype=dt,
                                                 device=h.device),
                            torch.zeros((), dtype=dt, device=h.device))
    h = torch.relu(h @ fc2["w"].to(dt) + fc2["b"].to(dt))
    return h @ fc3["w"].to(dt)


def _jax_uniform(key, shape, bound: float) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, -bound, bound)` for a
    threefry key: 32 bits per element from the counter words (0, flat
    index), the mantissa fill `bitcast((bits >> 9) | 0x3f800000) - 1` in
    f32, then `u * (max - min) + min` and `max(min, .)`. XLA contracts that
    multiply-add into one fused op, rounded once: here it is taken in f64,
    where the product (23 + 24 significant bits) and the sum are exact, and
    rounded once to f32."""
    from ..ops import threefry
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64)
    o0, o1 = threefry.threefry2x32(key[0], key[1], torch.zeros_like(idx), idx)
    bits = ((o0 ^ o1) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(-bound, dtype=torch.float32)
    hi = torch.tensor(bound, dtype=torch.float32)
    fused = (u.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, fused).reshape(shape)


def linear_init(key, fan_in: int, fan_out: int, bias: bool) -> dict:
    """The JAX package's `_torch_linear_init(key, fan_in, fan_out)`, bit for
    bit: `split(key)` into (wkey, bkey), each array `_jax_uniform` with
    bound 1/sqrt(fan_in)."""
    from ..ops import threefry
    bound = 1.0 / math.sqrt(fan_in)
    wkey, bkey = threefry.split(key)
    layer = {"w": _jax_uniform(wkey, (fan_in, fan_out), bound)}
    if bias:
        layer["b"] = _jax_uniform(bkey, (fan_out,), bound)
    return layer


def init_params(seed: int, dims=MLP_DIMS) -> Params:
    """The JAX package's `init_mlp(jax.random.key(seed), dims=dims)`, bit
    for bit, as a params tree of f32 CPU tensors: `split(key, 3)` gives one
    key per layer (`linear_init`)."""
    from ..ops import threefry
    d0, d1, d2, d3 = dims
    return {name: linear_init(key, fan_in, fan_out, bias)
            for name, key, (fan_in, fan_out), bias in zip(
                ("fc1", "fc2", "fc3"),
                threefry.split(threefry.key_data(seed), 3),
                ((d0, d1), (d1, d2), (d2, d3)), (True, True, False))}


def from_jax_params(tree, device="cpu") -> MLP:
    """A model holding exactly the weights of the JAX params tree
    `{"fc1": {"w","b"}, "fc2": {"w","b"}, "fc3": {"w"}}` (numpy arrays or
    anything np.asarray takes), in the same (fan_in, fan_out) layout; a
    zoo model's tree (models/zoo.py `from_tree`) builds that model."""
    if ("fc1" not in tree
            or np.asarray(tree["fc1"]["w"]).shape[1] != MLP_DIMS[1]):
        from .zoo import from_tree
        return from_tree(tree, device)
    model = MLP()
    with torch.no_grad():
        for name, layer in model.params().items():
            for k, p in layer.items():
                src = np.asarray(tree[name][k], np.float32)
                if src.shape != tuple(p.shape):
                    raise ValueError(f"{name}.{k}: shape {src.shape}, "
                                     f"expected {tuple(p.shape)}")
                p.copy_(torch.tensor(src))
    return model.to(device)


def to_numpy_params(params: Params) -> Dict[str, Dict[str, np.ndarray]]:
    """Params tree (or a model) -> the JAX-layout tree of float32 numpy
    arrays: the inverse of `from_jax_params`."""
    if isinstance(params, nn.Module):
        params = params.params()
    return {name: {k: v.detach().cpu().numpy().astype(np.float32, copy=True)
                   for k, v in layer.items()}
            for name, layer in params.items()}


def param_count(params: Params) -> int:
    return sum(int(p.numel()) for layer in params.values()
               for p in layer.values())
