"""The workload zoo: the model family behind one interface (port of
`pytorch_ddp_mnist_tpu/models/zoo.py`).

Every model is the same kind of module the trainers already take (an
`nn.Module` with `params()`, the JAX-layout params tree, and a forward
`apply(params, x, train=, keep=, dropout_mask=)` with `mlp_apply`'s
contract): 784 features in, 10 classes out, dropout 0.2 after the first
hidden layer only.

    resolve_model("mlp", 1)       -> the port's MLP itself (models/mlp.py):
                                     every existing pin stays
    resolve_model("mlp", N)       -> hidden widths 128 N (784-128N-128N-10)
    resolve_model("deep_mlp", N)  -> DEEP_MLP_LAYERS hidden layers of width
                                     128 N, a head without bias

`param_scale` multiplies the hidden width, so the parameters grow about as
its square (mlp@8 ~1.9M, deep_mlp@8 ~4.0M): the size at which the
gradient-communication strategies (parallel/collectives.py) differ. The
initial weights are the JAX package's `init_mlp(key, dims=...)` /
`init_deep_mlp` for the same seed, bit for bit (jax's threefry stream,
models/mlp.py `linear_init`). The fused kernels take the reference MLP's
shapes only, so the other models run the plain autograd step (`--kernel
xla`), as in JAX.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from .mlp import DROPOUT_RATE, MLP, MLP_DIMS, linear_init, mlp_apply

MODELS = ("mlp", "deep_mlp")
DEEP_MLP_LAYERS = 4          # hidden layers of the deep_mlp family
HIDDEN_BASE = MLP_DIMS[1]    # 128: param_scale multiplies this


class ModelSpec(NamedTuple):
    """One resolved model: `from_seed(seed)` builds the module with the JAX
    package's initial weights for `jax.random.key(seed)`; `apply` is its
    forward on a params tree; `dims` its layer widths."""
    name: str
    param_scale: int
    from_seed: Callable[[int], nn.Module]
    apply: Callable[..., torch.Tensor]
    dims: Tuple[int, ...]


def validate_model(model: str, param_scale: int) -> None:
    """Refuse an unknown family or a non-positive scale, by name."""
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}; choose one of {MODELS}")
    if not isinstance(param_scale, int) or param_scale < 1:
        raise ValueError(f"param_scale must be an int >= 1 (multiplies the "
                         f"{HIDDEN_BASE}-unit hidden width); got "
                         f"{param_scale!r}")


def is_default_model(model: str, param_scale: int) -> bool:
    return model == "mlp" and param_scale == 1


def init_deep_mlp(seed: int, width: int, depth: int) -> dict:
    """The JAX package's `init_deep_mlp(jax.random.key(seed), width,
    depth)`, bit for bit: `split(key, depth + 1)`, one key a layer; 784 ->
    depth x width (with bias) -> 10 (no bias)."""
    from ..ops import threefry
    keys = threefry.split(threefry.key_data(seed), depth + 1)
    params, fan_in = {}, MLP_DIMS[0]
    for i in range(depth):
        params[f"h{i}"] = linear_init(keys[i], fan_in, width, True)
        fan_in = width
    params["out"] = linear_init(keys[depth], fan_in, MLP_DIMS[3], False)
    return params


def deep_mlp_apply(params: dict, x: torch.Tensor, *, train: bool = False,
                   dropout_mask: torch.Tensor | None = None,
                   keep: torch.Tensor | None = None) -> torch.Tensor:
    """Forward of the deep family, `mlp_apply`'s contract: the compute
    dtype follows x, dropout after the first hidden layer only, exactly one
    of `keep` / `dropout_mask` in train mode, written as JAX writes it."""
    dt = x.dtype
    depth = sum(1 for k in params if k.startswith("h"))
    h = x
    for i in range(depth):
        layer = params[f"h{i}"]
        h = torch.relu(h @ layer["w"].to(dt) + layer["b"].to(dt))
        if i == 0 and train:
            if (keep is None) == (dropout_mask is None):
                raise ValueError("train=True requires exactly one of "
                                 "dropout_mask / keep")
            rate = 1.0 - DROPOUT_RATE
            if dropout_mask is not None:
                scale = torch.full((), 1.0 / rate, dtype=dt, device=h.device)
                h = h * (dropout_mask.to(dt) * scale)
            else:
                h = torch.where(keep, h / torch.full((), rate, dtype=dt,
                                                     device=h.device),
                                torch.zeros((), dtype=dt, device=h.device))
    return h @ params["out"]["w"].to(dt)


class _Layer(nn.Module):
    def __init__(self, w: torch.Tensor, b: torch.Tensor | None):
        super().__init__()
        self.w = nn.Parameter(w.clone())
        self.b = nn.Parameter(b.clone()) if b is not None else None


class DeepMLP(nn.Module):
    """The deep family as a module: layers h0..h{depth-1} and out, holding
    a params tree's weights (`params()` returns the parameters themselves,
    no copy)."""

    def __init__(self, tree: dict):
        super().__init__()
        self.names = tuple(sorted(tree))          # h0.., out
        for name in self.names:
            layer = tree[name]
            setattr(self, name, _Layer(torch.as_tensor(layer["w"]),
                                       torch.as_tensor(layer["b"])
                                       if "b" in layer else None))
        depth = sum(1 for n in self.names if n.startswith("h"))
        width = int(tree["h0"]["w"].shape[1])
        self.dims = (MLP_DIMS[0],) + (width,) * depth + (MLP_DIMS[3],)

    def params(self) -> dict:
        out = {}
        for name in self.names:
            layer = getattr(self, name)
            out[name] = {"w": layer.w}
            if layer.b is not None:
                out[name]["b"] = layer.b
        return out

    def forward(self, x: torch.Tensor, train: bool = False,
                dropout_mask: torch.Tensor | None = None,
                keep: torch.Tensor | None = None) -> torch.Tensor:
        return deep_mlp_apply(self.params(), x, train=train,
                              dropout_mask=dropout_mask, keep=keep)


def resolve_model(model: str = "mlp", param_scale: int = 1) -> ModelSpec:
    """The named family at the given width scale. The default is the
    reference MLP itself (`MLP.from_seed`, `mlp_apply`)."""
    validate_model(model, param_scale)
    if model == "mlp":
        dims = (MLP_DIMS[0], HIDDEN_BASE * param_scale,
                HIDDEN_BASE * param_scale, MLP_DIMS[3])
        if param_scale == 1:
            return ModelSpec("mlp", 1, MLP.from_seed, mlp_apply, MLP_DIMS)
        return ModelSpec("mlp", param_scale,
                         lambda seed: MLP.from_seed(seed, dims), mlp_apply,
                         dims)
    width = HIDDEN_BASE * param_scale
    dims = (MLP_DIMS[0],) + (width,) * DEEP_MLP_LAYERS + (MLP_DIMS[3],)
    return ModelSpec(
        "deep_mlp", param_scale,
        lambda seed: DeepMLP(init_deep_mlp(seed, width, DEEP_MLP_LAYERS)),
        deep_mlp_apply, dims)


def model_apply(model: nn.Module):
    """The forward on a params tree that goes with a zoo module."""
    return deep_mlp_apply if isinstance(model, DeepMLP) else mlp_apply


def hidden_width(params: dict) -> int:
    """The width of a params tree's first hidden layer (where dropout is)."""
    first = params["fc1"] if "fc1" in params else params["h0"]
    return int(first["w"].shape[1])


def from_tree(tree, device="cpu") -> nn.Module:
    """The zoo module holding exactly the weights of a JAX-layout params
    tree (numpy arrays or tensors): a (scaled) MLP for fc1..fc3, a DeepMLP
    for h0..out."""
    tree = {n: {k: torch.as_tensor(np.asarray(v, np.float32))
                for k, v in layer.items()} for n, layer in tree.items()}
    if "fc1" in tree:
        dims = (int(tree["fc1"]["w"].shape[0]), int(tree["fc1"]["w"].shape[1]),
                int(tree["fc2"]["w"].shape[1]), int(tree["fc3"]["w"].shape[1]))
        model = MLP(dims=dims)
        with torch.no_grad():
            for name, layer in model.params().items():
                for k, p in layer.items():
                    if tuple(tree[name][k].shape) != tuple(p.shape):
                        raise ValueError(f"{name}.{k}: shape "
                                         f"{tuple(tree[name][k].shape)}, "
                                         f"expected {tuple(p.shape)}")
                    p.copy_(tree[name][k])
        return model.to(device)
    if "h0" not in tree or "out" not in tree:
        raise ValueError(f"a params tree of layers {sorted(tree)} is neither "
                         f"the mlp family (fc1..fc3) nor deep_mlp (h0..out)")
    return DeepMLP(tree).to(device)


def spec_of(model: nn.Module) -> tuple:
    """(family, param_scale) of a zoo module."""
    if isinstance(model, DeepMLP):
        return "deep_mlp", model.dims[1] // HIDDEN_BASE
    return "mlp", model.dims[1] // HIDDEN_BASE
