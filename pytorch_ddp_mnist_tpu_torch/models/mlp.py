"""The MNIST MLP as an `nn.Module` (port of `pytorch_ddp_mnist_tpu/models/mlp.py`).

    Linear(784, 128) -> ReLU -> Dropout(0.2) -> Linear(128, 128) -> ReLU
        -> Linear(128, 10, bias=False)

Weights keep the JAX package's (fan_in, fan_out) layout, so the forward
pass is `x @ w` and a params tree `{"fc1": {"w", "b"}, "fc2": {"w", "b"},
"fc3": {"w"}}` carries over between the packages unchanged. Only the
reference `.pt` state_dict (train/checkpoint.py) uses torch Linear's
(out, in) layout.

Init follows torch.nn.Linear: weight and bias from U(-1/sqrt(fan_in),
+1/sqrt(fan_in)), drawn from an explicit `torch.Generator`. The draws are
not jax's, so the same seed gives other weights than the JAX package;
`from_jax_params` loads the JAX package's weights where a test needs both.
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
    """x @ w (+ b), with w stored (fan_in, fan_out)."""

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w
        return y + self.b if self.b is not None else y


class MLP(nn.Module):
    """The reference 784-128-128-10 MLP: dropout 0.2 after fc1 only, no
    bias on fc3. Parameters are float32 on CPU until moved with `.to()`."""

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        d0, d1, d2, d3 = MLP_DIMS
        self.fc1 = Dense(d0, d1, bias=True, generator=generator)
        self.fc2 = Dense(d1, d2, bias=True, generator=generator)
        self.fc3 = Dense(d2, d3, bias=False, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                dropout_mask: torch.Tensor | None = None) -> torch.Tensor:
        """(B, 784) -> (B, 10) logits. In train mode `dropout_mask` is the
        {0, 1} keep mask of fc1's output, (B, 128); kept units are scaled by
        1/keep (inverted dropout, as torch.nn.Dropout and `mlp_apply`)."""
        h = torch.relu(self.fc1(x))
        if train:
            if dropout_mask is None:
                raise ValueError("train=True requires a dropout_mask")
            keep = 1.0 - DROPOUT_RATE
            # 1/0.8 = 1.25 is exact, so mask * (1/keep) rounds like JAX's
            h = h * (dropout_mask.to(h.dtype) * (1.0 / keep))
        h = torch.relu(self.fc2(h))
        return self.fc3(h)

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


def keep_mask(generator: torch.Generator, batch: int,
              device: torch.device | str) -> torch.Tensor:
    """The dropout draw for one step: a (batch, 128) bool keep mask,
    uniform < 1 - DROPOUT_RATE, from `generator` (which must live on
    `device`). On CUDA the generator is Philox and on the CPU MT19937:
    neither is jax's threefry, so the same seed gives other masks than the
    JAX package. Tests that compare the two hand both the same numpy mask."""
    u = torch.rand((batch, MLP_DIMS[1]), generator=generator, device=device)
    return u < (1.0 - DROPOUT_RATE)


def from_jax_params(tree, device="cpu") -> MLP:
    """A model holding exactly the weights of the JAX params tree
    `{"fc1": {"w","b"}, "fc2": {"w","b"}, "fc3": {"w"}}` (numpy arrays or
    anything np.asarray takes), in the same (fan_in, fan_out) layout."""
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
    """Params tree (or an MLP) -> the JAX-layout tree of float32 numpy
    arrays: the inverse of `from_jax_params`."""
    if isinstance(params, MLP):
        params = params.params()
    return {name: {k: v.detach().cpu().numpy().astype(np.float32, copy=True)
                   for k, v in layer.items()}
            for name, layer in params.items()}


def param_count(params: Params) -> int:
    return sum(int(p.numel()) for layer in params.values()
               for p in layer.values())
