"""The torch re-statement of the reference model that the 10-epoch golden
starts from (port of `pytorch_ddp_mnist_tpu/utils/torch_ref.py`, which is
torch-only code, re-stated here because the port imports nothing of the
JAX package).

`build_reference_model(seed)` is the reference `create_model` graph
(ddp_tutorial_cpu.py:43-53: dropout 0.2 after layer 1 only, no bias on the
output layer, torch's default Linear init) under `torch.manual_seed(seed)`;
`params_from_torch` turns its state_dict into the port's params tree, the
weights transposed to the (fan_in, fan_out) `x @ w` layout of
models/mlp.py. Both are bitwise the JAX package's.
"""

from __future__ import annotations

import torch
from torch import nn


def build_reference_model(seed: int) -> nn.Sequential:
    """The reference create_model graph under torch.manual_seed(seed)."""
    torch.manual_seed(seed)
    return nn.Sequential(
        nn.Linear(784, 128), nn.ReLU(), nn.Dropout(0.2),
        nn.Linear(128, 128), nn.ReLU(),
        nn.Linear(128, 10, bias=False),
    )


def params_from_torch(model: nn.Module) -> dict:
    """Torch state_dict -> the params tree of f32 CPU tensors, weights
    transposed to (fan_in, fan_out)."""
    sd = {k: v.detach().to(torch.float32) for k, v in model.state_dict().items()}
    return {
        "fc1": {"w": sd["0.weight"].T.contiguous(), "b": sd["0.bias"].clone()},
        "fc2": {"w": sd["3.weight"].T.contiguous(), "b": sd["3.bias"].clone()},
        "fc3": {"w": sd["5.weight"].T.contiguous()},
    }
