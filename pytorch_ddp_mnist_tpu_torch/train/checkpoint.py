"""Checkpoints as the reference writes them (port of the `.pt` path of
`pytorch_ddp_mnist_tpu/train/checkpoint.py`).

The reference saves once, at the end, rank 0 only:
`torch.save(model.state_dict(), 'model.pt')` of its nn.Sequential, whose
keys are '0.weight', '0.bias', '3.weight', '3.bias', '5.weight' with torch
Linear's (out, in) weight layout. The port writes exactly that file, which
is also the file the JAX package writes for a `.pt` path, so a checkpoint
moves freely between the reference, the JAX package and the port. The
transpose from the port's (fan_in, fan_out) layout happens here and nowhere
else.
"""

from __future__ import annotations

import os

import torch

# our layer -> the reference nn.Sequential's state_dict key stem
_TORCH_STEMS = (("fc1", "0"), ("fc2", "3"), ("fc3", "5"))


def params_to_torch_state_dict(params):
    """Params tree (fan_in, fan_out) -> the reference state_dict: float32
    CPU tensors, weights transposed to (out, in)."""
    sd = {}
    for ours, stem in _TORCH_STEMS:
        layer = params[ours]
        sd[f"{stem}.weight"] = (layer["w"].detach().to("cpu", torch.float32)
                                .T.contiguous())
        if "b" in layer:
            sd[f"{stem}.bias"] = layer["b"].detach().to("cpu", torch.float32).clone()
    return sd


def params_from_torch_state_dict(sd):
    """The reference state_dict -> params tree of CPU tensors, weights back
    to (fan_in, fan_out). A uniformly 'module.'-prefixed (still
    DDP-wrapped) save is accepted; any other layout raises by name."""
    if sd and all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    params = {}
    for ours, stem in _TORCH_STEMS:
        key = f"{stem}.weight"
        if key not in sd:
            expected = [f"{s}.weight" for _, s in _TORCH_STEMS] + [
                f"{s}.bias" for o, s in _TORCH_STEMS if o != "fc3"]
            raise ValueError(
                f"torch state_dict is missing key {key!r}; expected the "
                f"reference nn.Sequential layout {expected} (optionally "
                f"uniformly 'module.'-prefixed), got keys {sorted(sd)}")
        layer = {"w": torch.as_tensor(sd[key]).T.contiguous()}
        if f"{stem}.bias" in sd:
            layer["b"] = torch.as_tensor(sd[f"{stem}.bias"]).clone()
        params[ours] = layer
    return params


def save_checkpoint(path: str, params) -> None:
    """Write the reference state_dict to `path` atomically (a crash never
    leaves a torn file)."""
    tmp = path + ".tmp"
    torch.save(params_to_torch_state_dict(params), tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str):
    """Read a reference-layout `.pt` (ours, the JAX package's, or the
    reference's own) into a params tree of CPU tensors."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return params_from_torch_state_dict(sd)
