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

The zoo's models (models/zoo.py) save in the same form: a scaled `mlp` under
the reference's keys, a `deep_mlp` as the nn.Sequential of its layers
(Linear, ReLU, Dropout, then Linear, ReLU per further hidden layer, the
head): h0 -> '0', h1 -> '3', h2 -> '5', ..., out -> '2 depth + 1'. A `.npz`
path writes the JAX-layout params tree instead, one array per
'layer/key' (`{"h0/w": ...}`), which numpy reads on either side: the JAX
package's params as numpy load into the port (`from_npz`), and back.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# our layer -> the reference nn.Sequential's state_dict key stem
_TORCH_STEMS = (("fc1", "0"), ("fc2", "3"), ("fc3", "5"))


def _deep_stems(depth: int) -> tuple:
    """deep_mlp's layers -> their nn.Sequential key stems."""
    return (("h0", "0"),) + tuple((f"h{i}", str(2 * i + 1))
                                  for i in range(1, depth)) + (
        ("out", str(2 * depth + 1)),)


def _stems_of(params) -> tuple:
    if "fc1" in params:
        return _TORCH_STEMS
    return _deep_stems(sum(1 for n in params if n.startswith("h")))


def params_to_torch_state_dict(params):
    """Params tree (fan_in, fan_out) -> the reference state_dict: float32
    CPU tensors, weights transposed to (out, in)."""
    sd = {}
    for ours, stem in _stems_of(params):
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
    weights = sum(1 for k in sd if k.endswith(".weight"))
    stems = _TORCH_STEMS if weights <= 3 else _deep_stems(weights - 1)
    params = {}
    for ours, stem in stems:
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


def to_npz_arrays(params) -> dict:
    """Params tree -> {'layer/key': float32 numpy array} in the JAX
    layout."""
    return {f"{n}/{k}": torch.as_tensor(v).detach().cpu().to(
        torch.float32).numpy() for n, layer in params.items()
        for k, v in layer.items()}


def from_npz_arrays(arrays) -> dict:
    """{'layer/key': array} (an .npz's contents) -> params tree of CPU
    tensors."""
    params = {}
    for name in arrays:
        layer, key = name.split("/")
        params.setdefault(layer, {})[key] = torch.as_tensor(
            np.asarray(arrays[name], np.float32))
    return params


def save_checkpoint(path: str, params) -> None:
    """Write the reference state_dict (or, for a `.npz` path, the params
    tree) to `path` atomically (a crash never leaves a torn file)."""
    tmp = path + ".tmp"
    if path.endswith(".npz"):
        with open(tmp, "wb") as f:
            np.savez(f, **to_npz_arrays(params))
    else:
        torch.save(params_to_torch_state_dict(params), tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str):
    """Read a reference-layout `.pt` (ours, the JAX package's, or the
    reference's own), or a `.npz` params tree, into a params tree of CPU
    tensors."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return from_npz_arrays({k: z[k] for k in z.files})
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return params_from_torch_state_dict(sd)
