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

Any other path (`.msgpack`, as the JAX package's default) is the JAX
package's own format: flax's msgpack of the params tree, written by the
port's codec (train/msgpack.py) byte for byte as
`flax.serialization.to_bytes` writes it, and read back from what either
side wrote. A file that does not decode raises `CheckpointError`, naming
the path and its size; the step-checkpoint manager (train/ckpt_manager.py)
falls back past exactly that class.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import msgpack

# our layer -> the reference nn.Sequential's state_dict key stem
_TORCH_STEMS = (("fc1", "0"), ("fc2", "3"), ("fc3", "5"))


class CheckpointError(RuntimeError):
    """A checkpoint that cannot be decoded (truncated, torn, or not a
    checkpoint), or, from the step-checkpoint manager, a directory with no
    intact checkpoint left."""


def is_torch_path(path: str) -> bool:
    """Whether `path` selects the reference's torch state_dict format."""
    return str(path).endswith((".pt", ".pth"))


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


def host_params(params) -> dict:
    """Params tree -> {layer: {key: float32 numpy array}} with the keys
    sorted at every level: the order `jax.tree_util.tree_map` leaves a
    dict in, which is the order the JAX package's params reach flax (and
    so the order of its bytes)."""
    return {n: {k: torch.as_tensor(params[n][k]).detach().to(
                "cpu", torch.float32).numpy() for k in sorted(params[n])}
            for n in sorted(params)}


def params_to_bytes(params) -> bytes:
    """The `.msgpack` payload of a params tree: the bytes
    `flax.serialization.to_bytes` gives for the JAX package's params."""
    return msgpack.to_bytes(host_params(params))


def params_from_bytes(blob: bytes, template=None, what: str = "checkpoint"):
    """A `.msgpack` payload -> params tree of CPU tensors. With
    `template` (a params tree) the layers and shapes must be its own, in
    its order; a payload that does not decode raises CheckpointError."""
    try:
        tree = msgpack.unpackb(blob)
    except (msgpack.MsgpackError, ValueError, TypeError) as e:
        raise CheckpointError(f"{what}: cannot decode checkpoint "
                              f"({len(blob)} bytes): {type(e).__name__}: "
                              f"{e}") from e
    if not isinstance(tree, dict) or not all(
            isinstance(v, dict) for v in tree.values()):
        raise CheckpointError(f"{what}: not a params tree ({len(blob)} "
                              f"bytes decode to {type(tree).__name__})")
    if template is not None:
        out = {}
        for n, layer in template.items():
            for k, want in layer.items():
                got = tree.get(n, {}).get(k)
                if got is None:
                    raise ValueError(f"{what}: checkpoint has no "
                                     f"{n}/{k}; it holds {_layout(tree)}")
                if tuple(got.shape) != tuple(want.shape):
                    raise ValueError(
                        f"{what}: checkpoint param {n}/{k} has shape "
                        f"{tuple(got.shape)}, expected {tuple(want.shape)}")
                out.setdefault(n, {})[k] = got
        tree = out
    return {n: {k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
            for n, layer in tree.items()}


def _layout(tree) -> list:
    return [f"{n}/{k}" for n, layer in tree.items() for k in layer]


def save_checkpoint(path: str, params) -> None:
    """Write the reference state_dict (`.pt`/`.pth`), the params tree
    (`.npz`) or the JAX package's msgpack (any other path) to `path`
    atomically (a crash never leaves a torn file)."""
    tmp = path + ".tmp"
    if path.endswith(".npz"):
        with open(tmp, "wb") as f:
            np.savez(f, **to_npz_arrays(params))
    elif is_torch_path(path):
        torch.save(params_to_torch_state_dict(params), tmp)
    else:
        with open(tmp, "wb") as f:
            f.write(params_to_bytes(params))
    os.replace(tmp, path)


def load_checkpoint(path: str, template=None):
    """Read a reference-layout `.pt` (ours, the JAX package's, or the
    reference's own), a `.npz` params tree, or a `.msgpack` (the JAX
    package's or ours) into a params tree of CPU tensors. `template` (a
    params tree) checks a msgpack's layers and shapes."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return from_npz_arrays({k: z[k] for k in z.files})
    if is_torch_path(path):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return params_from_torch_state_dict(sd)
    with open(path, "rb") as f:
        blob = f.read()
    return params_from_bytes(blob, template, what=path)
