"""The fused train step: one call computes a step's loss and gradients.

Port of the K1 part of `pytorch_ddp_mnist_tpu/ops/pallas_step.py`
(`fused_loss_and_grads` -> `_run_fused` -> `_make_fused_kernel`, f32 with a
mask input; `dropout_mask`; `make_pallas_train_step`).

  * `fused_loss_and_grads(params, x, y, scaled_mask)` is the public entry.
    For CUDA tensors it launches the hand-written kernel in
    `csrc/fused_step.cu` (two launches per call, no float atomics, true
    f32, bitwise repeatable) or raises; it never falls back. For CPU
    tensors, and only then, it runs `fused_loss_and_grads_reference`.
  * `fused_loss_and_grads_reference` spells out the same formulas in plain
    PyTorch (no autograd) on any device: the CPU tests hold it against the
    JAX kernel, and chip_smoke.py holds the CUDA kernel against it.
  * `launch_count["fused_step"]` counts wrapper calls that launched the
    kernel, so a run can show that its steps went through it.

`params` is the JAX-layout tree `{"fc1": {"w", "b"}, "fc2": {"w", "b"},
"fc3": {"w"}}` with weights (fan_in, fan_out), as `MLP.params()` gives it.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.mlp import DROPOUT_RATE, MLP_DIMS, keep_mask
from .sgd import sgd_step

IN_DIM, HIDDEN1, HIDDEN2, NUM_CLASSES = MLP_DIMS

# wrapper calls that launched the CUDA kernel (chip_smoke.py resets and reads it)
launch_count = {"fused_step": 0}

_lib = None


def _kernel_lib():
    """The built kernel library with its ctypes signatures declared."""
    global _lib
    if _lib is None:
        from . import _build
        lib = _build.load("fused_step")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pdmt_fused_step_f32.argtypes = [p] * 15 + [i, ctypes.c_float, p]
        lib.pdmt_fused_step_f32.restype = i
        lib.pdmt_fused_step_scratch_per_row.argtypes = []
        lib.pdmt_fused_step_scratch_per_row.restype = i
        lib.pdmt_error_string.argtypes = [i]
        lib.pdmt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _weights(params):
    return (params["fc1"]["w"], params["fc1"]["b"], params["fc2"]["w"],
            params["fc2"]["b"], params["fc3"]["w"])


_WEIGHT_SHAPES = ((IN_DIM, HIDDEN1), (HIDDEN1,), (HIDDEN1, HIDDEN2),
                  (HIDDEN2,), (HIDDEN2, NUM_CLASSES))
_WEIGHT_NAMES = ("fc1.w", "fc1.b", "fc2.w", "fc2.b", "fc3.w")


def _check_inputs(params, x, y, scaled_mask) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if x.dim() != 2 or x.shape[1] != IN_DIM or x.shape[0] < 1:
        raise ValueError(f"x must be (B >= 1, {IN_DIM}); got {tuple(x.shape)}")
    batch = x.shape[0]
    named = [("x", x, (batch, IN_DIM)),
             ("scaled_mask", scaled_mask, (batch, HIDDEN1))]
    named += list(zip(_WEIGHT_NAMES, _weights(params), _WEIGHT_SHAPES))
    for name, t, shape in named:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32; got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if tuple(y.shape) != (batch,) or y.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"y must be ({batch},) int32 or int64; got "
                         f"{tuple(y.shape)} {y.dtype}")
    if y.device != x.device:
        raise ValueError(f"y is on {y.device}, x on {x.device}")


@torch.no_grad()
def fused_loss_and_grads_reference(params, x, y, scaled_mask):
    """Plain PyTorch version of the kernel, on any device: the same
    formulas written out (not autograd). Returns (mean loss, grads tree)."""
    w1, b1, w2, b2, w3 = (t.detach() for t in _weights(params))
    batch = x.shape[0]
    m = scaled_mask
    z1 = x @ w1 + b1
    d1 = torch.relu(z1) * m
    z2 = d1 @ w2 + b2
    h2 = torch.relu(z2)
    logits = h2 @ w3
    # stable softmax cross-entropy
    mx = logits.amax(dim=1, keepdim=True)
    ex = torch.exp(logits - mx)
    se = ex.sum(dim=1, keepdim=True)
    classes = torch.arange(NUM_CLASSES, device=x.device)
    onehot = (classes == y.long()[:, None]).to(x.dtype)
    logit_y = torch.where(onehot > 0, logits, 0.0).sum(dim=1, keepdim=True)
    loss = ((mx + torch.log(se)) - logit_y).sum() / batch
    # backward
    dl = (ex / se - onehot) * (1.0 / batch)
    gw3 = h2.T @ dl
    dz2 = (dl @ w3.T) * (z2 > 0).to(x.dtype)
    gw2 = d1.T @ dz2
    gb2 = dz2.sum(dim=0)
    dz1 = ((dz2 @ w2.T) * m) * (z1 > 0).to(x.dtype)
    gw1 = x.T @ dz1
    gb1 = dz1.sum(dim=0)
    return loss, {"fc1": {"w": gw1, "b": gb1}, "fc2": {"w": gw2, "b": gb2},
                  "fc3": {"w": gw3}}


def _fused_cuda(params, x, y, scaled_mask):
    lib = _kernel_lib()
    batch = x.shape[0]
    y32 = y.to(torch.int32).contiguous()
    w1, b1, w2, b2, w3 = _weights(params)
    scratch = torch.empty(batch * lib.pdmt_fused_step_scratch_per_row(),
                          dtype=torch.float32, device=x.device)
    loss = torch.empty((), dtype=torch.float32, device=x.device)
    grads = [torch.empty_like(w) for w in (w1, b1, w2, b2, w3)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pdmt_fused_step_f32(
            x.data_ptr(), y32.data_ptr(), scaled_mask.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            w3.data_ptr(), scratch.data_ptr(), loss.data_ptr(),
            *(g.data_ptr() for g in grads), batch, 1.0 / batch, stream)
    if err != 0:
        raise RuntimeError(f"fused_step kernel launch failed: CUDA error "
                           f"{err} ({lib.pdmt_error_string(err).decode()})")
    launch_count["fused_step"] += 1
    gw1, gb1, gw2, gb2, gw3 = grads
    return loss, {"fc1": {"w": gw1, "b": gb1}, "fc2": {"w": gw2, "b": gb2},
                  "fc3": {"w": gw3}}


def fused_loss_and_grads(params, x, y, scaled_mask):
    """(params tree, x (B, 784) f32, y (B,) int, scaled_mask (B, 128) f32 in
    {0, 1/keep}) -> (mean loss, grads tree). Any B >= 1.

    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    version. Parameters may require grad: no autograd graph is built."""
    _check_inputs(params, x, y, scaled_mask)
    if x.device.type == "cuda":
        return _fused_cuda(params, x, y, scaled_mask)
    if x.device.type == "cpu":
        return fused_loss_and_grads_reference(params, x, y, scaled_mask)
    raise ValueError(f"fused_loss_and_grads runs on cuda or cpu, not "
                     f"{x.device.type}")


def dropout_mask(generator: torch.Generator, batch: int,
                 device: torch.device | str) -> torch.Tensor:
    """The pre-scaled (batch, 128) f32 mask the kernel takes: keep_mask's
    draw / keep, so 0 or 1.25. (A mask of ones is the no-dropout step.)"""
    keep = 1.0 - DROPOUT_RATE
    return keep_mask(generator, batch, device).to(torch.float32) / keep


def make_fused_train_step(lr: float):
    """The `--kernel pallas` step (counterpart of `make_pallas_train_step`):
    step(model, generator, x, y) -> mean loss as a 0-d device tensor. Draws
    this step's mask from `generator`, runs the fused step, then SGD in
    place on the model's parameters."""
    def step(model, generator, x, y):
        params = model.params()
        mask = dropout_mask(generator, x.shape[0], x.device)
        loss, grads = fused_loss_and_grads(params, x, y, mask)
        sgd_step(params, grads, lr)
        return loss

    return step
