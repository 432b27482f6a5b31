"""The whole-epoch kernel: one call runs an epoch of SGD steps.

Port of `epoch_fused_sgd` -> `_make_epoch_kernel` and `epoch_sgd_reference`
of `pytorch_ddp_mnist_tpu/ops/pallas_step.py`, single replica, in the four
dropout forms the resident-dataset trainer runs:

    K2a  masks=...            pre-drawn pre-scaled (S*B, 128) masks, f32 rows
    K2b  uint8 xp             raw pixels, normalised in the kernel
    K2c  rng_impl="core"      masks drawn in the kernel by Philox4x32-10
                              keyed (seed, step) (ops/philox.py): the port's
                              own stream in place of the TPU core PRNG
    K3   rng_impl="threefry"  masks drawn in the kernel by jax's threefry
                              from per-step key words (ops/threefry.py),
                              bit for bit dropout_mask(step_key)

each in f32 or with `compute_bf16=True` (K2-bf16: the six products take
bf16 operands at K1-bf16's cast points, the f32 master weights are rounded
at every step, the update stays f32), and with `steps_per_iter` K in
{1, 2, 4, 8} (the superstep: K steps per kernel iteration, bit for bit the
K = 1 result; a ragged step count is padded and its padded steps skipped).

  * `epoch_fused_sgd(...)` is the public entry. CUDA tensors launch the
    hand-written kernel in `csrc/epoch_step.cu` (one cooperative launch per
    epoch, no float atomics, bitwise repeatable) or raise; it never falls
    back. CPU tensors, and only they, run `epoch_fused_sgd_reference`.
  * `epoch_fused_sgd_reference` is the plain version on any device: a loop
    of `fused_loss_and_grads_reference` + `sgd_step` with the same masks.
  * `launch_count` counts wrapper calls that launched the epoch kernel,
    one key per form: `epoch_step` (f32, K = 1), `epoch_step_bf16`,
    `epoch_step_superstep` (K > 1) and `epoch_step_superstep_bf16`.
  * `kernel_mask_block(...)` returns the mask the kernel draws at one step
    (on CUDA from the kernel's own device function), so a card can compare
    the in-kernel streams with the plain ones bit for bit.

The input params are never written: the kernel copies them to new output
tensors first, as the TPU kernel does at its step 0.
"""

from __future__ import annotations

import ctypes

import torch

from ..data.mnist import device_normalize
from . import philox, threefry
from .fused_step import (HIDDEN1, IN_DIM, _WEIGHT_NAMES, _WEIGHT_SHAPES,
                         _tree, _weights, fused_loss_and_grads_reference,
                         step_reference_bf16)
from .sgd import sgd_step

# Largest per-step batch of the JAX epoch kernel (one VMEM block per step);
# kept so that the port accepts and refuses the same inputs.
EPOCH_KERNEL_MAX_BATCH = 1024
# The JAX kernel keeps the threefry key table in SMEM and caps it; the port
# keeps the cap for the same reason of parity (its table is in global memory).
EPOCH_KERNEL_MAX_RNG_STEPS = 4096

_RNG_CODE = {"masks": 0, "threefry": 1, "core": 2}

STEPS_PER_ITER = (1, 2, 4, 8)

# wrapper calls that launched the CUDA kernel, per form (chip_smoke.py resets
# and reads them)
launch_count = {"epoch_step": 0, "epoch_step_bf16": 0,
                "epoch_step_superstep": 0, "epoch_step_superstep_bf16": 0}
# what the last launch ran: its grid (blocks of 256 threads), its form
# ("<uint8|f32>/<masks|threefry|core>"), bf16 mode, steps per iteration and
# whether it staged its rows, for reports and checks
last_launch = {"blocks": 0, "form": "", "bf16": False, "steps_per_iter": 1,
               "staged": False}

_lib = None


def _kernel_lib():
    """The built kernel library with its ctypes signatures declared."""
    global _lib
    if _lib is None:
        from . import _build
        lib = _build.load("epoch_step")
        p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
        lib.pdmt_epoch_step.argtypes = ([p, i, p, i, p, p, u] + [p] * 10
                                        + [i, i, i] + [p] * 3
                                        + [i, i, f, f, ctypes.POINTER(i), p])
        lib.pdmt_epoch_step.restype = i
        lib.pdmt_epoch_mask.argtypes = [i, p, u, i, i, p, p]
        lib.pdmt_epoch_mask.restype = i
        lib.pdmt_epoch_stages.argtypes = [i, i]
        lib.pdmt_epoch_stages.restype = i
        lib.pdmt_epoch_scratch_per_row.argtypes = []
        lib.pdmt_epoch_scratch_per_row.restype = i
        lib.pdmt_epoch_error_string.argtypes = [i]
        lib.pdmt_epoch_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _kernel_lib().pdmt_epoch_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def _check(params, xp, yp, seed_or_keys, batch, masks, rng_impl,
           steps_per_iter=1, valid_steps=None):
    """The JAX wrapper's validation (single replica): the same inputs are
    accepted and refused. Returns (rng, nsteps, valid_steps, pad_steps):
    the steps in xp, the steps that train, and the steps a ragged xp lacks
    to a whole number of iterations."""
    if xp.dim() != 2 or xp.shape[1] != IN_DIM:
        raise ValueError(f"xp must be (S*B, {IN_DIM}); got {tuple(xp.shape)}")
    if batch % 8 != 0:
        raise ValueError(f"pallas_epoch needs a batch divisible by 8 (the "
                         f"f32 sublane tile); got {batch}")
    if batch > EPOCH_KERNEL_MAX_BATCH:
        raise ValueError(
            f"pallas_epoch streams each step's batch as ONE block; batch "
            f"{batch} > {EPOCH_KERNEL_MAX_BATCH} exceeds its budget. Use the "
            f"per-step kernel (--kernel pallas) instead")
    rows = xp.shape[0]
    nsteps = rows // batch
    if nsteps < 1 or nsteps * batch != rows:
        raise ValueError(f"xp has {rows} rows, not a whole number of steps "
                         f"of batch {batch}")
    if rng_impl not in ("core", "threefry"):
        raise ValueError(f"rng_impl must be 'core' (in-kernel Philox, the "
                         f"port's core stream) or 'threefry' (in-kernel "
                         f"reference RNG); got {rng_impl!r}")
    if masks is not None and rng_impl != "core":
        raise ValueError("pass either masks= (pre-drawn) or "
                         "rng_impl='threefry' (in-kernel draw), not both")
    rng = "masks" if masks is not None else rng_impl
    if rng == "threefry":
        keys = seed_or_keys
        if (not isinstance(keys, torch.Tensor) or keys.dim() != 2
                or keys.shape[1] != 2
                or keys.dtype not in (torch.int32, torch.int64)):
            raise ValueError(
                f"rng_impl='threefry' takes per-step key words: seed must be "
                f"an (nsteps, 2) int32 tensor of key_data rows; got "
                f"{getattr(keys, 'shape', keys)!r}")
        if keys.shape[0] != nsteps:
            raise ValueError(
                f"rng_impl='threefry' needs one key-word row per step: seed "
                f"has {keys.shape[0]} rows for {nsteps} steps")
    K = steps_per_iter
    if K not in STEPS_PER_ITER:
        raise ValueError(
            f"steps_per_iter must be 1, 2, 4 or 8 (the K sub-step loss rows "
            f"of a grid iteration must stay inside one 8-row loss tile); "
            f"got {K}")
    if K * batch > EPOCH_KERNEL_MAX_BATCH:
        raise ValueError(
            f"steps_per_iter={K} streams a ({K}*{batch}, 784) input block "
            f"per grid iteration; {K * batch} rows > "
            f"{EPOCH_KERNEL_MAX_BATCH} exceeds the VMEM stream budget")
    if valid_steps is None:
        valid_steps = nsteps
    elif not 0 < valid_steps <= nsteps:
        raise ValueError(
            f"valid_steps={valid_steps} must be in [1, {nsteps}] (the "
            f"number of steps present in xp)")
    pad_steps = (-nsteps) % K
    if rng == "threefry" and nsteps + pad_steps > EPOCH_KERNEL_MAX_RNG_STEPS:
        raise ValueError(
            f"rng_impl='threefry' takes at most {EPOCH_KERNEL_MAX_RNG_STEPS} "
            f"steps (the JAX kernel's key table budget); got "
            f"{nsteps + pad_steps}. Split the run into shorter epochs, or use "
            f"rng_impl='core' / pre-drawn masks")
    if masks is not None and tuple(masks.shape) != (rows, HIDDEN1):
        raise ValueError(f"masks must be ({rows}, {HIDDEN1}); got "
                         f"{tuple(masks.shape)}")
    if tuple(yp.shape) != (rows,):
        raise ValueError(f"yp must be ({rows},); got {tuple(yp.shape)}")
    if not (xp.dtype == torch.uint8 or xp.dtype.is_floating_point):
        raise ValueError(f"xp must be uint8 or float; got {xp.dtype}")
    for name, t, shape in zip(_WEIGHT_NAMES, _weights(params), _WEIGHT_SHAPES):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(t.shape)}")
    tensors = [("yp", yp)] + list(zip(_WEIGHT_NAMES, _weights(params)))
    if masks is not None:
        tensors.append(("masks", masks))
    if rng == "threefry":
        tensors.append(("seed", seed_or_keys))
    for name, t in tensors:
        if t.device != xp.device:
            raise ValueError(f"{name} is on {t.device}, xp on {xp.device}")
    return rng, nsteps, valid_steps, pad_steps


def step_mask(rng, seed_or_keys, masks, step, batch, device):
    """The plain (batch, 128) mask of `step` in form `rng`; for 'threefry'
    `seed_or_keys` is the key table (a tensor or its `.tolist()`)."""
    if rng == "masks":
        return masks[step * batch:(step + 1) * batch].to(torch.float32)
    if rng == "threefry":
        row = seed_or_keys[step]
        k0, k1 = (int(v) & threefry.M32 for v in
                  (row.tolist() if isinstance(row, torch.Tensor) else row))
        return threefry.mask_block(k0, k1, batch, device)
    return philox.mask_block(int(seed_or_keys), step, batch, device)


@torch.no_grad()
def epoch_fused_sgd_reference(params, xp, yp, seed_or_keys, lr: float,
                              batch: int, *, masks=None,
                              rng_impl: str = "core",
                              compute_bf16: bool = False,
                              steps_per_iter: int = 1, valid_steps=None):
    """Plain PyTorch version of the kernel, on any device: a step loop of
    fused_loss_and_grads_reference (or step_reference_bf16 with
    `compute_bf16`) + sgd_step (f32 product, then subtract), with the masks
    of the chosen form. Steps run in iterations of `steps_per_iter`; the
    steps at or past `valid_steps` (and those a ragged xp lacks) are
    skipped. Returns (new params tree, losses (valid_steps,) f32); the
    input params are not written."""
    rng, nsteps, valid_steps, _ = _check(params, xp, yp, seed_or_keys, batch,
                                         masks, rng_impl, steps_per_iter,
                                         valid_steps)
    p = {n: {k: v.detach().to(torch.float32).clone() for k, v in layer.items()}
         for n, layer in params.items()}
    if rng == "threefry":   # one fetch of the key table, not one per step
        seed_or_keys = seed_or_keys.tolist()
    step_fn = step_reference_bf16 if compute_bf16 else \
        fused_loss_and_grads_reference
    losses = []
    for base in range(0, nsteps, steps_per_iter):
        for s in range(base, min(base + steps_per_iter, valid_steps)):
            xb = xp[s * batch:(s + 1) * batch]
            xb = device_normalize(xb) if xb.dtype == torch.uint8 else xb.float()
            yb = yp[s * batch:(s + 1) * batch]
            mb = step_mask(rng, seed_or_keys, masks, s, batch, xp.device)
            loss, grads = step_fn(p, xb, yb, mb)
            sgd_step(p, grads, lr)
            losses.append(loss)
    return p, torch.stack(losses)


def _pad_steps(t, rows: int):
    """t with `rows` zero rows appended (the JAX wrapper's fallback for a
    ragged step count that the caller did not pad at the index level)."""
    if t is None or rows == 0:
        return t
    return torch.cat([t, t.new_zeros((rows,) + tuple(t.shape[1:]))])


def _form_key(bf16: bool, steps_per_iter: int) -> str:
    return ("epoch_step" + ("_superstep" if steps_per_iter > 1 else "")
            + ("_bf16" if bf16 else ""))


def _epoch_cuda(params, xp, yp, seed_or_keys, lr, batch, masks, rng, nsteps,
                compute_bf16, steps_per_iter, valid_steps, pad_steps):
    lib = _kernel_lib()
    dev = xp.device
    x = xp if xp.dtype == torch.uint8 else xp.to(torch.float32)
    x = _pad_steps(x, pad_steps * batch).contiguous()
    y32 = _pad_steps(yp.to(torch.int32), pad_steps * batch).contiguous()
    nsteps += pad_steps
    ins = [w.detach().to(torch.float32).contiguous() for w in _weights(params)]
    outs = [torch.empty_like(w) for w in ins]
    m = (_pad_steps(masks.to(torch.float32), pad_steps * batch).contiguous()
         if rng == "masks" else None)
    keys = (_pad_steps(threefry.to_int32_words(seed_or_keys), pad_steps)
            if rng == "threefry" else None)
    seed = int(seed_or_keys) & threefry.M32 if rng == "core" else 0
    scratch = torch.empty(batch * lib.pdmt_epoch_scratch_per_row(),
                          dtype=torch.float32, device=dev)
    u8 = int(x.dtype == torch.uint8)
    stage = (torch.empty(steps_per_iter * batch * IN_DIM, dtype=torch.float32,
                         device=dev)
             if lib.pdmt_epoch_stages(u8, steps_per_iter) else None)
    losses = torch.empty(nsteps, dtype=torch.float32, device=dev)
    grid = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pdmt_epoch_step(
            x.data_ptr(), u8, y32.data_ptr(),
            _RNG_CODE[rng], m.data_ptr() if m is not None else None,
            keys.data_ptr() if keys is not None else None, seed,
            *(w.data_ptr() for w in ins), *(w.data_ptr() for w in outs),
            int(compute_bf16), steps_per_iter, valid_steps,
            scratch.data_ptr(), stage.data_ptr() if stage is not None else None,
            losses.data_ptr(), nsteps, batch, lr, 1.0 / batch,
            ctypes.byref(grid), stream)
    _raise_on(err, "epoch_step kernel launch")
    launch_count[_form_key(compute_bf16, steps_per_iter)] += 1
    last_launch.update(
        blocks=grid.value, bf16=bool(compute_bf16),
        steps_per_iter=steps_per_iter, staged=stage is not None,
        form=f"{'uint8' if u8 else 'f32'}/{rng}")
    return _tree(*outs), losses[:valid_steps]


def epoch_fused_sgd(params, xp, yp, seed_or_keys, lr: float, batch: int, *,
                    masks=None, rng_impl: str = "core",
                    compute_bf16: bool = False, steps_per_iter: int = 1,
                    valid_steps=None):
    """One ENTIRE epoch as one kernel (`--kernel pallas_epoch`): (params, xp
    (S*B, 784) gathered epoch rows, f32 or raw uint8, yp (S*B,) int,
    seed_or_keys, lr, batch=B) -> (new params, losses (S,) f32).

    `seed_or_keys`: the epoch seed (an int, taken mod 2**32) for
    rng_impl='core'; an (S, 2) int32/int64 tensor of per-step key words for
    rng_impl='threefry'; unused with `masks` ((S*B, 128) pre-scaled).

    `compute_bf16`: the bf16-operand mode. `steps_per_iter` K in {1, 2, 4,
    8}: K steps per kernel iteration, the same bits as K = 1. A step count
    that K does not divide is padded with zero rows here; hot paths pad at
    the index level instead and pass `valid_steps`, the number of real
    steps: the steps past it are skipped (no update) and exactly
    `valid_steps` losses come back. Masks and keys stay those of the global
    step.

    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    version."""
    rng, nsteps, valid, pad = _check(params, xp, yp, seed_or_keys, batch,
                                     masks, rng_impl, steps_per_iter,
                                     valid_steps)
    if xp.device.type == "cuda":
        return _epoch_cuda(params, xp, yp, seed_or_keys, lr, batch, masks,
                           rng, nsteps, compute_bf16, steps_per_iter, valid,
                           pad)
    if xp.device.type == "cpu":
        return epoch_fused_sgd_reference(
            params, xp, yp, seed_or_keys, lr, batch, masks=masks,
            rng_impl=rng_impl, compute_bf16=compute_bf16,
            steps_per_iter=steps_per_iter, valid_steps=valid_steps)
    raise ValueError(f"epoch_fused_sgd runs on cuda or cpu, not "
                     f"{xp.device.type}")


def kernel_mask_block(seed_or_keys, step: int, batch: int, *,
                      rng_impl: str, device) -> torch.Tensor:
    """The (batch, 128) mask the epoch kernel draws at `step` for rng_impl
    'core' (seed) or 'threefry' ((S, 2) key words). On a CUDA device it
    comes from the kernel's own device function (one small launch, not
    counted in launch_count); on the CPU from the plain version."""
    if rng_impl not in ("core", "threefry"):
        raise ValueError(f"rng_impl must be 'core' or 'threefry'; got "
                         f"{rng_impl!r}")
    device = torch.device(device)
    if device.type == "cpu":
        return step_mask(rng_impl, seed_or_keys, None, step, batch, device)
    if device.type != "cuda":
        raise ValueError(f"kernel_mask_block runs on cuda or cpu, not "
                         f"{device.type}")
    lib = _kernel_lib()
    keys = (threefry.to_int32_words(seed_or_keys).to(device)
            if rng_impl == "threefry" else None)
    seed = int(seed_or_keys) & threefry.M32 if rng_impl == "core" else 0
    out = torch.empty((batch, HIDDEN1), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.pdmt_epoch_mask(_RNG_CODE[rng_impl],
                                  keys.data_ptr() if keys is not None else None,
                                  seed, step, batch, out.data_ptr(), stream)
    _raise_on(err, "epoch_step mask kernel launch")
    return out
