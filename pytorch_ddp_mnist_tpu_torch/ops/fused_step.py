"""The fused train step: one call computes a step's loss and gradients.

Port of the K1 part of `pytorch_ddp_mnist_tpu/ops/pallas_step.py`
(`fused_loss_and_grads` / `fused_loss_and_grads_rng` -> `_run_fused` ->
`_make_fused_kernel`; `step_reference_bf16`; `dropout_mask`;
`make_pallas_train_step`, `make_pallas_dp_train_step`), in its four
forms:

    K1            f32 x, pre-drawn mask
    K1-bf16       bf16 x: bf16 operands of the six products, f32
                  accumulation, f32 everything else (compute_bf16)
    K1-rng        the mask drawn in the kernel per (step seed, batch block)
                  from the port's Philox stream (ops/philox.py `rng_mask`)
    K1-rng-bf16   both

  * `fused_loss_and_grads(params, x, y, scaled_mask)` and
    `fused_loss_and_grads_rng(params, x, y, seed)` are the public entries;
    a bf16 `x` selects the bf16 mode, as in JAX. For CUDA tensors they
    launch the hand-written kernel in `csrc/fused_step.cu` (two launches per
    call, no float atomics, bitwise repeatable) or raise; they never fall
    back. For CPU tensors, and only then, they run the plain version.
  * `fused_loss_and_grads_reference` (f32) and `step_reference_bf16` spell
    out the same formulas in plain PyTorch (no autograd) on any device: the
    CPU tests hold them against the JAX kernel, and chip_smoke.py holds the
    CUDA kernel against them.
  * `dropout_mask(key, batch, device)` is the streaming trainer's draw,
    jax's `dropout_mask(key, batch)` bit for bit: on a card from the K3
    threefry device function (`csrc/mlp_step.cuh`), on the CPU from
    ops/threefry.py.
  * `launch_count` counts wrapper calls that launched a kernel, one key per
    form, so a run can show that its steps went through it.

`params` is the JAX-layout tree `{"fc1": {"w", "b"}, "fc2": {"w", "b"},
"fc3": {"w"}}` with weights (fan_in, fan_out), as `MLP.params()` gives it.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.mlp import MLP_DIMS
from . import philox, threefry
from .sgd import sgd_step

IN_DIM, HIDDEN1, HIDDEN2, NUM_CLASSES = MLP_DIMS

# wrapper calls that launched a CUDA kernel, per form (chip_smoke.py resets
# and reads them)
launch_count = {"fused_step": 0, "fused_step_bf16": 0, "fused_step_rng": 0,
                "fused_step_rng_bf16": 0, "threefry_mask": 0}

_lib = None


def _kernel_lib():
    """The built kernel library with its ctypes signatures declared."""
    global _lib
    if _lib is None:
        from . import _build
        lib = _build.load("fused_step")
        p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
        lib.pdmt_fused_step.argtypes = ([p, i, p, i, p, u, i] + [p] * 12
                                        + [i, f, p])
        lib.pdmt_fused_step.restype = i
        lib.pdmt_fused_rng_mask.argtypes = [u, i, i, p, p]
        lib.pdmt_fused_rng_mask.restype = i
        lib.pdmt_threefry_mask.argtypes = [u, u, i, p, p]
        lib.pdmt_threefry_mask.restype = i
        lib.pdmt_fused_step_scratch_per_row.argtypes = []
        lib.pdmt_fused_step_scratch_per_row.restype = i
        lib.pdmt_error_string.argtypes = [i]
        lib.pdmt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _kernel_lib().pdmt_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _weights(params):
    return (params["fc1"]["w"], params["fc1"]["b"], params["fc2"]["w"],
            params["fc2"]["b"], params["fc3"]["w"])


def _tree(w1, b1, w2, b2, w3):
    return {"fc1": {"w": w1, "b": b1}, "fc2": {"w": w2, "b": b2},
            "fc3": {"w": w3}}


_WEIGHT_SHAPES = ((IN_DIM, HIDDEN1), (HIDDEN1,), (HIDDEN1, HIDDEN2),
                  (HIDDEN2,), (HIDDEN2, NUM_CLASSES))
_WEIGHT_NAMES = ("fc1.w", "fc1.b", "fc2.w", "fc2.b", "fc3.w")


def _check_inputs(params, x, y, scaled_mask=None) -> None:
    """Raise ValueError on anything the kernel does not take. `x` is f32
    or bf16 (the bf16 mode); everything else is f32."""
    if x.dim() != 2 or x.shape[1] != IN_DIM or x.shape[0] < 1:
        raise ValueError(f"x must be (B >= 1, {IN_DIM}); got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16 (the bf16-operand "
                         f"mode); got {x.dtype}")
    batch = x.shape[0]
    named = [("x", x, (batch, IN_DIM))]
    if scaled_mask is not None:
        named.append(("scaled_mask", scaled_mask, (batch, HIDDEN1)))
    named += list(zip(_WEIGHT_NAMES, _weights(params), _WEIGHT_SHAPES))
    for name, t, shape in named:
        if name != "x" and t.dtype != torch.float32:
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


def _softmax_ce(logits, y):
    """(loss summed over rows, softmax - onehot) of the stable softmax
    cross-entropy, the kernels' own formulas."""
    mx = logits.amax(dim=1, keepdim=True)
    ex = torch.exp(logits - mx)
    se = ex.sum(dim=1, keepdim=True)
    classes = torch.arange(NUM_CLASSES, device=logits.device)
    onehot = (classes == y.long()[:, None]).to(logits.dtype)
    logit_y = torch.where(onehot > 0, logits, 0.0).sum(dim=1, keepdim=True)
    return ((mx + torch.log(se)) - logit_y).sum(), ex / se - onehot


@torch.no_grad()
def fused_loss_and_grads_reference(params, x, y, scaled_mask):
    """Plain PyTorch version of the f32 kernel, on any device: the same
    formulas written out (not autograd). Returns (mean loss, grads tree)."""
    w1, b1, w2, b2, w3 = (t.detach() for t in _weights(params))
    x = x.float()
    batch = x.shape[0]
    m = scaled_mask
    z1 = x @ w1 + b1
    d1 = torch.relu(z1) * m
    z2 = d1 @ w2 + b2
    h2 = torch.relu(z2)
    loss, dsm = _softmax_ce(h2 @ w3, y)
    dl = dsm * (1.0 / batch)
    gw3 = h2.T @ dl
    dz2 = (dl @ w3.T) * (z2 > 0).to(x.dtype)
    gw2 = d1.T @ dz2
    gb2 = dz2.sum(dim=0)
    dz1 = ((dz2 @ w2.T) * m) * (z1 > 0).to(x.dtype)
    gw1 = x.T @ dz1
    gb1 = dz1.sum(dim=0)
    return loss / batch, _tree(gw1, gb1, gw2, gb2, gw3)


def _bf(t: torch.Tensor) -> torch.Tensor:
    """An operand of a bf16 product: rounded to bf16 (nearest even), held
    in f32, where it is exact."""
    return t.to(torch.bfloat16).to(torch.float32)


@torch.no_grad()
def step_reference_bf16(params, x, y, scaled_mask):
    """Plain PyTorch version of the bf16-operand kernel (port of
    `step_reference_bf16`): every operand of the six products is rounded to
    bf16 and the products run as f32 matmuls (a product of two bf16 values
    is exact in f32; the caller keeps TF32 off on a card), at the kernels'
    cast points: x and the weights; d1, h2 and dl once where they are made;
    dz2 for dd1 and gw2, dz1 for gw1, while gb2 and gb1 sum them unrounded.
    Returns (mean loss, grads tree), f32."""
    w1, b1, w2, b2, w3 = (t.detach().float() for t in _weights(params))
    xm = _bf(x.float())
    batch = x.shape[0]
    m = scaled_mask
    z1 = xm @ _bf(w1) + b1
    d1m = _bf(torch.relu(z1) * m)
    z2 = d1m @ _bf(w2) + b2
    h2m = _bf(torch.relu(z2))
    w3m = _bf(w3)
    loss, dsm = _softmax_ce(h2m @ w3m, y)
    dlm = _bf(dsm * (1.0 / batch))
    gw3 = h2m.T @ dlm
    dz2 = (dlm @ w3m.T) * (z2 > 0).float()
    dz2m = _bf(dz2)
    gw2 = d1m.T @ dz2m
    gb2 = dz2.sum(dim=0)
    dz1 = ((dz2m @ _bf(w2).T) * m) * (z1 > 0).float()
    gw1 = xm.T @ _bf(dz1)
    gb1 = dz1.sum(dim=0)
    return loss / batch, _tree(gw1, gb1, gw2, gb2, gw3)


def _reference(params, x, y, scaled_mask):
    if x.dtype == torch.bfloat16:
        return step_reference_bf16(params, x, y, scaled_mask)
    return fused_loss_and_grads_reference(params, x, y, scaled_mask)


def _form(x, rng: bool) -> str:
    return ("fused_step" + ("_rng" if rng else "")
            + ("_bf16" if x.dtype == torch.bfloat16 else ""))


def _fused_cuda(params, x, y, scaled_mask, seed=None):
    """One launch pair of the kernel: the mask is `scaled_mask`, or drawn
    in the kernel from the uint32 step seed `seed`."""
    lib = _kernel_lib()
    batch = x.shape[0]
    y32 = y.to(torch.int32).contiguous()
    w1, b1, w2, b2, w3 = _weights(params)
    scratch = torch.empty(batch * lib.pdmt_fused_step_scratch_per_row(),
                          dtype=torch.float32, device=x.device)
    loss = torch.empty((), dtype=torch.float32, device=x.device)
    grads = [torch.empty_like(w) for w in (w1, b1, w2, b2, w3)]
    rng = seed is not None
    _, block = philox.batch_blocks(batch)
    with torch.cuda.device(x.device):
        err = lib.pdmt_fused_step(
            x.data_ptr(), int(x.dtype == torch.bfloat16), y32.data_ptr(),
            int(rng), None if rng else scaled_mask.data_ptr(),
            seed if rng else 0, block, w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), w3.data_ptr(), scratch.data_ptr(),
            loss.data_ptr(), *(g.data_ptr() for g in grads), batch,
            1.0 / batch, _stream(x.device))
    _raise_on(err, "fused_step kernel launch")
    launch_count[_form(x, rng)] += 1
    return loss, _tree(*grads)


def fused_loss_and_grads(params, x, y, scaled_mask):
    """(params tree, x (B, 784) f32 or bf16, y (B,) int, scaled_mask
    (B, 128) f32 in {0, 1/keep}) -> (mean loss, grads tree), f32. Any B >= 1.
    A bf16 `x` selects the bf16-operand mode.

    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    version. Parameters may require grad: no autograd graph is built."""
    _check_inputs(params, x, y, scaled_mask)
    if x.device.type == "cuda":
        return _fused_cuda(params, x, y, scaled_mask)
    if x.device.type == "cpu":
        return _reference(params, x, y, scaled_mask)
    raise ValueError(f"fused_loss_and_grads runs on cuda or cpu, not "
                     f"{x.device.type}")


def rng_seed(seed) -> int:
    """A step seed (an int, or the int32 bitcast of a key word, as JAX's
    `_loss_and_grads` makes it) as the kernel's uint32 key word."""
    return int(seed) & threefry.M32


def fused_loss_and_grads_rng(params, x, y, seed):
    """The kernel with its dropout mask drawn INSIDE it (`--kernel
    pallas_rng`): (params, x (B, 784) f32 or bf16, y (B,) int, seed (an
    int, taken mod 2**32)) -> (mean loss, grads tree).

    No (B, 128) mask tensor exists: each batch block of `_run_fused`'s grid
    draws the Philox block keyed (seed, block index)
    (ops/philox.py `rng_mask`), with the same keep rate and 1/keep scale as
    every other stream. It is the port's own stream, not the TPU core
    PRNG's. CUDA tensors launch the kernel (or raise); CPU tensors run the
    plain version on `philox.rng_mask(seed, B)`."""
    _check_inputs(params, x, y)
    seed = rng_seed(seed)
    if x.device.type == "cuda":
        return _fused_cuda(params, x, y, None, seed=seed)
    if x.device.type == "cpu":
        return _reference(params, x, y,
                          philox.rng_mask(seed, x.shape[0], x.device))
    raise ValueError(f"fused_loss_and_grads_rng runs on cuda or cpu, not "
                     f"{x.device.type}")


def kernel_rng_mask(seed, batch: int, device) -> torch.Tensor:
    """The (batch, 128) mask `fused_loss_and_grads_rng` draws for `seed`:
    on a CUDA device from the kernel's own device function (one small
    launch, not counted in launch_count), on the CPU from the plain
    version."""
    device = torch.device(device)
    seed = rng_seed(seed)
    if device.type == "cpu":
        return philox.rng_mask(seed, batch, device)
    if device.type != "cuda":
        raise ValueError(f"kernel_rng_mask runs on cuda or cpu, not "
                         f"{device.type}")
    lib = _kernel_lib()
    out = torch.empty((batch, HIDDEN1), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.pdmt_fused_rng_mask(seed, philox.batch_blocks(batch)[1],
                                      batch, out.data_ptr(), _stream(device))
    _raise_on(err, "fused_step rng mask kernel launch")
    return out


def dropout_mask(key, batch: int, device) -> torch.Tensor:
    """The pre-scaled (batch, 128) f32 mask jax's `dropout_mask(key,
    batch)` gives for the threefry key `key` ((k0, k1) key words): 0 or
    1.25. On a CUDA device one launch of the K3 threefry device function
    (counted as launch_count["threefry_mask"]); on the CPU ops/threefry.py.
    The two are bitwise equal."""
    device = torch.device(device)
    if device.type == "cpu":
        return threefry.dropout_mask(key, batch, device)
    if device.type != "cuda":
        raise ValueError(f"dropout_mask runs on cuda or cpu, not "
                         f"{device.type}")
    lib = _kernel_lib()
    k0, k1 = (int(w) & threefry.M32 for w in key)
    out = torch.empty((batch, HIDDEN1), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.pdmt_threefry_mask(k0, k1, batch, out.data_ptr(),
                                     _stream(device))
    _raise_on(err, "threefry mask kernel launch")
    launch_count["threefry_mask"] += 1
    return out


def make_fused_train_step(lr: float, *, dtype: str = "float32"):
    """The `--kernel pallas` step (counterpart of `make_pallas_train_step`):
    step(model, key, x, y) -> (key', mean loss as a 0-d device tensor).
    Splits the threefry key once (`key, sub = split(key)`), draws the mask
    `dropout_mask(sub)`, runs the fused step on x cast to `dtype` (bfloat16
    selects the kernel's bf16 mode), then SGD in place on the model's
    parameters."""
    compute_dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def step(model, key, x, y):
        key, sub = threefry.split(key)
        params = model.params()
        mask = dropout_mask(sub, x.shape[0], x.device)
        loss, grads = fused_loss_and_grads(params, x.to(compute_dt), y, mask)
        sgd_step(params, grads, lr)
        return key, loss

    return step


def make_pallas_dp_train_step(mesh, lr: float, *, dtype: str = "float32",
                              comm: str = "pmean"):
    """The data-parallel `--kernel pallas` step (JAX
    `make_pallas_dp_train_step`, comm='pmean'): step(model, key, x, y) ->
    (key', loss). The fused step (K1, or K1-bf16 with `dtype='bfloat16'`)
    runs once per replica of `mesh` on that replica's shard of the global
    batch x, with the mask of `fold_in(sub, replica)`; the gradients'
    fixed-order mean then feeds SGD, and the loss is the replicas' mean
    (parallel/ddp.py `dp_step`)."""
    from ..parallel.ddp import dp_step, validate_comm
    validate_comm(comm)
    compute_dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def loss_and_grads(params, x, y, mask):
        return fused_loss_and_grads(params, x.to(compute_dt), y, mask)

    return dp_step(tuple(mesh), lr, loss_and_grads)
