"""The fused train step: one call computes a step's loss and gradients.

Port of the K1 part of `pytorch_ddp_mnist_tpu/ops/pallas_step.py`
(`fused_loss_and_grads` / `fused_loss_and_grads_rng` -> `_run_fused` ->
`_make_fused_kernel`; `step_reference_bf16`; `dropout_mask`;
`make_pallas_train_step`, `make_pallas_dp_train_step`), in its four
forms and the keyed draw:

    K1            f32 x, pre-drawn mask
    K1-bf16       bf16 x: bf16 operands of the six products, f32
                  accumulation, f32 everything else (compute_bf16)
    K1-rng        the mask drawn in the kernel per (step seed, batch block)
                  from the port's Philox stream (ops/philox.py `rng_mask`);
                  the seed a host int, or word 0 of a key-table row on the
                  device (the device-seed form, which a captured step reads
                  at replay)
    K1-rng-bf16   both
    keyed         jax's threefry mask `dropout_mask(key, B)` drawn in the
                  kernel (K1-split, K1-mma), the key's words read from a
                  device key table: the `--kernel pallas` step

  * `fused_loss_and_grads(params, x, y, scaled_mask)`,
    `fused_loss_and_grads_rng(params, x, y, seed)` and
    `fused_loss_and_grads_keyed(params, x, y, key_words)` are the public
    entries (`seed` an int, or a key-table row: the device-seed form);
    a bf16 `x` selects the bf16 mode, as in JAX. For CUDA tensors they
    launch a hand-written kernel (no float atomics, bitwise repeatable) or
    raise; they never fall back. For CPU tensors, and only then, they run
    the plain version. `fused_design(x dtype, rng, batch)` picks one of
    three designs by form: 'split' (`csrc/fused_split.cu`: the chains
    spread over the card in three launches) for f32 x at B <=
    SPLIT_MAX_BATCH, the default trainer's step; 'mma' (`csrc/fused_mma.cu`:
    the six products on the tensor cores, bf16 operands accumulated in
    f32, in three launches) for bf16 x at B <= MMA_MAX_BATCH; 'rows'
    (`csrc/fused_step.cu`: two launches, 8 batch rows a block in the
    first) for larger batches in either type. 'split' and 'rows' compute
    the same bits; 'mma' sums in the tensor cores' order and is held to
    the JAX package's bf16 pins against the plain version.
  * `fused_loss_and_grads_reference` (f32) and `step_reference_bf16` spell
    out the same formulas in plain PyTorch (no autograd) on any device: the
    CPU tests hold them against the JAX kernel, and chip_smoke.py holds the
    CUDA kernel against them.
  * `dropout_mask(key, batch, device)` is the mask entry, jax's
    `dropout_mask(key, batch)` bit for bit: on a card one launch of the K3
    threefry device function (`csrc/mlp_step.cuh`), on the CPU
    ops/threefry.py. The `xla` steps draw their mask with it (autograd
    needs the tensor), the key read from the table (`keyed_dropout_mask`);
    the keyed step draws in K1-split and K1-mma instead, and with the mask
    entry only on the rows design, at B > 128.
  * `KeyedStep` is the step of the streaming loop (`pallas`, and with the
    mask entry `xla`): before an epoch's first step the loop loads its key
    table (ops/threefry.py `step_key_words`) into the static buffer its
    captured step reads (train/graphs.py), and step s reads row s.
  * `launch_count` counts wrapper calls that launched a kernel, one key per
    design and form (`fused_split`, `fused_split_rng`, `fused_split_keyed`
    for the split design; `fused_mma`, `fused_mma_rng`, `fused_mma_keyed`
    for the mma design; `fused_step`, `fused_step_rng`, `fused_step_bf16`,
    `fused_step_rng_bf16` for the rows design; `_rng_dev` in place of
    `_rng` for the device-seed forms; `threefry_mask` for the mask entry),
    so a run shows which design its steps went through. A step captured in
    a CUDA graph (train/graphs.py) adds its launches on every replay;
    `last_launch` names the last call's design and key.
    `split_phase_stamps(...)` and `mma_phase_stamps(...)` run a design's
    stamps build and return its per-phase split.

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

# f32 batches up to this many rows run the split design (fused_design):
# its gradient kernel holds the whole batch in shared memory
SPLIT_MAX_BATCH = 128
# bf16 batches up to this many rows run the mma design: its scratch and its
# gradient kernel's copy groups are sized for them
MMA_MAX_BATCH = 128

# wrapper calls that launched a CUDA kernel, per design and form
# (chip_smoke.py resets and reads them)
launch_count = {"fused_split": 0, "fused_split_rng": 0,
                "fused_split_rng_dev": 0, "fused_split_keyed": 0,
                "fused_mma": 0, "fused_mma_rng": 0, "fused_mma_rng_dev": 0,
                "fused_mma_keyed": 0, "fused_step": 0, "fused_step_bf16": 0,
                "fused_step_rng": 0, "fused_step_rng_bf16": 0,
                "fused_step_rng_dev": 0, "fused_step_rng_dev_bf16": 0,
                "threefry_mask": 0}
# the last launch's design ("split", "mma" or "rows") and launch_count key
last_launch = {"design": "", "form": ""}

_lib = None
_staged_libs = {}


def _kernel_lib():
    """The built kernel library with its ctypes signatures declared."""
    global _lib
    if _lib is None:
        from . import _build
        lib = _build.load("fused_step")
        p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
        lib.pdmt_fused_step.argtypes = ([p, i, p, i, p, p, u, i] + [p] * 12
                                        + [i, f, p])
        lib.pdmt_fused_step.restype = i
        lib.pdmt_fused_rng_mask.argtypes = [u, i, i, p, p]
        lib.pdmt_fused_rng_mask.restype = i
        lib.pdmt_threefry_mask.argtypes = [u, u, i, p, p]
        lib.pdmt_threefry_mask.restype = i
        lib.pdmt_threefry_mask_keyed.argtypes = [p, i, p, p]
        lib.pdmt_threefry_mask_keyed.restype = i
        lib.pdmt_fused_step_scratch_per_row.argtypes = []
        lib.pdmt_fused_step_scratch_per_row.restype = i
        lib.pdmt_error_string.argtypes = [i]
        lib.pdmt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# the designs that stage operands by TMA, in three launches: (x dtype, the
# largest batch, the library's default build)
_STAGED = {"split": (torch.float32, SPLIT_MAX_BATCH, "fused_split"),
           "mma": (torch.bfloat16, MMA_MAX_BATCH, "fused_mma")}


def _staged_lib(design: str, name: str = None):
    """Library `name` of the split or mma design (its default build unless
    `name` names its stamps build) with its ctypes signatures declared and
    its largest batch checked against this module's. Its entries are
    `pdmt_<design>_...`."""
    name = name or _STAGED[design][2]
    if name not in _staged_libs:
        from . import _build
        lib = _build.load(name)
        p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float

        def fn(entry, args, res=i):
            out = getattr(lib, f"pdmt_{design}_{entry}")
            out.argtypes, out.restype = args, res
            return out
        fn("step", [p, p, i, p, p, u, i] + [p] * 13 + [i, f, p])
        max_batch = fn("max_batch", [])
        fn("stamp_words", [])
        fn("scratch_floats", [i])
        fn("blocks", [i, p])
        lib.pdmt_error_string.argtypes = [i]
        lib.pdmt_error_string.restype = ctypes.c_char_p
        got, want = max_batch(), _STAGED[design][1]
        if got != want:
            raise RuntimeError(f"{name}: max batch {got}, expected {want}")
        _staged_libs[name] = lib
    return _staged_libs[name]


def _raise_on(err: int, what: str, lib) -> None:
    if err != 0:
        msg = lib.pdmt_error_string(err).decode()
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


def fused_design(x_dtype, rng: bool, batch: int) -> str:
    """The K1 design a launch runs: 'split' (csrc/fused_split.cu) for f32 x
    at batch <= SPLIT_MAX_BATCH, 'mma' (csrc/fused_mma.cu) for bf16 x at
    batch <= MMA_MAX_BATCH, with a mask or the in-kernel Philox draw (`rng`)
    alike; 'rows' (csrc/fused_step.cu) for larger batches. 'split' and
    'rows' give the same bits where both run."""
    del rng  # both dropout sources take the same design
    if x_dtype == torch.float32 and batch <= SPLIT_MAX_BATCH:
        return "split"
    if x_dtype == torch.bfloat16 and batch <= MMA_MAX_BATCH:
        return "mma"
    return "rows"


def _form(x, rng: bool, seed_words=None) -> str:
    return ("fused_step" + ("_rng" if rng else "")
            + ("_dev" if seed_words is not None else "")
            + ("_bf16" if x.dtype == torch.bfloat16 else ""))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a copy of it where its data does not start on 16 bytes (the
    split and mma designs' bulk and tensor copies): only a view at an odd
    offset does."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


# the kernels' codes for the mask's source (`pdmt_<design>_step` `rng`):
# read, Philox of a seed argument, threefry of the key at `key`, Philox of
# the seed at word 0 of `key`
_MASK, _PHILOX, _KEYED, _PHILOX_AT = 0, 1, 2, 3


def _staged_cuda(design, params, x, y, scaled_mask, seed=None, *,
                 key_words=None, seed_words=None, stamps=None, lib_name=None):
    """One call of the split or mma design (three launches), of its default
    build or the build `lib_name`, with the mask `scaled_mask`, drawn from
    the Philox seed `seed` or from the seed at word 0 of `seed_words`, or
    drawn from the threefry key at `key_words`; `stamps`, a zeroed int64
    tensor of the stamps build's words, receives its phase stamps."""
    dtype, max_batch, _ = _STAGED[design]
    batch = x.shape[0]
    if x.dtype != dtype or not 1 <= batch <= max_batch:
        raise ValueError(f"the {design} design takes {dtype} x at 1 <= B <= "
                         f"{max_batch}; got {x.dtype} B={batch}")
    lib = _staged_lib(design, lib_name)
    y32 = y.to(torch.int32).contiguous()
    w1, b1, w2, b2, w3 = _weights(params)
    x, w1, w2, w3 = _aligned(x), _aligned(w1), _aligned(w2), _aligned(w3)
    entry = f"pdmt_{design}_"
    scratch = torch.empty(getattr(lib, entry + "scratch_floats")(batch),
                          dtype=torch.float32, device=x.device)
    loss = torch.empty((), dtype=torch.float32, device=x.device)
    grads = [torch.empty_like(w) for w in (w1, b1, w2, b2, w3)]
    source = (_PHILOX if seed is not None else
              _PHILOX_AT if seed_words is not None else
              _KEYED if key_words is not None else _MASK)
    words = seed_words if source == _PHILOX_AT else key_words
    _, block = philox.batch_blocks(batch)
    with torch.cuda.device(x.device):
        err = getattr(lib, entry + "step")(
            x.data_ptr(), y32.data_ptr(), source,
            scaled_mask.data_ptr() if source == _MASK else None,
            words.data_ptr() if source in (_KEYED, _PHILOX_AT) else None,
            seed if source == _PHILOX else 0,
            block, w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), w3.data_ptr(), scratch.data_ptr(),
            loss.data_ptr(), *(g.data_ptr() for g in grads),
            None if stamps is None else stamps.data_ptr(), batch,
            1.0 / batch, _stream(x.device))
    _raise_on(err, f"fused_{design} kernel launch", lib)
    return loss, _tree(*grads)


def _fused_cuda(params, x, y, scaled_mask, seed=None, design=None,
                seed_words=None):
    """One call of the kernel: the mask is `scaled_mask`, or drawn in the
    kernel from the uint32 step seed `seed` or from the seed at word 0 of
    the key-table row `seed_words` (the device-seed form). `design`
    ('split', 'mma' or 'rows') overrides fused_design's choice."""
    rng = seed is not None or seed_words is not None
    design = design or fused_design(x.dtype, rng, x.shape[0])
    if design in _STAGED:
        loss, grads = _staged_cuda(design, params, x, y, scaled_mask, seed,
                                   seed_words=seed_words)
        key = (f"fused_{design}" + ("_rng" if rng else "")
               + ("_dev" if seed_words is not None else ""))
        launch_count[key] += 1
        last_launch.update(design=design, form=key)
        return loss, grads
    if design != "rows":
        raise ValueError(f"design must be 'split', 'mma' or 'rows', not "
                         f"{design!r}")
    lib = _kernel_lib()
    batch = x.shape[0]
    y32 = y.to(torch.int32).contiguous()
    w1, b1, w2, b2, w3 = _weights(params)
    scratch = torch.empty(batch * lib.pdmt_fused_step_scratch_per_row(),
                          dtype=torch.float32, device=x.device)
    loss = torch.empty((), dtype=torch.float32, device=x.device)
    grads = [torch.empty_like(w) for w in (w1, b1, w2, b2, w3)]
    _, block = philox.batch_blocks(batch)
    source = (_PHILOX_AT if seed_words is not None else
              _PHILOX if rng else _MASK)
    with torch.cuda.device(x.device):
        err = lib.pdmt_fused_step(
            x.data_ptr(), int(x.dtype == torch.bfloat16), y32.data_ptr(),
            source, None if rng else scaled_mask.data_ptr(),
            None if seed_words is None else seed_words.data_ptr(),
            seed if seed is not None else 0, block, w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), w3.data_ptr(), scratch.data_ptr(),
            loss.data_ptr(), *(g.data_ptr() for g in grads), batch,
            1.0 / batch, _stream(x.device))
    _raise_on(err, "fused_step kernel launch", lib)
    key = _form(x, rng, seed_words)
    launch_count[key] += 1
    last_launch.update(design=design, form=key)
    return loss, _tree(*grads)


def fused_loss_and_grads(params, x, y, scaled_mask, *, _design=None):
    """(params tree, x (B, 784) f32 or bf16, y (B,) int, scaled_mask
    (B, 128) f32 in {0, 1/keep}) -> (mean loss, grads tree), f32. Any B >= 1.
    A bf16 `x` selects the bf16-operand mode.

    CUDA tensors launch the kernel of `fused_design`'s design (or raise);
    `_design` forces one ('rows' is the card's yardstick for 'split' and
    'mma'). CPU tensors run the plain version. Parameters may require grad: no
    autograd graph is built."""
    _check_inputs(params, x, y, scaled_mask)
    if x.device.type == "cuda":
        return _fused_cuda(params, x, y, scaled_mask, design=_design)
    if x.device.type == "cpu":
        return _reference(params, x, y, scaled_mask)
    raise ValueError(f"fused_loss_and_grads runs on cuda or cpu, not "
                     f"{x.device.type}")


def rng_seed(seed) -> int:
    """A step seed (an int, or the int32 bitcast of a key word, as JAX's
    `_loss_and_grads` makes it) as the kernel's uint32 key word."""
    return int(seed) & threefry.M32


def fused_loss_and_grads_rng(params, x, y, seed, *, _design=None):
    """The kernel with its dropout mask drawn INSIDE it (`--kernel
    pallas_rng`): (params, x (B, 784) f32 or bf16, y (B,) int, seed) ->
    (mean loss, grads tree). `seed` is an int, taken mod 2**32, or (the
    device-seed form) a (2,) int32 key-table row on x's device
    (ops/threefry.py `step_key_words`) whose word 0 the kernel reads as the
    seed, so a step captured in a CUDA graph draws the seed the table holds
    at replay; the two forms are bitwise equal for the same word.

    No (B, 128) mask tensor exists: each batch block of `_run_fused`'s grid
    draws the Philox block keyed (seed, block index)
    (ops/philox.py `rng_mask`), with the same keep rate and 1/keep scale as
    every other stream. It is the port's own stream, not the TPU core
    PRNG's. CUDA tensors launch the kernel of `fused_design`'s design (or
    raise; `_design` forces one); CPU tensors run the plain version on
    `philox.rng_mask(seed, B)` of the seed (the row's word 0)."""
    _check_inputs(params, x, y)
    seed_words = None
    if isinstance(seed, torch.Tensor):
        _check_key_words(seed, x.device)
        seed_words = seed
    else:
        seed = rng_seed(seed)
    if x.device.type == "cuda":
        if seed_words is not None:
            return _fused_cuda(params, x, y, None, design=_design,
                               seed_words=seed_words)
        return _fused_cuda(params, x, y, None, seed=seed, design=_design)
    if x.device.type == "cpu":
        if seed_words is not None:
            seed = rng_seed(seed_words[0])
        return _reference(params, x, y,
                          philox.rng_mask(seed, x.shape[0], x.device))
    raise ValueError(f"fused_loss_and_grads_rng runs on cuda or cpu, not "
                     f"{x.device.type}")


def _check_key_words(key_words, device) -> None:
    """Raise ValueError unless `key_words` is a row of a key table: (2,)
    int32 on `device`, contiguous, on 8 bytes (the kernels read the two
    words with one load)."""
    if not isinstance(key_words, torch.Tensor) or \
            tuple(key_words.shape) != (2,) or key_words.dtype != torch.int32:
        raise ValueError(f"key_words must be a (2,) int32 tensor (a row of "
                         f"threefry.step_key_table); got {key_words!r}")
    if key_words.device != device:
        raise ValueError(f"key_words is on {key_words.device}, x on {device}")
    if key_words.stride() != (1,) or key_words.data_ptr() % 8:
        raise ValueError("key_words must be contiguous and start on 8 bytes "
                         "(a row of a contiguous key table)")


def keyed_dropout_mask(key_words, batch: int, device) -> torch.Tensor:
    """`dropout_mask` of the key at `key_words` (a key-table row on
    `device`): on a card one launch of the mask entry reading the key from
    device memory (counted as launch_count["threefry_mask"]), on the CPU
    `dropout_mask` of its words. The two are bitwise equal."""
    device = torch.device(device)
    _check_key_words(key_words, device)
    if device.type == "cpu":
        return dropout_mask(threefry.words_key(key_words), batch, device)
    if device.type != "cuda":
        raise ValueError(f"keyed_dropout_mask runs on cuda or cpu, not "
                         f"{device.type}")
    lib = _kernel_lib()
    out = torch.empty((batch, HIDDEN1), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.pdmt_threefry_mask_keyed(key_words.data_ptr(), batch,
                                           out.data_ptr(), _stream(device))
    _raise_on(err, "keyed threefry mask kernel launch", lib)
    launch_count["threefry_mask"] += 1
    return out


def _keyed_cuda(params, x, y, key_words, design=None):
    """One keyed call: K1-split or K1-mma drawing the mask in the kernel
    (counted as `fused_<design>_keyed`); on the rows design (B > 128, or
    forced) the mask entry reads the key and the rows design takes the
    mask."""
    design = design or fused_design(x.dtype, False, x.shape[0])
    if design not in _STAGED:
        mask = keyed_dropout_mask(key_words, x.shape[0], x.device)
        return _fused_cuda(params, x, y, mask, design=design)
    loss, grads = _staged_cuda(design, params, x, y, None,
                               key_words=key_words)
    key = f"fused_{design}_keyed"
    launch_count[key] += 1
    last_launch.update(design=design, form=key)
    return loss, grads


def fused_loss_and_grads_keyed(params, x, y, key_words, *, _design=None):
    """The kernel with jax's threefry mask `dropout_mask(key, B)` drawn
    INSIDE it (the `--kernel pallas` step): (params, x (B, 784) f32 or bf16,
    y (B,) int, key_words (2,) int32, a row of a key table on x's device
    (ops/threefry.py `step_key_table`)) -> (mean loss, grads tree).

    CUDA tensors launch the design `fused_design` picks: K1-split or K1-mma
    read the key's words from device memory and draw the mask in their
    hidden phase, so no mask tensor, no mask launch and no host key exist;
    at B > 128 the rows design takes the mask of `keyed_dropout_mask`. A
    form that cannot build or launch raises; nothing falls back. `_design`
    forces a design ('rows': the mask entry + the rows design). CPU
    tensors run the plain version on `dropout_mask(key, B)`. Bitwise, on
    each design, `fused_loss_and_grads` with the mask entry's mask."""
    _check_inputs(params, x, y)
    _check_key_words(key_words, x.device)
    if x.device.type == "cuda":
        return _keyed_cuda(params, x, y, key_words, design=_design)
    if x.device.type == "cpu":
        return _reference(params, x, y,
                          dropout_mask(threefry.words_key(key_words),
                                       x.shape[0], x.device))
    raise ValueError(f"fused_loss_and_grads_keyed runs on cuda or cpu, not "
                     f"{x.device.type}")


# the phases between the split design's stamps (csrc/fused_split.cu
# `Stamp`), in order
SPLIT_PHASES = ("hidden: z1, mask, d1", "gap to the rows launch",
                "rows: w2 in, z2, h2", "rows: logits, softmax, dl",
                "rows: dz2, dd1, dz1", "gap to the grads launch",
                "grads: gw1, gw2, gw3, biases, loss")
# the same of the mma design (csrc/fused_mma.cu `Stamp`)
MMA_PHASES = ("hidden: z1, mask, d1, w2 and w3 to bf16",
              "gap to the rows launch", "rows: w2 in, z2, h2",
              "rows: logits, softmax, dl", "rows: dh2, dz2, dd1, dz1",
              "gap to the grads launch", "grads: gw1, gw2, gw3, biases, loss")
_PHASES = {"split": SPLIT_PHASES, "mma": MMA_PHASES}


def _phase_stamps(design, params, x, y, scaled_mask, seed, calls,
                  key_words=None):
    """`calls` calls of `design`'s stamps build (`-D<DESIGN>_STAMPS`,
    ops/_build.py VARIANTS) on CUDA tensors, with the mask `scaled_mask`,
    the in-kernel Philox draw of `seed` or the keyed draw of `key_words`;
    not counted in launch_count. Returns
    (loss, grads) of the last call, {phase: us} for the design's phases
    averaged over the calls, and the mean us from the hidden kernel's start
    to the grads kernel's end."""
    _check_inputs(params, x, y, scaled_mask)
    if key_words is not None:
        _check_key_words(key_words, x.device)
    if x.device.type != "cuda" or fused_design(x.dtype, seed is not None,
                                               x.shape[0]) != design:
        raise ValueError(f"{design}_phase_stamps runs the {design} design's "
                         f"forms on CUDA tensors")
    seed = None if seed is None else rng_seed(seed)
    name = f"fused_{design}_stamps"
    n = getattr(_staged_lib(design, name), f"pdmt_{design}_stamp_words")()
    stamps = torch.zeros((calls, n), dtype=torch.int64, device=x.device)
    for i in range(calls):
        out = _staged_cuda(design, params, x, y, scaled_mask, seed,
                           key_words=key_words, stamps=stamps[i],
                           lib_name=name)
    t = stamps.double()
    per_phase = (t[:, 1:] - t[:, :-1]).mean(dim=0) / 1e3
    total = float((t[:, -1] - t[:, 0]).mean()) / 1e3
    return (out[0], out[1], dict(zip(_PHASES[design], per_phase.tolist())),
            total)


def split_phase_stamps(params, x, y, scaled_mask=None, seed=None, *,
                       key_words=None, calls: int = 20):
    """The split design's per-phase split (f32 x, B <= SPLIT_MAX_BATCH),
    from its stamps build: see _phase_stamps."""
    return _phase_stamps("split", params, x, y, scaled_mask, seed, calls,
                         key_words)


def mma_phase_stamps(params, x, y, scaled_mask=None, seed=None, *,
                     key_words=None, calls: int = 20):
    """The mma design's per-phase split (bf16 x, B <= MMA_MAX_BATCH), from
    its stamps build: see _phase_stamps."""
    return _phase_stamps("mma", params, x, y, scaled_mask, seed, calls,
                         key_words)


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
    _raise_on(err, "fused_step rng mask kernel launch", lib)
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
    _raise_on(err, "threefry mask kernel launch", lib)
    launch_count["threefry_mask"] += 1
    return out


class KeyedStep:
    """A train step of the streaming loop (`--kernel pallas` or `xla`,
    serial or data parallel), whose dropout keys come from a key table on
    the device:

      step.key_words(key, nsteps) -> (key after the steps, host words):
          the epoch's keys (ops/threefry.py `step_key_words`, with the
          step's `fold` of global replica indices), which train/loop.py
          `fit` loads into the static key buffer of its captured step;
      step.key_table(key, nsteps, device) -> (key after the steps, table):
          the same words copied to the device once, for the loops that run
          eagerly;
      step.run(model, words, x, y) -> loss: one step on row s of the table
          (a (2,) row, or (n, 2) for n replicas), SGD in place on the
          model's parameters; it reads its key from device memory only, so
          it can be captured in a CUDA graph;
      step(model, key, x, y) -> (key', loss): one step from a host key (a
          one-row table), for callers that step one at a time.

    A data-parallel step carries its mesh as `ddp_mesh` (parallel/ddp.py)."""

    def __init__(self, run, fold=None):
        self.run = run
        self.fold = fold

    def key_words(self, key, nsteps: int, start: int = 0):
        return threefry.step_key_words(key, nsteps, self.fold, start)

    def key_table(self, key, nsteps: int, device, start: int = 0):
        return threefry.step_key_table(key, nsteps, device, self.fold, start)

    def __call__(self, model, key, x, y):
        key, table = self.key_table(key, 1, x.device)
        return key, self.run(model, table[0], x, y)


def make_fused_train_step(lr: float, *, dtype: str = "float32") -> KeyedStep:
    """The `--kernel pallas` step (counterpart of `make_pallas_train_step`)
    as a KeyedStep: per step `key, sub = split(key)` (the table's row), the
    fused step on x cast to `dtype` (bfloat16 selects the kernel's bf16
    mode) with the mask of `sub` drawn in the kernel
    (`fused_loss_and_grads_keyed`), then SGD in place on the model's
    parameters. `step(model, key, x, y) -> (key', loss)` as before; the
    loops run an epoch's rows of its key table."""
    compute_dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def run(model, words, x, y):
        params = model.params()
        loss, grads = fused_loss_and_grads_keyed(params, x.to(compute_dt), y,
                                                 words)
        sgd_step(params, grads, lr)
        return loss

    return KeyedStep(run)


def make_pallas_dp_train_step(mesh, lr: float, *, dtype: str = "float32",
                              comm: str = "pmean",
                              bf16_rounding: str = "nearest") -> KeyedStep:
    """The data-parallel `--kernel pallas` step (JAX
    `make_pallas_dp_train_step`) as a KeyedStep: the fused step (K1-split,
    or K1-mma with `dtype='bfloat16'`) runs once per local replica of
    `mesh` on that replica's shard of this process's batch x, with the
    mask of `fold_in(sub, global replica index)` drawn in the kernel (the
    key table's row (s, r)); the gradients' mean over the mesh's world by
    `comm`'s strategy (`pmean`, `sharded` or `bf16`; parallel/
    collectives.py `DPComm`) then feeds SGD, and the loss is the world's
    mean (parallel/ddp.py `dp_keyed_step`). `int8` carries error-feedback
    state the fused DP step does not thread, and is refused by name, as
    in JAX."""
    from ..parallel import collectives
    from ..parallel.ddp import dp_keyed_step
    from ..parallel.mesh import as_mesh
    if comm == "int8":
        raise ValueError(
            "comm='int8' carries error-feedback state the fused Pallas DP "
            "step does not thread; use kernel='xla' "
            "(parallel.ddp.make_dp_train_step) for the int8 strategy")
    compute_dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    mesh = as_mesh(mesh)

    def loss_and_grads(params, x, y, words):
        return fused_loss_and_grads_keyed(params, x.to(compute_dt), y, words)

    return dp_keyed_step(mesh, lr, loss_and_grads,
                         collectives.DPComm(mesh, lr, comm,
                                            bf16_rounding=bf16_rounding))
