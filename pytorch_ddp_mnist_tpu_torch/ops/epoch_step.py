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

With `axis_size=n > 1` it is the DP form (K6, `_make_epoch_kernel` with
`n_devices > 1`): n replicas each run the epoch on their own rows and
masks, and every step's gradients are averaged by a ring inside the launch
(`ring="allgather"`: every replica sums the n origin slots in origin
order; `"reduce_scatter"`: chunk c of the packed gradient is summed along
one chain from replica c, then the finished chunks are broadcast), then
each replica applies `w -= lr * (sum * f32(1/n))`. The replicas end every
step with bitwise the same weights. The ring's summation trees are the
TPU kernel's, element by element: the gradients are packed in its row
layout (`_COMM_LAYOUT`, `EPOCH_COMM_ROWS`, `_rs_chunk_rows`), gw3's rows
10 wide instead of padded to 128.

  * `epoch_fused_sgd(...)` is the public entry. CUDA tensors launch a
    hand-written kernel (one cooperative launch per epoch, no float
    atomics, bitwise repeatable) or raise; it never falls back. CPU
    tensors, and only they, run `epoch_fused_sgd_reference`.
    `epoch_design(x dtype, bf16, batch)` picks one of three designs by
    form: 'ws' (`csrc/epoch_ws.cu`, K2-ws: the weights held in the SMs'
    shared memory, one block per group of hidden units) for uint8 rows in
    f32 at B <= WS_MAX_BATCH; 'mma' (`csrc/epoch_mma.cu`, K2-mma: K1-mma's
    three tensor-core phases a step with SGD folded in, bitwise K1-mma +
    SGD per step) for uint8 rows in the bf16 mode at B <= MMA_MAX_BATCH;
    'rows' (`csrc/epoch_step.cu`) for f32 rows and larger batches. 'ws'
    and 'rows' compute the same bits; 'mma' is held to the JAX bf16 pins
    against them. `_epoch_fused_sgd_rows` launches the 'rows' design on
    any inputs, so a card can hold the others against it.
  * `epoch_fused_sgd_reference` is the plain version on any device: a loop
    of `fused_loss_and_grads_reference` + `sgd_step` with the same masks.
  * `launch_count` counts wrapper calls that launched the epoch kernel,
    one key per form: `epoch_step_ws` (K2-ws, any K), `epoch_step_mma`
    (K2-mma, any K), and for the 'rows' design `epoch_step` (f32, K = 1),
    `epoch_step_bf16`, `epoch_step_superstep` (K > 1) and
    `epoch_step_superstep_bf16`.
  * `kernel_mask_block(...)` returns the mask the kernel draws at one step
    (on CUDA from the kernel's own device function), so a card can compare
    the in-kernel streams with the plain ones bit for bit;
    `kernel_pixel_table(device)` the 256-entry normalise table K2-ws fills,
    `pixel_table_bf16(device)` the bf16 one K2-mma converts its rows
    through; `ws_phase_stamps(...)` and `mma_epoch_phase_stamps(...)` run
    a design's stamps build and return its per-phase times.
  * `epoch_dp_sgd_reference` is K6's plain version: each replica's step,
    then the ring's exact summation tree (`ring_mean`), then SGD.
    `ring_design(x dtype, bf16, batch, n)` picks K6's design: 'ws'
    (`csrc/ring_ws.cu`, K6-ws: K2-ws's column-owner step on each replica,
    one mini-ring per column owner, bitwise the rows design's ring) for
    uint8 rows in f32 at B <= WS_MAX_BATCH and n <= RING_WS_MAX_REPLICAS;
    'mma' (`csrc/ring_mma.cu`, K6-mma: K2-mma's tensor-core step on each
    replica, one mini-ring per gradient-tile owner, bitwise K1-mma per
    replica + the ring tree + SGD) for uint8 rows in the bf16 mode at B <=
    MMA_MAX_BATCH and n <= RING_MMA_MAX_REPLICAS; else 'rows'
    (`csrc/epoch_step.cu` `ring_kernel`); `_design="rows"` forces the
    latter. `ring_mean_by_owner` and `ring_mean_by_grads_owner` are the
    plain versions of K6-ws's and K6-mma's schedules (tests only).
    `launch_count` counts K6 as `epoch_step_dp_ws_<ring>` (K6-ws),
    `epoch_step_dp_mma_<ring>` (K6-mma), `epoch_step_dp_<ring>` (the rows
    design; `_bf16` for its bf16 mode), ring `allgather` or
    `reduce_scatter`. `stalled_ring(...)` launches K6 with one replica that
    never signals, to show that a ring wait ends in `RingTimeoutError`, not
    a hang; `k6_phase_stamps(...)` and `k6_mma_phase_stamps(...)` run
    K6-ws's and K6-mma's stamps builds and return their per-phase splits.

The input params are never written: the kernel copies them to new output
tensors first, as the TPU kernel does at its step 0.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..data.mnist import device_normalize
from . import philox, threefry
from .fused_step import (HIDDEN1, HIDDEN2, IN_DIM, MMA_MAX_BATCH, NUM_CLASSES,
                         _WEIGHT_NAMES, _WEIGHT_SHAPES, _tree, _weights,
                         fused_loss_and_grads_reference, step_reference_bf16)
from .sgd import sgd_step

# Largest per-step batch of the JAX epoch kernel (one VMEM block per step);
# kept so that the port accepts and refuses the same inputs.
EPOCH_KERNEL_MAX_BATCH = 1024
# The JAX kernel keeps the threefry key table in SMEM and caps it; the port
# keeps the cap for the same reason of parity (its table is in global memory).
EPOCH_KERNEL_MAX_RNG_STEPS = 4096

_RNG_CODE = {"masks": 0, "threefry": 1, "core": 2}

STEPS_PER_ITER = (1, 2, 4, 8)

# K2-ws takes a step's rows into one block's shared memory, one row per
# thread of its first half: batches up to this size run it (epoch_design)
WS_MAX_BATCH = 128
# K2-ws's normalise table holds one copy per lane of a warp
WS_TABLE_COPIES = 32
# the shared memory a block may use on the card (227 KB)
WS_SMEM_LIMIT = 232448
# K6-ws runs every replica's G = 128 / COLS blocks at one block an SM, COLS
# growing with n (ring_ws_cols); its COLS fits beside the table up to here
RING_WS_MAX_REPLICAS = 4


def ws_smem_bytes(cols: int) -> int:
    """The shared memory of a block of K2-ws's step at `cols` hidden units
    a block (csrc/ws_step.cuh `Shape::SMEM_BYTES`): the step's uint8 rows,
    the exchange rows (LD = 132 floats), the per-lane table, w1's columns,
    w2's rows, w2's columns (overlaid by the mask and the row losses), w3
    in chunks (W3C = 44), the logits (LG = 12, overlaid by dz1), d1 and the
    biases."""
    b, h = WS_MAX_BATCH, HIDDEN1
    return b * IN_DIM + 4 * (b * (h + 4) + 256 * WS_TABLE_COPIES
                             + cols * IN_DIM + cols * h
                             + max(cols * h, cols * b, b)
                             + (h // 4) * (4 * NUM_CLASSES + 4)
                             + max(b * 12, cols * b) + cols * b + 2 * cols)


def ring_ws_cols(n: int) -> int:
    """The hidden units a K6-ws block owns at n replicas: the least of 2,
    4, 8 with n * (128 / COLS) <= 128 blocks (0 past 8)."""
    return next((c for c in (2, 4, 8) if n <= c), 0)

# K2-mma (csrc/epoch_mma.cu) takes uint8 bf16 batches up to MMA_MAX_BATCH
# rows (K1-mma's). Its blocks are the hidden phase's, MMA_EPOCH_THREADS
# threads; its grid is MMA_EPOCH_UNIT_BLOCKS hidden tiles per 16 rows of
# the batch or the MMA_EPOCH_GRADS_BLOCKS of the gradient phase, whichever
# is more (mma_epoch_blocks)
MMA_EPOCH_THREADS = 224
MMA_EPOCH_UNIT_BLOCKS = 16
MMA_EPOCH_GRADS_BLOCKS = 66


def mma_epoch_blocks(batch: int) -> int:
    """The blocks of a K2-mma launch at `batch` rows a step."""
    return max(MMA_EPOCH_UNIT_BLOCKS * -(-batch // 16), MMA_EPOCH_GRADS_BLOCKS)


def mma_epoch_smem_bytes() -> int:
    """The dynamic shared memory of a K2-mma or K6-mma block
    (csrc/mma_step.cuh EPOCH_SMEM): the phases overlay one region, the
    largest of the hidden tile's (x chunks 7 x 16 x 120 bf16, w1 chunks 7 x
    112 x 8 f32, partial sums 7 x 16 x 8 f32), the rows tile's (w2 128 x
    136 and w3 128 x 24 in bf16, three 16 x 136 activation tiles and dl 16
    x 24 in bf16, logits 16 x 16 f32) and the grads tile's (a 128 x 136 and
    a 128 x 24 bf16 box, 128 row losses); then their 7 + 4 + 4 mbarriers."""
    hidden = 7 * (16 * 120 * 2 + 112 * 8 * 4) + 4 * 7 * 16 * 8
    rows = (2 * HIDDEN1 * 136 + 2 * HIDDEN2 * 24 + 3 * 2 * 16 * 136
            + 2 * 16 * 24 + 4 * 16 * 16)
    grads = 2 * MMA_MAX_BATCH * 136 + 2 * MMA_MAX_BATCH * 24 + 4 * MMA_MAX_BATCH
    return max(hidden, rows, grads) + 8 * (7 + 4 + 4)


# K6-mma (csrc/ring_mma.cu) runs K2-mma's step on every replica on the
# gradient phase's MMA_EPOCH_GRADS_BLOCKS blocks, which own the ring's
# slices; four replicas of them are co-resident at two blocks an SM, and
# its kernel parameter holds four replicas' tensor maps
RING_MMA_MAX_REPLICAS = 4
RING_MMA_BLOCKS = MMA_EPOCH_GRADS_BLOCKS


def ring_mma_flags_per_replica(n: int, rs: bool) -> int:
    """A K6-mma replica's flag counters: its barrier's, then per ring block
    the entry barrier's, the handshake's from each side, hop 0's, and one
    per thread for each later hop."""
    hops = (2 if rs else 1) * (n - 1)
    return 1 + RING_MMA_BLOCKS * (4 + max(hops - 1, 0) * MMA_EPOCH_THREADS)

# ---- the DP form (K6) ----
RINGS = ("auto", "allgather", "reduce_scatter")
# The JAX kernel keeps one comm slot per replica in VMEM for the all-gather
# ring and switches to the reduce-scatter ring past this many replicas
# ('auto'); the port keeps the switch and the refusal for parity.
EPOCH_KERNEL_MAX_DEVICES = 8
# the TPU's packed gradient block: (row offset, rows) of gw1, gb1, gw2, gb2
# and gw3, in pack order; rows are 128 wide (gw3's padded classes)
PADDED_CLASSES = 128
_COMM_LAYOUT = (
    (0, IN_DIM),                                # gw1 rows [0, 784)
    (IN_DIM, 1),                                # gb1 [784]
    (IN_DIM + 1, HIDDEN2),                      # gw2 [785, 913)
    (IN_DIM + 1 + HIDDEN2, 1),                  # gb2 [913]
    (IN_DIM + 2 + HIDDEN2, PADDED_CLASSES),     # gw3 [914, 1042)
)
EPOCH_COMM_ROWS = _COMM_LAYOUT[-1][0] + _COMM_LAYOUT[-1][1]   # 1042
# the port packs the same rows unpadded: gw3's rows are NUM_CLASSES wide,
# so the packed block is the weights' own concatenation, w1|b1|w2|b2|w3
N_PARAMS = (IN_DIM * HIDDEN1 + HIDDEN1 + HIDDEN1 * HIDDEN2 + HIDDEN2
            + HIDDEN2 * NUM_CLASSES)                           # 118,272
# the bound of every wait of K6's ring, in seconds: a wait past it ends the
# launch with RingTimeoutError
RING_TIMEOUT_S = 5.0

# wrapper calls that launched the CUDA kernel, per form (chip_smoke.py resets
# and reads them)
launch_count = {"epoch_step_ws": 0, "epoch_step_mma": 0, "epoch_step": 0,
                "epoch_step_bf16": 0,
                "epoch_step_superstep": 0, "epoch_step_superstep_bf16": 0,
                "epoch_step_dp_ws_allgather": 0,
                "epoch_step_dp_ws_reduce_scatter": 0,
                "epoch_step_dp_mma_allgather": 0,
                "epoch_step_dp_mma_reduce_scatter": 0,
                "epoch_step_dp_allgather": 0,
                "epoch_step_dp_allgather_bf16": 0,
                "epoch_step_dp_reduce_scatter": 0,
                "epoch_step_dp_reduce_scatter_bf16": 0}
# what the last launch ran: its design ("ws", "mma" or "rows"), its blocks
# (per replica for K6), the hidden units a block owns (K2-ws, K6-ws; 0
# otherwise), its form ("<uint8|f32>/<masks|threefry|core>"), bf16 mode,
# steps per iteration, whether it staged its rows, its replicas and ring
# ("" for K2), for reports and checks
last_launch = {"design": "", "blocks": 0, "cols": 0, "form": "",
               "bf16": False, "steps_per_iter": 1, "staged": False,
               "replicas": 1, "ring": ""}


class RingTimeoutError(RuntimeError):
    """A wait of K6's ring passed its bound: a replica never received what
    it waited for. The message names the wait, the replica, step and hop."""

_lib = None
_ws_libs = {}
_mma_libs = {}
_ring_ws_libs = {}
_ring_mma_libs = {}


def epoch_design(x_dtype, compute_bf16: bool, batch: int) -> str:
    """The K2 design a single-replica launch runs: 'ws' (K2-ws) for uint8
    rows in f32 at batch <= WS_MAX_BATCH, 'mma' (K2-mma) for uint8 rows in
    the bf16 mode at batch <= MMA_MAX_BATCH, else 'rows' (the design of
    csrc/epoch_step.cu). This picks by form, never on failure."""
    if x_dtype == torch.uint8:
        if not compute_bf16 and batch <= WS_MAX_BATCH:
            return "ws"
        if compute_bf16 and batch <= MMA_MAX_BATCH:
            return "mma"
    return "rows"


def ring_design(x_dtype, compute_bf16: bool, batch: int, n: int) -> str:
    """The K6 design an n-replica launch runs: 'ws' (K6-ws) for uint8 rows
    in f32 at batch <= WS_MAX_BATCH when COLS(n) fits in shared memory
    (n <= RING_WS_MAX_REPLICAS: n * 128 / COLS blocks, one an SM); 'mma'
    (K6-mma) for uint8 rows in the bf16 mode at batch <= MMA_MAX_BATCH and
    n <= RING_MMA_MAX_REPLICAS; else 'rows' (the ring of csrc/epoch_step.cu:
    f32 rows, larger batches and more replicas). This picks by form, never
    on failure. (n = 1 reaches no ring: `_epoch_dp` runs the serial kernel.)"""
    if x_dtype == torch.uint8:
        cols = ring_ws_cols(n)
        if (not compute_bf16 and batch <= WS_MAX_BATCH and cols
                and ws_smem_bytes(cols) <= WS_SMEM_LIMIT):
            return "ws"
        if (compute_bf16 and batch <= MMA_MAX_BATCH
                and n <= RING_MMA_MAX_REPLICAS):
            return "mma"
    return "rows"


def _ring_mma_lib(name: str = "ring_mma"):
    """The K6-mma library `name` (the default build, or its stamps build of
    ops/_build.py VARIANTS) with its ctypes signatures declared and its
    constants checked against this module's."""
    if name not in _ring_mma_libs:
        from . import _build
        lib = _build.load(name)
        p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
        lib.pdmt_ring_mma_step.argtypes = [p, p, p, p, i, i, i, u, i, i, f, f,
                                           f, i, ctypes.c_ulonglong, i, p, p,
                                           p]
        lib.pdmt_ring_mma_step.restype = i
        for fn in ("pdmt_ring_mma_n_params", "pdmt_ring_mma_table_fields",
                   "pdmt_ring_mma_max_batch", "pdmt_ring_mma_threads",
                   "pdmt_ring_mma_max_replicas", "pdmt_ring_mma_blocks",
                   "pdmt_ring_mma_smem_bytes", "pdmt_ring_mma_stamp_words"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i
        for fn in ("pdmt_ring_mma_scratch_bytes", "pdmt_ring_mma_owner_lo",
                   "pdmt_ring_mma_owner_len"):
            getattr(lib, fn).argtypes = [i]
            getattr(lib, fn).restype = i
        for fn in ("pdmt_ring_mma_flags_per_replica",
                   "pdmt_ring_mma_stamps_used"):
            getattr(lib, fn).argtypes = [i, i]
            getattr(lib, fn).restype = i
        lib.pdmt_ring_mma_coresident.argtypes = [i, ctypes.POINTER(i)]
        lib.pdmt_ring_mma_coresident.restype = i
        lib.pdmt_ring_mma_error_string.argtypes = [i]
        lib.pdmt_ring_mma_error_string.restype = ctypes.c_char_p
        top = RING_MMA_MAX_REPLICAS
        got = (lib.pdmt_ring_mma_n_params(), lib.pdmt_ring_mma_table_fields(),
               lib.pdmt_ring_mma_max_batch(), lib.pdmt_ring_mma_threads(),
               lib.pdmt_ring_mma_max_replicas(), lib.pdmt_ring_mma_blocks(),
               lib.pdmt_ring_mma_smem_bytes(),
               [lib.pdmt_ring_mma_flags_per_replica(n, rs)
                for n in range(1, top + 1) for rs in (0, 1)],
               [(lib.pdmt_ring_mma_owner_lo(b), lib.pdmt_ring_mma_owner_len(b))
                for b in range(RING_MMA_BLOCKS)])
        want = (N_PARAMS, 11, MMA_MAX_BATCH, MMA_EPOCH_THREADS, top,
                RING_MMA_BLOCKS, mma_epoch_smem_bytes(),
                [ring_mma_flags_per_replica(n, rs)
                 for n in range(1, top + 1) for rs in (0, 1)],
                grads_owner_ranges())
        if got != want:
            raise RuntimeError(f"{name}: params, table fields, max batch, "
                               f"threads, max replicas, blocks, shared "
                               f"memory, flags and owner slices {got}; "
                               f"expected {want}")
        _ring_mma_libs[name] = lib
    return _ring_mma_libs[name]


def _ring_ws_lib(name: str = "ring_ws"):
    """The K6-ws library `name` (the default build, or its stamps build of
    ops/_build.py VARIANTS) with its ctypes signatures declared and its
    constants checked against this module's."""
    if name not in _ring_ws_libs:
        from . import _build
        lib = _build.load(name)
        p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
        lib.pdmt_ring_ws_step.argtypes = [p, p, p, i, i, i, u, i, i, f, f, f,
                                          i, ctypes.c_ulonglong, i, p,
                                          ctypes.POINTER(i), ctypes.POINTER(i),
                                          p]
        lib.pdmt_ring_ws_step.restype = i
        for fn in ("pdmt_ring_ws_n_params", "pdmt_ring_ws_table_fields",
                   "pdmt_ring_ws_max_batch", "pdmt_ring_ws_max_replicas",
                   "pdmt_ring_ws_stamp_words"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i
        for fn in ("pdmt_ring_ws_cols", "pdmt_ring_ws_smem_bytes",
                   "pdmt_ring_ws_scratch_floats"):
            getattr(lib, fn).argtypes = [i]
            getattr(lib, fn).restype = i
        for fn in ("pdmt_ring_ws_flags_per_replica",
                   "pdmt_ring_ws_stamps_used"):
            getattr(lib, fn).argtypes = [i, i]
            getattr(lib, fn).restype = i
        lib.pdmt_ring_ws_coresident.argtypes = [i, i, ctypes.POINTER(i)]
        lib.pdmt_ring_ws_coresident.restype = i
        lib.pdmt_ring_ws_error_string.argtypes = [i]
        lib.pdmt_ring_ws_error_string.restype = ctypes.c_char_p
        got = (lib.pdmt_ring_ws_n_params(), lib.pdmt_ring_ws_table_fields(),
               lib.pdmt_ring_ws_max_batch(), lib.pdmt_ring_ws_max_replicas(),
               [lib.pdmt_ring_ws_cols(n) for n in range(1, 10)],
               [lib.pdmt_ring_ws_smem_bytes(n) for n in range(1, 9)])
        want = (N_PARAMS, 11, WS_MAX_BATCH, RING_WS_MAX_REPLICAS,
                [ring_ws_cols(n) for n in range(1, 10)],
                [ws_smem_bytes(ring_ws_cols(n)) for n in range(1, 9)])
        if got != want:
            raise RuntimeError(f"{name}: params, table fields, max batch, max "
                               f"replicas, COLS and shared memory by n {got}; "
                               f"expected {want}")
        _ring_ws_libs[name] = lib
    return _ring_ws_libs[name]


def _ws_lib(name: str = "epoch_ws"):
    """The K2-ws library `name` (the default build, or a variant of
    ops/_build.py VARIANTS) with its ctypes signatures declared."""
    if name not in _ws_libs:
        from . import _build
        lib = _build.load(name)
        p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
        lib.pdmt_ws_epoch.argtypes = ([p, p, i, p, p, u] + [p] * 10
                                      + [i, p, p, p, i, i, f, f, p])
        lib.pdmt_ws_epoch.restype = i
        lib.pdmt_ws_epoch_cols.argtypes = [i] + lib.pdmt_ws_epoch.argtypes
        lib.pdmt_ws_epoch_cols.restype = i
        lib.pdmt_ws_smem_bytes_at.argtypes = [i]
        lib.pdmt_ws_smem_bytes_at.restype = i
        lib.pdmt_ws_table.argtypes = [p, p]
        lib.pdmt_ws_table.restype = i
        for fn in ("pdmt_ws_max_batch", "pdmt_ws_blocks",
                   "pdmt_ws_smem_bytes", "pdmt_ws_stamps_per_step",
                   "pdmt_ws_table_copies"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i
        lib.pdmt_ws_xch_floats.argtypes = [i]
        lib.pdmt_ws_xch_floats.restype = i
        lib.pdmt_ws_error_string.argtypes = [i]
        lib.pdmt_ws_error_string.restype = ctypes.c_char_p
        if (lib.pdmt_ws_max_batch(), lib.pdmt_ws_table_copies()) != (
                WS_MAX_BATCH, WS_TABLE_COPIES):
            raise RuntimeError(
                f"{name}: max batch {lib.pdmt_ws_max_batch()}, table copies "
                f"{lib.pdmt_ws_table_copies()}; expected {WS_MAX_BATCH}, "
                f"{WS_TABLE_COPIES}")
        _ws_libs[name] = lib
    return _ws_libs[name]


def _mma_lib(name: str = "epoch_mma"):
    """The K2-mma library `name` (the default build, or its stamps build
    of ops/_build.py VARIANTS) with its ctypes signatures declared and its
    constants checked against this module's."""
    if name not in _mma_libs:
        from . import _build
        lib = _build.load(name)
        p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
        lib.pdmt_emma_epoch.argtypes = ([p, p, i, p, p, u] + [p] * 11
                                        + [i, p, p, p, i, i, f, f,
                                           ctypes.POINTER(i), p])
        lib.pdmt_emma_epoch.restype = i
        for fn in ("pdmt_emma_max_batch", "pdmt_emma_threads",
                   "pdmt_emma_smem_bytes", "pdmt_emma_stamps_per_step"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i
        for fn in ("pdmt_emma_blocks", "pdmt_emma_scratch_bytes"):
            getattr(lib, fn).argtypes = [i]
            getattr(lib, fn).restype = i
        lib.pdmt_emma_error_string.argtypes = [i]
        lib.pdmt_emma_error_string.restype = ctypes.c_char_p
        got = (lib.pdmt_emma_max_batch(), lib.pdmt_emma_threads(),
               lib.pdmt_emma_blocks(MMA_MAX_BATCH))
        want = (MMA_MAX_BATCH, MMA_EPOCH_THREADS,
                mma_epoch_blocks(MMA_MAX_BATCH))
        if got != want:
            raise RuntimeError(f"{name}: max batch, threads, blocks at the "
                               f"max batch {got}; expected {want}")
        _mma_libs[name] = lib
    return _mma_libs[name]


def _kernel_lib():
    """The built kernel library with its ctypes signatures declared."""
    global _lib
    if _lib is None:
        from . import _build
        lib = _build.load("epoch_step")
        p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
        lib.pdmt_epoch_step.argtypes = ([p, i, p, i, p, p, u] + [p] * 10
                                        + [i, i, i] + [p] * 3
                                        + [i, i, f, f, i, ctypes.POINTER(i),
                                           p])
        lib.pdmt_epoch_step.restype = i
        lib.pdmt_ring_step.argtypes = ([p, p, p, i, i, i, i, i, u, i, i, f, f,
                                        f, i, ctypes.c_ulonglong, i, i,
                                        ctypes.POINTER(i), p])
        lib.pdmt_ring_step.restype = i
        lib.pdmt_epoch_mask.argtypes = [i, p, u, i, i, u, p, p]
        lib.pdmt_epoch_mask.restype = i
        for name in ("pdmt_epoch_n_params", "pdmt_ring_table_fields"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        lib.pdmt_ring_flags_per_replica.argtypes = [i, i]
        lib.pdmt_ring_flags_per_replica.restype = i
        lib.pdmt_epoch_stages.argtypes = [i, i]
        lib.pdmt_epoch_stages.restype = i
        lib.pdmt_epoch_scratch_per_row.argtypes = []
        lib.pdmt_epoch_scratch_per_row.restype = i
        lib.pdmt_epoch_error_string.argtypes = [i]
        lib.pdmt_epoch_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(err: int, what: str, error_string=None) -> None:
    """Raise naming `what` and the CUDA error `err`, spelled by the
    library's `error_string` (default: the rows design's)."""
    if err != 0:
        msg = (error_string or _kernel_lib().pdmt_epoch_error_string)(err)
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({msg.decode()})")


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


def step_mask(rng, seed_or_keys, masks, step, batch, device, replica=0):
    """The plain (batch, 128) mask of `step` in form `rng`; for 'threefry'
    `seed_or_keys` is the key table (a tensor or its `.tolist()`); for
    'core' the Philox stream of ring replica `replica` (0: K2's)."""
    if rng == "masks":
        return masks[step * batch:(step + 1) * batch].to(torch.float32)
    if rng == "threefry":
        row = seed_or_keys[step]
        k0, k1 = (int(v) & threefry.M32 for v in
                  (row.tolist() if isinstance(row, torch.Tensor) else row))
        return threefry.mask_block(k0, k1, batch, device)
    return philox.mask_block(int(seed_or_keys), step, batch, device,
                             replica=replica)


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


def _launch_inputs(params, xp, yp, seed_or_keys, masks, rng):
    """What a K2-ws or K2-mma launch reads: the uint8 rows (16-byte
    aligned: both read them 16 bytes at a time), int32 labels, the f32
    weights and fresh outputs of their shapes, and the form's dropout
    source: the f32 masks, the int32 key words or the uint32 seed (None,
    None or 0 for the other forms)."""
    x = xp.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    ins = [w.detach().to(torch.float32).contiguous() for w in _weights(params)]
    return (x, yp.to(torch.int32).contiguous(), ins,
            [torch.empty_like(w) for w in ins],
            masks.to(torch.float32).contiguous() if rng == "masks" else None,
            threefry.to_int32_words(seed_or_keys) if rng == "threefry"
            else None,
            int(seed_or_keys) & threefry.M32 if rng == "core" else 0)


def _ws_cuda(params, xp, yp, seed_or_keys, lr, batch, masks, rng, nsteps,
             steps_per_iter, valid_steps, max_blocks, lib_name="epoch_ws",
             cols=2):
    """One K2-ws launch, at `cols` hidden units a block (2, the design's;
    4 builds the step K6-ws runs at n = 3, 4, for comparing the two on a
    card). K needs no padding here: the steps past `valid_steps` are
    skipped in the kernel. Returns (params, losses (valid_steps,), the
    stamps build's (valid_steps, N) u64 stamps or None)."""
    lib = _ws_lib(lib_name)
    blocks = HIDDEN1 // cols
    if 0 < max_blocks < blocks:
        raise ValueError(
            f"K2-ws runs {blocks} blocks, one per {cols} hidden units; "
            f"max_blocks={max_blocks} caps the 'rows' design only")
    dev = xp.device
    x, y32, ins, outs, m, keys, seed = _launch_inputs(
        params, xp, yp, seed_or_keys, masks, rng)
    xch = torch.empty(lib.pdmt_ws_xch_floats(batch), dtype=torch.float32,
                      device=dev)
    losses = torch.empty(nsteps, dtype=torch.float32, device=dev)
    per_step = lib.pdmt_ws_stamps_per_step()
    stamps = (torch.zeros((nsteps, per_step), dtype=torch.int64, device=dev)
              if per_step else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pdmt_ws_epoch_cols(
            cols, x.data_ptr(), y32.data_ptr(), _RNG_CODE[rng],
            m.data_ptr() if m is not None else None,
            keys.data_ptr() if keys is not None else None, seed,
            *(w.data_ptr() for w in ins), *(w.data_ptr() for w in outs),
            valid_steps, xch.data_ptr(), losses.data_ptr(),
            stamps.data_ptr() if stamps is not None else None, nsteps, batch,
            lr, 1.0 / batch, stream)
    _raise_on(err, f"{lib_name} kernel launch", lib.pdmt_ws_error_string)
    if lib_name == "epoch_ws":
        launch_count["epoch_step_ws"] += 1
    last_launch.update(
        design="ws", blocks=blocks, cols=cols, bf16=False,
        steps_per_iter=steps_per_iter, staged=False, form=f"uint8/{rng}",
        replicas=1, ring="")
    return (_tree(*outs), losses[:valid_steps],
            stamps[:valid_steps] if stamps is not None else None)


_bf16_tables = {}


def pixel_table_bf16(device) -> torch.Tensor:
    """The (256,) bf16 table K2-mma converts its uint8 rows through: entry
    v is the normalised pixel v (`device_normalize`, f32) rounded to bf16,
    nearest even: bitwise the rows `device_normalize(x).to(bfloat16)` that
    K1-mma takes. Built here in torch on the CPU and copied to `device`
    once (a copy from the host at every launch would hold the host until
    the card had drained the stream)."""
    device = torch.device(device)
    if device not in _bf16_tables:
        table = device_normalize(torch.arange(256, dtype=torch.uint8))
        _bf16_tables[device] = table.to(torch.bfloat16).to(device)
    return _bf16_tables[device]


def _mma_cuda(params, xp, yp, seed_or_keys, lr, batch, masks, rng, nsteps,
              steps_per_iter, valid_steps, max_blocks, lib_name="epoch_mma"):
    """One K2-mma launch. K needs no padding and is not passed: every K
    runs K = 1's loop, and the steps past `valid_steps` are skipped in the
    kernel. Returns (params, losses (valid_steps,), the stamps build's
    (valid_steps, N) u64 stamps or None)."""
    blocks = mma_epoch_blocks(batch)
    if 0 < max_blocks < blocks:
        raise ValueError(
            f"K2-mma runs {blocks} blocks at batch {batch} (every phase's "
            f"tiles at once); max_blocks={max_blocks} caps the 'rows' design "
            f"only")
    lib = _mma_lib(lib_name)
    dev = xp.device
    x, y32, ins, outs, m, keys, seed = _launch_inputs(
        params, xp, yp, seed_or_keys, masks, rng)
    table = pixel_table_bf16(dev)
    scratch = torch.empty(lib.pdmt_emma_scratch_bytes(batch),
                          dtype=torch.uint8, device=dev)
    losses = torch.empty(nsteps, dtype=torch.float32, device=dev)
    per_step = lib.pdmt_emma_stamps_per_step()
    stamps = (torch.zeros((nsteps, per_step), dtype=torch.int64, device=dev)
              if per_step else None)
    grid = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pdmt_emma_epoch(
            x.data_ptr(), y32.data_ptr(), _RNG_CODE[rng],
            m.data_ptr() if m is not None else None,
            keys.data_ptr() if keys is not None else None, seed,
            *(w.data_ptr() for w in ins), *(w.data_ptr() for w in outs),
            table.data_ptr(), valid_steps, scratch.data_ptr(),
            losses.data_ptr(),
            stamps.data_ptr() if stamps is not None else None, nsteps, batch,
            lr, 1.0 / batch, ctypes.byref(grid), stream)
    _raise_on(err, f"{lib_name} kernel launch", lib.pdmt_emma_error_string)
    if lib_name == "epoch_mma":
        launch_count["epoch_step_mma"] += 1
    last_launch.update(
        design="mma", blocks=grid.value, cols=0, bf16=True,
        steps_per_iter=steps_per_iter, staged=False, form=f"uint8/{rng}",
        replicas=1, ring="")
    return (_tree(*outs), losses[:valid_steps],
            stamps[:valid_steps] if stamps is not None else None)


def _epoch_cuda(params, xp, yp, seed_or_keys, lr, batch, masks, rng, nsteps,
                compute_bf16, steps_per_iter, valid_steps, pad_steps,
                max_blocks, design=None):
    """One launch of `design` ('rows'), or of the design epoch_design
    picks (None)."""
    design = design or epoch_design(xp.dtype, compute_bf16, batch)
    if design == "ws":
        return _ws_cuda(params, xp, yp, seed_or_keys, lr, batch, masks, rng,
                        nsteps, steps_per_iter, valid_steps, max_blocks)[:2]
    if design == "mma":
        return _mma_cuda(params, xp, yp, seed_or_keys, lr, batch, masks, rng,
                         nsteps, steps_per_iter, valid_steps, max_blocks)[:2]
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
            losses.data_ptr(), nsteps, batch, lr, 1.0 / batch, max_blocks,
            ctypes.byref(grid), stream)
    _raise_on(err, "epoch_step kernel launch")
    launch_count[_form_key(compute_bf16, steps_per_iter)] += 1
    last_launch.update(
        design="rows", blocks=grid.value, cols=0, bf16=bool(compute_bf16),
        steps_per_iter=steps_per_iter, staged=stage is not None,
        form=f"{'uint8' if u8 else 'f32'}/{rng}", replicas=1, ring="")
    return _tree(*outs), losses[:valid_steps]


def epoch_fused_sgd(params, xp, yp, seed_or_keys, lr: float, batch: int, *,
                    masks=None, rng_impl: str = "core",
                    compute_bf16: bool = False, steps_per_iter: int = 1,
                    valid_steps=None, axis_size: int = 1, ring: str = "auto",
                    max_blocks: int = 0, _design=None):
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

    `axis_size=n > 1` runs the DP form (K6) on n replicas: `params`, `xp`,
    `yp`, `masks` and the threefry key tables are then sequences of n, one
    per replica (the params identical), the core seed one int for all (the
    kernel keys Philox by (seed, step) at counter word 1 = the replica);
    `ring` picks the allreduce ('auto': all-gather up to
    EPOCH_KERNEL_MAX_DEVICES replicas, reduce-scatter beyond). Returns
    (list of n params trees, bitwise equal; list of n per-replica loss
    tensors). K6's design is `ring_design`'s ('ws', 'mma' or 'rows'), or
    `_design`'s. `max_blocks` caps the blocks of the 'rows' design (per
    replica for K6; 0: the co-resident maximum cut to the work); the bits
    do not depend on it. K2-ws, K2-mma, K6-ws and K6-mma pick their own
    grids and refuse a cap below them.

    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    version."""
    if axis_size != 1 or ring != "auto":
        return _epoch_dp(params, xp, yp, seed_or_keys, lr, batch, masks=masks,
                         rng_impl=rng_impl, compute_bf16=compute_bf16,
                         steps_per_iter=steps_per_iter,
                         valid_steps=valid_steps, axis_size=axis_size,
                         ring=ring, max_blocks=max_blocks, design=_design)
    rng, nsteps, valid, pad = _check(params, xp, yp, seed_or_keys, batch,
                                     masks, rng_impl, steps_per_iter,
                                     valid_steps)
    if xp.device.type == "cuda":
        return _epoch_cuda(params, xp, yp, seed_or_keys, lr, batch, masks,
                           rng, nsteps, compute_bf16, steps_per_iter, valid,
                           pad, max_blocks, _design)
    if xp.device.type == "cpu":
        return epoch_fused_sgd_reference(
            params, xp, yp, seed_or_keys, lr, batch, masks=masks,
            rng_impl=rng_impl, compute_bf16=compute_bf16,
            steps_per_iter=steps_per_iter, valid_steps=valid_steps)
    raise ValueError(f"epoch_fused_sgd runs on cuda or cpu, not "
                     f"{xp.device.type}")


def _epoch_fused_sgd_rows(*args, **kwargs):
    """`epoch_fused_sgd`, single replica, on the 'rows' design
    whatever the form: the yardstick K2-ws and K2-mma are held against on
    a card."""
    return epoch_fused_sgd(*args, _design="rows", **kwargs)


# ---- K6: the DP form ----

def _rs_chunk_rows(n: int) -> int:
    """The reduce-scatter ring's chunk height in packed rows:
    EPOCH_COMM_ROWS split n ways, rounded up to 8 rows (the TPU's f32
    sublane tile), as the JAX kernel cuts it."""
    rows = -(-EPOCH_COMM_ROWS // n)
    return -(-rows // 8) * 8


def _row_offset(row: int) -> int:
    """Floats before packed row `row` (0..EPOCH_COMM_ROWS) in the port's
    packing: every row 128 wide except gw3's, NUM_CLASSES wide."""
    w3_row = _COMM_LAYOUT[-1][0]
    if row <= w3_row:
        return row * HIDDEN1
    return w3_row * HIDDEN1 + (row - w3_row) * NUM_CLASSES


def rs_chunk_bounds(n: int) -> list:
    """The n + 1 float offsets of the reduce-scatter ring's chunks in the
    packed gradient: chunk c holds the packed rows [c*C, (c+1)*C) of the
    TPU kernel's block, so each element is summed along the same chain as
    on the TPU. Offsets are multiples of 4 (whole float4s)."""
    C = _rs_chunk_rows(n)
    return [_row_offset(min(c * C, EPOCH_COMM_ROWS)) for c in range(n + 1)]


def pack(tree) -> torch.Tensor:
    """A params or grads tree -> the (N_PARAMS,) packed block w1|b1|w2|b2|w3
    (the TPU's _COMM_LAYOUT rows, gw3 unpadded)."""
    return torch.cat([t.reshape(-1) for t in _weights(tree)])


def unpack(flat: torch.Tensor):
    """The packed block -> a tree of views into it."""
    out, at = [], 0
    for shape in _WEIGHT_SHAPES:
        size = math.prod(shape)
        out.append(flat[at:at + size].view(shape))
        at += size
    return _tree(*out)


def ring_mean(flats, ring: str) -> torch.Tensor:
    """The mean of n packed gradient blocks by the ring's EXACT summation
    tree (tests/test_pallas_step.py `_ring_mean_grads`), element by element:
      allgather       tot = g0; tot = tot + g1; ...; tot * f32(1/n)
      reduce_scatter  chunk c: s = g_c; s = g_{c+1} + s; ... (ring order
                      from its origin), then s * f32(1/n)"""
    n = len(flats)
    inv = torch.tensor(1.0 / n, dtype=torch.float32, device=flats[0].device)
    if ring == "allgather":
        tot = flats[0]
        for d in range(1, n):
            tot = tot + flats[d]
        return tot * inv
    if ring != "reduce_scatter":
        raise ValueError(f"ring must be 'allgather' or 'reduce_scatter'; got "
                         f"{ring!r}")
    bounds = rs_chunk_bounds(n)
    out = torch.empty_like(flats[0])
    for c in range(n):
        lo, hi = bounds[c], bounds[c + 1]
        s = flats[c][lo:hi]
        for k in range(1, n):
            s = flats[(c + k) % n][lo:hi] + s
        out[lo:hi] = s * inv
    return out


def _owned_offsets(cols: int, g: int) -> torch.Tensor:
    """The packed offsets of the gradient elements that K6-ws's block g
    owns at `cols` hidden units a block (units j = g*cols ..): its slice of
    every row of w1, b1[j], its rows of w2, b2[j], its rows of w3, in the
    order the block holds them (csrc/ring_ws.cu `unit_off`)."""
    j = torch.arange(g * cols, (g + 1) * cols)
    off_b1 = IN_DIM * HIDDEN1
    off_w2 = off_b1 + HIDDEN1
    off_b2 = off_w2 + HIDDEN1 * HIDDEN2
    off_w3 = off_b2 + HIDDEN2
    return torch.cat([
        (torch.arange(IN_DIM)[:, None] * HIDDEN1 + j).reshape(-1),
        off_b1 + j,
        (off_w2 + j[:, None] * HIDDEN2 + torch.arange(HIDDEN2)).reshape(-1),
        off_b2 + j,
        (off_w3 + j[:, None] * NUM_CLASSES
         + torch.arange(NUM_CLASSES)).reshape(-1)])


def grads_owner_ranges() -> list:
    """The slices of the packed gradient that K6-mma's ring blocks own, one
    per block of K2-mma's gradient phase (csrc/mma_step.cuh grads_tile): as
    (first offset, length in floats), blocks 0..48 the 16-row tiles of gw1,
    49..56 those of gw2, 57 gw3, 58..61 and 62..65 the column quarters of
    gb1 and gb2 (csrc/ring_mma.cu `owner_lo`, `owner_len`)."""
    off_b1 = IN_DIM * HIDDEN1
    off_w2 = off_b1 + HIDDEN1
    off_b2 = off_w2 + HIDDEN1 * HIDDEN2
    off_w3 = off_b2 + HIDDEN2
    tile, quarter = 16 * HIDDEN1, HIDDEN1 // 4
    return ([(t * tile, tile) for t in range(IN_DIM // 16)]
            + [(off_w2 + t * tile, tile) for t in range(HIDDEN1 // 16)]
            + [(off_w3, HIDDEN2 * NUM_CLASSES)]
            + [(off + q * quarter, quarter) for off in (off_b1, off_b2)
               for q in range(4)])


def _ring_mean_by_sets(flats, ring: str, owned) -> torch.Tensor:
    """A ring schedule in plain torch: each owner runs its own mini-ring
    over the n replicas on the elements it owns (`owned`, one index tensor
    per owner), hop by hop, each replica with its own buffers:
      allgather       hop h: replica r's slot (r - h) mod n goes to its
                      right neighbour's same slot; then every replica sums
                      its n slots in origin order;
      reduce_scatter  an element's chunk is the one its packed offset falls
                      in (rs_chunk_bounds); hop h: replica r sends its
                      partial of chunk (r - h) to the right, which adds it
                      to its own (local + incoming); then n - 1 hops carry
                      the finished chunks around.
    Then every replica takes tot * f32(1/n). Returns replica 0's mean
    (every replica's is checked to be the same bits)."""
    n = len(flats)
    if ring not in ("allgather", "reduce_scatter"):
        raise ValueError(f"ring must be 'allgather' or 'reduce_scatter'; got "
                         f"{ring!r}")
    dev = flats[0].device
    inv = torch.tensor(1.0 / n, dtype=torch.float32, device=dev)
    means = [torch.empty_like(flats[0]) for _ in range(n)]
    bounds = torch.tensor(rs_chunk_bounds(n))
    for idx in owned:
        own = [f[idx.to(dev)] for f in flats]
        if ring == "allgather":
            # slots[r][s]: what replica r holds of origin s
            slots = [{r: own[r]} for r in range(n)]
            for h in range(n - 1):
                for r in range(n):
                    s = (r - h) % n
                    slots[(r + 1) % n][s] = slots[r][s]
            for r in range(n):
                tot = slots[r][0]
                for d in range(1, n):
                    tot = tot + slots[r][d]
                means[r][idx.to(dev)] = tot * inv
            continue
        # the owner's positions of each chunk's elements
        chunk = torch.bucketize(idx, bounds, right=True) - 1
        pos = [torch.nonzero(chunk == c).flatten().to(dev) for c in range(n)]
        comm = own
        for h in range(n - 1):
            for r in range(n):
                sc, dst = (r - h) % n, (r + 1) % n
                # the receiver's local + incoming (its own send this hop is
                # another chunk)
                comm[dst][pos[sc]] = comm[dst][pos[sc]] + comm[r][pos[sc]]
        for k in range(n - 1):
            for r in range(n):
                sc = (r + 1 - k) % n
                comm[(r + 1) % n][pos[sc]] = comm[r][pos[sc]]
        for r in range(n):
            means[r][idx.to(dev)] = comm[r] * inv
    for r in range(1, n):
        if not torch.equal(means[r], means[0]):
            raise AssertionError(f"replica {r}'s mean differs from replica "
                                 f"0's")
    return means[0]


def ring_mean_by_owner(flats, ring: str, cols: int) -> torch.Tensor:
    """K6-ws's schedule in plain torch (tests only): each column owner g
    runs its own mini-ring on the elements it owns (`_owned_offsets`), as
    csrc/ring_ws.cu does (`_ring_mean_by_sets`)."""
    return _ring_mean_by_sets(
        flats, ring, [_owned_offsets(cols, g) for g in range(HIDDEN1 // cols)])


def ring_mean_by_grads_owner(flats, ring: str) -> torch.Tensor:
    """K6-mma's schedule in plain torch (tests only): each gradient-tile
    owner runs its own mini-ring on its slice (`grads_owner_ranges`), as
    csrc/ring_mma.cu does (`_ring_mean_by_sets`); a reduce-scatter chunk
    bound may cut a slice, whose elements then move on their chunks'
    hops."""
    return _ring_mean_by_sets(
        flats, ring, [torch.arange(lo, lo + size)
                      for lo, size in grads_owner_ranges()])


def _resolve_ring(ring: str, n: int) -> str:
    """The JAX wrapper's ring checks; returns the strategy to run."""
    if ring not in RINGS:
        raise ValueError(f"ring must be 'auto', 'allgather' or "
                         f"'reduce_scatter'; got {ring!r}")
    if n == 1 and ring != "auto":
        raise ValueError(
            f"ring={ring!r} selects the DP ring allreduce strategy, but "
            f"axis_size=1 runs the serial kernel (no ring) — a forced "
            f"strategy here would silently measure the wrong program; drop "
            f"ring or pass axis_size")
    if ring == "auto":
        return ("allgather" if n <= EPOCH_KERNEL_MAX_DEVICES
                else "reduce_scatter")
    if ring == "allgather" and n > EPOCH_KERNEL_MAX_DEVICES:
        raise ValueError(
            f"ring='allgather' keeps one {EPOCH_COMM_ROWS}x128 f32 comm slot "
            f"per replica for the fixed-order ring sum; {n} replicas > "
            f"{EPOCH_KERNEL_MAX_DEVICES} exceeds the JAX kernel's budget. Use "
            f"ring='reduce_scatter' (the 'auto' default) on larger meshes")
    return ring


def _per_replica(name, value, n):
    if isinstance(value, (list, tuple)) and len(value) == n:
        return list(value)
    raise ValueError(f"axis_size={n}: {name} must be a sequence of {n} "
                     f"per-replica values; got {type(value).__name__}")


def _check_dp(params, xp, yp, seed_or_keys, batch, masks, rng_impl,
              steps_per_iter, valid_steps, axis_size, ring):
    """The DP form's validation. Returns (ring, rng, per-replica params,
    xp, yp, seeds (keys or the shared seed), masks (or Nones), nsteps,
    valid_steps)."""
    n = axis_size
    if not isinstance(n, int) or n < 1:
        raise ValueError(f"axis_size must be a positive int; got {n!r}")
    ring = _resolve_ring(ring, n)
    if steps_per_iter != 1:
        raise ValueError(
            "steps_per_iter > 1 is single-replica only: the DP ring "
            "allreduce handshake is per grid iteration, not per sub-step. "
            "Use steps_per_iter=1 on DP meshes")
    params = _per_replica("params", params, n)
    xp = _per_replica("xp", xp, n)
    yp = _per_replica("yp", yp, n)
    masks = ([None] * n if masks is None
             else _per_replica("masks", masks, n))
    if rng_impl == "threefry" and masks[0] is None:
        seeds = _per_replica("seed_or_keys (threefry key tables)",
                             seed_or_keys, n)
    else:
        seeds = [seed_or_keys] * n
    checked = [_check(params[r], xp[r], yp[r], seeds[r], batch, masks[r],
                      rng_impl, 1, valid_steps) for r in range(n)]
    rng, nsteps, valid, _ = checked[0]
    if any(c[1] != nsteps for c in checked):
        raise ValueError(f"every replica needs the same step count; got "
                         f"{[c[1] for c in checked]}")
    if len({x.dtype for x in xp}) != 1:
        raise ValueError(f"every replica's rows need one dtype; got "
                         f"{[x.dtype for x in xp]}")
    devices = {x.device for x in xp}
    if len(devices) != 1:
        raise ValueError(
            f"the replicas' rows lie on {sorted(map(str, devices))}: K6 runs "
            f"its ring among replicas of one card (or all on the CPU). "
            f"Replicas on several cards need peer pointers in its table, "
            f"which waits for a machine with two or more cards (ROADMAP.md "
            f"queue 2, K6)")
    return ring, rng, params, xp, yp, seeds, masks, nsteps, valid


@torch.no_grad()
def epoch_dp_sgd_reference(params, xp, yp, seed_or_keys, lr: float,
                           batch: int, *, masks=None, rng_impl: str = "core",
                           compute_bf16: bool = False, axis_size: int,
                           ring: str = "auto", valid_steps=None,
                           step_fn=None):
    """Plain PyTorch version of K6, on any device: per step, each replica's
    step (`step_fn`, default fused_loss_and_grads_reference, or
    step_reference_bf16 with `compute_bf16`) on its rows with its mask (the
    form's stream; core: Philox at counter word 1 = the replica), then the
    ring's exact summation tree (`ring_mean` on the packed gradients), then
    sgd_step on every replica's params. Inputs as `epoch_fused_sgd` with
    `axis_size`; returns (list of n params trees, list of n loss tensors
    (valid_steps,)). A `step_fn` of the kernel (K1) gives the per-element
    check of K6 on a card."""
    ring, rng, params, xp, yp, seeds, masks, nsteps, valid = _check_dp(
        params, xp, yp, seed_or_keys, batch, masks, rng_impl, 1, valid_steps,
        axis_size, ring)
    n = axis_size
    if step_fn is None:
        step_fn = (step_reference_bf16 if compute_bf16
                   else fused_loss_and_grads_reference)
    ps = [{name: {k: v.detach().to(torch.float32).clone()
                  for k, v in layer.items()} for name, layer in p.items()}
          for p in params]
    if rng == "threefry":   # one fetch of each key table, not one per step
        seeds = [k.tolist() for k in seeds]
    losses = [[] for _ in range(n)]
    for s in range(valid):
        flats = []
        for r in range(n):
            rows = slice(s * batch, (s + 1) * batch)
            xb = xp[r][rows]
            xb = device_normalize(xb) if xb.dtype == torch.uint8 else xb.float()
            mb = step_mask(rng, seeds[r], masks[r], s, batch, xb.device,
                           replica=r)
            loss, grads = step_fn(ps[r], xb, yp[r][rows], mb)
            losses[r].append(loss)
            flats.append(pack(grads))
        mean = unpack(ring_mean(flats, ring))
        for p in ps:
            sgd_step(p, mean, lr)
    return ps, [torch.stack(ls) for ls in losses]


def _int32_keys(keys, device) -> torch.Tensor:
    """A replica's threefry key table as the kernel takes it: an (S, 2)
    int32 table on `device` as it is (the words' bits already), anything
    else through threefry.to_int32_words."""
    if (isinstance(keys, torch.Tensor) and keys.dtype == torch.int32
            and keys.dim() == 2 and keys.is_contiguous()
            and keys.device == device):
        return keys
    return threefry.to_int32_words(keys).to(device)


_chunk_los = {}


def _chunk_lo(n: int, device) -> torch.Tensor:
    """rs_chunk_bounds(n) as an int32 tensor on `device`, made once."""
    if (n, device) not in _chunk_los:
        _chunk_los[n, device] = torch.tensor(rs_chunk_bounds(n),
                                             dtype=torch.int32).to(device)
    return _chunk_los[n, device]


def _ring_launch(params, xp, yp, seeds, masks, lr, batch, rng, nsteps,
                 compute_bf16, ring, max_blocks, timeout_s=RING_TIMEOUT_S,
                 fault=-1, design="rows", lib_name=None):
    """One K6 launch of `design` ('ws': K6-ws; 'mma': K6-mma; 'rows':
    csrc/epoch_step.cu's ring) on the replicas' card, from library
    `lib_name` (default: the design's own build); raises RingTimeoutError
    if a wait of the ring passed `timeout_s`. `fault` >= 0 names a replica
    that never signals its first hop (stalled_ring). Returns (params list,
    losses list, the stamps build's (nsteps, N) u64 stamps or None)."""
    n = len(xp)
    dev = xp[0].device
    rs = ring == "reduce_scatter"
    lib_name = lib_name or {"ws": "ring_ws", "mma": "ring_mma"}.get(
        design, "epoch_step")
    if design == "ws":
        lib = _ring_ws_lib(lib_name)
        G = HIDDEN1 // ring_ws_cols(n)
        if 0 < max_blocks < G:
            raise ValueError(
                f"K6-ws runs {G} blocks a replica at n = {n}; max_blocks="
                f"{max_blocks} caps the 'rows' design only")
        error_string = lib.pdmt_ring_ws_error_string
        per_rep = lib.pdmt_ring_ws_scratch_floats(batch)
        nflags = lib.pdmt_ring_ws_flags_per_replica(n, int(rs))
        words = lib.pdmt_ring_ws_stamp_words()
    elif design == "mma":
        if 0 < max_blocks < RING_MMA_BLOCKS:
            raise ValueError(
                f"K6-mma runs {RING_MMA_BLOCKS} blocks a replica; max_blocks="
                f"{max_blocks} caps the 'rows' design only")
        if (not compute_bf16 or xp[0].dtype != torch.uint8
                or batch > MMA_MAX_BATCH or n > RING_MMA_MAX_REPLICAS):
            raise ValueError(
                f"K6-mma runs uint8 rows in the bf16 mode at B <= "
                f"{MMA_MAX_BATCH} on n <= {RING_MMA_MAX_REPLICAS} replicas; "
                f"got {xp[0].dtype}, bf16={bool(compute_bf16)}, B = {batch}, "
                f"n = {n}")
        lib = _ring_mma_lib(lib_name)
        error_string = lib.pdmt_ring_mma_error_string
        per_rep = lib.pdmt_ring_mma_scratch_bytes(batch)
        nflags = ring_mma_flags_per_replica(n, rs)
        words = lib.pdmt_ring_mma_stamp_words()
    else:
        lib = _kernel_lib()
        P = lib.pdmt_epoch_n_params()
        if P != N_PARAMS or lib.pdmt_ring_table_fields() != 11:
            raise RuntimeError(f"epoch_step library: {P} params and "
                               f"{lib.pdmt_ring_table_fields()} table fields, "
                               f"expected {N_PARAMS} and 11")
        error_string = None
        per_rep = batch * lib.pdmt_epoch_scratch_per_row()
        nflags = lib.pdmt_ring_flags_per_replica(n, int(rs))
        words = 0
    P = N_PARAMS
    u8 = int(xp[0].dtype == torch.uint8)
    xs = [(x if u8 else x.to(torch.float32)).contiguous() for x in xp]
    if design != "rows":   # their rows are read 16 bytes at a time
        xs = [x.clone() if x.data_ptr() % 16 else x for x in xs]
    ys = [y.to(torch.int32).contiguous() for y in yp]
    ms = [m.to(torch.float32).contiguous() if m is not None else None
          for m in masks]
    keys = [_int32_keys(k, dev) if rng == "threefry" else None for k in seeds]
    seed = int(seeds[0]) & threefry.M32 if rng == "core" else 0
    ins = [pack(p).detach().to(torch.float32).contiguous() for p in params]
    outs = [torch.empty(P, dtype=torch.float32, device=dev) for _ in range(n)]
    # K6-mma's scratch is bytes (its exchange and its bf16 rows), a whole
    # number of 16-byte units a replica
    scratch = torch.empty((n, per_rep), device=dev,
                          dtype=torch.uint8 if design == "mma"
                          else torch.float32)
    losses = torch.empty((n, nsteps), dtype=torch.float32, device=dev)
    comm = torch.empty((n, P if rs else n * P), dtype=torch.float32,
                       device=dev)
    bounds = rs_chunk_bounds(n) if rs else None
    chunk_max = (max(b - a for a, b in zip(bounds, bounds[1:])) if rs else 0)
    recv = (torch.empty((n, (n - 1) * chunk_max), dtype=torch.float32,
                        device=dev) if rs else None)
    # the flag counters and the error record, zeroed by one fill
    zeroed = torch.zeros(n * nflags + 4, dtype=torch.int32, device=dev)
    flags, err_rec = zeroed[:-4].view(n, nflags), zeroed[-4:]
    ptr = lambda t: t.data_ptr() if t is not None else 0  # noqa: E731
    host_table = torch.tensor(
        [[ptr(xs[r]), ptr(ys[r]), ptr(ms[r]), ptr(keys[r]), ptr(ins[r]),
          ptr(outs[r]), ptr(scratch[r]), ptr(losses[r]), ptr(comm[r]),
          ptr(recv[r]) if rs else 0, ptr(flags[r])] for r in range(n)],
        dtype=torch.int64)
    table = host_table.to(dev)
    chunk_lo = _chunk_lo(n, dev) if rs else None
    stamps = (torch.zeros((nsteps, words), dtype=torch.int64, device=dev)
              if words else None)
    group, cols = ctypes.c_int(0), ctypes.c_int(0)
    inv_n = float(np.float32(1.0 / n))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if design == "ws":
            err = lib.pdmt_ring_ws_step(
                table.data_ptr(), ptr(chunk_lo), err_rec.data_ptr(), n,
                int(rs), _RNG_CODE[rng], seed, nsteps, batch, lr, 1.0 / batch,
                inv_n, chunk_max, int(timeout_s * 1e9), fault, ptr(stamps),
                ctypes.byref(group), ctypes.byref(cols), stream)
        elif design == "mma":
            err = lib.pdmt_ring_mma_step(
                table.data_ptr(), host_table.data_ptr(), ptr(chunk_lo),
                err_rec.data_ptr(), n, int(rs), _RNG_CODE[rng], seed, nsteps,
                batch, lr, 1.0 / batch, inv_n, chunk_max,
                int(timeout_s * 1e9), fault, pixel_table_bf16(dev).data_ptr(),
                ptr(stamps), stream)
            group.value = RING_MMA_BLOCKS
        else:
            err = lib.pdmt_ring_step(
                table.data_ptr(), ptr(chunk_lo), err_rec.data_ptr(), n,
                int(rs), u8, _RNG_CODE[rng], int(compute_bf16), seed, nsteps,
                batch, lr, 1.0 / batch, inv_n, chunk_max,
                int(timeout_s * 1e9), fault, max_blocks, ctypes.byref(group),
                stream)
    _raise_on(err, f"{lib_name} ring kernel launch", error_string)
    if lib_name in ("ring_ws", "ring_mma"):
        launch_count[f"epoch_step_dp_{design}_{ring}"] += 1
    elif design == "rows":
        launch_count[f"epoch_step_dp_{ring}"
                     + ("_bf16" if compute_bf16 else "")] += 1
    last_launch.update(design=design, blocks=group.value, cols=cols.value,
                       bf16=bool(compute_bf16), steps_per_iter=1,
                       staged=False,
                       form=f"{'uint8' if u8 else 'f32'}/{rng}", replicas=n,
                       ring=ring)
    what, rep, step, hop = err_rec.tolist()   # the launch's one sync
    if what:
        waits = {1: "its replica barrier", 2: "the entry barrier",
                 3: "the neighbour handshake",
                 4: f"hop {hop} from its left neighbour"}
        raise RingTimeoutError(
            f"K6 {ring} ring ({design} design) of {n} replicas: replica {rep} "
            f"waited more than {timeout_s} s for "
            f"{waits.get(what, f'wait {what}')}"
            f"{f' at step {step}' if step >= 0 else ''}")
    return [unpack(o) for o in outs], list(losses.unbind(0)), stamps


def _ring_cuda(params, xp, yp, seeds, masks, lr, batch, rng, nsteps,
               compute_bf16, ring, max_blocks, timeout_s=RING_TIMEOUT_S,
               fault=-1, design="rows"):
    """One K6 launch of `design` (`_ring_launch`); returns (params list,
    losses list)."""
    return _ring_launch(params, xp, yp, seeds, masks, lr, batch, rng, nsteps,
                        compute_bf16, ring, max_blocks, timeout_s, fault,
                        design)[:2]


def _epoch_dp(params, xp, yp, seed_or_keys, lr, batch, *, masks, rng_impl,
              compute_bf16, steps_per_iter, valid_steps, axis_size, ring,
              max_blocks, design=None):
    ring, rng, params, xp, yp, seeds, masks, nsteps, valid = _check_dp(
        params, xp, yp, seed_or_keys, batch, masks, rng_impl, steps_per_iter,
        valid_steps, axis_size, ring)
    if axis_size == 1:     # ring 'auto' only (checked): the serial kernel
        p, losses = epoch_fused_sgd(
            params[0], xp[0], yp[0], seeds[0], lr, batch, masks=masks[0],
            rng_impl=rng_impl, compute_bf16=compute_bf16,
            valid_steps=valid_steps, max_blocks=max_blocks, _design=design)
        return [p], [losses]
    device = xp[0].device
    if device.type == "cuda":
        design = design or ring_design(xp[0].dtype, compute_bf16, batch,
                                       axis_size)
        return _ring_cuda(params, xp, yp, seeds, masks, lr, batch, rng, valid,
                          compute_bf16, ring, max_blocks, design=design)
    if device.type == "cpu":
        return epoch_dp_sgd_reference(
            params, xp, yp, seed_or_keys, lr, batch,
            masks=None if masks[0] is None else masks,
            rng_impl=rng_impl, compute_bf16=compute_bf16,
            axis_size=axis_size, ring=ring, valid_steps=valid_steps)
    raise ValueError(f"epoch_fused_sgd runs on cuda or cpu, not "
                     f"{device.type}")


def stalled_ring(device, *, n: int = 2, ring: str = "allgather",
                 timeout_s: float = 0.05, design=None):
    """Launch K6 once on `device` with replica 0 never signalling its first
    hop (one 1-step epoch at B = 8, zero weights and rows) and return the
    RingTimeoutError it must end in; `design` 'ws', 'mma' (in the bf16
    mode) or 'rows' (default: `ring_design`'s for the f32 form, 'ws'). A
    debug entry: it shows that a ring wait is bounded, and is not counted
    in launch_count."""
    device = torch.device(device)
    zeros = unpack(torch.zeros(N_PARAMS, device=device))
    x = torch.zeros((8, IN_DIM), dtype=torch.uint8, device=device)
    y = torch.zeros(8, dtype=torch.int32, device=device)
    bf16 = design == "mma"
    before = dict(launch_count)
    try:
        _ring_cuda([zeros] * n, [x] * n, [y] * n, [0] * n, [None] * n, 0.0, 8,
                   "core", 1, bf16, _resolve_ring(ring, n), 0,
                   timeout_s=timeout_s, fault=0,
                   design=design or ring_design(x.dtype, bf16, 8, n))
    except RingTimeoutError as e:
        return e
    finally:
        launch_count.update(before)
    raise RuntimeError("K6 with a stalled replica finished: its ring waits "
                       "are not bounded")


def kernel_mask_block(seed_or_keys, step: int, batch: int, *,
                      rng_impl: str, device, replica: int = 0) -> torch.Tensor:
    """The (batch, 128) mask the epoch kernel draws at `step` for rng_impl
    'core' (seed; Philox of ring replica `replica`, 0 for K2) or 'threefry'
    ((S, 2) key words). On a CUDA device it comes from the kernel's own
    device function (one small launch, not counted in launch_count); on the
    CPU from the plain version."""
    if rng_impl not in ("core", "threefry"):
        raise ValueError(f"rng_impl must be 'core' or 'threefry'; got "
                         f"{rng_impl!r}")
    device = torch.device(device)
    if device.type == "cpu":
        return step_mask(rng_impl, seed_or_keys, None, step, batch, device,
                         replica=replica)
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
                                  seed, step, batch, replica, out.data_ptr(),
                                  stream)
    _raise_on(err, "epoch_step mask kernel launch")
    return out


def kernel_pixel_table(device) -> torch.Tensor:
    """The f32 normalise table K2-ws fills in shared memory: (256,
    WS_TABLE_COPIES), entry v of each lane's copy the normalised value of
    pixel v. On a CUDA device it comes from the kernel's own fill (one
    small launch, not counted in launch_count); on the CPU it is the plain
    normalise of 0..255 in every copy, which the kernel's must equal
    bitwise."""
    device = torch.device(device)
    if device.type == "cpu":
        plain = device_normalize(torch.arange(256, dtype=torch.uint8))
        return plain[:, None].repeat(1, WS_TABLE_COPIES)
    if device.type != "cuda":
        raise ValueError(f"kernel_pixel_table runs on cuda or cpu, not "
                         f"{device.type}")
    lib = _ws_lib()
    out = torch.empty((256, WS_TABLE_COPIES), dtype=torch.float32,
                      device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.pdmt_ws_table(out.data_ptr(), stream)
    _raise_on(err, "epoch_ws table kernel launch", lib.pdmt_ws_error_string)
    return out


# the phases between K2-ws's stamps (csrc/epoch_ws.cu `Stamp`), in order
WS_PHASES = ("rows copy", "z1 + mask + d1 out", "barrier 1", "d1 in",
             "z2 + h2 out", "barrier 2", "h2 in", "logits + loss + dl",
             "gw3", "dz2 of every unit",
             "w3/b2 update + dd1 + dz1 + gw2 row", "gb1 + gw1 + w1 update")


def ws_phase_stamps(params, xp, yp, seed_or_keys, lr: float, batch: int, *,
                    masks=None, rng_impl: str = "core", valid_steps=None):
    """One epoch on K2-ws's stamps build (`-DWS_STAMPS`, ops/_build.py
    VARIANTS), which reads %globaltimer at each phase boundary of block 0,
    and its SM clock at the start and end of each step. A debug entry on
    CUDA tensors, not counted in launch_count. Returns (params, losses,
    {phase: mean us a step}, mean us a step, mean SM clock in MHz): the
    phases of WS_PHASES, each averaged over the epoch's steps."""
    rng, nsteps, valid, _ = _check(params, xp, yp, seed_or_keys, batch,
                                   masks, rng_impl, 1, valid_steps)
    if xp.device.type != "cuda" or epoch_design(xp.dtype, False,
                                                batch) != "ws":
        raise ValueError("ws_phase_stamps runs K2-ws's form (uint8 rows, "
                         "f32) on a CUDA device")
    p, losses, stamps = _ws_cuda(params, xp, yp, seed_or_keys, lr, batch,
                                 masks, rng, nsteps, 1, valid, 0,
                                 lib_name="epoch_ws_stamps")
    n = len(WS_PHASES) + 1
    t = stamps[:, :n].double()
    per_phase = (t[:, 1:] - t[:, :-1]).mean(0) / 1e3
    split = dict(zip(WS_PHASES, per_phase.tolist()))
    ns = float((t[:, -1] - t[:, 0]).sum())
    cycles = float((stamps[:, n + 1] - stamps[:, n]).double().sum())
    return (p, losses, split, ns / valid / 1e3,
            cycles / ns * 1e3 if ns > 0 else 0.0)


# the phases between K2-mma's stamps (csrc/epoch_mma.cu `Stamp`), in order
MMA_EPOCH_PHASES = ("hidden: z1, mask, d1, w2 and w3 to bf16", "barrier 1",
                    "rows: z2 to dz1; the next step's rows to bf16",
                    "barrier 2", "grads: gw1, gw2, gw3, biases, loss, SGD",
                    "barrier 3")


def mma_epoch_phase_stamps(params, xp, yp, seed_or_keys, lr: float,
                           batch: int, *, masks=None, rng_impl: str = "core",
                           valid_steps=None):
    """One epoch on K2-mma's stamps build (`-DEMMA_STAMPS`, ops/_build.py
    VARIANTS), which reads %globaltimer at each phase's end (the last
    block's) and after each grid barrier (block 0's). A debug entry on
    CUDA tensors, not counted in launch_count. Returns (params, losses,
    {phase: mean us a step}, mean us a step): the phases of
    MMA_EPOCH_PHASES, each averaged over the epoch's steps."""
    rng, nsteps, valid, _ = _check(params, xp, yp, seed_or_keys, batch,
                                   masks, rng_impl, 1, valid_steps)
    if xp.device.type != "cuda" or epoch_design(xp.dtype, True,
                                                batch) != "mma":
        raise ValueError("mma_epoch_phase_stamps runs K2-mma's form (uint8 "
                         "rows, bf16) on a CUDA device")
    p, losses, stamps = _mma_cuda(params, xp, yp, seed_or_keys, lr, batch,
                                  masks, rng, nsteps, 1, valid, 0,
                                  lib_name="epoch_mma_stamps")
    t = stamps.double()
    per_phase = (t[:, 1:] - t[:, :-1]).mean(0) / 1e3
    split = dict(zip(MMA_EPOCH_PHASES, per_phase.tolist()))
    return p, losses, split, float((t[:, -1] - t[:, 0]).mean()) / 1e3


# the phases between K6-ws's stamps (csrc/ring_ws.cu `K6Stamp` and its ring
# events), in order, at n replicas of `ring`
def k6_phases(ring: str, n: int) -> list:
    out = ["handshake signal + rows + z1 + mask + d1 out", "barrier 1",
           "d1 in + z2 + h2 out (handshake wait beside)", "barrier 2",
           "h2 in + logits + gw3 + dz2 + dd1 + gw2 + gw1, hop 0's stores"]
    signal = lambda h: ("signal hop 0" if h == 0  # noqa: E731
                        else f"store + signal hop {h}")
    out += [signal(0)] * (n > 1)
    if ring == "allgather":
        for h in range(n - 1):
            out.append(f"wait + load hop {h}")
            if h + 1 < n - 1:
                out.append(signal(h + 1))
        return out + ["sum + SGD"]
    for h in range(n - 1):
        out.append(f"wait + add hop {h}")
        if h + 1 < n - 1:
            out.append(signal(h + 1))
    for k in range(n - 1):
        if k > 0:
            out.append(f"wait + load hop {n - 2 + k}")
        out.append(signal(n - 1 + k))
    return out + [f"wait + load hop {2 * n - 3}", "SGD"]


def k6_phase_stamps(params, xp, yp, seed_or_keys, lr: float, batch: int, *,
                    masks=None, rng_impl: str = "core", axis_size: int,
                    ring: str = "auto"):
    """One n-replica epoch on K6-ws's stamps build (`-DK6_STAMPS`,
    ops/_build.py VARIANTS), which reads %globaltimer at the phase
    boundaries of block 0 of replica 0. Inputs as `epoch_fused_sgd` with
    `axis_size`. A debug entry on CUDA tensors, not counted in
    launch_count. Returns (params list, losses list, {phase: mean us a
    step}, mean us a step): the phases of `k6_phases(ring, n)`, each
    averaged over the epoch's steps."""
    ring, rng, params, xp, yp, seeds, masks, nsteps, valid = _check_dp(
        params, xp, yp, seed_or_keys, batch, masks, rng_impl, 1, None,
        axis_size, ring)
    if xp[0].device.type != "cuda" or ring_design(
            xp[0].dtype, False, batch, axis_size) != "ws":
        raise ValueError("k6_phase_stamps runs K6-ws's form (uint8 rows, "
                         "f32, B <= 128, n <= RING_WS_MAX_REPLICAS) on a "
                         "CUDA device")
    ps, ls, stamps = _ring_launch(params, xp, yp, seeds, masks, lr, batch,
                                  rng, valid, False, ring, 0, design="ws",
                                  lib_name="ring_ws_stamps")
    phases = k6_phases(ring, axis_size)
    used = _ring_ws_lib("ring_ws_stamps").pdmt_ring_ws_stamps_used(
        axis_size, int(ring == "reduce_scatter"))
    if used != len(phases) + 1:
        raise RuntimeError(f"ring_ws_stamps records {used} stamps a step; "
                           f"k6_phases names {len(phases) + 1}")
    t = stamps[:, :used].double()
    per_phase = (t[:, 1:] - t[:, :-1]).mean(0) / 1e3
    return (ps, ls, dict(zip(phases, per_phase.tolist())),
            float((t[:, -1] - t[:, 0]).mean()) / 1e3)


# the phases between K6-mma's stamps (csrc/ring_mma.cu `KmStamp`, its ring
# events, the update's end and replica barrier 3), in order, at n replicas
# of `ring`: K2-mma's three phases on block 0 of replica 0, its barriers as
# replica barriers, then K6-ws's ring events (`k6_phases`)
def k6_mma_phases(ring: str, n: int) -> list:
    return (["hidden: z1, mask, d1, w2 and w3 to bf16", "replica barrier 1",
             "rows: z2 to dz1", "replica barrier 2 + handshake wait",
             "grads: the tile's gradient into comm, hop 0's stores; the "
             "next step's rows to bf16"]
            + k6_phases(ring, n)[5:] + ["replica barrier 3"])


def k6_mma_phase_stamps(params, xp, yp, seed_or_keys, lr: float, batch: int,
                        *, masks=None, rng_impl: str = "core",
                        axis_size: int, ring: str = "auto"):
    """One n-replica epoch in the bf16 mode on K6-mma's stamps build
    (`-DK6M_STAMPS`, ops/_build.py VARIANTS), which reads %globaltimer at
    the phase boundaries of block 0 of replica 0. Inputs as
    `epoch_fused_sgd` with `axis_size`. A debug entry on CUDA tensors, not
    counted in launch_count. Returns (params list, losses list, {phase: mean
    us a step}, mean us a step): the phases of `k6_mma_phases(ring, n)`,
    each averaged over the epoch's steps."""
    ring, rng, params, xp, yp, seeds, masks, nsteps, valid = _check_dp(
        params, xp, yp, seed_or_keys, batch, masks, rng_impl, 1, None,
        axis_size, ring)
    if xp[0].device.type != "cuda" or ring_design(
            xp[0].dtype, True, batch, axis_size) != "mma":
        raise ValueError("k6_mma_phase_stamps runs K6-mma's form (uint8 "
                         "rows, bf16, B <= 128, n <= RING_MMA_MAX_REPLICAS) "
                         "on a CUDA device")
    ps, ls, stamps = _ring_launch(params, xp, yp, seeds, masks, lr, batch,
                                  rng, valid, True, ring, 0, design="mma",
                                  lib_name="ring_mma_stamps")
    phases = k6_mma_phases(ring, axis_size)
    used = _ring_mma_lib("ring_mma_stamps").pdmt_ring_mma_stamps_used(
        axis_size, int(ring == "reduce_scatter"))
    if used != len(phases) + 1:
        raise RuntimeError(f"ring_mma_stamps records {used} stamps a step; "
                           f"k6_mma_phases names {len(phases) + 1}")
    t = stamps[:, :used].double()
    per_phase = (t[:, 1:] - t[:, :-1]).mean(0) / 1e3
    return (ps, ls, dict(zip(phases, per_phase.tolist())),
            float((t[:, -1] - t[:, 0]).mean()) / 1e3)
