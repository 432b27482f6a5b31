"""The port's in-kernel dropout stream for the TPU core PRNG: Philox4x32-10.

The JAX package draws two kinds of masks from the TPU core PRNG, a
hardware generator with no CUDA twin: the epoch kernel's `rng="core"` form
(`pltpu.prng_seed(seed, step)`) and the per-step kernel's `pallas_rng` form
(`pltpu.prng_seed(seed, batch block)`). The port draws both from
Philox4x32-10 (Salmon et al., SC'11; the Random123 constants) instead:

    key = (epoch seed, global step)       the epoch kernel (`mask_block`)
    key = (step seed, batch block)        the per-step kernel (`rng_mask`)
    counter = (row * 128 + col, replica, 0, 0), row within the step or
    block, replica the data-parallel ring's replica (K6, the TPU's
    `prng_seed(seed, me, step)`; 0 everywhere else),
    bits = output word 0, keep iff bits < _KEEP_THRESH, value 1/keep.

It is the port's own stream with the same Bernoulli keep distribution, as
`train/scan.py` of the JAX package says of rbg against threefry: the same
seed gives other masks than the TPU, and no test compares the two bitwise.
`csrc/mlp_step.cuh` computes the same function as a device function; the
card checks the two bit for bit.

Like `ops/threefry.py`, the arithmetic runs on Python ints and on int64
tensors of uint32 values: the 32x32 -> 64-bit products are taken in 16-bit
halves so that no intermediate leaves int64.
"""

from __future__ import annotations

import torch

from ..models.mlp import DROPOUT_RATE, MLP_DIMS

HIDDEN1 = MLP_DIMS[1]
M32 = 0xFFFFFFFF
# rows per batch block of the per-step kernel's grid (pallas_step.py
# MAX_BATCH_BLOCK)
MAX_BATCH_BLOCK = 512
# P(bits < _KEEP_THRESH) = 1 - DROPOUT_RATE for uniform uint32 bits
# (pallas_step.py `_KEEP_THRESH`)
KEEP_THRESH = int(round((1.0 - DROPOUT_RATE) * 2**32))

_M0, _M1 = 0xD2511F53, 0xCD9E8D57      # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85      # key bumps (golden ratio, sqrt(3)-1)
ROUNDS = 10


def _mulhilo(a: int, b):
    """(hi, lo) 32-bit words of the 64-bit product a * b (a a constant)."""
    t1 = (a & 0xFFFF) * b            # < 2**48
    t2 = (a >> 16) * b               # < 2**48
    mid = t1 + ((t2 & 0xFFFF) << 16)  # < 2**49
    return ((t2 >> 16) + (mid >> 32)) & M32, mid & M32


def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = ROUNDS):
    """Philox4x32-`rounds` of counter (c0..c3) under key (k0, k1) -> four
    output words (Random123's philox4x32_R)."""
    for r in range(rounds):
        if r:
            k0 = (k0 + _W0) & M32
            k1 = (k1 + _W1) & M32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def mask_block(seed: int, step: int, rows: int, device="cpu", *,
               replica: int = 0) -> torch.Tensor:
    """(rows, 128) pre-scaled mask of global step `step` under epoch seed
    `seed` (both taken mod 2**32), for ring replica `replica` (counter word
    1; 0 is the single-replica stream): 1/keep where the element's Philox
    word is below KEEP_THRESH, else 0. The scale is f32(1.0 / (1.0 -
    DROPOUT_RATE)), the expression of the JAX core form."""
    idx = torch.arange(rows * HIDDEN1, dtype=torch.int64, device=device)
    zero = torch.zeros_like(idx)
    bits = philox4x32(idx, torch.full_like(idx, int(replica) & M32), zero,
                      zero, int(seed) & M32, int(step) & M32)[0]
    keep = torch.tensor(1.0 / (1.0 - DROPOUT_RATE), dtype=torch.float32,
                        device=device)
    return torch.where(bits < KEEP_THRESH, keep,
                       torch.zeros((), dtype=torch.float32, device=device)
                       ).reshape(rows, HIDDEN1)


def batch_blocks(batch: int) -> tuple:
    """(grid, block) of the per-step kernel's batch grid, `_run_fused`'s
    own: the fewest blocks of at most MAX_BATCH_BLOCK rows, the rows spread
    evenly over them and rounded up to a multiple of 8."""
    grid = max(1, -(-batch // MAX_BATCH_BLOCK))
    block = -(-(-(-batch // grid)) // 8) * 8
    return grid, block


def rng_mask(seed: int, batch: int, device="cpu") -> torch.Tensor:
    """(batch, 128) pre-scaled mask of the per-step kernel's in-kernel draw
    for the step seed `seed` (taken mod 2**32): batch block b of
    `batch_blocks(batch)` is `mask_block(seed, b, block)`, and the rows past
    `batch` of the last block are dropped."""
    grid, block = batch_blocks(batch)
    blocks = [mask_block(seed, b, block, device) for b in range(grid)]
    return torch.cat(blocks)[:batch]
