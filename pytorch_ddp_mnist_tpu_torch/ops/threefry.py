"""jax's threefry-2x32 stream in plain PyTorch (port of `threefry2x32`,
`_threefry_mask_block` and `dropout_mask` of
`pytorch_ddp_mnist_tpu/ops/pallas_step.py`, plus the key chain the
resident-dataset trainer needs, `fold_in` for the data-parallel ones, and
the per-step loops' key table, which their steps read on the device).

Every function here is bit for bit what jax computes under its default
partitionable threefry (jax >= 0.5), so the port's masks are the JAX
package's masks for the same key, and `csrc/epoch_step.cu` draws the same
bits inside the kernel (the K3 form).

uint32 arithmetic is written so that it runs unchanged on Python ints and
on int64 tensors holding values in [0, 2**32): every sum and shift is
masked back to 32 bits (torch's uint32 tensors have too few operators).
Keys are `(k0, k1)` tuples of Python ints, the two words of
`jax.random.key_data`.
"""

from __future__ import annotations

import torch

from ..models.mlp import DROPOUT_RATE, MLP_DIMS

HIDDEN1 = MLP_DIMS[1]
M32 = 0xFFFFFFFF

# Threefry-2x32 rotation schedule (Random123 / jax._src.prng): 5 groups of
# 4 rounds, alternating the two lists, with a key injection after each group
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & M32


def threefry2x32(k0, k1, x0, x1):
    """The threefry-2x32 block cipher of jax.random: key words (k0, k1),
    counter words (x0, x1) -> two output words. Arguments are Python ints or
    int64 tensors of uint32 values (broadcast together)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in (_ROT_A if i % 2 == 0 else _ROT_B):
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def key_data(seed: int) -> tuple:
    """`jax.random.key_data(jax.random.key(seed))` for the threefry impl in
    jax's default 32-bit mode: (0, seed mod 2**32). Seeds outside
    [-2**31, 2**32) are refused: there jax's answer depends on its x64
    flag."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 32):
        raise ValueError(f"seed {seed} outside [-2**31, 2**32): jax's key "
                         f"words for it depend on jax_enable_x64")
    return (0, seed & M32)


def split(key, n: int = 2) -> list:
    """`jax.random.split(key, n)` as n key tuples. Under partitionable
    threefry, split i is both outputs of threefry2x32(k0, k1, 0, i)."""
    k0, k1 = key
    return [threefry2x32(k0, k1, 0, i) for i in range(n)]


def fold_in(key, data: int) -> tuple:
    """`jax.random.fold_in(key, data)` for a threefry key: jax hashes the
    key with the counter words (0, data mod 2**32), i.e.
    threefry2x32(k0, k1, 0, data). Every data-parallel path folds the
    replica index into its key this way."""
    k0, k1 = key
    return threefry2x32(k0, k1, 0, int(data) & M32)


def to_int32_words(keys) -> torch.Tensor:
    """Key tuples (or an (n, 2) int tensor of key words) -> the (n, 2)
    int32 table the epoch kernel takes: the words' bits, as
    `key_data(...).astype(int32)` gives them, on the input's device."""
    t = torch.as_tensor(keys, dtype=torch.int64).reshape(-1, 2) & M32
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(
        torch.int32).contiguous()


def step_keys(key, nsteps: int, fold=None) -> tuple:
    """The per-step loops' key chain over `nsteps` steps: per step `key,
    sub = split(key)`, as the JAX trainers split it. Returns (the key after
    the steps, the steps' keys): `sub` a step, or with `fold` (global
    replica indices) `[fold_in(sub, g) for g in fold]` a step, the keys of
    a data-parallel step's replicas."""
    subs = []
    for _ in range(nsteps):
        key, sub = split(key)
        subs.append(sub if fold is None else [fold_in(sub, g) for g in fold])
    return key, subs


def step_key_words(key, nsteps: int, fold=None, start: int = 0) -> tuple:
    """`step_keys` as the int32 words of a key table, on the host: (the key
    after the steps, an (nsteps, 2) table, or (nsteps, len(fold), 2) with
    `fold`). The per-step loops write it into the static key buffer their
    captured step reads (train/graphs.py `StaticInput`): step s reads row
    s (its replica r: row (s, r)). `start` > 0 is a resumed epoch: `key` is
    the key after `start` steps, rows start.. are the steps from there,
    the rows before it zero (never read)."""
    key, subs = step_keys(key, nsteps - start, fold)
    shape = (nsteps, 2) if fold is None else (nsteps, len(fold), 2)
    words = torch.zeros((start,) + shape[1:], dtype=torch.int32)
    if nsteps > start:
        words = torch.cat([words, to_int32_words(subs).reshape(
            (nsteps - start,) + shape[1:])])
    return key, words


def step_key_table(key, nsteps: int, device="cpu", fold=None,
                   start: int = 0) -> tuple:
    """`step_key_words` as a table on `device`, copied there once: (the key
    after the steps, the table). The loops that run eagerly (a world of
    processes, a mesh across cards, a step taken from a host key) read it;
    the captured loops load the words into their static buffer instead."""
    key, table = step_key_words(key, nsteps, fold, start)
    device = torch.device(device)
    if device.type == "cuda":
        # pinned + non_blocking: the copy queues on the stream the steps
        # launch on, and the host does not wait for it
        return key, table.pin_memory().to(device, non_blocking=True)
    return key, table.to(device)


def words_key(words) -> tuple:
    """A key-table row (int32 words, on the CPU) as the (k0, k1) key."""
    k0, k1 = (int(w) & M32 for w in words.tolist())
    return (k0, k1)


def uniform_keep(bits: torch.Tensor) -> torch.Tensor:
    """jax's uniform-then-bernoulli on 32 random bits (int64 tensor): the
    mantissa fill ((bits >> 9) | 0x3f800000, bitcast, -1, max 0), then
    `u < f32(keep)`, then the inverted-dropout scale f32(1)/f32(keep).
    Returns the pre-scaled f32 mask: 1.25 or 0."""
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    u = torch.clamp_min(u - 1.0, 0.0)
    keep = torch.tensor(1.0 - DROPOUT_RATE, dtype=torch.float32)
    scale = torch.tensor(1.0, dtype=torch.float32) / keep
    zero = torch.zeros((), dtype=torch.float32)
    return torch.where(u < keep, scale.to(u.device), zero.to(u.device))


def mask_block(k0: int, k1: int, rows: int, device="cpu") -> torch.Tensor:
    """(rows, 128) pre-scaled dropout mask, bit for bit `dropout_mask(key,
    rows)` of the JAX package: counter words (0, row * 128 + col), bits =
    out0 ^ out1, then `uniform_keep`."""
    idx = torch.arange(rows * HIDDEN1, dtype=torch.int64, device=device)
    o0, o1 = threefry2x32(k0, k1, torch.zeros_like(idx), idx)
    return uniform_keep(o0 ^ o1).reshape(rows, HIDDEN1)


def dropout_mask(key, batch: int, device="cpu", *, train: bool = True):
    """The pre-scaled (batch, 128) f32 mask jax's `dropout_mask(key,
    batch)` gives for this threefry key; ones when `train` is False."""
    if not train:
        return torch.ones((batch, HIDDEN1), dtype=torch.float32, device=device)
    return mask_block(key[0], key[1], batch, device)


def _word_pair(words: torch.Tensor):
    """An (..., 2) int tensor of key words -> (k0, k1) int64 tensors of
    their uint32 values, on the words' device (no host round trip)."""
    k = words.to(torch.int64) & M32
    return k[..., 0], k[..., 1]


def random_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.bits(key, (n,), uint32)` for the key(s) in `words` (an
    (..., 2) int tensor of key words, on any device): per element i the
    counter words (0, i), bits = out0 ^ out1, as uint32 values in an int64
    tensor of shape (..., n). Plain tensor ops on the words' device, so a
    captured step can draw them from keys in device memory."""
    k0, k1 = _word_pair(words)
    idx = torch.arange(n, dtype=torch.int64, device=words.device)
    o0, o1 = threefry2x32(k0[..., None], k1[..., None], torch.zeros_like(idx),
                          idx)
    return o0 ^ o1


def keep_from_words(words: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """The (rows, cols) bool keep draw of jax's `bernoulli(key, 0.8,
    (rows, cols))` for the key in `words` ((2,) int words on any device):
    `uniform(bits) < f32(0.8)`, as `uniform_keep` computes it, in plain
    tensor ops on the words' device (the zoo's hidden widths other than
    the mask entry's 128)."""
    bits = random_bits(words, rows * cols)
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    u = torch.clamp_min(u - 1.0, 0.0)
    return (u < 1.0 - DROPOUT_RATE).reshape(rows, cols)


def fold_in_words(words: torch.Tensor, data) -> torch.Tensor:
    """`fold_in` of the key(s) in `words` (an (..., 2) int tensor) with
    `data` (an int, or an int64 tensor broadcast against the keys), as
    (..., 2) int64 words on the same device."""
    k0, k1 = _word_pair(words)
    d = data if isinstance(data, torch.Tensor) else torch.full(
        (), int(data) & M32, dtype=torch.int64, device=words.device)
    o0, o1 = threefry2x32(k0, k1, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def split_words(words: torch.Tensor, n: int) -> torch.Tensor:
    """`split(key, n)` of the key(s) in `words` ((..., 2)) -> (..., n, 2)
    int64 words on the same device."""
    idx = torch.arange(n, dtype=torch.int64, device=words.device)
    return fold_in_words(words[..., None, :], idx)
