"""The reference's own CPU random streams: torch's MT19937 `randperm` (the
`DistributedSampler` shuffle) and `bernoulli_` (the `nn.Dropout` mask).

The reference shards its epoch by `torch.randperm(n, generator=g)` with a
CPU `torch.Generator` seeded `seed + epoch` inside `DistributedSampler`
(ddp_tutorial_multi_gpu.py:26-30, re-keyed by sampler.set_epoch at :81),
and `nn.Dropout(0.2)` draws `bernoulli_(0.8)` from the global CPU
generator (ddp_tutorial_cpu.py:47).

`TorchMT19937`, `torch_randperm_plain` and `torch_bernoulli_plain` are a
copy of the JAX package's numpy engine (`pytorch_ddp_mnist_tpu/parallel/
torch_rng.py`): they define the stream and are its plain version. The port
draws both streams with torch's own CPU generator, whose draws are the
copy's bit for bit (tests/test_torch_port_streams.py holds them against
each other, and chip_smoke.py checks the card machine's torch build):
`torch_randperm` is one `torch.randperm` call where the copy's swap loop
runs in Python (~37 ms an epoch at n = 60,000 on this repository's CPU
test host), and `MaskStream` draws its masks with `bernoulli_` on a
seeded generator.

The copy's notes: a CPU `torch.Generator().manual_seed(s)` is the classic
Mersenne Twister (init_genrand seeding, 624-word state, standard
tempering); CPU `randperm` is a Fisher-Yates pass drawing one 32-bit word
a position (`r[i] <-> r[i + mt() % (n - i)]`); CPU `bernoulli_(p)` draws a
64-bit word an element (two engine outputs, the first the high word),
keeps its low 53 bits as a double in [0, 1) and keeps the element iff it
is < p. The twist is vectorised per 624-word block, split where the
in-place recurrence reads words written earlier in the same twist.
"""

from __future__ import annotations

import numpy as np
import torch

_N, _M = 624, 397
_UPPER = np.uint32(0x80000000)        # most significant w-r bits
_LOWER = np.uint32(0x7FFFFFFF)        # least significant r bits
_MATRIX_A = np.uint32(0x9908B0DF)


class TorchMT19937:
    """`at::mt19937` with init_genrand seeding: the engine behind a CPU
    `torch.Generator().manual_seed(seed)`. Yields the same uint32 stream."""

    def __init__(self, seed: int):
        st = np.empty(_N, np.uint32)
        s = int(seed) & 0xFFFFFFFF
        st[0] = s
        for j in range(1, _N):
            s = (1812433253 * (s ^ (s >> 30)) + j) & 0xFFFFFFFF
            st[j] = s
        self._state = st
        self._pos = _N                 # force a twist before the first draw

    def _twist(self) -> None:
        s = self._state
        new = np.empty(_N, np.uint32)
        y = (s & _UPPER) | (np.concatenate([s[1:], s[:1]]) & _LOWER)
        f = (y >> np.uint32(1)) ^ np.where(
            (y & np.uint32(1)).astype(bool), _MATRIX_A, np.uint32(0))
        # i in [0, N-M): sources old state only
        new[:_N - _M] = s[_M:] ^ f[:_N - _M]
        # i in [N-M, N-1): new[i] = new[i-(N-M)] ^ f[i] — each 227-word
        # stripe depends on the stripe just written, so update stripe-wise
        i = _N - _M
        while i < _N - 1:
            j = min(i + (_N - _M), _N - 1)
            new[i:j] = new[i - (_N - _M):j - (_N - _M)] ^ f[i:j]
            i = j
        # i = N-1: y reads the NEW word 0 (the in-place recurrence)
        y_last = (s[_N - 1] & _UPPER) | (new[0] & _LOWER)
        f_last = (y_last >> np.uint32(1)) ^ (
            _MATRIX_A if (int(y_last) & 1) else np.uint32(0))
        new[_N - 1] = new[_M - 1] ^ f_last
        self._state = new
        self._pos = 0

    def draws(self, k: int) -> np.ndarray:
        """The next `k` tempered uint32 outputs, vectorised per block."""
        out = np.empty(k, np.uint32)
        filled = 0
        while filled < k:
            if self._pos >= _N:
                self._twist()
            take = min(k - filled, _N - self._pos)
            y = self._state[self._pos:self._pos + take].copy()
            y ^= y >> np.uint32(11)
            y ^= (y << np.uint32(7)) & np.uint32(0x9D2C5680)
            y ^= (y << np.uint32(15)) & np.uint32(0xEFC60000)
            y ^= y >> np.uint32(18)
            out[filled:filled + take] = y
            self._pos += take
            filled += take
        return out

    def skip(self, k: int) -> None:
        """Advance the stream by `k` outputs without keeping them, a chunk
        at a time (the fast-forward of a resumed mask stream)."""
        while k > 0:
            take = min(k, 1 << 20)
            self.draws(take)
            k -= take


def torch_randperm_plain(n: int, seed: int) -> np.ndarray:
    """`torch.randperm(n, generator=manual_seed(seed))` on the CPU from the
    copy's engine: one word a position, folded modulo the shrinking tail
    (torch's draw order, modulo bias and all)."""
    n = int(n)
    r = np.arange(n, dtype=np.int64)
    if n < 2:
        return r
    z = TorchMT19937(seed).draws(n - 1)
    for i in range(n - 1):
        j = i + int(z[i]) % (n - i)
        if j != i:
            r[i], r[j] = r[j], r[i]
    return r


def torch_bernoulli_plain(gen: TorchMT19937, n: int, p: float) -> np.ndarray:
    """`tensor.bernoulli_(p)` on a CPU float tensor from the copy's engine:
    `n` {0, 1} float32 values in element order, two engine words each."""
    d = gen.draws(2 * n).astype(np.uint64)
    x = (d[0::2] << np.uint64(32)) | d[1::2]
    u = (x & np.uint64((1 << 53) - 1)).astype(np.float64) * (2.0 ** -53)
    return (u < p).astype(np.float32)


def _generator(seed: int) -> torch.Generator:
    return torch.Generator(device="cpu").manual_seed(int(seed) & 0xFFFFFFFF)


def torch_randperm(n: int, seed: int) -> np.ndarray:
    """`torch.randperm(n)` on a CPU generator seeded `seed`, as int64 numpy
    (bitwise torch_randperm_plain)."""
    return torch.randperm(int(n), generator=_generator(seed)).numpy()


class MaskStream:
    """The reference's dropout mask stream: torch's CPU `bernoulli_(keep)`
    on a generator seeded `seed`, drawn in element order, call after call
    (bitwise torch_bernoulli_plain on a TorchMT19937(seed))."""

    def __init__(self, seed: int):
        self._gen = _generator(seed)

    def draw(self, n: int, p: float) -> np.ndarray:
        """The next `n` {0, 1} float32 values, each 1 with probability p."""
        return torch.empty(int(n), dtype=torch.float32).bernoulli_(
            p, generator=self._gen).numpy()

    def skip(self, n: int) -> None:
        """Pass over the next `n` values (2 n engine words: bitwise
        `TorchMT19937.skip(2 n)`), drawn and dropped a chunk at a time:
        the position of a resumed run's stream."""
        buf = torch.empty(min(int(n), 1 << 20), dtype=torch.float32)
        while n > 0:
            take = min(n, buf.numel())
            buf[:take].bernoulli_(0.5, generator=self._gen)
            n -= take
