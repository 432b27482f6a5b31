"""Epoch-seeded sharded sampler with DistributedSampler semantics (port of
`pytorch_ddp_mnist_tpu/parallel/sampler.py`, the `pcg64` permutation).

  1. one GLOBAL permutation of [0, n) seeded by (seed + epoch), seed=42 —
     every rank computes the same one, from numpy's PCG64;
  2. padding by repetition of the permutation's head up to
     ceil(n / world) * world;
  3. round-robin split: rank r takes indices[r::world];
  4. reshuffle each epoch through set_epoch(e).

The indices are bitwise those of the JAX package's sampler. The torch
MT19937 `randperm` source (`permutation="torch"`) belongs to a later slice
and is rejected by name.
"""

from __future__ import annotations

import math

import numpy as np


class ShardedSampler:
    def __init__(self, num_samples: int, *, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 42,
                 permutation: str = "pcg64"):
        if not (0 <= rank < num_replicas):
            raise ValueError(f"rank {rank} out of range for {num_replicas} replicas")
        if permutation != "pcg64":
            raise ValueError(
                f"permutation={permutation!r} is not ported to the PyTorch "
                f"package yet (ROADMAP.md queue 1, item 3); only 'pcg64'")
        self.num_samples = int(num_samples)
        self.num_replicas = int(num_replicas)
        self.rank = int(rank)
        self.shuffle = shuffle
        self.seed = int(seed)
        self.epoch = 0
        # Per-rank sample count after padding (DistributedSampler.num_samples).
        self.samples_per_replica = math.ceil(self.num_samples / self.num_replicas)
        self.total_size = self.samples_per_replica * self.num_replicas

    def set_epoch(self, epoch: int) -> None:
        """Re-key the shuffle for a new epoch (DistributedSampler.set_epoch)."""
        self.epoch = int(epoch)

    def global_permutation(self) -> np.ndarray:
        """The padded global order all ranks agree on this epoch."""
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            idx = rng.permutation(self.num_samples)
        else:
            idx = np.arange(self.num_samples)
        pad = self.total_size - self.num_samples
        if pad > 0:
            # torch repeats indices[:padding], cycling when padding exceeds n
            reps = np.resize(idx, pad) if pad > idx.size else idx[:pad]
            idx = np.concatenate([idx, reps])
        return idx

    def indices(self) -> np.ndarray:
        """This rank's shard for the current epoch: global_perm[rank::world]."""
        return self.global_permutation()[self.rank::self.num_replicas]

    def __len__(self) -> int:
        return self.samples_per_replica

    def __iter__(self):
        return iter(self.indices())
