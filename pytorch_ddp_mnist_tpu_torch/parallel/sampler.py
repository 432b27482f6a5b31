"""Epoch-seeded sharded sampler with DistributedSampler semantics (port of
`pytorch_ddp_mnist_tpu/parallel/sampler.py`).

  1. one GLOBAL permutation of [0, n) seeded by (seed + epoch), seed=42 —
     every rank computes the same one, from numpy's PCG64 (`pcg64`, the
     default) or torch's CPU MT19937 `randperm` (`torch`, `--sampler_rng
     torch`: DistributedSampler's own shuffle, so an epoch's shards are a
     live reference run's index for index; parallel/torch_rng.py);
  2. padding by repetition of the permutation's head up to
     ceil(n / world) * world;
  3. round-robin split: rank r takes indices[r::world];
  4. reshuffle each epoch through set_epoch(e).

The indices are bitwise those of the JAX package's sampler in both modes.
`reshard` re-splits the same global order under another world.
"""

from __future__ import annotations

import math

import numpy as np

from .torch_rng import torch_randperm


class ShardedSampler:
    def __init__(self, num_samples: int, *, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 42,
                 permutation: str = "pcg64"):
        if not (0 <= rank < num_replicas):
            raise ValueError(f"rank {rank} out of range for {num_replicas} replicas")
        if permutation not in ("pcg64", "torch"):
            raise ValueError(f"permutation must be 'pcg64' (default) or "
                             f"'torch' (torch's CPU MT19937 randperm); got "
                             f"{permutation!r}")
        self.num_samples = int(num_samples)
        self.num_replicas = int(num_replicas)
        self.rank = int(rank)
        self.shuffle = shuffle
        self.seed = int(seed)
        self.permutation = permutation
        self.epoch = 0
        # Per-rank sample count after padding (DistributedSampler.num_samples).
        self.samples_per_replica = math.ceil(self.num_samples / self.num_replicas)
        self.total_size = self.samples_per_replica * self.num_replicas

    def set_epoch(self, epoch: int) -> None:
        """Re-key the shuffle for a new epoch (DistributedSampler.set_epoch)."""
        self.epoch = int(epoch)

    def reshard(self, num_replicas: int, rank: int) -> "ShardedSampler":
        """A new sampler over the same dataset, seed and permutation source
        at another world geometry, at the same epoch: the global order is a
        function of seed + epoch alone, so the new shards still cover the
        epoch exactly."""
        out = ShardedSampler(self.num_samples, num_replicas=num_replicas,
                             rank=rank, shuffle=self.shuffle, seed=self.seed,
                             permutation=self.permutation)
        out.set_epoch(self.epoch)
        return out

    def global_permutation(self) -> np.ndarray:
        """The padded global order all ranks agree on this epoch."""
        if self.shuffle and self.permutation == "torch":
            idx = torch_randperm(self.num_samples, self.seed + self.epoch)
        elif self.shuffle:
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
