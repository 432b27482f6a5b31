"""Data-parallel pieces: the sharded sampler and the reference's torch
streams, the replica mesh, the DDP steps and the multi-process wireup."""
