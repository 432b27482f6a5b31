"""Data-parallel pieces: so far the sharded sampler (DDP is a later slice)."""
