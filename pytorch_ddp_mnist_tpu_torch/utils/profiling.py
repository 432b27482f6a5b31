"""Timing and profiler capture (the port of
`pytorch_ddp_mnist_tpu/utils/profiling.py`).

  * `CumulativeTimer`: wall time summed over repeated host sections (the
    streaming loop's loader wait and step dispatch). With `registry=`
    every section also lands in the `timer.{name}_s` histogram.
  * `trace(logdir)`: a `torch.profiler` session over the enclosed block
    (the CPU and, on a card, CUDA activity), written into `logdir` as a
    Chrome trace (`trace.<pid>.json`, viewable in Perfetto or
    chrome://tracing). The JAX package's XPlane protos have no
    counterpart here.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional


class CumulativeTimer:
    """Accumulates wall time over repeated sections (loader wait against
    step time inside an epoch).

        t = CumulativeTimer("io")
        for ...:
            with t:
                batch = next(loader)
        t.total, t.count, t.mean

    With `registry=`, every section also records into the `timer.{name}_s`
    histogram."""

    def __init__(self, name: str = "section", registry=None):
        self.name = name
        self.total = 0.0
        self.count = 0
        self._hist = (registry.histogram(f"timer.{name}_s")
                      if registry is not None else None)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def __enter__(self) -> "CumulativeTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self._t0
        self.total += dt
        self.count += 1
        if self._hist is not None:
            self._hist.record(dt)

    def __repr__(self) -> str:
        return (f"CumulativeTimer({self.name}: total={self.total:.4f}s "
                f"count={self.count} mean={self.mean * 1e3:.3f}ms)")


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """A `torch.profiler` session over the enclosed block, its Chrome trace
    written to `logdir/trace.<pid>.json` when the block ends (also when it
    raises); a no-op when `logdir` is falsy, so call sites need no branch.
    CUDA activity is recorded where a card is available."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(str(logdir), exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(
            os.path.join(str(logdir), f"trace.{os.getpid()}.json"))
