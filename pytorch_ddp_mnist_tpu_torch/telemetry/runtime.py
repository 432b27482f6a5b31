"""Runtime collectors: process identity, capture counts and their
attribution, memory (the port of `pytorch_ddp_mnist_tpu/telemetry/runtime.py`,
with the JAX package's metric and record names).

Everything here observes state other subsystems already produce: no
collector forces device work, and every probe degrades to None or a no-op
where the backend does not expose it (the CPU has no `memory_stats`), so
telemetry can be enabled anywhere.

What JAX counts as a compile, the port counts as a CUDA-graph capture:
train/graphs.py `StepLoop` captures the training step once a fit and
reports each capture here (`note_capture`). The counter keeps the JAX
name, `xla.compiles`, and its durations go to `xla.compile_s`, so the
`[telemetry]` line's `xla_compiles` field and the JAX read side need no
change; in the port the field counts captures. A capture made inside a
`label_compiles(label)` block is also attributed to `label`
(`compile_attribution`, the per-program table of telemetry/costs.py):
the step loops capture under their loop's label, the serve engine each
rung under `serve.bucket<N>`.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

_process_index: Optional[int] = None
# guards this module's lazy singletons (the process index, the capture
# listener's one target, the attribution table)
_LOCK = threading.Lock()


def process_index_cached() -> int:
    """This process's rank in a torch.distributed world, resolved once and
    cached. Before the world is up it reads as rank 0 and is not cached,
    so the first call after `init_process_group` resolves the real rank."""
    global _process_index
    if _process_index is None:
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            return 0
        with _LOCK:
            if _process_index is None:
                _process_index = int(dist.get_rank())
    return _process_index


# -- capture counting --------------------------------------------------------

_compile_counter = None  # the one counter note_capture feeds
_compile_hist = None     # its sibling duration histogram
# label -> {"count": int, "total_s": float}: captures made while a
# `label_compiles` block was active on the capturing thread
_compile_attr: dict = {}
_compile_label = threading.local()


def install_compile_listener(registry=None,
                             counter_name: str = "xla.compiles",
                             hist_name: str = "xla.compile_s") -> bool:
    """Count the process's CUDA-graph captures into
    `registry.counter(counter_name)` and their durations into
    `registry.histogram(hist_name)`. One counter per process can be fed,
    as in the JAX package: a repeat install for the same target returns
    True, a different registry or counter False (not armed there, and no
    zero-reading counter is left behind)."""
    global _compile_counter, _compile_hist
    from .registry import get_registry
    reg = registry or get_registry()
    with _LOCK:
        if _compile_counter is not None:
            return reg._counters.get(counter_name) is _compile_counter
        _compile_counter = reg.counter(counter_name)
        _compile_hist = reg.histogram(hist_name)
        return True


def note_capture(seconds: float) -> None:
    """One CUDA-graph capture of `seconds` (train/graphs.py and
    serve/engine.py call it): the counter, the histogram and, inside a
    `label_compiles` block, the label's row of the attribution table,
    where the listener is installed; nothing otherwise."""
    counter, hist = _compile_counter, _compile_hist
    if counter is None:
        return
    counter.inc()
    hist.record(float(seconds))
    label = getattr(_compile_label, "value", None)
    if label:
        with _LOCK:
            slot = _compile_attr.setdefault(label,
                                            {"count": 0, "total_s": 0.0})
            slot["count"] += 1
            slot["total_s"] += float(seconds)


class label_compiles:
    """Context manager naming the program whose captures are about to run
    on THIS thread: each one is attributed to `label` in
    `compile_attribution()`. Nestable (the inner label wins, the outer is
    restored); costs nothing when the listener is not installed."""

    def __init__(self, label: str):
        self.label = str(label)
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_compile_label, "value", None)
        _compile_label.value = self.label
        return self

    def __exit__(self, *exc):
        _compile_label.value = self._prev
        return None


def current_compile_label() -> Optional[str]:
    """The innermost `label_compiles` label active on this thread (None
    outside any block): the OOM forensics name it."""
    return getattr(_compile_label, "value", None)


def compile_attribution() -> dict:
    """{label: {"count": n, "total_s": s}} of every labelled capture the
    listener has seen. Unlabelled captures are in the `xla.compiles` /
    `xla.compile_s` metrics only."""
    with _LOCK:
        return {k: dict(v) for k, v in _compile_attr.items()}


# -- memory ------------------------------------------------------------------

def device_memory_stats() -> Optional[dict]:
    """The current CUDA device's allocator picture under the JAX names
    (`bytes_in_use`, `peak_bytes_in_use`, `bytes_reserved`,
    `peak_bytes_reserved`, from `torch.cuda.memory_stats()`), or None with
    no CUDA (the CPU) or before the process has touched the card: a probe
    never initialises CUDA itself."""
    import torch
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    stats = torch.cuda.memory_stats()
    if not stats:
        return None
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
            "peak_bytes_reserved": int(stats.get("reserved_bytes.all.peak",
                                                 0))}


def host_rss_bytes() -> Optional[int]:
    """This process's resident set size in bytes (Linux /proc, with a
    getrusage fallback); None when neither source exists."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        import resource
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(rss) if os.uname().sysname == "Darwin" else int(rss) * 1024
    except (ImportError, AttributeError, OSError, ValueError):
        return None


def _device_mem_field(key: str) -> Optional[int]:
    stats = device_memory_stats()
    if stats and key in stats:
        return int(stats[key])
    return None


# the watermark gauges: live providers, so every scrape and snapshot reads
# the instant; None (the CPU) renders absent in Prometheus, null in
# snapshots
MEM_GAUGES = (
    ("mem.device_in_use_bytes", lambda: _device_mem_field("bytes_in_use")),
    ("mem.device_peak_bytes",
     lambda: _device_mem_field("peak_bytes_in_use")),
    ("mem.host_rss_bytes", host_rss_bytes),
)


def install_memory_watermarks(registry=None) -> None:
    """Bind the `mem.*` watermark gauges as live providers on `registry`.
    Idempotent."""
    from .registry import get_registry
    reg = registry or get_registry()
    for name, fn in MEM_GAUGES:
        reg.gauge(name).set_fn(fn)


def collect_memory(registry=None) -> dict:
    """Stamp the current memory picture into registry gauges and return it:
    `host.rss_bytes` always, `device.bytes_in_use` /
    `device.peak_bytes_in_use` when a card reports them; also installs the
    `mem.*` watermarks, so a snapshot after one collect carries them (the
    `--require mem.` gate)."""
    from .registry import get_registry
    reg = registry or get_registry()
    install_memory_watermarks(reg)
    out = {}
    rss = host_rss_bytes()
    if rss is not None:
        reg.gauge("host.rss_bytes").set(rss)
        out["host.rss_bytes"] = rss
    stats = device_memory_stats()
    if stats:
        for key in ("bytes_in_use", "peak_bytes_in_use"):
            reg.gauge(f"device.{key}").set(int(stats[key]))
            out[f"device.{key}"] = int(stats[key])
    return out


def record_memory_point(tracer, name: str = "mem_watermark") -> None:
    """One `mem_watermark` point carrying the current watermark values
    (the device's where a card reports them, host RSS always); the train
    loop calls it once an epoch. Host-side probes only: no device sync."""
    if not getattr(tracer, "enabled", False):
        return
    attrs = {}
    for key, fn in MEM_GAUGES:
        v = fn()
        if v is not None:
            attrs[key] = v
    if attrs:
        tracer.point(name, **attrs)
