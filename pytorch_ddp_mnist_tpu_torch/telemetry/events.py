"""Structured JSONL event trace: schema-versioned records, nestable spans
(the port's copy of `pytorch_ddp_mnist_tpu/telemetry/events.py`; it writes
the same schema-v1 records, which `scripts/check_telemetry.py` validates).

One line per record, append-only, line-buffered — a trace survives a crash
up to its last completed record. Every record carries:

    v        schema version (SCHEMA_VERSION; checker rejects unknown)
    kind     "meta" | "span" | "point" | "snapshot"
    name     what the record describes ("serve.request", "registry")
    t_wall   wall-clock seconds (time.time — correlate across hosts/logs)
    t_mono   monotonic seconds (time.perf_counter — order/duration truth;
             non-decreasing within one run segment, checked). Files open
             in APPEND mode so a repeat run adds a new segment (fresh
             `trace_start`, fresh ids/clock) rather than losing the
             earlier trace.
    proc     process index (the torch.distributed rank, 0 outside a world)

Span records additionally carry `span` (id), `parent` (enclosing span's id
or null) and `dur_s`; `attrs` holds free-form per-record payload. A span is
ONE record emitted at exit (not a begin/end pair).

Spans are async-dispatch aware: on device work a naive wall pair measures
only enqueue time, so `span.sync(tree)` registers a tree of tensors whose
devices are synchronised at exit — strictly OPT-IN, so an instrumented
loop that never calls sync adds zero host syncs. `emit_span` publishes a
live span with explicit parentage (the serve path's overlapping requests).

The process-wide tracer is a no-op `NullTracer` until `enable()` swaps in
a real `EventTrace` — call sites never branch on "is telemetry on".
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Optional

from .runtime import process_index_cached

SCHEMA_VERSION = 1
KINDS = ("meta", "span", "point", "snapshot")


def cuda_devices(tree) -> set:
    """The devices of every CUDA tensor in a (nested dict / list / tuple)
    tree."""
    import torch
    stack, devices = [tree], set()
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif isinstance(t, torch.Tensor) and t.is_cuda:
            devices.add(t.device)
    return devices


def _synchronize(tree) -> None:
    """Wait for the devices of every CUDA tensor in a tree: the span's
    opt-in drain."""
    import torch
    for d in cuda_devices(tree):
        torch.cuda.synchronize(d)


class _Span:
    """Context manager for one live span; emitted as a single record at
    exit. `sync(tree)` opts into blocking on `tree` first (returns the tree
    unchanged)."""

    def __init__(self, trace: "EventTrace", name: str, attrs: dict):
        self._trace = trace
        self.name = name
        self.attrs = attrs
        self.span_id: Optional[int] = None
        self.parent_id: Optional[int] = None
        self._sync_tree: Any = None

    def sync(self, tree: Any) -> Any:
        self._sync_tree = tree
        return tree

    def __enter__(self) -> "_Span":
        self.span_id = self._trace._next_id()
        self.parent_id = self._trace._current_span_id()
        self._trace._stack.append(self.span_id)
        self._t0_mono = time.perf_counter()
        self._t0_wall = time.time()
        return self

    def __exit__(self, *exc) -> None:
        try:
            if self._sync_tree is not None:
                _synchronize(self._sync_tree)
        finally:
            # pop + emit even when the drain raises (device failure): an
            # unpopped id would corrupt every later span's parent, and the
            # recorded (enqueue-side) duration of the failed span is still
            # evidence
            self._finish()

    def _finish(self) -> None:
        dur = time.perf_counter() - self._t0_mono
        self._trace._stack.pop()
        attrs = dict(self.attrs)
        # span START stamps travel in attrs; the record's own t_mono/t_wall
        # are EMISSION time like every other record, keeping the whole file
        # non-decreasing in t_mono (a parent span's record is written after
        # its children even though it started first)
        attrs["t0_mono"] = self._t0_mono
        attrs["t0_wall"] = self._t0_wall
        self._trace._emit("span", self.name, span_id=self.span_id,
                          parent_id=self.parent_id, dur_s=dur,
                          attrs=attrs)


class EventTrace:
    """JSONL trace writer bound to one file. Not thread-safe by design —
    one trace per process (the module-level tracer), written from the train
    or serve loop's thread, exactly like the print-based epoch line."""

    enabled = True

    def __init__(self, path: str, *, process_index: Optional[int] = None):
        self.path = str(path)
        if process_index is None:
            process_index = process_index_cached()
        self.process_index = int(process_index)
        self._f = open(self.path, "a", buffering=1)  # line-buffered
        self._ids = 0
        self._stack: "list[int]" = []
        self._emit("meta", "trace_start",
                   attrs={"schema": SCHEMA_VERSION, "pid": os.getpid()})

    # -- record plumbing ---------------------------------------------------

    def _next_id(self) -> int:
        self._ids += 1
        return self._ids

    def _current_span_id(self) -> Optional[int]:
        return self._stack[-1] if self._stack else None

    def _emit(self, kind: str, name: str, *, span_id=None, parent_id=None,
              dur_s=None, attrs=None) -> None:
        if kind not in KINDS:  # writer-side guard, mirrored by the checker
            raise ValueError(f"unknown record kind {kind!r}")
        rec = {
            "v": SCHEMA_VERSION,
            "kind": kind,
            "name": name,
            "t_wall": time.time(),
            "t_mono": time.perf_counter(),
            "proc": self.process_index,
        }
        if span_id is not None:
            rec["span"] = span_id
            rec["parent"] = parent_id
            rec["dur_s"] = round(float(dur_s), 9)
        if attrs:
            rec["attrs"] = attrs
        if self._f.closed:
            return
        self._f.write(json.dumps(rec) + "\n")

    # -- public surface ----------------------------------------------------

    def span(self, name: str, **attrs) -> _Span:
        """Open a nestable span: `with trace.span("epoch", epoch=3) as s:`.
        Emits one record at exit; `s.sync(tree)` opts into a device drain
        first."""
        return _Span(self, name, attrs)

    def complete_span(self, name: str, dur_s: float, **attrs) -> None:
        """Emit an already-measured span (e.g. a cumulative timer total)
        under the currently open span — the per-phase aggregate pattern:
        data-wait/step-compute totals are accumulated per step but emitted
        once per epoch, so the trace grows per epoch, not per step."""
        self._emit("span", name, span_id=self._next_id(),
                   parent_id=self._current_span_id(), dur_s=dur_s,
                   attrs=attrs or None)

    def emit_span(self, name: str, *, t0_mono: float, t0_wall: float,
                  dur_s: float, parent: Optional[int] = None,
                  attrs: Optional[dict] = None) -> int:
        """Emit a LIVE span (real [t0, t0+dur] interval) with EXPLICIT
        parentage, outside the context-manager stack — the serve-path
        contract: concurrent requests overlap without nesting, so the
        stack's strict-containment invariant cannot hold for them; each
        caller-threaded context stamps its own interval and names its own
        parent (or none). Returns the allocated span id so a caller can
        parent further spans under it (the per-batch stage children).
        Stamps must be in this process's perf_counter/time.time frames —
        the structure validator checks t0_mono + dur_s against the
        record's own emission stamp."""
        sid = self._next_id()
        a = dict(attrs) if attrs else {}
        a["t0_mono"] = float(t0_mono)
        a["t0_wall"] = float(t0_wall)
        self._emit("span", name, span_id=sid, parent_id=parent,
                   dur_s=dur_s, attrs=a)
        return sid

    def point(self, name: str, **attrs) -> None:
        """One instantaneous event record."""
        self._emit("point", name, attrs=attrs or None)

    def snapshot(self, registry) -> None:
        """Stamp a full registry snapshot into the trace — the record a
        completed `--telemetry` train run closes with (a crashed run's
        trace legitimately lacks it; the checker validates schema, not
        run completeness)."""
        self._emit("snapshot", "registry", attrs=registry.snapshot())

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class NullTracer:
    """The disabled-telemetry tracer: every call is a no-op, and span()
    returns a no-op context manager whose sync() forwards its tree
    untouched — so instrumented call sites cost nothing and never force a
    host sync when telemetry is off."""

    class _NullSpan:
        name = None
        span_id = parent_id = None

        def sync(self, tree):
            return tree

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

    _SPAN = _NullSpan()
    # call sites that must not even BUILD their attrs payload when
    # telemetry is off (the serve request path) branch on this instead of
    # an isinstance check
    enabled = False

    def span(self, name: str, **attrs) -> "_NullSpan":
        return self._SPAN

    def complete_span(self, name: str, dur_s: float, **attrs) -> None:
        pass

    def emit_span(self, name: str, *, t0_mono: float, t0_wall: float,
                  dur_s: float, parent: Optional[int] = None,
                  attrs: Optional[dict] = None) -> int:
        return 0

    def point(self, name: str, **attrs) -> None:
        pass

    def snapshot(self, registry) -> None:
        pass

    def close(self) -> None:
        pass


_NULL = NullTracer()
_tracer = _NULL
# enable()/disable() are close-then-swap sequences on the process-wide
# tracer; the serve path's threads call get_tracer() concurrently with a
# CLI toggling telemetry, so the swap must be atomic. get_tracer() itself
# stays lock-free: it
# reads one reference, and a reader racing a swap gets either tracer,
# both valid.
_TRACER_LOCK = threading.Lock()


def get_tracer():
    """The process-wide tracer: a real EventTrace after `enable()`, the
    shared NullTracer otherwise."""
    return _tracer


def enable(out_dir: str, *, process_index: Optional[int] = None) -> EventTrace:
    """Switch the process-wide tracer to a real JSONL trace under
    `out_dir` (created if needed). Process 0 writes `events.jsonl`; other
    ranks write `events.rank{N}.jsonl` beside it — multi-host ranks cannot
    share a file, and the checker validates every `events*.jsonl` in the
    directory."""
    global _tracer
    if process_index is None:
        process_index = process_index_cached()
    os.makedirs(out_dir, exist_ok=True)
    name = ("events.jsonl" if process_index == 0
            else f"events.rank{process_index}.jsonl")
    with _TRACER_LOCK:
        if isinstance(_tracer, EventTrace):
            _tracer.close()
        _tracer = EventTrace(os.path.join(out_dir, name),
                             process_index=process_index)
        return _tracer


def disable() -> None:
    """Close any active trace and restore the no-op tracer."""
    global _tracer
    with _TRACER_LOCK:
        if isinstance(_tracer, EventTrace):
            _tracer.close()
        _tracer = _NULL
