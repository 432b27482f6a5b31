"""Dispatch forensics: the per-step host-timeline profiler that splits the
step boundary into named phases (the port of
`pytorch_ddp_mnist_tpu/telemetry/dispatch.py`; the phases, metric names
and point records are the JAX module's).

  * ``python_prestep``: loop bookkeeping between one step's call
    returning and the next one's being entered (the batch handoff,
    journal stamps, Python glue);
  * ``dispatch``: inside the step's call until it returns: on a captured
    loop the `graph.replay()` (train/graphs.py `StepLoop.step`), on an
    eager loop the step's launches;
  * ``device_idle``: the device's view of the same boundary: how long the
    queue sits empty between consecutive steps. It needs a drain, so it
    is sampled 1-in-K (``sample_every``): a synchronisation on the devices
    of the PREVIOUS step's outputs, after which the bracket is
    re-stamped, so the drain pollutes neither ``python_prestep`` nor
    ``dispatch``. The drain refuses to run while a CUDA graph is being
    captured on the current stream;
  * ``sync_wait``: the per-epoch (per-chunk) loss fetch, the one sync the
    loop already performs.

Per-step samples land in ``dispatch.<phase>`` registry histograms and the
flight ring; per-epoch totals flush as two trace ``point`` kinds,
``dispatch_phase`` (one a phase) and ``dispatch_window`` (window against
attributed seconds).

The default is ``NullProfiler``: every hook a no-op and no host sync, so
the instrumented loops never branch.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from . import flight
from .analysis import (DISPATCH_COVERAGE_PHASES, DISPATCH_PHASE_POINT,
                       DISPATCH_PHASES, DISPATCH_WINDOW_POINT)
from .events import cuda_devices, get_tracer
from .registry import get_registry

# sampled-drain default: probe the device-idle gap on 1-in-16 steps
DEFAULT_SAMPLE_EVERY = 16

# the drains this process's profilers made (the tests and chip_smoke.py
# count them against the steps)
counts = {"drains": 0}


def drain(tree: Any) -> None:
    """Wait for the work queued on the current stream of each device that
    holds a CUDA tensor of `tree` (a nested dict / list / tuple): the
    sampled device-idle bracket, one stream synchronisation a device.
    Refuses, by name, inside a CUDA-graph capture on the current stream,
    where a synchronisation would invalidate it."""
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized() \
            and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the dispatch profiler's device-idle drain ran "
                           "inside a CUDA-graph capture; it belongs between "
                           "replays")
    counts["drains"] += 1
    for d in cuda_devices(tree):
        torch.cuda.current_stream(d).synchronize()


class NullProfiler:
    """The default: every hook a no-op, so the profiler-off path performs
    no host sync and trains bitwise as it would without the hooks."""

    armed = False

    def mark_prestep(self) -> None:
        pass

    def begin_dispatch(self, sync_tree: Any = None) -> None:
        pass

    def end_dispatch(self, step: int) -> None:
        pass

    def note_sync_wait(self, seconds: float) -> None:
        pass

    def flush_epoch(self, epoch: int, *, steps: int,
                    step_total_s: Optional[float] = None) -> None:
        pass


class DispatchProfiler(NullProfiler):
    """Per-step host-timeline profiler. The loop calls, in step order::

        prof.mark_prestep()              # top of the loop body
        prof.begin_dispatch(prev_out)    # just before the step's call
        step(...)                        # the launches / the replay
        prof.end_dispatch(step_idx)      # just after it returns
        ...
        prof.note_sync_wait(fetch_s)     # the per-epoch loss fetch
        prof.flush_epoch(epoch, steps=n, step_total_s=loop_timer_total)

    ``begin_dispatch``'s ``sync_tree`` holds tensors the previous step
    wrote (the params it updated in place); on a sampled 1-in-K step
    their devices are drained so the device-idle bracket starts from an
    empty queue. ``step_total_s`` at the flush hands over the loop's own
    step-timer total as the window's denominator, an independent clock.
    """

    armed = True

    def __init__(self, registry=None, tracer=None,
                 sample_every: int = DEFAULT_SAMPLE_EVERY):
        self._registry = registry
        self._tracer = tracer
        self.sample_every = max(0, int(sample_every))
        self._hists: Dict[str, Any] = {}
        self._t_pre: Optional[float] = None
        self._t_d0: Optional[float] = None
        self._t_idle0: Optional[float] = None
        self._n_steps = 0          # lifetime step counter (sampling phase)
        self._reset_epoch()

    def _reset_epoch(self) -> None:
        self._totals = {phase: 0.0 for phase in DISPATCH_PHASES}
        self._counts = {phase: 0 for phase in DISPATCH_PHASES}

    def _record(self, phase: str, seconds: float) -> None:
        seconds = max(0.0, seconds)
        self._totals[phase] += seconds
        self._counts[phase] += 1
        hist = self._hists.get(phase)
        if hist is None:
            reg = self._registry if self._registry is not None \
                else get_registry()
            hist = reg.histogram(f"dispatch.{phase}")
            self._hists[phase] = hist
        hist.record(seconds)

    def mark_prestep(self) -> None:
        self._t_pre = time.perf_counter()

    def begin_dispatch(self, sync_tree: Any = None) -> None:
        now = time.perf_counter()
        if self._t_pre is not None:
            self._record("python_prestep", now - self._t_pre)
            self._t_pre = None
        self._t_idle0 = None
        if (self.sample_every > 0 and sync_tree is not None
                and self._n_steps % self.sample_every == 0):
            drain(sync_tree)
            self._t_idle0 = time.perf_counter()
        # (re-)stamp dispatch-begin AFTER any drain: the bracket must
        # pollute neither python_prestep nor dispatch
        self._t_d0 = time.perf_counter()

    def end_dispatch(self, step: int) -> None:
        now = time.perf_counter()
        dispatch_s = idle_s = None
        if self._t_d0 is not None:
            dispatch_s = now - self._t_d0
            self._record("dispatch", dispatch_s)
            self._t_d0 = None
        if self._t_idle0 is not None:
            # queue empty -> launch complete: a lower bound on the device's
            # idle gap
            idle_s = now - self._t_idle0
            self._record("device_idle", idle_s)
            self._t_idle0 = None
        self._n_steps += 1
        fields = {"step": int(step)}
        if dispatch_s is not None:
            fields["dispatch_s"] = round(dispatch_s, 9)
        if idle_s is not None:
            fields["idle_s"] = round(idle_s, 9)
        flight.record("dispatch", **fields)

    def note_sync_wait(self, seconds: float) -> None:
        self._record("sync_wait", float(seconds))

    def flush_epoch(self, epoch: int, *, steps: int,
                    step_total_s: Optional[float] = None) -> None:
        tracer = self._tracer if self._tracer is not None else get_tracer()
        for phase in DISPATCH_PHASES:
            if self._counts[phase] == 0:
                continue
            tracer.point(DISPATCH_PHASE_POINT, phase=phase,
                         total_s=round(self._totals[phase], 9),
                         n=self._counts[phase], epoch=int(epoch),
                         step=self._n_steps)
        attributed = sum(self._totals[p] for p in DISPATCH_COVERAGE_PHASES)
        in_call = step_total_s if step_total_s is not None \
            else self._totals["dispatch"]
        window = (self._totals["python_prestep"] + max(0.0, in_call)
                  + self._totals["sync_wait"])
        tracer.point(DISPATCH_WINDOW_POINT, window_s=round(window, 9),
                     attributed_s=round(attributed, 9),
                     coverage=round(attributed / window, 6)
                     if window > 0 else 1.0,
                     epoch=int(epoch), steps=int(steps))
        self._reset_epoch()
