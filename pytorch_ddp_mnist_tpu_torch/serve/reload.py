"""Hot reload: a checkpoint-directory watcher that swaps the fleet to new
weights behind per-replica drains, and refuses bad checkpoints BY NAME
(port of `pytorch_ddp_mnist_tpu/serve/reload.py`; its verdicts, event
names and metric names letter for letter).

The trainer commits step checkpoints (train/ckpt_manager.py: payload
fsync and rename, then the manifest's rename as the commit). The watcher
polls the directory, and when a step newer than what the fleet serves
commits, promotes it. What "promotable" means is not re-implemented: the
watcher calls the same `CheckpointManager.scan_restorable` walk that
`--resume` uses (newest intact AND finite, every rejection named), so the
two consumers never drift, and a directory the JAX package's manager
wrote promotes here as one the port wrote does. One deliberate
divergence: where a resume falls back to a non-finite checkpoint with a
warning, a reload REFUSES it, because the incumbent weights are healthy
and serving.

The promotion is `FleetService.apply_reload`: the validation, payload
read, CRC check, decode and every new engine's captures happen in the
executor, off the event loop, then replicas swap one at a time behind a
drain. A refused candidate (torn payload, CRC mismatch, non-finite
params, or an injected `reload_torn` fault, fired in the executor) is
recorded ONCE by name (`serve.reload.refused`, a `reload_event` point, a
flight record), and the watcher keeps polling; a refused step is never
re-validated, and the incumbent keeps serving. A NEWER commit reopens the
question, and the shared walk then promotes the newest intact-and-finite
step beyond what is serving, which may be an earlier candidate whose
refusal was transient.

`serve.reload.*` metrics: `reloads` / `refused` counters, `serving_step` /
`last_reload_s` gauges. `cli/serve.py --reload_dir` runs the watcher next
to the TCP server; serve_chaos.py's torn-checkpoint-swap leg drives every
branch.
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional

from ..telemetry import flight
from ..telemetry.events import get_tracer
from ..train.ckpt_manager import CheckpointManager
from ..utils import faultpoints

# Poll cadence default: fast enough that "commit to first request on new
# weights" is dominated by the ladder capture, slow enough that an idle
# watcher is one listdir per interval.
POLL_INTERVAL_S = 0.25


class ReloadWatcher:
    """Watch a `CheckpointManager` directory and hot-swap the fleet.

    `poll_once()` is the whole decision, separately callable so tests and
    the chaos smoke drive reloads deterministically without the timer:
    returns "idle" (nothing newer), "reloaded" (fleet now serves the new
    step), or "refused" (a newer candidate exists but nothing newer is
    promotable — named, counted, incumbent untouched). `run()` loops
    `poll_once` every `poll_interval_s` until `stop()`.
    """

    def __init__(self, fleet, directory: str, *,
                 poll_interval_s: float = POLL_INTERVAL_S,
                 clock=None):
        if poll_interval_s <= 0:
            raise ValueError(
                f"poll_interval_s must be > 0; got {poll_interval_s}")
        self.fleet = fleet
        self.manager = CheckpointManager(directory)
        self.poll_interval_s = float(poll_interval_s)
        self.clock = clock or time.monotonic
        self._stopped = False
        self._task: Optional[asyncio.Task] = None
        # steps already refused by name: a torn step_000042 stays torn —
        # re-validating it every poll would re-pay the payload read and
        # re-spam the named refusal; a NEWER commit resets the question
        self._refused_steps: "set[int]" = set()
        reg = fleet.metrics.registry
        self._reloads = reg.counter("serve.reload.reloads")
        self._refused = reg.counter("serve.reload.refused")
        reg.gauge("serve.reload.serving_step").set_fn(
            lambda: self.fleet.serving_step)
        self._last_reload_s = reg.gauge("serve.reload.last_reload_s")

    @property
    def reloads(self) -> int:
        return self._reloads.value

    @property
    def refused(self) -> int:
        return self._refused.value

    # -- the decision -------------------------------------------------------

    def _newest_candidate(self) -> Optional[int]:
        steps = self.manager.steps()   # one listdir — the idle-poll cost
        if not steps:
            return None
        newest = steps[-1]
        if newest <= self.fleet.serving_step or newest in self._refused_steps:
            return None
        return newest

    def _scan(self, serving_step: int):
        """Executor-side validation: fire the injectable fault point,
        then run the SHARED newest-intact-and-finite walk bounded to
        steps beyond what the fleet serves. Everything expensive —
        payload read, CRC, msgpack decode, finiteness walk — happens
        here, off the loop."""
        faultpoints.fire("reload_validate")
        return self.manager.scan_restorable(self.fleet._params,
                                            newer_than=serving_step)

    def _refuse(self, step: int, reason: str) -> None:
        self._refused_steps.add(step)
        self._refused.inc()
        reason = reason[:400]
        flight.record("reload_event", event="refused", step=step,
                      reason=reason)
        get_tracer().point("reload_event", event="refused", step=step,
                           serving_step=self.fleet.serving_step,
                           reason=reason)

    async def poll_once(self) -> str:
        """One watch cycle: cheap manifest peek, off-loop validation,
        drain-and-swap promotion. See class docstring for the verdicts."""
        newest = self._newest_candidate()
        if newest is None:
            return "idle"
        serving = self.fleet.serving_step
        loop = asyncio.get_running_loop()
        t0 = time.monotonic()
        try:
            scan = await loop.run_in_executor(None, self._scan, serving)
        except Exception as e:  # noqa: BLE001 — a validation crash (the
            # injected reload_torn fault, an unreadable directory) must
            # refuse by name, never take the watcher or the fleet down
            self._refuse(newest, f"validation failed: "
                                 f"{type(e).__name__}: {e}")
            return "refused"
        if scan.best is None:
            # a newer commit exists but nothing newer is promotable:
            # torn/corrupt candidates carry their defect in scan.tried;
            # an intact-but-non-finite one is the resume path's fallback
            # and the reload path's NAMED refusal (see module docstring)
            if scan.newest_nonfinite is not None:
                reason = (f"step {scan.newest_nonfinite.step} is intact "
                          f"but non-finite (a diverged run's checkpoint) "
                          f"— refusing to serve it")
            elif scan.tried:
                reason = scan.tried[0]
            else:
                reason = "no intact checkpoint newer than serving step"
            self._refuse(newest, reason)
            return "refused"
        ckpt = scan.best
        swapped = await self.fleet.apply_reload(ckpt.params, ckpt.step)
        dur = time.monotonic() - t0
        self._reloads.inc()
        self._last_reload_s.set(round(dur, 4))
        flight.record("reload_event", event="reloaded", step=ckpt.step,
                      swapped=swapped, dur_s=round(dur, 4),
                      skipped=len(scan.tried))
        get_tracer().point("reload_event", event="reloaded", step=ckpt.step,
                           swapped=swapped, dur_s=round(dur, 4),
                           skipped=len(scan.tried))
        return "reloaded"

    # -- the loop -----------------------------------------------------------

    async def run(self) -> None:
        """Poll until `stop()`; one failed cycle is counted and survived
        (`poll_once` already converts validation failures into refusals —
        anything else would be a watcher bug, logged to flight and
        retried next interval)."""
        while not self._stopped:
            try:
                await self.poll_once()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — the watcher outlives
                # its own bugs: a reload must never be able to stop
                # FUTURE reloads
                flight.record("reload_event", event="watcher_error",
                              error=f"{type(e).__name__}: {e}"[:400])
            await asyncio.sleep(self.poll_interval_s)

    def start(self) -> asyncio.Task:
        """Spawn `run()` on the running loop (idempotent)."""
        if self._task is None or self._task.done():
            self._stopped = False
            self._task = asyncio.get_running_loop().create_task(self.run())
        return self._task

    async def stop(self) -> None:
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
