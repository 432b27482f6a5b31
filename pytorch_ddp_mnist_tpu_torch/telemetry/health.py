"""Training-health watchdog: rolling detectors over the values the loop
already fetches, severity-leveled `health` events, and a rescue policy
(the port of `pytorch_ddp_mnist_tpu/telemetry/health.py`; the detectors,
their thresholds, the event and metric names and the policies are the JAX
module's).

  * every detector consumes values the loop already has on the host: the
    once-an-epoch (or once-a-chunk) loss fetch, the epoch wall timers,
    and, from the plain autograd step built with `health=True`, the
    health auxiliary vector (`device_health_aux` below: global grad norm,
    finite flag, param norm), computed on the device inside the step and
    fetched WITH the losses, so a healthy watchdog adds no host sync;
  * detectors are rolling EWMAs and windows, constant memory at any run
    length: loss spike, NaN/Inf, grad-norm explosion, update-to-param
    ratio drift, throughput collapse and straggler drift (telemetry/
    analysis.py `skew` over a rolling window of this process's per-step
    times);
  * every firing emits a `health` point into the event trace, an entry
    into the flight recorder and `health.*` registry metrics (a counter a
    detector, the worst-severity gauge), so `/metrics`, the trace and a
    post-mortem dump tell the same story;
  * the policy decides what a FATAL signal (a non-finite loss or grads)
    does: `warn` logs, `checkpoint-and-warn` also hands the last good
    state to an `on_fatal` callback (cli/train.py saves it through the
    step-checkpoint manager, pinned), and `abort` dumps the flight ring
    and raises `TrainingHealthError`.

The module is numpy and stdlib at import time; torch is imported inside
the functions that touch tensors.
"""

from __future__ import annotations

import collections
import sys
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

from .analysis import skew
from .events import get_tracer
from .registry import MetricsRegistry, get_registry
from . import flight

SEVERITIES = ("info", "warn", "fatal")
_SEVERITY_LEVEL = {"info": 0, "warn": 1, "fatal": 2}
POLICIES = ("warn", "checkpoint-and-warn", "abort")
DETECTORS = ("nan", "loss_spike", "grad_norm", "update_ratio",
             "throughput", "straggler")

# Layout of the per-step health auxiliary vector `device_health_aux`
# returns and the health-enabled train steps fold into their outputs.
AUX_FIELDS = ("grad_norm", "finite", "param_norm")


class TrainingHealthError(Exception):
    """A fatal health signal under the `abort` policy. Deliberately NOT a
    RuntimeError: the outage-retry machinery triages RuntimeErrors for
    backend-loss signatures, and a diverged model is not an outage —
    retrying would re-diverge."""


@dataclass
class HealthConfig:
    """Detector thresholds + the fatal-signal policy. The defaults are
    deliberately loose — a watchdog that cries wolf gets disabled; every
    band is a knob because every workload's 'normal' differs."""
    policy: str = "warn"
    # loss spike: max finite per-step loss > ratio x the EWMA of chunk
    # mean losses (armed after `warmup` observations)
    loss_spike_ratio: float = 4.0
    # grad-norm explosion: chunk max grad norm > ratio x its EWMA
    grad_norm_ratio: float = 10.0
    # update-to-param ratio lr*|g|/|p| outside [lo, hi]: the classic
    # "learning rate is effectively zero / is destroying the params" band
    update_ratio_band: Tuple[float, float] = (1e-9, 1e-1)
    # throughput collapse: imgs/s below ratio x its EWMA
    throughput_collapse_ratio: float = 0.3
    # straggler drift: skew (spread/mean, analysis.skew) of the rolling
    # per-step-time window above this percentage
    straggler_skew_pct: float = 75.0
    straggler_window: int = 8
    ewma_alpha: float = 0.3
    # ratio detectors stay silent for the first N observations: the EWMA
    # needs a baseline before "4x the baseline" means anything (step-1
    # loss IS the spike otherwise)
    warmup: int = 3

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}; "
                             f"got {self.policy!r}")
        lo, hi = self.update_ratio_band
        if not 0 < lo < hi:
            raise ValueError(f"update_ratio_band must be 0 < lo < hi; "
                             f"got {self.update_ratio_band}")


@dataclass
class HealthEvent:
    """One detector firing. `value`/`threshold` are the number that fired
    and the bound it crossed; `step` is the global step at the END of the
    observation window (detection granularity is the fetch granularity —
    the event says 'within the window ending here')."""
    detector: str
    severity: str
    value: float
    threshold: float
    message: str
    epoch: int
    step: int


class _EWMA:
    """Exponentially weighted mean with an observation count (for warmup
    gating). `baseline()` is the value BEFORE the current observation is
    folded in — a spike must not dilute the bound it is tested against."""

    def __init__(self, alpha: float):
        self.alpha = float(alpha)
        self.value: Optional[float] = None
        self.n = 0

    def baseline(self) -> Optional[float]:
        return self.value

    def update(self, x: float) -> None:
        x = float(x)
        self.value = (x if self.value is None
                      else self.alpha * x + (1 - self.alpha) * self.value)
        self.n += 1


class Watchdog:
    """The live monitor. One per process; `observe()` at every point the
    loop already fetched a chunk of per-step losses (epoch end in the
    streaming loop, checkpoint-chunk boundaries in the scanned loop).

    `on_fatal(stash)` is the checkpoint-and-warn rescue hook: called with
    the last known-good stash `{"params", "key" (raw key words), "epoch",
    "offset", "step"}` when a fatal signal fires. The stash is refreshed
    (host copies) at every HEALTHY observation — only under the
    checkpoint-and-warn policy, since it costs one params D2H copy per
    observation; the other policies never touch device state.
    """

    def __init__(self, config: Optional[HealthConfig] = None, *,
                 registry: Optional[MetricsRegistry] = None,
                 lr: Optional[float] = None,
                 on_fatal: Optional[Callable[[dict], None]] = None,
                 rank: int = 0,
                 log: Callable[[str], None] = None):
        self.config = config or HealthConfig()
        self.registry = registry if registry is not None else get_registry()
        self.lr = lr
        self.on_fatal = on_fatal
        self.rank = int(rank)
        self._log = log or (lambda m: print(m, file=sys.stderr, flush=True))
        self._loss_ewma = _EWMA(self.config.ewma_alpha)
        self._gnorm_ewma = _EWMA(self.config.ewma_alpha)
        self._tput_ewma = _EWMA(self.config.ewma_alpha)
        self._step_times: "collections.deque[float]" = collections.deque(
            maxlen=self.config.straggler_window)
        self._n_timed = 0      # timing observations seen (straggler warmup)
        self._last_good: Optional[dict] = None
        self.events: List[HealthEvent] = []
        # eager metric creation: the /metrics endpoint shows the health
        # surface (worst severity 0 = healthy) from the first scrape, not
        # only after something already went wrong
        self._events_total = self.registry.counter("health.events_total")
        self._worst = self.registry.gauge("health.worst_severity_level")
        self._worst.set(0)
        self._worst_level = 0
        self._last_loss = self.registry.gauge("health.last_loss")
        self._last_gnorm = self.registry.gauge("health.grad_norm")
        self._last_ratio = self.registry.gauge("health.update_ratio")
        self._last_tput = self.registry.gauge("health.imgs_per_sec")

    # -- rescue stash ------------------------------------------------------

    def seed_good(self, state, *, epoch: int, offset: int, step: int) -> None:
        """Record the starting state as known-good, so a fatal signal in
        the very first observation window still has something intact to
        rescue (the initial params — epoch 0 offset 0, or the restored
        resume position). Only when the rescue hook exists (rank 0 under
        checkpoint-and-warn): other ranks must not pay the params copy
        for a save they will never perform."""
        if self.config.policy == "checkpoint-and-warn" \
                and self.on_fatal is not None:
            self._stash(state, epoch=epoch, offset=offset, step=step)

    def _stash(self, state, *, epoch: int, offset: int, step: int) -> None:
        import torch
        import torch.distributed as dist
        # the int8 strategy's error-feedback residual is part of the
        # resume state, so the rescue carries it too; in a world of
        # processes rank 0 (the only rank that stashes) holds its own
        # replicas' rows only, so the stash degrades to params and key
        # there, as the step checkpoints do (a resume reseeds a zero
        # residual, losing at most one step's quantization error)
        resid = getattr(state, "resid", None)
        if resid is not None and not (dist.is_available()
                                      and dist.is_initialized()
                                      and dist.get_world_size() > 1):
            resid = torch.as_tensor(resid).detach().to(
                "cpu", torch.float32).numpy().copy()
        else:
            resid = None
        self._last_good = {
            "params": {n: {k: v.detach().cpu().clone()
                           for k, v in layer.items()}
                       for n, layer in state.model.params().items()},
            "key": np.asarray(state.key, np.uint32).ravel().copy(),
            "resid": resid,
            "epoch": int(epoch), "offset": int(offset), "step": int(step),
        }

    # -- the one entry point ----------------------------------------------

    def observe(self, losses, *, epoch: int, step: int,
                state=None, aux=None,
                ckpt_epoch: Optional[int] = None,
                ckpt_offset: Optional[int] = None,
                dt_s: Optional[float] = None,
                imgs: Optional[int] = None) -> List[HealthEvent]:
        """Run every detector over one observation window.

        `losses`: the window's per-step mean losses, already on host (the
        fetch the loop performs anyway). `aux`: optional (n, 3) array of
        per-step `AUX_FIELDS` vectors from a health-enabled step. `state`:
        the live TrainState at the window's end, stashed as known-good
        when healthy (checkpoint-and-warn only); `ckpt_epoch`/
        `ckpt_offset` are the positions a checkpoint of that state must
        record (`step_ckpt_positions` semantics). `dt_s`/`imgs` feed the
        throughput and straggler detectors. Returns (and records) the
        events that fired; raises TrainingHealthError on a fatal signal
        under the abort policy."""
        cfg = self.config
        losses = np.asarray(losses, np.float64).ravel()
        fired: List[HealthEvent] = []

        def fire(detector, severity, value, threshold, message):
            fired.append(HealthEvent(detector, severity, float(value),
                                     float(threshold), message,
                                     int(epoch), int(step)))

        finite_mask = np.isfinite(losses)
        aux_bad = False
        gnorm = ratio = None
        if aux is not None:
            aux = np.asarray(aux, np.float64).reshape(-1, len(AUX_FIELDS))
            aux_bad = bool((aux[:, 1] < 1.0).any()
                           or not np.isfinite(aux[:, 0]).all())
            g_fin = aux[np.isfinite(aux[:, 0]), 0]
            if g_fin.size:
                gnorm = float(g_fin.max())
            if self.lr is not None:
                pn = aux[:, 2]
                ok = np.isfinite(aux[:, 0]) & np.isfinite(pn) & (pn > 0)
                if ok.any():
                    ratio = float((self.lr * aux[ok, 0] / pn[ok]).max())

        # 1. NaN/Inf — the one FATAL signal: a non-finite loss or a step
        # whose in-program finite-check tripped
        if not finite_mask.all() or aux_bad:
            bad = int((~finite_mask).sum())
            what = (f"{bad}/{losses.size} non-finite per-step losses"
                    if bad else "step finite-check tripped (grads/params)")
            fire("nan", "fatal", bad if bad else 1.0, 0.0,
                 f"non-finite training signal: {what}")

        # 2. loss spike (finite values only; a NaN is detector 1's job)
        base = self._loss_ewma.baseline()
        if finite_mask.any():
            mx = float(losses[finite_mask].max())
            if (base is not None and self._loss_ewma.n >= cfg.warmup
                    and base > 0 and mx > cfg.loss_spike_ratio * base):
                fire("loss_spike", "warn", mx, cfg.loss_spike_ratio * base,
                     f"loss {mx:.4g} > {cfg.loss_spike_ratio:g}x rolling "
                     f"mean {base:.4g}")
            self._loss_ewma.update(float(losses[finite_mask].mean()))
            self._last_loss.set(float(losses[finite_mask][-1]))

        # 3. grad-norm explosion
        if gnorm is not None:
            gbase = self._gnorm_ewma.baseline()
            if (gbase is not None and self._gnorm_ewma.n >= cfg.warmup
                    and gbase > 0 and gnorm > cfg.grad_norm_ratio * gbase):
                fire("grad_norm", "warn", gnorm, cfg.grad_norm_ratio * gbase,
                     f"grad norm {gnorm:.4g} > {cfg.grad_norm_ratio:g}x "
                     f"rolling mean {gbase:.4g}")
            self._gnorm_ewma.update(gnorm)
            self._last_gnorm.set(gnorm)

        # 4. update-to-param ratio drift
        if ratio is not None:
            lo, hi = cfg.update_ratio_band
            if not lo <= ratio <= hi:
                edge = hi if ratio > hi else lo
                fire("update_ratio", "warn", ratio, edge,
                     f"update/param ratio {ratio:.3g} outside "
                     f"[{lo:g}, {hi:g}]")
            self._last_ratio.set(ratio)

        # 5. throughput collapse + 6. straggler drift (online skew)
        if dt_s and imgs and dt_s > 0 and losses.size:
            tput = imgs / dt_s
            tbase = self._tput_ewma.baseline()
            if (tbase is not None and self._tput_ewma.n >= cfg.warmup
                    and tput < cfg.throughput_collapse_ratio * tbase):
                fire("throughput", "warn", tput,
                     cfg.throughput_collapse_ratio * tbase,
                     f"throughput {tput:.0f} img/s < "
                     f"{cfg.throughput_collapse_ratio:g}x rolling mean "
                     f"{tbase:.0f}")
            self._tput_ewma.update(tput)
            self._last_tput.set(tput)
            # straggler window opens AFTER warmup: the first observations
            # carry the step's capture time, which would read as a skew
            # spike of the run's own ramp-up, not of a sick rank
            self._n_timed += 1
            if self._n_timed > cfg.warmup:
                self._step_times.append(dt_s / losses.size)
            if len(self._step_times) >= max(4, cfg.straggler_window // 2):
                _, skew_pct = skew(self._step_times)
                if skew_pct > cfg.straggler_skew_pct:
                    fire("straggler", "warn", skew_pct,
                         cfg.straggler_skew_pct,
                         f"per-step time skew {skew_pct:.0f}% of mean over "
                         f"the last {len(self._step_times)} windows")

        self._publish(fired)
        fatal = [e for e in fired if e.severity == "fatal"]
        healthy = not fatal
        if healthy and state is not None and self.on_fatal is not None \
                and cfg.policy == "checkpoint-and-warn":
            self._stash(state,
                        epoch=epoch + 1 if ckpt_epoch is None else ckpt_epoch,
                        offset=0 if ckpt_offset is None else ckpt_offset,
                        step=step)
        if fatal:
            self._act_on_fatal(fatal[0])
        return fired

    # -- recording + policy ------------------------------------------------

    def _publish(self, fired: List[HealthEvent]) -> None:
        if not fired:
            return
        tracer = get_tracer()
        for e in fired:
            self.events.append(e)
            self._events_total.inc()
            self.registry.counter(f"health.fired.{e.detector}").inc()
            level = _SEVERITY_LEVEL[e.severity]
            if level > self._worst_level:
                self._worst_level = level
                self._worst.set(level)
            tracer.point("health", detector=e.detector, severity=e.severity,
                         value=e.value, threshold=e.threshold,
                         message=e.message, epoch=e.epoch, step=e.step)
            flight.record("health", detector=e.detector, severity=e.severity,
                          value=e.value, threshold=e.threshold,
                          rank=self.rank, epoch=e.epoch, step=e.step)
            self._log(f"[health] rank{self.rank} {e.severity.upper()} "
                      f"{e.detector} at epoch {e.epoch} step {e.step}: "
                      f"{e.message}")

    def _act_on_fatal(self, event: HealthEvent) -> None:
        policy = self.config.policy
        if policy == "checkpoint-and-warn" and self.on_fatal is not None:
            if self._last_good is not None:
                stash = self._last_good
                self._log(f"[health] rank{self.rank} rescue: saving last "
                          f"known-good state (step {stash['step']}, epoch "
                          f"{stash['epoch']}, offset {stash['offset']})")
                try:
                    self.on_fatal(dict(stash))
                except Exception as e:  # noqa: BLE001 — the rescue hook
                    # must never turn a detection into a crash; the run's
                    # fate belongs to the policy, not the hook
                    flight.record("health_rescue_failed", error=str(e)[:500])
                    self._log(f"[health] rescue checkpoint failed "
                              f"(training continues): {e}")
        elif policy == "abort":
            flight.dump(reason=f"health abort: {event.detector} "
                               f"({event.message})")
            raise TrainingHealthError(
                f"fatal health signal ({event.detector} at epoch "
                f"{event.epoch} step {event.step}: {event.message}) under "
                f"--health abort")

    def snapshot(self) -> dict:
        """JSON-able verdict: worst severity + per-detector fire counts —
        the `/healthz` payload and the bench `health_summary` stamp."""
        return health_summary(self.registry)


def device_health_aux(loss, grads, params):
    """The device-side fragment the health-enabled step folds into its
    work: `[global grad norm, finite flag, param norm]` as one f32
    3-vector tensor, from values the step already holds (`grads` and
    `params` are {layer: {name: tensor}} trees, read in the JAX tree's
    leaf order). Tensor ops only, with no host sync, so it runs inside a
    captured step and is fetched with the epoch's losses."""
    import torch

    def _sumsq(tree):
        total = None
        for layer in sorted(tree):
            for name in sorted(tree[layer]):
                s = torch.sum(torch.square(tree[layer][name].float()))
                total = s if total is None else total + s
        return total

    with torch.no_grad():
        gn, pn = torch.sqrt(_sumsq(grads)), torch.sqrt(_sumsq(params))
        finite = (torch.isfinite(loss) & torch.isfinite(gn)
                  & torch.isfinite(pn)).float()
        return torch.stack([gn, finite.reshape(()), pn])


def health_summary(registry: Optional[MetricsRegistry] = None) -> dict:
    """{fired: {detector: count}, worst_severity} read back from the
    `health.*` registry metrics (the JAX bench's artifact stamp has this
    shape).
    A process that never ran a watchdog reads as `{fired: {},
    worst_severity: None}`.

    When the process hosts a serve replica fleet (serve/fleet.py
    publishes `serve.fleet.replicas` / `serve.fleet.healthy` gauges into
    the same registry), the summary carries a `fleet` section —
    `{replicas, healthy, degraded}` — so /healthz and the bench artifact
    see a quarantined-replica fleet as degraded, not silently fine."""
    snap = (registry if registry is not None else get_registry()).snapshot()
    prefix = "health.fired."
    fired = {name[len(prefix):]: v for name, v in snap["counters"].items()
             if name.startswith(prefix) and v}
    level = snap["gauges"].get("health.worst_severity_level")
    worst = None
    if level is not None:
        worst = {v: k for k, v in _SEVERITY_LEVEL.items()}.get(int(level))
        if int(level) == 0:
            worst = "ok"
    out = {"fired": fired, "worst_severity": worst}
    replicas = snap["gauges"].get("serve.fleet.replicas")
    if replicas is not None:
        healthy = int(snap["gauges"].get("serve.fleet.healthy") or 0)
        out["fleet"] = {"replicas": int(replicas), "healthy": healthy,
                        "degraded": healthy < int(replicas)}
    return out
