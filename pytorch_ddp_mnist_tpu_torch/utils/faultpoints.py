"""Deterministic fault injection: the switchboard the resilience paths are
tested against (port of `pytorch_ddp_mnist_tpu/utils/faultpoints.py`; pure
stdlib, and its specs are the JAX package's word for word).

The instrumented code asks `fire(point, **ctx)` at each fault point; a
spec that matches performs its failure there. Specs come from
`$PDMT_FAULT` and the trainer's `--fault`, merged, comma-separated:

    kill:rank=2:step=5                  SIGKILL this process
    ckpt_save_io:step=3                 OSError inside the checkpoint save
    loader_stall:batch=3:delay_s=0.5    sleep in the loader
    collective_timeout:rank=1           a DEADLINE_EXCEEDED barrier
    nan:step=5                          NaN the step-5 loss
    engine_crash:after=40:replica=0     the serve engine dies mid-burst
    engine_wedge:delay_s=2:replica=1    a staged serve fetch hangs
    reload_torn                         hot reload sees a torn checkpoint

    kind                point              action
    kill                "step"             flight dump, then SIGKILL: no
                                           cleanup, no atexit, as a real
                                           preemption
    ckpt_save_io        "ckpt_save"        raise OSError before the payload
                                           rename (the save fails, nothing
                                           is torn)
    loader_stall        "loader_next"      time.sleep(delay_s)
    collective_timeout  "barrier"          raise a RuntimeError whose text
                                           `parallel/wireup.py`
                                           `looks_like_backend_loss` takes
                                           for a lost peer
    nan                 "loss"             poison the reported loss with NaN
                                           (the parameters stay finite);
                                           fired through `poison` /
                                           `poison_array`, which RETURN the
                                           value
    engine_crash        "serve_engine"     raise from the serve engine's
                                           bucket dispatch
    engine_wedge        "serve_wedge"      `claim` returns the spec for the
                                           engine to wedge its batch
    reload_torn         "reload_validate"  raise from the reload watcher's
                                           validation

The trainer fires "step", "ckpt_save", "loader_next", "barrier" and
"loss". The serve engine fires "serve_engine" before each launch and
claims "serve_wedge" at each staged dispatch, with its launch ordinal
(`after`) and its fleet replica (`replica`, serve/fleet.py); the reload
watcher fires "reload_validate" in its executor-side validation
(serve/reload.py).

Matching: `step=K` and `after=N` fire at the FIRST crossing >= K (the
resident-dataset trainer reports steps only at its chunk boundaries, so
equality could miss them); `epoch=`, `batch=` and `replica=` match
exactly; `rank=` gates on the injecting process's rank (from `$RANK`
until the CLI calls `set_rank` after its wireup). A spec fires at most
`times=` times (default 1). Every fired fault is recorded in the flight
recorder (telemetry/flight.py, `fault_injected`) BEFORE it acts, so even a
SIGKILL leaves its record in the dump.

With no spec installed, `fire` is one attribute test and an environment
lookup: the per-step paths pay nothing for it.
"""

from __future__ import annotations

import math
import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

FAULT_ENV = "PDMT_FAULT"

# kind -> the fault point it fires at
POINTS = {
    "kill": "step",
    "ckpt_save_io": "ckpt_save",
    "loader_stall": "loader_next",
    "collective_timeout": "barrier",
    "nan": "loss",
    "engine_crash": "serve_engine",
    "engine_wedge": "serve_wedge",
    "reload_torn": "reload_validate",
}

# constraints that match at the first crossing (>=); the rest match ==
_THRESHOLD_KEYS = ("step", "after")
_KNOWN_KEYS = ("step", "epoch", "batch", "rank", "delay_s", "times",
               "after", "replica")


class FaultSpecError(ValueError):
    """A fault spec that does not parse, refused by name."""


@dataclass
class FaultSpec:
    kind: str
    point: str
    where: Dict[str, float] = field(default_factory=dict)
    delay_s: float = 0.5
    times: int = 1
    fired: int = 0

    def matches(self, rank: int, ctx: Dict[str, float]) -> bool:
        if self.fired >= self.times:
            return False
        for key, want in self.where.items():
            if key == "rank":
                if int(want) != int(rank):
                    return False
                continue
            got = ctx.get(key)
            if got is None:
                return False
            if (got < want) if key in _THRESHOLD_KEYS else (got != want):
                return False
        return True

    def describe(self) -> str:
        cons = ":".join(f"{k}={int(v) if float(v).is_integer() else v}"
                        for k, v in sorted(self.where.items()))
        return self.kind + (f":{cons}" if cons else "")


def _parse_one(raw: str) -> FaultSpec:
    kind, *items = raw.split(":")
    kind = kind.strip()
    if kind not in POINTS:
        raise FaultSpecError(f"unknown fault kind {kind!r} in {raw!r}; "
                             f"known: {sorted(POINTS)}")
    spec = FaultSpec(kind=kind, point=POINTS[kind])
    for item in items:
        key, sep, val = item.partition("=")
        if not sep:
            raise FaultSpecError(
                f"fault constraint {item!r} in {raw!r} is not key=value")
        key = key.strip()
        if key not in _KNOWN_KEYS:
            raise FaultSpecError(f"unknown fault constraint {key!r} in "
                                 f"{raw!r}; known: {_KNOWN_KEYS}")
        try:
            num = float(val)
        except ValueError:
            raise FaultSpecError(f"fault constraint {item!r} in {raw!r}: "
                                 f"{val!r} is not a number") from None
        if key == "delay_s":
            spec.delay_s = num
        elif key == "times":
            spec.times = int(num)
        else:
            spec.where[key] = num
    return spec


def parse_faults(text: Optional[str]) -> List[FaultSpec]:
    """A comma-separated spec string -> specs ([] for empty or None). An
    unknown kind or constraint, or a value that is not a number, raises
    FaultSpecError by name: a chaos run with a misspelt spec must not run
    fault-free and pass."""
    return [_parse_one(raw.strip()) for raw in (text or "").split(",")
            if raw.strip()]


class FaultInjector:
    """The parsed specs and this process's rank."""

    def __init__(self, specs: List[FaultSpec], rank: int = 0):
        self.specs = list(specs)
        self.rank = int(rank)

    def _due(self, point: str, ctx, value_faults: bool):
        """The specs at `point` that match now, of the value kind ("nan")
        or of the acting kinds."""
        return [s for s in self.specs
                if (s.kind == "nan") == value_faults and s.point == point
                and s.matches(self.rank, ctx)]

    def _record(self, spec: FaultSpec, ctx) -> None:
        from ..telemetry import flight
        flight.record("fault_injected", fault=spec.describe(),
                      point=spec.point, rank=self.rank,
                      **{k: v for k, v in ctx.items()
                         if k not in ("fault", "point", "rank")})

    def fire(self, point: str, **ctx) -> None:
        for spec in self._due(point, ctx, value_faults=False):
            spec.fired += 1
            self._record(spec, ctx)
            self._act(spec)

    def claim(self, point: str, **ctx) -> Optional[FaultSpec]:
        """The first due acting spec at `point`, marked fired and recorded,
        for the call site to act on; None when nothing is due."""
        for spec in self._due(point, ctx, value_faults=False):
            spec.fired += 1
            self._record(spec, ctx)
            return spec
        return None

    def poison(self, point: str, value, **ctx):
        """`value`, times NaN for each due "nan" spec at `point` (a device
        tensor stays on its device: nothing is fetched)."""
        for spec in self._due(point, ctx, value_faults=True):
            spec.fired += 1
            self._record(spec, ctx)
            value = value * float("nan")
        return value

    def poison_array(self, point: str, values, *, first_step: int, **ctx):
        """The chunk form of `poison` for per-step values fetched at once:
        `values[i]` is global step `first_step + i`. For each "nan" spec
        due at `point`, the first index whose step crosses the spec's
        `step` (index 0 when it has none, or when the threshold already
        lies behind) is set to NaN in a copy."""
        import numpy as np
        n = len(values)
        if n == 0:
            return values
        for spec in self.specs:
            if spec.kind != "nan" or spec.point != point:
                continue
            want = spec.where.get("step")
            if want is not None and first_step + n - 1 < want:
                continue
            idx = 0 if want is None else max(
                0, int(math.ceil(want)) - int(first_step))
            at = {**ctx, "step": int(first_step) + idx}
            if not spec.matches(self.rank, at):
                continue
            spec.fired += 1
            self._record(spec, at)
            values = np.array(values, copy=True)
            values[idx] = float("nan")
        return values

    def _act(self, spec: FaultSpec) -> None:
        what = f"injected fault: {spec.describe()}"
        if spec.kind == "kill":
            from ..telemetry import flight
            flight.dump(reason=what)
            os.kill(os.getpid(), signal.SIGKILL)
        elif spec.kind == "ckpt_save_io":
            raise OSError(f"{what} (simulated checkpoint I/O failure)")
        elif spec.kind == "loader_stall":
            time.sleep(spec.delay_s)
        elif spec.kind == "collective_timeout":
            raise RuntimeError(f"DEADLINE_EXCEEDED: {what} (simulated "
                               f"collective timeout)")
        elif spec.kind == "engine_crash":
            raise RuntimeError(f"{what} (simulated serve engine crash)")
        elif spec.kind == "reload_torn":
            raise RuntimeError(f"{what} (simulated torn checkpoint during "
                               f"reload validation)")


_INJECTOR: Optional[FaultInjector] = None
# fire() reads the reference unlocked (either injector is consistent); the
# lock orders a late install against the loader threads' lazy builds
_LOCK = threading.Lock()


def _env_injector() -> FaultInjector:
    try:
        rank = int(os.environ.get("RANK", "0"))
    except ValueError:
        rank = 0
    return FaultInjector(parse_faults(os.environ.get(FAULT_ENV)), rank=rank)


def install(extra: Optional[str] = None,
            rank: Optional[int] = None) -> FaultInjector:
    """(Re)build the process's injector from `$PDMT_FAULT` plus `extra`
    (the CLI's --fault), gated on `rank` when given; returns it."""
    global _INJECTOR
    inj = _env_injector()
    inj.specs.extend(parse_faults(extra))
    if rank is not None:
        inj.rank = int(rank)
    with _LOCK:
        _INJECTOR = inj
    return inj


def get_injector() -> FaultInjector:
    global _INJECTOR
    if _INJECTOR is None:
        with _LOCK:
            if _INJECTOR is None:
                _INJECTOR = _env_injector()
    return _INJECTOR


def set_rank(rank: int) -> None:
    """Bind the rank learnt at wireup; rank-gated specs use it from here."""
    get_injector().rank = int(rank)


def _live() -> Optional[FaultInjector]:
    """The injector when any spec could be installed, else None (the fast
    path: never configured)."""
    inj = _INJECTOR
    if inj is None:
        if FAULT_ENV not in os.environ:
            return None
        inj = get_injector()
    return inj if inj.specs else None


def fire(point: str, **ctx) -> None:
    """Perform a fault that is due at `point`, if any."""
    inj = _live()
    if inj is not None:
        inj.fire(point, **ctx)


def claim(point: str, **ctx) -> Optional[FaultSpec]:
    inj = _live()
    return inj.claim(point, **ctx) if inj is not None else None


def poison(point: str, value, **ctx):
    inj = _live()
    return inj.poison(point, value, **ctx) if inj is not None else value


def poison_array(point: str, values, *, first_step: int, **ctx):
    inj = _live()
    if inj is None:
        return values
    return inj.poison_array(point, values, first_step=first_step, **ctx)


def active() -> bool:
    """Whether any spec is installed."""
    return _live() is not None
