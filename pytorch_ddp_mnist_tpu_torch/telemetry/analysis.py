"""The fleet/reload record contract and the record names the port's
writers share (port of the parts of
`pytorch_ddp_mnist_tpu/telemetry/analysis.py` that serve/fleet.py,
serve/reload.py, telemetry/dispatch.py and telemetry/health.py answer to;
the read side's reports are ROADMAP.md queue 1, item 12c).

`skew` is the straggler math the health watchdog's drift detector shares
with the JAX read side's cross-process report. `dispatch_phase` /
`dispatch_window` are the point records of the dispatch profiler's epoch
flush; `scripts/check_telemetry.py` holds their contract.

serve/fleet.py and serve/reload.py emit `point` events at every replica
state transition and reload verdict. The names below are the JAX
package's letter for letter (a test holds them equal), so a trace either
package writes passes the other's check, and `scripts/check_telemetry.py`
reads the port's traces as they are. A `swapped` event carries the
hot-reload invariant itself: `outstanding_at_swap` must be 0 (a request
that spanned a swap would have run half on the old weights, half on the
new). `trace_contract_errors` is the check over a trace directory that
`serve_chaos.py` and chip_smoke.py run where the JAX checker is not
available.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Iterable, List, Tuple

FLEET_EVENT_POINT = "fleet_event"
RELOAD_EVENT_POINT = "reload_event"
FLEET_EVENTS = ("retry", "retry_exhausted", "quarantine", "dead",
                "restart")
RELOAD_EVENTS = ("swapped", "reloaded", "refused")
QUARANTINE_CAUSES = ("wedge", "crash")

DISPATCH_PHASE_POINT = "dispatch_phase"
DISPATCH_WINDOW_POINT = "dispatch_window"
DISPATCH_PHASES = ("python_prestep", "dispatch", "device_idle", "sync_wait")
# device_idle observes the same wall interval python_prestep + dispatch
# occupy on the host, so coverage counts each host interval once
DISPATCH_COVERAGE_PHASES = ("python_prestep", "dispatch", "sync_wait")


def skew(values) -> Tuple[float, float]:
    """(spread, spread as % of mean) of a set of durations: max - min, and
    that spread relative to the mean. The online drift detector
    (telemetry/health.py) and the offline cross-process report use this
    one function. Empty or zero-mean input reads as no skew."""
    vals = list(values)
    if not vals:
        return 0.0, 0.0
    lo, hi = min(vals), max(vals)
    mean = sum(vals) / len(vals)
    spread = hi - lo
    return spread, (100.0 * spread / mean if mean > 0 else 0.0)


def fleet_record_errors(segment: List[dict]) -> List[Tuple[int, str]]:
    """Violations of the fleet/reload point-record contract within ONE
    trace segment, as (line_no, message) pairs: the JAX package's
    `fleet_record_errors`, message for message.

    A `fleet_event` must name a known event and a non-negative int
    `replica`; a quarantine must name a known cause. A `reload_event` must
    name a known event; a `swapped` event must carry
    `outstanding_at_swap == 0`; a `refused` event must carry a non-empty
    string `reason`."""
    errors: List[Tuple[int, str]] = []
    for rec in segment:
        if rec.get("kind") != "point":
            continue
        name = rec.get("name")
        if name not in (FLEET_EVENT_POINT, RELOAD_EVENT_POINT):
            continue
        line = rec.get("_line", 0)
        attrs = rec.get("attrs") or {}
        event = attrs.get("event")
        if name == FLEET_EVENT_POINT:
            if event not in FLEET_EVENTS:
                errors.append((line, f"fleet_event names unknown event "
                                     f"{event!r}; known: {FLEET_EVENTS}"))
                continue
            rep = attrs.get("replica")
            if not isinstance(rep, int) or isinstance(rep, bool) \
                    or rep < 0:
                errors.append((line, f"fleet_event {event} replica must "
                                     f"be a non-negative int; got "
                                     f"{rep!r}"))
            if event == "quarantine" \
                    and attrs.get("cause") not in QUARANTINE_CAUSES:
                errors.append((line, f"fleet_event quarantine names "
                                     f"unknown cause "
                                     f"{attrs.get('cause')!r}; known: "
                                     f"{QUARANTINE_CAUSES}"))
            continue
        if event not in RELOAD_EVENTS:
            errors.append((line, f"reload_event names unknown event "
                                 f"{event!r}; known: {RELOAD_EVENTS}"))
            continue
        if event == "swapped":
            out = attrs.get("outstanding_at_swap")
            if out != 0 or isinstance(out, bool):
                errors.append((line, f"reload_event swapped violates the "
                                     f"drain-before-swap invariant: "
                                     f"outstanding_at_swap must be 0, "
                                     f"got {out!r}"))
        elif event == "refused":
            reason = attrs.get("reason")
            if not (isinstance(reason, str) and reason):
                errors.append((line, f"reload_event refused must carry a "
                                     f"non-empty string reason; got "
                                     f"{reason!r}"))
    return errors


def trace_contract_errors(directory: str,
                          require: Iterable[str] = ()) -> List[str]:
    """The record contract over every `events*.jsonl` under `directory`:
    `fleet_record_errors` per segment (a `trace_start` meta record opens
    one), and, for each prefix of `require`, at least one metric of that
    prefix in a registry snapshot. Returns "path:line: why" strings."""
    files = sorted(glob.glob(os.path.join(directory, "events*.jsonl")))
    if not files:
        return [f"{directory}: no events*.jsonl"]
    errors: List[str] = []
    names: set = set()
    for path in files:
        segment: List[dict] = []

        def flush():
            errors.extend(f"{path}:{line}: {msg}"
                          for line, msg in fleet_record_errors(segment))
            segment.clear()

        with open(path) as f:
            for line_no, line in enumerate(f, 1):
                try:
                    rec = json.loads(line)
                except ValueError:
                    errors.append(f"{path}:{line_no}: malformed JSON")
                    continue
                if not isinstance(rec, dict):
                    continue
                if rec.get("kind") == "meta" \
                        and rec.get("name") == "trace_start":
                    flush()
                if rec.get("kind") == "point" and rec.get("name") in (
                        FLEET_EVENT_POINT, RELOAD_EVENT_POINT):
                    rec["_line"] = line_no
                    segment.append(rec)
                if rec.get("kind") == "snapshot":
                    attrs = rec.get("attrs") or {}
                    for table in ("counters", "gauges", "histograms"):
                        if isinstance(attrs.get(table), dict):
                            names.update(attrs[table])
        flush()
    errors += [f"{directory}: no registry-snapshot metric matching "
               f"{prefix!r}" for prefix in require
               if not any(n.startswith(prefix) for n in names)]
    return errors
