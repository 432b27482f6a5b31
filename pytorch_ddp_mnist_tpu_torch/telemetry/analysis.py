"""Trace analysis, the read side of the port's JSONL telemetry (port of
`pytorch_ddp_mnist_tpu/telemetry/analysis.py`, function for function):

  * `load_trace` / `load_traces` / `split_segments` and the record
    contracts (`span_structure_errors`, `serve_structure_errors`,
    `cost_record_errors`, `dispatch_record_errors`, `fleet_record_errors`,
    `ledger_row_errors`), shared with `scripts/check_telemetry.py`;
  * `analyze` / `compare` / `format_report`: per-phase p50/p95/max, the
    per-epoch trend, cross-process straggler skew aligned on wall clock
    (`clock_offset`), and the step-time regression gate;
  * `serve_report` / `compare_serve`, `data_report` / `compare_data`,
    `efficiency_report`, and `overhead_report` / `overhead_from_artifact`
    / `compare_overhead` (the dispatch profiler's `dispatch.*` phases);
  * `trace_contract_errors`: the fleet/reload contract and the registry
    prefixes over a trace directory, which `serve_chaos.py` and
    chip_smoke.py run.

The port's writers (serve/fleet.py, serve/reload.py, telemetry/dispatch.py,
telemetry/health.py) share the record names and the `skew` math defined
here. Names, messages and report dicts are the JAX package's, so a trace
either package writes reads the same through both (tests hold the two
equal). Pure stdlib: the read side runs wherever a trace lands, with no
torch installed.
"""

from __future__ import annotations

import glob
import heapq
import json
import math
import os
from typing import Dict, List, Optional, Tuple

# Span names carrying the per-phase step-time story (train/loop.py,
# train/scan.py emit exactly these; serve spans would join by name).
PHASES = ("data_wait", "step_compute", "eval", "fused_run")
# Containment tolerance: both stamps come from the same perf_counter, but a
# parent's duration is computed a few instructions after its child's, so
# exact float equality is not guaranteed at the boundary.
_EPS = 1e-6

# -- the serve-side request/batch span contract (serve/tracing.py emits
# these; kept as LITERALS here so this module stays framework-free for the
# file-loading checker — tests pin the two catalogs against each other) --
SERVE_REQUEST_SPAN = "serve.request"
SERVE_BATCH_SPAN = "serve.batch"
SERVE_STAGES = ("admission", "queue", "batch_form", "pad_h2d", "compute",
                "reply")
SERVE_COALESCE_REASONS = ("size", "deadline", "drain", "manual")
# batch stage children in pipeline order: their start stamps must be
# monotone in this order within one batch (a violation means the stamps
# were reordered or two batches' ids collided)
SERVE_BATCH_STAGE_ORDER = ("serve.batch_form", "serve.pad_h2d",
                           "serve.compute")
# How many slowest-request exemplar trees a serve report carries.
SERVE_EXEMPLAR_K = 8

# -- the program-cost record contract (telemetry/costs.py emits these as
# `point` events; literals here so the file-loading checker stays
# framework-free — tests pin them against costs.py's catalog) --
COST_POINT = "program_cost"
# numeric cost fields: when present they must be non-negative numbers (a
# negative flop/byte count is a harvester bug masquerading as data)
COST_NUMERIC_FIELDS = (
    "flops", "transcendentals", "bytes_accessed", "argument_bytes",
    "output_bytes", "temp_bytes", "generated_code_bytes", "alias_bytes",
    "peak_bytes", "analytic_flops", "wire_bytes", "compile_s")

# -- the dispatch-forensics record contract (telemetry/dispatch.py emits
# these as `point` events at each epoch flush; literals here so the
# file-loading checker stays framework-free — tests pin them against
# dispatch.py's catalog). The phase catalog is the step-boundary
# decomposition of PR 12's overhead O (docs/OBSERVABILITY.md §Dispatch
# forensics): python_prestep (loop bookkeeping before the jitted call),
# dispatch (inside the jitted call until the async arrays return),
# device_idle (the DEVICE's view of the gap between consecutive
# executions, probed on sampled steps), sync_wait (the per-epoch
# loss/health fetch). --
DISPATCH_PHASE_POINT = "dispatch_phase"
DISPATCH_WINDOW_POINT = "dispatch_window"

# -- the fleet/reload record contract (serve/fleet.py + serve/reload.py
# emit these as `point` events at every replica state transition and
# reload verdict; literals here so the file-loading checker stays
# framework-free — tests pin them against the emitters). `swapped`
# events carry the hot-reload invariant itself: `outstanding_at_swap`
# must be 0 (a request that spanned a swap would have run half on the
# old weights, half on the new). --
FLEET_EVENT_POINT = "fleet_event"
RELOAD_EVENT_POINT = "reload_event"
FLEET_EVENTS = ("retry", "retry_exhausted", "quarantine", "dead",
                "restart")
RELOAD_EVENTS = ("swapped", "reloaded", "refused")
QUARANTINE_CAUSES = ("wedge", "crash")
DISPATCH_PHASES = ("python_prestep", "dispatch", "device_idle", "sync_wait")
# device_idle observes the SAME wall interval python_prestep + dispatch
# occupy on the host (queue empty until the next enqueue completes), so
# coverage counts each host interval exactly once.
DISPATCH_COVERAGE_PHASES = ("python_prestep", "dispatch", "sync_wait")
OVERHEAD_REPORT_TAG = "dispatch_overhead_report"
# the acceptance floor: measured phases must explain at least this share
# of the window (trace runs) / of the roofline's O (bench artifacts)
OVERHEAD_COVERAGE_MIN = 0.90
# share-ratio gate exemption: below this absolute phase total the
# numerator is scheduler noise (the data/serve sub-ms convention)
OVERHEAD_SUBMS_EXEMPT_S = 1e-3

# -- the performance-ledger record contract (telemetry/ledger.py emits
# `ledger_row` points when the ledger CLI runs with --telemetry; literals
# here so the file-loading checker stays framework-free — tests pin them
# against ledger.py's catalog). Every ledger row is direction-aware: the
# trend gate must know whether bigger is better before it can call a move
# a regression. --
LEDGER_ROW_POINT = "ledger_row"
LEDGER_DIRECTIONS = ("higher_better", "lower_better")

# The ONE workload normalizer (docs/OBSERVABILITY.md §Performance ledger):
# strategy rows that predate the --model/--param_scale stamps (the
# MULTICHIP_r06-generation artifacts) are the default 118k mlp at scale 1,
# and a row-less n_devices falls back to the artifact's. Both the PR 7
# efficiency-gate labels (`efficiency_report` below) and the ledger's
# series keys (telemetry/ledger.py) normalize through THIS function, so
# the two can never disagree about which legacy rows are comparable.
WORKLOAD_DEFAULTS = {"model": "mlp", "param_scale": 1}


def normalize_workload(row: dict, artifact: Optional[dict] = None) -> dict:
    """Canonical {model, param_scale, n_devices, per_chip_batch} for one
    strategy/bench row: absent model/param_scale pin to the documented
    defaults (mlp, x1 — un-stamped rows predate models/zoo.py); n_devices
    falls back row -> artifact -> None; per_chip_batch stays None when the
    row predates its stamp (r08 introduced it)."""
    art = artifact or {}
    model = row.get("model")
    if not isinstance(model, str) or not model:
        model = art.get("model")
    if not isinstance(model, str) or not model:
        model = WORKLOAD_DEFAULTS["model"]
    scale = row.get("param_scale", art.get("param_scale"))
    if not isinstance(scale, (int, float)) or isinstance(scale, bool):
        scale = WORKLOAD_DEFAULTS["param_scale"]
    ndev = row.get("n_devices", art.get("n_devices"))
    if isinstance(ndev, bool) or not isinstance(ndev, (int, float)):
        ndev = None
    pcb = row.get("per_chip_batch")
    if isinstance(pcb, bool) or not isinstance(pcb, (int, float)):
        pcb = None
    return {"model": model, "param_scale": int(scale),
            "n_devices": int(ndev) if ndev is not None else None,
            "per_chip_batch": int(pcb) if pcb is not None else None}


def strategy_row_label(row: dict, artifact: Optional[dict] = None) -> str:
    """The efficiency-gate row label: strategy, `+overlap` for
    bucket-pipelined rows, `@model xN` for non-default workloads and
    `@Ndev` for the device count — the key under which two artifacts'
    rows pair up for gating. Built on `normalize_workload`, the shared
    legacy-default rule."""
    wl = normalize_workload(row, artifact)
    label = str(row.get("strategy", "?"))
    if row.get("overlap"):
        label += "+overlap"
    if (wl["model"], wl["param_scale"]) != (WORKLOAD_DEFAULTS["model"],
                                            WORKLOAD_DEFAULTS["param_scale"]):
        label += f"@{wl['model']} x{wl['param_scale']}"
    if wl["n_devices"] is not None:
        label += f"@{wl['n_devices']}dev"
    return label


def ledger_row_errors(segment: List[dict]) -> List[Tuple[int, str]]:
    """Violations of the `ledger_row` point-record contract
    (telemetry/ledger.py emits these when the ledger CLI runs with
    --telemetry) within ONE segment, as (line_no, message) pairs — shared
    with the file-loading checker like `cost_record_errors`. A ledger row
    must carry a NON-EMPTY string `series` (the key the whole trend
    history joins on), a KNOWN direction (the gate is meaningless without
    one), and a FINITE numeric value (NaN/inf in a committed history would
    poison every later median)."""
    errors: List[Tuple[int, str]] = []
    for rec in segment:
        if rec.get("kind") != "point" or rec.get("name") != LEDGER_ROW_POINT:
            continue
        line = rec.get("_line", 0)
        attrs = rec.get("attrs") or {}
        series = attrs.get("series")
        if not (isinstance(series, str) and series):
            errors.append((line, f"ledger_row record missing a non-empty "
                                 f"series key (got {series!r})"))
        direction = attrs.get("direction")
        if direction not in LEDGER_DIRECTIONS:
            errors.append((line, f"ledger_row names unknown direction "
                                 f"{direction!r}; known: "
                                 f"{LEDGER_DIRECTIONS}"))
        value = attrs.get("value")
        if not isinstance(value, (int, float)) or isinstance(value, bool) \
                or not math.isfinite(value):
            errors.append((line, f"ledger_row value must be a finite "
                                 f"number; got {value!r}"))
    return errors


def skew(values) -> Tuple[float, float]:
    """(spread, spread as % of mean) of a set of durations — THE straggler
    math: max - min, and that spread relative to the mean. One function so
    the offline cross-process report below and the ONLINE drift detector
    (`telemetry/health.py`, which watches a rolling window of this
    process's own step times) can never disagree about what "skew" means.
    Empty/zero-mean input reads as no skew."""
    vals = list(values)
    if not vals:
        return 0.0, 0.0
    lo, hi = min(vals), max(vals)
    mean = sum(vals) / len(vals)
    spread = hi - lo
    return spread, (100.0 * spread / mean if mean > 0 else 0.0)


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------

def trace_files(target: str) -> List[str]:
    """Resolve a --telemetry dir (every `events*.jsonl` inside) or a single
    trace file to a sorted list of paths. Missing target -> []."""
    if os.path.isdir(target):
        return sorted(glob.glob(os.path.join(target, "events*.jsonl")))
    return [target] if os.path.exists(target) else []


def load_trace(path: str) -> Tuple[List[dict], List[str]]:
    """Parse one JSONL trace file -> (records, errors). Lenient: malformed
    lines become errors, not exceptions — a crashed run's torn last line
    must not hide the rest of the trace. Each record gains `_line` (1-based
    line number) and `_file` for error attribution."""
    records: List[dict] = []
    errors: List[str] = []
    with open(path) as f:
        for line_no, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                errors.append(f"{path}:{line_no}: malformed JSON ({e})")
                continue
            if not isinstance(rec, dict):
                errors.append(f"{path}:{line_no}: record is not an object")
                continue
            rec["_line"] = line_no
            rec["_file"] = path
            records.append(rec)
    return records, errors


def load_traces(paths: List[str]) -> Tuple[List[dict], List[str]]:
    """Concatenate several per-process trace files (order preserved within
    each file; files are independent streams, never interleaved)."""
    records: List[dict] = []
    errors: List[str] = []
    for p in paths:
        recs, errs = load_trace(p)
        records.extend(recs)
        errors.extend(errs)
    return records, errors


# ---------------------------------------------------------------------------
# span-tree reconstruction (shared with scripts/check_telemetry.py)
# ---------------------------------------------------------------------------

def split_segments(records: List[dict]) -> List[List[dict]]:
    """One ONE-FILE record stream -> run segments. Files open in append
    mode, so an outage-resume re-exec or repeat run adds a segment beginning
    with a fresh `trace_start` meta record; span ids and the monotonic clock
    reset per segment."""
    segments: List[List[dict]] = []
    current: List[dict] = []
    for rec in records:
        if rec.get("kind") == "meta" and rec.get("name") == "trace_start":
            if current:
                segments.append(current)
            current = []
        current.append(rec)
    if current:
        segments.append(current)
    return segments


def _span_interval(rec: dict) -> Optional[Tuple[float, float]]:
    """A LIVE span's [t0, t0+dur] monotonic interval, from the start stamp
    `_Span._finish` stores in attrs. Aggregate spans (`complete_span`: a
    duration measured elsewhere, no start stamp) have no interval."""
    attrs = rec.get("attrs") or {}
    t0 = attrs.get("t0_mono")
    dur = rec.get("dur_s")
    if isinstance(t0, (int, float)) and isinstance(dur, (int, float)):
        return float(t0), float(t0) + float(dur)
    return None


def span_structure_errors(segment: List[dict]) -> List[Tuple[int, str]]:
    """Structural violations of ONE segment's span records, as
    (line_no, message) pairs — the span-tree reconstructor the checker and
    `analyze` share. Checks:

      * orphaned parents — a span's `parent` id never recorded in the
        segment (parents close AFTER children, so ids resolve against the
        whole segment);
      * duplicate span ids — the writer's counter is unique per segment, a
        repeat means interleaved writers or a corrupted file;
      * enter/exit consistency — a live span's exit (t0_mono + dur_s) must
        not land after its emission stamp: every recorded exit must match
        a real enter (negative durations are a field-level violation the
        checker's schema pass owns);
      * crossing spans — a live child's interval must sit inside its live
        parent's (strict nesting is what the writer's stack guarantees;
        a violation means ids were reused or clocks mixed).
    """
    spans: Dict[object, dict] = {}
    errors: List[Tuple[int, str]] = []
    for rec in segment:
        if rec.get("kind") != "span" or "span" not in rec:
            continue
        sid, line = rec["span"], rec.get("_line", 0)
        if sid in spans:
            errors.append((line, f"duplicate span id {sid} in segment"))
            continue
        spans[sid] = rec
        iv = _span_interval(rec)
        if iv is not None:
            t0, t1 = iv
            t_emit = rec.get("t_mono")
            # (a negative dur_s is a FIELD-level violation, owned by the
            # checker's per-line schema pass — flagging it here too would
            # double-count one defect)
            if (isinstance(t_emit, (int, float))
                    and t1 > float(t_emit) + _EPS):
                errors.append((line, f"span {sid} exit (t0_mono + dur_s = "
                                     f"{t1:.6f}) is after its emission "
                                     f"stamp {float(t_emit):.6f} — no "
                                     f"matching enter for this exit"))
    for sid, rec in spans.items():
        parent = rec.get("parent")
        if parent is None:
            continue
        line = rec.get("_line", 0)
        if parent not in spans:
            errors.append((line, f"parent span {parent} never recorded"))
            continue
        child_iv, parent_iv = _span_interval(rec), _span_interval(spans[parent])
        if child_iv is None or parent_iv is None:
            continue  # aggregate durations have no interval to contain
        (c0, c1), (p0, p1) = child_iv, parent_iv
        if c0 < p0 - _EPS or c1 > p1 + _EPS:
            errors.append((line, f"span {sid} [{c0:.6f}, {c1:.6f}] crosses "
                                 f"its parent {parent} [{p0:.6f}, {p1:.6f}]"))
    errors.sort(key=lambda e: e[0])
    return errors


def serve_structure_errors(segment: List[dict]) -> List[Tuple[int, str]]:
    """Violations of the serve request/batch span contract within ONE
    segment, as (line_no, message) pairs — shared by the file-loading
    checker exactly like `span_structure_errors`. Checks:

      * every `serve.request` span carries a NON-EMPTY string
        `request_id` (the attribution key every reader joins on);
      * a request's `batch` link resolves to a real `serve.batch` span's
        `batch_id` in the same segment (N requests -> the one batch that
        carried them; a dangling link means the batch span was lost and
        the shared-stage attribution is unverifiable);
      * `serve.batch` spans carry a non-empty `batch_id`, a known
        `coalesce` reason, and a bucket >= n_real >= 1 (occupancy > 1
        would mean rows the engine never computed);
      * a batch's stage children start in pipeline order
        (batch_form -> pad_h2d -> compute, monotone t0).
    """
    errors: List[Tuple[int, str]] = []
    batch_ids = set()
    # parent span id -> [(t0, name, line)] for batch stage children
    children: Dict[object, List[Tuple[float, str, int]]] = {}
    requests: List[dict] = []
    for rec in segment:
        if rec.get("kind") != "span":
            continue
        name, line = rec.get("name"), rec.get("_line", 0)
        attrs = rec.get("attrs") or {}
        if name == SERVE_REQUEST_SPAN:
            requests.append(rec)
            rid = attrs.get("request_id")
            if not (isinstance(rid, str) and rid):
                errors.append((line, f"serve.request span missing a "
                                     f"non-empty request_id (got {rid!r})"))
        elif name == SERVE_BATCH_SPAN:
            bid = attrs.get("batch_id")
            if not (isinstance(bid, str) and bid):
                errors.append((line, f"serve.batch span missing a "
                                     f"non-empty batch_id (got {bid!r})"))
            else:
                batch_ids.add(bid)
            reason = attrs.get("coalesce")
            if reason not in SERVE_COALESCE_REASONS:
                errors.append((line, f"unknown coalesce reason {reason!r}; "
                                     f"known: {SERVE_COALESCE_REASONS}"))
            bucket, n_real = attrs.get("bucket"), attrs.get("n_real")
            if not (isinstance(bucket, int) and isinstance(n_real, int)
                    and not isinstance(bucket, bool)
                    and not isinstance(n_real, bool)):
                # absent or mistyped fields are themselves a contract
                # violation — a guard that silently skips them could not
                # catch the occupancy story going missing
                errors.append((line, f"serve.batch span missing int "
                                     f"bucket/n_real fields (got "
                                     f"bucket={bucket!r}, "
                                     f"n_real={n_real!r})"))
            elif not 1 <= n_real <= bucket:
                errors.append((line, f"batch n_real {n_real} outside "
                                     f"[1, bucket {bucket}]"))
        elif name in SERVE_BATCH_STAGE_ORDER:
            iv = _span_interval(rec)
            parent = rec.get("parent")
            if iv is not None and parent is not None:
                children.setdefault(parent, []).append(
                    (iv[0], name, line))
    for rec in requests:
        attrs = rec.get("attrs") or {}
        link = attrs.get("batch")
        if link is not None and link not in batch_ids:
            errors.append((rec.get("_line", 0),
                           f"request {attrs.get('request_id')!r} links to "
                           f"batch {link!r} but no serve.batch span with "
                           f"that batch_id exists in this segment"))
    order = {n: i for i, n in enumerate(SERVE_BATCH_STAGE_ORDER)}
    for stages in children.values():
        stages.sort(key=lambda it: it[0])   # by start stamp
        last = -1
        for _t0, name, line in stages:
            if order[name] < last:
                errors.append((line, f"batch stage {name} starts before "
                                     f"an earlier pipeline stage ended "
                                     f"its turn (stage order must be "
                                     f"{SERVE_BATCH_STAGE_ORDER})"))
            last = max(last, order[name])
    errors.sort(key=lambda e: e[0])
    return errors


def cost_record_errors(segment: List[dict]) -> List[Tuple[int, str]]:
    """Violations of the `program_cost` point-record contract
    (telemetry/costs.py emits these at harvest) within ONE segment, as
    (line_no, message) pairs — shared with the file-loading checker like
    `serve_structure_errors`. A cost record must carry a NON-EMPTY string
    `program` (the attribution key compile times, OOM dumps, and the gate
    all join on) and only non-negative numbers in its cost fields (a
    negative flop/byte count is harvester garbage, not data)."""
    errors: List[Tuple[int, str]] = []
    for rec in segment:
        if rec.get("kind") != "point" or rec.get("name") != COST_POINT:
            continue
        line = rec.get("_line", 0)
        attrs = rec.get("attrs") or {}
        program = attrs.get("program")
        if not (isinstance(program, str) and program):
            errors.append((line, f"program_cost record missing a "
                                 f"non-empty program label (got "
                                 f"{program!r})"))
        for fld in COST_NUMERIC_FIELDS:
            v = attrs.get(fld)
            if v is None:
                continue
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or v < 0:
                errors.append((line, f"program_cost field {fld!r} must be "
                                     f"a non-negative number when "
                                     f"present; got {v!r}"))
    return errors


def dispatch_record_errors(segment: List[dict]) -> List[Tuple[int, str]]:
    """Violations of the dispatch-forensics point-record contract
    (telemetry/dispatch.py emits `dispatch_phase` / `dispatch_window`
    points at each epoch flush) within ONE segment, as (line_no, message)
    pairs — shared with the file-loading checker like
    `cost_record_errors`. A phase record must name a KNOWN phase
    (DISPATCH_PHASES — an unknown name means the writer and reader
    catalogs drifted), carry a non-negative `total_s`, and a non-negative
    int `step` index; a window record must carry non-negative `window_s`
    and `attributed_s`."""
    errors: List[Tuple[int, str]] = []
    for rec in segment:
        if rec.get("kind") != "point":
            continue
        name = rec.get("name")
        line = rec.get("_line", 0)
        attrs = rec.get("attrs") or {}
        if name == DISPATCH_PHASE_POINT:
            phase = attrs.get("phase")
            if phase not in DISPATCH_PHASES:
                errors.append((line, f"dispatch_phase record names unknown "
                                     f"phase {phase!r}; known: "
                                     f"{DISPATCH_PHASES}"))
            total = attrs.get("total_s")
            if not isinstance(total, (int, float)) \
                    or isinstance(total, bool) or total < 0:
                errors.append((line, f"dispatch_phase total_s must be a "
                                     f"non-negative number; got {total!r}"))
            step = attrs.get("step")
            if not isinstance(step, int) or isinstance(step, bool) \
                    or step < 0:
                errors.append((line, f"dispatch_phase step must be a "
                                     f"non-negative int index; got "
                                     f"{step!r}"))
        elif name == DISPATCH_WINDOW_POINT:
            for fld in ("window_s", "attributed_s"):
                v = attrs.get(fld)
                if not isinstance(v, (int, float)) or isinstance(v, bool) \
                        or v < 0:
                    errors.append((line, f"dispatch_window {fld} must be a "
                                         f"non-negative number; got "
                                         f"{v!r}"))
    return errors


def fleet_record_errors(segment: List[dict]) -> List[Tuple[int, str]]:
    """Violations of the fleet/reload point-record contract
    (serve/fleet.py state transitions, serve/reload.py verdicts) within
    ONE segment, as (line_no, message) pairs — shared with the
    file-loading checker like `dispatch_record_errors`.

    A `fleet_event` must name a KNOWN event (writer/reader catalog
    drift otherwise) and a non-negative int `replica`; a quarantine must
    name a known cause. A `reload_event` must name a known event; a
    `swapped` event must carry `outstanding_at_swap == 0` — THE
    drain-before-swap invariant (any other value means a request's
    batch was still in flight when the engine under it changed); a
    `refused` event must carry a non-empty string `reason` (refusal
    by name is the whole point)."""
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


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted list; 0.0 when empty.
    Exact for the sample (no bucketing — the trace holds every duration)."""
    if not sorted_vals:
        return 0.0
    rank = max(1, math.ceil(q * len(sorted_vals)))
    return sorted_vals[min(rank, len(sorted_vals)) - 1]


def _stats(vals: List[float], with_p99: bool = False) -> dict:
    """n/p50/p95/max/mean/total over `vals`; the serve report adds p99
    (tail attribution is ABOUT the p99) via `with_p99` — one builder, so
    a fix to either caller's stats cannot miss the other."""
    s = sorted(vals)
    out = {
        "n": len(s),
        "p50_s": _percentile(s, 0.50),
        "p95_s": _percentile(s, 0.95),
    }
    if with_p99:
        out["p99_s"] = _percentile(s, 0.99)
    out.update({
        "max_s": s[-1] if s else 0.0,
        "mean_s": (sum(s) / len(s)) if s else 0.0,
        "total_s": sum(s),
    })
    return out


def clock_offset(records: List[dict]) -> float:
    """This stream's wall = mono + offset. Every record carries both stamps,
    so the offset is the median of their differences — robust to the few
    records delayed between the two clock reads (e.g. under a paging
    stall)."""
    diffs = sorted(float(r["t_wall"]) - float(r["t_mono"]) for r in records
                   if isinstance(r.get("t_wall"), (int, float))
                   and isinstance(r.get("t_mono"), (int, float)))
    return diffs[len(diffs) // 2] if diffs else 0.0


def _linear_trend_pct(values: List[float]) -> Optional[float]:
    """Least-squares slope of `values` over their index, as percent of the
    mean per step — the per-epoch drift signal (positive = getting slower).
    None with fewer than 2 points or a zero mean."""
    n = len(values)
    if n < 2:
        return None
    mean = sum(values) / n
    if mean <= 0:
        return None
    xbar = (n - 1) / 2
    num = sum((i - xbar) * (v - mean) for i, v in enumerate(values))
    den = sum((i - xbar) ** 2 for i in range(n))
    return 100.0 * (num / den) / mean


def analyze(paths: List[str]) -> dict:
    """One or many per-process trace files -> the machine-readable report.

    Phase statistics pool every process's spans (a straggler's slow steps
    belong in the distribution); the straggler section then separates the
    processes back out, comparing per-epoch durations and wall-aligned
    start times across ranks."""
    records, parse_errors = load_traces(paths)
    span_errors = list(parse_errors)
    # name -> [dur], pooled across processes
    phase_durs: Dict[str, List[float]] = {name: [] for name in PHASES}
    # (segment_ordinal, proc, epoch) -> dur / aligned wall start, from the
    # epoch spans. The segment ordinal keeps appended runs apart: a repeat
    # run re-emits epochs 0..N into the same file, and collapsing them to
    # (proc, epoch) would silently last-wins-overwrite the first run.
    epoch_dur: Dict[Tuple[int, int, int], float] = {}
    epoch_start: Dict[Tuple[int, int, int], float] = {}
    procs = set()
    snapshots = 0

    by_file: Dict[str, List[dict]] = {}
    for rec in records:
        by_file.setdefault(rec["_file"], []).append(rec)

    for path, recs in by_file.items():
        for seg_idx, seg in enumerate(split_segments(recs)):
            # Offset per SEGMENT, not per file: the monotonic clock resets
            # across the re-exec/reboot that starts an appended segment, so
            # one file-wide median would misalign whichever segment has
            # fewer records by the whole outage gap.
            off = clock_offset(seg)
            span_errors.extend(
                f"{path}:{line}: {msg}"
                for line, msg in span_structure_errors(seg))
            for rec in seg:
                proc = rec.get("proc", 0)
                procs.add(proc)
                kind = rec.get("kind")
                if kind == "snapshot":
                    snapshots += 1
                if kind != "span":
                    continue
                dur = rec.get("dur_s")
                if not isinstance(dur, (int, float)):
                    continue
                name = rec.get("name")
                if name in phase_durs:
                    phase_durs[name].append(float(dur))
                if name in ("epoch", "fused_run"):
                    attrs = rec.get("attrs") or {}
                    epoch = attrs.get("epoch", 0)
                    if not isinstance(epoch, int):
                        continue
                    key = (seg_idx, proc, epoch)
                    epoch_dur[key] = float(dur)
                    iv = _span_interval(rec)
                    if iv is not None:
                        epoch_start[key] = iv[0] + off

    phases = {name: _stats(durs)
              for name, durs in phase_durs.items() if durs}

    # per-epoch trend: mean duration across processes, in run order
    # (segment ordinal first — an appended repeat run's epochs follow the
    # first run's, they do not merge with them)
    epoch_ids = sorted({(s, e) for (s, _p, e) in epoch_dur})
    per_epoch_mean = []
    for s, e in epoch_ids:
        durs = [d for (ss, _p, ee), d in epoch_dur.items()
                if (ss, ee) == (s, e)]
        per_epoch_mean.append(sum(durs) / len(durs))
    epochs = {
        "count": len(epoch_ids),
        "mean_s": (sum(per_epoch_mean) / len(per_epoch_mean)
                   if per_epoch_mean else 0.0),
        "durations_s": per_epoch_mean,
        "trend_pct_per_epoch": _linear_trend_pct(per_epoch_mean),
    }

    # straggler skew: same epoch, different processes
    straggler = {"processes": len(procs), "epochs_compared": 0,
                 "max_skew_s": 0.0, "max_skew_pct": 0.0,
                 "mean_skew_pct": 0.0, "max_start_spread_s": 0.0,
                 "worst_epoch": None}
    skew_pcts = []
    for s, e in epoch_ids:
        durs = {p: d for (ss, p, ee), d in epoch_dur.items()
                if (ss, ee) == (s, e)}
        if len(durs) < 2:
            continue
        straggler["epochs_compared"] += 1
        skew_s, skew_pct = skew(durs.values())
        skew_pcts.append(skew_pct)
        if skew_s > straggler["max_skew_s"]:
            straggler.update(max_skew_s=skew_s, max_skew_pct=skew_pct,
                             worst_epoch={"epoch": e, "segment": s,
                                          "dur_s_by_proc": {str(p): d
                                                            for p, d
                                                            in sorted(
                                                                durs.items())}})
        starts = [epoch_start[(s, p, e)] for p in durs
                  if (s, p, e) in epoch_start]
        if len(starts) >= 2:
            straggler["max_start_spread_s"] = max(
                straggler["max_start_spread_s"], max(starts) - min(starts))
    if skew_pcts:
        straggler["mean_skew_pct"] = sum(skew_pcts) / len(skew_pcts)

    return {
        "report": "trace_phase_stats",
        "v": 1,
        "files": sorted(by_file),
        "processes": sorted(procs),
        "n_processes": len(procs),
        "records": len(records),
        "snapshots": snapshots,
        "span_errors": span_errors,
        "phases": phases,
        "epochs": epochs,
        "straggler": straggler,
    }


# ---------------------------------------------------------------------------
# the serve report: tail-latency attribution
# ---------------------------------------------------------------------------

def _serve_stats(vals: List[float]) -> dict:
    return _stats(vals, with_p99=True)


def serve_report(paths: List[str], exemplar_k: int = SERVE_EXEMPLAR_K) -> dict:
    """One or many serve trace files -> the tail-latency attribution
    report (`trace report --serve`):

      * per-stage latency statistics (p50/p95/p99) for every stage in
        `SERVE_STAGES`, with each stage's share of total end-to-end time
        (`pct_of_e2e`) — where the tail actually comes from;
      * `attribution_coverage`: sum of stage totals / e2e total. The
        stages telescope (each duration ends where the next begins), so
        this must sit near 1.0 — the acceptance test pins it within 5%.
        A hole here means a stage went missing, not jitter;
      * batch statistics: occupancy, padding waste (bucket rows computed
        that carried no request), coalesce-reason counts — the
        size-vs-deadline knob's observable output;
      * the slowest-`exemplar_k` requests as full stage trees (the same
        shape the live path leaves in the flight recorder at drain).

    Only completed requests with a full stage breakdown contribute to the
    stage table (a failed request has no honest decomposition); their
    count vs total is reported so silently dropped coverage is visible.
    """
    records, parse_errors = load_traces(paths)
    span_errors = list(parse_errors)
    stage_durs: Dict[str, List[float]] = {s: [] for s in SERVE_STAGES}
    e2e_durs: List[float] = []
    requests = attributed = 0
    exemplars: List[Tuple[float, int, dict]] = []
    batches: List[dict] = []
    procs = set()

    by_file: Dict[str, List[dict]] = {}
    for rec in records:
        by_file.setdefault(rec["_file"], []).append(rec)

    for path, recs in by_file.items():
        for seg in split_segments(recs):
            span_errors.extend(
                f"{path}:{line}: {msg}"
                for line, msg in span_structure_errors(seg))
            span_errors.extend(
                f"{path}:{line}: {msg}"
                for line, msg in serve_structure_errors(seg))
            for rec in seg:
                if rec.get("kind") != "span":
                    continue
                procs.add(rec.get("proc", 0))
                name = rec.get("name")
                attrs = rec.get("attrs") or {}
                if name == SERVE_BATCH_SPAN:
                    batches.append(attrs)
                if name != SERVE_REQUEST_SPAN:
                    continue
                requests += 1
                dur = rec.get("dur_s")
                stages = {s: attrs.get(f"{s}_s") for s in SERVE_STAGES}
                if (not isinstance(dur, (int, float))
                        or not all(isinstance(v, (int, float))
                                   for v in stages.values())):
                    continue   # failed / partial request: counted above
                attributed += 1
                e2e_durs.append(float(dur))
                for s, v in stages.items():
                    stage_durs[s].append(float(v))
                tree = {"request_id": attrs.get("request_id"),
                        "e2e_s": float(dur),
                        "stages": {f"{s}_s": float(v)
                                   for s, v in stages.items()},
                        "batch_id": attrs.get("batch")}
                item = (float(dur), attributed, tree)
                if len(exemplars) < exemplar_k:
                    heapq.heappush(exemplars, item)
                elif dur > exemplars[0][0]:
                    heapq.heapreplace(exemplars, item)

    e2e_total = sum(e2e_durs)
    stages_out = {}
    for s in SERVE_STAGES:
        durs = stage_durs[s]
        if not durs:
            continue
        st = _serve_stats(durs)
        st["pct_of_e2e"] = (100.0 * st["total_s"] / e2e_total
                            if e2e_total > 0 else 0.0)
        stages_out[s] = st
    stage_total = sum(st["total_s"] for st in stages_out.values())

    real_rows = sum(b.get("n_real", 0) for b in batches
                    if isinstance(b.get("n_real"), int))
    bucket_rows = sum(b.get("bucket", 0) for b in batches
                      if isinstance(b.get("bucket"), int))
    occs = [b["occupancy"] for b in batches
            if isinstance(b.get("occupancy"), (int, float))]
    coalesce: Dict[str, int] = {}
    for b in batches:
        r = b.get("coalesce")
        if isinstance(r, str):
            coalesce[r] = coalesce.get(r, 0) + 1

    return {
        "report": "serve_trace_attribution",
        "v": 1,
        "files": sorted(by_file),
        "processes": sorted(procs),
        "requests": requests,
        "attributed": attributed,
        "span_errors": span_errors,
        "e2e": _serve_stats(e2e_durs),
        "stages": stages_out,
        # stage totals / e2e total: the stages must ~cover the e2e story
        "attribution_coverage": (stage_total / e2e_total
                                 if e2e_total > 0 else None),
        "batches": {
            "count": len(batches),
            "mean_occupancy": (sum(occs) / len(occs) if occs else None),
            # bucket rows computed that carried no request — the padding
            # bill the coalescing knobs are paying
            "padding_waste_pct": (100.0 * (1.0 - real_rows / bucket_rows)
                                  if bucket_rows else None),
            "coalesce": coalesce,
        },
        "slowest": [t for _, _, t in sorted(exemplars,
                                            key=lambda it: -it[0])],
    }


# Below this per-request p95, a stage's share measures scheduler noise,
# not the pipeline: the share gate never regresses on a sub-ms stage —
# the same rule the step-time and data-share gates apply.
SERVE_SUBMS_EXEMPT_S = 1e-3


def compare_serve(new: dict, baseline: dict, threshold: float = 1.5) -> dict:
    """The serve stage-share regression gate (`trace report --serve
    --baseline OLD`): one row per stage present in both reports, gating
    each stage's SHARE of end-to-end time (`pct_of_e2e`). `compute` is
    the useful work — its share is better-BIGGER, so its ratio is old/new
    (the efficiency-gate convention: a drop reads as > 1); every other
    stage is overhead the fast path exists to shrink — better-smaller,
    ratio new/old. A regression is a ratio past `threshold`, UNLESS the
    stage's absolute per-request p95 is sub-millisecond in both runs
    (`SERVE_SUBMS_EXEMPT_S`: at that scale the share's numerator is
    scheduler noise — the step-time gate's exemption rule). The headline
    row this gate exists for: compute's share of e2e at saturation must
    not fall past threshold once the fast path lands (ROADMAP item 3)."""
    rows, regressions = [], []
    for stage in SERVE_STAGES:
        old_st = (baseline.get("stages") or {}).get(stage) or {}
        new_st = (new.get("stages") or {}).get(stage) or {}
        old_v, new_v = old_st.get("pct_of_e2e"), new_st.get("pct_of_e2e")
        if not (isinstance(old_v, (int, float))
                and isinstance(new_v, (int, float)) and old_v > 0):
            continue
        if stage == "compute":
            # a compute-share COLLAPSE to zero is the worst regression,
            # not a skippable row (the efficiency-gate convention)
            ratio = (old_v / new_v) if new_v > 0 else float("inf")
        else:
            ratio = new_v / old_v
        p95s = [v for v in (old_st.get("p95_s"), new_st.get("p95_s"))
                if isinstance(v, (int, float))]
        exempt = bool(p95s) and max(p95s) < SERVE_SUBMS_EXEMPT_S
        row = {"stage": stage, "stat": "pct_of_e2e",
               "baseline_pct": old_v, "new_pct": new_v, "ratio": ratio,
               "sub_ms_exempt": exempt,
               "regressed": ratio > threshold and not exempt}
        rows.append(row)
        if row["regressed"]:
            regressions.append(row)
    return {"threshold": threshold, "rows": rows,
            "regressions": regressions}


def format_compare_serve(diff: dict) -> str:
    lines = [f"serve stage-share gate (ratio > {diff['threshold']:g}x "
             f"regresses; compute share better-bigger, overhead shares "
             f"better-smaller; sub-ms stages exempt):"]
    for row in diff["rows"]:
        verdict = ("REGRESSION" if row["regressed"]
                   else "exempt (sub-ms)" if row["sub_ms_exempt"]
                   and row["ratio"] > diff["threshold"] else "ok")
        lines.append(f"  {row['stage']:<12} share "
                     f"{row['baseline_pct']:6.1f}% -> "
                     f"{row['new_pct']:6.1f}%  ({row['ratio']:.2f}x)  "
                     f"{verdict}")
    if not diff["rows"]:
        lines.append("  (no stage overlaps the baseline — nothing gated)")
    n = len(diff["regressions"])
    lines.append(f"regression gate: "
                 f"{f'FAIL — {n} stage share(s) past threshold' if n else 'PASS'}")
    return "\n".join(lines)


def format_serve_report(report: dict) -> str:
    """Human rendering of `serve_report` (the --json flag prints the dict
    itself)."""
    lines = [f"serve trace report: {report['requests']} request(s), "
             f"{report['attributed']} with full stage attribution, "
             f"{report['batches']['count']} batch(es)"]
    if report["stages"]:
        e2e = report["e2e"]
        lines.append(f"{'stage':<12} {'n':>6} {'p50_ms':>9} {'p95_ms':>9} "
                     f"{'p99_ms':>9} {'% of e2e':>9}")
        for s in SERVE_STAGES:
            st = report["stages"].get(s)
            if st:
                lines.append(f"{s:<12} {st['n']:>6} "
                             f"{st['p50_s'] * 1e3:>9.3f} "
                             f"{st['p95_s'] * 1e3:>9.3f} "
                             f"{st['p99_s'] * 1e3:>9.3f} "
                             f"{st['pct_of_e2e']:>8.1f}%")
        lines.append(f"{'e2e':<12} {e2e['n']:>6} {e2e['p50_s'] * 1e3:>9.3f} "
                     f"{e2e['p95_s'] * 1e3:>9.3f} "
                     f"{e2e['p99_s'] * 1e3:>9.3f} {'100.0%':>9}")
        cov = report["attribution_coverage"]
        lines.append(f"attribution coverage: {100.0 * cov:.1f}% of e2e "
                     f"accounted to stages" if cov is not None else
                     "attribution coverage: n/a")
    elif report["requests"]:
        lines.append(f"no fully attributed requests: {report['requests']} "
                     f"serve.request span(s) present but none carry a "
                     f"complete stage breakdown (all-failed requests, or "
                     f"a partial/torn trace)")
    else:
        lines.append("no serve.request spans found (serve with --telemetry "
                     "DIR to emit them)")
    b = report["batches"]
    if b["count"]:
        occ = (f"{b['mean_occupancy']:.3f}" if b["mean_occupancy"]
               is not None else "n/a")
        waste = (f"{b['padding_waste_pct']:.1f}%"
                 if b["padding_waste_pct"] is not None else "n/a")
        reasons = ", ".join(f"{k}={v}" for k, v in
                            sorted(b["coalesce"].items())) or "none"
        lines.append(f"batches: {b['count']} (mean occupancy {occ}, "
                     f"padding waste {waste}; coalesce: {reasons})")
    for i, t in enumerate(report["slowest"], 1):
        worst = max(t["stages"].items(), key=lambda kv: kv[1])
        lines.append(f"slow #{i}: {t['request_id']} "
                     f"e2e {t['e2e_s'] * 1e3:.3f}ms "
                     f"(worst stage {worst[0]} {worst[1] * 1e3:.3f}ms, "
                     f"batch {t['batch_id']})")
    if report["span_errors"]:
        lines.append(f"span structure: {len(report['span_errors'])} "
                     f"violation(s) — run scripts/check_telemetry.py")
    else:
        lines.append("span structure: OK")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the data-wait attribution report (`trace report --data`)
# ---------------------------------------------------------------------------

# Below this, the data_wait p95 measures scheduler noise, not the input
# stack: the share gate never fires on a sub-millisecond wait (the same
# rule the step-time gate applies to its absolute values).
DATA_SUBMS_EXEMPT_S = 1e-3


def data_report(paths: List[str]) -> dict:
    """One or many train trace files -> the input-attribution report
    (`trace report --data`): per-epoch data_wait SHARE — the fraction of
    each `epoch` span its `data_wait` child occupies, i.e. how much of
    training the host spent blocked on the input pipeline. Shares pair a
    data_wait span with ITS OWN parent epoch span (per segment, per
    process), so appended resume runs and stragglers never cross-
    contaminate. The p95 share is what the regression gate rides
    (`compare_data`): the pipeline's whole job is driving it toward 0,
    and a silent regression here is invisible to the step-time gate when
    compute shrinks in proportion."""
    records, parse_errors = load_traces(paths)
    span_errors = list(parse_errors)
    shares: List[float] = []
    waits: List[float] = []
    epoch_durs: List[float] = []
    batch_counts: List[int] = []
    procs = set()

    by_file: Dict[str, List[dict]] = {}
    for rec in records:
        by_file.setdefault(rec["_file"], []).append(rec)

    for path, recs in by_file.items():
        for seg in split_segments(recs):
            span_errors.extend(
                f"{path}:{line}: {msg}"
                for line, msg in span_structure_errors(seg))
            spans = {rec["span"]: rec for rec in seg
                     if rec.get("kind") == "span" and "span" in rec}
            for rec in spans.values():
                procs.add(rec.get("proc", 0))
                if rec.get("name") != "data_wait":
                    continue
                dur = rec.get("dur_s")
                parent = spans.get(rec.get("parent"))
                if (not isinstance(dur, (int, float)) or parent is None
                        or parent.get("name") != "epoch"):
                    continue
                pdur = parent.get("dur_s")
                if not isinstance(pdur, (int, float)) or pdur <= 0:
                    continue
                waits.append(float(dur))
                epoch_durs.append(float(pdur))
                shares.append(float(dur) / float(pdur))
                nb = (rec.get("attrs") or {}).get("batches")
                if isinstance(nb, int) and not isinstance(nb, bool):
                    batch_counts.append(nb)

    s = sorted(shares)
    return {
        "report": "trace_data_stats",
        "v": 1,
        "files": sorted(by_file),
        "processes": sorted(procs),
        "records": len(records),
        "epochs": len(shares),
        "span_errors": span_errors,
        "data_wait": _stats(waits, with_p99=True),
        "epoch": _stats(epoch_durs),
        "batches": sum(batch_counts),
        # fractions of the epoch the host spent blocked on input
        "share": {
            "p50": _percentile(s, 0.50),
            "p95": _percentile(s, 0.95),
            "max": s[-1] if s else 0.0,
            "mean": (sum(s) / len(s)) if s else 0.0,
        },
    }


def compare_data(new: dict, baseline: dict, threshold: float = 1.5) -> dict:
    """The data_wait-share regression gate: one row per share stat
    (p50/p95) present in both reports; a regression is a share ratio
    (new/old) past `threshold` — mirroring the step-time gate's
    convention — UNLESS the new run's absolute data_wait p95 is
    sub-millisecond (`DATA_SUBMS_EXEMPT_S`: at that scale the share's
    numerator is scheduler noise). `cli/trace.py report --data
    --baseline` turns regressions into exit 3, the same contract as the
    step-time and efficiency gates."""
    rows, regressions = [], []
    new_wait_p95 = (new.get("data_wait") or {}).get("p95_s", 0.0)
    exempt = (isinstance(new_wait_p95, (int, float))
              and new_wait_p95 < DATA_SUBMS_EXEMPT_S)
    for stat in ("p50", "p95"):
        old_v = (baseline.get("share") or {}).get(stat)
        new_v = (new.get("share") or {}).get(stat)
        if not (isinstance(old_v, (int, float))
                and isinstance(new_v, (int, float)) and old_v > 0):
            continue
        ratio = new_v / old_v
        row = {"phase": "data_wait_share", "stat": stat,
               "baseline": old_v, "new": new_v, "ratio": ratio,
               "sub_ms_exempt": exempt,
               "regressed": ratio > threshold and not exempt}
        rows.append(row)
        if row["regressed"]:
            regressions.append(row)
    return {"threshold": threshold, "rows": rows,
            "regressions": regressions}


def format_data_report(report: dict) -> str:
    """Human rendering of `data_report` (the --json flag prints the dict
    itself)."""
    lines = [f"data report: {report['epochs']} epoch(s) with data_wait "
             f"attribution across {len(report['files'])} file(s), "
             f"{report['batches']} batch wait(s)"]
    if report["epochs"]:
        sh, dw = report["share"], report["data_wait"]
        lines.append(f"data_wait share of epoch: p50 {100 * sh['p50']:.1f}% "
                     f"p95 {100 * sh['p95']:.1f}% max {100 * sh['max']:.1f}% "
                     f"(mean {100 * sh['mean']:.1f}%)")
        lines.append(f"data_wait absolute: p50 {dw['p50_s']:.4f}s "
                     f"p95 {dw['p95_s']:.4f}s max {dw['max_s']:.4f}s "
                     f"total {dw['total_s']:.4f}s")
        lines.append(f"epoch absolute: p50 {report['epoch']['p50_s']:.4f}s "
                     f"p95 {report['epoch']['p95_s']:.4f}s")
    else:
        lines.append("no epoch spans with a data_wait child found (a "
                     "--telemetry STREAMING train run emits them; the "
                     "cached path has no host data wait)")
    if report["span_errors"]:
        lines.append(f"span structure: {len(report['span_errors'])} "
                     f"violation(s) — run scripts/check_telemetry.py")
    return "\n".join(lines)


def format_compare_data(diff: dict) -> str:
    lines = [f"data-wait share gate (ratio > {diff['threshold']:g}x "
             f"regresses; sub-ms data_wait exempt):"]
    for row in diff["rows"]:
        verdict = ("REGRESSION" if row["regressed"]
                   else "exempt (sub-ms)" if row["sub_ms_exempt"]
                   and row["ratio"] > diff["threshold"] else "ok")
        lines.append(f"  share {row['stat']:<4} "
                     f"{100 * row['baseline']:.1f}% -> "
                     f"{100 * row['new']:.1f}%  ({row['ratio']:.2f}x)  "
                     f"{verdict}")
    if not diff["rows"]:
        lines.append("  (no share stats overlap baseline — nothing gated)")
    n = len(diff["regressions"])
    lines.append(f"regression gate: "
                 f"{f'FAIL — {n} share stat(s) past threshold' if n else 'PASS'}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the regression gate
# ---------------------------------------------------------------------------

EFFICIENCY_STAT = "scaling_efficiency_vs_1dev"


def efficiency_report(artifact: dict, path: str = "<artifact>") -> dict:
    """A report-shaped dict from a DDP bench artifact (the
    `MULTICHIP_r0X.json` shape: a `strategies` list of
    `bench.ddp_strategy_rows` rows). The phases section stays empty —
    what the artifact carries is per-strategy `scaling_efficiency_vs_1dev`
    under an `efficiency` key, which `compare` gates exactly like the
    step-time stats (ROADMAP item 2: efficiency regressions must exit 3
    like step-time regressions already do). Row labels are
    `strategy` plus `+overlap` for bucket-pipelined rows, plus
    `@model xN` for rows measured on a non-default workload and
    `@Ndev` for the device count (row-level, falling back to the
    artifact's) — efficiency is only comparable at MATCHED model size
    AND device count (per-chip efficiency always falls as devices grow),
    so rows from different `--model`/`--param_scale`/pool-size runs
    must never gate against each other (legacy artifacts without the
    workload fields are the default 118k mlp at scale 1 — the shared
    `normalize_workload` rule, which the performance ledger's series
    keys also use, so gate labels and ledger series can never
    disagree)."""
    eff = {}
    for row in artifact.get("strategies") or []:
        if not isinstance(row, dict):
            continue
        v = row.get(EFFICIENCY_STAT)
        if not isinstance(v, (int, float)):
            continue
        eff[strategy_row_label(row, artifact)] = float(v)
    return {
        "report": "trace_phase_stats", "v": 1,
        "files": [path], "processes": [], "n_processes": 0,
        "records": len(eff), "snapshots": 0, "span_errors": [],
        "phases": {},
        "epochs": {"count": 0, "mean_s": 0.0, "durations_s": [],
                   "trend_pct_per_epoch": None},
        "straggler": {"processes": 0, "epochs_compared": 0,
                      "max_skew_s": 0.0, "max_skew_pct": 0.0,
                      "mean_skew_pct": 0.0, "max_start_spread_s": 0.0,
                      "worst_epoch": None},
        "efficiency": eff,
    }


def compare(new: dict, baseline: dict, threshold: float = 1.5,
            stats: Tuple[str, ...] = ("p50_s", "p95_s")) -> dict:
    """Diff two reports' phase statistics -> {"rows": [...], "regressions":
    [...]}. A row per (phase, stat) present in both reports; a regression is
    a ratio past `threshold` (new/old > threshold means SLOWER). Tiny
    absolute values are not gated (< 1 ms both sides): at that scale the
    ratio measures scheduler noise, not the workload.

    Reports carrying an `efficiency` section (DDP bench artifacts via
    `efficiency_report`) gate scaling efficiency the same way, one row per
    strategy present in both. Efficiency is better-is-BIGGER, so its ratio
    is old/new — the same "ratio > threshold means regressed" convention
    as the time rows (a drop from 0.3 to 0.15 reads as 2.0x)."""
    rows, regressions = [], []
    for phase in sorted(set(new.get("phases", {}))
                        & set(baseline.get("phases", {}))):
        for stat in stats:
            old_v = baseline["phases"][phase].get(stat)
            new_v = new["phases"][phase].get(stat)
            if not (isinstance(old_v, (int, float))
                    and isinstance(new_v, (int, float)) and old_v > 0):
                continue
            ratio = new_v / old_v
            row = {"phase": phase, "stat": stat, "baseline_s": old_v,
                   "new_s": new_v, "ratio": ratio,
                   "regressed": (ratio > threshold
                                 and max(old_v, new_v) >= 1e-3)}
            rows.append(row)
            if row["regressed"]:
                regressions.append(row)
    eff_new = new.get("efficiency") or {}
    eff_old = baseline.get("efficiency") or {}
    for label in sorted(set(eff_new) & set(eff_old)):
        old_v, new_v = eff_old[label], eff_new[label]
        if not (isinstance(old_v, (int, float))
                and isinstance(new_v, (int, float)) and old_v > 0):
            continue
        # efficiency DROP reads as >1 (slower); a collapse to <= 0 (the
        # artifact rounds to 4 decimals, so a dead strategy lands as
        # exactly 0.0) is the WORST regression, not a skippable row
        ratio = (old_v / new_v) if new_v > 0 else float("inf")
        row = {"phase": label, "stat": EFFICIENCY_STAT,
               "baseline_s": old_v, "new_s": new_v, "ratio": ratio,
               "regressed": ratio > threshold}
        rows.append(row)
        if row["regressed"]:
            regressions.append(row)
    return {"threshold": threshold, "rows": rows, "regressions": regressions}


def format_report(report: dict) -> str:
    """The human rendering of `analyze`'s dict (the --json flag prints the
    dict itself)."""
    lines = [f"trace report: {report['n_processes']} process(es), "
             f"{len(report['files'])} file(s), {report['records']} "
             f"record(s)"]
    if report["phases"]:
        lines.append(f"{'phase':<14} {'n':>6} {'p50_s':>10} {'p95_s':>10} "
                     f"{'max_s':>10} {'total_s':>10}")
        for name in PHASES:
            st = report["phases"].get(name)
            if st:
                lines.append(f"{name:<14} {st['n']:>6} {st['p50_s']:>10.4f} "
                             f"{st['p95_s']:>10.4f} {st['max_s']:>10.4f} "
                             f"{st['total_s']:>10.4f}")
    else:
        lines.append("no phase spans found (not a --telemetry train trace?)")
    ep = report["epochs"]
    if ep["count"]:
        trend = ep["trend_pct_per_epoch"]
        trend_txt = (f", trend {trend:+.1f}%/epoch" if trend is not None
                     else "")
        lines.append(f"epochs: {ep['count']} "
                     f"(mean {ep['mean_s']:.4f}s{trend_txt})")
    st = report["straggler"]
    if st["epochs_compared"]:
        worst = st["worst_epoch"]
        lines.append(f"straggler skew: max {st['max_skew_s']:.4f}s "
                     f"({st['max_skew_pct']:.1f}% of epoch mean) at epoch "
                     f"{worst['epoch']}; mean {st['mean_skew_pct']:.1f}%; "
                     f"start spread {st['max_start_spread_s']:.4f}s")
    elif st["processes"] > 1:
        lines.append("straggler skew: no epoch seen on 2+ processes")
    else:
        lines.append("straggler skew: single process (nothing to compare)")
    if report["span_errors"]:
        lines.append(f"span structure: {len(report['span_errors'])} "
                     f"violation(s) — run scripts/check_telemetry.py")
    else:
        lines.append("span structure: OK")
    return "\n".join(lines)


def format_compare(diff: dict) -> str:
    lines = [f"baseline comparison (gate: ratio > {diff['threshold']:g}x "
             f"on p50/p95):"]
    for row in diff["rows"]:
        verdict = "REGRESSION" if row["regressed"] else "ok"
        u = "" if row["stat"] == EFFICIENCY_STAT else "s"
        lines.append(f"  {row['phase']:<14} {row['stat']:<6} "
                     f"{row['baseline_s']:.4f}{u} -> {row['new_s']:.4f}{u}  "
                     f"({row['ratio']:.2f}x)  {verdict}")
    if not diff["rows"]:
        lines.append("  (no phase overlaps baseline — nothing gated)")
    n = len(diff["regressions"])
    verdict = f"FAIL — {n} phase stat(s) past threshold" if n else "PASS"
    lines.append(f"regression gate: {verdict}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# dispatch-overhead attribution (trace report --overhead)
# ---------------------------------------------------------------------------

def _overhead_row(program: str, phases_s: dict, *, window_s: float,
                  steps: int, coverage: float,
                  overhead_share: Optional[float] = None,
                  note: Optional[str] = None) -> dict:
    """One report row: per-phase totals + shares of the window, coverage,
    and the worst HOST phase (device_idle is the device-side view of the
    same interval python_prestep + dispatch occupy — never 'worst')."""
    phases = {}
    for phase in DISPATCH_PHASES:
        total = phases_s.get(phase)
        if not isinstance(total, (int, float)):
            continue
        phases[phase] = {
            "total_s": float(total),
            "share": (float(total) / window_s) if window_s > 0 else 0.0,
        }
    host = [(p, phases[p]["total_s"]) for p in DISPATCH_COVERAGE_PHASES
            if p in phases]
    worst = max(host, key=lambda it: it[1]) if host else (None, 0.0)
    row = {
        "program": program,
        "window_s": window_s,
        "steps": int(steps),
        "phases": phases,
        "attributed_s": sum(s for _p, s in host),
        "coverage": coverage,
        "worst_phase": worst[0],
        "worst_share": ((worst[1] / window_s) if window_s > 0 else 0.0),
    }
    if overhead_share is not None:
        row["overhead_share"] = overhead_share
    if note:
        row["note"] = note
    return row


def overhead_report(paths: List[str]) -> dict:
    """The dispatch-overhead decomposition from one or many `--telemetry
    --profile_dispatch` traces: per-phase totals pooled across epochs and
    processes, shares of the profiled step-boundary window, coverage =
    attributed / window (what share of the window the named phases
    explain — falls below OVERHEAD_COVERAGE_MIN when someone grows
    unprofiled loop work), and the worst host phase. One row per
    process's trace (label `train` / `train@rankN`)."""
    records, errors = load_traces(paths)
    by_file: dict = {}
    for rec in records:
        by_file.setdefault(rec["_file"], []).append(rec)
    rows = []
    for fname in sorted(by_file):
        phases_s: dict = {}
        window_s = attributed_s = 0.0
        steps = 0
        proc = 0
        seen = False
        for rec in by_file[fname]:
            if rec.get("kind") != "point":
                continue
            attrs = rec.get("attrs") or {}
            if rec.get("name") == DISPATCH_PHASE_POINT:
                phase, total = attrs.get("phase"), attrs.get("total_s")
                if phase in DISPATCH_PHASES \
                        and isinstance(total, (int, float)):
                    phases_s[phase] = phases_s.get(phase, 0.0) \
                        + float(total)
                    seen = True
            elif rec.get("name") == DISPATCH_WINDOW_POINT:
                window_s += float(attrs.get("window_s") or 0.0)
                attributed_s += float(attrs.get("attributed_s") or 0.0)
                steps += int(attrs.get("steps") or 0)
                proc = int(rec.get("proc", 0))
                seen = True
        if not seen:
            continue
        coverage = (attributed_s / window_s) if window_s > 0 else 1.0
        label = "train" if proc == 0 else f"train@rank{proc}"
        rows.append(_overhead_row(label, phases_s, window_s=window_s,
                                  steps=steps, coverage=coverage))
    return {"report": OVERHEAD_REPORT_TAG, "v": 1,
            "files": sorted(by_file), "load_errors": errors, "rows": rows}


def overhead_from_artifact(artifact: dict,
                           path: str = "<artifact>") -> dict:
    """The same report shape from a DDP bench artifact (the
    `MULTICHIP_r0X.json` shape) whose rows carry the `overhead_phases`
    stamp (`bench.py --mode ddp` measures a streaming-step dispatch probe
    per strategy). The window is the probe's full step-boundary wall
    (host phases sum to it by construction); `coverage` is the stamped
    share of the roofline's O = T - bound that the host phases explain,
    clamped at 1.0 when the streaming probe's host cost exceeds the
    fused program's O (an upper-bound attribution — docs/PERF.md).
    Legacy rows without the stamp degrade to a named note, never a
    silent skip."""
    rows = []
    for row in artifact.get("strategies") or []:
        if not isinstance(row, dict):
            continue
        label = str(row.get("strategy", "?"))
        if row.get("overlap"):
            label += "+overlap"
        phases_s = row.get("overhead_phases")
        if not isinstance(phases_s, dict):
            rows.append({"program": label, "window_s": 0.0, "steps": 0,
                         "phases": {}, "attributed_s": 0.0,
                         "coverage": None, "worst_phase": None,
                         "worst_share": 0.0,
                         "note": "no overhead_phases stamp (artifact "
                                 "predates the dispatch probe)"})
            continue
        window_s = sum(float(phases_s.get(p) or 0.0)
                       for p in DISPATCH_COVERAGE_PHASES)
        cov = row.get("overhead_coverage")
        out = _overhead_row(
            label, phases_s, window_s=window_s,
            steps=int(row.get("overhead_probe_steps") or 0),
            coverage=(float(cov) if isinstance(cov, (int, float))
                      else None),
            overhead_share=row.get("overhead_share"))
        # bench computes worst over the O constituents only (the probe's
        # sync_wait is mostly the device computing, not overhead) —
        # prefer its stamp over the generic recomputation
        if row.get("overhead_worst_phase") in DISPATCH_PHASES:
            out["worst_phase"] = row["overhead_worst_phase"]
            if isinstance(row.get("overhead_worst_share"), (int, float)):
                out["worst_share"] = float(row["overhead_worst_share"])
        rows.append(out)
    return {"report": OVERHEAD_REPORT_TAG, "v": 1, "files": [path],
            "load_errors": [], "rows": rows}


def compare_overhead(new: dict, baseline: dict,
                     threshold: float = 1.5) -> dict:
    """The phase-SHARE regression gate (`trace report --overhead
    --baseline OLD`): one row per (program, phase) present in both
    reports. Every dispatch phase is overhead ROADMAP item 3 exists to
    shrink — better-smaller, so the ratio is new_share/old_share (the
    data/serve share-gate convention) and a regression is a ratio past
    `threshold`, UNLESS the new run's absolute phase total is
    sub-millisecond (`OVERHEAD_SUBMS_EXEMPT_S`: at that scale the
    numerator is scheduler noise). Returns the {"threshold", "rows",
    "regressions"} shape every other gate shares; cli/trace.py turns
    regressions into exit 3."""
    new_rows = {r["program"]: r for r in new.get("rows") or []
                if r.get("phases")}
    old_rows = {r["program"]: r for r in baseline.get("rows") or []
                if r.get("phases")}
    rows, regressions = [], []
    for program in sorted(set(new_rows) & set(old_rows)):
        np_, op = new_rows[program]["phases"], old_rows[program]["phases"]
        for phase in DISPATCH_PHASES:
            if phase not in np_ or phase not in op:
                continue
            old_v, new_v = op[phase]["share"], np_[phase]["share"]
            if old_v > 0:
                ratio = new_v / old_v
            else:
                ratio = math.inf if new_v > 0 else 1.0
            exempt = np_[phase]["total_s"] < OVERHEAD_SUBMS_EXEMPT_S
            row = {"program": program, "phase": phase,
                   "baseline_share": old_v, "new_share": new_v,
                   "ratio": ratio,
                   "regressed": ratio > threshold and not exempt}
            rows.append(row)
            if row["regressed"]:
                regressions.append(row)
    return {"threshold": threshold, "rows": rows,
            "regressions": regressions}


def format_overhead_report(report: dict) -> str:
    lines = [f"dispatch overhead report: {len(report['rows'])} program(s)"]
    for row in report["rows"]:
        if row.get("note"):
            lines.append(f"  {row['program']:<16} {row['note']}")
            continue
        cov = row.get("coverage")
        cov_txt = f"{cov:.0%}" if isinstance(cov, (int, float)) else "n/a"
        share_txt = ""
        if isinstance(row.get("overhead_share"), (int, float)):
            share_txt = f"  overhead_share={row['overhead_share']:.0%}"
        lines.append(f"  {row['program']:<16} window {row['window_s']:.4f}s"
                     f" over {row['steps']} step(s), coverage {cov_txt}"
                     f"{share_txt}")
        for phase in DISPATCH_PHASES:
            st = row["phases"].get(phase)
            if st:
                lines.append(f"    {phase:<16} {st['total_s']:>10.4f}s  "
                             f"{st['share']:>7.1%}")
        if row.get("worst_phase"):
            lines.append(f"    worst phase: {row['worst_phase']} "
                         f"({row['worst_share']:.1%} of window)")
    if not report["rows"]:
        lines.append("  (no dispatch records — not a --profile_dispatch "
                     "run or stamped artifact?)")
    return "\n".join(lines)


def format_compare_overhead(diff: dict) -> str:
    lines = [f"overhead baseline comparison (gate: share ratio > "
             f"{diff['threshold']:g}x):"]
    for row in diff["rows"]:
        verdict = "REGRESSION" if row["regressed"] else "ok"
        ratio = ("inf" if math.isinf(row["ratio"])
                 else f"{row['ratio']:.2f}x")
        lines.append(f"  {row['program']:<16} {row['phase']:<16} "
                     f"{row['baseline_share']:.1%} -> "
                     f"{row['new_share']:.1%}  ({ratio})  {verdict}")
    if not diff["rows"]:
        lines.append("  (no program/phase overlaps baseline — "
                     "nothing gated)")
    n = len(diff["regressions"])
    verdict = f"FAIL — {n} phase share(s) past threshold" if n else "PASS"
    lines.append(f"phase-share gate: {verdict}")
    return "\n".join(lines)


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
