"""Performance ledger: every artifact, one direction-aware history (port
of `pytorch_ddp_mnist_tpu/telemetry/ledger.py`; the rows, reports, gate
verdicts and markdown are the JAX package's for the same files, which
tests hold equal).

  * `ingest` loads every artifact generation (`detect_generation`: the
    driver-wrapped BENCH lines, bare stamped bench lines, MULTICHIP ok-bit
    smokes and `strategies` rows, COST / SERVE / INPUT reports,
    bench_matrix cells) into canonical rows: a series key (metric,
    variant, model, param_scale, n_devices, per_chip_batch, backend), a
    finite value, a declared direction, the run ordinal and the source.
    Legacy workloads normalise through analysis.normalize_workload. An
    unknown schema, a metric with no direction and a `schema_version`
    above SCHEMA_VERSION fail by name.
  * `trend` / `gate`: per series, the newest point against the median +
    MAD band of the last `window` runs, and consecutive-worse streaks.
  * `report` / `render_markdown`: the trajectory table.

The port's bench lines carry `schema_version` and `run_ord`
(bench.py `ledger_stamp_fields`) and read as the same generation here and
in the JAX ledger. Pure stdlib. Front door: `python -m
pytorch_ddp_mnist_tpu_torch ledger` (cli/ledger.py).
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Dict, List, Optional, Tuple

from .analysis import (LEDGER_DIRECTIONS, WORKLOAD_DEFAULTS,
                       normalize_workload)

HIGHER, LOWER = LEDGER_DIRECTIONS  # ("higher_better", "lower_better")

# Artifacts written from this round on stamp `schema_version`; absent means
# the artifact predates the ledger and is grandfathered as generation 1.
# Versions ABOVE this are someone else's future: refuse by name rather
# than guess at fields that may have changed meaning.
SCHEMA_VERSION = 2

# Default trend-gate knobs (cli/ledger.py exposes both as flags). The 1.5
# ratio matches the repo's pairwise step-time/efficiency gates; the window
# bounds how much history the band is computed over.
DEFAULT_THRESHOLD = 1.5
DEFAULT_WINDOW = 5
# The MAD band multiplier: a point must fall outside center +/- 3*MAD on
# the WORSE side (direction-aware) before the ratio test may fire, so a
# noisy-but-stable series doesn't gate on its own jitter. With a 1-point
# history MAD is 0 and the band collapses — the pairwise degenerate case.
MAD_BAND = 3.0

# Committed-artifact filename shapes. discover() matches exactly these —
# BASELINE.json and friends are prose-bearing configs, not metric
# artifacts, and must not trip the unknown-schema error.
ARTIFACT_GLOBS = ("BENCH_r*.json", "MULTICHIP_r*.json", "COST_r*.json",
                  "SERVE_r*.json", "INPUT_r*.json", "bench_matrix_r*.json")

_RUN_ORD_RE = re.compile(r"_r(\d+)\.json$")
_ACCURACY_RE = re.compile(r"^mnist_\d+epoch_test_accuracy$")

# -- the direction registry (docs/OBSERVABILITY.md §Performance ledger) --
# Every ledger metric declares which way is better ONCE, here. A bench.py
# line whose metric name is missing from these tables fails ingestion by
# name ("teach telemetry/ledger.py its direction") — a metric without a
# direction cannot be trend-gated and must not silently join the history.

# stdout bench-line metric -> (ledger metric, direction). Covers both the
# BENCH_r01 driver-wrapped `parsed` form and bare stamped lines.
BENCH_LINE_METRICS = {
    "mnist_train_images_per_sec_per_chip":
        ("bench.train_images_per_sec_per_chip", HIGHER),
    "mnist_ddp_train_images_per_sec_per_chip":
        ("bench.ddp_train_images_per_sec_per_chip", HIGHER),
    "mnist_eval_images_per_sec_per_chip":
        ("bench.eval_images_per_sec_per_chip", HIGHER),
    "mnist_serve_requests_per_sec": ("serve.requests_per_sec", HIGHER),
    "mnist_netcdf_stream_images_per_sec":
        ("input.netcdf_stream_images_per_sec", HIGHER),
    "mnist_input_pipeline_batches_per_sec":
        ("input.batches_per_sec", HIGHER),
}

# MULTICHIP `strategies` row field -> (ledger metric, direction). Only
# these fields are measurements; the rest of a row (strategy, overlap,
# n_params, overhead_phases, ...) is configuration or structure.
STRATEGY_ROW_METRICS = {
    "images_per_sec": ("ddp.images_per_sec", HIGHER),
    "per_chip_images_per_sec": ("ddp.per_chip_images_per_sec", HIGHER),
    "scaling_efficiency_vs_1dev":
        ("ddp.scaling_efficiency_vs_1dev", HIGHER),
    "bytes_on_wire_per_step_per_device":
        ("ddp.bytes_on_wire_per_step_per_device", LOWER),
    "collective_s_p50": ("ddp.collective_s_p50", LOWER),
    "parity_max_rel_diff_vs_pmean":
        ("ddp.parity_max_rel_diff_vs_pmean", LOWER),
    "parity_max_abs_diff_vs_pmean":
        ("ddp.parity_max_abs_diff_vs_pmean", LOWER),
    "analytic_efficiency": ("ddp.analytic_efficiency", HIGHER),
    "journal_overhead_share": ("ddp.journal_overhead_share", LOWER),
    "overhead_share": ("ddp.overhead_share", LOWER),
    "overhead_coverage": ("ddp.overhead_coverage", HIGHER),
    "overhead_worst_share": ("ddp.overhead_worst_share", LOWER),
}

# INPUT artifact legacy/pipeline sub-dict field -> (metric, direction).
INPUT_VARIANT_METRICS = {
    "batches_per_sec": ("input.batches_per_sec", HIGHER),
    "images_per_sec": ("input.images_per_sec", HIGHER),
    "data_wait_share_p50": ("input.data_wait_share_p50", LOWER),
    "data_wait_share_p95": ("input.data_wait_share_p95", LOWER),
}

# Serve-bench robustness companions: bench.py --mode serve stamps these
# ALONGSIDE the headline requests/sec line (PR 20); absent on pre-fleet
# artifacts, so old rounds contribute no rows and the pinned ingest
# counts hold. availability is the kept-promise fraction
# (completed/(completed+failed) over ADMITTED requests); retried_requests
# counts fleet failovers (lower is better — each one is a replica
# failure a request had to ride out); reloads counts hot checkpoint
# swaps served without downtime.
SERVE_ROBUSTNESS_METRICS = {
    "availability": ("serve.availability", HIGHER),
    "retried_requests": ("serve.retried_requests", LOWER),
    "reloads": ("serve.reloads", HIGHER),
}

# Fixed-name metrics the generation loaders emit directly.
FIXED_METRICS = {
    "multichip.ok": HIGHER,
    "bench.test_accuracy": HIGHER,
    "cost.compile_count": LOWER,
    "cost.compile_s_total": LOWER,
    "cost.peak_hbm_bytes": LOWER,
    "cost.analytic_efficiency": HIGHER,
    "serve.max_sustained_qps": HIGHER,
    "serve.p50_ms": LOWER,
    "serve.p99_ms": LOWER,
    "serve.reject_rate": LOWER,
    "serve.qps_gain": HIGHER,
    "input.xla_compiles": LOWER,
    "matrix.images_per_sec_per_chip": HIGHER,
}


def metric_directions() -> Dict[str, str]:
    """The full metric -> direction registry, one flat view (docs + the
    smoke's family-coverage assert read this)."""
    out = dict(FIXED_METRICS)
    for table in (BENCH_LINE_METRICS, STRATEGY_ROW_METRICS,
                  INPUT_VARIANT_METRICS, SERVE_ROBUSTNESS_METRICS):
        for name, direction in table.values():
            out[name] = direction
    return out


class LedgerError(Exception):
    """An artifact the ledger refuses to ingest — unknown schema, unknown
    future schema_version, or a metric without a registered direction.
    Always names the offending path/field: fail by name, never drop."""


def run_ordinal(doc: dict, path: str) -> int:
    """The run ordinal a row sorts under: an explicit `run_ord` stamp
    (schema v2+), the driver wrapper's `n`, or the `_rNN` filename
    convention — in that precedence order; 0 when nothing claims one."""
    for key in ("run_ord", "n"):
        v = doc.get(key)
        if isinstance(v, int) and not isinstance(v, bool):
            return v
    m = _RUN_ORD_RE.search(os.path.basename(path))
    return int(m.group(1)) if m else 0


def check_schema_version(doc: dict, path: str) -> int:
    """Grandfather version-absent artifacts as v1; refuse unknown FUTURE
    versions by name (a v3 artifact may have re-keyed its fields — better
    a loud error here than a silently wrong history)."""
    v = doc.get("schema_version")
    if v is None:
        return 1
    if isinstance(v, bool) or not isinstance(v, int):
        raise LedgerError(f"{path}: schema_version must be an int, got "
                          f"{v!r}")
    if v > SCHEMA_VERSION:
        raise LedgerError(
            f"{path}: schema_version {v} is newer than this ledger "
            f"understands (max {SCHEMA_VERSION}); update "
            f"telemetry/ledger.py before ingesting it")
    return v


def series_key(metric: str, variant: Optional[str], workload: dict,
               backend: Optional[str]) -> str:
    """One canonical, human-readable key per comparable series. Matching
    is STRICT: a row measured on an unknown backend (None) does not join
    a tpu-backend series — better two short honest series than one long
    lying one."""
    parts = [metric]
    if variant:
        parts.append(variant)
    parts.append(f"{workload['model']} x{workload['param_scale']}")
    if workload.get("n_devices") is not None:
        parts.append(f"{workload['n_devices']}dev")
    if workload.get("per_chip_batch") is not None:
        parts.append(f"b{workload['per_chip_batch']}")
    parts.append(backend if backend else "?")
    return "/".join(parts)


def _row(metric: str, direction: str, value: float, run_ord: int,
         source: str, workload: dict, backend: Optional[str],
         variant: Optional[str] = None,
         unit: Optional[str] = None) -> dict:
    if not (isinstance(value, (int, float)) and not isinstance(value, bool)
            and math.isfinite(value)):
        raise LedgerError(f"{source}: metric {metric!r} carries a "
                          f"non-finite value {value!r}")
    return {
        "series": series_key(metric, variant, workload, backend),
        "metric": metric, "variant": variant,
        "model": workload["model"],
        "param_scale": workload["param_scale"],
        "n_devices": workload.get("n_devices"),
        "per_chip_batch": workload.get("per_chip_batch"),
        "backend": backend, "value": float(value),
        "direction": direction, "run_ord": run_ord, "source": source,
        "unit": unit,
    }


def _bench_line_row(doc: dict, run_ord: int, source: str) -> dict:
    """One stdout bench line (bare, or the BENCH_rNN `parsed` payload)."""
    raw = doc.get("metric")
    if raw in BENCH_LINE_METRICS:
        metric, direction = BENCH_LINE_METRICS[raw]
    elif isinstance(raw, str) and _ACCURACY_RE.match(raw):
        metric, direction = "bench.test_accuracy", HIGHER
    else:
        raise LedgerError(
            f"{source}: bench metric {raw!r} has no registered direction; "
            f"teach telemetry/ledger.py (BENCH_LINE_METRICS) its direction "
            f"before it can join the history")
    return _row(metric, direction, doc.get("value"), run_ord, source,
                normalize_workload(doc), doc.get("backend"),
                unit=doc.get("unit"))


def _serve_robustness_rows(doc: dict, run_ord: int,
                           source: str) -> List[dict]:
    """Companion rows off a serve bench line (SERVE_ROBUSTNESS_METRICS):
    only the serve headline carries them, and only post-fleet artifacts
    stamp them — both absences are silent, not skips, so pre-fleet
    histories ingest unchanged."""
    if doc.get("metric") != "mnist_serve_requests_per_sec":
        return []
    wl = normalize_workload(doc)
    backend = doc.get("backend")
    rows = []
    for field, (metric, direction) in SERVE_ROBUSTNESS_METRICS.items():
        v = doc.get(field)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            rows.append(_row(metric, direction, v, run_ord, source,
                             wl, backend))
    return rows


# -- per-generation loaders: each returns (rows, skipped) ----------------

def _load_bench_line(doc: dict, run_ord: int,
                     source: str) -> Tuple[List[dict], List[dict]]:
    """A bare stamped stdout line. A null value with a recorded `error`
    (bench.py's _emit_backend_error shape) is a SKIP, same rule as the
    driver-wrapped failures."""
    if doc.get("value") is None:
        return [], [{"source": source, "reason":
                     doc.get("error") or "null value"}]
    return ([_bench_line_row(doc, run_ord, source)]
            + _serve_robustness_rows(doc, run_ord, source)), []


def _load_bench_wrapped(doc: dict, run_ord: int,
                        source: str) -> Tuple[List[dict], List[dict]]:
    """BENCH_rNN.json: the driver wrapper {n, cmd, rc, tail, parsed}.
    A failed round (parsed null / value null) is a SKIP with its recorded
    reason, not a zero — a backend that never ran is not a regression."""
    parsed = doc.get("parsed")
    if not isinstance(parsed, dict) or not isinstance(
            parsed.get("value"), (int, float)):
        reason = (parsed or {}).get("error") if isinstance(parsed, dict) \
            else None
        return [], [{"source": source, "reason":
                     reason or f"no parsed metric (rc={doc.get('rc')})"}]
    merged = dict(doc)
    merged.update(parsed)
    return ([_bench_line_row(merged, run_ord, source)]
            + _serve_robustness_rows(merged, run_ord, source)), []


def _load_multichip(doc: dict, run_ord: int,
                    source: str) -> Tuple[List[dict], List[dict]]:
    """MULTICHIP_rNN.json — both generations. Every one carries the ok
    bit (the 8-round health series); r06+ adds `strategies` rows. The ok
    bit is a HEALTH metric, not a workload measurement, so its series
    pins the default workload (splitting mnist-smoke ok from mlp-x8 ok
    would hide exactly the flakiness the series exists to show)."""
    backend = doc.get("backend")
    rows: List[dict] = []
    skipped: List[dict] = []
    if isinstance(doc.get("ok"), bool):
        wl = dict(WORKLOAD_DEFAULTS, n_devices=None, per_chip_batch=None)
        ndev = doc.get("n_devices")
        if isinstance(ndev, int) and not isinstance(ndev, bool):
            wl["n_devices"] = ndev
        rows.append(_row("multichip.ok", HIGHER,
                         1.0 if doc["ok"] else 0.0, run_ord, source, wl,
                         backend))
    for srow in doc.get("strategies") or []:
        if not isinstance(srow, dict):
            continue
        variant = str(srow.get("strategy", "?"))
        if srow.get("overlap"):
            variant += "+overlap"
        wl = normalize_workload(srow, doc)
        for field, (metric, direction) in STRATEGY_ROW_METRICS.items():
            v = srow.get(field)
            if v is None:
                continue
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                skipped.append({"source": source, "reason":
                                f"{variant}.{field} non-numeric: {v!r}"})
                continue
            rows.append(_row(metric, direction, v, run_ord, source, wl,
                             backend, variant=variant))
    return rows, skipped


def _load_cost(doc: dict, run_ord: int,
               source: str) -> Tuple[List[dict], List[dict]]:
    """COST_rNN.json (telemetry/costs.py `program_cost_report`): the
    compile/HBM budget summary plus per-program analytic efficiency."""
    wl = normalize_workload(
        {"per_chip_batch": doc.get("batch_per_device")}, doc)
    backend = doc.get("backend")
    summary = doc.get("summary") or {}
    rows: List[dict] = []
    for field, metric in (("compile_count", "cost.compile_count"),
                          ("compile_s_total", "cost.compile_s_total"),
                          ("peak_hbm_bytes", "cost.peak_hbm_bytes")):
        v = summary.get(field)
        if v is not None:
            rows.append(_row(metric, FIXED_METRICS[metric], v, run_ord,
                             source, wl, backend))
    for program, eff in sorted(
            (summary.get("analytic_efficiency") or {}).items()):
        rows.append(_row("cost.analytic_efficiency",
                         FIXED_METRICS["cost.analytic_efficiency"], eff,
                         run_ord, source, wl, backend, variant=program))
    return rows, []


def _load_serve(doc: dict, run_ord: int,
                source: str) -> Tuple[List[dict], List[dict]]:
    """SERVE_rNN.json (`serve_fast_path_before_after`): per path, the max
    SUSTAINED throughput point and its latency/reject shape — the knee of
    the curve is the only point worth trending."""
    backend = (doc.get("host") or {}).get("platform")
    wl = normalize_workload({}, doc)
    rows: List[dict] = []
    skipped: List[dict] = []
    for side in ("before", "after"):
        sweep = doc.get(side) or {}
        variant = str(sweep.get("path") or side)
        best = None
        for pt in sweep.get("points") or []:
            if isinstance(pt, dict) and pt.get("sustained") \
                    and isinstance(pt.get("value"), (int, float)):
                if best is None or pt["value"] > best["value"]:
                    best = pt
        if best is None:
            skipped.append({"source": source, "reason":
                            f"{variant}: no sustained point"})
            continue
        rows.append(_row("serve.max_sustained_qps", HIGHER, best["value"],
                         run_ord, source, wl, backend, variant=variant))
        for field, metric in (("p50_ms", "serve.p50_ms"),
                              ("p99_ms", "serve.p99_ms"),
                              ("reject_rate", "serve.reject_rate")):
            v = best.get(field)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                rows.append(_row(metric, FIXED_METRICS[metric], v,
                                 run_ord, source, wl, backend,
                                 variant=variant))
    gain = doc.get("qps_gain")
    if isinstance(gain, (int, float)) and not isinstance(gain, bool):
        rows.append(_row("serve.qps_gain", HIGHER, gain, run_ord, source,
                         wl, backend))
    return rows, skipped


def _load_input(doc: dict, run_ord: int,
                source: str) -> Tuple[List[dict], List[dict]]:
    """INPUT_rNN.json: the headline batches/sec line plus the paired
    legacy/pipeline variants (data-wait share is the ROADMAP item-3
    trajectory) and the compile count."""
    backend = doc.get("backend")
    wl = normalize_workload({}, doc)
    rows = [_bench_line_row(doc, run_ord, source)]
    for variant in ("legacy", "pipeline"):
        sub = doc.get(variant) or {}
        for field, (metric, direction) in INPUT_VARIANT_METRICS.items():
            v = sub.get(field)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                rows.append(_row(metric, direction, v, run_ord, source,
                                 wl, backend, variant=variant))
    compiles = doc.get("xla_compiles")
    if isinstance(compiles, (int, float)) and not isinstance(
            compiles, bool):
        rows.append(_row("input.xla_compiles",
                         FIXED_METRICS["input.xla_compiles"], compiles,
                         run_ord, source, wl, backend))
    return rows, []


def _load_bench_matrix(doc: dict, run_ord: int,
                       source: str) -> Tuple[List[dict], List[dict]]:
    """bench_matrix_rNN.json: one series per variant label. A null value
    (backend probe failed) is a SKIP with the artifact's recorded reason.
    Backend matching stays strict: r05's backend-null cells do NOT join
    r03's tpu series — an unprobed backend is not a measurement of it."""
    backend = doc.get("backend")
    wl = normalize_workload({}, doc)
    rows: List[dict] = []
    skipped: List[dict] = []
    for variant in doc.get("variants") or []:
        if not isinstance(variant, dict):
            continue
        label = str(variant.get("label", "?"))
        v = variant.get("value")
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            skipped.append({"source": source, "reason":
                            f"{label}: no value "
                            f"({doc.get('backend_probe_error') or 'null'})"
                            })
            continue
        rows.append(_row("matrix.images_per_sec_per_chip", HIGHER, v,
                         run_ord, source, wl, backend, variant=label,
                         unit=variant.get("unit")))
    return rows, skipped


def detect_generation(doc: dict, path: str) -> str:
    """Name the artifact generation, or refuse by name. Order matters:
    INPUT artifacts carry a bare `metric` too, so their legacy/pipeline
    pair is tested first."""
    if not isinstance(doc, dict):
        raise LedgerError(f"{path}: artifact is not a JSON object")
    if doc.get("report") == "program_cost_report":
        return "cost_report"
    if doc.get("artifact") == "serve_fast_path_before_after":
        return "serve_before_after"
    if isinstance(doc.get("legacy"), dict) \
            and isinstance(doc.get("pipeline"), dict):
        return "input_pipeline"
    if isinstance(doc.get("variants"), list) and "timestamp" in doc:
        return "bench_matrix"
    if isinstance(doc.get("strategies"), list):
        return "multichip_strategies"
    if "parsed" in doc and "rc" in doc:
        return "bench_wrapped"
    if "n_devices" in doc and "ok" in doc and "rc" in doc:
        return "multichip_legacy"
    if "metric" in doc and "value" in doc:
        return "bench_line"
    raise LedgerError(
        f"{path}: unrecognized artifact schema (keys: "
        f"{sorted(doc)[:12]}); teach telemetry/ledger.py its generation "
        f"— the ledger never silently drops an artifact")


_LOADERS = {
    "bench_wrapped": _load_bench_wrapped,
    "bench_line": _load_bench_line,
    "multichip_legacy": _load_multichip,
    "multichip_strategies": _load_multichip,
    "cost_report": _load_cost,
    "serve_before_after": _load_serve,
    "input_pipeline": _load_input,
    "bench_matrix": _load_bench_matrix,
}


def load_artifact(path: str) -> Tuple[List[dict], List[dict]]:
    """(rows, skipped) for ONE artifact file."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        raise LedgerError(f"{path}: unreadable artifact: {e}")
    check_schema_version(doc if isinstance(doc, dict) else {}, path)
    generation = detect_generation(doc, path)
    source = os.path.basename(path)
    return _LOADERS[generation](doc, run_ordinal(doc, path), source)


def discover(root: str) -> List[str]:
    """Every committed-artifact path under `root`, sorted by name."""
    paths: List[str] = []
    for pattern in ARTIFACT_GLOBS:
        rx = re.compile("^" + re.escape(pattern).replace(r"\*", ".*")
                        + "$")
        for name in os.listdir(root):
            if rx.match(name):
                paths.append(os.path.join(root, name))
    return sorted(paths)


def ingest(paths: List[str]) -> dict:
    """All rows from `paths`, sorted into series order."""
    rows: List[dict] = []
    skipped: List[dict] = []
    for path in paths:
        r, s = load_artifact(path)
        rows.extend(r)
        skipped.extend(s)
    rows.sort(key=lambda r: (r["series"], r["run_ord"], r["source"]))
    return {"rows": rows, "skipped": skipped, "artifacts": len(paths)}


def histories(rows: List[dict]) -> Dict[str, List[dict]]:
    """series key -> rows sorted by (run_ord, source)."""
    out: Dict[str, List[dict]] = {}
    for row in rows:
        out.setdefault(row["series"], []).append(row)
    for series in out.values():
        series.sort(key=lambda r: (r["run_ord"], r["source"]))
    return out


def _median(values: List[float]) -> float:
    s = sorted(values)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def _worse_ratio(newest: float, center: float, direction: str) -> float:
    """How many times WORSE the newest point is than the center, >= 1.0
    when it regressed, < 1.0 when it improved. A positive history that
    collapses to <= 0 is infinitely worse (the pairwise gates' rule)."""
    if direction == HIGHER:
        num, den = center, newest
    else:
        num, den = newest, center
    if den <= 0:
        return math.inf if num > 0 else 1.0
    if num <= 0:
        return 0.0
    return num / den


def trend(history: List[dict], window: int = DEFAULT_WINDOW,
          threshold: float = DEFAULT_THRESHOLD) -> dict:
    """Robust trend stats for ONE series (rows already run-ordered).

    The newest point is judged against the median of the last `window`
    PRIOR points; the MAD band only ever widens tolerance (a move inside
    center +/- MAD_BAND*MAD is jitter, never a regression). With one
    prior point MAD is 0 and this degenerates to the repo's existing
    pairwise ratio gates.
    """
    values = [r["value"] for r in history]
    direction = history[-1]["direction"]
    newest = values[-1]
    prior = values[:-1][-window:]
    best = max(values) if direction == HIGHER else min(values)
    worse_than = (lambda a, b: a < b) if direction == HIGHER \
        else (lambda a, b: a > b)
    streak = 0
    for i in range(len(values) - 1, 0, -1):
        if worse_than(values[i], values[i - 1]):
            streak += 1
        else:
            break
    stats = {
        "series": history[-1]["series"], "metric": history[-1]["metric"],
        "direction": direction, "n": len(values),
        "first": values[0], "latest": newest, "best": best,
        "vs_best_pct": ((newest - best) / abs(best) * 100.0)
        if best else 0.0,
        "streak": streak, "unit": history[-1]["unit"],
        "runs": [r["run_ord"] for r in history],
        "sources": [r["source"] for r in history],
        "regressed": False, "ratio": None, "center": None, "mad": None,
    }
    if not prior:
        return stats
    center = _median(prior)
    mad = _median([abs(v - center) for v in prior])
    ratio = _worse_ratio(newest, center, direction)
    band = MAD_BAND * mad
    outside_band = (newest < center - band) if direction == HIGHER \
        else (newest > center + band)
    stats.update(center=center, mad=mad, ratio=ratio,
                 regressed=bool(ratio > threshold and outside_band))
    return stats


def report(rows: List[dict], window: int = DEFAULT_WINDOW,
           threshold: float = DEFAULT_THRESHOLD) -> dict:
    """The full trajectory report: one trend entry per series."""
    series = [trend(h, window=window, threshold=threshold)
              for h in histories(rows).values()]
    series.sort(key=lambda s: s["series"])
    return {
        "report": "performance_ledger", "v": 1,
        "schema_version": SCHEMA_VERSION,
        "series": series,
        "n_series": len(series),
        "n_rows": len(rows),
        "families": sorted({s["metric"].split(".", 1)[0]
                            for s in series}),
        "regressions": [s for s in series if s["regressed"]],
    }


def gate(rows: List[dict], window: int = DEFAULT_WINDOW,
         threshold: float = DEFAULT_THRESHOLD) -> dict:
    """The trend gate: report plus the exit-3 verdict. Regressions name
    the series AND the offending run/source — a gate that can't say which
    run went bad is a gate nobody acts on."""
    rep = report(rows, window=window, threshold=threshold)
    failures = []
    for s in rep["regressions"]:
        failures.append(
            f"{s['series']}: run r{s['runs'][-1]:02d} "
            f"({s['sources'][-1]}) is {s['ratio']:.2f}x worse than the "
            f"last-{min(window, s['n'] - 1)}-run median "
            f"{s['center']:.6g} ({s['direction']}, latest "
            f"{s['latest']:.6g}, threshold {threshold:g})")
    rep["failures"] = failures
    rep["ok"] = not failures
    return rep


def _fmt(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if isinstance(v, float) and (abs(v) >= 1e6 or
                                 (v != 0 and abs(v) < 1e-3)):
        return f"{v:.4g}"
    return f"{v:g}"


def render_markdown(rep: dict) -> str:
    """The trajectory table docs/PERF.md embeds instead of hand-edited
    before/after tables."""
    lines = ["| series | n | first | latest | best | vs best | streak |",
             "|---|---|---|---|---|---|---|"]
    for s in rep["series"]:
        arrow = "+" if s["vs_best_pct"] >= 0 else ""
        lines.append(
            f"| {s['series']} | {s['n']} | {_fmt(s['first'])} "
            f"| {_fmt(s['latest'])} | {_fmt(s['best'])} "
            f"| {arrow}{s['vs_best_pct']:.1f}% | {s['streak']} |")
    lines.append("")
    lines.append(f"{rep['n_series']} series / {rep['n_rows']} rows across "
                 f"{len(rep['families'])} families: "
                 f"{', '.join(rep['families'])}.")
    return "\n".join(lines)
