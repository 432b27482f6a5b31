"""Trace export: schema-v1 JSONL -> Chrome trace-event JSON (Perfetto /
`chrome://tracing` loadable), plus the op-level profiler hook (port of
`pytorch_ddp_mnist_tpu/telemetry/export.py`; the event lists are the JAX
package's for the same files, which tests hold equal).

  * one track (pid) per process index, named in metadata events;
  * live spans become complete `X` events at their true start stamps;
    aggregate spans (per-epoch data_wait / step_compute totals) land on a
    separate `aggregates` thread;
  * `point` records become instant `i` events, except `mem_watermark`
    (counter tracks) and `dispatch_phase` totals (--profile_dispatch
    runs), which render as slices on paired `host dispatch` / `device
    idle` lanes;
  * registry `snapshot` records become counter `C` tracks;
  * per-rank collective journals (--journal runs) add a `collectives`
    track a rank and seq-aligned cross-rank flow arrows (at most
    COLLECTIVE_ARROW_CAP);
  * performance-ledger histories add one counter track a series on
    their own pid;
  * processes are aligned on WALL clock through each segment's
    mono->wall offset (analysis.clock_offset).

Timestamps are microseconds from the earliest aligned event.

`profiler_trace` is the op-level hatch: a `torch.profiler` session over a
block (utils/profiling.py `trace`, the one profiler wrapper of the port),
written as a Chrome trace. Everything else is pure stdlib.
"""

from __future__ import annotations

import contextlib
import json
from typing import List, Optional

from .analysis import (DISPATCH_PHASE_POINT, DISPATCH_PHASES,
                       SERVE_BATCH_SPAN, SERVE_BATCH_STAGE_ORDER,
                       SERVE_REQUEST_SPAN, clock_offset, load_traces,
                       split_segments, _span_interval)

# Thread ids within each process track: the real span timeline, the
# per-epoch aggregate durations, and instants/counters ride on spans' tid.
# Serve traces add two more: concurrent request spans (which overlap
# without nesting — they would render as a garbled stack on the spans
# thread) and the batch pipeline, connected by flow arrows so clicking a
# request walks to the batch that carried it. Collective journals
# (--journal runs, telemetry/cluster.py) add a per-rank collectives
# track, with seq-aligned flow arrows binding the SAME collective across
# ranks — straggler skew renders as visible arrow slant.
_TID_SPANS = 0
_TID_AGGREGATES = 1
_TID_REQUESTS = 2
_TID_BATCHES = 3
_TID_COLLECTIVES = 4
# Dispatch forensics (--profile_dispatch runs): the per-epoch
# dispatch_phase points render as slices on a HOST lane (python_prestep /
# dispatch / sync_wait) and a DEVICE lane (device_idle) so the idle gaps
# are visible as slices against the host work that causes them.
_TID_HOST_LANE = 5
_TID_DEVICE_LANE = 6
_SERVE_BATCH_TRACK = (SERVE_BATCH_SPAN,) + SERVE_BATCH_STAGE_ORDER
# seq-aligned cross-rank arrows are capped (a long run journals thousands
# of collectives; Perfetto renders arrows per flow id, and the first few
# hundred seqs carry the alignment story) — the cap is stamped into
# otherData so a truncated arrow set never reads as complete
COLLECTIVE_ARROW_CAP = 512
# The performance-ledger track (`trace export --ledger DIR`): one counter
# per series, on its own pid so the repo's MULTI-RUN history renders as a
# scrubbable timeline besides (not inside) any single run's trace. Run
# ordinals are not wall stamps — each run renders one second apart.
LEDGER_PID = 999
LEDGER_RUN_SPACING_S = 1.0


def _scale_us(seconds: float) -> float:
    return round(seconds * 1e6, 3)


def _journal_slices(journal_paths: List[str]) -> List[tuple]:
    """Per-rank collective journal records as (start_wall_s, rank, rec)
    triples — wall stamps are comparable across ranks directly (each
    record carries t_wall at its enter), so they join the events' aligned
    timeline without an offset computation. Open entries (enter, no exit)
    render as zero-duration slices marked open=True — a stuck collective
    is visible as the track's abrupt end."""
    from .cluster import load_journal
    out = []
    for path in journal_paths:
        j = load_journal(path)
        rank = j["rank"]
        for rec in j["records"]:
            # t_wall is the window's ENTER wall stamp (the writer's
            # contract), directly comparable across ranks
            t_wall = rec.get("t_wall")
            if not isinstance(t_wall, (int, float)):
                continue
            out.append((float(t_wall), rank, rec))
        for e in j["open"]:
            t_wall = e.get("t_wall")
            if not isinstance(t_wall, (int, float)):
                continue
            rec = {"seq": e["seq"], "k": e["kind"], "t_wall": t_wall,
                   "t_enter": e.get("t_enter"),
                   "t_exit": e.get("t_enter"), "open": True}
            out.append((float(t_wall), rank, rec))
    return out


def _ledger_events(ledger_series: dict) -> List[dict]:
    """One Perfetto counter track per ledger series (`ledger.histories`
    shape: series key -> run-ordered rows). Successive runs render
    LEDGER_RUN_SPACING_S apart — the x axis is run order, not wall time —
    so scrubbing the ledger pid walks the whole committed history."""
    events: List[dict] = []
    if not ledger_series:
        return events
    events.append({"ph": "M", "name": "process_name", "pid": LEDGER_PID,
                   "tid": _TID_SPANS,
                   "args": {"name": "performance ledger"}})
    events.append({"ph": "M", "name": "thread_name", "pid": LEDGER_PID,
                   "tid": _TID_SPANS, "args": {"name": "ledger series"}})
    for series in sorted(ledger_series):
        for i, row in enumerate(ledger_series[series]):
            events.append({
                "ph": "C", "name": series, "cat": "ledger",
                "ts": _scale_us(i * LEDGER_RUN_SPACING_S),
                "pid": LEDGER_PID, "tid": _TID_SPANS,
                "args": {"value": row["value"]},
            })
    return events


def chrome_trace(paths: List[str],
                 journal_paths: Optional[List[str]] = None,
                 ledger_series: Optional[dict] = None) -> dict:
    """Merge per-process JSONL trace files into one Chrome trace-event
    object: `{"traceEvents": [...], "displayTimeUnit": "ms"}`.
    `journal_paths` (per-rank collective journals from a --journal run)
    add one `collectives` track per rank plus seq-aligned cross-rank flow
    arrows; `ledger_series` (ledger.histories) adds the multi-run
    performance-ledger counter tracks on their own pid."""
    records, _errors = load_traces(paths)
    by_file: dict = {}
    for rec in records:
        by_file.setdefault(rec["_file"], []).append(rec)

    # Pass 1: per-stream wall alignment and the global origin. Offsets are
    # per SEGMENT (the monotonic clock resets across the re-exec that
    # starts an appended segment — a file-wide median would throw one
    # segment's events off by the whole outage gap). A span's visible
    # start is its t0 stamp when live, else emission minus duration (an
    # aggregate's duration accumulated up to its emission point).
    aligned = []  # (start_wall_s, rec)
    for recs in by_file.values():
        for seg in split_segments(recs):
            off = clock_offset(seg)
            for rec in seg:
                kind = rec.get("kind")
                t_mono = rec.get("t_mono")
                has_mono = isinstance(t_mono, (int, float))
                if kind == "span":
                    iv = _span_interval(rec)
                    if iv is not None:
                        start = iv[0] + off
                    else:
                        dur = rec.get("dur_s")
                        if not (isinstance(dur, (int, float)) and has_mono):
                            continue  # torn/foreign record: skip, not crash
                        start = float(t_mono) - float(dur) + off
                elif kind in ("point", "snapshot") and has_mono:
                    start = float(t_mono) + off
                else:  # meta records / stamp-less records: no timeline
                    continue
                aligned.append((start, rec))
    jslices = _journal_slices(journal_paths or [])
    lev = _ledger_events(ledger_series or {})
    if not aligned and not jslices:
        # a ledger-only export is a valid timeline (the committed-artifact
        # history exists independently of any single run's events files)
        out = {"traceEvents": lev, "displayTimeUnit": "ms"}
        if lev:
            out["otherData"] = {
                "source": "pytorch_ddp_mnist_tpu_torch telemetry schema v1",
                "ledger_series": len(ledger_series or {})}
        return out
    t_base = min([start for start, _rec in aligned]
                 + [start for start, _r, _rec in jslices])

    # serve flow arrows (request -> the batch that carried it) need the
    # batch slice's position BEFORE the request slices render: one pass
    # over the aligned records maps batch_id -> (pid, ts).
    batch_pos = {}
    for start, rec in aligned:
        if (rec.get("kind") == "span"
                and rec.get("name") == SERVE_BATCH_SPAN):
            bid = (rec.get("attrs") or {}).get("batch_id")
            if isinstance(bid, str) and bid:
                batch_pos[bid] = (int(rec.get("proc", 0)),
                                  _scale_us(start - t_base))

    events: List[dict] = []
    named_pids = set()
    dispatch_lanes_named = set()  # pids with host/device lane names out
    flow_seq = 0
    for start, rec in sorted(aligned, key=lambda it: it[0]):
        pid = int(rec.get("proc", 0))
        if pid not in named_pids:
            named_pids.add(pid)
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": _TID_SPANS,
                           "args": {"name": f"process {pid}"}})
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": _TID_SPANS, "args": {"name": "spans"}})
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": _TID_AGGREGATES,
                           "args": {"name": "aggregates"}})
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": _TID_REQUESTS,
                           "args": {"name": "serve requests"}})
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": _TID_BATCHES,
                           "args": {"name": "serve batches"}})
        ts = _scale_us(start - t_base)
        kind = rec.get("kind")
        if kind == "span":
            live = _span_interval(rec) is not None
            attrs = {k: v for k, v in (rec.get("attrs") or {}).items()
                     if k not in ("t0_mono", "t0_wall")}
            name = rec.get("name", "span")
            if name == SERVE_REQUEST_SPAN:
                tid = _TID_REQUESTS
            elif name in _SERVE_BATCH_TRACK:
                tid = _TID_BATCHES
            else:
                tid = _TID_SPANS if live else _TID_AGGREGATES
            events.append({
                "ph": "X", "name": name,
                "cat": "span" if live else "aggregate",
                "ts": ts, "dur": _scale_us(float(rec["dur_s"])),
                "pid": pid,
                "tid": tid,
                "args": attrs,
            })
            link = attrs.get("batch")
            if (name == SERVE_REQUEST_SPAN and isinstance(link, str)
                    and link in batch_pos):
                # one flow arrow per request: starts inside the request
                # slice, lands at the batch slice's start — Perfetto
                # renders the N-requests-into-one-batch coalescing
                bpid, bts = batch_pos[link]
                flow_seq += 1
                flow = {"cat": "serve_flow", "name": "batch",
                        "id": flow_seq}
                events.append({"ph": "s", "ts": ts, "pid": pid,
                               "tid": _TID_REQUESTS, **flow})
                events.append({"ph": "f", "bp": "e", "ts": bts,
                               "pid": bpid, "tid": _TID_BATCHES, **flow})
        elif kind == "point":
            name = rec.get("name", "point")
            if name == "mem_watermark":
                # HBM/RSS watermark samples (telemetry/runtime.py
                # record_memory_point, emitted per epoch by the train
                # loop): render each numeric field as its own counter
                # track beside the registry counters, so Perfetto shows
                # the memory envelope under the epoch spans instead of an
                # instant blip
                for metric, value in sorted(
                        (rec.get("attrs") or {}).items()):
                    if isinstance(value, (int, float)) \
                            and not isinstance(value, bool):
                        events.append({"ph": "C", "name": metric,
                                       "cat": "mem", "ts": ts, "pid": pid,
                                       "tid": _TID_SPANS,
                                       "args": {"value": value}})
                continue
            if name == DISPATCH_PHASE_POINT:
                # per-epoch phase totals (telemetry/dispatch.py flush):
                # render as slices ending at their emission point (the
                # aggregates idiom) — host phases on the host lane, the
                # sampled device_idle total on its own device lane, so
                # Perfetto shows the idle gap AGAINST the host work that
                # causes it
                attrs = rec.get("attrs") or {}
                phase, total = attrs.get("phase"), attrs.get("total_s")
                if phase in DISPATCH_PHASES \
                        and isinstance(total, (int, float)):
                    if pid not in dispatch_lanes_named:
                        dispatch_lanes_named.add(pid)
                        events.append({"ph": "M", "name": "thread_name",
                                       "pid": pid, "tid": _TID_HOST_LANE,
                                       "args": {"name": "host dispatch"}})
                        events.append({"ph": "M", "name": "thread_name",
                                       "pid": pid, "tid": _TID_DEVICE_LANE,
                                       "args": {"name": "device idle"}})
                    tid = (_TID_DEVICE_LANE if phase == "device_idle"
                           else _TID_HOST_LANE)
                    events.append({
                        "ph": "X", "name": str(phase), "cat": "dispatch",
                        "ts": _scale_us(start - float(total) - t_base),
                        "dur": _scale_us(float(total)),
                        "pid": pid, "tid": tid, "args": attrs,
                    })
                    continue
            events.append({"ph": "i", "name": name,
                           "cat": "point", "ts": ts, "pid": pid,
                           "tid": _TID_SPANS, "s": "t",
                           "args": rec.get("attrs") or {}})
        elif kind == "snapshot":
            snap = rec.get("attrs") or {}
            for table in ("counters", "gauges"):
                for metric, value in sorted((snap.get(table) or {}).items()):
                    if isinstance(value, (int, float)):
                        events.append({"ph": "C", "name": metric,
                                       "cat": "registry", "ts": ts,
                                       "pid": pid, "tid": _TID_SPANS,
                                       "args": {"value": value}})
    # -- per-rank collective tracks + seq-aligned cross-rank arrows ------
    arrows_capped = False
    if jslices:
        by_seq: dict = {}   # seq -> [(rank, ts_us)]
        for start, rank, rec in sorted(jslices, key=lambda it: it[0]):
            pid = int(rank)
            if pid not in named_pids:
                named_pids.add(pid)
                events.append({"ph": "M", "name": "process_name",
                               "pid": pid, "tid": _TID_SPANS,
                               "args": {"name": f"process {pid}"}})
            ts = _scale_us(start - t_base)
            t_enter, t_exit = rec.get("t_enter"), rec.get("t_exit")
            dur = (max(float(t_exit) - float(t_enter), 0.0)
                   if isinstance(t_enter, (int, float))
                   and isinstance(t_exit, (int, float)) else 0.0)
            seq = rec.get("seq")
            args = {"seq": seq, "bytes": rec.get("bytes"),
                    "bucket": rec.get("bucket"), "step": rec.get("step")}
            if rec.get("open"):
                args["open"] = True
            events.append({
                "ph": "X", "name": str(rec.get("k", "coll")),
                "cat": "collective", "ts": ts, "dur": _scale_us(dur),
                "pid": pid, "tid": _TID_COLLECTIVES,
                "args": {k: v for k, v in args.items() if v is not None},
            })
            if isinstance(seq, int):
                by_seq.setdefault(seq, []).append((pid, ts))
        for pid in sorted({int(r) for _s, r, _rec in jslices}):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": _TID_COLLECTIVES,
                           "args": {"name": "collectives"}})
        # one flow per seq present on >= 2 ranks: the arrow binds the SAME
        # collective across ranks, so straggler skew renders as slant
        arrow_seqs = sorted(s for s, where in by_seq.items()
                            if len(where) >= 2)
        arrows_capped = len(arrow_seqs) > COLLECTIVE_ARROW_CAP
        for seq in arrow_seqs[:COLLECTIVE_ARROW_CAP]:
            where = sorted(by_seq[seq])
            flow_seq += 1
            flow = {"cat": "collective_flow", "name": f"seq {seq}",
                    "id": flow_seq}
            pid0, ts0 = where[0]
            events.append({"ph": "s", "ts": ts0, "pid": pid0,
                           "tid": _TID_COLLECTIVES, **flow})
            for pid_n, ts_n in where[1:]:
                events.append({"ph": "f", "bp": "e", "ts": ts_n,
                               "pid": pid_n, "tid": _TID_COLLECTIVES,
                               **flow})
    events.extend(lev)
    other = {"source": "pytorch_ddp_mnist_tpu_torch telemetry schema v1",
             "files": sorted(by_file)}
    if journal_paths:
        other["journals"] = sorted(journal_paths)
        if arrows_capped:
            other["collective_arrow_cap"] = COLLECTIVE_ARROW_CAP
    if ledger_series:
        other["ledger_series"] = len(ledger_series)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}


def write_chrome_trace(paths: List[str], out_path: str,
                       journal_paths: Optional[List[str]] = None,
                       ledger_series: Optional[dict] = None) -> int:
    """Render `paths` (+ optional per-rank collective journals + optional
    performance-ledger histories) and write the trace-event JSON to
    `out_path`; returns the event count."""
    trace = chrome_trace(paths, journal_paths=journal_paths,
                         ledger_series=ledger_series)
    with open(out_path, "w") as f:
        json.dump(trace, f)
        f.write("\n")
    return len(trace["traceEvents"])


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """Op-level capture: a `torch.profiler` session over the block, its
    Chrome trace written under `logdir` (a no-op when logdir is falsy).
    Delegates to `utils.profiling.trace`, re-exported here so the
    telemetry package is the one front door from phase stats down to
    kernel timelines; `cli/train.py --profile` enters through the same
    wrapper."""
    from ..utils.profiling import trace
    with trace(logdir):
        yield
