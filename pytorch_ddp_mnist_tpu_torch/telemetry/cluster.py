"""Cluster forensics: the per-rank collective journal, cross-rank desync
detection, straggler attribution, and hang forensics (the port of
`pytorch_ddp_mnist_tpu/telemetry/cluster.py`; its record kinds, fields,
file names and metric names are the JAX module's, so the JAX read side
reads a port journal as it is).

  * every payload collective the step issues gets one journal record
    `(seq, kind, axis, bytes, bucket, step, t_enter, t_exit)`. The STATIC
    half (kinds, counts, bytes, buckets) comes from
    `parallel.collectives.collective_schedule`, the JAX package's schedule
    entry for entry. The DYNAMIC half is host-side stamps: the step's
    collectives share the step's host window (the host cannot subdivide
    it without a sync), while host-BLOCKING collectives (the wireup
    barrier, the reduce_max, the end-of-epoch flush that fetches every
    step's losses) are bracketed with enter/exit records: they are where
    a hang shows to the host. The byte counts are the schedule's
    ring-model bytes; what the port's all-gathers actually move is the
    `ddp.bytes_moved` counter (parallel/ddp.py), not the journal;
  * seq numbering is the same on every rank by construction (same step,
    same schedule, and the journal opens with a cross-rank startup
    barrier at seq 0), so the merged journals form one timeline: desync
    detection (another kind/bytes/bucket at the same seq, or cleanly
    closed journals ending at other positions), per-collective straggler
    attribution (wall-aligned enter spread per rank pair), and hang
    forensics (an enter with no exit is an open collective; the report
    renders every rank's last journal position);
  * `CollectiveWatchdog` is the live half: a daemon thread that fires
    when an open entry ages past its timeout: the who-is-where table to
    the flight recorder, the ring dumped, `/healthz` flipped to 503.

`get_journal()` returns the shared `NullJournal` until `enable_journal()`
swaps in a real one, so the wireup's barrier brackets cost one attribute
check when journaling is off, and the journal never touches the device
(host clock reads and one JSONL line a collective): journaled training is
bitwise unjournaled training.

Pure stdlib at import (registry and flight only).
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import flight
from .registry import MetricsRegistry, get_registry

JOURNAL_SCHEMA = 1
# journal record kinds: one header, completed collectives, open/close
# brackets for host-blocking collectives, and a clean-shutdown trailer
# (its absence marks a crashed rank — position differences then read as a
# crash/hang story, not a desync)
JOURNAL_KINDS = ("journal_start", "program", "coll", "coll_enter",
                 "coll_exit", "journal_end")
# collective kinds a journal may record beyond the step schedule's wire
# kinds: the wireup barrier/reduce_max and the end-of-epoch flush (the
# host-side drain of every dispatched step's collectives)
HOST_KINDS = ("barrier", "allreduce", "flush")
# default live-hang threshold (seconds an entered collective may stay
# open); override via $PDMT_COLLECTIVE_HANG_S or the CLI
DEFAULT_HANG_S = 120.0


def journal_path(out_dir: str, rank: int) -> str:
    """Rank 0 writes `journal.jsonl`, other ranks `journal.rankN.jsonl` —
    the events.jsonl naming convention, so one `--telemetry DIR` holds
    both surfaces side by side."""
    name = ("journal.jsonl" if rank == 0 else f"journal.rank{rank}.jsonl")
    return os.path.join(out_dir, name)


def journal_files(target: str) -> List[str]:
    """Resolve a --telemetry dir (every `journal*.jsonl` inside) or a
    single journal file to a sorted list of paths; [] when absent. The
    single-file form applies the same `journal*.jsonl` name rule as the
    dir glob — an events trace (or any other file) handed here must NOT
    be misparsed as a collective journal (the export CLI routes one
    target through both resolvers)."""
    if os.path.isdir(target):
        return sorted(glob.glob(os.path.join(target, "journal*.jsonl")))
    name = os.path.basename(target)
    if (os.path.exists(target) and name.startswith("journal")
            and name.endswith(".jsonl")):
        return [target]
    return []


class CollectiveJournal:
    """The write side: one journal per rank, append-only JSONL,
    line-buffered like the event trace (a crash keeps everything up to its
    last completed record — which is exactly the hang evidence).

    Thread-safety: the train loop and the wireup brackets write from the
    main thread; the watchdog thread only READS `open_entry()` — the
    `_lock` makes the open-entry handoff and seq allocation atomic."""

    def __init__(self, path: str, *, rank: int = 0, world: int = 1,
                 registry: Optional[MetricsRegistry] = None):
        self.path = str(path)
        self.rank = int(rank)
        self.world = int(world)
        self.dir = os.path.dirname(os.path.abspath(self.path))
        self._f = open(self.path, "a", buffering=1)
        self._lock = threading.Lock()
        self._seq = 0
        self._open: Optional[dict] = None
        self._schedule: List[dict] = []
        self.overhead_s = 0.0   # cumulative host seconds spent journaling
        reg = registry if registry is not None else get_registry()
        self._collectives = reg.counter("cluster.collectives")
        self._bytes = reg.counter("cluster.bytes_on_wire")
        self._seq_gauge = reg.gauge("cluster.seq")
        self._seq_gauge.set(0)
        reg.gauge("cluster.world").set(self.world)
        reg.gauge("cluster.journal_overhead_s").set_fn(
            lambda: self.overhead_s)
        self._write({"kind": "journal_start", "v": JOURNAL_SCHEMA,
                     "rank": self.rank, "world": self.world,
                     "pid": os.getpid()})

    # -- plumbing ----------------------------------------------------------

    def _write(self, rec: dict) -> None:
        rec.setdefault("t_wall", time.time())
        rec.setdefault("t_mono", time.perf_counter())
        if not self._f.closed:
            self._f.write(json.dumps(rec) + "\n")

    # -- write surface -----------------------------------------------------

    def bind_program(self, comm: str, overlap: bool,
                     schedule: List[dict]) -> None:
        """Record the step program's static collective schedule (one
        `program` record; per-step `coll` records then reference it by
        position so the hot path writes indices, not repeated shapes)."""
        self._schedule = list(schedule)
        self._write({"kind": "program", "comm": str(comm),
                     "overlap": bool(overlap), "schedule": self._schedule})

    def record_step(self, step: int, t_enter: float, t_exit: float,
                    t_wall: float) -> None:
        """Expand one dispatched step into per-collective records: every
        schedule entry gets its own seq, sharing the step's host dispatch
        window [t_enter, t_exit] (enqueue-side stamps under async
        dispatch — the Timer/span honesty contract; the end-of-epoch
        flush bracket is where device-side completion is observable).
        `t_wall` is the window's ENTER wall stamp — the cross-rank
        alignment key the skew report and the export arrows ride."""
        t0 = time.perf_counter()
        with self._lock:
            for i, ent in enumerate(self._schedule):
                self._write({"kind": "coll", "seq": self._seq + i,
                             "k": ent["kind"], "axis": ent["axis"],
                             "bytes": ent["bytes"],
                             "bucket": ent["bucket"], "step": int(step),
                             "t_enter": t_enter, "t_exit": t_exit,
                             "t_wall": t_wall})
                self._bytes.inc(ent["bytes"])
            self._seq += len(self._schedule)
            self._collectives.inc(len(self._schedule))
            self._seq_gauge.set(self._seq)
        self.overhead_s += time.perf_counter() - t0

    def enter(self, kind: str, *, axis: str = "world", nbytes: int = 0,
              **attrs) -> int:
        """Open a host-BLOCKING collective (barrier / reduce_max / the
        epoch flush): writes the enter record and arms the watchdog's
        open-entry view. Returns the seq to pass to `exit`."""
        now_m, now_w = time.perf_counter(), time.time()
        with self._lock:
            seq = self._seq
            self._seq += 1
            self._open = {"seq": seq, "kind": str(kind),
                          "t_enter_mono": now_m, "t_enter_wall": now_w,
                          **attrs}
            self._write({"kind": "coll_enter", "seq": seq, "k": str(kind),
                         "axis": axis, "bytes": int(nbytes), "bucket": 0,
                         "t_enter": now_m, "t_wall": now_w, **attrs})
            self._collectives.inc()
            self._seq_gauge.set(self._seq)
        return seq

    def exit(self, seq: int) -> None:
        with self._lock:
            if self._open is not None and self._open["seq"] == seq:
                self._open = None
            self._write({"kind": "coll_exit", "seq": int(seq),
                         "t_exit": time.perf_counter()})

    def open_entry(self) -> Optional[dict]:
        """The currently entered-but-not-exited collective (the watchdog's
        poll target), or None."""
        with self._lock:
            return dict(self._open) if self._open is not None else None

    def last_position(self) -> dict:
        with self._lock:
            return {"rank": self.rank, "seq": self._seq,
                    "open": dict(self._open) if self._open else None}

    def close(self, clean: bool = True) -> None:
        """Write the `journal_end` trailer (clean shutdown marker the
        desync detector keys on) and close the file."""
        with self._lock:
            if not self._f.closed:
                if clean:
                    self._write({"kind": "journal_end", "seq": self._seq})
                self._f.close()


class NullJournal:
    """The disabled default: every call is a no-op; `enter` returns -1 so
    the bracketing call sites never branch (one attribute check on the
    barrier path, nothing at all on the per-step path — the loop only
    journals when handed a real journal)."""

    rank = 0
    world = 1
    overhead_s = 0.0

    def bind_program(self, comm, overlap, schedule):
        pass

    def record_step(self, step, t_enter, t_exit, t_wall):
        pass

    def enter(self, kind, *, axis="world", nbytes=0, **attrs):
        return -1

    def exit(self, seq):
        pass

    def open_entry(self):
        return None

    def last_position(self):
        return {"rank": 0, "seq": 0, "open": None}

    def close(self, clean=True):
        pass


_NULL = NullJournal()
_journal = _NULL
_watchdog: "Optional[CollectiveWatchdog]" = None
# enable/disable swap the process-wide journal; the wireup brackets and a
# late CLI toggle can race the swap: readers get either journal, both valid
_JOURNAL_LOCK = threading.Lock()


def get_journal():
    """The process-wide journal: a real CollectiveJournal after
    `enable_journal()`, the shared NullJournal otherwise."""
    return _journal


def enable_journal(out_dir: str, *, rank: int = 0, world: int = 1,
                   registry: Optional[MetricsRegistry] = None,
                   hang_timeout_s: Optional[float] = None,
                   watchdog: bool = True) -> CollectiveJournal:
    """Open this rank's journal under `out_dir` (created if needed), swap
    it in process-wide, and (by default) start the collective hang
    watchdog. `hang_timeout_s` falls back to $PDMT_COLLECTIVE_HANG_S,
    then DEFAULT_HANG_S."""
    global _journal, _watchdog
    os.makedirs(out_dir, exist_ok=True)
    j = CollectiveJournal(journal_path(out_dir, rank), rank=rank,
                          world=world, registry=registry)
    with _JOURNAL_LOCK:
        if isinstance(_journal, CollectiveJournal):
            _journal.close(clean=False)
        if _watchdog is not None:
            _watchdog.stop()
            _watchdog = None
        _journal = j
        if watchdog:
            if hang_timeout_s is None:
                from ..parallel.wireup import env_seconds
                hang_timeout_s = env_seconds("PDMT_COLLECTIVE_HANG_S",
                                             DEFAULT_HANG_S)
            _watchdog = CollectiveWatchdog(j, timeout_s=hang_timeout_s,
                                           registry=registry)
            _watchdog.start()
    return j


def disable_journal(clean: bool = True) -> None:
    """Stop the watchdog, write the `journal_end` trailer (`clean=False`
    for a crash path: the missing trailer IS the evidence), restore the
    null journal."""
    global _journal, _watchdog
    with _JOURNAL_LOCK:
        if _watchdog is not None:
            _watchdog.stop()
            _watchdog = None
        if isinstance(_journal, CollectiveJournal):
            _journal.close(clean=clean)
        _journal = _NULL


# ---------------------------------------------------------------------------
# the live hang watchdog
# ---------------------------------------------------------------------------


class CollectiveWatchdog:
    """Fires when the journal's open entry (an entered, un-exited
    collective) ages past `timeout_s`: who-is-where table to the flight
    recorder, ring dump, `/healthz` flipped fatal (the
    `health.worst_severity_level` gauge prom.py's endpoint reads), one
    stderr line. Fires once per stuck seq — a wedged rank must not spam
    its own post-mortem."""

    def __init__(self, journal: CollectiveJournal, *,
                 timeout_s: float = DEFAULT_HANG_S,
                 registry: Optional[MetricsRegistry] = None,
                 poll_s: Optional[float] = None):
        self.journal = journal
        self.timeout_s = float(timeout_s)
        self.registry = registry if registry is not None else get_registry()
        self._poll_s = (poll_s if poll_s is not None
                        else max(self.timeout_s / 4.0, 0.01))
        self._stop = threading.Event()
        self._fired: "set[int]" = set()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._watch,
                                        name="pdmt-collective-watchdog",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _watch(self) -> None:
        while not self._stop.wait(self._poll_s):
            entry = self.journal.open_entry()
            if entry is None or entry["seq"] in self._fired:
                continue
            age = time.perf_counter() - entry["t_enter_mono"]
            if age >= self.timeout_s:
                self._fired.add(entry["seq"])
                self.fire(entry, age)

    def fire(self, entry: dict, age_s: float) -> None:
        """The hang verdict (also callable synchronously — the CLI's
        injected-timeout path reports through here so the live and
        crash-path stories are one code path)."""
        report_hang(self.journal, entry, age_s=age_s,
                    registry=self.registry)


def report_hang(journal: CollectiveJournal, entry: dict, *,
                age_s: float = 0.0,
                registry: Optional[MetricsRegistry] = None) -> dict:
    """Record a stuck collective: flight `collective_hang` entry with the
    who-is-where table (every rank's last journal position, read from the
    shared telemetry dir), flight ring dump, `cluster.hangs` counter, and
    the fatal health flip (`health.worst_severity_level` = 2 →
    `/healthz` answers 503; `health.fired.collective_hang` counts it).
    Returns the who-is-where table."""
    import sys
    reg = registry if registry is not None else get_registry()
    who = who_is_where(journal.dir)
    flight.record("collective_hang", rank=journal.rank,
                  seq=int(entry.get("seq", -1)),
                  collective=str(entry.get("kind", "?")),
                  age_s=round(float(age_s), 3), who_is_where=who)
    reg.counter("cluster.hangs").inc()
    reg.counter("health.fired.collective_hang").inc()
    reg.counter("health.events_total").inc()
    worst = reg.gauge("health.worst_severity_level")
    if not isinstance(worst.value, (int, float)) or worst.value < 2:
        worst.set(2)
    flight.dump(reason=f"collective hang: rank {journal.rank} entered seq "
                       f"{entry.get('seq')} ({entry.get('kind')}), not "
                       f"exited after {age_s:.1f}s")
    print(f"[cluster] rank{journal.rank} FATAL collective_hang: entered "
          f"seq {entry.get('seq')} ({entry.get('kind')}), not exited "
          f"after {age_s:.1f}s — who-is-where: "
          + "; ".join(f"rank{w['rank']} at seq {w['seq']} ({w['last']})"
                      for w in who),
          file=sys.stderr, flush=True)
    return who


def who_is_where(target: str) -> List[dict]:
    """Every rank's last journal position, read from the journals under
    `target` (the shared --telemetry dir — the same shared-fs contract
    the checkpoint directory documents): one
    `{rank, seq, last, open}` row per journal, `last` a human label of
    the newest record, `open` the stuck collective when an enter has no
    exit."""
    rows = []
    for path in journal_files(target):
        j = load_journal(path)
        rows.append({"rank": j["rank"], "seq": j["last_seq"],
                     "last": j["last_label"],
                     "open": j["open"][0] if j["open"] else None})
    rows.sort(key=lambda r: r["rank"])
    return rows


# ---------------------------------------------------------------------------
# read side: load, merge, detect
# ---------------------------------------------------------------------------


def load_journal(path: str) -> dict:
    """Parse one rank's journal -> {rank, world, program, records, open,
    closed, last_seq, last_label, segments, errors}. Lenient like the
    trace loader: a torn last line (the crash case) becomes an error
    string, never an exception. `records` holds completed collectives
    (both stamps); `open` holds enters with no matching exit — the hang
    evidence.

    The file opens in APPEND mode (a re-exec'd outage resume or a plain
    re-run into the same --telemetry dir adds a segment beginning with a
    fresh `journal_start`, exactly like events.jsonl), and seq numbering
    restarts per segment — so the loader reports the NEWEST segment (the
    live run's story; a stale segment's seqs would collide and its open
    entries would read as hangs a later clean run already superseded).
    Earlier segments stay in the file for manual inspection; their count
    is surfaced as `segments`."""
    rank, world = 0, 1
    program: Optional[dict] = None
    records: List[dict] = []
    enters: Dict[int, dict] = {}
    errors: List[str] = []
    closed = False
    last_seq = 0
    last_label = "journal_start"
    segments = 0
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
            kind = rec.get("kind")
            if kind == "journal_start":
                # a fresh appended segment: reset to ITS story (seq scope
                # and open-entry state restart with the run)
                segments += 1
                rank = int(rec.get("rank", rank))
                world = int(rec.get("world", world))
                program = None
                records = []
                enters = {}
                closed = False
                last_seq = 0
                last_label = "journal_start"
            elif kind == "program":
                program = rec
            elif kind == "coll":
                records.append(rec)
                last_seq = max(last_seq, int(rec.get("seq", 0)) + 1)
                last_label = (f"{rec.get('k')} step {rec.get('step')}"
                              if rec.get("step") is not None
                              else str(rec.get("k")))
            elif kind == "coll_enter":
                enters[rec.get("seq")] = rec
                last_seq = max(last_seq, int(rec.get("seq", 0)) + 1)
                last_label = f"{rec.get('k')} (open)"
            elif kind == "coll_exit":
                ent = enters.pop(rec.get("seq"), None)
                if ent is not None:
                    ent = dict(ent)
                    ent["t_exit"] = rec.get("t_exit")
                    records.append(ent)
                    last_label = str(ent.get("k"))
                else:
                    errors.append(f"{path}:{line_no}: exit for seq "
                                  f"{rec.get('seq')} with no matching "
                                  f"enter")
            elif kind == "journal_end":
                closed = True
                last_label = "journal_end"
            elif kind is not None and kind not in JOURNAL_KINDS:
                errors.append(f"{path}:{line_no}: unknown journal record "
                              f"kind {kind!r}")
    open_entries = sorted(
        ({"seq": int(e.get("seq", -1)), "kind": str(e.get("k", "?")),
          "t_enter": e.get("t_enter"), "t_wall": e.get("t_wall"),
          **{k: v for k, v in e.items()
             if k in ("first_seq", "last_seq", "steps")}}
         for e in enters.values()), key=lambda e: e["seq"])
    return {"path": path, "rank": rank, "world": world, "program": program,
            "records": records, "open": open_entries, "closed": closed,
            "last_seq": last_seq, "last_label": last_label,
            "segments": max(segments, 1), "errors": errors}


def _percentile(sorted_vals: List[float], q: float) -> float:
    import math
    if not sorted_vals:
        return 0.0
    rank = max(1, math.ceil(q * len(sorted_vals)))
    return sorted_vals[min(rank, len(sorted_vals)) - 1]


def _flight_context(target: str) -> List[dict]:
    """Fault/hang entries from the flight dumps beside the journals — the
    injected-fault and watchdog-verdict context a hang report renders.
    Lenient: an unreadable dump is skipped (the journals are the primary
    evidence)."""
    out = []
    if not os.path.isdir(target):
        return out
    for path in sorted(glob.glob(os.path.join(target, "flight.*.json"))):
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            continue
        for e in payload.get("entries", []):
            if isinstance(e, dict) and e.get("kind") in (
                    "fault_injected", "collective_hang"):
                out.append({k: v for k, v in e.items()
                            if k != "t_mono"})
    return out


def cluster_report(target: str) -> dict:
    """Merge every rank's journal (+ flight context) under `target` into
    the cluster forensics report: desync violations, per-rank-pair
    enter-time skew with the worst collective named, and the hang section
    (open collectives + the who-is-where table). The JAX package's
    `trace report --cluster` renders it and exits 3 on desync."""
    paths = journal_files(target)
    journals = [load_journal(p) for p in paths]
    journals.sort(key=lambda j: j["rank"])
    ranks = [j["rank"] for j in journals]
    errors: List[str] = []
    for j in journals:
        errors.extend(j["errors"])

    # per-seq view: rank -> record (completed collectives + opens)
    by_seq: Dict[int, Dict[int, dict]] = {}
    for j in journals:
        for rec in j["records"]:
            by_seq.setdefault(int(rec.get("seq", -1)), {})[j["rank"]] = rec
        for e in j["open"]:
            by_seq.setdefault(e["seq"], {})[j["rank"]] = {
                "k": e["kind"], "bytes": None, "bucket": None,
                "t_enter": e["t_enter"], "t_wall": e["t_wall"],
                "open": True}

    # -- desync: same seq, different collective ---------------------------
    violations: List[dict] = []
    for seq in sorted(by_seq):
        per_rank = by_seq[seq]
        if len(per_rank) < 2:
            continue
        items = sorted(per_rank.items())
        r0, rec0 = items[0]
        for r1, rec1 in items[1:]:
            for fld in ("k", "bytes", "bucket"):
                v0, v1 = rec0.get(fld), rec1.get(fld)
                if v0 is None or v1 is None:
                    continue   # an open entry has no bytes to compare
                if v0 != v1:
                    violations.append({
                        "seq": seq, "field": fld,
                        "ranks": [r0, r1],
                        "rank_a": {"rank": r0, "kind": rec0.get("k"),
                                   "bytes": rec0.get("bytes"),
                                   "bucket": rec0.get("bucket")},
                        "rank_b": {"rank": r1, "kind": rec1.get("k"),
                                   "bytes": rec1.get("bytes"),
                                   "bucket": rec1.get("bucket")},
                        "detail": f"rank {r0} recorded "
                                  f"{rec0.get('k')}/{rec0.get('bytes')}B/"
                                  f"bucket {rec0.get('bucket')} at seq "
                                  f"{seq} while rank {r1} recorded "
                                  f"{rec1.get('k')}/{rec1.get('bytes')}B/"
                                  f"bucket {rec1.get('bucket')}"})
                    break
    # position desync: two CLEANLY closed journals ending at different
    # seqs ran different programs (a crashed rank's short journal is a
    # crash story, reported under hang/who-is-where instead)
    closed = [j for j in journals if j["closed"]]
    for i in range(len(closed)):
        for k in range(i + 1, len(closed)):
            a, b = closed[i], closed[k]
            if a["last_seq"] != b["last_seq"]:
                violations.append({
                    "seq": min(a["last_seq"], b["last_seq"]),
                    "field": "position",
                    "ranks": [a["rank"], b["rank"]],
                    "rank_a": {"rank": a["rank"], "seq": a["last_seq"]},
                    "rank_b": {"rank": b["rank"], "seq": b["last_seq"]},
                    "detail": f"rank {a['rank']} closed its journal at "
                              f"seq {a['last_seq']} while rank "
                              f"{b['rank']} closed at seq "
                              f"{b['last_seq']} — the ranks ran "
                              f"different collective sequences"})

    # -- straggler attribution: wall-aligned enter spread per rank pair --
    pair_deltas: Dict[str, List[Tuple[float, int, str]]] = {}
    for seq, per_rank in by_seq.items():
        enters = {r: rec.get("t_wall") for r, rec in per_rank.items()
                  if isinstance(rec.get("t_wall"), (int, float))}
        if len(enters) < 2:
            continue
        rs = sorted(enters)
        kind = per_rank[rs[0]].get("k")
        for i in range(len(rs)):
            for k in range(i + 1, len(rs)):
                delta = abs(enters[rs[i]] - enters[rs[k]])
                pair_deltas.setdefault(f"{rs[i]}-{rs[k]}", []).append(
                    (delta, seq, str(kind)))
    pairs = {}
    worst = None
    for pair, deltas in sorted(pair_deltas.items()):
        vals = sorted(d for d, _s, _k in deltas)
        top = max(deltas)
        pairs[pair] = {"n": len(vals),
                       "p50_s": _percentile(vals, 0.50),
                       "p95_s": _percentile(vals, 0.95),
                       "max_s": top[0],
                       "worst": {"seq": top[1], "kind": top[2],
                                 "spread_s": top[0]}}
        if worst is None or top[0] > worst["spread_s"]:
            worst = {"pair": pair, "seq": top[1], "kind": top[2],
                     "spread_s": top[0]}

    # -- hang section -----------------------------------------------------
    open_all = [{"rank": j["rank"], **e} for j in journals
                for e in j["open"]]
    stuck = min(open_all, key=lambda e: e["seq"]) if open_all else None
    who = [{"rank": j["rank"], "seq": j["last_seq"],
            "last": j["last_label"], "closed": j["closed"],
            "open": j["open"][0] if j["open"] else None}
           for j in journals]

    totals = {"collectives": sum(len(j["records"]) for j in journals),
              "bytes": sum(int(r.get("bytes") or 0)
                           for j in journals for r in j["records"])}
    # appended re-runs: the report covers each journal's NEWEST segment;
    # say so rather than letting a truncated view read as the whole story
    multi_segment = sorted(j["rank"] for j in journals
                           if j["segments"] > 1)
    return {
        "report": "cluster_forensics",
        "v": 1,
        "files": paths,
        "ranks": ranks,
        "n_ranks": len(ranks),
        "programs": sorted({(j["program"] or {}).get("comm", "?")
                            for j in journals if j["program"]}),
        "totals": totals,
        "multi_segment_ranks": multi_segment,
        "errors": errors,
        "desync": {"ok": not violations, "violations": violations},
        "skew": {"pairs": pairs, "worst": worst},
        "hang": {"open": open_all, "stuck": stuck, "who_is_where": who},
        "faults": _flight_context(target),
    }


def format_cluster_report(report: dict) -> str:
    """Human rendering of `cluster_report` (the --json flag prints the
    dict itself)."""
    lines = [f"cluster report: {report['n_ranks']} rank(s), "
             f"{report['totals']['collectives']} journaled collective(s), "
             f"{report['totals']['bytes']} wire byte(s)"
             + (f", program(s): {', '.join(report['programs'])}"
                if report["programs"] else "")]
    if report.get("multi_segment_ranks"):
        lines.append(f"note: rank(s) {report['multi_segment_ranks']} hold "
                     f"appended earlier run segments — this report covers "
                     f"each journal's NEWEST segment only")
    d = report["desync"]
    if d["ok"]:
        lines.append("desync: OK — every shared seq agrees on "
                     "kind/bytes/bucket")
    else:
        lines.append(f"desync: {len(d['violations'])} violation(s)")
        for v in d["violations"][:8]:
            lines.append(f"  DESYNC seq {v['seq']} ({v['field']}): "
                         f"{v['detail']}")
    sk = report["skew"]
    if sk["pairs"]:
        for pair, st in sorted(sk["pairs"].items()):
            lines.append(f"skew rank pair {pair}: p50 "
                         f"{st['p50_s'] * 1e3:.3f}ms p95 "
                         f"{st['p95_s'] * 1e3:.3f}ms max "
                         f"{st['max_s'] * 1e3:.3f}ms at seq "
                         f"{st['worst']['seq']} ({st['worst']['kind']})")
        w = sk["worst"]
        lines.append(f"worst straggler collective: seq {w['seq']} "
                     f"({w['kind']}) — {w['spread_s'] * 1e3:.3f}ms spread "
                     f"on pair {w['pair']}")
    else:
        lines.append("skew: fewer than 2 ranks share a seq "
                     "(nothing to compare)")
    h = report["hang"]
    if h["stuck"] is not None:
        s = h["stuck"]
        lines.append(f"HANG: rank {s['rank']} entered collective seq "
                     f"{s['seq']} ({s['kind']}) and never exited")
        lines.append("who-is-where (every rank's last journal position):")
        for w in h["who_is_where"]:
            state = ("OPEN at seq {seq} ({kind})".format(**w["open"])
                     if w["open"] else
                     "closed cleanly" if w["closed"] else
                     "no trailer (crashed?)")
            lines.append(f"  rank {w['rank']}: seq {w['seq']}, last "
                         f"{w['last']} — {state}")
    else:
        lines.append("hang: none (no open collectives)")
    for f_ in report["faults"][:8]:
        lines.append(f"flight: {f_.get('kind')} "
                     + ", ".join(f"{k}={v}" for k, v in sorted(f_.items())
                                 if k not in ("kind", "t_wall",
                                              "who_is_where", "seq")
                                 and not isinstance(v, (dict, list))))
    if report["errors"]:
        lines.append(f"journal parse: {len(report['errors'])} "
                     f"problem(s); first: {report['errors'][0]}")
    verdict = ("FAIL — cross-rank desync" if not d["ok"]
               else "HANG detected" if h["stuck"] is not None else "OK")
    lines.append(f"cluster verdict: {verdict}")
    return "\n".join(lines)
