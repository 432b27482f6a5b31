"""`python -m pytorch_ddp_mnist_tpu_torch trace`: the read side of
`--telemetry` (port of `pytorch_ddp_mnist_tpu/cli/trace.py`, with its
subcommands, flags, texts and exit codes):

    trace report DIR [--json] [--baseline OLD] [--threshold 1.5]
                                 # per-phase p50/p95/max, epoch trend,
                                 # straggler skew; step-time gate
    trace report --serve DIR     # serve-path stage attribution (+ gate)
    trace report --data DIR      # data_wait share of epoch time (+ gate)
    trace report --cluster DIR   # per-rank collective journals: desync
                                 # (exit 3), straggler skew, hangs
    trace report --overhead DIR  # --profile_dispatch phases, >= 90%
                                 # coverage, worst phase (+ gate); DIR may
                                 # be a stamped DDP artifact
    trace report --cost COST.json [--baseline OLD]
                                 # program records + the compile / peak /
                                 # analytic-efficiency gate; also takes a
                                 # DDP bench artifact (strategies rows)
    trace report ARTIFACT --ledger DIR [--window 5]
                                 # ARTIFACT against the ledger history
    trace export DIR [-o trace.json] [--ledger DIR]
                                 # Chrome trace-event JSON (Perfetto)
    trace cost [-o COST.json] [--telemetry DIR] [--device 0|cpu]
               [--form step|run|both] [--artifact MULTICHIP.json]
                                 # harvest the program cost records on the
                                 # card (telemetry/costs.py)

A target or baseline that is a DDP bench artifact (anything carrying
`strategies` rows) gates each strategy's `scaling_efficiency_vs_1dev`.
Only rows of the same workload (model, param_scale, n_devices) pair up.
`trace cost` runs on the card unless `--device cpu` is passed; with no
card it exits by name.

Exit codes: 0 ok, 1 unreadable/empty target (or a program that failed in
`trace cost`), 2 usage, 3 regression gate.
"""

from __future__ import annotations

import argparse
import json
import sys


def _load_report(target: str):
    """A report dict from `target`: either a saved `trace report --json`
    file (recognized by its "report" tag; the combined --baseline shape
    `{"report": {...}, "comparison": ...}` unwraps to its report) or a
    trace dir/file to analyze. Returns (report, error_message)."""
    import os

    from ..telemetry import analysis

    paths = analysis.trace_files(target)
    if os.path.isfile(target) and not target.endswith(".jsonl"):
        # An explicitly named non-trace FILE may be a saved report (saved
        # reports are small; never sniffed for dir targets, whose
        # events*.jsonl can be large JSONL streams).
        try:
            with open(target) as f:
                head = json.load(f)
        except ValueError:
            head = None  # not one JSON document: treat as a JSONL trace
        if isinstance(head, dict):
            if head.get("report") == "trace_phase_stats":
                return head, None
            nested = head.get("report")
            if isinstance(nested, dict) \
                    and nested.get("report") == "trace_phase_stats":
                return nested, None  # a saved --baseline --json document
            if isinstance(head.get("strategies"), list):
                # a DDP bench artifact (MULTICHIP_r0X.json): gate on its
                # per-strategy scaling_efficiency_vs_1dev rows — the
                # efficiency regression gate (ROADMAP item 2), same exit-3
                # contract as the step-time phases
                rep = analysis.efficiency_report(head, path=target)
                if rep["records"] == 0:
                    return None, (f"{target}: artifact carries no "
                                  f"strategy rows with "
                                  f"{analysis.EFFICIENCY_STAT}")
                return rep, None
    if not paths:
        return None, f"{target}: no events*.jsonl found"
    report = analysis.analyze(paths)
    if report["records"] == 0:
        return None, f"{target}: empty trace"
    return report, None


def _load_tagged_report(target: str, tag: str, build, is_empty,
                        empty_msg: str):
    """A report from `target`: a saved `--json` file recognized by its
    `tag` (plain, or nested under the combined --baseline shape
    `{"report": {...}, "comparison": ...}`), or a trace dir/file run
    through `build(paths)`. Returns (report, error_message) — the one
    loader the --data and --serve report/gate paths share, so a format
    tweak cannot silently diverge between them."""
    import os

    from ..telemetry import analysis

    if os.path.isfile(target) and not target.endswith(".jsonl"):
        try:
            with open(target) as f:
                head = json.load(f)
        except ValueError:
            head = None  # not one JSON document: treat as a JSONL trace
        if isinstance(head, dict):
            if head.get("report") == tag:
                return head, None
            nested = head.get("report")
            if isinstance(nested, dict) and nested.get("report") == tag:
                return nested, None
    paths = analysis.trace_files(target)
    if not paths:
        return None, f"{target}: no events*.jsonl found"
    report = build(paths)
    if is_empty(report):
        return None, f"{target}: {empty_msg}"
    return report, None


def _load_data_report(target: str):
    from ..telemetry import analysis

    return _load_tagged_report(
        target, "trace_data_stats", analysis.data_report,
        lambda r: r["epochs"] == 0,
        "no epoch spans with data_wait attribution (train with "
        "--telemetry on the STREAMING path to emit them)")


def _load_serve_report(target: str):
    from ..telemetry import analysis

    return _load_tagged_report(
        target, "serve_trace_attribution", analysis.serve_report,
        lambda r: r["requests"] == 0,
        "no serve.request spans (serve with --telemetry DIR to emit "
        "them)")


def _load_overhead_report(target: str):
    """The dispatch-overhead report from `target`: a saved `--overhead
    --json` report, a DDP bench artifact (MULTICHIP_r0X.json — rows
    stamped by `bench.py --mode ddp`'s dispatch probe), or a
    `--profile_dispatch` trace dir/file."""
    import os

    from ..telemetry import analysis

    if os.path.isfile(target) and not target.endswith(".jsonl"):
        try:
            with open(target) as f:
                head = json.load(f)
        except ValueError:
            head = None  # not one JSON document: treat as a JSONL trace
        if isinstance(head, dict):
            if head.get("report") == analysis.OVERHEAD_REPORT_TAG:
                return head, None
            nested = head.get("report")
            if isinstance(nested, dict) \
                    and nested.get("report") == analysis.OVERHEAD_REPORT_TAG:
                return nested, None
            if isinstance(head.get("strategies"), list):
                rep = analysis.overhead_from_artifact(head, path=target)
                if not rep["rows"]:
                    return None, (f"{target}: artifact carries no "
                                  f"strategy rows")
                return rep, None
    return _load_tagged_report(
        target, analysis.OVERHEAD_REPORT_TAG, analysis.overhead_report,
        lambda r: not r["rows"],
        "no dispatch_phase/dispatch_window points (train with "
        "--telemetry DIR --profile_dispatch to emit them)")


def _cmd_ledger_gate(a) -> int:
    """`trace report TARGET --ledger DIR`: the pairwise gates' multi-run
    mode. TARGET (an ingestible artifact — the newest run) gates against
    the ledger HISTORY under DIR instead of one --baseline artifact: the
    median+MAD band of each series' last --window runs. The report-family
    flag narrows which series gate (--serve: serve.*, --data: input.*,
    --cost: cost.*, --overhead: the ddp overhead shares); exit semantics
    match the pairwise gates — 1 when nothing overlapped (the gate
    checked nothing), 3 naming series + runs on regression."""
    import os

    from ..telemetry import ledger as ledger_mod

    try:
        target_rows, _skips = ledger_mod.load_artifact(a.target)
    except ledger_mod.LedgerError as e:
        print(f"trace report: {e}", file=sys.stderr)
        return 1
    prefixes = None
    if a.serve:
        prefixes = ("serve.",)
    elif a.data:
        prefixes = ("input.",)
    elif a.cost:
        prefixes = ("cost.",)
    elif a.overhead:
        prefixes = ("ddp.overhead", "ddp.journal_overhead_share")
    if prefixes:
        target_rows = [r for r in target_rows
                       if r["metric"].startswith(prefixes)]
    if not target_rows:
        print(f"trace report: {a.target}: no gateable ledger rows"
              + (f" for the selected family ({'/'.join(prefixes)}*)"
                 if prefixes else ""), file=sys.stderr)
        return 1
    target_abs = os.path.abspath(a.target)
    history_paths = [p for p in ledger_mod.discover(a.ledger)
                     if os.path.abspath(p) != target_abs]
    try:
        hist = ledger_mod.ingest(history_paths)
    except ledger_mod.LedgerError as e:
        print(f"trace report: --ledger {e}", file=sys.stderr)
        return 1
    target_series = {r["series"] for r in target_rows}
    rows = [r for r in hist["rows"] if r["series"] in target_series]
    rows += target_rows
    rep = ledger_mod.gate(rows, window=a.window, threshold=a.threshold)
    if a.json:
        print(json.dumps(rep, indent=2 if sys.stdout.isatty() else None))
    checked = [s for s in rep["series"] if s["n"] >= 2]
    if not checked:
        print(f"trace report: no series of {a.target} overlaps the "
              f"ledger history under {a.ledger} — the gate checked "
              f"nothing (different workload/backend stamps?)",
              file=sys.stderr)
        return 1
    if rep["failures"]:
        for line in rep["failures"]:
            print(f"trace report: LEDGER REGRESSION {line}",
                  file=sys.stderr)
        return 3
    if not a.json:
        print(f"trace report: ledger gate OK — {len(checked)} series of "
              f"{os.path.basename(a.target)} checked against "
              f"{len(history_paths)} historical artifact(s) (window "
              f"{a.window}, threshold {a.threshold:g}), 0 regressions")
    return 0


def _cmd_report(a) -> int:
    from ..telemetry import analysis

    if a.ledger:
        return _cmd_ledger_gate(a)

    if a.cluster:
        # cluster forensics (docs/OBSERVABILITY.md §Cluster forensics):
        # TARGET is a --telemetry dir holding per-rank journal*.jsonl
        # files (cli/train --journal) — merged into one causal timeline:
        # desync detection (exit 3, naming both ranks and the diverging
        # collective), per-rank-pair straggler attribution, and the hang
        # report (open collectives + every rank's last journal position)
        from ..telemetry import cluster
        if not cluster.journal_files(a.target):
            print(f"trace report: {a.target}: no journal*.jsonl found "
                  f"(train with --journal --telemetry DIR to emit them)",
                  file=sys.stderr)
            return 1
        report = cluster.cluster_report(a.target)
        if a.json:
            print(json.dumps(report,
                             indent=2 if sys.stdout.isatty() else None))
        else:
            print(cluster.format_cluster_report(report))
        if not report["desync"]["ok"]:
            v = report["desync"]["violations"][0]
            print(f"trace report: cross-rank DESYNC at seq {v['seq']} "
                  f"between rank {v['ranks'][0]} and rank {v['ranks'][1]}"
                  f": {v['detail']}", file=sys.stderr)
            return 3
        return 0

    if a.cost:
        # the program-forensics report + the compile/HBM/efficiency gate
        # (docs/OBSERVABILITY.md §Program forensics): TARGET is a saved
        # `trace cost` report (COST_r0X.json) or a DDP bench artifact
        # (MULTICHIP_r0X.json), whose measured rows decompose into
        # analytic compute/comm/overhead shares — framework-free, like
        # the other report paths
        from ..telemetry import costs
        report, err = costs.load_cost_report(a.target,
                                             per_chip_batch=a.batch)
        if err:
            print(f"trace report: {err}", file=sys.stderr)
            return 1
        if a.baseline:
            baseline, err = costs.load_cost_report(a.baseline,
                                                   per_chip_batch=a.batch)
            if err:
                print(f"trace report: baseline {err}", file=sys.stderr)
                return 1
            diff = costs.compare_cost(report, baseline,
                                      threshold=a.threshold)
            if a.json:
                print(json.dumps({"report": report, "comparison": diff},
                                 indent=2 if sys.stdout.isatty() else None))
            else:
                print(costs.format_cost_report(report))
                print(costs.format_compare_cost(diff))
            if not diff["rows"]:
                print("trace report: no cost metric overlaps the baseline "
                      "— the gate checked nothing", file=sys.stderr)
                return 1
            return 3 if diff["regressions"] else 0
        if a.json:
            print(json.dumps(report,
                             indent=2 if sys.stdout.isatty() else None))
        else:
            print(costs.format_cost_report(report))
        return 0

    if a.data:
        # the input-attribution report + the data_wait-share regression
        # gate (docs/DATA.md): exit 3 when the share of epoch time spent
        # blocked on input regresses past --threshold (sub-ms exempt)
        report, err = _load_data_report(a.target)
        if err:
            print(f"trace report: {err}", file=sys.stderr)
            return 1
        if a.baseline:
            baseline, err = _load_data_report(a.baseline)
            if err:
                print(f"trace report: baseline {err}", file=sys.stderr)
                return 1
            diff = analysis.compare_data(report, baseline,
                                         threshold=a.threshold)
            if a.json:
                print(json.dumps({"report": report, "comparison": diff},
                                 indent=2 if sys.stdout.isatty() else None))
            else:
                print(analysis.format_data_report(report))
                print(analysis.format_compare_data(diff))
            if not diff["rows"]:
                print("trace report: no share stat overlaps the baseline "
                      "— the gate checked nothing", file=sys.stderr)
                return 1
            return 3 if diff["regressions"] else 0
        if a.json:
            print(json.dumps(report,
                             indent=2 if sys.stdout.isatty() else None))
        else:
            print(analysis.format_data_report(report))
        return 0

    if a.overhead:
        # the dispatch-overhead attribution report (docs/OBSERVABILITY.md
        # §Dispatch forensics): named host phases + coverage of the
        # profiled window / the roofline's O, worst phase; with
        # --baseline, the phase-SHARE regression gate (exit 3, sub-ms
        # phases exempt). Coverage below OVERHEAD_COVERAGE_MIN is a
        # hard failure — the decomposition stopped explaining the
        # overhead it exists to attribute.
        report, err = _load_overhead_report(a.target)
        if err:
            print(f"trace report: {err}", file=sys.stderr)
            return 1
        if a.baseline:
            baseline, err = _load_overhead_report(a.baseline)
            if err:
                print(f"trace report: baseline {err}", file=sys.stderr)
                return 1
            diff = analysis.compare_overhead(report, baseline,
                                             threshold=a.threshold)
            if a.json:
                print(json.dumps({"report": report, "comparison": diff},
                                 indent=2 if sys.stdout.isatty() else None))
            else:
                print(analysis.format_overhead_report(report))
                print(analysis.format_compare_overhead(diff))
            if not diff["rows"]:
                print("trace report: no phase share overlaps the baseline "
                      "— the gate checked nothing", file=sys.stderr)
                return 1
            return 3 if diff["regressions"] else 0
        if a.json:
            print(json.dumps(report,
                             indent=2 if sys.stdout.isatty() else None))
        else:
            print(analysis.format_overhead_report(report))
        low = [r for r in report["rows"]
               if isinstance(r.get("coverage"), (int, float))
               and not r.get("note")
               and r["coverage"] < analysis.OVERHEAD_COVERAGE_MIN]
        if low:
            r = low[0]
            print(f"trace report: {r['program']}: phases explain only "
                  f"{r['coverage']:.0%} of the overhead window (floor "
                  f"{analysis.OVERHEAD_COVERAGE_MIN:.0%}) — unprofiled "
                  f"host work grew outside the named phases",
                  file=sys.stderr)
            return 1
        return 0

    if a.serve:
        # the serve-path attribution report (docs/OBSERVABILITY.md
        # §Request tracing): per-stage p50/p95/p99 + %-of-e2e, batch
        # occupancy/padding waste, slowest-request exemplar trees; with
        # --baseline, the stage-SHARE regression gate — exit 3 when
        # compute's share of e2e drops (or an overhead stage's share
        # grows) past --threshold, sub-ms stages exempt (docs/SERVING.md
        # §Fast path)
        report, err = _load_serve_report(a.target)
        if err:
            print(f"trace report: {err}", file=sys.stderr)
            return 1
        if a.baseline:
            baseline, err = _load_serve_report(a.baseline)
            if err:
                print(f"trace report: baseline {err}", file=sys.stderr)
                return 1
            diff = analysis.compare_serve(report, baseline,
                                          threshold=a.threshold)
            if a.json:
                print(json.dumps({"report": report, "comparison": diff},
                                 indent=2 if sys.stdout.isatty() else None))
            else:
                print(analysis.format_serve_report(report))
                print(analysis.format_compare_serve(diff))
            if not diff["rows"]:
                print("trace report: no stage share overlaps the baseline "
                      "— the gate checked nothing", file=sys.stderr)
                return 1
            return 3 if diff["regressions"] else 0
        if a.json:
            print(json.dumps(report,
                             indent=2 if sys.stdout.isatty() else None))
        else:
            print(analysis.format_serve_report(report))
        return 0

    report, err = _load_report(a.target)
    if err:
        print(f"trace report: {err}", file=sys.stderr)
        return 1
    if a.baseline:
        baseline, err = _load_report(a.baseline)
        if err:
            print(f"trace report: baseline {err}", file=sys.stderr)
            return 1
        diff = analysis.compare(report, baseline, threshold=a.threshold)
        if a.json:
            print(json.dumps({"report": report, "comparison": diff},
                             indent=2 if sys.stdout.isatty() else None))
        else:
            print(analysis.format_report(report))
            print(analysis.format_compare(diff))
        if not diff["rows"]:
            # ZERO overlapping (phase, stat) rows means the gate compared
            # nothing — renamed/dropped spans or a fused run against a
            # non-fused baseline. A silent PASS here would let a real
            # regression in the missing phase sail through CI.
            print("trace report: no phase overlaps the baseline — the "
                  "gate checked nothing (renamed spans? fused vs "
                  "non-fused run?)", file=sys.stderr)
            return 1
        return 3 if diff["regressions"] else 0
    if a.json:
        print(json.dumps(report,
                         indent=2 if sys.stdout.isatty() else None))
    else:
        print(analysis.format_report(report))
    return 0


def _cmd_cost(a) -> int:
    from ..telemetry import costs
    if a.param_scale < 1 or a.batch < 1 or a.n_devices < 1:
        print("trace cost: --param_scale/--batch/--n_devices must be >= 1",
              file=sys.stderr)
        return 2
    return costs.harvest_cli(a)


def _cmd_export(a) -> int:
    from ..telemetry import analysis, cluster, export

    paths = analysis.trace_files(a.target)
    ledger_series = None
    if a.ledger:
        # the multi-run performance-ledger counter tracks (one per
        # series, own pid) — a ledger-only export is valid: the artifact
        # history exists independently of any single run's events files
        from ..telemetry import ledger as ledger_mod
        artifact_paths = ledger_mod.discover(a.ledger)
        if not artifact_paths:
            print(f"trace export: --ledger {a.ledger}: no artifacts "
                  f"found", file=sys.stderr)
            return 1
        try:
            ledger_series = ledger_mod.histories(
                ledger_mod.ingest(artifact_paths)["rows"])
        except ledger_mod.LedgerError as e:
            print(f"trace export: --ledger {e}", file=sys.stderr)
            return 1
    if not paths and not ledger_series:
        print(f"trace export: {a.target}: no events*.jsonl found",
              file=sys.stderr)
        return 1
    # per-rank collective journals beside the trace (a --journal run)
    # render as per-rank collective tracks with seq-aligned flow arrows
    journal_paths = cluster.journal_files(a.target) if paths else []
    n = export.write_chrome_trace(paths, a.out,
                                  journal_paths=journal_paths,
                                  ledger_series=ledger_series)
    if n == 0:
        print(f"trace export: {a.target}: no timeline records",
              file=sys.stderr)
        return 1
    extra = (f" (+ {len(journal_paths)} collective journal(s))"
             if journal_paths else "")
    if ledger_series:
        extra += f" (+ {len(ledger_series)} ledger series)"
    print(f"trace export: wrote {n} event(s) from {len(paths)} file(s)"
          f"{extra} to {a.out} (load in Perfetto or chrome://tracing)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_ddp_mnist_tpu_torch trace",
        description="analyze / gate / export telemetry JSONL traces "
                    "(see docs/OBSERVABILITY.md)")
    sub = p.add_subparsers(dest="cmd", required=True,
                           metavar="report|export|cost")

    r = sub.add_parser(
        "report", help="per-phase p50/p95/max, epoch trend, straggler "
                       "skew; --baseline gates step-time regressions")
    r.add_argument("target",
                   help="a --telemetry dir (merges every events*.jsonl), "
                        "one trace file, or a saved --json report")
    r.add_argument("--serve", action="store_true",
                   help="the serve-path tail-latency attribution report "
                        "instead of the train phase report: per-stage "
                        "p50/p95/p99 + %% of e2e, batch occupancy and "
                        "padding waste, slowest-request exemplars; with "
                        "--baseline, the stage-share regression gate — "
                        "exit 3 when compute's share of e2e drops past "
                        "--threshold, sub-ms stages exempt "
                        "(docs/OBSERVABILITY.md §Request tracing)")
    r.add_argument("--data", action="store_true",
                   help="the input-attribution report instead of the train "
                        "phase report: per-epoch data_wait share of epoch "
                        "time (how much of training the host spent blocked "
                        "on the input pipeline); with --baseline, the "
                        "data_wait-share regression gate — exit 3 past "
                        "--threshold, sub-ms data_wait exempt "
                        "(docs/DATA.md)")
    r.add_argument("--cluster", action="store_true",
                   help="the cluster-forensics report instead of the "
                        "train phase report: TARGET is a --telemetry dir "
                        "holding per-rank collective journals (train with "
                        "--journal) — cross-rank desync detection (exit 3 "
                        "naming both ranks and the diverging collective), "
                        "per-collective straggler attribution per rank "
                        "pair, and the hang report (open collectives + "
                        "every rank's last journal position) "
                        "(docs/OBSERVABILITY.md §Cluster forensics)")
    r.add_argument("--overhead", action="store_true",
                   help="the dispatch-overhead attribution report instead "
                        "of the train phase report: TARGET is a "
                        "--profile_dispatch trace dir, a saved --json "
                        "report, or a DDP bench artifact with stamped "
                        "overhead decompositions — named host phases "
                        "(python_prestep/dispatch/device_idle/sync_wait), "
                        "coverage of the overhead window (exit 1 below "
                        "90%%), worst phase; with --baseline, the "
                        "phase-share regression gate — exit 3 past "
                        "--threshold, sub-ms phases exempt "
                        "(docs/OBSERVABILITY.md §Dispatch forensics)")
    r.add_argument("--cost", action="store_true",
                   help="the program-forensics report: TARGET is a saved "
                        "`trace cost` report (COST_r0X.json) or a DDP "
                        "bench artifact whose measured rows decompose "
                        "into analytic compute/comm/overhead shares; "
                        "with --baseline, the compile-count / peak-HBM / "
                        "analytic-efficiency regression gate — exit 3 "
                        "(docs/OBSERVABILITY.md §Program forensics)")
    r.add_argument("--batch", type=int, default=None,
                   help="with --cost: per-chip batch of a LEGACY artifact "
                        "whose rows predate the per_chip_batch stamp "
                        "(MULTICHIP_r07 measured at 4; default 128, the "
                        "bench default)")
    r.add_argument("--baseline", metavar="OLD", default=None,
                   help="diff against another run (trace dir/file or saved "
                        "--json report); exit 3 when any phase p50/p95 "
                        "ratio exceeds --threshold")
    r.add_argument("--ledger", metavar="DIR", default=None,
                   help="gate TARGET (an ingestible artifact) against the "
                        "performance-ledger HISTORY under DIR instead of "
                        "one --baseline: the median+MAD band of each "
                        "series' last --window runs (telemetry/ledger.py; "
                        "the report-family flag narrows which series "
                        "gate). Exit 3 names series + offending runs")
    r.add_argument("--window", type=int, default=5,
                   help="with --ledger: history runs the band is computed "
                        "over (default %(default)s)")
    r.add_argument("--threshold", type=float, default=1.5,
                   help="regression gate ratio (default 1.5; the injected-"
                        "2x acceptance trips it with margin)")
    r.add_argument("--json", action="store_true",
                   help="print the machine-readable report instead of the "
                        "table (feed a saved copy back as --baseline)")
    r.set_defaults(run=_cmd_report)

    e = sub.add_parser(
        "export", help="merged trace -> Chrome trace-event JSON "
                       "(Perfetto / chrome://tracing)")
    e.add_argument("target", help="a --telemetry dir or one trace file")
    e.add_argument("-o", "--out", default="trace.chrome.json",
                   help="output path (default ./trace.chrome.json)")
    e.add_argument("--ledger", metavar="DIR", default=None,
                   help="also render the performance-ledger history under "
                        "DIR as one Perfetto counter track per series "
                        "(own pid; runs spaced 1s apart). Works without "
                        "events files — the repo history is a timeline of "
                        "its own")
    e.set_defaults(run=_cmd_export)

    c = sub.add_parser(
        "cost", help="HARVEST program cost/memory records: capture the "
                     "comm x overlap DDP matrix (train/scan.py dp_steps) "
                     "+ the serve bucket ladder as CUDA graphs, measure "
                     "each program's memory, write a COST_r0X.json "
                     "artifact (read it back with `trace report --cost`)")
    c.add_argument("-o", "--out", default=None,
                   help="write the cost report JSON here (stdout table "
                        "always prints)")
    c.add_argument("--telemetry", metavar="DIR", default=None,
                   help="also emit the JSONL trace: one program_cost "
                        "point per record + a final registry snapshot "
                        "(xla.* compile metrics, mem.* watermarks) — the "
                        "check_telemetry --require xla./mem. surface "
                        "(xla.compiles counts CUDA-graph captures)")
    c.add_argument("--model", default="mlp",
                   help="workload family (models/zoo.py; default mlp)")
    c.add_argument("--param_scale", type=int, default=1,
                   help="hidden-width multiplier (16 = the MULTICHIP_r07 "
                        "5.8M-param geometry)")
    c.add_argument("--batch", type=int, default=16,
                   help="PER-DEVICE batch rows of the harvested step "
                        "programs (default 16, the audit geometry)")
    c.add_argument("--n_devices", type=int, default=8,
                   help="replicas of the card in the mesh (default 8, the "
                        "audit geometry)")
    c.add_argument("--form", choices=("step", "run", "both"),
                   default="step",
                   help="which DDP program forms to harvest (default "
                        "step — the measured strategy programs)")
    c.add_argument("--no-serve-ladder", dest="serve_ladder",
                   action="store_false",
                   help="skip the serve engine bucket-ladder records")
    c.add_argument("--serve_max_batch", type=int, default=128,
                   help="serve ladder cap (default 128, the engine "
                        "default: buckets 1..128)")
    c.add_argument("--artifact", default=None,
                   help="a DDP bench artifact (MULTICHIP_r0X.json) whose "
                        "measured rows become the roofline attribution "
                        "section of the report")
    c.add_argument("--per_chip_batch", type=int, default=None,
                   help="the artifact's measured per-chip batch when its "
                        "rows predate the stamp (r07: 4)")
    c.add_argument("--device", default="0",
                   help="CUDA device ordinal (default 0), or 'cpu' for the "
                        "uncaptured programs on the CPU (no memory "
                        "measurement); with no card and no --device cpu "
                        "the harvest exits by name")
    c.set_defaults(run=_cmd_cost)

    a = p.parse_args(argv)
    if a.cmd == "report":
        if a.threshold <= 0:
            p.error("--threshold must be > 0")
        picked = [f for f in ("serve", "data", "cost", "cluster",
                              "overhead")
                  if getattr(a, f)]
        if len(picked) > 1:
            p.error(f"--{picked[0]} and --{picked[1]} select different "
                    f"reports; pass one")
        if a.cluster and a.baseline:
            p.error("--cluster compares ranks against each other, not "
                    "runs against a baseline; drop --baseline")
        if a.ledger and a.baseline:
            p.error("--ledger gates against the whole history band; "
                    "--baseline is the one-step pairwise mode — pass one")
        if a.ledger and a.cluster:
            p.error("--cluster reads per-rank journals, not ledger "
                    "artifacts; drop --ledger")
        if a.window < 1:
            p.error("--window must be >= 1")
        if a.batch is not None and not a.cost:
            p.error("--batch only applies to the --cost report")
        if a.batch is not None and a.batch < 1:
            p.error("--batch must be >= 1 (the artifact's measured "
                    "per-chip batch)")
    if a.cmd == "cost" and a.per_chip_batch is not None \
            and a.per_chip_batch < 1:
        p.error("--per_chip_batch must be >= 1")
    return a.run(a)


if __name__ == "__main__":
    sys.exit(main())
