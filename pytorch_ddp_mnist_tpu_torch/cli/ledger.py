"""`python -m pytorch_ddp_mnist_tpu_torch ledger`: the performance-ledger
CLI (port of `pytorch_ddp_mnist_tpu/cli/ledger.py`, with its verbs, flags
and exit codes).

  ingest DIR      parse every artifact generation into canonical ledger
                  rows; print the row/series/skip census (--json for the
                  raw rows). Exit 1 when DIR holds no artifacts.
  report DIR      the per-series trajectory table (markdown; --json for
                  machines).
  gate DIR        the direction-aware trend gate: exit 3 naming series and
                  offending runs when the newest point regresses past
                  --threshold against the median+MAD band of the last
                  --window runs; 0 on a healthy trajectory, 1 when there
                  was nothing to gate.

--telemetry OUT emits one schema-v1 `ledger_row` point per row plus the
`ledger.series` / `ledger.regressions` / `ledger.rows` registry metrics,
so `scripts/check_telemetry.py --require ledger.` reads a ledger run like
any other. Stdlib only, as telemetry/ledger.py.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..telemetry.ledger import (DEFAULT_THRESHOLD, DEFAULT_WINDOW,
                                LedgerError, discover, gate, ingest,
                                render_markdown, report)

EXIT_OK = 0
EXIT_EMPTY = 1
EXIT_USAGE = 2
EXIT_REGRESSION = 3


def _emit_telemetry(out_dir: str, rows, rep) -> None:
    """Mirror of costs.harvest_cli's producer shape: enable -> points ->
    registry snapshot -> disable. One `ledger_row` point per canonical
    row; the registry carries the census the checker's --require gates."""
    from ..telemetry import disable, enable, get_registry, get_tracer
    enable(out_dir, process_index=0)
    try:
        tracer = get_tracer()
        reg = get_registry()
        for row in rows:
            tracer.point("ledger_row", series=row["series"],
                         metric=row["metric"], value=row["value"],
                         direction=row["direction"],
                         run_ord=row["run_ord"], source=row["source"])
        reg.counter("ledger.rows").inc(len(rows))
        reg.gauge("ledger.series").set(float(rep["n_series"]))
        reg.gauge("ledger.regressions").set(float(len(rep["regressions"])))
        tracer.snapshot(reg)
    finally:
        disable()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_ddp_mnist_tpu_torch ledger",
        description="performance ledger: every committed artifact as one "
                    "direction-aware metric history with trend gates")
    p.add_argument("command", choices=("ingest", "report", "gate"),
                   help="ingest: parse + census; report: trajectory "
                        "table; gate: trend regression gate (exit 3)")
    p.add_argument("dir", nargs="?", default=".",
                   help="artifact directory (default: current directory)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output instead of the table")
    p.add_argument("--markdown", action="store_true",
                   help="force the markdown table (report's default)")
    p.add_argument("--window", type=int, default=DEFAULT_WINDOW,
                   help="history runs the median+MAD band is computed "
                        "over (default %(default)s)")
    p.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD,
                   help="direction-aware worse-ratio past which the "
                        "newest point regresses (default %(default)s)")
    p.add_argument("--telemetry", metavar="DIR",
                   help="emit ledger_row points + registry snapshot as a "
                        "schema-v1 JSONL trace under DIR")
    a = p.parse_args(argv)
    if a.json and a.markdown:
        print("ledger: --json and --markdown are mutually exclusive",
              file=sys.stderr)
        return EXIT_USAGE

    paths = discover(a.dir)
    if not paths:
        print(f"ledger: no artifacts under {a.dir} (looked for "
              f"BENCH_r*/MULTICHIP_r*/COST_r*/SERVE_r*/INPUT_r*/"
              f"bench_matrix_r*.json)", file=sys.stderr)
        return EXIT_EMPTY
    try:
        ing = ingest(paths)
    except LedgerError as e:
        print(f"ledger: {e}", file=sys.stderr)
        return EXIT_EMPTY
    rows = ing["rows"]
    rep = gate(rows, window=a.window, threshold=a.threshold)
    if a.telemetry:
        _emit_telemetry(a.telemetry, rows, rep)

    if a.command == "ingest":
        if a.json:
            json.dump(ing, sys.stdout, indent=2)
            print()
        else:
            print(f"ledger: {ing['artifacts']} artifact(s) -> "
                  f"{len(rows)} row(s) in {rep['n_series']} series "
                  f"across {len(rep['families'])} families "
                  f"({', '.join(rep['families'])}); "
                  f"{len(ing['skipped'])} skip(s)")
            for s in ing["skipped"]:
                print(f"  skipped {s['source']}: {s['reason']}")
        return EXIT_OK

    if a.command == "report":
        if a.json:
            json.dump(rep, sys.stdout, indent=2)
            print()
        else:
            print(render_markdown(rep))
        return EXIT_OK

    # gate
    if a.json:
        json.dump(rep, sys.stdout, indent=2)
        print()
    if not rows:
        print("ledger gate: artifacts present but no gateable rows",
              file=sys.stderr)
        return EXIT_EMPTY
    if rep["failures"]:
        for line in rep["failures"]:
            print(f"ledger gate: REGRESSION {line}", file=sys.stderr)
        print(f"ledger gate: {len(rep['failures'])} series regressed "
              f"(of {rep['n_series']} checked)", file=sys.stderr)
        return EXIT_REGRESSION
    if not a.json:
        print(f"ledger gate: OK — {rep['n_series']} series checked "
              f"(window {a.window}, threshold {a.threshold:g}), "
              f"0 regressions")
    return EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
