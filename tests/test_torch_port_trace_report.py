"""The port's trace read side (telemetry/analysis.py, cli/trace.py report)
held against the JAX package's on the same files, on the CPU:

  * traces the port's trainer writes (`--telemetry --profile_dispatch`, 2
    epochs of 4 steps), a port `serve --selftest` trace, the synthetic
    traces the JAX tests fabricate (written by the port's EventTrace: two
    processes, data_wait shares, dispatch phases) and their regressed
    copies go through both packages' `analyze`, `serve_report`,
    `data_report`, `overhead_report`, the `compare_*` gates and the
    `format_*` texts: the reports are equal as dicts and the texts equal;
  * `efficiency_report` / `overhead_from_artifact` on the committed
    MULTICHIP artifacts, and `cluster_report` on 2-rank journals the
    port's writer makes (clean, desynced, one rank stuck): equal;
  * `trace report` exits 0/1/2/3 in both CLIs on the same cases, with the
    same text.
"""

import contextlib
import io
import json
import os
import pathlib
import time

import pytest
import torch

from pytorch_ddp_mnist_tpu.cli import trace as jax_trace_cli
from pytorch_ddp_mnist_tpu.data.idx import write_idx
from pytorch_ddp_mnist_tpu.telemetry import analysis as jax_analysis
from pytorch_ddp_mnist_tpu.telemetry import cluster as jax_cluster
from pytorch_ddp_mnist_tpu_torch import telemetry
from pytorch_ddp_mnist_tpu_torch.cli import serve as port_serve_cli
from pytorch_ddp_mnist_tpu_torch.cli import trace as port_trace_cli
from pytorch_ddp_mnist_tpu_torch.cli import train as port_train_cli
from pytorch_ddp_mnist_tpu_torch.data.mnist import synthetic_mnist
from pytorch_ddp_mnist_tpu_torch.telemetry import analysis, cluster

REPO = pathlib.Path(__file__).resolve().parents[1]
SCHED = [{"kind": "allreduce", "dtype": "float32", "axis": "dp",
          "elems": 10, "bytes": 100, "bucket": 0}]


def _emit_run(path, proc, step_durs, *, data_wait=0.002, eval_s=0.004):
    """The JAX tests' fabricated trace, written by the port's EventTrace:
    one epoch span an entry of `step_durs` with aggregate children."""
    tr = telemetry.EventTrace(str(path), process_index=proc)
    for epoch, dur in enumerate(step_durs):
        with tr.span("epoch", epoch=epoch):
            tr.complete_span("data_wait", data_wait, batches=2)
            tr.complete_span("step_compute", dur, steps=2)
            tr.complete_span("eval", eval_s)
    reg = telemetry.MetricsRegistry()
    reg.counter("xla.compiles").inc(3)
    reg.gauge("host.rss_bytes").set(1 << 20)
    tr.snapshot(reg)
    tr.close()


def _emit_data(path, shares, epoch_s=0.1):
    tr = telemetry.EventTrace(str(path), process_index=0)
    for e, share in enumerate(shares):
        t0 = time.perf_counter() - epoch_s - 0.01
        w0 = time.time() - epoch_s - 0.01
        pid = tr.emit_span("epoch", t0_mono=t0, t0_wall=w0, dur_s=epoch_s,
                           attrs={"epoch": e})
        tr.emit_span("data_wait", t0_mono=t0, t0_wall=w0,
                     dur_s=share * epoch_s, parent=pid, attrs={"batches": 4})
    tr.close()


def _emit_dispatch(path, dispatch_s=0.6, window_s=0.7, sync_s=0.03):
    tr = telemetry.EventTrace(str(path), process_index=0)
    prestep_s = 0.01
    for phase, total in (("python_prestep", prestep_s),
                         ("dispatch", dispatch_s),
                         ("device_idle", 0.55), ("sync_wait", sync_s)):
        tr.point("dispatch_phase", phase=phase, total_s=total, n=8,
                 epoch=0, step=8)
    tr.point("dispatch_window", window_s=window_s,
             attributed_s=prestep_s + dispatch_s + sync_s, coverage=1.0,
             epoch=0, steps=8)
    tr.close()


def _journal(d, rank, *, steps, kinds=None, open_kind=None):
    j = cluster.CollectiveJournal(cluster.journal_path(d, rank), rank=rank,
                                  world=2, registry=telemetry.MetricsRegistry())
    sched = SCHED if kinds is None else [
        {**SCHED[0], "kind": k, "bytes": b} for k, b in kinds]
    j.bind_program("pmean", False, sched)
    for i in range(steps):
        j.record_step(i, 0.0 + i, 0.001 + i + 0.002 * rank, 1000.0 + i)
    if open_kind is not None:
        j.enter(open_kind)
    j.close(clean=open_kind is None)


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """{name: directory} of every trace the tests read."""
    root = tmp_path_factory.mktemp("traces")
    out = {}
    idx = root / "idx"
    idx.mkdir()
    for prefix, n, seed in (("train", 256, 4), ("t10k", 64, 5)):
        split = synthetic_mnist(n, seed)
        write_idx(str(idx / f"{prefix}-images-idx3-ubyte"), split.images)
        write_idx(str(idx / f"{prefix}-labels-idx1-ubyte"), split.labels)
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            port_train_cli.train([
                "--device", "cpu", "--epochs", "2", "--limit", "256",
                "--batch_size", "64", "--path", str(idx), "--checkpoint", "",
                "--telemetry", str(root / "train"), "--profile_dispatch",
                "2"])
            assert port_serve_cli.main([
                "--selftest", "60", "--telemetry", str(root / "serve"),
                "--device", "cpu", "--max_batch", "16", "--offered_rps",
                "4000"]) == 0
    finally:
        torch.set_num_threads(before)
    out["train"] = str(root / "train")
    out["serve"] = str(root / "serve")
    for name, scale in (("two_proc", 1.0), ("slow", 2.0)):
        d = root / name
        d.mkdir()
        _emit_run(d / "events.jsonl", 0, [0.05 * scale, 0.052 * scale])
        _emit_run(d / "events.rank1.jsonl", 1, [0.06 * scale, 0.07 * scale])
        out[name] = str(d)
    for name, shares in (("data", [0.2, 0.4, 0.8]), ("data_slow",
                                                     [0.6, 0.8, 0.9])):
        (root / name).mkdir()
        _emit_data(root / name / "events.jsonl", shares)
        out[name] = str(root / name)
    for name, kw in (("dispatch", {}),
                     ("dispatch_slow", {"sync_s": 0.3, "window_s": 0.95}),
                     ("dispatch_low", {"window_s": 3.0})):
        (root / name).mkdir()
        _emit_dispatch(root / name / "events.jsonl", **kw)
        out[name] = str(root / name)
    for name, kw1 in (("world", {}),
                      ("desync", {"kinds": [("allgather", 100)]}),
                      ("stuck", {"steps": 2, "open_kind": "allreduce"})):
        d = str(root / name)
        os.makedirs(d)
        _journal(d, 0, steps=4)
        _journal(d, 1, **{"steps": 4, **kw1})
        out[name] = d
    (root / "empty").mkdir()
    out["empty"] = str(root / "empty")
    return out


def _files(d):
    return analysis.trace_files(d)


@pytest.mark.parametrize("name", ["train", "two_proc", "serve"])
def test_analyze_and_its_text_are_the_jax_packages(traces, name):
    paths = _files(traces[name])
    assert paths == jax_analysis.trace_files(traces[name])
    ours, theirs = analysis.analyze(paths), jax_analysis.analyze(paths)
    assert ours == theirs
    assert analysis.format_report(ours) == jax_analysis.format_report(theirs)
    if name == "train":
        assert ours["records"] > 0 and ours["phases"]["step_compute"]


def test_the_step_time_gate_is_the_jax_packages(traces):
    new = analysis.analyze(_files(traces["slow"]))
    old = analysis.analyze(_files(traces["two_proc"]))
    diff = analysis.compare(new, old, threshold=1.5)
    assert diff == jax_analysis.compare(new, old, threshold=1.5)
    assert diff["regressions"]
    assert analysis.format_compare(diff) == jax_analysis.format_compare(diff)


def test_the_serve_report_and_gate_are_the_jax_packages(traces):
    paths = _files(traces["serve"])
    ours, theirs = analysis.serve_report(paths), \
        jax_analysis.serve_report(paths)
    assert ours == theirs and ours["requests"] > 0
    assert analysis.format_serve_report(ours) == \
        jax_analysis.format_serve_report(theirs)
    diff = analysis.compare_serve(ours, ours)
    assert diff == jax_analysis.compare_serve(theirs, theirs)
    assert analysis.format_compare_serve(diff) == \
        jax_analysis.format_compare_serve(diff)


@pytest.mark.parametrize("name", ["train", "data"])
def test_the_data_report_and_gate_are_the_jax_packages(traces, name):
    paths = _files(traces[name])
    ours = analysis.data_report(paths)
    assert ours == jax_analysis.data_report(paths) and ours["epochs"] > 0
    assert analysis.format_data_report(ours) == \
        jax_analysis.format_data_report(ours)
    slow = analysis.data_report(_files(traces["data_slow"]))
    diff = analysis.compare_data(slow, ours)
    assert diff == jax_analysis.compare_data(slow, ours)
    assert analysis.format_compare_data(diff) == \
        jax_analysis.format_compare_data(diff)


@pytest.mark.parametrize("name", ["train", "dispatch", "dispatch_low"])
def test_the_overhead_report_and_gate_are_the_jax_packages(traces, name):
    paths = _files(traces[name])
    ours = analysis.overhead_report(paths)
    assert ours == jax_analysis.overhead_report(paths) and ours["rows"]
    assert analysis.format_overhead_report(ours) == \
        jax_analysis.format_overhead_report(ours)
    slow = analysis.overhead_report(_files(traces["dispatch_slow"]))
    diff = analysis.compare_overhead(slow, ours)
    assert diff == jax_analysis.compare_overhead(slow, ours)
    assert analysis.format_compare_overhead(diff) == \
        jax_analysis.format_compare_overhead(diff)
    assert analysis.OVERHEAD_COVERAGE_MIN == \
        jax_analysis.OVERHEAD_COVERAGE_MIN == 0.90


@pytest.mark.parametrize("new,old", [("MULTICHIP_r08.json",
                                      "MULTICHIP_r07.json"),
                                     ("MULTICHIP_r07.json",
                                      "MULTICHIP_r06.json")])
def test_the_artifact_reports_are_the_jax_packages(new, old):
    docs = [json.loads((REPO / p).read_text()) for p in (new, old)]
    reps = [analysis.efficiency_report(d, path=p)
            for d, p in zip(docs, (new, old))]
    assert reps == [jax_analysis.efficiency_report(d, path=p)
                    for d, p in zip(docs, (new, old))]
    diff = analysis.compare(*reps)
    assert diff == jax_analysis.compare(*reps)
    assert analysis.format_compare(diff) == jax_analysis.format_compare(diff)
    over = analysis.overhead_from_artifact(docs[0], path=new)
    assert over == jax_analysis.overhead_from_artifact(docs[0], path=new)


@pytest.mark.parametrize("name", ["world", "desync", "stuck"])
def test_the_cluster_report_is_the_jax_packages(traces, name):
    ours = cluster.cluster_report(traces[name])
    assert ours == jax_cluster.cluster_report(traces[name])
    assert (name == "desync") == (not ours["desync"]["ok"])
    assert (name == "stuck") == (ours["hang"]["stuck"] is not None)


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue()


CLI_CASES = [
    (["{train}"], 0),
    (["{train}", "--baseline", "{train}"], 0),
    (["{slow}", "--baseline", "{two_proc}"], 3),
    (["{empty}"], 1),
    (["--serve", "{serve}", "--baseline", "{serve}"], 0),
    (["--data", "{data_slow}", "--baseline", "{data}"], 3),
    (["--overhead", "{train}"], 0),
    (["--overhead", "{dispatch_low}"], 1),
    (["--overhead", "{dispatch_slow}", "--baseline", "{dispatch}"], 3),
    (["--cluster", "{world}"], 0),
    (["--cluster", "{desync}"], 3),
    (["--cluster", "{empty}"], 1),
    (["--cost", "{repo}/COST_r01.json", "--baseline",
      "{repo}/COST_r01.json"], 0),
    (["{repo}/MULTICHIP_r08.json", "--baseline",
      "{repo}/MULTICHIP_r07.json"], None),
    (["--serve", "--data", "{train}"], 2),
    (["{train}", "--threshold", "0"], 2),
    (["--cluster", "{world}", "--baseline", "{world}"], 2),
]


@pytest.mark.parametrize("argv,rc", CLI_CASES,
                         ids=[" ".join(c[0]) for c in CLI_CASES])
def test_trace_report_exits_as_the_jax_cli(traces, argv, rc):
    argv = ["report"] + [a.format(repo=REPO, **traces) for a in argv]
    ours, theirs = _run(port_trace_cli.main, argv), \
        _run(jax_trace_cli.main, argv)
    assert ours == theirs
    if rc is not None:
        assert ours[0] == rc
