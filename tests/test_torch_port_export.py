"""The port's Chrome/Perfetto export (telemetry/export.py, `trace export`)
held against the JAX package's on the same inputs, on the CPU: the port's
trainer trace (`--telemetry --profile_dispatch`, its mem_watermark
counters and dispatch lanes), the fabricated two-process trace, 2-rank
journals the port's writer makes (collective tracks, cross-rank flow
arrows, an open entry), and the committed artifacts' ledger series (one
counter track a series) give equal event lists; `trace export` exits and
writes as the JAX CLI does."""

import contextlib
import io
import json
import os
import pathlib
import sys

import pytest
import torch

from pytorch_ddp_mnist_tpu.cli import trace as jax_trace_cli
from pytorch_ddp_mnist_tpu.telemetry import export as jax_export
from pytorch_ddp_mnist_tpu.telemetry import ledger as jax_ledger
from pytorch_ddp_mnist_tpu_torch.cli import trace as port_trace_cli
from pytorch_ddp_mnist_tpu_torch.cli import train as port_train_cli
from pytorch_ddp_mnist_tpu_torch.data.mnist import synthetic_mnist
from pytorch_ddp_mnist_tpu_torch.telemetry import (analysis, cluster, export,
                                                   ledger)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_trace_report import (_emit_dispatch, _emit_run,  # noqa: E402
                                          _journal)

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    from pytorch_ddp_mnist_tpu.data.idx import write_idx
    root = tmp_path_factory.mktemp("export")
    idx = root / "idx"
    idx.mkdir()
    for prefix, n, seed in (("train", 128, 4), ("t10k", 64, 5)):
        split = synthetic_mnist(n, seed)
        write_idx(str(idx / f"{prefix}-images-idx3-ubyte"), split.images)
        write_idx(str(idx / f"{prefix}-labels-idx1-ubyte"), split.labels)
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            port_train_cli.train([
                "--device", "cpu", "--epochs", "2", "--limit", "128",
                "--batch_size", "32", "--path", str(idx), "--checkpoint", "",
                "--telemetry", str(root / "train"), "--profile_dispatch",
                "2"])
    finally:
        torch.set_num_threads(before)
    world = root / "world"
    world.mkdir()
    _emit_run(world / "events.jsonl", 0, [0.05, 0.06])
    _emit_run(world / "events.rank1.jsonl", 1, [0.07, 0.08])
    _emit_dispatch(world / "events.dispatch.jsonl")
    _journal(str(world), 0, steps=4)
    _journal(str(world), 1, steps=3, open_kind="allreduce")
    return {"train": str(root / "train"), "world": str(world),
            "root": str(root)}


def _series(module):
    return module.histories(module.ingest(module.discover(str(REPO)))["rows"])


def _both(paths, journals=None, series=None):
    ours = export.chrome_trace(paths, journal_paths=journals,
                               ledger_series=series)
    theirs = jax_export.chrome_trace(paths, journal_paths=journals,
                                     ledger_series=series)
    assert ours["traceEvents"] == theirs["traceEvents"]
    return ours["traceEvents"]


def test_a_trainer_trace_exports_as_the_jax_package(dirs):
    events = _both(analysis.trace_files(dirs["train"]))
    names = {e.get("name") for e in events}
    assert "epoch" in names and "mem.host_rss_bytes" in names
    assert {"dispatch", "sync_wait"} & names


def test_journals_export_collective_tracks_and_arrows(dirs):
    paths = analysis.trace_files(dirs["world"])
    journals = cluster.journal_files(dirs["world"])
    assert len(journals) == 2
    events = _both(paths, journals)
    coll = [e for e in events if e.get("cat") == "collective"]
    flows = [e for e in events if e.get("cat") == "collective_flow"]
    assert {e["pid"] for e in coll} == {0, 1}
    assert flows and any(e["args"].get("open") for e in coll)
    assert export.COLLECTIVE_ARROW_CAP == jax_export.COLLECTIVE_ARROW_CAP
    alone = _both([], journals)
    assert [e for e in alone if e.get("cat") == "collective"] and len(
        [e for e in alone if e.get("cat") == "collective_flow"]) == len(flows)


def test_ledger_series_export_one_counter_track_a_series(dirs):
    series = _series(ledger)
    assert series == _series(jax_ledger)
    events = _both([], series=series)
    tracks = {e["name"] for e in events if e.get("ph") == "C"}
    assert tracks == set(series)
    assert {e["pid"] for e in events} == {export.LEDGER_PID}
    both = _both(analysis.trace_files(dirs["world"]),
                 cluster.journal_files(dirs["world"]), series)
    assert len(both) > len(events)


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("case", ["world", "ledger", "empty", "usage"])
def test_trace_export_exits_and_writes_as_the_jax_cli(dirs, case):
    root = dirs["root"]
    target = {"world": dirs["world"], "ledger": os.path.join(root, "none"),
              "empty": os.path.join(root, "none"), "usage": None}[case]
    outs = []
    for tag, main in (("port", port_trace_cli.main),
                      ("jax", jax_trace_cli.main)):
        out = os.path.join(root, f"{case}.{tag}.json")
        argv = (["export", target, "-o", out] if target else
                ["export", "-o", out, "--bogus"])
        if case == "ledger":
            argv += ["--ledger", str(REPO)]
        rc, text, _ = _run(main, argv)
        outs.append((rc, text.replace(out, "OUT"),
                     json.load(open(out))["traceEvents"]
                     if os.path.exists(out) else None))
    assert outs[0] == outs[1]
    assert outs[0][0] == {"world": 0, "ledger": 0, "empty": 1,
                          "usage": 2}[case]
