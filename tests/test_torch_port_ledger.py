"""The port's performance ledger (telemetry/ledger.py, cli/ledger.py, the
bench's stamps) held against the JAX package's, on the CPU:

  * both ledgers read the repo's committed artifacts (as data) to equal
    rows, skips, reports, markdown and gate verdicts, and name the same
    generations;
  * an injected MULTICHIP run with its throughput halved gates (exit 3,
    the series named) and a future `schema_version` is refused by name,
    the same in both CLIs, text for text;
  * a port bench line with its registry and ledger stamps, and a port
    `--mode ddp` line, are read by the JAX ledger into the rows the port's
    ledger reads (the same generation, the same series).
"""

import contextlib
import copy
import io
import json
import pathlib
import shutil

import pytest
import torch

from pytorch_ddp_mnist_tpu.cli import ledger as jax_ledger_cli
from pytorch_ddp_mnist_tpu.telemetry import ledger as jax_ledger
from pytorch_ddp_mnist_tpu_torch import bench
from pytorch_ddp_mnist_tpu_torch.cli import ledger as port_ledger_cli
from pytorch_ddp_mnist_tpu_torch.telemetry import ledger

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def test_the_committed_artifacts_read_the_same_in_both_ledgers():
    paths = ledger.discover(str(REPO))
    assert paths == jax_ledger.discover(str(REPO)) and len(paths) > 10
    ours, theirs = ledger.ingest(paths), jax_ledger.ingest(paths)
    assert ours == theirs and ours["rows"]
    for path in paths:
        doc = json.loads(pathlib.Path(path).read_text())
        assert ledger.detect_generation(doc, path) == \
            jax_ledger.detect_generation(doc, path)
    for window, threshold in ((5, 1.5), (2, 1.1)):
        rep = ledger.gate(ours["rows"], window=window, threshold=threshold)
        assert rep == jax_ledger.gate(theirs["rows"], window=window,
                                      threshold=threshold)
        assert ledger.render_markdown(rep) == jax_ledger.render_markdown(rep)
    assert ledger.SCHEMA_VERSION == jax_ledger.SCHEMA_VERSION == 2
    assert ledger.metric_directions() == jax_ledger.metric_directions()


@pytest.fixture
def history(tmp_path):
    """A directory of the committed MULTICHIP strategy artifacts."""
    for name in ("MULTICHIP_r06.json", "MULTICHIP_r07.json",
                 "MULTICHIP_r08.json"):
        shutil.copy(REPO / name, tmp_path / name)
    return tmp_path


def _halved(src: pathlib.Path, dst: pathlib.Path, **extra) -> None:
    doc = json.loads(src.read_text())
    doc.pop("run_ord", None)
    for row in doc["strategies"]:
        for key in ("images_per_sec", "per_chip_images_per_sec"):
            row[key] = row[key] / 2
    doc.update(extra)
    dst.write_text(json.dumps(doc))


@pytest.mark.parametrize("case", ["healthy", "halved", "future", "empty"])
@pytest.mark.parametrize("verb", ["gate", "report"])
def test_the_ledger_cli_exits_as_the_jax_cli(history, tmp_path, case, verb):
    target = history
    if case == "halved":
        _halved(history / "MULTICHIP_r08.json",
                history / "MULTICHIP_r09.json")
    elif case == "future":
        _halved(history / "MULTICHIP_r08.json",
                history / "MULTICHIP_r09.json", schema_version=3)
    elif case == "empty":
        target = tmp_path / "nothing"
        target.mkdir()
    argv = [verb, str(target)]
    ours, theirs = _run(port_ledger_cli.main, argv), \
        _run(jax_ledger_cli.main, argv)
    assert ours == theirs
    want = {"healthy": 0, "halved": 3 if verb == "gate" else 0,
            "future": 1, "empty": 1}[case]
    assert ours[0] == want
    if case == "halved" and verb == "gate":
        assert "ddp.images_per_sec/" in ours[2] and "r09" in ours[2]
    if case == "future":
        assert "schema_version 3 is newer" in ours[2]


def test_ledger_telemetry_rows_are_the_jax_clis(history, tmp_path):
    outs = []
    for tag, main in (("port", port_ledger_cli.main),
                      ("jax", jax_ledger_cli.main)):
        tel = tmp_path / tag
        assert _run(main, ["report", str(history), "--json", "--telemetry",
                           str(tel)])[0] == 0
        recs = [json.loads(ln) for ln in
                (tel / "events.jsonl").read_text().splitlines()]
        outs.append([r["attrs"] for r in recs
                     if r.get("name") == "ledger_row"])
    assert outs[0] == outs[1] and outs[0]


@pytest.fixture(scope="module")
def port_lines():
    """A port train bench line and two `--mode ddp` lines, stamped as
    bench.main stamps them (measured on the CPU: plumbing, not numbers)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        stamp = {"backend": "cpu", "device": "cpu"}
        train = {**bench.run_train_bench(CPU, epochs=1, batch_size=64,
                                         kernel="xla", impl="threefry2x32",
                                         n_train=256, windows=1),
                 **stamp, "kernel": "xla", **bench.registry_stamp()}
        rows = bench.run_ddp_rows(CPU, strategies=("pmean", "int8"),
                                  replicas=2, per_replica_batch=16, epochs=1,
                                  n_rows=64, windows=1)
        ddp = bench.ddp_lines(rows, {**stamp, **bench.registry_stamp()})
    finally:
        torch.set_num_threads(before)
    return train, ddp


def test_the_bench_stamps_are_the_jax_benchs(port_lines):
    train, ddp = port_lines
    for line in [train] + ddp:
        assert line["schema_version"] == 2
        assert isinstance(line["run_ord"], int)
        assert isinstance(line["health_summary"], dict)
        for key in ("xla_compiles", "host_rss_mb", "peak_hbm_bytes",
                    "compile_s_total"):
            assert key in line
        assert "statics" not in line
    for line in ddp:
        assert line["n_devices"] == line["replicas"] == 2
        assert line["per_chip_batch"] == line["per_replica_batch"] == 16
        assert line["scaling_efficiency_vs_1dev"] == line["vs_one_replica"]
        assert line["bytes_on_wire_per_step_per_device"] == \
            line["bytes_on_wire_per_step_per_replica"]


@pytest.mark.parametrize("shape", ["bare", "multichip"])
def test_the_jax_ledger_reads_port_lines_into_the_same_rows(
        port_lines, tmp_path, shape):
    train, ddp = port_lines
    if shape == "bare":
        docs = {"BENCH_r01.json": train, "MULTICHIP_r01.json": ddp[0]}
    else:
        docs = {"MULTICHIP_r01.json": {
            "n_devices": 2, "backend": "cpu", "model": "mlp",
            "param_scale": 1, "strategies": copy.deepcopy(ddp),
            "schema_version": 2, "run_ord": 1}}
    for name, doc in docs.items():
        (tmp_path / name).write_text(json.dumps(doc))
        assert ledger.detect_generation(doc, name) == \
            jax_ledger.detect_generation(doc, name)
    paths = ledger.discover(str(tmp_path))
    ours, theirs = ledger.ingest(paths), jax_ledger.ingest(paths)
    assert ours == theirs and ours["rows"] and not ours["skipped"]
    series = {r["series"] for r in ours["rows"]}
    if shape == "bare":
        assert "bench.ddp_train_images_per_sec_per_chip/mlp x1/2dev/b16/cpu" \
            in series
    else:
        assert "ddp.scaling_efficiency_vs_1dev/int8/mlp x1/2dev/b16/cpu" \
            in series
