"""The per-rank collective journal in the port (`--journal`;
telemetry/cluster.py), held against the JAX package on the CPU:

  * journals the port writes are read by the JAX `load_journal` /
    `cluster_report` to the same reports as by the port's own read side,
    and the other way round: round trips, appended segments, desync at a
    seq and by position, a crashed rank's hang story, the skew report;
  * the wireup's barrier is journal-bracketed, and an injected
    `collective_timeout` leaves its enter open; the collective watchdog
    fires once and flips the `/healthz` verdict; the startup barrier's
    timeout exits with the JAX CLI's named hang report;
  * a journaled `fit` of the DP step records the step's schedule (the
    JAX package's `collective_schedule`) a step, brackets the epoch's
    fetch as a `flush`, and trains bitwise the unjournaled fit; a step
    with no schedule is refused with the JAX loop's words;
  * a 2-rank gloo world `--parallel --kernel xla --journal` trains
    bitwise its unjournaled twin, and the JAX `cluster_report` reads its
    two journals with no desync, no hang, seq 0 the startup barrier on
    both ranks (a 90 s limit a world);
  * the five refusals of `--journal` are the JAX CLI's, word for word.
"""

import ast
import os
import pathlib
import time

import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu.cli import train as jax_cli
from pytorch_ddp_mnist_tpu.parallel import collectives as jax_collectives
from pytorch_ddp_mnist_tpu.telemetry import MetricsRegistry as JaxRegistry
from pytorch_ddp_mnist_tpu.telemetry import cluster as jax_cluster
from pytorch_ddp_mnist_tpu_torch import chaos, telemetry
from pytorch_ddp_mnist_tpu_torch.cli import train as port_cli
from pytorch_ddp_mnist_tpu_torch.data.loader import BatchLoader
from pytorch_ddp_mnist_tpu_torch.data.mnist import (normalize_images,
                                                    synthetic_mnist)
from pytorch_ddp_mnist_tpu_torch.models.mlp import MLP
from pytorch_ddp_mnist_tpu_torch.ops.threefry import key_data
from pytorch_ddp_mnist_tpu_torch.parallel import collectives, ddp
from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler
from pytorch_ddp_mnist_tpu_torch.parallel.wireup import Runtime
from pytorch_ddp_mnist_tpu_torch.telemetry import cluster, flight, health
from pytorch_ddp_mnist_tpu_torch.train import loop
from pytorch_ddp_mnist_tpu_torch.train.config import configure
from pytorch_ddp_mnist_tpu_torch.utils import faultpoints

REPO = pathlib.Path(__file__).resolve().parents[1]
LIMIT_S = 90
SCHED = [{"kind": "allreduce", "dtype": "float32", "axis": "dp",
          "elems": 10, "bytes": 100, "bucket": 0}]


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    monkeypatch.delenv(faultpoints.FAULT_ENV, raising=False)
    faultpoints.install()
    yield
    faultpoints.install()
    cluster.disable_journal(clean=False)


def _write(d, rank, *, steps, kinds=None, close=True, open_kind=None,
           t0=1000.0, module=cluster, registry=None):
    reg = registry if registry is not None else (
        telemetry.MetricsRegistry() if module is cluster else JaxRegistry())
    j = module.CollectiveJournal(module.journal_path(d, rank), rank=rank,
                                 world=2, registry=reg)
    sched = SCHED if kinds is None else [
        {**SCHED[0], "kind": k, "bytes": b} for k, b in kinds]
    j.bind_program("pmean", False, sched)
    for i in range(steps):
        j.record_step(i, 0.0 + i, 0.001 + i, t0 + i)
    if open_kind is not None:
        j.enter(open_kind)
    j.close(clean=close and open_kind is None)
    return reg


def _same_reports(d):
    ours, theirs = cluster.cluster_report(d), jax_cluster.cluster_report(d)
    assert ours == theirs
    assert cluster.format_cluster_report(ours) == \
        jax_cluster.format_cluster_report(theirs)
    return ours


def _params():
    return MLP.from_seed(0).params()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_round_trip_reads_the_same_in_both_packages(tmp_path, writer):
    d = str(tmp_path)
    module = cluster if writer == "port" else jax_cluster
    sched = collectives.collective_schedule(_params(), 8, "pmean")
    reg = (telemetry.MetricsRegistry() if writer == "port"
           else JaxRegistry())
    j = module.CollectiveJournal(module.journal_path(d, 0), rank=0, world=2,
                                 registry=reg)
    j.bind_program("pmean", False, sched)
    for i in range(3):
        j.record_step(i, 0.0 + i, 0.001 + i, 1000.0 + i)
    j.close()
    for reader in (cluster, jax_cluster):
        loaded = reader.load_journal(reader.journal_path(d, 0))
        assert loaded["closed"] and not loaded["open"]
        assert not loaded["errors"]
        assert [r["seq"] for r in loaded["records"]] == list(
            range(3 * len(sched)))
    snap = reg.snapshot()
    assert snap["counters"]["cluster.collectives"] == 3 * len(sched)
    assert snap["counters"]["cluster.bytes_on_wire"] == 3 * \
        collectives.bytes_on_wire(_params(), 8, "pmean")
    _same_reports(d)


def test_the_schedule_is_the_jax_packages():
    jparams = {n: {k: v.detach().numpy() for k, v in layer.items()}
               for n, layer in _params().items()}
    for comm in ("pmean", "sharded", "bf16", "int8"):
        for n in (1, 2, 8):
            assert collectives.collective_schedule(_params(), n, comm) == \
                jax_collectives.collective_schedule(jparams, n, comm)


@pytest.mark.parametrize("case", ["desync", "position", "crash",
                                  "appended", "skew"])
def test_the_read_side_reports_as_the_jax_one(tmp_path, case):
    d = str(tmp_path)
    if case == "desync":
        _write(d, 0, steps=1, kinds=[("allreduce", 100)])
        _write(d, 1, steps=1, kinds=[("reduce_scatter", 50)])
    elif case == "position":
        _write(d, 0, steps=2)
        _write(d, 1, steps=3)
    elif case == "crash":
        _write(d, 0, steps=3, close=False)
        _write(d, 1, steps=3, close=False, open_kind="flush")
    elif case == "appended":
        _write(d, 0, steps=2, close=False, open_kind="flush")
        _write(d, 0, steps=3, module=jax_cluster)
    else:
        _write(d, 0, steps=3)
        j = cluster.CollectiveJournal(cluster.journal_path(d, 1), rank=1,
                                      world=2,
                                      registry=telemetry.MetricsRegistry())
        j.bind_program("pmean", False, SCHED)
        for i, late in enumerate((0.05, 0.05, 0.2)):
            j.record_step(i, 0.0 + i, 0.001 + i, 1000.0 + i + late)
        j.close()
    rep = _same_reports(d)
    if case in ("desync", "position"):
        assert not rep["desync"]["ok"]
    elif case == "crash":
        assert rep["desync"]["ok"] and rep["hang"]["stuck"]["rank"] == 1
    elif case == "appended":
        assert rep["hang"]["stuck"] is None and rep["multi_segment_ranks"] \
            == [0]
    else:
        assert rep["skew"]["worst"]["seq"] == 2


def test_the_barrier_is_bracketed_and_a_timeout_leaves_it_open(tmp_path):
    cluster.enable_journal(str(tmp_path), rank=0, world=1, watchdog=False,
                           registry=telemetry.MetricsRegistry())
    Runtime(method="single").barrier()
    faultpoints.install("collective_timeout")
    with pytest.raises(RuntimeError, match="DEADLINE_EXCEEDED"):
        Runtime(method="single").barrier()
    assert cluster.get_journal().open_entry()["kind"] == "barrier"
    cluster.disable_journal(clean=False)
    for reader in (cluster, jax_cluster):
        loaded = reader.load_journal(reader.journal_path(str(tmp_path), 0))
        assert [r["k"] for r in loaded["records"]] == ["barrier"]
        assert loaded["open"][0]["kind"] == "barrier"
        assert not loaded["closed"]


def test_the_watchdog_fires_once_and_flips_healthz(tmp_path):
    reg = telemetry.MetricsRegistry()
    j = cluster.CollectiveJournal(cluster.journal_path(str(tmp_path), 0),
                                  rank=0, world=1, registry=reg)
    wd = cluster.CollectiveWatchdog(j, timeout_s=0.05, registry=reg,
                                    poll_s=0.01)
    wd.start()
    j.enter("barrier")
    deadline = time.monotonic() + 5.0
    while (reg.snapshot()["counters"].get("cluster.hangs", 0) == 0
           and time.monotonic() < deadline):
        time.sleep(0.02)
    time.sleep(0.1)
    wd.stop()
    snap = reg.snapshot()
    assert snap["counters"]["cluster.hangs"] == 1
    assert snap["gauges"]["health.worst_severity_level"] == 2
    assert health.health_summary(reg)["worst_severity"] == "fatal"
    hangs = [e for e in flight.get_flight_recorder().snapshot()
             if e["kind"] == "collective_hang"]
    assert hangs[-1]["who_is_where"][0]["open"]["kind"] == "barrier"
    j.close(clean=False)


def test_a_startup_barrier_timeout_exits_with_the_hang_report(tmp_path):
    tel = str(tmp_path / "tel")
    flight.set_dump_dir(tel)
    faultpoints.install("collective_timeout")
    try:
        with pytest.raises(SystemExit) as e:
            port_cli._open_journal({"telemetry": tel},
                                   Runtime(method="single"))
    finally:
        flight.set_dump_dir(None)
    msg = str(e.value.code)
    assert msg.startswith("[cluster] collective timeout in the startup "
                          "barrier (seq 0): ")
    assert msg.endswith(f"— hang report in the flight dump under {tel}; "
                        f"read it with `trace report --cluster {tel}`")
    rep = jax_cluster.cluster_report(tel)
    assert rep["hang"]["stuck"]["seq"] == 0
    assert rep["hang"]["stuck"]["kind"] == "barrier"
    assert any(f["kind"] == "collective_hang" for f in rep["faults"])


def _dp_fit(journal=None):
    split = synthetic_mnist(256, seed=0)
    test = synthetic_mnist(32, seed=1)
    mesh = ddp.dp_mesh([torch.device("cpu")])
    loader = BatchLoader(normalize_images(split.images), split.labels,
                         ShardedSampler(256, num_replicas=1, rank=0,
                                        seed=42), batch_size=64)
    state, history = loop.fit(
        loop.TrainState(MLP.from_seed(0), key_data(1)), loader,
        normalize_images(test.images), test.labels.astype(np.int32),
        epochs=1, batch_size=64,
        train_step=ddp.make_dp_train_step(mesh, 0.1), journal=journal,
        log=lambda m: None)
    return state, history


def test_a_journaled_fit_is_bitwise_and_records_the_schedule(tmp_path):
    plain = _dp_fit()
    j = cluster.CollectiveJournal(cluster.journal_path(str(tmp_path), 0),
                                  rank=0, world=1,
                                  registry=telemetry.MetricsRegistry())
    journaled = _dp_fit(journal=j)
    j.close()
    assert np.array_equal(plain[1][0], journaled[1][0])
    for a, b in zip(plain[0].model.parameters(),
                    journaled[0].model.parameters()):
        assert torch.equal(a, b)
    loaded = jax_cluster.load_journal(
        jax_cluster.journal_path(str(tmp_path), 0))
    per_step = len(collectives.collective_schedule(_params(), 1, "pmean"))
    colls = [r for r in loaded["records"] if r["k"] != "flush"]
    assert len(colls) == 4 * per_step
    assert [r["k"] for r in loaded["records"]].count("flush") == 1
    assert loaded["program"]["comm"] == "pmean" and not loaded["open"]


def test_a_step_without_a_schedule_is_refused_as_jax_refuses_it(tmp_path):
    j = cluster.CollectiveJournal(cluster.journal_path(str(tmp_path), 0),
                                  rank=0, registry=telemetry.MetricsRegistry())
    split = synthetic_mnist(64, seed=0)
    loader = BatchLoader(normalize_images(split.images), split.labels,
                         ShardedSampler(64, num_replicas=1, rank=0,
                                        seed=42), batch_size=32)
    with pytest.raises(ValueError) as e:
        loop.fit(loop.TrainState(MLP.from_seed(0), key_data(1)), loader,
                 normalize_images(split.images),
                 split.labels.astype(np.int32), epochs=1, batch_size=32,
                 lr=0.1, journal=j, log=lambda m: None)
    j.close(clean=False)
    assert str(e.value) in _jax_strings("train/loop.py")


def test_a_two_rank_world_journals_bitwise_as_the_jax_reader_wants(
        tmp_path):
    base = ["--parallel", "--wireup_method", "env", "--device", "cpu",
            "--kernel", "xla", "--n_epochs", "2", "--limit", "256",
            "--batch_size", "32", "--lr", "0.1", "--path",
            str(tmp_path / "nodata")]
    tel = str(tmp_path / "tel")
    res = chaos.run_world(base + ["--checkpoint", "g.msgpack"], 2,
                          str(tmp_path), LIMIT_S)
    assert [r[0] for r in res] == [0, 0], res[0][2][-3000:]
    res = chaos.run_world(base + ["--checkpoint", "j.msgpack", "--journal",
                                  "--telemetry", tel, "--health", "warn"],
                          2, str(tmp_path), LIMIT_S)
    assert [r[0] for r in res] == [0, 0], res[1][2][-3000:]
    assert (tmp_path / "g.msgpack").read_bytes() == \
        (tmp_path / "j.msgpack").read_bytes()
    rep = jax_cluster.cluster_report(tel)
    assert rep["n_ranks"] == 2 and rep["desync"]["ok"]
    assert rep["hang"]["stuck"] is None and rep["programs"] == ["pmean"]
    assert rep == cluster.cluster_report(tel)
    for path in rep["files"]:
        first = jax_cluster.load_journal(path)["records"][0]
        assert (first["seq"], first["k"]) == (0, "barrier")
    assert sorted(os.listdir(tel)) == ["events.jsonl", "events.rank1.jsonl",
                                       "journal.jsonl",
                                       "journal.rank1.jsonl"]


def _jax_strings(rel: str) -> set:
    """Every string constant of a JAX package module (implicitly
    concatenated literals are one constant)."""
    path = REPO / "pytorch_ddp_mnist_tpu" / rel
    return {n.value for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


@pytest.mark.parametrize("argv", [
    ["--journal", "--parallel"],
    ["--journal", "--telemetry", "tdir"],
    ["--journal", "--telemetry", "tdir", "--parallel", "--cached"],
    ["--journal", "--telemetry", "tdir", "--parallel", "--kernel",
     "pallas"],
])
def test_the_journal_refusals_are_the_jax_clis_word_for_word(
        argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as jax_exit:
        jax_cli.main(argv)
    with pytest.raises(SystemExit) as port_exit:
        configure(argv)
    assert str(port_exit.value.code) == str(jax_exit.value.code)


def test_auto_resolved_to_the_fused_step_is_refused_by_the_jax_words(
        tmp_path, monkeypatch):
    monkeypatch.setattr(port_cli, "resolve_kernel", lambda *a: "pallas")
    monkeypatch.setattr(port_cli, "resolve_world",
                        lambda method, device: (Runtime(method="single"),
                                                None))
    with pytest.raises(SystemExit) as e:
        port_cli.train(["--parallel", "--journal", "--telemetry",
                        str(tmp_path / "t"), "--device", "cpu"])
    assert str(e.value.code) in _jax_strings("cli/train.py")
    assert "resolved to pallas" in str(e.value.code)
