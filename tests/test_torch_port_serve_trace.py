"""The port's serve tracing, load generator, serve CLI and eval / serve
benches (pytorch_ddp_mnist_tpu_torch/serve/tracing.py, loadgen.py,
cli/serve.py, bench.py --mode eval|serve) against the JAX package's, on
the CPU.

  * `arrival_times` (poisson, ramp, spike) and `request_rows` (float32,
    uint8) at two seeds: bitwise the JAX package's.
  * The spans that `serve --selftest 200 --telemetry DIR --device cpu`
    writes pass `scripts/check_telemetry.py --require serve.` as that
    script is; the request/batch links resolve; the telescoped stages sum
    to each request's e2e; the slowest-request exemplars reach the flight
    dump.
  * The TCP server: one pixels request answers the JAX engine's pred for
    the same row; `{"op": "metrics"}` answers the snapshot; the protocol
    core's stats and health ops; the drain on SIGTERM.
  * The eval pass: the port's `make_eval_program` at 3 passes against the
    root bench.py `make_eval_program` on the same params and data: mean
    losses within rtol 1e-6, accuracies equal. The eval and serve bench
    lines' fields on a tiny CPU run (plumbing only: a CPU time is no
    device number).
  * The refusals by name: the fleet knobs' bad values (JAX's messages), a
    `$PDMT_FAULT` spec that does not parse, `--mesh` over two cards, no
    card. (The fleet itself: tests/test_torch_port_fleet.py and
    test_torch_port_reload.py.)
"""

import asyncio
import importlib.util
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu.models.mlp import init_mlp
from pytorch_ddp_mnist_tpu.serve import InferenceEngine as JaxEngine
from pytorch_ddp_mnist_tpu.serve import loadgen as jax_loadgen
from pytorch_ddp_mnist_tpu_torch import bench, telemetry
from pytorch_ddp_mnist_tpu_torch.cli import serve as serve_cli
from pytorch_ddp_mnist_tpu_torch.data.mnist import synthetic_mnist
from pytorch_ddp_mnist_tpu_torch.models.mlp import init_params
from pytorch_ddp_mnist_tpu_torch.serve import InferenceEngine, ServeService
from pytorch_ddp_mnist_tpu_torch.serve import loadgen, tracing
from pytorch_ddp_mnist_tpu_torch.telemetry import flight
from pytorch_ddp_mnist_tpu_torch.train.scan import resident_images

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


check_main = _load("check_telemetry", REPO / "scripts" / "check_telemetry.py").main


@pytest.fixture(scope="module")
def engine():
    return InferenceEngine.from_seed(0, max_batch=16, device=CPU)


# ---- the load generator: bitwise the JAX package's ----

@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("shape", loadgen.SHAPES)
def test_arrival_times_are_the_jax_packages_bitwise(shape, seed):
    assert loadgen.SHAPES == jax_loadgen.SHAPES
    for n, rps in ((1, 50.0), (300, 500.0), (1000, 20000.0)):
        got = loadgen.arrival_times(n, rps, shape=shape, seed=seed)
        want = jax_loadgen.arrival_times(n, rps, shape=shape, seed=seed)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("seed", [1, 8])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_request_rows_are_the_jax_packages_bitwise(dtype, seed):
    got = loadgen.request_rows(37, dtype, seed=seed)
    want = jax_loadgen.request_rows(37, dtype, seed=seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_the_load_answers_the_direct_preds_and_both_clocks(engine):
    svc = ServeService(engine, max_delay_ms=2.0, max_depth=256,
                       registry=telemetry.MetricsRegistry())
    out = loadgen.run_loadgen(svc, offered_rps=3000.0, n_requests=80, seed=3)
    rows = loadgen.request_rows(80, "float32", seed=4)
    np.testing.assert_array_equal(np.asarray(out["predictions"]),
                                  engine.predict(rows))
    assert out["completed"] == 80 and out["rejected"] == 0
    cl = out["client_latency_ms"]
    assert 0 < cl["p50"] <= cl["p95"] <= cl["p99"] <= cl["max"]
    assert set(out["front_door_overhead_ms"]) == {"p50", "p95", "p99"}
    with pytest.raises(ValueError, match="offered_rps"):
        loadgen.run_loadgen(svc, offered_rps=0.0, n_requests=1)


# ---- tracing: spans, the checker, attribution, exemplars ----

def test_selftest_spans_pass_the_telemetry_checker(tmp_path, capsys):
    out_dir = tmp_path / "obs"
    assert serve_cli.main(["--selftest", "200", "--telemetry", str(out_dir),
                           "--device", "cpu", "--max_batch", "16",
                           "--offered_rps", "4000"]) == 0
    snap = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert snap["completed"] + snap["rejected"] == 200
    assert check_main([str(out_dir)]) == 0
    assert check_main(["--require", "serve.", str(out_dir)]) == 0
    recs = [json.loads(line) for line in open(out_dir / "events.jsonl")]
    reqs = [r for r in recs if r.get("name") == tracing.REQUEST_SPAN]
    batches = {r["attrs"]["batch_id"]: r for r in recs
               if r.get("name") == tracing.BATCH_SPAN}
    assert len(reqs) == snap["completed"] and batches
    for r in reqs:
        assert r["attrs"]["ok"] is True and r["attrs"]["batch"] in batches
        stages = sum(r["attrs"][k] for k in tracing.STAGE_KEYS)
        assert abs(stages - r["dur_s"]) <= 0.05 * r["dur_s"] + 1e-5
    for b in batches.values():
        assert b["attrs"]["coalesce"] in tracing.COALESCE_REASONS
        assert 1 <= b["attrs"]["n_real"] <= b["attrs"]["bucket"]
    dumps = list(out_dir.glob("flight.*.json"))
    assert dumps and any(e["kind"] == "serve_exemplar" for e in
                         json.loads(dumps[0].read_text())["entries"])
    assert not telemetry.get_tracer().enabled     # the CLI disabled it


def test_tracing_off_writes_no_spans_and_feeds_the_stage_histograms(engine):
    assert not telemetry.get_tracer().enabled
    svc = ServeService(engine, max_delay_ms=2.0,
                       registry=telemetry.MetricsRegistry())
    loadgen.run_loadgen(svc, offered_rps=3000.0, n_requests=40, seed=0)
    att = svc.metrics.attribution()
    assert list(att["stages"]) == list(tracing.STAGES)
    assert all(s["n"] == 40 for s in att["stages"].values())
    assert abs(sum(s["share_pct"] for s in att["stages"].values()) - 100) < 0.1


def test_the_drain_flushes_the_slowest_exemplars_to_the_flight_ring(engine):
    before = flight.get_flight_recorder().recorded
    svc = ServeService(engine, max_delay_ms=2.0)
    loadgen.run_loadgen(svc, offered_rps=3000.0, n_requests=30, seed=1)
    entries = [e for e in flight.get_flight_recorder().snapshot()
               if e["seq"] >= before and e["kind"] == "serve_exemplar"]
    assert len(entries) == tracing.EXEMPLAR_K
    assert [e["rank"] for e in entries] == list(range(tracing.EXEMPLAR_K))
    e2e = [e["e2e_s"] for e in entries]
    assert e2e == sorted(e2e, reverse=True)


def test_the_exemplar_heap_survives_equal_e2e():
    t = [0.0]
    tr = tracing.ServeTracer(clock=lambda: t[0], exemplar_k=2)
    for _ in range(4):
        r = tr.begin()
        tr.admitted(r)
        tr.enqueued(r)
        b = tr.batch_begin("manual")
        b.mark_formed()
        b.mark_h2d(1)
        b.mark_computed()
        r.batch = b
        t[0] += 1.0
        tr.finish(r, ok=True)
        t[0] -= 1.0
    assert len(tr.exemplars()) == 2 and tr.flush_exemplars() == 2


# ---- the TCP server and the protocol core ----

def test_the_protocol_core_answers_metrics_stats_and_health(engine):
    svc = ServeService(engine, max_delay_ms=0.0,
                       registry=telemetry.MetricsRegistry())
    row = loadgen.request_rows(1, seed=5)[0]

    async def scenario():
        pred = await serve_cli.handle_request(svc, {"pixels": row.tolist()})
        out = [pred]
        for op in ("metrics", "stats", "health"):
            out.append(await serve_cli.handle_request(svc, {"op": op}))
        await svc.shutdown()
        return out

    pred, metrics, stats, health = asyncio.run(scenario())
    assert pred == {"ok": True, "pred": int(engine.predict(row)[0])}
    assert metrics["completed"] == 1 and "attribution" in metrics
    assert stats["registry"]["counters"]["serve.completed"] == 1
    assert stats["serve"]["completed"] == 1
    assert {"rolling_p99_ms", "predicted_p99_ms", "queue_depth",
            "draining"} <= set(health["health"])


def test_the_tcp_server_answers_the_jax_engines_pred(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytorch_ddp_mnist_tpu_torch", "serve",
         "--device", "cpu", "--port", "0", "--seed", "0"], cwd=REPO,
        text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)
    row = loadgen.request_rows(1, seed=6)[0]
    want = int(JaxEngine(init_mlp(jax.random.key(0)), max_batch=1)
               .predict(row)[0])
    try:
        deadline = time.monotonic() + 60
        line = ""
        while time.monotonic() < deadline and not line.startswith(
                "serving on"):
            line = proc.stderr.readline()
            assert line, proc.stderr.read()
        host, port = line.split()[-1].rsplit(":", 1)
        with socket.create_connection((host, int(port)), timeout=30) as s, \
                s.makefile("rw") as f:
            for req in ({"pixels": row.tolist()}, {"op": "metrics"},
                        {"pixels": [1.0, 2.0]}):
                f.write(json.dumps(req) + "\n")
                f.flush()
            pixels, metrics, bad = (json.loads(f.readline())
                                    for _ in range(3))
        os.killpg(proc.pid, signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert pixels == {"ok": True, "pred": want}
    assert metrics["ok"] and metrics["completed"] == 1
    assert not bad["ok"] and "784" in bad["error"]
    assert proc.returncode == 0 and "drain" in err
    assert json.loads(out.strip().splitlines()[-1])["completed"] == 1


# ---- the eval pass against the JAX bench's ----

def test_the_eval_program_is_the_jax_benchs():
    root_bench = _load("root_bench", REPO / "bench.py")
    split = synthetic_mnist(512, seed=1)
    x = resident_images(split.images)
    y = split.labels.astype(np.int32)
    jparams = init_mlp(jax.random.key(0))
    want_l, want_a = root_bench.make_eval_program(3)(jparams,
                                                     jax.numpy.asarray(x), y)
    got_l, got_a = bench.make_eval_program(3)(
        init_params(0), torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=1e-6)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    assert got_l.shape == (3,)


def test_the_eval_and_serve_bench_lines_on_a_tiny_cpu_run():
    # plumbing only: a CPU time is no device number and is not recorded
    ev = bench.run_eval_bench(CPU, epochs=2, windows=1, n_test=256)
    assert ev["metric"] == "mnist_eval_images_per_sec_per_chip"
    assert ev["unit"] == "images/sec/chip" and ev["value"] > 0
    assert ev["tflops"] == pytest.approx(
        ev["value"] * 2 * bench.MACS_FWD_PER_IMG / 1e12, abs=0.01)
    sv = bench.run_serve_bench(CPU, offered_rps=3000.0, requests=60,
                               max_batch=16)
    assert sv["metric"] == "mnist_serve_requests_per_sec"
    assert sv["compile_count"] == 5 and sv["availability"] == 1.0
    assert (sv["replicas"], sv["retried_requests"], sv["reloads"]) == (1, 0, 0)
    assert list(sv["stage_attribution"]) == list(tracing.STAGES)
    assert {"p50_ms", "p95_ms", "p99_ms", "front_door_overhead_ms",
            "batch_occupancy", "staging_grown", "fast_path"} <= set(sv)


@pytest.mark.parametrize("argv,match", [
    (["--mode", "serve", "--epochs", "3"], "never read by --mode serve"),
    (["--mode", "eval", "--requests", "5"], "serve-mode knob"),
    (["--mode", "eval", "--kernel", "xla"], "train-mode variant knob"),
    (["--mode", "serve", "--replicas", "0"], "--replicas must be > 0"),
])
def test_bench_eval_and_serve_refuse_knobs_by_name(argv, match, capsys):
    with pytest.raises(SystemExit) as e:
        bench.main(argv)
    assert match in str(e.value.code) + capsys.readouterr().err


def test_bench_eval_and_serve_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("eval", "serve"):
        with pytest.raises(SystemExit, match="no CUDA card"):
            bench.main(["--mode", mode])


# ---- the serve CLI's refusals ----

@pytest.mark.parametrize("argv,match", [
    (["--replicas", "0"], "--replicas must be >= 1"),
    (["--wedge_timeout_ms", "0"], "--wedge_timeout_ms must be > 0"),
    (["--reload_dir", "ckpts", "--selftest", "1"],
     "--reload_dir needs the TCP server"),
    (["--retry_budget", "-1"], "--retry_budget must be >= 0"),
])
def test_serve_refuses_the_unported_features_by_name(argv, match, capsys):
    # the fleet's knobs are ported (serve/fleet.py, serve/reload.py): what
    # stays refused is a bad value, by JAX's message
    with pytest.raises(SystemExit) as e:
        serve_cli.main(["--device", "cpu", *argv])
    assert e.value.code == 2 and match in capsys.readouterr().err


def test_serve_refuses_the_fault_points_by_name(monkeypatch):
    # the serve fault points are armed by $PDMT_FAULT now; a spec that does
    # not parse exits naming it, before any engine is built
    monkeypatch.setenv("PDMT_FAULT", "engine_krash:after=4:replica=0")
    with pytest.raises(SystemExit, match="PDMT_FAULT: unknown fault kind "
                                         "'engine_krash'"):
        serve_cli.main(["--device", "cpu", "--selftest", "1"])


def test_serve_mesh_over_two_cards_is_refused_by_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(SystemExit, match="2 cards .* item 7"):
        serve_cli.main(["--mesh", "--selftest", "1"])


def test_serve_without_a_card_exits_naming_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card.*serve runs on the "
                                         "card; pass --device cpu"):
        serve_cli.main(["--selftest", "1"])
