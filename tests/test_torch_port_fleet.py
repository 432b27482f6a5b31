"""The port's replica fleet (pytorch_ddp_mnist_tpu_torch/serve/fleet.py), the
engine's fleet plumbing and the batcher's supervision surface, against the
JAX package's, on the CPU.

  * Parity: a 2-replica fleet's preds bitwise the port's direct engine and
    equal to the JAX engine's, both over `init_mlp(jax.random.key(0))`
    (moved with `from_jax_params`).
  * The port's counterparts of tests/test_fleet.py's pins: crash failover
    loses nothing, the wedge watchdog fails over, the retry budget bounds
    failover, a client error is never retried, the geometry refused with
    JAX's messages.
  * The engine: the `serve_engine` ordinal and replica, a crash that leaks
    no slab, a wedged handle never ready nor inline, a fetch that close()
    abandoned reading nothing.
  * The batcher: `oldest_inflight_age`, `fail_all`, a late scatter that
    delivers nothing, `close(wait=False)`, a drain that leaves no answered
    future counted.
  * The names: `fleet_snapshot()` keys, the `serve.fleet.*` /
    `serve.reload.*` metric names, the record-contract constants and
    `fleet_record_errors`' verdicts equal to the JAX package's.
  * The front doors: `serve --replicas 2 --selftest N`, the health op's
    fleet block, `bench --mode serve --replicas 2`, and `serve_chaos.py
    --device cpu`'s three legs, whose trace passes
    `scripts/check_telemetry.py --require serve.fleet.,serve.reload.`.
"""

import asyncio
import importlib.util
import json
import pathlib
import time

import jax
import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu.models.mlp import init_mlp
from pytorch_ddp_mnist_tpu.serve import FleetService as JaxFleet
from pytorch_ddp_mnist_tpu.serve import InferenceEngine as JaxEngine
from pytorch_ddp_mnist_tpu.serve import ReloadWatcher as JaxWatcher
from pytorch_ddp_mnist_tpu.telemetry import analysis as jax_analysis
from pytorch_ddp_mnist_tpu.telemetry.registry import \
    MetricsRegistry as JaxRegistry
from pytorch_ddp_mnist_tpu.utils import faultpoints as jax_faultpoints
from pytorch_ddp_mnist_tpu_torch import bench, serve_chaos
from pytorch_ddp_mnist_tpu_torch.cli import serve as serve_cli
from pytorch_ddp_mnist_tpu_torch.models.mlp import from_jax_params
from pytorch_ddp_mnist_tpu_torch.serve import (FleetService, FleetUnavailable,
                                               InferenceEngine, MicroBatcher,
                                               ReloadWatcher, ReplicaCrashed,
                                               ServeService, fleet as fleet_mod)
from pytorch_ddp_mnist_tpu_torch.serve.loadgen import request_rows
from pytorch_ddp_mnist_tpu_torch.telemetry import MetricsRegistry, analysis
from pytorch_ddp_mnist_tpu_torch.utils import faultpoints

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
MAX_BATCH = 8


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


check_main = _load("check_telemetry", REPO / "scripts" / "check_telemetry.py").main


@pytest.fixture(scope="module")
def jax_params():
    return init_mlp(jax.random.key(0))


@pytest.fixture(scope="module")
def params(jax_params):
    return from_jax_params(
        jax.tree_util.tree_map(np.asarray, jax_params)).params()


@pytest.fixture(scope="module")
def rows():
    return request_rows(48, "float32", seed=1)


@pytest.fixture(scope="module")
def direct(params, rows):
    eng = InferenceEngine(params, max_batch=MAX_BATCH, device=CPU)
    preds = [int(eng.predict(np.stack([r]))[0]) for r in rows]
    eng.close()
    return preds


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    faultpoints.install("")
    jax_faultpoints.install("")


def _build(p):
    return InferenceEngine(p, max_batch=MAX_BATCH, device=CPU)


def _fleet(params, **kw):
    kw.setdefault("n_replicas", 2)
    kw.setdefault("max_batch", MAX_BATCH)
    kw.setdefault("max_delay_ms", 1.0)
    kw.setdefault("registry", MetricsRegistry())
    return FleetService(_build, params, **kw)


def _serve_all(fleet, rows):
    async def scenario():
        got = await asyncio.gather(*[fleet.handle(r) for r in rows],
                                   return_exceptions=True)
        snap = fleet.fleet_snapshot()
        await fleet.shutdown()
        return got, snap
    return asyncio.run(scenario())


# ---- parity ----

def test_fleet_preds_are_the_direct_engines_and_the_jax_engines(
        jax_params, params, rows, direct):
    got, snap = _serve_all(_fleet(params), rows)
    assert list(got) == direct
    jeng = JaxEngine(jax_params, max_batch=MAX_BATCH)
    assert direct == [int(jeng.predict(np.stack([r]))[0]) for r in rows]
    jeng.close()
    assert snap["healthy"] == 2 and not snap["degraded"]
    assert all(r["window_n"] > 0 for r in snap["per_replica"])


def test_fleet_refuses_a_bad_geometry_with_the_jax_messages(params,
                                                            jax_params):
    for kw in ({"n_replicas": 0}, {"retry_budget": -1},
               {"wedge_timeout_s": 0}):
        with pytest.raises(ValueError) as ours:
            FleetService(_build, params, **kw)
        with pytest.raises(ValueError) as theirs:
            JaxFleet(lambda p: None, jax_params, **kw)
        assert str(ours.value) == str(theirs.value)


# ---- failover ----

def test_client_error_propagates_unretried(params, rows):
    fleet = _fleet(params)

    async def scenario():
        with pytest.raises((ValueError, TypeError)):
            await fleet.handle(np.zeros(3))
        ok = await fleet.handle(rows[0])
        snap = fleet.fleet_snapshot()
        await fleet.shutdown()
        return ok, snap

    ok, snap = asyncio.run(scenario())
    assert isinstance(ok, int)
    assert snap["retried_requests"] == 0
    assert snap["crashes"] == 0 and snap["healthy"] == 2


def test_crash_failover_loses_nothing(params, rows, direct):
    faultpoints.install("engine_crash:after=1:replica=0")
    got, snap = _serve_all(_fleet(params), rows)
    assert list(got) == direct
    assert snap["crashes"] >= 1 and snap["retried_requests"] >= 1


def test_wedge_watchdog_fails_over(params, rows, direct):
    faultpoints.install("engine_wedge:delay_s=2.0:replica=1")
    t0 = time.monotonic()
    got, snap = _serve_all(
        _fleet(params, wedge_timeout_s=0.05, retry_budget=3), rows)
    assert list(got) == direct
    assert snap["wedges"] >= 1 and snap["retried_requests"] >= 1
    # the watchdog, not the wedge's end, released the waiters
    assert time.monotonic() - t0 < 1.5


def test_retry_budget_bounds_failover(params, rows):
    faultpoints.install("engine_crash:times=100")
    fleet = _fleet(params, retry_budget=1, no_replica_wait_s=0.2)

    async def scenario():
        with pytest.raises(Exception) as ei:
            await fleet.handle(rows[0])
        snap = fleet.fleet_snapshot()
        await fleet.shutdown()
        return ei.value, snap

    exc, snap = asyncio.run(scenario())
    assert not isinstance(exc, (ValueError, TypeError))
    assert snap["retry_exhausted"] >= 1 or isinstance(exc, FleetUnavailable)
    assert snap["retried_requests"] <= 1


def test_a_restart_rejoins_on_the_current_generation(params, rows, direct):
    fleet = _fleet(params)

    async def scenario():
        faultpoints.install("engine_crash:replica=0")
        await asyncio.gather(*[fleet.handle(r) for r in rows[:8]])
        deadline = time.monotonic() + 5
        while fleet.replicas[0].state != fleet_mod.HEALTHY \
                and time.monotonic() < deadline:
            await asyncio.sleep(0.005)
        got = await asyncio.gather(*[fleet.handle(r) for r in rows])
        snap = fleet.fleet_snapshot()
        await fleet.shutdown()
        return got, snap

    got, snap = asyncio.run(scenario())
    assert list(got) == direct
    assert snap["restarts"] == 1 and snap["healthy"] == 2
    assert snap["per_replica"][0]["restarts"] == 1


def test_a_failed_rebuild_leaves_the_replica_dead_by_name(params, rows):
    calls = {"n": 0}

    def build(p):
        calls["n"] += 1
        if calls["n"] > 2:
            raise RuntimeError("no card left for the rebuild")
        return _build(p)

    fleet = FleetService(build, params, n_replicas=2, max_batch=MAX_BATCH,
                         max_delay_ms=1.0, registry=MetricsRegistry())

    async def scenario():
        faultpoints.install("engine_crash:replica=0")
        got = await asyncio.gather(*[fleet.handle(r) for r in rows[:8]])
        deadline = time.monotonic() + 5
        while fleet.replicas[0].state == fleet_mod.RESTARTING \
                and time.monotonic() < deadline:
            await asyncio.sleep(0.005)
        snap = fleet.fleet_snapshot()
        await fleet.shutdown()
        return got, snap

    got, snap = asyncio.run(scenario())
    assert all(isinstance(g, int) for g in got)
    assert snap["per_replica"][0]["state"] == fleet_mod.DEAD
    assert snap["healthy"] == 1 and snap["degraded"]


# ---- the engine's fleet plumbing ----

def test_the_engine_fault_context_is_the_jax_engines(params, jax_params):
    ours = _build(params)
    theirs = JaxEngine(jax_params, max_batch=MAX_BATCH)
    for eng, fp in ((ours, faultpoints), (theirs, jax_faultpoints)):
        assert eng.replica is None and eng._fault_ctx() == {"after": 0}
        eng.replica = 1
        eng.predict(request_rows(3, seed=2))
        assert eng._fault_ctx() == {"after": 1, "replica": 1}
        # the ordinal counts launches and fires at its first crossing
        fp.install("engine_crash:after=2:replica=1")
        with pytest.raises(RuntimeError, match="simulated serve engine "
                                               "crash"):
            eng.predict(request_rows(1, seed=3))
        eng.predict(request_rows(1, seed=3))        # times=1: spent
        assert eng._fault_ctx() == {"after": 3, "replica": 1}
    theirs.close()


def test_an_injected_crash_leaks_no_slab(params):
    eng = _build(params)
    pool, grown = len(eng._staging_pool), eng.staging_grown
    faultpoints.install("engine_crash:times=5")
    for i in range(5):
        eng.staging()[:1] = request_rows(1, seed=70 + i)
        with pytest.raises(RuntimeError, match="engine crash"):
            eng.dispatch_staged(1)
    faultpoints.install("")
    assert eng.inflight_count == 0 and eng._staging_writer is None
    assert (len(eng._staging_pool), eng.staging_grown) == (pool, grown)
    eng.staging()[:2] = request_rows(2, seed=80)
    logits, preds = eng.fetch_staged(eng.dispatch_staged(2))
    assert preds.shape == (2,) and eng.staging_grown == grown


def test_a_wedged_handle_is_never_ready_nor_inline_until_its_deadline(
        params):
    eng = _build(params)
    faultpoints.install("engine_wedge:delay_s=0.1:replica=0")
    eng.replica = 0
    eng.staging()[:1] = request_rows(1, seed=81)
    h = eng.dispatch_staged(1)
    assert h.wedged_until > 0 and not h.ready() and not h.inline_ok
    t0 = time.monotonic()
    _, preds = eng.fetch_staged(h)
    assert time.monotonic() - t0 >= 0.05 and preds.shape == (1,)
    assert h.ready() and h.inline_ok


def test_a_fetch_that_close_abandoned_reads_nothing(params):
    eng = _build(params)
    faultpoints.install("engine_wedge:delay_s=0.05")
    eng.staging()[:1] = request_rows(1, seed=82)
    h = eng.dispatch_staged(1)
    eng.close()                          # the retirement: slab back in pool
    pool = len(eng._staging_pool)
    with pytest.raises(RuntimeError, match="abandoned by close"):
        eng.fetch_staged(h)
    assert len(eng._staging_pool) == pool and eng.inflight_count == 0


# ---- the batcher's supervision surface ----

def test_fail_all_releases_every_waiter_and_a_late_scatter_delivers_nothing(
        params, rows):
    eng = _build(params)
    b = MicroBatcher(eng, max_delay_ms=1000.0)
    # the flush stays in flight (its fetch blocks on the reply thread)
    faultpoints.install("engine_wedge:delay_s=0.2")

    async def scenario():
        subs = [asyncio.ensure_future(b.submit(r)) for r in rows[:3]]
        await asyncio.sleep(0)
        assert b.oldest_inflight_age(b.clock()) == 0.0
        b.flush()
        assert b.oldest_inflight_age(b.clock() + 1.0) >= 1.0
        (item,) = b._inflight_meta.values()
        batch = item[1]
        pending = [asyncio.ensure_future(b.submit(r)) for r in rows[3:5]]
        await asyncio.sleep(0)
        released = b.fail_all(ReplicaCrashed("replica 0 crash: test"))
        got = await asyncio.gather(*subs, *pending, return_exceptions=True)
        assert released == 5
        assert all(isinstance(g, ReplicaCrashed) for g in got)
        assert b.oldest_inflight_age(b.clock()) == 0.0
        # the abandoned flush's fetch lands late: nothing is delivered
        b._scatter((batch, None, 1, np.zeros(3, np.int32), None))
        await b.drain()
        b.close(wait=False)
        return b._outstanding

    assert asyncio.run(scenario()) == set()


def test_close_without_wait_abandons_a_blocked_reply_thread(params):
    eng = _build(params)
    b = MicroBatcher(eng, max_delay_ms=1000.0)
    faultpoints.install("engine_wedge:delay_s=0.3")

    async def scenario():
        sub = asyncio.ensure_future(b.submit(request_rows(1, seed=83)[0]))
        await asyncio.sleep(0)
        b.flush()
        await asyncio.sleep(0.02)        # the reply thread is in the fetch
        thread = b._reply_thread
        t0 = time.monotonic()
        b.fail_all(ReplicaCrashed("wedged"))
        b.close(wait=False)
        took = time.monotonic() - t0
        with pytest.raises(ReplicaCrashed):
            await sub
        return thread, took

    thread, took = asyncio.run(scenario())
    assert took < 0.1 and b._reply_thread is None
    thread.join(timeout=2.0)
    assert not thread.is_alive()


def test_a_drain_counts_no_answered_future(params, rows):
    """`gather` over futures that are all done returns without yielding,
    before their discard callbacks run: the drain drops them itself, so
    the fleet's `outstanding_at_swap` counts only the unanswered."""
    eng = _build(params)
    b = MicroBatcher(eng, max_delay_ms=1000.0)

    async def scenario():
        subs = [asyncio.ensure_future(b.submit(r)) for r in rows[:4]]
        await asyncio.sleep(0)
        b.flush()
        while not all(f.done() for f in b._outstanding):
            await asyncio.sleep(0)
        await b.drain()
        left = len(b._outstanding)
        await asyncio.gather(*subs)
        b.close()
        return left

    assert asyncio.run(scenario()) == 0


# ---- the names: snapshot keys, metrics, the record contract ----

def test_snapshot_keys_and_metric_names_are_the_jax_packages(
        params, jax_params, rows, tmp_path):
    async def run(fleet, watcher_cls, reg, d):
        watcher_cls(fleet, str(d))
        await fleet.handle(rows[0])
        snap = fleet.fleet_snapshot()
        await fleet.shutdown()
        s = reg.snapshot()
        names = {n for t in ("counters", "gauges", "histograms")
                 for n in s[t] if n.startswith(("serve.fleet.",
                                                "serve.reload."))}
        return snap, names

    reg, jreg = MetricsRegistry(), JaxRegistry()
    ours = asyncio.run(run(_fleet(params, registry=reg), ReloadWatcher, reg,
                           tmp_path / "a"))
    theirs = asyncio.run(run(
        JaxFleet(lambda p: JaxEngine(p, max_batch=MAX_BATCH), jax_params,
                 n_replicas=2, max_batch=MAX_BATCH, registry=jreg),
        JaxWatcher, jreg, tmp_path / "b"))
    assert list(ours[0]) == list(theirs[0])
    assert list(ours[0]["per_replica"][0]) == \
        list(theirs[0]["per_replica"][0])
    assert ours[1] == theirs[1] and len(ours[1]) == 14
    assert (fleet_mod.HEALTHY, fleet_mod.DRAINING, fleet_mod.RESTARTING,
            fleet_mod.DEAD) == ("healthy", "draining", "restarting", "dead")


def test_the_record_contract_is_the_jax_packages():
    for name in ("FLEET_EVENT_POINT", "RELOAD_EVENT_POINT", "FLEET_EVENTS",
                 "RELOAD_EVENTS", "QUARANTINE_CAUSES"):
        assert getattr(analysis, name) == getattr(jax_analysis, name)

    def point(name, line, **attrs):
        return {"kind": "point", "name": name, "_line": line, "attrs": attrs}

    cases = [
        point("fleet_event", 1, event="quarantine", replica=0, cause="wedge"),
        point("fleet_event", 2, event="restart", replica=0, dur_s=0.1),
        point("reload_event", 3, event="swapped", replica=1,
              outstanding_at_swap=0),
        point("reload_event", 4, event="refused", step=3, reason="torn"),
        point("fleet_event", 5, event="exploded", replica=0),
        point("fleet_event", 6, event="quarantine", replica=-1,
              cause="gremlins"),
        point("fleet_event", 7, event="dead", replica=True),
        point("reload_event", 8, event="swapped", replica=1,
              outstanding_at_swap=2),
        point("reload_event", 9, event="swapped", outstanding_at_swap=False),
        point("reload_event", 10, event="refused", step=3, reason=""),
        point("reload_event", 11, event="rolled_back"),
        {"kind": "span", "name": "fleet_event", "_line": 12},
    ]
    got = analysis.fleet_record_errors(cases)
    assert got == jax_analysis.fleet_record_errors(cases)
    assert [line for line, _ in got] == [5, 6, 6, 7, 8, 9, 10, 11]


# ---- the front doors ----

def test_serve_replicas_2_selftest_runs_the_fleet(capsys, monkeypatch):
    # the selftest's snapshot reads the process's registry: a fresh one,
    # so an earlier selftest in this process does not add its requests
    from pytorch_ddp_mnist_tpu_torch.telemetry import registry
    monkeypatch.setattr(registry, "_GLOBAL", registry.MetricsRegistry())
    assert serve_cli.main(["--device", "cpu", "--replicas", "2",
                           "--selftest", "60", "--max_batch", "8",
                           "--offered_rps", "3000"]) == 0
    out = capsys.readouterr()
    snap = json.loads(out.out.strip().splitlines()[-1])
    assert snap["completed"] + snap["rejected"] == 60 and snap["failed"] == 0
    assert "replicas=2" in out.err and "captures=4" in out.err


def test_the_health_op_answers_the_fleet_block(params):
    fleet = _fleet(params)

    async def scenario():
        health = await serve_cli.handle_request(fleet, {"op": "health"})
        await fleet.shutdown()
        return health

    health = asyncio.run(scenario())["health"]
    assert health["fleet"]["replicas"] == 2
    assert health["fleet"]["serving_step"] == -1
    single = ServeService(_build(params))

    async def plain():
        return await serve_cli.handle_request(single, {"op": "health"})

    assert "fleet" not in asyncio.run(plain())["health"]


def test_bench_serve_with_two_replicas_reads_the_fleet_counters():
    # plumbing only: a CPU time is no device number and is not recorded
    sv = bench.run_serve_bench(CPU, offered_rps=3000.0, requests=60,
                               max_batch=16, replicas=2)
    assert (sv["replicas"], sv["retried_requests"], sv["reloads"]) == (2, 0, 0)
    assert sv["availability"] == 1.0 and sv["compile_count"] == 5


def test_serve_chaos_holds_its_three_legs_on_the_cpu(tmp_path):
    verdict = serve_chaos.run(CPU, requests=120, offered_rps=1500.0,
                              workdir=str(tmp_path))
    assert verdict["serve_chaos"] == "ok", verdict.get("problems")
    legs = verdict["legs"]
    assert verdict["availability"] == 1.0
    assert legs["kill_mid_burst"]["crashes"] >= 1
    assert legs["wedge_then_watchdog"]["wedges"] >= 1
    assert legs["kill_mid_burst"]["bitwise_mismatches"] == 0
    swap = legs["torn_checkpoint_swap"]
    assert (swap["reloads"], swap["refused"], swap["serving_step"],
            swap["failed"]) == (3, 2, 5, 0)
    tel = str(tmp_path / "telemetry")
    assert check_main(["--require", "serve.fleet.,serve.reload.", tel]) == 0
    assert analysis.trace_contract_errors(
        tel, require=("serve.fleet.", "serve.reload.")) == []
