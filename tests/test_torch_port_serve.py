"""The port's serving engine, micro-batcher, admission and metrics
(pytorch_ddp_mnist_tpu_torch/serve/) against the JAX package's, on the CPU.

  * The forward: the port's `InferenceEngine` (device "cpu": the bucket
    forward run eagerly on the static buffers a card's graphs replay) and
    the JAX `InferenceEngine`, both over `init_mlp(jax.random.key(0))`
    (moved with `from_jax_params`), at max_batch 64, on every bucket, a
    padded batch and chunked batches above max_batch, float32 and uint8
    rows: the preds equal, the logits within rtol 1e-5 / atol 1e-6 (f32
    summation order only).
  * The pure functions: `bucket_ladder` and `bucket_for` over a grid,
    equal.
  * Under one fake clock: `SLOWindow` percentiles, `predicted_p99`,
    `AdmissionController`'s decisions in both modes, `STAGES` and
    `COALESCE_REASONS`, and the key sets of `ServeMetrics.snapshot()` and
    `attribution()`: equal.
  * The port's own counterparts of the JAX pins of tests/test_serve.py
    and tests/test_serve_fast.py: served equals direct bitwise (tracing on
    and off, fast and legacy), inert padding, no slab per flush and a
    bounded burst, a second batcher refused, the drain, a malformed row
    refused at submit, fetch failures scattered, the capture count fixed
    after warm-up, and a `.pt` moving between the packages.

Card-only pins (the graphs' captures, served == direct on the card, no
sync in a dispatch) are in tests/test_torch_port_gpu.py (`-k serve`)."""

import asyncio
import time

import jax
import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu.models.mlp import init_mlp
from pytorch_ddp_mnist_tpu.serve import InferenceEngine as JaxEngine
from pytorch_ddp_mnist_tpu.serve import admission as jax_admission
from pytorch_ddp_mnist_tpu.serve import engine as jax_engine_mod
from pytorch_ddp_mnist_tpu.serve import metrics as jax_metrics
from pytorch_ddp_mnist_tpu.serve import tracing as jax_tracing
from pytorch_ddp_mnist_tpu.train import checkpoint as jax_ckpt
from pytorch_ddp_mnist_tpu_torch import telemetry
from pytorch_ddp_mnist_tpu_torch.data.mnist import normalize_images
from pytorch_ddp_mnist_tpu_torch.models.mlp import from_jax_params
from pytorch_ddp_mnist_tpu_torch.serve import (AdmissionController,
                                               InferenceEngine, MicroBatcher,
                                               Rejected, ServeMetrics,
                                               ServeService, admission,
                                               bucket_ladder, engine as
                                               engine_mod, metrics, tracing)
from pytorch_ddp_mnist_tpu_torch.serve.engine import STAGING_SLOTS
from pytorch_ddp_mnist_tpu_torch.serve.loadgen import request_rows, run_loadgen
from pytorch_ddp_mnist_tpu_torch.train.checkpoint import save_checkpoint

# the port's forward against the JAX engine's: f32 summation order only
RTOL, ATOL = 1e-5, 1e-6
MAX_BATCH = 64
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jax_params():
    return init_mlp(jax.random.key(0))


@pytest.fixture(scope="module")
def model(jax_params):
    """The JAX params moved with from_jax_params: the port's params tree."""
    return from_jax_params(
        jax.tree_util.tree_map(np.asarray, jax_params)).params()


@pytest.fixture(scope="module")
def engines(jax_params, model):
    """{dtype: (port engine, JAX engine)} at max_batch 64."""
    return {dt: (InferenceEngine(model, max_batch=MAX_BATCH, device=CPU,
                                 input_dtype=dt),
                 JaxEngine(jax_params, max_batch=MAX_BATCH, input_dtype=dt))
            for dt in ("float32", "uint8")}


@pytest.fixture
def engine(model):
    return InferenceEngine(model, max_batch=16, device=CPU)


def _flushed(service, groups):
    """Each group of rows submitted together and flushed as one batch."""
    async def scenario():
        out = []
        for rows in groups:
            subs = [asyncio.ensure_future(service.handle(r)) for r in rows]
            await asyncio.sleep(0)
            service.batcher.flush()
            out.append(np.asarray(await asyncio.gather(*subs), np.int32))
        await service.shutdown()
        return out
    return asyncio.run(scenario())


# ---- the forward against the JAX engine ----

@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 8, 16, 32, 33, 64, 100, 150])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_forward_and_predict_are_the_jax_engines(engines, dtype, n):
    port, ref = engines[dtype]
    rows = request_rows(n, dtype, seed=n)
    np.testing.assert_allclose(port.forward(rows), np.asarray(ref.forward(rows)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(port.predict(rows), ref.predict(rows))
    assert port.predict(rows).dtype == np.int32
    assert port.forward(rows).shape == (n, 10)


def test_the_engines_ladders_and_buckets_are_the_jax_engines(engines):
    port, ref = engines["float32"]
    assert port.buckets == ref.buckets == bucket_ladder(MAX_BATCH)
    assert port.capture_count == ref.compile_count == len(port.buckets) == 7
    for n in range(1, MAX_BATCH + 1):
        assert port.bucket_for(n) == ref.bucket_for(n)
    for eng in (port, ref):
        with pytest.raises(ValueError, match="largest bucket"):
            eng.bucket_for(MAX_BATCH + 1)


@pytest.mark.parametrize("multiple_of", [1, 2, 4, 8])
def test_bucket_ladder_is_the_jax_packages(multiple_of):
    for max_batch in range(1, 130):
        want = _outcome(lambda: jax_engine_mod.bucket_ladder(max_batch,
                                                             multiple_of))
        assert _outcome(lambda: bucket_ladder(max_batch, multiple_of)) == want
    with pytest.raises(ValueError, match="max_batch"):
        bucket_ladder(0)


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("ValueError", str(e))


def test_bucket_for_on_an_explicit_ladder_is_the_jax_engines(jax_params,
                                                             model):
    port = InferenceEngine(model, max_batch=16, device=CPU,
                           buckets=(2, 3, 8, 16))
    ref = JaxEngine(jax_params, max_batch=16, buckets=(2, 3, 8, 16))
    assert port.capture_count == ref.compile_count == 4
    for n in range(1, 17):
        assert port.bucket_for(n) == ref.bucket_for(n) == next(
            b for b in port.buckets if b >= n)
    np.testing.assert_array_equal(port.predict(request_rows(5, seed=1)),
                                  ref.predict(request_rows(5, seed=1)))


def test_uint8_rows_are_the_normalised_f32_rows_bitwise(engines):
    f32, u8 = engines["float32"][0], engines["uint8"][0]
    raw = request_rows(40, "uint8", seed=5)
    x = normalize_images(raw.reshape(40, 28, 28))
    np.testing.assert_array_equal(u8.forward(raw), f32.forward(x))


def test_a_jax_written_pt_serves_as_the_jax_engine_and_back(tmp_path,
                                                            jax_params,
                                                            model):
    path = str(tmp_path / "jax.pt")
    jax_ckpt.save_checkpoint(path, jax_params)
    port = InferenceEngine.from_checkpoint(path, max_batch=16, device=CPU)
    ref = JaxEngine.from_checkpoint(path, max_batch=16)
    rows = request_rows(20, seed=6)
    np.testing.assert_array_equal(port.predict(rows), ref.predict(rows))
    np.testing.assert_allclose(port.forward(rows), ref.forward(rows),
                               rtol=RTOL, atol=ATOL)
    # the port's own .pt served by the JAX engine
    ours = str(tmp_path / "port.pt")
    save_checkpoint(ours, model)
    np.testing.assert_array_equal(
        JaxEngine.from_checkpoint(ours, max_batch=16).predict(rows),
        port.predict(rows))
    # the JAX package's flax msgpack serves too, as the JAX engine serves it
    blob = str(tmp_path / "jax.msgpack")
    jax_ckpt.save_checkpoint(blob, jax_params)
    np.testing.assert_array_equal(
        InferenceEngine.from_checkpoint(blob, max_batch=16,
                                        device=CPU).predict(rows),
        JaxEngine.from_checkpoint(blob, max_batch=16).predict(rows))


def test_from_seed_is_init_mlp_of_the_seed(jax_params, engines):
    rows = request_rows(9, seed=7)
    np.testing.assert_array_equal(
        InferenceEngine.from_seed(0, max_batch=MAX_BATCH,
                                  device=CPU).forward(rows),
        engines["float32"][0].forward(rows))


def test_the_engine_without_a_card_names_it(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        InferenceEngine(model, max_batch=4)


def test_input_validation(engine):
    with pytest.raises(ValueError, match="784"):
        engine.predict(np.zeros((2, 100), np.float32))
    with pytest.raises(ValueError, match="input_dtype"):
        InferenceEngine(engine._params, device=CPU, input_dtype="float16")
    assert engine.predict(np.zeros(784, np.float32)).shape == (1,)


def test_a_bucket_missing_from_the_ladder_raises_by_name(engine):
    with pytest.raises(KeyError, match="bucket 3 has no captured graph"):
        engine._launch(engine._new_slab(3), 3)


# ---- capture accounting, padding, chunking ----

def test_the_capture_count_is_fixed_after_warmup(engine):
    assert engine.capture_count == len(engine.buckets) == 5
    rungs = dict(engine._rungs)
    svc = ServeService(engine, max_delay_ms=1.0)
    run_loadgen(svc, offered_rps=4000.0, n_requests=60, seed=2)
    engine.forward(request_rows(40, seed=3))
    assert engine.capture_count == 5 and engine._rungs == rungs


def test_padding_is_inert(engine):
    x = request_rows(3, seed=11)
    alone = engine.forward(x)
    padded = engine.forward(np.concatenate([x, request_rows(1, seed=12)]))
    np.testing.assert_array_equal(alone, padded[:3])   # same bucket 4
    big = request_rows(16, seed=13)
    engine.staging()[:16] = big
    engine.fetch_staged(engine.dispatch_staged(16))
    # the next flush into a used slab zeroes its pad tail
    engine.staging()[:3] = x
    for _ in range(STAGING_SLOTS):
        engine.staging()[:3] = x
        logits, _ = engine.fetch_staged(engine.dispatch_staged(3))
        np.testing.assert_array_equal(logits, alone)


def test_multichunk_forward_launches_every_chunk_before_a_fetch(
        engine, monkeypatch):
    x = request_rows(40, seed=2)           # 16 + 16 + 8: three chunks
    order = []
    launch, wait = engine._launch, engine._wait

    def spy_launch(slab, bucket, bctx=None):
        order.append(("launch", bucket))
        return launch(slab, bucket, bctx)

    def spy_wait(h):
        order.append(("wait", h.bucket))
        return wait(h)

    monkeypatch.setattr(engine, "_launch", spy_launch)
    monkeypatch.setattr(engine, "_wait", spy_wait)
    out = engine.forward(x)
    assert order == [("launch", 16), ("launch", 16), ("launch", 8),
                     ("wait", 16), ("wait", 16), ("wait", 8)]
    monkeypatch.undo()
    np.testing.assert_array_equal(out[:16], engine.forward(x[:16]))
    np.testing.assert_array_equal(out[32:], engine.forward(x[32:]))


# ---- the batcher: served == direct, the fast path's staging ----

@pytest.mark.parametrize("traced", [False, True], ids=["plain", "traced"])
@pytest.mark.parametrize("fast", [True, False], ids=["fast", "legacy"])
def test_served_equals_direct_bitwise(engine, tmp_path, fast, traced):
    groups = [request_rows(n, seed=20 + n) for n in (1, 3, 5, 8, 11, 16)]
    if traced:
        telemetry.enable(str(tmp_path / "obs"))
    try:
        svc = ServeService(engine, max_delay_ms=1000.0, max_depth=64,
                           fast=fast, registry=telemetry.MetricsRegistry())
        assert svc.batcher.fast_path is fast
        served = _flushed(svc, groups)
    finally:
        telemetry.disable()
    for rows, preds in zip(groups, served):
        np.testing.assert_array_equal(preds, engine.predict(rows))
    assert svc.batcher.flushes == len(groups)


def test_batcher_coalesces_to_one_engine_call(engine):
    svc = ServeService(engine, max_delay_ms=1000.0, max_depth=64)
    rows = request_rows(5, seed=1)
    (preds,) = _flushed(svc, [rows])
    assert svc.batcher.flushes == 1
    snap = svc.metrics.snapshot()
    assert snap["batches"] == 1 and snap["completed"] == 5
    assert snap["batch_occupancy"] == round(5 / 8, 4)
    np.testing.assert_array_equal(preds, engine.predict(rows))


def test_the_flush_decision_is_pure_under_a_fake_clock(engine):
    t = [100.0]
    b = MicroBatcher(engine, max_batch=4, max_delay_ms=2.0,
                     clock=lambda: t[0])
    assert not b.flush_due(t[0])
    b._pending.append((None, None, 100.0, None))
    assert not b.flush_due(100.0019) and b.flush_due(100.0021)
    b._pending.extend([(None, None, 100.001, None)] * 3)
    assert b.flush_due(100.0)               # full batch
    b.close()


def test_fast_path_on_by_default_off_by_knob_and_for_wrappers(engine):
    assert ServeService(engine).batcher.fast_path
    assert not ServeService(engine, fast=False).batcher.fast_path

    class Wrapper:      # an engine without the staging surface
        max_batch = engine.max_batch

        def _as_rows(self, x):
            return engine._as_rows(x)

        def _run_bucket(self, x, bctx=None):
            return engine._run_bucket(x, bctx)

    assert not MicroBatcher(Wrapper()).fast_path
    svc = ServeService(Wrapper(), max_delay_ms=1000.0)
    rows = request_rows(3, seed=4)
    np.testing.assert_array_equal(_flushed(svc, [rows])[0],
                                  engine.predict(rows))


def test_no_slab_is_allocated_per_flush(engine, monkeypatch):
    svc = ServeService(engine, max_delay_ms=1000.0, max_depth=64)
    rows = request_rows(24, seed=32)
    slabs, calls = set(), {"stack": 0, "concatenate": 0, "slab": 0}
    new_slab = engine._new_slab

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    async def scenario():
        grown = engine.staging_grown
        monkeypatch.setattr(np, "stack", counting("stack", np.stack))
        monkeypatch.setattr(np, "concatenate",
                            counting("concatenate", np.concatenate))
        monkeypatch.setattr(engine, "_new_slab", counting("slab", new_slab))
        try:
            for start in range(0, 24, 3):      # 8 flushes of 3 rows each
                slabs.add(id(engine.staging()))
                subs = [asyncio.ensure_future(svc.handle(r))
                        for r in rows[start:start + 3]]
                await asyncio.sleep(0)
                svc.batcher.flush()
                await asyncio.gather(*subs)
        finally:
            monkeypatch.undo()
        await svc.shutdown()
        return grown

    grown = asyncio.run(scenario())
    assert calls == {"stack": 0, "concatenate": 0, "slab": 0}
    assert engine.staging_grown == grown
    assert 1 <= len(slabs) <= STAGING_SLOTS


def test_a_burst_grows_the_pool_by_a_bounded_amount_then_flat(engine):
    handles = []
    for i in range(4):                      # 4 un-fetched dispatches
        engine.staging()[:1] = request_rows(1, seed=41 + i)
        handles.append(engine.dispatch_staged(1))
    assert engine.staging_grown == 4 - (STAGING_SLOTS - 1)
    assert engine.inflight_count == 4
    for h in handles:
        engine.fetch_staged(h)
    grown = engine.staging_grown
    for i in range(6):
        engine.staging()[:1] = request_rows(1, seed=50 + i)
        engine.fetch_staged(engine.dispatch_staged(1))
    assert engine.staging_grown == grown and engine.inflight_count == 0


def test_dispatch_swaps_the_slab_and_fetch_returns_it(engine):
    slab0 = engine.staging()
    slab0[:2] = request_rows(2, seed=36)
    h = engine.dispatch_staged(2)
    assert engine.staging() is not slab0 and engine.inflight_count == 1
    logits, preds = engine.fetch_staged(h)
    assert logits.shape == (2, 10) and preds.shape == (2,)
    assert engine.inflight_count == 0
    engine.staging()[:1] = request_rows(1, seed=37)
    h2 = engine.dispatch_staged(1)
    assert engine.staging() is slab0
    engine.fetch_staged(h2)


def test_close_returns_every_inflight_slab(engine):
    engine.staging()[:2] = request_rows(2, seed=38)
    engine.dispatch_staged(2)
    engine.staging()[:1] = request_rows(1, seed=39)
    engine.dispatch_staged(1)
    assert engine.inflight_count == 2
    engine.close()
    assert engine.inflight_count == 0
    assert len(engine._staging_pool) == 2
    engine.close()                          # idempotent
    assert engine.predict(request_rows(2, seed=40)).shape == (2,)


def test_a_fetch_failure_still_releases_the_slab(engine):
    engine.staging()[:1] = request_rows(1, seed=60)
    h = engine.dispatch_staged(1)

    class Boom:
        def synchronize(self):
            raise RuntimeError("injected wait failure")

    h.event = Boom()
    with pytest.raises(RuntimeError, match="injected"):
        engine.fetch_staged(h)
    assert engine.inflight_count == 0
    grown = engine.staging_grown
    engine.staging()[:1] = request_rows(1, seed=61)
    engine.fetch_staged(engine.dispatch_staged(1))
    assert engine.staging_grown == grown


def test_a_second_concurrent_batcher_fails_loudly(engine):
    svc1 = ServeService(engine, max_delay_ms=1000.0, max_depth=8)
    svc2 = ServeService(engine, max_delay_ms=1000.0, max_depth=8)
    rows = request_rows(2, seed=62)

    async def scenario():
        t1 = asyncio.ensure_future(svc1.handle(rows[0]))
        await asyncio.sleep(0)              # svc1 claims the slab
        t2 = asyncio.ensure_future(svc2.handle(rows[1]))
        (r2,) = await asyncio.gather(t2, return_exceptions=True)
        svc1.batcher.flush()
        r1 = await t1
        await svc1.shutdown()
        await svc2.shutdown()
        return r1, r2

    r1, r2 = asyncio.run(scenario())
    assert isinstance(r1, int)
    assert isinstance(r2, RuntimeError) and "ONE batcher" in str(r2)
    # sequential sharing stays allowed: the flush released the claim
    svc3 = ServeService(engine, max_delay_ms=1000.0, max_depth=8)
    assert _flushed(svc3, [rows[1:]])[0].shape == (1,)


def test_the_drain_waits_for_the_replies_still_out(engine):
    svc = ServeService(engine, max_delay_ms=1000.0, max_depth=64)
    rows = request_rows(5, seed=43)

    async def scenario():
        tasks = [asyncio.ensure_future(svc.handle(r)) for r in rows]
        await asyncio.sleep(0)
        await svc.shutdown()        # drain flushes AND awaits the replies
        return tasks

    tasks = asyncio.run(scenario())
    assert all(t.done() and isinstance(t.result(), int) for t in tasks)
    np.testing.assert_array_equal([t.result() for t in tasks],
                                  engine.predict(rows))
    assert svc.batcher._reply_thread is None
    assert engine.inflight_count == 0


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "legacy"])
def test_a_malformed_row_is_refused_at_submit(engine, fast):
    svc = ServeService(engine, max_delay_ms=1000.0, max_depth=8, fast=fast)
    good = request_rows(2, seed=35)

    async def scenario():
        tasks = [asyncio.ensure_future(svc.handle(r)) for r in good]
        bad = asyncio.ensure_future(svc.handle(np.zeros(10, np.float32)))
        await asyncio.sleep(0)
        svc.batcher.flush()
        out = await asyncio.gather(*tasks, bad, return_exceptions=True)
        await svc.shutdown()
        return out

    r0, r1, rbad = asyncio.run(scenario())
    assert isinstance(rbad, ValueError) and "784" in str(rbad)
    np.testing.assert_array_equal([r0, r1], engine.predict(good))
    assert svc.metrics.snapshot()["failed"] == 1


def test_a_fetch_failure_scatters_to_the_futures(engine, monkeypatch):
    svc = ServeService(engine, max_delay_ms=1000.0, max_depth=8)
    boom = RuntimeError("injected fetch failure")
    orig = engine.fetch_staged

    def failing(handle):
        orig(handle)                # release the slab, then fail
        raise boom

    monkeypatch.setattr(engine, "fetch_staged", failing)
    rows = request_rows(2, seed=42)

    async def scenario():
        tasks = [asyncio.ensure_future(svc.handle(r)) for r in rows]
        await asyncio.sleep(0)
        svc.batcher.flush()
        out = await asyncio.gather(*tasks, return_exceptions=True)
        await svc.shutdown()
        return out

    assert all(r is boom for r in asyncio.run(scenario()))
    snap = svc.metrics.snapshot()
    assert snap["failed"] == 2 and snap["queue_depth"] == 0


def test_the_loop_keeps_running_while_a_fetch_waits_off_loop(engine,
                                                             monkeypatch):
    svc = ServeService(engine, max_delay_ms=1000.0, max_depth=16)
    orig = engine.fetch_staged

    def slow_fetch(handle):
        time.sleep(0.15)
        return orig(handle)

    monkeypatch.setattr(engine, "fetch_staged", slow_fetch)
    monkeypatch.setattr(engine_mod.InflightBatch, "ready", lambda self: False)
    ticks = []

    async def scenario():
        sub = asyncio.ensure_future(svc.handle(request_rows(1, seed=44)[0]))
        await asyncio.sleep(0)
        svc.batcher.flush()
        t0 = time.monotonic()
        for _ in range(10):
            ticks.append(time.monotonic() - t0)
            await asyncio.sleep(0.005)
        pred = await sub
        await svc.shutdown()
        return pred

    assert isinstance(asyncio.run(scenario()), int)
    assert len(ticks) == 10 and ticks[-1] < 0.14    # ticked during the wait
    assert svc.batcher.inline_replies == 0          # the thread path


# ---- admission, the SLO window, the schema: equal to the JAX package's ----

def test_stages_and_coalesce_reasons_are_the_jax_packages():
    assert tracing.STAGES == jax_tracing.STAGES
    assert tracing.COALESCE_REASONS == jax_tracing.COALESCE_REASONS
    assert tracing.STAGE_KEYS == jax_tracing.STAGE_KEYS
    assert tracing.BATCH_STAGE_SPANS == jax_tracing.BATCH_STAGE_SPANS
    assert admission.ADMIT_MODES == jax_admission.ADMIT_MODES
    assert metrics.SLO_WINDOW == jax_metrics.SLO_WINDOW


def _fed_metrics(module, depth):
    """A ServeMetrics of `module` under a fake clock, fed one fixed
    sequence of arrivals, completions, rejects and stage breakdowns."""
    t = [0.0]
    m = module.ServeMetrics(depth_fn=lambda: depth[0], clock=lambda: t[0])
    rng = np.random.default_rng(3)
    for i in range(700):
        t[0] += float(rng.exponential(0.002))
        m.record_arrival()
        if i % 13 == 0:
            m.record_reject()
        elif i % 29 == 0:
            m.record_failure()
        else:
            m.record_done(float(rng.gamma(2.0, 0.003)))
            m.record_stage_values(tuple(float(v) for v in
                                        rng.exponential(0.001, 6)))
        if i % 7 == 0:
            m.record_batch(int(rng.integers(1, 9)), 8)
    return m


def test_slo_window_and_predicted_p99_are_the_jax_packages():
    depth = [5]
    port, ref = _fed_metrics(metrics, depth), _fed_metrics(jax_metrics, depth)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert port.slo.percentile(q) == ref.slo.percentile(q)
    assert port.slo.service_rate() == ref.slo.service_rate()
    assert port.slo.snapshot() == ref.slo.snapshot()
    for d in (0, 5, 40):
        depth[0] = d
        assert port.predicted_p99() == ref.predicted_p99()
    assert port.snapshot() == ref.snapshot()
    assert port.attribution() == ref.attribution()
    assert metrics.nearest_rank([1.0, 2.0, 3.0], 0.5) == \
        jax_metrics.nearest_rank([1.0, 2.0, 3.0], 0.5)


def test_snapshot_and_attribution_keys_are_the_jax_packages():
    port, ref = ServeMetrics(), jax_metrics.ServeMetrics()
    for m in (port, ref):
        m.record_arrival()
        m.record_done(0.003)
        m.record_stage_values((1e-4,) * 6)
        m.record_batch(1, 1)
    assert port.snapshot().keys() == ref.snapshot().keys()
    assert port.snapshot()["latency_ms"].keys() == \
        ref.snapshot()["latency_ms"].keys()
    assert port.attribution().keys() == ref.attribution().keys()
    assert port.attribution()["stages"].keys() == \
        ref.attribution()["stages"].keys()
    assert port.registry.snapshot().keys() == ref.registry.snapshot().keys()
    assert sorted(port.registry.snapshot()["histograms"]) == \
        sorted(ref.registry.snapshot()["histograms"])


def _decisions(module, mode):
    """The admission decisions of `module`'s controller over one fixed
    sequence of admits, releases and predicted p99s."""
    pred = [None]
    kw = (dict(slo_p99_s=0.05, predictor=lambda: pred[0])
          if mode == "predicted_p99" else {})
    ac = module.AdmissionController(6, mode=mode, **kw)
    rng = np.random.default_rng(9)
    out = []
    for i in range(200):
        pred[0] = (None if i < 20 else float(rng.uniform(0.0, 0.1)))
        if rng.random() < 0.6:
            try:
                ac.admit()
                out.append("ok")
            except module.Rejected as e:
                out.append(e.reason[:20])
        elif ac.depth:
            ac.release()
    ac.begin_drain()
    try:
        ac.admit()
    except module.Rejected as e:
        out.append(e.reason)
    return out, (ac.admitted, ac.rejected, ac.rejected_predicted, ac.depth)


@pytest.mark.parametrize("mode", ["depth", "predicted_p99"])
def test_admission_decisions_are_the_jax_packages(mode):
    assert _decisions(admission, mode) == _decisions(jax_admission, mode)


def test_admission_rejects_past_budget_and_drains():
    ac = AdmissionController(2, retry_after_s=0.1)
    ac.admit()
    ac.admit()
    with pytest.raises(Rejected) as e:
        ac.admit()
    assert e.value.retry_after_s == 0.1
    ac.release()

    async def drain():
        waiter = asyncio.ensure_future(ac.drained())
        await asyncio.sleep(0)
        assert not waiter.done()
        with pytest.raises(Rejected, match="draining"):
            ac.admit()
        ac.release()
        await waiter

    asyncio.run(drain())
    with pytest.raises(ValueError, match="slo_p99_s"):
        AdmissionController(4, mode="predicted_p99")
