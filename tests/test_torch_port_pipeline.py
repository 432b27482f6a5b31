"""The port's input pipeline (pytorch_ddp_mnist_tpu_torch/pipeline/) and
the workload zoo (models/zoo.py), against the JAX package on the CPU.

  * `SyntheticSource` and `ShardReader.plan(start)`: bitwise the JAX
    package's, batches and plans.
  * `feed` at every workers x depth in {0, 1, 4} x {1, 2, 4}: bitwise the
    unpiped order of the same source (and of the JAX pipeline's).
  * The worker pool's contracts as tests/test_pipeline.py pins them: the
    error in order, the join on an early close, one-shot, the bad-knob
    refusals, the index-level start, the `data.*` metrics.
  * `prefetch`: order at any depth, the eager depth refusal, the drain on
    an error and on an early close; `SlotRing` (the captured step's slots)
    at depth 1, 2, 4.
  * A piped port `fit` bitwise its unpiped `fit` (serial, a 2-replica mesh,
    `--dropout_rng torch`'s masks at any worker count), and within rtol
    1e-5 of JAX's piped `fit` on the same batches and keys; `fit_cached`'s
    prefetch depth bitwise; a NetCDF source through the workers bitwise.
  * The CLI's new flags and every JAX refusal of their combinations, by
    name; `bench --mode input`'s plumbing (a CPU time is no device number).
  * The zoo: the JAX inits of mlp@2 and deep_mlp@2 bitwise, a step of each
    against JAX, `.npz` and `.pt` checkpoints of zoo models both ways.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_ddp_mnist_tpu import pipeline as jpipe
from pytorch_ddp_mnist_tpu.data import BatchLoader as JaxLoader
from pytorch_ddp_mnist_tpu.parallel.sampler import ShardedSampler as JaxSampler
from pytorch_ddp_mnist_tpu_torch import bench
from pytorch_ddp_mnist_tpu_torch.data.loader import BatchLoader
from pytorch_ddp_mnist_tpu_torch.data.mnist import (normalize_images,
                                                    synthetic_mnist)
from pytorch_ddp_mnist_tpu_torch.models import zoo
from pytorch_ddp_mnist_tpu_torch.models.mlp import MLP
from pytorch_ddp_mnist_tpu_torch.ops import fused_step
from pytorch_ddp_mnist_tpu_torch.ops.threefry import key_data
from pytorch_ddp_mnist_tpu_torch.parallel import ddp
from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler
from pytorch_ddp_mnist_tpu_torch.pipeline import (ShardReader, SlotRing,
                                                  SyntheticSource, WorkerPool,
                                                  feed, host_iter,
                                                  pipeline_capable, prefetch)
from pytorch_ddp_mnist_tpu_torch.pipeline.reader import reshard_source
from pytorch_ddp_mnist_tpu_torch.telemetry import MetricsRegistry
from pytorch_ddp_mnist_tpu_torch.train import loop, scan
from pytorch_ddp_mnist_tpu_torch.train.checkpoint import (load_checkpoint,
                                                          save_checkpoint)
from pytorch_ddp_mnist_tpu_torch.train.config import configure

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU steps only contend with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _loader(n=256, batch=32, seed=42):
    split = synthetic_mnist(n, seed=0)
    return BatchLoader(normalize_images(split.images), split.labels,
                       ShardedSampler(n, seed=seed), batch)


def _np(batches):
    return [tuple(np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
                  for a in b) for b in batches]


def _assert_batches_equal(a, b):
    assert len(a) == len(b) and len(a) > 0
    for ba, bb in zip(a, b):
        assert len(ba) == len(bb)
        for u, v in zip(ba, bb):
            np.testing.assert_array_equal(u, v)


# ------------------------------------------------------ sources and plans --

@pytest.mark.parametrize("seed,epoch", [(0, 0), (3, 1), (7, 5)])
def test_synthetic_source_is_the_jax_source_bitwise(seed, epoch):
    ours = SyntheticSource(6, 16, seed=seed)
    theirs = jpipe.SyntheticSource(6, 16, seed=seed)
    ours.sampler.set_epoch(epoch)
    theirs.sampler.set_epoch(epoch)
    _assert_batches_equal(_np(ours), _np(theirs))
    _assert_batches_equal(_np(ours.iter_from(2)), _np(theirs.iter_from(2)))
    assert len(ours) == len(theirs) == 6
    assert ours._table.shape == (251, 784)


@pytest.mark.parametrize("start", [0, 2, 7])
def test_shard_reader_plan_is_the_jax_plan_bitwise(start):
    split = synthetic_mnist(230, seed=0)
    x = normalize_images(split.images)
    ours = BatchLoader(x, split.labels, ShardedSampler(230, num_replicas=2,
                                                       rank=1, seed=42), 32)
    theirs = JaxLoader(x, split.labels, JaxSampler(230, num_replicas=2,
                                                   rank=1, seed=42), 32)
    ours.sampler.set_epoch(3)
    theirs.sampler.set_epoch(3)
    a = list(ShardReader(ours).plan(start))
    b = list(jpipe.ShardReader(theirs).plan(start))
    assert [i for i, _ in a] == [i for i, _ in b] == list(range(start, 4))
    for (_, ra), (_, rb) in zip(a, b):
        np.testing.assert_array_equal(ra, rb)
        _assert_batches_equal([ours.read_batch(ra)], [theirs.read_batch(rb)])
    assert len(ShardReader(ours)) == 4


def test_pipeline_capable_and_reshard():
    assert pipeline_capable(SyntheticSource(2, 8))
    assert pipeline_capable(_loader())
    assert not pipeline_capable(iter([(1, 2)]))
    with pytest.raises(ValueError, match="not pipeline-capable"):
        ShardReader(iter([(1, 2)]))
    src = _loader(n=64, batch=8)
    src.sampler.set_epoch(2)
    reshard_source(src, 2, 1)
    assert (src.sampler.num_replicas, src.sampler.rank,
            src.sampler.epoch) == (2, 1, 2)
    with pytest.raises(ValueError, match="elastic re-sharding"):
        reshard_source(iter([]), 2, 0)


# ----------------------------------------------------------------- order --

@pytest.mark.parametrize("workers", [0, 1, 4])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_feed_order_is_the_unpiped_order_bitwise(workers, depth):
    src = _loader(n=300, batch=32)
    src.sampler.set_epoch(1)
    want = _np(iter(src))
    got = _np(feed(src, workers=workers, depth=depth, device=CPU))
    _assert_batches_equal(got, want)
    jsrc = JaxLoader(src.images, src.labels, JaxSampler(300, seed=42), 32)
    jsrc.sampler.set_epoch(1)
    _assert_batches_equal(got, _np(jpipe.host_iter(jsrc, workers=workers)))


def test_worker_pool_start_offset_skips_at_the_index_level():
    src = SyntheticSource(8, 4, seed=2)
    reads = []
    orig = src.read_batch
    src.read_batch = lambda rows: (reads.append(rows.copy()), orig(rows))[1]
    got = _np(WorkerPool(ShardReader(src), 2, start=5))
    assert len(got) == 3 and len(reads) == 3
    _assert_batches_equal(got, _np(SyntheticSource(8, 4, seed=2).iter_from(5)))


class _Boom(Exception):
    pass


def test_worker_pool_raises_the_error_in_order_and_joins():
    src = SyntheticSource(10, 4, seed=0)
    orig = src.read_batch
    calls = {"n": 0}

    def flaky(rows):
        calls["n"] += 1
        if rows.tolist() == list(bad):
            raise _Boom("batch 4 failed")
        return orig(rows)

    plan = list(ShardReader(src).plan())
    bad = plan[4][1]
    src.read_batch = flaky
    pool = WorkerPool(ShardReader(src), 3)
    seen = []
    with pytest.raises(_Boom, match="batch 4 failed"):
        for b in pool:
            seen.append(b)
    assert len(seen) == 4                  # the batches before it, in order
    assert all(not t.is_alive() for t in pool._threads)


def test_worker_pool_early_close_joins_the_workers():
    src = SyntheticSource(50, 4, latency_s=0.002, seed=0)
    pool = WorkerPool(ShardReader(src), 4, queue_depth=1)
    it = iter(pool)
    next(it)
    next(it)
    it.close()
    assert pool._threads and all(not t.is_alive() for t in pool._threads)


def test_worker_pool_backpressure_bounds_the_batches_ahead():
    src = SyntheticSource(40, 4, seed=0)
    pool = WorkerPool(ShardReader(src), 2, queue_depth=2)
    it = iter(pool)
    next(it)
    time.sleep(0.3)
    with pool._cv:
        ahead = len(pool._done)
    assert ahead <= 2 * 2
    it.close()


def test_worker_pool_is_one_shot_and_refuses_bad_knobs():
    pool = WorkerPool(ShardReader(SyntheticSource(2, 4)), 1)
    list(pool)
    with pytest.raises(RuntimeError, match="one-shot"):
        iter(pool)
    with pytest.raises(ValueError, match="num_workers must be >= 1"):
        WorkerPool(ShardReader(SyntheticSource(2, 4)), 0)
    with pytest.raises(ValueError, match="queue_depth must be >= 1"):
        WorkerPool(ShardReader(SyntheticSource(2, 4)), 1, queue_depth=0)
    with pytest.raises(ValueError, match="workers must be >= 0"):
        host_iter(SyntheticSource(2, 4), workers=-1)
    with pytest.raises(ValueError, match="not pipeline-capable"):
        host_iter(iter([(np.zeros(1), np.zeros(1))]), workers=2)
    with pytest.raises(ValueError, match="n_batches/batch_size"):
        SyntheticSource(0, 4)


def test_the_pool_and_the_sequential_path_publish_data_metrics():
    for workers in (0, 3):
        reg = MetricsRegistry()
        got = list(host_iter(SyntheticSource(5, 4), workers=workers,
                             registry=reg))
        snap = reg.snapshot()
        assert len(got) == 5
        assert snap["counters"]["data.batches"] == 5
        assert snap["histograms"]["data.batch_wait_s"]["n"] == 5
        if workers:
            assert snap["gauges"]["data.workers"] == 3
            assert "data.queue_depth" in snap["gauges"]


# -------------------------------------------------------------- prefetch --

@pytest.mark.parametrize("depth", [1, 2, 4, 9])
def test_prefetch_keeps_order_and_its_lookahead(depth):
    started = []

    def put(b):
        started.append(b)
        return b
    out = []
    for b in prefetch(range(7), depth=depth, put=put):
        out.append(b)
        assert len(started) <= min(len(out) + depth, 7)
    assert out == list(range(7))
    with pytest.raises(ValueError, match="depth must be >= 1"):
        prefetch(range(3), depth=0, put=put)
    with pytest.raises(ValueError, match="put= or device="):
        prefetch(range(3))


def test_prefetch_drains_on_an_error_and_on_an_early_close():
    drained = []

    def source():
        yield 0
        yield 1
        yield 2
        raise _Boom("source failed")

    gen = prefetch(source(), depth=2, put=lambda b: b,
                   drain=drained.append)
    got = []
    with pytest.raises(_Boom, match="source failed"):
        for b in gen:
            got.append(b)
    assert got == [0] and drained == [1, 2]
    drained.clear()
    gen = prefetch(range(10), depth=3, put=lambda b: b, drain=drained.append)
    assert next(gen) == 0
    gen.close()
    assert drained == [1, 2, 3]


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_slot_ring_fills_slot_k_mod_ring_in_order(depth):
    ring_size = depth + 1
    slots = (torch.zeros(ring_size, 3, 4),
             torch.zeros(ring_size, 3, dtype=torch.int32))
    ring = SlotRing(slots)
    batches = [(np.full((3, 4), k, np.float32), np.full(3, 10 + k, np.int32))
               for k in range(9)]
    for epoch in range(2):      # one ring, every epoch from slot 0
        for k, j in enumerate(ring.feed(iter(batches), depth)):
            assert j == k % ring_size
            assert torch.equal(slots[0][j], torch.full((3, 4), float(k)))
            assert torch.equal(slots[1][j], torch.full((3,), 10 + k,
                                                       dtype=torch.int32))
    with pytest.raises(ValueError, match="takes a depth of"):
        ring.feed(iter(batches), ring_size)


# ------------------------------------------------------------ the trainers --

def _fit(step_kind, workers, depth, *, epochs=2, n=300, batch=32, mesh=None,
         lr=0.05):
    split = synthetic_mnist(n, seed=4)
    test = synthetic_mnist(64, seed=5)
    local = batch * (len(mesh) if mesh else 1)
    src = BatchLoader(normalize_images(split.images), split.labels,
                      ShardedSampler(n, seed=42), local)
    if mesh is not None:
        step = ddp.make_dp_train_step(mesh, lr)
    elif step_kind == "pallas":
        step = fused_step.make_fused_train_step(lr)
    elif step_kind == "torch_dropout":
        step = loop.make_torch_dropout_train_step(lr, 3)
    else:
        step = None
    state, hist = loop.fit(
        loop.TrainState(MLP.from_seed(0), key_data(1)), src,
        normalize_images(test.images), test.labels.astype(np.int32),
        epochs=epochs, batch_size=local, lr=None if step else lr,
        train_step=step, input_workers=workers, prefetch_depth=depth,
        log=lambda _m: None)
    return np.stack(hist), {n: {k: v.detach().clone() for k, v in layer.items()}
                            for n, layer in state.model.params().items()}


def _assert_runs_equal(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    for n in a[1]:
        for k in a[1][n]:
            assert torch.equal(a[1][n][k], b[1][n][k]), (n, k)


@pytest.mark.parametrize("kind", ["xla", "pallas", "torch_dropout", "mesh"])
def test_piped_fit_is_the_unpiped_fit_bitwise(kind):
    mesh = (CPU, CPU) if kind == "mesh" else None
    ref = _fit(kind, 0, 1, mesh=mesh)
    for workers, depth in ((4, 3), (1, 2)):
        _assert_runs_equal(_fit(kind, workers, depth, mesh=mesh), ref)


def test_piped_fit_tracks_the_jax_piped_fit():
    from pytorch_ddp_mnist_tpu.models import init_mlp
    from pytorch_ddp_mnist_tpu.train import TrainState as JaxState
    from pytorch_ddp_mnist_tpu.train import fit as jax_fit
    n, batch, lr = 300, 32, 0.05
    split = synthetic_mnist(n, seed=4)
    test = synthetic_mnist(64, seed=5)
    x_test, y_test = normalize_images(test.images), test.labels.astype(np.int32)
    jsrc = JaxLoader(normalize_images(split.images), split.labels,
                     JaxSampler(n, seed=42), batch)
    jstate = jax_fit(JaxState(init_mlp(jax.random.key(0)),
                              jax.random.key(1)), jsrc, x_test, y_test,
                     epochs=2, batch_size=batch, lr=lr, log=lambda _m: None,
                     input_workers=4, prefetch_depth=2)
    losses, params = _fit("xla", 4, 2, lr=lr)
    for name in params:
        for k in params[name]:
            np.testing.assert_allclose(params[name][k].numpy(),
                                       np.asarray(jstate.params[name][k]),
                                       rtol=1e-5, atol=1e-6)
    assert losses.shape == (2, 10) and np.isfinite(losses).all()


def test_torch_dropout_masks_do_not_depend_on_the_worker_count():
    """`MaskedStep.with_masks` draws on the consumer's side, after the
    reorder buffer: the masks the step gets are the step order's."""
    step = loop.make_torch_dropout_train_step(0.05, 3)
    src = SyntheticSource(6, 8, seed=1)
    ref = [m for _, _, m in step.with_masks(host_iter(src, workers=0))]
    step = loop.make_torch_dropout_train_step(0.05, 3)
    got = [m for _, _, m in step.with_masks(host_iter(src, workers=4))]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(ref[0], ref[1])


def test_fit_refuses_bad_pipeline_knobs():
    with pytest.raises(ValueError, match="input_workers must be >= 0"):
        loop.fit(loop.TrainState(MLP.from_seed(0), key_data(1)), _loader(),
                 np.zeros((1, 784), np.float32), np.zeros(1, np.int32),
                 epochs=1, batch_size=32, lr=0.01, input_workers=-1)
    with pytest.raises(ValueError, match="prefetch_depth must be >= 1"):
        loop.fit(loop.TrainState(MLP.from_seed(0), key_data(1)), _loader(),
                 np.zeros((1, 784), np.float32), np.zeros(1, np.int32),
                 epochs=1, batch_size=32, lr=0.01, prefetch_depth=0)


@pytest.mark.parametrize("mesh", [None, (CPU, CPU)])
def test_fit_cached_prefetch_depth_is_bitwise(mesh):
    split = synthetic_mnist(256, seed=2)
    test = synthetic_mnist(32, seed=3)
    runs = []
    for depth in (1, 3):
        model = MLP.from_seed(0)
        key, hist = scan.fit_cached(
            model, key_data(1), split.images, split.labels,
            ShardedSampler(256, seed=42), normalize_images(test.images),
            test.labels.astype(np.int32), epochs=3, batch_size=64, lr=0.05,
            mesh=mesh, prefetch_depth=depth, log=lambda _m: None)
        runs.append((np.stack(hist), {n: {k: v.detach().clone()
                                          for k, v in layer.items()}
                                      for n, layer in model.params().items()}))
    _assert_runs_equal(runs[0], runs[1])
    with pytest.raises(ValueError, match="nothing to prefetch"):
        scan.fit_cached(MLP.from_seed(0), key_data(1), split.images,
                        split.labels, ShardedSampler(256, seed=42),
                        split.images, split.labels, epochs=1, batch_size=64,
                        lr=0.05, fused=True, prefetch_depth=2)


def test_netcdf_source_through_the_workers_is_bitwise(tmp_path):
    from pytorch_ddp_mnist_tpu_torch.data.convert import main as convert
    from pytorch_ddp_mnist_tpu_torch.data.loader import NetCDFShardLoader
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        convert(["--synthetic", "200:16", "--out_dir", str(tmp_path)])
    ldr = NetCDFShardLoader(str(tmp_path / "mnist_train_images.nc"),
                            batch_size=32)
    ldr.sampler = ShardedSampler(200, seed=42)
    ldr.sampler.set_epoch(1)
    want = _np(iter(ldr))
    _assert_batches_equal(_np(feed(ldr, workers=3, depth=2, device=CPU)),
                          want)


# -------------------------------------------------------- CLI and bench --

def _cfg(*argv):
    return configure(["--device", "cpu", *argv])["trainer"]


def test_cli_accepts_the_pipeline_flags_and_runs_bitwise(capsys):
    from pytorch_ddp_mnist_tpu_torch.cli import train as cli
    t = _cfg("--input_workers", "3", "--prefetch_depth", "2",
             "--num_workers", "0")
    assert (t["input_workers"], t["prefetch_depth"], t["num_workers"]) == (
        3, 2, 0)
    base = ["--device", "cpu", "--limit", "512", "--batch_size", "64",
            "--checkpoint", ""]
    _, h0 = cli.train(base)
    _, h1 = cli.train(base + ["--input_workers", "3", "--prefetch_depth",
                              "3"])
    np.testing.assert_array_equal(np.stack(h0), np.stack(h1))
    assert "input_workers=3 prefetch_depth=3" in capsys.readouterr().out


@pytest.mark.parametrize("argv,match", [
    (["--input_workers", "-1"], "--input_workers must be >= 0"),
    (["--prefetch_depth", "0"], "--prefetch_depth must be >= 1"),
    (["--input_workers", "2", "--cached"], "--cached holds the dataset in "
                                           "HBM with no loader to feed"),
    (["--input_workers", "2", "--num_workers", "2"],
     "supersedes the NetCDF loader's --num_workers"),
    (["--prefetch_depth", "2", "--cached", "--fused"],
     "there is nothing to prefetch"),
])
def test_cli_refuses_the_jax_pipeline_combinations_by_name(argv, match):
    with pytest.raises(SystemExit, match=match):
        configure(["--device", "cpu", *argv])


def test_bench_input_mode_plumbing_and_refusals(capsys):
    out = bench.run_input_bench(CPU, epochs=1, batch_size=16, latency_ms=1,
                                batches=4, workers=2, depth=2)
    assert out["metric"] == "mnist_input_pipeline_batches_per_sec"
    for run in ("legacy", "pipeline"):
        r = out[run]
        assert r["batches_seen"] == 4 and 0 <= r["data_wait_share"] <= 1
        assert r["syncs"] <= r["sync_budget"] == 6
    assert (out["legacy"]["workers"], out["pipeline"]["workers"]) == (0, 2)
    for argv, match in ((["--mode", "input", "--input_workers", "0"],
                         "--input_workers must be >= 1"),
                        (["--mode", "input", "--input_depth", "0"],
                         "--input_depth must be >= 1"),
                        (["--mode", "eval", "--input_batches", "3"],
                         "input-mode knob")):
        with pytest.raises(SystemExit):
            bench.main(argv)
        assert match in capsys.readouterr().err


# ------------------------------------------------------------------- zoo --

@pytest.mark.parametrize("model,scale", [("mlp", 1), ("mlp", 2),
                                         ("deep_mlp", 2)])
def test_zoo_inits_are_the_jax_inits_bitwise(model, scale):
    from pytorch_ddp_mnist_tpu.models.zoo import resolve_model as jresolve
    jp = jresolve(model, scale).init(jax.random.key(3))
    spec = zoo.resolve_model(model, scale)
    tp = spec.from_seed(3).params()
    assert sorted(jp) == sorted(tp)
    for n in jp:
        assert sorted(jp[n]) == sorted(tp[n])
        for k in jp[n]:
            np.testing.assert_array_equal(tp[n][k].detach().numpy(),
                                          np.asarray(jp[n][k]))
    assert spec.dims == jresolve(model, scale).dims
    if (model, scale) == ("mlp", 1):
        assert spec.from_seed == MLP.from_seed


@pytest.mark.parametrize("model,scale", [("mlp", 2), ("deep_mlp", 2)])
def test_zoo_step_tracks_the_jax_step(model, scale):
    from pytorch_ddp_mnist_tpu.models.zoo import resolve_model as jresolve
    from pytorch_ddp_mnist_tpu.train.loop import make_train_step as jstep
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 784)).astype(np.float32)
    y = rng.integers(0, 10, 16).astype(np.int32)
    jspec = jresolve(model, scale)
    jp, jk = jspec.init(jax.random.key(0)), jax.random.key(1)
    step = jstep(0.05, apply_fn=jspec.apply)
    for _ in range(2):
        jp, jk, jl = step(jp, jk, jnp.asarray(x), jnp.asarray(y))
    spec = zoo.resolve_model(model, scale)
    m = spec.from_seed(0)
    tstep, key = loop.make_train_step(0.05, spec.apply), key_data(1)
    for _ in range(2):
        key, tl = tstep(m, key, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for n, layer in m.params().items():
        for k, v in layer.items():
            np.testing.assert_allclose(v.detach().numpy(),
                                       np.asarray(jp[n][k]), rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("model", ["mlp", "deep_mlp"])
def test_zoo_checkpoints_load_both_ways(model, tmp_path):
    from pytorch_ddp_mnist_tpu.models.zoo import resolve_model as jresolve
    jp = jax.tree_util.tree_map(np.asarray,
                                jresolve(model, 2).init(jax.random.key(5)))
    # JAX params as numpy -> .npz -> the port's module, bitwise
    npz = tmp_path / "jax.npz"
    np.savez(npz, **{f"{n}/{k}": v for n, layer in jp.items()
                     for k, v in layer.items()})
    m = zoo.from_tree(load_checkpoint(str(npz)))
    assert zoo.spec_of(m) == (model, 2)
    # the port's module -> .npz / .pt -> numpy trees equal to JAX's
    for name in ("port.npz", "port.pt"):
        save_checkpoint(str(tmp_path / name), m.params())
        back = load_checkpoint(str(tmp_path / name))
        for n in jp:
            for k in jp[n]:
                np.testing.assert_array_equal(back[n][k].numpy(), jp[n][k])
    with np.load(tmp_path / "port.npz") as z:
        assert sorted(z.files) == sorted(f"{n}/{k}" for n in jp for k in jp[n])


def test_zoo_refusals_by_name():
    with pytest.raises(ValueError, match="unknown model"):
        zoo.resolve_model("resnet", 1)
    with pytest.raises(ValueError, match="param_scale must be an int >= 1"):
        zoo.resolve_model("mlp", 0)
    with pytest.raises(ValueError, match="use kernel='xla'"):
        scan.make_run_fn(0.01, kernel="pallas", model="deep_mlp",
                         param_scale=2)
    with pytest.raises(ValueError, match="neither"):
        zoo.from_tree({"x": {"w": np.zeros((2, 2))}})
