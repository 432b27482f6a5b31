"""The port's gradient-communication strategies (pytorch_ddp_mnist_tpu_torch/
parallel/collectives.py, the DP steps of parallel/ddp.py and train/
scan.py) against the JAX package's parallel/collectives.py on the CPU.

  * `bytes_on_wire` and `collective_schedule`: equal to JAX's for every
    strategy, n in {2, 4}, overlap on and off, and zoo model; the residual's
    length too.
  * `quantize_block_int8` / `dequantize_block_int8` and
    `stochastic_round_bf16`: bitwise JAX's; the rounding bits are
    `jax.random.bits`.
  * `int8_allreduce_mean` at n = 4 with error feedback against JAX's under
    the 8 fake CPU devices: within 2 ulp of the mean (XLA's CPU backend
    contracts the dequantising multiply into its sum as a fused multiply-
    add chain; the port multiplies and sums in replica order) and within
    4 n ulp of the mean's scale on the residual (its owner slice carries
    the mean's error x n).
  * The DP step of every strategy on a 4-replica CPU mesh: sharded (and
    pmean with overlap) within rtol 1e-6 of pmean (bitwise at n = 4), bf16
    and int8 within JAX's drift bounds of pmean (tests/test_collectives.py:
    1e-4 and 1e-3 after 3 steps at lr 0.05), each strategy within 1e-4 of
    JAX's own step; deterministic; the scan's captured-loop body (run
    eagerly on the CPU) bitwise the eager host loop; small buckets.
  * A 2-rank gloo world (this file run as a script is the rank) bitwise
    the 2-replica mesh fed the same rows, for every non-pmean strategy,
    on the streaming step and on a cached epoch.
  * The validators' and the CLI's refusals, by name; the ddp.* metrics,
    the comm probe, `bench --mode ddp`'s plumbing.

The ranks and the meshes they are held against run torch single-threaded.
No rank imports jax: only the tests here do.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu_torch import bench
from pytorch_ddp_mnist_tpu_torch.data.mnist import synthetic_mnist
from pytorch_ddp_mnist_tpu_torch.models import zoo
from pytorch_ddp_mnist_tpu_torch.models.mlp import MLP
from pytorch_ddp_mnist_tpu_torch.ops import fused_step, threefry
from pytorch_ddp_mnist_tpu_torch.parallel import collectives as tc
from pytorch_ddp_mnist_tpu_torch.parallel import ddp, wireup
from pytorch_ddp_mnist_tpu_torch.parallel.mesh import WorldMesh
from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler
from pytorch_ddp_mnist_tpu_torch.telemetry import MetricsRegistry
from pytorch_ddp_mnist_tpu_torch.train import scan
from pytorch_ddp_mnist_tpu_torch.train.config import configure

CPU = torch.device("cpu")
N = 4
LR = 0.05
# every strategy the ranks and the mesh run: (comm, its knobs)
CASES = {
    "sharded": dict(comm="sharded"),
    "bf16": dict(comm="bf16"),
    "bf16_stochastic": dict(comm="bf16", bf16_rounding="stochastic"),
    "int8": dict(comm="int8"),
    "int8_no_feedback": dict(comm="int8", error_feedback=False),
    "pmean_overlap": dict(comm="pmean", overlap=True),
    "bf16_overlap_stochastic": dict(comm="bf16", overlap=True,
                                    bf16_rounding="stochastic"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax():
    import jax
    return jax


def _jax_mesh(n):
    jax = _jax()
    from pytorch_ddp_mnist_tpu.parallel.mesh import make_mesh
    return make_mesh([n], ["dp"], jax.devices()[:n])


def _batch(n_rows, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_rows, 784)).astype(np.float32)
    y = rng.integers(0, 10, size=n_rows).astype(np.int32)
    return x, y


def _numpy(params):
    return {n: {k: v.detach().cpu().numpy() for k, v in layer.items()}
            for n, layer in params.items()}


def _worst(a, b):
    return max(float(np.max(np.abs(np.asarray(a[n][k]) - np.asarray(b[n][k]))))
               for n in a for k in a[n])


def _port_train(kw, n=N, steps=3, mesh=None, model="mlp", scale=1):
    mesh = mesh or (CPU,) * n
    step = ddp.make_dp_train_step(mesh, LR, model=model, param_scale=scale,
                                  **kw)
    m = zoo.resolve_model(model, scale).from_seed(0)
    step.place_comm_state(m.params())
    key, (x, y) = threefry.key_data(1), _batch(n * 16)
    for _ in range(steps):
        key, loss = step(m, key, torch.from_numpy(x), torch.from_numpy(y))
    assert np.isfinite(float(loss))
    return _numpy(m.params()), step


def _jax_train(kw, n=N, steps=3):
    jax = _jax()
    from pytorch_ddp_mnist_tpu.models import init_mlp
    from pytorch_ddp_mnist_tpu.parallel.ddp import (batch_sharding,
                                                    make_dp_train_step,
                                                    replicated)
    mesh = _jax_mesh(n)
    step = make_dp_train_step(mesh, lr=LR, **kw)
    p = jax.device_put(init_mlp(jax.random.key(0)), replicated(mesh))
    k = jax.device_put(jax.random.key(1), replicated(mesh))
    r = step.place_comm_state(None, p) if step.comm_state else None
    x, y = _batch(n * 16)
    for _ in range(steps):
        xs = jax.device_put(x, batch_sharding(mesh))
        ys = jax.device_put(y, batch_sharding(mesh))
        if step.comm_state:
            p, k, _, r = step(p, k, xs, ys, r)
        else:
            p, k, _ = step(p, k, xs, ys)
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def pmean_ref():
    return _port_train({"comm": "pmean"})[0]


# ---------------------------------------------------- accounting vs JAX --

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("model,scale", [("mlp", 1), ("mlp", 2),
                                         ("deep_mlp", 2)])
def test_bytes_on_wire_and_schedule_equal_jax(n, model, scale):
    jax = _jax()
    from pytorch_ddp_mnist_tpu.models.zoo import resolve_model as jresolve
    from pytorch_ddp_mnist_tpu.parallel import collectives as jc
    jp = jresolve(model, scale).init(jax.random.key(0))
    tp = zoo.resolve_model(model, scale).from_seed(0).params()
    for comm in tc.STRATEGIES:
        for kw in ({}, {"bucket_elems": 50_000}, {"quant_block": 64}):
            if "quant_block" in kw and comm != "int8":
                continue
            assert tc.bytes_on_wire(tp, n, comm, **kw) == \
                jc.bytes_on_wire(jp, n, comm, **kw)
            for overlap in (False, True):
                assert tc.collective_schedule(tp, n, comm, overlap=overlap,
                                              **kw) == \
                    jc.collective_schedule(jp, n, comm, overlap=overlap, **kw)
        assert tc.bytes_on_wire(118272, n, comm) == \
            jc.bytes_on_wire(118272, n, comm)
    assert tc.comm_state_elems(tp, n) == jc.comm_state_elems(jp, n)
    np.testing.assert_array_equal(tc.comm_state_zeros(tp, n),
                                  jc.comm_state_zeros(jp, n))
    assert tc.bytes_on_wire(tp, 1, "pmean") == 0
    assert tc.padded_size(10, 4) == jc.padded_size(10, 4) == 12


def test_bytes_moved_counts_the_all_gathers():
    n_params = 118272
    # pmean: one buffer of grads and the loss from each other replica
    assert tc.bytes_moved(n_params, 4, "pmean") == 3 * 4 * (n_params + 1)
    assert tc.bytes_moved(n_params, 1, "int8") == 0
    for comm in tc.STRATEGIES:
        assert tc.bytes_moved(n_params, 4, comm) >= \
            tc.bytes_on_wire(n_params, 4, comm)


# --------------------------------------------------------- numerics vs JAX --

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantizers_and_rounding_are_jax_bitwise(seed):
    jax = _jax()
    import jax.numpy as jnp
    from pytorch_ddp_mnist_tpu.parallel import collectives as jc
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=2048) * 10.0 ** rng.integers(-6, 1)).astype(
        np.float32)
    x[256:512] = 0.0                           # an all-zero block
    q, s = jc.quantize_block_int8(jnp.asarray(x), 256)
    tq, ts = tc.quantize_block_int8(torch.from_numpy(x), 256)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
    assert ts[1] == 0
    np.testing.assert_array_equal(
        tc.dequantize_block_int8(tq, ts, 256).numpy(),
        np.asarray(jc.dequantize_block_int8(q, s, 256)))
    key = jax.random.fold_in(jax.random.key(seed), 7)
    words = tuple(int(w) for w in np.asarray(jax.random.key_data(key)))
    np.testing.assert_array_equal(
        tc.stochastic_round_bf16(words, torch.from_numpy(x)).float().numpy(),
        np.asarray(jc.stochastic_round_bf16(key, jnp.asarray(x))
                   .astype(jnp.float32)))
    np.testing.assert_array_equal(
        threefry.random_bits(torch.tensor(words), 1000).numpy(),
        np.asarray(jax.random.bits(key, (1000,), jnp.uint32)).astype(
            np.int64))


def test_int8_allreduce_mean_within_ulps_of_jax():
    jax = _jax()
    from jax.sharding import PartitionSpec as P
    from pytorch_ddp_mnist_tpu.compat import shard_map
    from pytorch_ddp_mnist_tpu.parallel import collectives as jc
    rng = np.random.default_rng(0)
    g = rng.normal(size=(N, 2048)).astype(np.float32) * 0.01
    r = rng.normal(size=(N, 2048)).astype(np.float32) * 1e-4

    def body(gi, ri):
        m, nr = jc.int8_allreduce_mean(gi.reshape(-1), ri.reshape(-1), "dp",
                                       N, 256)
        return m[None], nr[None]
    run = jax.jit(shard_map(body, mesh=_jax_mesh(N),
                            in_specs=(P("dp"), P("dp")),
                            out_specs=(P("dp"), P("dp")), check_vma=False))
    jm, jr = (np.asarray(a) for a in run(g, r))
    mean, resid = tc.int8_allreduce_mean([torch.from_numpy(v) for v in g],
                                         [torch.from_numpy(v) for v in r],
                                         256)
    ulp = np.spacing(np.float32(np.abs(jm).max()))
    for i in range(N):
        np.testing.assert_array_max_ulp(mean.numpy(), jm[i], maxulp=2)
        assert np.abs(resid[i].numpy() - jr[i]).max() <= 4 * N * ulp
    mean0, none = tc.int8_allreduce_mean([torch.from_numpy(v) for v in g],
                                         None, 256)
    assert none is None and torch.isfinite(mean0).all()


API_CASES = [("sharded", {}), ("pmean", {"overlap": True}),
             ("bf16", {}), ("bf16", {"stochastic": True}),
             ("bf16", {"overlap": True, "stochastic": True}),
             ("int8", {"feedback": True}), ("int8", {})]


@pytest.mark.parametrize("comm,opts", API_CASES)
def test_mesh_api_tracks_the_jax_shard_map_api(comm, opts):
    """apply_gradients / sharded_update / int8_apply_gradients /
    bf16_allreduce_mean on the replica mesh against JAX's inside a
    shard_map over 4 fake CPU devices, on the same per-replica grads g and
    rounding keys. sharded and pmean: rtol 1e-6. bf16: within lr x 2^-6 x
    max|g| (XLA orders and rounds its bf16 psum itself: a few bf16
    roundings of the mean). int8: within one quantization step of the
    mean, lr x max|g| / 127, and n of them on the residual (an ulp of the
    mean from XLA's fused dequantising sum can move a re-quantized value
    one step, and the owner's residual carries its error x n)."""
    jax = _jax()
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from pytorch_ddp_mnist_tpu.compat import shard_map
    from pytorch_ddp_mnist_tpu.parallel import collectives as jc
    params = MLP.from_seed(0).params()
    rng = np.random.default_rng(1)
    grads = [{n: {k: torch.from_numpy(rng.normal(
        size=tuple(v.shape)).astype(np.float32) * 0.01)
        for k, v in layer.items()} for n, layer in params.items()}
        for _ in range(N)]
    words = np.stack([np.asarray(jax.random.key_data(jax.random.fold_in(
        jax.random.fold_in(jax.random.key(3), r), 7))) for r in range(N)])
    stochastic = opts.get("stochastic", False)
    overlap = opts.get("overlap", False)
    g_max = max(float(g[n][k].abs().max()) for g in grads for n in g
                for k in g[n])
    elems = tc.comm_state_elems(params, N)
    resid = (rng.normal(size=(N, elems)).astype(np.float32) * 1e-4
             if opts.get("feedback") else None)

    def body(p, g, w, r):
        g = jax.tree_util.tree_map(lambda a: a[0], g)
        key = jax.random.wrap_key_data(w[0]) if stochastic else None
        if comm == "sharded":
            return jc.sharded_update(p, g, LR, "dp", N), r
        if comm == "int8":
            fresh, nr = jc.int8_apply_gradients(
                p, g, LR, "dp", N, resid=r[0] if resid is not None else None)
            return fresh, (nr[None] if nr is not None else r)
        return jc.apply_gradients(p, g, LR, "dp", comm, N, rounding_key=key,
                                  overlap=overlap), r
    run = jax.jit(shard_map(body, mesh=_jax_mesh(N),
                            in_specs=(P(), P("dp"), P("dp"), P("dp")),
                            out_specs=(P(), P("dp")), check_vma=False))
    np_params = _numpy(params)
    np_grads = {n: {k: np.stack([g[n][k].numpy() for g in grads])
                    for k in layer} for n, layer in np_params.items()}
    jr = resid if resid is not None else np.zeros((N, 1), np.float32)
    jp, jres = run(np_params, np_grads, words.astype(np.uint32), jr)
    if comm == "sharded":
        got = tc.sharded_update(params, grads, LR)
    elif comm == "int8":
        got, tres = tc.int8_apply_gradients(params, grads, LR, resid=resid)
        if resid is not None:
            assert np.abs(tres.numpy() - np.asarray(jres)).max() <= \
                N * g_max / 127
        else:
            assert tres is None
    else:
        got = tc.apply_gradients(
            params, grads, LR, comm, overlap=overlap,
            rounding_key=torch.from_numpy(words.astype(np.int64))
            if stochastic else None)
    for n in jp:
        for k in jp[n]:
            want = np.asarray(jp[n][k])
            if comm in ("sharded", "pmean"):
                np.testing.assert_allclose(got[n][k].numpy(), want,
                                           rtol=1e-6, atol=1e-7)
            else:
                bound = LR * g_max * (2.0 ** -6 if comm == "bf16"
                                      else 1.0 / 127)
                assert np.abs(got[n][k].numpy() - want).max() <= bound
    if comm == "bf16" and not overlap:
        mean = tc.bf16_allreduce_mean(grads, rounding_keys=[
            threefry.split_words(torch.from_numpy(w.astype(np.int64)), 5)
            for w in words] if stochastic else None)
        for n in mean:
            for k in mean[n]:
                fresh = params[n][k].detach() - mean[n][k] * LR
                assert torch.equal(fresh, got[n][k])


# ------------------------------------------------ the step on the mesh --

@pytest.mark.parametrize("case", list(CASES))
def test_strategy_on_the_mesh_against_pmean_and_jax(case, pmean_ref):
    kw = CASES[case]
    got, step = _port_train(kw)
    drift = _worst(got, pmean_ref)
    if kw["comm"] in ("sharded", "pmean"):
        for n in got:
            for k in got[n]:
                np.testing.assert_allclose(got[n][k], pmean_ref[n][k],
                                           rtol=1e-6, atol=1e-7)
    elif kw["comm"] == "bf16":
        assert 0 < drift < 1e-4, drift
    else:
        assert 0 < drift < 1e-3, drift
    assert _worst(got, _jax_train(kw)) < 1e-4
    again, _ = _port_train(kw)
    assert _worst(got, again) == 0
    assert step.ddp_comm == kw["comm"] and step.ddp_devices == N
    assert step.comm_state == (kw["comm"] == "int8"
                               and kw.get("error_feedback", True))
    assert step.collective_schedule(got) == tc.collective_schedule(
        got, N, kw["comm"], overlap=kw.get("overlap", False))


def test_pmean_is_untouched_and_matches_jax(pmean_ref):
    assert _worst(pmean_ref, _jax_train({"comm": "pmean"})) < 1e-6


@pytest.mark.parametrize("comm", ["sharded", "bf16", "int8"])
def test_small_buckets_keep_every_strategy(comm):
    one, _ = _port_train({"comm": comm})
    many, _ = _port_train({"comm": comm, "bucket_elems": 20_000})
    if comm == "sharded":
        assert _worst(one, many) == 0
    else:
        assert _worst(one, many) < 1e-3


@pytest.mark.parametrize("case", ["sharded", "bf16_stochastic", "int8",
                                  "pmean_overlap"])
def test_cached_captured_body_is_the_eager_host_loop_bitwise(case):
    """The scan's captured step (CachedSteps; on the CPU the same body runs
    eagerly on the static buffers) against the eager host loop a world
    runs (`_dp_steps_epoch`), 2 epochs each, both with the strategy."""
    kw = CASES[case]
    split = synthetic_mnist(256, seed=2)
    x_all = torch.from_numpy(scan.resident_images(split.images))
    y_all = torch.from_numpy(split.labels.astype(np.int32))
    sampler = ShardedSampler(256, seed=42)
    idxs = []
    for e in range(2):
        sampler.set_epoch(e)
        idxs.append(scan.epoch_batch_indices(sampler, 64))
    params = MLP.from_seed(0).params()
    runs = []
    for mesh in ((CPU,) * N, WorldMesh([CPU] * N, world_size=1, rank=0)):
        run = scan.make_dp_run_fn(mesh, LR, **kw)
        p, key, losses = run(params, threefry.key_data(1), x_all, y_all,
                             np.stack(idxs))
        runs.append((losses.numpy(), _numpy(p), key,
                     run.comm.resid.clone() if run.comm.resid is not None
                     else None))
    (l0, p0, k0, r0), (l1, p1, k1, r1) = runs
    np.testing.assert_array_equal(l0, l1)
    assert _worst(p0, p1) == 0 and k0 == k1
    if r0 is not None:
        assert torch.equal(r0, r1) and r0.abs().max() > 0


def test_int8_residual_is_comm_state():
    got, step = _port_train({"comm": "int8"}, steps=2)
    resid = step.comm.resid
    assert resid.shape == (N, tc.comm_state_elems(got, N))
    assert resid.abs().max() > 0
    with pytest.raises(ValueError, match="does not fit this run"):
        step.place_comm_state(MLP.from_seed(0).params(),
                              np.zeros((N, 7), np.float32))
    step.place_comm_state(MLP.from_seed(0).params(), resid.numpy())
    assert torch.equal(step.comm.resid, resid)
    with pytest.raises(RuntimeError, match="place_state"):
        tc.DPComm((CPU,) * 2, LR, "int8").update(
            MLP.from_seed(0).params(), [torch.zeros(())] * 2,
            [MLP.from_seed(0).params()] * 2)


@pytest.mark.parametrize("comm", ["sharded", "int8"])
def test_fit_cached_runs_the_strategy_and_carries_the_residual(comm):
    from pytorch_ddp_mnist_tpu_torch.data.mnist import normalize_images
    split = synthetic_mnist(256, seed=2)
    test = synthetic_mnist(32, seed=3)
    model = MLP.from_seed(0)
    key, hist = scan.fit_cached(
        model, threefry.key_data(1), split.images, split.labels,
        ShardedSampler(256, seed=42), normalize_images(test.images),
        test.labels.astype(np.int32), epochs=2, batch_size=64, lr=LR,
        mesh=(CPU,) * N, comm=comm, log=lambda _m: None)
    assert np.isfinite(np.stack(hist)).all()
    comm_obj = scan.fit_cached.comm
    assert comm_obj.comm == comm
    if comm == "int8":
        assert comm_obj.resid.abs().max() > 0


def test_zoo_model_on_the_mesh_with_a_strategy():
    got, _ = _port_train({"comm": "int8"}, model="deep_mlp", scale=2,
                         steps=2)
    ref, _ = _port_train({"comm": "pmean"}, model="deep_mlp", scale=2,
                         steps=2)
    assert 0 < _worst(got, ref) < 1e-3


# --------------------------------------------------------------- refusals --

def test_validators_refuse_by_name():
    with pytest.raises(ValueError, match="unknown DDP comm strategy"):
        tc.validate_comm("nccl")
    with pytest.raises(ValueError, match="never casts"):
        tc.validate_bf16_rounding("stochastic", "pmean")
    with pytest.raises(ValueError, match="must be 'nearest' or 'stochastic'"):
        tc.validate_bf16_rounding("up", "bf16")
    for qb, ef, comm, match in ((4, True, "int8", "int >= 8"),
                                (True, True, "int8", "int >= 8"),
                                (64, True, "pmean", "never quantizes"),
                                (None, False, "sharded", "no quantization "
                                                         "error")):
        with pytest.raises(ValueError, match=match):
            tc.validate_int8_options(qb, ef, comm)
    tc.validate_int8_options(tc.QUANT_BLOCK, True, "pmean")
    with pytest.raises(ValueError, match="int8_apply_gradients"):
        tc.apply_gradients(MLP.from_seed(0).params(), [], LR, "int8")
    with pytest.raises(ValueError, match="fused Pallas DP"):
        fused_step.make_pallas_dp_train_step((CPU,) * 2, LR, comm="int8")
    with pytest.raises(ValueError, match="IN-kernel"):
        scan.make_dp_run_fn((CPU,) * 2, LR, kernel="pallas_epoch",
                            overlap=True)
    with pytest.raises(ValueError, match="needs a mesh"):
        scan.fit_cached(MLP.from_seed(0), (0, 1), np.zeros((8, 28, 28),
                                                           np.uint8),
                        np.zeros(8), ShardedSampler(8), np.zeros((1, 784)),
                        np.zeros(1), epochs=1, batch_size=8, lr=LR,
                        comm="sharded")
    assert tc.carries_state("int8") and not tc.carries_state("int8", False)
    assert tc.step_cost_label("bf16", True) == "ddp.step.bf16+overlap"


@pytest.mark.parametrize("argv,match", [
    (["--ddp_comm", "sharded"], "it needs --parallel"),
    (["--parallel", "--ddp_comm", "bf16", "--cached", "--kernel",
      "pallas_epoch"], "performs its allreduce IN-kernel"),
    (["--parallel", "--bf16_rounding", "stochastic"], "never casts"),
    (["--parallel", "--quant_block", "64"], "never quantizes to int8"),
    (["--parallel", "--error_feedback", "off"], "no quantization error"),
    (["--parallel", "--ddp_comm", "int8", "--quant_block", "4"],
     "int >= 8"),
    (["--param_scale", "0"], "param_scale must be an int >= 1"),
    (["--overlap"], "it needs --parallel"),
    (["--parallel", "--overlap", "--kernel", "pallas"],
     r"need\(s\) --kernel xla"),
    (["--parallel", "--ddp_comm", "int8", "--kernel", "pallas"],
     "error-feedback state threading"),
    (["--model", "deep_mlp", "--kernel", "pallas"], "non-reference shapes"),
    (["--model", "deep_mlp", "--dropout_rng", "torch"],
     "masks sized for the reference"),
])
def test_cli_refuses_the_jax_comm_and_zoo_combinations_by_name(argv, match):
    with pytest.raises(SystemExit, match=match):
        configure(["--device", "cpu", *argv])


def test_cli_resolves_kernel_auto_to_xla_for_the_xla_only_options():
    for argv in (["--parallel", "--overlap"], ["--parallel", "--ddp_comm",
                                               "int8"],
                 ["--model", "mlp", "--param_scale", "2"]):
        assert configure(argv)["trainer"]["kernel"] == "xla"
    assert configure(["--parallel", "--ddp_comm", "sharded"])["trainer"][
        "kernel"] == "auto"


# ------------------------------------------------- metrics, probe, bench --

def test_ddp_comm_recorder_publishes_metrics(monkeypatch):
    from pytorch_ddp_mnist_tpu_torch import telemetry
    reg = MetricsRegistry()
    monkeypatch.setattr(telemetry, "get_registry", lambda: reg)
    params = MLP.from_seed(0).params()
    comm = tc.DPComm((CPU,) * N, LR, "int8")
    record = ddp.make_ddp_comm_recorder((CPU,) * N, comm, params)
    record(3, params)
    snap = reg.snapshot()["counters"]
    assert snap["ddp.bytes_on_wire"] == 3 * tc.bytes_on_wire(params, N,
                                                             "int8")
    assert snap["ddp.bytes_moved"] == 3 * tc.bytes_moved(params, N, "int8")


@pytest.mark.parametrize("comm", tc.STRATEGIES)
def test_comm_probe_runs_every_strategy(comm):
    params = MLP.from_seed(0).params()
    probe = tc.make_comm_probe((CPU,) * N, comm)
    out = probe(params)
    assert _worst(_numpy(out), _numpy(params)) < 1e-2
    secs = tc.measure_collective_seconds(probe, params, reps=2)
    assert len(secs) == 2 and min(secs) > 0


def test_bench_ddp_mode_plumbing_and_refusals(capsys):
    rows = bench.run_ddp_rows(CPU, strategies=("pmean", "int8"), replicas=2,
                              per_replica_batch=16, epochs=1, n_rows=64,
                              windows=1, model="deep_mlp", param_scale=1)
    assert [r["strategy"] for r in rows] == ["pmean", "int8"]
    assert rows[0]["parity_max_abs_diff_vs_pmean"] == 0
    assert rows[1]["bytes_on_wire_per_step_per_replica"] < \
        rows[0]["bytes_on_wire_per_step_per_replica"]
    assert rows[1]["bytes_moved_per_step_per_replica"] >= \
        rows[1]["bytes_on_wire_per_step_per_replica"]
    for argv, match in ((["--mode", "ddp", "--replicas", "1"],
                         "mesh of 2 or more"),
                        (["--mode", "train", "--overlap"], "ddp-mode knob"),
                        (["--mode", "ddp", "--param_scale", "0"],
                         "param_scale must be"),
                        (["--mode", "eval", "--replicas", "2"],
                         "serve- or ddp-mode knob")):
        with pytest.raises(SystemExit):
            bench.main(argv)
        assert match in capsys.readouterr().err


# ------------------------------------------------------- a 2-rank world --

WORLD_STEPS = 4


def _world_rows(hp, world):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_port_world import _shards
    return _shards(hp, world)


def _world_hp():
    return dict(n=512, local_batch=16, data_seed=0, sampler_seed=42,
                param_seed=0, key_seed=1)


def _stream(mesh, kw, hp, x_all, y_all, rows_of_step):
    step = ddp.make_dp_train_step(mesh, LR, **kw)
    m = MLP.from_seed(hp["param_seed"])
    step.place_comm_state(m.params())
    key, losses = threefry.key_data(hp["key_seed"]), []
    for s in range(WORLD_STEPS):
        rows = rows_of_step(s)
        key, loss = step(m, key, torch.from_numpy(x_all[rows]),
                         torch.from_numpy(y_all[rows]))
        losses.append(loss)
    resid = step.comm.resid
    return {"losses": torch.stack(losses), "params": m.params(),
            "resid": resid.clone() if resid is not None else None}


def _cached(mesh, kw, hp):
    split = synthetic_mnist(256, seed=hp["data_seed"])
    x_all = torch.from_numpy(scan.resident_images(split.images))
    y_all = torch.from_numpy(split.labels.astype(np.int32))
    sampler = ShardedSampler(256, seed=hp["sampler_seed"])
    idx = scan.epoch_rows(sampler, 64, mesh)
    run = scan.make_dp_run_fn(mesh, LR, **kw)
    p, _, losses = run(MLP.from_seed(0).params(), threefry.key_data(1),
                       x_all, y_all, idx[None])
    return {"losses": losses, "params": p}


def _world_data(hp):
    from pytorch_ddp_mnist_tpu_torch.data.mnist import normalize_images
    split = synthetic_mnist(hp["n"], seed=hp["data_seed"])
    return normalize_images(split.images), split.labels.astype(np.int32)


def _rank_main(out: str) -> int:
    torch.set_num_threads(1)
    hp = _world_hp()
    rt = wireup.initialize_runtime("env", device_type="cpu")
    mesh = WorldMesh([rt.device], world_size=rt.size, rank=rt.rank)
    x_all, y_all = _world_data(hp)
    shard = _world_rows(hp, rt.size)[rt.rank]
    lb = hp["local_batch"]
    for case, kw in CASES.items():
        res = _stream(mesh, kw, hp, x_all, y_all,
                      lambda s: shard[s * lb:(s + 1) * lb])
        res["cached"] = _cached(mesh, kw, hp)
        torch.save(res, os.path.join(out, f"rank{rt.rank}_{case}.pt"))
    rt.finalize()
    return 0


@pytest.fixture(scope="module")
def world_out(tmp_path_factory):
    from test_torch_port_world import _run_world
    out = tmp_path_factory.mktemp("comm_world")
    _run_world([sys.executable, os.path.abspath(__file__), "--rank", "--out",
                str(out)], world=2)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_gloo_world_is_the_two_replica_mesh_bitwise(case,
                                                             world_out):
    hp = _world_hp()
    x_all, y_all = _world_data(hp)
    shards = _world_rows(hp, 2)
    lb = hp["local_batch"]
    mesh = (CPU, CPU)
    want = _stream(mesh, CASES[case], hp, x_all, y_all,
                   lambda s: np.concatenate([sh[s * lb:(s + 1) * lb]
                                             for sh in shards]))
    want_cached = _cached(mesh, CASES[case], hp)
    for rank in range(2):
        got = torch.load(os.path.join(world_out, f"rank{rank}_{case}.pt"),
                         weights_only=False)
        assert torch.equal(got["losses"], want["losses"])
        assert _worst(_numpy(got["params"]), _numpy(want["params"])) == 0
        if want["resid"] is not None:
            assert torch.equal(got["resid"][0], want["resid"][rank])
        assert torch.equal(got["cached"]["losses"], want_cached["losses"])
        assert _worst(_numpy(got["cached"]["params"]),
                      _numpy(want_cached["params"])) == 0


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--rank", action="store_true")
    p.add_argument("--out", required=True)
    sys.exit(_rank_main(p.parse_args().out))
