"""The streaming trainer's key chain, the superstep and the in-kernel-dropout
step of the port against the JAX package, on the CPU.

* The streaming `fit` keys its dropout by jax's threefry chain: the same
  rows, weights (through `from_jax_params`) and seed through JAX's
  streaming `fit` and the port's give bitwise the same keys and masks,
  per-step losses at rtol 1e-5 and params at rtol 1e-4 / atol 1e-6
  (tests/test_torch_port_slice.py's pin for a run).
* The superstep (`steps_per_iter` K) of the epoch kernel's plain version is
  bitwise K = 1, and agrees with JAX `epoch_fused_sgd(steps_per_iter=K,
  interpret=True)` at rtol 1e-5 / atol 1e-6 (JAX's pin for that kernel).
* `pallas_rng` takes JAX's per-step seeds bitwise and draws the port's
  Philox (seed, batch block) stream; the TPU core PRNG has no CUDA twin, so
  its masks are held against that stream, not against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu.data.loader import BatchLoader as JaxLoader
from pytorch_ddp_mnist_tpu.models.mlp import init_mlp
from pytorch_ddp_mnist_tpu.ops import pallas_step as jax_ps
from pytorch_ddp_mnist_tpu.parallel.sampler import ShardedSampler as JaxSampler
from pytorch_ddp_mnist_tpu.train import loop as jax_loop
from pytorch_ddp_mnist_tpu.train import scan as jax_scan
from pytorch_ddp_mnist_tpu_torch import bench
from pytorch_ddp_mnist_tpu_torch.cli import train as port_cli
from pytorch_ddp_mnist_tpu_torch.data.loader import BatchLoader
from pytorch_ddp_mnist_tpu_torch.data.mnist import normalize_images, synthetic_mnist
from pytorch_ddp_mnist_tpu_torch.models.mlp import from_jax_params, to_numpy_params
from pytorch_ddp_mnist_tpu_torch.ops import epoch_step, fused_step, philox, threefry
from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler
from pytorch_ddp_mnist_tpu_torch.train import loop, scan
from pytorch_ddp_mnist_tpu_torch.train.config import configure

RTOL, ATOL = 1e-5, 1e-6


def _jax_params(seed=0):
    return jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.key(seed)))


def _assert_tree_close(got, ref, **tol):
    got = to_numpy_params(got)
    for n in got:
        for k in got[n]:
            np.testing.assert_allclose(got[n][k], np.asarray(ref[n][k]),
                                       err_msg=f"{n}.{k}", **tol)


def _words(key):
    return tuple(np.asarray(jax.random.key_data(key)).tolist())


# ---- the repair: the streaming fit draws JAX's masks ----

@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_streaming_fit_keys_dropout_by_the_jax_chain(kernel):
    n, batch, lr, epochs, seed = 300, 64, 0.05, 2, 3
    split = synthetic_mnist(n, 4)
    x_all = normalize_images(split.images)
    test = synthetic_mnist(100, 5)
    x_test, y_test = normalize_images(test.images), test.labels.astype(np.int32)
    tree = _jax_params()

    # JAX's streaming fit, its step recorded: the key it got and its loss
    inner = (jax_loop.make_train_step(lr) if kernel == "xla" else
             jax_ps.make_pallas_train_step(lr, interpret=True))
    jax_keys, jax_losses = [], []

    def jax_step(params, key, x, y):
        jax_keys.append(_words(key))
        params, key, loss = inner(params, key, x, y)
        jax_losses.append(float(loss))
        return params, key, loss

    state = jax_loop.TrainState(jax.tree_util.tree_map(jnp.asarray, tree),
                                jax.random.key(seed + 1))
    state = jax_loop.fit(state, JaxLoader(x_all, split.labels,
                                          JaxSampler(n, seed=42), batch),
                         x_test, y_test, epochs=epochs, batch_size=batch,
                         train_step=jax_step, log=lambda s: None)

    # the port's streaming fit with the CLI's key, its masks recorded
    port_keys, port_masks = [], []
    draw = fused_step.dropout_mask

    def recorded(key, b, device):
        mask = draw(key, b, device)
        port_masks.append(mask.numpy())
        return mask

    port_step = (loop.make_train_step(lr) if kernel == "xla" else
                 fused_step.make_fused_train_step(lr))

    def step(model, key, x, y):
        port_keys.append(tuple(key))
        return port_step(model, key, x, y)

    orig = (loop.dropout_mask, fused_step.dropout_mask)
    loop.dropout_mask = fused_step.dropout_mask = recorded
    try:
        port_state, history = loop.fit(
            loop.TrainState(from_jax_params(tree), threefry.key_data(seed + 1)),
            BatchLoader(x_all, split.labels, ShardedSampler(n, seed=42), batch),
            x_test, y_test, epochs=epochs, batch_size=batch, train_step=step,
            log=lambda s: None)
    finally:
        loop.dropout_mask, fused_step.dropout_mask = orig

    assert port_keys == jax_keys and len(jax_keys) == epochs * 5
    assert tuple(port_state.key) == _words(state.key)
    for key, mask in zip(jax_keys, port_masks):
        sub = jax.random.split(jax.random.wrap_key_data(
            jnp.asarray(key, jnp.uint32)))[1]
        np.testing.assert_array_equal(mask, np.asarray(
            jax_ps.dropout_mask(sub, batch)))
    np.testing.assert_allclose(np.concatenate(history), jax_losses, rtol=1e-5)
    _assert_tree_close(port_state.model, state.params, rtol=1e-4, atol=1e-6)


def test_cli_streaming_runs_take_the_threefry_key(tmp_path, capsys):
    # `--impl threefry2x32` is the streaming default and may be named;
    # the two kernels draw the same masks, so they agree to f32 rounding
    runs = []
    for kernel in ("xla", "pallas"):
        _, history = port_cli.train(
            ["--device", "cpu", "--limit", "256", "--batch_size", "64",
             "--kernel", kernel, "--impl", "threefry2x32", "--checkpoint", "",
             "--path", str(tmp_path / "none")])
        runs.append(history[0])
    assert "impl=threefry2x32 dtype=float32" in capsys.readouterr().out
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-5)


# ---- the superstep ----

def _epoch_data(nsteps, batch, seed):
    split = synthetic_mnist(nsteps * batch, seed=seed)
    rng = np.random.default_rng(seed)
    masks = (rng.random((nsteps * batch, 128)) < 0.8).astype(np.float32) \
        / np.float32(0.8)
    return (split.images.reshape(nsteps * batch, -1),
            split.labels.astype(np.int32), masks)


@pytest.mark.parametrize("k,rng,valid", [
    pytest.param(2, "masks", None, id="2"),
    pytest.param(4, "masks", None, id="4"),
    pytest.param(8, "masks", None, id="8"),
    pytest.param(4, "masks", 11, id="4-masks-ragged"),
    pytest.param(4, "threefry", 11, id="4-threefry-ragged")])
def test_superstep_plain_is_bitwise_k1_and_tracks_jax(k, rng, valid):
    # K steps an iteration is bitwise K = 1 on the real steps. A ragged
    # epoch (`valid`) is 11 real steps that the hot paths pad to 12 at the
    # index level; the JAX kernel runs the same launch.
    nsteps, batch, lr = (11, 16, 0.01) if valid is None else (12, 8, 0.05)
    real = nsteps if valid is None else valid
    x, y, masks = _epoch_data(nsteps, batch, seed=7)
    keys = None
    if rng == "threefry":
        masks = None
        keys = threefry.to_int32_words(
            threefry.split(threefry.key_data(7), nsteps))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    mt = None if masks is None else torch.from_numpy(masks)
    impl = "threefry" if rng == "threefry" else "core"
    tree = _jax_params()
    n = real * batch
    p1, l1 = epoch_step.epoch_fused_sgd(
        from_jax_params(tree).params(), xt[:n], yt[:n],
        None if keys is None else keys[:real], lr, batch,
        masks=None if mt is None else mt[:n], rng_impl=impl)
    pk, lk = epoch_step.epoch_fused_sgd(
        from_jax_params(tree).params(), xt, yt, keys, lr, batch, masks=mt,
        rng_impl=impl, steps_per_iter=k, valid_steps=valid)
    assert lk.shape == (real,) and torch.equal(lk, l1)
    _assert_tree_close(pk, to_numpy_params(p1), rtol=0, atol=0)
    jp, jl = jax_ps.epoch_fused_sgd(
        tree, jnp.asarray(x), jnp.asarray(y),
        None if keys is None else jnp.asarray(keys.numpy()), lr, batch,
        masks=None if masks is None else jnp.asarray(masks), rng_impl=impl,
        interpret=True, steps_per_iter=k, valid_steps=valid)
    np.testing.assert_allclose(lk.numpy(), np.asarray(jl)[:real], rtol=RTOL,
                               atol=ATOL)
    _assert_tree_close(pk, jp, rtol=RTOL, atol=ATOL)


def test_superstep_valid_steps_trims_index_padding():
    # 11 real steps padded at the index level to 16: the padded steps train
    # nothing, and exactly 11 losses come back
    x, y, masks = _epoch_data(16, 16, seed=2)
    tree = _jax_params()
    xt, yt, mt = (torch.from_numpy(a) for a in (x, y, masks))
    p11, l11 = epoch_step.epoch_fused_sgd(
        from_jax_params(tree).params(), xt[:176], yt[:176], None, 0.01, 16,
        masks=mt[:176])
    p16, l16 = epoch_step.epoch_fused_sgd(
        from_jax_params(tree).params(), xt, yt, None, 0.01, 16, masks=mt,
        steps_per_iter=8, valid_steps=11)
    assert torch.equal(l16, l11)
    _assert_tree_close(p16, to_numpy_params(p11), rtol=0, atol=0)


def _superstep_error_cases():
    x, y, masks = _epoch_data(4, 16, seed=0)
    big = (np.tile(x, (16, 1)), np.tile(y, 16), np.tile(masks, (16, 1)))
    return [
        ((x, y, masks), 16, {"steps_per_iter": 3},
         "steps_per_iter must be 1, 2, 4"),
        (big, 256, {"steps_per_iter": 8}, "VMEM stream budget"),
        ((x, y, masks), 16, {"valid_steps": 9}, "valid_steps=9 must be in"),
    ]


@pytest.mark.parametrize("case", range(3))
def test_superstep_named_errors_match_jax(case):
    (x, y, masks), batch, kw, match = _superstep_error_cases()[case]
    tree = _jax_params()
    with pytest.raises(ValueError, match=match):
        jax_ps.epoch_fused_sgd(tree, jnp.asarray(x), jnp.asarray(y), None,
                               0.01, batch, masks=jnp.asarray(masks),
                               interpret=True, **kw)
    with pytest.raises(ValueError, match=match):
        epoch_step.epoch_fused_sgd(from_jax_params(tree).params(),
                                   torch.from_numpy(x), torch.from_numpy(y),
                                   None, 0.01, batch,
                                   masks=torch.from_numpy(masks), **kw)


@pytest.mark.parametrize("kw,match", [
    ({"kernel": "pallas", "superstep": 2}, "whole-epoch-kernel knob"),
    ({"kernel": "pallas_epoch", "superstep": 5},
     "superstep must be 1, 2, 4 or 8"),
])
def test_scan_superstep_refusals_match_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        jax_scan.make_run_fn(lr=0.01, **kw)
    with pytest.raises(ValueError, match=match):
        scan.make_run_fn(0.01, **kw)


@pytest.mark.parametrize("k", [2, 8])
def test_run_fn_superstep_is_bitwise_k1_and_tracks_jax(k):
    n, nsteps, batch = 100, 5, 16       # ragged at both K
    split = synthetic_mnist(n, seed=3)
    x, y = split.images.reshape(n, -1), split.labels.astype(np.int32)
    rng = np.random.default_rng(0)
    idxs = np.stack([rng.permutation(n)[:nsteps * batch].reshape(nsteps, batch)
                     for _ in range(2)]).astype(np.int32)
    tree = _jax_params()
    args = (threefry.key_data(9), torch.from_numpy(x), torch.from_numpy(y),
            idxs)
    base = scan.make_run_fn(0.05, kernel="pallas_epoch")(
        from_jax_params(tree).params(), *args)
    got = scan.make_run_fn(0.05, kernel="pallas_epoch", superstep=k)(
        from_jax_params(tree).params(), *args)
    assert got[1] == base[1] and torch.equal(got[2], base[2])
    _assert_tree_close(got[0], to_numpy_params(base[0]), rtol=0, atol=0)
    jp, _, jl = jax_scan.make_run_fn(0.05, kernel="pallas_epoch",
                                     interpret=True, superstep=k)(
        jax.tree_util.tree_map(jnp.asarray, tree), jax.random.key(9),
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(idxs))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    _assert_tree_close(got[0], jp, rtol=RTOL, atol=ATOL)


# ---- pallas_rng: the in-kernel dropout of the per-step kernel ----

def test_pallas_rng_seeds_are_jax_key_words():
    # the step seed is the int32 bitcast of word 0 of the step's sub key
    # (JAX train/scan.py `_loss_and_grads`); the port's chain gives it
    key, jkey = threefry.key_data(5), jax.random.key(5)
    for _ in range(6):
        key, sub = threefry.split(key)
        jkey, jsub = jax.random.split(jkey)
        want = jax.lax.bitcast_convert_type(
            jax.random.key_data(jsub).ravel()[0], jnp.int32)
        assert fused_step.rng_seed(sub[0]) == int(want) & 0xFFFFFFFF
        assert fused_step.rng_seed(int(want)) == sub[0]


@pytest.mark.parametrize("batch", [64, 600, 1025])
def test_pallas_rng_plain_mask_is_the_philox_block_stream(batch):
    grid, block = philox.batch_blocks(batch)
    assert (grid, block) == (max(1, -(-batch // jax_ps.MAX_BATCH_BLOCK)),
                             -(-(-(-batch // grid)) // 8) * 8)
    seed = 0x9E3779B9
    mask = fused_step.kernel_rng_mask(seed, batch, "cpu")
    assert mask.shape == (batch, 128)
    for b in range(grid):
        rows = slice(b * block, min((b + 1) * block, batch))
        assert torch.equal(mask[rows], philox.mask_block(
            seed, b, block)[:rows.stop - rows.start])
    assert abs(float((mask > 0).float().mean()) - 0.8) < 0.02


def test_pallas_rng_plain_step_same_seed_same_bits():
    split = synthetic_mnist(96, seed=1)
    x = torch.from_numpy(normalize_images(split.images))
    y = torch.from_numpy(split.labels.astype(np.int32))
    params = from_jax_params(_jax_params(1)).params()
    a = fused_step.fused_loss_and_grads_rng(params, x, y, 7)
    b = fused_step.fused_loss_and_grads_rng(params, x, y, 7)
    c = fused_step.fused_loss_and_grads_rng(params, x, y, 8)
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    for n in a[1]:
        for k in a[1][n]:
            assert torch.equal(a[1][n][k], b[1][n][k])
    ref = fused_step.fused_loss_and_grads(params, x, y,
                                          philox.rng_mask(7, 96))
    assert torch.equal(a[0], ref[0])


def test_scan_pallas_rng_trains():
    # JAX's tests/test_pallas_step.py::test_scan_pallas_rng_trains, on the CPU
    split = synthetic_mnist(1024, seed=5)
    x_all = torch.from_numpy(normalize_images(split.images))
    y_all = torch.from_numpy(split.labels.astype(np.int32))
    idxs = np.arange(1024, dtype=np.int32).reshape(1, 8, 128)
    run = scan.make_run_fn(0.1, kernel="pallas_rng")
    params = from_jax_params(_jax_params(0)).params()
    _, _, losses = run(params, threefry.key_data(1), x_all, y_all,
                       np.concatenate([idxs] * 4))
    losses = losses.numpy().ravel()
    assert np.isfinite(losses).all() and losses[-1] < losses[0] * 0.7


# ---- front doors ----

@pytest.mark.parametrize("argv,match", [
    (["--kernel", "pallas_rng"], "pallas_rng runs inside the epoch scan"),
    (["--impl", "rbg", "--kernel", "pallas"], "--impl rbg.*--cached"),
])
def test_cli_refuses_what_jax_refuses(argv, match):
    with pytest.raises(SystemExit, match=match):
        configure(["--device", "cpu", *argv])


def test_cli_cached_pallas_rng_trains_on_the_cpu(tmp_path, capsys):
    before = dict(fused_step.launch_count)
    _, history = port_cli.train(
        ["--device", "cpu", "--cached", "--kernel", "pallas_rng", "--limit",
         "256", "--batch_size", "64", "--checkpoint", "",
         "--path", str(tmp_path / "none")])
    assert "kernel=pallas_rng cached" in capsys.readouterr().out
    assert history[0].shape == (4,) and np.isfinite(history[0]).all()
    assert dict(fused_step.launch_count) == before


def test_bench_superstep_refusals(capsys):
    with pytest.raises(SystemExit) as e:
        bench.main(["--superstep", "3"])
    assert e.value.code == 2 and "--superstep" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="whole-epoch-kernel knob"):
        bench.main(["--superstep", "2", "--kernel", "xla"])
    assert bench.resolve_bench_config("auto", 0) == ("float32", 1)
    assert bench.resolve_bench_config("bfloat16", 8) == ("bfloat16", 8)


def test_bench_fields_carry_dtype_and_superstep():
    # plumbing only: a CPU time is no device number and is not recorded
    out = bench.run_train_bench(torch.device("cpu"), epochs=1, batch_size=64,
                                kernel="pallas_epoch", impl="rbg",
                                dtype="bfloat16", superstep=2, n_train=256,
                                windows=1)
    assert out["value"] > 0
    assert (out["dtype"], out["superstep"]) == ("bfloat16", 2)


def test_build_hash_covers_every_source_and_header(monkeypatch, tmp_path):
    # every CUDA source of the port is built, and an edit to any header or
    # to a library's own source gives that library a new file name
    from pytorch_ddp_mnist_tpu_torch.ops import _build
    assert sorted(_build.SOURCES.values()) == sorted(
        p.name for p in _build.CSRC.glob("*.cu"))
    for name in ("a.cu", "b.cu", "h.cuh", "g.cuh"):
        (tmp_path / name).write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "SOURCES", {"a": "a.cu", "b": "b.cu"})
    before = {n: _build._target(n) for n in ("a", "b")}
    (tmp_path / "g.cuh").write_text("// g, edited\n")
    after = {n: _build._target(n) for n in ("a", "b")}
    assert all(after[n] != before[n] for n in after)
    (tmp_path / "b.cu").write_text("// b, edited\n")
    assert _build._target("a") == after["a"] and _build._target("b") != after["b"]
