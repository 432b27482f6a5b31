"""The port's resident-dataset trainer (train/scan.py), its CLI branch and
its bench, against the JAX package on the CPU.

The same weights (through `from_jax_params`), sampler indices and threefry
train key go through JAX `make_run_fn` / `fit_cached` (the Pallas epoch
kernel interpreted, so its masks come from the same key chain as the
port's in-kernel threefry draw) and through the port's counterparts, whose
kernels run their plain versions on the CPU. Losses and params agree at
rtol 1e-5 / atol 1e-6 (the JAX package's pin for its epoch kernel), the
printed epoch-line numbers at rtol 1e-5; indices, keys and the normalize
are bitwise.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu.models.mlp import init_mlp
from pytorch_ddp_mnist_tpu.parallel.sampler import ShardedSampler as JaxSampler
from pytorch_ddp_mnist_tpu.train import loop as jax_loop
from pytorch_ddp_mnist_tpu.train import scan as jax_scan
from pytorch_ddp_mnist_tpu_torch import __main__ as port_main
from pytorch_ddp_mnist_tpu_torch import bench
from pytorch_ddp_mnist_tpu_torch.cli import train as port_cli
from pytorch_ddp_mnist_tpu_torch.data.mnist import normalize_images, synthetic_mnist
from pytorch_ddp_mnist_tpu_torch.models.mlp import from_jax_params, to_numpy_params
from pytorch_ddp_mnist_tpu_torch.ops import epoch_step, fused_step, threefry
from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler
from pytorch_ddp_mnist_tpu_torch.telemetry.dispatch import DispatchProfiler
from pytorch_ddp_mnist_tpu_torch.train import loop, scan
from pytorch_ddp_mnist_tpu_torch.train.config import configure

RTOL, ATOL = 1e-5, 1e-6


def _jax_params(seed=0):
    return jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.key(seed)))


def _key_tuple(key):
    return tuple(np.asarray(jax.random.key_data(key)).tolist())


def _assert_tree_close(got, ref, **tol):
    got = to_numpy_params(got)
    for n in got:
        for k in got[n]:
            np.testing.assert_allclose(got[n][k], np.asarray(ref[n][k]),
                                       err_msg=f"{n}.{k}", **tol)


# ---- data placement ----

def test_device_normalize_is_bitwise_on_every_byte_and_on_rows():
    every = np.tile(np.arange(256, dtype=np.uint8), 4)[:784][None]
    rows = synthetic_mnist(64, seed=2).images.reshape(64, -1)
    for u8 in (every, rows):
        port = scan.device_normalize(torch.from_numpy(u8)).numpy()
        jax_out = np.asarray(jax_scan.device_normalize(jnp.asarray(u8)))
        assert port.dtype == np.float32
        np.testing.assert_array_equal(port.view(np.uint32),
                                      jax_out.view(np.uint32))
        np.testing.assert_array_equal(port, normalize_images(u8))


def test_resident_images_and_epoch_batch_indices_are_bitwise():
    images = synthetic_mnist(300, seed=1).images
    for arr in (images, normalize_images(images).astype(np.float64)):
        port, ref = scan.resident_images(arr), jax_scan.resident_images(arr)
        assert port.dtype == ref.dtype and port.flags.c_contiguous
        np.testing.assert_array_equal(port, ref)
    for batch in (64, 128, 7):
        port, ref = ShardedSampler(300, seed=42), JaxSampler(300, seed=42)
        for epoch in range(3):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            got = scan.epoch_batch_indices(port, batch)
            want = jax_scan.epoch_batch_indices(ref, batch)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)


# ---- the run programs against JAX make_run_fn ----

def _run_inputs(epochs=3, nsteps=4, batch=16, n=100):
    split = synthetic_mnist(n, seed=3)
    x = split.images.reshape(n, -1)
    y = split.labels.astype(np.int32)
    rng = np.random.default_rng(0)
    idxs = np.stack([rng.permutation(n)[:nsteps * batch].reshape(nsteps, batch)
                     for _ in range(epochs)]).astype(np.int32)
    return x, y, idxs


@pytest.mark.parametrize("kernel", ["pallas_epoch", "xla", "pallas"])
def test_make_run_fn_matches_jax_over_three_epochs(kernel):
    x, y, idxs = _run_inputs()
    tree = _jax_params()
    jax_out = jax_scan.make_run_fn(0.05, kernel=kernel, interpret=True,
                                   snapshots=True)(
        jax.tree_util.tree_map(jnp.asarray, tree), jax.random.key(9),
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(idxs))
    params = from_jax_params(tree).params()
    port = scan.make_run_fn(0.05, kernel=kernel, snapshots=True)(
        params, threefry.key_data(9), torch.from_numpy(x), torch.from_numpy(y),
        idxs)
    j_params, j_key, j_losses, (j_snaps, j_ksnaps) = jax_out
    p_params, p_key, p_losses, (p_snaps, p_ksnaps) = port
    assert p_losses.shape == (3, 4)
    np.testing.assert_allclose(p_losses.numpy(), np.asarray(j_losses),
                               rtol=RTOL, atol=ATOL)
    _assert_tree_close(p_params, j_params, rtol=RTOL, atol=ATOL)
    _assert_tree_close(p_snaps, j_snaps, rtol=RTOL, atol=ATOL)
    assert p_key == _key_tuple(j_key)
    assert p_ksnaps == [tuple(k) for k in
                        np.asarray(jax.random.key_data(j_ksnaps)).tolist()]
    # the last snapshot is the returned params, and the input was not written
    _assert_tree_close(jax.tree_util.tree_map(lambda a: a[-1], p_snaps),
                       to_numpy_params(p_params), rtol=0, atol=0)
    _assert_tree_close(params, tree, rtol=0, atol=0)


def test_epoch_fn_is_the_first_epoch_of_the_run():
    x, y, idxs = _run_inputs(epochs=1)
    tree = _jax_params()
    args = (threefry.key_data(3), torch.from_numpy(x), torch.from_numpy(y))
    run = scan.make_run_fn(0.05, kernel="pallas_epoch", impl="rbg")
    p_run, k_run, l_run = run(from_jax_params(tree).params(), *args, idxs)
    epoch = scan.make_epoch_fn(0.05, kernel="pallas_epoch", impl="rbg")
    p_ep, k_ep, l_ep = epoch(from_jax_params(tree).params(), *args, idxs[0])
    assert k_run == k_ep and torch.equal(l_run[0], l_ep)
    _assert_tree_close(p_ep, to_numpy_params(p_run), rtol=0, atol=0)


@pytest.mark.parametrize("kw,match", [
    ({"kernel": "pallas_epoch", "superstep": 3}, "superstep must be 1, 2, 4 or 8"),
    ({"kernel": "xla", "superstep": 2}, "whole-epoch-kernel knob"),
    ({"kernel": "pallas_epoch", "unroll": 2}, "no per-step scan to unroll"),
    ({"kernel": "pallas", "unroll": 4}, "nothing to unroll"),
    ({"kernel": "pallas_rng", "superstep": 4}, "whole-epoch-kernel knob"),
    ({"kernel": "xla", "dtype": "float16"}, "unknown dtype"),
    ({"kernel": "xla", "impl": "rbg"}, "rbg"),
    ({"kernel": "nope"}, "unknown kernel"),
])
def test_run_fn_refuses_by_name(kw, match):
    with pytest.raises(ValueError, match=match):
        scan.make_run_fn(0.01, **kw)


# ---- fit_cached against JAX fit_cached ----

_LINE = re.compile(r"^Epoch=(\d+), train_loss=(\S+), val_loss=(\S+)  "
                   r"\[mean_train=(\S+) mean_val=(\S+) acc=(\S+) ")


def _line_numbers(lines):
    out = []
    for line in lines:
        m = _LINE.match(line)
        assert m, line
        out.append([float(v) for v in m.groups()])
    return np.array(out)


@pytest.mark.parametrize("fused", [False, True], ids=["per_epoch", "fused"])
@pytest.mark.parametrize("kernel", ["pallas_epoch", "xla"])
def test_fit_cached_prints_jax_epoch_lines(kernel, fused):
    n, batch, epochs = 160, 16, 2
    train, test = synthetic_mnist(n, seed=4), synthetic_mnist(64, seed=5)
    y_train = train.labels.astype(np.int32)
    x_test = normalize_images(test.images)
    y_test = test.labels.astype(np.int32)
    tree = _jax_params()

    jax_lines = []
    jax_scan.fit_cached(
        jax_loop.TrainState(jax.tree_util.tree_map(jnp.asarray, tree),
                            jax.random.key(1)),
        train.images, y_train, JaxSampler(n, seed=42), x_test, y_test,
        epochs=epochs, batch_size=batch, lr=0.05, kernel=kernel,
        interpret=True, fused=fused, log=jax_lines.append)

    port_lines = []
    model = from_jax_params(tree)
    key, history = scan.fit_cached(
        model, threefry.key_data(1), train.images, y_train,
        ShardedSampler(n, seed=42), x_test, y_test, epochs=epochs,
        batch_size=batch, lr=0.05, kernel=kernel, fused=fused,
        log=port_lines.append)
    assert len(history) == epochs and history[0].shape == (n // batch,)
    got, want = _line_numbers(port_lines), _line_numbers(jax_lines)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])          # epochs
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=RTOL)
    assert all(torch.isfinite(p).all() for p in model.parameters())


@pytest.mark.parametrize("kw,where", [
    ({"mesh": (torch.device("cpu"),) * 2, "comm": "int8",
      "kernel": "pallas_epoch"}, "IN-kernel"),
    ({"ckpt_every_steps": 5, "fused": True}, "fused=True runs all epochs"),
    ({"step_hook": print, "fused": True}, "needs per-chunk host control"),
    ({"start_offset": 3, "kernel": "pallas_epoch"}, "fork the RNG chain"),
    ({"watchdog": object(), "fused": True}, "live health monitoring"),
    ({"dispatch_profiler": DispatchProfiler(), "fused": True},
     "dispatch profiling decomposes"),
])
def test_fit_cached_refuses_unported_options_by_name(kw, where):
    split = synthetic_mnist(32, seed=0)
    with pytest.raises(ValueError, match=where):
        scan.fit_cached(from_jax_params(_jax_params()), (0, 1), split.images,
                        split.labels, ShardedSampler(32), split.images,
                        split.labels, epochs=1, batch_size=16, lr=0.01, **kw)


def test_snapshot_eval_matches_jax():
    trees = [_jax_params(s) for s in range(3)]
    test = synthetic_mnist(50, seed=6)
    x, y = normalize_images(test.images), test.labels.astype(np.int32)
    stacked = jax.tree_util.tree_map(lambda *a: np.stack(a), *trees)
    j_ps, j_corr = jax_loop.make_snapshot_eval_step()(
        stacked, jnp.asarray(x), jnp.asarray(y))
    p_snaps = {n: {k: torch.from_numpy(v) for k, v in layer.items()}
               for n, layer in stacked.items()}
    p_ps, p_corr = loop.make_snapshot_eval_step()(
        p_snaps, torch.from_numpy(x), torch.from_numpy(y))
    assert p_ps.shape == (3, 50)
    np.testing.assert_allclose(p_ps.numpy(), np.asarray(j_ps), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(p_corr.numpy(), np.asarray(j_corr))


# ---- the CLI ----

@pytest.mark.parametrize("argv,match", [
    (["--kernel", "pallas_epoch"], "add --cached"),
    (["--cached", "--kernel", "pallas_epoch", "--batch_size", "100"],
     "divisible by 8"),
    (["--cached", "--kernel", "pallas_epoch", "--batch_size", "2048"],
     "<= 1024"),
    (["--fused"], "--fused fuses the epoch scan; add --cached"),
    (["--impl", "rbg"], "--impl.*--cached"),
    (["--kernel", "pallas_rng"], "pallas_rng runs inside the epoch scan; "
     "add --cached"),
])
def test_cli_refuses_unsound_combinations_by_name(argv, match):
    with pytest.raises(SystemExit, match=match):
        configure(["--device", "cpu", *argv])


def test_cli_refuses_rbg_on_the_per_step_kernels(tmp_path):
    with pytest.raises(SystemExit, match="rbg"):
        port_cli.main(["--device", "cpu", "--cached", "--kernel", "xla",
                       "--impl", "rbg", "--path", str(tmp_path / "none")])


@pytest.mark.parametrize("extra,epochs", [
    (["--kernel", "pallas_epoch"], 1),
    (["--kernel", "pallas_epoch", "--fused", "--impl", "rbg"], 2),
    (["--kernel", "pallas"], 1),
])
def test_cli_cached_trains_on_the_cpu(tmp_path, capsys, extra, epochs):
    before = (dict(fused_step.launch_count), dict(epoch_step.launch_count))
    ckpt = tmp_path / "m.pt"
    state, history = port_cli.train(
        ["--device", "cpu", "--cached", "--limit", "256", "--batch_size", "64",
         "--n_epochs", str(epochs), "--checkpoint", str(ckpt),
         "--path", str(tmp_path / "no_mnist"), *extra])
    out = capsys.readouterr().out
    assert "cached" in out
    for e in range(epochs):
        assert re.search(rf"^Epoch={e}, train_loss=\S+, val_loss=\S+", out,
                         re.M)
    assert len(history) == epochs and history[0].shape == (4,)
    assert np.isfinite(np.concatenate(history)).all() and ckpt.exists()
    # the CPU runs the plain versions: no kernel is launched
    assert (dict(fused_step.launch_count),
            dict(epoch_step.launch_count)) == before


# ---- the bench ----

def test_bench_kernel_policy_and_refusals(monkeypatch):
    assert bench.resolve_bench_kernel("auto", "float32", "cuda") == "pallas_epoch"
    assert bench.resolve_bench_kernel("auto", "float32", "cuda",
                                      batch=100) == "pallas"
    assert bench.resolve_bench_kernel("auto", "float32", "cuda",
                                      unroll=2) == "pallas"
    assert bench.resolve_bench_kernel("auto", "float32", "cpu") == "xla"
    assert bench.resolve_bench_kernel("xla", "float32", "cuda") == "xla"
    for argv, match in [(["--dtype", "bfloat16", "--superstep", "8"],
                         "resolved kernel is 'xla'"),
                        (["--superstep", "2", "--kernel", "xla"],
                         "whole-epoch-kernel knob"),
                        (["--ring", "allgather"], "K6")]:
        with pytest.raises(SystemExit, match=match):
            bench.main(argv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        bench.main(["--epochs", "1"])
    # the serve fleet is ported: `--replicas 2` passes the checks and, like
    # every mode, needs the card
    with pytest.raises(SystemExit, match="no CUDA card"):
        bench.main(["--mode", "serve", "--replicas", "2"])


def test_bench_fields_on_a_tiny_run():
    # plumbing only: a CPU time is no device number and is not recorded
    out = bench.run_train_bench(torch.device("cpu"), epochs=1, batch_size=64,
                                kernel="pallas_epoch", impl="rbg", n_train=256,
                                windows=1)
    assert out["metric"] == "mnist_train_images_per_sec_per_chip"
    assert out["unit"] == "images/sec/chip" and out["value"] > 0
    assert set(out) >= {"vs_baseline", "tflops", "mfu_pct_vs_bf16_peak"}
    assert bench.perf_fields(1e6)["tflops"] == round(6 * 118016 * 1e6 / 1e12, 2)


def test_front_door_runs_bench(capsys):
    assert port_main.main(["--help"]) == 0
    assert "bench" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        port_main.main(["bench", "--mode", "ddp", "--input_batches", "3"])
    assert "input-mode knob" in capsys.readouterr().err
