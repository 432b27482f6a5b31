"""The port's first slice as a whole against the JAX package: the serial
streaming trainer with the fused step, its epoch line, its CLI and its
`.pt` checkpoints.

The same shards and the same numpy dropout masks go through the port's
fused step (its plain version on the CPU) and through JAX
`fused_loss_and_grads(interpret=True)` + `sgd_step`. Per-step losses agree
at rtol 1e-5 and the final params at rtol 1e-4 / atol 1e-6, the JAX
package's own pins for its fused step over a run
(tests/test_pallas_step.py)."""

import re
from functools import partial

import jax
import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu.data.loader import BatchLoader as JaxLoader
from pytorch_ddp_mnist_tpu.models.mlp import init_mlp
from pytorch_ddp_mnist_tpu.ops.pallas_step import fused_loss_and_grads as jax_fused
from pytorch_ddp_mnist_tpu.ops.sgd import sgd_step as jax_sgd_step
from pytorch_ddp_mnist_tpu.parallel.sampler import ShardedSampler as JaxSampler
from pytorch_ddp_mnist_tpu.train import checkpoint as jax_ckpt
from pytorch_ddp_mnist_tpu.train import loop as jax_loop
from pytorch_ddp_mnist_tpu_torch import __main__ as port_main
from pytorch_ddp_mnist_tpu_torch.cli import train as port_cli
from pytorch_ddp_mnist_tpu_torch.data.loader import BatchLoader
from pytorch_ddp_mnist_tpu_torch.data.mnist import normalize_images, synthetic_mnist
from pytorch_ddp_mnist_tpu_torch.models.mlp import from_jax_params, to_numpy_params
from pytorch_ddp_mnist_tpu_torch.ops import fused_step
from pytorch_ddp_mnist_tpu_torch.ops.threefry import key_data
from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler
from pytorch_ddp_mnist_tpu_torch.train import loop
from pytorch_ddp_mnist_tpu_torch.train.checkpoint import load_checkpoint
from pytorch_ddp_mnist_tpu_torch.train.config import configure, resolve_kernel

_jax_step = jax.jit(partial(jax_fused, interpret=True))


def _assert_trees_close(got, ref, **tol):
    for n in ref:
        for k in ref[n]:
            np.testing.assert_allclose(got[n][k], np.asarray(ref[n][k]),
                                       err_msg=f"{n}.{k}", **tol)


def _assert_trees_equal(got, ref):
    assert {n: set(d) for n, d in got.items()} == {n: set(d) for n, d in ref.items()}
    for n in ref:
        for k in ref[n]:
            np.testing.assert_array_equal(got[n][k], np.asarray(ref[n][k]))


@pytest.mark.parametrize("epochs", [1, 2])
def test_fit_with_the_fused_step_tracks_jax_over_a_run(monkeypatch, epochs):
    n, batch, lr = 300, 64, 0.01          # 5 steps an epoch, last one wrapped
    split = synthetic_mnist(n, 4)
    x_all = normalize_images(split.images)
    test = synthetic_mnist(100, 5)
    x_test, y_test = normalize_images(test.images), test.labels.astype(np.int32)
    steps = epochs * -(-n // batch)
    rng = np.random.default_rng(0)
    masks = [(rng.random((batch, 128)) < 0.8).astype(np.float32)
             / np.float32(0.8) for _ in range(steps)]

    # JAX: the same shards and masks through its fused kernel + SGD
    params = init_mlp(jax.random.key(0))
    tree0 = jax.tree_util.tree_map(np.asarray, params)
    jax_losses = []
    jl = JaxLoader(x_all, split.labels, JaxSampler(n, seed=42), batch)
    it = iter(masks)
    for epoch in range(epochs):
        jl.sampler.set_epoch(epoch)
        for xb, yb in jl:
            loss, grads = _jax_step(params, xb, yb, next(it))
            params = jax_sgd_step(params, grads, lr)
            jax_losses.append(float(loss))
    jax_val = jax_loop.evaluate(jax_loop.make_eval_step(), params, x_test,
                                y_test, batch)

    # the port: its loop and step factory, fed the same masks
    it = iter(masks)
    monkeypatch.setattr(fused_step, "dropout_mask",
                        lambda key, b, device: torch.from_numpy(next(it)))
    state = loop.TrainState(from_jax_params(tree0), key_data(1))
    lines = []
    state, history = loop.fit(
        state, BatchLoader(x_all, split.labels, ShardedSampler(n, seed=42),
                           batch), x_test, y_test, epochs=epochs,
        batch_size=batch, train_step=fused_step.make_fused_train_step(lr),
        log=lines.append)
    losses = np.concatenate(history)
    assert losses.dtype == np.float32 and losses.shape == (steps,)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
    _assert_trees_close(to_numpy_params(state.model), params,
                        rtol=1e-4, atol=1e-6)
    val = loop.evaluate(state.model, torch.from_numpy(x_test),
                        torch.from_numpy(y_test), batch)
    np.testing.assert_allclose(val[:2], jax_val[:2], rtol=1e-5)
    assert val[2] == jax_val[2]
    assert [ln.split(",")[0] for ln in lines] == [f"Epoch={e}"
                                                 for e in range(epochs)]


def test_autograd_step_matches_the_fused_step():
    # `--kernel xla` and `--kernel pallas` draw the same masks from the same
    # key chain, so their runs agree to f32 rounding
    split = synthetic_mnist(256, 1)
    x = torch.from_numpy(normalize_images(split.images))
    y = torch.from_numpy(split.labels.astype(np.int32))
    tree = jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.key(2)))
    runs = []
    for step in (loop.make_train_step(0.01),
                 fused_step.make_fused_train_step(0.01)):
        model, key = from_jax_params(tree), key_data(1)
        losses = []
        for i in range(0, 256, 64):
            key, loss = step(model, key, x[i:i + 64], y[i:i + 64])
            losses.append(float(loss))
        runs.append((losses, to_numpy_params(model)))
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-5)
    _assert_trees_close(runs[0][1], runs[1][1], rtol=1e-4, atol=1e-6)


def test_epoch_line_and_val_summary_are_character_equal():
    rng = np.random.default_rng(3)
    per_sample = rng.random(1000).astype(np.float32) * 2
    correct = (rng.random(1000) < 0.9).astype(np.float32)
    for batch in (128, 64, 7):
        val = loop.val_summary(per_sample, correct, batch)
        assert val == jax_loop.val_summary(per_sample, correct, batch)
        losses = rng.random(47).astype(np.float32) + 0.5
        for io in (None, 0.123):
            assert (loop.epoch_summary(3, losses, batch, val, 1.7, io) ==
                    jax_loop.epoch_summary(3, losses, batch, val, 1.7, io))


def test_eval_math_matches_jax():
    tree = jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.key(4)))
    test = synthetic_mnist(200, 6)
    x, y = normalize_images(test.images), test.labels.astype(np.int32)
    ps, cor = loop.eval_math(from_jax_params(tree), torch.from_numpy(x),
                             torch.from_numpy(y))
    ref_ps, ref_cor = jax_loop._eval_math(tree, x, y)
    np.testing.assert_allclose(ps.numpy(), np.asarray(ref_ps), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(cor.numpy(), np.asarray(ref_cor))


def test_cli_trains_on_cpu_and_the_pt_moves_between_packages(tmp_path, capsys):
    ckpt = tmp_path / "m.pt"
    rc = port_cli.main(["--device", "cpu", "--n_epochs", "1", "--limit", "512",
                        "--batch_size", "64", "--kernel", "pallas",
                        "--checkpoint", str(ckpt),
                        "--path", str(tmp_path / "no_mnist")])
    out = capsys.readouterr().out
    assert rc == 0
    epochs = [ln for ln in out.splitlines() if ln.startswith("Epoch=")]
    assert len(epochs) == 1
    assert re.match(r"Epoch=0, train_loss=[0-9.e-]+, val_loss=[0-9.e-]+  "
                    r"\[mean_train=", epochs[0])
    assert "kernel=pallas" in out and f"saved checkpoint to {ckpt}" in out
    # the port's file, read by the JAX package, is bitwise the port's params
    in_jax = jax_ckpt.params_from_torch_state_dict(
        torch.load(ckpt, weights_only=True))
    _assert_trees_equal(to_numpy_params(load_checkpoint(str(ckpt))), in_jax)
    # and the JAX package's file, read by the port, is bitwise its params
    tree = jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.key(8)))
    jax_ckpt.save_checkpoint(str(tmp_path / "j.pt"), tree)
    _assert_trees_equal(to_numpy_params(load_checkpoint(str(tmp_path / "j.pt"))),
                        tree)


def test_cli_without_a_card_exits_naming_it(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        port_cli.main(["--limit", "64"])
    assert e.value.code not in (0, None)
    assert "no CUDA card" in str(e.value.code)
    assert "--device cpu" in str(e.value.code)
    with pytest.raises(SystemExit, match="expected a CUDA device ordinal"):
        port_cli.main(["--device", "gpu0"])


@pytest.mark.parametrize("argv,name", [
    (["--outage_retries", "1"], "--outage_retries"),
    (["--ckpt_every_steps", "5"], "--ckpt_every_steps"),
    (["--sampler_rng", "torch"], "--sampler_rng"),
    (["--elastic"], "--elastic"),
    (["--dropout_rng=torch"], "--dropout_rng"),
    (["--download"], "--download"),
    (["--telemetry", "/tmp/t"], "--telemetry"),
    (["--resume=x.pt"], "--resume"),
])
def test_unported_flags_exit_by_name(argv, name):
    with pytest.raises(SystemExit) as e:
        configure(["--device", "cpu", *argv])
    msg = str(e.value.code)
    assert msg.startswith(name) and "not ported" in msg and "ROADMAP.md" in msg


def test_config_defaults_and_checkpoint_format():
    cfg = configure([])
    assert cfg["trainer"] == {"batch_size": 128, "n_epochs": 1, "lr": 0.01,
                              "seed": 0, "device": "0",
                              "checkpoint": "model.pt", "dtype": "float32",
                              "kernel": "auto", "cached": False,
                              "fused": False, "impl": "threefry2x32",
                              "parallel": False, "wireup_method": "auto"}
    assert cfg["data"] == {"path": "data/", "limit": -1}
    with pytest.raises(SystemExit, match="msgpack"):
        configure(["--checkpoint", "model.msgpack"])
    with pytest.raises(SystemExit):
        configure(["--no_such_flag"])


def test_kernel_auto_policy():
    assert resolve_kernel("auto", "float32", "cuda") == "pallas"
    assert resolve_kernel("auto", "float32", "cpu") == "xla"
    assert resolve_kernel("pallas", "float32", "cpu") == "pallas"
    assert resolve_kernel("xla", "float32", "cuda") == "xla"


def test_front_door_names_unported_commands(capsys):
    assert port_main.main(["serve"]) == 2
    assert "not ported" in capsys.readouterr().err
    assert port_main.main(["frobnicate"]) == 2
    assert port_main.main(["--help"]) == 0
    assert "train" in capsys.readouterr().out
