"""The reference's own random streams in the port against the JAX package:
torch's CPU MT19937 `randperm` (`--sampler_rng torch`, `ShardedSampler
(permutation="torch")`, `reshard`), its `bernoulli_` mask stream
(`--dropout_rng torch`, `make_torch_dropout_train_step`) and the shuffled
eval segmentation (`--eval_shuffle`).

Tolerances: permutations, shards and masks are bitwise (the JAX package
pins them bitwise against live torch); per-step losses of the torch-dropout
step at rtol 1e-5 (the JAX package's pin for per-step losses: XLA and
torch's CPU kernels sum the f32 products in other orders), and so are the
epoch lines of the two CLIs; the captured step's loop on its static slots
is bitwise the direct step calls."""

import re

import jax
import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu.cli.train import main as jax_train_main
from pytorch_ddp_mnist_tpu.data.loader import BatchLoader as JaxBatchLoader
from pytorch_ddp_mnist_tpu.models.mlp import init_mlp
from pytorch_ddp_mnist_tpu.parallel import torch_rng as jax_rng
from pytorch_ddp_mnist_tpu.parallel.sampler import ShardedSampler as JaxSampler
from pytorch_ddp_mnist_tpu.train import loop as jax_loop
from pytorch_ddp_mnist_tpu_torch.cli.train import main as port_train_main
from pytorch_ddp_mnist_tpu_torch.data.loader import BatchLoader
from pytorch_ddp_mnist_tpu_torch.data.mnist import (normalize_images,
                                                    synthetic_mnist)
from pytorch_ddp_mnist_tpu_torch.models.mlp import from_jax_params
from pytorch_ddp_mnist_tpu_torch.parallel import torch_rng
from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler
from pytorch_ddp_mnist_tpu_torch.train import loop
from pytorch_ddp_mnist_tpu_torch.train.config import configure

LOSS_RTOL = 1e-5
_NUM = r"([-0-9.e]+)"
_LINE = re.compile(rf"^Epoch=(\d+), train_loss={_NUM}, val_loss={_NUM}  "
                   rf"\[mean_train={_NUM} mean_val={_NUM} acc={_NUM} ")


# ------------------------------------------------------------- streams ---

@pytest.mark.parametrize("n,seed", [(0, 1), (1, 5), (2, 0), (625, 9),
                                    (1877, 42), (60000, 43)])
def test_randperm_is_the_jax_copy_and_torchs_own(n, seed):
    want = jax_rng.torch_randperm(n, seed)
    got = torch_rng.torch_randperm(n, seed)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    if n <= 2000:   # the plain copy's Python swap loop
        assert np.array_equal(torch_rng.torch_randperm_plain(n, seed), want)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 7])
def test_engine_and_mask_stream_are_the_jax_copys(seed):
    ref = jax_rng.TorchMT19937(seed & 0xFFFFFFFF)
    assert np.array_equal(torch_rng.TorchMT19937(seed).draws(1500),
                          ref.draws(1500))
    stream = torch_rng.MaskStream(seed)
    plain = torch_rng.TorchMT19937(seed)
    jax_gen = jax_rng.TorchMT19937(seed & 0xFFFFFFFF)
    for n, p in ((128 * 128, 0.8), (3, 0.8), (1000, 0.5), (311, 0.1)):
        got = stream.draw(n, p)
        assert got.dtype == np.float32
        want = jax_rng.torch_bernoulli(jax_gen, n, p)
        assert np.array_equal(got, want)
        assert np.array_equal(torch_rng.torch_bernoulli_plain(plain, n, p),
                              want)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_torch_sampler_and_reshard_are_the_jax_samplers(world):
    n = 1001
    for rank in range(world):
        ours = ShardedSampler(n, num_replicas=world, rank=rank,
                              permutation="torch")
        ref = JaxSampler(n, num_replicas=world, rank=rank,
                         permutation="torch")
        for epoch in (0, 3):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert np.array_equal(ours.indices(), ref.indices())
            for new_world in (1, world + 1):
                a = ours.reshard(new_world, new_world - 1)
                b = ref.reshard(new_world, new_world - 1)
                assert (a.epoch, a.permutation) == (epoch, "torch")
                assert np.array_equal(a.indices(), b.indices())
    # the pcg64 source reshards too
    a = ShardedSampler(50, num_replicas=2, rank=1).reshard(3, 0)
    assert np.array_equal(a.indices(), JaxSampler(50, num_replicas=3,
                                                  rank=0).indices())


# ------------------------------------------------- the torch-mask step ---

def _jax_params(seed=0):
    return jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.key(seed)))


def test_torch_dropout_steps_are_the_jax_steps(tmp_path):
    """20 serial steps on torch-permuted batches: the masks bitwise the
    JAX stream's, the losses at rtol 1e-5, the port's `fit` (the captured
    loop's body on its static slots, eagerly on the CPU) bitwise the
    direct step calls."""
    n, batch, seed, lr = 20 * 32, 32, 11, 0.01
    split = synthetic_mnist(n, seed=0)
    x = normalize_images(split.images)
    ours = loop.make_torch_dropout_train_step(lr, seed)
    ref = jax_loop.make_torch_dropout_train_step(lr, seed)
    sampler = ShardedSampler(n, permutation="torch")
    jax_loader = JaxBatchLoader(x, split.labels,
                                JaxSampler(n, permutation="torch"), batch)
    model = from_jax_params(_jax_params())
    params, key = jax.tree_util.tree_map(jax.numpy.asarray,
                                         _jax_params()), None
    check = torch_rng.MaskStream(seed)
    got, want = [], []
    for (xb, yb), (xj, yj) in zip(BatchLoader(x, split.labels, sampler,
                                              batch), jax_loader):
        assert xb.tobytes() == xj.tobytes()
        mask = ours.draw(batch)
        assert np.array_equal(mask.reshape(-1),
                              check.draw(batch * 128, 0.8))
        got.append(float(ours.run(model, torch.from_numpy(mask),
                                  torch.from_numpy(xb),
                                  torch.from_numpy(yb))))
        params, key, loss = ref(params, key, xj, yj)
        want.append(float(loss))
    assert len(got) == 20
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    # the trainer's loop on the same stream and batches: bitwise
    model2 = from_jax_params(_jax_params())
    _, history = loop.fit(loop.TrainState(model2, None),
                          BatchLoader(x, split.labels, sampler, batch),
                          x[:64], split.labels[:64].astype(np.int32),
                          epochs=1, batch_size=batch,
                          train_step=loop.make_torch_dropout_train_step(
                              lr, seed), log=lambda line: None)
    assert np.array_equal(history[0], np.asarray(got, np.float32))
    for name, layer in model.params().items():
        for k, v in layer.items():
            assert torch.equal(v, model2.params()[name][k])


def test_the_masked_loop_reads_each_steps_slot():
    """The captured loop's body (run eagerly here, as on the CPU) reads
    the mask slot of its step: a step replayed after its slot changed
    trains on the new mask, the same as a direct call."""
    batch = 8
    split = synthetic_mnist(4 * batch, seed=3)
    x = normalize_images(split.images).reshape(4, batch, -1)
    y = split.labels.astype(np.int32).reshape(4, batch)
    step = loop.make_torch_dropout_train_step(0.05, 1)
    masks = [step.draw(batch) for _ in range(4)]
    model = from_jax_params(_jax_params())
    steps, slots, keys = loop._captured_steps(step, model, 4, batch,
                                              torch.device("cpu"))
    assert keys is None and [s.shape[-1] for s in slots] == [784, batch, 128]
    steps.start_epoch()
    for s in range(4):
        for slot, a in zip(slots, (x[s], y[s], masks[s])):
            slot[s % 2].copy_(torch.from_numpy(a))
        steps.step()
    direct = from_jax_params(_jax_params())
    want = [step.run(direct, torch.from_numpy(m), torch.from_numpy(xs),
                     torch.from_numpy(ys)) for m, xs, ys in zip(masks, x, y)]
    assert torch.equal(steps.losses(), torch.stack(want))
    assert not np.array_equal(masks[0], masks[2])


# --------------------------------------------------------- the CLIs ---

def _epoch_lines(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    return [_LINE.match(ln).groups() for ln in capsys.readouterr().out
            .splitlines() if ln.startswith("Epoch=")]


def _assert_lines_close(got, want):
    assert len(got) == len(want) > 0
    for p, j in zip(got, want):
        assert p[0] == j[0] and p[5] == j[5]
        np.testing.assert_allclose([float(v) for v in p[1:5]],
                                   [float(v) for v in j[1:5]],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("extra", [
    ["--sampler_rng", "torch", "--dropout_rng", "torch", "--eval_shuffle"],
    ["--cached", "--fused", "--kernel", "xla", "--sampler_rng", "torch",
     "--eval_shuffle"],
])
def test_the_two_clis_draw_the_same_streams(extra, tmp_path, capsys):
    argv = ["--limit", "1280", "--n_epochs", "2", "--seed", "5",
            "--checkpoint", "", "--path", str(tmp_path / "no_mnist"), *extra]
    _assert_lines_close(_epoch_lines(port_train_main,
                                     ["--device", "cpu", *argv], capsys),
                        _epoch_lines(jax_train_main, argv, capsys))


def test_eval_shuffle_segments_like_the_jax_summary():
    rng = np.random.default_rng(0)
    per_sample = rng.random(1003).astype(np.float32)
    correct = (rng.random(1003) < 0.7).astype(np.float32)
    perm = torch_rng.torch_randperm(1003, 4)
    got = loop.val_summary(per_sample, correct, 128, perm=perm)
    assert got == jax_loop.val_summary(per_sample, correct, 128, perm=perm)
    plain = loop.val_summary(per_sample, correct, 128)
    assert got[0] != plain[0] and got[2] == plain[2]


@pytest.mark.parametrize("argv,match", [
    (["--dropout_rng", "torch", "--parallel"], "--dropout_rng torch is "
                                               "serial-only"),
    (["--dropout_rng", "torch", "--cached"], "--dropout_rng torch streams"),
    (["--dropout_rng", "torch", "--kernel", "pallas"],
     "--dropout_rng torch uses the plain autograd step"),
    (["--dropout_rng", "torch", "--kernel", "pallas_rng", "--cached"],
     "--dropout_rng torch"),
    (["--dropout_rng", "torch", "--cached", "--fused"],
     "--dropout_rng torch streams"),
])
def test_unsound_stream_flags_exit_by_name(argv, match):
    with pytest.raises(SystemExit) as e:
        configure(["--device", "cpu", *argv])
    assert match in str(e.value.code)


def test_stream_flags_reach_the_config():
    cfg = configure(["--dropout_rng", "torch", "--sampler_rng", "torch",
                     "--eval_shuffle", "--hdf5", "--label_map", "1", "2"])
    t, d = cfg["trainer"], cfg["data"]
    assert (t["kernel"], t["dropout_rng"], t["sampler_rng"],
            t["eval_shuffle"]) == ("xla", "torch", "torch", True)
    assert d["hdf5"] is True and d["label_map"] == [1, 2]
