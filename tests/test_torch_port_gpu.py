"""The port's CUDA kernels on a card. Every test here is marked `gpu` and
skips, from inside its fixture, where torch.cuda.is_available() is False:
a kernel has no CPU mode. The file imports neither jax nor the JAX package,
so it also runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_port_gpu.py -m gpu --noconftest -q

Tolerances are the JAX package's pins for its fused step
(tests/test_pallas_step.py): loss rtol 1e-5, grads rtol 2e-4 / atol 1e-6;
two launches on the same inputs must be bitwise equal (no atomics). The
whole-epoch kernel (K2) is held bitwise against K1 + SGD per step (the
same row and gradient code), its in-kernel masks bitwise against the plain
streams, and against its plain version: losses at rtol 1e-5 / atol 1e-6,
params in relative Frobenius norm 1e-3 (per element, a ReLU input within
rounding of 0 may take the other branch in one of the two summation
orders; chip_smoke.py PARAM_FRO_RTOL says more)."""

import re
from functools import partial

import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu_torch.cli import train as port_cli
from pytorch_ddp_mnist_tpu_torch.data.mnist import (device_normalize,
                                                     normalize_images,
                                                     synthetic_mnist)
from pytorch_ddp_mnist_tpu_torch.models.mlp import MLP
from pytorch_ddp_mnist_tpu_torch.ops import (epoch_step, fused_step, philox,
                                             threefry)
from pytorch_ddp_mnist_tpu_torch.ops.sgd import sgd_step
from pytorch_ddp_mnist_tpu_torch.train.loop import make_train_step

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(batch, seed, device):
    split = synthetic_mnist(batch, seed=seed)
    rng = np.random.default_rng(seed)
    mask = (rng.random((batch, 128)) < 0.8).astype(np.float32) / np.float32(0.8)
    model = MLP(torch.Generator().manual_seed(seed)).to(device)
    return (model.params(),
            torch.from_numpy(normalize_images(split.images)).to(device),
            torch.from_numpy(split.labels.astype(np.int32)).to(device),
            torch.from_numpy(mask).to(device))


@pytest.mark.parametrize("batch", [128, 1000, 700, 3])
def test_kernel_matches_its_plain_version_and_repeats_bitwise(cuda, batch):
    args = _inputs(batch, batch, cuda)
    before = fused_step.launch_count["fused_step"]
    loss, grads = fused_step.fused_loss_and_grads(*args)
    loss2, grads2 = fused_step.fused_loss_and_grads(*args)
    assert fused_step.launch_count["fused_step"] == before + 2
    ref_loss, ref_grads = fused_step.fused_loss_and_grads_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(loss, loss2)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=0)
    for n in ref_grads:
        for k in ref_grads[n]:
            assert grads[n][k].shape == ref_grads[n][k].shape
            assert torch.equal(grads[n][k], grads2[n][k]), f"{n}.{k}"
            torch.testing.assert_close(grads[n][k], ref_grads[n][k],
                                       rtol=2e-4, atol=1e-6, msg=f"{n}.{k}")


def test_wrapper_rejects_a_tensor_on_another_device(cuda):
    params, x, y, mask = _inputs(8, 0, cuda)
    with pytest.raises(ValueError, match="scaled_mask"):
        fused_step.fused_loss_and_grads(params, x, y, mask.cpu())


def test_fused_step_tracks_the_autograd_step_on_card(cuda):
    # same seeds -> same weights and the same dropout masks on both paths
    split = synthetic_mnist(512, 3)
    x = torch.from_numpy(normalize_images(split.images)).to(cuda)
    y = torch.from_numpy(split.labels.astype(np.int32)).to(cuda)
    runs = []
    for step in (make_train_step(0.01), fused_step.make_fused_train_step(0.01)):
        model = MLP(torch.Generator().manual_seed(0)).to(cuda)
        key = threefry.key_data(1)
        before = fused_step.launch_count["fused_step"]
        losses = []
        for i in range(0, 512, 128):
            key, loss = step(model, key, x[i:i + 128], y[i:i + 128])
            losses.append(loss)
        losses = torch.stack(losses)
        runs.append((losses.cpu(), fused_step.launch_count["fused_step"]
                     - before, model))
    (plain, plain_launches, _), (fused, fused_launches, model) = runs
    assert (plain_launches, fused_launches) == (0, 4)
    torch.testing.assert_close(fused, plain, rtol=1e-5, atol=0)
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_cli_trains_through_the_kernel(cuda, tmp_path, capsys):
    before = fused_step.launch_count["fused_step"]
    rc = port_cli.main(["--limit", "512", "--batch_size", "64",
                        "--checkpoint", str(tmp_path / "m.pt"),
                        "--path", str(tmp_path / "no_mnist")])
    out = capsys.readouterr().out
    assert rc == 0 and "kernel=pallas" in out
    assert re.search(r"^Epoch=0, train_loss=\S+, val_loss=\S+", out, re.M)
    assert fused_step.launch_count["fused_step"] == before + 512 // 64
    assert (tmp_path / "m.pt").exists()


# ---- K2, the whole-epoch kernel ----

K2_FORMS = {"K2a": ("f32", "masks"), "K2b": ("uint8", "masks"),
            "K2c": ("uint8", "core"), "K3": ("uint8", "threefry")}


def _epoch_inputs(batch, nsteps, seed, device):
    rows = batch * nsteps
    split = synthetic_mnist(rows, seed=seed)
    rng = np.random.default_rng(seed)
    masks = (rng.random((rows, 128)) < 0.8).astype(np.float32) / np.float32(0.8)
    model = MLP(torch.Generator().manual_seed(seed)).to(device)
    return {
        "params": {n: {k: v.detach() for k, v in layer.items()}
                   for n, layer in model.params().items()},
        "uint8": torch.from_numpy(split.images.reshape(rows, -1)).to(device),
        "f32": torch.from_numpy(normalize_images(split.images)).to(device),
        "y": torch.from_numpy(split.labels.astype(np.int32)).to(device),
        "masks": torch.from_numpy(masks).to(device),
        "threefry": threefry.to_int32_words(
            threefry.split(threefry.key_data(seed), nsteps)).to(device),
        "core": int(rng.integers(0, 2**32)), "batch": batch,
    }


def _epoch(fn, form, inp):
    pixels, rng = K2_FORMS[form]
    return fn(inp["params"], inp[pixels], inp["y"],
              None if rng == "masks" else inp[rng], 0.01, inp["batch"],
              masks=inp["masks"] if rng == "masks" else None,
              rng_impl="threefry" if rng == "threefry" else "core")


def _k1_epoch(form, inp):
    pixels, rng = K2_FORMS[form]
    batch = inp["batch"]
    params = {n: {k: t.clone() for k, t in layer.items()}
              for n, layer in inp["params"].items()}
    losses = []
    for s in range(inp["y"].shape[0] // batch):
        rows = slice(s * batch, (s + 1) * batch)
        x = inp[pixels][rows]
        x = device_normalize(x) if pixels == "uint8" else x
        mask = epoch_step.step_mask(rng, inp[rng], inp["masks"], s, batch,
                                    x.device)
        loss, grads = fused_step.fused_loss_and_grads(params, x,
                                                      inp["y"][rows], mask)
        sgd_step(params, grads, 0.01)
        losses.append(loss)
    return params, torch.stack(losses)


def _leaves(params, losses):
    return [losses] + [t for layer in params.values() for t in layer.values()]


@pytest.mark.parametrize("form", list(K2_FORMS))
@pytest.mark.parametrize("batch,nsteps", [(128, 24), (8, 5)])
def test_epoch_kernel_matches_k1_bitwise_and_its_plain_version(cuda, form,
                                                               batch, nsteps):
    inp = _epoch_inputs(batch, nsteps, seed=batch + nsteps, device=cuda)
    before = epoch_step.launch_count["epoch_step"]
    got = _leaves(*_epoch(epoch_step.epoch_fused_sgd, form, inp))
    again = _leaves(*_epoch(epoch_step.epoch_fused_sgd, form, inp))
    assert epoch_step.launch_count["epoch_step"] == before + 2
    assert epoch_step.last_launch["form"] == "/".join(K2_FORMS[form])
    k1 = _leaves(*_k1_epoch(form, inp))
    ref = _leaves(*_epoch(epoch_step.epoch_fused_sgd_reference, form, inp))
    torch.cuda.synchronize()
    for a, b, c in zip(got, again, k1):
        assert torch.equal(a, b) and torch.equal(a, c)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-6)
    for a, r in zip(got[1:], ref[1:]):
        assert float((a - r).norm() / r.norm()) <= 1e-3


@pytest.mark.parametrize("impl", ["core", "threefry"])
def test_in_kernel_masks_are_the_plain_streams_bitwise(cuda, impl):
    inp = _epoch_inputs(64, 6, seed=3, device=cuda)
    rng = "core" if impl == "core" else "threefry"
    for step in range(6):
        km = epoch_step.kernel_mask_block(inp[rng], step, 64, rng_impl=impl,
                                          device=cuda)
        pm = epoch_step.step_mask(rng, inp[rng], None, step, 64, cuda)
        assert torch.equal(km, pm)


def test_cached_cli_runs_one_epoch_kernel_launch_per_epoch(cuda, tmp_path,
                                                           capsys):
    before = dict(epoch_step.launch_count)
    rc = port_cli.main(["--cached", "--fused", "--kernel", "pallas_epoch",
                        "--n_epochs", "2", "--limit", "1024",
                        "--checkpoint", str(tmp_path / "m.pt"),
                        "--path", str(tmp_path / "no_mnist")])
    out = capsys.readouterr().out
    assert rc == 0 and "kernel=pallas_epoch cached fused" in out
    assert re.search(r"^Epoch=1, train_loss=\S+, val_loss=\S+", out, re.M)
    assert epoch_step.launch_count["epoch_step"] == before["epoch_step"] + 2


# ---- slice 3: K1-bf16, K1-rng, K2-bf16, K2 superstep, the streaming mask ----
#
# bf16 tolerances are the JAX package's pins for its bf16 kernels against
# step_reference_bf16 (tests/test_pallas_step.py): loss rtol 1e-3, grads
# rtol 2e-3 / atol 1e-4; over a multi-step epoch, losses rtol 1e-3 / atol
# 1e-4 and params 2e-3 in relative Frobenius norm (a bf16 rounding that
# flips in the other summation order moves a value by 2**-8 of itself).

def _bf16_close(got, ref):
    loss, grads = got
    ref_loss, ref_grads = ref
    torch.testing.assert_close(loss, ref_loss, rtol=1e-3, atol=0)
    for n in ref_grads:
        for k in ref_grads[n]:
            torch.testing.assert_close(grads[n][k], ref_grads[n][k],
                                       rtol=2e-3, atol=1e-4, msg=f"{n}.{k}")


@pytest.mark.parametrize("batch", [128, 1000, 3])
def test_bf16_kernel_matches_its_plain_version(cuda, batch):
    params, x, y, mask = _inputs(batch, batch, cuda)
    xb = x.to(torch.bfloat16)
    before = dict(fused_step.launch_count)
    got = fused_step.fused_loss_and_grads(params, xb, y, mask)
    again = fused_step.fused_loss_and_grads(params, xb, y, mask)
    f32 = fused_step.fused_loss_and_grads(params, x, y, mask)
    assert fused_step.launch_count["fused_step_bf16"] == \
        before["fused_step_bf16"] + 2
    ref = fused_step.step_reference_bf16(params, xb, y, mask)
    torch.cuda.synchronize()
    assert torch.equal(got[0], again[0])
    for n in got[1]:
        for k in got[1][n]:
            assert torch.equal(got[1][n][k], again[1][n][k])
    _bf16_close(got, ref)
    assert not torch.equal(got[0], f32[0])


@pytest.mark.parametrize("batch", [128, 600, 3])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_rng_kernel_draws_the_philox_blocks_and_matches_plain(cuda, batch,
                                                              bf16):
    params, x, y, _ = _inputs(batch, batch, cuda)
    x = x.to(torch.bfloat16) if bf16 else x
    seed = (1 << 31) + batch
    km = fused_step.kernel_rng_mask(seed, batch, cuda)
    assert torch.equal(km, philox.rng_mask(seed, batch, cuda))
    got = fused_step.fused_loss_and_grads_rng(params, x, y, seed)
    again = fused_step.fused_loss_and_grads_rng(params, x, y, seed)
    other = fused_step.fused_loss_and_grads_rng(params, x, y, seed + 1)
    ref = (fused_step.step_reference_bf16 if bf16 else
           fused_step.fused_loss_and_grads_reference)(params, x, y, km)
    torch.cuda.synchronize()
    assert torch.equal(got[0], again[0]) and not torch.equal(got[0], other[0])
    if bf16:
        _bf16_close(got, ref)
    else:
        torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=0)
        for n in ref[1]:
            for k in ref[1][n]:
                torch.testing.assert_close(got[1][n][k], ref[1][n][k],
                                           rtol=2e-4, atol=1e-6)


def test_streaming_mask_is_the_threefry_draw(cuda):
    for seed in (0, 7, (1 << 31) + 3):
        key = threefry.split(threefry.key_data(seed))[1]
        for batch in (128, 3):
            before = fused_step.launch_count["threefry_mask"]
            got = fused_step.dropout_mask(key, batch, cuda)
            assert fused_step.launch_count["threefry_mask"] == before + 1
            assert torch.equal(got.cpu(),
                               threefry.dropout_mask(key, batch, "cpu"))


def _k1_epoch_bf16(form, inp):
    pixels, rng = K2_FORMS[form]
    batch = inp["batch"]
    params = {n: {k: t.clone() for k, t in layer.items()}
              for n, layer in inp["params"].items()}
    losses = []
    for s in range(inp["y"].shape[0] // batch):
        rows = slice(s * batch, (s + 1) * batch)
        x = inp[pixels][rows]
        x = (device_normalize(x) if pixels == "uint8" else x).to(torch.bfloat16)
        mask = epoch_step.step_mask(rng, inp[rng], inp["masks"], s, batch,
                                    x.device)
        loss, grads = fused_step.fused_loss_and_grads(params, x,
                                                      inp["y"][rows], mask)
        sgd_step(params, grads, 0.01)
        losses.append(loss)
    return params, torch.stack(losses)


@pytest.mark.parametrize("form", list(K2_FORMS))
def test_bf16_epoch_kernel_matches_k1_bf16_bitwise_and_plain(cuda, form):
    inp = _epoch_inputs(128, 12, seed=5, device=cuda)
    before = epoch_step.launch_count["epoch_step_bf16"]
    got = _leaves(*_epoch(partial(epoch_step.epoch_fused_sgd,
                                  compute_bf16=True), form, inp))
    again = _leaves(*_epoch(partial(epoch_step.epoch_fused_sgd,
                                    compute_bf16=True), form, inp))
    assert epoch_step.launch_count["epoch_step_bf16"] == before + 2
    k1 = _leaves(*_k1_epoch_bf16(form, inp))
    ref = _leaves(*_epoch(partial(epoch_step.epoch_fused_sgd_reference,
                                  compute_bf16=True), form, inp))
    torch.cuda.synchronize()
    for a, b, c in zip(got, again, k1):
        assert torch.equal(a, b) and torch.equal(a, c)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-3, atol=1e-4)
    for a, r in zip(got[1:], ref[1:]):
        assert float((a - r).norm() / r.norm()) <= 2e-3


@pytest.mark.parametrize("form", ["K2a", "K2c", "K3"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_superstep_is_bitwise_k1_on_a_ragged_epoch(cuda, form, bf16):
    inp = _epoch_inputs(64, 11, seed=9, device=cuda)
    fn = partial(epoch_step.epoch_fused_sgd, compute_bf16=bf16)
    base = _leaves(*_epoch(fn, form, inp))
    for k in (2, 4, 8):
        got = _leaves(*_epoch(partial(fn, steps_per_iter=k), form, inp))
        assert epoch_step.last_launch["steps_per_iter"] == k
        assert epoch_step.last_launch["staged"] == (form != "K2a")
        assert got[0].shape == (11,)
        for a, b in zip(got, base):
            assert torch.equal(a, b), (form, bf16, k)
