"""The port's CUDA kernels on a card. Every test here is marked `gpu` and
skips, from inside its fixture, where torch.cuda.is_available() is False:
a kernel has no CPU mode. The file imports neither jax nor the JAX package,
so it also runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_port_gpu.py -m gpu --noconftest -q

Tolerances are the JAX package's pins for its fused step
(tests/test_pallas_step.py): loss rtol 1e-5, grads rtol 2e-4 / atol 1e-6;
two launches on the same inputs must be bitwise equal (no atomics)."""

import re

import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu_torch.cli import train as port_cli
from pytorch_ddp_mnist_tpu_torch.data.mnist import normalize_images, synthetic_mnist
from pytorch_ddp_mnist_tpu_torch.models.mlp import MLP
from pytorch_ddp_mnist_tpu_torch.ops import fused_step
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
        gen = torch.Generator(device=cuda).manual_seed(1)
        before = fused_step.launch_count["fused_step"]
        losses = torch.stack([step(model, gen, x[i:i + 128], y[i:i + 128])
                              for i in range(0, 512, 128)])
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
