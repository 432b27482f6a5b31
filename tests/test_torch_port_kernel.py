"""The port's fused train step (K1) against the JAX package's Pallas kernel.

On the CPU the port's `fused_loss_and_grads` runs its plain PyTorch version;
it is held against JAX `fused_loss_and_grads(..., interpret=True)` on the
same weights (through `from_jax_params`), inputs and mask, at the JAX
package's own tolerances (tests/test_pallas_step.py): loss rtol 1e-5, grads
rtol 2e-4 / atol 1e-6. The CUDA kernel itself runs only on a card:
tests/test_torch_port_gpu.py holds it against the plain version there, and
chip_smoke.py does the same on every chip run.
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu.models.mlp import init_mlp
from pytorch_ddp_mnist_tpu.ops import pallas_step as jax_k1
from pytorch_ddp_mnist_tpu_torch.data.mnist import normalize_images, synthetic_mnist
from pytorch_ddp_mnist_tpu_torch.models.mlp import from_jax_params
from pytorch_ddp_mnist_tpu_torch.ops import _build, fused_step
from pytorch_ddp_mnist_tpu_torch.ops.loss import cross_entropy

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6

_jax_fused = jax.jit(partial(jax_k1.fused_loss_and_grads, interpret=True))


def _inputs(batch, seed, dropout):
    """Numpy-seeded (x, y, {0,1} keep mask, pre-scaled mask)."""
    split = synthetic_mnist(batch, seed=seed)
    x = normalize_images(split.images)
    y = split.labels.astype(np.int32)
    rng = np.random.default_rng(seed + 1000)
    keep = ((rng.random((batch, 128)) < 0.8) if dropout
            else np.ones((batch, 128), bool))
    return x, y, keep, keep.astype(np.float32) / np.float32(0.8)


def _jax_params(seed):
    return jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.key(seed)))


def _assert_close(loss, grads, ref_loss, ref_grads):
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    for name in ("fc1", "fc2", "fc3"):
        assert set(grads[name]) == set(ref_grads[name])
        for k in grads[name]:
            np.testing.assert_allclose(
                np.asarray(grads[name][k]), np.asarray(ref_grads[name][k]),
                rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=f"{name}.{k}")


@pytest.mark.parametrize("dropout", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("batch", [32, 1024, 700, 3])
def test_fused_step_matches_jax_kernel(batch, dropout):
    tree = _jax_params(batch)
    x, y, _, mask = _inputs(batch, seed=batch, dropout=dropout)
    ref_loss, ref_grads = _jax_fused(tree, x, y, mask)
    model = from_jax_params(tree)
    loss, grads = fused_step.fused_loss_and_grads(
        model.params(), torch.from_numpy(x), torch.from_numpy(y),
        torch.from_numpy(mask))
    assert loss.shape == () and grads["fc3"]["w"].shape == (128, 10)
    _assert_close(loss, {n: {k: v.numpy() for k, v in d.items()}
                         for n, d in grads.items()}, ref_loss, ref_grads)


@pytest.mark.parametrize("batch", [64, 3])
def test_fused_step_matches_autograd_of_the_model(batch):
    tree = _jax_params(7)
    x, y, keep, mask = _inputs(batch, seed=11, dropout=True)
    model = from_jax_params(tree)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    ref = cross_entropy(model(xt, train=True,
                              dropout_mask=torch.from_numpy(keep)), yt)
    params = model.params()
    leaves = [(n, k, p) for n, d in params.items() for k, p in d.items()]
    auto = torch.autograd.grad(ref, [p for _, _, p in leaves])
    ref_grads = {n: {} for n in params}
    for (n, k, _), g in zip(leaves, auto):
        ref_grads[n][k] = g.numpy()
    loss, grads = fused_step.fused_loss_and_grads(params, xt, yt,
                                                  torch.from_numpy(mask))
    assert not loss.requires_grad
    _assert_close(loss, {n: {k: v.numpy() for k, v in d.items()}
                         for n, d in grads.items()}, ref.detach(), ref_grads)


def _bad(kind):
    tree = _jax_params(0)
    x, y, _, mask = _inputs(4, seed=0, dropout=False)
    params = from_jax_params(tree).params()
    x, y, mask = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask)
    if kind == "x_width":
        x = x[:, :700]
    elif kind == "x_dtype":
        x = x.double()
    elif kind == "x_strided":
        x = torch.cat([x, x], dim=1)[:, ::2]
    elif kind == "mask_rows":
        mask = mask[:3]
    elif kind == "y_float":
        y = y.float()
    elif kind == "w3_padded":
        params["fc3"]["w"] = torch.zeros(128, 128)
    elif kind == "empty":
        x, y, mask = x[:0], y[:0], mask[:0]
    else:
        assert kind == "valid", kind
    return params, x, y, mask


@pytest.mark.parametrize("kind", ["x_width", "x_dtype", "x_strided",
                                  "mask_rows", "y_float", "w3_padded",
                                  "empty"])
def test_wrapper_rejects_what_the_kernel_does_not_take(kind):
    with pytest.raises(ValueError):
        fused_step.fused_loss_and_grads(*_bad(kind))


def test_plain_version_is_used_for_cpu_tensors_only(monkeypatch):
    # a CPU call never reaches the kernel library or its launch count
    def boom(*a, **k):
        raise AssertionError("the CPU path must not touch the kernel")
    monkeypatch.setattr(fused_step, "_fused_cuda", boom)
    before = dict(fused_step.launch_count)
    fused_step.fused_loss_and_grads(*_bad("valid"))
    assert fused_step.launch_count == before


def test_build_without_nvcc_raises_by_name(monkeypatch, tmp_path):
    # no silent fallback: a machine without the compiler gets an error
    # naming nvcc, not the plain version
    monkeypatch.setattr(_build.os, "access", lambda *a, **k: False)
    monkeypatch.setattr(_build.shutil, "which", lambda *a, **k: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.build_all()


def test_dropout_mask_is_prescaled_keep_draw():
    gen = torch.Generator().manual_seed(3)
    m = fused_step.dropout_mask(gen, 512, "cpu")
    assert m.dtype == torch.float32 and m.shape == (512, 128)
    assert set(torch.unique(m).tolist()) == {0.0, 1.25}
    assert abs(float((m > 0).float().mean()) - 0.8) < 0.01
    again = fused_step.dropout_mask(torch.Generator().manual_seed(3), 512, "cpu")
    assert torch.equal(m, again)
