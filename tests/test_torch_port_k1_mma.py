"""K1-mma, the mma design of the per-step fused kernel's bf16 forms
(csrc/fused_mma.cu: the six products on the tensor cores, bf16 operands
accumulated in f32), on the CPU.

The kernel runs only on a card (tests/test_torch_port_gpu.py and
chip_smoke.py hold it there against the plain version and the rows design
at the JAX package's bf16 pins). Here: the rule that sends a launch to it
and its boundary, the constants the wrapper and the source share, the build
entries, the refusals of what it does not take (before any library is
loaded), and the CPU path for a bf16 x, which runs the plain version
(`step_reference_bf16`) and never loads a library: against the JAX kernel
in interpret mode with a bf16 x and against the JAX oracle, at the JAX
package's pins for its bf16 kernels (loss rtol 1e-3, grads rtol 2e-3 /
atol 1e-4)."""

import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu.models.mlp import init_mlp
from pytorch_ddp_mnist_tpu.ops import pallas_step as jax_k1
from pytorch_ddp_mnist_tpu_torch.data.mnist import normalize_images, synthetic_mnist
from pytorch_ddp_mnist_tpu_torch.models.mlp import from_jax_params
from pytorch_ddp_mnist_tpu_torch.ops import _build, fused_step, philox

LOSS_RTOL = 1e-3
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-4

_jax_fused = jax.jit(partial(jax_k1.fused_loss_and_grads, interpret=True))


def _inputs(batch, seed):
    """Numpy-seeded (params tree of the JAX init, x, y, pre-scaled mask)."""
    split = synthetic_mnist(batch, seed=seed)
    rng = np.random.default_rng(seed + 2000)
    mask = (rng.random((batch, 128)) < 0.8).astype(np.float32) / np.float32(0.8)
    tree = jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.key(seed)))
    return (tree, normalize_images(split.images),
            split.labels.astype(np.int32), mask)


def _assert_close(got, ref):
    loss, grads = got
    ref_loss, ref_grads = ref
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    for n in ("fc1", "fc2", "fc3"):
        for k in ref_grads[n]:
            np.testing.assert_allclose(
                np.asarray(grads[n][k]), np.asarray(ref_grads[n][k]),
                rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=f"{n}.{k}")


# ---- the design rule ----

@pytest.mark.parametrize("rng", [False, True], ids=["mask", "rng"])
@pytest.mark.parametrize("batch", [128, 96, 8, 3, 1])
def test_bf16_batches_up_to_the_maximum_take_the_mma_design(batch, rng):
    # the main path's full (128) and ragged last (96) batches among them
    assert fused_step.fused_design(torch.bfloat16, rng, batch) == "mma"


@pytest.mark.parametrize("rng", [False, True], ids=["mask", "rng"])
@pytest.mark.parametrize("dtype,batch,design", [
    (torch.bfloat16, 129, "rows"), (torch.bfloat16, 256, "rows"),
    (torch.float32, 128, "split"), (torch.float32, 3, "split")])
def test_other_forms_keep_their_designs(dtype, batch, design, rng):
    assert fused_step.fused_design(dtype, rng, batch) == design


def test_design_boundary_is_mma_max_batch():
    assert fused_step.MMA_MAX_BATCH == 128
    top = fused_step.MMA_MAX_BATCH
    assert fused_step.fused_design(torch.bfloat16, False, top) == "mma"
    assert fused_step.fused_design(torch.bfloat16, False, top + 1) == "rows"


# ---- the wrapper, the source and the build ----

def test_wrapper_and_source_share_their_constants():
    # the kernels and their entries, and the phase code they share with
    # K2-mma (csrc/mma_step.cuh)
    src = "".join((_build.CSRC / name).read_text()
                  for name in ("fused_mma.cu", "mma_step.cuh"))
    assert int(re.search(r"constexpr int B_MAX = (\d+);", src).group(1)) \
        == fused_step.MMA_MAX_BATCH
    # one stamp more than the phases between them
    stamps = re.search(r"enum Stamp : int \{(.*?)N_STAMPS", src, re.S).group(1)
    assert len(re.findall(r"\bST_\w+", stamps)) == \
        len(fused_step.MMA_PHASES) + 1
    # the kernels chip_smoke.py's profiler job names
    for name in ("mma_hidden_kernel", "mma_rows_kernel", "mma_grads_kernel"):
        assert f"{name}(" in src
    # the products on the tensor cores; no float atomics
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16" in src
    assert "atomicAdd" not in src and "fmaf(" not in src
    assert "#ifdef MMA_STAMPS" in src
    # the entries the wrapper declares
    for entry in ("step", "max_batch", "stamp_words", "scratch_floats",
                  "blocks"):
        assert f'extern "C" int pdmt_mma_{entry}(' in src
    assert {"fused_mma", "fused_mma_rng"} <= set(fused_step.launch_count)


def test_build_has_the_mma_source_and_its_stamps_variant():
    assert _build.SOURCES["fused_mma"] == "fused_mma.cu"
    assert _build.VARIANTS["fused_mma_stamps"] == ("fused_mma",
                                                   ("-DMMA_STAMPS",))
    assert _build._target("fused_mma") != _build._target("fused_mma_stamps")
    # the TMA helpers it shares with K1-split are a header: part of the hash
    assert "tma.cuh" in [h.name for h in _build.CSRC.glob("*.cuh")]
    for name in ("fused_mma.cu", "fused_split.cu"):
        assert '#include "tma.cuh"' in (_build.CSRC / name).read_text()


def test_mma_design_refuses_what_it_does_not_take(monkeypatch):
    # f32 rows, batches past the maximum and unknown designs are refused by
    # name, before any library is built or loaded
    def boom(*a, **k):
        raise AssertionError("a library was loaded")
    for name in ("_staged_lib", "_kernel_lib"):
        monkeypatch.setattr(fused_step, name, boom)
    monkeypatch.setattr(_build, "load", boom)
    params = from_jax_params(_inputs(1, seed=0)[0]).params()
    for batch, dtype in ((4, torch.float32), (129, torch.bfloat16)):
        _, x, y, mask = _inputs(batch, seed=0)
        with pytest.raises(ValueError, match="mma design"):
            fused_step._staged_cuda("mma", params,
                                    torch.from_numpy(x).to(dtype),
                                    torch.from_numpy(y), torch.from_numpy(mask))
    with pytest.raises(ValueError, match="design must be"):
        fused_step._fused_cuda(params, torch.from_numpy(x).to(torch.bfloat16),
                               torch.from_numpy(y), torch.from_numpy(mask),
                               design="wgmma")


def test_mma_stamps_refuse_the_cpu_and_f32():
    tree, x, y, mask = _inputs(4, seed=0)
    params = from_jax_params(tree).params()
    x, y, mask = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask)
    for xin in (x.to(torch.bfloat16), x):
        with pytest.raises(ValueError, match="CUDA"):
            fused_step.mma_phase_stamps(params, xin, y, mask)


# ---- the CPU path ----

@pytest.fixture
def no_kernels(monkeypatch):
    """Fail on any attempt to build or load a kernel library or reach a
    CUDA wrapper."""
    def boom(*a, **k):
        raise AssertionError("the CPU path must not touch a kernel")
    for name in ("_staged_cuda", "_fused_cuda", "_staged_lib", "_kernel_lib"):
        monkeypatch.setattr(fused_step, name, boom)
    monkeypatch.setattr(_build, "load", boom)
    monkeypatch.setattr(_build, "build_all", boom)


@pytest.mark.parametrize("batch", [128, 96, 3])
def test_cpu_path_for_bf16_x_matches_the_jax_kernel_and_oracle(no_kernels,
                                                               batch):
    tree, x, y, mask = _inputs(batch, seed=batch + 5)
    params = from_jax_params(tree).params()
    xt = torch.from_numpy(x).to(torch.bfloat16)
    counts, last = dict(fused_step.launch_count), dict(fused_step.last_launch)
    got = fused_step.fused_loss_and_grads(params, xt, torch.from_numpy(y),
                                          torch.from_numpy(mask))
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    _assert_close(got, _jax_fused(tree, xj, jnp.asarray(y), jnp.asarray(mask)))
    _assert_close(got, jax_k1.step_reference_bf16(
        tree, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)))
    # the rng form on the CPU is the plain version on philox.rng_mask
    got_rng = fused_step.fused_loss_and_grads_rng(params, xt,
                                                  torch.from_numpy(y), 77)
    ref_rng = fused_step.step_reference_bf16(
        params, xt, torch.from_numpy(y), philox.rng_mask(77, batch))
    assert torch.equal(got_rng[0], ref_rng[0])
    for n in ref_rng[1]:
        for k in ref_rng[1][n]:
            assert torch.equal(got_rng[1][n][k], ref_rng[1][n][k]), f"{n}.{k}"
    assert fused_step.launch_count == counts
    assert fused_step.last_launch == last
