"""K1-split, the split design of the per-step fused kernel's f32 forms
(csrc/fused_split.cu), on the CPU.

The kernel runs only on a card (tests/test_torch_port_gpu.py and
chip_smoke.py hold it bitwise against the rows design, csrc/fused_step.cu,
there). Here: the rule that picks the design for a launch and its boundary,
the constants the wrapper and the source share, the build entries, the
debug entries' refusals, and the CPU path, which runs the plain version and
never loads a library: against the JAX kernel (interpret mode) at the
batches the split design takes, at the JAX package's tolerances (loss rtol
1e-5, grads rtol 2e-4 / atol 1e-6)."""

import re
from functools import partial

import jax
import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu.models.mlp import init_mlp
from pytorch_ddp_mnist_tpu.ops import pallas_step as jax_k1
from pytorch_ddp_mnist_tpu_torch.data.mnist import normalize_images, synthetic_mnist
from pytorch_ddp_mnist_tpu_torch.models.mlp import from_jax_params
from pytorch_ddp_mnist_tpu_torch.ops import _build, fused_step, philox

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6

_jax_fused = jax.jit(partial(jax_k1.fused_loss_and_grads, interpret=True))


def _inputs(batch, seed):
    """Numpy-seeded (params tree of the JAX init, x, y, pre-scaled mask)."""
    split = synthetic_mnist(batch, seed=seed)
    rng = np.random.default_rng(seed + 1000)
    mask = (rng.random((batch, 128)) < 0.8).astype(np.float32) / np.float32(0.8)
    tree = jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.key(seed)))
    return (tree, normalize_images(split.images),
            split.labels.astype(np.int32), mask)


# ---- the design rule ----

@pytest.mark.parametrize("rng", [False, True], ids=["mask", "rng"])
@pytest.mark.parametrize("batch", [128, 96, 8, 3, 1])
def test_f32_batches_up_to_the_maximum_take_the_split_design(batch, rng):
    # the main path's full (128) and ragged last (96) batches among them
    assert fused_step.fused_design(torch.float32, rng, batch) == "split"


# f32 past the split design's maximum and bf16 past the mma design's keep
# the rows design; bf16 at B <= 128 (3, 96 and 128 here) runs the mma design
# (csrc/fused_mma.cu, tests/test_torch_port_k1_mma.py)
@pytest.mark.parametrize("rng", [False, True], ids=["mask", "rng"])
@pytest.mark.parametrize("dtype,batch", [
    (torch.float32, 129), (torch.float32, 1000), (torch.bfloat16, 3),
    (torch.bfloat16, 96), (torch.bfloat16, 128), (torch.bfloat16, 1000)])
def test_larger_batches_and_bf16_keep_the_rows_design(dtype, batch, rng):
    want = "mma" if dtype == torch.bfloat16 and batch <= 128 else "rows"
    assert fused_step.fused_design(dtype, rng, batch) == want


def test_design_boundary_is_split_max_batch():
    assert fused_step.SPLIT_MAX_BATCH == 128
    top = fused_step.SPLIT_MAX_BATCH
    assert fused_step.fused_design(torch.float32, False, top) == "split"
    assert fused_step.fused_design(torch.float32, False, top + 1) == "rows"


# ---- the wrapper, the source and the build ----

def test_wrapper_and_source_share_their_constants():
    src = (_build.CSRC / "fused_split.cu").read_text()
    assert int(re.search(r"constexpr int B_MAX = (\d+);", src).group(1)) \
        == fused_step.SPLIT_MAX_BATCH
    # one stamp more than the phases between them
    stamps = re.search(r"enum Stamp : int \{(.*?)N_STAMPS", src, re.S).group(1)
    assert len(re.findall(r"\bST_\w+", stamps)) == \
        len(fused_step.SPLIT_PHASES) + 1
    # the kernels chip_smoke.py's profiler job names
    for name in ("split_hidden_kernel", "split_rows_kernel",
                 "split_grads_kernel"):
        assert f"{name}(" in src
    assert "#ifdef SPLIT_STAMPS" in src and "launch_count" not in src
    assert {"fused_split", "fused_split_rng"} <= set(fused_step.launch_count)
    assert set(fused_step.last_launch) == {"design", "form"}


def test_build_has_the_split_source_and_its_stamps_variant():
    assert _build.SOURCES["fused_split"] == "fused_split.cu"
    assert _build.SOURCES["fused_step"] == "fused_step.cu"
    assert _build.VARIANTS["fused_split_stamps"] == ("fused_split",
                                                     ("-DSPLIT_STAMPS",))
    assert _build._target("fused_split") != _build._target("fused_split_stamps")


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


@pytest.mark.parametrize("batch", [96, 3])
def test_cpu_path_runs_the_plain_version_and_loads_no_library(no_kernels,
                                                              batch):
    tree, x, y, mask = _inputs(batch, seed=batch)
    params = from_jax_params(tree).params()
    x, y, mask = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask)
    counts, last = dict(fused_step.launch_count), dict(fused_step.last_launch)
    got = fused_step.fused_loss_and_grads(params, x, y, mask)
    ref = fused_step.fused_loss_and_grads_reference(params, x, y, mask)
    got_rng = fused_step.fused_loss_and_grads_rng(params, x, y, 77)
    ref_rng = fused_step.fused_loss_and_grads_reference(
        params, x, y, philox.rng_mask(77, batch))
    for (a, ga), (b, gb) in ((got, ref), (got_rng, ref_rng)):
        assert torch.equal(a, b)
        for n in gb:
            for k in gb[n]:
                assert torch.equal(ga[n][k], gb[n][k]), f"{n}.{k}"
    assert fused_step.launch_count == counts
    assert fused_step.last_launch == last


@pytest.mark.parametrize("batch", [128, 96])
def test_cpu_path_at_split_batches_matches_the_jax_kernel(batch):
    tree, x, y, mask = _inputs(batch, seed=batch + 1)
    ref_loss, ref_grads = _jax_fused(tree, x, y, mask)
    loss, grads = fused_step.fused_loss_and_grads(
        from_jax_params(tree).params(), torch.from_numpy(x),
        torch.from_numpy(y), torch.from_numpy(mask))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    for n in ("fc1", "fc2", "fc3"):
        for k in grads[n]:
            np.testing.assert_allclose(
                grads[n][k].numpy(), np.asarray(ref_grads[n][k]),
                rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=f"{n}.{k}")


def test_split_design_refuses_what_it_does_not_take(monkeypatch):
    # bf16 rows, batches past the maximum and unknown designs are refused
    # by name, before any library is built or loaded
    def boom(*a, **k):
        raise AssertionError("a library was loaded")
    monkeypatch.setattr(fused_step, "_staged_lib", boom)
    monkeypatch.setattr(fused_step, "_kernel_lib", boom)
    monkeypatch.setattr(_build, "load", boom)
    params = from_jax_params(_inputs(1, seed=0)[0]).params()
    for batch, dtype in ((4, torch.bfloat16), (129, torch.float32)):
        _, x, y, mask = _inputs(batch, seed=0)
        with pytest.raises(ValueError, match="split design"):
            fused_step._staged_cuda("split", params,
                                    torch.from_numpy(x).to(dtype),
                                    torch.from_numpy(y), torch.from_numpy(mask))
    with pytest.raises(ValueError, match="design must be"):
        fused_step._fused_cuda(params, torch.from_numpy(x),
                               torch.from_numpy(y), torch.from_numpy(mask),
                               design="columns")


def test_debug_entries_refuse_the_cpu():
    tree, x, y, mask = _inputs(4, seed=0)
    params = from_jax_params(tree).params()
    x, y, mask = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask)
    with pytest.raises(ValueError, match="CUDA"):
        fused_step.split_phase_stamps(params, x, y, mask)
