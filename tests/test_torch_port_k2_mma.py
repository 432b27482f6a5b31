"""K2-mma, the tensor-core design of the whole-epoch kernel's uint8 bf16
forms (csrc/epoch_mma.cu: K1-mma's three phases a step in one cooperative
launch, SGD folded into the gradient phase), on the CPU.

The kernel runs only on a card (tests/test_torch_port_gpu.py and
chip_smoke.py hold it bitwise against K1-mma + SGD per step there, and at
the JAX bf16 pins against its plain version and the rows design). Here: the
rule that sends a launch to it and its boundary, the constants the wrapper
and the source share, the build entries and launch counter, the refusals
made before any library is loaded, the bf16 normalise table the wrapper
builds for it, and the CPU path of its forms (the plain version, which
never loads a library) at full width against the JAX kernel in interpret
mode and the JAX oracle, at the JAX package's pins for its bf16 epoch
kernel (losses and params rtol 1e-3 / atol 1e-4, tests/test_torch_port_bf16.py
EPOCH_TOL), and bitwise against the port's bf16 step + SGD per step."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu.data.mnist import normalize_images as jax_normalize
from pytorch_ddp_mnist_tpu.models.mlp import init_mlp
from pytorch_ddp_mnist_tpu.ops import pallas_step as jax_ps
from pytorch_ddp_mnist_tpu_torch.data.mnist import device_normalize, synthetic_mnist
from pytorch_ddp_mnist_tpu_torch.models.mlp import from_jax_params, to_numpy_params
from pytorch_ddp_mnist_tpu_torch.ops import _build, epoch_step, fused_step, threefry
from pytorch_ddp_mnist_tpu_torch.ops.sgd import sgd_step

EPOCH_TOL = dict(rtol=1e-3, atol=1e-4)
RNGS = ("masks", "core", "threefry")


def _jax_params(seed=0):
    return jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.key(seed)))


def _inputs(nsteps, batch, rng, seed=3):
    split = synthetic_mnist(nsteps * batch, seed=seed)
    x = torch.from_numpy(np.ascontiguousarray(
        split.images.reshape(nsteps * batch, -1)))
    y = torch.from_numpy(split.labels.astype(np.int32))
    masks = seed_or_keys = None
    if rng == "masks":
        g = np.random.default_rng(seed)
        masks = torch.from_numpy((g.random((nsteps * batch, 128)) < 0.8)
                                 .astype(np.float32) / np.float32(0.8))
    elif rng == "threefry":
        seed_or_keys = threefry.to_int32_words(
            threefry.split(threefry.key_data(seed), nsteps))
    else:
        seed_or_keys = 12345
    return x, y, masks, seed_or_keys


# ---- the design rule ----

@pytest.mark.parametrize("k", epoch_step.STEPS_PER_ITER)
@pytest.mark.parametrize("rng", RNGS)
@pytest.mark.parametrize("batch", [8, 96, 128])
def test_design_is_mma_for_uint8_bf16_at_every_rng_and_k(batch, rng, k):
    # the wrapper's checks accept the launch, and the rule picks K2-mma
    x, y, masks, seed_or_keys = _inputs(k, batch, rng)
    params = from_jax_params(_jax_params()).params()
    got = epoch_step._check(params, x, y, seed_or_keys, batch, masks,
                            "threefry" if rng == "threefry" else "core", k)
    assert got[0] == rng
    assert epoch_step.epoch_design(x.dtype, True, batch) == "mma"


def test_design_boundary_is_mma_max_batch():
    top = fused_step.MMA_MAX_BATCH
    assert top == 128
    assert epoch_step.epoch_design(torch.uint8, True, top) == "mma"
    assert epoch_step.epoch_design(torch.uint8, True, top + 1) == "rows"


@pytest.mark.parametrize("dtype,bf16,batch,design", [
    (torch.uint8, False, 128, "ws"), (torch.uint8, False, 8, "ws"),
    (torch.float32, True, 128, "rows"), (torch.float32, True, 8, "rows"),
    (torch.float32, False, 128, "rows"), (torch.uint8, True, 256, "rows")])
def test_other_forms_keep_their_designs(dtype, bf16, batch, design):
    assert epoch_step.epoch_design(dtype, bf16, batch) == design


# ---- the source, the build and the counters ----

def _src(name):
    return (_build.CSRC / name).read_text()


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_wrapper_and_source_share_their_constants():
    src, hdr = _src("epoch_mma.cu"), _src("mma_step.cuh")
    assert _const(src, "MAX_BATCH") == fused_step.MMA_MAX_BATCH
    assert _const(hdr, "B_MAX") == fused_step.MMA_MAX_BATCH
    assert _const(src, "THREADS") == epoch_step.MMA_EPOCH_THREADS
    # the hidden phase's block: a warp a k chunk of 112
    assert _const(src, "THREADS") == 32 * 784 // _const(hdr, "KC")
    unit, grads = _const(src, "UNIT_BLOCKS"), _const(src, "GRADS_BLOCKS")
    assert (unit, grads) == (epoch_step.MMA_EPOCH_UNIT_BLOCKS,
                             epoch_step.MMA_EPOCH_GRADS_BLOCKS)
    assert unit == 128 // _const(hdr, "HU")
    tiles = 784 // 16 + 128 // 16 + 1 + 2 * 128 // _const(hdr, "BIAS_COLS")
    assert grads == tiles == 66
    rows_tile = _const(hdr, "HR")
    for batch in range(1, fused_step.MMA_MAX_BATCH + 1):
        want = max(unit * -(-batch // rows_tile), grads)
        assert epoch_step.mma_epoch_blocks(batch) == want, batch
    assert epoch_step.mma_epoch_blocks(128) == 128    # one block an SM
    # one stamp more than the phases between them
    stamps = re.search(r"enum Stamp : int \{(.*?)N_STAMPS", src, re.S).group(1)
    assert len(re.findall(r"\bST_\w+", stamps)) == \
        len(epoch_step.MMA_EPOCH_PHASES) + 1
    assert "#ifdef EMMA_STAMPS" in src


def test_the_epoch_runs_k1_mma_phase_code_in_one_cooperative_launch():
    src, k1, hdr = _src("epoch_mma.cu"), _src("fused_mma.cu"), \
        _src("mma_step.cuh")
    for text in (src, k1):
        assert '#include "mma_step.cuh"' in text
        # a call of each phase (K1-mma's hidden_tile names its template
        # arguments: it draws the mask before the chain)
        assert re.search(r"hidden_tile(<MaskAt, true>)?\(", text)
        for body in ("rows_tile<", "grads_tile("):
            assert body in text
    # the products on the tensor cores, in the shared header only
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in hdr
    assert "mma.sync.aligned" not in src + k1
    assert src.count("cudaLaunchCooperativeKernel(") == 1
    assert "fence.proxy.async" in src and "grid.sync()" in src
    assert "StoreSgd{" in src and "StoreGrad{" in k1
    # no float atomics, no FFMA chains
    for text in (src, hdr):
        assert "atomicAdd" not in text and "fmaf(" not in text
    for entry in ("max_batch", "threads", "blocks", "smem_bytes",
                  "scratch_bytes", "stamps_per_step", "epoch"):
        assert f'extern "C" int pdmt_emma_{entry}(' in src


def test_build_has_the_mma_epoch_source_and_its_stamps_variant():
    assert _build.SOURCES["epoch_mma"] == "epoch_mma.cu"
    assert _build.VARIANTS["epoch_mma_stamps"] == ("epoch_mma",
                                                   ("-DEMMA_STAMPS",))
    assert _build._target("epoch_mma") != _build._target("epoch_mma_stamps")
    assert "mma_step.cuh" in [h.name for h in _build.CSRC.glob("*.cuh")]
    assert "epoch_step_mma" in epoch_step.launch_count


def test_mma_epoch_refuses_before_loading_a_library(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a library was loaded")
    monkeypatch.setattr(_build, "load", boom)
    monkeypatch.setattr(epoch_step, "_mma_lib", boom)
    x, y, _, seed = _inputs(2, 8, "core")
    params = from_jax_params(_jax_params()).params()
    with pytest.raises(ValueError, match="max_blocks"):
        epoch_step._mma_cuda(params, x, y, seed, 0.01, 8, None, "core", 2, 1,
                             2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        epoch_step.mma_epoch_phase_stamps(params, x, y, seed, 0.01, 8)
    with pytest.raises(ValueError, match="CUDA"):
        epoch_step.mma_epoch_phase_stamps(params, x.float(), y, seed, 0.01, 8)


# ---- the bf16 normalise table ----

def test_the_bf16_table_is_the_normalised_pixel_rounded_bitwise():
    table = epoch_step.pixel_table_bf16("cpu")
    assert table.dtype == torch.bfloat16 and table.shape == (256,)
    px = torch.arange(256, dtype=torch.uint8)
    assert torch.equal(table, device_normalize(px).to(torch.bfloat16))
    v = np.arange(256, dtype=np.uint8).reshape(1, 16, 16)
    jax_bf16 = np.asarray(jnp.asarray(jax_normalize(v)[0]).astype(jnp.bfloat16)
                          .astype(jnp.float32))
    np.testing.assert_array_equal(table.float().numpy(), jax_bf16)
    # a step's rows through the table are K1-mma's bf16 x
    rows = torch.from_numpy(synthetic_mnist(32, seed=2).images.reshape(32, -1))
    assert torch.equal(table[rows.long()],
                       device_normalize(rows).to(torch.bfloat16))


# ---- the CPU path at full width against JAX ----

@pytest.fixture
def no_kernels(monkeypatch):
    """Fail on any attempt to build or load a kernel library or reach a
    CUDA wrapper."""
    def boom(*a, **k):
        raise AssertionError("the CPU path must not touch a kernel")
    for name in ("_mma_cuda", "_mma_lib", "_ws_cuda", "_epoch_cuda",
                 "_kernel_lib"):
        monkeypatch.setattr(epoch_step, name, boom)
    monkeypatch.setattr(_build, "load", boom)
    monkeypatch.setattr(_build, "build_all", boom)


def _jax_masks(rng, masks, keys, nsteps, batch):
    """The real steps' masks as the JAX package draws them: the pre-drawn
    rows, or jax's dropout_mask of each step's threefry key."""
    if rng == "masks":
        return np.asarray(masks[:nsteps * batch])
    words = np.asarray(keys[:nsteps]).astype(np.uint32)
    return np.concatenate([np.asarray(jax_ps.dropout_mask(
        jax.random.wrap_key_data(jnp.asarray(w)), batch)) for w in words])


@pytest.mark.parametrize("rng", ["masks", "threefry"])
@pytest.mark.parametrize("k", [1, 4], ids=["K1", "K4-ragged"])
def test_cpu_path_matches_the_jax_kernel_oracle_and_bf16_steps(no_kernels,
                                                               rng, k):
    # B = 128 at full width, 3 real steps; K = 4 gets them padded to 4 at
    # the index level with valid_steps = 3, as the hot paths pass them
    batch, real, lr = 128, 3, 0.05
    nsteps = real if k == 1 else 4
    valid = None if k == 1 else real
    x, y, masks, keys = _inputs(nsteps, batch, rng, seed=k + 20)
    tree = _jax_params(k)
    params = from_jax_params(tree).params()
    assert epoch_step.epoch_design(x.dtype, True, batch) == "mma"
    counts = dict(epoch_step.launch_count)
    got_p, got_l = epoch_step.epoch_fused_sgd(
        params, x, y, keys, lr, batch, masks=masks,
        rng_impl="threefry" if rng == "threefry" else "core",
        compute_bf16=True, steps_per_iter=k, valid_steps=valid)
    assert epoch_step.launch_count == counts
    assert got_l.shape == (real,)

    jp, jl = jax_ps.epoch_fused_sgd(
        tree, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
        None if keys is None else jnp.asarray(keys.numpy()), lr, batch,
        masks=None if masks is None else jnp.asarray(masks.numpy()),
        rng_impl="threefry" if rng == "threefry" else "core",
        interpret=True, compute_bf16=True, steps_per_iter=k,
        valid_steps=valid)
    n = real * batch
    op, ol = jax_ps.epoch_sgd_reference(
        tree, jnp.asarray(x.numpy()[:n]), jnp.asarray(y.numpy()[:n]),
        jnp.asarray(_jax_masks(rng, masks, keys, real, batch)), lr, batch,
        compute_bf16=True)
    mine = to_numpy_params(got_p)
    for ref_p, ref_l in ((jp, np.asarray(jl)[:real]), (op, ol)):
        np.testing.assert_allclose(got_l.numpy(), np.asarray(ref_l),
                                   **EPOCH_TOL)
        for name in mine:
            for leaf in mine[name]:
                np.testing.assert_allclose(
                    mine[name][leaf], np.asarray(ref_p[name][leaf]),
                    err_msg=f"{name}.{leaf}", **EPOCH_TOL)

    # bitwise the port's bf16 step (K1-mma's plain version, on the rows
    # K2-mma converts through its table) + SGD per step
    table = epoch_step.pixel_table_bf16("cpu")
    p = {name: {leaf: v.clone() for leaf, v in layer.items()}
         for name, layer in params.items()}
    losses = []
    for s in range(real):
        rows = slice(s * batch, (s + 1) * batch)
        mask = epoch_step.step_mask(rng, keys, masks, s, batch, "cpu")
        loss, grads = fused_step.step_reference_bf16(
            p, table[x[rows].long()], y[rows], mask)
        sgd_step(p, grads, lr)
        losses.append(loss)
    assert torch.equal(got_l, torch.stack(losses))
    for name in p:
        for leaf in p[name]:
            assert torch.equal(got_p[name][leaf], p[name][leaf]), \
                f"{name}.{leaf}"
