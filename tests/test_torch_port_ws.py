"""K2-ws, the weight-stationary design of the whole-epoch kernel's uint8
f32 forms (csrc/epoch_ws.cu), on the CPU.

The kernel runs only on a card (tests/test_torch_port_gpu.py and
chip_smoke.py hold it bitwise against the rows design and K1 + SGD
there). Here: the rule that picks the design for a launch, the build
entries, the constants the wrapper and the source share, and the plain
normalise table against the JAX package's normalize (bitwise). The
plain version of its forms is held against the JAX kernel in
tests/test_torch_port_variants.py."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu.data.mnist import normalize_images as jax_normalize
from pytorch_ddp_mnist_tpu.models.mlp import init_mlp
from pytorch_ddp_mnist_tpu.train.scan import device_normalize as jax_device_normalize
from pytorch_ddp_mnist_tpu_torch.data.mnist import synthetic_mnist
from pytorch_ddp_mnist_tpu_torch.models.mlp import from_jax_params
from pytorch_ddp_mnist_tpu_torch.ops import _build, epoch_step, threefry

RNGS = ("masks", "core", "threefry")


def _inputs(nsteps, batch, rng, seed=3, uint8=True):
    split = synthetic_mnist(nsteps * batch, seed=seed)
    x = split.images.reshape(nsteps * batch, -1)
    x = torch.from_numpy(np.ascontiguousarray(x if uint8 else
                                              x.astype(np.float32)))
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
@pytest.mark.parametrize("batch", [8, 128])
def test_design_is_ws_for_the_main_path_forms(batch, rng, k):
    # uint8 rows in f32 at B = 8 and 128, every dropout source and K: the
    # wrapper's checks accept the launch and the rule picks K2-ws
    x, y, masks, seed_or_keys = _inputs(k, batch, rng)
    params = from_jax_params(jax.tree_util.tree_map(
        np.asarray, init_mlp(jax.random.key(0)))).params()
    got = epoch_step._check(params, x, y, seed_or_keys, batch, masks,
                            "threefry" if rng == "threefry" else "core", k)
    assert got[0] == rng
    assert epoch_step.epoch_design(x.dtype, False, batch) == "ws"


@pytest.mark.parametrize("dtype,bf16,batch", [
    (torch.float32, False, 8), (torch.float32, False, 128),
    (torch.float32, True, 8), (torch.float32, True, 128),
    (torch.uint8, False, 136), (torch.uint8, False, 1024),
    (torch.float32, True, 1024)])
def test_design_is_rows_for_f32_rows_bf16_and_large_batches(dtype, bf16,
                                                            batch):
    assert epoch_step.epoch_design(dtype, bf16, batch) == "rows"


def test_design_boundary_is_ws_max_batch():
    assert epoch_step.WS_MAX_BATCH == 128
    assert epoch_step.epoch_design(torch.uint8, False, 128) == "ws"
    assert epoch_step.epoch_design(torch.uint8, False, 129) == "rows"


def test_wrapper_and_source_share_their_constants():
    # the step's constants and stamps live in the header K2-ws shares with
    # K6-ws (csrc/ws_step.cuh)
    src = ((_build.CSRC / "epoch_ws.cu").read_text()
           + (_build.CSRC / "ws_step.cuh").read_text())
    assert int(re.search(r"constexpr int B_MAX = (\d+);", src).group(1)) \
        == epoch_step.WS_MAX_BATCH
    assert int(re.search(r"constexpr int TCOPIES = (\d+);", src).group(1)) \
        == epoch_step.WS_TABLE_COPIES
    # one stamp more than the phases between them
    stamps = re.search(r"enum Stamp : int \{(.*?)N_STAMPS", src, re.S).group(1)
    assert len(re.findall(r"\bST_\w+", stamps)) == \
        len(epoch_step.WS_PHASES) + 1
    assert "launch_count" not in src and "epoch_step_ws" in \
        epoch_step.launch_count and "design" in epoch_step.last_launch
    # the dropout-source codes the wrapper passes are the kernels' enum
    hdr = (_build.CSRC / "mlp_step.cuh").read_text()
    enum = re.search(r"enum Rng : int \{(.*?)\};", hdr).group(1)
    codes = {name: int(v) for name, v in re.findall(r"RNG_(\w+) = (\d)", enum)}
    assert codes == {"MASKS": epoch_step._RNG_CODE["masks"],
                     "THREEFRY": epoch_step._RNG_CODE["threefry"],
                     "PHILOX": epoch_step._RNG_CODE["core"]}


def test_build_has_the_ws_source_and_its_variants(monkeypatch, tmp_path):
    assert _build.SOURCES["epoch_ws"] == "epoch_ws.cu"
    for base, flags in _build.VARIANTS.values():
        assert base in _build.SOURCES
        assert all(f.startswith("-D") for f in flags)
    for name in ("a.cu", "h.cuh"):
        (tmp_path / name).write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "SOURCES", {"a": "a.cu"})
    monkeypatch.setattr(_build, "VARIANTS", {"a_x": ("a", ("-DX",)),
                                             "a_y": ("a", ("-DY",))})
    targets = {n: _build._target(n) for n in ("a", "a_x", "a_y")}
    assert len(set(targets.values())) == 3     # the flags are in the hash
    assert _build._spec("a_x") == ("a.cu", _build.NVCC_FLAGS + ("-DX",))


def test_the_plain_table_is_the_jax_normalize_bitwise():
    table = epoch_step.kernel_pixel_table("cpu")
    assert table.dtype == torch.float32
    assert table.shape == (256, epoch_step.WS_TABLE_COPIES)
    v = np.arange(256, dtype=np.uint8).reshape(1, 16, 16)
    for copy in table.unbind(1):
        np.testing.assert_array_equal(copy.numpy(), jax_normalize(v)[0])
    rows = synthetic_mnist(64, seed=2).images.reshape(64, -1)
    want = np.asarray(jax_device_normalize(jnp.asarray(rows)))
    np.testing.assert_array_equal(table[torch.from_numpy(rows).long(), 0]
                                  .numpy(), want)


def test_debug_entries_refuse_the_cpu():
    x, y, _, seed = _inputs(2, 8, "core")
    params = from_jax_params(jax.tree_util.tree_map(
        np.asarray, init_mlp(jax.random.key(0)))).params()
    with pytest.raises(ValueError, match="CUDA"):
        epoch_step.ws_phase_stamps(params, x, y, seed, 0.01, 8)
    with pytest.raises(ValueError, match="cuda or cpu"):
        epoch_step.kernel_pixel_table("meta")
