"""The port's whole-epoch kernel (K2) and its dropout streams against the
JAX package, on the CPU.

On the CPU `epoch_fused_sgd` runs its plain version; it is held against
JAX `epoch_fused_sgd(..., masks=..., interpret=True)` and
`epoch_sgd_reference` on the same weights (through `from_jax_params`),
rows and masks at the JAX package's own tolerance for that kernel
(tests/test_pallas_step.py, test_epoch_masked_kernel_matches_pure_jax_oracle):
rtol 1e-5 / atol 1e-6. The threefry stream, its key chain and the normalize
are bitwise. The CUDA kernel runs only on a card: tests/test_torch_port_gpu.py
and chip_smoke.py hold it against the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu.models.mlp import init_mlp
from pytorch_ddp_mnist_tpu.ops import pallas_step as jax_ps
from pytorch_ddp_mnist_tpu_torch.data.mnist import normalize_images, synthetic_mnist
from pytorch_ddp_mnist_tpu_torch.models.mlp import from_jax_params, to_numpy_params
from pytorch_ddp_mnist_tpu_torch.ops import _build, epoch_step, philox, threefry

RTOL, ATOL = 1e-5, 1e-6
SEEDS = [0, 7, (1 << 31) + 3]


def _jax_params(seed=0):
    return jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.key(seed)))


def _port_params(tree):
    return from_jax_params(tree).params()


def _epoch_data(nsteps, batch, seed, uint8):
    split = synthetic_mnist(nsteps * batch, seed=seed)
    x = (split.images.reshape(nsteps * batch, -1) if uint8
         else normalize_images(split.images))
    return np.ascontiguousarray(x), split.labels.astype(np.int32)


def _masks(rows, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((rows, 128)) < 0.8).astype(np.float32) / np.float32(0.8)


def _assert_epoch_close(port, jax_out, **tol):
    (pp, pl), (jp, jl) = port, jax_out
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **tol)
    got = to_numpy_params(pp)
    for n in got:
        for k in got[n]:
            np.testing.assert_allclose(got[n][k], np.asarray(jp[n][k]),
                                       err_msg=f"{n}.{k}", **tol)


# ---- the threefry stream and its key chain ----

@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_cipher_and_mask_bitwise_vs_jax(seed):
    key = jax.random.key(seed)
    k0, k1 = threefry.key_data(seed)
    idx = torch.arange(4096, dtype=torch.int64)
    o0, o1 = threefry.threefry2x32(k0, k1, torch.zeros_like(idx), idx)
    np.testing.assert_array_equal(
        (o0 ^ o1).numpy().astype(np.uint32),
        np.asarray(jax.random.bits(key, (4096,), "uint32")))
    jk0, jk1 = (jnp.uint32(w) for w in (k0, k1))
    block = np.asarray(jax.jit(jax_ps._threefry_mask_block,
                               static_argnums=2)(jk0, jk1, 256))
    np.testing.assert_array_equal(threefry.mask_block(k0, k1, 256).numpy(),
                                  block)
    np.testing.assert_array_equal(
        threefry.dropout_mask((k0, k1), 256).numpy(),
        np.asarray(jax_ps.dropout_mask(key, 256)))
    # Python ints and int64 tensors give the same words
    assert threefry.threefry2x32(k0, k1, 0, 4095) == (int(o0[-1]), int(o1[-1]))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_data_and_split_chain_bitwise_vs_jax(seed):
    key = jax.random.key(seed)
    port = threefry.key_data(seed)
    assert port == tuple(np.asarray(jax.random.key_data(key)).tolist())
    for _ in range(3):    # the trainer's chain: key, sub = split(key)
        key, sub = jax.random.split(key)
        port, psub = threefry.split(port)
        assert port == tuple(np.asarray(jax.random.key_data(key)).tolist())
        assert psub == tuple(np.asarray(jax.random.key_data(sub)).tolist())
    subs = jax.random.split(sub, 37)
    np.testing.assert_array_equal(
        np.array(threefry.split(psub, 37), np.uint32),
        np.asarray(jax.random.key_data(subs)))
    np.testing.assert_array_equal(
        threefry.to_int32_words(threefry.split(psub, 37)).numpy(),
        np.asarray(jax.random.key_data(subs).astype(jnp.int32)))


def test_key_data_refuses_seeds_whose_words_depend_on_x64():
    assert threefry.key_data(-1) == (0, 0xFFFFFFFF)
    assert threefry.key_data((1 << 32) - 1) == (0, 0xFFFFFFFF)
    for seed in (1 << 32, -(1 << 31) - 1):
        with pytest.raises(ValueError, match="jax_enable_x64"):
            threefry.key_data(seed)


def test_dropout_mask_eval_is_ones():
    m = threefry.dropout_mask((0, 1), 4, train=False)
    assert m.shape == (4, 128) and bool((m == 1).all())


# ---- the Philox stream of the core form ----

def test_philox_known_answers_on_ints_and_tensors():
    # Random123's philox4x32-10 known-answer vectors
    m = 0xFFFFFFFF
    vectors = [
        ((0, 0, 0, 0, 0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((m, m, m, m, m, m), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344, 0xA4093822,
          0x299F31D0), (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for args, want in vectors:
        assert philox.philox4x32(*args) == want
        t = [torch.tensor([a], dtype=torch.int64) for a in args[:4]]
        got = philox.philox4x32(*t, *args[4:])
        assert tuple(int(w) for w in got) == want
    assert philox.KEEP_THRESH == jax_ps._KEEP_THRESH


def test_philox_masks_deterministic_distinct_and_keep_rate():
    a = philox.mask_block(123, 5, 64)
    assert torch.equal(a, philox.mask_block(123, 5, 64))
    assert torch.equal(a, philox.mask_block(123 + (1 << 32), 5, 64))
    for other in (philox.mask_block(124, 5, 64), philox.mask_block(123, 6, 64),
                  philox.mask_block(5, 123, 64)):
        assert not torch.equal(a, other)
    assert set(torch.unique(a).tolist()) == {0.0, 1.25}
    # the keep rate over 40 steps x 256 x 128 draws, within 4 sigma of 0.8
    keep = torch.cat([philox.mask_block(9, s, 256).flatten() > 0
                      for s in range(40)]).double()
    n = keep.numel()
    assert abs(float(keep.mean()) - 0.8) < 4 * (0.8 * 0.2 / n) ** 0.5
    # a row's draw does not depend on how many rows the block has
    assert torch.equal(philox.mask_block(9, 3, 8), philox.mask_block(9, 3, 16)[:8])


# ---- the epoch: plain version against the JAX kernel ----

@pytest.mark.parametrize("uint8", [False, True], ids=["f32", "uint8"])
def test_epoch_plain_matches_jax_kernel_and_oracle(uint8):
    nsteps, batch, lr = 12, 16, 0.05     # crosses an (8, 128) loss tile
    x, y = _epoch_data(nsteps, batch, seed=3, uint8=uint8)
    masks = _masks(nsteps * batch, seed=5)
    tree = _jax_params()
    jax_kernel = jax_ps.epoch_fused_sgd(tree, jnp.asarray(x), jnp.asarray(y),
                                        None, lr, batch,
                                        masks=jnp.asarray(masks),
                                        interpret=True)
    jax_oracle = jax_ps.epoch_sgd_reference(tree, jnp.asarray(x),
                                            jnp.asarray(y), jnp.asarray(masks),
                                            lr, batch)
    params = _port_params(tree)
    before = to_numpy_params(params)
    port = epoch_step.epoch_fused_sgd(params, torch.from_numpy(x),
                                      torch.from_numpy(y), None, lr, batch,
                                      masks=torch.from_numpy(masks))
    assert port[1].shape == (nsteps,) and port[1].dtype == torch.float32
    _assert_epoch_close(port, jax_kernel, rtol=RTOL, atol=ATOL)
    _assert_epoch_close(port, jax_oracle, rtol=RTOL, atol=ATOL)
    after = to_numpy_params(params)     # the inputs are never written
    for n in before:
        for k in before[n]:
            np.testing.assert_array_equal(after[n][k], before[n][k])


def test_epoch_threefry_form_matches_jax_threefry_kernel():
    nsteps, batch, lr = 5, 32, 0.05
    x, y = _epoch_data(nsteps, batch, seed=3, uint8=True)
    subs = jax.random.split(jax.random.key(42), nsteps)
    keys = np.array(jax.random.key_data(subs).astype(jnp.int32))
    tree = _jax_params()
    jax_out = jax_ps.epoch_fused_sgd(tree, jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(keys), lr, batch,
                                     rng_impl="threefry", interpret=True)
    port = epoch_step.epoch_fused_sgd(_port_params(tree), torch.from_numpy(x),
                                      torch.from_numpy(y),
                                      torch.from_numpy(keys), lr, batch,
                                      rng_impl="threefry")
    _assert_epoch_close(port, jax_out, rtol=RTOL, atol=ATOL)
    # the same epoch with the threefry masks streamed in: the same bits
    masks = torch.cat([epoch_step.kernel_mask_block(
        torch.from_numpy(keys), s, batch, rng_impl="threefry", device="cpu")
        for s in range(nsteps)])
    streamed = epoch_step.epoch_fused_sgd(_port_params(tree),
                                          torch.from_numpy(x),
                                          torch.from_numpy(y), None, lr, batch,
                                          masks=masks)
    assert torch.equal(streamed[1], port[1])


def test_epoch_core_form_draws_the_philox_stream():
    nsteps, batch, lr = 3, 8, 0.05
    x, y = _epoch_data(nsteps, batch, seed=4, uint8=True)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    seed = (1 << 32) - 5
    core = epoch_step.epoch_fused_sgd(_port_params(_jax_params()), xt, yt,
                                      seed, lr, batch, rng_impl="core")
    masks = torch.cat([philox.mask_block(seed, s, batch) for s in range(nsteps)])
    streamed = epoch_step.epoch_fused_sgd(_port_params(_jax_params()), xt, yt,
                                          None, lr, batch, masks=masks)
    assert torch.equal(core[1], streamed[1])
    for s in range(nsteps):
        assert torch.equal(epoch_step.kernel_mask_block(
            seed, s, batch, rng_impl="core", device="cpu"),
            philox.mask_block(seed, s, batch))


# ---- the wrapper refuses what the JAX wrapper refuses ----

def _refusal_case(kind):
    x = np.zeros((32, 784), np.float32)
    y = np.zeros(32, np.int32)
    keys = np.zeros((2, 2), np.int32)
    cases = {
        "batch_not_8": (x[:30], y[:30], 5, 15, {}, "divisible by 8"),
        "batch_over_cap": (np.zeros((2048, 784), np.float32),
                           np.zeros(2048, np.int32), 5, 2048, {}, "1024"),
        "bad_impl": (x, y, keys, 16, {"rng_impl": "rbg"}, "rng_impl"),
        "masks_and_threefry": (x, y, keys, 16,
                               {"rng_impl": "threefry",
                                "masks": np.ones((32, 128), np.float32)},
                               "not both"),
        "keys_not_2d": (x, y, np.zeros((2,), np.int32), 16,
                        {"rng_impl": "threefry"}, "key words"),
        "keys_per_step": (x, y, np.zeros((3, 2), np.int32), 16,
                          {"rng_impl": "threefry"}, "one key-word row per step"),
    }
    return cases[kind]


@pytest.mark.parametrize("kind", ["batch_not_8", "batch_over_cap", "bad_impl",
                                  "masks_and_threefry", "keys_not_2d",
                                  "keys_per_step"])
def test_epoch_wrapper_refuses_what_jax_refuses(kind):
    x, y, seed, batch, kw, match = _refusal_case(kind)
    tree = _jax_params()
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    with pytest.raises(ValueError, match=match):
        jax_ps.epoch_fused_sgd(tree, jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(seed), 0.01, batch,
                               interpret=True, **jkw)
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tseed = torch.from_numpy(seed) if isinstance(seed, np.ndarray) else seed
    with pytest.raises(ValueError, match=match):
        epoch_step.epoch_fused_sgd(_port_params(tree), torch.from_numpy(x),
                                   torch.from_numpy(y), tseed, 0.01, batch,
                                   **tkw)


def test_threefry_step_cap_is_kept():
    batch = 8
    nsteps = epoch_step.EPOCH_KERNEL_MAX_RNG_STEPS + 1
    x = torch.zeros((nsteps * batch, 784), dtype=torch.uint8)
    y = torch.zeros(nsteps * batch, dtype=torch.int32)
    keys = torch.zeros((nsteps, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 4096 steps"):
        epoch_step.epoch_fused_sgd(_port_params(_jax_params()), x, y, keys,
                                   0.01, batch, rng_impl="threefry")


def test_plain_version_runs_for_cpu_tensors_only(monkeypatch):
    def no_kernel():
        raise AssertionError("the CPU path must not build or load the kernel")

    monkeypatch.setattr(epoch_step, "_kernel_lib", no_kernel)
    x, y = _epoch_data(2, 8, seed=1, uint8=True)
    before = dict(epoch_step.launch_count)
    epoch_step.epoch_fused_sgd(_port_params(_jax_params()), torch.from_numpy(x),
                               torch.from_numpy(y), 3, 0.01, 8)
    assert epoch_step.launch_count == before
    meta = torch.empty((16, 784), device="meta")
    params = {n: {k: v.to("meta") for k, v in layer.items()}
              for n, layer in _port_params(_jax_params()).items()}
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        epoch_step.epoch_fused_sgd(params, meta,
                                   torch.empty(16, dtype=torch.int32,
                                               device="meta"), 3, 0.01, 8)
    with pytest.raises(ValueError, match="rng_impl"):
        epoch_step.kernel_mask_block(3, 0, 8, rng_impl="masks", device="cpu")


def test_build_knows_the_epoch_source_and_hashes_the_headers(monkeypatch,
                                                             tmp_path):
    assert _build.SOURCES["epoch_step"] == "epoch_step.cu"
    for src in _build.SOURCES.values():
        assert (_build.CSRC / src).exists()
    (tmp_path / "a.cu").write_text("// a\n")
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "SOURCES", {"a": "a.cu"})
    first = _build._target("a")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._target("a") != first
