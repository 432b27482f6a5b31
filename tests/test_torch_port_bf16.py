"""The bf16-operand mode of the port (K1-bf16, K2-bf16, the cached `xla`
run in bf16, the CLI with `--dtype bfloat16`) against the JAX package, on
the CPU.

The plain versions cast each product's operands to bf16 and back and run
f32 matmuls, at the kernels' cast points (ops/fused_step.py
`step_reference_bf16`). Tolerances are the JAX package's pins for its bf16
kernels against its own oracle (tests/test_pallas_step.py): loss rtol 1e-3,
grads rtol 2e-3 / atol 1e-4; an epoch's losses and params rtol 1e-3 /
atol 1e-4. The cached `xla` run computes every product and every
elementwise op in bf16 (JAX's recipe), so a bf16 rounding that goes the
other way in the other library moves a value by up to 2**-8 of itself;
over 2 epochs it is held at rtol 1e-2 / atol 3e-3 (losses and params; on
this test's inputs the worst were 3.1e-3 relative on a loss and 1.8e-3
absolute on a param).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu.models.mlp import init_mlp
from pytorch_ddp_mnist_tpu.models.mlp import mlp_apply as jax_mlp_apply
from pytorch_ddp_mnist_tpu.ops import pallas_step as jax_ps
from pytorch_ddp_mnist_tpu.train import scan as jax_scan
from pytorch_ddp_mnist_tpu_torch.cli import train as port_cli
from pytorch_ddp_mnist_tpu_torch.data.mnist import normalize_images, synthetic_mnist
from pytorch_ddp_mnist_tpu_torch.models.mlp import (from_jax_params, mlp_apply,
                                                    to_numpy_params)
from pytorch_ddp_mnist_tpu_torch.ops import epoch_step, fused_step, threefry
from pytorch_ddp_mnist_tpu_torch.ops.sgd import sgd_step
from pytorch_ddp_mnist_tpu_torch.train import scan

LOSS_RTOL = 1e-3
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-4
EPOCH_TOL = dict(rtol=1e-3, atol=1e-4)
RUN_TOL = dict(rtol=1e-2, atol=3e-3)

_jax_fused = jax.jit(partial(jax_ps.fused_loss_and_grads, interpret=True))


def _jax_params(seed=0):
    return jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.key(seed)))


def _step_inputs(batch, seed):
    split = synthetic_mnist(batch, seed=seed)
    rng = np.random.default_rng(seed + 1000)
    mask = (rng.random((batch, 128)) < 0.8).astype(np.float32) / np.float32(0.8)
    return normalize_images(split.images), split.labels.astype(np.int32), mask


def _assert_step_close(got, ref):
    loss, grads = got
    ref_loss, ref_grads = ref
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    for n in ref_grads:
        for k in ref_grads[n]:
            np.testing.assert_allclose(
                np.asarray(grads[n][k]), np.asarray(ref_grads[n][k]),
                rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=f"{n}.{k}")


def _assert_tree_close(got, ref, **tol):
    got = to_numpy_params(got)
    for n in got:
        for k in got[n]:
            np.testing.assert_allclose(got[n][k], np.asarray(ref[n][k]),
                                       err_msg=f"{n}.{k}", **tol)


# ---- K1-bf16 ----

@pytest.mark.parametrize("batch", [64, 600])     # one and two batch blocks
def test_bf16_step_matches_jax_kernel_and_oracle(batch):
    tree = _jax_params(batch)
    x, y, mask = _step_inputs(batch, seed=batch)
    params = from_jax_params(tree).params()
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = fused_step.fused_loss_and_grads(params, xt, torch.from_numpy(y),
                                          torch.from_numpy(mask))
    assert got[0].dtype == torch.float32
    assert all(g.dtype == torch.float32 for layer in got[1].values()
               for g in layer.values())
    jax_kernel = _jax_fused(tree, jnp.asarray(x).astype(jnp.bfloat16),
                            jnp.asarray(y), jnp.asarray(mask))
    jax_oracle = jax_ps.step_reference_bf16(tree, jnp.asarray(x),
                                            jnp.asarray(y), jnp.asarray(mask))
    _assert_step_close(got, jax_kernel)
    _assert_step_close(got, jax_oracle)
    # the mode switch does something: the f32 step differs
    f32 = fused_step.fused_loss_and_grads(params, torch.from_numpy(x),
                                          torch.from_numpy(y),
                                          torch.from_numpy(mask))
    assert float(got[0]) != float(f32[0])


def test_bf16_plain_version_rounds_at_the_cast_points():
    # gb1 sums dz1 unrounded: it equals the f32 sum of the plain backward,
    # while gw1 uses the rounded dz1 and x
    tree = _jax_params(1)
    x, y, mask = _step_inputs(32, seed=2)
    params = from_jax_params(tree).params()
    xt = torch.from_numpy(x).to(torch.bfloat16)
    loss, grads = fused_step.step_reference_bf16(params, xt,
                                                 torch.from_numpy(y),
                                                 torch.from_numpy(mask))
    _, jgrads = jax_ps.step_reference_bf16(tree, jnp.asarray(x),
                                           jnp.asarray(y), jnp.asarray(mask))
    np.testing.assert_allclose(grads["fc1"]["b"].numpy(),
                               np.asarray(jgrads["fc1"]["b"]), rtol=1e-5,
                               atol=1e-7)
    assert not torch.equal(grads["fc1"]["w"], grads["fc1"]["w"].to(
        torch.bfloat16).float())          # f32 accumulations, not bf16


# ---- K2-bf16 ----

@pytest.mark.parametrize("uint8", [True, False], ids=["uint8", "f32"])
def test_bf16_epoch_matches_jax_kernel_and_oracle(uint8):
    nsteps, batch, lr = 4, 16, 0.05
    split = synthetic_mnist(nsteps * batch, seed=11)
    x = (split.images.reshape(nsteps * batch, -1) if uint8
         else normalize_images(split.images))
    y = split.labels.astype(np.int32)
    rng = np.random.default_rng(6)
    masks = (rng.random((nsteps * batch, 128)) < 0.8).astype(np.float32) \
        / np.float32(0.8)
    tree = _jax_params()
    jax_kernel = jax_ps.epoch_fused_sgd(
        tree, jnp.asarray(x), jnp.asarray(y), None, lr, batch,
        masks=jnp.asarray(masks), interpret=True, compute_bf16=True)
    jax_oracle = jax_ps.epoch_sgd_reference(
        tree, jnp.asarray(x), jnp.asarray(y), jnp.asarray(masks), lr, batch,
        compute_bf16=True)
    port = epoch_step.epoch_fused_sgd(
        from_jax_params(tree).params(), torch.from_numpy(x),
        torch.from_numpy(y), None, lr, batch, masks=torch.from_numpy(masks),
        compute_bf16=True)
    for jp, jl in (jax_kernel, jax_oracle):
        np.testing.assert_allclose(port[1].numpy(), np.asarray(jl),
                                   **EPOCH_TOL)
        _assert_tree_close(port[0], jp, **EPOCH_TOL)
    f32 = epoch_step.epoch_fused_sgd(
        from_jax_params(tree).params(), torch.from_numpy(x),
        torch.from_numpy(y), None, lr, batch, masks=torch.from_numpy(masks))
    assert not torch.equal(port[1], f32[1])


def test_bf16_epoch_is_bf16_steps_plus_sgd():
    # the plain epoch is the bf16 step + SGD per step, bit for bit, in the
    # threefry form too (the card holds K2-bf16 to K1-bf16 the same way)
    nsteps, batch, lr = 3, 8, 0.05
    split = synthetic_mnist(nsteps * batch, seed=4)
    x = torch.from_numpy(split.images.reshape(nsteps * batch, -1))
    y = torch.from_numpy(split.labels.astype(np.int32))
    keys = threefry.to_int32_words(threefry.split(threefry.key_data(2), nsteps))
    params = from_jax_params(_jax_params()).params()
    got_p, got_l = epoch_step.epoch_fused_sgd(params, x, y, keys, lr, batch,
                                              rng_impl="threefry",
                                              compute_bf16=True)
    p = {n: {k: v.detach().clone() for k, v in layer.items()}
         for n, layer in params.items()}
    losses = []
    for s in range(nsteps):
        rows = slice(s * batch, (s + 1) * batch)
        xb = scan.device_normalize(x[rows]).to(torch.bfloat16)
        mask = epoch_step.step_mask("threefry", keys, None, s, batch, "cpu")
        loss, grads = fused_step.fused_loss_and_grads(p, xb, y[rows], mask)
        sgd_step(p, grads, lr)
        losses.append(loss)
    assert torch.equal(got_l, torch.stack(losses))
    _assert_tree_close(got_p, to_numpy_params(p), rtol=0, atol=0)


# ---- the bf16 forward and the cached runs ----

@pytest.mark.parametrize("form", ["keyed", "streamed"])
def test_bf16_dropout_divisor_pins_jax(form):
    # keyed dropout divides by bf16(0.8) = 0.80078125, which is not a
    # multiplication by 1.25; the streamed mask multiplies by bf16(1.25)
    tree = _jax_params(3)
    x = np.random.default_rng(4).normal(0, 1, (64, 784)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    key = jax.random.key(7)
    keep = np.array(jax.random.bernoulli(key, 0.8, (64, 128)))
    if form == "keyed":
        ref = jax_mlp_apply(tree, xb, train=True, dropout_key=key)
        kw = {"keep": torch.from_numpy(keep)}
    else:
        ref = jax_mlp_apply(tree, xb, train=True, dropout_mask=jnp.asarray(keep))
        kw = {"dropout_mask": torch.from_numpy(keep)}
    params = from_jax_params(tree).params()
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = mlp_apply(params, xt, train=True, **kw)
    assert got.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(got.float().detach().numpy(), ref, rtol=2e-2,
                               atol=2e-2)
    # the divisor itself, on the values fc1 gives
    h = torch.relu(xt @ params["fc1"]["w"].to(torch.bfloat16)
                   + params["fc1"]["b"].to(torch.bfloat16))
    div = h / torch.tensor(0.8, dtype=torch.bfloat16)
    jdiv = np.asarray((jax.nn.relu(xb @ jnp.asarray(tree["fc1"]["w"]).astype(
        jnp.bfloat16) + jnp.asarray(tree["fc1"]["b"]).astype(jnp.bfloat16))
        / jnp.asarray(0.8, jnp.bfloat16)).astype(jnp.float32))
    mul = h * torch.tensor(1.25, dtype=torch.bfloat16)
    assert float(torch.tensor(0.8, dtype=torch.bfloat16)) == 0.80078125
    assert int((div != mul).sum()) > 0
    np.testing.assert_allclose(div.float().detach().numpy(), jdiv, rtol=1e-2,
                               atol=1e-2)


def _run_inputs(epochs=2, nsteps=4, batch=16, n=100):
    split = synthetic_mnist(n, seed=3)
    rng = np.random.default_rng(0)
    idxs = np.stack([rng.permutation(n)[:nsteps * batch].reshape(nsteps, batch)
                     for _ in range(epochs)]).astype(np.int32)
    return split.images.reshape(n, -1), split.labels.astype(np.int32), idxs


@pytest.mark.parametrize("kernel", ["xla", "pallas", "pallas_epoch"])
def test_cached_bf16_run_tracks_jax_make_run_fn(kernel):
    x, y, idxs = _run_inputs()
    tree = _jax_params()
    jp, jk, jl = jax_scan.make_run_fn(0.05, dtype="bfloat16", kernel=kernel,
                                      interpret=True)(
        jax.tree_util.tree_map(jnp.asarray, tree), jax.random.key(9),
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(idxs))
    pp, pk, pl = scan.make_run_fn(0.05, dtype="bfloat16", kernel=kernel)(
        from_jax_params(tree).params(), threefry.key_data(9),
        torch.from_numpy(x), torch.from_numpy(y), idxs)
    assert pl.shape == (2, 4) and pl.dtype == torch.float32
    assert pk == tuple(np.asarray(jax.random.key_data(jk)).tolist())
    tol = RUN_TOL if kernel == "xla" else EPOCH_TOL
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **tol)
    _assert_tree_close(pp, jp, **tol)
    f32 = scan.make_run_fn(0.05, kernel=kernel)(
        from_jax_params(tree).params(), threefry.key_data(9),
        torch.from_numpy(x), torch.from_numpy(y), idxs)
    assert not torch.equal(pl, f32[2])


# ---- the CLI ----

@pytest.mark.parametrize("extra", [
    [],                                               # streaming, auto -> xla
    ["--kernel", "pallas"],                           # streaming K1-bf16
    ["--cached", "--kernel", "xla"],
    ["--cached", "--kernel", "pallas_epoch", "--fused", "--n_epochs", "2"],
])
def test_cli_trains_in_bf16_on_the_cpu(tmp_path, capsys, extra):
    before = (dict(fused_step.launch_count), dict(epoch_step.launch_count))
    _, history = port_cli.train(
        ["--device", "cpu", "--dtype", "bfloat16", "--limit", "256",
         "--batch_size", "64", "--checkpoint", "",
         "--path", str(tmp_path / "none"), *extra])
    out = capsys.readouterr().out
    assert "dtype=bfloat16" in out
    assert all(h.shape == (4,) and np.isfinite(h).all() for h in history)
    assert (dict(fused_step.launch_count),
            dict(epoch_step.launch_count)) == before


def test_streaming_xla_trains_in_f32_under_bf16(tmp_path):
    # the JAX trainer's streaming `xla` step takes no dtype; neither does
    # the port's: --dtype bfloat16 there gives the float32 run bit for bit
    runs = []
    for dtype in ("float32", "bfloat16"):
        _, history = port_cli.train(
            ["--device", "cpu", "--dtype", dtype, "--kernel", "xla",
             "--limit", "128", "--batch_size", "64", "--checkpoint", "",
             "--path", str(tmp_path / "none")])
        runs.append(history[0])
    np.testing.assert_array_equal(runs[0], runs[1])
