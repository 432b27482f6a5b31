"""The port's model, loss and SGD against the JAX package's, on the same
weights and numpy-seeded inputs.

Tolerances: forward passes and losses through float32 matrix products in
two BLAS libraries agree to rtol 1e-5 / atol 1e-6 (summation order only);
SGD and the params-tree round trip are elementwise and must be bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu.models.mlp import init_mlp, mlp_apply
from pytorch_ddp_mnist_tpu.ops import loss as jax_loss
from pytorch_ddp_mnist_tpu.ops.sgd import sgd_step as jax_sgd_step
from pytorch_ddp_mnist_tpu_torch.models.mlp import (
    DROPOUT_RATE, MLP, MLP_DIMS, from_jax_params, param_count,
    to_numpy_params)
from pytorch_ddp_mnist_tpu_torch.ops import fused_step
from pytorch_ddp_mnist_tpu_torch.ops import loss as port_loss
from pytorch_ddp_mnist_tpu_torch.ops import threefry
from pytorch_ddp_mnist_tpu_torch.ops.sgd import sgd_step

RTOL, ATOL = 1e-5, 1e-6


def _tree(seed):
    return jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.key(seed)))


def _x(batch, seed):
    return np.random.default_rng(seed).normal(0, 1, (batch, 784)).astype(np.float32)


def test_constants_match_the_jax_package():
    from pytorch_ddp_mnist_tpu.models import mlp as jax_mlp
    assert MLP_DIMS == jax_mlp.MLP_DIMS
    assert DROPOUT_RATE == jax_mlp.DROPOUT_RATE


@pytest.mark.parametrize("batch", [1, 17, 128])
def test_forward_eval_matches_mlp_apply(batch):
    tree, x = _tree(batch), _x(batch, batch)
    ref = np.asarray(mlp_apply(tree, jnp.asarray(x), train=False))
    got = from_jax_params(tree)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("batch", [5, 64])
def test_forward_train_matches_mlp_apply_with_the_same_mask(batch):
    tree, x = _tree(3), _x(batch, 4)
    keep = np.random.default_rng(5).random((batch, 128)) < 0.8
    ref = np.asarray(mlp_apply(tree, jnp.asarray(x), train=True,
                               dropout_mask=jnp.asarray(keep)))
    got = from_jax_params(tree)(torch.from_numpy(x), train=True,
                                dropout_mask=torch.from_numpy(keep))
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=RTOL, atol=ATOL)


def test_forward_train_requires_a_mask():
    with pytest.raises(ValueError, match="dropout_mask"):
        MLP()(torch.zeros(2, 784), train=True)


@pytest.mark.parametrize("batch", [1, 33, 256])
def test_cross_entropy_and_accuracy_match_jax(batch):
    rng = np.random.default_rng(batch)
    logits = rng.normal(0, 3, (batch, 10)).astype(np.float32)
    labels = rng.integers(0, 10, batch).astype(np.int32)
    np.testing.assert_allclose(
        float(port_loss.cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(labels))),
        float(jax_loss.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=RTOL)
    assert float(port_loss.accuracy(torch.from_numpy(logits),
                                    torch.from_numpy(labels))) == \
        float(jax_loss.accuracy(jnp.asarray(logits), jnp.asarray(labels)))


@pytest.mark.parametrize("lr", [0.01, 0.37])
def test_sgd_step_is_bitwise_jax(lr):
    tree = _tree(1)
    grads = jax.tree_util.tree_map(
        lambda p: np.random.default_rng(p.size).normal(0, 1, p.shape)
        .astype(np.float32), tree)
    ref = jax.tree_util.tree_map(np.asarray, jax_sgd_step(tree, grads, lr))
    model = from_jax_params(tree)
    out = sgd_step(model.params(),
                   {n: {k: torch.from_numpy(v) for k, v in d.items()}
                    for n, d in grads.items()}, lr)
    assert out is not None
    got = to_numpy_params(model)
    for n in ref:
        for k in ref[n]:
            np.testing.assert_array_equal(got[n][k], ref[n][k], err_msg=f"{n}.{k}")


def test_jax_params_round_trip_bitwise():
    tree = _tree(9)
    back = to_numpy_params(from_jax_params(tree))
    assert set(back) == {"fc1", "fc2", "fc3"}
    assert set(back["fc3"]) == {"w"}
    for n in tree:
        for k in tree[n]:
            assert back[n][k].dtype == np.float32
            np.testing.assert_array_equal(back[n][k], tree[n][k])


def test_from_jax_params_rejects_a_wrong_shape():
    tree = _tree(0)
    tree["fc2"]["w"] = tree["fc2"]["w"][:, :64]
    with pytest.raises(ValueError, match="fc2.w"):
        from_jax_params(tree)


def test_init_is_torch_linear_uniform_and_seeded():
    a = MLP(torch.Generator().manual_seed(0))
    b = MLP(torch.Generator().manual_seed(0))
    c = MLP(torch.Generator().manual_seed(1))
    pa, pb, pc = a.params(), b.params(), c.params()
    assert param_count(pa) == 784 * 128 + 128 + 128 * 128 + 128 + 128 * 10
    assert pa["fc3"].keys() == {"w"}
    for n, fan_in in (("fc1", 784), ("fc2", 128), ("fc3", 128)):
        for k, p in pa[n].items():
            assert p.dtype == torch.float32
            assert float(p.detach().abs().max()) <= 1 / np.sqrt(fan_in)
            assert torch.equal(p, pb[n][k])
            assert not torch.equal(p, pc[n][k])
    assert tuple(pa["fc1"]["w"].shape) == (784, 128)   # (fan_in, fan_out)


def test_keep_mask_rate_and_determinism():
    # the keep draw of the keyed dropout: jax's bernoulli of a threefry key
    key = threefry.key_data(0)
    m = fused_step.dropout_mask(key, 1000, "cpu") > 0
    assert m.dtype == torch.bool and m.shape == (1000, 128)
    assert abs(float(m.float().mean()) - (1 - DROPOUT_RATE)) < 0.01
    assert torch.equal(m, fused_step.dropout_mask(key, 1000, "cpu") > 0)
    ref = jax.random.bernoulli(jax.random.key(0), 1 - DROPOUT_RATE, (1000, 128))
    np.testing.assert_array_equal(m.numpy(), np.asarray(ref))
