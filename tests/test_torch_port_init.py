"""The port's initial weights for a seed against the JAX package's.

`MLP.from_seed(s)` (the CLI's and the bench's init) must be bitwise
`init_mlp(jax.random.key(s))` for every leaf, and so the two CLIs, given
the same `--seed`, train the same model: their epoch lines agree on the
CPU. The losses in those lines are f32 sums taken in another order by the
two frameworks (XLA against torch's CPU kernels), so they are held at rtol
1e-5, the JAX package's pin for per-step losses; the accuracy is a count
and must be equal."""

import re

import jax
import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu.cli.train import main as jax_main
from pytorch_ddp_mnist_tpu.models.mlp import init_mlp
from pytorch_ddp_mnist_tpu_torch.cli.train import main as port_main
from pytorch_ddp_mnist_tpu_torch.models.mlp import MLP, init_params

SEEDS = [0, 1, 42, 2**31 - 1, -5]
LOSS_RTOL = 1e-5


@pytest.mark.parametrize("seed", SEEDS)
def test_init_is_bitwise_the_jax_init(seed):
    ref = init_mlp(jax.random.key(seed))
    got = MLP.from_seed(seed).params()
    assert {n: set(d) for n, d in got.items()} == \
        {n: set(d) for n, d in ref.items()}
    for name in ref:
        for k in ref[name]:
            want = np.asarray(ref[name][k])
            have = got[name][k].detach().numpy()
            assert have.dtype == np.float32 and have.shape == want.shape
            np.testing.assert_array_equal(have, want, err_msg=f"{name}.{k}")
    # the model's parameters are trainable leaves, the tree a plain copy
    assert all(p.requires_grad for p in MLP.from_seed(seed).parameters())
    assert not any(t.requires_grad for layer in init_params(seed).values()
                   for t in layer.values())


def test_torch_generator_init_stays_for_callers_that_ask_for_it():
    a = MLP(torch.Generator().manual_seed(0)).params()["fc1"]["w"]
    b = MLP.from_seed(0).params()["fc1"]["w"]
    assert not torch.equal(a, b)


_NUM = r"([-0-9.e]+)"
_LINE = re.compile(rf"^Epoch=(\d+), train_loss={_NUM}, val_loss={_NUM}  "
                   rf"\[mean_train={_NUM} mean_val={_NUM} acc={_NUM} ")


def _epoch_lines(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    out = capsys.readouterr().out
    return [_LINE.match(ln).groups() for ln in out.splitlines()
            if ln.startswith("Epoch=")]


@pytest.mark.parametrize("seed", SEEDS)
def test_the_two_clis_train_the_same_model_for_a_seed(seed, tmp_path,
                                                      capsys):
    argv = ["--kernel", "xla", "--limit", "1024", "--seed", str(seed),
            "--n_epochs", "2", "--checkpoint", "",
            "--path", str(tmp_path / "no_mnist")]
    jax_lines = _epoch_lines(jax_main, argv, capsys)
    port_lines = _epoch_lines(port_main, ["--device", "cpu", *argv], capsys)
    assert len(jax_lines) == len(port_lines) == 2
    for j, p in zip(jax_lines, port_lines):
        assert p[0] == j[0]
        np.testing.assert_allclose([float(v) for v in p[1:5]],
                                   [float(v) for v in j[1:5]],
                                   rtol=LOSS_RTOL)
        assert p[5] == j[5]
