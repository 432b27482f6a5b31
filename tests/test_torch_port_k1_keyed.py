"""The keyed step: jax's threefry mask drawn inside K1-split and K1-mma
(`fused_loss_and_grads_keyed`), the key's words read from a device key table
that the per-step loops build before an epoch's first step
(ops/threefry.py `step_key_table`), on the CPU.

The kernels run only on a card (tests/test_torch_port_gpu.py and
chip_smoke.py hold each keyed form bitwise its design's mask-input form on
the mask entry's mask there). Here:

  * the keyed entry's CPU path (the plain version on `dropout_mask(key,
    B)`, no library loaded) against JAX's `fused_loss_and_grads(params, x,
    y, dropout_mask(key, B), interpret=True)` at B = 128, 96 and 3, with
    keys whose words have the high bit set: f32 at K1's tolerances (loss
    rtol 1e-5, grads rtol 2e-4 / atol 1e-6), a bf16 x at the JAX package's
    bf16 pins (loss rtol 1e-3, grads rtol 2e-3 / atol 1e-4);
  * the key table's rows bitwise `jax.random.split` chained S times and
    `jax.random.fold_in` over n replicas;
  * `fit_cached(kernel="pallas")`, the streaming `fit`, the 4-replica mesh
    and a 2-rank gloo world (this file run as a script is a rank), each
    bitwise the path before the fold (a `key, sub = split(key)` a step,
    the mask entry, the mask-input form) over a few steps;
  * the design a keyed launch takes and its launch counts (the kernel
    wrappers replaced by recorders): K1-split and K1-mma keyed at B <= 128,
    the mask entry reading the key and the rows design past it; the
    refusals of what the entry does not take, by name;
  * the kernels' entries and the keyed functor in the sources.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from functools import partial

import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu_torch.data.loader import BatchLoader
from pytorch_ddp_mnist_tpu_torch.data.mnist import normalize_images, synthetic_mnist
from pytorch_ddp_mnist_tpu_torch.models.mlp import MLP, from_jax_params
from pytorch_ddp_mnist_tpu_torch.ops import _build, fused_step, threefry
from pytorch_ddp_mnist_tpu_torch.ops.sgd import sgd_step
from pytorch_ddp_mnist_tpu_torch.parallel import ddp
from pytorch_ddp_mnist_tpu_torch.parallel.mesh import WorldMesh
from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler
from pytorch_ddp_mnist_tpu_torch.train import loop, scan

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_RTOL, BF16_GRAD_ATOL = 2e-3, 1e-4
LR = 0.05
CPU = torch.device("cpu")
# keys whose words span the int32 bitcast: high bits set in one or both
HIGH_KEYS = [(0x80000000, 0x7FFFFFFF), (0xFFFFFFFF, 0x80000001),
             (0xDEADBEEF, 12345)]


def _jax():
    """jax on the CPU and the JAX package's fused step (imported here, not
    at the top: the ranks of this file's world import no jax)."""
    import jax
    from pytorch_ddp_mnist_tpu.models.mlp import init_mlp
    from pytorch_ddp_mnist_tpu.ops import pallas_step as jax_k1
    return jax, init_mlp, jax_k1


def _inputs(batch, seed):
    """Numpy-seeded (params tree of the JAX init, x, y)."""
    jax, init_mlp, _ = _jax()
    split = synthetic_mnist(batch, seed=seed)
    tree = jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.key(seed)))
    return tree, normalize_images(split.images), split.labels.astype(np.int32)


def _words(key) -> torch.Tensor:
    """A key as a one-row table's row (what the loops pass)."""
    return threefry.to_int32_words([key])[0]


def _assert_close(got, ref, loss_rtol, grad_rtol, grad_atol):
    loss, grads = got
    ref_loss, ref_grads = ref
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=loss_rtol)
    for n in ("fc1", "fc2", "fc3"):
        for k in ref_grads[n]:
            np.testing.assert_allclose(
                np.asarray(grads[n][k]), np.asarray(ref_grads[n][k]),
                rtol=grad_rtol, atol=grad_atol, err_msg=f"{n}.{k}")


def _assert_trees_equal(a, b):
    for n in a:
        for k in a[n]:
            assert torch.equal(a[n][k], b[n][k]), f"{n}.{k}"


@pytest.fixture
def no_kernels(monkeypatch):
    """Fail on any attempt to build or load a kernel library or reach a
    CUDA wrapper."""
    def boom(*a, **k):
        raise AssertionError("the CPU path must not touch a kernel")
    for name in ("_staged_cuda", "_fused_cuda", "_keyed_cuda", "_staged_lib",
                 "_kernel_lib"):
        monkeypatch.setattr(fused_step, name, boom)
    monkeypatch.setattr(_build, "load", boom)
    monkeypatch.setattr(_build, "build_all", boom)


# ---- the keyed entry on the CPU against JAX ----

@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [128, 96, 3])
def test_keyed_entry_matches_the_jax_step_on_dropout_mask(no_kernels, batch,
                                                          bf16):
    jax, _, jax_k1 = _jax()
    import jax.numpy as jnp
    jax_fused = jax.jit(partial(jax_k1.fused_loss_and_grads, interpret=True))
    tree, x, y = _inputs(batch, seed=batch + 11)
    params = from_jax_params(tree).params()
    xt = torch.from_numpy(x)
    xj = jnp.asarray(x)
    if bf16:
        xt, xj = xt.to(torch.bfloat16), xj.astype(jnp.bfloat16)
    tol = ((BF16_LOSS_RTOL, BF16_GRAD_RTOL, BF16_GRAD_ATOL) if bf16
           else (LOSS_RTOL, GRAD_RTOL, GRAD_ATOL))
    counts, last = dict(fused_step.launch_count), dict(fused_step.last_launch)
    for key in HIGH_KEYS + [threefry.split(threefry.key_data(batch))[1]]:
        words = _words(key)
        got = fused_step.fused_loss_and_grads_keyed(params, xt,
                                                    torch.from_numpy(y), words)
        jkey = jax.random.wrap_key_data(jnp.asarray(key, jnp.uint32))
        mask = jax_k1.dropout_mask(jkey, batch)
        _assert_close(got, jax_fused(tree, xj, jnp.asarray(y), mask), *tol)
        # bitwise the mask-input entry on the JAX mask
        want = fused_step.fused_loss_and_grads(
            params, xt, torch.from_numpy(y), torch.from_numpy(np.array(mask)))
        assert torch.equal(got[0], want[0])
        _assert_trees_equal(got[1], want[1])
    assert all((_words(k) < 0).any() for k in HIGH_KEYS)
    assert fused_step.launch_count == counts
    assert fused_step.last_launch == last


def test_keyed_mask_is_jax_dropout_mask_for_high_bit_keys(no_kernels):
    jax, _, jax_k1 = _jax()
    import jax.numpy as jnp
    for key in HIGH_KEYS:
        got = fused_step.keyed_dropout_mask(_words(key), 96, CPU)
        jkey = jax.random.wrap_key_data(jnp.asarray(key, jnp.uint32))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jax_k1.dropout_mask(jkey, 96)))


# ---- the key table against jax.random ----

@pytest.mark.parametrize("seed", [0, 7, (1 << 31) + 5])
def test_key_table_rows_are_jax_split_chain(seed):
    jax, _, _ = _jax()
    steps = 9
    key, table = threefry.step_key_table(threefry.key_data(seed), steps)
    assert table.dtype == torch.int32 and tuple(table.shape) == (steps, 2)
    jkey = jax.random.key(seed)
    for s in range(steps):
        jkey, sub = jax.random.split(jkey)
        want = np.asarray(jax.random.key_data(sub)).astype(np.int32)
        np.testing.assert_array_equal(table[s].numpy(), want)
        assert threefry.words_key(table[s]) == tuple(
            np.asarray(jax.random.key_data(sub)).tolist())
    assert key == tuple(np.asarray(jax.random.key_data(jkey)).tolist())


@pytest.mark.parametrize("first,n", [(0, 4), (2, 2), (3, 1)])
def test_key_table_folds_each_replicas_global_index(first, n):
    jax, _, _ = _jax()
    steps = 5
    key, table = threefry.step_key_table(threefry.key_data(3), steps,
                                         fold=range(first, first + n))
    assert tuple(table.shape) == (steps, n, 2)
    jkey = jax.random.key(3)
    for s in range(steps):
        jkey, sub = jax.random.split(jkey)
        for r in range(n):
            want = np.asarray(jax.random.key_data(
                jax.random.fold_in(sub, first + r))).astype(np.int32)
            np.testing.assert_array_equal(table[s, r].numpy(), want)
    assert key == tuple(np.asarray(jax.random.key_data(jkey)).tolist())


def test_key_table_of_no_steps_keeps_the_key():
    key, table = threefry.step_key_table((1, 2), 0)
    assert key == (1, 2) and tuple(table.shape) == (0, 2)


# ---- the loops: bitwise the path before the fold ----

def _data(n, seed=0):
    split = synthetic_mnist(n, seed=seed)
    return split.images, normalize_images(split.images), \
        split.labels.astype(np.int32)


def _before_steps_epoch(params, key, x_all, y_all, idx_e, lr, kernel,
                        compute_dt):
    """scan._steps_epoch's `pallas` epoch before the fold: a split a step,
    the mask entry, the mask-input form."""
    losses = []
    for rows in idx_e:
        key, sub = threefry.split(key)
        x = scan._gathered_x(x_all, rows, compute_dt)
        mask = fused_step.dropout_mask(sub, rows.shape[0], x.device)
        loss, grads = fused_step.fused_loss_and_grads(
            params, x, y_all.index_select(0, rows), mask)
        sgd_step(params, grads, lr)
        losses.append(loss)
    return key, torch.stack(losses)


def _before_dp_steps_epoch(mesh, params, key, data, idx_e, lr, kernel,
                           compute_dt):
    """scan._dp_steps_epoch's `pallas` epoch before the fold."""
    n = len(mesh)
    batch = idx_e.shape[1] // n
    losses = []
    for s in range(idx_e.shape[0]):
        key, sub = threefry.split(key)
        step_losses, grads = [], []
        for r, dev in enumerate(mesh):
            x_all, y_all, ix = data[dev]
            rows = ix[s, r * batch:(r + 1) * batch]
            x = scan._gathered_x(x_all, rows, compute_dt)
            mask = fused_step.dropout_mask(threefry.fold_in(sub, r),
                                           rows.shape[0], x.device)
            loss, g = fused_step.fused_loss_and_grads(
                ddp.on_device(params, dev), x, y_all.index_select(0, rows),
                mask)
            step_losses.append(loss)
            grads.append(g)
        loss, mean = ddp.world_mean(mesh, step_losses, grads, idx_e.device)
        sgd_step(params, mean, lr)
        losses.append(loss)
    return key, torch.stack(losses)


def _fit_cached(mesh, dtype, n_rows, batch):
    images, _, labels = _data(n_rows)
    x_test, y_test = normalize_images(images[:64]), labels[:64]
    model = MLP.from_seed(0)
    key, history = scan.fit_cached(
        model, threefry.key_data(1), images, labels,
        ShardedSampler(n_rows, seed=42), x_test, y_test, epochs=2,
        batch_size=batch, lr=LR, kernel="pallas", dtype=dtype, mesh=mesh,
        log=lambda line: None)
    return key, np.concatenate(history), model.params()


def _before_fit_cached(mesh, dtype, n_rows, batch):
    """`_fit_cached`'s two epochs on the epochs before the fold above, over
    the same sampler's rows (fit_cached's step loop is captured on a card
    and runs its step eagerly on static buffers here)."""
    images, _, labels = _data(n_rows)
    x_all = torch.from_numpy(scan.resident_images(images))
    y_all = torch.from_numpy(labels)
    params = scan._clone(MLP.from_seed(0).params())
    key, sampler, history = threefry.key_data(1), ShardedSampler(
        n_rows, seed=42), []
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    for epoch in range(2):
        sampler.set_epoch(epoch)
        idx = torch.from_numpy(scan.epoch_batch_indices(sampler, batch))
        if mesh is None:
            key, losses = _before_steps_epoch(params, key, x_all, y_all, idx,
                                              LR, "pallas", dt)
        else:
            key, losses = _before_dp_steps_epoch(
                mesh, params, key, {CPU: (x_all, y_all, idx)}, idx, LR,
                "pallas", dt)
        history.append(losses.numpy())
    return key, np.concatenate(history), params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fit_cached_pallas_is_the_path_before_the_fold_bitwise(dtype):
    counts = dict(fused_step.launch_count)
    got = _fit_cached(None, dtype, 96, 16)
    want = _before_fit_cached(None, dtype, 96, 16)
    assert got[0] == want[0] and got[1].shape == (12,)
    np.testing.assert_array_equal(got[1], want[1])
    _assert_trees_equal(got[2], want[2])
    assert fused_step.launch_count == counts


def test_fit_cached_pallas_on_a_four_replica_mesh_is_the_path_before_the_fold():
    mesh = (CPU,) * 4
    got = _fit_cached(mesh, "float32", 128, 32)
    want = _before_fit_cached(mesh, "float32", 128, 32)
    assert got[0] == want[0] and got[1].shape == (8,)
    np.testing.assert_array_equal(got[1], want[1])
    _assert_trees_equal(got[2], want[2])


def _before_step(lr, dtype):
    """make_fused_train_step before the fold: a plain step function, which
    `fit` calls a step at a time with the host key."""
    compute_dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def step(model, key, x, y):
        key, sub = threefry.split(key)
        params = model.params()
        mask = fused_step.dropout_mask(sub, x.shape[0], x.device)
        loss, grads = fused_step.fused_loss_and_grads(
            params, x.to(compute_dt), y, mask)
        sgd_step(params, grads, lr)
        return key, loss
    return step


def _fit(step, n_rows=80, batch=16, epochs=2):
    _, x, y = _data(n_rows, seed=4)
    lines = []
    state, history = loop.fit(
        loop.TrainState(MLP.from_seed(0), threefry.key_data(1)),
        BatchLoader(x, y, ShardedSampler(n_rows, seed=42), batch), x[:32],
        y[:32], epochs=epochs, batch_size=batch, train_step=step,
        log=lines.append)
    return state, np.concatenate(history), lines


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streaming_fit_keyed_step_is_the_path_before_the_fold(dtype):
    step = fused_step.make_fused_train_step(LR, dtype=dtype)
    assert isinstance(step, fused_step.KeyedStep)
    got_state, got, got_lines = _fit(step)
    want_state, want, want_lines = _fit(_before_step(LR, dtype))
    assert got_state.key == want_state.key and got.shape == (10,)
    np.testing.assert_array_equal(got, want)
    _assert_trees_equal(got_state.model.params(), want_state.model.params())
    # the epoch lines differ only in their img/s
    strip = partial(re.sub, r" [0-9]+ img/s.*", "")
    assert [strip(s) for s in got_lines] == [strip(s) for s in want_lines]


def test_keyed_step_a_step_at_a_time_is_the_epoch_table():
    # `step(model, key, x, y)` (a one-row table) and `fit`'s epoch table
    # give the same keys and bits
    _, x, y = _data(48, seed=6)
    runs = []
    for by_table in (False, True):
        step = fused_step.make_fused_train_step(LR)
        model, key = MLP.from_seed(0), threefry.key_data(1)
        if by_table:
            key, table = step.key_table(key, 3, CPU)
        losses = []
        for s in range(3):
            xb, yb = (torch.from_numpy(a[16 * s:16 * (s + 1)]) for a in (x, y))
            if by_table:
                losses.append(step.run(model, table[s], xb, yb))
            else:
                key, loss = step(model, key, xb, yb)
                losses.append(loss)
        runs.append((key, torch.stack(losses), model.params()))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])
    _assert_trees_equal(runs[0][2], runs[1][2])


def test_fit_refuses_a_loader_that_gives_other_than_its_len():
    class Short(BatchLoader):
        def __len__(self):
            return super().__len__() + 1
    _, x, y = _data(32, seed=2)
    with pytest.raises(RuntimeError, match="len"):
        loop.fit(loop.TrainState(MLP.from_seed(0), threefry.key_data(1)),
                 Short(x, y, ShardedSampler(32, seed=42), 16), x[:16], y[:16],
                 epochs=1, batch_size=16,
                 train_step=fused_step.make_fused_train_step(LR),
                 log=lambda line: None)


@pytest.mark.parametrize("n", [2, 4])
def test_dp_keyed_step_on_a_mesh_is_the_mask_input_dp_step(n):
    _, x, y = _data(n * 16 * 3, seed=8)
    mesh = (CPU,) * n
    keyed = fused_step.make_pallas_dp_train_step(mesh, LR)
    assert list(keyed.fold) == list(range(n))
    before = ddp.dp_step(mesh, LR, fused_step.fused_loss_and_grads)
    runs = []
    for step in (keyed, before):
        model, key = MLP.from_seed(0), threefry.key_data(2)
        losses = []
        for i in range(0, x.shape[0], n * 16):
            key, loss = step(model, key, torch.from_numpy(x[i:i + n * 16]),
                             torch.from_numpy(y[i:i + n * 16]))
            losses.append(loss)
        runs.append((key, torch.stack(losses), model.params()))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])
    _assert_trees_equal(runs[0][2], runs[1][2])


# ---- a 2-rank gloo world: this file run as a script is a rank ----

WORLD_STEPS, WORLD_BATCH = 4, 16


def _world_train(step, keyed, x, y, rows):
    """WORLD_STEPS steps from MLP.from_seed(0) and key 1: the keyed step
    through the steps' key table, as `fit` runs it; the step before the
    fold a step at a time."""
    model, key = MLP.from_seed(0), threefry.key_data(1)
    if keyed:
        key, table = step.key_table(key, WORLD_STEPS, CPU)
    losses = []
    for s in range(WORLD_STEPS):
        r = rows[s * WORLD_BATCH:(s + 1) * WORLD_BATCH]
        xb, yb = torch.from_numpy(x[r]), torch.from_numpy(y[r])
        if keyed:
            losses.append(step.run(model, table[s], xb, yb))
        else:
            key, loss = step(model, key, xb, yb)
            losses.append(loss)
    return key, torch.stack(losses), model.params()


def _rank_main(out: str) -> int:
    from pytorch_ddp_mnist_tpu_torch.parallel import wireup
    torch.set_num_threads(1)
    rt = wireup.initialize_runtime("env", device_type="cpu")
    mesh = WorldMesh([rt.device], world_size=rt.size, rank=rt.rank)
    _, x, y = _data(256, seed=3)
    sampler = ShardedSampler(256, num_replicas=rt.size, rank=rt.rank, seed=42)
    sampler.set_epoch(0)
    rows = sampler.indices()
    runs = {}
    for name, step, keyed in (
            ("keyed", fused_step.make_pallas_dp_train_step(mesh, LR), True),
            ("before", ddp.dp_step(mesh, LR, fused_step.fused_loss_and_grads),
             False)):
        key, losses, params = _world_train(step, keyed, x, y, rows)
        runs[name] = {"key": key, "losses": losses, "params": params,
                      "fold": list(getattr(step, "fold", []))}
    torch.save(runs, os.path.join(out, f"rank{rt.rank}.pt"))
    rt.finalize()
    return 0


def test_two_rank_gloo_world_keyed_steps_are_the_steps_before_the_fold(
        tmp_path):
    from test_torch_port_world import _run_world
    _run_world([sys.executable, os.path.abspath(__file__), "--rank", "--out",
                str(tmp_path)], world=2)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for r, run in enumerate(ranks):
        # each rank folds its own replica's global index
        assert run["keyed"]["fold"] == [r]
        assert run["keyed"]["key"] == run["before"]["key"]
        assert torch.equal(run["keyed"]["losses"], run["before"]["losses"])
        _assert_trees_equal(run["keyed"]["params"], run["before"]["params"])
        # and the ranks stay in lockstep
        assert torch.equal(run["keyed"]["losses"], ranks[0]["keyed"]["losses"])
        _assert_trees_equal(run["keyed"]["params"], ranks[0]["keyed"]["params"])
    assert ranks[0]["keyed"]["losses"].shape == (WORLD_STEPS,)


# ---- the design and the launch counts (the kernel wrappers recorded) ----

@pytest.fixture
def recorded(monkeypatch):
    """The CUDA wrappers under the keyed entry replaced by recorders, so
    `_keyed_cuda`'s routing and counts run on CPU tensors."""
    calls = []

    def staged(design, params, x, y, mask, seed=None, *, key_words=None,
               **kw):
        calls.append(("staged", design, mask, key_words))
        return fused_step.fused_loss_and_grads_reference(
            params, x.float(), y, torch.ones(x.shape[0], 128))

    def rows(params, x, y, mask, seed=None, design=None):
        calls.append(("rows", design, mask))
        fused_step.launch_count["fused_step"] += 1
        return fused_step.fused_loss_and_grads_reference(params, x.float(),
                                                         y, mask)

    def entry(words, batch, device):
        calls.append(("mask entry", words, batch))
        fused_step.launch_count["threefry_mask"] += 1
        return threefry.dropout_mask(threefry.words_key(words), batch)

    monkeypatch.setattr(fused_step, "_staged_cuda", staged)
    monkeypatch.setattr(fused_step, "_fused_cuda", rows)
    monkeypatch.setattr(fused_step, "keyed_dropout_mask", entry)
    saved = dict(fused_step.launch_count)
    for k in fused_step.launch_count:
        fused_step.launch_count[k] = 0
    yield calls
    fused_step.launch_count.update(saved)


def _keyed_call(batch, dtype, design=None):
    tree, x, y = _inputs(batch, seed=1)
    params = from_jax_params(tree).params()
    words = _words((0x80000000, 7))
    return fused_step._keyed_cuda(params, torch.from_numpy(x).to(dtype),
                                  torch.from_numpy(y), words, design=design)


@pytest.mark.parametrize("dtype,batch,design", [
    (torch.float32, 128, "split"), (torch.float32, 96, "split"),
    (torch.float32, 3, "split"), (torch.bfloat16, 128, "mma"),
    (torch.bfloat16, 96, "mma"), (torch.bfloat16, 3, "mma")])
def test_keyed_launch_at_most_128_rows_draws_in_its_design(recorded, dtype,
                                                           batch, design):
    assert fused_step.fused_design(dtype, False, batch) == design
    _keyed_call(batch, dtype)
    (kind, got, mask, words), = recorded
    assert (kind, got, mask) == ("staged", design, None)
    assert words.tolist() == _words((0x80000000, 7)).tolist()
    key = f"fused_{design}_keyed"
    assert {k: v for k, v in fused_step.launch_count.items() if v} == {key: 1}
    assert fused_step.last_launch == {"design": design, "form": key}


@pytest.mark.parametrize("dtype,batch,design", [
    (torch.float32, 129, None), (torch.bfloat16, 256, None),
    (torch.float32, 96, "rows"), (torch.bfloat16, 128, "rows")])
def test_keyed_launch_past_128_rows_keeps_the_mask_entry(recorded, dtype,
                                                         batch, design):
    _keyed_call(batch, dtype, design)
    kinds = [c[0] for c in recorded]
    assert kinds == ["mask entry", "rows"]
    assert recorded[1][1] == "rows"
    mask = recorded[1][2]
    assert torch.equal(mask, threefry.dropout_mask((0x80000000, 7), batch))
    assert {k: v for k, v in fused_step.launch_count.items() if v} == {
        "threefry_mask": 1, "fused_step": 1}


def test_keyed_entry_refuses_what_it_does_not_take(no_kernels):
    tree, x, y = _inputs(4, seed=0)
    params = from_jax_params(tree).params()
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    bad = {"a (3,) row": torch.zeros(3, dtype=torch.int32),
           "int64 words": torch.zeros(2, dtype=torch.int64),
           "a tuple": (1, 2),
           "a strided row": torch.zeros((2, 2), dtype=torch.int32)[:, 0]}
    for what, words in bad.items():
        with pytest.raises(ValueError, match="key_words"):
            fused_step.fused_loss_and_grads_keyed(params, x, y, words)
    # a row off 8 bytes: the kernels read the two words with one load
    odd = torch.zeros(5, dtype=torch.int32)[1:3]
    with pytest.raises(ValueError, match="8 bytes"):
        fused_step.fused_loss_and_grads_keyed(params, x, y, odd)
    with pytest.raises(ValueError, match="x must be"):
        fused_step.fused_loss_and_grads_keyed(params, x[:, :10], y,
                                              _words((1, 2)))


def test_keyed_stamps_refuse_the_cpu():
    tree, x, y = _inputs(4, seed=0)
    params = from_jax_params(tree).params()
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    for stamps, xin in ((fused_step.split_phase_stamps, x),
                        (fused_step.mma_phase_stamps, x.to(torch.bfloat16))):
        with pytest.raises(ValueError, match="CUDA"):
            stamps(params, xin, y, key_words=_words((1, 2)))


# ---- the sources ----

def test_sources_have_the_keyed_entries_and_functor():
    header = (_build.CSRC / "mlp_step.cuh").read_text()
    assert "struct ThreefryKeyMask" in header
    for name, entry in (("fused_split.cu", "pdmt_split_step"),
                        ("fused_mma.cu", "pdmt_mma_step")):
        src = (_build.CSRC / name).read_text()
        sig = re.search(rf'extern "C" int {entry}\((.*?)\)', src, re.S).group(1)
        # the key pointer after the mask, as the wrapper declares it
        assert re.search(r"const float\* mask,\s*const uint32_t\* key", sig)
        assert "ThreefryKeyMask{key}" in src
        assert "key == nullptr" in src
    step = (_build.CSRC / "fused_step.cu").read_text()
    assert 'extern "C" int pdmt_threefry_mask_keyed(' in step
    # the hoist is K1-mma's alone: the epoch kernels keep the default
    assert "hidden_tile<MaskAt, true>" in (_build.CSRC / "fused_mma.cu").read_text()
    for name in ("epoch_mma.cu", "ring_mma.cu"):
        assert "hidden_tile<" not in (_build.CSRC / name).read_text()
    assert {"fused_split_keyed", "fused_mma_keyed", "threefry_mask"} <= set(
        fused_step.launch_count)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--rank", action="store_true")
    p.add_argument("--out", required=True)
    sys.exit(_rank_main(p.parse_args().out))
