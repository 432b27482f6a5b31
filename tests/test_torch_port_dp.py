"""The port's data-parallel paths (parallel/mesh.py, parallel/ddp.py, the
DP form of ops/epoch_step.py, the DP scan of train/scan.py, `--parallel`)
against the JAX package on the CPU.

The JAX side runs on the conftest's mesh of fake CPU devices; its DP epoch
kernel's REAL ring (remote DMAs, semaphores, the fixed-order sum) runs
under the TPU-semantics simulator (`pltpu.InterpretParams()`), at n <= 4
replicas of the 8-device pool (a ring over the whole pool starves the
simulator; see the guard note in its `epoch_fused_sgd`). The port's side
is a mesh of CPU replicas, where every kernel is its plain version, so
its ring is `ring_mean`'s summation tree.

Tolerances: key words, masks, index rows and the ring's summation tree
(against the TPU layout) bitwise; the port's replicas bitwise in
lockstep; losses against JAX at rtol 1e-5 (atol 1e-6), the JAX package's
pin for its epoch kernel; params against JAX at rtol 2e-5 / atol 2e-6
(its pin for the DP ring against the serial oracle: f32 rounding, as
XLA's CPU matmuls and the port's sum in other orders). The streaming DP
steps against JAX's: the JAX pmean is an all-reduce in XLA's order divided
by n, the port's a fixed-order sum times f32(1/n), so losses rtol 1e-5
and params rtol 2e-5 / atol 2e-6 again.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh

from pytorch_ddp_mnist_tpu.models.mlp import init_mlp
from pytorch_ddp_mnist_tpu.ops import pallas_step as jax_ops
from pytorch_ddp_mnist_tpu.parallel import ddp as jax_ddp
from pytorch_ddp_mnist_tpu.train import scan as jax_scan
from pytorch_ddp_mnist_tpu_torch.cli import train as port_cli
from pytorch_ddp_mnist_tpu_torch.data.mnist import normalize_images, synthetic_mnist
from pytorch_ddp_mnist_tpu_torch.models.mlp import from_jax_params, to_numpy_params
from pytorch_ddp_mnist_tpu_torch.ops import epoch_step, fused_step, philox, threefry
from pytorch_ddp_mnist_tpu_torch.parallel import ddp
from pytorch_ddp_mnist_tpu_torch.parallel.mesh import DATA_AXIS, data_parallel_mesh
from pytorch_ddp_mnist_tpu_torch.train import scan
from pytorch_ddp_mnist_tpu_torch.train.config import configure

CPU = torch.device("cpu")
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
PARAM_RTOL, PARAM_ATOL = 2e-5, 2e-6


def _jax_params(seed=0):
    return jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.key(seed)))


def _port_params(seed=0):
    return from_jax_params(_jax_params(seed)).params()


def _assert_tree_close(got, ref, **tol):
    got = to_numpy_params(got)
    for n in got:
        for k in got[n]:
            np.testing.assert_allclose(got[n][k], np.asarray(ref[n][k]),
                                       err_msg=f"{n}.{k}", **tol)


def _assert_trees_equal(a, b):
    a, b = to_numpy_params(a), to_numpy_params(b)
    for n in a:
        for k in a[n]:
            np.testing.assert_array_equal(a[n][k], b[n][k], err_msg=f"{n}.{k}")


def _jax_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("dp",))


def _data(rows, seed):
    split = synthetic_mnist(rows, seed=seed)
    return split.images.reshape(rows, -1), split.labels.astype(np.int32)


# ---- keys and the mesh ----

@pytest.mark.parametrize("seed", [0, 7, (1 << 31) + 3, (1 << 32) - 1])
def test_fold_in_is_jax_fold_in_bitwise(seed):
    key = jax.random.key(seed)
    for data in (0, 1, 2, 3, 7, 1 << 31, (1 << 32) - 1):
        want = tuple(np.asarray(jax.random.key_data(
            jax.random.fold_in(key, data)), np.uint32).tolist())
        assert threefry.fold_in(threefry.key_data(seed), data) == want


def test_replica_key_tables_and_masks_are_jax_bitwise():
    # the DP epoch's threefry chain: split(fold_in(sub, r), S), and each
    # step key's mask is jax's dropout_mask
    sub = jax.random.split(jax.random.key(9))[1]
    port_sub = tuple(np.asarray(jax.random.key_data(sub), np.uint32).tolist())
    for r in range(3):
        want = np.asarray(jax.random.key_data(jax.random.split(
            jax.random.fold_in(sub, r), 4))).astype(np.int32)
        got = threefry.to_int32_words(
            threefry.split(threefry.fold_in(port_sub, r), 4)).numpy()
        np.testing.assert_array_equal(got, want)
        mask = np.asarray(jax_ops.dropout_mask(
            jax.random.fold_in(sub, r), 16))
        np.testing.assert_array_equal(
            threefry.dropout_mask(threefry.fold_in(port_sub, r), 16).numpy(),
            mask)


def test_philox_replica_word_keeps_the_single_replica_stream():
    base = philox.mask_block(5, 3, 16)
    assert torch.equal(philox.mask_block(5, 3, 16, replica=0), base)
    other = philox.mask_block(5, 3, 16, replica=1)
    assert not torch.equal(other, base)
    keep = float((philox.mask_block(5, 3, 512, replica=2) > 0).float().mean())
    assert abs(keep - 0.8) < 0.01


def test_data_parallel_mesh_is_an_ordered_tuple_of_replica_slots():
    assert DATA_AXIS == "dp"
    mesh = data_parallel_mesh(["cpu", CPU, "cpu"])
    assert mesh == (CPU, CPU, CPU)
    assert ddp.dp_mesh([CPU]) == (CPU,)
    with pytest.raises(ValueError, match="at least one"):
        data_parallel_mesh([])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        data_parallel_mesh()


def test_shard_batch_replicate_state_and_replica_mean():
    mesh = (CPU,) * 4
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    shards = ddp.shard_batch(mesh, (x, x[:, 0]))
    assert len(shards) == 4
    for r, (xs, ys) in enumerate(shards):
        assert torch.equal(xs, x[2 * r:2 * r + 2])
        assert torch.equal(ys, x[2 * r:2 * r + 2, 0])
    assert torch.equal(ddp.global_batch_from_local(mesh, x)[3], x[6:])
    with pytest.raises(ValueError, match="does not divide over 4"):
        ddp.shard_batch(mesh, x[:6])
    params = _port_params()
    reps = ddp.replicate_state(mesh, params)
    reps[1]["fc1"]["w"].add_(1.0)
    _assert_trees_equal(reps[0], params)
    vals = [torch.full((3,), v) for v in (0.1, 0.2, 0.7)]
    want = ((vals[0] + vals[1]) + vals[2]) * torch.tensor(
        1.0 / 3, dtype=torch.float32)
    assert torch.equal(ddp.replica_mean(vals), want)


# ---- the ring's index algebra (csrc/dp_ring.cuh ring_step) ----

@pytest.mark.parametrize("n", range(2, 10))
def test_allgather_ring_slot_schedule_algebra(n):
    """Hop h: replica me forwards origin slot (me - h) mod n into the same
    slot of its right neighbour. Every replica ends holding all n slots,
    each slot of each replica is written once per step, and every hop
    forwards what arrived the hop before."""
    held = {d: {d} for d in range(n)}
    writes = {d: [] for d in range(n)}
    for h in range(n - 1):
        sends = {}
        for me in range(n):
            slot = (me - h) % n
            assert slot in held[me]
            if h > 0:
                assert slot == (me - (h - 1) - 1) % n   # last hop's arrival
            sends[(me + 1) % n] = slot
        for dst, slot in sends.items():
            assert slot not in held[dst]
            writes[dst].append(slot)
            held[dst].add(slot)
    for d in range(n):
        assert held[d] == set(range(n))
        assert len(writes[d]) == len(set(writes[d])) == n - 1
        assert d not in writes[d]        # a replica's own slot is local


@pytest.mark.parametrize("n", range(2, 10))
def test_reduce_scatter_ring_schedule_algebra(n):
    """Reduce-scatter hop h: send partial chunk (me - h) into recv slot h of
    the right neighbour, fold the arriving chunk (me - h - 1). All-gather
    hop k: forward chunk (me + 1 - k) into the same place on the right.
    Each chunk's chain visits every replica once and ends at (c - 1) mod
    n; each recv slot and each chunk position takes one write per step;
    the final buffers are bitwise equal and equal ring_mean's tree."""
    bounds = epoch_step.rs_chunk_bounds(n)
    assert bounds[0] == 0 and bounds[-1] == epoch_step.N_PARAMS
    assert all(b % 4 == 0 for b in bounds)
    rng = np.random.default_rng(n)
    grads = [torch.from_numpy(rng.normal(size=epoch_step.N_PARAMS).astype(
        np.float32)) for _ in range(n)]
    buf = [g.clone() for g in grads]
    chains = {c: [c] for c in range(n)}
    recv_writes = {d: [] for d in range(n)}
    for h in range(n - 1):
        sent = {}
        for me in range(n):
            c = (me - h) % n
            if h > 0:
                assert c == (me - (h - 1) - 1) % n   # folded the hop before
            sent[(me + 1) % n] = (c, buf[me][bounds[c]:bounds[c + 1]].clone())
        for dst, (c, part) in sent.items():
            assert c == (dst - h - 1) % n
            recv_writes[dst].append(h)
            chains[c].append(dst)
            lo, hi = bounds[c], bounds[c + 1]
            buf[dst][lo:hi] = buf[dst][lo:hi] + part
    for c in range(n):
        assert sorted(chains[c]) == list(range(n))
        assert chains[c][-1] == (c - 1) % n
    owned = {me: (me + 1) % n for me in range(n)}
    pos_writes = {d: [] for d in range(n)}
    for k in range(n - 1):
        sent = {}
        for me in range(n):
            c = (me + 1 - k) % n
            assert k == 0 and c == owned[me] or c in pos_writes[me]
            sent[(me + 1) % n] = (c, buf[me][bounds[c]:bounds[c + 1]].clone())
        for dst, (c, part) in sent.items():
            assert c not in pos_writes[dst] and c != owned[dst]
            pos_writes[dst].append(c)
            buf[dst][bounds[c]:bounds[c + 1]] = part
    for d in range(n):
        assert recv_writes[d] == list(range(n - 1))
        assert sorted(pos_writes[d] + [owned[d]]) == list(range(n))
        assert torch.equal(buf[d], buf[0])
    inv = torch.tensor(1.0 / n, dtype=torch.float32)
    assert torch.equal(buf[0] * inv, epoch_step.ring_mean(grads,
                                                          "reduce_scatter"))


def _jax_ring_tree(packs, ring):
    """The TPU ring's summation tree on the TPU's padded (1042, 128) packed
    layout (tests/test_pallas_step.py `_ring_mean_grads`)."""
    n = len(packs)
    if ring == "allgather":
        tot = packs[0]
        for d in range(1, n):
            tot = tot + packs[d]
        return tot * np.float32(1.0 / n)
    C = jax_ops._rs_chunk_rows(n)
    padded = np.zeros((n, n * C, 128), np.float32)
    for d in range(n):
        padded[d, :jax_ops.EPOCH_COMM_ROWS] = packs[d]
    out = np.zeros((n * C, 128), np.float32)
    for c in range(n):
        s = padded[c, c * C:(c + 1) * C]
        for k in range(1, n):
            s = padded[(c + k) % n, c * C:(c + 1) * C] + s
        out[c * C:(c + 1) * C] = s * np.float32(1.0 / n)
    return out[:jax_ops.EPOCH_COMM_ROWS]


def _tpu_pack(tree):
    buf = np.zeros((jax_ops.EPOCH_COMM_ROWS, 128), np.float32)
    leaves = (tree["fc1"]["w"], tree["fc1"]["b"][None], tree["fc2"]["w"],
              tree["fc2"]["b"][None], tree["fc3"]["w"])
    for (off, rows), a in zip(jax_ops._COMM_LAYOUT, leaves):
        buf[off:off + rows, :a.shape[1]] = a
    return buf


@pytest.mark.parametrize("ring,n", [("allgather", 2), ("allgather", 5),
                                    ("reduce_scatter", 3),
                                    ("reduce_scatter", 4),
                                    ("reduce_scatter", 9),
                                    ("reduce_scatter", 16)])
def test_ring_mean_is_the_tpu_ring_tree_bitwise(ring, n):
    """The port packs gw3 unpadded; its chunks keep the TPU's rows, so every
    element is summed along the TPU's chain: bitwise the same mean."""
    assert epoch_step._rs_chunk_rows(n) == jax_ops._rs_chunk_rows(n)
    assert epoch_step.EPOCH_COMM_ROWS == jax_ops.EPOCH_COMM_ROWS
    rng = np.random.default_rng(n)
    trees = [{k: {kk: (rng.normal(size=v.shape) * 10.0 ** rng.integers(
        -3, 3, size=v.shape)).astype(np.float32) for kk, v in layer.items()}
        for k, layer in _jax_params().items()} for _ in range(n)]
    want = _jax_ring_tree([_tpu_pack(t) for t in trees], ring)
    got = epoch_step.ring_mean(
        [epoch_step.pack({k: {kk: torch.from_numpy(v) for kk, v in l.items()}
                          for k, l in t.items()}) for t in trees], ring)
    np.testing.assert_array_equal(_tpu_pack(to_numpy_params(
        epoch_step.unpack(got))), want)


# ---- K6's plain version against the JAX ring kernel under the simulator ----

@pytest.mark.parametrize("ring,n", [("allgather", 2), ("allgather", 3),
                                    ("reduce_scatter", 3)])
def test_dp_epoch_matches_the_jax_ring_kernel_under_the_simulator(ring, n):
    E, S, B = 1, 3, 8
    rows = S * B * n
    x_all, y_all = _data(rows, seed=n)
    idxs = np.random.default_rng(n).permutation(rows).astype(
        np.int32).reshape(E, S, B * n)
    run = jax_scan.make_dp_run_fn(_jax_mesh(n), lr=0.05, kernel="pallas_epoch",
                                  interpret=pltpu.InterpretParams(), ring=ring)
    jp, jkey, jlosses = run(init_mlp(jax.random.key(0)), jax.random.key(9),
                            jnp.asarray(x_all), jnp.asarray(y_all),
                            jnp.asarray(idxs))
    mesh = (CPU,) * n
    before = dict(epoch_step.launch_count)
    port_run = scan.make_dp_run_fn(mesh, 0.05, kernel="pallas_epoch",
                                   ring=ring)
    pp, pkey, plosses = port_run(_port_params(), threefry.key_data(9),
                                 torch.from_numpy(x_all),
                                 torch.from_numpy(y_all), idxs)
    assert epoch_step.launch_count == before     # the CPU runs the plain version
    assert pkey == tuple(np.asarray(jax.random.key_data(jkey)).tolist())
    np.testing.assert_allclose(plosses.numpy(), np.asarray(jlosses),
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    _assert_tree_close(pp, jax.tree_util.tree_map(np.asarray, jp),
                       rtol=PARAM_RTOL, atol=PARAM_ATOL)

    # the replicas themselves: bitwise in lockstep, each with its own masks
    sub = threefry.split(threefry.key_data(9))[1]
    xs = [torch.from_numpy(x_all[idxs[0][:, r * B:(r + 1) * B].reshape(-1)])
          for r in range(n)]
    ys = [torch.from_numpy(y_all[idxs[0][:, r * B:(r + 1) * B].reshape(-1)])
          for r in range(n)]
    keys = [threefry.to_int32_words(threefry.split(threefry.fold_in(sub, r),
                                                   S)) for r in range(n)]
    reps, losses = epoch_step.epoch_fused_sgd(
        [_port_params() for _ in range(n)], xs, ys, keys, 0.05, B,
        rng_impl="threefry", axis_size=n, ring=ring)
    for r in range(1, n):
        _assert_trees_equal(reps[r], reps[0])
        assert not torch.equal(losses[r], losses[0])
    _assert_trees_equal(reps[0], pp)


@pytest.mark.parametrize("ring,n", [("allgather", 2), ("reduce_scatter", 3)])
def test_dp_bf16_epoch_matches_the_jax_ring_kernel_under_the_simulator(ring,
                                                                       n):
    """The bf16 mode on both sides: the JAX DP ring kernel with bf16
    operands under the simulator, and the port's CPU mesh (K6's plain
    version, step_reference_bf16 per replica + the ring tree + SGD). Both
    round the same operands to bf16 at the same points and sum in f32, so
    the f32-rounding pins above hold."""
    E, S, B = 1, 3, 8
    rows = S * B * n
    x_all, y_all = _data(rows, seed=20 + n)
    idxs = np.random.default_rng(20 + n).permutation(rows).astype(
        np.int32).reshape(E, S, B * n)
    run = jax_scan.make_dp_run_fn(_jax_mesh(n), lr=0.05, dtype="bfloat16",
                                  kernel="pallas_epoch",
                                  interpret=pltpu.InterpretParams(), ring=ring)
    jp, jkey, jlosses = run(init_mlp(jax.random.key(0)), jax.random.key(9),
                            jnp.asarray(x_all), jnp.asarray(y_all),
                            jnp.asarray(idxs))
    before = dict(epoch_step.launch_count)
    port_run = scan.make_dp_run_fn((CPU,) * n, 0.05, dtype="bfloat16",
                                   kernel="pallas_epoch", ring=ring)
    pp, pkey, plosses = port_run(_port_params(), threefry.key_data(9),
                                 torch.from_numpy(x_all),
                                 torch.from_numpy(y_all), idxs)
    assert epoch_step.launch_count == before     # the CPU runs the plain version
    assert pkey == tuple(np.asarray(jax.random.key_data(jkey)).tolist())
    np.testing.assert_allclose(plosses.numpy(), np.asarray(jlosses),
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    _assert_tree_close(pp, jax.tree_util.tree_map(np.asarray, jp),
                       rtol=PARAM_RTOL, atol=PARAM_ATOL)


@pytest.mark.parametrize("ring,n", [("allgather", 4), ("reduce_scatter", 4),
                                    ("reduce_scatter", 9)])
def test_dp_epoch_equals_serial_on_the_global_batch(ring, n):
    """(1/n) sum_r (1/B) sum_rows == (1/(nB)) sum_rows: with each replica's
    masks, the DP epoch lands on the serial epoch over the global batch to
    f32 rounding (test_dp_epoch_kernel_math_numeric_oracle's identity)."""
    S, B, lr = 4, 8, 0.05
    rng = np.random.default_rng(7)
    x = rng.normal(size=(S, n * B, 784)).astype(np.float32)
    y = rng.integers(0, 10, size=(S, n * B)).astype(np.int32)
    m = ((rng.random(size=(S, n * B, 128)) > 0.2) / np.float32(0.8)).astype(
        np.float32)
    per = lambda a, r: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        a[:, r * B:(r + 1) * B].reshape((S * B,) + a.shape[2:])))
    reps, losses = epoch_step.epoch_dp_sgd_reference(
        [_port_params() for _ in range(n)], [per(x, r) for r in range(n)],
        [per(y, r) for r in range(n)], None, lr, B,
        masks=[per(m, r) for r in range(n)], axis_size=n, ring=ring)
    serial, serial_losses = epoch_step.epoch_fused_sgd_reference(
        _port_params(), torch.from_numpy(x.reshape(-1, 784)),
        torch.from_numpy(y.reshape(-1)), None, lr, n * B,
        masks=torch.from_numpy(m.reshape(-1, 128)))
    for r in range(n):
        _assert_trees_equal(reps[r], reps[0])
    _assert_tree_close(reps[0], to_numpy_params(serial), rtol=PARAM_RTOL,
                       atol=PARAM_ATOL)
    np.testing.assert_allclose(ddp.replica_mean(losses).numpy(),
                               serial_losses.numpy(), rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)


# ---- the per-step DP paths against JAX ----

@pytest.mark.parametrize("kernel", ["xla", "pallas"])
@pytest.mark.parametrize("n", [2, 4])
def test_dp_run_fn_step_kernels_match_jax(kernel, n):
    E, S, B = 2, 3, 8
    rows = S * B * n
    x_all, y_all = _data(rows, seed=11 + n)
    idxs = np.stack([np.random.default_rng(e).permutation(rows)
                     for e in range(E)]).astype(np.int32).reshape(E, S, B * n)
    run = jax_scan.make_dp_run_fn(_jax_mesh(n), 0.05, kernel=kernel,
                                  interpret=True)
    jp, jkey, jlosses = run(init_mlp(jax.random.key(0)), jax.random.key(4),
                            jnp.asarray(x_all), jnp.asarray(y_all),
                            jnp.asarray(idxs))
    before = dict(fused_step.launch_count)
    pp, pkey, plosses = scan.make_dp_run_fn((CPU,) * n, 0.05, kernel=kernel)(
        _port_params(), threefry.key_data(4), torch.from_numpy(x_all),
        torch.from_numpy(y_all), idxs)
    assert fused_step.launch_count == before
    assert pkey == tuple(np.asarray(jax.random.key_data(jkey)).tolist())
    np.testing.assert_allclose(plosses.numpy(), np.asarray(jlosses),
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    _assert_tree_close(pp, jax.tree_util.tree_map(np.asarray, jp),
                       rtol=PARAM_RTOL, atol=PARAM_ATOL)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("which", ["xla", "pallas"])
def test_dp_train_step_matches_jax(which, n):
    from pytorch_ddp_mnist_tpu_torch.models.mlp import from_jax_params as load
    split = synthetic_mnist(n * 16 * 2, seed=5)
    x = normalize_images(split.images)
    y = split.labels.astype(np.int32)
    mesh = _jax_mesh(n)
    if which == "xla":
        jstep = jax_ddp.make_dp_train_step(mesh, 0.05)
        pstep = ddp.make_dp_train_step((CPU,) * n, 0.05)
    else:
        jstep = jax_ops.make_pallas_dp_train_step(mesh, 0.05, interpret=True)
        pstep = fused_step.make_pallas_dp_train_step((CPU,) * n, 0.05)
    jp = jax.device_put(init_mlp(jax.random.key(0)), jax_ddp.replicated(mesh))
    jkey = jax.random.key(3)
    model = load(_jax_params())
    pkey = threefry.key_data(3)
    for i in range(0, x.shape[0], n * 16):
        xb, yb = x[i:i + n * 16], y[i:i + n * 16]
        jp, jkey, jloss = jstep(jp, jkey, *jax_ddp.shard_batch(mesh, (xb, yb)))
        pkey, ploss = pstep(model, pkey, torch.from_numpy(xb),
                            torch.from_numpy(yb))
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=LOSS_RTOL)
    assert pkey == tuple(np.asarray(jax.random.key_data(jkey)).tolist())
    _assert_tree_close(model.params(), jax.tree_util.tree_map(np.asarray, jp),
                       rtol=PARAM_RTOL, atol=PARAM_ATOL)


def test_fit_cached_dp_matches_jax_fit_cached(capsys):
    from pytorch_ddp_mnist_tpu.parallel.sampler import ShardedSampler as JS
    from pytorch_ddp_mnist_tpu.train.loop import TrainState as JState
    from pytorch_ddp_mnist_tpu_torch.models.mlp import from_jax_params as load
    from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler
    n = 2
    tr, te = synthetic_mnist(256, seed=0), synthetic_mnist(64, seed=1)
    x_test = normalize_images(te.images)
    jlines, plines = [], []
    jax_scan.fit_cached(
        JState(init_mlp(jax.random.key(0)), jax.random.key(1)), tr.images,
        tr.labels.astype(np.int32), JS(256, seed=42), x_test,
        te.labels.astype(np.int32), epochs=2, batch_size=16 * n, lr=0.05,
        mesh=_jax_mesh(n), kernel="pallas", interpret=True,
        log=jlines.append)
    model = load(_jax_params())
    scan.fit_cached(model, threefry.key_data(1), tr.images,
                    tr.labels.astype(np.int32), ShardedSampler(256, seed=42),
                    x_test, te.labels.astype(np.int32), epochs=2,
                    batch_size=16 * n, lr=0.05, kernel="pallas",
                    mesh=(CPU,) * n, log=plines.append)
    for jl, pl in zip(jlines, plines):
        jv = [float(v) for v in re.findall(r"loss=([-0-9.e]+)", jl)]
        pv = [float(v) for v in re.findall(r"loss=([-0-9.e]+)", pl)]
        np.testing.assert_allclose(pv, jv, rtol=LOSS_RTOL)


# ---- --parallel through the CLI ----

def _cli(argv, tmp_path):
    return port_cli.train(["--device", "cpu", "--limit", "512",
                           "--batch_size", "64", "--checkpoint", "",
                           "--path", str(tmp_path / "no_mnist"), *argv])


def test_parallel_cached_epoch_kernel_on_a_one_replica_mesh_is_serial(
        tmp_path, capsys):
    """A 1-replica mesh runs the serial epoch kernel with the serial key
    chain (no ring, as in JAX): bitwise the serial run."""
    argv = ["--cached", "--kernel", "pallas_epoch"]
    state, serial = _cli(argv, tmp_path)
    dp_state, dp = _cli(argv + ["--parallel"], tmp_path)
    captured = capsys.readouterr()
    assert "parallel=1x64" in captured.out
    assert "in-kernel ring (K6)" in captured.err
    for a, b in zip(serial, dp):
        np.testing.assert_array_equal(a, b)
    assert dp_state.key == state.key
    _assert_trees_equal(dp_state.model.params(), state.model.params())


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_parallel_streaming_cli_runs_the_dp_step(kernel, tmp_path, capsys):
    from pytorch_ddp_mnist_tpu_torch.data.loader import BatchLoader
    from pytorch_ddp_mnist_tpu_torch.data.mnist import get_mnist
    from pytorch_ddp_mnist_tpu_torch.models.mlp import MLP
    from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler
    from pytorch_ddp_mnist_tpu_torch.train.loop import TrainState, fit
    state, hist = _cli(["--parallel", "--kernel", kernel], tmp_path)
    assert f"kernel={kernel} parallel=1x64" in capsys.readouterr().out
    train = get_mnist(str(tmp_path / "no_mnist"), train=True)
    test = get_mnist(str(tmp_path / "no_mnist"), train=False)
    loader = BatchLoader(normalize_images(train.images[:512]),
                         train.labels[:512], ShardedSampler(512, seed=42),
                         batch_size=64)
    make = (ddp.make_dp_train_step if kernel == "xla"
            else fused_step.make_pallas_dp_train_step)
    _, want = fit(TrainState(MLP.from_seed(0),
                             threefry.key_data(1)), loader,
                  normalize_images(test.images), test.labels.astype(np.int32),
                  epochs=1, batch_size=64, train_step=make((CPU,), 0.01),
                  log=lambda s: None)
    np.testing.assert_array_equal(hist[0], want[0])


# ---- the named refusals ----

def test_ring_without_dp_is_refused_by_name():
    p = _port_params()
    x = torch.zeros((8, 784), dtype=torch.uint8)
    y = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="axis_size=1 runs the serial"):
        epoch_step.epoch_fused_sgd(p, x, y, 0, 0.01, 8, ring="allgather")
    with pytest.raises(ValueError, match="multi-device mesh"):
        scan.make_dp_run_fn((CPU,), 0.01, kernel="pallas_epoch",
                            ring="reduce_scatter")
    with pytest.raises(ValueError, match="needs kernel='pallas_epoch'"):
        scan.make_dp_run_fn((CPU,) * 2, 0.01, kernel="xla", ring="allgather")
    with pytest.raises(ValueError, match="ring must be"):
        scan.check_ring("tree", "pallas_epoch", 2)
    with pytest.raises(ValueError, match="reduce_scatter"):
        epoch_step.epoch_fused_sgd([p] * 9, [x] * 9, [y] * 9, 0, 0.01, 8,
                                   axis_size=9, ring="allgather")


def test_superstep_on_a_multi_replica_mesh_is_refused_by_name():
    with pytest.raises(ValueError, match="single-replica only"):
        scan.make_dp_run_fn((CPU,) * 2, 0.01, kernel="pallas_epoch",
                            superstep=2)
    p = _port_params()
    x = torch.zeros((16, 784), dtype=torch.uint8)
    y = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="single-replica only"):
        epoch_step.epoch_fused_sgd([p] * 2, [x] * 2, [y] * 2, 0, 0.01, 8,
                                   axis_size=2, steps_per_iter=2)
    # one replica keeps the superstep: the serial kernel, bitwise
    x_all, y_all = _data(40, seed=2)
    idxs = np.arange(40, dtype=np.int32).reshape(1, 5, 8)
    args = (_port_params(), threefry.key_data(3), torch.from_numpy(x_all),
            torch.from_numpy(y_all), idxs)
    dp = scan.make_dp_run_fn((CPU,), 0.01, kernel="pallas_epoch",
                             superstep=2)(*args)
    serial = scan.make_run_fn(0.01, kernel="pallas_epoch", superstep=2)(*args)
    _assert_trees_equal(dp[0], serial[0])
    assert dp[1] == serial[1] and torch.equal(dp[2], serial[2])


@pytest.mark.parametrize("comm", ["sharded", "bf16", "int8"])
def test_comm_other_than_pmean_is_refused_by_name(comm):
    """The strategies run (tests/test_torch_collectives.py); what stays
    refused by name, as in JAX: a strategy on the epoch kernel, which
    takes its mean in its ring, int8 on the fused DP step, and an unknown
    strategy."""
    ddp.make_dp_train_step((CPU,) * 2, 0.01, comm=comm)
    with pytest.raises(ValueError, match="IN-kernel"):
        scan.make_dp_run_fn((CPU,) * 2, 0.01, kernel="pallas_epoch",
                            comm=comm)
    if comm == "int8":
        with pytest.raises(ValueError, match="fused Pallas DP"):
            fused_step.make_pallas_dp_train_step((CPU,) * 2, 0.01, comm=comm)
    else:
        fused_step.make_pallas_dp_train_step((CPU,) * 2, 0.01, comm=comm)
    with pytest.raises(ValueError, match="unknown DDP comm strategy"):
        ddp.validate_comm("nccl")


def test_wireup_and_multi_process_worlds_are_refused_by_name(monkeypatch,
                                                             tmp_path):
    """What stays refused of the process-level world (the worlds themselves
    run: tests/test_torch_port_world.py): the JAX package's `tpu` method, a
    wireup without --parallel, and NCCL for ranks on the CPU."""
    with pytest.raises(SystemExit, match="--wireup_method tpu reads a Cloud "
                                         "TPU pod's metadata"):
        configure(["--parallel", "--wireup_method", "tpu"])
    with pytest.raises(SystemExit, match="forms the world of --parallel"):
        configure(["--wireup_method", "env"])
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "4")
    monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "0")
    with pytest.raises(SystemExit, match="NCCL was asked for .* on the CPU"):
        _cli(["--parallel", "--wireup_method", "nccl-openmpi"], tmp_path)
    trainer = configure(["--parallel"])["trainer"]
    assert trainer["parallel"] is True and trainer["wireup_method"] == "auto"


def test_parallel_without_a_card_names_it(tmp_path):
    with pytest.raises(SystemExit, match="no CUDA card"):
        port_cli.train(["--parallel", "--limit", "64", "--checkpoint", "",
                        "--path", str(tmp_path / "no_mnist")])


def test_dp_inputs_are_checked_by_name():
    p = _port_params()
    x = torch.zeros((16, 784), dtype=torch.uint8)
    y = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="sequence of 2 per-replica"):
        epoch_step.epoch_fused_sgd(p, [x] * 2, [y] * 2, 0, 0.01, 8,
                                   axis_size=2)
    with pytest.raises(ValueError, match="same step count"):
        epoch_step.epoch_fused_sgd([p] * 2, [x, x[:8]], [y, y[:8]], 0, 0.01,
                                   8, axis_size=2)
    with pytest.raises(ValueError, match="does not divide over the 3"):
        scan.fit_cached(from_jax_params(_jax_params()), (0, 1),
                        np.zeros((64, 784), np.uint8), np.zeros(64, np.int32),
                        None, np.zeros((8, 784), np.float32),
                        np.zeros(8, np.int32), epochs=1, batch_size=16,
                        lr=0.01, mesh=(CPU,) * 3)
