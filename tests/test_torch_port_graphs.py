"""The per-step loops as compiled programs (train/graphs.py), on the CPU.

On a card the port's per-step loops capture one step as a CUDA graph and
replay it once a step, reading the step's rows and key from static device
buffers through a device cursor. On the CPU the same step body runs
eagerly on the same buffers, so these tests hold the buffer plumbing that
the card replays:

* the cached loops (`make_run_fn`, `make_dp_run_fn` on a 4-replica CPU
  mesh) in `xla`, `pallas` and `pallas_rng`, f32 and bf16, over 3 epochs,
  bitwise the host loop they replace (re-stated below: a host split a
  step, the mask entry of the host key for `xla`, word 0 of the host key
  as `pallas_rng`'s seed); the DP bf16 runs within the JAX bf16 run pins
  of the JAX package's `make_dp_run_fn` (the serial and f32 runs' JAX
  checks are in test_torch_port_scan.py, _bf16.py and _dp.py, which run
  the same code);
* the streaming `fit` (serial and on the mesh, `xla` and `pallas`) bitwise
  the host loop before capture;
* refilling the buffers with epoch 1's indices and keys gives the eager
  epoch 1 from the same state;
* a world of processes, one rank too, keeps the eager loop, whose keys
  come from the same key table for every kernel: a 1-rank gloo world
  bitwise the host loop;
* the key table's `xla` masks bitwise the host-split masks and jax's;
  `pallas_rng`'s seeds (word 0 of the table's rows) jax's key words; the
  device-seed `pallas_rng` form's CPU version bitwise the scalar-seed one;
* the fill-made constants of the captured step bitwise the host-made ones;
* the port's `build_reference_model(7)` / `params_from_torch` bitwise the
  JAX package's, and the golden's quick form (1 epoch, 4096 / 1024 rows)
  within rtol 1e-5 of the JAX `scripts/golden_accuracy.py`
  `train_framework` on the same inputs, with equal accuracy; the verdict
  formula gives the committed artifact's verdict.
"""

import importlib.util
import json

import jax
import jax.extend.backend
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu.models.mlp import init_mlp
from pytorch_ddp_mnist_tpu.ops import pallas_step as jax_ps
from pytorch_ddp_mnist_tpu.train import scan as jax_scan
from pytorch_ddp_mnist_tpu.utils import torch_ref as jax_torch_ref
from pytorch_ddp_mnist_tpu_torch.data.loader import BatchLoader, device_prefetch
from pytorch_ddp_mnist_tpu_torch.data.mnist import normalize_images, synthetic_mnist
from pytorch_ddp_mnist_tpu_torch.models import mlp
from pytorch_ddp_mnist_tpu_torch.models.mlp import MLP, from_jax_params, to_numpy_params
from pytorch_ddp_mnist_tpu_torch.ops import fused_step, philox, threefry
from pytorch_ddp_mnist_tpu_torch.ops.sgd import sgd_step
from pytorch_ddp_mnist_tpu_torch.parallel import ddp
from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler
from pytorch_ddp_mnist_tpu_torch.train import graphs, loop, scan
from pytorch_ddp_mnist_tpu_torch.utils import golden, torch_ref
from jax.sharding import Mesh

CPU = torch.device("cpu")
LR = 0.05
EPOCHS, STEPS, BATCH, REPLICAS = 3, 4, 16, 4
# the JAX package's pins for its bf16 runs (test_torch_port_bf16.py)
EPOCH_TOL = dict(rtol=1e-3, atol=1e-4)
RUN_TOL = dict(rtol=1e-2, atol=3e-3)
REPO = __import__("pathlib").Path(__file__).resolve().parent.parent


def _dt(dtype):
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


def _jax_params(seed=0):
    return jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.key(seed)))


def _assert_trees_equal(a, b):
    a, b = to_numpy_params(a), to_numpy_params(b)
    for n in a:
        for k in a[n]:
            np.testing.assert_array_equal(a[n][k], b[n][k], err_msg=f"{n}.{k}")


def _run_inputs(n_rep=1, seed=3):
    rows = STEPS * BATCH * n_rep
    split = synthetic_mnist(rows + 20, seed=seed)
    x = split.images.reshape(rows + 20, -1)
    y = split.labels.astype(np.int32)
    rng = np.random.default_rng(seed)
    idxs = np.stack([rng.permutation(rows + 20)[:rows].reshape(STEPS, -1)
                     for _ in range(EPOCHS)]).astype(np.int32)
    return x, y, idxs


# ---- the host loop the captured step replaces, re-stated ----

def _host_epoch(params, key, x_all, y_all, idx_e, kernel, dt, n=None):
    """One epoch of scan.py's per-step loop before capture: `pallas` reads
    row s of the epoch's key table; `xla` and `pallas_rng` split the host
    key a step (`fold_in(sub, r)` for replica r of a mesh of n) and draw
    the mask entry's mask of it, or hand its word 0 to the kernel."""
    nsteps = idx_e.shape[0]
    reps = 1 if n is None else n
    batch = idx_e.shape[1] // reps
    fold = None if n is None else range(n)
    if kernel == "pallas":
        key, table = threefry.step_key_table(key, nsteps, CPU, fold)
    losses = []
    for s in range(nsteps):
        if kernel == "pallas":
            subs = [table[s]] if n is None else [table[s, r] for r in fold]
        else:
            key, sub = threefry.split(key)
            subs = ([sub] if n is None else
                    [threefry.fold_in(sub, r) for r in fold])
        step_losses, grads = [], []
        for r in range(reps):
            rows = idx_e[s, r * batch:(r + 1) * batch]
            x = scan._gathered_x(x_all, rows, dt)
            y = y_all.index_select(0, rows)
            if kernel == "pallas":
                loss, g = fused_step.fused_loss_and_grads_keyed(params, x, y,
                                                                subs[r])
            elif kernel == "pallas_rng":
                loss, g = fused_step.fused_loss_and_grads_rng(params, x, y,
                                                              subs[r][0])
            else:
                mask = fused_step.dropout_mask(subs[r], batch, CPU)
                loss, g = loop.xla_loss_and_grads(params, x, y, mask > 0)
            step_losses.append(loss)
            grads.append(g)
        if n is None:
            loss, mean = step_losses[0], grads[0]
        else:
            loss, mean = ddp.replica_mean(step_losses), ddp.replica_mean(grads)
        sgd_step(params, mean, LR)
        losses.append(loss)
    return key, torch.stack(losses)


def _host_run(params, key, x, y, idxs, kernel, dtype, n=None):
    params = scan._clone(params)
    x_all, y_all = torch.from_numpy(x), torch.from_numpy(y)
    losses, snaps = [], []
    for idx_e in torch.from_numpy(idxs):
        key, ls = _host_epoch(params, key, x_all, y_all, idx_e, kernel,
                              _dt(dtype), n)
        losses.append(ls)
        snaps.append(scan._clone(params))
    return params, key, torch.stack(losses), snaps


@pytest.mark.parametrize("mesh", [None, REPLICAS], ids=["serial", "mesh4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["xla", "pallas", "pallas_rng"])
def test_cached_loop_is_the_host_loop_bitwise(kernel, dtype, mesh):
    x, y, idxs = _run_inputs(mesh or 1)
    params = from_jax_params(_jax_params()).params()
    key = threefry.key_data(9)
    before = dict(fused_step.launch_count)
    counts = dict(graphs.counts)
    if mesh is None:
        run = scan.make_run_fn(LR, kernel=kernel, dtype=dtype, snapshots=True)
    else:
        run = scan.make_dp_run_fn((CPU,) * mesh, LR, kernel=kernel,
                                  dtype=dtype, snapshots=True)
    got_p, got_key, got_l, (got_snaps, got_keys) = run(
        params, key, torch.from_numpy(x), torch.from_numpy(y), idxs)
    want_p, want_key, want_l, want_snaps = _host_run(
        params, key, x, y, idxs, kernel, dtype, mesh)
    assert got_l.shape == (EPOCHS, STEPS) and got_l.dtype == torch.float32
    assert torch.equal(got_l, want_l)
    assert got_key == want_key and got_keys[-1] == want_key
    _assert_trees_equal(got_p, want_p)
    for e, snap in enumerate(want_snaps):
        _assert_trees_equal({n: {k: v[e] for k, v in layer.items()}
                             for n, layer in got_snaps.items()}, snap)
    # no kernel launched and nothing captured on the CPU
    assert fused_step.launch_count == before and graphs.counts == counts


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_dp_bf16_loop_tracks_jax_make_dp_run_fn(kernel):
    x, y, idxs = _run_inputs(REPLICAS)
    jp, jkey, jl = jax_scan.make_dp_run_fn(
        Mesh(np.array(jax.devices()[:REPLICAS]), ("dp",)), LR,
        dtype="bfloat16", kernel=kernel, interpret=True)(
        jax.tree_util.tree_map(jnp.asarray, _jax_params()),
        jax.random.key(9), jnp.asarray(x), jnp.asarray(y), jnp.asarray(idxs))
    pp, pkey, pl = scan.make_dp_run_fn((CPU,) * REPLICAS, LR, kernel=kernel,
                                       dtype="bfloat16")(
        from_jax_params(_jax_params()).params(), threefry.key_data(9),
        torch.from_numpy(x), torch.from_numpy(y), idxs)
    assert pkey == tuple(np.asarray(jax.random.key_data(jkey)).tolist())
    tol = RUN_TOL if kernel == "xla" else EPOCH_TOL
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **tol)
    got = to_numpy_params(pp)
    for n in got:
        for k in got[n]:
            np.testing.assert_allclose(got[n][k], np.asarray(jp[n][k]),
                                       err_msg=f"{n}.{k}", **tol)


@pytest.mark.parametrize("mesh", [None, REPLICAS], ids=["serial", "mesh4"])
@pytest.mark.parametrize("kernel", ["xla", "pallas", "pallas_rng"])
def test_refilled_buffers_give_the_eager_epoch_1(kernel, mesh):
    x, y, idxs = _run_inputs(mesh or 1, seed=5)
    x_all, y_all = torch.from_numpy(x), torch.from_numpy(y)
    params = scan._clone(MLP.from_seed(0).params())
    steps = scan.CachedSteps(params, x_all, y_all, idxs.shape[1:], LR, kernel,
                             torch.float32,
                             None if mesh is None else (CPU,) * mesh)
    key, _ = steps.epoch(threefry.key_data(2), idxs[0])
    state = scan._clone(params)
    got_key, got = steps.epoch(key, idxs[1])
    want_key, want = _host_epoch(state, key, x_all, y_all,
                                 torch.from_numpy(idxs[1]), kernel,
                                 torch.float32, mesh)
    assert got_key == want_key and torch.equal(got, want)
    _assert_trees_equal(params, state)
    # the loss buffer is copied out: the next epoch does not overwrite it
    again_key, _ = steps.epoch(got_key, idxs[2])
    assert torch.equal(got, want) and again_key != got_key


# ---- the streaming loop ----

def _host_step(kind, dtype, mesh):
    """The streaming step before capture, a plain callable that `fit`
    calls a step at a time with the host key: a split a step, replica r of
    a mesh keyed by `fold_in(sub, r)`; `xla` draws the mask entry's mask
    of the host key, `pallas` reads the key's words from a one-row table."""
    dt = _dt(dtype)

    def replica(params, x, y, sub):
        if kind == "xla":
            mask = fused_step.dropout_mask(sub, x.shape[0], x.device)
            return loop.xla_loss_and_grads(params, x.to(dt), y, mask > 0)
        words = threefry.to_int32_words([sub])[0]
        return fused_step.fused_loss_and_grads_keyed(params, x.to(dt), y,
                                                     words)

    def step(model, key, x, y):
        key, sub = threefry.split(key)
        params = model.params()
        if mesh is None:
            loss, grads = replica(params, x, y, sub)
        else:
            b = x.shape[0] // mesh
            out = [replica(params, x[r * b:(r + 1) * b], y[r * b:(r + 1) * b],
                           threefry.fold_in(sub, r)) for r in range(mesh)]
            loss = ddp.replica_mean([o[0] for o in out])
            grads = ddp.replica_mean([o[1] for o in out])
        sgd_step(params, grads, LR)
        return key, loss
    return step


def _port_step(kind, dtype, mesh):
    if mesh is None:
        return (loop.make_train_step(LR) if kind == "xla" else
                fused_step.make_fused_train_step(LR, dtype=dtype))
    make = (ddp.make_dp_train_step if kind == "xla" else
            fused_step.make_pallas_dp_train_step)
    return make((CPU,) * mesh, LR, dtype=dtype)


@pytest.mark.parametrize("kind,dtype,mesh", [
    ("xla", "float32", None), ("pallas", "float32", None),
    ("pallas", "bfloat16", None), ("xla", "float32", REPLICAS),
    ("xla", "bfloat16", REPLICAS), ("pallas", "bfloat16", REPLICAS)])
def test_streaming_fit_is_the_host_loop_bitwise(kind, dtype, mesh):
    n = 5 * BATCH * (mesh or 1) - 7         # a wrap-padded last batch
    split = synthetic_mnist(n, seed=4)
    x_norm = normalize_images(split.images)
    test = synthetic_mnist(40, seed=5)
    x_test, y_test = normalize_images(test.images), test.labels.astype(np.int32)
    runs = []
    for step in (_port_step(kind, dtype, mesh), _host_step(kind, dtype, mesh)):
        counts = dict(graphs.counts)
        state, history = loop.fit(
            loop.TrainState(MLP.from_seed(1), threefry.key_data(6)),
            BatchLoader(x_norm, split.labels, ShardedSampler(n, seed=42),
                        BATCH * (mesh or 1)),
            x_test, y_test, epochs=2, batch_size=BATCH * (mesh or 1),
            train_step=step, log=lambda line: None)
        assert graphs.counts == counts
        runs.append((state.key, np.stack(history), state.model.params()))
    (key, losses, params), (want_key, want_losses, want_params) = runs
    assert key == want_key and losses.shape == (2, 5)
    np.testing.assert_array_equal(losses, want_losses)
    _assert_trees_equal(params, want_params)


def test_device_prefetch_fills_alternate_slots_on_the_cpu():
    slots = (torch.zeros(2, 3, 4), torch.zeros(2, 3, dtype=torch.int32))
    batches = [(np.full((3, 4), k, np.float32), np.full(3, 10 + k, np.int32))
               for k in range(5)]
    for k, j in enumerate(device_prefetch(iter(batches), slots)):
        assert j == k % 2
        assert torch.equal(slots[0][j], torch.full((3, 4), float(k)))
        assert torch.equal(slots[1][j], torch.full((3,), 10 + k,
                                                   dtype=torch.int32))
    assert k == 4


def test_step_loop_and_static_inputs_refuse_what_they_cannot_hold():
    with pytest.raises(ValueError, match="CUDA graph needs a CUDA device"):
        graphs.StepLoop(lambda *a: None, {}, 3, CPU, capture=True,
                        what="a test step")
    buf = graphs.StaticInput((3, 2), torch.int32, CPU)
    with pytest.raises(ValueError, match=r"\(3, 2\) cannot take \(4, 2\)"):
        buf.load(np.zeros((4, 2), np.int32))
    buf.load(np.arange(6, dtype=np.int32).reshape(3, 2))
    assert buf.buf.tolist() == [[0, 1], [2, 3], [4, 5]]
    # the loops decide by the mesh: one device, or eager
    assert graphs.on_one_device(None, CPU)
    assert graphs.on_one_device((CPU,) * 4, CPU)
    assert not graphs.on_one_device((torch.device("cuda", 0),), CPU)


@pytest.mark.parametrize("world", [1, 2])
def test_a_world_of_any_size_keeps_the_eager_loop(world):
    # a world's mean is a collective: one rank's world is a world too
    from pytorch_ddp_mnist_tpu_torch.parallel.mesh import WorldMesh
    mesh = WorldMesh([CPU], world_size=world, rank=world - 1)
    assert not graphs.on_one_device(mesh, CPU)
    assert graphs.on_one_device(tuple(mesh), CPU)


@pytest.mark.parametrize("kernel", ["xla", "pallas", "pallas_rng"])
def test_one_rank_world_reads_its_keys_from_the_table_bitwise(kernel):
    # a world's eager loop (scan.py `_dp_steps_epoch`) takes every kernel's
    # keys from the (S, 1, 2) key table: bitwise the host loop's split
    import torch.distributed as dist
    from test_torch_port_world import _free_port
    from pytorch_ddp_mnist_tpu_torch.parallel.mesh import WorldMesh
    x, y, idxs = _run_inputs(1, seed=4)
    params = from_jax_params(_jax_params()).params()
    key = threefry.key_data(9)
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        counts = dict(graphs.counts)
        got_p, got_key, got_l = scan.make_dp_run_fn(
            WorldMesh([CPU], world_size=1, rank=0), LR, kernel=kernel)(
            params, key, torch.from_numpy(x), torch.from_numpy(y), idxs)
    finally:
        dist.destroy_process_group()
    want_p, want_key, want_l, _ = _host_run(params, key, x, y, idxs, kernel,
                                            "float32", 1)
    assert torch.equal(got_l, want_l) and got_key == want_key
    _assert_trees_equal(got_p, want_p)
    assert graphs.counts == counts


def test_steps_of_a_run_are_the_key_tables_rows():
    # a step's keys come from the table, not from a host split: a run's
    # keys and losses do not depend on anything but the table's rows
    x, y, idxs = _run_inputs()
    steps = scan.CachedSteps(scan._clone(MLP.from_seed(0).params()),
                             torch.from_numpy(x), torch.from_numpy(y),
                             idxs.shape[1:], LR, "xla", torch.float32)
    key, words = threefry.step_key_words(threefry.key_data(3), STEPS)
    got_key, _ = steps.epoch(threefry.key_data(3), idxs[0])
    assert got_key == key and torch.equal(steps.keys.buf, words)
    assert torch.equal(steps.idx.buf, torch.from_numpy(idxs[0]))
    assert int(steps.loop.cursor) == STEPS


# ---- keys, seeds and constants ----

@pytest.mark.parametrize("fold", [None, range(3)])
def test_xla_key_table_masks_are_the_host_split_masks(fold):
    key = (0x80000001, 0xDEADBEEF)
    end, table = threefry.step_key_table(key, 5, CPU, fold)
    host, jkey = key, jax.random.wrap_key_data(jnp.asarray(key, jnp.uint32))
    for s in range(5):
        host, sub = threefry.split(host)
        jkey, jsub = jax.random.split(jkey)
        for r in ([None] if fold is None else fold):
            row = table[s] if fold is None else table[s, r]
            want = sub if fold is None else threefry.fold_in(sub, r)
            jwant = jsub if fold is None else jax.random.fold_in(jsub, r)
            got = fused_step.keyed_dropout_mask(row, 24, CPU)
            assert torch.equal(got, fused_step.dropout_mask(want, 24, CPU))
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jax_ps.dropout_mask(jwant, 24)))
    assert end == host


def test_pallas_rng_table_seeds_are_jax_key_words():
    _, words = threefry.step_key_words(threefry.key_data(5), 6)
    jkey = jax.random.key(5)
    for s in range(6):
        jkey, jsub = jax.random.split(jkey)
        want = jax.lax.bitcast_convert_type(
            jax.random.key_data(jsub).ravel()[0], jnp.int32)
        assert fused_step.rng_seed(words[s, 0]) == int(want) & 0xFFFFFFFF


@pytest.mark.parametrize("batch", [128, 96, 3, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_seed_rng_is_the_scalar_seed_form_on_the_cpu(batch, dtype):
    split = synthetic_mnist(batch, seed=batch)
    x = torch.from_numpy(normalize_images(split.images)).to(_dt(dtype))
    y = torch.from_numpy(split.labels.astype(np.int32))
    params = from_jax_params(_jax_params(2)).params()
    for seed in (0, 7, 0x9E3779B9, 0xFFFFFFFF):
        row = threefry.to_int32_words([(seed, 12345)])[0]
        got = fused_step.fused_loss_and_grads_rng(params, x, y, row)
        want = fused_step.fused_loss_and_grads_rng(params, x, y, seed)
        assert torch.equal(got[0], want[0])
        _assert_trees_equal(got[1], want[1])
    ref = fused_step.fused_loss_and_grads(
        params, x, y, philox.rng_mask(0x9E3779B9, batch))
    assert torch.equal(fused_step.fused_loss_and_grads_rng(
        params, x, y, threefry.to_int32_words([(0x9E3779B9, 0)])[0])[0],
        ref[0])
    with pytest.raises(ValueError, match="key_words"):
        fused_step.fused_loss_and_grads_rng(params, x, y,
                                            torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fill_made_constants_have_the_host_made_bits(dtype):
    # a captured step makes its constants by fill kernels, never by a
    # host-to-device copy; the bits stay those of torch.tensor
    for v in (1.0 / (1.0 - mlp.DROPOUT_RATE), 1.0 - mlp.DROPOUT_RATE):
        a = torch.full((), v, dtype=dtype)
        assert torch.equal(a, torch.tensor(v, dtype=dtype))
    for n in range(1, 17):
        got = ddp._inverse(n, CPU)
        want = torch.tensor(1.0 / n, dtype=torch.float32)
        assert got.view(torch.int32) == want.view(torch.int32)
    # and the forward's two dropout forms round as before
    h = torch.randn(8, 784, generator=torch.Generator().manual_seed(0)).to(dtype)
    params = MLP.from_seed(0).params()
    keep = torch.rand(8, 128, generator=torch.Generator().manual_seed(1)) < 0.8
    out = mlp.mlp_apply(params, h, train=True, keep=keep)
    z = torch.relu(h @ params["fc1"]["w"].to(dtype) + params["fc1"]["b"].to(dtype))
    z = torch.where(keep, z / torch.tensor(0.8, dtype=dtype),
                    torch.zeros((), dtype=dtype))
    z = torch.relu(z @ params["fc2"]["w"].to(dtype) + params["fc2"]["b"].to(dtype))
    assert torch.equal(out, z @ params["fc3"]["w"].to(dtype))


# ---- the golden ----

@pytest.fixture(scope="module")
def jax_golden():
    """scripts/golden_accuracy.py as a module, imported without its
    backend reset (the other tests of this process keep their arrays)."""
    spec = importlib.util.spec_from_file_location(
        "golden_accuracy_script", REPO / "scripts" / "golden_accuracy.py")
    module = importlib.util.module_from_spec(spec)
    orig = jax.extend.backend.clear_backends
    jax.extend.backend.clear_backends = lambda: None
    try:
        spec.loader.exec_module(module)
    finally:
        jax.extend.backend.clear_backends = orig
    return module


def test_reference_model_and_params_are_the_jax_packages_bitwise():
    for seed in (7, 0):
        ours = torch_ref.build_reference_model(seed).state_dict()
        theirs = jax_torch_ref.build_reference_model(seed).state_dict()
        assert list(ours) == list(theirs)
        for k in ours:
            assert torch.equal(ours[k], theirs[k]), k
        got = torch_ref.params_from_torch(torch_ref.build_reference_model(seed))
        want = jax_torch_ref.params_from_torch(
            jax_torch_ref.build_reference_model(seed))
        for n in want:
            for k in want[n]:
                assert got[n][k].is_contiguous()
                np.testing.assert_array_equal(got[n][k].numpy(),
                                              np.asarray(want[n][k]))


def test_golden_constants_and_batch_order_are_the_scripts(jax_golden):
    assert (golden.NOISE_MULT, golden.ACC_FLOOR, golden.ACC_FLOOR_SAMPLES,
            golden.LOSS_RATIO_BOUND) == (
        jax_golden.NOISE_MULT, jax_golden.ACC_FLOOR,
        jax_golden.ACC_FLOOR_SAMPLES, jax_golden.LOSS_RATIO_BOUND)
    got = golden.shared_batch_indices(1000, 3, 128)
    assert got.dtype == np.int32 and got.shape == (3, 8, 128)
    np.testing.assert_array_equal(got,
                                  jax_golden.shared_batch_indices(1000, 3, 128))


def test_golden_verdict_gives_the_artifacts_verdict():
    art = json.loads((REPO / "docs" / "golden_accuracy.json").read_text())
    v = golden.verdict(art["framework_run"], art["torch_runs"],
                       art["config"]["test_n"])
    want = art["verdict"]
    assert v["pass"] is want["pass"] is True
    for k in ("accuracy_gap", "torch_run_to_run_spread", "accuracy_bound",
              "val_loss_ratio_gap"):
        assert round(v[k], 6) == want[k], k
    assert v["val_loss_ratio_bound"] == want["val_loss_ratio_bound"]
    # a run off by more than the loss bound fails
    worse = dict(art["framework_run"],
                 final_mean_val_loss=art["framework_run"]
                 ["final_mean_val_loss"] * 1.2)
    assert golden.verdict(worse, art["torch_runs"], 10000)["pass"] is False


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_golden_quick_form_matches_the_jax_framework_run(jax_golden, kernel):
    train = synthetic_mnist(4096, seed=0)
    test = synthetic_mnist(1024, seed=1)
    x_test = normalize_images(test.images)
    idxs = golden.shared_batch_indices(4096, 1, 128)
    want = jax_golden.train_framework(
        jax_golden.params_from_torch(jax_golden.build_reference_model(7)),
        train.images, train.labels, idxs, x_test, test.labels, 0.01)
    got = golden.train_port(
        torch_ref.params_from_torch(torch_ref.build_reference_model(7)),
        train.images, train.labels, idxs, x_test, test.labels, 0.01, CPU,
        kernel=kernel)
    assert len(got["curve"]) == 1 and got["kernel"] == kernel
    np.testing.assert_allclose(got["final_mean_val_loss"],
                               want["final_mean_val_loss"], rtol=1e-5)
    assert got["final_accuracy"] == want["final_accuracy"]
