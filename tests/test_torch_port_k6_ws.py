"""K6-ws, the DP epoch kernel's rings on K2-ws's column-owner step
(csrc/ring_ws.cu), on the CPU.

The kernel runs only on a card (tests/test_torch_port_gpu.py and
chip_smoke.py hold it bitwise against the rows design's ring and K1 per
replica + the ring tree + SGD there). Here: the rule that picks K6's
design, the COLS / blocks table and the shared-memory budget against the
constants of the CUDA source, the build entries, the stamps' phase names,
and the plain version of its schedule, `ring_mean_by_owner` (one
mini-ring per column owner), bitwise `ring_mean` and the JAX ring's
summation tree. Seeded numpy inputs; every comparison is bitwise."""

import re

import jax
import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu.models.mlp import init_mlp
from pytorch_ddp_mnist_tpu.ops import pallas_step as jax_ops
from pytorch_ddp_mnist_tpu_torch.data.mnist import synthetic_mnist
from pytorch_ddp_mnist_tpu_torch.models.mlp import from_jax_params, to_numpy_params
from pytorch_ddp_mnist_tpu_torch.ops import _build, epoch_step, threefry

RINGS = ("allgather", "reduce_scatter")
SMEM_LIMIT = 232448          # the 227 KB a block may use on an H100


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the schedule's many small ops: intra-op threads only contend with the
    # other test workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _src(name):
    return (_build.CSRC / name).read_text()


def _int_const(src, name):
    return int(re.search(rf"constexpr (?:int|size_t) {name} = (\d+);",
                         src).group(1))


def _smem_from_source(cols):
    """ws_step.cuh's Shape<cols>::SMEM_BYTES, evaluated from the source's
    own expression and constants."""
    src = _src("ws_step.cuh")
    consts = {"IN": 784, "H1": 128, "H2": 128, "NC": 10, "COLS": cols}
    for name in ("B_MAX", "LG", "TCOPIES"):
        consts[name] = _int_const(src, name)
    consts["LD"] = consts["H1"] + int(re.search(
        r"constexpr int LD = H1 \+ (\d+);", src).group(1))
    consts["W3C"] = 4 * consts["NC"] + int(re.search(
        r"constexpr int W3C = 4 \* NC \+ (\d+);", src).group(1))
    env = dict(consts)
    env["cmax"] = max
    for name in ("R_W2C", "R_LG"):
        expr = re.search(rf"static constexpr int {name} = (.*?);", src,
                         re.S).group(1)
        env[name] = eval(" ".join(expr.split()), {}, env)
    expr = re.search(r"static constexpr size_t SMEM_BYTES =(.*?);", src,
                     re.S).group(1)
    expr = expr.replace("(size_t)", "").replace("sizeof(float)", "4")
    return eval(" ".join(expr.split()), {}, env)


# ---- the design rule ----

@pytest.mark.parametrize("n", range(1, 10))
def test_ring_design_is_ws_for_the_main_path_forms_up_to_four(n):
    want = "ws" if n <= epoch_step.RING_WS_MAX_REPLICAS else "rows"
    for batch in (8, 96, 128):
        assert epoch_step.ring_design(torch.uint8, False, batch, n) == want


@pytest.mark.parametrize("dtype,bf16,batch", [
    (torch.float32, False, 128), (torch.float32, True, 128),
    (torch.uint8, True, 128), (torch.uint8, True, 8),
    (torch.uint8, False, 129), (torch.uint8, False, 256),
    (torch.float32, False, 8)])
def test_ring_design_is_rows_for_f32_rows_bf16_and_large_batches(dtype, bf16,
                                                                 batch):
    # never K6-ws; uint8 rows in bf16 at B <= 128 run K6-mma up to its
    # replicas (tests/test_torch_port_k6_mma.py), the rows design past them
    mma = dtype == torch.uint8 and bf16 and batch <= 128
    for n in range(1, 10):
        want = ("mma" if mma and n <= epoch_step.RING_MMA_MAX_REPLICAS
                else "rows")
        assert epoch_step.ring_design(dtype, bf16, batch, n) == want


def test_ring_design_boundaries():
    assert epoch_step.WS_MAX_BATCH == 128
    assert epoch_step.RING_WS_MAX_REPLICAS == 4
    assert epoch_step.ring_design(torch.uint8, False, 128, 4) == "ws"
    assert epoch_step.ring_design(torch.uint8, False, 129, 4) == "rows"
    assert epoch_step.ring_design(torch.uint8, False, 128, 5) == "rows"
    # the key names the launch counts: the new design's beside the old
    for ring in RINGS:
        assert f"epoch_step_dp_ws_{ring}" in epoch_step.launch_count
        assert f"epoch_step_dp_{ring}" in epoch_step.launch_count
    assert "cols" in epoch_step.last_launch


@pytest.mark.parametrize("ring,n", [("allgather", 2), ("reduce_scatter", 3)])
def test_forced_rows_design_keeps_the_cpu_path(ring, n):
    # on the CPU every design is the plain version: `_design` changes
    # nothing there, and nothing is launched
    B, S = 8, 2
    split = synthetic_mnist(n * B * S, seed=n)
    xs = torch.from_numpy(split.images.reshape(n, B * S, -1).copy())
    ys = torch.from_numpy(split.labels.astype(np.int32).reshape(n, B * S))
    params = from_jax_params(jax.tree_util.tree_map(
        np.asarray, init_mlp(jax.random.key(0)))).params()
    keys = [threefry.to_int32_words(threefry.split(threefry.key_data(r), S))
            for r in range(n)]
    before = dict(epoch_step.launch_count)
    runs = [epoch_step.epoch_fused_sgd(
        [params] * n, list(xs), list(ys), keys, 0.05, B,
        rng_impl="threefry", axis_size=n, ring=ring, _design=d)
        for d in (None, "rows", "ws")]
    ref = epoch_step.epoch_dp_sgd_reference(
        [params] * n, list(xs), list(ys), keys, 0.05, B, rng_impl="threefry",
        axis_size=n, ring=ring)
    assert epoch_step.launch_count == before
    for ps, ls in runs:
        for r in range(n):
            assert torch.equal(ls[r], ref[1][r])
            for name in ps[r]:
                for k in ps[r][name]:
                    assert torch.equal(ps[r][name][k], ref[0][r][name][k])


# ---- the table against the CUDA source ----

def test_cols_and_blocks_table_matches_the_source():
    src = _src("ring_ws.cu")
    body = re.search(r"constexpr int cols_for\(int n\) \{\s*return (.*?);",
                     src, re.S).group(1)
    pairs = [(int(a), int(b)) for a, b in
             re.findall(r"n <= (\d+) \? (\d+) :", body)]
    default = int(re.search(r": (\d+)$", body.strip()).group(1))

    def rule(n):
        return next((cols for le, cols in pairs if n <= le), default)
    assert _int_const(src, "MAX_N") == epoch_step.RING_WS_MAX_REPLICAS
    for n in range(1, 10):
        cols = epoch_step.ring_ws_cols(n)
        assert rule(n) == cols
        assert cols == (0 if n > 8 else min(c for c in (2, 4, 8) if n <= c))
        if cols:
            # one block an SM: n replicas of 128 / COLS blocks fit 128 SMs
            assert n * (128 // cols) <= 128


@pytest.mark.parametrize("cols", [2, 4, 8])
def test_shared_memory_of_the_step_is_the_sources(cols):
    src = _src("ws_step.cuh")
    assert _int_const(src, "SMEM_LIMIT") == SMEM_LIMIT
    assert _int_const(src, "TCOPIES") == epoch_step.WS_TABLE_COPIES
    assert _int_const(src, "B_MAX") == epoch_step.WS_MAX_BATCH
    assert _smem_from_source(cols) == epoch_step.ws_smem_bytes(cols)
    admitted = any(epoch_step.ring_ws_cols(n) == cols and
                   epoch_step.ring_design(torch.uint8, False, 128, n) == "ws"
                   for n in range(1, 10))
    assert admitted == (epoch_step.ws_smem_bytes(cols) <= SMEM_LIMIT)
    assert admitted == (cols in (2, 4))


def test_stamps_phases_match_the_sources_events():
    src = _src("ring_ws.cu")
    enum = re.search(r"enum K6Stamp : int \{(.*?)\};", src, re.S).group(1)
    ring0 = re.findall(r"\bKS_\w+", enum).index("KS_RING0")
    per_hop = re.search(r"int ring_events\(int n, int rs\) \{\s*return "
                        r"\(rs \? (\d) : (\d)\) \* \(n - 1\);", src).groups()
    words = _int_const(src, "K6_STAMP_WORDS")
    for ring in RINGS:
        for n in range(2 if ring == "reduce_scatter" else 1, 5):
            events = int(per_hop[0 if ring == "reduce_scatter" else 1]) * (n - 1)
            phases = epoch_step.k6_phases(ring, n)
            assert len(phases) == ring0 + events      # stamps - 1
            assert len(phases) + 1 <= words
            assert len(set(phases)) == len(phases)


def test_build_has_the_ring_source_and_its_stamps_variant():
    assert _build.SOURCES["ring_ws"] == "ring_ws.cu"
    assert _build.VARIANTS["ring_ws_stamps"] == ("ring_ws", ("-DK6_STAMPS",))
    src = _src("ring_ws.cu")
    assert "#ifdef K6_STAMPS" in src
    assert '#include "ws_step.cuh"' in src and '#include "dp_ring.cuh"' in src
    assert '#include "ws_step.cuh"' in _src("epoch_ws.cu")
    # the step's phase code lives in the header only
    assert "__global__" not in _src("ws_step.cuh")
    assert "launch_count" not in src


def test_debug_entries_refuse_the_cpu():
    n, B = 2, 8
    x = torch.zeros((B, 784), dtype=torch.uint8)
    y = torch.zeros(B, dtype=torch.int32)
    params = epoch_step.unpack(torch.zeros(epoch_step.N_PARAMS))
    with pytest.raises(ValueError, match="CUDA"):
        epoch_step.k6_phase_stamps([params] * n, [x] * n, [y] * n, 1, 0.01,
                                   B, axis_size=n, ring="allgather")


# ---- the plain version of the schedule ----

@pytest.mark.parametrize("cols", [2, 4, 8])
def test_owners_partition_the_packed_gradient_in_whole_chunk_runs(cols):
    owned = [epoch_step._owned_offsets(cols, g) for g in range(128 // cols)]
    every = torch.cat(owned)
    assert torch.equal(every.sort().values, torch.arange(epoch_step.N_PARAMS))
    for n in range(2, 10):
        bounds = torch.tensor(epoch_step.rs_chunk_bounds(n))
        for idx in owned:
            runs = idx.view(-1, cols) if cols <= 4 else idx.view(-1, 4)
            chunk = torch.bucketize(runs, bounds, right=True)
            assert bool((chunk == chunk[:, :1]).all())   # no run straddles


def _grads(n, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.normal(size=epoch_step.N_PARAMS)
                              * 10.0 ** rng.integers(-3, 3, size=epoch_step
                                                     .N_PARAMS))
                             .astype(np.float32)) for _ in range(n)]


@pytest.mark.parametrize("n", range(2, 10))
@pytest.mark.parametrize("ring", RINGS)
def test_ring_mean_by_owner_is_ring_mean_bitwise(ring, n):
    flats = _grads(n, seed=n)
    want = epoch_step.ring_mean(flats, ring)
    for cols in (2, 4, 8):
        got = epoch_step.ring_mean_by_owner(flats, ring, cols)
        assert torch.equal(got, want), (ring, n, cols)


def _tpu_pack(tree):
    buf = np.zeros((jax_ops.EPOCH_COMM_ROWS, 128), np.float32)
    leaves = (tree["fc1"]["w"], tree["fc1"]["b"][None], tree["fc2"]["w"],
              tree["fc2"]["b"][None], tree["fc3"]["w"])
    for (off, rows), a in zip(jax_ops._COMM_LAYOUT, leaves):
        buf[off:off + rows, :a.shape[1]] = a
    return buf


def _jax_ring_tree(packs, ring):
    """The TPU ring's summation tree on its padded (1042, 128) packed
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


@pytest.mark.parametrize("ring,n", [("allgather", 2), ("allgather", 4),
                                    ("reduce_scatter", 3),
                                    ("reduce_scatter", 4),
                                    ("reduce_scatter", 9)])
def test_ring_mean_by_owner_is_the_jax_ring_tree_bitwise(ring, n):
    assert epoch_step._rs_chunk_rows(n) == jax_ops._rs_chunk_rows(n)
    flats = _grads(n, seed=100 + n)
    want = _jax_ring_tree([_tpu_pack(to_numpy_params(epoch_step.unpack(f)))
                           for f in flats], ring)
    cols = epoch_step.ring_ws_cols(n) or 8
    got = epoch_step.ring_mean_by_owner(flats, ring, cols)
    np.testing.assert_array_equal(
        _tpu_pack(to_numpy_params(epoch_step.unpack(got))), want)


def test_ring_mean_by_owner_refuses_an_unknown_ring():
    with pytest.raises(ValueError, match="ring must be"):
        epoch_step.ring_mean_by_owner(_grads(2, 0), "tree", 2)
