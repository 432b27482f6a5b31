"""K6-mma, the DP epoch kernel's bf16 rings on K2-mma's tensor-core step
(csrc/ring_mma.cu), on the CPU.

The kernel runs only on a card (tests/test_torch_port_gpu.py and
chip_smoke.py hold it bitwise against K1-mma per replica + the ring tree +
SGD there, and at the JAX bf16 pins against its plain version and the rows
design's ring). Here: the rule that picks K6's design at its boundaries,
the constants the wrapper shares with the CUDA source (blocks a replica,
shared memory, replicas, flag counters, stamps), the build entries, the
refusals made before any library loads, the gradient-tile owners' slices,
and the plain version of the schedule, `ring_mean_by_grads_owner` (one
mini-ring per gradient-tile owner), bitwise `ring_mean` and the JAX ring's
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
from pytorch_ddp_mnist_tpu_torch.ops import _build, epoch_step, fused_step, threefry

RINGS = ("allgather", "reduce_scatter")
SM_SMEM = 233472             # an H100 SM's shared memory, 228 KB
SM_REGS = 65536
RESERVED_SMEM = 1024         # the runtime's share of a block's


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


def _const(src, name):
    return int(re.search(rf"constexpr (?:int|size_t) {name} = (\d+);",
                         src).group(1))


# ---- the design rule ----

@pytest.mark.parametrize("n", range(1, 10))
def test_ring_design_is_mma_for_uint8_bf16_up_to_four_replicas(n):
    want = "mma" if n <= epoch_step.RING_MMA_MAX_REPLICAS else "rows"
    for batch in (8, 96, 128):
        assert epoch_step.ring_design(torch.uint8, True, batch, n) == want


@pytest.mark.parametrize("dtype,bf16,batch,n,design", [
    (torch.uint8, True, 128, 4, "mma"), (torch.uint8, True, 129, 4, "rows"),
    (torch.uint8, True, 128, 5, "rows"), (torch.uint8, True, 1, 2, "mma"),
    (torch.uint8, True, 256, 2, "rows"), (torch.float32, True, 128, 2, "rows"),
    (torch.float32, True, 8, 4, "rows"), (torch.uint8, False, 128, 4, "ws"),
    (torch.uint8, False, 128, 2, "ws"), (torch.float32, False, 128, 2, "rows")])
def test_ring_design_boundaries(dtype, bf16, batch, n, design):
    # dtype, bf16 mode, B and n: K6-mma only for uint8 rows in bf16 at
    # B <= MMA_MAX_BATCH and n <= RING_MMA_MAX_REPLICAS
    assert fused_step.MMA_MAX_BATCH == 128
    assert epoch_step.RING_MMA_MAX_REPLICAS == 4
    assert epoch_step.ring_design(dtype, bf16, batch, n) == design


def test_launch_keys_of_the_new_design_beside_the_old():
    for ring in RINGS:
        for key in (f"epoch_step_dp_mma_{ring}", f"epoch_step_dp_ws_{ring}",
                    f"epoch_step_dp_{ring}", f"epoch_step_dp_{ring}_bf16"):
            assert key in epoch_step.launch_count


@pytest.mark.parametrize("ring,n", [("allgather", 2), ("reduce_scatter", 3)])
def test_every_design_keeps_the_cpu_path_in_bf16(ring, n):
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
        [params] * n, list(xs), list(ys), keys, 0.05, B, compute_bf16=True,
        rng_impl="threefry", axis_size=n, ring=ring, _design=d)
        for d in (None, "rows", "mma")]
    ref = epoch_step.epoch_dp_sgd_reference(
        [params] * n, list(xs), list(ys), keys, 0.05, B, compute_bf16=True,
        rng_impl="threefry", axis_size=n, ring=ring)
    assert epoch_step.launch_count == before
    for ps, ls in runs:
        for r in range(n):
            assert torch.equal(ls[r], ref[1][r])
            for name in ps[r]:
                for k in ps[r][name]:
                    assert torch.equal(ps[r][name][k], ref[0][r][name][k])


# ---- the constants against the CUDA source ----

def test_blocks_replicas_and_threads_are_the_sources():
    src, hdr = _src("ring_mma.cu"), _src("mma_step.cuh")
    assert _const(src, "THREADS") == epoch_step.MMA_EPOCH_THREADS == 224
    assert _const(src, "BLOCKS") == epoch_step.RING_MMA_BLOCKS
    assert _const(src, "MAX_N") == epoch_step.RING_MMA_MAX_REPLICAS
    assert _const(src, "MAX_BATCH") == fused_step.MMA_MAX_BATCH
    # a replica's blocks: the gradient phase's tiles and bias quarters
    tiles = (784 // 16 + 128 // 16 + 1
             + 2 * 128 // _const(hdr, "BIAS_COLS"))
    assert epoch_step.RING_MMA_BLOCKS == tiles == \
        epoch_step.MMA_EPOCH_GRADS_BLOCKS == 66
    # the hidden phase's tiles at B = 128 run two a block
    assert -(-epoch_step.mma_epoch_blocks(128) // 66) == 2


def _eval_header(hdr, name, env):
    expr = re.search(rf"constexpr size_t {name} =(.*?);", hdr, re.S).group(1)
    expr = (expr.replace("sizeof(bf16)", "2").replace("sizeof(float)", "4")
            .replace("sizeof(uint64_t)", "8"))
    return eval(" ".join(expr.split()), {}, env)


def test_shared_memory_is_the_sources_and_fits_two_blocks_an_sm():
    hdr = _src("mma_step.cuh")
    env = {"IN": 784, "H1": 128, "H2": 128, "max3": lambda *a: max(a)}
    for name in ("B_MAX", "HR", "HU", "KC", "NKC", "XC", "RR", "NWC", "AS",
                 "NCP", "DLS", "NGC", "LS"):
        m = re.search(rf"constexpr int {name} = ([^;]+);", hdr).group(1)
        env[name] = eval(m.split("//")[0], {}, env)
    for name in ("X_CHUNK", "W_CHUNK", "HIDDEN_DATA", "W2_BYTES", "W3_BYTES",
                 "ACT_BYTES", "ROWS_DATA", "WIDE_BYTES", "NARROW_BYTES",
                 "GRADS_DATA", "EPOCH_DATA"):
        env[name] = _eval_header(hdr, name, env)
    env["EPOCH_BARS"] = env["NKC"] + env["NWC"] + env["NGC"]
    smem = _eval_header(hdr, "EPOCH_SMEM", env)
    assert smem == epoch_step.mma_epoch_smem_bytes() == 55928
    # two blocks an SM: the shared memory (with the table, the block's
    # context and the runtime's reserve) and 128 registers a thread
    static = 2 * 256 + 128
    assert 2 * (smem + static + RESERVED_SMEM) <= SM_SMEM
    assert 2 * 128 * epoch_step.MMA_EPOCH_THREADS <= SM_REGS
    assert "__launch_bounds__(THREADS, 2)" in _src("ring_mma.cu")


@pytest.mark.parametrize("rs", [0, 1])
def test_flag_counters_a_replica_are_the_sources(rs):
    src = " ".join(_src("ring_mma.cu").split())
    enum = re.search(r"enum BlockFlag : int \{(.*?)\};", src).group(1)
    flags = dict((k, int(v)) for k, v in re.findall(r"(BF_\w+) = (\d+)", enum))
    assert list(flags) == ["BF_ENTRY", "BF_LREADY", "BF_RREADY", "BF_HOP0",
                           "BF_THREAD"]
    assert "return (rs ? 2 : 1) * (n - 1);" in src
    assert ("return BF_THREAD + (hops_for(n, rs) > 1 ? hops_for(n, rs) - 1 "
            ": 0) * THREADS;") in src
    assert "return 1 + BLOCKS * flags_per_block(n, rs);" in src
    threads, blocks = _const(src, "THREADS"), _const(src, "BLOCKS")
    for n in range(1, epoch_step.RING_MMA_MAX_REPLICAS + 1):
        hops = (2 if rs else 1) * (n - 1)
        per_block = flags["BF_THREAD"] + max(hops - 1, 0) * threads
        assert epoch_step.ring_mma_flags_per_replica(n, bool(rs)) == \
            1 + blocks * per_block


def test_stamps_phases_match_the_sources_events():
    src = _src("ring_mma.cu")
    enum = re.search(r"enum KmStamp : int \{(.*?)\};", src, re.S).group(1)
    ring0 = re.findall(r"\bKM_\w+", enum).index("KM_RING0")
    per_hop = re.search(r"int ring_events\(int n, int rs\) \{\s*return "
                        r"\(rs \? (\d) : (\d)\) \* \(n - 1\);", src).groups()
    words = _const(src, "KM_STAMP_WORDS")
    used = re.search(r"pdmt_ring_mma_stamps_used\(int n, int rs\) \{\s*"
                     r"return KM_RING0 \+ ring_events\(n, rs\) \+ (\d);",
                     src).group(1)
    for ring in RINGS:
        for n in range(2 if ring == "reduce_scatter" else 1, 5):
            events = int(per_hop[0 if ring == "reduce_scatter" else 1]) * (n - 1)
            phases = epoch_step.k6_mma_phases(ring, n)
            assert len(phases) + 1 == ring0 + events + int(used)
            assert len(phases) + 1 <= words
            assert len(set(phases)) == len(phases)
            assert phases[-1] == "replica barrier 3"


# ---- the build, the source and the refusals ----

def test_build_has_the_ring_source_and_its_stamps_variant():
    assert _build.SOURCES["ring_mma"] == "ring_mma.cu"
    assert _build.VARIANTS["ring_mma_stamps"] == ("ring_mma",
                                                  ("-DK6M_STAMPS",))
    assert _build._target("ring_mma") != _build._target("ring_mma_stamps")
    src = _src("ring_mma.cu")
    assert "#ifdef K6M_STAMPS" in src
    assert '#include "mma_step.cuh"' in src and '#include "dp_ring.cuh"' in src
    for entry in ("n_params", "table_fields", "max_batch", "threads",
                  "max_replicas", "blocks", "owner_lo", "owner_len",
                  "smem_bytes", "scratch_bytes", "flags_per_replica",
                  "stamp_words", "stamps_used", "coresident", "step"):
        assert f'extern "C" int pdmt_ring_mma_{entry}(' in src
    assert "launch_count" not in src


def test_the_step_is_k2_mma_and_the_ring_the_only_coupling():
    src = _src("ring_mma.cu")
    # K2-mma's phase code, with a third store policy for the ring
    for body in ("hidden_tile(", "rows_tile<", "grads_tile(", "round_w23(",
                 "rows_to_bf16(", "StoreComm{"):
        assert body in src
    assert "StoreSgd" not in src.split("namespace {", 1)[1].replace(
        "StoreGrad and StoreSgd", "")
    # no grid-wide barrier: replica barriers and the ring's flags only
    assert "grid.sync" not in src and "cooperative_groups" not in src
    assert src.count("cudaLaunchCooperativeKernel(") == 1
    assert "fence.proxy.async" in src and "__grid_constant__" in src
    assert "__noinline__ bool ring_hops(" in src
    # no float atomics, no products of its own
    assert "atomicAdd" not in src and "mma.sync" not in src


def test_store_policies_of_the_step_keep_their_code():
    hdr = _src("mma_step.cuh")
    assert "struct StoreGrad {" in hdr and "struct StoreSgd {" in hdr
    assert "struct StoreComm" not in hdr


def test_debug_entries_refuse_the_cpu():
    n, B = 2, 8
    x = torch.zeros((B, 784), dtype=torch.uint8)
    y = torch.zeros(B, dtype=torch.int32)
    params = epoch_step.unpack(torch.zeros(epoch_step.N_PARAMS))
    with pytest.raises(ValueError, match="CUDA"):
        epoch_step.k6_mma_phase_stamps([params] * n, [x] * n, [y] * n, 1,
                                       0.01, B, axis_size=n,
                                       ring="allgather")


@pytest.mark.parametrize("dtype,bf16,batch,n,blocks", [
    (torch.float32, True, 8, 2, 0), (torch.uint8, False, 8, 2, 0),
    (torch.uint8, True, 136, 2, 0), (torch.uint8, True, 8, 5, 0),
    (torch.uint8, True, 8, 2, 33)])
def test_mma_launch_refuses_before_loading_a_library(monkeypatch, dtype, bf16,
                                                     batch, n, blocks):
    def boom(*a, **k):
        raise AssertionError("a library was loaded")
    monkeypatch.setattr(_build, "load", boom)
    monkeypatch.setattr(epoch_step, "_ring_mma_lib", boom)
    params = epoch_step.unpack(torch.zeros(epoch_step.N_PARAMS))
    x = torch.zeros((batch, 784), dtype=dtype)
    y = torch.zeros(batch, dtype=torch.int32)
    with pytest.raises(ValueError, match="K6-mma"):
        epoch_step._ring_launch([params] * n, [x] * n, [y] * n, [0] * n,
                                [None] * n, 0.01, batch, "core", 1, bf16,
                                "allgather", blocks, design="mma")


# ---- the gradient-tile owners and the plain version of the schedule ----

def test_owners_partition_the_packed_gradient_once():
    ranges = epoch_step.grads_owner_ranges()
    assert len(ranges) == epoch_step.RING_MMA_BLOCKS
    every = torch.cat([torch.arange(lo, lo + size) for lo, size in ranges])
    assert torch.equal(every.sort().values,
                       torch.arange(epoch_step.N_PARAMS))
    # whole float4s; 16-row tiles of gw1 and gw2, gw3, bias quarters
    assert all(lo % 4 == 0 and size % 4 == 0 for lo, size in ranges)
    sizes = [size for _, size in ranges]
    assert sizes == [2048] * 57 + [1280] + [32] * 8


def test_owners_are_grads_tiles_blocks():
    # grads_tile's block b writes gw1 rows 16b.. (b < 49), gw2 rows
    # 16(b - 49).. (b < 57), gw3 (57), gb1 and gb2 quarters (58..65): the
    # same slices, in that order, of the packed w1|b1|w2|b2|w3
    hdr = _src("mma_step.cuh")
    assert "constexpr int TILES_W1 = IN / 16;" in hdr
    assert "constexpr int TILES_W2 = H1 / 16;" in hdr
    w1_tiles, w2_tiles = 784 // 16, 128 // 16
    ranges = epoch_step.grads_owner_ranges()
    off_b1 = 784 * 128
    off_w2, off_b2 = off_b1 + 128, off_b1 + 128 + 128 * 128
    off_w3 = off_b2 + 128
    assert [lo for lo, _ in ranges[:w1_tiles]] == \
        [16 * 128 * b for b in range(w1_tiles)]
    assert [lo for lo, _ in ranges[w1_tiles:w1_tiles + w2_tiles]] == \
        [off_w2 + 16 * 128 * b for b in range(w2_tiles)]
    assert ranges[w1_tiles + w2_tiles] == (off_w3, 1280)
    quarters = [lo for lo, _ in ranges[w1_tiles + w2_tiles + 1:]]
    assert quarters == [off_b1 + 32 * q for q in range(4)] + \
        [off_b2 + 32 * q for q in range(4)]


def test_some_reduce_scatter_bound_cuts_a_tile():
    # a bound inside a 2,048-float slice: its elements move on two chunks'
    # hops (the case K6-ws's runs of COLS floats never met)
    cut = [(n, lo) for n in range(2, 10)
           for lo, size in epoch_step.grads_owner_ranges()
           if any(lo < b < lo + size for b in epoch_step.rs_chunk_bounds(n))]
    assert any(n <= epoch_step.RING_MMA_MAX_REPLICAS for n, _ in cut)


def _grads(n, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.normal(size=epoch_step.N_PARAMS)
                              * 10.0 ** rng.integers(-3, 3, size=epoch_step
                                                     .N_PARAMS))
                             .astype(np.float32)) for _ in range(n)]


@pytest.mark.parametrize("n", range(2, 10))
@pytest.mark.parametrize("ring", RINGS)
def test_ring_mean_by_grads_owner_is_ring_mean_bitwise(ring, n):
    flats = _grads(n, seed=200 + n)
    assert torch.equal(epoch_step.ring_mean_by_grads_owner(flats, ring),
                       epoch_step.ring_mean(flats, ring))


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


@pytest.mark.parametrize("ring,n", [("allgather", 2), ("allgather", 3),
                                    ("allgather", 4), ("reduce_scatter", 2),
                                    ("reduce_scatter", 3),
                                    ("reduce_scatter", 4),
                                    ("reduce_scatter", 9)])
def test_ring_mean_by_grads_owner_is_the_jax_ring_tree_bitwise(ring, n):
    assert epoch_step._rs_chunk_rows(n) == jax_ops._rs_chunk_rows(n)
    flats = _grads(n, seed=300 + n)
    want = _jax_ring_tree([_tpu_pack(to_numpy_params(epoch_step.unpack(f)))
                           for f in flats], ring)
    got = epoch_step.ring_mean_by_grads_owner(flats, ring)
    np.testing.assert_array_equal(
        _tpu_pack(to_numpy_params(epoch_step.unpack(got))), want)


def test_ring_mean_by_grads_owner_refuses_an_unknown_ring():
    with pytest.raises(ValueError, match="ring must be"):
        epoch_step.ring_mean_by_grads_owner(_grads(2, 0), "tree")
