// K6-mma: the DP epoch kernel (K6) redesigned on the tensor-core step, in
// its bf16 forms: uint8 rows, compute_bf16, dropout from pre-drawn masks
// (K2b), in-kernel Philox (K2c) or in-kernel threefry (K3), B <= 128 rows
// a replica, the all-gather ring and the reduce-scatter + all-gather ring,
// n = 1..MAX_N replicas on one card, one cooperative launch an epoch.
//
// Replaces the TPU kernel pytorch_ddp_mnist_tpu/ops/pallas_step.py
// `_make_epoch_kernel` with n_devices > 1 (:662-799) in its `compute_bf16`
// forms (:517, products :600-660), reached through
// `epoch_fused_sgd(axis_size=n, ring=..., compute_bf16=True)`. The rows
// design's ring (epoch_step.cu `ring_kernel`) keeps the bf16 forms with f32
// rows, B > 128 and n > MAX_N; ops/epoch_step.py `ring_design` picks.
//
// Each replica is BLOCKS = 66 blocks of THREADS threads, the gradient
// phase's, running K2-mma's step (mma_step.cuh: hidden_tile, round_w23,
// rows_tile, grads_tile, the uint8 rows converted to bf16 through the
// wrapper's table into a double buffer), with its own rows, masks,
// weights, exchange and tensor maps. K2-mma's three grid barriers a step
// are replica barriers here (a generation counter of the replica's, as
// dp_ring.cuh ReplicaGroup's, with K2-mma's fence.proxy.async around
// each): the ring is the only coupling between replicas. The hidden
// phase's 16 B/16 tiles run in turn on the 66 blocks (t = b, b + 66, ...:
// two at B = 128), each by the same device function as in K2-mma, so the
// bits do not depend on the grid; the row tiles of replica r start at
// block r B/16 (so the replicas' row tiles fall on different SMs), and the
// next step's rows are converted by the warps the gradient phase leaves
// idle. MAX_N = 4: 4 x 66 blocks are co-resident at two an SM (128
// registers a thread, ~57 KB of shared memory a block), and the kernel
// parameter holds four replicas' tensor maps. (Up to 16 B/16 blocks a
// replica, one tile each, was no faster at n = 2 and 3 on an H100, within
// the noise of the turns.)
//
// The ring: one mini-ring per gradient-tile owner. Block b of replica r
// runs grads_tile's block b, which makes one fixed, contiguous slice of
// the packed gradient w1|b1|w2|b2|w3 (`owner_lo`, `owner_len`): blocks
// 0..48 16-row tiles of gw1 (2,048 floats each), 49..56 of gw2, 57 gw3
// (1,280), 58..61 and 62..65 column quarters of gb1 and gb2 (32 each). A
// third store policy beside mma_step.cuh's StoreGrad and StoreSgd,
// StoreComm, writes each element into the replica's comm buffer and, for
// hop 0, straight into the right neighbour's (all-gather: origin slot r
// there; reduce-scatter: the elements of chunk r into recv slot 0 there).
// Block b then exchanges only its slice, and only with block b of its
// neighbours, through per-(replica, block) flag counters: hop 0 is
// signalled for the block, later hops per thread (thread t carries the
// float4s t, t + THREADS, ... of the slice on every replica alike). The
// trees are dp_ring.cuh's, in K6-ws's schedule:
//   all-gather      hop h sends origin slot (r - h) mod n to the same slot
//                   of the right neighbour; then tot = g0; tot = tot + g1;
//                   ... in origin order;
//   reduce-scatter  an element's chunk is the one its packed offset falls
//                   in (rs_chunk_bounds; bounds are multiples of 4, so a
//                   float4 never straddles one, though a gw1 tile may hold
//                   elements of two chunks, which move on different hops);
//                   hop h sends partial chunk (r - h) into recv slot h of
//                   the right neighbour and folds the arriving chunk
//                   (r - h - 1) in as local + incoming, then n - 1 hops
//                   broadcast the finished chunks.
// Then w = w - lr * (tot * f32(1/n)) (dp_ring.cuh sgd1) on the replica's
// weights in place, each element by its owner, and a replica barrier: the
// next step's tensor copies read w1. So an epoch is bitwise K1-mma per
// replica + ring_mean's tree + SGD (every gradient element made by the
// same MMA sequence as in K1-mma and K2-mma, the same trees, the same
// update), every replica ends every step with the same bits, and a repeat
// launch gives the same bits. No float atomics.
//
// Kept from dp_ring.cuh and K6-ws: the entry barrier and the per-step
// neighbour handshake (per block: my hop-0 stores overwrite buffers of
// block b on my right that its previous step read last; signalled at the
// step's start, waited beside replica barrier 2, before the gradient
// phase's first store), release/acquire flags, ld.global.cg / st.global.cg
// for everything a neighbour writes or reads, the bounded waits with the
// launch's error record, and the test hook of a replica that never
// signals hop 0. Flags only grow within a launch. The hops run out of line
// (`ring_hops`) with their block context in a file-scope `__shared__`
// struct, as in K6-ws, whose inlined ring spilled its step.
//
// The tensor maps: each replica's 14 (mma_step.cuh EpochMaps: its bf16 rows
// in two buffers, its w1, its exchange) in one `__grid_constant__` kernel
// parameter, 1,792 bytes a replica, 7,168 at MAX_N: past the classic 4 KB
// of parameters, within the 32,764 bytes CUDA 12.1 allows. A parameter is
// constant for the launch; a map in global memory is read through the
// tensor-map proxy and would need fence.proxy.tensormap against its writer
// (and against a map cached from an earlier launch at the same address).
//
// What bounds it on an H100: n times K2-mma's products (64.9 MFLOP a
// replica a step at B = 128) at the 989 TFLOP/s bf16 peak, against the
// ring's bytes (all-gather: n (n - 1) packed gradients a step, each written
// once and read once); the bytes set the bound. In practice a step is
// K2-mma's three dependent phases, three replica barriers and the ring's
// dependent hops: latency sets the time.
//
// Build macro: K6M_STAMPS, a debug build that records %globaltimer at the
// phase boundaries of block 0 of replica 0 (ops/epoch_step.py
// `k6_mma_phase_stamps`); the default build has none of that code.
//
// Plain C interface for ctypes (ops/_build.py, ops/epoch_step.py): launches
// on the caller's stream, never synchronises, allocates nothing, and
// returns the CUDA error code (0 on success).

#include <algorithm>
#include <cstdint>

#include "dp_ring.cuh"
#include "mma_step.cuh"

namespace {

using namespace mma_step;

// the block: the widest phase's (hidden_tile, a warp a k chunk)
constexpr int THREADS = 224;
// rows a step of a replica
constexpr int MAX_BATCH = 128;
// hidden tiles a 16-row group
constexpr int UNIT_BLOCKS = 16;
// a replica's blocks: the gradient-tile owners, grads_tile's blocks
constexpr int BLOCKS = 66;
// replicas: four replicas' blocks fit the card at two an SM, and the
// kernel parameter holds four replicas' tensor maps
constexpr int MAX_N = 4;
static_assert(THREADS == HIDDEN_THREADS && THREADS >= ROWS_THREADS &&
                  THREADS >= GRAD_THREADS && MAX_BATCH == B_MAX &&
                  UNIT_BLOCKS == UNIT_GROUPS && BLOCKS == GRAD_BLOCKS &&
                  HR == RR,
              "the phases' geometry (mma_step.cuh)");

// the packed layout of the weights and of the gradient (epoch_step.cu's)
constexpr int OFF_B1 = IN * H1;
constexpr int OFF_W2 = OFF_B1 + H1;
constexpr int OFF_B2 = OFF_W2 + H1 * H2;
constexpr int OFF_W3 = OFF_B2 + H2;
constexpr int N_PARAMS = OFF_W3 + H2 * NC;  // 118,272

// The slice of the packed gradient that grads_tile's block b makes: its
// first offset and its length in floats.
__host__ __device__ constexpr int owner_lo(int b) {
  return b < TILES_W1    ? b * 16 * H1
         : b < W3_BLOCK  ? OFF_W2 + (b - TILES_W1) * 16 * H2
         : b == W3_BLOCK ? OFF_W3
         : b < GB2_BLOCK ? OFF_B1 + (b - GB1_BLOCK) * BIAS_COLS
                         : OFF_B2 + (b - GB2_BLOCK) * BIAS_COLS;
}

__host__ __device__ constexpr int owner_len(int b) {
  return b < W3_BLOCK ? 16 * H1 : b == W3_BLOCK ? H2 * NC : BIAS_COLS;
}

// the slices are whole float4s and cover the packed gradient once
constexpr bool owners_partition() {
  int total = 0;
  for (int b = 0; b < BLOCKS; ++b) {
    const int lo = owner_lo(b), len = owner_len(b);
    if (lo % 4 || len % 4 || lo < 0 || lo + len > N_PARAMS) return false;
    for (int c = 0; c < b; ++c)
      if (lo < owner_lo(c) + owner_len(c) && owner_lo(c) < lo + len)
        return false;
    total += len;
  }
  return total == N_PARAMS;
}
static_assert(owners_partition(), "the gradient-tile owners' slices");

// float4s of a slice a thread carries, at most
constexpr int UPT = (16 * H1 / 4 + THREADS - 1) / THREADS;  // 3

// a block's flag counters, after the replica barrier's (flags[0]): the
// entry barrier's, the handshake's from each side, hop 0's, then one per
// thread for each later hop (BF_THREAD + (h - 1) * THREADS + t)
enum BlockFlag : int { BF_ENTRY = 0, BF_LREADY = 1, BF_RREADY = 2,
                       BF_HOP0 = 3, BF_THREAD = 4 };

__host__ __device__ constexpr int hops_for(int n, int rs) {
  return (rs ? 2 : 1) * (n - 1);
}

__host__ __device__ constexpr int flags_per_block(int n, int rs) {
  return BF_THREAD + (hops_for(n, rs) > 1 ? hops_for(n, rs) - 1 : 0) * THREADS;
}

// the stamps of a step (K6M_STAMPS): KM_START .. KM_RING0 - 1, then one per
// ring event (hop 0's signal; all-gather: each hop's wait and load, and
// store and signal; reduce-scatter: each hop's wait and add, and store and
// signal, then the broadcast hops' waits and loads, and stores and
// signals), then the end of the update, then replica barrier 3 passed
enum KmStamp : int { KM_START, KM_HIDDEN, KM_BAR1, KM_ROWS, KM_BAR2,
                     KM_GRADS, KM_RING0 };
constexpr int KM_STAMP_WORDS = 24;
__host__ __device__ constexpr int ring_events(int n, int rs) {
  return (rs ? 4 : 2) * (n - 1);
}
static_assert(KM_RING0 + ring_events(MAX_N, 1) + 2 <= KM_STAMP_WORDS,
              "stamp words of a step");

struct RingMmaLaunch {
  ring::RingArgs ring;
  const uint16_t* table;  // (256,) bf16 bits of normalise(v)
  int nsteps;
  int batch;
  uint32_t seed;
  float inv_batch;
  unsigned long long* stamps;  // (S, KM_STAMP_WORDS) in the stamps build
};

// every replica's tensor maps
struct RingMmaMaps {
  EpochMaps rep[MAX_N];
};

// What a block's step and ring read besides the kernel's arguments, held
// in shared memory so that the step's chains keep the registers (K2-mma's
// step alone takes 128, the most two blocks an SM allow).
struct BlockCtx {
  StepScratch sc;     // the replica's exchange
  unsigned* bar;      // the replica barrier's counter
  unsigned* myf;      // this block's flag counters
  unsigned* rtf;      // block b's of the right neighbour
  unsigned* ltf;      // and of the left
  float* my_comm;     // the replica's comm and recv; the right neighbour's
  float* my_recv;
  float* rt_comm;
  float* rt_recv;
  float* own;         // the block's gradient: origin slot, or the flat comm
  float* peer;        // hop 0's destination, indexed by packed offset
  float* w;           // the replica's packed weights
  int plo, phi;       // the packed offsets hop 0 sends
  unsigned long long* stamps;  // replica 0's block 0, else null
};

// one per block; the kernel's thread 0 fills it
__shared__ BlockCtx blk;

__device__ __forceinline__ void km_stamp(unsigned long long* stamps, int step,
                                         int slot) {
#ifdef K6M_STAMPS
  if (stamps != nullptr && threadIdx.x == 0) {
    unsigned long long t;  // "memory": not moved across the barriers
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
    stamps[(size_t)step * KM_STAMP_WORDS + slot] = t;
  }
#endif
}

// orders this thread's generic accesses before its later async-proxy ones
// (tensor copies) and hands its generic stores to other threads' copies
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async;" ::: "memory");
}

// The replica barriers a launch has passed after its `k`-th of step s
// (k = 1..3; the one before the steps is the first)
__device__ __forceinline__ unsigned barrier_gen(int s, int k) {
  return 1u + 3u * static_cast<unsigned>(s) + static_cast<unsigned>(k);
}

// K2-mma's grid barrier as a barrier of the replica's BLOCKS blocks
// (dp_ring.cuh ReplicaGroup's generation counter; `gen` the barriers passed
// with this one): every thread fences its stores to the async proxy, the
// block arrives on the replica's counter and waits for all of them; the
// thread that issues the next phase's copies fences after it. With `hs`,
// thread 32 meanwhile waits for the handshake: both neighbours' blocks b
// have started step `step` (are done with its buffers of step - 1). False
// when a wait failed.
__device__ __forceinline__ bool replica_sync(const ring::Err& err,
                                             unsigned gen, int step,
                                             const unsigned* hs = nullptr) {
  const int me = blockIdx.x / BLOCKS;
  proxy_fence();
  __syncthreads();
  int ok = 1;
  if (threadIdx.x == 0) {
    __threadfence();
    ring::add_release(blk.bar, 1u);
    ok = ring::spin_geq(blk.bar, gen * BLOCKS, err, ring::W_BARRIER, me,
                        step, -1);
  } else if (hs != nullptr && threadIdx.x == 32) {
    const unsigned done = static_cast<unsigned>(step) + 1u;
    ok = ring::spin_geq(hs + BF_LREADY, done, err, ring::W_HANDSHAKE, me,
                        step, -1) &&
         ring::spin_geq(hs + BF_RREADY, done, err, ring::W_HANDSHAKE, me,
                        step, -1);
  }
  ok = __syncthreads_and(ok);
  if (threadIdx.x == 0) proxy_fence();
  return ok != 0;
}

// Where grads_tile puts a gradient element of K6-mma: into the replica's
// own gradient (`own`, indexed by packed offset: the tile's pointers are
// into it) and, where the offset is one hop 0 sends, into the right
// neighbour's buffer at `peer` (indexed the same way). Both through L2.
struct StoreComm {
  const float* own;
  float* peer;
  int plo, phi;
  __device__ bool sends(const float* p) const {
    const int off = static_cast<int>(p - own);
    return off >= plo && off < phi;
  }
  template <int N>
  __device__ void ones(float* (&p)[N], const float (&g)[N]) const {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (p[i] != nullptr) {
        __stcg(p[i], g[i]);
        if (sends(p[i])) __stcg(peer + (p[i] - own), g[i]);
      }
  }
  template <int N>
  __device__ void twos(float* (&p)[N], const float (&g)[N][2]) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float2 v = make_float2(g[i][0], g[i][1]);
      __stcg(reinterpret_cast<float2*>(p[i]), v);
      if (sends(p[i]))  // an even offset: a pair never straddles a bound
        __stcg(reinterpret_cast<float2*>(peer + (p[i] - own)), v);
    }
  }
};

template <int RNG>
__device__ __forceinline__ StepMask<RNG> step_mask(const ring::Replica& r,
                                                   uint32_t seed, int batch,
                                                   int s, int me) {
  if constexpr (RNG == RNG_MASKS) {
    return {r.masks + (size_t)s * batch * H1, 0u, 0u, 0u};
  } else if constexpr (RNG == RNG_THREEFRY) {
    return {nullptr, static_cast<uint32_t>(r.keys[2 * s]),
            static_cast<uint32_t>(r.keys[2 * s + 1]), 0u};
  } else {
    return {nullptr, seed, static_cast<uint32_t>(s),
            static_cast<uint32_t>(me)};
  }
}

// One step's ring on block b's slice, after the gradient phase: hop 0's
// signal, the hops, then the update of the slice's weights from the mean.
// False when the block must leave the launch (a failed wait, or the test
// hook). Kept out of line, so that its registers are allocated apart from
// the step's.
__device__ __noinline__ bool ring_hops(const ring::RingArgs ra, int me, int b,
                                       int step) {
  const BlockCtx& c = blk;
  const int n = ra.n, P = ra.P, tid = threadIdx.x;
  const unsigned done = static_cast<unsigned>(step) + 1u;
  int slot = KM_RING0;
  const auto mark = [&](int at) { km_stamp(c.stamps, step, at); };
  // this thread's float4s of the slice: packed offset (-1: none) and, for
  // the reduce-scatter ring, chunk
  const int lo = owner_lo(b), len4 = owner_len(b) / 4;
  int off[UPT], ch[UPT];
#pragma unroll
  for (int m = 0; m < UPT; ++m) {
    const int q = tid + m * THREADS;
    off[m] = q < len4 ? lo + 4 * q : -1;
    ch[m] = 0;
    if (ra.rs && off[m] >= 0)
      while (off[m] >= __ldg(ra.chunk_lo + ch[m] + 1)) ++ch[m];
  }
  // Hop 0 carries what the gradient phase stored (any thread's), so it is
  // signalled for the block: a barrier, then one fence and flag. Every
  // later hop carries only float4s a thread holds itself, the same on both
  // sides, so thread t signals thread t of the neighbour's block b on a
  // flag of its own and waits on its own: no block barrier between hops. A
  // thread with no float4s takes no part in them. A failed wait skips the
  // rest; the barrier at the end makes the exit uniform.
  const bool any = off[0] >= 0;
  bool ok = true;
  const auto wait_hop = [&](int h) {
    if (ok && any)
      ok = ring::spin_geq(h == 0 ? c.myf + BF_HOP0
                                 : c.myf + BF_THREAD + (h - 1) * THREADS + tid,
                          done, ra.err, ring::W_HOP, me, step, h);
    return ok;
  };
  const auto signal_hop = [&](int h) {
    if (h == 0) {
      // the test hook: replica `fault` never signals hop 0 and leaves the
      // launch there, so the one wait that times out is its neighbour's
      if (me == ra.fault) return false;
      ring::block_signal(c.rtf + BF_HOP0);
    } else if (any) {
      ring::add_release(c.rtf + BF_THREAD + (h - 1) * THREADS + tid, 1u);
    }
    mark(slot++);
    return true;
  };
  const auto in_chunk = [&](int m, int chunk) {
    return off[m] >= 0 && (chunk < 0 || ch[m] == chunk);
  };
  // this thread's float4s of `chunk` (-1: all) from src into v / from v to
  // dst, every load issued before the first use
  const auto load = [&](float4 (&v)[UPT], const float* src, int chunk) {
    if (!ok) return;
#pragma unroll
    for (int m = 0; m < UPT; ++m)
      if (in_chunk(m, chunk))
        v[m] = __ldcg(reinterpret_cast<const float4*>(src + off[m]));
  };
  const auto store = [&](float* dst, const float4 (&v)[UPT], int chunk) {
#pragma unroll
    for (int m = 0; m < UPT; ++m)
      if (in_chunk(m, chunk))
        __stcg(reinterpret_cast<float4*>(dst + off[m]), v[m]);
  };
  const auto apply = [&](int m, float4 tot) {
    float4* const pw = reinterpret_cast<float4*>(c.w + off[m]);
    __stcg(pw, ring::sgd4(__ldcg(pw), tot, ra.lr, ra.inv_n));
  };
  // hop 0 first (its fence then waits for the gradient phase's stores
  // only), then the block's own gradient of this thread's float4s (the
  // signal's barrier, or a barrier of its own at n = 1, made every
  // thread's stores visible to the block)
  if (n == 1)
    __syncthreads();
  else if (!signal_hop(0))
    return false;
  float4 own[UPT];
  load(own, c.own, -1);
  if (!ra.rs) {
    // all-gather: hop 0 is my own slot, stored into `right` by the
    // gradient phase; hop h forwards origin slot (me - h) mod n, which
    // arrived at hop h - 1, into the same slot of `right`; rv[h] holds
    // slot (me - h - 1) mod n
    float4 rv[MAX_N - 1][UPT];
#pragma unroll
    for (int h = 0; h < MAX_N - 1; ++h) {
      if (h >= n - 1) break;
      wait_hop(h);
      const size_t sl = (size_t)((me - h - 1 + n) % n) * P;
      load(rv[h], c.my_comm + sl, -1);
      mark(slot++);
      if (h + 1 < n - 1) {
        store(c.rt_comm + sl, rv[h], -1);
        signal_hop(h + 1);
      }
    }
    // the fixed origin-order sum: tot = g0; tot = tot + g1; ...
    if (ok) {
#pragma unroll
      for (int m = 0; m < UPT; ++m) {
        if (off[m] < 0) continue;
        float4 tot = own[m];
#pragma unroll
        for (int d = 0; d < MAX_N; ++d) {
          if (d >= n) break;
          const int h = (me - d + n) % n;  // 0: mine, else rv[h - 1]
          float4 x = own[m];
#pragma unroll
          for (int r = 1; r < MAX_N; ++r)
            if (h == r) x = rv[r - 1][m];
          tot = d == 0 ? x : ring::add4(tot, x);
        }
        apply(m, tot);
      }
    }
  } else {
    const int* lo_of = ra.chunk_lo;
    const size_t cmax = ra.chunk_max;
    // reduce-scatter: hop 0 is chunk `me` of my gradient, stored into recv
    // slot 0 of `right` by the gradient phase; at hop h the arriving
    // partial of chunk (me - h - 1) is folded in as local + incoming, and
    // sent on at hop h + 1
    for (int h = 0; h < n - 1; ++h) {
      wait_hop(h);
      const int ac = (me - h - 1 + 2 * n) % n;
      float4 inc[UPT];
      load(inc, c.my_recv + h * cmax - __ldg(lo_of + ac), ac);
#pragma unroll
      for (int m = 0; m < UPT; ++m)
        if (in_chunk(m, ac)) own[m] = ring::add4(own[m], inc[m]);
      mark(slot++);
      if (h + 1 < n - 1) {
        store(c.rt_recv + (h + 1) * cmax - __ldg(lo_of + ac), own, ac);
        signal_hop(h + 1);
      }
    }
    // all-gather of the reduced chunks: hop k forwards chunk (me + 1 - k),
    // finished here at hop k - 1 (hop 0: the one this replica reduced),
    // into the same place of `right`
    for (int k = 0; k < n - 1; ++k) {
      const int sc = (me + 1 - k + n) % n;
      if (k > 0) {
        wait_hop(n - 1 + k - 1);
        load(own, c.my_comm, sc);
        mark(slot++);
      }
      store(c.rt_comm, own, sc);
      signal_hop(n - 1 + k);
    }
    if (n > 1) {
      wait_hop(2 * n - 3);
      load(own, c.my_comm, (me + 2) % n);
      mark(slot++);
    }
    if (ok) {
#pragma unroll
      for (int m = 0; m < UPT; ++m)
        if (off[m] >= 0) apply(m, own[m]);
    }
  }
  // the slice's weights updated before the replica barrier; a failed wait
  // anywhere in the block ends it
  if (!__syncthreads_and(ok)) return false;
  mark(slot);
  return true;
}

template <int RNG>
__global__ void __launch_bounds__(THREADS, 2) ring_mma_kernel(
    const __grid_constant__ RingMmaLaunch a,
    const __grid_constant__ RingMmaMaps maps) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint16_t tbl[256];
  uint64_t* const hbars = reinterpret_cast<uint64_t*>(smem + EPOCH_DATA);
  uint64_t* const rbars = hbars + NKC;
  uint64_t* const gbars = rbars + NWC;
  const ring::RingArgs& ra = a.ring;
  const int n = ra.n, tid = threadIdx.x;
  const int me = blockIdx.x / BLOCKS, b = blockIdx.x % BLOCKS;
  const ring::Replica& mine = ra.reps[me];
  const EpochMaps& mp = maps.rep[me];
  // this thread's index in the replica, and the replica's threads
  const int rtid = b * THREADS + tid, rthr = BLOCKS * THREADS;
  const int batch = a.batch;
  const int groups = (batch + HR - 1) / HR;  // 16-row groups
  const int tiles = UNIT_BLOCKS * groups;    // the hidden phase's
  const int chunks = batch * IN / 16;        // 16-pixel chunks of a step
  const size_t step_px = (size_t)batch * IN;
  unsigned char* const scratch = reinterpret_cast<unsigned char*>(mine.scratch);
  bf16* const xb = epoch_rows(scratch, batch);
  const uint8_t* const x = static_cast<const uint8_t*>(mine.x);
  float* const w = mine.w;
  if (tid == 0) {
    BlockCtx& c = blk;
    const ring::Replica& rt = ra.reps[(me + 1) % n];
    const ring::Replica& lt = ra.reps[(me + n - 1) % n];
    const int fpb = flags_per_block(n, ra.rs);
    c.myf = mine.flags + 1 + b * fpb;
    c.rtf = rt.flags + 1 + b * fpb;
    c.ltf = lt.flags + 1 + b * fpb;
    c.my_comm = mine.comm;
    c.my_recv = mine.recv;
    c.rt_comm = rt.comm;
    c.rt_recv = rt.recv;
    c.own = mine.comm + (ra.rs ? 0 : (size_t)me * ra.P);
    // hop 0's destination: all of origin slot `me` on the right
    // (all-gather), or chunk `me` of recv slot 0 there (reduce-scatter);
    // none at n = 1
    c.plo = ra.rs ? __ldg(ra.chunk_lo + me) : 0;
    c.phi = n == 1 ? 0 : ra.rs ? __ldg(ra.chunk_lo + me + 1) : ra.P;
    c.peer = ra.rs ? rt.recv - c.plo : rt.comm + (size_t)me * ra.P;
    c.w = w;
    c.stamps = blockIdx.x == 0 ? a.stamps : nullptr;
    c.sc = carve(scratch, batch);
    c.bar = mine.flags + ring::F_BAR;
  }
  // the TPU kernel's step-0 init: the weights start as a copy of the
  // inputs; step 0's rows to bf16
  for (int i = tid; i < 256; i += THREADS) tbl[i] = a.table[i];
  {
    const float4* in4 = reinterpret_cast<const float4*>(mine.in);
    float4* w4 = reinterpret_cast<float4*>(w);
    for (int i = rtid; i < N_PARAMS / 4; i += rthr)
      __stcg(w4 + i, __ldg(in4 + i));
  }
  bars_init(hbars, EPOCH_BARS);  // and the table and the context are in
  rows_to_bf16(x, xb, tbl, chunks, rtid, rthr);
  if (!replica_sync(ra.err, 1u, -1)) return;
  // the entry barrier: tell block b of both neighbours that this one runs,
  // then wait for both of theirs
  ring::block_signal(blk.ltf + BF_ENTRY, blk.rtf + BF_ENTRY);
  if (!ring::block_wait(blk.myf + BF_ENTRY, 2u, ra.err, ring::W_ENTRY, me, -1,
                        -1))
    return;

  float* const b1 = w + OFF_B1;
  float* const w2 = w + OFF_W2;
  float* const b2 = w + OFF_B2;
  float* const w3 = w + OFF_W3;
  constexpr int ROUND_ALL = H1 * H2 + H2 * NCP;  // round_w23's elements
  uint32_t huse = 0;  // the hidden barriers' completed phases
  for (int s = 0; s < a.nsteps; ++s) {
    const uint32_t ph = s & 1;  // the rows' buffer and the other parities
    km_stamp(blk.stamps, s, KM_START);
    // the handshake, first half: this block is done with step s - 1's
    // buffers (replica barrier 3, or the entry barrier, ordered every
    // thread's reads before this), so its neighbours' blocks b may
    // overwrite them
    if (tid == 32) {
      __threadfence();
      ring::add_release(blk.rtf + BF_LREADY, 1u);
      ring::add_release(blk.ltf + BF_RREADY, 1u);
    }

    // ---- 1. z1, the mask, d1; w2 and w3 to bf16 ----
    if (b < tiles) {
      for (int t = b; t < tiles; t += BLOCKS) {
        if (t != b) {  // the last tile's operands read, its copies issued
          __syncthreads();
          if (tid == 0) proxy_fence();
        }
        hidden_tile(smem, hbars, huse & 1,
                    ph ? &mp.x_rows1 : &mp.step.x_rows,
                    step_mask<RNG>(mine, a.seed, batch, s, me),
                    &mp.step.w1_cols, b1, w2, w3, blk.sc.w2b, blk.sc.w3b,
                    blk.sc.d1b, blk.sc.z1, blk.sc.mv, batch, t % UNIT_BLOCKS,
                    t / UNIT_BLOCKS, t == b ? rtid : ROUND_ALL, rthr);
        ++huse;
      }
    } else {
      round_w23(w2, w3, blk.sc.w2b, blk.sc.w3b, rtid, rthr);
    }
    km_stamp(blk.stamps, s, KM_HIDDEN);
    if (!replica_sync(ra.err, barrier_gen(s, 1), s)) return;
    km_stamp(blk.stamps, s, KM_BAR1);

    // ---- 2. the rest of each row ----
    // row tile rb runs on block (rb + me * groups) mod BLOCKS: the
    // replicas' row tiles on blocks of different indices, which the card
    // spreads over different SMs
    {
      const int rb = (b + BLOCKS - (me * groups) % BLOCKS) % BLOCKS;
      if (rb < groups && tid < ROWS_THREADS) {
        const StepScratch& sc = blk.sc;
        rows_tile<THREADS>(smem, rbars, ph, mine.y + (size_t)s * batch,
                           &mp.step.w2_rows, &mp.step.w3_rows, b2, sc.d1b,
                           sc.z1, sc.mv, sc.h2b, sc.dlb, sc.rl, sc.dz2f,
                           sc.dz2b, sc.dz1f, sc.dz1b, batch, a.inv_batch, rb,
                           NoStamps{});
      }
    }
    km_stamp(blk.stamps, s, KM_ROWS);
    if (!replica_sync(ra.err, barrier_gen(s, 2), s, blk.myf)) return;
    km_stamp(blk.stamps, s, KM_BAR2);

    // ---- 3. the gradients into the ring's buffers, the loss; the next
    // step's rows to bf16 on the threads the gradient phase leaves idle ----
    if (tid < GRAD_THREADS) {
      float* const g = blk.own;
      grads_tile(smem, gbars, ph, ph ? &mp.x_cols1 : &mp.step.x_cols,
                 &mp.step.d1_cols, &mp.step.dz1_rows, &mp.step.dz2_rows,
                 &mp.step.h2_rows, &mp.step.dl_rows, &mp.step.dz1_cols,
                 &mp.step.dz2_cols, blk.sc.rl, mine.losses + s, g, g + OFF_B1,
                 g + OFF_W2, g + OFF_B2, g + OFF_W3, batch, b,
                 StoreComm{g, blk.peer, blk.plo, blk.phi});
    } else if (s + 1 < a.nsteps) {
      constexpr int IDLE = THREADS - GRAD_THREADS;
      rows_to_bf16(x + (size_t)(s + 1) * step_px, xb + (ph ^ 1) * step_px,
                   tbl, chunks, b * IDLE + tid - GRAD_THREADS, BLOCKS * IDLE);
    }
    km_stamp(blk.stamps, s, KM_GRADS);
    // ---- the ring on this block's slice, then its update ----
    if (!ring_hops(ra, me, b, s)) return;
    if (!replica_sync(ra.err, barrier_gen(s, 3), s)) return;
    km_stamp(blk.stamps, s, KM_RING0 + ring_events(n, ra.rs) + 1);
  }
}

using RingMmaKernel = void (*)(const RingMmaLaunch, const RingMmaMaps);

RingMmaKernel pick(int rng) {
  static const RingMmaKernel table[3] = {ring_mma_kernel<RNG_MASKS>,
                                         ring_mma_kernel<RNG_THREEFRY>,
                                         ring_mma_kernel<RNG_PHILOX>};
  return table[rng];
}

// the co-resident blocks of the kernel of dropout source `rng` on this card
// (the cooperative occupancy query at THREADS and EPOCH_SMEM), or an error;
// queried once a kernel and device
cudaError_t coresident(int rng, int* blocks) {
  static int known[8][3];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 8 && known[dev][rng] > 0) {
    *blocks = known[dev][rng];
    return cudaSuccess;
  }
  const void* fn = reinterpret_cast<const void*>(pick(rng));
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(EPOCH_SMEM));
  int coop = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                        EPOCH_SMEM);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  *blocks = per_sm * sms;
  if (dev < 8) known[dev][rng] = *blocks;
  return cudaSuccess;
}

}  // namespace

extern "C" int pdmt_ring_mma_n_params() { return N_PARAMS; }

extern "C" int pdmt_ring_mma_table_fields() { return ring::TABLE_FIELDS; }

extern "C" int pdmt_ring_mma_max_batch() { return MAX_BATCH; }

extern "C" int pdmt_ring_mma_threads() { return THREADS; }

// the largest n this design runs
extern "C" int pdmt_ring_mma_max_replicas() { return MAX_N; }

// a replica's blocks: the gradient-tile owners
extern "C" int pdmt_ring_mma_blocks() { return BLOCKS; }

// the slice of the packed gradient that block b owns
extern "C" int pdmt_ring_mma_owner_lo(int b) { return owner_lo(b); }

extern "C" int pdmt_ring_mma_owner_len(int b) { return owner_len(b); }

extern "C" int pdmt_ring_mma_smem_bytes() {
  return static_cast<int>(EPOCH_SMEM);
}

// a replica's scratch at `batch`, in bytes (K2-mma's: the step's exchange,
// then two bf16 row buffers)
extern "C" int pdmt_ring_mma_scratch_bytes(int batch) {
  return static_cast<int>(epoch_scratch_bytes(batch));
}

// a replica's flag counters: its barrier, then per block the entry,
// the handshake from each side and one per hop
extern "C" int pdmt_ring_mma_flags_per_replica(int n, int rs) {
  return 1 + BLOCKS * flags_per_block(n, rs);
}

// the stamp words a step records in the stamps build (the used ones lead),
// and how many are used at (n, rs); 0 in the default build
extern "C" int pdmt_ring_mma_stamp_words() {
#ifdef K6M_STAMPS
  return KM_STAMP_WORDS;
#else
  return 0;
#endif
}

extern "C" int pdmt_ring_mma_stamps_used(int n, int rs) {
  return KM_RING0 + ring_events(n, rs) + 2;
}

extern "C" const char* pdmt_ring_mma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The blocks of K6-mma's kernel of dropout source rng that can be
// co-resident on this card, into *blocks.
extern "C" int pdmt_ring_mma_coresident(int rng, int* blocks) {
  if (rng < 0 || rng > 2) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(coresident(rng, blocks));
}

// K6-mma, one epoch on n = 1..pdmt_ring_mma_max_replicas() replicas:
// `table` is the device-resident (n,) ring::Replica table and `host_table`
// the same rows in host memory (x uint8, w and scratch 16-byte aligned;
// scratch of pdmt_ring_mma_scratch_bytes(batch) bytes; comm, recv as
// epoch_step.cu's ring; flags of pdmt_ring_mma_flags_per_replica(n, rs)
// counters zeroed in this stream; w the packed output), chunk_lo the device
// (n + 1,) chunk offsets for rs = 1 (else null), err_rec 4 zeroed ints, rng
// 0/1/2 = masks/threefry/philox (one form for every replica), nsteps steps
// of `batch` rows (1..128) per replica, lr, inv_n = f32(1/n), chunk_max the
// floats of a recv slot, timeout_ns the bound of every wait, fault a
// replica that never signals hop 0 (-1: none), pixel_table the (256,) bf16
// normalise table, stamps (nsteps, pdmt_ring_mma_stamp_words()) u64 in the
// stamps build (else ignored).
extern "C" int pdmt_ring_mma_step(
    const void* table, const void* host_table, const int* chunk_lo,
    int* err_rec, int n, int rs, int rng, uint32_t seed, int nsteps,
    int batch, float lr, float inv_batch, float inv_n, int chunk_max,
    unsigned long long timeout_ns, int fault, const void* pixel_table,
    unsigned long long* stamps, void* stream) {
  if (rng < 0 || rng > 2 || batch < 1 || batch > MAX_BATCH || nsteps < 1 ||
      n < 1 || n > MAX_N ||
      (rs && (n < 2 || chunk_lo == nullptr || chunk_max < 4 ||
              chunk_max % 4)) ||
      table == nullptr || host_table == nullptr || err_rec == nullptr ||
      pixel_table == nullptr ||
      (pdmt_ring_mma_stamp_words() > 0 && stamps == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const ring::Replica* reps = static_cast<const ring::Replica*>(host_table);
  RingMmaMaps maps;
  for (int r = 0; r < n; ++r) {
    unsigned char* scratch = reinterpret_cast<unsigned char*>(reps[r].scratch);
    if (!aligned16(reps[r].x) || !aligned16(reps[r].w) ||
        !aligned16(reps[r].in) || !aligned16(scratch))
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = epoch_maps(&maps.rep[r], scratch, reps[r].w, batch);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int slots = 0;
  const cudaError_t err = coresident(rng, &slots);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (slots < n * BLOCKS)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  RingMmaLaunch a{ring::RingArgs{static_cast<const ring::Replica*>(table),
                                 chunk_lo, ring::Err{err_rec, timeout_ns}, n,
                                 rs, N_PARAMS, chunk_max, fault, lr, inv_n},
                  static_cast<const uint16_t*>(pixel_table), nsteps, batch,
                  seed, inv_batch, stamps};
  void* args[] = {&a, &maps};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(pick(rng)), dim3(n * BLOCKS), dim3(THREADS),
      args, EPOCH_SMEM, static_cast<cudaStream_t>(stream)));
}
