// K6-ws: the DP epoch kernel (K6) redesigned for Hopper in the forms the
// main path launches: uint8 rows, f32, dropout from pre-drawn masks (K2b),
// in-kernel Philox (K2c) or in-kernel threefry (K3), B <= 128 rows a
// replica, the all-gather ring and the reduce-scatter + all-gather ring,
// n = 1..4 replicas on one card.
//
// Replaces the TPU kernel pytorch_ddp_mnist_tpu/ops/pallas_step.py
// `_make_epoch_kernel` with n_devices > 1 (:662-799) in those forms,
// reached through `epoch_fused_sgd(axis_size=n, ring=...)`. The rows
// design (epoch_step.cu `ring_kernel` + dp_ring.cuh) keeps the f32-row and
// bf16 forms, B > 128 and n > 4; ops/epoch_step.py `ring_design` picks.
//
// Each replica is G = 128 / COLS blocks running K2-ws's step (ws_step.cuh):
// block g of replica r owns hidden units j = g*COLS .. g*COLS + COLS - 1
// and holds their weights in shared memory for the epoch. Every block must
// be resident at one block an SM, so COLS grows with n: n <= 2 at COLS = 2
// (G = 64), n = 3, 4 at COLS = 4 (G = 32); COLS = 8 (n = 5..8) does not
// fit in shared memory beside the per-lane table and stays on the rows
// design. The launch checks n * G against the cooperative occupancy.
//
// The ring: one mini-ring per column owner. Block g of replica r owns the
// packed-gradient elements of its units, 924 runs of COLS floats in the
// unchanged layout w1|b1|w2|b2|w3 (its COLS-wide slice of each of the 784
// rows of w1, b1[j], its COLS rows of w2, b2[j], its COLS rows of w3); it
// exchanges only those, and only with block g of its neighbours, through
// per-(replica, block) flag counters in the replica's flag array (after
// the replica barrier's counter: entry, handshake from the left and the
// right, one per hop). So the G mini-rings run concurrently, with no
// replica-wide barrier between the gradients and hop 0, nor between the
// last hop and the update. The trees are dp_ring.cuh's, element by
// element:
//   all-gather      hop h sends origin slot (r - h) mod n to the same slot
//                   of the right neighbour; then tot = g0; tot = tot + g1;
//                   ... in origin order;
//   reduce-scatter  an element's chunk is the one its packed offset falls
//                   in (rs_chunk_bounds); hop h sends partial chunk
//                   (r - h) into recv slot h of the right neighbour and
//                   folds the arriving chunk (r - h - 1) in as local +
//                   incoming, then n - 1 hops broadcast the finished
//                   chunks. A run of COLS floats never straddles a chunk
//                   bound (bounds are multiples of 4).
// Then w = w - lr * (tot * f32(1/n)) (dp_ring.cuh sgd1) on the block's
// shared-memory weights, in place. So the replicas stay bitwise in
// lockstep, and the result is bitwise the rows design's ring: the same
// per-replica gradients (K1's bits), the same trees, the same update.
//
// What changes from K2-ws's step, because the weights update with the
// ring's mean and not the replica's own gradient: every block computes
// gw3 (the same chains, so the same bits) but sends only its COLS rows;
// after the ring it writes its updated rows of w3 to a replica buffer (two,
// by step parity), which every block of the replica copies into its own w3
// after the next step's first barrier (phase 3 reads w3 first). The w2 row
// update, and the transposed copy the next step's z2 reads, come after the
// ring; dz2 and dd1 still read the pre-update w3 and w2, as in K2-ws.
//
// Kept from dp_ring.cuh: the entry barrier and the per-step two-neighbour
// handshake (now per block: my hop-0 store overwrites buffers of block g
// on my right that its previous step read last), release/acquire flags,
// ld.global.cg / st.global.cg for everything a neighbour writes or reads,
// the bounded waits with the launch's error record, and the test hook of a
// replica that never signals hop 0. Flags only grow within a launch.
//
// What bounds it: n times K2's operations (n x 64.9 MFLOP a step at B =
// 128) and the ring's stores, as epoch_step.cu's K6; latency-bound in
// practice.
//
// Build macro: K6_STAMPS, a debug build that records %globaltimer at the
// phase boundaries of block 0 of replica 0 (step start, z1, barrier 1, z2,
// barrier 2, the gradients, the handshake, each hop's copy, wait and add,
// the end of the update).
//
// Plain C interface for ctypes (ops/_build.py, ops/epoch_step.py): launches
// on the caller's stream, never synchronises, allocates nothing, and
// returns the CUDA error code (0 on success).

#include <cstdint>

#include "dp_ring.cuh"
#include "ws_step.cuh"

namespace {

using namespace ws;

// the packed layout of the weights and of the gradient (epoch_step.cu's)
constexpr int OFF_B1 = IN * H1;
constexpr int OFF_W2 = OFF_B1 + H1;
constexpr int OFF_B2 = OFF_W2 + H1 * H2;
constexpr int OFF_W3 = OFF_B2 + H2;
constexpr int N_PARAMS = OFF_W3 + H2 * NC;  // 118,272

// a block's elements of the packed gradient, in runs ("units") of COLS
// floats: 784 of w1, 1 of b1, 128 of w2, 1 of b2, 10 of w3
constexpr int UNITS = IN + 1 + H2 + 1 + NC;           // 924
constexpr int UPT = (UNITS + THREADS - 1) / THREADS;  // units a thread
constexpr int MAX_N = 4;  // replicas whose COLS fits beside the table

// COLS at n replicas: the least of 2, 4, 8 with n * (128 / COLS) <= 128
__host__ __device__ constexpr int cols_for(int n) {
  return n <= 2 ? 2 : n <= 4 ? 4 : n <= 8 ? 8 : 0;
}
static_assert(Shape<cols_for(1)>::FITS && Shape<cols_for(MAX_N)>::FITS &&
                  !Shape<cols_for(MAX_N + 1)>::FITS,
              "MAX_N is the last n whose COLS fits");

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

// the stamps of a step (K6_STAMPS): KS_START .. KS_RING0 - 1, then one per
// ring event (hop 0's signal; all-gather: each hop's wait and load, and
// store and signal; reduce-scatter: each hop's wait and add, and store and
// signal, then the broadcast hops' waits and loads, and stores and
// signals), then the end of the update
enum K6Stamp : int { KS_START, KS_Z1, KS_BAR1, KS_Z2, KS_BAR2, KS_GRADS,
                     KS_RING0 };
constexpr int K6_STAMP_WORDS = 24;
__host__ __device__ constexpr int ring_events(int n, int rs) {
  return (rs ? 4 : 2) * (n - 1);
}
static_assert(KS_RING0 + ring_events(MAX_N, 1) + 1 <= K6_STAMP_WORDS,
              "stamp words of a step");

struct RingWsLaunch {
  ring::RingArgs ring;
  int G;                 // blocks per replica
  int nsteps;
  int batch;
  uint32_t seed;
  float inv_batch;
  unsigned long long* stamps;  // (S, K6_STAMP_WORDS) in the stamps build
};

__device__ __forceinline__ void k6_stamp(unsigned long long* stamps, int step,
                                         int slot) {
#ifdef K6_STAMPS
  if (stamps != nullptr && threadIdx.x == 0) {
    unsigned long long t;  // "memory": not moved across the barriers
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
    stamps[(size_t)step * K6_STAMP_WORDS + slot] = t;
  }
#endif
}

// one unit (C floats, 8- or 16-byte aligned) through L2
template <int C>
__device__ __forceinline__ void ld_unit(const float* p, float (&v)[C]) {
  if constexpr (C == 2) {
    const float2 t = __ldcg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    static_assert(C == 4, "units of 2 or 4 floats");
    const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
}

template <int C>
__device__ __forceinline__ void st_unit(float* p, const float (&v)[C]) {
  if constexpr (C == 2)
    __stcg(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  else
    __stcg(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

// the packed offset of unit u of the block owning units j0 ..
template <int C>
__device__ __forceinline__ int unit_off(int u, int j0) {
  if (u < IN) return u * H1 + j0;
  if (u == IN) return OFF_B1 + j0;
  if (u < IN + 1 + H2) return OFF_W2 + j0 * H2 + (u - IN - 1) * C;
  if (u == IN + 1 + H2) return OFF_B2 + j0;
  return OFF_W3 + j0 * NC + (u - IN - 2 - H2) * C;
}

// K6-ws's side of ws_step: replica barriers, its stamps, the handshake's
// wait, and each gradient element this block owns written to its ring
// buffer and, for hop 0, straight into the right neighbour's: all-gather,
// every element into origin slot `me` there; reduce-scatter, the elements
// of chunk `me` into recv slot 0 there (the handshake's wait comes first).
// What a block's steps and ring read besides the kernel's arguments, held
// in shared memory so that the step's chains keep the registers (at COLS =
// 4 they need nearly all of them).
struct BlockCtx {
  StepIO io;
  float* comm;        // the block's gradient: origin slot, or the flat buffer
  float* peer;        // hop 0's destination, indexed by packed offset
  int plo, phi;       // the packed offsets hop 0 sends
  float* w3x;         // (2, H2 * NC) the replica's updated w3, by parity
  float* losses;
  unsigned long long* stamps;  // replica 0's block 0, else null
  unsigned* myf;      // this block's flag counters
  unsigned* rtf;      // block g's of the right neighbour
  unsigned* ltf;      // and of the left
  float* my_comm;     // the replica's comm, recv; the right neighbour's
  float* my_recv;
  float* rt_comm;
  float* rt_recv;
  float* wout;        // the replica's packed weights out
  int hs_ok;          // the handshake's wait succeeded
};

// one per block; the kernel's thread 0 fills it
__shared__ BlockCtx blk;

template <int C>
struct RingCtx {
  ring::ReplicaGroup& grp;
  const Smem& sm;
  BlockCtx& b;
  int me;
  int j0;
  bool first;         // block 0 of its replica

  __device__ bool sync() { return grp.sync(); }
  __device__ void stamp(int step, int at) const {
    const int slot = at == ST_Z1     ? KS_Z1
                     : at == ST_BAR1 ? KS_BAR1
                     : at == ST_Z2   ? KS_Z2
                     : at == ST_BAR2 ? KS_BAR2
                     : at == ST_GW1  ? KS_GRADS
                                     : -1;
    if (slot >= 0) k6_stamp(b.stamps, step, slot);
  }
  __device__ void stamp_gw3(int, const float (&)[NC]) const {}
  // the previous step's w3, updated by its row owners after their rings
  __device__ void after_bar1(int step, const Smem& s) const {
    if (step == 0) return;
    const float* src = b.w3x + ((step - 1) & 1) * (H2 * NC);
    for (int i = threadIdx.x; i < H2 * NC; i += THREADS)
      s.w3s[w3i(i / NC, i % NC)] = __ldcg(src + i);
  }
  // the handshake, second half, while the z2 chains run: both neighbours'
  // blocks g are done with step - 1 before this block's first store into
  // their buffers (phase 3)
  __device__ void idle_z2(int step) const {
    if (threadIdx.x != HALF) return;
    const unsigned done = static_cast<unsigned>(step) + 1u;
    b.hs_ok = ring::spin_geq(b.myf + BF_LREADY, done, grp.err,
                             ring::W_HANDSHAKE, me, step, -1) &&
              ring::spin_geq(b.myf + BF_RREADY, done, grp.err,
                             ring::W_HANDSHAKE, me, step, -1);
  }
  __device__ bool ok() const { return b.hs_ok != 0; }
  __device__ void put(int off, float v) const {
    __stcg(b.comm + off, v);
    if (off >= b.plo && off < b.phi) __stcg(b.peer + off, v);
  }
  __device__ void w3(int k, const float (&g3)[NC]) const {
    if (k >= j0 && k < j0 + C) {
#pragma unroll
      for (int c = 0; c < NC; ++c) put(OFF_W3 + k * NC + c, g3[c]);
    }
  }
  __device__ void b2(int c, float s) const { put(OFF_B2 + j0 + c, s); }
  __device__ void loss(int step, float v) const {
    if (first) b.losses[step] = v;
  }
  __device__ void w2row(int i, const float (&g2)[C]) const {
#pragma unroll
    for (int c = 0; c < C; ++c) put(OFF_W2 + (j0 + c) * H2 + i, g2[c]);
  }
  __device__ void w1(int t, const float (&acc)[C][4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v[C];
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = acc[c][e];
      const int off = (4 * t + e) * H1 + j0;  // one unit: in one chunk
      st_unit<C>(b.comm + off, v);
      if (off >= b.plo && off < b.phi) st_unit<C>(b.peer + off, v);
    }
  }
  __device__ void b1(int c, float s) const { put(OFF_B1 + j0 + c, s); }
};

// w = w - lr * (g * inv_n) on unit u's weights in shared memory; a w2 row
// also into the transposed copy, w3 rows into the replica's w3 buffer of
// this step and the output
template <int C>
__device__ __forceinline__ void apply_unit(const Smem& sm, int u,
                                           const float (&g)[C], float lr,
                                           float inv_n, float* w2t,
                                           float* w3x, float* w3out, int j0) {
  if (u < IN) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      sm.w1c[c * IN + u] = ring::sgd1(sm.w1c[c * IN + u], g[c], lr, inv_n);
  } else if (u == IN || u == IN + 1 + H2) {
    float* b = sm.bias + (u == IN ? 0 : C);
#pragma unroll
    for (int c = 0; c < C; ++c) b[c] = ring::sgd1(b[c], g[c], lr, inv_n);
  } else if (u < IN + 1 + H2) {
    const int e = (u - IN - 1) * C;
    const int r = e / H2, i = e - r * H2;  // C divides H2: one row
#pragma unroll
    for (int v = 0; v < C; ++v) {
      const float w = ring::sgd1(sm.w2r[r * H2 + i + v], g[v], lr, inv_n);
      sm.w2r[r * H2 + i + v] = w;
      __stcg(w2t + (i + v) * H1 + j0 + r, w);
    }
  } else {
    const int e = (u - IN - 2 - H2) * C;
#pragma unroll
    for (int v = 0; v < C; ++v) {
      const int k = j0 + (e + v) / NC, c = (e + v) % NC;
      const float w = ring::sgd1(sm.w3s[w3i(k, c)], g[v], lr, inv_n);
      __stcg(w3x + k * NC + c, w);
      __stcg(w3out + k * NC + c, w);
    }
  }
}

// One step's ring on the block's units, after ws_step: the hops, then the
// update of the block's weights from the mean. False when the block must
// leave the launch (a failed wait, or the test hook). Kept out of line, so
// that its registers are allocated apart from the step's chains.
template <int C>
__device__ __noinline__ bool ring_hops(const ring::RingArgs ra, int me, int j0,
                                       int step) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve<C>(smem_raw);
  BlockCtx& b = blk;
  const int n = ra.n, P = ra.P;
  const unsigned done = static_cast<unsigned>(step) + 1u;
  int slot = KS_RING0;
  const auto mark = [&](int at) { k6_stamp(b.stamps, step, at); };
  const float lr = ra.lr, inv_n = ra.inv_n;
  float* const my_comm = b.my_comm;
  float* const rt_comm = b.rt_comm;
  unsigned* const myf = b.myf;
  unsigned* const rtf = b.rtf;
  // this thread's units of the block's elements: packed offset (-1:
  // none) and, for the reduce-scatter ring, chunk (recomputed each step,
  // not held across it)
  int uoff[UPT], uch[UPT];
#pragma unroll
  for (int m = 0; m < UPT; ++m) {
    const int u = threadIdx.x + m * THREADS;
    uoff[m] = u < UNITS ? unit_off<C>(u, j0) : -1;
    uch[m] = 0;
    if (ra.rs && uoff[m] >= 0)
      while (uoff[m] >= __ldg(ra.chunk_lo + uch[m] + 1)) ++uch[m];
  }
  // Hop 0 carries what the gradient phase stored (every thread's), so it
  // is signalled for the block: a barrier, then thread 0's fence and
  // flag. Every later hop carries only the units a thread holds itself,
  // the same units on both sides (u = t + 256 m), so thread t signals
  // thread t of the neighbour's block g on a flag of its own (red.release
  // after its stores) and waits on its own (ld.acquire): no block barrier
  // between hops. A thread keeps its units' values in registers from hop
  // to hop, and loads only what arrives. A failed wait skips the rest; the
  // barrier at the end makes the exit uniform.
  bool ok = true;
  const auto wait_hop = [&](int h) {
    if (ok)
      ok = ring::spin_geq(h == 0 ? myf + BF_HOP0
                                 : myf + BF_THREAD + (h - 1) * THREADS +
                                       threadIdx.x,
                          done, ra.err, ring::W_HOP, me, step, h);
    return ok;
  };
  const auto signal_hop = [&](int h) {
    if (h == 0) {
      // the test hook: replica `fault` never signals hop 0 and leaves the
      // launch there, so the one wait that times out is its neighbour's
      if (me == ra.fault) return false;
      ring::block_signal(rtf + BF_HOP0);
    } else {
      ring::add_release(rtf + BF_THREAD + (h - 1) * THREADS + threadIdx.x,
                        1u);
    }
    mark(slot++);
    return true;
  };
  const auto in_chunk = [&](int m, int chunk) {
    return uoff[m] >= 0 && (chunk < 0 || uch[m] == chunk);
  };
  // this thread's units of `chunk` (-1: all) from src into v / from v to
  // dst, every load issued before the first use
  const auto load = [&](float (&v)[UPT][C], const float* src, int chunk) {
    if (!ok) return;
#pragma unroll
    for (int m = 0; m < UPT; ++m)
      if (in_chunk(m, chunk)) ld_unit<C>(src + uoff[m], v[m]);
  };
  const auto store = [&](float* dst, const float (&v)[UPT][C], int chunk) {
#pragma unroll
    for (int m = 0; m < UPT; ++m)
      if (in_chunk(m, chunk)) st_unit<C>(dst + uoff[m], v[m]);
  };
  const auto apply = [&](int m, const float (&tot)[C]) {
    apply_unit<C>(sm, threadIdx.x + m * THREADS, tot, lr, inv_n, b.io.w2t,
                  b.w3x + (step & 1) * (H2 * NC), b.wout + OFF_W3, j0);
  };
  // hop 0 first (thread 0's fence then waits for the gradient phase's
  // stores only), then the block's own gradient of this thread's units
  // (the step's last barrier made the hooks' stores visible to the block)
  if (n > 1 && !signal_hop(0)) return false;
  float own[UPT][C];
  load(own, b.comm, -1);
  if (!ra.rs) {
    // all-gather: hop 0 is my own slot, stored into `right` by the
    // gradient phase; hop h forwards origin slot (me - h) mod n, which
    // arrived at hop h - 1, into the same slot of `right`; rv[h] holds
    // slot (me - h - 1) mod n
    float rv[MAX_N - 1][UPT][C];
#pragma unroll
    for (int h = 0; h < MAX_N - 1; ++h) {
      if (h >= n - 1) break;
      wait_hop(h);
      const size_t sl = (size_t)((me - h - 1 + n) % n) * P;
      load(rv[h], my_comm + sl, -1);
      mark(slot++);
      if (h + 1 < n - 1) {
        store(rt_comm + sl, rv[h], -1);
        signal_hop(h + 1);
      }
    }
    // the fixed origin-order sum: tot = g0; tot = tot + g1; ...
    if (ok) {
#pragma unroll
      for (int m = 0; m < UPT; ++m) {
        if (uoff[m] < 0) continue;
        float tot[C];
#pragma unroll
        for (int d = 0; d < MAX_N; ++d) {
          if (d >= n) break;
          const int h = (me - d + n) % n;  // 0: mine, else rv[h - 1]
#pragma unroll
          for (int c = 0; c < C; ++c) {
            float x = own[m][c];
#pragma unroll
            for (int r = 1; r < MAX_N; ++r)
              if (h == r) x = rv[r - 1][m][c];
            tot[c] = d == 0 ? x : __fadd_rn(tot[c], x);
          }
        }
        apply(m, tot);
      }
    }
  } else {
    const int* lo = ra.chunk_lo;
    const size_t cmax = ra.chunk_max;
    // reduce-scatter: hop 0 is chunk `me` of my gradient, stored into recv
    // slot 0 of `right` by the gradient phase; at hop h the arriving
    // partial of chunk (me - h - 1) is folded in as local + incoming, and
    // sent on at hop h + 1
    for (int h = 0; h < n - 1; ++h) {
      wait_hop(h);
      const int ac = (me - h - 1 + 2 * n) % n;
      float inc[UPT][C];
      load(inc, b.my_recv + h * cmax - __ldg(lo + ac), ac);
#pragma unroll
      for (int m = 0; m < UPT; ++m)
        if (in_chunk(m, ac)) {
#pragma unroll
          for (int c = 0; c < C; ++c)
            own[m][c] = __fadd_rn(own[m][c], inc[m][c]);
        }
      mark(slot++);
      if (h + 1 < n - 1) {
        store(b.rt_recv + (h + 1) * cmax - __ldg(lo + ac), own, ac);
        signal_hop(h + 1);
      }
    }
    // all-gather of the reduced chunks: hop k forwards chunk (me + 1 -
    // k), finished here at hop k - 1 (hop 0: the one this replica
    // reduced), into the same place of `right`
    for (int k = 0; k < n - 1; ++k) {
      const int sc = (me + 1 - k + n) % n;
      if (k > 0) {
        wait_hop(n - 1 + k - 1);
        load(own, my_comm, sc);
        mark(slot++);
      }
      store(rt_comm, own, sc);
      signal_hop(n - 1 + k);
    }
    wait_hop(2 * n - 3);
    load(own, my_comm, (me + 2) % n);
    mark(slot++);
    if (ok) {
#pragma unroll
      for (int m = 0; m < UPT; ++m)
        if (uoff[m] >= 0) apply(m, own[m]);
    }
  }
  // the block's weights settled before the next step; a failed wait
  // anywhere in the block ends it
  if (!__syncthreads_and(ok)) return false;
  mark(slot);
  return true;
}

template <int C, int RNG>
__global__ void __launch_bounds__(THREADS, 1) ring_ws_kernel(RingWsLaunch a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BlockCtx& b = blk;
  const Smem sm = carve<C>(smem_raw);
  const ring::RingArgs& ra = a.ring;
  const int n = ra.n, G = a.G, P = ra.P;
  const int me = blockIdx.x / G, g = blockIdx.x % G, j0 = g * C;
  const ring::Replica& mine = ra.reps[me];
  if (threadIdx.x == 0) {
    const ring::Replica& rt = ra.reps[(me + 1) % n];
    const int fpb = flags_per_block(n, ra.rs);
    b.myf = mine.flags + 1 + g * fpb;
    b.rtf = rt.flags + 1 + g * fpb;
    b.ltf = ra.reps[(me + n - 1) % n].flags + 1 + g * fpb;
    const int batch = a.batch;
    float* const d1x = mine.scratch;
    float* const h2x = d1x + (size_t)batch * H1;
    float* const w2t = h2x + (size_t)batch * H2;  // w2 transposed
    b.w3x = w2t + H1 * H2;                        // (2, H2 * NC)
    b.io = StepIO{static_cast<const uint8_t*>(mine.x), mine.y,
                  MaskSrc{mine.masks, mine.keys, a.seed,
                          static_cast<uint32_t>(me), batch},
                  d1x, h2x, w2t, batch, a.inv_batch};
    b.my_comm = mine.comm;
    b.my_recv = mine.recv;
    b.rt_comm = rt.comm;
    b.rt_recv = rt.recv;
    b.wout = mine.w;
    b.losses = mine.losses;
    b.stamps = blockIdx.x == 0 ? a.stamps : nullptr;
    b.comm = mine.comm + (ra.rs ? 0 : (size_t)me * P);
    // hop 0's destination: all of origin slot `me` on the right
    // (all-gather), or chunk `me` of recv slot 0 there (reduce-scatter);
    // none at n = 1
    b.plo = ra.rs ? __ldg(ra.chunk_lo + me) : 0;
    b.phi = n == 1 ? 0 : ra.rs ? __ldg(ra.chunk_lo + me + 1) : P;
    b.peer = ra.rs ? rt.recv - b.plo : rt.comm + (size_t)me * P;
    b.hs_ok = 1;
  }
  __syncthreads();
  ring::ReplicaGroup grp{me, G, g, mine.flags, 0u, -1, ra.err};
  {
    const float* const in = mine.in;
    load_weights<C>(sm, in, in + OFF_B1, in + OFF_W2, in + OFF_B2,
                    in + OFF_W3, b.io.w2t, j0);
  }
  __syncthreads();
  // the entry barrier: tell block g of both neighbours that this one runs,
  // then wait for both of theirs
  ring::block_signal(b.ltf + BF_ENTRY, b.rtf + BF_ENTRY);
  if (!ring::block_wait(b.myf + BF_ENTRY, 2u, ra.err, ring::W_ENTRY, me, -1,
                        -1))
    return;

  RingCtx<C> ctx{grp, sm, b, me, j0, g == 0};
  for (int step = 0; step < a.nsteps; ++step) {
    grp.step = step;
    k6_stamp(b.stamps, step, KS_START);
    // the handshake, first half: this block is done with step - 1, so its
    // neighbours' blocks g may overwrite what it read last (the second
    // half is RingCtx::idle_z2). The last thread fences and signals: it
    // draws masks while thread 0 runs row 0's z1 chain.
    ring::block_signal(b.rtf + BF_LREADY, b.ltf + BF_RREADY, THREADS - 1);
    if (!ws_step<C, RNG>(b.io, ctx, sm, j0, step)) return;
    if (!ring_hops<C>(ra, me, j0, step)) return;
  }
  store_weights<C>(sm, b.wout, b.wout + OFF_B1, b.wout + OFF_W2,
                   b.wout + OFF_B2, nullptr, j0);
}

using RingWsKernel = void (*)(RingWsLaunch);

template <int C>
RingWsKernel pick(int rng) {
  static const RingWsKernel table[3] = {ring_ws_kernel<C, RNG_MASKS>,
                                        ring_ws_kernel<C, RNG_THREEFRY>,
                                        ring_ws_kernel<C, RNG_PHILOX>};
  return table[rng];
}

size_t smem_for(int cols) {
  return cols == 2 ? Shape<2>::SMEM_BYTES : Shape<4>::SMEM_BYTES;
}

// the co-resident blocks of `fn` at `smem` bytes a block on this card
// (the cooperative occupancy query), or an error
cudaError_t coresident(const void* fn, size_t smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                        smem);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

}  // namespace

extern "C" int pdmt_ring_ws_n_params() { return N_PARAMS; }

extern "C" int pdmt_ring_ws_table_fields() { return ring::TABLE_FIELDS; }

extern "C" int pdmt_ring_ws_max_batch() { return B_MAX; }

// the largest n this design runs (its COLS fits in shared memory)
extern "C" int pdmt_ring_ws_max_replicas() { return MAX_N; }

// COLS at n replicas (2, 4 or 8; 0 past 8), built or not
extern "C" int pdmt_ring_ws_cols(int n) { return n < 1 ? 0 : cols_for(n); }

// the shared memory a block takes at n replicas, or -1 past 8
extern "C" int pdmt_ring_ws_smem_bytes(int n) {
  const int cols = pdmt_ring_ws_cols(n);
  return cols == 2   ? static_cast<int>(Shape<2>::SMEM_BYTES)
         : cols == 4 ? static_cast<int>(Shape<4>::SMEM_BYTES)
         : cols == 8 ? static_cast<int>(Shape<8>::SMEM_BYTES)
                     : -1;
}

// a replica's flag counters: its barrier, then per block the entry, the
// handshake from each side and one per hop
extern "C" int pdmt_ring_ws_flags_per_replica(int n, int rs) {
  return 1 + (H1 / cols_for(n)) * flags_per_block(n, rs);
}

// a replica's scratch in floats: d1, h2 (batch x 128 each), w2 transposed
// (128 x 128), two copies of w3 (by step parity)
extern "C" int pdmt_ring_ws_scratch_floats(int batch) {
  return 2 * batch * H1 + H1 * H2 + 2 * H2 * NC;
}

// the stamp words a step records in the stamps build (the used ones lead),
// and how many are used at (n, rs); 0 in the default build
extern "C" int pdmt_ring_ws_stamp_words() {
#ifdef K6_STAMPS
  return K6_STAMP_WORDS;
#else
  return 0;
#endif
}

extern "C" int pdmt_ring_ws_stamps_used(int n, int rs) {
  return KS_RING0 + ring_events(n, rs) + 1;
}

extern "C" const char* pdmt_ring_ws_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The blocks of K6-ws at n replicas (1..pdmt_ring_ws_max_replicas()) and
// dropout source rng that can be co-resident on this card, into *blocks.
extern "C" int pdmt_ring_ws_coresident(int n, int rng, int* blocks) {
  if (n < 1 || n > MAX_N || rng < 0 || rng > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cols = cols_for(n);
  const RingWsKernel kernel = cols == 2 ? pick<2>(rng) : pick<4>(rng);
  return static_cast<int>(coresident(reinterpret_cast<const void*>(kernel),
                                     smem_for(cols), blocks));
}

// K6-ws, one epoch on n = 1..pdmt_ring_ws_max_replicas() replicas:
// `table` is the device-resident (n,) ring::Replica table (x uint8 and
// 16-byte aligned, comm, recv as epoch_step.cu's ring, scratch of
// pdmt_ring_ws_scratch_floats(batch) floats, flags of
// pdmt_ring_ws_flags_per_replica(n, rs) counters zeroed in this stream, w
// the packed output), chunk_lo the device (n + 1,) chunk offsets for rs = 1
// (else null), err_rec 4 zeroed ints, rng 0/1/2 = masks/threefry/philox
// (one form for every replica), nsteps steps of `batch` rows (a multiple
// of 4, at most 128) per replica, lr, inv_n = f32(1/n), chunk_max the
// floats of a recv slot, timeout_ns the bound of every wait, fault a
// replica that never signals hop 0 (-1: none), stamps (nsteps,
// pdmt_ring_ws_stamp_words()) u64 in the stamps build (else ignored).
// Writes the blocks per replica and COLS it launched to *group_out and
// *cols_out.
extern "C" int pdmt_ring_ws_step(
    const void* table, const int* chunk_lo, int* err_rec, int n, int rs,
    int rng, uint32_t seed, int nsteps, int batch, float lr, float inv_batch,
    float inv_n, int chunk_max, unsigned long long timeout_ns, int fault,
    unsigned long long* stamps, int* group_out, int* cols_out, void* stream) {
  if (rng < 0 || rng > 2 || batch < 4 || batch > B_MAX || batch % 4 ||
      nsteps < 1 || n < 1 || n > MAX_N ||
      (rs && (n < 2 || chunk_lo == nullptr || chunk_max < 4 ||
              chunk_max % 4)) ||
      table == nullptr || err_rec == nullptr ||
      (pdmt_ring_ws_stamp_words() > 0 && stamps == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cols = cols_for(n), G = H1 / cols;
  const RingWsKernel kernel = cols == 2 ? pick<2>(rng) : pick<4>(rng);
  const size_t smem = smem_for(cols);
  const void* fn = reinterpret_cast<const void*>(kernel);
  // the occupancy query (and the shared-memory attribute it sets) once a
  // kernel and device: the answer does not change between launches
  static int known[8][2][3];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int uncached = 0;
  int& blocks = dev < 8 ? known[dev][cols == 4][rng] : uncached;
  if (blocks == 0) {
    err = coresident(fn, smem, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (blocks < n * G)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  RingWsLaunch a{ring::RingArgs{static_cast<const ring::Replica*>(table),
                                chunk_lo, ring::Err{err_rec, timeout_ns}, n,
                                rs, N_PARAMS, chunk_max, fault, lr, inv_n},
                 G, nsteps, batch, seed, inv_batch, stamps};
  void* args[] = {&a};
  *group_out = G;
  *cols_out = cols;
  return static_cast<int>(cudaLaunchCooperativeKernel(
      fn, dim3(n * G), dim3(THREADS), args, smem,
      static_cast<cudaStream_t>(stream)));
}
