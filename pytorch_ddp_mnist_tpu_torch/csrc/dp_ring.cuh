// K6's ring: the per-step data-parallel gradient mean of the DP epoch
// kernel, carried over from pytorch_ddp_mnist_tpu/ops/pallas_step.py
// `_make_epoch_kernel` (n_devices > 1): the entry barrier (:672-685), the
// per-step two-neighbour handshake (:687-700), the reduce-scatter +
// all-gather ring (:702-767) and the all-gather ring with its fixed-order
// sum (:768-799).
//
// On the TPU the replicas are chips that talk by remote DMA and
// semaphores. Here the n replicas are n groups of G thread blocks of one
// cooperative launch (epoch_step.cu `ring_kernel`), each with its own
// weights, rows, masks and buffers, and a replica reaches its neighbours
// only through the per-replica pointer table (`Replica`). A store into the
// neighbour's buffer plays the remote DMA; a flag counter plays each
// semaphore:
//   signal  every block of the sender stores its share, a block barrier,
//           then thread 0 fences (__threadfence, cumulative over what the
//           barrier ordered before it) and adds 1 to the receiver's flag
//           with red.release.gpu;
//   wait    thread 0 of every block of the receiver spins on ld.acquire.gpu
//           of its own flag until it reaches G * k (each of the sender's G
//           blocks has signalled it k times), then a block barrier; the
//           data is read with ld.global.cg (L1 is not coherent across SMs).
// Flags only grow within a launch (the wrapper zeroes them in the same
// stream before it), so a neighbour a step ahead is never taken for the
// current one. Replicas never synchronise as a whole grid: a grid sync
// would order the ring by itself and hide a fault in its protocol.
//
// Inside a replica, each phase of a step ends in a generation barrier over
// its G blocks (`ReplicaGroup::sync`: an integer counter that every block
// adds 1 to and waits on for G * k). Integer atomics only; gradients are
// never summed with atomics.
//
// Every wait is bounded: past `timeout_ns` on %globaltimer it writes the
// launch's error record (what, replica, step, hop) and its block leaves
// the kernel; every other waiter sees the record and leaves too, and the
// wrapper raises the record by name. A machine with several cards would
// fill the table with peer pointers and use `.sys` in place of `.gpu`.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace ring {

// a replica's flag counters: its barrier, the entry barrier, the handshake
// from the left and from the right neighbour, then one per hop
enum Flag : int { F_BAR = 0, F_ENTRY = 1, F_LREADY = 2, F_RREADY = 3,
                  F_HOP0 = 4 };
// what a timed-out wait was for: word 0 of the error record
enum Wait : int { W_BARRIER = 1, W_ENTRY = 2, W_HANDSHAKE = 3, W_HOP = 4 };

// One replica's buffers: a row of the pointer table the wrapper builds
// (TABLE_FIELDS pointers, in this order).
struct Replica {
  const void* x;       // (S*B, 784) f32 or uint8: this replica's rows
  const int* y;        // (S*B,) labels
  const float* masks;  // (S*B, 128) pre-scaled masks, or null
  const int* keys;     // (S, 2) threefry key words, or null
  const float* in;     // (P,) input weights, packed w1|b1|w2|b2|w3
  float* w;            // (P,) the replica's weights, updated every step
  float* scratch;      // B * SCRATCH_PER_ROW floats
  float* losses;       // (S,) the replica's per-step mean losses
  float* comm;         // all-gather: (n, P) origin slots; reduce-scatter: (P,)
  float* recv;         // reduce-scatter: (n - 1, chunk_max); else null
  unsigned* flags;     // F_HOP0 + hops counters
};
constexpr int TABLE_FIELDS = 11;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void add_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// the launch's error record (4 ints: what, replica, step, hop; what = 0
// while nothing failed) and the bound of every wait
struct Err {
  int* rec;
  uint64_t timeout_ns;
};

// Thread 0 of a block: spin until *flag >= target. False when the bound
// passed (this waiter writes the record unless another one did first) or
// when another waiter has failed.
__device__ __noinline__ bool spin_geq(const unsigned* flag, unsigned target,
                                      const Err& e, int what, int replica,
                                      int step, int hop) {
  if (ld_acquire(flag) >= target) return true;
  const uint64_t t0 = now_ns();
  for (unsigned i = 1;; ++i) {
    if (ld_acquire(flag) >= target) return true;
    if ((i & 255u) == 0) {
      if (*reinterpret_cast<volatile int*>(e.rec) != 0) return false;
      if (now_ns() - t0 > e.timeout_ns) {
        if (atomicCAS(e.rec, 0, what) == 0) {
          e.rec[1] = replica;
          e.rec[2] = step;
          e.rec[3] = hop;
        }
        return false;
      }
    }
  }
}

// Every thread of a block: wait until *flag >= target. False (in every
// thread) when the wait failed; the caller leaves the kernel.
__device__ __forceinline__ bool block_wait(const unsigned* flag,
                                           unsigned target, const Err& e,
                                           int what, int replica, int step,
                                           int hop) {
  int ok = 1;
  if (threadIdx.x == 0) ok = spin_geq(flag, target, e, what, replica, step, hop);
  return __syncthreads_and(ok) != 0;
}

// Every thread of a block: make the block's stores visible, then add 1 to
// each non-null flag. Only thread `by` fences, after the barrier (as a
// grid sync does), so the other threads go on at once.
__device__ __forceinline__ void block_signal(unsigned* f0,
                                             unsigned* f1 = nullptr,
                                             unsigned by = 0) {
  __syncthreads();
  if (threadIdx.x == by) {
    __threadfence();
    add_release(f0, 1u);
    if (f1 != nullptr) add_release(f1, 1u);
  }
}

// The G blocks of one replica: the counterpart, for K6, of K2's grid.
struct ReplicaGroup {
  int replica;     // this block's replica
  int G;           // blocks per replica
  int bid;         // this block's index within the replica
  unsigned* bar;   // the replica's F_BAR counter
  unsigned gen;    // barriers passed so far
  int step;        // the step being run, for the error record
  Err err;
  __device__ int nblk() const { return G; }
  __device__ int block() const { return bid; }
  // the generation barrier over the replica's G blocks
  __device__ bool sync() {
    ++gen;
    __syncthreads();
    int ok = 1;
    if (threadIdx.x == 0) {
      __threadfence();
      add_release(bar, 1u);
      ok = spin_geq(bar, gen * static_cast<unsigned>(G), err, W_BARRIER,
                    replica, step, -1);
    }
    return __syncthreads_and(ok) != 0;
  }
};

// f32 element-wise ops with round-to-nearest and no contraction
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// w - lr * (g * inv_n): the mean is the sum times f32(1/n), then JAX's
// `w -= lr * g`, each product rounded to f32 first
__device__ __forceinline__ float sgd1(float w, float g, float lr, float inv_n) {
  return __fsub_rn(w, __fmul_rn(lr, __fmul_rn(g, inv_n)));
}

__device__ __forceinline__ float4 sgd4(float4 w, float4 g, float lr,
                                       float inv_n) {
  return make_float4(sgd1(w.x, g.x, lr, inv_n), sgd1(w.y, g.y, lr, inv_n),
                     sgd1(w.z, g.z, lr, inv_n), sgd1(w.w, g.w, lr, inv_n));
}

// This thread's share of a chunk of `len` floats (a multiple of 4): the
// float4 elements t, t + nt, ... of it. Every operation on one chunk in a
// step uses the same share, so a thread re-reads only what it wrote itself
// or what arrived behind a flag.
__device__ __forceinline__ void copy_share(float* dst, const float* src,
                                           int len, int t, int nt) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int i = t; i < len / 4; i += nt) __stcg(d + i, __ldcg(s + i));
}

// acc[i] = acc[i] + in[i]: the local partial plus the incoming one
__device__ __forceinline__ void add_share(float* acc, const float* in, int len,
                                          int t, int nt) {
  float4* a = reinterpret_cast<float4*>(acc);
  const float4* b = reinterpret_cast<const float4*>(in);
  for (int i = t; i < len / 4; i += nt) __stcg(a + i, add4(__ldcg(a + i), __ldcg(b + i)));
}

// w[i] = w - lr * (g[i] * inv_n)
__device__ __forceinline__ void sgd_share(float* w, const float* g, int len,
                                          float lr, float inv_n, int t,
                                          int nt) {
  float4* pw = reinterpret_cast<float4*>(w);
  const float4* pg = reinterpret_cast<const float4*>(g);
  for (int i = t; i < len / 4; i += nt)
    __stcg(pw + i, sgd4(__ldcg(pw + i), __ldcg(pg + i), lr, inv_n));
}

// What the ring needs besides the table.
struct RingArgs {
  const Replica* reps;    // (n,) the pointer table, in device memory
  const int* chunk_lo;    // reduce-scatter: (n + 1,) chunk offsets in floats
  Err err;
  int n;                  // replicas
  int rs;                 // 1: reduce-scatter + all-gather; 0: all-gather
  int P;                  // floats in the packed gradient (118,272)
  int chunk_max;          // floats in a recv slot (reduce-scatter)
  int fault;              // a replica that never signals hop 0 (a test of
                          // the bounded wait), or -1
  float lr;
  float inv_n;            // f32(1/n)
};

// The entry barrier: each block tells both neighbours that it runs, then
// waits for both neighbours' G blocks (the TPU kernel's barrier semaphore).
__device__ __forceinline__ bool entry_barrier(const RingArgs& a,
                                              const ReplicaGroup& g) {
  const int me = g.replica;
  const int left = (me + a.n - 1) % a.n, right = (me + 1) % a.n;
  block_signal(a.reps[left].flags + F_ENTRY, a.reps[right].flags + F_ENTRY);
  return block_wait(a.reps[me].flags + F_ENTRY, 2u * g.G, a.err, W_ENTRY, me,
                    -1, -1);
}

// One step's mean gradient and update, after the replica has packed its
// gradient into its comm buffer and passed a replica barrier: the
// handshake, the ring's hops, then w -= lr * (sum * inv_n) on this
// replica's weights, then a replica barrier. False when a wait failed.
__device__ bool ring_step(const RingArgs& a, ReplicaGroup& g, int step) {
  const int n = a.n, me = g.replica, G = g.G;
  const int left = (me + n - 1) % n, right = (me + 1) % n;
  const Replica& mine = a.reps[me];
  const Replica& rt = a.reps[right];
  unsigned* const flags = mine.flags;
  const unsigned done = static_cast<unsigned>(G) * (step + 1);
  const int t = g.bid * blockDim.x + threadIdx.x;
  const int nt = G * blockDim.x;

  // the per-step handshake: my hop-0 store overwrites buffers of `right`
  // that its previous step read last, so no hop starts before both
  // neighbours have finished that step
  block_signal(rt.flags + F_LREADY, a.reps[left].flags + F_RREADY);
  if (!block_wait(flags + F_LREADY, done, a.err, W_HANDSHAKE, me, step, -1) ||
      !block_wait(flags + F_RREADY, done, a.err, W_HANDSHAKE, me, step, -1))
    return false;

  const auto hop_done = [&](int h) {
    return block_wait(flags + F_HOP0 + h, done, a.err, W_HOP, me, step, h);
  };
  // the test hook: replica `a.fault` never signals hop 0 and leaves the
  // launch there, so the one wait that times out is its neighbour's wait
  // for that hop (a wait of its own would race it to the error record)
  const auto signal_hop = [&](int h) {
    if (me == a.fault && h == 0) return false;
    block_signal(rt.flags + F_HOP0 + h);
    return true;
  };

  if (!a.rs) {
    // all-gather: hop h forwards origin slot (me - h) mod n, which arrived
    // at hop h - 1 (hop 0: my own), into the same slot of `right`
    for (int h = 0; h < n - 1; ++h) {
      if (h > 0 && !hop_done(h - 1)) return false;
      const int s = (me - h + n) % n;
      copy_share(rt.comm + (size_t)s * a.P, mine.comm + (size_t)s * a.P, a.P,
                 t, nt);
      if (!signal_hop(h)) return false;
    }
    if (n > 1 && !hop_done(n - 2)) return false;
    // the fixed origin-order sum: tot = g0; tot = tot + g1; ... on every
    // replica alike, so the weights stay bitwise in lockstep
    const float4* slot = reinterpret_cast<const float4*>(mine.comm);
    float4* w = reinterpret_cast<float4*>(mine.w);
    const int P4 = a.P / 4;
    for (int i = t; i < P4; i += nt) {
      float4 tot = __ldcg(slot + i);
      for (int d = 1; d < n; ++d) tot = add4(tot, __ldcg(slot + (size_t)d * P4 + i));
      __stcg(w + i, sgd4(__ldcg(w + i), tot, a.lr, a.inv_n));
    }
  } else {
    const auto lo = [&](int c) { return a.chunk_lo[c]; };
    const auto len = [&](int c) { return a.chunk_lo[c + 1] - a.chunk_lo[c]; };
    // reduce-scatter: hop h sends partial chunk (me - h) into recv slot h
    // of `right`, then folds the arriving chunk (me - h - 1) into mine:
    // chunk c is s = g_c; s = g_{c+1} + s; ... along one chain that ends
    // at replica (c - 1) mod n
    for (int h = 0; h < n - 1; ++h) {
      const int sc = (me - h + n) % n;
      copy_share(rt.recv + (size_t)h * a.chunk_max, mine.comm + lo(sc),
                 len(sc), t, nt);
      if (!signal_hop(h)) return false;
      if (!hop_done(h)) return false;
      const int ac = (me - h - 1 + 2 * n) % n;
      add_share(mine.comm + lo(ac), mine.recv + (size_t)h * a.chunk_max,
                len(ac), t, nt);
    }
    // all-gather of the reduced chunks: hop k forwards chunk (me + 1 - k),
    // finished here at hop k - 1 (hop 0: the one this replica reduced),
    // into the same place of `right`
    for (int k = 0; k < n - 1; ++k) {
      if (k > 0 && !hop_done(n - 1 + k - 1)) return false;
      const int sc = (me + 1 - k + n) % n;
      copy_share(rt.comm + lo(sc), mine.comm + lo(sc), len(sc), t, nt);
      if (!signal_hop(n - 1 + k)) return false;
    }
    if (!hop_done(2 * n - 3)) return false;
    for (int c = 0; c < n; ++c)
      sgd_share(mine.w + lo(c), mine.comm + lo(c), len(c), a.lr, a.inv_n, t,
                nt);
  }
  return g.sync();
}

}  // namespace ring
