// K2: one whole epoch of SGD for the reference MLP in ONE launch, with the
// weights carried from step to step inside the kernel; and K6, the same
// epoch on n data-parallel replicas with each step's gradient mean taken
// by a ring inside the launch (`ring_kernel`, below K2).
//
// Replaces the TPU kernel pytorch_ddp_mnist_tpu/ops/pallas_step.py
// `_make_epoch_kernel` in its single-replica forms, reached through
// `epoch_fused_sgd`:
//   K2a  rng="masks", f32 rows      pre-drawn (S*B, 128) masks are read
//   K2b  uint8_in=True              raw pixels, normalised in the kernel
//   K2c  rng="core"                 mask drawn in the kernel; the TPU core
//                                   PRNG becomes Philox4x32-10 keyed by
//                                   (epoch seed, step), counter row*128+col
//   K3   rng="threefry"             mask drawn in the kernel by jax's
//                                   threefry-2x32 from the step's key words,
//                                   bit for bit dropout_mask(step_key)
// each in f32 or in the bf16-operand mode (compute_bf16, K2-bf16: the cast
// points of K1-bf16, mlp_step.cuh; the weights are rounded from the f32
// master copy at every step and the update stays f32), and with K = 1, 2, 4
// or 8 steps per iteration (steps_per_iter, the superstep; see below).
// Per step s (rows s*B .. s*B+B-1 of the gathered epoch): forward, loss,
// backward, then `w -= lr * g` in place; the step's mean loss goes to
// losses[s]. The outputs start as a copy of the input weights, which are
// never written.
//
// What bounds it on an H100: at B = 128 each step is 64.9 MFLOP of f32
// multiply-adds (see fused_step.cu), so a 469-step epoch is 30.5 GFLOP,
// 0.455 ms at the 67 TFLOP/s f32 CUDA-core peak; its uint8 rows are 47 MB,
// 0.014 ms at 3.35 TB/s. Operations set the bound. In practice each step is
// a chain of dependent small products, so latency, not either peak, sets
// the time.
//
// Design, and what it does about the differences from the TPU:
//  * The TPU ran the steps as a sequential grid over one core, with the
//    weights resident in VMEM. Here one cooperative launch
//    (cudaLaunchCooperativeKernel) runs every step, and each step is two
//    phases, each ended by a grid-wide sync (cooperative_groups): (A) each
//    block takes ROWS_A batch rows and writes their activations, activation
//    gradients and losses to scratch, reading the weights that the previous
//    step wrote (mlp_step.cuh rows_block, K1's row math); (B) every weight
//    element sums its gradient over rows 0..B-1 in that order and updates
//    itself (`w -= lr*g`, the product rounded first, as in JAX), and one
//    thread sums the step's loss in row order. No float atomics: two
//    launches on the same inputs give the same bits.
//  * The weights (473,088 B) do not fit one block's 227 KB of shared memory.
//    They live in global memory and stay in the 50 MB L2; every load of a
//    weight or of scratch is ld.global.cg (L2, never a stale L1 line).
//  * The grid is the co-resident maximum (occupancy x SMs) cut to the work
//    there is: max(B / ROWS_A row groups, 65 gradient-tile pairs + 1). A
//    refused cooperative launch returns its error; nothing falls back.
//  * The 256-thread block runs phase B as two halves of 128 threads, each a
//    gradient tile; both halves take the same code path and barriers.
//  * Exact f32: built without --use_fast_math; true divisions in the uint8
//    normalise; the masks' 1/keep is the JAX form's own expression.
//  * The epoch's rows are gathered outside the kernel (torch indexing), as
//    JAX gathers them outside Pallas.
//  * Superstep K (steps_per_iter): the TPU kernel runs K SGD steps per grid
//    iteration to spread its fixed per-iteration cost. A cooperative launch
//    has no per-iteration pipeline to amortise; what K spreads here is the
//    rows' normalisation. With uint8 rows and K > 1, each iteration first
//    normalises the rows of its K steps into an f32 staging buffer with
//    every block of the grid (one grid sync), and the K steps' rows and
//    gw1 phases then read f32 from it: per step, the normalise work moves
//    from the 16 busy blocks of the rows phase (and again from the gw1
//    tiles) to all blocks, once. The staged value is pixel()'s, so the
//    math is bit for bit K = 1's. Steps at or past `valid_steps` (the
//    index-level padding of a ragged epoch) are skipped: no update, loss 0
//    (the TPU kernel runs them with lr 0; a skipped update is that update
//    exactly). Masks stay keyed by the global step, so K never changes them.
//
// K6 replaces the DP form of the same TPU kernel (`n_devices > 1`,
// pallas_step.py:662-799), reached through `epoch_fused_sgd(axis_size=n,
// ring=...)`. One cooperative launch runs all n replicas on one card: each
// is a group of G blocks with its own weights, rows, mask stream and
// buffers, running K2's step (the same template: rows, gradients, each
// phase ended by a barrier over the replica's blocks instead of a grid
// sync); the gradients are packed in the TPU's row layout, summed by the
// ring of dp_ring.cuh (all-gather with the fixed origin-order sum, or
// reduce-scatter + all-gather), and every replica applies
// `w -= lr * (sum * f32(1/n))`, so the replicas stay bitwise in lockstep.
// Masks: per-replica key tables (threefry), Philox keyed (epoch seed, step)
// at counter word 1 = the replica (core; replica 0 is K2c's stream), or
// per-replica mask arrays. What bounds it: n times K2's operations (n x
// 64.9 MFLOP a step at B = 128, 0.97 us per replica-step at 67 TFLOP/s)
// and the ring's stores (all-gather: n (n - 1) gradient blocks of 473 KB a
// step); like K2 it is latency-bound in practice. G is the co-resident
// maximum split n ways and cut to the work, so no replica ever waits on
// one that is not resident.
//
// Plain C interface for ctypes (ops/_build.py, ops/epoch_step.py): launches
// on the caller's stream, never synchronises, allocates nothing, and
// returns the CUDA error code (0 on success).

#include <algorithm>

#include <cooperative_groups.h>

#include "dp_ring.cuh"
#include "mlp_step.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace mlp;

constexpr int THREADS = THREADS_A;                   // 256
constexpr int HALVES = THREADS / TILE_THREADS;       // 2 gradient tiles at once
constexpr int TILE_PAIRS = (GRAD_TILES + HALVES - 1) / HALVES;  // 65
constexpr int N_LAYERS = 5;                          // w1, b1, w2, b2, w3

// the packed layout of the weights and of K6's gradient block: w1, b1, w2,
// b2, w3 one after the other (the TPU's _COMM_LAYOUT rows, with gw3's rows
// NC wide instead of padded to 128)
constexpr int OFF_B1 = IN * H1;
constexpr int OFF_W2 = OFF_B1 + H1;
constexpr int OFF_B2 = OFF_W2 + H1 * H2;
constexpr int OFF_W3 = OFF_B2 + H2;
constexpr int N_PARAMS = OFF_W3 + H2 * NC;           // 118,272

// What one replica's steps read and write.
struct StepIO {
  const int* y;         // (S*B,) labels
  const float* masks;   // (S*B, 128) pre-scaled masks      (RNG_MASKS)
  const int* keys;      // (S, 2) per-step key words         (RNG_THREEFRY)
  uint32_t seed;        // the epoch seed                    (RNG_PHILOX)
  uint32_t replica;     // Philox counter word 1: the ring replica (0 in K2)
  float* w[N_LAYERS];   // the weights the steps read (K2 also updates them)
  float* scratch;       // B * SCRATCH_PER_ROW floats
  float* losses;        // (S,)
  int batch;
  float lr;
  float inv_batch;
};

struct EpochArgs {
  const void* xp;       // (S*B, 784) f32 or uint8, the epoch's gathered rows
  const float* in[N_LAYERS];
  float* stage;         // K * B * 784 floats, or null: no staging
  int nsteps;           // S, a multiple of K
  int valid_steps;      // steps < valid_steps train; the rest are padding
  int steps_per_iter;   // K
  StepIO io;
};

template <int RNG>
__device__ StepMask<RNG> step_mask(const StepIO& io, int step) {
  if constexpr (RNG == RNG_MASKS) {
    return {io.masks + (size_t)step * io.batch * H1, 0u, 0u, 0u};
  } else if constexpr (RNG == RNG_THREEFRY) {
    return {nullptr, static_cast<uint32_t>(io.keys[2 * step]),
            static_cast<uint32_t>(io.keys[2 * step + 1]), 0u};
  } else {
    return {nullptr, io.seed, static_cast<uint32_t>(step), io.replica};
  }
}

// w[k][j] -= lr * g, the product rounded to f32 first (JAX's `w -= lr * g`;
// a fused multiply-add would round once and differ)
struct StoreSgd {
  float* w;
  int n;
  float lr;
  __device__ void operator()(int k, int j, float g) const {
    float* p = w + k * n + j;
    *p = __fsub_rn(__ldcg(p), __fmul_rn(lr, g));
  }
};

// g[k][j] = the gradient, into a packed block
struct StorePack {
  float* g;
  int n;
  __device__ void operator()(int k, int j, float v) const {
    __stcg(g + k * n + j, v);
  }
};

// Where the gradient phase puts layer p's gradient (p = 0..4: w1, b1, w2,
// b2, w3): K2 updates its weights in place, K6 packs it for the ring.
struct SgdSink {
  float* w1;
  float* b1;
  float* w2;
  float* b2;
  float* w3;
  float lr;
  __device__ StoreSgd at(int p, int n) const {
    return {p == 0 ? w1 : p == 1 ? b1 : p == 2 ? w2 : p == 3 ? b2 : w3, n, lr};
  }
};

struct PackSink {
  float* g;  // (N_PARAMS,)
  __device__ StorePack at(int p, int n) const {
    return {g + (p == 0   ? 0
                 : p == 1 ? OFF_B1
                 : p == 2 ? OFF_W2
                 : p == 3 ? OFF_B2
                          : OFF_W3),
            n};
  }
};

// K2's blocks: the whole grid, synchronised by grid syncs
struct GridGroup {
  cg::grid_group grid;
  __device__ int nblk() const { return gridDim.x; }
  __device__ int block() const { return blockIdx.x; }
  __device__ bool sync() {
    grid.sync();
    return true;
  }
};

// One training step at global step `step` on rows x (f32 staged rows, or
// the XT rows of the epoch) by the blocks of `grp`: phase A, a barrier,
// phase B (the gradients, each summed over the rows in order, go to
// `sink`), a barrier. False when a barrier failed (K6's bounded waits).
template <bool BF, int RNG, class XT, class Grp, class Sink>
__device__ bool train_step(const StepIO& io, Grp& grp, const Sink& sink,
                           float (*as)[BT][TK], int step, const XT* x) {
  const int nblk = grp.nblk();
  const int bid = grp.block();
  const int batch = io.batch;
  float* const w1 = io.w[0];
  float* const b1 = io.w[1];
  float* const w2 = io.w[2];
  float* const b2 = io.w[3];
  float* const w3 = io.w[4];
  float* const d1 = io.scratch;
  float* const h2 = d1 + (size_t)batch * H1;
  float* const dz2 = h2 + (size_t)batch * H2;
  float* const dz1 = dz2 + (size_t)batch * H2;
  float* const dl = dz1 + (size_t)batch * H1;
  float* const rl = dl + (size_t)batch * NC;
  const int* y = io.y + (size_t)step * batch;
  const int half = threadIdx.x / TILE_THREADS;
  const int lt = threadIdx.x % TILE_THREADS;
  const int bias_block = TILE_PAIRS % nblk;

  // ---- phase A: rows ----
  const StepMask<RNG> mask = step_mask<RNG>(io, step);
  for (int g = bid; g * ROWS_A < batch; g += nblk)
    rows_block<CgLoad, BF>(x, y, mask, w1, b1, w2, b2, w3, d1, h2, dz2, dz1,
                           dl, rl, g * ROWS_A, batch, io.inv_batch);
  if (!grp.sync()) return false;

  // ---- phase B: gradients summed in row order, into the sink ----
  for (int pair = bid; pair < TILE_PAIRS; pair += nblk) {
    const int t = pair * HALVES + half;
    const float* af = nullptr;
    const uint8_t* au = nullptr;
    const float* gsrc = nullptr;
    int lda = 0, ka = 0, n = 0, k0 = 0, layer = 0;
    if (t < GRAD_TILES) {
      const GradTile gt = grad_tile(t);
      k0 = gt.k0;
      if (gt.which == 0) {
        if constexpr (sizeof(XT) == 1)
          au = reinterpret_cast<const uint8_t*>(x);
        else
          af = reinterpret_cast<const float*>(x);
        lda = ka = IN;
        gsrc = dz1;
        n = H1;
        layer = 0;
      } else if (gt.which == 1) {
        af = d1;
        lda = ka = H1;
        gsrc = dz2;
        n = H2;
        layer = 2;
      } else {
        af = h2;
        lda = ka = H2;
        gsrc = dl;
        n = NC;
        layer = 4;
      }
    }
    at_g_tile<CgLoad, BF>(as[half], lt, af, au, nullptr, lda, ka, gsrc, n, k0,
                          batch, sink.at(layer, n));
  }
  if (bid == bias_block && threadIdx.x < H1) {
    // biases (of the unrounded dz1, dz2) and the step's mean loss, each
    // summed in row order
    const int j = threadIdx.x;
    float s1 = 0.f, s2 = 0.f;
    for (int b = 0; b < batch; ++b) {
      s1 += __ldcg(dz1 + (size_t)b * H1 + j);
      s2 += __ldcg(dz2 + (size_t)b * H2 + j);
    }
    sink.at(1, H1)(0, j, s1);
    sink.at(3, H2)(0, j, s2);
    if (j == 0) {
      float s = 0.f;
      for (int b = 0; b < batch; ++b) s += __ldcg(rl + b);
      io.losses[step] = s / (float)batch;
    }
  }
  return grp.sync();
}

template <class XT, int RNG, bool BF>
__global__ void __launch_bounds__(THREADS) epoch_kernel(EpochArgs a) {
  GridGroup grp{cg::this_grid()};
  const int nblk = gridDim.x;
  const int gtid = blockIdx.x * THREADS + threadIdx.x;
  const StepIO& io = a.io;
  const SgdSink sink{io.w[0], io.w[1], io.w[2], io.w[3], io.w[4], io.lr};

  // the TPU kernel's step-0 init: outputs start as a copy of the inputs
  for (int p = 0; p < N_LAYERS; ++p)
    for (int i = gtid; i < layer_size(p); i += nblk * THREADS)
      io.w[p][i] = a.in[p][i];
  grp.sync();

  __shared__ float as[HALVES][BT][TK];
  const int batch = io.batch;
  const int K = a.steps_per_iter;
  for (int base = 0; base < a.nsteps; base += K) {
    const int kv = min(K, a.valid_steps - base);  // steps of this iteration that train
    if (a.stage != nullptr && kv > 0) {
      // the iteration's rows, normalised once by the whole grid
      const XT* src = static_cast<const XT*>(a.xp) + (size_t)base * batch * IN;
      const size_t n = (size_t)kv * batch * IN;
      for (size_t i = gtid; i < n; i += (size_t)nblk * THREADS)
        a.stage[i] = pixel(src[i]);
      grp.sync();
    }
    for (int k = 0; k < K; ++k) {
      const int step = base + k;
      if (k >= kv) {  // index-level padding: no update, loss row 0
        if (blockIdx.x == 0 && threadIdx.x == 0) io.losses[step] = 0.f;
        continue;
      }
      if (a.stage != nullptr)
        train_step<BF, RNG>(io, grp, sink, as, step,
                            a.stage + (size_t)k * batch * IN);
      else
        train_step<BF, RNG>(
            io, grp, sink, as, step,
            static_cast<const XT*>(a.xp) + (size_t)step * batch * IN);
    }
  }
}

// K6: blocks [r*G, (r+1)*G) run replica r. Every step is K2's step with
// the gradients packed into the replica's comm buffer, then ring_step.
struct RingLaunch {
  ring::RingArgs ring;
  int G;
  int nsteps;
  int batch;
  uint32_t seed;
  float inv_batch;
};

template <class XT, int RNG, bool BF>
__global__ void __launch_bounds__(THREADS) ring_kernel(RingLaunch a) {
  const int me = blockIdx.x / a.G;
  const ring::Replica& rep = a.ring.reps[me];
  ring::ReplicaGroup grp{me, a.G, static_cast<int>(blockIdx.x) % a.G,
                         rep.flags + ring::F_BAR, 0u, -1, a.ring.err};
  const int t = grp.bid * THREADS + threadIdx.x;
  const int nt = a.G * THREADS;
  float* const w = rep.w;
  for (int i = t; i < N_PARAMS; i += nt) w[i] = rep.in[i];
  if (!grp.sync() || !ring::entry_barrier(a.ring, grp)) return;

  const StepIO io{rep.y, rep.masks, rep.keys, a.seed,
                  static_cast<uint32_t>(me),
                  {w, w + OFF_B1, w + OFF_W2, w + OFF_B2, w + OFF_W3},
                  rep.scratch, rep.losses, a.batch, a.ring.lr, a.inv_batch};
  // the replica's own gradient: its origin slot (all-gather) or its flat
  // buffer (reduce-scatter)
  const PackSink sink{rep.comm + (a.ring.rs ? 0 : (size_t)me * N_PARAMS)};
  __shared__ float as[HALVES][BT][TK];
  const XT* x = static_cast<const XT*>(rep.x);
  for (int step = 0; step < a.nsteps; ++step) {
    grp.step = step;
    if (!train_step<BF, RNG>(io, grp, sink, as, step,
                             x + (size_t)step * a.batch * IN) ||
        !ring::ring_step(a.ring, grp, step))
      return;
  }
}

// the mask block of one step, as the epoch kernel draws it (a debug entry:
// the card compares it bitwise with the plain version)
template <int RNG>
__global__ void mask_kernel(StepIO io, int step, float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < io.batch * H1) out[i] = step_mask<RNG>(io, step)(i / H1, i % H1);
}

using EpochKernel = void (*)(EpochArgs);
using RingKernel = void (*)(RingLaunch);

template <bool BF>
EpochKernel pick_epoch(int x_u8, int rng) {
  static const EpochKernel table[2][3] = {
      {epoch_kernel<float, RNG_MASKS, BF>, epoch_kernel<float, RNG_THREEFRY, BF>,
       epoch_kernel<float, RNG_PHILOX, BF>},
      {epoch_kernel<uint8_t, RNG_MASKS, BF>,
       epoch_kernel<uint8_t, RNG_THREEFRY, BF>,
       epoch_kernel<uint8_t, RNG_PHILOX, BF>}};
  return table[x_u8 ? 1 : 0][rng];
}

template <bool BF>
RingKernel pick_ring(int x_u8, int rng) {
  static const RingKernel table[2][3] = {
      {ring_kernel<float, RNG_MASKS, BF>, ring_kernel<float, RNG_THREEFRY, BF>,
       ring_kernel<float, RNG_PHILOX, BF>},
      {ring_kernel<uint8_t, RNG_MASKS, BF>,
       ring_kernel<uint8_t, RNG_THREEFRY, BF>,
       ring_kernel<uint8_t, RNG_PHILOX, BF>}};
  return table[x_u8 ? 1 : 0][rng];
}

// the co-resident blocks of `kernel` on this card (the cooperative
// occupancy query), or an error
cudaError_t coresident(const void* kernel, int* blocks) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, 0);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

// blocks one replica's step can keep busy: B / ROWS_A row groups, or every
// gradient tile pair plus the bias block
int work_blocks(int batch) { return std::max(batch / ROWS_A, TILE_PAIRS + 1); }

}  // namespace

extern "C" int pdmt_epoch_scratch_per_row() { return SCRATCH_PER_ROW; }

extern "C" int pdmt_epoch_n_params() { return N_PARAMS; }

// whether a launch with these arguments stages its rows (its caller
// allocates steps_per_iter * batch * 784 floats for it)
extern "C" int pdmt_epoch_stages(int x_u8, int steps_per_iter) {
  return x_u8 && steps_per_iter > 1;
}

extern "C" const char* pdmt_epoch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One epoch: xp (nsteps*batch, 784) f32 or uint8 (x_u8), yp (nsteps*batch,)
// int32, rng 0/1/2 = masks/threefry/philox with its source (masks, keys or
// seed), params in (w1, b1, w2, b2, w3) and out (same shapes, written),
// bf16 = the bf16-operand mode, steps_per_iter K (nsteps a multiple of K),
// valid_steps <= nsteps, scratch of batch * SCRATCH_PER_ROW floats, stage
// of K * batch * 784 floats where pdmt_epoch_stages says so (else null),
// losses (nsteps,), max_blocks a cap on the grid (0: none; the bits do not
// depend on it). Writes the grid size it launched to *grid_out.
extern "C" int pdmt_epoch_step(
    const void* xp, int x_u8, const int* yp, int rng, const float* masks,
    const int* keys, uint32_t seed, const float* w1, const float* b1,
    const float* w2, const float* b2, const float* w3, float* ow1, float* ob1,
    float* ow2, float* ob2, float* ow3, int bf16, int steps_per_iter,
    int valid_steps, float* scratch, float* stage, float* losses, int nsteps,
    int batch, float lr, float inv_batch, int max_blocks, int* grid_out,
    void* stream) {
  const int K = steps_per_iter;
  if (rng < 0 || rng > 2 || batch < ROWS_A || batch % ROWS_A != 0 ||
      nsteps < 1 || (K != 1 && K != 2 && K != 4 && K != 8) || nsteps % K ||
      valid_steps < 1 || valid_steps > nsteps || max_blocks < 0 ||
      (stage == nullptr) == (pdmt_epoch_stages(x_u8, K) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const EpochKernel kernel =
      bf16 ? pick_epoch<true>(x_u8, rng) : pick_epoch<false>(x_u8, rng);
  int blocks = 0;
  const cudaError_t err =
      coresident(reinterpret_cast<const void*>(kernel), &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  int grid = std::min(blocks, work_blocks(batch));
  if (max_blocks > 0) grid = std::min(grid, max_blocks);
  EpochArgs a{xp, {w1, b1, w2, b2, w3}, stage, nsteps, valid_steps, K,
              StepIO{yp, masks, keys, seed, 0u, {ow1, ob1, ow2, ob2, ow3},
                     scratch, losses, batch, lr, inv_batch}};
  void* args[] = {&a};
  *grid_out = grid;
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid), dim3(THREADS), args,
      0, static_cast<cudaStream_t>(stream)));
}

// The pointer table's row width and the flag counters a replica needs.
extern "C" int pdmt_ring_table_fields() { return ring::TABLE_FIELDS; }

extern "C" int pdmt_ring_flags_per_replica(int n, int rs) {
  return ring::F_HOP0 + (rs ? 2 : 1) * (n - 1);
}

// K6, one epoch on n replicas: `table` is the device-resident (n,)
// ring::Replica table (every buffer already allocated; flags zeroed in this
// stream), chunk_lo the device (n + 1,) chunk offsets for rs = 1 (else
// null), err_rec 4 zeroed ints, rng/x_u8/bf16 as in pdmt_epoch_step (one
// form for every replica), nsteps steps of `batch` rows per replica, lr,
// inv_n = f32(1/n), chunk_max the floats of a recv slot, timeout_ns the
// bound of every wait, fault a replica that never signals hop 0 (-1: none),
// max_blocks a cap on the blocks per replica (0: none). Writes the blocks
// per replica it launched to *group_out.
extern "C" int pdmt_ring_step(
    const void* table, const int* chunk_lo, int* err_rec, int n, int rs,
    int x_u8, int rng, int bf16, uint32_t seed, int nsteps, int batch,
    float lr, float inv_batch, float inv_n, int chunk_max,
    unsigned long long timeout_ns, int fault, int max_blocks, int* group_out,
    void* stream) {
  if (rng < 0 || rng > 2 || batch < ROWS_A || batch % ROWS_A != 0 ||
      nsteps < 1 || n < 1 || (rs && (n < 2 || chunk_lo == nullptr ||
                                     chunk_max < 4 || chunk_max % 4)) ||
      max_blocks < 0 || table == nullptr || err_rec == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const RingKernel kernel =
      bf16 ? pick_ring<true>(x_u8, rng) : pick_ring<false>(x_u8, rng);
  int blocks = 0;
  const cudaError_t err =
      coresident(reinterpret_cast<const void*>(kernel), &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  int G = std::min(blocks / n, work_blocks(batch));
  if (max_blocks > 0) G = std::min(G, max_blocks);
  if (G < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  RingLaunch a{ring::RingArgs{static_cast<const ring::Replica*>(table),
                              chunk_lo,
                              ring::Err{err_rec, timeout_ns},
                              n, rs, N_PARAMS, chunk_max, fault, lr, inv_n},
               G, nsteps, batch, seed, inv_batch};
  void* args[] = {&a};
  *group_out = G;
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(n * G), dim3(THREADS), args,
      0, static_cast<cudaStream_t>(stream)));
}

// The (batch, 128) mask the epoch kernel draws at `step` (rng 1 or 2) for
// replica `replica` (the Philox counter word; 0 is K2's stream).
extern "C" int pdmt_epoch_mask(int rng, const int* keys, uint32_t seed,
                               int step, int batch, uint32_t replica,
                               float* out, void* stream) {
  StepIO io{};
  io.keys = keys;
  io.seed = seed;
  io.replica = replica;
  io.batch = batch;
  const int n = batch * H1;
  const dim3 grid((n + 255) / 256), block(256);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rng == RNG_THREEFRY)
    mask_kernel<RNG_THREEFRY><<<grid, block, 0, s>>>(io, step, out);
  else if (rng == RNG_PHILOX)
    mask_kernel<RNG_PHILOX><<<grid, block, 0, s>>>(io, step, out);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
