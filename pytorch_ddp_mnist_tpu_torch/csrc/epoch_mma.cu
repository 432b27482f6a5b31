// K2-mma: the whole-epoch kernel (K2) redesigned on the tensor-core step,
// in the bf16 forms the resident-dataset trainer and the bench launch:
// uint8 rows, compute_bf16, dropout from pre-drawn masks (K2b), in-kernel
// Philox (K2c) or in-kernel threefry (K3), any superstep K, ragged epochs,
// at batches up to MAX_BATCH rows. One cooperative launch runs the epoch.
//
// Replaces the TPU kernel pytorch_ddp_mnist_tpu/ops/pallas_step.py
// `_make_epoch_kernel` (:433) in its single-replica bf16 forms
// (`compute_bf16` :517, products :600-660, superstep :505-514 and :555),
// reached through `epoch_fused_sgd` (:812). ops/epoch_step.py
// `epoch_design` sends uint8 rows in the bf16 mode at B <= MAX_BATCH here;
// the rows design (epoch_step.cu) keeps f32 rows, larger batches and
// K6-bf16.
//
// What bounds it on an H100: at B = 128 a step's six products are 64.9
// MFLOP of bf16 MMAs, a 469-step epoch 30.5 GFLOP: 0.0308 ms at the 989
// TFLOP/s bf16 tensor-core peak; its uint8 rows are 47 MB, 0.014 ms at
// 3.35 TB/s. Operations set the bound. In practice a step is K1-mma's
// three dependent phases with a grid barrier after each, so latency sets
// the time.
//
// The design: per step s, the three phases of mma_step.cuh (the bodies
// K1-mma launches one at a time) on one grid of max(16 B/16, 66) blocks of
// THREADS threads, the hidden phase's block; the warps a phase does not
// use go straight to its barrier:
//  1. hidden: blocks < 16 B/16 run hidden_tile on step s's bf16 rows with
//     the epoch's mask of step s (StepMask: the step's pre-drawn rows,
//     threefry under the step's key words, or Philox keyed (epoch seed,
//     step) at counter row*128 + col); every block rounds its share of w2
//     and w3 into bf16 scratch. Grid barrier.
//  2. rows: blocks < B/16 run rows_tile (its 4 warps); the other blocks
//     convert step s+1's uint8 rows to bf16 through a 256-entry table
//     (normalise, then round to nearest even; the wrapper builds it) into
//     the other half of a double-buffered (2, B, 784) bf16 scratch. Step
//     0's rows are converted before the loop. Grid barrier.
//  3. grads: blocks < 66 run grads_tile (4 warps) with SGD folded in:
//     each gradient element is applied as w = w - lr * g in place of being
//     written out, and the loss mean goes to losses[s]. Grid barrier: the
//     next step reads the updated f32 weights.
// Steps at or past valid_steps are skipped: no update, loss 0. The
// superstep K changes only the loop's structure: no rows are staged (the
// conversion already runs once a step), so every K gives K = 1's bits, and
// the kernel takes no K at all.
//
// The bitwise contract: every output element is made by the same MMA
// sequence and f32 operations as in K1-mma (the same device functions),
// and the update is JAX's `w -= lr * g` with the product rounded first. So
// an epoch is bitwise K1-mma + SGD per step on the same rows, masks and
// weights, and a repeat launch gives the same bits. No float atomics.
//
// What one launch has to do that K1-mma's kernel boundaries did for it:
//  * The async proxy. The tensor copies read w1, the bf16 w2 and w3, the
//    bf16 rows and the exchange through the async proxy; generic stores
//    write them (SGD, round_w23, the rows phase, the conversion). Every
//    thread issues `fence.proxy.async` after its stores, before each grid
//    barrier, and the thread that issues the copies one after it (which
//    also orders the copies after the generic shared-memory accesses of
//    the phase before).
//  * The barriers' phases. The mbarriers are initialised once a launch,
//    and each completes once a step, so step s waits on parity s & 1.
//  * Shared memory. The phases overlay one dynamic allocation, the largest
//    of theirs, and keep their barriers after it.
//  * Stale L1. Every load of a weight or of the exchange is ld.global.cg.
//  * Co-residency. The grid is checked against the cooperative occupancy
//    at this block size and shared memory, and cudaLaunchCooperativeKernel
//    refuses a grid that is not co-resident. Nothing falls back.
//
// Build macro: EMMA_STAMPS, a debug build that records %globaltimer at
// every phase and barrier boundary of every step (ops/epoch_step.py
// `mma_epoch_phase_stamps`); the default build has none of that code.
//
// Plain C interface for ctypes (ops/_build.py, ops/epoch_step.py): launches
// on the caller's stream, never synchronises, allocates nothing, and
// returns the CUDA error code (0 on success).

#include <algorithm>
#include <cstdint>

#include <cooperative_groups.h>

#include "mma_step.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace mma_step;

// the block: the widest phase's (hidden_tile, a warp a k chunk)
constexpr int THREADS = 224;
// rows a step
constexpr int MAX_BATCH = 128;
// the grid: UNIT_BLOCKS hidden tiles a 16-row group, or GRADS_BLOCKS (the
// gradient tiles and bias quarters), whichever is more
constexpr int UNIT_BLOCKS = 16;
constexpr int GRADS_BLOCKS = 66;
static_assert(THREADS == HIDDEN_THREADS && THREADS >= ROWS_THREADS &&
                  THREADS >= GRAD_THREADS && MAX_BATCH == B_MAX &&
                  UNIT_BLOCKS == UNIT_GROUPS && GRADS_BLOCKS == GRAD_BLOCKS &&
                  HR == RR,
              "the phases' geometry (mma_step.cuh)");

// shared memory: the phases' overlaid region, then their barriers
constexpr size_t SMEM_BYTES = EPOCH_SMEM;

// The boundaries a step records in the stamps build: block 0's thread 0
// after a grid barrier, or the last block to end a phase (atomicMax).
enum Stamp : int {
  ST_START,   // the step begins (block 0)
  ST_HIDDEN,  // the last block's hidden phase and w2, w3 rounding done
  ST_BAR1,    // grid barrier 1 passed (block 0)
  ST_ROWS,    // the last block's rows phase or conversion done
  ST_BAR2,    // grid barrier 2 passed (block 0)
  ST_GRADS,   // the last block's gradients and SGD done
  ST_BAR3,    // grid barrier 3 passed (block 0): the step's end
  N_STAMPS
};

struct EmmaArgs {
  const uint8_t* x;        // (S*B, 784) the epoch's gathered rows
  const int* y;            // (S*B,)
  const float* masks;      // (S*B, 128) pre-scaled      (RNG_MASKS)
  const int* keys;         // (S, 2) per-step key words  (RNG_THREEFRY)
  uint32_t seed;           // epoch seed                 (RNG_PHILOX)
  const float* in[5];      // w1, b1, w2, b2, w3 (never written)
  float* w[5];             // the same shapes: out, updated in place
  const uint16_t* table;   // (256,) bf16 bits of normalise(v)
  bf16* xb;                // (2, B, 784) the bf16 rows, double-buffered
  unsigned char* scratch;  // scratch_bytes(B): the step's exchange
  float* losses;           // (S,)
  unsigned long long* stamps;  // (S, N_STAMPS) or null
  int nsteps;
  int valid_steps;
  int batch;
  float lr;
  float inv_batch;
};

template <int RNG>
__device__ __forceinline__ StepMask<RNG> step_mask(const EmmaArgs& a, int s) {
  if constexpr (RNG == RNG_MASKS) {
    return {a.masks + (size_t)s * a.batch * H1, 0u, 0u, 0u};
  } else if constexpr (RNG == RNG_THREEFRY) {
    return {nullptr, static_cast<uint32_t>(a.keys[2 * s]),
            static_cast<uint32_t>(a.keys[2 * s + 1]), 0u};
  } else {
    return {nullptr, a.seed, static_cast<uint32_t>(s), 0u};
  }
}

__device__ __forceinline__ void stamp0(const EmmaArgs& a, int s, int at) {
#ifdef EMMA_STAMPS
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
    a.stamps[(size_t)s * N_STAMPS + at] = t;
  }
#endif
}

__device__ __forceinline__ void stamp_last(const EmmaArgs& a, int s, int at) {
#ifdef EMMA_STAMPS
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
    atomicMax(a.stamps + (size_t)s * N_STAMPS + at, t);
  }
#endif
}

// orders this thread's generic accesses before its later async-proxy ones
// (tensor copies) and hands its generic stores to other threads' copies
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async;" ::: "memory");
}

__device__ __forceinline__ void grid_barrier(cg::grid_group& grid) {
  proxy_fence();
  grid.sync();
  if (threadIdx.x == 0) proxy_fence();  // every phase's copies issue here
}

template <int RNG>
__global__ void __launch_bounds__(THREADS) emma_kernel(
    const __grid_constant__ EmmaArgs a, const __grid_constant__ EpochMaps mp) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint16_t tbl[256];
  uint64_t* const hbars = reinterpret_cast<uint64_t*>(smem + EPOCH_DATA);
  uint64_t* const rbars = hbars + NKC;
  uint64_t* const gbars = rbars + NWC;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, blk = blockIdx.x, nblk = gridDim.x;
  const int gtid = blk * THREADS + tid, nthr = nblk * THREADS;
  const int batch = a.batch;
  const int groups = (batch + HR - 1) / HR;  // 16-row groups
  const int chunks = batch * IN / 16;        // 16-pixel chunks of a step
  const size_t step_px = (size_t)batch * IN;
  const StepScratch sc = carve(a.scratch, batch);
  float* const w1 = a.w[0];
  float* const b1 = a.w[1];
  float* const w2 = a.w[2];
  float* const b2 = a.w[3];
  float* const w3 = a.w[4];

  // the TPU kernel's step-0 init: the outputs start as a copy of the
  // inputs; step 0's rows to bf16
  for (int i = tid; i < 256; i += THREADS) tbl[i] = a.table[i];
  for (int p = 0; p < 5; ++p)
    for (int i = gtid; i < layer_size(p); i += nthr) a.w[p][i] = a.in[p][i];
  bars_init(hbars, EPOCH_BARS);  // and the table is in
  rows_to_bf16(a.x, a.xb, tbl, chunks, gtid, nthr);
  grid_barrier(grid);

  for (int s = 0; s < a.valid_steps; ++s) {
    const uint32_t ph = s & 1;  // the rows' buffer and the barriers' parity
    stamp0(a, s, ST_START);
    // ---- 1. z1, the mask, d1; w2 and w3 to bf16 ----
    if (blk < UNIT_BLOCKS * groups)
      hidden_tile(smem, hbars, ph, ph ? &mp.x_rows1 : &mp.step.x_rows,
                  step_mask<RNG>(a, s), &mp.step.w1_cols, b1, w2, w3, sc.w2b,
                  sc.w3b, sc.d1b, sc.z1, sc.mv, batch, blk % UNIT_BLOCKS,
                  blk / UNIT_BLOCKS, gtid, nthr);
    else
      round_w23(w2, w3, sc.w2b, sc.w3b, gtid, nthr);
    stamp_last(a, s, ST_HIDDEN);
    grid_barrier(grid);
    stamp0(a, s, ST_BAR1);

    // ---- 2. the rest of each row; the next step's rows to bf16 ----
    if (blk < groups) {
      if (tid < ROWS_THREADS)
        rows_tile<THREADS>(smem, rbars, ph, a.y + (size_t)s * batch,
                           &mp.step.w2_rows, &mp.step.w3_rows, b2, sc.d1b,
                           sc.z1, sc.mv, sc.h2b, sc.dlb, sc.rl, sc.dz2f,
                           sc.dz2b, sc.dz1f, sc.dz1b, batch, a.inv_batch, blk,
                           NoStamps{});
    } else if (s + 1 < a.valid_steps) {
      rows_to_bf16(a.x + (size_t)(s + 1) * step_px, a.xb + (ph ^ 1) * step_px,
                   tbl, chunks, (blk - groups) * THREADS + tid,
                   (nblk - groups) * THREADS);
    }
    stamp_last(a, s, ST_ROWS);
    grid_barrier(grid);
    stamp0(a, s, ST_BAR2);

    // ---- 3. the gradients into SGD in place; the loss ----
    if (blk < GRADS_BLOCKS && tid < GRAD_THREADS)
      grads_tile(smem, gbars, ph, ph ? &mp.x_cols1 : &mp.step.x_cols,
                 &mp.step.d1_cols, &mp.step.dz1_rows, &mp.step.dz2_rows,
                 &mp.step.h2_rows, &mp.step.dl_rows, &mp.step.dz1_cols,
                 &mp.step.dz2_cols, sc.rl, a.losses + s, w1, b1, w2, b2, w3,
                 batch, blk, StoreSgd{a.lr});
    stamp_last(a, s, ST_GRADS);
    grid_barrier(grid);
    stamp0(a, s, ST_BAR3);
  }

  // the padded steps of a ragged epoch
  if (blk == 0)
    for (int s = a.valid_steps + tid; s < a.nsteps; s += THREADS)
      a.losses[s] = 0.f;
}

using EmmaKernel = void (*)(const EmmaArgs, const EpochMaps);

EmmaKernel pick(int rng) {
  static const EmmaKernel table[3] = {emma_kernel<RNG_MASKS>,
                                      emma_kernel<RNG_THREEFRY>,
                                      emma_kernel<RNG_PHILOX>};
  return table[rng];
}

int grid_blocks(int batch) {
  return std::max(UNIT_BLOCKS * ((batch + HR - 1) / HR), GRADS_BLOCKS);
}

}  // namespace

extern "C" int pdmt_emma_max_batch() { return MAX_BATCH; }

extern "C" int pdmt_emma_threads() { return THREADS; }

// the blocks a launch at `batch` runs (0 for a batch it refuses)
extern "C" int pdmt_emma_blocks(int batch) {
  return batch < 1 || batch > MAX_BATCH ? 0 : grid_blocks(batch);
}

extern "C" int pdmt_emma_smem_bytes() { return static_cast<int>(SMEM_BYTES); }

// the scratch a launch at `batch` takes, in bytes: the step's exchange
// (mma_step.cuh scratch_bytes), then the two bf16 row buffers
extern "C" int pdmt_emma_scratch_bytes(int batch) {
  return static_cast<int>(epoch_scratch_bytes(batch));
}

// the stamp words a step records in the stamps build (N_STAMPS
// %globaltimer stamps), 0 in the default build
extern "C" int pdmt_emma_stamps_per_step() {
#ifdef EMMA_STAMPS
  return N_STAMPS;
#else
  return 0;
#endif
}

extern "C" const char* pdmt_emma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One epoch: x (nsteps*batch, 784) uint8, y (nsteps*batch,) int32, rng
// 0/1/2 = masks/threefry/philox with its source (masks, keys or seed),
// params in (w1, b1, w2, b2, w3) and out (same shapes, written), table the
// (256,) bf16 normalise table, valid_steps <= nsteps, scratch of
// pdmt_emma_scratch_bytes(batch) bytes, losses (nsteps,), stamps (nsteps,
// pdmt_emma_stamps_per_step()) u64, zeroed, in the stamps build (else
// ignored). x, ow1 and scratch 16-byte aligned; 1 <= batch <=
// pdmt_emma_max_batch(). Writes the grid it launched to *grid_out.
extern "C" int pdmt_emma_epoch(
    const void* x, const int* y, int rng, const float* masks,
    const int* keys, uint32_t seed, const float* w1, const float* b1,
    const float* w2, const float* b2, const float* w3, float* ow1, float* ob1,
    float* ow2, float* ob2, float* ow3, const void* table, int valid_steps,
    unsigned char* scratch, float* losses, unsigned long long* stamps,
    int nsteps, int batch, float lr, float inv_batch, int* grid_out,
    void* stream) {
  if (rng < 0 || rng > 2 || batch < 1 || batch > MAX_BATCH || nsteps < 1 ||
      valid_steps < 1 || valid_steps > nsteps || table == nullptr ||
      (rng == RNG_MASKS && masks == nullptr) ||
      (rng == RNG_THREEFRY && keys == nullptr) || !aligned16(x) ||
      !aligned16(ow1) || !aligned16(scratch) ||
      (pdmt_emma_stamps_per_step() > 0 && stamps == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = reinterpret_cast<const void*>(pick(rng));
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                        SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  const int grid = grid_blocks(batch);
  if (per_sm * sms < grid)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  bf16* const xb = epoch_rows(scratch, batch);
  EpochMaps mp;
  err = epoch_maps(&mp, scratch, ow1, batch);
  if (err != cudaSuccess) return static_cast<int>(err);
  EmmaArgs a{static_cast<const uint8_t*>(x), y, masks, keys, seed,
             {w1, b1, w2, b2, w3}, {ow1, ob1, ow2, ob2, ow3},
             static_cast<const uint16_t*>(table), xb, scratch, losses, stamps,
             nsteps, valid_steps, batch, lr, inv_batch};
  void* args[] = {&a, &mp};
  *grid_out = grid;
  return static_cast<int>(cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(THREADS), args, SMEM_BYTES,
      static_cast<cudaStream_t>(stream)));
}
