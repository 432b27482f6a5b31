// K2-ws: the whole-epoch kernel (K2) redesigned for Hopper in the forms the
// main path launches: uint8 rows, f32, dropout from pre-drawn masks (K2b),
// in-kernel Philox (K2c) or in-kernel threefry (K3), any superstep K, ragged
// epochs. The weights stay in the SMs' shared memory for the whole epoch.
//
// Replaces the TPU kernel pytorch_ddp_mnist_tpu/ops/pallas_step.py
// `_make_epoch_kernel` (:433) in its single-replica uint8 f32 forms,
// reached through `epoch_fused_sgd`. The rows design (epoch_step.cu
// `epoch_kernel`, named for its phase of 8 batch rows a block) keeps the
// f32-row, bf16 and batch > WS_MAX_BATCH forms; ops/epoch_step.py
// `epoch_design` picks by form. The step is ws_step.cuh's, which K6-ws
// (ring_ws.cu) runs on each replica of a data-parallel ring.
//
// What bounds it on an H100: at B = 128 a step is 64.9 MFLOP of f32
// multiply-adds, a 469-step epoch 30.5 GFLOP: 0.455 ms at the 67 TFLOP/s
// f32 CUDA-core peak; its uint8 rows are 47 MB, 0.014 ms at 3.35 TB/s.
// Operations set the bound. In practice a step is a chain of dependent
// small products with two grid-wide barriers, so latency sets the time.
//
// What the rows design lost its time to, and what this one does:
//  * its rows phase ran on B/8 = 16 blocks, and each of them read all of
//    w1 (401 KB) from L2 every step. Here block g owns COLS = 2 hidden
//    units j = 2g, 2g+1 (ws_step.cuh), so all 128 units' z1 and gw1
//    chains run on 64 SMs at once. Weights are read from device memory
//    once and written back once; w2's rows are owned here and written to
//    a transposed copy every step, from which each block reads its COLS
//    columns of w2 (512 B each) before its z2 chains. No gradient element
//    is computed twice, except gw3 (5 KB), which every block computes and
//    applies with the same chains, so the w3 copies stay bit-identical.
//  * the uint8 normalise did two IEEE divisions per pixel load; here a
//    256-entry table per lane (ws_step.cuh).
//  * Where the time goes (the stamps build, PERF.md): the z1 and gw1
//    chains, whose table lookups and broadcast weight loads are bound by
//    the SM's shared-memory throughput; then the barriers and exchanges.
//
// Every update is __fsub_rn(w, __fmul_rn(lr, g)) of ws_step.cuh's
// gradients, which are K1's bits: K2-ws is bitwise K1 + SGD per step, and
// bitwise the rows design.
//
// Superstep K: the rows design staged the rows of K steps as f32 to
// spread the normalise. Here the table makes staging moot, so K only
// shapes the ragged tail: steps at or past `valid_steps` are skipped (loss
// 0, no update), which is K = 1's result for every K.
//
// Build macro: WS_STAMPS, a debug build that records %globaltimer at every
// phase boundary of block 0 (the default build has none of that code).
//
// Plain C interface for ctypes (ops/_build.py, ops/epoch_step.py): launches
// on the caller's stream, never synchronises, allocates nothing, and
// returns the CUDA error code (0 on success).

#include <cstdint>

#include <cooperative_groups.h>

#include "ws_step.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ws;

// hidden units a block owns: 2 (64 blocks) measured 6-8% faster than 1
// (128 blocks, twice the exchange reads, PERF.md). 4 (32 blocks) is built
// too, for K6-ws's comparison at its G (pdmt_ws_epoch_cols).
constexpr int COLS = 2;
constexpr int NBLK = Shape<COLS>::NBLK;  // the grid: one block per group
// the stamp words of a step: N_STAMPS %globaltimer stamps, then the SM's
// clock64() at ST_START and at ST_GW1 (with the two %globaltimer stamps
// they give the clock rate the step ran at)
constexpr int N_STAMP_WORDS = N_STAMPS + 2;
static_assert(Shape<2>::FITS && Shape<4>::FITS,
              "over the 227 KB a block may use");

struct WsArgs {
  const uint8_t* x;      // (S*B, 784) the epoch's gathered rows
  const int* y;          // (S*B,)
  const float* masks;    // (S*B, 128) pre-scaled      (RNG_MASKS)
  const int* keys;       // (S, 2) per-step key words  (RNG_THREEFRY)
  uint32_t seed;         // epoch seed                 (RNG_PHILOX)
  const float* in[5];    // w1, b1, w2, b2, w3 (never written)
  float* out[5];         // the same shapes, written
  float* xch;            // d1, h2 (B x 128 each), w2^T (128 x 128)
  float* losses;         // (S,)
  unsigned long long* stamps;  // (S, N_STAMP_WORDS) or null
  int nsteps;
  int valid_steps;
  int batch;
  float lr;
  float inv_batch;
};

// K2-ws's side of ws_step: grid syncs, its stamps, and SGD in place.
template <int C>
struct WsCtx {
  cg::grid_group grid;
  const WsArgs& a;
  const Smem& sm;
  float* w2t;
  int j0;

  __device__ bool sync() {
    grid.sync();
    return true;
  }
  __device__ void stamp(int step, int at, int who = 0) const {
#ifdef WS_STAMPS
    if (blockIdx.x == 0 && threadIdx.x == who) {
      unsigned long long t;  // "memory": not moved across the barriers
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
      unsigned long long* row = a.stamps + (size_t)step * N_STAMP_WORDS;
      row[at] = t;
      if (at == ST_START) row[N_STAMPS] = clock64();
      if (at == ST_GW1) row[N_STAMPS + 1] = clock64();
    }
#endif
  }
  // gw3's end is stamped by its first thread, HALF, behind a branch on its
  // own chains' results, so the stamp cannot be read before them. Thread 0
  // stamping after the barrier that ends gw3 read 0.08 us for the phase
  // and gave gw3's time to dz2's (PERF.md); the few ns that the other gw3
  // warps may take longer are counted in dz2's phase.
  __device__ void stamp_gw3(int step, const float (&g3)[NC]) const {
#ifdef WS_STAMPS
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) s += g3[c];
    if (__float_as_uint(s) != 0xffffffffu) stamp(step, ST_GW3, HALF);
#endif
  }
  __device__ void after_bar1(int, const Smem&) const {}
  __device__ void idle_z2(int) const {}
  __device__ bool ok() const { return true; }
  __device__ void w3(int k, const float (&g3)[NC]) const {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      sm.w3s[w3i(k, c)] = sgd(sm.w3s[w3i(k, c)], a.lr, g3[c]);
  }
  __device__ void b2(int c, float s) const {
    sm.bias[C + c] = sgd(sm.bias[C + c], a.lr, s);
  }
  __device__ void loss(int step, float v) const {
    if (blockIdx.x == 0) a.losses[step] = v;
  }
  // the row update, and its transpose for the next step's column reads
  __device__ void w2row(int i, const float (&g2)[C]) const {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float w = sgd(sm.w2r[c * H2 + i], a.lr, g2[c]);
      sm.w2r[c * H2 + i] = w;
      __stcg(w2t + i * H1 + j0 + c, w);
    }
  }
  __device__ void w1(int t, const float (&acc)[C][4]) const {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float4* w = reinterpret_cast<float4*>(sm.w1c + c * IN + 4 * t);
      float4 v = *w;
      v.x = sgd(v.x, a.lr, acc[c][0]);
      v.y = sgd(v.y, a.lr, acc[c][1]);
      v.z = sgd(v.z, a.lr, acc[c][2]);
      v.w = sgd(v.w, a.lr, acc[c][3]);
      *w = v;
    }
  }
  __device__ void b1(int c, float s) const {
    sm.bias[c] = sgd(sm.bias[c], a.lr, s);
  }
};

template <int C, int RNG>
__global__ void __launch_bounds__(THREADS, 1) ws_kernel(WsArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve<C>(smem_raw);
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * C;  // the first unit this block owns
  const int batch = a.batch;
  float* const d1x = a.xch;
  float* const h2x = d1x + (size_t)batch * H1;
  float* const w2t = h2x + (size_t)batch * H2;  // w2 transposed, (128, 128)
  const StepIO io{a.x, a.y, MaskSrc{a.masks, a.keys, a.seed, 0u, batch},
                  d1x, h2x, w2t, batch, a.inv_batch};
  WsCtx<C> ctx{cg::this_grid(), a, sm, w2t, j0};

  // ---- the block's weights into shared memory, once ----
  load_weights<C>(sm, a.in[0], a.in[1], a.in[2], a.in[3], a.in[4], w2t, j0);
  __syncthreads();

  for (int step = 0; step < a.valid_steps; ++step)
    ws_step<C, RNG>(io, ctx, sm, j0, step);

  // ---- the padded steps of a ragged epoch, and the weights out ----
  if (blockIdx.x == 0)
    for (int s = a.valid_steps + tid; s < a.nsteps; s += THREADS)
      a.losses[s] = 0.f;
  store_weights<C>(sm, a.out[0], a.out[1], a.out[2], a.out[3],
                   blockIdx.x == 0 ? a.out[4] : nullptr, j0);
}

// the table as the kernel fills it, every copy (a debug entry: the card
// compares each with the plain normalise bitwise)
__global__ void table_kernel(float* out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tbl = reinterpret_cast<float*>(smem_raw);
  fill_table(tbl);
  __syncthreads();
  for (int i = threadIdx.x; i < 256 * TCOPIES; i += blockDim.x)
    out[i] = tbl[i];
}

using WsKernel = void (*)(WsArgs);

template <int C>
WsKernel pick(int rng) {
  static const WsKernel table[3] = {ws_kernel<C, RNG_MASKS>,
                                    ws_kernel<C, RNG_THREEFRY>,
                                    ws_kernel<C, RNG_PHILOX>};
  return table[rng];
}

}  // namespace

extern "C" int pdmt_ws_max_batch() { return B_MAX; }

extern "C" int pdmt_ws_blocks() { return NBLK; }

extern "C" int pdmt_ws_smem_bytes() {
  return static_cast<int>(Shape<COLS>::SMEM_BYTES);
}

// the shared memory a block of the step at `cols` units a block takes
// (2, 4 or 8; 8 does not fit and is not built), or -1
extern "C" int pdmt_ws_smem_bytes_at(int cols) {
  return cols == 2   ? static_cast<int>(Shape<2>::SMEM_BYTES)
         : cols == 4 ? static_cast<int>(Shape<4>::SMEM_BYTES)
         : cols == 8 ? static_cast<int>(Shape<8>::SMEM_BYTES)
                     : -1;
}

// the exchange scratch a launch at `batch` takes: d1, h2 (batch x 128
// each) and w2 transposed (128 x 128)
extern "C" int pdmt_ws_xch_floats(int batch) {
  return 2 * batch * H1 + H1 * H2;
}

// the stamp words a step records in the stamps build (N_STAMPS
// %globaltimer stamps, then two clock64() reads), 0 in the default build
extern "C" int pdmt_ws_stamps_per_step() {
#ifdef WS_STAMPS
  return N_STAMP_WORDS;
#else
  return 0;
#endif
}

extern "C" const char* pdmt_ws_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One epoch at `cols` hidden units a block (2: the default, pdmt_ws_epoch;
// 4: 32 blocks, the step K6-ws runs on each replica at n = 3, 4): x
// (nsteps*batch, 784) uint8 (16-byte aligned), batch a multiple of 4 up to
// pdmt_ws_max_batch(), y (nsteps*batch,) int32, rng 0/1/2 =
// masks/threefry/philox with its source (masks, keys or seed), params in
// (w1, b1, w2, b2, w3) and out (same shapes, written), valid_steps <=
// nsteps, xch of pdmt_ws_xch_floats(batch) floats, losses (nsteps,),
// stamps (nsteps, pdmt_ws_stamps_per_step()) u64 in the stamps build (else
// ignored). Launches 128 / cols blocks.
extern "C" int pdmt_ws_epoch_cols(
    int cols, const void* x, const int* y, int rng, const float* masks,
    const int* keys, uint32_t seed, const float* w1, const float* b1,
    const float* w2, const float* b2, const float* w3, float* ow1, float* ob1,
    float* ow2, float* ob2, float* ow3, int valid_steps, float* xch,
    float* losses, unsigned long long* stamps, int nsteps, int batch,
    float lr, float inv_batch, void* stream) {
  if ((cols != 2 && cols != 4) || rng < 0 || rng > 2 || batch < 4 ||
      batch > B_MAX || batch % 4 || nsteps < 1 || valid_steps < 1 ||
      valid_steps > nsteps || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      (pdmt_ws_stamps_per_step() > 0 && stamps == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const WsKernel kernel = cols == 2 ? pick<2>(rng) : pick<4>(rng);
  const int nblk = H1 / cols;
  const size_t smem = static_cast<size_t>(pdmt_ws_smem_bytes_at(cols));
  const void* fn = reinterpret_cast<const void*>(kernel);
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
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (per_sm * sms < nblk)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  WsArgs a{static_cast<const uint8_t*>(x), y, masks, keys, seed,
           {w1, b1, w2, b2, w3}, {ow1, ob1, ow2, ob2, ow3}, xch, losses,
           stamps, nsteps, valid_steps, batch, lr, inv_batch};
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      fn, dim3(nblk), dim3(THREADS), args, smem,
      static_cast<cudaStream_t>(stream)));
}

// One epoch at COLS = 2 (NBLK blocks), as pdmt_ws_epoch_cols.
extern "C" int pdmt_ws_epoch(
    const void* x, const int* y, int rng, const float* masks,
    const int* keys, uint32_t seed, const float* w1, const float* b1,
    const float* w2, const float* b2, const float* w3, float* ow1, float* ob1,
    float* ow2, float* ob2, float* ow3, int valid_steps, float* xch,
    float* losses, unsigned long long* stamps, int nsteps, int batch,
    float lr, float inv_batch, void* stream) {
  return pdmt_ws_epoch_cols(COLS, x, y, rng, masks, keys, seed, w1, b1, w2,
                            b2, w3, ow1, ob1, ow2, ob2, ow3, valid_steps, xch,
                            losses, stamps, nsteps, batch, lr, inv_batch,
                            stream);
}

// The copies of the table a lane reads (32).
extern "C" int pdmt_ws_table_copies() { return TCOPIES; }

// The normalise table the kernel fills, into out (256 * 32 floats: entry v
// of copy l at v * 32 + l).
extern "C" int pdmt_ws_table(float* out, void* stream) {
  table_kernel<<<1, 256, 256 * TCOPIES * sizeof(float),
                 static_cast<cudaStream_t>(stream)>>>(out);
  return static_cast<int>(cudaGetLastError());
}
