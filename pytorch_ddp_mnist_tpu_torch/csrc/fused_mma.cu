// K1-mma: the per-step fused kernel (K1) redesigned for Hopper's tensor
// cores in its bf16 forms, at batches up to B_MAX rows. One call computes
// one training step's mean cross-entropy loss and the gradients of fc1
// (w, b), fc2 (w, b) and fc3 (w) with bf16 operands in all six products,
// accumulated in f32 by `mma.sync.m16n8k16` on the tensor cores.
//
// Replaces the TPU kernel pytorch_ddp_mnist_tpu/ops/pallas_step.py
// `_make_fused_kernel` (:191) in its `compute_bf16` mode (:207-212,
// products :246-291), reached through `_run_fused` (:350), in two forms:
//   bf16 x, pre-drawn mask           `fused_loss_and_grads`
//   bf16 x, in-kernel Philox mask    `fused_loss_and_grads_rng` (the Philox
//                                    block keyed (step seed, batch block)),
//                                    the seed a launch argument or read
//                                    from word 0 of a key-table row in
//                                    device memory (a captured step's)
//   bf16 x, in-kernel threefry mask  `fused_loss_and_grads_keyed`: jax's
//                                    `dropout_mask(key, B)` (pallas_step.py
//                                    :1226, cipher :92, element rule
//                                    :123), the key's words read from a
//                                    device table
// The keyed form is the bf16 `--kernel pallas` step: it takes the place of
// the streaming mask entry (fused_step.cu `threefry_mask_kernel`), its
// launch, its host wrapper and the mask's round trip through device memory.
// ops/fused_step.py `fused_design` sends them here at B <= B_MAX; larger
// batches stay on the rows design (fused_step.cu).
//
// The precision contract is `step_reference_bf16`'s (ops/fused_step.py),
// spelled out with the mma fragment layout in mma_step.cuh. The tensor
// cores add the exact bf16 products in their own order, another than the
// MXU's and the CPU's, so the design is held to the JAX package's pins for
// its bf16 kernels (loss rtol 1e-3, grads rtol 2e-3 / atol 1e-4) against
// the plain version, not bitwise to the rows design; a repeat launch gives
// the same bits. The mean is taken with 1/B.
//
// What bounds it on an H100: at B = 128 the six products are 64.9 MFLOP,
// 0.066 us at the 989 TFLOP/s bf16 tensor-core peak; the bytes (x in bf16,
// mask, labels, weights in; loss and grads out) are 1.21 MB, 0.362 us at
// 3.35 TB/s. The longest dependent chain is 8 MMAs (z2, dd1, the batch
// contractions at B = 128; z1's 49 k-steps are cut in 7 chains of 7, one a
// warp, summed in a fixed order). What sets the time is, as in K1-split,
// the launches (~1.2 us each in a CUDA graph) and staging the operands.
//
// The design, three launches (each phase gets the grid its work wants, the
// exchange passes through global scratch across the kernel boundaries, and
// the launches capture in a CUDA graph). The phases' bodies are the device
// functions of mma_step.cuh, which K2-mma (epoch_mma.cu) runs too, one
// cooperative launch an epoch:
//  * mma_hidden_kernel: z1 over (16 rows x 8 units) tiles, 16 unit groups x
//    B/16 row groups (128 blocks at B = 128). Warp c of 7 owns k = 112c ..
//    112c+111: its x rows and w1 columns come in by one tensor copy each
//    (x as bf16, w1 as f32, rounded as the B fragments are built) on its
//    own mbarrier, and it runs 7 MMAs. The 7 partial tiles are summed in
//    order c = 0..6 by the thread that owns the element, which adds b1 and
//    the mask, and writes d1 (bf16), z1 and m. That thread draws or reads
//    its mask before the chain (hidden_tile's HOIST_MASK), so the draw
//    overlaps the copies' waits. Meanwhile the grid rounds w2 and w3 to
//    bf16 copies in scratch, once a call.
//  * mma_rows_kernel: 16 rows a block (B/16 blocks), warp w owning units
//    32w .. 32w+31: z2 (8 k-steps), h2, the logits (two class tiles),
//    softmax, loss and dl in f32 one thread a row, dh2 (one k-step over 16
//    padded classes), dz2, dd1 (8 k-steps), dz1. The bf16 w2 comes in by 4
//    tensor copies of 32 rows and w3 by one, all four products' B
//    fragments by `ldmatrix`; a thread keeps z2, z1 and m of its
//    accumulator elements in registers for the ReLU masks.
//  * mma_grads_kernel: 49 gw1 tiles and 8 gw2 tiles of 16 rows x 128
//    columns, and one gw3 block (128 x 16), each a K = B contraction in
//    32-row groups of tensor copies (both operands bf16, `ldmatrix.trans`);
//    8 blocks sum gb1 and gb2 from the unrounded f32 dz1, dz2, 32 columns
//    a block (one thread a column, over b in order); the gw3 block's thread
//    0 sums the loss. 66 blocks.
//
// Build macro: MMA_STAMPS, a debug build that records %globaltimer at the
// phase boundaries (ops/fused_step.py `mma_phase_stamps`); the default
// build has none of that code.
//
// Plain C interface for ctypes (ops/_build.py, ops/fused_step.py): launches
// on the caller's stream, never synchronises, allocates nothing, and
// returns the CUDA error code (0 on success).

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>

#include "mma_step.cuh"
#include "tma.cuh"

namespace {

using namespace mma_step;

// ---- phase stamps (MMA_STAMPS) ----

// Each kernel's start is stamped by its block 0 as it begins; each kernel's
// end is the last of its blocks' ends (atomicMax over blocks, after a
// barrier). The rows kernel's inner boundaries are its block 0's.
enum Stamp : int {
  ST_HIDDEN_START,  // mma_hidden_kernel, block 0 begins
  ST_HIDDEN_END,    // its last block's z1, mask and d1 out
  ST_ROWS_START,    // mma_rows_kernel, block 0 begins
  ST_ROWS_Z2,       // w2 in, z2 and h2 out (block 0)
  ST_ROWS_SOFTMAX,  // logits, softmax, loss and dl (block 0)
  ST_ROWS_END,      // its last block's dz2 and dz1 out
  ST_GRADS_START,   // mma_grads_kernel, block 0 begins
  ST_GRADS_END,     // its last block's gradients out
  N_STAMPS
};

__device__ __forceinline__ void stamp_block0(unsigned long long* st, int at) {
#ifdef MMA_STAMPS
  __syncthreads();
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
    st[at] = t;
  }
#endif
}

__device__ __forceinline__ void stamp_last(unsigned long long* st, int at) {
#ifdef MMA_STAMPS
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
    atomicMax(st + at, t);
  }
#endif
}

// the rows kernel's inner stamps (rows_tile's on_phase 0 and 1)
struct RowsStamps {
  unsigned long long* st;
  __device__ void operator()(int i) const {
    stamp_block0(st, i == 0 ? ST_ROWS_Z2 : ST_ROWS_SOFTMAX);
  }
};

// ---- the three kernels: one phase each (mma_step.cuh) ----

// Block (unit group, row group); the whole grid rounds w2 and w3.
template <class MaskAt>
__global__ void __launch_bounds__(HIDDEN_THREADS) mma_hidden_kernel(
    const __grid_constant__ CUtensorMap x_map, MaskAt mask_at,
    const __grid_constant__ CUtensorMap w1_map, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ w3,
    bf16* __restrict__ w2b, bf16* __restrict__ w3b,
    bf16* __restrict__ d1_out, float* __restrict__ z1_out,
    float* __restrict__ m_out, int batch, unsigned long long* stamps) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem + HIDDEN_DATA);
  stamp_block0(stamps, ST_HIDDEN_START);
  bars_init(bars, NKC);
  hidden_tile<MaskAt, true>(
      smem, bars, 0u, &x_map, mask_at, &w1_map, b1, w2, w3, w2b, w3b, d1_out,
      z1_out, m_out, batch, blockIdx.x, blockIdx.y,
      (blockIdx.y * gridDim.x + blockIdx.x) * HIDDEN_THREADS + threadIdx.x,
      HIDDEN_THREADS * gridDim.x * gridDim.y);
  stamp_last(stamps, ST_HIDDEN_END);
}

// Block: rows 16 blockIdx.x .. 16 blockIdx.x + 15.
__global__ void __launch_bounds__(ROWS_THREADS) mma_rows_kernel(
    const int* __restrict__ y, const __grid_constant__ CUtensorMap w2_map,
    const __grid_constant__ CUtensorMap w3_map, const float* __restrict__ b2,
    const bf16* __restrict__ d1_in, const float* __restrict__ z1_in,
    const float* __restrict__ m_in, bf16* __restrict__ h2_out,
    bf16* __restrict__ dl_out, float* __restrict__ row_loss,
    float* __restrict__ dz2_out, bf16* __restrict__ dz2b_out,
    float* __restrict__ dz1_out, bf16* __restrict__ dz1b_out, int batch,
    float inv_batch, unsigned long long* stamps) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem + ROWS_DATA);
  stamp_block0(stamps, ST_ROWS_START);
  bars_init(bars, NWC);
  rows_tile<ROWS_THREADS>(smem, bars, 0u, y, &w2_map, &w3_map, b2, d1_in,
                          z1_in, m_in, h2_out, dl_out, row_loss, dz2_out,
                          dz2b_out, dz1_out, dz1b_out, batch, inv_batch,
                          blockIdx.x, RowsStamps{stamps});
  stamp_last(stamps, ST_ROWS_END);
}

// Block blockIdx.x of the GRAD_BLOCKS: a gradient tile, gw3 and the loss,
// or a quarter of a bias.
__global__ void __launch_bounds__(GRAD_THREADS) mma_grads_kernel(
    const __grid_constant__ CUtensorMap x_map,
    const __grid_constant__ CUtensorMap d1_map,
    const __grid_constant__ CUtensorMap dz1_map,
    const __grid_constant__ CUtensorMap dz2_map,
    const __grid_constant__ CUtensorMap h2_map,
    const __grid_constant__ CUtensorMap dl_map,
    const __grid_constant__ CUtensorMap dz1f_map,
    const __grid_constant__ CUtensorMap dz2f_map,
    const float* __restrict__ row_loss, float* __restrict__ loss,
    float* __restrict__ gw1, float* __restrict__ gb1, float* __restrict__ gw2,
    float* __restrict__ gb2, float* __restrict__ gw3, int batch,
    unsigned long long* stamps) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem + GRADS_DATA);
  stamp_block0(stamps, ST_GRADS_START);
  bars_init(bars, NGC);
  grads_tile(smem, bars, 0u, &x_map, &d1_map, &dz1_map, &dz2_map, &h2_map,
             &dl_map, &dz1f_map, &dz2f_map, row_loss, loss, gw1, gb1, gw2, gb2,
             gw3, batch, blockIdx.x, StoreGrad{});
  stamp_last(stamps, ST_GRADS_END);
}

// every kernel's dynamic shared memory above 48 KB, once per device (a
// driver call per launch costs host time on the per-step path)
cudaError_t allow_smem_once() {
  constexpr int MAX_DEVICES = 64;
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < MAX_DEVICES && done[dev])) return err;
  err = allow_smem(mma_hidden_kernel<ArrayMask>, HIDDEN_SMEM);
  if (err == cudaSuccess)
    err = allow_smem(mma_hidden_kernel<PhiloxBlockMask>, HIDDEN_SMEM);
  if (err == cudaSuccess)
    err = allow_smem(mma_hidden_kernel<ThreefryKeyMask>, HIDDEN_SMEM);
  if (err == cudaSuccess)
    err = allow_smem(mma_hidden_kernel<PhiloxKeyMask>, HIDDEN_SMEM);
  if (err == cudaSuccess) err = allow_smem(mma_rows_kernel, ROWS_SMEM);
  if (err == cudaSuccess) err = allow_smem(mma_grads_kernel, GRADS_SMEM);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

template <class MaskAt>
cudaError_t launch(const bf16* x, const int* y, MaskAt mask_at,
                   const float* w1, const float* b1, const float* w2,
                   const float* b2, const float* w3, unsigned char* scratch,
                   float* loss, float* gw1, float* gb1, float* gw2, float* gb2,
                   float* gw3, unsigned long long* stamps, int batch,
                   float inv_batch, cudaStream_t s) {
  const StepScratch sc = carve(scratch, batch);
  StepMaps m;
  cudaError_t err = allow_smem_once();
  if (err == cudaSuccess) err = step_maps(&m, x, w1, sc, batch);
  if (err != cudaSuccess) return err;
  mma_hidden_kernel<MaskAt>
      <<<dim3(UNIT_GROUPS, (batch + HR - 1) / HR), HIDDEN_THREADS, HIDDEN_SMEM,
         s>>>(m.x_rows, mask_at, m.w1_cols, b1, w2, w3, sc.w2b, sc.w3b, sc.d1b,
              sc.z1, sc.mv, batch, stamps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mma_rows_kernel<<<(batch + RR - 1) / RR, ROWS_THREADS, ROWS_SMEM, s>>>(
      y, m.w2_rows, m.w3_rows, b2, sc.d1b, sc.z1, sc.mv, sc.h2b, sc.dlb, sc.rl,
      sc.dz2f, sc.dz2b, sc.dz1f, sc.dz1b, batch, inv_batch, stamps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mma_grads_kernel<<<GRAD_BLOCKS, GRAD_THREADS, GRADS_SMEM, s>>>(
      m.x_cols, m.d1_cols, m.dz1_rows, m.dz2_rows, m.h2_rows, m.dl_rows,
      m.dz1_cols, m.dz2_cols, sc.rl, loss, gw1, gb1, gw2, gb2, gw3, batch,
      stamps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pdmt_mma_max_batch() { return B_MAX; }

// the scratch a call at `batch` takes, in floats (whole 16-byte units)
extern "C" int pdmt_mma_scratch_floats(int batch) {
  return static_cast<int>(scratch_bytes(batch) / sizeof(float));
}

// the blocks of the three launches at `batch`
extern "C" int pdmt_mma_blocks(int batch, int* out3) {
  if (batch < 1 || batch > B_MAX) return static_cast<int>(cudaErrorInvalidValue);
  out3[0] = UNIT_GROUPS * ((batch + HR - 1) / HR);
  out3[1] = (batch + RR - 1) / RR;
  out3[2] = GRAD_BLOCKS;
  return 0;
}

// the stamp words a call records in the stamps build (N_STAMPS
// %globaltimer stamps), 0 in the default build
extern "C" int pdmt_mma_stamp_words() {
#ifdef MMA_STAMPS
  return N_STAMPS;
#else
  return 0;
#endif
}

extern "C" const char* pdmt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One step. x (batch, 784) bf16; y (batch,) int32. The mask by `rng`: 0
// reads `mask` (batch, 128) f32; 1 draws it in the kernel from (seed, batch
// block of rng_block rows); 2 draws jax's threefry mask under the key words
// (k0, k1) at `key` (device memory, 8-byte aligned); 3 draws it as 1 does
// with the seed read from word 0 at `key` (a key-table row, so that a
// captured launch reads the seed at replay). What a form does not
// use may be null. The weights f32. x, w1, w2, w3 and scratch 16-byte
// aligned; scratch: pdmt_mma_scratch_floats(batch) floats. stamps:
// pdmt_mma_stamp_words() u64, zeroed, in the stamps build (else ignored).
// 1 <= batch <= pdmt_mma_max_batch().
extern "C" int pdmt_mma_step(
    const bf16* x, const int* y, int rng, const float* mask,
    const uint32_t* key, uint32_t seed, int rng_block, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* w3,
    unsigned char* scratch, float* loss, float* gw1, float* gb1, float* gw2,
    float* gb2, float* gw3, unsigned long long* stamps, int batch,
    float inv_batch, void* stream) {
  if (batch < 1 || batch > B_MAX || rng < 0 || rng > 3 ||
      ((rng == 1 || rng == 3) && rng_block < 1) ||
      (rng == 0 && mask == nullptr) ||
      (rng >= 2 && (key == nullptr || reinterpret_cast<uintptr_t>(key) % 8)) ||
      !aligned16(x) || !aligned16(w1) || !aligned16(w2) || !aligned16(w3) ||
      !aligned16(scratch) || (pdmt_mma_stamp_words() > 0 && stamps == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rng == 1)
    return static_cast<int>(launch(x, y, PhiloxBlockMask{seed, rng_block}, w1,
                                   b1, w2, b2, w3, scratch, loss, gw1, gb1,
                                   gw2, gb2, gw3, stamps, batch, inv_batch, s));
  if (rng == 3)
    return static_cast<int>(launch(x, y, PhiloxKeyMask{key, rng_block}, w1,
                                   b1, w2, b2, w3, scratch, loss, gw1, gb1,
                                   gw2, gb2, gw3, stamps, batch, inv_batch, s));
  if (rng == 2)
    return static_cast<int>(launch(x, y, ThreefryKeyMask{key}, w1, b1, w2, b2,
                                   w3, scratch, loss, gw1, gb1, gw2, gb2, gw3,
                                   stamps, batch, inv_batch, s));
  return static_cast<int>(launch(x, y, ArrayMask{mask}, w1, b1, w2, b2, w3,
                                 scratch, loss, gw1, gb1, gw2, gb2, gw3, stamps,
                                 batch, inv_batch, s));
}
