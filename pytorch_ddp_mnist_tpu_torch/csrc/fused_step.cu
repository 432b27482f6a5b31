// K1: one training step's forward + backward for the reference MLP.
//
// Replaces the TPU kernel pytorch_ddp_mnist_tpu/ops/pallas_step.py
// `_make_fused_kernel`, reached through `_run_fused`, in its four forms:
//   K1        f32, pre-drawn mask            `fused_loss_and_grads`
//   K1-bf16   compute_bf16: bf16 operands,   `fused_loss_and_grads` of a
//             f32 accumulation               bf16 x
//   K1-rng    in_kernel_rng: the mask is     `fused_loss_and_grads_rng`
//             drawn in the kernel per (step
//             seed, batch block), no mask
//             array in memory
//   K1-rng-bf16  both
// The K1-rng forms take their seed as a launch argument or, for a step
// captured in a CUDA graph, read it from word 0 of a key-table row in
// device memory (`fused_loss_and_grads_rng` of a row; PhiloxKeyMask).
// Same math, same outputs: the mean cross-entropy loss and the gradients of
// fc1 (w, b), fc2 (w, b) and fc3 (w). SGD runs outside, in the caller.
//
//   z1 = x w1 + b1          d1 = relu(z1) * m       z2 = d1 w2 + b2
//   h2 = relu(z2)           logits = h2 w3          loss_b = lse - logit_y
//   dl = (softmax - onehot) / B
//   dz2 = (dl w3^T) * [z2 > 0]                      dz1 = (dz2 w2^T) * m * [z1 > 0]
//   gw3 = h2^T dl   gw2 = d1^T dz2   gw1 = x^T dz1   gb2 = sum dz2   gb1 = sum dz1
//
// What bounds it on an H100: at the main path's B = 128 the six products are
// B * 253,696 multiply-adds = 64.9 MFLOP, 0.97 us at the 67 TFLOP/s f32
// CUDA-core peak (0.066 us at the 989 TFLOP/s bf16 tensor-core peak for
// the bf16 form); the bytes (x, mask, labels, weights in; loss and grads
// out) are 1.41 MB, 0.42 us at 3.35 TB/s. Both are below the cost of
// launching a kernel at all: at this size the step is launch-bound.
//
// Design, and what it does about the differences from the TPU:
//  * The TPU kernel carried the gradient sums across a SEQUENTIAL grid.
//    CUDA blocks run in any order, and float atomics would make every
//    gradient differ from run to run. So the step is two launches with no
//    atomics: `rows_kernel` takes ROWS_A batch rows per block and writes
//    their activations, activation gradients and per-row losses to scratch
//    that the caller allocates; `grads_kernel` then computes every gradient
//    element in one thread that sums over the batch rows in order 0..B-1.
//    The result is bitwise the same on every launch.
//  * Shared memory is 227 KB and w1 alone is 401,408 B: w1 never goes to
//    shared memory. Each thread owns one hidden column and streams that
//    column of w1 from global memory (coalesced across the warp), while the
//    block's ROWS_A rows of x (25 KB) sit in shared memory and are read as
//    broadcasts. K = 784 needs no tail handling that way. dz2 w2^T reads w2
//    by rows, so w2 passes through shared memory in 32-column tiles.
//  * True f32: every product is an f32 FFMA on the CUDA cores, as the TPU
//    kernel accumulates in f32. Tensor cores (wgmma, TF32) are later work.
//  * bf16 operands (K1-bf16): each operand is rounded to bf16 where it is
//    loaded (mlp_step.cuh `opnd`); the product of two bf16 values is exact
//    in f32, so the same FFMA loops give bf16 products with f32
//    accumulation in a fixed order.
//  * In-kernel dropout (K1-rng): the TPU core PRNG has no CUDA twin. The
//    mask element (row, col) is Philox4x32-10 keyed (step seed, batch block)
//    at counter (row in block) * 128 + col, the K2c stream with the block
//    index in place of the step (ops/philox.py). The batch blocks are
//    those of `_run_fused`'s grid, which the caller passes as `rng_block`.
//  * The 10 classes are not padded: loops run over exactly NC = 10, so no
//    padded column can touch the softmax or the gradients.
//  * Ragged batches: rows past B load as zeros and are never written, and
//    grads_kernel reads only rows < B; the mean divides by the true B.
//  * ReLU's gradient is the strict z > 0, and the mask multiplies both d1
//    and dz1, as in the TPU kernel.
//
// The row and gradient-element math is shared with K2 (epoch_step.cu) and
// lives in mlp_step.cuh; this file holds K1's two kernels and its entry.
//
// Plain C interface for ctypes (ops/_build.py, ops/fused_step.py): launches
// on the caller's stream, never synchronises, allocates nothing, and
// returns cudaGetLastError().

#include "mlp_step.cuh"

namespace {

using namespace mlp;

constexpr int BLOCKS_B = GRAD_TILES + 1;  // + the bias / loss block

// MaskAt: the mask is read (ArrayMask) or drawn (PhiloxBlockMask, or
// PhiloxKeyMask with the seed read from device memory)
template <class XT, bool BF, class MaskAt>
__global__ void __launch_bounds__(THREADS_A) rows_kernel(
    const XT* __restrict__ x, const int* __restrict__ y, MaskAt mask_at,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ w3,
    float* __restrict__ d1_out, float* __restrict__ h2_out,
    float* __restrict__ dz2_out, float* __restrict__ dz1_out,
    float* __restrict__ dl_out, float* __restrict__ row_loss,
    int batch, float inv_batch) {
  rows_block<LdgLoad, BF>(x, y, mask_at, w1, b1, w2, b2, w3, d1_out, h2_out,
                          dz2_out, dz1_out, dl_out, row_loss,
                          blockIdx.x * ROWS_A, batch, inv_batch);
}

struct StoreTo {
  float* out;
  int n;
  __device__ void operator()(int k, int j, float v) const { out[k * n + j] = v; }
};

template <class XT, bool BF>
__global__ void __launch_bounds__(TILE_THREADS) grads_kernel(
    const XT* __restrict__ x, const float* __restrict__ d1,
    const float* __restrict__ h2, const float* __restrict__ dz2,
    const float* __restrict__ dz1, const float* __restrict__ dl,
    const float* __restrict__ row_loss,
    float* __restrict__ loss, float* __restrict__ gw1, float* __restrict__ gb1,
    float* __restrict__ gw2, float* __restrict__ gb2, float* __restrict__ gw3,
    int batch) {
  __shared__ float as[BT][TK];
  const int t = blockIdx.x;
  if (t < GRAD_TILES) {
    const GradTile gt = grad_tile(t);
    if (gt.which == 0) {
      const float* xf = nullptr;
      const __nv_bfloat16* xb = nullptr;
      if constexpr (sizeof(XT) == 2)
        xb = reinterpret_cast<const __nv_bfloat16*>(x);
      else
        xf = reinterpret_cast<const float*>(x);
      at_g_tile<LdgLoad, BF>(as, threadIdx.x, xf, nullptr, xb, IN, IN, dz1,
                             H1, gt.k0, batch, StoreTo{gw1, H1});
    } else if (gt.which == 1) {
      at_g_tile<LdgLoad, BF>(as, threadIdx.x, d1, nullptr, nullptr, H1, H1,
                             dz2, H2, gt.k0, batch, StoreTo{gw2, H2});
    } else {
      at_g_tile<LdgLoad, BF>(as, threadIdx.x, h2, nullptr, nullptr, H2, H2,
                             dl, NC, gt.k0, batch, StoreTo{gw3, NC});
    }
    return;
  }
  // the last block: bias gradients (of the unrounded dz1, dz2) and the mean
  // loss, each summed in row order
  const int j = threadIdx.x;
  float s1 = 0.f, s2 = 0.f;
  for (int b = 0; b < batch; ++b) {
    s1 += dz1[(size_t)b * H1 + j];
    s2 += dz2[(size_t)b * H2 + j];
  }
  gb1[j] = s1;
  gb2[j] = s2;
  if (j == 0) {
    float s = 0.f;
    for (int b = 0; b < batch; ++b) s += row_loss[b];
    loss[0] = s / (float)batch;
  }
}

template <class XT, bool BF, class MaskAt>
cudaError_t launch(const void* xv, const int* y, MaskAt mask_at,
                   const float* w1, const float* b1, const float* w2,
                   const float* b2, const float* w3, float* scratch,
                   float* loss, float* gw1, float* gb1, float* gw2, float* gb2,
                   float* gw3, int batch, float inv_batch, cudaStream_t s) {
  const XT* x = static_cast<const XT*>(xv);
  float* d1 = scratch;
  float* h2 = d1 + (size_t)batch * H1;
  float* dz2 = h2 + (size_t)batch * H2;
  float* dz1 = dz2 + (size_t)batch * H2;
  float* dl = dz1 + (size_t)batch * H1;
  float* rl = dl + (size_t)batch * NC;
  rows_kernel<XT, BF, MaskAt><<<(batch + ROWS_A - 1) / ROWS_A, THREADS_A, 0,
                                s>>>(x, y, mask_at, w1, b1, w2, b2, w3, d1,
                                     h2, dz2, dz1, dl, rl, batch, inv_batch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  grads_kernel<XT, BF><<<BLOCKS_B, TILE_THREADS, 0, s>>>(
      x, d1, h2, dz2, dz1, dl, rl, loss, gw1, gb1, gw2, gb2, gw3, batch);
  return cudaGetLastError();
}

template <class XT, bool BF>
cudaError_t launch_form(const void* x, const int* y, int rng,
                        const float* mask, const uint32_t* key, uint32_t seed,
                        int rng_block, const float* w1, const float* b1,
                        const float* w2, const float* b2, const float* w3,
                        float* scratch, float* loss, float* gw1, float* gb1,
                        float* gw2, float* gb2, float* gw3, int batch,
                        float inv_batch, cudaStream_t s) {
  if (rng == 1)
    return launch<XT, BF>(x, y, PhiloxBlockMask{seed, rng_block}, w1, b1, w2,
                          b2, w3, scratch, loss, gw1, gb1, gw2, gb2, gw3,
                          batch, inv_batch, s);
  if (rng == 3)
    return launch<XT, BF>(x, y, PhiloxKeyMask{key, rng_block}, w1, b1, w2,
                          b2, w3, scratch, loss, gw1, gb1, gw2, gb2, gw3,
                          batch, inv_batch, s);
  return launch<XT, BF>(x, y, ArrayMask{mask}, w1, b1, w2, b2, w3, scratch,
                        loss, gw1, gb1, gw2, gb2, gw3, batch, inv_batch, s);
}

// K1-rng's mask as rows_kernel draws it (a debug entry: the card compares
// it bitwise with the plain version)
__global__ void rng_mask_kernel(uint32_t seed, int rng_block, int batch,
                                float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < batch * H1) out[i] = PhiloxBlockMask{seed, rng_block}(i / H1, i % H1);
}

// the streaming trainer's mask for one threefry key: K3's draw, the key
// words (k0, k1) given, or read from device memory (a row of the per-step
// loops' key table: the mask of the rows design's keyed step, B > 128)
template <class Key>
__global__ void threefry_mask_kernel(Key key, int batch, float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < batch * H1) out[i] = key(i / H1, i % H1);
}

struct WordsKey {
  uint32_t k0, k1;
  __device__ float operator()(int row, int col) const {
    return threefry_mask(k0, k1, row, col);
  }
};

template <class Key>
cudaError_t launch_threefry_mask(Key key, int batch, float* out,
                                 void* stream) {
  const int n = batch * H1;
  threefry_mask_kernel<Key><<<(n + 255) / 256, 256, 0,
                              static_cast<cudaStream_t>(stream)>>>(key, batch,
                                                                   out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pdmt_fused_step_scratch_per_row() { return SCRATCH_PER_ROW; }

extern "C" const char* pdmt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One step. x (batch, 784): f32, or bf16 (x_bf16 = 1: the bf16-operand
// form). rng = 0 reads `mask` (batch, 128); rng = 1 draws it in the kernel
// from (seed, batch block of rng_block rows); rng = 3 draws it as 1 does
// with the seed read from word 0 at `key` (device memory, 8-byte aligned: a
// row of the per-step loops' key table, so that a captured launch reads the
// seed at replay). What a form does not use may be null.
// scratch: batch * SCRATCH_PER_ROW floats, carved into d1, h2, dz2, dz1
// (batch x 128 each), dl (batch x 10) and the per-row losses.
extern "C" int pdmt_fused_step(
    const void* x, int x_bf16, const int* y, int rng, const float* mask,
    const uint32_t* key, uint32_t seed, int rng_block, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* w3,
    float* scratch, float* loss, float* gw1, float* gb1, float* gw2,
    float* gb2, float* gw3, int batch, float inv_batch, void* stream) {
  if (batch < 1 || !(rng == 0 || rng == 1 || rng == 3) ||
      (rng != 0 && rng_block < 1) || (rng == 0 && mask == nullptr) ||
      (rng == 3 && (key == nullptr || reinterpret_cast<uintptr_t>(key) % 8)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return static_cast<int>(launch_form<__nv_bfloat16, true>(
        x, y, rng, mask, key, seed, rng_block, w1, b1, w2, b2, w3, scratch,
        loss, gw1, gb1, gw2, gb2, gw3, batch, inv_batch, s));
  return static_cast<int>(launch_form<float, false>(
      x, y, rng, mask, key, seed, rng_block, w1, b1, w2, b2, w3, scratch, loss,
      gw1, gb1, gw2, gb2, gw3, batch, inv_batch, s));
}

// The (batch, 128) mask K1-rng draws for `seed` with batch blocks of
// `rng_block` rows.
extern "C" int pdmt_fused_rng_mask(uint32_t seed, int rng_block, int batch,
                                   float* out, void* stream) {
  if (batch < 1 || rng_block < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n = batch * H1;
  rng_mask_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, rng_block, batch, out);
  return static_cast<int>(cudaGetLastError());
}

// The (batch, 128) dropout mask of one threefry key (k0, k1), bit for bit
// jax's dropout_mask(key, batch): the streaming trainer's per-step draw.
extern "C" int pdmt_threefry_mask(uint32_t k0, uint32_t k1, int batch,
                                  float* out, void* stream) {
  if (batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_threefry_mask(WordsKey{k0, k1}, batch, out, stream));
}

// The same mask under the key words (k0, k1) at `key` (device memory,
// 8-byte aligned).
extern "C" int pdmt_threefry_mask_keyed(const uint32_t* key, int batch,
                                        float* out, void* stream) {
  if (batch < 1 || key == nullptr || reinterpret_cast<uintptr_t>(key) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_threefry_mask(ThreefryKeyMask{key}, batch, out, stream));
}
