// K1: one training step's forward + backward for the reference MLP, f32,
// with a pre-drawn dropout mask.
//
// Replaces the TPU kernel pytorch_ddp_mnist_tpu/ops/pallas_step.py
// `_make_fused_kernel` (f32, mask input), reached through `_run_fused` /
// `fused_loss_and_grads`. Same math, same outputs: the mean cross-entropy
// loss and the gradients of fc1 (w, b), fc2 (w, b) and fc3 (w). SGD runs
// outside, in the caller.
//
//   z1 = x w1 + b1          d1 = relu(z1) * m       z2 = d1 w2 + b2
//   h2 = relu(z2)           logits = h2 w3          loss_b = lse - logit_y
//   dl = (softmax - onehot) / B
//   dz2 = (dl w3^T) * [z2 > 0]                      dz1 = (dz2 w2^T) * m * [z1 > 0]
//   gw3 = h2^T dl   gw2 = d1^T dz2   gw1 = x^T dz1   gb2 = sum dz2   gb1 = sum dz1
//
// What bounds it on an H100: at the main path's B = 128 the six products are
// B * 253,696 multiply-adds = 64.9 MFLOP, 0.97 us at the 67 TFLOP/s f32
// CUDA-core peak; the bytes (x, mask, labels, weights in; loss and grads
// out) are 1.41 MB, 0.42 us at 3.35 TB/s. So operations set the bound, and
// both are below the cost of launching a kernel at all: at this size the
// step is launch-bound.
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

__global__ void __launch_bounds__(THREADS_A) rows_kernel(
    const float* __restrict__ x, const int* __restrict__ y,
    const float* __restrict__ mask,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ w3,
    float* __restrict__ d1_out, float* __restrict__ h2_out,
    float* __restrict__ dz2_out, float* __restrict__ dz1_out,
    float* __restrict__ dl_out, float* __restrict__ row_loss,
    int batch, float inv_batch) {
  const auto mask_at = [mask](int row, int col) {
    return mask[(size_t)row * H1 + col];
  };
  rows_block<LdgLoad>(x, y, mask_at, w1, b1, w2, b2, w3, d1_out, h2_out,
                      dz2_out, dz1_out, dl_out, row_loss,
                      blockIdx.x * ROWS_A, batch, inv_batch);
}

struct StoreTo {
  float* out;
  int n;
  __device__ void operator()(int k, int j, float v) const { out[k * n + j] = v; }
};

__global__ void __launch_bounds__(TILE_THREADS) grads_kernel(
    const float* __restrict__ x, const float* __restrict__ d1,
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
    if (gt.which == 0)
      at_g_tile<LdgLoad>(as, threadIdx.x, x, nullptr, IN, IN, dz1, H1, gt.k0, batch,
                         StoreTo{gw1, H1});
    else if (gt.which == 1)
      at_g_tile<LdgLoad>(as, threadIdx.x, d1, nullptr, H1, H1, dz2, H2, gt.k0, batch,
                         StoreTo{gw2, H2});
    else
      at_g_tile<LdgLoad>(as, threadIdx.x, h2, nullptr, H2, H2, dl, NC, gt.k0, batch,
                         StoreTo{gw3, NC});
    return;
  }
  // the last block: bias gradients and the mean loss, each summed in row order
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

}  // namespace

extern "C" int pdmt_fused_step_scratch_per_row() { return SCRATCH_PER_ROW; }

extern "C" const char* pdmt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// scratch: batch * SCRATCH_PER_ROW floats, carved here into d1, h2, dz2,
// dz1 (batch x 128 each), dl (batch x 10) and the per-row losses.
extern "C" int pdmt_fused_step_f32(
    const float* x, const int* y, const float* mask,
    const float* w1, const float* b1, const float* w2, const float* b2,
    const float* w3, float* scratch, float* loss, float* gw1, float* gb1,
    float* gw2, float* gb2, float* gw3, int batch, float inv_batch,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* d1 = scratch;
  float* h2 = d1 + (size_t)batch * H1;
  float* dz2 = h2 + (size_t)batch * H2;
  float* dz1 = dz2 + (size_t)batch * H2;
  float* dl = dz1 + (size_t)batch * H1;
  float* rl = dl + (size_t)batch * NC;
  rows_kernel<<<(batch + ROWS_A - 1) / ROWS_A, THREADS_A, 0, s>>>(
      x, y, mask, w1, b1, w2, b2, w3, d1, h2, dz2, dz1, dl, rl, batch,
      inv_batch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  grads_kernel<<<BLOCKS_B, TILE_THREADS, 0, s>>>(
      x, d1, h2, dz2, dz1, dl, rl, loss, gw1, gb1, gw2, gb2, gw3, batch);
  return static_cast<int>(cudaGetLastError());
}
