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
// Plain C interface for ctypes (ops/_build.py, ops/fused_step.py): launches
// on the caller's stream, never synchronises, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int IN = 784;
constexpr int H1 = 128;
constexpr int H2 = 128;
constexpr int NC = 10;

// rows_kernel: ROWS_A rows per block, 256 threads = 2 row groups x 128
// columns, each thread RPT rows of one column.
constexpr int ROWS_A = 8;
constexpr int RPT = 4;
constexpr int THREADS_A = H1 * ROWS_A / RPT;
constexpr int KT = 32;  // w2 tile width for dz2 w2^T

// scratch layout per batch row: d1, h2, dz2, dz1 (128 each), dl (10), loss
constexpr int SCRATCH_PER_ROW = 4 * H1 + NC + 1;

// grads_kernel: each block owns TK rows of one gradient matrix, one thread
// per column; BT batch rows of the left operand pass through shared memory.
constexpr int TK = 8;
constexpr int BT = 32;
constexpr int THREADS_B = 128;
constexpr int TILES_GW1 = (IN + TK - 1) / TK;  // 98
constexpr int TILES_GW2 = H1 / TK;             // 16
constexpr int TILES_GW3 = H2 / TK;             // 16
constexpr int BLOCKS_B = TILES_GW1 + TILES_GW2 + TILES_GW3 + 1;

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
  __shared__ float xs[ROWS_A * IN];  // x rows, later the w2 tile
  __shared__ float d1s[ROWS_A * H1];
  __shared__ float h2s[ROWS_A * H2];
  __shared__ float dz2s[ROWS_A * H2];
  __shared__ float lg[ROWS_A * NC];  // logits, then dl

  const int tid = threadIdx.x;
  const int j = tid % H1;      // the column this thread owns
  const int r0 = (tid / H1) * RPT;  // its first row within the block
  const int row0 = blockIdx.x * ROWS_A;

  for (int i = tid; i < ROWS_A * IN; i += THREADS_A) {
    const int r = i / IN;
    const int row = row0 + r;
    xs[i] = row < batch ? x[(size_t)row * IN + (i - r * IN)] : 0.f;
  }
  __syncthreads();

  // ---- forward ----
  float z1[RPT], m[RPT], z2[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) z1[r] = 0.f;
  const float* xr = xs + r0 * IN;
#pragma unroll 4
  for (int k = 0; k < IN; ++k) {
    const float w = __ldg(w1 + k * H1 + j);
#pragma unroll
    for (int r = 0; r < RPT; ++r) z1[r] = fmaf(xr[r * IN + k], w, z1[r]);
  }
  const float bj1 = __ldg(b1 + j);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + r0 + r;
    z1[r] += bj1;
    m[r] = row < batch ? mask[(size_t)row * H1 + j] : 0.f;
    const float d1 = fmaxf(z1[r], 0.f) * m[r];
    d1s[(r0 + r) * H1 + j] = d1;
    if (row < batch) d1_out[(size_t)row * H1 + j] = d1;
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < RPT; ++r) z2[r] = 0.f;
#pragma unroll 4
  for (int k = 0; k < H1; ++k) {
    const float w = __ldg(w2 + k * H2 + j);
#pragma unroll
    for (int r = 0; r < RPT; ++r) z2[r] = fmaf(d1s[(r0 + r) * H1 + k], w, z2[r]);
  }
  const float bj2 = __ldg(b2 + j);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + r0 + r;
    z2[r] += bj2;
    const float h2 = fmaxf(z2[r], 0.f);
    h2s[(r0 + r) * H2 + j] = h2;
    if (row < batch) h2_out[(size_t)row * H2 + j] = h2;
  }
  __syncthreads();

  if (tid < ROWS_A * NC) {
    const int r = tid / NC;
    const int c = tid - r * NC;
    float acc = 0.f;
    for (int k = 0; k < H2; ++k) acc = fmaf(h2s[r * H2 + k], __ldg(w3 + k * NC + c), acc);
    lg[tid] = acc;
  }
  __syncthreads();

  // ---- stable softmax cross-entropy, one thread per row ----
  if (tid < ROWS_A) {
    const int row = row0 + tid;
    const bool valid = row < batch;
    float* l = lg + tid * NC;
    float mx = l[0];
    for (int c = 1; c < NC; ++c) mx = fmaxf(mx, l[c]);
    float ex[NC];
    float se = 0.f;
    for (int c = 0; c < NC; ++c) {
      ex[c] = expf(l[c] - mx);
      se += ex[c];
    }
    const int yr = valid ? y[row] : -1;
    float logit_y = 0.f;
    for (int c = 0; c < NC; ++c) logit_y += c == yr ? l[c] : 0.f;
    const float scale = valid ? inv_batch : 0.f;
    for (int c = 0; c < NC; ++c) {
      const float dl = (ex[c] / se - (c == yr ? 1.f : 0.f)) * scale;
      l[c] = dl;
      if (valid) dl_out[(size_t)row * NC + c] = dl;
    }
    if (valid) row_loss[row] = (mx + logf(se)) - logit_y;
  }
  __syncthreads();

  // ---- backward through fc3 and fc2 ----
  float wj3[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) wj3[c] = __ldg(w3 + j * NC + c);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + r0 + r;
    float dh2 = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) dh2 = fmaf(lg[(r0 + r) * NC + c], wj3[c], dh2);
    const float dz2 = dh2 * (z2[r] > 0.f ? 1.f : 0.f);
    dz2s[(r0 + r) * H2 + j] = dz2;
    if (row < batch) dz2_out[(size_t)row * H2 + j] = dz2;
  }

  // dd1 = dz2 w2^T: w2 is read by rows here, so it passes through shared
  // memory in (128 x KT) tiles, padded to KT + 1 against bank conflicts.
  float dd1[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) dd1[r] = 0.f;
  float* tile = xs;
  for (int k0 = 0; k0 < H2; k0 += KT) {
    __syncthreads();  // dz2s complete / previous tile consumed
    for (int i = tid; i < H1 * KT; i += THREADS_A) {
      const int jj = i / KT;
      const int kk = i - jj * KT;
      tile[jj * (KT + 1) + kk] = __ldg(w2 + jj * H2 + k0 + kk);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KT; ++kk) {
      const float w = tile[j * (KT + 1) + kk];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        dd1[r] = fmaf(dz2s[(r0 + r) * H2 + k0 + kk], w, dd1[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + r0 + r;
    if (row < batch)
      dz1_out[(size_t)row * H1 + j] = (dd1[r] * m[r]) * (z1[r] > 0.f ? 1.f : 0.f);
  }
}

// out[k][j] = sum over b = 0..B-1, in order, of a[b][k] * g[b][j], for the
// TK rows k0 .. k0+TK-1 of out. One thread per column j < n.
__device__ void at_g_tile(const float* __restrict__ a, int lda, int ka,
                          const float* __restrict__ g, int n,
                          float* __restrict__ out, int k0, int batch) {
  __shared__ float as[BT][TK];
  const int j = threadIdx.x;
  float acc[TK];
#pragma unroll
  for (int kk = 0; kk < TK; ++kk) acc[kk] = 0.f;
  for (int b0 = 0; b0 < batch; b0 += BT) {
    for (int i = threadIdx.x; i < BT * TK; i += THREADS_B) {
      const int bb = i / TK;
      const int kk = i - bb * TK;
      const int b = b0 + bb;
      const int k = k0 + kk;
      as[bb][kk] = (b < batch && k < ka) ? a[(size_t)b * lda + k] : 0.f;
    }
    __syncthreads();
    if (j < n) {
      const int nb = min(BT, batch - b0);
      for (int bb = 0; bb < nb; ++bb) {
        const float gv = g[(size_t)(b0 + bb) * n + j];
#pragma unroll
        for (int kk = 0; kk < TK; ++kk) acc[kk] = fmaf(as[bb][kk], gv, acc[kk]);
      }
    }
    __syncthreads();
  }
  if (j < n) {
#pragma unroll
    for (int kk = 0; kk < TK; ++kk)
      if (k0 + kk < ka) out[(k0 + kk) * n + j] = acc[kk];
  }
}

__global__ void __launch_bounds__(THREADS_B) grads_kernel(
    const float* __restrict__ x, const float* __restrict__ d1,
    const float* __restrict__ h2, const float* __restrict__ dz2,
    const float* __restrict__ dz1, const float* __restrict__ dl,
    const float* __restrict__ row_loss,
    float* __restrict__ loss, float* __restrict__ gw1, float* __restrict__ gb1,
    float* __restrict__ gw2, float* __restrict__ gb2, float* __restrict__ gw3,
    int batch) {
  int t = blockIdx.x;
  if (t < TILES_GW1) {
    at_g_tile(x, IN, IN, dz1, H1, gw1, t * TK, batch);
    return;
  }
  t -= TILES_GW1;
  if (t < TILES_GW2) {
    at_g_tile(d1, H1, H1, dz2, H2, gw2, t * TK, batch);
    return;
  }
  t -= TILES_GW2;
  if (t < TILES_GW3) {
    at_g_tile(h2, H2, H2, dl, NC, gw3, t * TK, batch);
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

static_assert(THREADS_B == H1 && H1 == H2, "bias block: one thread per unit");

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
  grads_kernel<<<BLOCKS_B, THREADS_B, 0, s>>>(
      x, d1, h2, dz2, dz1, dl, rl, loss, gw1, gb1, gw2, gb2, gw3, batch);
  return static_cast<int>(cudaGetLastError());
}
