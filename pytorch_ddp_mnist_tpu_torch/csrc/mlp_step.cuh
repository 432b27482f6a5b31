// The per-row and per-gradient-element math of one training step of the
// reference MLP, shared by K1 (fused_step.cu, one step per call) and K2
// (epoch_step.cu, a whole epoch per launch).
//
//   z1 = x w1 + b1          d1 = relu(z1) * m       z2 = d1 w2 + b2
//   h2 = relu(z2)           logits = h2 w3          loss_b = lse - logit_y
//   dl = (softmax - onehot) / B
//   dz2 = (dl w3^T) * [z2 > 0]                      dz1 = (dz2 w2^T) * m * [z1 > 0]
//   gw3 = h2^T dl   gw2 = d1^T dz2   gw1 = x^T dz1   gb2 = sum dz2   gb1 = sum dz1
//
// `rows_block` is the first half: ROWS_A batch rows per block of THREADS_A
// threads, writing each row's activations, activation gradients and loss
// to scratch. `at_g_tile` is the second: TK rows of one weight gradient,
// one thread per column, each summing over the batch rows in order 0..B-1
// (no atomics, so every launch gives the same bits).
//
// Three things vary between the kernels:
//  * `L`, how weights and scratch are loaded. K1's weights do not change
//    during a launch and go through the read-only cache (`LdgLoad`). K2
//    updates its weights inside the launch, from other blocks, so all its
//    loads of weights and scratch bypass L1 and read L2 (`CgLoad`,
//    ld.global.cg): a stale L1 line can never be read after a grid sync.
//  * the pixel type: f32 rows are taken as they are; uint8 rows are
//    normalised as they are loaded, (v / 255 - mean) / std in f32 with true
//    divisions, in the op order of normalize_images (bitwise the same). A
//    template parameter of rows_block, a run-time choice in at_g_tile.
//  * `MaskAt` (rows_block), the dropout mask source: a functor (row in the step, column)
//    -> 0 or 1/keep. K1 reads a mask array; K2 reads one or draws it.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace mlp {

constexpr int IN = 784;
constexpr int H1 = 128;
constexpr int H2 = 128;
constexpr int NC = 10;

// rows_block: ROWS_A rows per block, THREADS_A = 2 row groups x 128
// columns, each thread RPT rows of one column.
constexpr int ROWS_A = 8;
constexpr int RPT = 4;
constexpr int THREADS_A = H1 * ROWS_A / RPT;
constexpr int KT = 32;  // w2 tile width for dz2 w2^T

// scratch layout per batch row: d1, h2, dz2, dz1 (128 each), dl (10), loss
constexpr int SCRATCH_PER_ROW = 4 * H1 + NC + 1;

// at_g_tile: TK rows of one gradient matrix, TILE_THREADS threads (one per
// column); BT batch rows of the left operand pass through shared memory.
constexpr int TK = 8;
constexpr int BT = 32;
constexpr int TILE_THREADS = 128;
constexpr int TILES_GW1 = (IN + TK - 1) / TK;  // 98
constexpr int TILES_GW2 = H1 / TK;             // 16
constexpr int TILES_GW3 = H2 / TK;             // 16
constexpr int GRAD_TILES = TILES_GW1 + TILES_GW2 + TILES_GW3;

static_assert(TILE_THREADS == H1 && H1 == H2, "one thread per hidden unit");

struct LdgLoad {
  __device__ static float w(const float* p) { return __ldg(p); }
  __device__ static float s(const float* p) { return *p; }
};

struct CgLoad {
  __device__ static float w(const float* p) { return __ldcg(p); }
  __device__ static float s(const float* p) { return __ldcg(p); }
};

__device__ __forceinline__ float pixel(float v) { return v; }

__device__ __forceinline__ float pixel(uint8_t v) {
  // normalize_images: /255, then -mean, then /std, each rounded to f32
  // (no --use_fast_math, so `/` is the IEEE division)
  return (static_cast<float>(v) / 255.0f - 0.1307f) / 0.3081f;
}

// Rows row0 .. row0 + ROWS_A - 1 of one step. Rows past `batch` load as
// zeros and are never written. Needs blockDim.x == THREADS_A.
template <class L, class XT, class MaskAt>
__device__ void rows_block(
    const XT* __restrict__ x, const int* __restrict__ y, MaskAt mask_at,
    const float* w1, const float* b1, const float* w2, const float* b2,
    const float* w3, float* __restrict__ d1_out, float* __restrict__ h2_out,
    float* __restrict__ dz2_out, float* __restrict__ dz1_out,
    float* __restrict__ dl_out, float* __restrict__ row_loss, int row0,
    int batch, float inv_batch) {
  __shared__ float xs[ROWS_A * IN];  // x rows, later the w2 tile
  __shared__ float d1s[ROWS_A * H1];
  __shared__ float h2s[ROWS_A * H2];
  __shared__ float dz2s[ROWS_A * H2];
  __shared__ float lg[ROWS_A * NC];  // logits, then dl

  const int tid = threadIdx.x;
  const int j = tid % H1;           // the column this thread owns
  const int r0 = (tid / H1) * RPT;  // its first row within the block

  __syncthreads();  // a previous call's shared memory reads are done
  for (int i = tid; i < ROWS_A * IN; i += THREADS_A) {
    const int r = i / IN;
    const int row = row0 + r;
    xs[i] = row < batch ? pixel(x[(size_t)row * IN + (i - r * IN)]) : 0.f;
  }
  __syncthreads();

  // ---- forward ----
  float z1[RPT], m[RPT], z2[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) z1[r] = 0.f;
  const float* xr = xs + r0 * IN;
#pragma unroll 4
  for (int k = 0; k < IN; ++k) {
    const float w = L::w(w1 + k * H1 + j);
#pragma unroll
    for (int r = 0; r < RPT; ++r) z1[r] = fmaf(xr[r * IN + k], w, z1[r]);
  }
  const float bj1 = L::w(b1 + j);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + r0 + r;
    z1[r] += bj1;
    m[r] = row < batch ? mask_at(row, j) : 0.f;
    const float d1 = fmaxf(z1[r], 0.f) * m[r];
    d1s[(r0 + r) * H1 + j] = d1;
    if (row < batch) d1_out[(size_t)row * H1 + j] = d1;
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < RPT; ++r) z2[r] = 0.f;
#pragma unroll 4
  for (int k = 0; k < H1; ++k) {
    const float w = L::w(w2 + k * H2 + j);
#pragma unroll
    for (int r = 0; r < RPT; ++r) z2[r] = fmaf(d1s[(r0 + r) * H1 + k], w, z2[r]);
  }
  const float bj2 = L::w(b2 + j);
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
    for (int k = 0; k < H2; ++k) acc = fmaf(h2s[r * H2 + k], L::w(w3 + k * NC + c), acc);
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
  for (int c = 0; c < NC; ++c) wj3[c] = L::w(w3 + j * NC + c);
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
      tile[jj * (KT + 1) + kk] = L::w(w2 + jj * H2 + k0 + kk);
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

// The gradient matrix and rows of tile t < GRAD_TILES: gw1 rows in tiles
// 0..97, gw2 in 98..113, gw3 in 114..129, TK rows each.
struct GradTile {
  int which;  // 0: gw1 = x^T dz1, 1: gw2 = d1^T dz2, 2: gw3 = h2^T dl
  int k0;     // first row of the tile
};

__device__ __forceinline__ GradTile grad_tile(int t) {
  if (t < TILES_GW1) return {0, t * TK};
  t -= TILES_GW1;
  if (t < TILES_GW2) return {1, t * TK};
  return {2, (t - TILES_GW2) * TK};
}

// out[k][j] = sum over b = 0..B-1, in order, of a[b][k] * g[b][j], for the
// TK rows k0 .. k0+TK-1 of out; `store(k, j, value)` writes each element.
// The left operand is f32 (`af`: scratch, or f32 rows) or, where `au` is
// not null, raw uint8 rows normalised as in rows_block: a run-time choice,
// so that the two halves of a K2 block run one code path with one set of
// barriers. `lt` in [0, TILE_THREADS) is this thread's index within the
// threads that share `as`; every thread of the block must call this the
// same number of times with the same `batch` (it holds __syncthreads). A
// call with n = 0 and ka = 0 touches no memory outside `as`: an idle part
// of the block.
template <class L, class Store>
__device__ void at_g_tile(float (*as)[TK], int lt, const float* af,
                          const uint8_t* au, int lda, int ka, const float* g,
                          int n, int k0, int batch, Store store) {
  const int j = lt;
  float acc[TK];
#pragma unroll
  for (int kk = 0; kk < TK; ++kk) acc[kk] = 0.f;
  for (int b0 = 0; b0 < batch; b0 += BT) {
    for (int i = lt; i < BT * TK; i += TILE_THREADS) {
      const int bb = i / TK;
      const int kk = i - bb * TK;
      const int b = b0 + bb;
      const int k = k0 + kk;
      float v = 0.f;
      if (b < batch && k < ka) {
        const size_t at = (size_t)b * lda + k;
        v = au != nullptr ? pixel(au[at]) : L::s(af + at);
      }
      as[bb][kk] = v;
    }
    __syncthreads();
    if (j < n) {
      const int nb = min(BT, batch - b0);
      for (int bb = 0; bb < nb; ++bb) {
        const float gv = L::s(g + (size_t)(b0 + bb) * n + j);
#pragma unroll
        for (int kk = 0; kk < TK; ++kk) acc[kk] = fmaf(as[bb][kk], gv, acc[kk]);
      }
    }
    __syncthreads();
  }
  if (j < n) {
#pragma unroll
    for (int kk = 0; kk < TK; ++kk)
      if (k0 + kk < ka) store(k0 + kk, j, acc[kk]);
  }
}

}  // namespace mlp
