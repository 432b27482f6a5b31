// The per-row and per-gradient-element math of one training step of the
// reference MLP, shared by K1 (fused_step.cu, one step per call) and K2
// (epoch_step.cu, a whole epoch per launch); K1-split (fused_split.cu) and
// K2-ws (epoch_ws.cu) keep the same chains in their own loops and take the
// constants, the mask sources and the pixel normalise from here, as do the
// tensor-core designs (mma_step.cuh: K1-mma and K2-mma).
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
// (no atomics, so every launch gives the same bits). The in-kernel dropout
// streams both kernels draw from (Philox4x32-10, jax's threefry-2x32) are
// device functions here too.
//
// Four things vary between the kernels:
//  * `L`, how weights and scratch are loaded. K1's weights do not change
//    during a launch and go through the read-only cache (`LdgLoad`). K2
//    updates its weights inside the launch, from other blocks, so all its
//    loads of weights and scratch bypass L1 and read L2 (`CgLoad`,
//    ld.global.cg): a stale L1 line can never be read after a grid sync.
//  * the pixel type: f32 rows are taken as they are; bf16 rows are widened;
//    uint8 rows are normalised as they are loaded, (v / 255 - mean) / std in
//    f32 with true divisions, in the op order of normalize_images (bitwise
//    the same). A template parameter of rows_block, a run-time choice in
//    at_g_tile.
//  * `MaskAt` (rows_block), the dropout mask source: a functor (row in the
//    step, column) -> 0 or 1/keep. K1 reads a mask array, draws Philox
//    per (seed, batch block) or draws jax's threefry under a key it reads
//    from device memory; K2 reads one or draws it per step.
//  * `BF`, the bf16-operand mode (compute_bf16 of the TPU kernels): every
//    operand of the six products is rounded to bf16 (round to nearest even)
//    where it is loaded, and everything else stays f32. A product of two
//    bf16 values is exact in f32, so each fmaf adds the exact product: the
//    FFMA loops and their fixed summation order are K1's own. The cast
//    points are those of pallas_step.py `_make_fused_kernel` and
//    `step_reference_bf16`: x and the weights at each product; d1 (-> z2,
//    gw2), h2 (-> logits, gw3) and dl (-> gw3, dh2) rounded once where they
//    are made; dz2 rounded for dd1 and gw2 but summed unrounded into gb2;
//    dz1 rounded for gw1 only and summed unrounded into gb1.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
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

__device__ __forceinline__ float pixel(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float pixel(uint8_t v) {
  // normalize_images: /255, then -mean, then /std, each rounded to f32
  // (no --use_fast_math, so `/` is the IEEE division)
  return (static_cast<float>(v) / 255.0f - 0.1307f) / 0.3081f;
}

// An operand of a product: itself in f32 mode, rounded to bf16 (and held in
// f32, where it is exact) in bf16 mode. Rounding twice is rounding once.
template <bool BF>
__device__ __forceinline__ float opnd(float v) {
  if constexpr (BF)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

// One x element as f32: f32 rows through L (K2 writes its staged rows
// inside the launch, so they must not come from a stale L1 line); uint8 and
// bf16 rows are inputs only.
template <class L>
__device__ __forceinline__ float load_x(const float* p) { return L::s(p); }
template <class L>
__device__ __forceinline__ float load_x(const uint8_t* p) { return pixel(*p); }
template <class L>
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) {
  return pixel(*p);
}

// ---- the in-kernel dropout streams ----

// the epoch kernels' dropout sources, by the codes ops/epoch_step.py passes
enum Rng : int { RNG_MASKS = 0, RNG_THREEFRY = 1, RNG_PHILOX = 2 };

constexpr float KEEP = 0.8f;                   // f32(1 - DROPOUT_RATE)
constexpr uint32_t KEEP_THRESH = 3435973837u;  // round(0.8 * 2**32)

// Philox4x32-10 (Random123 constants) of counter (idx, word1, 0, 0) under
// key (k0, k1), output word 0: ops/philox.py computes the same bits. word1
// is the replica of a data-parallel ring (K6), 0 everywhere else.
__device__ __forceinline__ uint32_t philox_bits(uint32_t k0, uint32_t k1,
                                                uint32_t idx,
                                                uint32_t word1 = 0) {
  uint32_t c0 = idx, c1 = word1, c2 = 0, c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return c0;
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

// jax's threefry-2x32 of counter words (0, idx) under key (k0, k1); the
// two outputs xor-ed, as jax.random.bits does for 32-bit draws.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t idx) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = k0;
  uint32_t x1 = idx + k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][r]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return x0 ^ x1;
}

// _threefry_mask_block for one element: uniform's mantissa fill, max 0,
// `u < keep`, scale f32(1)/keep
__device__ __forceinline__ float threefry_mask(uint32_t k0, uint32_t k1,
                                               int row, int col) {
  const uint32_t bits = threefry_bits(
      k0, k1, (static_cast<uint32_t>(row) << 7) | static_cast<uint32_t>(col));
  float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  u = fmaxf(0.0f, u);
  return u < KEEP ? 1.0f / KEEP : 0.0f;
}

// the core form's keep test and scale, f32(1.0 / (1.0 - DROPOUT_RATE)), for
// element (row, col) of the (rows, 128) block keyed (k0, k1), of replica
// `replica` of a data-parallel ring
__device__ __forceinline__ float philox_mask(uint32_t k0, uint32_t k1,
                                             int row, int col,
                                             uint32_t replica = 0) {
  return philox_bits(k0, k1, static_cast<uint32_t>(row * H1 + col),
                     replica) <
                 KEEP_THRESH
             ? static_cast<float>(1.0 / (1.0 - 0.2))
             : 0.0f;
}

// K1's mask input: the pre-drawn (batch, 128) array
struct ArrayMask {
  const float* mask;
  __device__ float operator()(int row, int col) const {
    return mask[(size_t)row * H1 + col];
  }
};

// K1-rng's mask (pallas_step.py `fused_loss_and_grads_rng`): the TPU seeds
// its core PRNG per (step seed, batch block of `_run_fused`'s grid) and draws
// a (block, 128) array per block; here each block is the Philox block keyed
// (seed, block index), so row r of the batch is row r % block of block
// r / block.
struct PhiloxBlockMask {
  uint32_t seed;
  int block;
  __device__ float operator()(int row, int col) const {
    const int b = row / block;
    return philox_mask(seed, static_cast<uint32_t>(b), row - b * block, col);
  }
};

// K1-rng's mask with its seed read from device memory: word 0 of a row of
// the per-step loops' key table (ops/threefry.py `step_key_words`), so a
// step captured in a CUDA graph draws the seed the table holds at replay,
// not the one it held at capture. The same draw as PhiloxBlockMask of that
// word, bit for bit.
struct PhiloxKeyMask {
  const uint32_t* key;  // word 0 is the seed; 8-byte aligned (a table row)
  int block;
  __device__ float operator()(int row, int col) const {
    return PhiloxBlockMask{__ldg(key), block}(row, col);
  }
};

// K1's keyed mask (K1-split, K1-mma; ops/fused_step.py
// `fused_loss_and_grads_keyed`): jax's `dropout_mask(key, batch)` drawn in
// the kernel, the key's two words read from device memory (a row of the
// per-step loops' key table, ops/threefry.py `step_key_table`), so no key
// is a launch argument. A thread reads the 8 bytes once, with one load; the
// threads of a warp read the same address, which the warp serves as one
// broadcast.
struct ThreefryKeyMask {
  const uint32_t* key;  // (k0, k1), 8-byte aligned
  __device__ float operator()(int row, int col) const {
    const uint2 k = __ldg(reinterpret_cast<const uint2*>(key));
    return threefry_mask(k.x, k.y, row, col);
  }
};

// the floats of layer p = 0..4 (w1, b1, w2, b2, w3)
__device__ __forceinline__ int layer_size(int p) {
  return p == 0 ? IN * H1 : p == 1 ? H1 : p == 2 ? H1 * H2 : p == 3 ? H2 : H2 * NC;
}

// The epoch kernels' mask of one step (K2, K6, K2-mma), a (row in the
// step, column) functor: the step's rows of the pre-drawn masks; threefry
// under the step's key words (k0, k1); or Philox keyed (epoch seed k0, step
// k1) at counter row*128 + col, word 1 the ring replica (0 but in K6).
template <int RNG>
struct StepMask {
  const float* masks;
  uint32_t k0, k1, replica;
  __device__ float operator()(int row, int col) const {
    if constexpr (RNG == RNG_MASKS) {
      return masks[(size_t)row * H1 + col];
    } else if constexpr (RNG == RNG_THREEFRY) {
      return threefry_mask(k0, k1, row, col);
    } else {
      return philox_mask(k0, k1, row, col, replica);
    }
  }
};

// rows_block's shared memory. It lives in one non-template function so that
// every instantiation of rows_block in a kernel (K2's staged and unstaged
// rows) uses the same 38,720 bytes.
struct RowsShared {
  float xs[ROWS_A * IN];  // x rows, later the w2 tile
  float d1s[ROWS_A * H1];
  float h2s[ROWS_A * H2];
  float dz2s[ROWS_A * H2];
  float lg[ROWS_A * NC];  // logits, then dl
};

__device__ __forceinline__ RowsShared& rows_shared() {
  __shared__ RowsShared sm;
  return sm;
}

// Rows row0 .. row0 + ROWS_A - 1 of one step. Rows past `batch` load as
// zeros and are never written. Needs blockDim.x == THREADS_A.
template <class L, bool BF, class XT, class MaskAt>
__device__ void rows_block(
    const XT* __restrict__ x, const int* __restrict__ y, MaskAt mask_at,
    const float* w1, const float* b1, const float* w2, const float* b2,
    const float* w3, float* __restrict__ d1_out, float* __restrict__ h2_out,
    float* __restrict__ dz2_out, float* __restrict__ dz1_out,
    float* __restrict__ dl_out, float* __restrict__ row_loss, int row0,
    int batch, float inv_batch) {
  RowsShared& sm = rows_shared();
  float* const xs = sm.xs;
  float* const d1s = sm.d1s;
  float* const h2s = sm.h2s;
  float* const dz2s = sm.dz2s;
  float* const lg = sm.lg;

  const int tid = threadIdx.x;
  const int j = tid % H1;           // the column this thread owns
  const int r0 = (tid / H1) * RPT;  // its first row within the block

  __syncthreads();  // a previous call's shared memory reads are done
  for (int i = tid; i < ROWS_A * IN; i += THREADS_A) {
    const int r = i / IN;
    const int row = row0 + r;
    xs[i] = row < batch
                ? opnd<BF>(load_x<L>(x + (size_t)row * IN + (i - r * IN)))
                : 0.f;
  }
  __syncthreads();

  // ---- forward ----
  float z1[RPT], m[RPT], z2[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) z1[r] = 0.f;
  const float* xr = xs + r0 * IN;
#pragma unroll 4
  for (int k = 0; k < IN; ++k) {
    const float w = opnd<BF>(L::w(w1 + k * H1 + j));
#pragma unroll
    for (int r = 0; r < RPT; ++r) z1[r] = fmaf(xr[r * IN + k], w, z1[r]);
  }
  const float bj1 = L::w(b1 + j);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + r0 + r;
    z1[r] += bj1;
    m[r] = row < batch ? mask_at(row, j) : 0.f;
    const float d1 = opnd<BF>(fmaxf(z1[r], 0.f) * m[r]);
    d1s[(r0 + r) * H1 + j] = d1;
    if (row < batch) d1_out[(size_t)row * H1 + j] = d1;
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < RPT; ++r) z2[r] = 0.f;
#pragma unroll 4
  for (int k = 0; k < H1; ++k) {
    const float w = opnd<BF>(L::w(w2 + k * H2 + j));
#pragma unroll
    for (int r = 0; r < RPT; ++r) z2[r] = fmaf(d1s[(r0 + r) * H1 + k], w, z2[r]);
  }
  const float bj2 = L::w(b2 + j);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + r0 + r;
    z2[r] += bj2;
    const float h2 = opnd<BF>(fmaxf(z2[r], 0.f));
    h2s[(r0 + r) * H2 + j] = h2;
    if (row < batch) h2_out[(size_t)row * H2 + j] = h2;
  }
  __syncthreads();

  if (tid < ROWS_A * NC) {
    const int r = tid / NC;
    const int c = tid - r * NC;
    float acc = 0.f;
    for (int k = 0; k < H2; ++k)
      acc = fmaf(h2s[r * H2 + k], opnd<BF>(L::w(w3 + k * NC + c)), acc);
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
      const float dl = opnd<BF>((ex[c] / se - (c == yr ? 1.f : 0.f)) * scale);
      l[c] = dl;
      if (valid) dl_out[(size_t)row * NC + c] = dl;
    }
    if (valid) row_loss[row] = (mx + logf(se)) - logit_y;
  }
  __syncthreads();

  // ---- backward through fc3 and fc2 ----
  float wj3[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) wj3[c] = opnd<BF>(L::w(w3 + j * NC + c));
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + r0 + r;
    float dh2 = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) dh2 = fmaf(lg[(r0 + r) * NC + c], wj3[c], dh2);
    const float dz2 = dh2 * (z2[r] > 0.f ? 1.f : 0.f);
    dz2s[(r0 + r) * H2 + j] = opnd<BF>(dz2);  // for dd1
    if (row < batch) dz2_out[(size_t)row * H2 + j] = dz2;  // gb2 sums it as is
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
      tile[jj * (KT + 1) + kk] = opnd<BF>(L::w(w2 + jj * H2 + k0 + kk));
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
// The left operand is f32 (`af`: scratch, or f32 rows), or, where `au` or
// `ab` is not null, raw uint8 rows normalised as in rows_block or bf16 rows:
// a run-time choice, so that the two halves of a K2 block run one code path
// with one set of barriers. In bf16 mode both operands are rounded as they
// are loaded (the scratch keeps dz1 and dz2 unrounded for the biases). `lt` in [0, TILE_THREADS) is this thread's index within the
// threads that share `as`; every thread of the block must call this the
// same number of times with the same `batch` (it holds __syncthreads). A
// call with n = 0 and ka = 0 touches no memory outside `as`: an idle part
// of the block.
template <class L, bool BF, class Store>
__device__ void at_g_tile(float (*as)[TK], int lt, const float* af,
                          const uint8_t* au, const __nv_bfloat16* ab, int lda,
                          int ka, const float* g, int n, int k0, int batch,
                          Store store) {
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
        v = au != nullptr   ? pixel(au[at])
            : ab != nullptr ? pixel(ab[at])
                            : L::s(af + at);
      }
      as[bb][kk] = opnd<BF>(v);
    }
    __syncthreads();
    if (j < n) {
      const int nb = min(BT, batch - b0);
      for (int bb = 0; bb < nb; ++bb) {
        const float gv = opnd<BF>(L::s(g + (size_t)(b0 + bb) * n + j));
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
