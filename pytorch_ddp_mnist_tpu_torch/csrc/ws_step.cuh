// The weight-stationary step of K2-ws (epoch_ws.cu), shared with K6-ws
// (ring_ws.cu): one training step of the reference MLP on one replica's G =
// 128 / COLS blocks of THREADS threads, block g owning the COLS hidden
// units j = g*COLS .. g*COLS + COLS - 1 ("column owners"): w1[:, j], b1[j],
// row j of w2 (the pre-update operand of dd1), b2[j] and a full copy of w3,
// all in shared memory for the whole epoch. The z1 and gw1 chains of unit j
// run on its owner, so all 128 units' chains run on G SMs at once.
//
//  * Per step, two barriers over the replica's blocks (`Ctx::sync`: a grid
//    sync in K2-ws, a replica barrier in K6-ws). (1) cp.async copies the
//    step's rows (B x 784 uint8) into shared memory; z1[:, j] = one fmaf
//    chain a row over k = 0..783, + b1[j]; the mask at (b, j) drawn
//    meanwhile by the threads the chains leave idle; d1[:, j] out to the
//    exchange. Barrier. (2) All of d1 in, and w2's columns j (from a
//    transposed copy the row owners keep); z2[:, j]; h2[:, j] out. Barrier.
//    (3) All of h2 in; every block computes the logits, loss and dl of all
//    rows, gw3, and dz2 of EVERY unit (not only its own) from the
//    pre-update w3: the same chains in every block, so the same bits, and
//    no third barrier and dz2 exchange. (4) dd1[:, j] from the PRE-update
//    w2 row j (beside gw2[j, :] on threads 128..255); dz1[:, j], gb1[j],
//    gw1[:, j] from the rows still in shared memory. Step s+1 writes an
//    exchange array only after a barrier that every reader of step s's
//    copy has passed, so one buffer each is enough. Exchange reads are
//    cp.async.cg into shared memory (L2, never a stale L1 line, all of a
//    thread's copies in flight at once), rows padded to 132 floats so that
//    the per-row chains read float4s with no bank conflict.
//  * Every gradient goes to the caller's `Ctx` at the point where K2-ws
//    updates it: gw3 (every row, every block), gb2 and the loss after dz2;
//    the gw2 row after every read of the pre-update w2 row; gw1 and gb1
//    last. K2-ws applies `w - lr * g` in shared memory there; K6-ws writes
//    the block's own elements into the ring's buffer and updates after the
//    ring (ring_ws.cu).
//  * The uint8 normalise is a 256-entry f32 table, filled once per launch
//    by pixel()'s own expression (the same bits as the two IEEE divisions,
//    with one shared-memory load), held once per lane of a warp (32 KB), so
//    a warp's 32 lookups hit 32 banks whatever the pixels.
//  * Shared memory: buffers that no phase uses at the same time share one
//    region (w2's columns in phase 2, the mask in phase 1 and the row
//    losses in phase 3; the logits and dl in phase 3 and dz1 in phase 4).
//    That is what lets COLS = 4 fit beside the per-lane table (231,200 B of
//    the 232,448 a block may use); COLS = 8 does not (249,920 B).
//
// The bitwise contract: every output element is ONE sequential chain in
// mlp_step.cuh's order (z1: fmaf over k = 0..783 from 0, then + b1; z2:
// fmaf over k = 0..127, + b2, ReLU; logits: fmaf over k = 0..127; the
// softmax and loss as written there; dh2: fmaf over c = 0..9, dz2 = dh2 *
// [z2 > 0]; dd1: fmaf over i = 0..127, dz1 = (dd1 * m) * [z1 > 0]; each
// weight gradient fmaf over b = 0..B-1 from 0; biases and the loss plain
// adds over b in order). No split-K, no float atomics; built without
// --use_fast_math. So the gradients are K1's bits at any COLS.

#pragma once

#include <cstdint>

#include "mlp_step.cuh"

namespace ws {

using namespace mlp;

constexpr int THREADS = 256;
constexpr int B_MAX = 128;       // rows a step; threads 0..B-1 own a row
constexpr int HALF = THREADS / 2;
static_assert(B_MAX <= HALF && H2 == HALF, "rows and gw3/gw2 thread halves");
// exchange rows in shared memory: 132 floats, so a row starts 16-byte
// aligned (cp.async, float4 loads) and lanes that own rows b = 0..7 read
// 16 bytes each from distinct banks (132 = 4 mod 32)
constexpr int LD = H1 + 4;
constexpr int LG = 12;           // logits / dl row: 10 classes + 2 pad
// w3 in shared memory: rows 4q .. 4q+3 (40 floats) at 44 q, so that lanes
// reading the chunks q = g + 8m (g = 0..7) hit distinct banks (44 = 12 mod
// 32) and each chunk starts 16-byte aligned
constexpr int W3C = 4 * NC + 4;
__host__ __device__ constexpr int w3i(int k, int c) {
  return (k >> 2) * W3C + (k & 3) * NC + c;
}
constexpr int XW = IN / 4;       // 32-bit words of one uint8 row (196)
constexpr int XQ = IN / 16;      // 16-byte chunks of one row (49)
// the normalise table, one copy per lane: entry v of lane l at v*32 + l,
// so a warp's 32 lookups of any 32 pixel values hit 32 distinct banks
constexpr int TCOPIES = 32;
constexpr size_t SMEM_LIMIT = 232448;  // the 227 KB a block may use

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The sizes of a step at COLS hidden units a block.
template <int COLS>
struct Shape {
  static constexpr int NBLK = H1 / COLS;  // blocks of one replica
  // w2's columns (phase 2), overlaid by the mask (phase 1) and the row
  // losses (phase 3)
  static constexpr int R_W2C = cmax(COLS * H1, cmax(COLS * B_MAX, B_MAX));
  // the logits, then dl (phase 3), overlaid by dz1 (phase 4)
  static constexpr int R_LG = cmax(B_MAX * LG, COLS * B_MAX);
  static constexpr size_t SMEM_BYTES =
      (size_t)B_MAX * IN +
      sizeof(float) * ((size_t)B_MAX * LD + 256 * TCOPIES + COLS * IN +
                       COLS * H2 + R_W2C + (H2 / 4) * W3C + R_LG +
                       COLS * B_MAX + 2 * COLS);
  static constexpr bool FITS = SMEM_BYTES <= SMEM_LIMIT;
};
static_assert((B_MAX * IN) % 16 == 0 && LD % 4 == 0 && B_MAX % 4 == 0,
              "f32 arrays and rows 16-byte aligned");

// Shared memory, carved from one dynamic allocation.
struct Smem {
  uint8_t* xs;   // [B_MAX][784] the step's rows
  float* buf;    // [B_MAX][LD]  d1, then h2, then dz2 of all units
  float* tbl;    // [256][TCOPIES] pixel(v), one copy per lane
  float* w1c;    // [COLS][784]  w1[:, j]
  float* w2r;    // [COLS][128]  w2[j, :]
  float* w2c;    // [COLS][128]  w2[:, j], read each step (phase 2)
  float* mv;     // [COLS][B_MAX] the step's dropout mask at (b, j) (phase 1)
  float* rl;     // [B_MAX]      row losses (phase 3)
  float* w3s;    // [32][W3C]    w3, in chunks of 4 rows (w3i)
  float* lg;     // [B_MAX][LG]  logits, then dl (phase 3)
  float* dz1v;   // [COLS][B_MAX] (phase 4)
  float* d1v;    // [COLS][B_MAX]
  float* bias;   // [2][COLS]    b1[j], b2[j]
};

template <int COLS>
__device__ __forceinline__ Smem carve(unsigned char* p) {
  using S = Shape<COLS>;
  Smem s;
  s.xs = p;
  float* f = reinterpret_cast<float*>(p + (size_t)B_MAX * IN);
  s.buf = f;  f += B_MAX * LD;
  s.tbl = f;  f += 256 * TCOPIES;
  s.w1c = f;  f += COLS * IN;
  s.w2r = f;  f += COLS * H2;
  s.w2c = s.mv = s.rl = f;  f += S::R_W2C;
  s.w3s = f;  f += (H2 / 4) * W3C;
  s.lg = s.dz1v = f;  f += S::R_LG;
  s.d1v = f;  f += COLS * B_MAX;
  s.bias = f;
  return s;
}

// Phase boundaries a step reports to `Ctx::stamp` (block 0, thread 0 after
// a barrier; ST_GW3 by thread HALF, see Ctx::stamp_gw3).
enum Stamp : int {
  ST_START,      // step start
  ST_ROWS,       // rows in shared memory
  ST_Z1,         // z1 chains, masks, d1 out
  ST_BAR1,       // barrier 1
  ST_D1_IN,      // d1 exchange in
  ST_Z2,         // z2 chains, h2 out
  ST_BAR2,       // barrier 2
  ST_H2_IN,      // h2 exchange in
  ST_LOGITS,     // logits, softmax, loss, dl
  ST_GW3,        // gw3 (thread HALF's chains)
  ST_DZ2,        // dz2 of every unit, in place of h2
  ST_DD1,        // w3, b2 gradients; dd1, dz1, gw2 row
  ST_GW1,        // gb1, gw1
  N_STAMPS
};

// A step's dropout source, per replica.
struct MaskSrc {
  const float* masks;    // (S*B, 128) pre-scaled      (RNG_MASKS)
  const int* keys;       // (S, 2) per-step key words  (RNG_THREEFRY)
  uint32_t seed;         // epoch seed                 (RNG_PHILOX)
  uint32_t replica;      // Philox counter word 1 (0 in K2-ws)
  int batch;
};

// the dropout mask at (row in the step, column), as epoch_step.cu draws it
template <int RNG>
__device__ __forceinline__ float mask_at(const MaskSrc& a, int step, int row,
                                         int col) {
  if constexpr (RNG == RNG_MASKS) {
    return a.masks[((size_t)step * a.batch + row) * H1 + col];
  } else if constexpr (RNG == RNG_THREEFRY) {
    return threefry_mask(static_cast<uint32_t>(a.keys[2 * step]),
                         static_cast<uint32_t>(a.keys[2 * step + 1]), row,
                         col);
  } else {
    return philox_mask(a.seed, static_cast<uint32_t>(step), row, col,
                       a.replica);
  }
}

// What a replica's steps read, and its exchange buffers.
struct StepIO {
  const uint8_t* x;      // (S*B, 784) the epoch's gathered rows
  const int* y;          // (S*B,)
  MaskSrc mask;
  float* d1x;            // (B, 128) d1 exchange
  float* h2x;            // (B, 128) h2 exchange
  float* w2t;            // (128, 128) w2 transposed, written by row owners
  int batch;
  float inv_batch;
};

// the normalise table, TCOPIES copies: pixel()'s own expression, so the
// same bits as the division, with none in the loops
__device__ __forceinline__ void fill_table(float* tbl) {
  for (int i = threadIdx.x; i < 256 * TCOPIES; i += blockDim.x)
    tbl[i] = pixel(static_cast<uint8_t>(i / TCOPIES));
}

// pixel(byte e of word w) from this lane's copy of the table: entry v of
// lane l is at byte v*128 + l*4, so the offset is one shift and one
// and-or of the word (lane4 = l*4 holds bits 2..6, the byte bits 7..14)
static_assert(TCOPIES * sizeof(float) == 128, "entry stride of 128 bytes");
__device__ __forceinline__ float px(const unsigned char* tbl, uint32_t lane4,
                                    uint32_t w, int e) {
  const uint32_t off = (e == 0 ? w << 7 : w >> (8 * e - 7)) & 0x7F80u;
  return *reinterpret_cast<const float*>(tbl + (off | lane4));
}

// the 16 pixels of 16 bytes, normalised, in byte order
__device__ __forceinline__ void px16(const unsigned char* tbl, uint32_t lane4,
                                     const uint4& v, float (&out)[16]) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int w = 0; w < 4; ++w)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[4 * w + e] = px(tbl, lane4, words[w], e);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// (B, 128) exchange rows from global into buf (stride LD) by cp.async.cg:
// L2, never a stale L1 line; every copy of the thread in flight at once.
// The caller waits (cp_async_wait_all) and syncs the block.
__device__ __forceinline__ void exchange_issue(float* buf, const float* src,
                                               int batch) {
  for (int i = threadIdx.x; i < batch * (H1 / 4); i += THREADS) {
    const int b = i / (H1 / 4);
    const int k = (i - b * (H1 / 4)) * 4;
    cp_async16(buf + b * LD + k, src + (size_t)i * 4);
  }
}

__device__ __forceinline__ float sgd(float w, float lr, float g) {
  return __fsub_rn(w, __fmul_rn(lr, g));
}

// sum of v[0..n-1] (n a multiple of 4), plain adds in order from 0
__device__ __forceinline__ float sum_in_order(const float* v, int n) {
  float s = 0.f;
  for (int b = 0; b < n; b += 4) {
    const float4 q = *reinterpret_cast<const float4*>(v + b);
    s += q.x;
    s += q.y;
    s += q.z;
    s += q.w;
  }
  return s;
}

// The block's weights into shared memory, and its rows of w2 into the
// transposed copy that phase 2 reads columns from. The caller syncs.
template <int COLS>
__device__ __forceinline__ void load_weights(const Smem& sm, const float* w1,
                                             const float* b1, const float* w2,
                                             const float* b2, const float* w3,
                                             float* w2t, int j0) {
  const int tid = threadIdx.x;
  fill_table(sm.tbl);
  for (int i = tid; i < COLS * IN; i += THREADS) {
    const int c = i / IN, k = i - c * IN;
    sm.w1c[i] = w1[k * H1 + j0 + c];
  }
  for (int i = tid; i < COLS * H2; i += THREADS) {
    const int c = i / H2, n = i - c * H2;
    const float v = w2[(j0 + c) * H2 + n];
    sm.w2r[i] = v;
    w2t[n * H1 + j0 + c] = v;
  }
  for (int i = tid; i < H2 * NC; i += THREADS)
    sm.w3s[w3i(i / NC, i % NC)] = w3[i];
  if (tid < COLS) {
    sm.bias[tid] = b1[j0 + tid];
    sm.bias[COLS + tid] = b2[j0 + tid];
  }
}

// The block's weights out of shared memory: its columns of w1, b1[j],
// b2[j], its rows of w2; w3 too where `w3` is not null. The caller syncs
// first.
template <int COLS>
__device__ __forceinline__ void store_weights(const Smem& sm, float* w1,
                                              float* b1, float* w2, float* b2,
                                              float* w3, int j0) {
  const int tid = threadIdx.x;
  for (int i = tid; i < COLS * IN; i += THREADS) {
    const int c = i / IN, k = i - c * IN;
    w1[k * H1 + j0 + c] = sm.w1c[i];
  }
  for (int i = tid; i < COLS * H2; i += THREADS) {
    const int c = i / H2, n = i - c * H2;
    w2[(j0 + c) * H2 + n] = sm.w2r[i];
  }
  if (tid < COLS) {
    b1[j0 + tid] = sm.bias[tid];
    b2[j0 + tid] = sm.bias[COLS + tid];
  }
  if (w3 != nullptr)
    for (int i = tid; i < H2 * NC; i += THREADS)
      w3[i] = sm.w3s[w3i(i / NC, i % NC)];
}

// the unroll of the z1 and gw1 chains' loops: 2 at COLS = 2; 1 at COLS =
// 4, whose 4 chains a thread give the loop its parallelism (unrolled, its
// weight loads take registers the ring kernel needs)
template <int COLS>
constexpr int CHAIN_UNROLL = COLS == 2 ? 2 : 1;

// One step at global step `step` by the block owning units j0 ..
// j0 + COLS - 1. `Ctx` gives the barriers (`bool sync()`), the stamps
// (`stamp(step, at)`, `stamp_gw3(step, g3)`), the hook after barrier 1
// (`after_bar1(step, sm)`, threads may write shared memory that phase 3
// reads), the hook of the threads the z2 chains leave idle (`idle_z2(step)`,
// threads batch..), a check after barrier 2 (`bool ok()`: false leaves the
// step) and the gradients, each called where K2-ws applies it:
//   w3(k, g3)      threads HALF.., row k = tid - HALF, every row
//   b2(c, s)       threads c < COLS
//   loss(step, v)  thread 32 (the context decides which block writes)
//   w2row(i, g2)   threads HALF.., column i = tid - HALF, COLS rows
//   w1(t, acc)     threads t < XW: rows k = 4t .. 4t + 3, COLS columns
//   b1(c, s)       threads XW + c
// False when a barrier failed (K6-ws's bounded waits).
template <int COLS, int RNG, class Ctx>
__device__ __forceinline__ bool ws_step(const StepIO& io, Ctx& ctx,
                                        const Smem& sm, int j0, int step) {
  const int tid = threadIdx.x;
  const unsigned char* const tbl =
      reinterpret_cast<const unsigned char*>(sm.tbl);
  const uint32_t lane4 = (tid & 31) * 4;
  const int batch = io.batch;
  // per-row state of thread t < batch, kept across the step's barriers
  float z1[COLS], m[COLS];

  ctx.stamp(step, ST_START);
  // ---- phase 1: rows, z1, mask, d1 ----
  {
    const uint8_t* src = io.x + (size_t)step * batch * IN;
    for (int q = tid; q < batch * XQ; q += THREADS)
      cp_async16(sm.xs + (size_t)q * 16, src + (size_t)q * 16);
    cp_async_wait_all();
    __syncthreads();
  }
  ctx.stamp(step, ST_ROWS);
  float z1acc[COLS];
  if (tid < batch) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) z1acc[c] = 0.f;
    // 16 pixels a chunk, software-pipelined: chunk q's products while
    // chunk q+1's lookups and chunk q+2's bytes are in flight (one warp
    // per scheduler here, so nothing else hides their latency)
    const uint4* xr = reinterpret_cast<const uint4*>(sm.xs + tid * IN);
    const float4* w4 = reinterpret_cast<const float4*>(sm.w1c);
    float xc[16];
    px16(tbl, lane4, xr[0], xc);
    uint4 vn = xr[1];
#pragma unroll CHAIN_UNROLL<COLS>
    for (int q = 0; q < XQ; ++q) {
      float4 wt[COLS][4];
#pragma unroll
      for (int c = 0; c < COLS; ++c)
#pragma unroll
        for (int w = 0; w < 4; ++w) wt[c][w] = w4[c * XW + q * 4 + w];
      const uint4 v2 = xr[min(q + 2, XQ - 1)];
      float xn[16];
      px16(tbl, lane4, vn, xn);
#pragma unroll
      for (int w = 0; w < 4; ++w)
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          z1acc[c] = fmaf(xc[4 * w], wt[c][w].x, z1acc[c]);
          z1acc[c] = fmaf(xc[4 * w + 1], wt[c][w].y, z1acc[c]);
          z1acc[c] = fmaf(xc[4 * w + 2], wt[c][w].z, z1acc[c]);
          z1acc[c] = fmaf(xc[4 * w + 3], wt[c][w].w, z1acc[c]);
        }
#pragma unroll
      for (int i = 0; i < 16; ++i) xc[i] = xn[i];
      vn = v2;
    }
  } else if (tid >= HALF) {
    // the step's masks at (b, j), drawn by the threads the chains leave
    // idle (the threefry draw is ~20 rounds: off the chains' path)
    for (int e = tid - HALF; e < COLS * batch; e += THREADS - HALF) {
      const int c = e / batch, b = e - c * batch;
      sm.mv[c * B_MAX + b] = mask_at<RNG>(io.mask, step, b, j0 + c);
    }
  }
  __syncthreads();
  if (tid < batch) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      z1[c] = z1acc[c] + sm.bias[c];
      m[c] = sm.mv[c * B_MAX + tid];
      const float d1 = fmaxf(z1[c], 0.f) * m[c];
      sm.d1v[c * B_MAX + tid] = d1;
      __stcg(io.d1x + (size_t)tid * H1 + j0 + c, d1);
    }
  }
  ctx.stamp(step, ST_Z1);
  if (!ctx.sync()) return false;
  ctx.stamp(step, ST_BAR1);

  // ---- phase 2: d1 in, z2, h2 ----
  exchange_issue(sm.buf, io.d1x, batch);
  for (int i = tid; i < COLS * (H1 / 4); i += THREADS)
    cp_async16(sm.w2c + 4 * i, io.w2t + j0 * H1 + 4 * i);
  ctx.after_bar1(step, sm);
  cp_async_wait_all();
  __syncthreads();
  ctx.stamp(step, ST_D1_IN);
  if (tid >= batch) ctx.idle_z2(step);
  if (tid < batch) {
    float acc[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[c] = 0.f;
    const float4* dr = reinterpret_cast<const float4*>(sm.buf + tid * LD);
#pragma unroll 4
    for (int k4 = 0; k4 < H1 / 4; ++k4) {
      const float4 dv = dr[k4];
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const float4 w =
            *reinterpret_cast<const float4*>(sm.w2c + c * H1 + 4 * k4);
        acc[c] = fmaf(dv.x, w.x, acc[c]);
        acc[c] = fmaf(dv.y, w.y, acc[c]);
        acc[c] = fmaf(dv.z, w.z, acc[c]);
        acc[c] = fmaf(dv.w, w.w, acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      __stcg(io.h2x + (size_t)tid * H2 + j0 + c,
             fmaxf(acc[c] + sm.bias[COLS + c], 0.f));
  }
  ctx.stamp(step, ST_Z2);
  if (!ctx.sync() || !ctx.ok()) return false;
  ctx.stamp(step, ST_BAR2);

  // ---- phase 3: h2 in; logits, loss, dl; gw3; dz2 of every unit ----
  exchange_issue(sm.buf, io.h2x, batch);
  cp_async_wait_all();
  __syncthreads();
  ctx.stamp(step, ST_H2_IN);
  if (tid < batch) {
    float acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = 0.f;
    const float4* hr = reinterpret_cast<const float4*>(sm.buf + tid * LD);
    const float4* w4 = reinterpret_cast<const float4*>(sm.w3s);
#pragma unroll 2
    for (int k4 = 0; k4 < H2 / 4; ++k4) {
      const float4 h = hr[k4];
      // w3 rows 4 k4 .. 4 k4 + 3: 40 floats, 10 float4s
      float w[4 * NC];
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const float4 t = w4[k4 * (W3C / 4) + q];
        w[4 * q] = t.x;
        w[4 * q + 1] = t.y;
        w[4 * q + 2] = t.z;
        w[4 * q + 3] = t.w;
      }
      const float hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[c] = fmaf(hv[r], w[r * NC + c], acc[c]);
    }
    // the stable softmax cross-entropy of rows_block, for this row
    float* l = sm.lg + tid * LG;
    float mx = acc[0];
#pragma unroll
    for (int c = 1; c < NC; ++c) mx = fmaxf(mx, acc[c]);
    float ex[NC];
    float se = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      ex[c] = expf(acc[c] - mx);
      se += ex[c];
    }
    const int yr = io.y[(size_t)step * batch + tid];
    float logit_y = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) logit_y += c == yr ? acc[c] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      l[c] = (ex[c] / se - (c == yr ? 1.f : 0.f)) * io.inv_batch;
    l[NC] = l[NC + 1] = 0.f;
    sm.rl[tid] = (mx + logf(se)) - logit_y;
  }
  __syncthreads();
  ctx.stamp(step, ST_LOGITS);
  float g3[NC];
  if (tid >= HALF) {
    // gw3 row k = h2[:, k]^T dl, summed over the rows in order
    const int k = tid - HALF;
#pragma unroll
    for (int c = 0; c < NC; ++c) g3[c] = 0.f;
    const float4* dl = reinterpret_cast<const float4*>(sm.lg);
    for (int b = 0; b < batch; b += 4) {
      // four rows' loads first, then their products in row order
      float hv[4], d[4][LG];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        hv[r] = sm.buf[(b + r) * LD + k];
#pragma unroll
        for (int q = 0; q < LG / 4; ++q) {
          const float4 t = dl[(b + r) * (LG / 4) + q];
          d[r][4 * q] = t.x;
          d[r][4 * q + 1] = t.y;
          d[r][4 * q + 2] = t.z;
          d[r][4 * q + 3] = t.w;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) g3[c] = fmaf(hv[r], d[r][c], g3[c]);
    }
    ctx.stamp_gw3(step, g3);
  }
  __syncthreads();  // gw3's reads of h2 are done
  {
    // dz2 of EVERY unit i, not only this block's: dh2 = dl w3^T from the
    // pre-update w3 (every block holds the same copy), then the ReLU
    // gate [z2 > 0], read as [h2 > 0] (h2 = fmaxf(z2, 0)), written over
    // h2 in place. The chains are the owners' own, so the values are;
    // and no block has to wait for another's dz2 (one barrier and one
    // exchange fewer a step). Thread: 4 rows x the 4-unit chunks q = g +
    // 8m.
    const int g = tid & 7;
    const int r0 = (tid >> 3) * 4;
    if (r0 < batch) {
      float dlr[4][NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4* dl = reinterpret_cast<const float4*>(sm.lg) +
                           (r0 + r) * (LG / 4);
        const float4 d0 = dl[0], d1 = dl[1], d2 = dl[2];
        dlr[r][0] = d0.x; dlr[r][1] = d0.y; dlr[r][2] = d0.z;
        dlr[r][3] = d0.w; dlr[r][4] = d1.x; dlr[r][5] = d1.y;
        dlr[r][6] = d1.z; dlr[r][7] = d1.w; dlr[r][8] = d2.x;
        dlr[r][9] = d2.y;
      }
#pragma unroll
      for (int mq = 0; mq < H2 / 32; ++mq) {
        const int q = g + 8 * mq;  // units 4q .. 4q + 3
        float w[4 * NC];
        const float4* w4 = reinterpret_cast<const float4*>(sm.w3s) +
                           q * (W3C / 4);
#pragma unroll
        for (int t = 0; t < NC; ++t) {
          const float4 v = w4[t];
          w[4 * t] = v.x;
          w[4 * t + 1] = v.y;
          w[4 * t + 2] = v.z;
          w[4 * t + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float4* hp = reinterpret_cast<float4*>(sm.buf + (r0 + r) * LD) + q;
          const float4 h = *hp;
          const float hv[4] = {h.x, h.y, h.z, h.w};
          float out[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float dh2 = 0.f;
#pragma unroll
            for (int c = 0; c < NC; ++c)
              dh2 = fmaf(dlr[r][c], w[e * NC + c], dh2);
            out[e] = dh2 * (hv[e] > 0.f ? 1.f : 0.f);
          }
          *hp = make_float4(out[0], out[1], out[2], out[3]);
        }
      }
    }
  }
  __syncthreads();  // dz2 complete; every read of the pre-update w3 done
  ctx.stamp(step, ST_DZ2);
  if (tid >= HALF) {
    ctx.w3(tid - HALF, g3);
  } else if (tid < COLS) {
    float s = 0.f;
    for (int b = 0; b < batch; ++b) s += sm.buf[b * LD + j0 + tid];
    ctx.b2(tid, s);
  } else if (tid == 32) {
    ctx.loss(step, sum_in_order(sm.rl, batch) / (float)batch);
  }

  // ---- phase 4: dd1, dz1; gw2 row; gb1, gw1 ----
  float g2[COLS];
  if (tid < batch) {
    const float4* dr = reinterpret_cast<const float4*>(sm.buf + tid * LD);
    float dd1[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) dd1[c] = 0.f;
#pragma unroll 4
    for (int i4 = 0; i4 < H2 / 4; ++i4) {
      const float4 dv = dr[i4];
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const float4 w =
            *reinterpret_cast<const float4*>(sm.w2r + c * H2 + 4 * i4);
        dd1[c] = fmaf(dv.x, w.x, dd1[c]);
        dd1[c] = fmaf(dv.y, w.y, dd1[c]);
        dd1[c] = fmaf(dv.z, w.z, dd1[c]);
        dd1[c] = fmaf(dv.w, w.w, dd1[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      sm.dz1v[c * B_MAX + tid] = (dd1[c] * m[c]) * (z1[c] > 0.f ? 1.f : 0.f);
  } else if (tid >= HALF) {
    // gw2[j, i] = d1[:, j]^T dz2[:, i], summed over the rows in order
    const int i = tid - HALF;
#pragma unroll
    for (int c = 0; c < COLS; ++c) g2[c] = 0.f;
    for (int b = 0; b < batch; b += 4) {
      float4 dv[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        dv[c] = *reinterpret_cast<const float4*>(sm.d1v + c * B_MAX + b);
      const float z0 = sm.buf[b * LD + i], z1v = sm.buf[(b + 1) * LD + i],
                  z2v = sm.buf[(b + 2) * LD + i],
                  z3 = sm.buf[(b + 3) * LD + i];
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        g2[c] = fmaf(dv[c].x, z0, g2[c]);
        g2[c] = fmaf(dv[c].y, z1v, g2[c]);
        g2[c] = fmaf(dv[c].z, z2v, g2[c]);
        g2[c] = fmaf(dv[c].w, z3, g2[c]);
      }
    }
  }
  __syncthreads();  // every read of the pre-update w2 row is done
  if (tid >= HALF) ctx.w2row(tid - HALF, g2);
  ctx.stamp(step, ST_DD1);
  if (tid < XW) {
    // gw1[k, j] for k = 4 tid .. 4 tid + 3: x[:, k]^T dz1[:, j]
    float acc[COLS][4];
#pragma unroll
    for (int c = 0; c < COLS; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
    // 4 rows a group, software-pipelined as z1: group g's products
    // while group g+1's lookups and group g+2's bytes are in flight
    const uint32_t* xw = reinterpret_cast<const uint32_t*>(sm.xs) + tid;
    const float4* g4 = reinterpret_cast<const float4*>(sm.dz1v);
    float xc[16];
    uint4 wn = make_uint4(xw[0], xw[XW], xw[2 * XW], xw[3 * XW]);
    px16(tbl, lane4, wn, xc);
    {
      const int b1 = min(4, batch - 4);
      wn = make_uint4(xw[b1 * XW], xw[(b1 + 1) * XW], xw[(b1 + 2) * XW],
                      xw[(b1 + 3) * XW]);
    }
#pragma unroll CHAIN_UNROLL<COLS>
    for (int b = 0; b < batch; b += 4) {
      float4 g[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c) g[c] = g4[(c * B_MAX + b) / 4];
      const int b2 = min(b + 8, batch - 4);
      const uint4 w2 = make_uint4(xw[b2 * XW], xw[(b2 + 1) * XW],
                                  xw[(b2 + 2) * XW], xw[(b2 + 3) * XW]);
      float xn[16];
      px16(tbl, lane4, wn, xn);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          const float gv = r == 0   ? g[c].x
                           : r == 1 ? g[c].y
                           : r == 2 ? g[c].z
                                    : g[c].w;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[c][e] = fmaf(xc[4 * r + e], gv, acc[c][e]);
        }
#pragma unroll
      for (int i = 0; i < 16; ++i) xc[i] = xn[i];
      wn = w2;
    }
    ctx.w1(tid, acc);
  } else if (tid >= XW && tid < XW + COLS) {
    const int c = tid - XW;
    ctx.b1(c, sum_in_order(sm.dz1v + c * B_MAX, batch));
  }
  __syncthreads();  // rows, w1 and biases settled before the next step
  ctx.stamp(step, ST_GW1);
  return true;
}

}  // namespace ws
