// K2-ws: the whole-epoch kernel (K2) redesigned for Hopper in the forms the
// main path launches: uint8 rows, f32, dropout from pre-drawn masks (K2b),
// in-kernel Philox (K2c) or in-kernel threefry (K3), any superstep K, ragged
// epochs. The weights stay in the SMs' shared memory for the whole epoch.
//
// Replaces the TPU kernel pytorch_ddp_mnist_tpu/ops/pallas_step.py
// `_make_epoch_kernel` (:433) in its single-replica uint8 f32 forms,
// reached through `epoch_fused_sgd`. The rows design (epoch_step.cu
// `epoch_kernel`, named for its phase of 8 batch rows a block) keeps the
// f32-row, bf16 and batch > WS_MAX_BATCH forms and K6's ring;
// ops/epoch_step.py `epoch_design` picks by form.
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
//    units j = 2g, 2g+1 ("column owners", weight-stationary):
//    w1[:, j], b1[j], row j of w2 (the pre-update operand of dd1), b2[j]
//    and a full copy of w3, all in shared memory for the whole epoch. The
//    z1 and gw1 chains of unit j run on its owner, so all 128 units' chains
//    run on 128 / COLS SMs at once. Weights are read from device memory
//    once and written back once, except w2: its rows are owned here and
//    written back every step (and transposed), and each block reads its
//    COLS columns of w2 (512 B each) from L2 before its z2 chains. So no
//    weight is held twice and no gradient element is computed twice,
//    except w3 (5 KB), which every block updates with the same chains, so
//    the copies stay bit-identical.
//  * the uint8 normalise did two IEEE divisions per pixel load. Here a
//    256-entry f32 table, filled once per launch by pixel()'s own
//    expression, gives the same bits with one shared-memory load. The
//    table is held once per lane of a warp (32 KB), so a warp's 32
//    lookups hit 32 banks whatever the pixels (with one copy, near-uniform
//    pixel values would meet ~4-way bank conflicts).
//  * Per step, two grid barriers. (1) cp.async copies the step's rows
//    (B x 784 uint8) into shared memory; z1[:, j] = one fmaf chain a row
//    over k = 0..783, + b1[j]; the mask at (b, j) from the same device
//    functions as before, drawn meanwhile by the threads the chains leave
//    idle; d1[:, j] out to the exchange. Barrier. (2) All
//    of d1 in, and w2's columns j (from a transposed copy the row owners
//    keep); z2[:, j]; h2[:, j] out. Barrier. (3) All of h2 in; every block
//    computes the logits, loss and dl of all rows, gw3 and the w3 update,
//    and dz2 of EVERY unit (not only its own) from the pre-update w3: the
//    same chains in every block, so the same bits, and no third barrier
//    and dz2 exchange. (4) dd1[:, j] from the PRE-update w2 row j (beside
//    gw2[j, :] on threads 128..255); the row update, written back to w2
//    and its transpose for the next step's column reads; dz1[:, j],
//    gb1[j], gw1[:, j] from the rows still in shared memory; w1[:, j] and
//    b1[j] updated in place. Step s+1 writes an exchange array only after
//    a barrier that every reader of step s's copy has passed, so one
//    buffer each is enough. Exchange reads are cp.async.cg into shared
//    memory (L2, never a stale L1 line, all of a thread's copies in flight
//    at once), rows padded to 132 floats so that the per-row chains read
//    float4s with no bank conflict.
//  * Where the time goes (the stamps build, PERF.md): the z1 and gw1
//    chains, whose table lookups and broadcast weight loads are bound by
//    the SM's shared-memory throughput; then the barriers and exchanges.
//
// The bitwise contract: every output element is ONE sequential chain in
// mlp_step.cuh's order (z1: fmaf over k = 0..783 from 0, then + b1; z2:
// fmaf over k = 0..127, + b2, ReLU; logits: fmaf over k = 0..127; the
// softmax and loss as written there; dh2: fmaf over c = 0..9, dz2 = dh2 *
// [z2 > 0]; dd1: fmaf over i = 0..127, dz1 = (dd1 * m) * [z1 > 0]; each
// weight gradient fmaf over b = 0..B-1 from 0; biases and the loss plain
// adds over b in order; the update __fsub_rn(w, __fmul_rn(lr, g))). No
// split-K, no float atomics; built without --use_fast_math. So K2-ws is
// bitwise K1 + SGD per step, and bitwise the rows design.
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

#include "mlp_step.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace mlp;

// hidden units a block owns: 2 (64 blocks) measured 6-8% faster than 1
// (128 blocks, twice the exchange reads); 4 does not fit beside the
// per-lane table (PERF.md)
constexpr int COLS = 2;
constexpr int NBLK = H1 / COLS;  // the grid: one block per column group
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

// Phase boundaries the stamps build records (block 0, thread 0 after a
// barrier; ST_GW3 by thread HALF, see stamp_gw3).
enum Stamp : int {
  ST_START,      // step start
  ST_ROWS,       // rows in shared memory
  ST_Z1,         // z1 chains, masks, d1 out
  ST_BAR1,       // grid barrier 1
  ST_D1_IN,      // d1 exchange in
  ST_Z2,         // z2 chains, h2 out
  ST_BAR2,       // grid barrier 2
  ST_H2_IN,      // h2 exchange in
  ST_LOGITS,     // logits, softmax, loss, dl
  ST_GW3,        // gw3 (thread HALF's chains)
  ST_DZ2,        // dz2 of every unit, in place of h2
  ST_DD1,        // w3, b2 updates; dd1, dz1, gw2 row and its update
  ST_GW1,        // gb1, gw1 and the w1, b1 update
  N_STAMPS,
  // then the SM's clock64() at ST_START and at ST_GW1: with the two
  // %globaltimer stamps they give the clock rate the step ran at
  N_STAMP_WORDS = N_STAMPS + 2
};

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

// the dropout mask at (row in the step, column), as epoch_step.cu draws it
template <int RNG>
__device__ __forceinline__ float ws_mask(const WsArgs& a, int step, int row,
                                         int col) {
  if constexpr (RNG == RNG_MASKS) {
    return a.masks[((size_t)step * a.batch + row) * H1 + col];
  } else if constexpr (RNG == RNG_THREEFRY) {
    return threefry_mask(static_cast<uint32_t>(a.keys[2 * step]),
                         static_cast<uint32_t>(a.keys[2 * step + 1]), row,
                         col);
  } else {
    return philox_mask(a.seed, static_cast<uint32_t>(step), row, col);
  }
}

// Shared memory, carved from one dynamic allocation.
struct Smem {
  uint8_t* xs;   // [B_MAX][784] the step's rows
  float* buf;    // [B_MAX][LD]  d1, then h2, then dz2 of all units
  float* tbl;    // [256][TCOPIES] pixel(v), one copy per lane
  float* w1c;    // [COLS][784]  w1[:, j]
  float* w2r;    // [COLS][128]  w2[j, :]
  float* w2c;    // [COLS][128]  w2[:, j], read each step
  float* w3s;    // [32][W3C]    w3, in chunks of 4 rows (w3i)
  float* lg;     // [B_MAX][LG]  logits, then dl
  float* rl;     // [B_MAX]      row losses
  float* mv;     // [COLS][B_MAX] the step's dropout mask at (b, j)
  float* d1v;    // [COLS][B_MAX]
  float* dz1v;   // [COLS][B_MAX]
  float* bias;   // [2][COLS]    b1[j], b2[j]
};

constexpr size_t SMEM_BYTES =
    (size_t)B_MAX * IN +
    sizeof(float) * ((size_t)B_MAX * LD + 256 * TCOPIES + COLS * IN +
                     2 * COLS * H2 + (H2 / 4) * W3C + B_MAX * LG + B_MAX +
                     3 * COLS * B_MAX + 2 * COLS);
static_assert(SMEM_BYTES <= 232448, "over the 227 KB a block may use");
static_assert((B_MAX * IN) % 16 == 0 && LD % 4 == 0 && B_MAX % 4 == 0,
              "f32 arrays and rows 16-byte aligned");

__device__ __forceinline__ Smem carve(unsigned char* p) {
  Smem s;
  s.xs = p;
  float* f = reinterpret_cast<float*>(p + (size_t)B_MAX * IN);
  s.buf = f;  f += B_MAX * LD;
  s.tbl = f;  f += 256 * TCOPIES;
  s.w1c = f;  f += COLS * IN;
  s.w2r = f;  f += COLS * H2;
  s.w2c = f;  f += COLS * H2;
  s.w3s = f;  f += (H2 / 4) * W3C;
  s.lg = f;   f += B_MAX * LG;
  s.rl = f;   f += B_MAX;
  s.mv = f;   f += COLS * B_MAX;
  s.d1v = f;  f += COLS * B_MAX;
  s.dz1v = f; f += COLS * B_MAX;
  s.bias = f;
  return s;
}

__device__ __forceinline__ void stamp(const WsArgs& a, int step, int at,
                                      int who = 0) {
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
// stamping after the barrier that ends gw3 read 0.08 us for the phase and
// gave gw3's time to dz2's (PERF.md); the few ns that the other gw3 warps
// may take longer are counted in dz2's phase.
__device__ __forceinline__ void stamp_gw3(const WsArgs& a, int step,
                                          const float (&g3)[NC]) {
#ifdef WS_STAMPS
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) s += g3[c];
  if (__float_as_uint(s) != 0xffffffffu) stamp(a, step, ST_GW3, HALF);
#endif
}

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

template <int RNG>
__global__ void __launch_bounds__(THREADS, 1) ws_kernel(WsArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const unsigned char* const tbl = reinterpret_cast<const unsigned char*>(sm.tbl);
  const uint32_t lane4 = (tid & 31) * 4;
  const int j0 = blockIdx.x * COLS;  // the first unit this block owns
  const int batch = a.batch;
  const float lr = a.lr;
  float* const d1x = a.xch;
  float* const h2x = d1x + (size_t)batch * H1;
  float* const w2t = h2x + (size_t)batch * H2;  // w2 transposed, (128, 128)
  float* const ow2 = a.out[2];

  // ---- the block's weights into shared memory, once ----
  fill_table(sm.tbl);
  for (int i = tid; i < COLS * IN; i += THREADS) {
    const int c = i / IN, k = i - c * IN;
    sm.w1c[i] = a.in[0][k * H1 + j0 + c];
  }
  for (int i = tid; i < COLS * H2; i += THREADS) {
    const int c = i / H2, n = i - c * H2;
    const float v = a.in[2][(j0 + c) * H2 + n];
    sm.w2r[i] = v;
    ow2[(j0 + c) * H2 + n] = v;
    w2t[n * H1 + j0 + c] = v;  // the columns phase 2 reads start from
  }
  for (int i = tid; i < H2 * NC; i += THREADS)
    sm.w3s[w3i(i / NC, i % NC)] = a.in[4][i];
  if (tid < COLS) {
    sm.bias[tid] = a.in[1][j0 + tid];
    sm.bias[COLS + tid] = a.in[3][j0 + tid];
  }
  __syncthreads();

  // per-row state of thread t < batch, kept across the step's barriers
  float z1[COLS], m[COLS];

  for (int step = 0; step < a.valid_steps; ++step) {
    stamp(a, step, ST_START);
    // ---- phase 1: rows, z1, mask, d1 ----
    {
      const uint8_t* src = a.x + (size_t)step * batch * IN;
      for (int q = tid; q < batch * XQ; q += THREADS)
        cp_async16(sm.xs + (size_t)q * 16, src + (size_t)q * 16);
      cp_async_wait_all();
      __syncthreads();
    }
    stamp(a, step, ST_ROWS);
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
#pragma unroll 2
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
        sm.mv[c * B_MAX + b] = ws_mask<RNG>(a, step, b, j0 + c);
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
        __stcg(d1x + (size_t)tid * H1 + j0 + c, d1);
      }
    }
    stamp(a, step, ST_Z1);
    grid.sync();
    stamp(a, step, ST_BAR1);

    // ---- phase 2: d1 in, z2, h2 ----
    exchange_issue(sm.buf, d1x, batch);
    for (int i = tid; i < COLS * (H1 / 4); i += THREADS)
      cp_async16(sm.w2c + 4 * i, w2t + j0 * H1 + 4 * i);
    cp_async_wait_all();
    __syncthreads();
    stamp(a, step, ST_D1_IN);
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
        __stcg(h2x + (size_t)tid * H2 + j0 + c,
               fmaxf(acc[c] + sm.bias[COLS + c], 0.f));
    }
    stamp(a, step, ST_Z2);
    grid.sync();
    stamp(a, step, ST_BAR2);

    // ---- phase 3: h2 in; logits, loss, dl; gw3; dz2 of every unit ----
    exchange_issue(sm.buf, h2x, batch);
    cp_async_wait_all();
    __syncthreads();
    stamp(a, step, ST_H2_IN);
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
      const int yr = a.y[(size_t)step * batch + tid];
      float logit_y = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) logit_y += c == yr ? acc[c] : 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        l[c] = (ex[c] / se - (c == yr ? 1.f : 0.f)) * a.inv_batch;
      l[NC] = l[NC + 1] = 0.f;
      sm.rl[tid] = (mx + logf(se)) - logit_y;
    }
    __syncthreads();
    stamp(a, step, ST_LOGITS);
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
      stamp_gw3(a, step, g3);
    }
    __syncthreads();  // gw3's reads of h2 are done
    {
      // dz2 of EVERY unit i, not only this block's: dh2 = dl w3^T from the
      // pre-update w3 (every block holds the same copy), then the ReLU
      // gate [z2 > 0], read as [h2 > 0] (h2 = fmaxf(z2, 0)), written over
      // h2 in place. The chains are the owners' own, so the values are;
      // and no block has to wait for another's dz2 (one grid barrier and
      // one exchange fewer a step). Thread: 4 rows x the 4-unit chunks
      // q = g + 8m.
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
    stamp(a, step, ST_DZ2);
    if (tid >= HALF) {
      const int k = tid - HALF;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        sm.w3s[w3i(k, c)] = sgd(sm.w3s[w3i(k, c)], lr, g3[c]);
    } else if (tid < COLS) {
      float s = 0.f;
      for (int b = 0; b < batch; ++b) s += sm.buf[b * LD + j0 + tid];
      sm.bias[COLS + tid] = sgd(sm.bias[COLS + tid], lr, s);
    } else if (tid == 32 && blockIdx.x == 0) {
      a.losses[step] = sum_in_order(sm.rl, batch) / (float)batch;
    }

    // ---- phase 4: dd1, dz1; gw2 row; gb1, gw1; updates ----
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
    if (tid >= HALF) {
      const int i = tid - HALF;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const float w = sgd(sm.w2r[c * H2 + i], lr, g2[c]);
        sm.w2r[c * H2 + i] = w;
        __stcg(ow2 + (j0 + c) * H2 + i, w);
        __stcg(w2t + i * H1 + j0 + c, w);
      }
    }
    stamp(a, step, ST_DD1);
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
#pragma unroll 2
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
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        float4* w = reinterpret_cast<float4*>(sm.w1c + c * IN + 4 * tid);
        float4 v = *w;
        v.x = sgd(v.x, lr, acc[c][0]);
        v.y = sgd(v.y, lr, acc[c][1]);
        v.z = sgd(v.z, lr, acc[c][2]);
        v.w = sgd(v.w, lr, acc[c][3]);
        *w = v;
      }
    } else if (tid >= XW && tid < XW + COLS) {
      const int c = tid - XW;
      sm.bias[c] = sgd(sm.bias[c], lr, sum_in_order(sm.dz1v + c * B_MAX,
                                                    batch));
    }
    __syncthreads();  // rows, w1 and biases settled before the next step
    stamp(a, step, ST_GW1);
  }

  // ---- the padded steps of a ragged epoch, and the weights out ----
  if (blockIdx.x == 0)
    for (int s = a.valid_steps + tid; s < a.nsteps; s += THREADS)
      a.losses[s] = 0.f;
  for (int i = tid; i < COLS * IN; i += THREADS) {
    const int c = i / IN, k = i - c * IN;
    a.out[0][k * H1 + j0 + c] = sm.w1c[i];
  }
  if (tid < COLS) {
    a.out[1][j0 + tid] = sm.bias[tid];
    a.out[3][j0 + tid] = sm.bias[COLS + tid];
  }
  if (blockIdx.x == 0)
    for (int i = tid; i < H2 * NC; i += THREADS)
      a.out[4][i] = sm.w3s[w3i(i / NC, i % NC)];
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

WsKernel pick(int rng) {
  static const WsKernel table[3] = {ws_kernel<RNG_MASKS>,
                                    ws_kernel<RNG_THREEFRY>,
                                    ws_kernel<RNG_PHILOX>};
  return table[rng];
}

}  // namespace

extern "C" int pdmt_ws_max_batch() { return B_MAX; }

extern "C" int pdmt_ws_blocks() { return NBLK; }

extern "C" int pdmt_ws_smem_bytes() { return static_cast<int>(SMEM_BYTES); }

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

// One epoch: x (nsteps*batch, 784) uint8 (16-byte aligned), batch a
// multiple of 4 up to pdmt_ws_max_batch(), y
// (nsteps*batch,) int32, rng 0/1/2 = masks/threefry/philox with its source
// (masks, keys or seed), params in (w1, b1, w2, b2, w3) and out (same
// shapes, written), valid_steps <= nsteps, xch of pdmt_ws_xch_floats(batch)
// floats,
// losses (nsteps,), stamps (nsteps, pdmt_ws_stamps_per_step()) u64 in the
// stamps build (else ignored). Launches NBLK blocks.
extern "C" int pdmt_ws_epoch(
    const void* x, const int* y, int rng, const float* masks,
    const int* keys, uint32_t seed, const float* w1, const float* b1,
    const float* w2, const float* b2, const float* w3, float* ow1, float* ob1,
    float* ow2, float* ob2, float* ow3, int valid_steps, float* xch,
    float* losses, unsigned long long* stamps, int nsteps, int batch,
    float lr, float inv_batch, void* stream) {
  if (rng < 0 || rng > 2 || batch < 4 || batch > B_MAX || batch % 4 ||
      nsteps < 1 ||
      valid_steps < 1 || valid_steps > nsteps ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      (pdmt_ws_stamps_per_step() > 0 && stamps == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const WsKernel kernel = pick(rng);
  const void* fn = reinterpret_cast<const void*>(kernel);
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
  if (per_sm * sms < NBLK)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  WsArgs a{static_cast<const uint8_t*>(x), y, masks, keys, seed,
           {w1, b1, w2, b2, w3}, {ow1, ob1, ow2, ob2, ow3}, xch, losses,
           stamps, nsteps, valid_steps, batch, lr, inv_batch};
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      fn, dim3(NBLK), dim3(THREADS), args, SMEM_BYTES,
      static_cast<cudaStream_t>(stream)));
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
