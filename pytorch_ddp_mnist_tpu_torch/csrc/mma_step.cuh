// The tensor-core step of the bf16 forms: the three phases of one training
// step with the six products as `mma.sync.m16n8k16` (bf16 operands, f32
// accumulate), as device functions that three kernels instantiate:
//   fused_mma.cu  K1-mma, one step in three launches (a phase a launch)
//   epoch_mma.cu  K2-mma, a whole epoch in one cooperative launch, the
//                 phases separated by grid barriers and SGD folded into
//                 the gradient phase
//   ring_mma.cu   K6-mma, an epoch of n replicas in one cooperative launch,
//                 the phases separated by replica barriers and the
//                 gradients averaged by a ring
// All run the same MMA sequence for every output element, so an epoch of
// K2-mma is bitwise K1-mma + SGD per step, and K6-mma K1-mma per replica +
// the ring's tree + SGD.
//
// The precision contract (`step_reference_bf16`, ops/fused_step.py): the
// bf16 operands, each rounded to nearest even from its f32 value, are x and
// w1 into z1; d1 = relu(z1 + b1) * m and w2 into z2; h2 and w3 into the
// logits; dl and h2 into gw3; dl and w3 into dh2; dz2 with d1 into gw2 and
// with w2 into dd1; x and dz1 into gw1. Everything else is f32. The k order
// of every output is fixed (no split of a sum across blocks, no atomics);
// gb1, gb2 and the loss are serial f32 chains over b in one thread each.
// Rows past the batch in a 16-row tile are zero operands (zero-filled
// copies) and add nothing to any gradient.
//
// The mma fragments (m16n8k16, bf16 in, f32 out; g = lane / 4, t = lane %
// 4): A (16 x 16) in four 32-bit registers, a0 = A[g][2t, 2t+1], a1 =
// A[g+8][2t, 2t+1], a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9], the
// lower k in the low half; B (16 x 8) in two, b0 = B[2t, 2t+1][g], b1 =
// B[2t+8, 2t+9][g]; C (16 x 8 f32) c0, c1 = C[g][2t, 2t+1], c2, c3 =
// C[g+8][2t, 2t+1]. An operand that lies in shared memory as bf16 comes in
// by `ldmatrix` (x4: four 8 x 8 blocks), with `.trans` where its k runs down
// the rows (the contractions over the batch, and w's k x n layout); an f32
// weight is read as f32 pairs and rounded into a register
// (`__floats2bfloat162_rn`). Rows of bf16 tiles are an odd count of 16-byte
// units apart (120, 136 or 24 elements) so the eight rows an `ldmatrix`
// phase reads fall in distinct bank groups.
//
// The phases (block geometry in fused_mma.cu's header comment):
//  * hidden_tile: z1 over (16 rows x 8 units) tiles; warp c of 7 owns k =
//    112c .. 112c+111 (7 MMAs), the 7 partial tiles summed in order; + b1,
//    the mask (drawn or read before the chain in K1-mma, after the sum in
//    the epoch kernels), d1 (bf16), z1 and m out. round_w23, run meanwhile
//    by the grid, rounds w2 and w3 into bf16 scratch for the rows phase.
//  * rows_tile: 16 rows a block, warp w owning units 32w .. 32w+31: z2, h2,
//    the logits, softmax, loss and dl, dh2, dz2, dd1, dz1.
//  * grads_tile: 49 gw1 tiles and 8 gw2 tiles of 16 rows x 128 columns,
//    one gw3 block, 8 bias blocks of 32 columns; the loss mean. Each
//    gradient element goes to a `Store`: written out (K1-mma) or applied
//    as `w -= lr * g` in place (K2-mma) or into a ring's buffers (K6-mma).
//
// Every global load of a value that is written inside a K2-mma launch
// (weights, scratch) is ld.global.cg (L2, never a stale L1 line); the
// values and so the bits are those of a plain load. Every wait on a tensor
// copy names the parity of the barrier's phase: 0 in a K1-mma launch, the
// step's parity in K2-mma, whose barriers complete once a step.

#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>

#include "mlp_step.cuh"
#include "tma.cuh"

namespace mma_step {

using namespace mlp;
using namespace tma;
using bf16 = __nv_bfloat16;

// rows a step: the scratch and the grads phase's groups are sized for it
constexpr int B_MAX = 128;

// hidden_tile: HR rows x HU units a block, one warp a k chunk
constexpr int HR = 16;
constexpr int HU = 8;
constexpr int UNIT_GROUPS = H1 / HU;    // 16
constexpr int KC = 112;                 // k a chunk
constexpr int NKC = IN / KC;            // 7 chunks, 7 warps
constexpr int HIDDEN_THREADS = 32 * NKC;
constexpr int XC = KC + 8;              // x box: 120 bf16, 15 16-byte units
static_assert(NKC * KC == IN && KC % 16 == 0 && (XC * 2 / 16) % 2 == 1,
              "whole k-steps; an odd 16-byte row stride");
constexpr size_t X_CHUNK = HR * XC * sizeof(bf16);       // 3840
// w1's box is the tile's 8 columns as they are: padding its rows against
// the 2-way bank conflict of the B fragments' scalar loads (7 k-steps a
// warp) would add half again to the bytes the hidden phase moves
constexpr size_t W_CHUNK = KC * HU * sizeof(float);      // 3584
static_assert(X_CHUNK % 128 == 0 && W_CHUNK % 128 == 0,
              "tensor-copy boxes start on 128 bytes");
// shared memory: the data, then NKC barriers
constexpr size_t HIDDEN_DATA = NKC * (X_CHUNK + W_CHUNK) +
                               sizeof(float) * NKC * HR * HU;
constexpr size_t HIDDEN_SMEM = HIDDEN_DATA + sizeof(uint64_t) * NKC;

// rows_tile: RR rows a block, warp w owns units 32w .. 32w+31
constexpr int RR = 16;
constexpr int ROWS_THREADS = 128;
constexpr int NT = H2 / 8 / (ROWS_THREADS / 32);  // 4 n-tiles a warp
constexpr int NWC = 4;                 // copy groups of w2
constexpr int WCR = H1 / NWC;          // 32 rows of w2 a group
constexpr int AS = H1 + 8;             // bf16 rows of 128: 17 16-byte units
constexpr int NCP = 16;                // classes padded to two n-tiles
constexpr int DLS = NCP + 8;           // bf16 rows of 16: 3 units
static_assert(NT == 4 && (AS * 2 / 16) % 2 == 1 && (DLS * 2 / 16) % 2 == 1,
              "4 n-tiles a warp; odd 16-byte row strides");
// w2 and w3 as round_w23 rounded them: [H1][AS] and [H2][DLS] bf16
constexpr size_t W2_BYTES = sizeof(bf16) * H1 * AS;       // 34816
constexpr size_t W3_BYTES = sizeof(bf16) * H2 * DLS;      // 6144
constexpr size_t ACT_BYTES = sizeof(bf16) * RR * AS;      // 4352
constexpr size_t ROWS_DATA = W2_BYTES + W3_BYTES + 3 * ACT_BYTES +
                             sizeof(bf16) * RR * DLS + sizeof(float) * RR * NCP;
constexpr size_t ROWS_SMEM = ROWS_DATA + sizeof(uint64_t) * NWC;
static_assert((WCR * AS * sizeof(bf16)) % 128 == 0 && W2_BYTES % 128 == 0 &&
                  W3_BYTES % 16 == 0 && ACT_BYTES % 16 == 0,
              "w2's and w3's boxes on 128 bytes; ldmatrix rows on 16");

// grads_tile: blocks 0..48 gw1 tiles, 49..56 gw2 tiles, 57 gw3, 58..61 gb1
// and 62..65 gb2 in column quarters
constexpr int GRAD_THREADS = 128;
constexpr int TILES_W1 = IN / 16;                  // 49
constexpr int TILES_W2 = H1 / 16;                  // 8
constexpr int W3_BLOCK = TILES_W1 + TILES_W2;      // 57
constexpr int BIAS_COLS = 32;                      // columns a bias block
constexpr int BIAS_SPLIT = H1 / BIAS_COLS;         // 4 blocks a bias
constexpr int GB1_BLOCK = W3_BLOCK + 1;
constexpr int GB2_BLOCK = GB1_BLOCK + BIAS_SPLIT;
constexpr int GRAD_BLOCKS = GB2_BLOCK + BIAS_SPLIT;  // 66
constexpr int NGC = B_MAX / 32;                    // copy groups of rows
constexpr int GCR = 32;                            // batch rows a group
constexpr int LS = 24;                             // narrow box: 3 units
static_assert(GRAD_THREADS >= BIAS_COLS && TILES_W1 * 16 == IN &&
                  (LS * 2 / 16) % 2 == 1,
              "one thread a column of a bias block; whole m-tiles");
constexpr size_t WIDE_BYTES = sizeof(bf16) * B_MAX * AS;    // 34816
constexpr size_t NARROW_BYTES = sizeof(bf16) * B_MAX * LS;  // 6144
constexpr size_t GRADS_DATA = WIDE_BYTES + NARROW_BYTES + sizeof(float) * B_MAX;
constexpr size_t GRADS_SMEM = GRADS_DATA + sizeof(uint64_t) * NGC;
static_assert(GCR * AS * sizeof(bf16) % 128 == 0 &&
                  GCR * LS * sizeof(bf16) % 128 == 0 && WIDE_BYTES % 128 == 0 &&
                  GCR * BIAS_COLS * sizeof(float) % 128 == 0 &&
                  sizeof(float) * B_MAX * BIAS_COLS <= WIDE_BYTES,
              "the grads phase's boxes start on 128 bytes");
static_assert(HIDDEN_SMEM <= 232448 && ROWS_SMEM <= 232448 &&
                  GRADS_SMEM <= 232448,
              "over the 227 KB a block may use");
static_assert(HIDDEN_DATA % 8 == 0 && ROWS_DATA % 8 == 0 &&
                  GRADS_DATA % 8 == 0,
              "the barriers after the data on 8 bytes");

__host__ __device__ constexpr size_t round16z(size_t n) {
  return (n + 15) / 16 * 16;
}

// The scratch a step takes, in bytes, every region on 16 bytes: w2 and w3
// rounded to bf16 (128 x 128; 128 x 16, classes past 9 zero); d1, h2, dz2,
// dz1 as bf16 (batch x 128 each), dl as bf16 (batch x 16, classes past 9
// zero), z1, m, dz2, dz1 as f32 (batch x 128 each), the row losses (f32,
// 16 bytes of slack: the bulk copy rounds its size up).
__host__ __device__ constexpr size_t scratch_bytes(int batch) {
  return sizeof(bf16) * (H1 * H2 + H2 * NCP) + 4 * sizeof(bf16) * batch * H1 +
         sizeof(bf16) * batch * NCP + 4 * sizeof(float) * batch * H1 +
         round16z(sizeof(float) * batch) + 16;
}

// The regions of that scratch.
struct StepScratch {
  bf16 *w2b, *w3b, *d1b, *h2b, *dz2b, *dz1b, *dlb;
  float *z1, *mv, *dz2f, *dz1f, *rl;
};

__host__ __device__ inline StepScratch carve(unsigned char* scratch,
                                             int batch) {
  const size_t act = (size_t)batch * H1;
  StepScratch s;
  s.w2b = reinterpret_cast<bf16*>(scratch);
  s.w3b = s.w2b + H1 * H2;
  s.d1b = s.w3b + H2 * NCP;
  s.h2b = s.d1b + act;
  s.dz2b = s.h2b + act;
  s.dz1b = s.dz2b + act;
  s.dlb = s.dz1b + act;
  s.z1 = reinterpret_cast<float*>(s.dlb + (size_t)batch * NCP);
  s.mv = s.z1 + act;
  s.dz2f = s.mv + act;
  s.dz1f = s.dz2f + act;
  s.rl = s.dz1f + act;
  return s;
}

// The tensor maps of one step: x (bf16) by the hidden phase's rows and the
// gw1 tiles' narrow columns, w1 (f32) by the hidden tile's columns, the
// bf16 w2 and w3, and the exchange the grads phase reads.
struct StepMaps {
  CUtensorMap x_rows, w1_cols, w2_rows, w3_rows, x_cols, d1_cols, dz1_rows,
      dz2_rows, h2_rows, dl_rows, dz1_cols, dz2_cols;
};

// The two maps of x at `x` (batch, 784) bf16.
inline cudaError_t x_maps(CUtensorMap* rows, CUtensorMap* cols, const bf16* x,
                          int batch) {
  cudaError_t err = tensor_map(rows, x, batch, IN, HR, XC);
  if (err == cudaSuccess) err = tensor_map(cols, x, batch, IN, GCR, LS);
  return err;
}

inline cudaError_t step_maps(StepMaps* m, const bf16* x, const float* w1,
                             const StepScratch& s, int batch) {
  cudaError_t err = x_maps(&m->x_rows, &m->x_cols, x, batch);
  if (err == cudaSuccess) err = tensor_map(&m->w1_cols, w1, IN, H1, KC, HU);
  if (err == cudaSuccess) err = tensor_map(&m->w2_rows, s.w2b, H1, H2, WCR, AS);
  if (err == cudaSuccess)
    err = tensor_map(&m->w3_rows, s.w3b, H2, NCP, H2, DLS);
  if (err == cudaSuccess)
    err = tensor_map(&m->d1_cols, s.d1b, batch, H1, GCR, LS);
  if (err == cudaSuccess)
    err = tensor_map(&m->dz1_rows, s.dz1b, batch, H1, GCR, AS);
  if (err == cudaSuccess)
    err = tensor_map(&m->dz2_rows, s.dz2b, batch, H1, GCR, AS);
  if (err == cudaSuccess)
    err = tensor_map(&m->h2_rows, s.h2b, batch, H2, GCR, AS);
  if (err == cudaSuccess)
    err = tensor_map(&m->dl_rows, s.dlb, batch, NCP, GCR, LS);
  if (err == cudaSuccess)
    err = tensor_map(&m->dz1_cols, s.dz1f, batch, H1, GCR, BIAS_COLS);
  if (err == cudaSuccess)
    err = tensor_map(&m->dz2_cols, s.dz2f, batch, H1, GCR, BIAS_COLS);
  return err;
}

// ---- the tensor cores ----

// D += A B for one m16n8k16 tile, bf16 operands, f32 accumulator
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 blocks, block i's row addresses from lanes 8i .. 8i+7:
// lane l receives row l / 4, elements 2 (l % 4) and 2 (l % 4) + 1 of each
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// the same, each block transposed: lane l receives rows 2 (l % 4) and
// 2 (l % 4) + 1 of column l / 4
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// (lo, hi) rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of rows 0..15, k = k0 .. k0+15 of a row-major [16][ld]
// bf16 tile
__device__ __forceinline__ void a_rows(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int k0, int lane) {
  ldsm_x4(a, tile + (lane & 15) * ld + k0 + (lane >> 4) * 8);
}

// The A fragment of A = L^T, rows m0 .. m0+15 and k = b0 .. b0+15 of it,
// from L [b][m] (row-major, leading dimension ld): the contraction over b
__device__ __forceinline__ void a_cols(uint32_t (&a)[4], const bf16* l,
                                       int ld, int b0, int m0, int lane) {
  ldsm_x4_t(a, l + (b0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 +
                   ((lane >> 3) & 1) * 8);
}

// The B fragments of two n-tiles, n0 .. n0+7 (b[0], b[1]) and n0+8 ..
// n0+15 (b[2], b[3]), k = b0 .. b0+15, from R [b][n] (row-major, leading
// dimension ld)
__device__ __forceinline__ void b_rows(uint32_t (&b)[4], const bf16* r,
                                       int ld, int b0, int n0, int lane) {
  ldsm_x4_t(b, r + (b0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
                   (lane >> 4) * 8);
}

// The same two n-tiles' B fragments from B^T [n][k] (row-major, leading
// dimension ld): B = w^T where w lies as it is, n its rows
__device__ __forceinline__ void b_cols(uint32_t (&b)[4], const bf16* bt,
                                       int ld, int k0, int n0, int lane) {
  ldsm_x4(b, bt + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                 ((lane >> 3) & 1) * 8);
}

// ---- phase 1: z1, the mask, d1 ----

// w2 and w3 rounded to bf16 for the rows phase (w2 as it is; w3 padded to
// 16 classes), each element once: element i by the thread of index i mod
// n among the n threads that share the work, i0 this thread's index.
__device__ __forceinline__ void round_w23(const float* w2, const float* w3,
                                          bf16* __restrict__ w2b,
                                          bf16* __restrict__ w3b, int i0,
                                          int n) {
  for (int i = i0; i < H1 * H2 + H2 * NCP; i += n) {
    if (i < H1 * H2) {
      w2b[i] = __float2bfloat16_rn(__ldcg(w2 + i));
    } else {
      const int k = (i - H1 * H2) / NCP, cl = (i - H1 * H2) % NCP;
      w3b[k * NCP + cl] =
          __float2bfloat16_rn(cl < NC ? __ldcg(w3 + k * NC + cl) : 0.f);
    }
  }
}

// Tile (unit group ug, row group rg): rows row0 .. row0+15 x units j0 ..
// j0+7, HIDDEN_THREADS threads. Chunk c (warp c): one tensor copy of the
// tile's rows of x at k = 112c .. 112c+119 (the 8 past the chunk are read
// and not used; past k = 783 they are zeros) and one of w1's rows 112c ..
// 112c+111 at columns j0 .. j0+7, on barrier c. While the copies land,
// this block's threads take their share (round_i0, round_n) of round_w23.
// HOIST_MASK (K1-mma): the threads that own an element (tid < HR * HU) draw
// or read its mask into a register before the chain, so a keyed draw's ~130
// dependent integer operations (or a mask load's round trip) overlap the
// copies' waits instead of ending the phase after the cross-chunk sum. The
// epoch kernels (K2-mma, K6-mma) keep it after the sum: their steps hold
// more registers, and K6-mma's already spill.
template <class MaskAt, bool HOIST_MASK = false>
__device__ __forceinline__ void hidden_tile(
    unsigned char* smem, uint64_t* bars, uint32_t ph,
    const CUtensorMap* x_map, MaskAt mask_at, const CUtensorMap* w1_map,
    const float* b1, const float* w2, const float* w3,
    bf16* __restrict__ w2b, bf16* __restrict__ w3b,
    bf16* __restrict__ d1_out, float* __restrict__ z1_out,
    float* __restrict__ m_out, int batch, int ug, int rg, int round_i0,
    int round_n) {
  bf16* const xs = reinterpret_cast<bf16*>(smem);               // [NKC][HR][XC]
  float* const ws = reinterpret_cast<float*>(smem + NKC * X_CHUNK);  // [NKC][KC][HU]
  float* const parts = ws + NKC * KC * HU;                      // [NKC][HR][HU]
  const int tid = threadIdx.x, lane = tid & 31, c = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = ug * HU;
  const int row0 = rg * HR;
  if (tid == 0)
    for (int cc = 0; cc < NKC; ++cc) {
      bar_expect(bars + cc, X_CHUNK + W_CHUNK);
      tensor_copy(xs + cc * HR * XC, x_map, cc * KC, row0, bars + cc);
      tensor_copy(ws + cc * KC * HU, w1_map, j0, cc * KC, bars + cc);
    }
  round_w23(w2, w3, w2b, w3b, round_i0, round_n);
  float m_pre = 0.f;
  if constexpr (HOIST_MASK) {
    const int r = tid / HU, u = tid % HU;
    if (tid < HR * HU && row0 + r < batch) m_pre = mask_at(row0 + r, j0 + u);
  }

  bar_wait(bars + c, ph);
  const bf16* xc = xs + c * HR * XC;
  const float* wc = ws + c * KC * HU;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ks = 0; ks < KC / 16; ++ks) {
    uint32_t a[4];
    a_rows(a, xc, XC, 16 * ks, lane);
    const float* wk = wc + (16 * ks + 2 * t) * HU + g;
    mma(acc, a, pack(wk[0], wk[HU]), pack(wk[8 * HU], wk[9 * HU]));
  }
  float* const pc = parts + c * HR * HU;
  pc[g * HU + 2 * t] = acc[0];
  pc[g * HU + 2 * t + 1] = acc[1];
  pc[(g + 8) * HU + 2 * t] = acc[2];
  pc[(g + 8) * HU + 2 * t + 1] = acc[3];
  __syncthreads();

  if (tid < HR * HU) {
    const int r = tid / HU, u = tid % HU;
    const int row = row0 + r, j = j0 + u;
    if (row < batch) {
      float s = parts[tid];
#pragma unroll
      for (int cc = 1; cc < NKC; ++cc) s += parts[cc * HR * HU + tid];
      const float z1 = s + __ldcg(b1 + j);
      const float m = HOIST_MASK ? m_pre : mask_at(row, j);
      const size_t at = (size_t)row * H1 + j;
      d1_out[at] = __float2bfloat16_rn(fmaxf(z1, 0.f) * m);
      z1_out[at] = z1;
      m_out[at] = m;
    }
  }
}

// ---- phase 2: the rest of each row ----

// A barrier of the rows phase's ROWS_THREADS threads: the block's own in a
// block of that size (K1-mma); in a wider block (K2-mma) named barrier 1,
// which the block's other warps do not take.
template <int BLOCK>
__device__ __forceinline__ void rows_sync() {
  if constexpr (BLOCK == ROWS_THREADS)
    __syncthreads();
  else
    asm volatile("bar.sync 1, %0;" ::"n"(ROWS_THREADS) : "memory");
}

// No inner stamps (rows_tile's `on_phase`).
struct NoStamps {
  __device__ void operator()(int) const {}
};

// Rows row0 = 16 rb .. row0+15, threads 0 .. ROWS_THREADS-1 of a block of
// BLOCK threads. Thread (warp w, g, t) holds, for n-tile nt of its warp,
// the accumulator elements e = 0..3 at row g + 8 (e / 2) and unit 32w +
// 8nt + 2t + e % 2, in every product of the block (z2, dh2, dd1): the same
// elements, so z2 > 0 and z1, m stay in its registers. w2 and w3 come in
// as round_w23 rounded them (bf16), w2 in 4 tensor copies of 32 rows and
// w3 in one, each row padded to an odd count of 16 bytes; their B
// fragments come by `ldmatrix`, `.trans` where k runs down the rows (z2 =
// d1 w2, logits = h2 w3), plain where it runs along them (dh2 = dl w3^T,
// dd1 = dz2 w2^T). `on_phase(0)` after h2 is out, `on_phase(1)` after dl.
template <int BLOCK, class OnPhase>
__device__ __forceinline__ void rows_tile(
    unsigned char* smem, uint64_t* bars, uint32_t ph, const int* y,
    const CUtensorMap* w2_map, const CUtensorMap* w3_map, const float* b2,
    const bf16* d1_in, const float* z1_in, const float* m_in,
    bf16* __restrict__ h2_out, bf16* __restrict__ dl_out,
    float* __restrict__ row_loss, float* __restrict__ dz2_out,
    bf16* __restrict__ dz2b_out, float* __restrict__ dz1_out,
    bf16* __restrict__ dz1b_out, int batch, float inv_batch, int rb,
    OnPhase on_phase) {
  bf16* const w2s = reinterpret_cast<bf16*>(smem);              // [H1][AS]
  bf16* const w3s = w2s + H1 * AS;                              // [H2][DLS]
  bf16* const d1s = w3s + H2 * DLS;                             // [RR][AS]
  bf16* const h2s = d1s + RR * AS;                              // [RR][AS]
  bf16* const dz2s = h2s + RR * AS;                             // [RR][AS]
  bf16* const dls = dz2s + RR * AS;                             // [RR][DLS]
  float* const lg = reinterpret_cast<float*>(dls + RR * DLS);   // [RR][NCP]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = rb * RR;
  // group c: rows c*WCR .. c*WCR+WCR-1 of w2 (its columns past 127 read as
  // zeros: the padding), and w3 with the first group
  if (tid == 0)
    for (int c = 0; c < NWC; ++c) {
      bar_expect(bars + c, WCR * AS * sizeof(bf16) + (c == 0 ? W3_BYTES : 0));
      tensor_copy(w2s + c * WCR * AS, w2_map, 0, c * WCR, bars + c);
      if (c == 0) tensor_copy(w3s, w3_map, 0, 0, bars);
    }
  // the block's rows of d1, zeros past the batch
  for (int i = tid; i < RR * (H1 / 8); i += ROWS_THREADS) {
    const int r = i / (H1 / 8), q = i % (H1 / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < batch)
      v = __ldcg(reinterpret_cast<const uint4*>(d1_in + (size_t)(row0 + r) * H1 +
                                                8 * q));
    *reinterpret_cast<uint4*>(d1s + r * AS + 8 * q) = v;
  }
  // read before the chains: the biases, z1 and m of this thread's
  // elements, a softmax thread's label
  float z1[NT][4], m[NT][4], bj2[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = 32 * warp + 8 * nt + 2 * t;
    bj2[nt][0] = __ldcg(b2 + n);
    bj2[nt][1] = __ldcg(b2 + n + 1);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e >> 1);
      const size_t at = (size_t)row * H1 + n + (e & 1);
      z1[nt][e] = row < batch ? __ldcg(z1_in + at) : 0.f;
      m[nt][e] = row < batch ? __ldcg(m_in + at) : 0.f;
    }
  }
  const int yr = tid < RR && row0 + tid < batch ? y[row0 + tid] : -1;
  rows_sync<BLOCK>();

  // z2 = d1 w2: k-steps of 16, each group of w2 as it lands
  float z2[NT][4] = {};
#pragma unroll
  for (int ks = 0; ks < H1 / 16; ++ks) {
    if (ks % 2 == 0) bar_wait(bars + ks / 2, ph);
    uint32_t a[4];
    a_rows(a, d1s, AS, 16 * ks, lane);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      b_rows(b, w2s, AS, 16 * ks, 32 * warp + 16 * np, lane);
      mma(z2[2 * np], a, b[0], b[1]);
      mma(z2[2 * np + 1], a, b[2], b[3]);
    }
  }
  // + b2; h2 = relu(z2), rounded once to bf16 for the logits and gw3
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = 32 * warp + 8 * nt + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      z2[nt][2 * h] += bj2[nt][0];
      z2[nt][2 * h + 1] += bj2[nt][1];
      const uint32_t hv = pack(fmaxf(z2[nt][2 * h], 0.f),
                               fmaxf(z2[nt][2 * h + 1], 0.f));
      *reinterpret_cast<uint32_t*>(h2s + r * AS + n) = hv;
      if (row0 + r < batch)
        *reinterpret_cast<uint32_t*>(h2_out + (size_t)(row0 + r) * H2 + n) = hv;
    }
  }
  on_phase(0);
  rows_sync<BLOCK>();

  // logits = h2 w3: warp 0, both class tiles (classes past 9: zeros)
  if (warp == 0) {
    float l[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < H2 / 16; ++ks) {
      uint32_t a[4], b[4];
      a_rows(a, h2s, AS, 16 * ks, lane);
      b_rows(b, w3s, DLS, 16 * ks, 0, lane);
      mma(l[0], a, b[0], b[1]);
      mma(l[1], a, b[2], b[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      lg[g * NCP + 8 * nt + 2 * t] = l[nt][0];
      lg[g * NCP + 8 * nt + 2 * t + 1] = l[nt][1];
      lg[(g + 8) * NCP + 8 * nt + 2 * t] = l[nt][2];
      lg[(g + 8) * NCP + 8 * nt + 2 * t + 1] = l[nt][3];
    }
  }
  rows_sync<BLOCK>();

  // the stable softmax cross-entropy, one thread a row, in f32; dl rounded
  // once to bf16 (classes past 9 zero)
  if (tid < RR) {
    const int row = row0 + tid;
    const bool valid = row < batch;
    const float* l = lg + tid * NCP;
    float mx = l[0];
    for (int c = 1; c < NC; ++c) mx = fmaxf(mx, l[c]);
    float ex[NC];
    float se = 0.f;
    for (int c = 0; c < NC; ++c) {
      ex[c] = expf(l[c] - mx);
      se += ex[c];
    }
    float logit_y = 0.f;
    for (int c = 0; c < NC; ++c) logit_y += c == yr ? l[c] : 0.f;
    const float scale = valid ? inv_batch : 0.f;
    for (int c = 0; c < NCP; ++c) {
      const bf16 dl = __float2bfloat16_rn(
          c < NC ? (ex[c] / se - (c == yr ? 1.f : 0.f)) * scale : 0.f);
      dls[tid * DLS + c] = dl;
      if (valid) dl_out[(size_t)row * NCP + c] = dl;
    }
    if (valid) row_loss[row] = (mx + logf(se)) - logit_y;
  }
  on_phase(1);
  rows_sync<BLOCK>();

  // dh2 = dl w3^T (one k-step over the 16 padded classes); dz2 = dh2 *
  // [z2 > 0], f32 for gb2, rounded to bf16 for dd1 and gw2
  {
    uint32_t a[4];
    a_rows(a, dls, DLS, 0, lane);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      b_cols(b, w3s, DLS, 0, 32 * warp + 16 * np, lane);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int nt = 2 * np + q;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma(d, a, b[2 * q], b[2 * q + 1]);
        const int n = 32 * warp + 8 * nt + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = g + 8 * h, row = row0 + r;
          const float v0 = d[2 * h] * (z2[nt][2 * h] > 0.f ? 1.f : 0.f);
          const float v1 =
              d[2 * h + 1] * (z2[nt][2 * h + 1] > 0.f ? 1.f : 0.f);
          const uint32_t vb = pack(v0, v1);
          *reinterpret_cast<uint32_t*>(dz2s + r * AS + n) = vb;
          if (row < batch) {
            *reinterpret_cast<float2*>(dz2_out + (size_t)row * H2 + n) =
                make_float2(v0, v1);
            *reinterpret_cast<uint32_t*>(dz2b_out + (size_t)row * H2 + n) = vb;
          }
        }
      }
    }
  }
  rows_sync<BLOCK>();

  // dd1 = dz2 w2^T; dz1 = (dd1 * m) * [z1 > 0], f32 for gb1, rounded to
  // bf16 for gw1
  float dd1[NT][4] = {};
#pragma unroll
  for (int ks = 0; ks < H2 / 16; ++ks) {
    uint32_t a[4];
    a_rows(a, dz2s, AS, 16 * ks, lane);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      b_cols(b, w2s, AS, 16 * ks, 32 * warp + 16 * np, lane);
      mma(dd1[2 * np], a, b[0], b[1]);
      mma(dd1[2 * np + 1], a, b[2], b[3]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = 32 * warp + 8 * nt + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + 8 * h;
      if (row >= batch) continue;
      float v[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int e = 2 * h + q;
        v[q] = (dd1[nt][e] * m[nt][e]) * (z1[nt][e] > 0.f ? 1.f : 0.f);
      }
      *reinterpret_cast<float2*>(dz1_out + (size_t)row * H1 + n) =
          make_float2(v[0], v[1]);
      *reinterpret_cast<uint32_t*>(dz1b_out + (size_t)row * H1 + n) =
          pack(v[0], v[1]);
    }
  }
}

// ---- phase 3: the gradients ----

// Where grads_tile puts a thread's gradient elements: `ones` puts g[i] at
// p[i] (none where p[i] is null), `twos` g[i][0], g[i][1] at p[i], p[i] + 1
// (p[i] 8-byte aligned).
struct StoreGrad {       // written out (K1-mma)
  template <int N>
  __device__ void ones(float* (&p)[N], const float (&g)[N]) const {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (p[i] != nullptr) *p[i] = g[i];
  }
  template <int N>
  __device__ void twos(float* (&p)[N], const float (&g)[N][2]) const {
#pragma unroll
    for (int i = 0; i < N; ++i)
      *reinterpret_cast<float2*>(p[i]) = make_float2(g[i][0], g[i][1]);
  }
};

// w -= lr * g in place (K2-mma). A thread's weights are all loaded before
// any is stored, so their L2 round trips overlap (a load after a store to
// a pointer that may alias it waits for the store).
struct StoreSgd {
  float lr;
  // the product rounded to f32 first (JAX's `w -= lr * g`; a fused
  // multiply-add would round once and differ)
  __device__ float sgd(float w, float g) const {
    return __fsub_rn(w, __fmul_rn(lr, g));
  }
  template <int N>
  __device__ void ones(float* (&p)[N], const float (&g)[N]) const {
    float w[N];
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = p[i] != nullptr ? __ldcg(p[i]) : 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (p[i] != nullptr) *p[i] = sgd(w[i], g[i]);
  }
  template <int N>
  __device__ void twos(float* (&p)[N], const float (&g)[N][2]) const {
    float2 w[N];
#pragma unroll
    for (int i = 0; i < N; ++i)
      w[i] = __ldcg(reinterpret_cast<const float2*>(p[i]));
#pragma unroll
    for (int i = 0; i < N; ++i)
      *reinterpret_cast<float2*>(p[i]) =
          make_float2(sgd(w[i].x, g[i][0]), sgd(w[i].y, g[i][1]));
  }
};

// Block `blk` < GRAD_BLOCKS, threads 0 .. GRAD_THREADS-1. A tile block (gw1
// rows m0 .. m0+15 = x^T dz1, or gw2's = d1^T dz2) takes the right operand
// (dz1 or dz2, [b][136]) and the tile's 16 columns of the left (x or d1,
// [b][24]) in groups of 32 batch rows, one tensor copy each (rows past the
// batch zero-filled), and warp w runs n-tiles 4w .. 4w+3 over k = b in
// order. The gw3 block takes h2 ([b][136]) and dl ([b][24]) the same way,
// warp w owning units 32w .. 32w+31 x the 16 padded classes, and the row
// losses, whose mean its thread 0 writes to *loss; a bias block takes 32
// columns of dz1 or dz2 in f32 ([b][32], tensor copies) and its thread j
// sums column j over b in order. Each gradient element goes to `store` at
// its place in gw1, gb1, gw2, gb2 or gw3.
template <class Store>
__device__ __forceinline__ void grads_tile(
    unsigned char* smem, uint64_t* bars, uint32_t ph,
    const CUtensorMap* x_map, const CUtensorMap* d1_map,
    const CUtensorMap* dz1_map, const CUtensorMap* dz2_map,
    const CUtensorMap* h2_map, const CUtensorMap* dl_map,
    const CUtensorMap* dz1f_map, const CUtensorMap* dz2f_map,
    const float* row_loss, float* __restrict__ loss, float* gw1, float* gb1,
    float* gw2, float* gb2, float* gw3, int batch, int blk, Store store) {
  bf16* const wide = reinterpret_cast<bf16*>(smem);                // [B_MAX][AS]
  bf16* const narrow = reinterpret_cast<bf16*>(smem + WIDE_BYTES);  // [B_MAX][LS]
  float* const ls = reinterpret_cast<float*>(smem + WIDE_BYTES + NARROW_BYTES);
  float* const fs = reinterpret_cast<float*>(smem);          // [B_MAX][BIAS_COLS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ngroups = (batch + GCR - 1) / GCR;
  const bool bias = blk >= GB1_BLOCK;
  const bool w1_tile = blk < TILES_W1;
  const int m0 = (w1_tile ? blk : blk - TILES_W1) * 16;  // a tile's first row
  if (tid == 0)
    for (int c = 0; c < ngroups; ++c) {
      const int b0 = c * GCR, nb = min(GCR, batch - b0);
      if (bias) {
        const int q = (blk - GB1_BLOCK) % BIAS_SPLIT;
        bar_expect(bars + c, GCR * BIAS_COLS * sizeof(float));
        tensor_copy(fs + b0 * BIAS_COLS, blk < GB2_BLOCK ? dz1f_map : dz2f_map,
                    q * BIAS_COLS, b0, bars + c);
        continue;
      }
      const bool w3 = blk == W3_BLOCK;
      const unsigned lbytes = w3 ? round16(nb * sizeof(float)) : 0;
      bar_expect(bars + c, GCR * (AS + LS) * sizeof(bf16) + lbytes);
      tensor_copy(wide + b0 * AS, w3 ? h2_map : w1_tile ? dz1_map : dz2_map, 0,
                  b0, bars + c);
      tensor_copy(narrow + b0 * LS, w3 ? dl_map : w1_tile ? x_map : d1_map,
                  w3 ? 0 : m0, b0, bars + c);
      if (w3) bulk_copy(ls + b0, row_loss + b0, lbytes, bars + c);
    }

  if (bias) {
    // one serial f32 chain over b a column, the unrounded dz1 (dz2)
    if (tid < BIAS_COLS) {
      float s = 0.f;
      for (int c = 0; c < ngroups; ++c) {
        bar_wait(bars + c, ph);
        const int end = min(batch, (c + 1) * GCR);
#pragma unroll 8
        for (int b = c * GCR; b < end; ++b) s += fs[b * BIAS_COLS + tid];
      }
      const int q = (blk - GB1_BLOCK) % BIAS_SPLIT;
      float* p[1] = {(blk < GB2_BLOCK ? gb1 : gb2) + q * BIAS_COLS + tid};
      const float v[1] = {s};
      store.ones(p, v);
    }
  } else if (blk != W3_BLOCK) {
    float acc[4][4] = {};
    for (int ks = 0; ks < (batch + 15) / 16; ++ks) {
      if (ks % 2 == 0) bar_wait(bars + ks / 2, ph);
      uint32_t a[4];
      a_cols(a, narrow, LS, 16 * ks, 0, lane);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        b_rows(b, wide, AS, 16 * ks, 32 * warp + 16 * np, lane);
        mma(acc[2 * np], a, b[0], b[1]);
        mma(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    float* const out = w1_tile ? gw1 : gw2;
    float* p[8];
    float v[8][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = 32 * warp + 8 * nt + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        p[2 * nt + h] = out + (size_t)(m0 + g + 8 * h) * H1 + n;
        v[2 * nt + h][0] = acc[nt][2 * h];
        v[2 * nt + h][1] = acc[nt][2 * h + 1];
      }
    }
    store.twos(p, v);
  } else {
    // gw3 = h2^T dl: warp w, units 32w .. 32w+31 (two m-tiles) x classes
    float acc[2][2][4] = {};
    for (int ks = 0; ks < (batch + 15) / 16; ++ks) {
      if (ks % 2 == 0) bar_wait(bars + ks / 2, ph);
      uint32_t b[4];
      b_rows(b, narrow, LS, 16 * ks, 0, lane);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t a[4];
        a_cols(a, wide, AS, 16 * ks, 32 * warp + 16 * mt, lane);
        mma(acc[mt][0], a, b[0], b[1]);
        mma(acc[mt][1], a, b[2], b[3]);
      }
    }
    float* p[16];
    float v[16];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 32 * warp + 16 * mt + g + 8 * (e >> 1);
          const int c = 8 * nt + 2 * t + (e & 1);
          const int i = 8 * mt + 4 * nt + e;
          p[i] = c < NC ? gw3 + k * NC + c : nullptr;
          v[i] = acc[mt][nt][e];
        }
    store.ones(p, v);
    // the mean loss: one serial chain over b
    if (tid == 0) {
      for (int c = 0; c < ngroups; ++c) bar_wait(bars + c, ph);
      float s = 0.f;
#pragma unroll 8
      for (int b = 0; b < batch; ++b) s += ls[b];
      *loss = s / (float)batch;
    }
  }
}

// ---- what a whole-epoch kernel adds (K2-mma, K6-mma) ----

constexpr size_t max3(size_t a, size_t b, size_t c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}
// shared memory: the phases overlay one region, then their barriers
constexpr size_t EPOCH_DATA = max3(HIDDEN_DATA, ROWS_DATA, GRADS_DATA);
constexpr int EPOCH_BARS = NKC + NWC + NGC;
constexpr size_t EPOCH_SMEM = EPOCH_DATA + sizeof(uint64_t) * EPOCH_BARS;
static_assert(EPOCH_SMEM <= 232448, "over the 227 KB a block may use");

// An epoch's scratch: the step's exchange (scratch_bytes), then its rows
// as bf16 in two buffers, (2, batch, 784), the next step's converted while
// the current step's are read.
__host__ __device__ constexpr size_t epoch_scratch_bytes(int batch) {
  return scratch_bytes(batch) + 2 * sizeof(bf16) * (size_t)batch * IN;
}

__host__ __device__ inline bf16* epoch_rows(unsigned char* scratch,
                                            int batch) {
  return reinterpret_cast<bf16*>(scratch + scratch_bytes(batch));
}

// The tensor maps of an epoch: one step's (x of row buffer 0), and x of
// buffer 1.
struct EpochMaps {
  StepMaps step;
  CUtensorMap x_rows1, x_cols1;
};

// The maps of an epoch whose scratch (epoch_scratch_bytes) is at `scratch`
// and whose f32 w1 is at `w1`.
inline cudaError_t epoch_maps(EpochMaps* m, unsigned char* scratch,
                              const float* w1, int batch) {
  const bf16* xb = epoch_rows(scratch, batch);
  cudaError_t err = step_maps(&m->step, xb, w1, carve(scratch, batch), batch);
  if (err == cudaSuccess)
    err = x_maps(&m->x_rows1, &m->x_cols1, xb + (size_t)batch * IN, batch);
  return err;
}

// A step's rows (`chunks` x 16 uint8 pixels at src) to bf16 at dst through
// the table, chunk i by the thread of index i mod n (i0 this thread's).
// The rows are an input: never written in the launch.
__device__ __forceinline__ void rows_to_bf16(const uint8_t* src, bf16* dst,
                                             const uint16_t* tbl, int chunks,
                                             int i0, int n) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  for (int i = i0; i < chunks; i += n) {
    const uint4 v = __ldg(s4 + i);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t o[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {  // pixels 2q, 2q+1: bytes of word q / 2
      const uint32_t word = w[q >> 1], sh = 16 * (q & 1);
      o[q] = static_cast<uint32_t>(tbl[(word >> sh) & 0xffu]) |
             static_cast<uint32_t>(tbl[(word >> (sh + 8)) & 0xffu]) << 16;
    }
    d4[2 * i] = make_uint4(o[0], o[1], o[2], o[3]);
    d4[2 * i + 1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

}  // namespace mma_step
