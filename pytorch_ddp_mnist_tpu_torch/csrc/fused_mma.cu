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
//                                    block keyed (step seed, batch block))
// ops/fused_step.py `fused_design` sends them here at B <= B_MAX; larger
// batches stay on the rows design (fused_step.cu), whose bf16 step is the
// one epoch_step.cu's kernels (K2-bf16, its superstep, K6-bf16) compute.
//
// The precision contract, the TPU kernel's and `step_reference_bf16`'s
// (ops/fused_step.py): the bf16 operands, each rounded to nearest even from
// its f32 value, are x and w1 into z1; d1 = relu(z1 + b1) * m and w2 into
// z2; h2 and w3 into the logits; dl and h2 into gw3; dl and w3 into dh2;
// dz2 with d1 into gw2 and with w2 into dd1; x and dz1 into gw1. Everything
// else is f32: the bias adds, ReLU, the mask, softmax, loss, dz2 = dh2 *
// [z2 > 0], dz1 = (dd1 * m) * [z1 > 0], gb1 and gb2 (sums of the unrounded
// dz1, dz2) and the loss mean. A product of two bf16 values is exact in
// f32; the tensor cores add them in their own order, another than the MXU's
// and the CPU's, so the design is held to the JAX package's pins for its
// bf16 kernels (loss rtol 1e-3, grads rtol 2e-3 / atol 1e-4) against the
// plain version, not bitwise to the rows design. The k order of every
// output is fixed: no split of a sum across blocks, no atomics, so a
// repeat launch gives the same bits. gb1, gb2 and the loss are serial f32
// chains over b in one thread each. Rows past B in a 16-row tile are zero
// operands (zero-filled copies) and have dl = 0 and dz = 0, so they add
// nothing to any gradient; the mean is taken with 1/B.
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
// the launches capture in a CUDA graph):
//  * mma_hidden_kernel: z1 over (16 rows x 8 units) tiles, 16 unit groups x
//    B/16 row groups (128 blocks at B = 128). Warp c of 7 owns k = 112c ..
//    112c+111: its x rows and w1 columns come in by one tensor copy each
//    (x as bf16, w1 as f32, rounded as the B fragments are built) on its
//    own mbarrier, and it runs 7 MMAs. The 7 partial tiles are summed in
//    order c = 0..6 by the thread that owns the element, which adds b1,
//    draws or reads the mask, and writes d1 (bf16), z1 and m. Meanwhile the
//    grid rounds w2 and w3 to bf16 copies in scratch, once a call.
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

#include "mlp_step.cuh"
#include "tma.cuh"

namespace {

using namespace mlp;
using namespace tma;
using bf16 = __nv_bfloat16;

// rows a call: the scratch and the grads kernel's groups are sized for it
constexpr int B_MAX = 128;

// mma_hidden_kernel: HR rows x HU units a block, one warp a k chunk
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
constexpr size_t HIDDEN_SMEM = NKC * (X_CHUNK + W_CHUNK) +
                               sizeof(float) * NKC * HR * HU +
                               sizeof(uint64_t) * NKC;

// mma_rows_kernel: RR rows a block, warp w owns units 32w .. 32w+31
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
// w2 and w3 as the hidden kernel rounded them: [H1][AS] and [H2][DLS] bf16
constexpr size_t W2_BYTES = sizeof(bf16) * H1 * AS;       // 34816
constexpr size_t W3_BYTES = sizeof(bf16) * H2 * DLS;      // 6144
constexpr size_t ACT_BYTES = sizeof(bf16) * RR * AS;      // 4352
constexpr size_t ROWS_SMEM = W2_BYTES + W3_BYTES + 3 * ACT_BYTES +
                             sizeof(bf16) * RR * DLS + sizeof(float) * RR * NCP +
                             sizeof(uint64_t) * NWC;
static_assert((WCR * AS * sizeof(bf16)) % 128 == 0 && W2_BYTES % 128 == 0 &&
                  W3_BYTES % 16 == 0 && ACT_BYTES % 16 == 0,
              "w2's and w3's boxes on 128 bytes; ldmatrix rows on 16");

// mma_grads_kernel: blocks 0..48 gw1 tiles, 49..56 gw2 tiles, 57 gw3,
// 58..61 gb1 and 62..65 gb2 in column quarters
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
constexpr size_t GRADS_SMEM = WIDE_BYTES + NARROW_BYTES + sizeof(float) * B_MAX +
                              sizeof(uint64_t) * NGC;
static_assert(GCR * AS * sizeof(bf16) % 128 == 0 &&
                  GCR * LS * sizeof(bf16) % 128 == 0 && WIDE_BYTES % 128 == 0 &&
                  GCR * BIAS_COLS * sizeof(float) % 128 == 0 &&
                  sizeof(float) * B_MAX * BIAS_COLS <= WIDE_BYTES,
              "the grads kernel's boxes start on 128 bytes");
static_assert(HIDDEN_SMEM <= 232448 && ROWS_SMEM <= 232448 &&
                  GRADS_SMEM <= 232448,
              "over the 227 KB a block may use");

__host__ __device__ constexpr size_t round16z(size_t n) {
  return (n + 15) / 16 * 16;
}

// The scratch a call takes, in bytes, every region on 16 bytes: w2 and w3
// rounded to bf16 (128 x 128; 128 x 16, classes past 9 zero); d1, h2, dz2,
// dz1 as bf16 (batch x 128 each), dl as bf16 (batch x 16, classes past 9
// zero), z1, m, dz2, dz1 as f32 (batch x 128 each), the row losses (f32,
// 16 bytes of slack: the bulk copy rounds its size up).
__host__ __device__ constexpr size_t scratch_bytes(int batch) {
  return sizeof(bf16) * (H1 * H2 + H2 * NCP) + 4 * sizeof(bf16) * batch * H1 +
         sizeof(bf16) * batch * NCP + 4 * sizeof(float) * batch * H1 +
         round16z(sizeof(float) * batch) + 16;
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

// ---- phase 1: z1, the mask, d1 ----

// Block (unit group, row group): rows row0 .. row0+15 x units j0 .. j0+7.
// Chunk c (warp c): one tensor copy of the block's rows of x at k = 112c ..
// 112c+119 (the 8 past the chunk are read and not used; past k = 783 they
// are zeros) and one of w1's rows 112c .. 112c+111 at columns j0 .. j0+7,
// on its own mbarrier. While the copies land, the grid rounds w2 and w3 to
// bf16 for the rows kernel (w2 as it is; w3 padded to 16 classes), each
// element once, one a thread.
template <class MaskAt>
__global__ void __launch_bounds__(HIDDEN_THREADS) mma_hidden_kernel(
    const __grid_constant__ CUtensorMap x_map, MaskAt mask_at,
    const __grid_constant__ CUtensorMap w1_map, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ w3,
    bf16* __restrict__ w2b, bf16* __restrict__ w3b,
    bf16* __restrict__ d1_out, float* __restrict__ z1_out,
    float* __restrict__ m_out, int batch, unsigned long long* stamps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* const xs = reinterpret_cast<bf16*>(smem);               // [NKC][HR][XC]
  float* const ws = reinterpret_cast<float*>(smem + NKC * X_CHUNK);  // [NKC][KC][HU]
  float* const parts = ws + NKC * KC * HU;                      // [NKC][HR][HU]
  uint64_t* const bars = reinterpret_cast<uint64_t*>(parts + NKC * HR * HU);
  const int tid = threadIdx.x, lane = tid & 31, c = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * HU;
  const int row0 = blockIdx.y * HR;
  stamp_block0(stamps, ST_HIDDEN_START);
  bars_init(bars, NKC);
  if (tid == 0)
    for (int cc = 0; cc < NKC; ++cc) {
      bar_expect(bars + cc, X_CHUNK + W_CHUNK);
      tensor_copy(xs + cc * HR * XC, &x_map, cc * KC, row0, bars + cc);
      tensor_copy(ws + cc * KC * HU, &w1_map, j0, cc * KC, bars + cc);
    }
  {
    const int nthreads = HIDDEN_THREADS * gridDim.x * gridDim.y;
    for (int i = (blockIdx.y * gridDim.x + blockIdx.x) * HIDDEN_THREADS + tid;
         i < H1 * H2 + H2 * NCP; i += nthreads) {
      if (i < H1 * H2) {
        w2b[i] = __float2bfloat16_rn(w2[i]);
      } else {
        const int k = (i - H1 * H2) / NCP, cl = (i - H1 * H2) % NCP;
        w3b[k * NCP + cl] = __float2bfloat16_rn(cl < NC ? w3[k * NC + cl] : 0.f);
      }
    }
  }

  bar_wait(bars + c);
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
      const float z1 = s + b1[j];
      const float m = mask_at(row, j);
      const size_t at = (size_t)row * H1 + j;
      d1_out[at] = __float2bfloat16_rn(fmaxf(z1, 0.f) * m);
      z1_out[at] = z1;
      m_out[at] = m;
    }
  }
  stamp_last(stamps, ST_HIDDEN_END);
}

// ---- phase 2: the rest of each row ----

// Block: rows row0 .. row0+15. Thread (warp w, g, t) holds, for n-tile nt
// of its warp, the accumulator elements e = 0..3 at row g + 8 (e / 2) and
// unit 32w + 8nt + 2t + e % 2, in every product of the block (z2, dh2,
// dd1): the same elements, so z2 > 0 and z1, m stay in its registers. w2
// and w3 come in as the hidden kernel rounded them (bf16), w2 in 4 tensor
// copies of 32 rows and w3 in one, each row padded to an odd count of 16
// bytes; their B fragments come by `ldmatrix`, `.trans` where k runs down
// the rows (z2 = d1 w2, logits = h2 w3), plain where it runs along them
// (dh2 = dl w3^T, dd1 = dz2 w2^T).
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
  bf16* const w2s = reinterpret_cast<bf16*>(smem);              // [H1][AS]
  bf16* const w3s = w2s + H1 * AS;                              // [H2][DLS]
  bf16* const d1s = w3s + H2 * DLS;                             // [RR][AS]
  bf16* const h2s = d1s + RR * AS;                              // [RR][AS]
  bf16* const dz2s = h2s + RR * AS;                             // [RR][AS]
  bf16* const dls = dz2s + RR * AS;                             // [RR][DLS]
  float* const lg = reinterpret_cast<float*>(dls + RR * DLS);   // [RR][NCP]
  uint64_t* const bars = reinterpret_cast<uint64_t*>(lg + RR * NCP);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * RR;
  stamp_block0(stamps, ST_ROWS_START);
  bars_init(bars, NWC);
  // group c: rows c*WCR .. c*WCR+WCR-1 of w2 (its columns past 127 read as
  // zeros: the padding), and w3 with the first group
  if (tid == 0)
    for (int c = 0; c < NWC; ++c) {
      bar_expect(bars + c, WCR * AS * sizeof(bf16) + (c == 0 ? W3_BYTES : 0));
      tensor_copy(w2s + c * WCR * AS, &w2_map, 0, c * WCR, bars + c);
      if (c == 0) tensor_copy(w3s, &w3_map, 0, 0, bars);
    }
  // the block's rows of d1, zeros past the batch
  for (int i = tid; i < RR * (H1 / 8); i += ROWS_THREADS) {
    const int r = i / (H1 / 8), q = i % (H1 / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < batch)
      v = *reinterpret_cast<const uint4*>(d1_in + (size_t)(row0 + r) * H1 + 8 * q);
    *reinterpret_cast<uint4*>(d1s + r * AS + 8 * q) = v;
  }
  // read before the chains: the biases, z1 and m of this thread's
  // elements, a softmax thread's label
  float z1[NT][4], m[NT][4], bj2[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = 32 * warp + 8 * nt + 2 * t;
    bj2[nt][0] = b2[n];
    bj2[nt][1] = b2[n + 1];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e >> 1);
      const size_t at = (size_t)row * H1 + n + (e & 1);
      z1[nt][e] = row < batch ? z1_in[at] : 0.f;
      m[nt][e] = row < batch ? m_in[at] : 0.f;
    }
  }
  const int yr = tid < RR && row0 + tid < batch ? y[row0 + tid] : -1;
  __syncthreads();

  // z2 = d1 w2: k-steps of 16, each group of w2 as it lands
  float z2[NT][4] = {};
#pragma unroll
  for (int ks = 0; ks < H1 / 16; ++ks) {
    if (ks % 2 == 0) bar_wait(bars + ks / 2);
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
  stamp_block0(stamps, ST_ROWS_Z2);
  __syncthreads();

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
  __syncthreads();

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
  stamp_block0(stamps, ST_ROWS_SOFTMAX);
  __syncthreads();

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
  __syncthreads();

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
  stamp_last(stamps, ST_ROWS_END);
}

// ---- phase 3: the gradients ----

// A tile block (gw1 rows m0 .. m0+15 = x^T dz1, or gw2's = d1^T dz2) takes
// the right operand (dz1 or dz2, [b][136]) and the tile's 16 columns of the
// left (x or d1, [b][24]) in groups of 32 batch rows, one tensor copy each
// (rows past the batch zero-filled), and warp w runs n-tiles 4w .. 4w+3
// over k = b in order. The gw3 block takes h2 ([b][136]) and dl ([b][24])
// the same way, warp w owning units 32w .. 32w+31 x the 16 padded classes,
// and the row losses; a bias block takes 32 columns of dz1 or dz2 in f32
// ([b][32], tensor copies) and its thread j sums column j over b in order.
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
  bf16* const wide = reinterpret_cast<bf16*>(smem);                // [B_MAX][AS]
  bf16* const narrow = reinterpret_cast<bf16*>(smem + WIDE_BYTES);  // [B_MAX][LS]
  float* const ls = reinterpret_cast<float*>(smem + WIDE_BYTES + NARROW_BYTES);
  float* const fs = reinterpret_cast<float*>(smem);          // [B_MAX][BIAS_COLS]
  uint64_t* const bars = reinterpret_cast<uint64_t*>(ls + B_MAX);
  const int blk = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ngroups = (batch + GCR - 1) / GCR;
  const bool bias = blk >= GB1_BLOCK;
  const bool w1_tile = blk < TILES_W1;
  const int m0 = (w1_tile ? blk : blk - TILES_W1) * 16;  // a tile's first row
  stamp_block0(stamps, ST_GRADS_START);
  bars_init(bars, NGC);
  if (tid == 0)
    for (int c = 0; c < ngroups; ++c) {
      const int b0 = c * GCR, nb = min(GCR, batch - b0);
      if (bias) {
        const int q = (blk - GB1_BLOCK) % BIAS_SPLIT;
        bar_expect(bars + c, GCR * BIAS_COLS * sizeof(float));
        tensor_copy(fs + b0 * BIAS_COLS, blk < GB2_BLOCK ? &dz1f_map : &dz2f_map,
                    q * BIAS_COLS, b0, bars + c);
        continue;
      }
      const bool w3 = blk == W3_BLOCK;
      const unsigned lbytes = w3 ? round16(nb * sizeof(float)) : 0;
      bar_expect(bars + c, GCR * (AS + LS) * sizeof(bf16) + lbytes);
      tensor_copy(wide + b0 * AS, w3 ? &h2_map : w1_tile ? &dz1_map : &dz2_map,
                  0, b0, bars + c);
      tensor_copy(narrow + b0 * LS, w3 ? &dl_map : w1_tile ? &x_map : &d1_map,
                  w3 ? 0 : m0, b0, bars + c);
      if (w3) bulk_copy(ls + b0, row_loss + b0, lbytes, bars + c);
    }

  if (bias) {
    // one serial f32 chain over b a column, the unrounded dz1 (dz2)
    if (tid < BIAS_COLS) {
      float s = 0.f;
      for (int c = 0; c < ngroups; ++c) {
        bar_wait(bars + c);
        const int end = min(batch, (c + 1) * GCR);
#pragma unroll 8
        for (int b = c * GCR; b < end; ++b) s += fs[b * BIAS_COLS + tid];
      }
      const int q = (blk - GB1_BLOCK) % BIAS_SPLIT;
      (blk < GB2_BLOCK ? gb1 : gb2)[q * BIAS_COLS + tid] = s;
    }
  } else if (blk != W3_BLOCK) {
    float acc[4][4] = {};
    for (int ks = 0; ks < (batch + 15) / 16; ++ks) {
      if (ks % 2 == 0) bar_wait(bars + ks / 2);
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
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = 32 * warp + 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(out + (size_t)(m0 + g) * H1 + n) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(out + (size_t)(m0 + g + 8) * H1 + n) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  } else {
    // gw3 = h2^T dl: warp w, units 32w .. 32w+31 (two m-tiles) x classes
    float acc[2][2][4] = {};
    for (int ks = 0; ks < (batch + 15) / 16; ++ks) {
      if (ks % 2 == 0) bar_wait(bars + ks / 2);
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
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 32 * warp + 16 * mt + g + 8 * (e >> 1);
          const int c = 8 * nt + 2 * t + (e & 1);
          if (c < NC) gw3[k * NC + c] = acc[mt][nt][e];
        }
    // the mean loss: one serial chain over b
    if (tid == 0) {
      for (int c = 0; c < ngroups; ++c) bar_wait(bars + c);
      float s = 0.f;
#pragma unroll 8
      for (int b = 0; b < batch; ++b) s += ls[b];
      loss[0] = s / (float)batch;
    }
  }
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
  const size_t act = (size_t)batch * H1;
  bf16* w2b = reinterpret_cast<bf16*>(scratch);
  bf16* w3b = w2b + H1 * H2;
  bf16* d1b = w3b + H2 * NCP;
  bf16* h2b = d1b + act;
  bf16* dz2b = h2b + act;
  bf16* dz1b = dz2b + act;
  bf16* dlb = dz1b + act;
  float* z1 = reinterpret_cast<float*>(dlb + (size_t)batch * NCP);
  float* mv = z1 + act;
  float* dz2f = mv + act;
  float* dz1f = dz2f + act;
  float* rl = dz1f + act;
  CUtensorMap x_rows, w1_cols, w2_rows, w3_rows, x_cols, d1_cols, dz1_rows,
      dz2_rows, h2_rows, dl_rows, dz1_cols, dz2_cols;
  cudaError_t err = allow_smem_once();
  if (err == cudaSuccess) err = tensor_map(&x_rows, x, batch, IN, HR, XC);
  if (err == cudaSuccess) err = tensor_map(&w1_cols, w1, IN, H1, KC, HU);
  if (err == cudaSuccess) err = tensor_map(&w2_rows, w2b, H1, H2, WCR, AS);
  if (err == cudaSuccess) err = tensor_map(&w3_rows, w3b, H2, NCP, H2, DLS);
  if (err == cudaSuccess) err = tensor_map(&x_cols, x, batch, IN, GCR, LS);
  if (err == cudaSuccess) err = tensor_map(&d1_cols, d1b, batch, H1, GCR, LS);
  if (err == cudaSuccess) err = tensor_map(&dz1_rows, dz1b, batch, H1, GCR, AS);
  if (err == cudaSuccess) err = tensor_map(&dz2_rows, dz2b, batch, H1, GCR, AS);
  if (err == cudaSuccess) err = tensor_map(&h2_rows, h2b, batch, H2, GCR, AS);
  if (err == cudaSuccess) err = tensor_map(&dl_rows, dlb, batch, NCP, GCR, LS);
  if (err == cudaSuccess)
    err = tensor_map(&dz1_cols, dz1f, batch, H1, GCR, BIAS_COLS);
  if (err == cudaSuccess)
    err = tensor_map(&dz2_cols, dz2f, batch, H1, GCR, BIAS_COLS);
  if (err != cudaSuccess) return err;
  mma_hidden_kernel<MaskAt>
      <<<dim3(UNIT_GROUPS, (batch + HR - 1) / HR), HIDDEN_THREADS, HIDDEN_SMEM,
         s>>>(x_rows, mask_at, w1_cols, b1, w2, w3, w2b, w3b, d1b, z1, mv, batch,
              stamps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mma_rows_kernel<<<(batch + RR - 1) / RR, ROWS_THREADS, ROWS_SMEM, s>>>(
      y, w2_rows, w3_rows, b2, d1b, z1, mv, h2b, dlb, rl, dz2f, dz2b, dz1f,
      dz1b, batch, inv_batch, stamps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mma_grads_kernel<<<GRAD_BLOCKS, GRAD_THREADS, GRADS_SMEM, s>>>(
      x_cols, d1_cols, dz1_rows, dz2_rows, h2_rows, dl_rows, dz1_cols,
      dz2_cols, rl, loss, gw1, gb1, gw2, gb2, gw3, batch, stamps);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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

// One step. x (batch, 784) bf16; y (batch,) int32; rng = 0 reads `mask`
// (batch, 128) f32; rng = 1 draws it in the kernel from (seed, batch block
// of rng_block rows) and `mask` is unused. The weights f32. x, w1, w2, w3
// and scratch 16-byte aligned; scratch: pdmt_mma_scratch_floats(batch)
// floats. stamps: pdmt_mma_stamp_words() u64, zeroed, in the stamps build
// (else ignored). 1 <= batch <= pdmt_mma_max_batch().
extern "C" int pdmt_mma_step(
    const bf16* x, const int* y, int rng, const float* mask, uint32_t seed,
    int rng_block, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* w3, unsigned char* scratch, float* loss,
    float* gw1, float* gb1, float* gw2, float* gb2, float* gw3,
    unsigned long long* stamps, int batch, float inv_batch, void* stream) {
  if (batch < 1 || batch > B_MAX || (rng && rng_block < 1) ||
      (!rng && mask == nullptr) || !aligned16(x) || !aligned16(w1) ||
      !aligned16(w2) || !aligned16(w3) || !aligned16(scratch) ||
      (pdmt_mma_stamp_words() > 0 && stamps == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rng)
    return static_cast<int>(launch(x, y, PhiloxBlockMask{seed, rng_block}, w1,
                                   b1, w2, b2, w3, scratch, loss, gw1, gb1,
                                   gw2, gb2, gw3, stamps, batch, inv_batch, s));
  return static_cast<int>(launch(x, y, ArrayMask{mask}, w1, b1, w2, b2, w3,
                                 scratch, loss, gw1, gb1, gw2, gb2, gw3, stamps,
                                 batch, inv_batch, s));
}
