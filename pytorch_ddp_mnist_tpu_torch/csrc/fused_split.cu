// K1-split: the per-step fused kernel (K1) redesigned for Hopper in its f32
// forms, at batches up to B_MAX rows. One call computes one training step's
// mean cross-entropy loss and the gradients of fc1 (w, b), fc2 (w, b) and
// fc3 (w), bitwise the rows design (fused_step.cu) on the same inputs.
//
// Replaces the TPU kernel pytorch_ddp_mnist_tpu/ops/pallas_step.py
// `_make_fused_kernel` (:191), reached through `_run_fused` (:350), in the
// forms the default trainer launches:
//   f32 x, pre-drawn mask           `fused_loss_and_grads`
//   f32 x, in-kernel Philox mask    `fused_loss_and_grads_rng` (the Philox
//                                   block keyed (step seed, batch block)),
//                                   the seed a launch argument or read
//                                   from word 0 of a key-table row in
//                                   device memory (a captured step's)
//   f32 x, in-kernel threefry mask  `fused_loss_and_grads_keyed`: jax's
//                                   `dropout_mask(key, B)` (pallas_step.py
//                                   `dropout_mask` :1226, `threefry2x32`
//                                   :92, `_threefry_mask_block` :123), the
//                                   key's words read from a device table
// The keyed form is the `--kernel pallas` step: it takes the place of the
// streaming mask entry (fused_step.cu `threefry_mask_kernel`), its launch,
// its host wrapper and the mask's round trip through device memory, and
// leaves no per-step host input but the table's row.
// ops/fused_step.py `fused_design` sends them here at B <= B_MAX; the bf16
// forms and larger batches stay on the rows design (fused_step.cu).
//
// What bounds it on an H100: at B = 128 the six products are 64.9 MFLOP of
// f32 multiply-adds, 0.97 us at the 67 TFLOP/s CUDA-core peak; the bytes
// (x, mask, labels, weights in; loss and grads out) are 1.41 MB, 0.42 us at
// 3.35 TB/s. The longest dependent chain, z1 of one (row, unit), is 784
// FMAs of ~4 cycles each: ~1.6 us at a 2 GHz SM clock. What sets the time
// here is none of those: each of the three launches costs ~1.4 us even in a
// CUDA graph, and within a kernel the SM's shared memory delivers 128 bytes
// of thread operands a cycle, broadcast or not, so the operand bytes a
// thread loads per FMA bound each phase.
//
// What the rows design lost its time to, and what this one does:
//  * its rows_kernel ran the z1 chains on B/8 = 16 blocks, each streaming
//    all of w1 from L2 with a global load before every FMA. Here
//    split_hidden_kernel spreads the chains over the card: its grid is 16
//    unit groups of HU = 8 x B/16 row groups of HR = 16, 128 blocks at B =
//    128, one chain a thread.
//  * operands come to shared memory by the Tensor Memory Accelerator, one
//    copy a group: a thread that issues cp.async stalls until its copies
//    drain, which held every chain back until nearly all of its block's
//    operands had landed, and small bulk copies cost ~40 ns each, one after
//    another. The hidden kernel takes k in 7 groups of 112: one 2-D tensor
//    copy of its 16 rows of x (a box 116 floats wide, so a row is an odd 29
//    float4s and the 4 rows a warp reads fall in distinct bank groups) and
//    one of w1's 8 columns ([k][8]); each group completes on its own
//    mbarrier and the chains run on it as soon as it lands.
//  * the rest of the row work (z2, h2, logits, softmax, loss, dl, dz2, dd1,
//    dz1) runs in split_rows_kernel, RR = 4 rows a block (32 blocks at B
//    = 128), thread j owning unit j of the block's rows. w2 comes in 4
//    tensor copies of 32 rows, each a box 132 floats wide (its padded row
//    stride; the 4 columns past the array read as zeros), and z2 starts on
//    the first; dd1 then reads the rows j of the same copy as float4s. d1
//    and dz2 are held by unit ([k][RR]), so one float4 broadcast gives the
//    block's 4 rows at one k.
//  * its grads_kernel waited on a global load of g[b][j] inside every
//    gradient chain, and one block summed the biases and the loss.
//    split_grads_kernel: 98 gw1 tiles and 16 gw2 tiles of GT = 8 rows and
//    4 gw3 blocks (row halves x class halves), 64 threads each. A tile's
//    thread owns 4 rows x 4 columns: per batch row one float4 of the right
//    operand (dz1 or dz2) and one of the left (x or d1) for 16 FMAs, a
//    quarter of the operand bytes per FMA of one chain a thread. A block
//    takes the right operand (B x 128) in 4 bulk copies of 32 batch rows
//    and the left's 8 columns in 4 tensor copies, and runs its chains on a
//    group as soon as it lands. gb1 is summed by gw1's first tile, gb2 by
//    gw2's first, the loss by gw3's first block: one thread an output, from
//    shared memory, so no block does all of them.
//  * three plain launches, no grid barrier: each phase has the grid its
//    work wants (128, B/4 and 118 blocks), the exchange passes through
//    global scratch across the kernel boundaries, and the launches capture
//    in a CUDA graph. (Launching the rows and grads kernels as programmatic
//    dependents of the kernel before took no time off a call in a graph:
//    PERF.md.)
//  * every wait on a copy is bounded (BAR_TRIES polls, then __trap): a
//    copy that never lands (a byte count or a tensor map that does not
//    match its box) fails the launch instead of holding the card.
//
// The bitwise contract: every output element is ONE sequential chain in
// mlp_step.cuh's order: z1 fmaf over k = 0..783 from 0, then + b1; d1 =
// fmaxf(z1, 0) * m; z2 fmaf over k = 0..127, + b2; h2 = fmaxf(z2, 0);
// logits fmaf over k = 0..127; rows_block's softmax and loss; dh2 fmaf
// over c = 0..9, dz2 = dh2 * [z2 > 0]; dd1 fmaf over k = 0..127, dz1 =
// (dd1 * m) * [z1 > 0]; each weight gradient fmaf over b = 0..B-1 from 0;
// gb1, gb2 and the loss plain adds over b in order, then loss / B. The
// speed comes from which block owns which chains and where their operands
// sit, never from splitting a chain: no split-K, no float atomics, no
// partial sum that crosses threads; built without --use_fast_math.
//
// Build macro: SPLIT_STAMPS, a debug build that records %globaltimer at the
// phase boundaries (ops/fused_step.py `split_phase_stamps`); the default
// build has none of that code.
//
// Plain C interface for ctypes (ops/_build.py, ops/fused_step.py): launches
// on the caller's stream, never synchronises, allocates nothing, and
// returns the CUDA error code (0 on success).

#include <cstdint>

#include <cuda.h>

#include "mlp_step.cuh"
#include "tma.cuh"

namespace {

using namespace mlp;
using namespace tma;

// rows a call: split_grads_kernel holds all of them in shared memory
constexpr int B_MAX = 128;
constexpr int THREADS = 128;

// split_hidden_kernel: HR rows x HU units a block, one chain a thread
constexpr int HR = 16;
constexpr int HU = 8;
constexpr int UNIT_GROUPS = H1 / HU;  // 16
constexpr int KC = 112;               // k a copy group
constexpr int NKC = IN / KC;          // 7 groups
// a group's box of x: HR rows x XC columns, 4 more than KC (past k = 783
// they read as zeros) so that a row is 29 float4s, an odd stride
constexpr int XC = KC + 4;
static_assert(HR * HU == THREADS && HU == 8 && HR == 4 * (THREADS / 32),
              "a warp is 4 rows x 8 units");
static_assert(NKC * KC == IN && KC % 4 == 0 && (XC / 4) % 2 == 1,
              "whole float4 groups; an odd float4 stride");
static_assert(HR * XC * sizeof(float) % 128 == 0 &&
                  KC * HU * sizeof(float) % 128 == 0,
              "tensor-copy boxes start on 128 bytes");
// per group: the box of x ([HR][XC]), then w1's columns j0 .. j0+7 as they
// lie in w1 ([k][8]); one mbarrier a group
constexpr size_t HIDDEN_SMEM =
    sizeof(float) * (NKC * HR * XC + IN * HU) + sizeof(uint64_t) * NKC;

// split_rows_kernel: RR rows a block, thread j owns unit j
constexpr int RR = 4;
constexpr int W2S = H2 + 4;           // w2's shared row stride (16-byte rows)
constexpr int NWC = 4;                // copy groups of w2
constexpr int WCR = H1 / NWC;         // 32 rows of w2 a group
static_assert(THREADS == H1 && RR * NC <= THREADS && RR == 4,
              "one thread a unit; float4 of the block's rows");
static_assert(WCR * W2S * sizeof(float) % 128 == 0 &&
                  H1 * W2S * sizeof(float) % 16 == 0,
              "w2's boxes start on 128 bytes; w3 after them on 16");
constexpr size_t ROWS_SMEM =
    sizeof(float) * (H1 * W2S + H2 * NC + 3 * H1 * RR + RR * NC) +
    sizeof(uint64_t) * NWC;

// split_grads_kernel: 64 threads a block; a gw1 or gw2 tile's thread owns
// 4 rows x 4 columns (16 chains), a gw3 block's thread one row x 5 classes
constexpr int GRAD_THREADS = 64;
constexpr int GT = 8;                          // rows of a gw1 / gw2 tile
constexpr int GK = 4;                          // of them a thread's
constexpr int GJ = 4;                          // columns a thread's
constexpr int TILES_W1 = IN / GT;              // 98
constexpr int TILES_W2 = H1 / GT;              // 16
constexpr int W3_BLOCKS = 4;                   // 2 row halves x 2 class halves
constexpr int W3C = NC / 2;                    // 5 classes a gw3 block
constexpr int GRAD_BLOCKS = TILES_W1 + TILES_W2 + W3_BLOCKS;  // 118
constexpr int NGC = 4;                         // copy groups of rows
constexpr int GCR = B_MAX / NGC;               // 32 batch rows a group
// the left operand in shared memory: a tile's 8 columns ([b][GT], a tensor
// copy's box), or gw3's dl ([b][NC]) and row losses ([b])
constexpr int LEFT_FLOATS = B_MAX * (NC + 1);
static_assert(TILES_W1 * GT == IN && GT == 2 * GK &&
                  GRAD_THREADS == 2 * (H1 / GJ) && GRAD_THREADS == H2 / 2 &&
                  LEFT_FLOATS >= B_MAX * GT,
              "whole tiles; a warp a row group of a tile; gw3 row halves");

__host__ __device__ constexpr size_t grads_smem(int batch) {
  return sizeof(float) * ((size_t)batch * H1 + LEFT_FLOATS) +
         sizeof(uint64_t) * NGC;
}
static_assert(HIDDEN_SMEM <= 232448 && ROWS_SMEM <= 232448 &&
                  grads_smem(B_MAX) <= 232448,
              "over the 227 KB a block may use");

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// The scratch a call takes, in floats: d1, z1, m, h2, dz2, dz1 (batch x 128
// each), dl (batch x 10), the row losses, each region starting on 16 bytes,
// and 4 floats of slack: the bulk copies of dl and the row losses round
// their size up to 16 bytes.
__host__ __device__ constexpr int scratch_floats(int batch) {
  return 6 * batch * H1 + round4(batch * NC) + round4(batch) + 4;
}

// ---- phase stamps (SPLIT_STAMPS) ----

// Each kernel's start is stamped by its block 0 as it begins; each kernel's
// end is the last of its blocks' ends (atomicMax over blocks, after a
// barrier). The rows kernel's inner boundaries are its block 0's.
enum Stamp : int {
  ST_HIDDEN_START,  // split_hidden_kernel, block 0 begins
  ST_HIDDEN_END,    // its last block's z1, mask and d1 out
  ST_ROWS_START,    // split_rows_kernel, block 0 begins
  ST_ROWS_Z2,       // w2 in, z2 and h2 out (block 0)
  ST_ROWS_SOFTMAX,  // logits, softmax, loss and dl (block 0)
  ST_ROWS_END,      // its last block's dz2, dd1 and dz1 out
  ST_GRADS_START,   // split_grads_kernel, block 0 begins
  ST_GRADS_END,     // its last block's gradients out
  N_STAMPS
};

#ifdef SPLIT_STAMPS
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;  // "memory": not moved across the barriers
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}
#endif

// block 0's time at `at` (all threads call it: it holds a barrier)
__device__ __forceinline__ void stamp_block0(unsigned long long* st, int at) {
#ifdef SPLIT_STAMPS
  __syncthreads();
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    st[at] = global_ns();
#endif
}

// the last block's time at `at` (all threads call it: it holds a barrier)
__device__ __forceinline__ void stamp_last(unsigned long long* st, int at) {
#ifdef SPLIT_STAMPS
  __syncthreads();
  if (threadIdx.x == 0) atomicMax(st + at, global_ns());
#endif
}

// ---- staging by the Tensor Memory Accelerator (tma.cuh) ----
//
// One lane issues one tensor or bulk copy a group, each group on its own
// mbarrier, and the chains start on a group as soon as it lands.

// ---- phase 1: z1, the mask, d1 ----

// Block (unit group, row group): rows row0 .. row0+HR-1 x units j0 ..
// j0+HU-1. Thread t: unit j0 + (t & 7), row row0 + 4 (t / 32) + (t % 32) /
// 8. Group c: k = c*KC .. c*KC+KC-1 of the block's rows (one tensor copy of
// an HR x XC box) and of w1's 8 columns (one of a KC x 8 box). Per 4 k a
// warp reads one float4 of x for each of its 4 rows (distinct bank groups
// by the odd float4 stride) and, at each k, one float of w1 for each of its
// 8 units (one 32-byte span).
template <class MaskAt>
__global__ void __launch_bounds__(THREADS) split_hidden_kernel(
    const __grid_constant__ CUtensorMap x_map, MaskAt mask_at,
    const __grid_constant__ CUtensorMap w1_map, const float* __restrict__ b1,
    float* __restrict__ d1_out, float* __restrict__ z1_out,
    float* __restrict__ m_out, int batch, unsigned long long* stamps) {
  extern __shared__ __align__(128) float smem[];
  float* const xs = smem;                  // [NKC][HR][XC] the rows of x
  float* const ws = smem + NKC * HR * XC;  // [IN][HU] the columns of w1
  uint64_t* const bars = reinterpret_cast<uint64_t*>(ws + IN * HU);
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * HU;
  const int row0 = blockIdx.y * HR;
  const int nrows = min(HR, batch - row0);
  stamp_block0(stamps, ST_HIDDEN_START);
  bars_init(bars, NKC);
  if (tid == 0)
    for (int c = 0; c < NKC; ++c) {
      bar_expect(bars + c, (HR * XC + KC * HU) * sizeof(float));
      tensor_copy(xs + c * HR * XC, &x_map, c * KC, row0, bars + c);
      tensor_copy(ws + c * KC * HU, &w1_map, j0, c * KC, bars + c);
    }

  const int u = tid & 7;
  const int r = 4 * (tid >> 5) + ((tid & 31) >> 3);
  const int row = row0 + r, j = j0 + u;
  const bool valid = r < nrows;
  // the bias and the mask, read (or drawn: the keyed form's ~130 dependent
  // integer operations) before the chain, while the copies are in flight
  const float bj = b1[j];
  const float m = valid ? mask_at(row, j) : 0.f;
  const float* wu = ws + u;
  float acc = 0.f;
#pragma unroll 1
  for (int c = 0; c < NKC; ++c) {
    bar_wait(bars + c);
    const float4* xc =
        reinterpret_cast<const float4*>(xs + (c * HR + r) * XC);
    const float* wc = wu + c * KC * HU;
#pragma unroll
    for (int q = 0; q < KC / 4; ++q) {
      const float4 a = xc[q];
      acc = fmaf(a.x, wc[(4 * q) * HU], acc);
      acc = fmaf(a.y, wc[(4 * q + 1) * HU], acc);
      acc = fmaf(a.z, wc[(4 * q + 2) * HU], acc);
      acc = fmaf(a.w, wc[(4 * q + 3) * HU], acc);
    }
  }
  if (valid) {
    const size_t at = (size_t)row * H1 + j;
    const float z1 = acc + bj;
    d1_out[at] = fmaxf(z1, 0.f) * m;
    z1_out[at] = z1;
    m_out[at] = m;  // drawn or read, the rows phase reads it for dz1
  }
  stamp_last(stamps, ST_HIDDEN_END);
}

// ---- phase 2: the rest of each row ----

__global__ void __launch_bounds__(THREADS) split_rows_kernel(
    const int* __restrict__ y, const __grid_constant__ CUtensorMap w2_map,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const float* __restrict__ d1_in, const float* __restrict__ z1_in,
    const float* __restrict__ m_in, float* __restrict__ h2_out,
    float* __restrict__ dz2_out, float* __restrict__ dz1_out,
    float* __restrict__ dl_out, float* __restrict__ row_loss, int batch,
    float inv_batch, unsigned long long* stamps) {
  extern __shared__ __align__(128) float smem[];
  float* const w2s = smem;              // [H1][W2S] w2 as it is
  float* const w3s = w2s + H1 * W2S;    // [H2][NC]
  float* const d1s = w3s + H2 * NC;     // [H1][RR] by unit, then row
  float* const h2s = d1s + H1 * RR;     // [H2][RR]
  float* const dz2s = h2s + H2 * RR;    // [H2][RR]
  float* const lg = dz2s + H2 * RR;     // [RR][NC] logits, then dl
  uint64_t* const bars = reinterpret_cast<uint64_t*>(lg + RR * NC);
  const int j = threadIdx.x;
  const int row0 = blockIdx.x * RR;
  stamp_block0(stamps, ST_ROWS_START);
  bars_init(bars, NWC);
  // group c: rows c*WCR .. c*WCR+WCR-1 of w2, one tensor copy of a WCR x
  // W2S box (its columns past 127 read as zeros: the padding), and w3 with
  // the first group
  if (j == 0)
    for (int c = 0; c < NWC; ++c) {
      bar_expect(bars + c, (WCR * W2S + (c == 0 ? H2 * NC : 0)) *
                               sizeof(float));
      tensor_copy(w2s + c * WCR * W2S, &w2_map, 0, c * WCR, bars + c);
      if (c == 0) bulk_copy(w3s, w3, H2 * NC * sizeof(float), bars);
    }
  // read before the chains: the bias, and a softmax thread's label
  const float bj2 = b2[j];
  const int yr = j < RR && row0 + j < batch ? y[row0 + j] : -1;
  float z1[RR], m[RR], z2[RR];
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    const int row = row0 + r;
    const bool valid = row < batch;
    const size_t at = (size_t)row * H1 + j;
    z1[r] = valid ? z1_in[at] : 0.f;
    m[r] = valid ? m_in[at] : 0.f;
    d1s[j * RR + r] = valid ? d1_in[at] : 0.f;
    z2[r] = 0.f;
  }
  __syncthreads();

  // z2 over k = 0..127 in order, each group of w2 as it lands; the
  // operands of k + 2 are loaded before the products of k
  const float4* d1v = reinterpret_cast<const float4*>(d1s);
#pragma unroll
  for (int c = 0; c < NWC; ++c) {
    bar_wait(bars + c);
    const int k0 = c * WCR;
    float4 d0 = d1v[k0], d1 = d1v[k0 + 1];
    float v0 = w2s[k0 * W2S + j], v1 = w2s[(k0 + 1) * W2S + j];
#pragma unroll
    for (int kk = 0; kk < WCR; ++kk) {
      const float4 d2 = kk + 2 < WCR ? d1v[k0 + kk + 2] : d1;
      const float v2 = kk + 2 < WCR ? w2s[(k0 + kk + 2) * W2S + j] : v1;
      z2[0] = fmaf(d0.x, v0, z2[0]);
      z2[1] = fmaf(d0.y, v0, z2[1]);
      z2[2] = fmaf(d0.z, v0, z2[2]);
      z2[3] = fmaf(d0.w, v0, z2[3]);
      d0 = d1;
      d1 = d2;
      v0 = v1;
      v1 = v2;
    }
  }
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    const int row = row0 + r;
    z2[r] += bj2;
    const float h2 = fmaxf(z2[r], 0.f);
    h2s[j * RR + r] = h2;
    if (row < batch) h2_out[(size_t)row * H2 + j] = h2;
  }
  stamp_block0(stamps, ST_ROWS_Z2);
  __syncthreads();

  if (j < RR * NC) {
    const int r = j / NC, c = j - r * NC;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < H2; ++k)
      acc = fmaf(h2s[k * RR + r], w3s[k * NC + c], acc);
    lg[j] = acc;
  }
  __syncthreads();

  // the stable softmax cross-entropy of rows_block, one thread per row
  if (j < RR) {
    const int row = row0 + j;
    const bool valid = row < batch;
    float* l = lg + j * NC;
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
    for (int c = 0; c < NC; ++c) {
      const float dl = (ex[c] / se - (c == yr ? 1.f : 0.f)) * scale;
      l[c] = dl;
      if (valid) dl_out[(size_t)row * NC + c] = dl;
    }
    if (valid) row_loss[row] = (mx + logf(se)) - logit_y;
  }
  stamp_block0(stamps, ST_ROWS_SOFTMAX);
  __syncthreads();

  float wj3[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) wj3[c] = w3s[j * NC + c];
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    const int row = row0 + r;
    float dh2 = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) dh2 = fmaf(lg[r * NC + c], wj3[c], dh2);
    const float dz2 = dh2 * (z2[r] > 0.f ? 1.f : 0.f);
    dz2s[j * RR + r] = dz2;
    if (row < batch) dz2_out[(size_t)row * H2 + j] = dz2;
  }
  __syncthreads();

  // dd1 = dz2 w2^T: row j of w2, as float4s along k
  float dd1[RR];
#pragma unroll
  for (int r = 0; r < RR; ++r) dd1[r] = 0.f;
  const float4* wrow = reinterpret_cast<const float4*>(w2s + j * W2S);
  const float4* dzv = reinterpret_cast<const float4*>(dz2s);
#pragma unroll
  for (int k4 = 0; k4 < H2 / 4; ++k4) {
    const float4 w4 = wrow[k4];
    const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 d = dzv[4 * k4 + e];
      dd1[0] = fmaf(d.x, wv[e], dd1[0]);
      dd1[1] = fmaf(d.y, wv[e], dd1[1]);
      dd1[2] = fmaf(d.z, wv[e], dd1[2]);
      dd1[3] = fmaf(d.w, wv[e], dd1[3]);
    }
  }
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    const int row = row0 + r;
    if (row < batch)
      dz1_out[(size_t)row * H1 + j] =
          (dd1[r] * m[r]) * (z1[r] > 0.f ? 1.f : 0.f);
  }
  stamp_last(stamps, ST_ROWS_END);
}

// ---- phase 3: the gradients ----

// Blocks 0..97: gw1 rows 8t .. 8t+7 = x^T dz1; 98..113: gw2 rows = d1^T
// dz2; 114..117: gw3 rows 0..63 / 64..127 x classes 0..4 / 5..9 = h2^T dl.
// Thread t of a tile owns its rows 4 (t / 32) .. +3 x columns 4 (t % 32)
// .. +3: per batch row one float4 of the right operand (the warp's 32
// lanes on 512 contiguous bytes) and one of the left (a broadcast) for 16
// FMAs. Thread t of a gw3 block owns one row of it x 5 classes. Group c:
// batch rows c*GCR .. c*GCR+GCR-1 of the right operand (one bulk copy) and
// of the left (a tensor copy of the tile's 8 columns, or bulk copies of dl
// and the row losses).
__global__ void __launch_bounds__(GRAD_THREADS) split_grads_kernel(
    const __grid_constant__ CUtensorMap x_map,
    const __grid_constant__ CUtensorMap d1_map, const float* __restrict__ h2,
    const float* __restrict__ dz2, const float* __restrict__ dz1,
    const float* __restrict__ dl, const float* __restrict__ row_loss,
    float* __restrict__ loss, float* __restrict__ gw1,
    float* __restrict__ gb1, float* __restrict__ gw2, float* __restrict__ gb2,
    float* __restrict__ gw3, int batch, unsigned long long* stamps) {
  extern __shared__ __align__(128) float smem[];
  float* const gs = smem;                       // [batch][H1]
  float* const ls = smem + (size_t)batch * H1;  // the left operand
  uint64_t* const bars = reinterpret_cast<uint64_t*>(ls + LEFT_FLOATS);
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const bool tile = t < TILES_W1 + TILES_W2;
  const bool w1_tile = t < TILES_W1;
  const int k0 = (w1_tile ? t : t - TILES_W1) * GT;
  const float* g = !tile ? h2 : w1_tile ? dz1 : dz2;
  const int ngroups = (batch + GCR - 1) / GCR;
  stamp_block0(stamps, ST_GRADS_START);
  bars_init(bars, NGC);
  if (tid == 0) {
    for (int c = 0; c < ngroups; ++c) {
      const int b0 = c * GCR, nb = min(GCR, batch - b0);
      const unsigned gbytes = nb * H1 * sizeof(float);
      if (tile) {
        bar_expect(bars + c, gbytes + GCR * GT * sizeof(float));
        bulk_copy(gs + (size_t)b0 * H1, g + (size_t)b0 * H1, gbytes, bars + c);
        tensor_copy(ls + b0 * GT, w1_tile ? &x_map : &d1_map, k0, b0,
                    bars + c);
      } else {
        const unsigned dbytes = round16(nb * NC * sizeof(float));
        const unsigned lbytes = round16(nb * sizeof(float));
        bar_expect(bars + c, gbytes + dbytes + lbytes);
        bulk_copy(gs + (size_t)b0 * H1, g + (size_t)b0 * H1, gbytes, bars + c);
        bulk_copy(ls + b0 * NC, dl + (size_t)b0 * NC, dbytes, bars + c);
        bulk_copy(ls + B_MAX * NC + b0, row_loss + b0, lbytes, bars + c);
      }
    }
  }

  if (tile) {
    const int kk = GK * (tid >> 5);  // this thread's first row in the tile
    const int j0 = GJ * (tid & 31);  // and first column
    // the bias gradient of the unrounded dz1 (dz2), in the first tile
    const bool bias = (t == 0 || t == TILES_W1) && kk == 0;
    float acc[GK][GJ] = {};
    float s[GJ] = {};
#pragma unroll 1
    for (int c = 0; c < ngroups; ++c) {
      bar_wait(bars + c);
      const int end = min(batch, (c + 1) * GCR);
#pragma unroll 4
      for (int b = c * GCR; b < end; ++b) {
        const float4 gv = *reinterpret_cast<const float4*>(gs + (size_t)b * H1 + j0);
        const float4 av = *reinterpret_cast<const float4*>(ls + b * GT + kk);
        const float a[GK] = {av.x, av.y, av.z, av.w};
        const float gj[GJ] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int i = 0; i < GK; ++i)
#pragma unroll
          for (int e = 0; e < GJ; ++e) acc[i][e] = fmaf(a[i], gj[e], acc[i][e]);
        if (bias)
#pragma unroll
          for (int e = 0; e < GJ; ++e) s[e] += gj[e];
      }
    }
    float* out = w1_tile ? gw1 : gw2;
#pragma unroll
    for (int i = 0; i < GK; ++i)
      *reinterpret_cast<float4*>(out + (size_t)(k0 + kk + i) * H1 + j0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (bias)
      *reinterpret_cast<float4*>((w1_tile ? gb1 : gb2) + j0) =
          make_float4(s[0], s[1], s[2], s[3]);
  } else {
    const int q = t - TILES_W1 - TILES_W2;
    const int k = (q & 1) * GRAD_THREADS + tid;  // this thread's row of gw3
    const int c0 = (q >> 1) * W3C;
    const float* dls = ls;                 // [batch][NC]
    const float* rls = ls + B_MAX * NC;    // [batch]
    // the mean loss: one thread of the first gw3 block
    const bool loss_thread = q == 0 && tid == 0;
    float acc[W3C] = {};
    float s = 0.f;
#pragma unroll 1
    for (int c = 0; c < ngroups; ++c) {
      bar_wait(bars + c);
      const int end = min(batch, (c + 1) * GCR);
#pragma unroll 4
      for (int b = c * GCR; b < end; ++b) {
        const float hv = gs[(size_t)b * H1 + k];
#pragma unroll
        for (int cc = 0; cc < W3C; ++cc)
          acc[cc] = fmaf(hv, dls[b * NC + c0 + cc], acc[cc]);
        if (loss_thread) s += rls[b];
      }
    }
#pragma unroll
    for (int cc = 0; cc < W3C; ++cc) gw3[k * NC + c0 + cc] = acc[cc];
    if (loss_thread) loss[0] = s / (float)batch;
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
  err = allow_smem(split_hidden_kernel<ArrayMask>, HIDDEN_SMEM);
  if (err == cudaSuccess)
    err = allow_smem(split_hidden_kernel<PhiloxBlockMask>, HIDDEN_SMEM);
  if (err == cudaSuccess)
    err = allow_smem(split_hidden_kernel<ThreefryKeyMask>, HIDDEN_SMEM);
  if (err == cudaSuccess)
    err = allow_smem(split_hidden_kernel<PhiloxKeyMask>, HIDDEN_SMEM);
  if (err == cudaSuccess) err = allow_smem(split_rows_kernel, ROWS_SMEM);
  if (err == cudaSuccess)
    err = allow_smem(split_grads_kernel, grads_smem(B_MAX));
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

template <class MaskAt>
cudaError_t launch(const float* x, const int* y, MaskAt mask_at,
                   const float* w1, const float* b1, const float* w2,
                   const float* b2, const float* w3, float* scratch,
                   float* loss, float* gw1, float* gb1, float* gw2, float* gb2,
                   float* gw3, unsigned long long* stamps, int batch,
                   float inv_batch, cudaStream_t s) {
  float* d1 = scratch;
  float* z1 = d1 + (size_t)batch * H1;
  float* mv = z1 + (size_t)batch * H1;
  float* h2 = mv + (size_t)batch * H1;
  float* dz2 = h2 + (size_t)batch * H2;
  float* dz1 = dz2 + (size_t)batch * H2;
  float* dl = dz1 + (size_t)batch * H1;
  float* rl = dl + round4(batch * NC);
  CUtensorMap x_rows, w1_cols, w2_rows, x_cols, d1_cols;
  cudaError_t err = allow_smem_once();
  if (err == cudaSuccess) err = tensor_map(&x_rows, x, batch, IN, HR, XC);
  if (err == cudaSuccess) err = tensor_map(&w1_cols, w1, IN, H1, KC, HU);
  if (err == cudaSuccess) err = tensor_map(&w2_rows, w2, H1, H2, WCR, W2S);
  if (err == cudaSuccess) err = tensor_map(&x_cols, x, batch, IN, GCR, GT);
  if (err == cudaSuccess) err = tensor_map(&d1_cols, d1, batch, H1, GCR, GT);
  if (err != cudaSuccess) return err;
  split_hidden_kernel<MaskAt>
      <<<dim3(UNIT_GROUPS, (batch + HR - 1) / HR), THREADS, HIDDEN_SMEM, s>>>(
          x_rows, mask_at, w1_cols, b1, d1, z1, mv, batch, stamps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  split_rows_kernel<<<(batch + RR - 1) / RR, THREADS, ROWS_SMEM, s>>>(
      y, w2_rows, b2, w3, d1, z1, mv, h2, dz2, dz1, dl, rl, batch, inv_batch,
      stamps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  split_grads_kernel<<<GRAD_BLOCKS, GRAD_THREADS, grads_smem(batch), s>>>(
      x_cols, d1_cols, h2, dz2, dz1, dl, rl, loss, gw1, gb1, gw2, gb2, gw3,
      batch, stamps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pdmt_split_max_batch() { return B_MAX; }

// the scratch floats a call at `batch` takes
extern "C" int pdmt_split_scratch_floats(int batch) {
  return scratch_floats(batch);
}

// the blocks of the three launches at `batch`
extern "C" int pdmt_split_blocks(int batch, int* out3) {
  if (batch < 1 || batch > B_MAX) return static_cast<int>(cudaErrorInvalidValue);
  out3[0] = UNIT_GROUPS * ((batch + HR - 1) / HR);
  out3[1] = (batch + RR - 1) / RR;
  out3[2] = GRAD_BLOCKS;
  return 0;
}

// the stamp words a call records in the stamps build (N_STAMPS
// %globaltimer stamps), 0 in the default build
extern "C" int pdmt_split_stamp_words() {
#ifdef SPLIT_STAMPS
  return N_STAMPS;
#else
  return 0;
#endif
}

extern "C" const char* pdmt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One step. x (batch, 784) f32; y (batch,) int32. The mask by `rng`: 0
// reads `mask` (batch, 128); 1 draws it in the kernel from (seed, batch
// block of rng_block rows); 2 draws jax's threefry mask under the key words
// (k0, k1) at `key` (device memory, 8-byte aligned); 3 draws it as 1 does
// with the seed read from word 0 at `key` (a key-table row, so that a
// captured launch reads the seed at replay). What a form does not
// use may be null. x, w1, w2, w3 and scratch 16-byte aligned; scratch:
// pdmt_split_scratch_floats(batch) floats. stamps: pdmt_split_stamp_words()
// u64, zeroed, in the stamps build (else ignored). 1 <= batch <=
// pdmt_split_max_batch().
extern "C" int pdmt_split_step(
    const float* x, const int* y, int rng, const float* mask,
    const uint32_t* key, uint32_t seed, int rng_block, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* w3,
    float* scratch, float* loss, float* gw1, float* gb1, float* gw2,
    float* gb2, float* gw3, unsigned long long* stamps, int batch,
    float inv_batch, void* stream) {
  if (batch < 1 || batch > B_MAX || rng < 0 || rng > 3 ||
      ((rng == 1 || rng == 3) && rng_block < 1) ||
      (rng == 0 && mask == nullptr) ||
      (rng >= 2 && (key == nullptr || reinterpret_cast<uintptr_t>(key) % 8)) ||
      !aligned16(x) || !aligned16(w1) || !aligned16(w2) || !aligned16(w3) ||
      !aligned16(scratch) ||
      (pdmt_split_stamp_words() > 0 && stamps == nullptr))
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
