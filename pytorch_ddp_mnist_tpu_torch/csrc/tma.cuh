// Staging by the Tensor Memory Accelerator, shared by K1-split
// (fused_split.cu), K1-mma (fused_mma.cu), K2-mma (epoch_mma.cu) and
// K6-mma (ring_mma.cu).
//
// A thread that issues cp.async stalls until its copies drain, so per-thread
// copies held every chain back until nearly all of a block's operands had
// landed. Here one lane issues bulk copies (contiguous pieces) and 2-D
// tensor copies (strided boxes) per group, and each group completes on its
// own mbarrier: the work starts on a group as soon as it lands.
//
// Tensor maps are encoded on the host (cuTensorMapEncodeTiled, reached
// through the runtime's driver entry point: no link against libcuda) and
// cached by address, shape, box and element type; a map is copied out by
// value, so a later call that reuses the slot cannot change a map a launch
// holds. Every wait on a copy is bounded (BAR_TRIES polls, then __trap): a
// copy that never lands (a byte count or a tensor map that does not match
// its box) fails the launch instead of holding the card.

#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tma {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// barriers: init by one thread, then every thread syncs. A K1 launch uses
// each once (its phase 0); K2-mma inits them once a launch and uses each
// once a step, so the phase a wait names is the step's parity.
__device__ __forceinline__ void bars_init(uint64_t* bars, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_addr(bars + i))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// the one arrival of `bar`'s current phase, expecting `bytes` of copies
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// whether `bar`'s phase of parity `parity` has completed: its copies have
// landed
__device__ __forceinline__ bool bar_done(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until `bar`'s phase of parity `parity` (0: its first) has
// completed. The wait is bounded: a copy that never lands (a wrong byte
// count, or a wait on the wrong parity) traps, and the launch fails with a
// CUDA error instead of holding the card.
constexpr unsigned BAR_TRIES = 1u << 24;

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity = 0) {
  for (unsigned i = 0; !bar_done(bar, parity); ++i)
    if (i == BAR_TRIES) __trap();
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the box of `map` at (column c0, row c1) into shared dst (128-byte
// aligned), dense, elements past the array zero-filled, completing on `bar`
// (which counts the whole box, zeros included)
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// whether p is on 16 bytes, as bulk and tensor copies need
inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

__host__ __device__ constexpr unsigned round16(unsigned bytes) {
  return (bytes + 15) / 16 * 16;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a row-major (rows, cols) array of `type` (elements of
// `elem_bytes`) at `base` whose box is box_rows x box_cols, copied into
// *out; elements past the array read as zeros. Maps are cached by all of
// these (encoding one costs host time on every step; the weights, and the
// batches the caching allocator hands back, keep their addresses). The copy
// is by value: a later call may overwrite the slot.
inline cudaError_t tensor_map(CUtensorMap* out, const void* base,
                              CUtensorMapDataType type, int elem_bytes,
                              int rows, int cols, int box_rows,
                              int box_cols) {
  struct Entry {
    CUtensorMap map;
    const void* base;
    CUtensorMapDataType type;
    int rows, cols, box_rows, box_cols;
  };
  // K6-mma holds 14 maps a replica, 56 at four replicas
  constexpr int SLOTS = 64;
  static Entry cache[SLOTS];
  static int used = 0, next = 0;
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.base == base && e.type == type && e.rows == rows &&
        e.cols == cols && e.box_rows == box_rows && e.box_cols == box_cols) {
      *out = e.map;
      return cudaSuccess;
    }
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  Entry& e = cache[next];
  const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  if (fn(&e.map, type, 2, const_cast<void*>(base), dim, stride, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_NONE,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    e.base = nullptr;
    return cudaErrorInvalidValue;
  }
  e.base = base;
  e.type = type;
  e.rows = rows;
  e.cols = cols;
  e.box_rows = box_rows;
  e.box_cols = box_cols;
  next = (next + 1) % SLOTS;
  used = used < SLOTS ? used + 1 : SLOTS;
  *out = e.map;
  return cudaSuccess;
}

inline cudaError_t tensor_map(CUtensorMap* out, const float* base, int rows,
                              int cols, int box_rows, int box_cols) {
  return tensor_map(out, base, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, rows, cols,
                    box_rows, box_cols);
}

inline cudaError_t tensor_map(CUtensorMap* out, const __nv_bfloat16* base,
                              int rows, int cols, int box_rows,
                              int box_cols) {
  return tensor_map(out, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, rows,
                    cols, box_rows, box_cols);
}

}  // namespace tma
