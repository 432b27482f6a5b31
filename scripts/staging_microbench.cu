// Staging microbenchmark for the per-step kernels' design: what a launch
// costs in a CUDA graph, and what it costs to stage B x 512 bytes (and an
// 8-column box of a 784-wide array) into each of many blocks' shared
// memory by TMA bulk and tensor copies, by cp.async, or by plain loads;
// data just written by another kernel against data at rest. Built and run
// by scripts/staging_microbench.py.

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned sa(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wait_phase0(uint64_t* bar) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(sa(bar)),
      "r"(0u)
      : "memory");
}

__global__ void empty_kernel() {}

// 64 blocks x 128 threads write n floats
__global__ void writer_kernel(float* dst, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    dst[i] = static_cast<float>(i);
}

// rows x 512 B from g (+ block * stride floats) in `groups` bulk copies,
// and with `box` an 8 x 32 tensor copy of x per group
__global__ void tma_kernel(const float* g, long stride, int rows, int groups,
                           int box, const __grid_constant__ CUtensorMap xmap,
                           float* out) {
  extern __shared__ __align__(128) float sm[];
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(sa(&bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const char* src = reinterpret_cast<const char*>(g + blockIdx.x * stride);
  float* ls = sm + rows * 128;
  if (threadIdx.x == 0) {
    const unsigned per = rows * 512 / groups;
    const unsigned bytes = rows * 512 + (box ? groups * 32 * 8 * 4 : 0);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                     "r"(sa(&bar)),
                 "r"(bytes)
                 : "memory");
    for (int c = 0; c < groups; ++c) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];" ::"r"(sa(reinterpret_cast<char*>(sm) +
                                           c * per)),
          "l"(src + c * per), "r"(per), "r"(sa(&bar))
          : "memory");
      if (box)
        asm volatile(
            "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
            "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(
                sa(ls + c * 256)),
            "l"(reinterpret_cast<uint64_t>(&xmap)),
            "r"(static_cast<int>(blockIdx.x % 98) * 8), "r"(c * 32),
            "r"(sa(&bar))
            : "memory");
    }
  }
  wait_phase0(&bar);
  if (threadIdx.x == 0 && sm[5] == 12345.f) out[blockIdx.x] = ls[3];
}

// the same bytes by cp.async.cg, 16 bytes a thread
__global__ void cp_async_kernel(const float* g, long stride, int rows,
                                float* out) {
  extern __shared__ __align__(128) float sm[];
  const char* src = reinterpret_cast<const char*>(g + blockIdx.x * stride);
  for (int i = threadIdx.x; i < rows * 32; i += blockDim.x)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     sa(reinterpret_cast<char*>(sm) + 16 * i)),
                 "l"(src + 16 * i)
                 : "memory");
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0 && sm[5] == 12345.f) out[blockIdx.x] = 1.f;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
CUtensorMap xmap;

}  // namespace

// x: a (rows, 784) f32 array the box copies read
extern "C" int mb_setup(const float* x, int rows) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                              &found) != cudaSuccess ||
      found != cudaDriverEntryPointSuccess)
    return -1;
  const cuuint64_t dim[2] = {784, static_cast<cuuint64_t>(rows)};
  const cuuint64_t stride[1] = {784 * 4};
  const cuuint32_t box[2] = {8, 32}, unit[2] = {1, 1};
  for (const void* k : {reinterpret_cast<const void*>(tma_kernel),
                        reinterpret_cast<const void*>(cp_async_kernel)})
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         200000);
  return reinterpret_cast<EncodeTiled>(p)(
      &xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x), dim,
      stride, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// what: 0 an empty kernel; 1 TMA; 2 cp.async. write: first the writer
// kernel over `fresh`. blocks read from g (+ block * rows * 128 floats when
// `spread`).
extern "C" int mb_run(int what, int write, float* fresh, const float* g,
                      int spread, int rows, int groups, int box, int blocks,
                      float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (write) writer_kernel<<<64, 128, 0, s>>>(fresh, rows * 128);
  const long stride = spread ? rows * 128L : 0L;
  const size_t smem = rows * 512 + 4 * 32 * 8 * 4;
  if (what == 0) empty_kernel<<<1, 32, 0, s>>>();
  if (what == 1)
    tma_kernel<<<blocks, 128, smem, s>>>(g, stride, rows, groups, box, xmap,
                                         out);
  if (what == 2) cp_async_kernel<<<blocks, 128, smem, s>>>(g, stride, rows, out);
  return static_cast<int>(cudaGetLastError());
}
