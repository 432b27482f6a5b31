// The latency of one `mma.sync.aligned.m16n8k16` bf16 -> f32 on this card:
// one warp runs `n` MMAs, each accumulating into the previous one's result
// (a dependent chain, as a K1-mma output's k-steps are), between two reads
// of the SM's cycle counter. scripts/mma_latency.py builds and runs it.

#include <cstdint>

__global__ void mma_chain(int n, const uint32_t* in, float* out,
                          long long* cycles) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = in[i * 32 + threadIdx.x];
  for (int i = 0; i < 2; ++i) b[i] = in[128 + i * 32 + threadIdx.x];
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  __syncwarp();
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  // the last result is read before the clock, so the chain has finished
  const float s = d[0] + d[1] + d[2] + d[3];
  __syncwarp();
  const long long t1 = clock64();
  out[threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
}

extern "C" int mma_chain_cycles(int n, const uint32_t* in, float* out,
                                long long* cycles, void* stream) {
  mma_chain<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(n, in, out,
                                                             cycles);
  return static_cast<int>(cudaGetLastError());
}
