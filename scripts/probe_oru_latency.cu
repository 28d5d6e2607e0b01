// Latencies of the operations on the ORU kernel's dependent chain
// (aicamera_tpu_torch/csrc/oru.cu), one warp on one SM: clock64() cycles a
// step of a chain of kSteps dependent operations, each chain written to a
// slot of the caller's buffer. Built with --fmad=false, as the kernel is.
// scripts/probe_oru_latency.py builds, launches and prints it.

#include <cuda_runtime.h>

namespace {

constexpr int kSteps = 256;
constexpr int kChains = 10;

__global__ void chains(float* sink, long long* cycles, float b, float c) {
  const int t = threadIdx.x;
  float a = 1.0f + t * 1e-3f;
  long long t0;
#define CHAIN(slot, init, body, result)                                 \
  {                                                                     \
    init;                                                               \
    t0 = clock64();                                                     \
    _Pragma("unroll 16") for (int i = 0; i < kSteps; ++i) { body; }     \
    sink[(slot) * 32 + t] = (result);                                   \
    if (t == 0) cycles[slot] = clock64() - t0;                          \
  }
  // 0: the checked IEEE division
  CHAIN(0, , a = a / b, a);
  // 1: the division of a zero dividend (its slow subroutine)
  CHAIN(1, float z = a * 0.0f, z = z / b, z);
  // 2: four independent divisions a step
  CHAIN(2, float d0 = a; float d1 = a + 1; float d2 = a + 2; float d3 = a + 3,
        d0 = d0 / b; d1 = d1 / b; d2 = d2 / b; d3 = d3 / b,
        d0 + d1 + d2 + d3);
  // 3: the IEEE square root, then an add
  CHAIN(3, , a = sqrtf(a) + c, a);
  // 4: an add
  CHAIN(4, , a = a + c, a);
  // 5: a multiply
  CHAIN(5, , a = a * b, a);
  // 6: a width-8 shuffle under the whole warp's mask
  CHAIN(6, , a = __shfl_sync(0xffffffffu, a, (t + 1) & 7, 8), a);
  // 7: a width-8 shuffle under the 8-lane group's own mask (a runtime mask)
  CHAIN(7, const unsigned m = (unsigned)(b > 0.0f ? 0xff : 0) << (t & 24),
        a = __shfl_sync(m, a, (t + 1) & 7, 8), a);
  // 8: a select on a compare, as the replay's discarded steps take
  CHAIN(8, , a = a > c ? a : c + 1.0f, a);
  // 9: the zero test and direct answer that replace a zero division
  CHAIN(9, float z = a * 0.0f,
        z = z == 0.0f ? __uint_as_float((__float_as_uint(z) ^
                                         __float_as_uint(b)) & 0x80000000u)
                      : z / b,
        z);
#undef CHAIN
}

}  // namespace

// Launches one warp and copies the kChains cycle counts into host[0:10].
// Returns 0 or the CUDA error.
extern "C" int aicam_oru_latency(long long* host) {
  float* sink = nullptr;
  long long* cycles = nullptr;
  cudaError_t e = cudaMalloc(&sink, kChains * 32 * sizeof(float));
  if (e == cudaSuccess) e = cudaMalloc(&cycles, kChains * sizeof(long long));
  for (int rep = 0; rep < 3 && e == cudaSuccess; ++rep) {
    chains<<<1, 32>>>(sink, cycles, 1.0001f, 0.5f);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess)
    e = cudaMemcpy(host, cycles, kChains * sizeof(long long),
                   cudaMemcpyDeviceToHost);
  cudaFree(sink);
  cudaFree(cycles);
  return (int)e;
}

extern "C" int aicam_oru_latency_steps() { return kSteps; }
