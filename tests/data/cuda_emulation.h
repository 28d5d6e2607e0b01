// A CPU emulation of the CUDA built-ins that aicamera_tpu_torch/csrc/oru.cu
// uses, for tests/test_torch_oru.py: a kernel launch runs its blocks one
// after another, each block's threads as std::threads; __syncthreads is a
// barrier of the block; __shfl_sync, __any_sync and __reduce_max_sync are
// barriers of the warp on each side of an exchange (every lane of a warp
// takes part, as the kernel's full-warp masks say). f32 arithmetic is the host's
// IEEE single precision (built with -ffp-contract=off, as the kernel is
// with --fmad=false), so what the emulation shows about the order of the
// operations holds for the card; what the card's compiler does does not
// show here.
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__

struct float4 { float x, y, z, w; };
struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3 threadIdx, blockIdx;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class T>
cudaError_t cudaMemcpyFromSymbol(void* dst, const T& src, size_t n) {
  std::memcpy(dst, &src, n);
  return cudaSuccess;
}
template <class T>
cudaError_t cudaMemcpyToSymbol(T& dst, const void* src, size_t n) {
  std::memcpy(&dst, src, n);
  return cudaSuccess;
}
inline long long clock64() { return 0; }
using std::isnan;

struct EmuBlock {
  std::barrier<>* block;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  float exchange[1024];
  int votes[1024];
};
inline EmuBlock* g_emu_block;

inline std::barrier<>& warp_barrier() {
  return *g_emu_block->warps[threadIdx.x / 32];
}
inline float __shfl_sync(unsigned, float v, int src, int width) {
  const int t = threadIdx.x;
  g_emu_block->exchange[t] = v;
  warp_barrier().arrive_and_wait();
  const float got = g_emu_block->exchange[t / width * width + src];
  warp_barrier().arrive_and_wait();
  return got;
}
inline int __reduce_max_sync(unsigned, int v) {
  const int t = threadIdx.x, w = t / 32 * 32;
  g_emu_block->votes[t] = v;
  warp_barrier().arrive_and_wait();
  int m = g_emu_block->votes[w];
  for (int i = 1; i < 32; ++i)
    m = g_emu_block->votes[w + i] > m ? g_emu_block->votes[w + i] : m;
  warp_barrier().arrive_and_wait();
  return m;
}
inline int __any_sync(unsigned mask, int v) {
  return __reduce_max_sync(mask, v != 0 ? 1 : 0);
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, sizeof u);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
}
inline unsigned long long atomicAdd(unsigned long long* a,
                                    unsigned long long v) {
  return __atomic_fetch_add(a, v, __ATOMIC_RELAXED);
}
inline void __syncthreads() { g_emu_block->block->arrive_and_wait(); }

// kernel<<<blocks, threads>>>(args...); threads a multiple of 32
template <class Kernel, class... Args>
void emu_launch(int blocks, int threads, Kernel kernel, Args... args) {
  for (int b = 0; b < blocks; ++b) {
    std::barrier<> block(threads);
    EmuBlock emu;
    emu.block = &block;
    for (int w = 0; w < threads / 32; ++w)
      emu.warps.push_back(std::make_unique<std::barrier<>>(32));
    g_emu_block = &emu;
    std::vector<std::thread> lanes;
    for (int t = 0; t < threads; ++t)
      lanes.emplace_back([=] {
        threadIdx.x = t;
        blockIdx.x = b;
        kernel(args...);
      });
    for (auto& lane : lanes) lane.join();
  }
}
