// A CPU emulation of the CUDA built-ins that aicamera_tpu_torch/csrc/oru.cu
// and csrc/nms.cu use, for tests/test_torch_oru.py and
// tests/test_torch_nms_kernel.py: a kernel launch runs its blocks one after
// another (a 2-D grid row by row), a block's threads as std::threads;
// __shared__ variables are function statics, which the blocks share one
// after another as a block's threads share them on the card, and a
// launch's dynamic shared memory one buffer, filled with garbage first;
// __syncthreads is a barrier of the block; __shfl_sync, __shfl_up_sync,
// __any_sync, __reduce_max_sync, __ballot_sync and __syncwarp are barriers
// of the warp on each side of an exchange (every lane of a warp takes
// part, as the kernels' full-warp masks say). The Hopper primitives that
// csrc/nms.cu wraps (AICAM_CPU_EMULATION set: the source then leaves them
// to this file) are a plain copy for the bulk copy, done at once by the
// thread that issues it, a block barrier for the wait on its mbarrier,
// which every thread of the block makes, and max.NaN and min.NaN as the
// NaN-keeping selects they stand for. f32 arithmetic is the
// host's IEEE single precision (built with -ffp-contract=off, as the
// kernel is with --fmad=false), so what the emulation shows about the
// order of the operations holds for the card; what the card's compiler
// does does not show here.
#define AICAM_CPU_EMULATION 1
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
#define __host__
#define __shared__ static
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__

struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return {x, y, z, w};
}
struct dim3 {
  unsigned x = 0, y = 0, z = 0;
  dim3() = default;
  dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class Kernel>
cudaError_t cudaFuncSetAttribute(Kernel, cudaFuncAttribute, int) {
  return cudaSuccess;
}
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
  unsigned words[1024];
  int votes[1024];
  std::vector<unsigned char> dynamic;  // the launch's dynamic shared memory
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
inline unsigned __shfl_sync(unsigned, unsigned v, int src, int width = 32) {
  const int t = threadIdx.x;
  g_emu_block->words[t] = v;
  warp_barrier().arrive_and_wait();
  const unsigned got = g_emu_block->words[t / width * width + src];
  warp_barrier().arrive_and_wait();
  return got;
}
inline int __shfl_sync(unsigned mask, int v, int src, int width = 32) {
  return (int)__shfl_sync(mask, (unsigned)v, src, width);
}
inline int __shfl_up_sync(unsigned, int v, unsigned delta) {
  const int t = threadIdx.x, lane = t % 32;
  g_emu_block->words[t] = (unsigned)v;
  warp_barrier().arrive_and_wait();
  const int got = lane >= (int)delta ? (int)g_emu_block->words[t - delta] : v;
  warp_barrier().arrive_and_wait();
  return got;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  const int t = threadIdx.x, w = t / 32 * 32;
  g_emu_block->votes[t] = pred != 0;
  warp_barrier().arrive_and_wait();
  unsigned bits = 0;
  for (int i = 0; i < 32; ++i)
    bits |= (unsigned)(g_emu_block->votes[w + i] != 0) << i;
  warp_barrier().arrive_and_wait();
  return bits;
}
inline void __syncwarp(unsigned = 0xffffffffu) {
  warp_barrier().arrive_and_wait();
}
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __clz(int x) { return x == 0 ? 32 : __builtin_clz((unsigned)x); }
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
inline unsigned atomicOr(unsigned* a, unsigned v) {
  return __atomic_fetch_or(a, v, __ATOMIC_RELAXED);
}
inline void __syncthreads() { g_emu_block->block->arrive_and_wait(); }

// csrc/nms.cu's Hopper primitives
inline uint8_t* dynamic_smem() { return g_emu_block->dynamic.data(); }
inline void mbarrier_init(uint64_t*, uint32_t) {}
inline void fence_mbarrier_init() {}
inline void fence_proxy_async() {}
inline void mbarrier_arrive_expect_tx(uint64_t*, uint32_t) {}
inline void cp_async_bulk_g2s(void* dst, const void* src, uint32_t bytes,
                              uint64_t*) {
  std::memcpy(dst, src, bytes);
}
inline void mbarrier_wait_parity(uint64_t*, uint32_t) { __syncthreads(); }
// max.NaN and min.NaN: NaN where either input is NaN
inline float fmax_nan(float a, float b) {
  return std::isnan(a) ? a : (std::isnan(b) ? b : (a > b ? a : b));
}
inline float fmin_nan(float a, float b) {
  return std::isnan(a) ? a : (std::isnan(b) ? b : (a < b ? a : b));
}

// kernel<<<grid, threads, smem>>>(args...); threads a multiple of 32. The
// block's threads are made once a launch and run the blocks one after
// another, all of a block's threads done before the next block starts.
template <class Kernel, class... Args>
void emu_launch_smem(dim3 grid, int threads, size_t smem, Kernel kernel,
                     Args... args) {
  std::barrier<> block(threads), next(threads);
  EmuBlock emu;
  emu.block = &block;
  emu.dynamic.assign(smem + 16, 0xA5);
  for (int w = 0; w < threads / 32; ++w)
    emu.warps.push_back(std::make_unique<std::barrier<>>(32));
  g_emu_block = &emu;
  std::vector<std::thread> lanes;
  for (int t = 0; t < threads; ++t)
    lanes.emplace_back([&, t] {
      threadIdx.x = t;
      for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          blockIdx.x = bx;
          blockIdx.y = by;
          kernel(args...);
          next.arrive_and_wait();
        }
    });
  for (auto& lane : lanes) lane.join();
}

template <class Kernel, class... Args>
void emu_launch(dim3 grid, int threads, Kernel kernel, Args... args) {
  emu_launch_smem(grid, threads, 0, kernel, args...);
}

template <class Kernel, class... Args>
void emu_launch(int blocks, int threads, Kernel kernel, Args... args) {
  emu_launch(dim3(blocks), threads, kernel, args...);
}
