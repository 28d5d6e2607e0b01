// Fused letterbox preprocess for Hopper (sm_90a).
//
// Replaces aicamera_tpu/ops/pallas_preprocess.py::_kernel (launched by
// preprocess_yolo_pallas). One launch per K-frame chunk turns uint8 BGR
// frames (K, H, W, 3) into letterboxed, [0, 1]-normalized RGB planes
// (K, 3, Dh, Dw) in f32 or bf16: a bilinear resize of the frame to the
// content rectangle, 114-padding around it, BGR->RGB, round half-to-even,
// clip to 0..255 and a division by 255.
//
// Bound: device-memory bytes. The work is ~10 flops per output value, far
// below the card's flop/byte balance. A chunk of 8 frames of 960x540 to
// 640x640 reads 12.4 MB of uint8 and writes 19.7 MB of bf16 (39.3 MB of
// f32): 9.6 us (15.4 us) at the H100's 3.35 TB/s. Measured by chip_smoke.py
// on an NVIDIA H100 80GB HBM3 at 700 W, inputs in device memory: the vector
// variant 17 us (22 us), the scalar variant 31 us (32 us).
//
// Two kernels, chosen on the host from shapes and alignment
// (ops/letterbox.py::launch_plan):
//
// letterbox_tile_kernel, the vector variant. A block owns `rows` consecutive
// output rows of one frame (grid: row tiles x frames, so no index is divided
// by a run-time divisor). It copies the contiguous band of source rows that
// the tile taps into shared memory with 16-byte cp.async, each source byte
// once per tile. The host moves a row tap of weight 0 onto its partner row
// (it adds byte * 0 = +0 whatever it names), so the band holds only rows
// that contribute: at an integer ratio (1920x1080 to 640x360) one source row
// per output row. A thread owns 8 consecutive output pixels of a row: it
// loads their 8 column taps (byte offsets and weights) into registers once
// with 16-byte loads and reuses them over the tile's rows and the three
// channels; the row taps are block-uniform. It reads its 2x2 neighbourhoods
// as bytes from shared memory, and per channel stores 8 bf16 as one 16-byte
// store (8 f32: two). Pad rows and groups in the left/right pad load
// nothing and store the constant 16 bytes at a time; tiles of pad rows skip
// the staging. It needs W*3 and the frame pointer to be multiples of 16
// bytes, Dw a multiple of 8, and the band of one tile to fit shared memory.
// The host picks small tiles (2 rows, or 1 where that stages fewer source
// rows) in blocks of one row of threads: a block only waits, then only
// computes, so the overlap of loads and arithmetic comes from the 8 blocks
// an SM holds at a time, and many small blocks measured faster than few
// large ones (8-row tiles in 320-thread blocks).
//
// letterbox_pixel_kernel, the scalar variant: one thread per output pixel,
// byte loads from device memory, one store per value. It takes every
// geometry and alignment, and runs those the vector variant does not take.
//
// The vertical blend is recomputed at every tap, not kept in shared memory
// as f32 per source column. At the usual ratios (1.5 to 3) a source column
// is tapped by 1.3 to 0.7 output pixels, so the buffer saves little and
// costs a store, a load and two block barriers per row. Built that way
// (scripts/probe_letterbox_blend.cu, timed by
// scripts/probe_letterbox_kernel.py on the same card) it took 23 us against
// 17 us at 960x540 bf16 and 36 us against 19 us at 1920x1080.
//
// Numerics, the same in both kernels: the weights equal the JAX package's
// dense bilinear matrix entries bit for bit; the arithmetic follows its
// einsum order (vertical, then horizontal), with explicit round-to-nearest
// intrinsics so nvcc cannot contract products and sums into FMAs, a round
// half-to-even (as torch.round) and a true division by 255. The vector
// variant reaches the same bits with full-rate instructions in place of
// quarter-rate conversions and the ~10-instruction IEEE division: a byte
// times a weight is one multiply on the byte read as a denormal
// (byte_times), the rounding is (v + 2^23) - 2^23, and n / 255 for an
// integer n is one Newton step (byte_over_255); each is exact on its whole
// domain. Its inner loop is branch-free: the rounding is a template
// parameter and a group with pad pixels takes a masked instantiation.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 8;  // output pixels per thread, vector variant
// Threads per block, vector variant. With 2 blocks per SM this leaves each
// thread 96 registers: the unrolled 8-pixel, 3-channel blend spills below
// about 90, and builds capped at 64 and 48 registers ran 1.2 to 2.4 times
// slower on the card (scripts/probe_letterbox_kernel.py).
constexpr int kMaxThreads = 320;

// ---------------------------------------------------------------- scalar --

__device__ __forceinline__ void store(float* out, size_t i, float v) {
  out[i] = v;
}

__device__ __forceinline__ void store(__nv_bfloat16* out, size_t i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

// taps_i / taps_w layout: [y0 (uh), y1 (uh), x0 (uw), x1 (uw)]
template <typename OutT>
__global__ void letterbox_pixel_kernel(const uint8_t* __restrict__ frames,
                                       OutT* __restrict__ out,
                                       const int32_t* __restrict__ taps_i,
                                       const float* __restrict__ taps_w,
                                       int k, int h, int w, int dh, int dw,
                                       int uh, int uw, int top, int left,
                                       int do_round) {
  const size_t plane = (size_t)dh * dw;
  const size_t total = (size_t)k * plane;
  size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int ox = (int)(idx % dw);
  const int oy = (int)((idx / dw) % dh);
  const int f = (int)(idx / plane);
  // out[f, c, oy, ox]
  const size_t o0 = (size_t)f * 3 * plane + (size_t)oy * dw + ox;

  const int ry = oy - top;
  const int rx = ox - left;
  if (ry < 0 || ry >= uh || rx < 0 || rx >= uw) {
    const float pad = __fdiv_rn(114.0f, 255.0f);
    store(out, o0, pad);
    store(out, o0 + plane, pad);
    store(out, o0 + 2 * plane, pad);
    return;
  }
  const int y0 = taps_i[ry];
  const int y1 = taps_i[uh + ry];
  const int x0 = taps_i[2 * uh + rx];
  const int x1 = taps_i[2 * uh + uw + rx];
  const float wy0 = taps_w[ry];
  const float wy1 = taps_w[uh + ry];
  const float wx0 = taps_w[2 * uh + rx];
  const float wx1 = taps_w[2 * uh + uw + rx];

  const uint8_t* base = frames + (size_t)f * h * w * 3;
  const uint8_t* p00 = base + ((size_t)y0 * w + x0) * 3;
  const uint8_t* p10 = base + ((size_t)y1 * w + x0) * 3;
  const uint8_t* p01 = base + ((size_t)y0 * w + x1) * 3;
  const uint8_t* p11 = base + ((size_t)y1 * w + x1) * 3;

#pragma unroll
  for (int c = 0; c < 3; ++c) {  // c indexes BGR input channels
    const float t0 = __fadd_rn(__fmul_rn((float)p00[c], wy0),
                               __fmul_rn((float)p10[c], wy1));
    const float t1 = __fadd_rn(__fmul_rn((float)p01[c], wy0),
                               __fmul_rn((float)p11[c], wy1));
    float v = __fadd_rn(__fmul_rn(t0, wx0), __fmul_rn(t1, wx1));
    if (do_round) {
      v = fminf(fmaxf(rintf(v), 0.0f), 255.0f);
    }
    store(out, o0 + (size_t)(2 - c) * plane, __fdiv_rn(v, 255.0f));
  }
}

// ---------------------------------------------------------------- vector --

constexpr float kTwo23 = 8388608.0f;  // 2^23

// A byte read as float bits is the denormal b * 2^-149, so one full-rate
// multiply by w * 2^127 gives RN(b * w) * 2^-22 with no conversion: the
// product is a normal number, rounded to 24 bits exactly as b * w would be,
// and scaling by a power of two commutes with every rounding that follows.
// The vertical sum stays at that scale; the column weights carry 2^22.
// (Denormal inputs need flush-to-zero off, nvcc's default; a weight would
// have to be below 2^-100 to underflow, and the smallest non-zero one here
// is a difference of float64 pixel coordinates, above 2^-43.)
constexpr float kTwo127 = 1.7014118346046923e38f;  // 2^127
constexpr float kTwo22 = 4194304.0f;               // 2^22

__device__ __forceinline__ float byte_times(uint32_t b, float w_two127) {
  return __fmul_rn(__uint_as_float(b), w_two127);
}

// Round half-to-even for 0 <= v < 2^22, as rintf.
__device__ __forceinline__ float round_even(float v) {
  return __fsub_rn(__fadd_rn(v, kTwo23), kTwo23);
}

// n / 255 for an integer 0 <= n <= 255, correctly rounded: one Newton step
// on n * RN(1/255) with an exact residual. Equal to __fdiv_rn(n, 255.0f) on
// all 256 values (tests/test_torch_preprocess.py checks it in exact
// arithmetic), in 3 instructions for the division's ~10.
__device__ __forceinline__ float byte_over_255(float n) {
  const float r = __uint_as_float(0x3B808081u);  // RN(1 / 255)
  const float q = __fmul_rn(n, r);
  return __fmaf_rn(__fmaf_rn(-255.0f, q, n), r, q);
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 8 consecutive values of one output row, 16-byte aligned.
__device__ __forceinline__ void store8(float* dst, const float (&v)[kGroup]) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(v[0], v[1], v[2], v[3]);
  d[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst,
                                       const float (&v)[kGroup]) {
  uint32_t u[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    u[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
}

// One output row's 8 pixels of this thread, three channels: the 2x2 taps
// from the band, vertical blend, horizontal blend, round, clip, / 255, and
// one 16-byte store per channel (two for f32). p0/p1: the two source rows
// in the band; wy0/wy1: their weights times 2^127; xab: the byte offsets of
// the left and right taps, 16 bits each; wa/wb: their weights times 2^22.
// MASKED: some of the 8 pixels lie in the left/right pad (bit j of `inside`
// clear) and come out as the pad value.
template <typename OutT, bool ROUND, bool MASKED>
__device__ __forceinline__ void blend_row(
    const uint8_t* __restrict__ p0, const uint8_t* __restrict__ p1,
    float wy0, float wy1, const uint32_t (&xab)[kGroup],
    const float (&wa)[kGroup], const float (&wb)[kGroup], uint32_t inside,
    OutT* __restrict__ dst, size_t plane) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {  // c indexes BGR input channels
    float v[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const uint32_t xa = xab[j] & 0xFFFFu, xb = xab[j] >> 16;
      const float t0 = __fadd_rn(byte_times(p0[xa + c], wy0),
                                 byte_times(p1[xa + c], wy1));
      const float t1 = __fadd_rn(byte_times(p0[xb + c], wy0),
                                 byte_times(p1[xb + c], wy1));
      float s = __fadd_rn(__fmul_rn(t0, wa[j]), __fmul_rn(t1, wb[j]));
      if (ROUND) {
        // clip to 0..255: s >= 0 always (sums of products of non-negatives)
        s = fminf(round_even(s), 255.0f);
      }
      if (MASKED) {
        s = ((inside >> j) & 1u) ? s : 114.0f;
      }
      // s is an integer in 0..255 here, rounded or not (identity taps)
      v[j] = byte_over_255(s);
    }
    store8(dst + (size_t)(2 - c) * plane, v);
  }
}

// Tables, built on the host (ops/letterbox.py::tile_tables). With
// dh4 = dh rounded up to a multiple of 4:
//   tab_i: [y0 (dh4)] [y1 (dh4)] [x0 * 3 (dw)] [x1 * 3 (dw)]
//   tab_w: [wy0 (dh4)] [wy1 (dh4)] [wx0 (dw)] [wx1 (dw)]
// indexed by output row / column. A pad row has y0 = -1; a pad column has
// byte offsets 0 and weights 0 (and is masked out below).
template <typename OutT, bool ROUND>
__global__ void __launch_bounds__(kMaxThreads, 2)
letterbox_tile_kernel(const uint8_t* __restrict__ frames,
                      OutT* __restrict__ out,
                      const int32_t* __restrict__ tab_i,
                      const float* __restrict__ tab_w,
                      int h, int w3, int dh, int dw, int uh, int uw,
                      int top, int left, int rows) {
  extern __shared__ __align__(16) uint8_t band[];

  const int f = blockIdx.y;
  const int oy_base = blockIdx.x * rows;
  const int gx = threadIdx.x;                 // 8-pixel group of the row
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int dh4 = (dh + 3) & ~3;

  // The band of source rows this tile taps: from the first content row's
  // upper tap to the last content row's lower tap (taps are monotone). It
  // is fetched in one piece: other blocks of the SM compute meanwhile.
  // (Fetching it in one cp.async group per step of blockDim.y rows, so that
  // the first step starts early, was no faster on the card.)
  const int oy_lo = max(oy_base, top);
  const int oy_hi = min(min(oy_base + rows, dh), top + uh);  // exclusive
  int ys_lo = 0;
  if (oy_lo < oy_hi) {
    ys_lo = tab_i[oy_lo];
    const int ys_hi = tab_i[dh4 + oy_hi - 1];
    const int n16 = ((ys_hi - ys_lo + 1) * w3) >> 4;  // w3 % 16 == 0
    const uint4* src = reinterpret_cast<const uint4*>(
        frames + ((size_t)f * h + ys_lo) * w3);
    uint4* dst = reinterpret_cast<uint4*>(band);
    for (int i = tid; i < n16; i += nthreads) {
      cp_async_16(dst + i, src + i);
    }
  }

  // This thread's 8 column taps, kept in registers over rows and channels.
  const int ox0 = gx * kGroup;
  uint32_t xab[kGroup];
  float wa[kGroup], wb[kGroup];
  {
    const int4* pi0 = reinterpret_cast<const int4*>(tab_i + 2 * dh4 + ox0);
    const int4* pi1 =
        reinterpret_cast<const int4*>(tab_i + 2 * dh4 + dw + ox0);
    const float4* pw0 =
        reinterpret_cast<const float4*>(tab_w + 2 * dh4 + ox0);
    const float4* pw1 =
        reinterpret_cast<const float4*>(tab_w + 2 * dh4 + dw + ox0);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int4 a = __ldg(pi0 + q);
      const int4 b = __ldg(pi1 + q);
      const float4 u = __ldg(pw0 + q);
      const float4 v = __ldg(pw1 + q);
      xab[4 * q + 0] = (uint32_t)a.x | ((uint32_t)b.x << 16);
      xab[4 * q + 1] = (uint32_t)a.y | ((uint32_t)b.y << 16);
      xab[4 * q + 2] = (uint32_t)a.z | ((uint32_t)b.z << 16);
      xab[4 * q + 3] = (uint32_t)a.w | ((uint32_t)b.w << 16);
      wa[4 * q + 0] = u.x; wa[4 * q + 1] = u.y;
      wa[4 * q + 2] = u.z; wa[4 * q + 3] = u.w;
      wb[4 * q + 0] = v.x; wb[4 * q + 1] = v.y;
      wb[4 * q + 2] = v.z; wb[4 * q + 3] = v.w;
    }
  }
  // which of the 8 pixels lie in the content columns
  uint32_t inside = 0;
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    inside |= (uint32_t)((unsigned)(ox0 + j - left) < (unsigned)uw) << j;
    wa[j] = __fmul_rn(wa[j], kTwo22);  // exact: see byte_times
    wb[j] = __fmul_rn(wb[j], kTwo22);
  }

  cp_async_wait_all();
  __syncthreads();

  const size_t plane = (size_t)dh * dw;
  const int oy_end = min(oy_base + rows, dh);
  for (int oy = oy_base + threadIdx.y; oy < oy_end; oy += blockDim.y) {
    OutT* dst = out + (size_t)f * 3 * plane + (size_t)oy * dw + ox0;
    const int y0 = tab_i[oy];
    if (y0 < 0 || inside == 0) {
      float v[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) v[j] = __fdiv_rn(114.0f, 255.0f);
      store8(dst, v);
      store8(dst + plane, v);
      store8(dst + 2 * plane, v);
      continue;
    }
    const int y1 = tab_i[dh4 + oy];
    const float wy0 = __fmul_rn(tab_w[oy], kTwo127);
    const float wy1 = __fmul_rn(tab_w[dh4 + oy], kTwo127);
    const uint8_t* p0 = band + (y0 - ys_lo) * w3;
    const uint8_t* p1 = band + (y1 - ys_lo) * w3;
    if (inside == 0xFFu) {
      blend_row<OutT, ROUND, false>(p0, p1, wy0, wy1, xab, wa, wb, inside,
                                    dst, plane);
    } else {
      blend_row<OutT, ROUND, true>(p0, p1, wy0, wy1, xab, wa, wb, inside,
                                   dst, plane);
    }
  }
}

template <typename OutT, bool ROUND>
int launch_tile(const uint8_t* frames, OutT* out, const int32_t* tab_i,
                const float* tab_w, int k, int h, int w, int dh, int dw,
                int uh, int uw, int top, int left, int rows, int block_rows,
                int smem_bytes, cudaStream_t s) {
  auto kernel = letterbox_tile_kernel<OutT, ROUND>;
  if (smem_bytes > 48 * 1024) {
    // beyond the default limit: opted into per device, so on every launch
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((dh + rows - 1) / rows, k);
  const dim3 block(dw / kGroup, block_rows);
  kernel<<<grid, block, smem_bytes, s>>>(frames, out, tab_i, tab_w, h, w * 3,
                                         dh, dw, uh, uw, top, left, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// Both entry points return cudaGetLastError() after the launch (0 on
// success) and launch nothing for an empty chunk.

// The scalar variant: any geometry, any alignment.
extern "C" int aicam_letterbox_pixel(const void* frames, void* out,
                                     const void* taps_i, const void* taps_w,
                                     int k, int h, int w, int dh, int dw,
                                     int uh, int uw, int top, int left,
                                     int do_round, int out_bf16,
                                     void* stream) {
  const size_t total = (size_t)k * dh * dw;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (out_bf16) {
    letterbox_pixel_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const uint8_t*)frames, (__nv_bfloat16*)out, (const int32_t*)taps_i,
        (const float*)taps_w, k, h, w, dh, dw, uh, uw, top, left, do_round);
  } else {
    letterbox_pixel_kernel<float><<<blocks, threads, 0, s>>>(
        (const uint8_t*)frames, (float*)out, (const int32_t*)taps_i,
        (const float*)taps_w, k, h, w, dh, dw, uh, uw, top, left, do_round);
  }
  return (int)cudaGetLastError();
}

// The vector variant: `rows` output rows per block, `block_rows` of them in
// flight (block = (dw / 8, block_rows) threads), `smem_bytes` for the band.
// The caller guarantees its alignment rules (see the header).
extern "C" int aicam_letterbox_tile(const void* frames, void* out,
                                    const void* tab_i, const void* tab_w,
                                    int k, int h, int w, int dh, int dw,
                                    int uh, int uw, int top, int left,
                                    int do_round, int out_bf16, int rows,
                                    int block_rows, int smem_bytes,
                                    void* stream) {
  if ((size_t)k * dh * dw == 0) return (int)cudaSuccess;
#define AICAM_TILE(OutT, ROUND)                                              \
  launch_tile<OutT, ROUND>((const uint8_t*)frames, (OutT*)out,               \
                           (const int32_t*)tab_i, (const float*)tab_w, k, h, \
                           w, dh, dw, uh, uw, top, left, rows, block_rows,   \
                           smem_bytes, (cudaStream_t)stream)
  if (out_bf16) {
    return do_round ? AICAM_TILE(__nv_bfloat16, true)
                    : AICAM_TILE(__nv_bfloat16, false);
  }
  return do_round ? AICAM_TILE(float, true) : AICAM_TILE(float, false);
#undef AICAM_TILE
}
