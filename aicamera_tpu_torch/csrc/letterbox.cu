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
// below the card's flop/byte balance. Per 960x540 frame the kernel must read
// 1.56 MB of uint8 and write 2.46 MB as bf16 (4.92 MB as f32) at 640x640.
// Design: one thread per output pixel computes all three channels, so each
// output byte is written once and each source pixel's 3 bytes come in one
// neighbourhood; a pad pixel writes the pad constant and reads nothing (the
// analogue of the Pallas kernel's pure-pad tile skip); a content pixel reads
// only its 2x2 source neighbourhood. The tap tables (index and weight per
// output row and column) are built on the host. Coalesced 16-byte reads,
// shared-memory row staging and TMA are later work.
//
// Numerics: the weights equal the JAX package's dense bilinear matrix
// entries bit for bit; the arithmetic follows its einsum order (vertical,
// then horizontal), with explicit round-to-nearest intrinsics so nvcc cannot
// contract products and sums into FMAs, rintf (half-to-even, as
// torch.round) and a true division by 255.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void store(float* out, size_t i, float v) {
  out[i] = v;
}

__device__ __forceinline__ void store(__nv_bfloat16* out, size_t i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void letterbox_kernel(const uint8_t* __restrict__ frames,
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
  // taps_i / taps_w layout: [y0 (uh), y1 (uh), x0 (uw), x1 (uw)]
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

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int aicam_letterbox_u8(const void* frames, void* out,
                                  const void* taps_i, const void* taps_w,
                                  int k, int h, int w, int dh, int dw,
                                  int uh, int uw, int top, int left,
                                  int do_round, int out_bf16, void* stream) {
  const size_t total = (size_t)k * dh * dw;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (out_bf16) {
    letterbox_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const uint8_t*)frames, (__nv_bfloat16*)out, (const int32_t*)taps_i,
        (const float*)taps_w, k, h, w, dh, dw, uh, uw, top, left, do_round);
  } else {
    letterbox_kernel<float><<<blocks, threads, 0, s>>>(
        (const uint8_t*)frames, (float*)out, (const int32_t*)taps_i,
        (const float*)taps_w, k, h, w, dh, dw, uh, uw, top, left, do_round);
  }
  return (int)cudaGetLastError();
}
