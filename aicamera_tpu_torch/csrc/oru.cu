// OC-SORT's observation-centric re-update (ORU) for Hopper (sm_90a): one
// thread a track slot, for every slot of every stream in one launch.
//
// Replaces the JAX package's device loop, an XLA while-loop under a cond,
// not Pallas: aicamera_tpu/core/ocsort.py::step's do_replay (:540-583, the
// lax.while_loop at :581). A track re-observed after `gap` missed frames
// rolls back to the state frozen at its first miss and replays `gap`
// virtual steps along the line from its last observation z1 to the new one
// z2 (cx, cy, s, r): a Joseph-form Kalman update at each step, the bare
// constant-velocity predict (no area guard) between two steps. JAX runs the
// loop to the largest gap of the frame; under jax.vmap over streams, to the
// largest of all streams. Here each thread loops over its own gap, so a
// frame with no replay costs one launch that copies its inputs.
//
// What it computes is the plain PyTorch version's
// (aicamera_tpu_torch/core/ocsort.py::oru_replay_plain, its oracle on the
// card), in its operation order: the step sizes (z2 - z1) / max(gap, 1) and
// the interpolated box; S = P[:4, :4] + diag(R); the closed-form 4x4
// Cholesky of S and its two triangular solves (core/kalman.py's
// recurrences, same order); K = (S^-1 H P^T)^T; x += K (z - x[:4]);
// P = (I - K H) P (I - K H)^T + (K R) K^T; the predict F x, F P F^T + Q.
// The file is built with --fmad=false (ops/oru.py), so that no product is
// fused into a sum, as PyTorch's separate kernels round each operation. The
// products of the 7x7 matrices are summed in index order; cuBLAS, which the
// plain version calls on the card, may order them otherwise, so the two
// agree to rounding, not bitwise (chip_smoke.py counts the bitwise lanes).
// Clamps keep NaN as torch.clamp does. A slot without a replay returns its
// input unchanged; one with a replay returns after min(gap, max_gap) steps
// (the plain version's static trip count).
//
// Bound: latency. At the main path's 8 x 128 slots the kernel moves 1024 x
// 2 x 56 floats in and out (0.46 MB: 0.14 us at 3.35 TB/s) and a replay of
// g steps does ~1.9 kflop a step a slot (0.03 us for every slot at g = 31,
// at f32 rate); one launch costs more than both. The design keeps a slot's
// state and every intermediate in registers (the loops are unrolled over
// the fixed 7 and 4), reads and writes each slot once, and launches
// ceil(n / 128) blocks, so that a frame's replay of all streams is one
// kernel node in the captured scan.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kDx = 7;   // state: cx, cy, s, r, vcx, vcy, vs
constexpr int kDz = 4;   // measurement: cx, cy, s, r

// torch.clamp(v, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : (v < lo ? lo : v);
}

// Joseph-form update with measurement z; R = diag(1, 1, 10, 10).
__device__ __forceinline__ void kf_update(float (&x)[kDx],
                                          float (&p)[kDx * kDx],
                                          const float (&z)[kDz]) {
  const float r[kDz] = {(float)1.0, (float)1.0, (float)10.0, (float)10.0};
  float s[kDz][kDz];
#pragma unroll
  for (int i = 0; i < kDz; ++i)
#pragma unroll
    for (int j = 0; j < kDz; ++j)
      s[i][j] = p[i * kDx + j] + (i == j ? r[i] : 0.0f);
  // lower Cholesky factor, kalman._chol_small's recurrence
  float l[kDz][kDz];
#pragma unroll
  for (int i = 0; i < kDz; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float acc = s[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) acc = acc - l[i][k] * l[j][k];
      l[i][j] = (i == j) ? sqrtf(acc) : acc / l[j][j];
    }
  // S X = (P H^T)^T: forward then back substitution, column by column;
  // the gain K[m][i] = X[i][m]
  float kg[kDx][kDz];
#pragma unroll
  for (int m = 0; m < kDx; ++m) {
    float y[kDz];
#pragma unroll
    for (int i = 0; i < kDz; ++i) {
      float acc = p[m * kDx + i];          // (P H^T)^T [i][m] = P[m][i]
#pragma unroll
      for (int k = 0; k < i; ++k) acc = acc - l[i][k] * y[k];
      y[i] = acc / l[i][i];
    }
    float xs[kDz];
#pragma unroll
    for (int i = kDz - 1; i >= 0; --i) {
      float acc = y[i];
#pragma unroll
      for (int k = i + 1; k < kDz; ++k) acc = acc - l[k][i] * xs[k];
      xs[i] = acc / l[i][i];
    }
#pragma unroll
    for (int i = 0; i < kDz; ++i) kg[m][i] = xs[i];
  }
  float v[kDz];
#pragma unroll
  for (int i = 0; i < kDz; ++i) v[i] = z[i] - x[i];
#pragma unroll
  for (int m = 0; m < kDx; ++m) {
    float acc = kg[m][0] * v[0];
#pragma unroll
    for (int i = 1; i < kDz; ++i) acc = acc + kg[m][i] * v[i];
    x[m] = x[m] + acc;
  }
  // I - K H: the identity minus K in its first four columns
  float ikh[kDx][kDx];
#pragma unroll
  for (int m = 0; m < kDx; ++m)
#pragma unroll
    for (int q = 0; q < kDx; ++q)
      ikh[m][q] = (m == q ? 1.0f : 0.0f) - (q < kDz ? kg[m][q] : 0.0f);
  float np[kDx * kDx];
#pragma unroll
  for (int m = 0; m < kDx; ++m) {
    float a[kDx];                          // row m of (I - K H) P
#pragma unroll
    for (int n = 0; n < kDx; ++n) {
      float acc = ikh[m][0] * p[n];
#pragma unroll
      for (int q = 1; q < kDx; ++q) acc = acc + ikh[m][q] * p[q * kDx + n];
      a[n] = acc;
    }
#pragma unroll
    for (int n = 0; n < kDx; ++n) {
      float b = a[0] * ikh[n][0];
#pragma unroll
      for (int q = 1; q < kDx; ++q) b = b + a[q] * ikh[n][q];
      float c = (kg[m][0] * r[0]) * kg[n][0];
#pragma unroll
      for (int i = 1; i < kDz; ++i) c = c + (kg[m][i] * r[i]) * kg[n][i];
      np[m * kDx + n] = b + c;
    }
  }
#pragma unroll
  for (int i = 0; i < kDx * kDx; ++i) p[i] = np[i];
}

// The bare constant-velocity predict: x = F x, P = F P F^T + Q with
// F = I + (cx, cy, s) += (vcx, vcy, vs), Q = diag(1, 1, 1, 1, .01, .01,
// 1e-4) (each entry the f32 nearest the double, as torch.tensor rounds).
__device__ __forceinline__ void kf_predict_bare(float (&x)[kDx],
                                                float (&p)[kDx * kDx]) {
  const float q[kDx] = {(float)1.0, (float)1.0, (float)1.0, (float)1.0,
                        (float)0.01, (float)0.01, (float)0.0001};
#pragma unroll
  for (int i = 0; i < 3; ++i) x[i] = x[i] + x[i + 4];
  float fp[kDx * kDx];                     // F P
#pragma unroll
  for (int i = 0; i < kDx; ++i)
#pragma unroll
    for (int j = 0; j < kDx; ++j)
      fp[i * kDx + j] = i < 3 ? p[i * kDx + j] + p[(i + 4) * kDx + j]
                              : p[i * kDx + j];
#pragma unroll
  for (int i = 0; i < kDx; ++i)
#pragma unroll
    for (int j = 0; j < kDx; ++j) {
      const float f = j < 3 ? fp[i * kDx + j] + fp[i * kDx + j + 4]
                            : fp[i * kDx + j];
      p[i * kDx + j] = f + (i == j ? q[i] : 0.0f);
    }
}

__global__ void __launch_bounds__(kThreads)
oru_kernel(int n, const float* __restrict__ x_in,
           const float* __restrict__ p_in, const float* __restrict__ fx,
           const float* __restrict__ fp, const uint8_t* __restrict__ replay,
           const int32_t* __restrict__ gap, const float* __restrict__ z1,
           const float* __restrict__ z2, int max_gap,
           float* __restrict__ x_out, float* __restrict__ p_out) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= n) return;
  const bool rep = replay[s] != 0;
  const float* xs = (rep ? fx : x_in) + (size_t)s * kDx;
  const float* ps = (rep ? fp : p_in) + (size_t)s * kDx * kDx;
  float x[kDx], p[kDx * kDx];
#pragma unroll
  for (int i = 0; i < kDx; ++i) x[i] = xs[i];
#pragma unroll
  for (int i = 0; i < kDx * kDx; ++i) p[i] = ps[i];
  if (rep) {
    const int g = gap[s];
    const float a0 = z1[s * kDz], a1 = z1[s * kDz + 1],
                a2 = z1[s * kDz + 2], a3 = z1[s * kDz + 3];
    const float b0 = z2[s * kDz], b1 = z2[s * kDz + 1],
                b2 = z2[s * kDz + 2], b3 = z2[s * kDz + 3];
    const float w1 = sqrtf(clamp_min(a2 * a3, 0.0f));
    const float h1 = sqrtf(clamp_min(a2 / clamp_min(a3, (float)1e-6), 0.0f));
    const float w2 = sqrtf(clamp_min(b2 * b3, 0.0f));
    const float h2 = sqrtf(clamp_min(b2 / clamp_min(b3, (float)1e-6), 0.0f));
    const float gf = (float)(g < 1 ? 1 : g);
    const float dxc = (b0 - a0) / gf, dyc = (b1 - a1) / gf;
    const float dw = (w2 - w1) / gf, dh = (h2 - h1) / gf;
    const int last = g < max_gap ? g : max_gap;
    for (int i = 1; i <= last; ++i) {
      const float fi = (float)i;
      const float wi = w1 + fi * dw;
      const float hi = h1 + fi * dh;
      const float z[kDz] = {a0 + fi * dxc, a1 + fi * dyc, wi * hi,
                            wi / clamp_min(hi, (float)1e-6)};
      kf_update(x, p, z);
      if (i < g) kf_predict_bare(x, p);
    }
  }
  float* xo = x_out + (size_t)s * kDx;
  float* po = p_out + (size_t)s * kDx * kDx;
#pragma unroll
  for (int i = 0; i < kDx; ++i) xo[i] = x[i];
#pragma unroll
  for (int i = 0; i < kDx * kDx; ++i) po[i] = p[i];
}

}  // namespace

// n slots: x (n, 7), p (n, 7, 7), frozen x and p likewise, replay (n,) bool
// as bytes, gap (n,) int32, z1 and z2 (n, 4), all f32 and contiguous;
// writes x_out and p_out. Returns the launch's CUDA error (0 on success).
extern "C" int aicam_oru_replay(int n, const void* x, const void* p,
                                const void* frozen_x, const void* frozen_p,
                                const void* replay, const void* gap,
                                const void* z1, const void* z2, int max_gap,
                                void* x_out, void* p_out, void* stream) {
  if (n < 1 || max_gap < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  oru_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      n, (const float*)x, (const float*)p, (const float*)frozen_x,
      (const float*)frozen_p, (const uint8_t*)replay, (const int32_t*)gap,
      (const float*)z1, (const float*)z2, max_gap, (float*)x_out,
      (float*)p_out);
  return (int)cudaGetLastError();
}
