// OC-SORT's observation-centric re-update (ORU) for Hopper (sm_90a): every
// track slot of every stream in one launch.
//
// Replaces the JAX package's device loop, an XLA while-loop under a cond,
// not Pallas: aicamera_tpu/core/ocsort.py::step's do_replay (:540-583, the
// lax.while_loop at :581). A track re-observed after `gap` missed frames
// rolls back to the state frozen at its first miss and replays `gap`
// virtual steps along the line from its last observation z1 to the new one
// z2 (cx, cy, s, r): a Joseph-form Kalman update at each step, the bare
// constant-velocity predict (no area guard) between two steps. JAX runs the
// loop to the largest gap of the frame; under jax.vmap over streams, to the
// largest of all streams. Here a slot (v1) or a warp's 4 slots (rows) loop
// to their own gap, so a frame with no replay costs one launch that copies
// its inputs.
//
// What it computes is the plain PyTorch version's
// (aicamera_tpu_torch/core/ocsort.py::oru_replay_plain, its oracle on the
// card), in its operation order: the step sizes (z2 - z1) / max(gap, 1) and
// the interpolated box; S = P[:4, :4] + diag(R); the closed-form 4x4
// Cholesky of S and its two triangular solves (core/kalman.py's
// recurrences, same order); K = (S^-1 H P^T)^T; x += K (z - x[:4]);
// P = (I - K H) P (I - K H)^T + (K R) K^T; the predict F x, F P F^T + Q.
// The file is built with --fmad=false (ops/oru.py), so that no product is
// fused into a sum, as PyTorch's separate kernels round each operation, and
// every element of every product is summed by one thread in index order.
// The plain version's 7x7 products go through cuBLAS on the card, which may
// order a sum otherwise, so the kernel is held to it within 1e-5 of a
// slot's scale; on every lane chip_smoke.py has checked the two were
// bitwise equal. Clamps keep NaN as torch.clamp does. A slot without a
// replay returns its input unchanged; one with a replay returns after
// min(gap, max_gap) steps (the plain version's static trip count).
//
// Two designs, bitwise equal to each other on every lane (each element is
// the same sequence of rounded operations in both):
//
// - "rows" (aicam_oru_replay, every path's): a slot is a group of 8 lanes,
//   4 slots a warp, 8 slots (64 threads) a block, so the 128 slots of one
//   stream spread over 16 SMs and 8 streams over 128. Lane r < 7 owns x[r]
//   and row r of P and computes row r of everything: its row of the gain
//   (kg[r] reads only P[r][0:4] and the Cholesky factor, which every lane
//   of the group computes from the same shuffled S in the same order, so
//   the lanes hold the same bits), its row of (I - K H) P, of the Joseph
//   product and of F P F^T + Q. What a row needs of other rows (x[0:4], the
//   rows of P, the rows of K, row r + 4 in the predict) comes by a width-8
//   __shfl_sync. The warp stays converged: its groups all step to the
//   warp's largest count, a group past its own count (or without a replay)
//   discarding its steps by selects, so every shuffle names the whole warp
//   and none waits on a divergence check. A zero dividend in S's factor and
//   the gain is answered without the division's slow subroutine
//   (quotient<true>). The block first copies its slots' x and p to the
//   outputs in 16-byte chunks, neighbouring threads on neighbouring
//   addresses (the mask and gap loads in flight beside them; a stack whose
//   pointers are off the 16-byte grid takes a scalar copy); after a
//   barrier, the groups whose slot replays load their frozen rows, replay,
//   and overwrite their slot. 128 registers at most (__launch_bounds__).
// - "v1" (aicam_oru_replay_v1, the first design, on no path): a thread a
//   slot, 128 a block; the whole 2,252-operation update as one dependent
//   chain in one thread (210 registers), its 56 floats loaded and stored at
//   a 224-byte stride after the mask chose the pointer.
//
// Bound: latency. At the main path's 8 x 128 slots the kernel moves 1024 x
// 2 x 56 floats in and out (0.46 MB: 0.14 us at 3.35 TB/s) and a replay of
// g steps does ~2.3 kflop a step a slot (0.03 us for every slot at g = 31,
// at f32 rate); an empty kernel's replay (~1.1 us) is above both. What a
// launch costs over that floor is the copy's round trip to memory and, for
// each virtual step, the dependent chain of the gain: four square roots
// and the divisions of S's factor and the two triangular solves, ~58
// cycles each on one warp (none overlaps another: each is a branch around
// its slow path), then the products (chip_smoke.py's [oru] times both
// designs in turns and reads the probe's phases; PERF.md section 6).
//
// Built with -DAICAM_ORU_PROBE (a second library that only chip_smoke.py
// loads), both designs add clock64() cycles by phase into a device buffer
// that aicam_oru_probe reads: each slot's leading thread (v1: the slot's
// thread; rows: lane 0 of its group) adds its cycles of load, of each
// virtual step's gain (the box, S, its factor, the gain), Joseph product
// and predict, and of store, the slots, the replaying slots and the
// virtual steps; thread 0 of each block adds the block's cycles from entry
// to exit and one block. The probe waits for each phase's last value
// before it reads the clock, so phases do not overlap in that build.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDx = 7;   // state: cx, cy, s, r, vcx, vcy, vs
constexpr int kDz = 4;   // measurement: cx, cy, s, r
constexpr int kDp = kDx * kDx;

// --- the phase probe ----------------------------------------------------------
enum ProbeSlot {
  kSlots, kReplaying, kSteps, kLoad, kGain, kJoseph, kPredict, kStore,
  kBlocks, kTotal, kSink, kProbeSlots
};

#ifdef AICAM_ORU_PROBE
__device__ unsigned long long g_probe[kProbeSlots];

// One thread's clock; `lead` threads add what they measure.
struct Probe {
  long long t0, t;
  bool own, lead;
  __device__ explicit Probe(bool is_lead) : own(is_lead), lead(is_lead) {
    t0 = clock64();
    t = t0;
  }
  // a lead thread adds only while `b` (a step its slot takes)
  __device__ void only(bool b) { lead = own && b; }
  // makes the thread wait for loaded bits before the next clock read: a
  // branch on them (never taken) that the clock read cannot move above
  __device__ void wait(unsigned bits) {
    if (bits == 0x7fbadbadu) atomicAdd(&g_probe[kSink], 1ull);
  }
  __device__ void mark(int slot) {
    const long long now = clock64();
    if (lead) atomicAdd(&g_probe[slot], (unsigned long long)(now - t));
    t = now;
  }
  __device__ void add(int slot, unsigned long long v) {
    if (lead) atomicAdd(&g_probe[slot], v);
  }
  __device__ void block_done() {
    if (threadIdx.x == 0) {
      atomicAdd(&g_probe[kTotal], (unsigned long long)(clock64() - t0));
      atomicAdd(&g_probe[kBlocks], 1ull);
    }
  }
};
#else
struct Probe {
  __device__ explicit Probe(bool) {}
  __device__ void only(bool) {}
  __device__ void wait(unsigned) {}
  __device__ void mark(int) {}
  __device__ void add(int, unsigned long long) {}
  __device__ void block_done() {}
};
#endif

__device__ __forceinline__ unsigned bits_of(float v) {
  return __float_as_uint(v);
}

// torch.clamp(v, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : (v < lo ? lo : v);
}

// The virtual trajectory from observation z1 to z2 over g steps: box i.
struct Line {
  float a0 = 0.0f, a1 = 0.0f, dxc = 0.0f, dyc = 0.0f, w1 = 0.0f, h1 = 0.0f,
        dw = 0.0f, dh = 0.0f;
  __device__ Line() {}   // a slot without a replay: its steps are discarded
  __device__ Line(const float* z1, const float* z2, int g) {
    a0 = z1[0];
    a1 = z1[1];
    const float a2 = z1[2], a3 = z1[3];
    const float b0 = z2[0], b1 = z2[1], b2 = z2[2], b3 = z2[3];
    w1 = sqrtf(clamp_min(a2 * a3, 0.0f));
    h1 = sqrtf(clamp_min(a2 / clamp_min(a3, (float)1e-6), 0.0f));
    const float w2 = sqrtf(clamp_min(b2 * b3, 0.0f));
    const float h2 = sqrtf(clamp_min(b2 / clamp_min(b3, (float)1e-6), 0.0f));
    const float gf = (float)(g < 1 ? 1 : g);
    dxc = (b0 - a0) / gf;
    dyc = (b1 - a1) / gf;
    dw = (w2 - w1) / gf;
    dh = (h2 - h1) / gf;
  }
  __device__ void at(int i, float (&z)[kDz]) const {
    const float fi = (float)i;
    const float wi = w1 + fi * dw;
    const float hi = h1 + fi * dh;
    z[0] = a0 + fi * dxc;
    z[1] = a1 + fi * dyc;
    z[2] = wi * hi;
    z[3] = wi / clamp_min(hi, (float)1e-6);
  }
};

// a / b, the IEEE quotient either way. The division's checked fast path
// hands a zero dividend to its slow subroutine (~270 cycles against ~58 on
// the H100: scripts/probe_oru_latency.py); kDirectZero answers a zero
// dividend here instead, with the same bits: a zero signed by the operands'
// signs, NaN for 0/0 and 0/NaN. P's blocks (cx with vcx, cy with vcy, s with
// vs, r alone) make most dividends of S's factor and of the gain exactly 0.
template <bool kDirectZero>
__device__ __forceinline__ float quotient(float a, float b) {
  if (kDirectZero && a == 0.0f)
    return (b == 0.0f || isnan(b))
               ? __int_as_float(0x7fffffff)
               : __uint_as_float((__float_as_uint(a) ^ __float_as_uint(b)) &
                                 0x80000000u);
  return a / b;
}

// lower Cholesky factor of S, kalman._chol_small's recurrence
template <bool kDirectZero>
__device__ __forceinline__ void cholesky(const float (&s)[kDz][kDz],
                                         float (&l)[kDz][kDz]) {
#pragma unroll
  for (int i = 0; i < kDz; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float acc = s[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) acc = acc - l[i][k] * l[j][k];
      l[i][j] = (i == j) ? sqrtf(acc) : quotient<kDirectZero>(acc, l[j][j]);
    }
}

// Row m of the gain from row m of P H^T, (P H^T)^T [i][m] = P[m][i]: S X =
// (P H^T)^T by forward then back substitution; K[m][i] = X[i][m].
template <bool kDirectZero>
__device__ __forceinline__ void gain_row(const float (&l)[kDz][kDz],
                                         const float* pm, float (&kg)[kDz]) {
  float y[kDz];
#pragma unroll
  for (int i = 0; i < kDz; ++i) {
    float acc = pm[i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc = acc - l[i][k] * y[k];
    y[i] = quotient<kDirectZero>(acc, l[i][i]);
  }
#pragma unroll
  for (int i = kDz - 1; i >= 0; --i) {
    float acc = y[i];
#pragma unroll
    for (int k = i + 1; k < kDz; ++k) acc = acc - l[k][i] * kg[k];
    kg[i] = quotient<kDirectZero>(acc, l[i][i]);
  }
}

// =============================================================================
// v1: a thread a slot
// =============================================================================
namespace v1 {

constexpr int kThreads = 128;

// Joseph-form update with measurement z; R = diag(1, 1, 10, 10).
__device__ __forceinline__ void kf_update(float (&x)[kDx], float (&p)[kDp],
                                          const float (&z)[kDz],
                                          Probe& probe) {
  const float r[kDz] = {(float)1.0, (float)1.0, (float)10.0, (float)10.0};
  float s[kDz][kDz];
#pragma unroll
  for (int i = 0; i < kDz; ++i)
#pragma unroll
    for (int j = 0; j < kDz; ++j)
      s[i][j] = p[i * kDx + j] + (i == j ? r[i] : 0.0f);
  float l[kDz][kDz];
  cholesky<false>(s, l);
  float kg[kDx][kDz];
#pragma unroll
  for (int m = 0; m < kDx; ++m) gain_row<false>(l, p + m * kDx, kg[m]);
  probe.wait(bits_of(kg[kDx - 1][0]));
  probe.mark(kGain);
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
  float np[kDp];
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
  for (int i = 0; i < kDp; ++i) p[i] = np[i];
  probe.wait(bits_of(p[kDp - 1]));
  probe.mark(kJoseph);
}

// The bare constant-velocity predict: x = F x, P = F P F^T + Q with
// F = I + (cx, cy, s) += (vcx, vcy, vs), Q = diag(1, 1, 1, 1, .01, .01,
// 1e-4) (each entry the f32 nearest the double, as torch.tensor rounds).
__device__ __forceinline__ void kf_predict_bare(float (&x)[kDx],
                                                float (&p)[kDp]) {
  const float q[kDx] = {(float)1.0, (float)1.0, (float)1.0, (float)1.0,
                        (float)0.01, (float)0.01, (float)0.0001};
#pragma unroll
  for (int i = 0; i < 3; ++i) x[i] = x[i] + x[i + 4];
  float fp[kDp];                           // F P
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
  Probe probe(s < n);
  if (s < n) {
    const bool rep = replay[s] != 0;
    const float* xs = (rep ? fx : x_in) + (size_t)s * kDx;
    const float* ps = (rep ? fp : p_in) + (size_t)s * kDp;
    float x[kDx], p[kDp];
#pragma unroll
    for (int i = 0; i < kDx; ++i) x[i] = xs[i];
#pragma unroll
    for (int i = 0; i < kDp; ++i) p[i] = ps[i];
#ifdef AICAM_ORU_PROBE
    unsigned seen = 0;
#pragma unroll
    for (int i = 0; i < kDx; ++i) seen |= bits_of(x[i]);
#pragma unroll
    for (int i = 0; i < kDp; ++i) seen |= bits_of(p[i]);
    probe.wait(seen);
#endif
    probe.mark(kLoad);
    if (rep) {
      const int g = gap[s];
      const Line line(z1 + (size_t)s * kDz, z2 + (size_t)s * kDz, g);
      const int last = g < max_gap ? g : max_gap;
      for (int i = 1; i <= last; ++i) {
        float z[kDz];
        line.at(i, z);
        kf_update(x, p, z, probe);
        if (i < g) {
          kf_predict_bare(x, p);
          probe.wait(bits_of(p[kDp - 1]));
          probe.mark(kPredict);
        }
      }
      probe.add(kReplaying, 1);
      probe.add(kSteps, (unsigned long long)(last > 0 ? last : 0));
    }
    float* xo = x_out + (size_t)s * kDx;
    float* po = p_out + (size_t)s * kDp;
#pragma unroll
    for (int i = 0; i < kDx; ++i) xo[i] = x[i];
#pragma unroll
    for (int i = 0; i < kDp; ++i) po[i] = p[i];
    probe.mark(kStore);
    probe.add(kSlots, 1);
  }
  probe.block_done();
}

}  // namespace v1

// =============================================================================
// rows: a group of 8 lanes a slot, lane r < 7 on row r
// =============================================================================
namespace rows {

constexpr int kLanes = 8;                       // a slot's group
constexpr int kBlockSlots = 8;                  // slots a block
constexpr int kThreads = kLanes * kBlockSlots;  // 64: two warps
constexpr int kChunks = 2;                      // 16-byte chunks a thread copies
static_assert(kBlockSlots * (kDx + kDp) / 4 <= kChunks * kThreads,
              "the copy covers a block's slots");

// v from lane `src` of this lane's group: a width-8 shuffle of the whole
// warp, which the kernel keeps converged (a group's own mask costs a
// divergence check before every shuffle)
__device__ __forceinline__ float from(float v, int src) {
  return __shfl_sync(0xffffffffu, v, src, kLanes);
}

// Joseph-form update with measurement z: lane r holds x[r] in xr and row r
// of P in pr, and leaves row r of the result there.
__device__ __forceinline__ void kf_update(int r, float& xr,
                                          float (&pr)[kDx],
                                          const float (&z)[kDz],
                                          Probe& probe) {
  const float rr[kDz] = {(float)1.0, (float)1.0, (float)10.0, (float)10.0};
  float s[kDz][kDz];
#pragma unroll
  for (int i = 0; i < kDz; ++i)
#pragma unroll
    for (int j = 0; j < kDz; ++j)
      s[i][j] = from(pr[j], i) + (i == j ? rr[i] : 0.0f);
  float l[kDz][kDz];
  cholesky<true>(s, l);
  float kr[kDz];                           // row r of the gain
  gain_row<true>(l, pr, kr);
  probe.wait(bits_of(kr[0]));
  probe.mark(kGain);
  float v[kDz];
#pragma unroll
  for (int i = 0; i < kDz; ++i) v[i] = z[i] - from(xr, i);
  {
    float acc = kr[0] * v[0];
#pragma unroll
    for (int i = 1; i < kDz; ++i) acc = acc + kr[i] * v[i];
    xr = xr + acc;
  }
  float ir[kDx];                           // row r of I - K H
#pragma unroll
  for (int q = 0; q < kDx; ++q)
    ir[q] = (r == q ? 1.0f : 0.0f) - (q < kDz ? kr[q] : 0.0f);
  float a[kDx];                            // row r of (I - K H) P
#pragma unroll
  for (int q = 0; q < kDx; ++q)
#pragma unroll
    for (int n = 0; n < kDx; ++n) {
      const float t = ir[q] * from(pr[n], q);
      a[n] = q == 0 ? t : a[n] + t;
    }
  float krr[kDz];                          // row r of K R
#pragma unroll
  for (int i = 0; i < kDz; ++i) krr[i] = kr[i] * rr[i];
#pragma unroll
  for (int n = 0; n < kDx; ++n) {
    float kn[kDz];                         // row n of K, from lane n
#pragma unroll
    for (int i = 0; i < kDz; ++i) kn[i] = from(kr[i], n);
    float b = a[0] * ((n == 0 ? 1.0f : 0.0f) - kn[0]);
#pragma unroll
    for (int q = 1; q < kDx; ++q)
      b = b + a[q] * ((n == q ? 1.0f : 0.0f) - (q < kDz ? kn[q] : 0.0f));
    float c = krr[0] * kn[0];
#pragma unroll
    for (int i = 1; i < kDz; ++i) c = c + krr[i] * kn[i];
    pr[n] = b + c;   // a holds what row r still needs of the old P
  }
  probe.wait(bits_of(pr[kDx - 1]));
  probe.mark(kJoseph);
}

// The bare constant-velocity predict on row r (Q as v1's): lanes 0-2 add
// row r + 4.
__device__ __forceinline__ void kf_predict_bare(int r, float& xr,
                                                float (&pr)[kDx]) {
  const int up = (r + 4) & (kLanes - 1);
  const float xu = from(xr, up);
  if (r < 3) xr = xr + xu;
  float fr[kDx];                           // row r of F P
#pragma unroll
  for (int j = 0; j < kDx; ++j) {
    const float pu = from(pr[j], up);
    fr[j] = r < 3 ? pr[j] + pu : pr[j];
  }
  const float qr = r < 4 ? (float)1.0 : (r < 6 ? (float)0.01 : (float)0.0001);
#pragma unroll
  for (int j = 0; j < kDx; ++j) {
    const float f = j < 3 ? fr[j] + fr[j + 4] : fr[j];
    pr[j] = f + (r == j ? qr : 0.0f);
  }
}

// The block's `live` slots of x and p into x_out and p_out: 16-byte chunks,
// neighbouring threads on neighbouring addresses, all loads issued before
// the first store (`vec`: every pointer on the 16-byte grid; else scalars).
__device__ __forceinline__ void copy_slots(const float* __restrict__ xi,
                                           const float* __restrict__ pi,
                                           float* __restrict__ xo,
                                           float* __restrict__ po, int live,
                                           bool vec, Probe& probe) {
  const int t = threadIdx.x;
  const int nx = live * kDx, np = live * kDp;
  if (vec) {
    const int cx = nx >> 2, cn = cx + (np >> 2);
    const float4* xi4 = reinterpret_cast<const float4*>(xi);
    const float4* pi4 = reinterpret_cast<const float4*>(pi);
    float4 v[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = t + k * kThreads;
      if (c < cn) v[k] = c < cx ? xi4[c] : pi4[c - cx];
    }
    // the ragged ends (a block with fewer than 8 slots), at most 3 each
    const int tx = (cx << 2) + t, tp = ((np >> 2) << 2) + t;
    float ex = 0.0f, ep = 0.0f;
    if (tx < nx) ex = xi[tx];
    if (tp < np) ep = pi[tp];
#ifdef AICAM_ORU_PROBE
    probe.wait(bits_of(v[0].x) | bits_of(v[0].w) | bits_of(ex) |
               bits_of(ep));
#endif
    probe.mark(kLoad);
    float4* xo4 = reinterpret_cast<float4*>(xo);
    float4* po4 = reinterpret_cast<float4*>(po);
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = t + k * kThreads;
      if (c < cn) {
        if (c < cx) xo4[c] = v[k];
        else po4[c - cx] = v[k];
      }
    }
    if (tx < nx) xo[tx] = ex;
    if (tp < np) po[tp] = ep;
  } else {
    for (int i = t; i < nx; i += kThreads) xo[i] = xi[i];
    for (int i = t; i < np; i += kThreads) po[i] = pi[i];
    probe.mark(kLoad);
  }
}

__global__ void __launch_bounds__(kThreads, 8)
oru_kernel(int n, const float* __restrict__ x_in,
           const float* __restrict__ p_in, const float* __restrict__ fx,
           const float* __restrict__ fp, const uint8_t* __restrict__ replay,
           const int32_t* __restrict__ gap, const float* __restrict__ z1,
           const float* __restrict__ z2, int max_gap, bool vec,
           float* __restrict__ x_out, float* __restrict__ p_out) {
  const int t = threadIdx.x;
  const int s0 = blockIdx.x * kBlockSlots;
  const int live = n - s0 < kBlockSlots ? n - s0 : kBlockSlots;
  const int r = t & (kLanes - 1);
  const int slot = t / kLanes;
  const size_t s = (size_t)s0 + slot;
  Probe probe(r == 0 && slot < live);
  // the slot's mask and gap, in flight beside the copy
  const bool rep = slot < live && replay[s] != 0;
  const int g = slot < live ? gap[s] : 0;
  copy_slots(x_in + (size_t)s0 * kDx, p_in + (size_t)s0 * kDp,
             x_out + (size_t)s0 * kDx, p_out + (size_t)s0 * kDp, live, vec,
             probe);
  __syncthreads();   // every copy written before a replayed slot overwrites
  probe.mark(kStore);
  // Every group of the warp steps to the warp's largest count, so that the
  // warp stays converged through its shuffles; a group past its own count,
  // or without a replay, keeps its state (the selects).
  const int last = rep ? (g < max_gap ? g : max_gap) : 0;
  if (__any_sync(0xffffffffu, rep)) {
    const int steps = __reduce_max_sync(0xffffffffu, last);
    float xr = 0.0f, pr[kDx] = {};
    if (rep && r < kDx) {
      xr = fx[s * kDx + r];
#pragma unroll
      for (int j = 0; j < kDx; ++j) pr[j] = fp[s * kDp + r * kDx + j];
    }
    const Line line = rep ? Line(z1 + s * kDz, z2 + s * kDz, g) : Line();
    probe.wait(bits_of(xr) | bits_of(pr[kDx - 1]));
    probe.mark(kLoad);
    for (int i = 1; i <= steps; ++i) {
      const bool on = i <= last;
      probe.only(on);
      float z[kDz];
      line.at(i, z);
      float ux = xr, up[kDx];
#pragma unroll
      for (int j = 0; j < kDx; ++j) up[j] = pr[j];
      kf_update(r, ux, up, z, probe);
      xr = on ? ux : xr;
#pragma unroll
      for (int j = 0; j < kDx; ++j) pr[j] = on ? up[j] : pr[j];
      kf_predict_bare(r, ux, up);
      const bool mid = on && i < g;
      xr = mid ? ux : xr;
#pragma unroll
      for (int j = 0; j < kDx; ++j) pr[j] = mid ? up[j] : pr[j];
      probe.wait(bits_of(pr[kDx - 1]));
      probe.mark(kPredict);
    }
    probe.only(true);
    if (rep) {
      probe.add(kReplaying, 1);
      probe.add(kSteps, (unsigned long long)(last > 0 ? last : 0));
      if (r < kDx) {
        x_out[s * kDx + r] = xr;
#pragma unroll
        for (int j = 0; j < kDx; ++j) p_out[s * kDp + r * kDx + j] = pr[j];
      }
      probe.mark(kStore);
    }
  }
  probe.add(kSlots, 1);
  probe.block_done();
}

}  // namespace rows

bool on_grid(const void* ptr) { return ((uintptr_t)ptr & 15u) == 0; }

}  // namespace

// n slots: x (n, 7), p (n, 7, 7), frozen x and p likewise, replay (n,) bool
// as bytes, gap (n,) int32, z1 and z2 (n, 4), all f32 and contiguous;
// writes x_out and p_out. Returns the launch's CUDA error (0 on success).
// The rows design.
extern "C" int aicam_oru_replay(int n, const void* x, const void* p,
                                const void* frozen_x, const void* frozen_p,
                                const void* replay, const void* gap,
                                const void* z1, const void* z2, int max_gap,
                                void* x_out, void* p_out, void* stream) {
  if (n < 1 || max_gap < 0) return (int)cudaErrorInvalidValue;
  const bool vec = on_grid(x) && on_grid(p) && on_grid(x_out) &&
                   on_grid(p_out);
  const int blocks = (n + rows::kBlockSlots - 1) / rows::kBlockSlots;
  rows::oru_kernel<<<blocks, rows::kThreads, 0, (cudaStream_t)stream>>>(
      n, (const float*)x, (const float*)p, (const float*)frozen_x,
      (const float*)frozen_p, (const uint8_t*)replay, (const int32_t*)gap,
      (const float*)z1, (const float*)z2, max_gap, vec, (float*)x_out,
      (float*)p_out);
  return (int)cudaGetLastError();
}

// The same function by the first design (a thread a slot).
extern "C" int aicam_oru_replay_v1(int n, const void* x, const void* p,
                                   const void* frozen_x, const void* frozen_p,
                                   const void* replay, const void* gap,
                                   const void* z1, const void* z2,
                                   int max_gap, void* x_out, void* p_out,
                                   void* stream) {
  if (n < 1 || max_gap < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n + v1::kThreads - 1) / v1::kThreads;
  v1::oru_kernel<<<blocks, v1::kThreads, 0, (cudaStream_t)stream>>>(
      n, (const float*)x, (const float*)p, (const float*)frozen_x,
      (const float*)frozen_p, (const uint8_t*)replay, (const int32_t*)gap,
      (const float*)z1, (const float*)z2, max_gap, (float*)x_out,
      (float*)p_out);
  return (int)cudaGetLastError();
}

#ifdef AICAM_ORU_PROBE
// The probe's sums since the last reset into host[0:slots] (slots,
// replaying slots, virtual steps, cycles of load, gain, Joseph product,
// predict and store, blocks, the blocks' cycles, a sink); reset != 0
// zeroes them after. Synchronous.
// Returns the slot count, or -(CUDA error).
extern "C" int aicam_oru_probe(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_probe, sizeof(g_probe));
  if (e == cudaSuccess && reset) {
    static const unsigned long long zeros[kProbeSlots] = {};
    e = cudaMemcpyToSymbol(g_probe, zeros, sizeof(g_probe));
  }
  return e == cudaSuccess ? (int)kProbeSlots : -(int)e;
}
#endif
