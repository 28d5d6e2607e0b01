// Optimal assignment (shortest-augmenting-path LAPJV) and the DeepSORT
// matching cascade for Hopper (sm_90a), one thread block per problem.
//
// Replaces the JAX package's device loops, which are XLA while-loops and
// conds, not Pallas: aicamera_tpu/core/assignment.py::solve_square,
// ::min_cost_matching and ::matching_cascade. The JAX package keeps the
// solver on the device so that the tracking step never returns to the host;
// this kernel does the same for the port: one launch solves B masked
// (R, C) problems, or B whole cascades of up to max_age levels, and reads
// nothing back. Problem b is block b (blockIdx.x): the counterpart of the
// JAX package's jax.vmap of the tracker step over streams, whose
// association loops run for every stream at once. B = 1 is the launch of
// one problem; the streams of a multi-stream dispatch are B problems of
// one launch (a stage of a frame: one launch for all streams).
//
// What it computes is exactly the plain PyTorch version's
// (aicamera_tpu_torch/core/assignment.py, its oracle on the card):
//   - the clamp max_d + 1e-5 in f32; costs of ineligible pairs and costs
//     above max_d take it; rows and columns without a feasible entry drop
//     out; the problem is padded to n = max(R, C) with the clamp;
//   - the row-argmin pre-assignment: every remaining row claims its
//     cheapest column (first index of the minimum), a collision goes to the
//     smallest row, and u of a winner is the value at its argmin;
//   - one shortest augmenting path for each remaining row, in ascending
//     row order, each step taking the first column of least reduced cost;
//   - the JV dual updates in f32 and in the same operation order:
//     ((min_val + cost) - u) - v, (u + min_val) - spc, v - (min_val - spc),
//     with __fadd_rn / __fsub_rn so that nvcc neither contracts nor
//     reorders them;
//   - a match stands only if both ends are eligible and its original cost
//     is at most max_d;
//   - the cascade: the levels in [1, depth] present among the eligible
//     tracks, ascending, each solved against the detections still
//     unmatched, stopping once none is left.
//
// Bound: latency. At the tracker's 128 x 64 the kernel reads 32 KB once
// (10 ns at 3.35 TB/s), far less than one launch costs; its time is a chain
// of dependent steps on one warp plus the fixed work around them. The
// design (aicam_assignment) cuts both:
//   - it solves the live problem, not the padded square. Only rows with a
//     feasible entry enter a search. A clamp column (padding, or a column
//     with no feasible entry) holds the clamp in every live row; until a
//     search first takes it as its sink it has v = 0 and the same spc as
//     every other untouched one, so ties always go to the lowest-indexed
//     untouched one, and at most k (the live rows) are ever touched. The
//     feasible columns plus the first k clamp columns, in ascending
//     original index, therefore reproduce the full solve exactly
//     (tests/test_torch_assignment.py holds a mirror of this to
//     solve_square). At the main path's load that is at most 48 columns of
//     128, at most 8 a lane at n = 256;
//   - one warp runs every search with its columns' v, spc, path, row4col
//     and scanned bits in registers (S slots a lane, S = ceil(m / 32), a
//     template); a step reads the cost row of the current row and u from
//     shared memory, takes its argmin by one __reduce_min_sync over an
//     order-preserving key of the reduced cost (-0.0 as +0.0), one ballot
//     and __ffs for the smallest index, and two shuffles from the owner;
//   - the pre-assignment gives a warp to each row (lanes over columns, two
//     warp reductions for the first index of the minimum);
//   - the fixed costs are paid once a launch: the cost is staged by
//     cp.async, issued first, overlapping the mask and level loads; the
//     feasibility of every entry is one bit, computed once; each level of
//     the cascade touches only its own rows, found by warp 0 from levels it
//     holds in registers; a launch with no eligible row writes its -1s and
//     returns after the mask load; the kernel reads the tracker's int32
//     levels and clamps them itself, so the wrapper launches nothing else.
// The design before it (aicam_assignment_v1, kept as a variant, on no path)
// scanned all n columns a step from shared memory with a 10-shuffle argmin
// and re-initialised n entries of seven arrays for every solve.
//
// What bounds it now (chip_smoke.py's [assignment]: both designs in turns in
// one call, and the phase probe; NVIDIA H100 80GB HBM3 at 700 W; PERF.md
// section 6): at the seeded 128 x 64 problems (24 tracks, 24 detections,
// ~25 augmenting steps a launch) 15 us a cascade against v1's 36, half of
// it the search at ~590 cycles a step against v1's ~1760; at the problems
// the main path records (tests/data/assignment_main_path.npz) the
// pre-assignment settles every row, no search runs, and a launch is its
// fixed costs alone: 7.1 us a cascade (v1 12.0) and 3.6 us an IoU solve
// (v1 5.8), spread evenly over the mask and level loads, the feasibility
// bits, the level's live rows, the pre-assignment and the two barriers
// around it, each 1000-3000 cycles; an empty kernel's replay is 1.1 us.
// Moving the mask loads ahead of the copy, reading the staged cost with
// shared loads and giving each warp its own threads' rows for the
// feasibility bits measured slower (17.6-17.8 us a cascade): not taken.
//
// Built with -DAICAM_ASG_PROBE (a second library that only chip_smoke.py
// loads), both designs add thread 0's clock64() cycles by phase, the solves,
// the rows augmented and the augmenting steps of every problem (every block)
// into a device buffer that aicam_assignment_probe reads; kProblems counts
// the problems, so the sums divide into per-problem means whatever B was.
//
// A batch: the B blocks are independent, each with its own shared memory
// (at 128 x 64, 17 KB of Smem and 32 KB of staged cost) and 256 threads of
// 96 registers (ptxas, sm_90a): an SM holds two such blocks (registers bound
// it, shared memory would allow four), so up to 264 problems, and any
// stream count up to the H100 SXM's 132 SMs, run as one wave.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <climits>

namespace {

constexpr int kMaxN = 256;        // the largest max(R, C) taken
constexpr int kThreads = 256;     // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kWords = kMaxN / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxStagedBytes = 200 * 1024;

// --- the phase probe ----------------------------------------------------------
enum ProbeSlot {
  kProblems, kLoad, kStage, kFeasibility, kLevels, kInit, kArgmin, kAugment,
  kAccept, kOutput, kSolves, kRowsAugmented, kSteps, kTotal, kProbeSlots
};

#ifdef AICAM_ASG_PROBE
__device__ unsigned long long g_probe[kProbeSlots];

// Thread 0's clock: mark(slot) adds the cycles since the last mark to slot.
struct Probe {
  long long t0, t;
  __device__ Probe() {
#ifdef __CUDA_ARCH__
    t0 = clock64();
#endif
    t = t0;
  }
  __device__ void mark(int slot) {
    if (threadIdx.x == 0) {
      long long now = 0;
#ifdef __CUDA_ARCH__
      now = clock64();
#endif
      atomicAdd(&g_probe[slot], (unsigned long long)(now - t));
      t = now;
    }
  }
  __device__ void add(int slot, unsigned long long v) {
    if (threadIdx.x == 0) atomicAdd(&g_probe[slot], v);
  }
  __device__ void finish() {
    mark(kOutput);
    add(kTotal, (unsigned long long)(t - t0));
    add(kProblems, 1);
  }
};
#else
struct Probe {
  __device__ void mark(int) {}
  __device__ void add(int, unsigned long long) {}
  __device__ void finish() {}
};
#endif

// The bytes of shared memory a launch of this (R, C) stages, 0 when the cost
// stays in device memory; each row of the layout takes `ld` floats.
int staged_bytes(int r, int ld) {
  const long bytes = (long)r * ld * (long)sizeof(float);
  return bytes <= kMaxStagedBytes ? (int)bytes : 0;
}

// A block gets 48 KB of shared memory, static and dynamic together, unless
// its kernel opts into more: done once a device, for the largest staging.
cudaError_t opt_in(const void* kernel, size_t static_bytes, int smem,
                   bool* done) {
  if (static_bytes + smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 0 && dev < 64 && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxStagedBytes);
  if (e == cudaSuccess && dev >= 0 && dev < 64) done[dev] = true;
  return e;
}

// ============================================================================
// The design of the main path: the live problem, searched in warp registers.
// ============================================================================
namespace lanes {

struct Smem {
  uint32_t feas[kMaxN][kWords];  // bit j of row i: cost[i][j] <= max_d
  float u[kMaxN];                // by row
  float rowmin[kMaxN];           // by live position: the argmin's value
  int col4row[kMaxN];            // by row: its compact column, -1
  int match[kMaxN];              // by row: the accepted column, -1
  int lv[kMaxN];                 // by row: its level, 0 for none
  int live[kMaxN];               // the level's live rows, ascending
  int jmin[kMaxN];               // by live position: its argmin column
  int colmap[kMaxN];             // compact column -> original, -1: clamp
  int winner[kMaxN];             // compact column -> smallest claimer
  uint32_t cols[kWords];         // the columns still unmatched
  // the level's live rows and columns (-1 rows: no level left), by the
  // parity of the level loop's turn: a warp that reads one turn's late
  // never sees the next turn's
  int km[2][2];
};

// An order-preserving key of a float that is not NaN, -0.0 as +0.0.
__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t b = __float_as_uint(x == 0.0f ? 0.0f : x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ uint32_t lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// The entry (i, jo) of the padded problem for a live row: jo < 0 is a clamp
// column.
__device__ __forceinline__ float entry(const float* cm, int ld, int i, int jo,
                                       float max_d, float clamp) {
  if (jo < 0) return clamp;
  const float x = cm[i * ld + jo];
  return x <= max_d ? x : clamp;
}

// Warp 0: the pre-assignment's outcome, then a shortest augmenting path for
// every live row it left unassigned, in ascending row order. S compact
// columns a lane, lane l holding l * S .. l * S + S - 1 (so the lowest lane
// that holds the minimum holds its first index).
template <int S>
__device__ void search(Smem& s, const float* cm, int ld, float max_d,
                       float clamp, int k, int m, Probe& pr) {
  const int lane = threadIdx.x & 31;
  int jo[S], r4c[S], path[S];
  float v[S], spc[S];
  uint32_t off = 0;  // slots beyond m: never taken
#pragma unroll
  for (int t = 0; t < S; ++t) {
    const int jc = lane * S + t;
    const bool on = jc < m;
    jo[t] = on ? s.colmap[jc] : -1;
    const int w = on ? s.winner[jc] : INT_MAX;
    r4c[t] = w != INT_MAX ? w : -1;
    v[t] = 0.0f;
    path[t] = -1;
    if (!on) off |= 1u << t;
  }
  for (int p = lane; p < k; p += 32) {
    const int i = s.live[p];
    const bool won = s.winner[s.jmin[p]] == i;
    s.col4row[i] = won ? s.jmin[p] : -1;
    s.u[i] = won ? s.rowmin[p] : 0.0f;
  }
  __syncwarp();
  unsigned long long steps = 0, rows = 0;

  for (int p0 = 0; p0 < k; p0 += 32) {
    // a path flips only rows assigned already: a row unassigned here is
    // still unassigned at its turn
    unsigned todo = __ballot_sync(
        kFull, p0 + lane < k && s.col4row[s.live[p0 + lane]] < 0);
    while (todo) {
      const int i = s.live[p0 + __ffs(todo) - 1];
      todo &= todo - 1;
      ++rows;
      uint32_t sc = off;
#pragma unroll
      for (int t = 0; t < S; ++t) spc[t] = INFINITY;
      float min_val = 0.0f;
      int cur = i, sink;
      while (true) {
        const float ucur = s.u[cur];
        float x[S];
#pragma unroll
        for (int t = 0; t < S; ++t)
          x[t] = entry(cm, ld, cur, jo[t], max_d, clamp);
        float bv = INFINITY;
        int bt = -1;
#pragma unroll
        for (int t = 0; t < S; ++t) {
          if (!((sc >> t) & 1u)) {
            const float red = __fsub_rn(
                __fsub_rn(__fadd_rn(min_val, x[t]), ucur), v[t]);
            if (red < spc[t]) {
              spc[t] = red;
              path[t] = cur;
            }
            if (bt < 0 || spc[t] < bv) {
              bv = spc[t];
              bt = t;
            }
          }
        }
        const uint32_t key = bt < 0 ? 0xffffffffu : order_key(bv);
        const uint32_t least = __reduce_min_sync(kFull, key);
        const int owner = __ffs(__ballot_sync(kFull, key == least)) - 1;
        int rsel = -1;
#pragma unroll
        for (int t = 0; t < S; ++t)
          if (t == bt) rsel = r4c[t];
        const int got = __shfl_sync(kFull, bt | ((rsel + 1) << 8), owner);
        min_val = __shfl_sync(kFull, bv, owner);
        const int wt = got & 0xff, rr = (got >> 8) - 1;
        if (lane == owner) sc |= 1u << wt;
        ++steps;
        if (rr < 0) {
          sink = owner * S + wt;
          break;
        }
        cur = rr;
      }
      // dual updates, before the flip (they read the old row4col): the rows
      // visited other than i are the rows of the scanned columns but the
      // sink
      sc &= ~off;
#pragma unroll
      for (int t = 0; t < S; ++t) {
        if ((sc >> t) & 1u) {
          if (r4c[t] >= 0)
            s.u[r4c[t]] = __fsub_rn(__fadd_rn(s.u[r4c[t]], min_val), spc[t]);
          v[t] = __fsub_rn(v[t], __fsub_rn(min_val, spc[t]));
        }
      }
      if (lane == 0) s.u[i] = __fadd_rn(s.u[i], min_val);
      // the flip, from the sink back to i
      int j = sink;
      while (true) {
        const int ow = j / S, t = j - ow * S;
        int pj = -1;
#pragma unroll
        for (int tt = 0; tt < S; ++tt)
          if (tt == t) pj = path[tt];
        const int ii = __shfl_sync(kFull, pj, ow);
        if (lane == ow) {
#pragma unroll
          for (int tt = 0; tt < S; ++tt)
            if (tt == t) r4c[tt] = ii;
        }
        int jn = 0;
        if (lane == 0) {
          jn = s.col4row[ii];
          s.col4row[ii] = j;
        }
        jn = __shfl_sync(kFull, jn, 0);
        if (ii == i) break;
        j = jn;
      }
      __syncwarp();
    }
  }
  pr.add(kSteps, steps);
  pr.add(kRowsAugmented, rows);
}

// Problem b = blockIdx.x of the batch: levels == nullptr: one
// min_cost_matching of row_mask against col_mask (one level). Else the
// cascade over the eligible rows (row_mask) by level (int32, clamped here),
// against the valid columns (col_mask); `unmatched` gets the columns left.
// Every pointer is the batch's base; problem b's data start b problems in.
__global__ void __launch_bounds__(kThreads, 1)
assignment_kernel(const float* __restrict__ cost, int r, int c,
                  const uint8_t* __restrict__ row_mask,
                  const int32_t* __restrict__ levels,
                  const uint8_t* __restrict__ col_mask, float max_d,
                  int depth, int staged, int64_t* __restrict__ match,
                  uint8_t* __restrict__ unmatched) {
  __shared__ Smem s;
  extern __shared__ __align__(16) float staged_cost[];
  Probe pr;
  {
    const size_t b = blockIdx.x;
    cost += b * r * c;
    row_mask += b * r;
    if (levels != nullptr) levels += b * r;
    col_mask += b * c;
    match += b * r;
    if (unmatched != nullptr) unmatched += b * c;
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = r > c ? r : c;
  const int words = (c + 31) >> 5;
  const float clamp = __fadd_rn(max_d, 1e-5f);
  const int ld = staged ? ((c + 3) & ~3) : c;
  const float* cm = staged ? staged_cost : cost;

  // --- the copy first: every row, overlapping the loads below -------------
  if (staged) {
    if ((c & 3) == 0 && ((uintptr_t)cost & 15) == 0) {
      const int q = c >> 2, total = r * q;
      for (int x = tid; x < total; x += kThreads) {
        const int i = x / q, jq = x - i * q;
        const uint32_t dst = (uint32_t)__cvta_generic_to_shared(
            staged_cost + i * ld + 4 * jq);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                     "l"(cost + (size_t)x * 4));
      }
    } else {
      const int total = r * c;
      for (int x = tid; x < total; x += kThreads) {
        const int i = x / c, j = x - i * c;
        const uint32_t dst =
            (uint32_t)__cvta_generic_to_shared(staged_cost + i * ld + j);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                     "l"(cost + x));
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  // --- masks and levels: one row and one column a thread --------------------
  int lv = 0;
  if (tid < r && row_mask[tid]) {
    if (levels == nullptr) {
      lv = 1;
    } else {
      const int l = levels[tid];
      lv = (l >= 1 && l <= depth) ? l : 0;
    }
  }
  s.lv[tid] = lv;
  s.match[tid] = -1;
  const unsigned colw = __ballot_sync(kFull, tid < c && col_mask[tid]);
  if (lane == 0 && warp < kWords) s.cols[warp] = colw;
  const bool any = __syncthreads_or(lv > 0);
  pr.mark(kLoad);
  if (!any) {
    if (tid < r) match[tid] = -1;
    if (unmatched != nullptr && tid < c) unmatched[tid] = col_mask[tid];
    if (staged) asm volatile("cp.async.wait_all;\n" ::: "memory");
    pr.finish();
    return;
  }
  if (staged) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  pr.mark(kStage);

  // --- the feasible entries of the eligible rows, once: a warp a row ------
  for (int i = warp; i < r; i += kWarps) {
    if (s.lv[i] == 0) continue;  // uniform over the warp
    for (int w = 0; w < words; ++w) {
      const int j = 32 * w + lane;
      const unsigned b =
          __ballot_sync(kFull, j < c && cm[i * ld + j] <= max_d);
      if (lane == 0) s.feas[i][w] = b;
    }
  }
  __syncthreads();
  pr.mark(kFeasibility);

  // warp 0 holds the levels of rows lane + 32 q
  int lvr[kWords];
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    const int i = lane + 32 * q;
    lvr[q] = (warp == 0 && i < r) ? s.lv[i] : 0;
  }
  int prev = 0;
  bool first = true;
  for (int turn = 0;; turn ^= 1) {
    if (warp == 0) {
      // --- the next level present, and its live rows ----------------------
      int mn = INT_MAX;
#pragma unroll
      for (int q = 0; q < kWords; ++q)
        if (lvr[q] > prev && lvr[q] < mn) mn = lvr[q];
      const int level = __reduce_min_sync(kFull, mn);
      bool stop = level == INT_MAX;
      // a level's solve against no columns matches nothing: only later
      // levels need the check
      if (!stop && !first)
        stop = !__any_sync(kFull, lane < words && s.cols[lane] != 0);
      int k = 0, m = 0;
      if (!stop) {
        uint32_t unm[kWords], acc[kWords];
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          unm[w] = w < words ? s.cols[w] : 0u;
          acc[w] = 0u;
        }
#pragma unroll
        for (int q = 0; q < kWords; ++q) {
          if (32 * q >= r) break;
          const int i = lane + 32 * q;
          bool ok = false;
          if (lvr[q] == level) {
#pragma unroll
            for (int w = 0; w < kWords; ++w) {
              if (w < words) {
                const uint32_t f = s.feas[i][w] & unm[w];
                ok |= f != 0u;
                acc[w] |= f;
              }
            }
          }
          const unsigned b = __ballot_sync(kFull, ok);
          if (ok) s.live[k + __popc(b & lanes_below(lane))] = i;
          k += __popc(b);
        }
        pr.mark(kLevels);
        // --- the live columns: the feasible ones and the first k clamp
        // columns, ascending --------------------------------------------
        int taken = 0;
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          const int j0 = 32 * w;
          if (j0 >= n || (j0 >= c && taken >= k)) break;
          const uint32_t colok = __reduce_or_sync(kFull, acc[w]);
          const int j = j0 + lane;
          const bool feas = j < c && ((colok >> lane) & 1u);
          const bool cl = j < n && !feas;
          const unsigned bc = __ballot_sync(kFull, cl);
          const bool inc =
              feas || (cl && taken + __popc(bc & lanes_below(lane)) < k);
          const unsigned bi = __ballot_sync(kFull, inc);
          if (inc) {
            const int pos = m + __popc(bi & lanes_below(lane));
            s.colmap[pos] = feas ? j : -1;
            s.winner[pos] = INT_MAX;
          }
          m += __popc(bi);
          taken += __popc(bc);
        }
        prev = level;
        first = false;
      }
      if (lane == 0) {
        s.km[turn][0] = stop ? -1 : k;
        s.km[turn][1] = m;
      }
    }
    __syncthreads();
    const int k = s.km[turn][0], m = s.km[turn][1];
    pr.mark(kInit);
    if (k < 0) break;
    if (k == 0) continue;  // nothing feasible on this level
    pr.add(kSolves, 1);

    // --- the pre-assignment: a warp a live row ------------------------------
    for (int p = warp; p < k; p += kWarps) {
      const int i = s.live[p];
      float bv = INFINITY;
      int bj = -1;
      for (int jc = lane; jc < m; jc += 32) {
        const float x = entry(cm, ld, i, s.colmap[jc], max_d, clamp);
        if (bj < 0 || x < bv) {
          bv = x;
          bj = jc;
        }
      }
      const uint32_t key = bj < 0 ? 0xffffffffu : order_key(bv);
      const uint32_t least = __reduce_min_sync(kFull, key);
      const uint32_t jm = __reduce_min_sync(
          kFull, key == least ? (uint32_t)bj : 0xffffffffu);
      if (lane == (int)(jm & 31)) {
        s.jmin[p] = (int)jm;
        s.rowmin[p] = bv;
        atomicMin(&s.winner[jm], i);
      }
    }
    __syncthreads();
    pr.mark(kArgmin);

    if (warp == 0) {
      switch ((m + 31) >> 5) {
        case 1: search<1>(s, cm, ld, max_d, clamp, k, m, pr); break;
        case 2: search<2>(s, cm, ld, max_d, clamp, k, m, pr); break;
        case 3: search<3>(s, cm, ld, max_d, clamp, k, m, pr); break;
        case 4: search<4>(s, cm, ld, max_d, clamp, k, m, pr); break;
        case 5: search<5>(s, cm, ld, max_d, clamp, k, m, pr); break;
        case 6: search<6>(s, cm, ld, max_d, clamp, k, m, pr); break;
        case 7: search<7>(s, cm, ld, max_d, clamp, k, m, pr); break;
        default: search<8>(s, cm, ld, max_d, clamp, k, m, pr); break;
      }
      pr.mark(kAugment);
      // --- acceptance: a clamp column or a cost above max_d is no match --
      for (int p = lane; p < k; p += 32) {
        const int i = s.live[p];
        const int jo = s.colmap[s.col4row[i]];
        if (jo >= 0 && cm[i * ld + jo] <= max_d) {
          s.match[i] = jo;  // each row is on one level: written once
          atomicAnd(&s.cols[jo >> 5], ~(1u << (jo & 31)));
        }
      }
      __syncwarp();
      pr.mark(kAccept);
    }
  }
  if (tid < r) match[tid] = s.match[tid];
  if (unmatched != nullptr && tid < c)
    unmatched[tid] = (s.cols[tid >> 5] >> (tid & 31)) & 1u;
  pr.finish();
}

}  // namespace lanes

// ============================================================================
// The first design, kept as a variant on no path: the padded square,
// searched from shared memory; one problem a launch (no batch).
// ============================================================================
namespace v1 {

constexpr int kRowsInFlight = 4;  // rows a warp loads at once when staging

struct Problem {
  const float* cost;  // the raw (R, C) block: shared or device memory
  int ld;             // its row stride
  int r, c, n;
  float max_d, clamp;
};

// The padded, clamped cost of entry (i, j) for a row with a feasible entry.
__device__ __forceinline__ float padded(const Problem& p,
                                        const uint8_t* colok, int i, int j) {
  if (j >= p.c || !colok[j]) return p.clamp;
  const float x = p.cost[i * p.ld + j];
  return x <= p.max_d ? x : p.clamp;
}

// (bv, bj) := the better of itself and (ov, oj): the smaller value, the
// smaller index on a tie (-0.0 ties +0.0); an index < 0 holds nothing.
__device__ __forceinline__ void take_better(float& bv, int& bj, float ov,
                                            int oj) {
  if (oj >= 0 && (bj < 0 || ov < bv || (ov == bv && oj < bj))) {
    bv = ov;
    bj = oj;
  }
}

struct Smem {
  float u[kMaxN], v[kMaxN], spc[kMaxN], rowmin[kMaxN];
  int col4row[kMaxN], row4col[kMaxN], path[kMaxN], winner[kMaxN];
  int jmin[kMaxN], lv[kMaxN], match[kMaxN];
  uint8_t sr[kMaxN], sc[kMaxN], rowok[kMaxN], colok[kMaxN];
  uint8_t rows[kMaxN], cols[kMaxN], eligible[kMaxN];
  int next_level;
};

// One masked min_cost_matching of s.rows against s.cols; every thread of
// the block calls it. Leaves the accepted matches in s.match[0:r] (-1 where
// none).
__device__ void solve(const Problem& p, Smem& s, Probe& pr) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int n = p.n;
  pr.add(kSolves, 1);

  // --- rows and columns with a feasible entry -----------------------------
  for (int k = tid; k < n; k += blockDim.x) {
    s.rowok[k] = 0;
    s.colok[k] = 0;
    s.winner[k] = n;
    s.col4row[k] = -1;
    s.row4col[k] = -1;
    s.u[k] = 0.0f;
    s.v[k] = 0.0f;
  }
  __syncthreads();
  pr.mark(kInit);
  for (int i = warp; i < p.r; i += nwarps) {
    if (!s.rows[i]) continue;  // uniform over the warp
    bool any = false;
    for (int j = lane; j < p.c; j += 32) {
      if (s.cols[j] && p.cost[i * p.ld + j] <= p.max_d) {
        any = true;
        s.colok[j] = 1;
      }
    }
    if (__any_sync(kFull, any) && lane == 0) s.rowok[i] = 1;
  }
  __syncthreads();
  pr.mark(kFeasibility);

  // --- row-argmin pre-assignment -----------------------------------------
  // Rows at or beyond R are padding and never eligible.
  for (int i = tid; i < p.r; i += blockDim.x) {
    if (!s.rowok[i]) continue;
    float best = padded(p, s.colok, i, 0);
    int bj = 0;
    for (int j = 1; j < p.c; ++j) {
      const float x = padded(p, s.colok, i, j);
      if (x < best) {
        best = x;
        bj = j;
      }
    }
    // every padded column holds the clamp: only the first can be the argmin
    if (n > p.c && p.clamp < best) {
      best = p.clamp;
      bj = p.c;
    }
    s.jmin[i] = bj;
    s.rowmin[i] = best;
    atomicMin(&s.winner[bj], i);
  }
  __syncthreads();
  for (int i = tid; i < p.r; i += blockDim.x) {
    if (s.rowok[i] && s.winner[s.jmin[i]] == i) {
      s.col4row[i] = s.jmin[i];
      s.row4col[s.jmin[i]] = i;
      s.u[i] = s.rowmin[i];
    }
  }
  __syncthreads();
  pr.mark(kArgmin);

  // --- augmenting paths, warp 0 -------------------------------------------
  if (warp == 0) {
    unsigned long long steps = 0, rows = 0;
    // the rows left unassigned by the pre-assignment, in row order, 32 rows
    // a ballot: a path only flips rows that are assigned already, so a row
    // unassigned at the ballot is still unassigned at its turn
    for (int i0 = 0; i0 < p.r; i0 += 32) {
      unsigned todo = __ballot_sync(
          kFull, i0 + lane < p.r && s.rowok[i0 + lane] &&
                     s.col4row[i0 + lane] < 0);
      while (todo) {
        const int i = i0 + __ffs(todo) - 1;
        todo &= todo - 1;
        ++rows;
        for (int k = lane; k < n; k += 32) {
          s.sr[k] = 0;
          s.sc[k] = 0;
          s.spc[k] = INFINITY;
          s.path[k] = -1;
        }
        __syncwarp();
        float min_val = 0.0f;
        int cur = i, sink;
        while (true) {
          if (lane == 0) s.sr[cur] = 1;
          const float ucur = s.u[cur];
          float bv = INFINITY;
          int bj = -1;
          for (int j = lane; j < n; j += 32) {
            float m = INFINITY;
            if (!s.sc[j]) {
              const float red = __fsub_rn(
                  __fsub_rn(__fadd_rn(min_val, padded(p, s.colok, cur, j)),
                            ucur),
                  s.v[j]);
              m = s.spc[j];
              if (red < m) {
                m = red;
                s.spc[j] = red;
                s.path[j] = cur;
              }
            }
            take_better(bv, bj, m, j);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const float ov = __shfl_xor_sync(kFull, bv, off);
            const int oj = __shfl_xor_sync(kFull, bj, off);
            take_better(bv, bj, ov, oj);
          }
          min_val = bv;
          const int rr = s.row4col[bj];
          ++steps;
          __syncwarp();
          if (lane == 0) s.sc[bj] = 1;
          __syncwarp();
          if (rr < 0) {
            sink = bj;
            break;
          }
          cur = rr;
        }
        // dual updates (before the flip: they read the old col4row)
        for (int k = lane; k < n; k += 32) {
          if (s.sr[k] && k != i)
            s.u[k] = __fsub_rn(__fadd_rn(s.u[k], min_val),
                               s.spc[s.col4row[k]]);
          if (s.sc[k])
            s.v[k] = __fsub_rn(s.v[k], __fsub_rn(min_val, s.spc[k]));
        }
        __syncwarp();
        if (lane == 0) {
          s.u[i] = __fadd_rn(s.u[i], min_val);
          int j = sink;
          while (true) {
            const int ii = s.path[j];
            s.row4col[j] = ii;
            const int jn = s.col4row[ii];
            s.col4row[ii] = j;
            if (ii == i) break;
            j = jn;
          }
        }
        __syncwarp();
      }
    }
    pr.add(kSteps, steps);
    pr.add(kRowsAugmented, rows);
  }
  __syncthreads();
  pr.mark(kAugment);

  // --- acceptance ---------------------------------------------------------
  for (int i = tid; i < p.r; i += blockDim.x) {
    const int j = s.col4row[i];
    const bool ok = s.rows[i] && j >= 0 && j < p.c && s.cols[j] &&
                    p.cost[i * p.ld + j] <= p.max_d;
    s.match[i] = ok ? j : -1;
  }
  __syncthreads();
  pr.mark(kAccept);
}

// levels == nullptr: one min_cost_matching of row_mask against col_mask.
// Else the cascade over the eligible rows (row_mask) by level, against the
// valid columns (col_mask); `unmatched` gets the columns left.
__global__ void __launch_bounds__(kThreads, 1)
assignment_kernel(const float* __restrict__ cost, int r, int c,
                  const uint8_t* __restrict__ row_mask,
                  const int32_t* __restrict__ levels,
                  const uint8_t* __restrict__ col_mask, float max_d,
                  int depth, int staged, int64_t* __restrict__ match,
                  uint8_t* __restrict__ unmatched) {
  __shared__ Smem s;
  extern __shared__ __align__(16) float staged_cost[];
  Probe pr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool cascade = levels != nullptr;
  const int sentinel = depth + 1;

  // the masks and levels, in one round of loads
  for (int i = tid; i < r; i += blockDim.x) {
    s.eligible[i] = row_mask[i];
    if (cascade) {
      const int l = levels[i];
      s.lv[i] = (row_mask[i] && l >= 1 && l <= depth) ? l : sentinel;
      match[i] = -1;
    }
  }
  for (int j = tid; j < c; j += blockDim.x) s.cols[j] = col_mask[j];
  __syncthreads();
  pr.mark(kLoad);

  Problem p;
  p.r = r;
  p.c = c;
  p.n = r > c ? r : c;
  p.max_d = max_d;
  p.clamp = __fadd_rn(max_d, 1e-5f);
  if (staged) {
    // Only the eligible rows: no solve reads another. A lane loads its
    // columns of kRowsInFlight rows before it stores any, so that the
    // loads from device memory overlap instead of queueing one by one.
    p.ld = c | 1;
    for (int i0 = warp; i0 < r; i0 += nwarps * kRowsInFlight) {
      float x[kRowsInFlight][kMaxN / 32];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int i = i0 + u * nwarps;
        const bool on = i < r && s.eligible[i];
#pragma unroll
        for (int k = 0; k < kMaxN / 32; ++k) {
          const int j = lane + 32 * k;
          x[u][k] = (on && j < c) ? cost[(size_t)i * c + j] : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int i = i0 + u * nwarps;
        if (i >= r || !s.eligible[i]) continue;
#pragma unroll
        for (int k = 0; k < kMaxN / 32; ++k) {
          const int j = lane + 32 * k;
          if (j < c) staged_cost[i * p.ld + j] = x[u][k];
        }
      }
    }
    p.cost = staged_cost;
  } else {
    p.ld = c;
    p.cost = cost;
  }
  pr.mark(kStage);

  if (!cascade) {
    for (int i = tid; i < r; i += blockDim.x) s.rows[i] = s.eligible[i];
    __syncthreads();
    solve(p, s, pr);
    for (int i = tid; i < r; i += blockDim.x) match[i] = s.match[i];
    pr.finish();
    return;
  }

  // --- the cascade ---------------------------------------------------------
  int prev = 0;
  bool first = true;
  while (true) {
    if (tid == 0) s.next_level = INT_MAX;
    __syncthreads();
    for (int i = tid; i < r; i += blockDim.x)
      if (s.lv[i] > prev && s.lv[i] < sentinel)
        atomicMin(&s.next_level, s.lv[i]);
    __syncthreads();
    const int level = s.next_level;
    bool left = false;
    for (int j = tid; j < c; j += blockDim.x) left |= s.cols[j] != 0;
    // a level's solve against no columns matches nothing: only later
    // levels need the check
    left = __syncthreads_or(left);
    if (level == INT_MAX || (!first && !left)) break;
    first = false;
    for (int i = tid; i < r; i += blockDim.x) s.rows[i] = s.lv[i] == level;
    __syncthreads();
    pr.mark(kLevels);
    solve(p, s, pr);
    for (int i = tid; i < r; i += blockDim.x) {
      const int m = s.match[i];
      if (m >= 0) {
        match[i] = m;   // each row is on one level: written at most once
        s.cols[m] = 0;  // claimed; distinct rows hold distinct columns
      }
    }
    prev = level;
  }
  pr.mark(kLevels);
  __syncthreads();
  for (int j = tid; j < c; j += blockDim.x) unmatched[j] = s.cols[j];
  pr.finish();
}

}  // namespace v1

}  // namespace

// B problems, each contiguous after the one before: cost (B, R, C) f32,
// row-major. row_mask (B, R), col_mask (B, C): bytes 0/1. levels: (B, R)
// int32, or null (see lanes::assignment_kernel). match: (B, R) int64.
// unmatched: (B, C) bytes, the cascade only. 1 <= R, C <= 256, B >= 1.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int aicam_assignment(const void* cost, int b, int r, int c,
                                const void* row_mask, const void* levels,
                                const void* col_mask, float max_d, int depth,
                                void* match, void* unmatched, void* stream) {
  if (b < 1 || r < 1 || c < 1 || r > kMaxN || c > kMaxN)
    return (int)cudaErrorInvalidValue;
  const int smem = staged_bytes(r, (c + 3) & ~3);
  static bool opted[64];
  const cudaError_t e = opt_in((const void*)lanes::assignment_kernel,
                               sizeof(lanes::Smem), smem, opted);
  if (e != cudaSuccess) return (int)e;
  lanes::assignment_kernel<<<b, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)cost, r, c, (const uint8_t*)row_mask,
      (const int32_t*)levels, (const uint8_t*)col_mask, max_d, depth,
      smem > 0, (int64_t*)match, (uint8_t*)unmatched);
  return (int)cudaGetLastError();
}

// The first design, with its own interface: one problem, levels (R,) int32
// in [0, depth + 1] (the wrapper clamps them), else as aicam_assignment at
// B = 1.
extern "C" int aicam_assignment_v1(const void* cost, int r, int c,
                                   const void* row_mask, const void* levels,
                                   const void* col_mask, float max_d,
                                   int depth, void* match, void* unmatched,
                                   void* stream) {
  if (r < 1 || c < 1 || r > kMaxN || c > kMaxN)
    return (int)cudaErrorInvalidValue;
  const int smem = staged_bytes(r, c | 1);
  static bool opted[64];
  const cudaError_t e = opt_in((const void*)v1::assignment_kernel,
                               sizeof(v1::Smem), smem, opted);
  if (e != cudaSuccess) return (int)e;
  v1::assignment_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)cost, r, c, (const uint8_t*)row_mask,
      (const int32_t*)levels, (const uint8_t*)col_mask, max_d, depth,
      smem > 0, (int64_t*)match, (uint8_t*)unmatched);
  return (int)cudaGetLastError();
}

#ifdef AICAM_ASG_PROBE
// The probe's sums since the last reset into host[0:slots] (problems, then
// cycles of load, stage, feasibility, levels, init, argmin, augment, accept,
// output; solves, rows augmented, augmenting steps, total cycles); reset
// != 0 zeroes them after. Synchronous. Returns the slot count, or -(CUDA
// error).
extern "C" int aicam_assignment_probe(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_probe, sizeof(g_probe));
  if (e == cudaSuccess && reset) {
    static const unsigned long long zeros[kProbeSlots] = {};
    e = cudaMemcpyToSymbol(g_probe, zeros, sizeof(g_probe));
  }
  return e == cudaSuccess ? (int)kProbeSlots : -(int)e;
}
#endif
