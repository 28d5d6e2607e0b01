// Optimal assignment (shortest-augmenting-path LAPJV) and the DeepSORT
// matching cascade for Hopper (sm_90a), one thread block per problem.
//
// Replaces the JAX package's device loops, which are XLA while-loops and
// conds, not Pallas: aicamera_tpu/core/assignment.py::solve_square,
// ::min_cost_matching and ::matching_cascade. The JAX package keeps the
// solver on the device so that the tracking step never returns to the host;
// this kernel does the same for the port: one launch solves one masked
// (R, C) problem, or a whole cascade of up to max_age levels, and reads
// nothing back.
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
// Bound: latency. The work is a sequential search over an n x n matrix of
// at most 256 x 256 f32; at the tracker's 128 x 64 it reads 32 KB once
// (10 ns at 3.35 TB/s), far less than one launch costs. The design keeps
// every step on chip and short:
//   - the eligible rows of the raw cost block sit in shared memory (rows
//     padded to an odd stride, so that a warp reading down a column meets
//     no bank conflict) when the block fits in 200 KB, else they are read
//     from device memory; the staging keeps 4 rows of loads in flight a
//     warp; the padding and the clamp are computed where an entry is
//     read, not stored;
//   - the parallel parts (staging, the feasible rows and columns, the row
//     argmins) use all 8 warps; the augmenting search, sequential by
//     nature, runs on warp 0 alone, so each step costs one warp argmin
//     (shuffles) and __syncwarp, not block barriers; the rows it augments
//     are found 32 at a time by a ballot;
//   - the cascade finds each next level by one block reduction, so it
//     costs the levels present (1 to 3 a frame), not max_age.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, 128 x 64
// with 24 tracks and 24 detections: 35 us a cascade, 33 us a solve
// (graph replay), against 0.9 us for an empty kernel; staging one row at
// a time and scanning the 128 rows one by one for augmenting rows, the
// first build took 47 and 40 us.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <climits>

namespace {

constexpr int kMaxN = 256;        // the largest max(R, C) taken
constexpr int kThreads = 256;     // 8 warps
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxStagedBytes = 200 * 1024;
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
__device__ void solve(const Problem& p, Smem& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int n = p.n;

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

  // --- augmenting paths, warp 0 -------------------------------------------
  if (warp == 0) {
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
  }
  __syncthreads();

  // --- acceptance ---------------------------------------------------------
  for (int i = tid; i < p.r; i += blockDim.x) {
    const int j = s.col4row[i];
    const bool ok = s.rows[i] && j >= 0 && j < p.c && s.cols[j] &&
                    p.cost[i * p.ld + j] <= p.max_d;
    s.match[i] = ok ? j : -1;
  }
  __syncthreads();
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
  extern __shared__ float staged_cost[];
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

  if (!cascade) {
    for (int i = tid; i < r; i += blockDim.x) s.rows[i] = s.eligible[i];
    __syncthreads();
    solve(p, s);
    for (int i = tid; i < r; i += blockDim.x) match[i] = s.match[i];
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
    solve(p, s);
    for (int i = tid; i < r; i += blockDim.x) {
      const int m = s.match[i];
      if (m >= 0) {
        match[i] = m;   // each row is on one level: written at most once
        s.cols[m] = 0;  // claimed; distinct rows hold distinct columns
      }
    }
    prev = level;
  }
  __syncthreads();
  for (int j = tid; j < c; j += blockDim.x) unmatched[j] = s.cols[j];
}

// The bytes of shared memory a launch of this (R, C) stages, 0 when the cost
// stays in device memory.
int staged_bytes(int r, int c) {
  const long bytes = (long)r * (c | 1) * (long)sizeof(float);
  return bytes <= kMaxStagedBytes ? (int)bytes : 0;
}

}  // namespace

// cost: (R, C) f32, row-major. row_mask (R,), col_mask (C,): bytes 0/1.
// levels: (R,) int32 or null (see assignment_kernel). match: (R,) int64.
// unmatched: (C,) bytes, the cascade only. 1 <= R, C <= 256. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int aicam_assignment(const void* cost, int r, int c,
                                const void* row_mask, const void* levels,
                                const void* col_mask, float max_d, int depth,
                                void* match, void* unmatched, void* stream) {
  if (r < 1 || c < 1 || r > kMaxN || c > kMaxN)
    return (int)cudaErrorInvalidValue;
  const int smem = staged_bytes(r, c);
  if (smem > 48 * 1024) {
    // beyond the default limit: opted into per device, so on every launch
    const cudaError_t e = cudaFuncSetAttribute(
        assignment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  assignment_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)cost, r, c, (const uint8_t*)row_mask,
      (const int32_t*)levels, (const uint8_t*)col_mask, max_d, depth,
      smem > 0, (int64_t*)match, (uint8_t*)unmatched);
  return (int)cudaGetLastError();
}
