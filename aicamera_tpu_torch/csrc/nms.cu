// The greedy-NMS keep for Hopper (sm_90a): every frame of a batch in one
// call, nothing read back to the host.
//
// Replaces the JAX package's device loop, an XLA while-loop, not Pallas:
// aicamera_tpu/ops/nms.py::_greedy_keep (:36, its lax.while_loop at :66)
// over the overlap that _suppress_and_emit builds at :109,
// `_greedy_keep(pairwise(shifted) > iou_threshold, k_valid)`. Over K
// score-ordered candidates of a frame, that is the sequential greedy scan:
// kept[i] = valid[i] and no kept j < i overlaps i by more than the
// threshold. JAX iterates the fixpoint with a (K, K) matvec a step until it
// stops changing; here the scan runs in index order, once.
//
// What it computes is the plain PyTorch version's
// (aicamera_tpu_torch/ops/nms.py: _greedy_keep over _pairwise_iou_xyxy or
// _pairwise_ios_xyxy), bit for bit: each pair's overlap is the same
// sequence of rounded f32 operations as there, areas first, then the
// intersection, then (area_j + area_i) - inter (IoU) or min(area_j,
// area_i) (IoS), clamped below at 1e-7, then an IEEE division, then `> thr`
// with the threshold as the f32 the plain version compares against. The
// file is built with --fmad=false (ops/nms.py), so that no product is fused
// into the sum beside it, as PyTorch's separate kernels round each
// operation. max, min and clamp keep NaN as torch.maximum, torch.minimum
// and torch.clamp do, so a NaN or infinite box overlaps nothing, as there.
// The order of the candidates is the caller's (the stable top-k before
// it): nothing here reorders them.
//
// Two launches on the caller's stream:
//
// - mask: a block of 4 warps for one (32-row tile, 32-column word) pair of
//   a frame at or right of the diagonal (only the upper triangle is made:
//   a candidate suppresses later ones only), so a frame of K = 300 is 55
//   blocks. The tile's 32 row boxes and the word's 32 column boxes, each
//   with its area, are staged in shared memory; lane l of a warp holds
//   column i = 32 w + l, takes its warp's 8 rows j of the tile in turn and
//   votes `i > j and overlap(j, i) > thr` with __ballot_sync: the vote is
//   row j's word w. Lane r keeps its row's vote and the warp stores its 8
//   row words side by side. The mask is (B, W, 32 W) uint32, W = ceil(K /
//   32), word-major so that a chunk's 32 rows of one word are 128
//   contiguous bytes; the wrapper allocates it (torch.empty). Rows and
//   columns past K vote 0. A tile with no valid row makes no words: no
//   candidate of it can be kept, so the scan never uses them.
// - scan: one warp a frame walks the chunks of 32 candidates in order. It
//   first loads every chunk's valid bits at once (lane l the 32 bytes of
//   chunks l, l + 32, ...) into shared memory beside the "removed" words.
//   A chunk with no candidate standing (valid and not removed) keeps none
//   and removes nothing, so it costs no load. Otherwise the warp loads the
//   chunk's diagonal words (row i's word c, one per lane) and each lane its
//   first later word's line, and takes the standing candidates lowest index
//   first: each taken candidate t is kept and ORs its diagonal word,
//   shuffled from lane t, into the chunk's removed bits, which can only
//   drop later candidates of the chunk. Then the lane that owns a later
//   word w (w = lane, lane + 32, ...) ORs the chunk's kept rows of word w
//   (one 128-byte line, 8 16-byte loads, masked by the kept bits) into
//   removed[w] (past 32 words, K > 1024, a lane's further lines are loaded
//   there).
//
// One code path for every K from 1 to kMaxK (16384): shared memory holds
// the removed words and valid bits (kMaxWords each, 4 KB) and a pair's 64
// boxes, never a frame's mask, so a large K takes the same path as the
// main path's 300.
//
// Bound: latency. The keep needs only a frame's n valid candidates: their
// n x 16 bytes of boxes, the K valid bytes read and the K kept bytes
// written, n areas and n (n - 1) / 2 pair overlaps of ~14 operations each.
// The main path's frames hold ~5 valid candidates, so its chunk of 8 is
// 5.4 KB and ~1,300 operations (0.002 us at 3.35 TB/s); even a chunk with
// all 300 valid is 43 KB and 5.0 Mop (0.075 us at the f32 rate). Both are
// far below an empty kernel's
// replay (about 1.1 us), so what a call costs is its two launches and two
// chains: in the mask launch a warp's 8 overlaps, each ending in an IEEE
// division whose slow-path branch keeps one from overlapping the next (8
// rows a warp, not 32, keeps the chain short); in the scan, the chunks one
// after another (a chunk's removed word is final only after the chunks
// before it), each chunk with a candidate standing one round trip to the
// L2 and a few cycles a kept candidate. The main path's frames hold ~5
// valid candidates, all in the first chunk (valid is a prefix of the
// score order), so their scan is two round trips. The mask (B x W x 32 W
// x 4 bytes, 12.8 KB a frame at K = 300) is written at most once and read
// at most once, from the L2.
// chip_smoke.py's [nms] phase times it against that bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaskWarps = 4;                 // mask: warps a block
constexpr int kMaskThreads = kMaskWarps * kWarp;
constexpr int kRowsPerWarp = kWarp / kMaskWarps;  // a tile's rows a warp
constexpr int kMaxK = 16384;                  // the wrapper's limit
constexpr int kMaxWords = kMaxK / kWarp;
constexpr unsigned kFull = 0xffffffffu;

// torch.clamp(v, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : (v < lo ? lo : v);
}

// torch.maximum and torch.minimum: NaN if either is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : (a > b ? a : b));
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : (a < b ? a : b));
}

struct Box {
  float x1, y1, x2, y2, area;
};

// Candidate i of a frame (zeros past k); its area as the plain version
// computes it: clamp(x2 - x1, 0) * clamp(y2 - y1, 0).
__device__ __forceinline__ Box load_box(const float* frame, int i, int k) {
  Box b{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (i < k) {
    b.x1 = frame[4 * i + 0];
    b.y1 = frame[4 * i + 1];
    b.x2 = frame[4 * i + 2];
    b.y2 = frame[4 * i + 3];
    b.area = clamp_min(b.x2 - b.x1, 0.0f) * clamp_min(b.y2 - b.y1, 0.0f);
  }
  return b;
}

// The overlap of row box a (candidate j) with column box b (candidate i),
// in _pairwise_iou_xyxy's and _pairwise_ios_xyxy's operation order.
__device__ __forceinline__ float overlap(const Box& a, const Box& b,
                                         bool ios) {
  const float ix1 = max_nan(a.x1, b.x1);
  const float iy1 = max_nan(a.y1, b.y1);
  const float ix2 = min_nan(a.x2, b.x2);
  const float iy2 = min_nan(a.y2, b.y2);
  const float inter =
      clamp_min(ix2 - ix1, 0.0f) * clamp_min(iy2 - iy1, 0.0f);
  const float den = ios ? min_nan(a.area, b.area) : (a.area + b.area) - inter;
  return inter / clamp_min(den, 1e-7f);
}

// The mask launch's block p of a frame: the p-th (row tile, word) pair of
// the upper triangle, row tile by row tile.
__device__ __forceinline__ void pair_of(int words, int p, int& rt, int& w) {
  rt = 0;
  while (p >= words - rt) {
    p -= words - rt;
    ++rt;
  }
  w = rt + p;
}

__global__ void __launch_bounds__(kMaskThreads)
mask_kernel(int k, int words, const float* __restrict__ boxes,
            const uint8_t* __restrict__ valid, float thr, int ios,
            uint32_t* __restrict__ mask) {
  __shared__ Box s_rows[kWarp], s_cols[kWarp];
  __shared__ int s_any;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  int rt, w;
  pair_of(words, blockIdx.x, rt, w);
  const int frame = blockIdx.y;
  const float* fb = boxes + (size_t)frame * k * 4;
  const int kpad = words * kWarp;
  uint32_t* fm = mask + (size_t)frame * words * kpad;
  if (warp == 0) {
    const int j = rt * kWarp + lane;
    s_rows[lane] = load_box(fb, j, k);
    const uint32_t rows_on =
        __ballot_sync(kFull, j < k && valid[(size_t)frame * k + j] != 0);
    if (lane == 0) s_any = rows_on != 0u;
  }
  if (warp == 1) s_cols[lane] = load_box(fb, w * kWarp + lane, k);
  __syncthreads();
  // a tile without a valid row keeps no candidate: the scan never uses its
  // words, so they are not made
  if (!s_any) return;
  const int i = w * kWarp + lane;  // this lane's column
  const Box col = s_cols[lane];
  uint32_t mine = 0;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int jj = warp * kRowsPerWarp + r;
    const int j = rt * kWarp + jj;
    const bool hit =
        i > j && i < k && overlap(s_rows[jj], col, ios != 0) > thr;
    const uint32_t bits = __ballot_sync(kFull, hit);
    mine = lane == r ? bits : mine;
  }
  if (lane < kRowsPerWarp)
    fm[(size_t)w * kpad + rt * kWarp + warp * kRowsPerWarp + lane] = mine;
}

// Rows 32 c .. 32 c + 31 of word w (one 128-byte line), or zeros where the
// lane has no such word right of the chunk.
__device__ __forceinline__ void load_rows(uint4 (&rows)[kWarp / 4],
                                          const uint32_t* fm, int kpad,
                                          int words, int w, int c) {
  const bool on = w > c && w < words;
  const uint4* line =
      reinterpret_cast<const uint4*>(fm + (size_t)w * kpad + c * kWarp);
#pragma unroll
  for (int q = 0; q < kWarp / 4; ++q)
    rows[q] = on ? line[q] : make_uint4(0u, 0u, 0u, 0u);
}

// The OR of the rows whose bit is set in keep.
__device__ __forceinline__ uint32_t or_kept(const uint4 (&rows)[kWarp / 4],
                                            uint32_t keep) {
  uint32_t acc = 0u;
#pragma unroll
  for (int q = 0; q < kWarp / 4; ++q) {
    const int t = 4 * q;
    acc |= ((keep >> t) & 1u) ? rows[q].x : 0u;
    acc |= ((keep >> (t + 1)) & 1u) ? rows[q].y : 0u;
    acc |= ((keep >> (t + 2)) & 1u) ? rows[q].z : 0u;
    acc |= ((keep >> (t + 3)) & 1u) ? rows[q].w : 0u;
  }
  return acc;
}

__global__ void __launch_bounds__(kWarp)
scan_kernel(int k, int words, const uint32_t* __restrict__ mask,
            const uint8_t* __restrict__ valid, uint8_t* __restrict__ kept) {
  __shared__ uint32_t removed[kMaxWords], cands[kMaxWords];
  const int lane = threadIdx.x, frame = blockIdx.x;
  const int kpad = words * kWarp;
  const uint32_t* fm = mask + (size_t)frame * words * kpad;
  const uint8_t* fv = valid + (size_t)frame * k;
  uint8_t* fk = kept + (size_t)frame * k;
  // every chunk's valid bits at once: lane l reads the 32 bytes of chunks
  // l, l + 32, ..., all loads in flight together
  for (int w = lane; w < words; w += kWarp) {
    uint32_t bits = 0u;
#pragma unroll
    for (int t = 0; t < kWarp; ++t) {
      const int i = w * kWarp + t;
      bits |= (i < k && fv[i] != 0) ? 1u << t : 0u;
    }
    cands[w] = bits;
    removed[w] = 0u;
  }
  __syncwarp();
  for (int c = 0; c < words; ++c) {
    const int i = c * kWarp + lane;
    uint32_t keep = 0u;
    uint32_t todo = cands[c] & ~removed[c];
    // a chunk with no candidate standing keeps none and removes nothing:
    // it costs no load (every lane reads the same words, so the branch and
    // the warp's shuffles below are uniform)
    if (todo != 0u) {
      const uint32_t here = i < k ? fm[(size_t)c * kpad + i] : 0u;
      uint4 rows[kWarp / 4];
      load_rows(rows, fm, kpad, words, lane, c);
      // the scan of the chunk, lowest index first
      uint32_t gone = removed[c];
      while (todo != 0u) {
        const int t = __ffs((int)todo) - 1;
        keep |= 1u << t;
        gone |= __shfl_sync(kFull, here, t);  // only later bits of the chunk
        todo = cands[c] & ~gone & ~((2u << t) - 1u);
      }
      // the kept rows of the chunk remove what they overlap in later
      // words: the lane's first word from the line loaded with the
      // diagonal words, its further words (past 32 words, K > 1024) here
      if (lane > c && lane < words) removed[lane] |= or_kept(rows, keep);
      for (int w = lane + kWarp; w < words; w += kWarp) {
        if (w <= c) continue;
        load_rows(rows, fm, kpad, words, w, c);
        removed[w] |= or_kept(rows, keep);
      }
    }
    if (i < k) fk[i] = (uint8_t)((keep >> lane) & 1u);
    __syncwarp();
  }
}

}  // namespace

// batch frames of k score-ordered candidates: boxes (batch, k, 4) f32 xyxy,
// already shifted by class, valid (batch, k) bool as bytes, both
// contiguous; thr the f32 threshold; ios 0 for IoU, 1 for intersection
// over the smaller area; mask a scratch of batch x W x 32 W uint32
// (W = ceil(k / 32)), 16-byte aligned; writes kept (batch, k) as bytes
// 0 or 1. Two launches on `stream`. Returns the first launch error (0 on
// success).
extern "C" int aicam_nms_keep(int batch, int k, const void* boxes,
                              const void* valid, float thr, int ios,
                              void* mask, void* kept, void* stream) {
  if (batch < 1 || batch > 65535 || k < 1 || k > kMaxK ||
      ((uintptr_t)mask & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  const int words = (k + kWarp - 1) / kWarp;
  const dim3 grid(words * (words + 1) / 2, batch);
  mask_kernel<<<grid, kMaskThreads, 0, (cudaStream_t)stream>>>(
      k, words, (const float*)boxes, (const uint8_t*)valid, thr, ios,
      (uint32_t*)mask);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_kernel<<<batch, kWarp, 0, (cudaStream_t)stream>>>(
      k, words, (const uint32_t*)mask, (const uint8_t*)valid,
      (uint8_t*)kept);
  return (int)cudaGetLastError();
}

// The largest k the kernel takes.
extern "C" int aicam_nms_max_k() { return kMaxK; }
