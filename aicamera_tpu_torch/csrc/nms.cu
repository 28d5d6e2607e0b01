// The greedy-NMS tail for Hopper (sm_90a): class shift, greedy keep and
// emit of every frame of a batch in one launch, nothing read back.
//
// Replaces the JAX package's device loop, an XLA while-loop, not Pallas,
// and the jitted program around it: aicamera_tpu/ops/nms.py's
// _suppress_and_emit (:90), the class shift (:108), _greedy_keep (:36, its
// lax.while_loop at :66) over the overlap at :109, and the emit of the
// first max_det kept candidates (:112-125). Over K score-ordered
// candidates of a frame the keep is the sequential greedy scan: kept[i] =
// valid[i] and no kept j < i overlaps i by more than the threshold. JAX
// iterates the fixpoint with a (K, K) matvec a step until it stops
// changing; here the scan runs in index order, once.
//
// What it computes is the plain PyTorch version's
// (aicamera_tpu_torch/ops/nms.py: suppress_and_emit_plain, _greedy_keep
// over _pairwise_iou_xyxy or _pairwise_ios_xyxy), bit for bit:
// - the shift is box + float(cls) * class_offset, two rounded f32
//   operations, as k_boxes + (k_cls.float() * class_offset)[..., None];
// - each pair's overlap is the same sequence of rounded f32 operations as
//   there: areas first, then the intersection, then (area_j + area_i) -
//   inter (IoU) or min(area_j, area_i) (IoS), clamped below at 1e-7; then
//   the quotient's test `> thr`, with the threshold as the f32 the plain
//   version compares against: v1 divides, the one-launch design decides
//   the rounded quotient's comparison exactly without dividing (exceeds).
//   The file is built with --fmad=false (ops/nms.py), so that no product
//   is fused into the sum beside it, as PyTorch's separate kernels round
//   each operation. max, min and clamp give NaN where torch.maximum,
//   torch.minimum and torch.clamp do, so a NaN or infinite box overlaps
//   nothing, as there;
// - the emit writes the kept candidates whose score is above 0, in index
//   order, to slots 0, 1, ...: slot s of a frame gets the s-th such
//   candidate's unshifted box, score and class while s < max_det, and
//   every other slot zeros; num = min(their count, max_det). This is the
//   plain version's stable top-k of where(kept, score, -1) under one
//   precondition, which the JAX package's docstring states too: the
//   scores do not increase along K (fused_decode_nms sorts them with a
//   stable top-k, merge_detections fully by score). Then the kept
//   candidates' scores, in index order, are the stable descending order.
//
// Design (aicam_nms_emit): one block of kEmitWarps (16) warps a frame, on
// the caller's stream.
// - Stage. Thread 0 posts one asynchronous bulk copy (the TMA's
//   cp.async.bulk, completing on an mbarrier in shared memory) of the
//   first tile's boxes, scores and classes into shared memory; the copy's
//   ragged ends off the 16-byte grid go by plain loads. While it is in
//   flight the other warps read the frame's valid bytes from global memory
//   into words of valid bits, and a block reduction gives n, one past the
//   last valid candidate: nothing past n is shifted, compared or scanned.
//   Each candidate's shifted box and area are computed once, into shared
//   memory (float4 and float), beside the words of positive scores.
// - Diagonal. The whole block computes every chunk's column words at once:
//   for lane i of a 32-candidate chunk, the candidates j < i of its chunk
//   that overlap it (kDiagRows rows an item, an atomicOr a lane).
// - Scan, a step a chunk c, in order, all in shared memory, one block
//   barrier a step. Every warp resolves chunk c from its standing
//   candidates (valid and not removed) and its column words: the greedy
//   keep is the unique fixpoint of kept[i] = stands[i] and no kept j in
//   column i, and Jacobi rounds reach it, a ballot a round (bit i is final
//   after i + 1 rounds; a crowded chunk takes a few). Then the warps share
//   the chunk's later words of the tile, a word a warp: every kept row of
//   the chunk against the word's standing candidates, kRowGroup rows at a
//   time, their overlaps independent, a ballot ORed into the word's
//   removed bits. No mask is written to global memory and the wrapper
//   allocates no scratch.
// - Emit. An exclusive prefix over the popcounts of the tile's emitted
//   words (kept and score above 0) gives each such candidate its slot; it
//   writes its box, score and class from the staged copy. Then the slots
//   past the last are zeroed, num written, and the kept bits stored as
//   bytes.
// - Any K up to kMaxK (16384) takes this one path: the candidates go
//   through shared memory a tile of up to kTile (2048) at a time. After a
//   tile is scanned and emitted, its kept rows are held against each later
//   tile, staged in turn into a second buffer, before the next tile is
//   scanned. At K <= kTile (every detect path: 300, 500) a frame is one
//   tile.
// - The threshold test (exceeds) decides the rounded quotient against thr
//   exactly, without the division: see there.
// Measured on the card (chip_smoke.py's [nms] phase probe), a resolve by
// the first design's scan order, a candidate at a time, cost ~1,500 cycles
// a crowded step, and the division's branch kept a lane's overlaps in
// sequence; the ballots and the branch-free test replaced them.
//
// No tensor cores: the work is comparisons, products of two numbers and
// one double-precision product a pair, not a matrix product. What the
// design takes from Hopper is the asynchronous bulk copy, its barrier and
// the shared memory.
//
// Bound: latency. The tail needs only a frame's n valid candidates: their
// n x 24 bytes of boxes, scores and classes, the K valid bytes read, the K
// kept bytes and max_det x 24 output bytes written, n shifts and areas and
// n (n - 1) / 2 pair overlaps of ~14 operations each. The main path's
// frames hold ~5 valid candidates, so its chunk of 8 is ~25 KB of mostly
// output and ~2,000 operations, far below an empty kernel's replay (about
// 1.1 us). What a call costs is one launch and a chain: the first global
// round trip (the valid bytes, with the copy in flight), a few block
// barriers, and a step a chunk (a resolve, then a word's overlaps).
// The main path's frames hold all their valid candidates in the first
// chunk (valid is a prefix of the score order): one step.
//
// v1 (aicam_nms_keep), the first design, kept for measurements and tests
// on no path: the keep alone of already shifted boxes, two launches.
// - mask: a block of 4 warps for one (32-row tile, 32-column word) pair of
//   a frame at or right of the diagonal, so a frame of K = 300 is 55
//   blocks; lane l holds column i = 32 w + l, takes its warp's 8 rows j in
//   turn and votes `i > j and overlap(j, i) > thr` with __ballot_sync. The
//   mask is (B, W, 32 W) uint32, W = ceil(K / 32), word-major, in a scratch
//   the wrapper allocates; a tile with no valid row makes no words.
// - scan: one warp a frame walks the chunks of 32 candidates in order; a
//   chunk with a candidate standing loads its diagonal words and each
//   lane's later words (one L2 round trip a chunk) and ORs the chunk's kept
//   rows into the removed words.
// chip_smoke.py's [nms] phase times both against the bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cfloat>
#include <cmath>
#include <cstring>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxK = 16384;                  // the wrapper's limit
constexpr int kMaxWords = kMaxK / kWarp;
constexpr unsigned kFull = 0xffffffffu;

// the one-launch design
constexpr int kEmitWarps = 16;                // warps a block (a frame)
constexpr int kEmitThreads = kEmitWarps * kWarp;
// candidates a tile, at most; a build option only so that the tests can
// take frames of several tiles at small K
#ifndef AICAM_NMS_TILE
#define AICAM_NMS_TILE 2048
#endif
constexpr int kTile = AICAM_NMS_TILE;
constexpr int kTileWords = 2 * kWarp;         // a tile's words, at most
static_assert(kTile % kWarp == 0 && kTile <= kTileWords * kWarp,
              "a tile is whole words, at most 64");
constexpr int kRowGroup = 8;                  // kept rows at a time, a tile
constexpr int kStreamGroup = 32;              // kept rows an item, later tiles
constexpr int kDiagRows = 4;                  // diagonal rows an item

// v1
constexpr int kMaskWarps = 4;                 // mask: warps a block
constexpr int kMaskThreads = kMaskWarps * kWarp;
constexpr int kRowsPerWarp = kWarp / kMaskWarps;  // a tile's rows a warp

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

// A box and its area as the plain version computes it: clamp(x2 - x1, 0)
// * clamp(y2 - y1, 0).
__device__ __forceinline__ Box make_box(float x1, float y1, float x2,
                                        float y2) {
  Box b{x1, y1, x2, y2, 0.0f};
  b.area = clamp_min(x2 - x1, 0.0f) * clamp_min(y2 - y1, 0.0f);
  return b;
}

// Candidate i of a frame (zeros past k).
__device__ __forceinline__ Box load_box(const float* frame, int i, int k) {
  if (i >= k) return Box{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  return make_box(frame[4 * i + 0], frame[4 * i + 1], frame[4 * i + 2],
                  frame[4 * i + 3]);
}

// The overlap of row box a (candidate j) with column box b (candidate i),
// in _pairwise_iou_xyxy's and _pairwise_ios_xyxy's operation order (v1).
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

// --- Hopper primitives: dynamic shared memory, the mbarrier, the bulk copy
// (the tests' CPU emulation, tests/data/cuda_emulation.h, supplies its own)
#ifndef AICAM_CPU_EMULATION
__device__ __forceinline__ uint8_t* dynamic_smem() {
  extern __shared__ __align__(16) uint8_t smem[];
  return smem;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbarrier_init(uint64_t* bar, uint32_t n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(n)
               : "memory");
}

// the barrier's initialisation, visible to the asynchronous proxy
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the block's earlier accesses to shared memory, ordered before the
// asynchronous proxy's
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbarrier_arrive_expect_tx(uint64_t* bar,
                                                          uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar
__device__ __forceinline__ void cp_async_bulk_g2s(void* dst, const void* src,
                                                  uint32_t bytes,
                                                  uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbarrier_wait_parity(uint64_t* bar,
                                                     uint32_t parity) {
  uint32_t done = 0u;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
// max and min that give NaN where either input is NaN (sm_80's max.NaN):
// the NaN-keeping max_nan and min_nan in one instruction each. A NaN's
// payload and a zero's sign may differ from theirs; neither reaches a
// threshold test's outcome (a NaN compares false, +-0 compare equal, and a
// zero intersection or area is clamped the same either way).
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float fmin_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
#endif  // AICAM_CPU_EMULATION

// The threshold test of the one-launch design: overlap > thr as the plain
// version decides it, f32(inter / den) > thr with the quotient rounded to
// the nearest f32 (ties to even), decided without the division. Rounding
// is monotone, so the rounded quotient exceeds thr exactly when the exact
// quotient q = inter / den exceeds mid, the midpoint of thr and the next
// f32 above it, or equals mid and the tie rounds up (tie_up: the next f32
// is the even one). den is at least 1e-7, +inf or NaN, so q > mid is inter
// > mid * den, compared in double: mid has at most 25 significant bits and
// den 24, so the product is exact, and NaN compares false as there. thr
// NaN or +inf: mid NaN, never. The operations before the quotient are the
// plain version's, in its order (max and min as fmax_nan and fmin_nan,
// clamp(v, lo) as fmax_nan(v, lo)). No branch: a lane's overlaps of
// several rows interleave (a division's slow-path branch kept them apart,
// and took ~270 cycles for a zero dividend, most pairs of a crowded frame).
struct ThrTest {
  double mid;
  int tie_up;
};

__device__ __forceinline__ bool exceeds(float4 a, float area_a, float4 b,
                                        float area_b, bool ios,
                                        const ThrTest& t) {
  const float ix1 = fmax_nan(a.x, b.x);
  const float iy1 = fmax_nan(a.y, b.y);
  const float ix2 = fmin_nan(a.z, b.z);
  const float iy2 = fmin_nan(a.w, b.w);
  const float inter =
      fmax_nan(ix2 - ix1, 0.0f) * fmax_nan(iy2 - iy1, 0.0f);
  const float den = fmax_nan(
      ios ? fmin_nan(area_a, area_b) : (area_a + area_b) - inter, 1e-7f);
  const double x = (double)inter, p = t.mid * (double)den;
  return (x > p) | ((t.tie_up != 0) & (x == p) & (fabs(p) < INFINITY));
}

// --- the phase probe of the one-launch design (-DAICAM_NMS_PROBE) -----------
// Thread 0's clock: mark(slot) adds the cycles since the last mark to slot;
// the items and steps are counted by every warp's lane 0.
enum ProbeSlot {
  kPrBlocks, kPrStage, kPrCount, kPrShift, kPrDiag, kPrWait, kPrResolve,
  kPrItems, kPrEmit, kPrStream, kPrTail, kPrTotal, kPrSteps, kPrDiagItems,
  kPrOrItems, kPrSlots
};

#ifdef AICAM_NMS_PROBE
__device__ unsigned long long g_probe[kPrSlots];

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
  __device__ void count(int slot) {
    if (threadIdx.x % kWarp == 0) atomicAdd(&g_probe[slot], 1ull);
  }
  __device__ void finish() {
    mark(kPrTail);
    if (threadIdx.x == 0) {
      atomicAdd(&g_probe[kPrTotal], (unsigned long long)(t - t0));
      atomicAdd(&g_probe[kPrBlocks], 1ull);
    }
  }
};
#else
struct Probe {
  __device__ void mark(int) {}
  __device__ void count(int) {}
  __device__ void finish() {}
};
#endif

// --- the one-launch design ---------------------------------------------------

// Byte offsets of a launch's dynamic shared memory for frames of k
// candidates: a tile's staged boxes, scores and classes (each 16 bytes
// over, so that a copy keeps its source's place on the 16-byte grid), the
// tile's shifted boxes and their areas (rows) and, where a frame is more
// than one tile, a second tile's (cols) and the tile's kept rows as a
// list.
struct Layout {
  int tile, boxes, scores, cls, rows, row_areas, cols, col_areas, klist,
      bytes;
};

__host__ __device__ inline Layout layout_of(int k) {
  Layout l;
  const int k32 = (k + kWarp - 1) / kWarp * kWarp;
  l.tile = k32 < kTile ? k32 : kTile;
  const int later = k > l.tile ? l.tile : 0;  // a second tile's room
  int at = 0;
  l.boxes = at;
  at += l.tile * 16 + 16;
  l.scores = at;
  at += l.tile * 4 + 16;
  l.cls = at;
  at += l.tile * 4 + 16;
  l.rows = at;
  at += l.tile * 16;
  l.row_areas = at;
  at += l.tile * 4;
  l.cols = at;
  at += later * 16;
  l.col_areas = at;
  at += later * 4;
  l.klist = at;
  at += later * 4;
  l.bytes = at;
  return l;
}

// A piece of one staging copy: bytes from global src to shared memory at
// base + (src mod 16), so that the two agree on the 16-byte grid.
struct Piece {
  uint8_t* dst;
  const uint8_t* src;
  uint32_t bytes;
};

__device__ __forceinline__ Piece piece(uint8_t* base, const void* src,
                                       uint32_t bytes) {
  const uint8_t* s = (const uint8_t*)src;
  return Piece{base + ((uintptr_t)s & 15u), s, bytes};
}

// The piece's part on the 16-byte grid, [lo, hi), for the bulk copy.
__device__ __forceinline__ void bulk_part(const Piece& p, uint32_t& lo,
                                          uint32_t& hi) {
  const uint32_t head = (16u - ((uintptr_t)p.src & 15u)) & 15u;
  lo = head < p.bytes ? head : p.bytes;
  hi = lo + ((p.bytes - lo) & ~15u);
}

// Issues the staging copy of the pieces: thread 0 posts the bytes the
// barrier waits for and issues one bulk copy a piece; the threads copy the
// ragged ends byte by byte. A thread may read the pieces once it has
// waited for the barrier's phase and a block barrier has followed the
// plain copies.
template <int N>
__device__ __forceinline__ void issue_stage(const Piece (&ps)[N],
                                            uint64_t* bar) {
  if (threadIdx.x == 0) {
    uint32_t total = 0u;
    for (int q = 0; q < N; ++q) {
      uint32_t lo, hi;
      bulk_part(ps[q], lo, hi);
      total += hi - lo;
    }
    fence_proxy_async();
    mbarrier_arrive_expect_tx(bar, total);
    for (int q = 0; q < N; ++q) {
      uint32_t lo, hi;
      bulk_part(ps[q], lo, hi);
      if (hi > lo) cp_async_bulk_g2s(ps[q].dst + lo, ps[q].src + lo, hi - lo,
                                     bar);
    }
  }
  for (int q = 0; q < N; ++q) {
    uint32_t lo, hi;
    bulk_part(ps[q], lo, hi);
    const uint32_t ends = lo + (ps[q].bytes - hi);
    for (uint32_t x = threadIdx.x; x < ends; x += kEmitThreads) {
      const uint32_t b = x < lo ? x : hi + (x - lo);
      ps[q].dst[b] = ps[q].src[b];
    }
  }
}

// Stages the pieces and waits for them; the leading block barrier frees
// the buffers.
template <int N>
__device__ __forceinline__ void stage(const Piece (&ps)[N], uint64_t* bar,
                                      uint32_t& phase) {
  __syncthreads();
  issue_stage(ps, bar);
  mbarrier_wait_parity(bar, phase);
  phase ^= 1u;
  __syncthreads();
}

// The shifted box of staged candidate j, box + float(cls) * offset, into
// out[j] and its area into area[j].
__device__ __forceinline__ void shift_box(const float* boxes, const int* cls,
                                          int j, float offset, float4* out,
                                          float* area) {
  const float shift = (float)cls[j] * offset;
  const Box b = make_box(boxes[4 * j + 0] + shift, boxes[4 * j + 1] + shift,
                         boxes[4 * j + 2] + shift, boxes[4 * j + 3] + shift);
  out[j] = make_float4(b.x1, b.y1, b.x2, b.y2);
  area[j] = b.area;
}

// Chunk c's keep, on every lane of a warp: lane i stands (valid, not
// removed) or not, and col holds the candidates j < i of the chunk that
// overlap it. The greedy keep is the unique fixpoint of kept[i] = stands[i]
// and no kept j in col; Jacobi iteration from the standing set reaches it
// (bit i is final after i + 1 rounds), a ballot a round, and stops at the
// first round that changes nothing: that round's set is the fixpoint.
__device__ __forceinline__ uint32_t resolve(uint32_t stand, uint32_t col) {
  const bool on = (stand >> (threadIdx.x % kWarp)) & 1u;
  uint32_t keep = stand;
  for (;;) {
    const uint32_t next = __ballot_sync(kFull, on && (col & keep) == 0u);
    if (next == keep) return keep;
    keep = next;
  }
}

// Warp 0 and warp 1 of the block: the exclusive prefix over a tile's cw
// words (cw <= kTileWords) of popc(a[w] & b[w]) into prefix, the total
// into *total.
__device__ __forceinline__ void word_prefix(const uint32_t* a,
                                            const uint32_t* b, int cw,
                                            uint32_t* prefix, int* total) {
  const int lane = threadIdx.x % kWarp;
  const int p0 = lane < cw ? __popc(a[lane] & b[lane]) : 0;
  const int p1 =
      lane + kWarp < cw ? __popc(a[lane + kWarp] & b[lane + kWarp]) : 0;
  int s0 = p0, s1 = p1;
  for (int d = 1; d < kWarp; d <<= 1) {
    const int u0 = __shfl_up_sync(kFull, s0, d);
    const int u1 = __shfl_up_sync(kFull, s1, d);
    if (lane >= d) {
      s0 += u0;
      s1 += u1;
    }
  }
  const int t0 = __shfl_sync(kFull, s0, kWarp - 1);
  const int t1 = __shfl_sync(kFull, s1, kWarp - 1);
  prefix[lane] = (uint32_t)(s0 - p0);
  prefix[lane + kWarp] = (uint32_t)(t0 + s1 - p1);
  if (lane == 0) *total = t0 + t1;
}

struct EmitArgs {
  int k;
  const float* boxes;      // (batch, k, 4) f32, unshifted
  const float* scores;     // (batch, k) f32, rows score_stride apart
  long long score_stride;
  const int* cls;          // (batch, k) int32
  const uint8_t* valid;    // (batch, k) bool as bytes
  float offset;
  ThrTest thr;
  int ios, max_det;
  int* num;                // (batch,) int32
  float* out_boxes;        // (batch, max_det, 4) f32
  float* out_scores;       // (batch, max_det) f32
  int* out_labels;         // (batch, max_det) int32
  uint8_t* kept;           // (batch, k) bool as bytes
};

__global__ void __launch_bounds__(kEmitThreads) emit_kernel(EmitArgs a) {
  __shared__ uint32_t cands[kMaxWords], removed[kMaxWords],
      keptw[kMaxWords];
  __shared__ uint32_t posw[kTileWords];         // a tile's scores above 0
  __shared__ uint32_t colw[kTileWords][kWarp];  // a tile's column words
  __shared__ uint32_t prefix[2][kTileWords];    // emitted, kept before a word
  __shared__ uint8_t kept_rows[kEmitWarps][kWarp];  // a chunk's, a warp's
  __shared__ int totals[2];
  __shared__ int last[kEmitWarps];
  __shared__ uint64_t bar;

  Probe pr;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int f = blockIdx.x, k = a.k;
  const Layout l = layout_of(k);
  uint8_t* sm = dynamic_smem();
  const float* fb = a.boxes + (size_t)f * k * 4;
  const float* fs = a.scores + (size_t)f * a.score_stride;
  const int* fc = a.cls + (size_t)f * k;
  const uint8_t* fv = a.valid + (size_t)f * k;
  const ThrTest thr = a.thr;
  const bool ios = a.ios != 0;
  float4* rows = (float4*)(sm + l.rows);
  float* row_areas = (float*)(sm + l.row_areas);
  float4* cols = (float4*)(sm + l.cols);
  float* col_areas = (float*)(sm + l.col_areas);
  int* klist = (int*)(sm + l.klist);

  // the first tile's boxes, scores and classes: one copy, issued first
  const int first = k < l.tile ? k : l.tile;
  const Piece batch0[3] = {
      piece(sm + l.boxes, fb, (uint32_t)first * 16u),
      piece(sm + l.scores, fs, (uint32_t)first * 4u),
      piece(sm + l.cls, fc, (uint32_t)first * 4u)};
  if (tid == 0) {
    mbarrier_init(&bar, 1u);
    fence_mbarrier_init();
  }
  issue_stage(batch0, &bar);

  // meanwhile the other warps find n, one past the last valid candidate,
  // and the valid words, from global memory
  const int words_k = (k + kWarp - 1) / kWarp;
  int mine = -1;
  for (int w = warp - 1; warp > 0 && w < words_k; w += kEmitWarps - 1) {
    const int i = w * kWarp + lane;
    const uint32_t bits = __ballot_sync(kFull, i < k && fv[i] != 0);
    if (bits != 0u) mine = w * kWarp + 31 - __clz((int)bits);
    if (lane == 0) {
      cands[w] = bits;
      removed[w] = 0u;
      keptw[w] = 0u;
    }
  }
  if (lane == 0) last[warp] = mine;
  __syncthreads();
  int n = 0;
  for (int q = 0; q < kEmitWarps; ++q) n = last[q] + 1 > n ? last[q] + 1 : n;
  pr.mark(kPrCount);
  mbarrier_wait_parity(&bar, 0u);
  uint32_t phase = 1u;
  pr.mark(kPrStage);

  int emitted = 0;  // candidates emitted by the tiles before, every thread
  for (int t0 = 0; t0 < n; t0 += l.tile) {
    const int cnt = n - t0 < l.tile ? n - t0 : l.tile;
    const int c0 = t0 / kWarp, cw = (cnt + kWarp - 1) / kWarp;
    if (t0 > 0) {
      const Piece ps[3] = {
          piece(sm + l.boxes, fb + (size_t)t0 * 4, (uint32_t)cnt * 16u),
          piece(sm + l.scores, fs + t0, (uint32_t)cnt * 4u),
          piece(sm + l.cls, fc + t0, (uint32_t)cnt * 4u)};
      stage(ps, &bar, phase);
    }
    // where the copy put the tile (its source's place on the 16-byte grid)
    const float* rb = (const float*)piece(sm + l.boxes, fb + (size_t)t0 * 4,
                                          0u).dst;
    const float* rs = (const float*)piece(sm + l.scores, fs + t0, 0u).dst;
    const int* rc = (const int*)piece(sm + l.cls, fc + t0, 0u).dst;

    // shifted boxes and areas, the words of scores above 0, column words
    // at 0
    for (int w = warp; w < cw; w += kEmitWarps) {
      const int j = w * kWarp + lane;
      if (j < cnt) shift_box(rb, rc, j, a.offset, rows, row_areas);
      const uint32_t pos = __ballot_sync(kFull, j < cnt && rs[j] > 0.0f);
      if (lane == 0) posw[w] = pos;
      colw[w][lane] = 0u;
    }
    __syncthreads();
    pr.mark(kPrShift);

    // every chunk's diagonal at once: rows j0 .. j0 + kDiagRows - 1 of a
    // chunk against its later candidates, into their column words (lane i:
    // the rows j < i of its chunk that overlap it)
    for (int q = warp; q < cw * (kWarp / kDiagRows); q += kEmitWarps) {
      const int wl = q / (kWarp / kDiagRows);
      const int j0 = q % (kWarp / kDiagRows) * kDiagRows;
      const uint32_t cand = cands[c0 + wl];
      if (((cand >> j0) & ((1u << kDiagRows) - 1u)) == 0u) continue;
      pr.count(kPrDiagItems);
      const bool on = (cand >> lane) & 1u;
      const float4 col = rows[wl * kWarp + lane];
      const float col_area = row_areas[wl * kWarp + lane];
      uint32_t bits = 0u;
#pragma unroll
      for (int r = 0; r < kDiagRows; ++r) {
        const int jj = j0 + r, j = wl * kWarp + jj;
        const bool hit = exceeds(rows[j], row_areas[j], col, col_area, ios,
                                 thr);
        bits |= (uint32_t)(on & (jj < lane) & ((cand >> jj) & 1u) & hit)
                << jj;
      }
      if (bits != 0u) atomicOr(&colw[wl][lane], bits);
    }
    pr.mark(kPrDiag);

    // the scan: step c resolves chunk c, then the block's warps share its
    // kept rows against the tile's later words, a word a warp
    for (int c = c0; c < c0 + cw; ++c) {
      __syncthreads();
      pr.mark(kPrWait);
      if (warp == 0) pr.count(kPrSteps);
      const uint32_t keep =
          resolve(cands[c] & ~removed[c], colw[c - c0][lane]);
      if (tid == 0) keptw[c] = keep;
      // the kept rows as a list, in this warp's own slot
      if ((keep >> lane) & 1u)
        kept_rows[warp][__popc(keep & ((1u << lane) - 1u))] =
            (uint8_t)lane;
      __syncwarp();
      pr.mark(kPrResolve);
      const int n_rows = __popc(keep);
      for (int w = c + 1 + warp; w < c0 + cw; w += kEmitWarps) {
        // every kept row of chunk c against word w, kRowGroup at a time: a
        // lane's overlaps in a group are independent
        pr.count(kPrOrItems);
        const bool standing = ((cands[w] & ~removed[w]) >> lane) & 1u;
        const int i = (w - c0) * kWarp + lane;
        const float4 col = rows[i];
        const float col_area = row_areas[i];
        bool hit = false;
        for (int r0 = 0; r0 < n_rows; r0 += kRowGroup) {
#pragma unroll
          for (int m = 0; m < kRowGroup; ++m) {
            const bool on = r0 + m < n_rows;
            const int j = (c - c0) * kWarp + kept_rows[warp][on ? r0 + m : 0];
            hit |= on &
                   exceeds(rows[j], row_areas[j], col, col_area, ios, thr);
          }
        }
        const uint32_t bits = __ballot_sync(kFull, standing && hit);
        if (lane == 0 && bits != 0u) atomicOr(&removed[w], bits);
      }
      pr.mark(kPrItems);
    }
    __syncthreads();
    pr.mark(kPrWait);

    // the emit: slots by an exclusive prefix over the emitted words; and,
    // where later tiles follow, the tile's kept rows as a list
    const bool more = t0 + l.tile < n;
    if (warp == 0)
      word_prefix(keptw + c0, posw, cw, prefix[0], &totals[0]);
    if (warp == 1 && more)
      word_prefix(keptw + c0, keptw + c0, cw, prefix[1], &totals[1]);
    __syncthreads();
    for (int j = tid; j < cnt; j += kEmitThreads) {
      const int w = j / kWarp, b = j % kWarp;
      const uint32_t kw = keptw[c0 + w];
      if (!((kw >> b) & 1u)) continue;
      const uint32_t below = (1u << b) - 1u;
      if (more) klist[prefix[1][w] + __popc(kw & below)] = j;
      const uint32_t ew = kw & posw[w];
      if (!((ew >> b) & 1u)) continue;
      const int slot = emitted + (int)prefix[0][w] + __popc(ew & below);
      if (slot >= a.max_det) continue;
      const size_t o = (size_t)f * a.max_det + slot;
      a.out_boxes[4 * o + 0] = rb[4 * j + 0];
      a.out_boxes[4 * o + 1] = rb[4 * j + 1];
      a.out_boxes[4 * o + 2] = rb[4 * j + 2];
      a.out_boxes[4 * o + 3] = rb[4 * j + 3];
      a.out_scores[o] = rs[j];
      a.out_labels[o] = rc[j];
    }
    emitted += totals[0];
    pr.mark(kPrEmit);
    if (!more) break;

    // the tile's kept rows against each later tile
    const int n_kept = totals[1];
    if (n_kept == 0) continue;
    const int sgroups = (n_kept + kStreamGroup - 1) / kStreamGroup;
    for (int u0 = t0 + l.tile; u0 < n; u0 += l.tile) {
      const int ucnt = n - u0 < l.tile ? n - u0 : l.tile;
      const int uw = (ucnt + kWarp - 1) / kWarp;
      const Piece ps[2] = {
          piece(sm + l.boxes, fb + (size_t)u0 * 4, (uint32_t)ucnt * 16u),
          piece(sm + l.cls, fc + u0, (uint32_t)ucnt * 4u)};
      stage(ps, &bar, phase);
      const float* ub = (const float*)ps[0].dst;
      const int* uc = (const int*)ps[1].dst;
      for (int j = tid; j < ucnt; j += kEmitThreads)
        shift_box(ub, uc, j, a.offset, cols, col_areas);
      __syncthreads();
      for (int q = warp; q < uw * sgroups; q += kEmitWarps) {
        const int wl = q / sgroups, g = q % sgroups;
        const int w = u0 / kWarp + wl;
        const bool standing = ((cands[w] & ~removed[w]) >> lane) & 1u;
        bool hit = false;
        if (standing) {
          const float4 col = cols[wl * kWarp + lane];
          const float col_area = col_areas[wl * kWarp + lane];
          const int r1 = (g + 1) * kStreamGroup < n_kept
                             ? (g + 1) * kStreamGroup : n_kept;
          for (int r = g * kStreamGroup; r < r1; ++r)
            hit |= exceeds(rows[klist[r]], row_areas[klist[r]], col,
                           col_area, ios, thr);
        }
        const uint32_t bits = __ballot_sync(kFull, hit);
        if (lane == 0 && bits != 0u) atomicOr(&removed[w], bits);
      }
    }
    pr.mark(kPrStream);
  }

  // the slots past the last, the count, the kept bytes
  const int total = emitted < a.max_det ? emitted : a.max_det;
  for (int s = total + tid; s < a.max_det; s += kEmitThreads) {
    const size_t o = (size_t)f * a.max_det + s;
    a.out_boxes[4 * o + 0] = 0.0f;
    a.out_boxes[4 * o + 1] = 0.0f;
    a.out_boxes[4 * o + 2] = 0.0f;
    a.out_boxes[4 * o + 3] = 0.0f;
    a.out_scores[o] = 0.0f;
    a.out_labels[o] = 0;
  }
  if (tid == 0) a.num[f] = total;
  uint8_t* fk = a.kept + (size_t)f * k;
  for (int i = tid; i < k; i += kEmitThreads)
    fk[i] = (uint8_t)((keptw[i / kWarp] >> (i % kWarp)) & 1u);
  pr.finish();
}

// The threshold test of thr (ThrTest), on the host.
ThrTest thr_test(float thr) {
  ThrTest t{NAN, 0};
  if (std::isnan(thr) || thr == INFINITY) return t;  // never exceeded
  const float up = std::nextafterf(thr, INFINITY);
  // past FLT_MAX the next "f32" is 2^128: from FLT_MAX + half an ulp on,
  // a quotient rounds to +inf, and at the tie too (FLT_MAX is odd)
  const double next = thr == FLT_MAX ? std::ldexp(1.0, 128) : (double)up;
  uint32_t bits;
  std::memcpy(&bits, &up, sizeof bits);
  t.mid = ((double)thr + next) * 0.5;  // exact: adjacent f32s
  t.tie_up = thr == FLT_MAX || (bits & 1u) == 0u;
  return t;
}

// --- v1: the first design (keep only, two launches) -------------------------

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

// The one-launch tail. batch frames of k score-ordered candidates (scores
// not increasing along k): boxes (batch, k, 4) f32 xyxy unshifted, scores
// (batch, k) f32 with rows score_stride floats apart, cls (batch, k) int32
// and valid (batch, k) bool as bytes, contiguous; offset the class offset
// and thr the threshold as f32; ios 0 for IoU, 1 for intersection over the
// smaller area; max_det >= 0 output slots. Writes num (batch,) int32,
// out_boxes (batch, max_det, 4) f32, out_scores (batch, max_det) f32,
// out_labels (batch, max_det) int32 and kept (batch, k) as bytes 0 or 1.
// One launch on `stream`. Returns the launch error (0 on success).
extern "C" int aicam_nms_emit(int batch, int k, const void* boxes,
                              const void* scores, long long score_stride,
                              const void* cls, const void* valid,
                              float offset, float thr, int ios, int max_det,
                              void* num, void* out_boxes, void* out_scores,
                              void* out_labels, void* kept, void* stream) {
  if (batch < 1 || batch > 65535 || k < 1 || k > kMaxK || max_det < 0 ||
      score_stride < 0 || ((uintptr_t)boxes & 3u) != 0 ||
      ((uintptr_t)scores & 3u) != 0 || ((uintptr_t)cls & 3u) != 0)
    return (int)cudaErrorInvalidValue;
  const Layout l = layout_of(k);
  if (l.bytes > 32 * 1024) {  // past 48 KB with the static arrays
    const cudaError_t e = cudaFuncSetAttribute(
        emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.bytes);
    if (e != cudaSuccess) return (int)e;
  }
  EmitArgs a;
  a.k = k;
  a.boxes = (const float*)boxes;
  a.scores = (const float*)scores;
  a.score_stride = score_stride;
  a.cls = (const int*)cls;
  a.valid = (const uint8_t*)valid;
  a.offset = offset;
  a.thr = thr_test(thr);
  a.ios = ios;
  a.max_det = max_det;
  a.num = (int*)num;
  a.out_boxes = (float*)out_boxes;
  a.out_scores = (float*)out_scores;
  a.out_labels = (int*)out_labels;
  a.kept = (uint8_t*)kept;
  emit_kernel<<<batch, kEmitThreads, l.bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// v1: batch frames of k score-ordered candidates: boxes (batch, k, 4) f32 xyxy,
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

#ifdef AICAM_NMS_PROBE
// The probe's sums since the last reset (kPrSlots of them) into out;
// reset zeroes them. Synchronous. Returns the slots copied (-1 on error).
extern "C" int aicam_nms_probe(unsigned long long* out, int reset) {
  if (cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe)) != cudaSuccess)
    return -1;
  if (reset) {
    unsigned long long zero[kPrSlots] = {};
    if (cudaMemcpyToSymbol(g_probe, zero, sizeof(zero)) != cudaSuccess)
      return -1;
  }
  return kPrSlots;
}
#endif

// The largest k the kernels take.
extern "C" int aicam_nms_max_k() { return kMaxK; }
