// Greedy non-maximum suppression over score-sorted boxes (RoI Selection).
//
// Replaces the TPU kernel `_nms_kernel` / `nms_sorted` in
// src/repro/kernels/nms.py (pallas_call at :64), which `nms` (:75) calls
// on the score-descending order of the candidates.
//
// boxes (N, 4) f32 xyxy, sorted by descending score; valid (N,) bool
// (score above the score threshold) -> keep (N,) bool. Walking i = 0..N-1:
//   alive    = keep[i] & valid[i]
//   suppress = iou(i, j) > thr & j > i & alive
//   keep    &= ~suppress
// with iou = union > 0 ? inter / union : 0, union = area_j + area_i - inter.
// So keep[j] = valid[j] and no kept i < j has iou(i, j) > thr.
//
// Bound on the card: neither bytes (8192 boxes are 128 KB) nor operations
// (one IoU row per kept box, ~13 flops an entry): the greedy walk is a
// serial chain. The design moves the N^2 / 2 IoUs off the chain and leaves
// it N / 64 steps long, all in one launch:
//   * the mask phase: CTAs of 256 threads over 64 x 64 tiles of (i, j),
//     four row blocks of one column block a CTA, the CTAs wholly below the
//     diagonal returning at once. A thread takes one valid row i and writes
//     one 64-bit word: bit j of mask[i][j / 64] is set iff j > i and
//     iou(i, j) > thr. Rows of invalid boxes are skipped (they never
//     suppress), and words below the diagonal are never written or read;
//   * the reduce: the last mask CTA to finish (a per-device counter, 0 on
//     entry and left 0, as decode.cu merges its splits) walks the column
//     blocks c = 0, 1, ... with the removed set in shared memory. Warp 0
//     resolves block c in registers: lane l holds the diagonal words of
//     candidates l and l + 32 (block c + 1's are loaded while c resolves),
//     and the kept set K is iterated to its fixpoint
//       K = valid & ~removed[c] & ~OR{diag[k] : k in K},
//     which is the greedy order's result (bit j of diag[k] needs k < j, so
//     the first t candidates are right after t rounds) in as many rounds as
//     the block's longest chain of suppressions. Then the CTA ORs the kept
//     rows' words for the later blocks into the removed set, each thread
//     owning a column and a share of the kept rows, its loads in flight
//     (ORs commute);
//   * the IoU rounds every product, sum and quotient on its own
//     (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, never contracted to
//     an FMA), as the plain version's separate ops round: a pair whose IoU
//     sits at the threshold must fall the same way on both, since the keep
//     mask is compared exactly.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowBlocks = kThreads / 64;  // row blocks of a mask CTA
constexpr int kMaxWords = 128;             // 8192 boxes
constexpr int kOrBatch = 8;                // loads a thread holds in flight

using u64 = unsigned long long;

__device__ __forceinline__ float rn_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float rn_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float rn_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rn_div(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ float area_of(float4 b) {
  return rn_mul(fmaxf(rn_sub(b.z, b.x), 0.f), fmaxf(rn_sub(b.w, b.y), 0.f));
}

// OR of v over the warp's lanes
__device__ __forceinline__ u64 warp_or(u64 v) {
  const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(v));
  const unsigned hi = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(v >> 32));
  return (static_cast<u64>(hi) << 32) | lo;
}

// Resolve block c in warp 0: lane l holds d0 / d1, the diagonal words of
// candidates l and l + 32. The kept set goes to keptw[c] and its indices,
// in order, to kept_idx.
__device__ __forceinline__ void resolve(int c, u64 d0, u64 d1, const u64* validw,
                                        const u64* removed, u64* keptw,
                                        int* kept_idx) {
  const int lane = threadIdx.x & 31;
  const u64 cand = validw[c] & ~removed[c];
  u64 kept = cand, prev;
  do {  // to the fixpoint: at most one round per link of a chain
    prev = kept;
    const u64 sup = ((prev >> lane & 1) ? d0 : 0) | ((prev >> (lane + 32) & 1) ? d1 : 0);
    kept = cand & ~warp_or(sup);
  } while (kept != prev);
  if (lane == 0) keptw[c] = kept;
  const u64 below = (1ull << lane) - 1;
  if (kept >> lane & 1) kept_idx[__popcll(kept & below)] = lane;
  if (kept >> (lane + 32) & 1)
    kept_idx[__popcll(kept & ((below << 32) | 0xffffffffull))] = lane + 32;
}

// The kept rows of block c: their words for blocks c + 1 .. W - 1 ORed
// into the removed set. Thread t owns column c + 1 + t % cols and ORs the
// kept rows g, g + G, ... (g = t / cols, G = kThreads / cols) in registers,
// all its loads in flight; the G partials of a column meet in shared
// memory (32-bit ORs, which commute).
__device__ __forceinline__ void or_later(int c, int W, const u64* mask,
                                         const u64* keptw, const int* kept_idx,
                                         u64* removed) {
  const int cols = W - 1 - c, tid = threadIdx.x;  // cols < W <= kThreads
  if (cols == 0) return;
  const int groups = kThreads / cols, col = tid % cols, g = tid / cols;
  if (g >= groups) return;
  const int nk = __popcll(keptw[c]);
  const u64* m = mask + static_cast<int64_t>(c) * 64 * W + c + 1 + col;
  u64 acc = 0;
  for (int q0 = g; q0 < nk; q0 += groups * kOrBatch) {
    u64 w[kOrBatch];
#pragma unroll
    for (int u = 0; u < kOrBatch; ++u) {
      const int q = q0 + u * groups;
      w[u] = q < nk ? __ldcg(m + static_cast<int64_t>(kept_idx[q]) * W) : 0;
    }
#pragma unroll
    for (int u = 0; u < kOrBatch; ++u) acc |= w[u];
  }
  unsigned* r = reinterpret_cast<unsigned*>(removed + c + 1 + col);
  if (static_cast<unsigned>(acc)) atomicOr(r, static_cast<unsigned>(acc));
  if (acc >> 32) atomicOr(r + 1, static_cast<unsigned>(acc >> 32));
}

// The greedy pass over the mask, by the last CTA (all kThreads threads).
// Warp 0 resolves block c while the diagonal words of block c + 1 are in
// flight (the loop is unrolled by two, so the prefetch lands in the other
// pair of registers and nothing waits on it before the next block).
__device__ void reduce(const unsigned char* __restrict__ valid,
                       unsigned char* __restrict__ keep, const u64* mask,
                       int n, int W) {
  __shared__ u64 removed[kMaxWords], validw[kMaxWords], keptw[kMaxWords];
  __shared__ int kept_idx[64];
  const int tid = threadIdx.x, lane = tid & 31;
  for (int w = tid; w < W; w += kThreads) removed[w] = 0;
  for (int b = 0; b < W * 64; b += kThreads) {  // uniform: every lane ballots
    const int i = b + tid;
    const unsigned v = __ballot_sync(0xffffffffu, i < n && valid[i]);
    if (lane == 0 && i < W * 64) reinterpret_cast<unsigned*>(validw)[i / 32] = v;
  }
  __syncthreads();
  auto diag = [&](int c, int k) -> u64 {
    const int i = c * 64 + k;
    return c < W && (validw[c] >> k & 1)
               ? __ldcg(mask + static_cast<int64_t>(i) * W + c) : 0;
  };
  u64 a0 = 0, a1 = 0, b0 = 0, b1 = 0;
  if (tid < 32) {
    a0 = diag(0, lane);
    a1 = diag(0, lane + 32);
  }
  for (int c = 0; c < W; c += 2) {
    if (tid < 32) {
      b0 = diag(c + 1, lane);
      b1 = diag(c + 1, lane + 32);
      resolve(c, a0, a1, validw, removed, keptw, kept_idx);
    }
    __syncthreads();
    or_later(c, W, mask, keptw, kept_idx, removed);
    __syncthreads();
    if (c + 1 == W) break;
    if (tid < 32) {
      a0 = diag(c + 2, lane);
      a1 = diag(c + 2, lane + 32);
      resolve(c + 1, b0, b1, validw, removed, keptw, kept_idx);
    }
    __syncthreads();
    or_later(c + 1, W, mask, keptw, kept_idx, removed);
    __syncthreads();
  }
  for (int j = tid; j < n; j += kThreads) keep[j] = keptw[j >> 6] >> (j & 63) & 1;
}

__global__ void __launch_bounds__(kThreads)
    nms_kernel(const float* __restrict__ boxes,
               const unsigned char* __restrict__ valid,
               unsigned char* __restrict__ keep, u64* mask, int* counter,
               int n, float thr) {
  const int W = (n + 63) / 64;
  const int bj = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  if (g * kRowBlocks > bj) return;  // wholly below the diagonal
  __shared__ float x1[64], y1[64], x2[64], y2[64], area[64];
  if (tid < 64) {
    const int j = bj * 64 + tid;
    if (j < n) {
      const float4 b = reinterpret_cast<const float4*>(boxes)[j];
      x1[tid] = b.x;
      y1[tid] = b.y;
      x2[tid] = b.z;
      y2[tid] = b.w;
      area[tid] = area_of(b);
    }
  }
  const int rb = g * kRowBlocks + tid / 64, t = tid & 63;
  const int i = rb * 64 + t;
  const bool row = rb <= bj && i < n && valid[i];
  float4 bi = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row) bi = reinterpret_cast<const float4*>(boxes)[i];
  __syncthreads();
  if (row) {
    const float ai = area_of(bi);
    const int jn = min(64, n - bj * 64);
    u64 word = 0;
    for (int jj = rb == bj ? t + 1 : 0; jj < jn; ++jj) {
      const float iw = fmaxf(rn_sub(fminf(x2[jj], bi.z), fmaxf(x1[jj], bi.x)), 0.f);
      const float ih = fmaxf(rn_sub(fminf(y2[jj], bi.w), fmaxf(y1[jj], bi.y)), 0.f);
      const float inter = rn_mul(iw, ih);
      const float uni = rn_sub(rn_add(area[jj], ai), inter);
      const float iou = uni > 0.f ? rn_div(inter, uni) : 0.f;
      if (iou > thr) word |= 1ull << jj;
    }
    mask[static_cast<int64_t>(i) * W + bj] = word;
  }

  // the last mask CTA to finish runs the reduce and sets the counter back
  __shared__ int last;
  __threadfence();  // this CTA's words are visible before it counts
  __syncthreads();
  if (tid == 0) {
    int total = 0;  // the CTAs that do not return at once
    for (int c = 0; c < W; ++c) total += c / kRowBlocks + 1;
    last = atomicAdd(counter, 1) == total - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  reduce(valid, keep, mask, n, W);
  if (tid == 0) *counter = 0;
}

}  // namespace

// mask: n * ceil(n / 64) words of scratch (never zeroed: each word read is
// written first); counter: one int that is 0 on entry and is left 0, so
// launches that share it run one after another (one stream)
extern "C" int repro_nms(const void* boxes, const void* valid, void* keep,
                         void* mask, void* counter, int n, float iou_threshold,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || n > kMaxWords * 64 || !repro::aligned16(boxes) ||
      mask == nullptr || counter == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = (n + 63) / 64;
  const dim3 grid(W, (W + kRowBlocks - 1) / kRowBlocks);
  nms_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes),
      static_cast<const unsigned char*>(valid),
      static_cast<unsigned char*>(keep), static_cast<u64*>(mask),
      static_cast<int*>(counter), n, iou_threshold);
  return static_cast<int>(cudaGetLastError());
}
