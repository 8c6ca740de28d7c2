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
//
// Bound on the card: neither bytes (N = 256 boxes are 4 KB) nor operations
// (one IoU row per kept box, ~N^2 / 2 * 13 flops at most): the N steps are
// serial, so the chain of steps bounds it. The design keeps a step short:
//   * one CTA per call, one thread per candidate (each thread loops over
//     candidates j = t, t + blockDim, ... above 1024); the boxes, their
//     areas and the keep / valid flags live in shared memory;
//   * a step whose box is not alive writes nothing, so every thread skips
//     it (the flag is uniform across the CTA) and no barrier is needed;
//     a live step clears its row and ends in one __syncthreads;
//   * the arithmetic rounds every product, sum and quotient on its own
//     (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, never contracted to
//     an FMA), as the plain version's separate ops round: a pair whose IoU
//     sits at the threshold must fall the same way on both, since the keep
//     mask is compared exactly.
// An IoU bitmask over CTAs with a serial reduce comes in later work.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float rn_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float rn_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float rn_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rn_div(float a, float b) { return __fdiv_rn(a, b); }

__global__ void __launch_bounds__(kMaxThreads)
    nms_kernel(const float* __restrict__ boxes,
               const unsigned char* __restrict__ valid,
               unsigned char* __restrict__ keep, int n, float thr) {
  extern __shared__ float smem[];
  float* x1 = smem;
  float* y1 = x1 + n;
  float* x2 = y1 + n;
  float* y2 = x2 + n;
  float* area = y2 + n;
  unsigned char* valid_s = reinterpret_cast<unsigned char*>(area + n);
  unsigned char* keep_s = valid_s + n;

  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float4 b = reinterpret_cast<const float4*>(boxes)[j];
    x1[j] = b.x;
    y1[j] = b.y;
    x2[j] = b.z;
    y2[j] = b.w;
    area[j] = rn_mul(fmaxf(rn_sub(b.z, b.x), 0.f), fmaxf(rn_sub(b.w, b.y), 0.f));
    valid_s[j] = valid[j];
    keep_s[j] = valid[j];
  }
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    if (!(keep_s[i] && valid_s[i])) continue;  // uniform: nothing written
    const float bx1 = x1[i], by1 = y1[i], bx2 = x2[i], by2 = y2[i];
    const float ai = area[i];
    for (int j = i + 1 + threadIdx.x; j < n; j += blockDim.x) {
      const float iw = fmaxf(rn_sub(fminf(x2[j], bx2), fmaxf(x1[j], bx1)), 0.f);
      const float ih = fmaxf(rn_sub(fminf(y2[j], by2), fmaxf(y1[j], by1)), 0.f);
      const float inter = rn_mul(iw, ih);
      const float uni = rn_sub(rn_add(area[j], ai), inter);
      const float iou = uni > 0.f ? rn_div(inter, uni) : 0.f;
      if (iou > thr) keep_s[j] = 0;
    }
    __syncthreads();  // row i's clears land before a later step reads them
  }

  for (int j = threadIdx.x; j < n; j += blockDim.x) keep[j] = keep_s[j];
}

size_t smem_bytes(int n) {
  return static_cast<size_t>(n) * (5 * sizeof(float) + 2);
}

}  // namespace

extern "C" int repro_nms(const void* boxes, const void* valid, void* keep,
                         int n, float iou_threshold, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || !repro::aligned16(boxes))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n);
  err = cudaFuncSetAttribute(nms_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = std::min(kMaxThreads, (n + 31) / 32 * 32);
  nms_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes),
      static_cast<const unsigned char*>(valid),
      static_cast<unsigned char*>(keep), n, iou_threshold);
  return static_cast<int>(cudaGetLastError());
}
