// RMSNorm over the last dim: y = x * rsqrt(mean(x^2) + eps) * w  (or (1 + w)).
//
// Replaces the TPU kernel `_rms_kernel` / `rms_norm` in
// src/repro/kernels/norms.py (pallas_call at :61).
//
// Bound on the card: bytes. Each row is read and written once and does
// ~3 flops per element, far below the ~295 flop/byte where an H100 turns
// compute bound. The design does about that:
//   * one block of 256 threads per row, so every SM holds many rows in
//     flight and the ragged edge of the TPU's 8-row tiles disappears;
//   * 16-byte vector loads and stores where the width and the pointers
//     allow it (d % 8 == 0 for bf16, d % 4 == 0 for f32), scalar ones
//     otherwise (ragged widths such as 257);
//   * the f32 sum of squares is reduced by warp shuffles, then across the
//     block's eight warps through shared memory;
//   * the second pass re-reads the row from L1/L2 (8 KB for d=4096 bf16),
//     not from device memory, and writes y once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, int d, float eps, int zero_centered,
                    int vec_ok) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;

  float ss = 0.f;
  if (vec_ok) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < d / V; i += kThreads) {
      uint4 u = xv[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float f = repro::to_f(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      float f = repro::to_f(xr[i]);
      ss += f * f;
    }
  }

  __shared__ float warp_sums[kThreads / 32];
  __shared__ float inv_rms;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  ss = repro::warp_sum(ss);
  if (lane == 0) warp_sums[wid] = ss;
  __syncthreads();
  if (wid == 0) {
    float t = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
    t = repro::warp_sum(t);
    if (lane == 0) inv_rms = rsqrtf(t / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float r = inv_rms;

  if (vec_ok) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    const uint4* wv = reinterpret_cast<const uint4*>(w);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = threadIdx.x; i < d / V; i += kThreads) {
      uint4 ux = xv[i], uw = wv[i], uo;
      const T* ex = reinterpret_cast<const T*>(&ux);
      const T* ew = reinterpret_cast<const T*>(&uw);
      T* eo = reinterpret_cast<T*>(&uo);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float s = repro::to_f(ew[j]);
        if (zero_centered) s = 1.f + s;
        eo[j] = repro::from_f<T>(repro::to_f(ex[j]) * r * s);
      }
      yv[i] = uo;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      float s = repro::to_f(w[i]);
      if (zero_centered) s = 1.f + s;
      yr[i] = repro::from_f<T>(repro::to_f(xr[i]) * r * s);
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, void* y, int64_t rows, int d,
            float eps, int zero_centered, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int vec_ok = (d % V == 0) && repro::aligned16(x) &&
                     repro::aligned16(w) && repro::aligned16(y);
  rms_norm_kernel<T><<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      d, eps, zero_centered, vec_ok);
}

}  // namespace

extern "C" int repro_rms_norm(const void* x, const void* w, void* y,
                              int64_t rows, int d, float eps,
                              int zero_centered, int dtype, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || rows > 0x7fffffff || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    launch<float>(x, w, y, rows, d, eps, zero_centered, s);
  else if (dtype == repro::kBF16)
    launch<__nv_bfloat16>(x, w, y, rows, d, eps, zero_centered, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
