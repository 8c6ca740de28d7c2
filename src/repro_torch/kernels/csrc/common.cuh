// Shared helpers for the hand-written Hopper kernels of repro_torch.
//
// Every kernel keeps its arithmetic in f32 whatever the storage type
// (f32 or bf16, selected by the `dtype` code its C entry takes) and rounds
// once on the way out, round-to-nearest-even, as torch's `.to(bfloat16)`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes shared with repro_torch/kernels/_build.py (DTYPE_CODE)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// finite, as in the JAX kernels: exp(m_prev - m_new) never sees -inf - -inf
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// V consecutive elements at p, widened to f32. With V * sizeof(T) == 16
// one 16-byte load (p must be 16-byte aligned); V == 1 is the scalar path.
template <typename T, int V>
__device__ __forceinline__ void load_vec(float (&f)[V], const T* p) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = to_f(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = to_f(p[j]);
  }
}

// The store twin of load_vec: each value rounded once to T.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = from_f<T>(f[j]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = from_f<T>(f[j]);
  }
}

// Stage ROWS rows of `cols` elements (row stride `stride` elements) into
// shared memory as f32 with a row pitch of `ld` floats; rows >= `valid` are
// zero-filled. With VEC, each thread issues all its 16-byte loads before
// any of its stores, so they are in flight together (a tile costs about
// one memory latency, not one per element); VEC needs cols % (16 /
// sizeof(T)) == 0, 16-byte aligned rows and cols <= MAX_COLS. Otherwise
// one element at a time.
template <typename T, int ROWS, int NT, int MAX_COLS, bool VEC>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const T* __restrict__ src,
                                           int64_t stride, int valid,
                                           int cols) {
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T);
    constexpr int kIters = (ROWS * (MAX_COLS / V) + NT - 1) / NT;
    const int vpr = cols / V;  // vectors per row
    const int total = ROWS * vpr;
    uint4 buf[kIters];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = threadIdx.x + it * NT;
      const int r = i / vpr;
      buf[it] = (i < total && r < valid)
                    ? *reinterpret_cast<const uint4*>(src + r * stride + (i - r * vpr) * V)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = threadIdx.x + it * NT;
      if (i < total) {
        const int r = i / vpr, c = (i - r * vpr) * V;
        const T* e = reinterpret_cast<const T*>(&buf[it]);
#pragma unroll
        for (int j = 0; j < V; ++j) dst[r * ld + c + j] = to_f(e[j]);
      }
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * cols; i += NT) {
      const int r = i / cols, c = i - r * cols;
      dst[r * ld + c] = r < valid ? to_f(src[r * stride + c]) : 0.f;
    }
  }
}

}  // namespace repro
