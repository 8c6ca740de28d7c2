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

// The attention logit cap of the TPU body `_online_softmax_step`
// (src/repro/kernels/attn_template.py:136-138): tanh(s / cap) * cap on the
// natural-unit score, after the scale and before the mask (a masked score
// stays NEG_INF, so a row that sees no key still leaves as zeros). tanhf and
// an IEEE division: tanh.approx.f32 errs by ~2^-11 relative, 0.025 of a
// score at cap 50, past f32's limits. CAP false returns the score as it
// is, so an uncapped instantiation compiles to the code it had without it
template <bool CAP>
__device__ __forceinline__ float softcap(float s, float cap) {
  if constexpr (CAP) return tanhf(s / cap) * cap;
  return s;
}

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

// One 16-byte asynchronous copy from device to shared memory (sm_80+).
// With `fill` false nothing is read and the 16 bytes are zeroed: the
// ragged tail of a tile and the zero padding of its head dim. `src` must
// be a valid address either way.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = fill ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// ---------------------------------------------------------------------------
// the tensor cores (mma.sync, sm_80+): the bf16 bodies of attention.cu and
// decode.cu
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane i gives the row address of matrix i / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4],
                                          const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 2^x by the SFU (ex2.approx.ftz: relative error ~2^-22, 3-4 % faster on
// these shapes than exp2f's denormal-safe sequence)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two probabilities, each as a bf16 head plus the bf16 of its remainder,
// packed in pairs (the first in the low half); the values the pairs hold
// are added to `sum`
__device__ __forceinline__ void split_pack(float a, float b, uint32_t& head,
                                           uint32_t& rest, float& sum) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float ha = __low2float(h), hb = __high2float(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(a - ha, b - hb);
  sum += (ha + __low2float(r)) + (hb + __high2float(r));
  head = *reinterpret_cast<const uint32_t*>(&h);
  rest = *reinterpret_cast<const uint32_t*>(&r);
}

}  // namespace repro
