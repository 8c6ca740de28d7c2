// Row norms over the last dim: RMSNorm, LayerNorm, their fused
// residual-add twins and the int8-dequant + add + RMSNorm epilogue, from
// one template.
//
// Replaces five TPU kernels of src/repro/kernels/norms.py:
//   _rms_kernel              -> rms_norm              (pallas_call at :61)
//   _add_rms_kernel          -> fused_add_rms_norm    (pallas_call at :98)
//   _dequant_add_rms_kernel  -> dequant_add_rms_norm  (pallas_call at :154)
//   _add_ln_kernel           -> fused_add_layer_norm  (pallas_call at :200)
//   _ln_kernel               -> layer_norm            (pallas_call at :240)
// KIND picks the statistic (RMS: mean(v^2); LN: mean, then
// mean((v - mean)^2)); ADD puts the residual add in front of it; XT is the
// type of the row read as x (T, or int8 for the dequant epilogue):
//   rms_norm        y = v * rsqrt(mean(v^2) + eps) * w   (or (1 + w))
//   layer_norm      y = (v - mean) * rsqrt(var + eps) * w + b
//   fused twins     r = round(x + res) is written, and v = r, the ROUNDED
//                   sum (norms.py:83, :185), so r matches the plain
//                   version bit for bit: both add in f32 and round once.
//   dequant         r = round(q * qscale + res), q int8 and qscale one f32
//                   read from device memory (no host sync); the multiply
//                   and the add are __fmul_rn / __fadd_rn, since nvcc
//                   would otherwise contract them into one FMA, rounded
//                   once where the plain version (and norms.py:126-127)
//                   rounds twice. Then RMSNorm of the rounded r
//                   (norms.py:129), as the fused twins.
//
// Bound on the card: bytes. Each operand row is read once and each output
// written once for a few flops per element, far below the ~295 flop/byte
// where an H100 turns compute bound. The design does about that:
//   * one block of 256 threads per row, so the ragged edge of the TPU's
//     8-row tiles disappears and every SM holds many rows in flight;
//   * 16-byte vector loads and stores where the width and the pointers
//     allow it (d % 8 == 0 for bf16, d % 4 == 0 for f32), scalar ones
//     otherwise (ragged widths such as 257); the int8 row of the dequant
//     epilogue is read with the same number of elements a load (8 or 4
//     bytes), a quarter of the float bytes;
//   * the row (for the fused twins: the rounded r) stays in shared memory
//     as f32, so LayerNorm's second pass and the output pass read no
//     device memory;
//   * the variance is two-pass, mean((v - mean)^2), as in the TPU kernel:
//     a one-pass E[v^2] - E[v]^2 cancels in f32 on a residual stream whose
//     mean is far from zero;
//   * block sums reduce by warp shuffles, then across the eight warps
//     through shared memory.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRms = 0;
constexpr int kLn = 1;
constexpr int kMaxWidth = 32768;  // 128 KB of f32 row in shared memory

// Sum of v over the block; every thread gets the total. `red` holds
// kThreads / 32 + 1 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = repro::warp_sum(v);
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    float t = lane < kThreads / 32 ? red[lane] : 0.f;
    t = repro::warp_sum(t);
    if (lane == 0) red[kThreads / 32] = t;
  }
  __syncthreads();
  return red[kThreads / 32];
}

// V int8 values at p, widened to f32: one load of V bytes (p aligned to
// V bytes) for V = 4 or 8, one byte otherwise.
template <int V>
__device__ __forceinline__ void load_q8(float (&f)[V], const int8_t* p) {
  if constexpr (V == 8 || V == 4) {
    using W = typename std::conditional<V == 8, uint2, uint32_t>::type;
    const W u = *reinterpret_cast<const W*>(p);
    const int8_t* e = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = static_cast<float>(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = static_cast<float>(p[j]);
  }
}

// x is read as XT: T, or int8 (the dequant epilogue, scaled by *qs).
template <typename T, typename XT, int KIND, bool ADD, bool VEC>
__global__ void __launch_bounds__(kThreads)
    row_norm_kernel(const XT* __restrict__ x, const float* __restrict__ qs,
                    const T* __restrict__ res, const T* __restrict__ w,
                    const T* __restrict__ bias, T* __restrict__ y,
                    T* __restrict__ r, int d, float eps, int zero_centered) {
  constexpr int V = VEC ? 16 / sizeof(T) : 1;
  constexpr bool kDequant = std::is_same<XT, int8_t>::value;
  static_assert(!kDequant || (ADD && KIND == kRms), "dequant: RMS + add only");
  extern __shared__ float row[];  // d floats
  __shared__ float red[kThreads / 32 + 1];
  const int64_t off = static_cast<int64_t>(blockIdx.x) * d;
  const int n = d / V;  // VEC only where d % V == 0
  float qscale = 1.f;
  if constexpr (kDequant) qscale = *qs;

  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float v[V];
    if constexpr (kDequant) {
      load_q8<V>(v, x + off + i * V);
    } else {
      repro::load_vec<T, V>(v, x + off + i * V);
    }
    if constexpr (ADD) {
      float rv[V];
      repro::load_vec<T, V>(rv, res + off + i * V);
#pragma unroll
      for (int j = 0; j < V; ++j)
        v[j] = kDequant ? __fadd_rn(__fmul_rn(v[j], qscale), rv[j]) : v[j] + rv[j];
      repro::store_vec<T, V>(r + off + i * V, v);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = repro::to_f(repro::from_f<T>(v[j]));
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      row[i * V + j] = v[j];
      acc += KIND == kRms ? v[j] * v[j] : v[j];
    }
  }
  // each thread reads back only the row entries it wrote itself
  const float m1 = block_sum(acc, red) / static_cast<float>(d);
  float mean = 0.f, inv;
  if constexpr (KIND == kLn) {
    mean = m1;
    float acc2 = 0.f;
    for (int i = threadIdx.x; i < n; i += kThreads) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float c = row[i * V + j] - mean;
        acc2 += c * c;
      }
    }
    inv = rsqrtf(block_sum(acc2, red) / static_cast<float>(d) + eps);
  } else {
    inv = rsqrtf(m1 + eps);
  }

  for (int i = threadIdx.x; i < n; i += kThreads) {
    float s[V], o[V];
    repro::load_vec<T, V>(s, w + i * V);
    if constexpr (KIND == kLn) {
      float b[V];
      repro::load_vec<T, V>(b, bias + i * V);
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = (row[i * V + j] - mean) * inv * s[j] + b[j];
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = row[i * V + j] * inv * (zero_centered ? 1.f + s[j] : s[j]);
    }
    repro::store_vec<T, V>(y + off + i * V, o);
  }
}

template <typename T, typename XT, int KIND, bool ADD, bool VEC>
int launch_impl(const void* x, const void* qs, const void* res, const void* w,
                const void* b, void* y, void* r, int64_t rows, int d,
                float eps, int zero_centered, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(d);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        row_norm_kernel<T, XT, KIND, ADD, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  row_norm_kernel<T, XT, KIND, ADD, VEC>
      <<<static_cast<unsigned>(rows), kThreads, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const float*>(qs),
      static_cast<const T*>(res), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), static_cast<T*>(r), d,
      eps, zero_centered);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned_to(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

template <typename T, typename XT, int KIND, bool ADD>
int launch(const void* x, const void* qs, const void* res, const void* w,
           const void* b, void* y, void* r, int64_t rows, int d, float eps,
           int zero_centered, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  // null pointers (no res / r / bias) count as aligned; x holds V elements
  // of XT a load
  const bool vec = d % V == 0 && aligned_to(x, V * sizeof(XT)) &&
                   repro::aligned16(res) && repro::aligned16(w) &&
                   repro::aligned16(b) && repro::aligned16(y) &&
                   repro::aligned16(r);
  return vec ? launch_impl<T, XT, KIND, ADD, true>(x, qs, res, w, b, y, r, rows,
                                                   d, eps, zero_centered, stream)
             : launch_impl<T, XT, KIND, ADD, false>(x, qs, res, w, b, y, r, rows,
                                                    d, eps, zero_centered, stream);
}

template <typename T>
int dispatch(int kind, const void* x, const void* res, const void* w,
             const void* b, void* y, void* r, int64_t rows, int d, float eps,
             int zero_centered, cudaStream_t s) {
  if (kind == kRms)
    return res ? launch<T, T, kRms, true>(x, nullptr, res, w, b, y, r, rows, d,
                                          eps, zero_centered, s)
               : launch<T, T, kRms, false>(x, nullptr, res, w, b, y, r, rows, d,
                                           eps, zero_centered, s);
  return res ? launch<T, T, kLn, true>(x, nullptr, res, w, b, y, r, rows, d, eps, 0, s)
             : launch<T, T, kLn, false>(x, nullptr, res, w, b, y, r, rows, d, eps, 0, s);
}

bool bad_shape(int64_t rows, int d) {
  return rows <= 0 || rows > 0x7fffffff || d <= 0 || d > kMaxWidth;
}

}  // namespace

// kind 0: RMSNorm (w, optional zero-centred scale), 1: LayerNorm (w, b).
// res == nullptr: plain norm of x; else the fused twin, which also writes
// r = round(x + res) (r must then be given too).
extern "C" int repro_row_norm(const void* x, const void* res, const void* w,
                              const void* b, void* y, void* r, int64_t rows,
                              int d, float eps, int zero_centered, int kind,
                              int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_shape(rows, d) || (kind != kRms && kind != kLn) || (kind == kLn && !b) ||
      (res != nullptr) != (r != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return dispatch<float>(kind, x, res, w, b, y, r, rows, d, eps, zero_centered, s);
  if (dtype == repro::kBF16)
    return dispatch<__nv_bfloat16>(kind, x, res, w, b, y, r, rows, d, eps,
                                   zero_centered, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// y = rms_norm(r), r = round(q * *qscale + res) to the residual's dtype;
// q int8 (rows, d), qscale one f32 in device memory, res / w / y / r of
// `dtype`.
extern "C" int repro_dequant_add_rms_norm(const void* q, const void* qscale,
                                          const void* res, const void* w,
                                          void* y, void* r, int64_t rows,
                                          int d, float eps, int zero_centered,
                                          int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_shape(rows, d) || !q || !qscale || !res || !w || !y || !r)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch<float, int8_t, kRms, true>(q, qscale, res, w, nullptr, y, r,
                                             rows, d, eps, zero_centered, s);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16, int8_t, kRms, true>(
        q, qscale, res, w, nullptr, y, r, rows, d, eps, zero_centered, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
