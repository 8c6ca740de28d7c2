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
// where an H100 turns compute bound. So the design moves each byte once,
// keeps the row in registers and puts enough loads in flight. The host
// picks one of three bodies from the shapes alone (kernels/norms.py
// row_norm_plan) and passes the plan in; a plan with no instantiation
// here is refused with cudaErrorInvalidValue:
//   A "warp"  rows of at most 32 16-byte vectors (bf16 <= 256 wide, f32
//             <= 128): a group of G = 4..32 lanes of one warp per row, one
//             vector a lane, 256 / G rows a 256-thread CTA. The group sums
//             by __shfl_xor_sync over its own G lanes, so no shared memory
//             and no barrier; w and b stay in registers over the rows the
//             CTA walks (a grid-stride loop).
//   B "cta"   wider rows up to 256 * 8 vectors (bf16 <= 16384, f32 <=
//             8192): one CTA of whole warps per row, K <= 8 vectors a
//             thread; warp shuffles, then one shared-memory exchange per
//             statistic (RMS one barrier, LayerNorm two). Rows that would
//             fit a warp at up to 8 vectors a lane (384, 768, 1600 wide)
//             run here too: one warp a row ran slower than B at every
//             main-path shape timed, from 4 rows to 2048 (PERF.md).
//   C "smem"  the rest: ragged or misaligned rows (scalar loads, such as
//             width 257) and f32 rows above 8192; one 256-thread CTA per
//             row, the row kept in shared memory as f32.
// In A and B each lane issues all its loads (x, res, w, b) before any
// arithmetic, so a row costs about one memory trip; the row stays in
// registers as f32 (for the fused twins: the rounded r), so LayerNorm's
// centred pass and the output pass read no memory. The variance is
// two-pass, mean((v - mean)^2), as in the TPU kernel: a one-pass
// E[v^2] - E[v]^2 cancels in f32 on a residual stream whose mean is far
// from zero.
#include <type_traits>

#include "common.cuh"

namespace {

// bodies A and C; body B's CTA at most. Every body is declared
// __launch_bounds__(kThreads, 1): without the 1, ptxas spilled a few
// values in 12 of the 201 instantiations to stop at 64, 80 or 128
// registers; with it, none spills.
constexpr int kThreads = 256;
constexpr int kMaxVecs = 8;    // 16-byte vectors a thread holds in body B
constexpr int kRms = 0;
constexpr int kLn = 1;
constexpr int kWarp = 0, kCta = 1, kSmem = 2;  // row_norm_plan's bodies
constexpr int kMaxWidth = 32768;  // body C: 128 KB of f32 row in shared memory

// V elements of XT as one load: 16 bytes of T, or V bytes of int8.
template <typename XT, int V>
using raw_t = typename std::conditional<
    sizeof(XT) * V == 16, uint4,
    typename std::conditional<sizeof(XT) * V == 8, uint2, uint32_t>::type>::type;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(int8_t v) { return static_cast<float>(v); }

template <typename XT, int V>
__device__ __forceinline__ void unpack(float (&f)[V], const raw_t<XT, V>& u) {
  const XT* e = reinterpret_cast<const XT*>(&u);
#pragma unroll
  for (int j = 0; j < V; ++j) f[j] = widen(e[j]);
}

template <typename XT, int V>
__device__ __forceinline__ raw_t<XT, V> load_raw(const XT* p) {
  return *reinterpret_cast<const raw_t<XT, V>*>(p);
}

// A lane's K vectors of one row, as f32 in v[k]: vector k is the row's
// (k * stride + lane)-th, and those past the row (the K tail) hold zeros.
// Every load is issued before any arithmetic. With ADD, r = round(x + res)
// is written and v holds the rounded r.
template <typename T, typename XT, bool ADD, int K, int V>
__device__ __forceinline__ void load_row(float (&v)[K][V], const XT* __restrict__ x,
                                         const T* __restrict__ res, T* __restrict__ r,
                                         int64_t off, int lane, int stride, int n,
                                         float qscale) {
  constexpr bool kDequant = std::is_same<XT, int8_t>::value;
  raw_t<XT, V> xr[K];
  raw_t<T, V> rr[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = k * stride + lane;
    const bool in_row = c < n;  // the K tail
    xr[k] = in_row ? load_raw<XT, V>(x + off + c * V) : raw_t<XT, V>{};
    if constexpr (ADD) rr[k] = in_row ? load_raw<T, V>(res + off + c * V) : raw_t<T, V>{};
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    unpack<XT, V>(v[k], xr[k]);
    if constexpr (ADD) {
      float rv[V];
      unpack<T, V>(rv, rr[k]);
#pragma unroll
      for (int j = 0; j < V; ++j)
        v[k][j] = kDequant ? __fadd_rn(__fmul_rn(v[k][j], qscale), rv[j]) : v[k][j] + rv[j];
      const int c = k * stride + lane;
      if (c < n) repro::store_vec<T, V>(r + off + c * V, v[k]);
#pragma unroll
      for (int j = 0; j < V; ++j) v[k][j] = repro::to_f(repro::from_f<T>(v[k][j]));
    }
  }
}

// (mean, 1 / sigma) of a row from the values its lanes hold: RMS's
// (0, rsqrt(mean(v^2) + eps)), LayerNorm's two-pass (mean,
// rsqrt(mean((v - mean)^2) + eps)). sum(a, i) adds a lane value over the
// row's lanes, every lane getting the same total (i: which statistic).
template <int KIND, int K, int V, typename Sum>
__device__ __forceinline__ float2 row_moments(const float (&v)[K][V], int lane, int stride,
                                              int n, int d, float eps, Sum sum) {
  float acc = 0.f;  // the K tail holds zeros
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) acc += KIND == kRms ? v[k][j] * v[k][j] : v[k][j];
  const float m1 = sum(acc, 0) / static_cast<float>(d);
  if constexpr (KIND == kRms) {
    return make_float2(0.f, rsqrtf(m1 + eps));
  } else {
    float acc2 = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k * stride + lane < n) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float c = v[k][j] - m1;
          acc2 += c * c;
        }
      }
    }
    return make_float2(m1, rsqrtf(sum(acc2, 1) / static_cast<float>(d) + eps));
  }
}

// The row's outputs from the held values and the lane's w (and b) vectors.
template <typename T, int KIND, int K, int V>
__device__ __forceinline__ void store_row(T* __restrict__ y, const float (&v)[K][V],
                                          const raw_t<T, V> (&wv)[K],
                                          const raw_t<T, V> (&bv)[K], float2 mi,
                                          int zero_centered, int64_t off, int lane,
                                          int stride, int n) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = k * stride + lane;
    if (c < n) {
      float s[V], o[V];
      unpack<T, V>(s, wv[k]);
      if constexpr (KIND == kLn) {
        float b[V];
        unpack<T, V>(b, bv[k]);
#pragma unroll
        for (int j = 0; j < V; ++j) o[j] = (v[k][j] - mi.x) * mi.y * s[j] + b[j];
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          o[j] = v[k][j] * mi.y * (zero_centered ? 1.f + s[j] : s[j]);
      }
      repro::store_vec<T, V>(y + off + c * V, o);
    }
  }
}

// The lane's K vectors of w (and, for LayerNorm, b); zeros past the row.
template <typename T, int KIND, int K, int V>
__device__ __forceinline__ void load_weights(raw_t<T, V> (&wv)[K], raw_t<T, V> (&bv)[K],
                                             const T* __restrict__ w,
                                             const T* __restrict__ bias, int lane,
                                             int stride, int n) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = k * stride + lane;
    wv[k] = c < n ? load_raw<T, V>(w + c * V) : raw_t<T, V>{};
    bv[k] = KIND == kLn && c < n ? load_raw<T, V>(bias + c * V) : raw_t<T, V>{};
  }
}

// Sum over the G lanes of one group (G a power of two, groups aligned in
// the warp); every lane of the group gets the total.
template <int G>
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o, G);
  return v;
}

// Body A: 256 / G rows at a time, a group of G lanes each, one vector a
// lane, walking the rows with a grid stride.
template <typename T, typename XT, int KIND, bool ADD, int G>
__global__ void __launch_bounds__(kThreads, 1)
    row_norm_warp(const XT* __restrict__ x, const float* __restrict__ qs,
                  const T* __restrict__ res, const T* __restrict__ w,
                  const T* __restrict__ bias, T* __restrict__ y, T* __restrict__ r,
                  int64_t rows, int d, float eps, int zero_centered) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kRows = kThreads / G;
  const int n = d / V;
  const int lane = threadIdx.x % G;
  // the group's lanes: a shuffle waits for these only, so a group whose
  // row is past the end may leave the loop while its warp's others go on
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << (G % 32)) - 1u) << (threadIdx.x % 32 / G * G);
  float qscale = 1.f;
  if constexpr (std::is_same<XT, int8_t>::value) qscale = *qs;
  raw_t<T, V> wv[1], bv[1];
  load_weights<T, KIND, 1, V>(wv, bv, w, bias, lane, G, n);
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.x / G; row < rows;
       row += static_cast<int64_t>(gridDim.x) * kRows) {
    const int64_t off = row * d;
    float v[1][V];
    load_row<T, XT, ADD, 1, V>(v, x, res, r, off, lane, G, n, qscale);
    const float2 mi = row_moments<KIND, 1, V>(
        v, lane, G, n, d, eps, [mask](float a, int) { return group_sum<G>(a, mask); });
    store_row<T, KIND, 1, V>(y, v, wv, bv, mi, zero_centered, off, lane, G, n);
  }
}

// Sum over the CTA's whole warps (bodies B and C): shuffles, one exchange
// through `red` (a buffer for each statistic, so that the second needs no
// barrier to protect the first's reads) and one barrier; every thread adds
// the warps' sums in the same order, so all get the same total.
__device__ __forceinline__ float cta_sum(float v, float* red) {
  v = repro::warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < static_cast<int>(blockDim.x / 32); ++i) t += red[i];
  return t;
}

// Body B: one CTA of blockDim.x threads (whole warps) per row.
template <typename T, typename XT, int KIND, bool ADD, int K>
__global__ void __launch_bounds__(kThreads, 1)
    row_norm_cta(const XT* __restrict__ x, const float* __restrict__ qs,
                 const T* __restrict__ res, const T* __restrict__ w,
                 const T* __restrict__ bias, T* __restrict__ y, T* __restrict__ r,
                 int64_t rows, int d, float eps, int zero_centered) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[2][kThreads / 32];
  const int n = d / V, lane = threadIdx.x, stride = blockDim.x;
  const int64_t off = static_cast<int64_t>(blockIdx.x) * d;
  float qscale = 1.f;
  if constexpr (std::is_same<XT, int8_t>::value) qscale = *qs;
  raw_t<T, V> wv[K], bv[K];
  load_weights<T, KIND, K, V>(wv, bv, w, bias, lane, stride, n);
  float v[K][V];
  load_row<T, XT, ADD, K, V>(v, x, res, r, off, lane, stride, n, qscale);
  float(*reds)[kThreads / 32] = red;
  const float2 mi = row_moments<KIND, K, V>(
      v, lane, stride, n, d, eps, [reds](float a, int i) { return cta_sum(a, reds[i]); });
  store_row<T, KIND, K, V>(y, v, wv, bv, mi, zero_centered, off, lane, stride, n);
}

// V int8 values at p, widened to f32: one load of V bytes (p aligned to
// V bytes) for V = 4 or 8, one byte otherwise.
template <int V>
__device__ __forceinline__ void load_q8(float (&f)[V], const int8_t* p) {
  if constexpr (V == 8 || V == 4) {
    unpack<int8_t, V>(f, load_raw<int8_t, V>(p));
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = static_cast<float>(p[j]);
  }
}

// Body C: one 256-thread CTA per row, the row in shared memory as f32.
template <typename T, typename XT, int KIND, bool ADD, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
    row_norm_smem(const XT* __restrict__ x, const float* __restrict__ qs,
                  const T* __restrict__ res, const T* __restrict__ w,
                  const T* __restrict__ bias, T* __restrict__ y, T* __restrict__ r,
                  int64_t rows, int d, float eps, int zero_centered) {
  constexpr int V = VEC ? 16 / sizeof(T) : 1;
  constexpr bool kDequant = std::is_same<XT, int8_t>::value;
  static_assert(!kDequant || (ADD && KIND == kRms), "dequant: RMS + add only");
  extern __shared__ float row[];  // d floats
  __shared__ float red[2][kThreads / 32];
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
  const float m1 = cta_sum(acc, red[0]) / static_cast<float>(d);
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
    inv = rsqrtf(cta_sum(acc2, red[1]) / static_cast<float>(d) + eps);
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

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void* x;
  const void* qs;
  const void* res;
  const void* w;
  const void* b;
  void* y;
  void* r;
  int64_t rows;
  int d;
  float eps;
  int zero_centered;
};

// the plan of kernels/norms.py RowNormPlan
struct Plan {
  int body, lanes, vecs, threads, grid;
};

template <typename T, typename XT>
using kernel_t = void (*)(const XT*, const float*, const T*, const T*, const T*, T*, T*,
                          int64_t, int, float, int);

template <typename T, typename XT>
int start(kernel_t<T, XT> kern, const Args& a, int grid, int threads, size_t smem,
          cudaStream_t s) {
  kern<<<static_cast<unsigned>(grid), threads, smem, s>>>(
      static_cast<const XT*>(a.x), static_cast<const float*>(a.qs),
      static_cast<const T*>(a.res), static_cast<const T*>(a.w), static_cast<const T*>(a.b),
      static_cast<T*>(a.y), static_cast<T*>(a.r), a.rows, a.d, a.eps, a.zero_centered);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

template <typename T, typename XT, int KIND, bool ADD, int K = 1>
int start_cta(const Args& a, const Plan& p, cudaStream_t s) {
  if constexpr (K > kMaxVecs) {
    return kInvalid;
  } else {
    if (p.vecs == K)
      return start<T, XT>(row_norm_cta<T, XT, KIND, ADD, K>, a, p.grid, p.threads, 0, s);
    return start_cta<T, XT, KIND, ADD, K + 1>(a, p, s);
  }
}

inline bool aligned_to(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

template <typename T, typename XT, int KIND, bool ADD>
int launch(const Args& a, const Plan& p, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  // null pointers (no res / r / bias) count as aligned; x holds V elements
  // of XT a load
  const bool vec = a.d % V == 0 && aligned_to(a.x, V * sizeof(XT)) &&
                   repro::aligned16(a.res) && repro::aligned16(a.w) &&
                   repro::aligned16(a.b) && repro::aligned16(a.y) && repro::aligned16(a.r);
  const int64_t width = static_cast<int64_t>(p.lanes) * p.vecs * V;  // values a row's lanes hold
  switch (p.body) {
    case kWarp:
      if (!vec || p.vecs != 1 || p.threads != kThreads || width < a.d || p.grid < 1)
        return kInvalid;
      switch (p.lanes) {
        case 4:
          return start<T, XT>(row_norm_warp<T, XT, KIND, ADD, 4>, a, p.grid, kThreads, 0, s);
        case 8:
          return start<T, XT>(row_norm_warp<T, XT, KIND, ADD, 8>, a, p.grid, kThreads, 0, s);
        case 16:
          return start<T, XT>(row_norm_warp<T, XT, KIND, ADD, 16>, a, p.grid, kThreads, 0, s);
        case 32:
          return start<T, XT>(row_norm_warp<T, XT, KIND, ADD, 32>, a, p.grid, kThreads, 0, s);
      }
      return kInvalid;
    case kCta:
      if (!vec || p.lanes != p.threads || p.threads % 32 || p.threads > kThreads ||
          width < a.d || p.grid != a.rows)
        return kInvalid;
      return start_cta<T, XT, KIND, ADD>(a, p, s);
    case kSmem: {
      if (p.threads != kThreads || p.grid != a.rows) return kInvalid;
      const size_t smem = sizeof(float) * static_cast<size_t>(a.d);
      const kernel_t<T, XT> kern = vec ? &row_norm_smem<T, XT, KIND, ADD, true>
                                       : &row_norm_smem<T, XT, KIND, ADD, false>;
      if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
      }
      return start<T, XT>(kern, a, p.grid, kThreads, smem, s);
    }
  }
  return kInvalid;
}

template <typename T>
int dispatch(int kind, const Args& a, const Plan& p, cudaStream_t s) {
  if (kind == kRms)
    return a.res ? launch<T, T, kRms, true>(a, p, s) : launch<T, T, kRms, false>(a, p, s);
  return a.res ? launch<T, T, kLn, true>(a, p, s) : launch<T, T, kLn, false>(a, p, s);
}

bool bad_shape(int64_t rows, int d) {
  return rows <= 0 || rows > 0x7fffffff || d <= 0 || d > kMaxWidth;
}

__global__ void empty_kernel() {}

}  // namespace

// kind 0: RMSNorm (w, optional zero-centred scale), 1: LayerNorm (w, b).
// res == nullptr: plain norm of x; else the fused twin, which also writes
// r = round(x + res) (r must then be given too). body / lanes / vecs /
// threads / grid: the launch plan (kernels/norms.py row_norm_plan).
extern "C" int repro_row_norm(const void* x, const void* res, const void* w,
                              const void* b, void* y, void* r, int64_t rows,
                              int d, float eps, int zero_centered, int kind,
                              int dtype, int body, int lanes, int vecs,
                              int threads, int grid, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_shape(rows, d) || (kind != kRms && kind != kLn) || (kind == kLn && !b) ||
      (res != nullptr) != (r != nullptr))
    return kInvalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{x, nullptr, res, w, b, y, r, rows, d, eps, kind == kRms ? zero_centered : 0};
  const Plan p{body, lanes, vecs, threads, grid};
  if (dtype == repro::kF32) return dispatch<float>(kind, a, p, s);
  if (dtype == repro::kBF16) return dispatch<__nv_bfloat16>(kind, a, p, s);
  return kInvalid;
}

// y = rms_norm(r), r = round(q * *qscale + res) to the residual's dtype;
// q int8 (rows, d), qscale one f32 in device memory, res / w / y / r of
// `dtype`; the plan as repro_row_norm's.
extern "C" int repro_dequant_add_rms_norm(const void* q, const void* qscale,
                                          const void* res, const void* w,
                                          void* y, void* r, int64_t rows,
                                          int d, float eps, int zero_centered,
                                          int dtype, int body, int lanes,
                                          int vecs, int threads, int grid,
                                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_shape(rows, d) || !q || !qscale || !res || !w || !y || !r) return kInvalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, qscale, res, w, nullptr, y, r, rows, d, eps, zero_centered};
  const Plan p{body, lanes, vecs, threads, grid};
  if (dtype == repro::kF32) return launch<float, int8_t, kRms, true>(a, p, s);
  if (dtype == repro::kBF16) return launch<__nv_bfloat16, int8_t, kRms, true>(a, p, s);
  return kInvalid;
}

// One launch of a kernel that does nothing, on `stream`: the floor under
// every kernel time taken by the same timer.
extern "C" int repro_empty_kernel(int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
