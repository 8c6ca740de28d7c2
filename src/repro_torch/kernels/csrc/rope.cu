// Rotary embedding, rotate-halves layout, on the leading rot = 2 * half
// dims of every head; dims [rot, D) pass through.
//
// Replaces the TPU kernel `_rope_kernel` / `rope` in
// src/repro/kernels/rope.py (pallas_call at :60).
//
// x (B,S,H,D) -> out (B,S,H,D), with i < half:
//   out[..., i]        = x1 * cos(theta_i) - x2 * sin(theta_i)
//   out[..., half + i] = x1 * sin(theta_i) + x2 * cos(theta_i)
//   x1 = x[..., i], x2 = x[..., half + i], theta_i = pos * base^(-i/half)
// Positions are int32, read by the kernel at b * pos_sb + s * pos_ss, so a
// broadcast (1, S) table or a (B, 1) decode column needs no copy.
//
// Bound on the card: bytes. The tensor is read and written once; the
// angles cost a pow, a sin and a cos per (row, i), shared by the H heads.
// The design does about that:
//   * one block of 256 threads per (b, s) row; the row's half angles are
//     computed once into shared memory and read by all its heads;
//   * the angles follow nn.apply_rope op for op in f32: e = -i * (1/half)
//     (the reciprocal product torch's CUDA division by a scalar computes),
//     freq = powf(base, e), theta = pos * freq, then IEEE sinf / cosf --
//     not the fast __sinf / __cosf, which lose accuracy as |theta| grows
//     and positions reach thousands of radians. Products and sums round
//     one at a time (__fmul_rn / __fadd_rn / __fsub_rn, never contracted
//     to an FMA), as the plain version's separate ops round;
//   * 16-byte vectors of V consecutive i from each half where half % V == 0
//     and the pointers allow it, scalars otherwise (odd head dims);
//   * the unrotated tail is copied through in the same launch, so the
//     wrapper neither slices nor concatenates (the TPU wrapper does both).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    rope_kernel(const T* __restrict__ x, const int* __restrict__ pos,
                T* __restrict__ out, int S, int H, int D, int half,
                int64_t pos_sb, int64_t pos_ss, float base) {
  constexpr int V = VEC ? 16 / sizeof(T) : 1;
  extern __shared__ float cs[];  // cos[0, half), sin[half, 2 * half)
  const int row = blockIdx.x;    // b * S + s
  const int b = row / S, s = row - b * S;
  const float p = static_cast<float>(pos[b * pos_sb + s * pos_ss]);
  const float inv_half = 1.f / static_cast<float>(half);
  for (int i = threadIdx.x; i < half; i += kThreads) {
    const float e = __fmul_rn(-static_cast<float>(i), inv_half);
    const float theta = __fmul_rn(p, powf(base, e));
    cs[i] = cosf(theta);
    cs[half + i] = sinf(theta);
  }
  __syncthreads();

  const int64_t off = static_cast<int64_t>(row) * H * D;
  const int hv = half / V;  // vectors per half head
  for (int k = threadIdx.x; k < H * hv; k += kThreads) {
    const int h = k / hv, i = (k - h * hv) * V;
    const T* xr = x + off + static_cast<int64_t>(h) * D;
    T* orow = out + off + static_cast<int64_t>(h) * D;
    float x1[V], x2[V], o1[V], o2[V];
    repro::load_vec<T, V>(x1, xr + i);
    repro::load_vec<T, V>(x2, xr + half + i);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float c = cs[i + j], sn = cs[half + i + j];
      o1[j] = __fsub_rn(__fmul_rn(x1[j], c), __fmul_rn(x2[j], sn));
      o2[j] = __fadd_rn(__fmul_rn(x1[j], sn), __fmul_rn(x2[j], c));
    }
    repro::store_vec<T, V>(orow + i, o1);
    repro::store_vec<T, V>(orow + half + i, o2);
  }
  const int rot = 2 * half, tail = D - rot;
  for (int k = threadIdx.x; k < H * tail; k += kThreads) {
    const int h = k / tail;
    const int64_t e = off + static_cast<int64_t>(h) * D + rot + (k - h * tail);
    out[e] = x[e];
  }
}

template <typename T, bool VEC>
int launch_impl(const void* x, const void* pos, void* out, int64_t rows,
                int S, int H, int D, int half, int64_t pos_sb, int64_t pos_ss,
                float base, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * static_cast<size_t>(half);
  rope_kernel<T, VEC><<<static_cast<unsigned>(rows), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(pos),
      static_cast<T*>(out), S, H, D, half, pos_sb, pos_ss, base);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* pos, void* out, int64_t rows, int S,
           int H, int D, int half, int64_t pos_sb, int64_t pos_ss, float base,
           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = half % V == 0 && D % V == 0 && repro::aligned16(x) &&
                   repro::aligned16(out);
  return vec ? launch_impl<T, true>(x, pos, out, rows, S, H, D, half, pos_sb,
                                    pos_ss, base, stream)
             : launch_impl<T, false>(x, pos, out, rows, S, H, D, half, pos_sb,
                                     pos_ss, base, stream);
}

}  // namespace

extern "C" int repro_rope(const void* x, const void* pos, void* out,
                          int64_t rows, int S, int H, int D, int half,
                          int64_t pos_sb, int64_t pos_ss, float base, int dtype,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // half <= 6144 keeps the angle table within the default 48 KB
  if (rows <= 0 || rows > 0x7fffffff || S <= 0 || rows % S || H <= 0 ||
      D <= 0 || half < 0 || 2 * half > D || half > 6144)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch<float>(x, pos, out, rows, S, H, D, half, pos_sb, pos_ss, base, s);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(x, pos, out, rows, S, H, D, half, pos_sb,
                                 pos_ss, base, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
