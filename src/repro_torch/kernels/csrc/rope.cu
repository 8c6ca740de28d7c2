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
// The design makes one memory trip and keeps the loads in flight:
//   * loads first: a thread issues the 16-byte loads of its x1 and x2
//     vectors before the position is read, and the angles of the row are
//     computed into shared memory while they are in flight; only the
//     rotation and the stores wait for the table;
//   * a launch plan chosen on the host from the shapes alone
//     (kernels/rope.py rope_plan): a CTA of `threads` threads takes
//     `rows_per_cta` rows at a time over all their heads, one vector a
//     thread (more vectors than threads: in chunks). Few rows: one CTA a
//     row. Many rows: a grid of the SMs times the resident CTAs, each
//     walking its rows by a grid stride and issuing the next rows' loads
//     (a second register set) and their positions before the current
//     rows' arithmetic; the next rows' angles follow the rotation, into
//     the other of two tables, so one barrier a step keeps them apart.
//     Each row's angles are computed once per CTA and read by all its
//     heads, each thread's frequency once per launch. The launch's own
//     divisions (the step, 1 / half) are done on the host:
//     the first loads wait on little arithmetic;
//   * the angles follow nn.apply_rope op for op in f32: e = -i * (1/half)
//     (the reciprocal product torch's CUDA division by a scalar computes),
//     freq = powf(base, e), theta = pos * freq, then IEEE sinf / cosf --
//     not the fast __sinf / __cosf, which lose accuracy as |theta| grows
//     and positions reach thousands of radians. Products and sums round
//     one at a time (__fmul_rn / __fadd_rn / __fsub_rn, never contracted
//     to an FMA), as the plain version's separate ops round;
//   * 16-byte vectors of V consecutive i from each half where half % V == 0,
//     D % V == 0 and the pointers allow it, scalars otherwise (odd head
//     dims);
//   * the unrotated tail is copied through in the same launch, so the
//     wrapper neither slices nor concatenates (the TPU wrapper does both).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr size_t kMaxSmem = 48 * 1024;  // the default limit: no opt-in

// what a thread holds of one vector: 16 bytes, or one element
template <typename T, bool VEC>
using Raw = std::conditional_t<VEC, uint4, T>;

template <typename T, bool VEC>
__device__ __forceinline__ Raw<T, VEC> load_raw(const T* p) {
  if constexpr (VEC) return *reinterpret_cast<const uint4*>(p);
  else return *p;
}

// one vector of the step: its offset from the step's first element (-1:
// none), its angle index in the step's table and its row in the step
struct Slot {
  int off, ang, r;
};

// (hv_shift: log2 of hv where hv is a power of two, else -1)
__device__ __forceinline__ Slot slot_at(int idx, int items, int per_row,
                                        int hv, int hv_shift, int H, int D,
                                        int half, int V, int R) {
  if (idx >= items) return {-1, 0, 0};
  const int r = R == 1 ? 0 : idx / per_row, rem = idx - r * per_row;
  const int h = hv_shift >= 0 ? rem >> hv_shift : rem / hv, iv = rem - h * hv;
  return {r * H * D + h * D + iv * V, r * 2 * half + iv * V, r};
}

template <typename T, bool VEC>
__device__ __forceinline__ void load_slot(const T* __restrict__ x, int64_t base,
                                          const Slot& sl, int row0, int rows,
                                          int half, Raw<T, VEC>& v1,
                                          Raw<T, VEC>& v2) {
  if (sl.off >= 0 && row0 + sl.r < rows) {
    const T* p = x + base + sl.off;
    v1 = load_raw<T, VEC>(p);
    v2 = load_raw<T, VEC>(p + half);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
    rope_kernel(const T* __restrict__ x, const int* __restrict__ pos,
                T* __restrict__ out, int rows, int S, int H, int D, int half,
                int64_t pos_sb, int64_t pos_ss, float base, float inv_half,
                int R, int step, int hv_shift) {
  constexpr int V = VEC ? 16 / sizeof(T) : 1;
  using RawT = Raw<T, VEC>;
  // per buffer, per row of the step: cos[0, half), sin[half, 2 * half)
  extern __shared__ float cs[];
  // a step of `step` rows: divided on the host, so that the first loads
  // wait on little arithmetic
  const int nt = blockDim.x, tid = threadIdx.x;
  int r0 = blockIdx.x * R;
  if (r0 >= rows) return;  // uniform over the CTA
  const int hv = half / V, per_row = H * hv, items = R * per_row;
  const int64_t row_elems = static_cast<int64_t>(H) * D;

  // loads first: the first step's vectors, then this thread's position
  Slot cur = slot_at(tid, items, per_row, hv, hv_shift, H, D, half, V, R),
       nxt = cur;
  RawT a1{}, a2{}, b1{}, b2{};
  load_slot<T, VEC>(x, r0 * row_elems, cur, r0, rows, half, a1, a2);
  const int n_chunk = max(1, (items + nt - 1) / nt);
  // one angle a thread where the step has no more than the CTA's threads:
  // its (row, i) and frequency stay fixed while the CTA walks, and its
  // position is loaded a step ahead, beside that step's vectors
  const bool one = R * half <= nt;
  const int ar = R == 1 || half == 0 ? 0 : tid / half, ai = tid - ar * half;
  const bool mine = one && tid < R * half;
  auto pos_at = [&](int row) {
    const int b = S == 1 ? row : row / S, s = row - b * S;
    return pos[b * pos_sb + s * pos_ss];
  };
  int pv = mine && r0 + ar < rows ? pos_at(r0 + ar) : 0;
  const float freq = mine ? powf(base, __fmul_rn(-static_cast<float>(ai), inv_half)) : 0.f;
  // the angle table of the step at row0 into buffer `tab`
  auto angles = [&](int row0, float* tab) {
    if (one) {
      if (mine && row0 + ar < rows) {
        const float theta = __fmul_rn(static_cast<float>(pv), freq);
        tab[ar * 2 * half + ai] = cosf(theta);
        tab[ar * 2 * half + half + ai] = sinf(theta);
      }
      return;
    }
    for (int j = tid; j < R * half; j += nt) {
      const int r = j / half, i = j - r * half;
      const int row = row0 + r;
      if (row >= rows) break;  // j grows with r
      const float p = static_cast<float>(pos_at(row));
      const float e = __fmul_rn(-static_cast<float>(i), inv_half);
      const float theta = __fmul_rn(p, powf(base, e));
      tab[r * 2 * half + i] = cosf(theta);
      tab[r * 2 * half + half + i] = sinf(theta);
    }
  };
  angles(r0, cs);
  __syncthreads();
  for (int it = 0;; ++it) {
    const float* tab = cs + (it & 1) * R * 2 * half;
    const int nr0 = r0 + step;  // rows + step < 2^31 (repro_rope)
    for (int c = 0; c < n_chunk; ++c) {
      // the next vectors (this step's next chunk, or the next step's
      // first) and the next step's position, issued before this chunk's
      // arithmetic
      const bool same = c + 1 < n_chunk;
      const int lr0 = same ? r0 : nr0;
      if (n_chunk > 1)
        nxt = slot_at((same ? c + 1 : 0) * nt + tid, items, per_row, hv,
                      hv_shift, H, D, half, V, R);
      if (lr0 < rows) load_slot<T, VEC>(x, lr0 * row_elems, nxt, lr0, rows, half, b1, b2);
      if (!same && mine && nr0 + ar < rows) pv = pos_at(nr0 + ar);
      if (cur.off >= 0 && r0 + cur.r < rows) {
        float x1[V], x2[V], o1[V], o2[V];
        const T* e1 = reinterpret_cast<const T*>(&a1);
        const T* e2 = reinterpret_cast<const T*>(&a2);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          x1[j] = repro::to_f(e1[j]);
          x2[j] = repro::to_f(e2[j]);
        }
        const float* ct = tab + cur.ang;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float co = ct[j], sn = ct[half + j];
          o1[j] = __fsub_rn(__fmul_rn(x1[j], co), __fmul_rn(x2[j], sn));
          o2[j] = __fadd_rn(__fmul_rn(x1[j], sn), __fmul_rn(x2[j], co));
        }
        T* q = out + r0 * row_elems + cur.off;
        repro::store_vec<T, V>(q, o1);
        repro::store_vec<T, V>(q + half, o2);
      }
      cur = nxt;
      a1 = b1;
      a2 = b2;
    }
    // the unrotated tail of the step's rows and heads, V elements at a time
    const int tv = (D - 2 * half) / V;
    for (int k = tid; k < R * H * tv; k += nt) {
      const int r = k / (H * tv), rem = k - r * H * tv;
      const int h = rem / tv;
      if (r0 + r >= rows) break;
      const int64_t e = (r0 + r) * row_elems + static_cast<int64_t>(h) * D +
                        2 * half + (rem - h * tv) * V;
      *reinterpret_cast<RawT*>(out + e) = load_raw<T, VEC>(x + e);
    }
    if (nr0 >= rows) break;
    // the next step's angles into the other buffer: the rotation above
    // read this one, and the barrier keeps the next rotation after them
    angles(nr0, cs + ((it + 1) & 1) * R * 2 * half);
    __syncthreads();
    r0 = nr0;
  }
}

template <typename T, bool VEC>
int launch_impl(const void* x, const void* pos, void* out, int64_t rows,
                int S, int H, int D, int half, int64_t pos_sb, int64_t pos_ss,
                float base, int threads, int R, int grid,
                cudaStream_t stream) {
  constexpr int V = VEC ? 16 / sizeof(T) : 1;
  // two angle tables where a CTA walks more than one step
  const int bufs = static_cast<int64_t>(grid) * R < rows ? 2 : 1;
  const size_t smem = sizeof(float) * bufs * R * 2 * static_cast<size_t>(half);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int hv = half / V;
  int hv_shift = -1;
  if (hv > 0 && (hv & (hv - 1)) == 0)
    for (hv_shift = 0; (1 << hv_shift) < hv; ++hv_shift) {}
  // 1/half rounded once, as the device would (IEEE single division)
  const float inv_half = 1.f / static_cast<float>(half);
  rope_kernel<T, VEC><<<static_cast<unsigned>(grid), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(pos),
      static_cast<T*>(out), static_cast<int>(rows), S, H, D, half, pos_sb,
      pos_ss, base, inv_half, R, grid * R, hv_shift);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* pos, void* out, int64_t rows, int S,
           int H, int D, int half, int64_t pos_sb, int64_t pos_ss, float base,
           int width, int threads, int R, int grid, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (width == V) {  // the plan's 16-byte vectors must be possible
    if (half % V || D % V || !repro::aligned16(x) || !repro::aligned16(out))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_impl<T, true>(x, pos, out, rows, S, H, D, half, pos_sb,
                                pos_ss, base, threads, R, grid, stream);
  }
  if (width != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_impl<T, false>(x, pos, out, rows, S, H, D, half, pos_sb,
                               pos_ss, base, threads, R, grid, stream);
}

}  // namespace

// The plan (kernels/rope.py RopePlan): `width` values a vector (16 bytes'
// worth, or 1), `threads` a CTA (a multiple of 32), `rows_per_cta` rows a
// step of a CTA and `grid` CTAs. A plan it has no instantiation for
// returns cudaErrorInvalidValue.
extern "C" int repro_rope(const void* x, const void* pos, void* out,
                          int64_t rows, int S, int H, int D, int half,
                          int64_t pos_sb, int64_t pos_ss, float base,
                          int width, int threads, int rows_per_cta, int grid,
                          int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // half <= 6144 keeps one angle table within the default 48 KB
  if (rows <= 0 || rows > 0x7fffffff || S <= 0 || rows % S || H <= 0 ||
      D <= 0 || half < 0 || 2 * half > D || half > 6144)
    return static_cast<int>(cudaErrorInvalidValue);
  if (threads < 32 || threads > kMaxThreads || threads % 32 ||
      rows_per_cta < 1 || grid < 1 ||
      static_cast<int64_t>(rows_per_cta) * H * D > 0x7fffffff ||
      rows + static_cast<int64_t>(grid) * rows_per_cta > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch<float>(x, pos, out, rows, S, H, D, half, pos_sb, pos_ss,
                         base, width, threads, rows_per_cta, grid, s);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(x, pos, out, rows, S, H, D, half, pos_sb,
                                 pos_ss, base, width, threads, rows_per_cta,
                                 grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
