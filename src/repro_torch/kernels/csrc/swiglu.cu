// The gated FFN activations, out = act(gate) * up in f32, rounded once:
//   SwiGLU  act = silu(g) = g * sigmoid(g)
//   GeGLU   act = gelu_tanh(g) = 0.5 g (1 + tanh(sqrt(2/pi) (g + 0.044715 g^3)))
//
// Replaces the TPU kernels `_swiglu_kernel` and `_geglu_kernel`, reached
// through `_glu_call` (pallas_call at :47) from `swiglu` and `geglu` in
// src/repro/kernels/swiglu.py. GeGLU is `jax.nn.gelu(approximate=True)`.
//
// Bound on the card: bytes. Two reads and one write per element against
// ~10 f32 operations. The design:
//   * one pass over the flattened tensor (so no 256x512 tile padding is
//     read or written), in one step: a thread takes one vector of `width`
//     elements of each operand, its loads go out first, and a tensor of
//     any size is as many CTAs as its vectors need; the last partial
//     vector is done one element a thread;
//   * the launch plan comes from the sizes alone (kernels/swiglu.py
//     glu_plan): 8-byte accesses where the pointers allow them, scalars
//     otherwise, CTAs of 128 threads. On an H100, 16-byte accesses were
//     up to 5 % slower at the decode step (each thread's activation chain
//     after its loads is twice as long) and within 3 % at prefill; a
//     resident grid walking the tensor by its stride, the next step's
//     loads issued ahead, was 3 % slower at gemma3-27b's prefill than one
//     step of plain CTAs (PERF.md §6);
//   * one exponential and one reciprocal an element, by the exact
//     identities silu(g) = g / (1 + e^-g) and 0.5 (1 + tanh(z)) =
//     1 / (1 + e^-2z), on the MUFU (ex2.approx.ftz, rcp.approx through
//     __fdividef), in place of expf, an IEEE division and tanhf: a third
//     of the instructions. Where e^-2z overflows, g^3 overflows or the
//     denominator passes 2^126 the quotient goes to the right signed zero
//     or to g. Not tanh.approx.f32: its error near 0 is several bf16 ulps
//     of the product.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

// 2^x on the MUFU (relative error ~2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

struct Silu {
  __device__ __forceinline__ float operator()(float g) const {
    return __fdividef(g, 1.f + ex2(-kLog2e * g));
  }
};

struct GeluTanh {
  // -2 sqrt(2/pi) log2(e): e^-2z = 2^(kGeluArg (g + 0.044715 g^3))
  static constexpr float kGeluArg = -2.f * 0.7978845608028654f * kLog2e;
  __device__ __forceinline__ float operator()(float g) const {
    return __fdividef(g, 1.f + ex2(kGeluArg * (g + 0.044715f * g * g * g)));
  }
};

// one access of BYTES bytes: the 8-byte vector, or one element
template <int BYTES> struct Access;
template <> struct Access<8> { using type = uint2; };
template <> struct Access<4> { using type = unsigned; };
template <> struct Access<2> { using type = unsigned short; };

// Thread i of the grid takes vector i (of BYTES / sizeof(T) elements) of
// each operand, and element nv * W + i of the last partial vector.
template <typename T, typename Act, int BYTES>
__global__ void __launch_bounds__(kMaxThreads)
    glu_kernel(const T* __restrict__ gate, const T* __restrict__ up,
               T* __restrict__ out, int64_t n) {
  using V = typename Access<BYTES>::type;
  constexpr int W = BYTES / sizeof(T);
  const Act act;
  const int64_t nv = n / W;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < nv) {
    const V g = reinterpret_cast<const V*>(gate)[i];
    const V u = reinterpret_cast<const V*>(up)[i];
    const T* eg = reinterpret_cast<const T*>(&g);
    const T* eu = reinterpret_cast<const T*>(&u);
    V o;
    T* eo = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int j = 0; j < W; ++j)
      eo[j] = repro::from_f<T>(act(repro::to_f(eg[j])) * repro::to_f(eu[j]));
    reinterpret_cast<V*>(out)[i] = o;
  }
  const int64_t t = nv * W + i;
  if (t < n)
    out[t] = repro::from_f<T>(act(repro::to_f(gate[t])) * repro::to_f(up[t]));
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The plan's instantiation (8-byte accesses, or scalars), or
// cudaErrorInvalidValue.
template <typename T, typename Act>
int launch(const void* gate, const void* up, void* out, int64_t n, int width,
           int threads, int grid, cudaStream_t s) {
  const int bytes = width * static_cast<int>(sizeof(T));
  if ((width != 1 && bytes != 8) || !aligned(gate, bytes) ||
      !aligned(up, bytes) || !aligned(out, bytes) ||
      static_cast<int64_t>(grid) * threads < n / width)  // a vector left out
    return static_cast<int>(cudaErrorInvalidValue);
  const T* g = static_cast<const T*>(gate);
  const T* u = static_cast<const T*>(up);
  T* o = static_cast<T*>(out);
  if (bytes == 8)
    glu_kernel<T, Act, 8><<<grid, threads, 0, s>>>(g, u, o, n);
  else
    glu_kernel<T, Act, sizeof(T)><<<grid, threads, 0, s>>>(g, u, o, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename Act>
int entry(const void* gate, const void* up, void* out, int64_t n, int width,
          int threads, int grid, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || threads < 32 || threads > kMaxThreads || threads % 32 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch<float, Act>(gate, up, out, n, width, threads, grid, s);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16, Act>(gate, up, out, n, width, threads, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The plan (kernels/swiglu.py GluPlan): `width` elements an access (8
// bytes' worth, or 1), `threads` a CTA (a multiple of 32) and `grid` CTAs,
// at least one thread a vector. A plan it has no instantiation for
// returns cudaErrorInvalidValue.
extern "C" int repro_swiglu(const void* gate, const void* up, void* out,
                            int64_t n, int width, int threads, int grid,
                            int dtype, int device, void* stream) {
  return entry<Silu>(gate, up, out, n, width, threads, grid, dtype, device,
                     stream);
}

extern "C" int repro_geglu(const void* gate, const void* up, void* out,
                           int64_t n, int width, int threads, int grid,
                           int dtype, int device, void* stream) {
  return entry<GeluTanh>(gate, up, out, n, width, threads, grid, dtype, device,
                         stream);
}
