// The gated FFN activations, out = act(gate) * up in f32, rounded once:
//   SwiGLU  act = silu(g) = g * sigmoid(g)
//   GeGLU   act = gelu_tanh(g) = 0.5 g (1 + tanh(sqrt(2/pi) (g + 0.044715 g^3)))
//
// Replaces the TPU kernels `_swiglu_kernel` and `_geglu_kernel`, reached
// through `_glu_call` (pallas_call at :47) from `swiglu` and `geglu` in
// src/repro/kernels/swiglu.py. GeGLU is `jax.nn.gelu(approximate=True)`;
// it uses tanhf, not the tanh.approx.f32 intrinsic, whose error near 0 is
// several bf16 ulps of the product.
//
// Bound on the card: bytes. Two reads and one write per element against
// ~6-10 flops and one exp or tanh. The design does about that: one
// grid-stride pass over the flattened tensor (so no 256x512 tile padding is
// read or written), 16-byte vector loads and stores of both operands where
// the length and the pointers allow it, and a scalar tail. The grid is
// capped at a few blocks per SM; each thread walks the tensor with the
// grid's stride so the launch size does not grow with the tensor. One
// elementwise template over the activation serves both entries.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Silu {
  __device__ __forceinline__ float operator()(float g) const {
    return g * (1.f / (1.f + expf(-g)));
  }
};

struct GeluTanh {
  __device__ __forceinline__ float operator()(float g) const {
    constexpr float kSqrt2OverPi = 0.7978845608028654f;
    return 0.5f * g * (1.f + tanhf(kSqrt2OverPi * (g + 0.044715f * g * g * g)));
  }
};

template <typename T, typename Act>
__global__ void __launch_bounds__(kThreads)
    glu_kernel(const T* __restrict__ gate, const T* __restrict__ up,
               T* __restrict__ out, int64_t n, int vec_ok) {
  constexpr int V = 16 / sizeof(T);
  const Act act;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t nv = vec_ok ? n / V : 0;
  const uint4* gv = reinterpret_cast<const uint4*>(gate);
  const uint4* uv = reinterpret_cast<const uint4*>(up);
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (int64_t i = tid; i < nv; i += stride) {
    uint4 ug = gv[i], uu = uv[i], uo;
    const T* eg = reinterpret_cast<const T*>(&ug);
    const T* eu = reinterpret_cast<const T*>(&uu);
    T* eo = reinterpret_cast<T*>(&uo);
#pragma unroll
    for (int j = 0; j < V; ++j)
      eo[j] = repro::from_f<T>(act(repro::to_f(eg[j])) * repro::to_f(eu[j]));
    ov[i] = uo;
  }
  for (int64_t i = nv * V + tid; i < n; i += stride)
    out[i] = repro::from_f<T>(act(repro::to_f(gate[i])) * repro::to_f(up[i]));
}

template <typename T, typename Act>
void launch(const void* gate, const void* up, void* out, int64_t n,
            cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int vec_ok = repro::aligned16(gate) && repro::aligned16(up) &&
                     repro::aligned16(out);
  const int64_t work = vec_ok ? n / V + n % V : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 16;  // 16 blocks for each of the H100's 132 SMs
  if (blocks > cap) blocks = cap;
  glu_kernel<T, Act><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(gate), static_cast<const T*>(up),
      static_cast<T*>(out), n, vec_ok);
}

template <typename Act>
int entry(const void* gate, const void* up, void* out, int64_t n, int dtype,
          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    launch<float, Act>(gate, up, out, n, s);
  else if (dtype == repro::kBF16)
    launch<__nv_bfloat16, Act>(gate, up, out, n, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_swiglu(const void* gate, const void* up, void* out,
                            int64_t n, int dtype, int device, void* stream) {
  return entry<Silu>(gate, up, out, n, dtype, device, stream);
}

extern "C" int repro_geglu(const void* gate, const void* up, void* out,
                           int64_t n, int dtype, int device, void* stream) {
  return entry<GeluTanh>(gate, up, out, n, dtype, device, stream);
}
