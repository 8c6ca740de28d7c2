// One-query decode attention over a per-row valid KV prefix.
//
// Replaces the TPU kernel `_decode_kernel` (shared body
// `_online_softmax_step`) reached through `decode_core` in
// src/repro/kernels/attn_template.py (pallas_call at :335).
//
// q (B,1,Hq,Dk), k (B,T,Hkv,Dk), v (B,T,Hkv,Dv), lengths (B,) int32
// -> o (B,1,Hq,Dv): row b attends keys [0, lengths[b]).
//
// Bound on the card: bytes. Every valid KV row is read once for about
// 4*G*D flops (G = Hq/Hkv queries share it), well under the card's
// flop/byte balance. What the design does:
//   * one CTA per (b, kv-head) that holds the whole GQA group, so each K/V
//     row is read from device memory once for all G query heads (the TPU
//     kernel padded each single query row to an 8-row block per head);
//   * the CTA reads lengths[b] itself from device memory (no scalar
//     prefetch) and loops over 64-key tiles only up to lengths[b], never
//     over the whole cache depth T;
//   * tiles are staged with 16-byte loads all in flight together
//     (common.cuh stage_rows), where the head dims allow it;
//   * the online (m, l, acc) live in shared memory in f32; one warp runs
//     the softmax update of a head's 64 scores with two shuffles;
//   * lengths[b] == 0 (a dead slot) runs no tile and emits exact zeros.
// Splitting T across CTAs (for few rows and long caches) comes later.
#include "common.cuh"

namespace {

constexpr int kBK = 64;        // keys per staged tile (two per lane)
constexpr int kThreads = 256;
constexpr int kDMax = 128;     // largest Dk and Dv taken
constexpr int kGMax = 32;      // largest GQA group taken

size_t smem_bytes(int g, int dk, int dv) {
  return sizeof(float) *
         (static_cast<size_t>(g) * dk + static_cast<size_t>(kBK) * (dk + 1) +
          static_cast<size_t>(kBK) * dv + static_cast<size_t>(g) * kBK +
          static_cast<size_t>(g) * dv + 3 * static_cast<size_t>(g));
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ lengths,
                  T* __restrict__ o, int Tlen, int Hq, int Hkv, int Dk, int Dv,
                  float scale) {
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  const int ldk = Dk + 1;
  float* Qs = smem;               // G x Dk
  float* Ks = Qs + G * Dk;        // kBK x ldk
  float* Vs = Ks + kBK * ldk;     // kBK x Dv
  float* Ss = Vs + kBK * Dv;      // G x kBK: scores, then probabilities
  float* Acc = Ss + G * kBK;      // G x Dv
  float* Ml = Acc + G * Dv;       // G x (m, l, corr)

  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(lengths[b], 0), Tlen);

  // the group's G query heads are contiguous in q[b, 0, :, :]
  const int64_t qbase = (static_cast<int64_t>(b) * Hq + static_cast<int64_t>(hk) * G) * Dk;
  for (int i = tid; i < G * Dk; i += kThreads) Qs[i] = repro::to_f(q[qbase + i]);
  for (int i = tid; i < G * Dv; i += kThreads) Acc[i] = 0.f;
  for (int g = tid; g < G; g += kThreads) {
    Ml[3 * g] = repro::kNegInf;
    Ml[3 * g + 1] = 0.f;
    Ml[3 * g + 2] = 1.f;
  }

  for (int k0 = 0; k0 < len; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    const int valid = min(kBK, len - k0);
    const int64_t row0 = static_cast<int64_t>(b) * Tlen + k0;
    repro::stage_rows<T, kBK, kThreads, kDMax, VEC>(
        Ks, ldk, k + (row0 * Hkv + hk) * Dk, static_cast<int64_t>(Hkv) * Dk,
        valid, Dk);
    repro::stage_rows<T, kBK, kThreads, kDMax, VEC>(
        Vs, Dv, v + (row0 * Hkv + hk) * Dv, static_cast<int64_t>(Hkv) * Dv,
        valid, Dv);
    __syncthreads();

    for (int i = tid; i < G * kBK; i += kThreads) {
      const int g = i / kBK, c = i % kBK;
      float s = 0.f;
      for (int dd = 0; dd < Dk; ++dd) s += Qs[g * Dk + dd] * Ks[c * ldk + dd];
      Ss[i] = (k0 + c < len) ? s * scale : repro::kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kThreads / 32) {
      const float a = Ss[g * kBK + lane], c = Ss[g * kBK + lane + 32];
      const float m_old = Ml[3 * g];
      const float m_new = fmaxf(m_old, repro::warp_max(fmaxf(a, c)));
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      Ss[g * kBK + lane] = pa;
      Ss[g * kBK + lane + 32] = pc;
      const float ls = repro::warp_sum(pa + pc);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        Ml[3 * g] = m_new;
        Ml[3 * g + 1] = Ml[3 * g + 1] * corr + ls;
        Ml[3 * g + 2] = corr;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * Dv; i += kThreads) {
      const int g = i / Dv, dd = i % Dv;
      float a = Acc[i] * Ml[3 * g + 2];
      const float* p = Ss + g * kBK;
      for (int c = 0; c < kBK; ++c) a += p[c] * Vs[c * Dv + dd];
      Acc[i] = a;
    }
  }
  __syncthreads();

  const int64_t obase = (static_cast<int64_t>(b) * Hq + static_cast<int64_t>(hk) * G) * Dv;
  for (int i = tid; i < G * Dv; i += kThreads) {
    const int g = i / Dv;
    const bool seen = Ml[3 * g] > repro::kNegInf * 0.5f;
    o[obase + i] = repro::from_f<T>(seen ? Acc[i] / fmaxf(Ml[3 * g + 1], 1e-30f) : 0.f);
  }
}

template <typename T, bool VEC>
int launch_impl(const void* q, const void* k, const void* v,
                const void* lengths, void* o, int B, int Tlen, int Hq, int Hkv,
                int Dk, int Dv, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(Hq / Hkv, Dk, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_kernel<T, VEC><<<static_cast<unsigned>(B) * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(o), Tlen, Hq, Hkv, Dk, Dv, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* o, int B, int Tlen, int Hq, int Hkv, int Dk, int Dv,
           float scale, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = Dk % V == 0 && Dv % V == 0 && repro::aligned16(k) &&
                   repro::aligned16(v);
  return vec ? launch_impl<T, true>(q, k, v, lengths, o, B, Tlen, Hq, Hkv, Dk,
                                    Dv, scale, stream)
             : launch_impl<T, false>(q, k, v, lengths, o, B, Tlen, Hq, Hkv, Dk,
                                     Dv, scale, stream);
}

}  // namespace

extern "C" int repro_decode(const void* q, const void* k, const void* v,
                            const void* lengths, void* o, int B, int Tlen,
                            int Hq, int Hkv, int Dk, int Dv, float scale,
                            int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || Tlen < 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv ||
      Hq / Hkv > kGMax || Dk <= 0 || Dk > kDMax || Dv <= 0 || Dv > kDMax)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch<float>(q, k, v, lengths, o, B, Tlen, Hq, Hkv, Dk, Dv, scale, s);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(q, k, v, lengths, o, B, Tlen, Hq, Hkv, Dk, Dv,
                                 scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
