// Per-row softmax cross-entropy over a large vocabulary:
//   loss[i] = logsumexp(logits[i, :]) - logits[i, labels[i]]   (f32)
//
// Replaces the TPU kernel `_xent_kernel` (src/repro/kernels/softmax_xent.py
// :26), reached through `softmax_xent` (pallas_call at :69). As there, the
// row is read once, with an online (m, l) logsumexp and the picked label
// logit carried alongside; nothing of size V is written.
//
// Bound on the card: bytes. Each logit is read once for a max, a subtract,
// an exp and an add; at (256, 32000) f32 that is 32.8 MB, 9.8 us at
// 3.35 TB/s. The design does about that:
//   * one block of 256 threads per row (the TPU's sequential vocab grid
//     dimension becomes a loop inside the block); every thread keeps its
//     own running (m, l, picked) in registers, and the block combines them
//     at the end by warp shuffles, then across the eight warps through
//     shared memory;
//   * 16-byte vector loads (4 f32 or 8 bf16 logits), four of them issued
//     before any is used, so a thread has 64 bytes in flight; f32 math
//     whatever the input dtype;
//   * rows whose start is not 16-byte aligned (V not a multiple of the
//     vector width) take scalar loads;
//   * the row is walked in tiles of 256 columns, and the columns of the
//     last tile past V are masked to NEG_INF (softmax_xent.py:37), so they
//     add exp(NEG_INF - m) = 0 to l and read nothing;
//   * the label logit is found by comparing column indices with the label
//     (softmax_xent.py:39), never by indexing memory with it: a label
//     outside [0, V) picks nothing and gives logsumexp.
// With few rows one block a row fills few of the 132 SMs (8 rows of
// gemma3's 262144 logits run on 8 SMs); a split of V across blocks with a
// combine pass is the fix for that, not made here.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

struct Online {
  float m = repro::kNegInf;  // running max
  float l = 0.f;             // sum of exp(x - m)
  float pick = 0.f;          // the label logit

  // fold in n values at once: one rescale of l for the group
  template <int N>
  __device__ __forceinline__ void add(const float (&x)[N]) {
    float mx = m;
#pragma unroll
    for (int j = 0; j < N; ++j) mx = fmaxf(mx, x[j]);
    float s = l * expf(m - mx);
#pragma unroll
    for (int j = 0; j < N; ++j) s += expf(x[j] - mx);
    m = mx;
    l = s;
  }

  __device__ __forceinline__ void merge(float m2, float l2, float p2) {
    const float mx = fmaxf(m, m2);
    l = l * expf(m - mx) + l2 * expf(m2 - mx);
    m = mx;
    pick += p2;
  }
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    xent_kernel(const T* __restrict__ logits, const int64_t* __restrict__ labels,
                float* __restrict__ out, int64_t vocab) {
  constexpr int V = 16 / sizeof(T);
  const T* row = logits + static_cast<int64_t>(blockIdx.x) * vocab;
  const int64_t label = labels[blockIdx.x];
  Online acc;

  int64_t done = 0;  // columns covered by the vector loop
  if constexpr (VEC) {
    const int64_t nvec = vocab / V;
    constexpr int64_t kStep = static_cast<int64_t>(kThreads) * kUnroll;
    const int64_t nfull = nvec / kStep * kStep;
    for (int64_t base = 0; base < nfull; base += kStep) {
      uint4 buf[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        buf[u] = reinterpret_cast<const uint4*>(row)[base + u * kThreads + threadIdx.x];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t c0 = (base + u * kThreads + threadIdx.x) * V;
        const T* e = reinterpret_cast<const T*>(&buf[u]);
        float x[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          x[j] = repro::to_f(e[j]);
          if (c0 + j == label) acc.pick = x[j];
        }
        acc.add(x);
      }
    }
    for (int64_t i = nfull + threadIdx.x; i < nvec; i += kThreads) {
      float x[V];
      repro::load_vec<T, V>(x, row + i * V);
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (i * V + j == label) acc.pick = x[j];
      acc.add(x);
    }
    done = nvec * V;
  }
  // the rest of the row, in tiles of kThreads columns; the last tile's
  // columns past the vocabulary are masked
  const int64_t padded = done + (vocab - done + kThreads - 1) / kThreads * kThreads;
  for (int64_t c = done + threadIdx.x; c < padded; c += kThreads) {
    const bool in_vocab = c < vocab;
    const float xv = in_vocab ? repro::to_f(row[c]) : repro::kNegInf;
    if (in_vocab && c == label) acc.pick = xv;
    const float x[1] = {xv};
    acc.add(x);
  }

  // combine the 256 partial (m, l, pick): warps, then across warps
  __shared__ float sm[kThreads / 32], sl[kThreads / 32], sp[kThreads / 32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, acc.m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, acc.l, o);
    const float p2 = __shfl_xor_sync(0xffffffffu, acc.pick, o);
    acc.merge(m2, l2, p2);
  }
  if (lane == 0) {
    sm[wid] = acc.m;
    sl[wid] = acc.l;
    sp[wid] = acc.pick;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    Online tot;
    for (int w = 0; w < kThreads / 32; ++w) tot.merge(sm[w], sl[w], sp[w]);
    const float lse = tot.m + logf(fmaxf(tot.l, 1e-30f));
    out[blockIdx.x] = lse - tot.pick;
  }
}

template <typename T>
int launch(const void* logits, const void* labels, void* out, int64_t rows,
           int64_t vocab, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = vocab % V == 0 && repro::aligned16(logits);
  const unsigned grid = static_cast<unsigned>(rows);
  if (vec)
    xent_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(logits), static_cast<const int64_t*>(labels),
        static_cast<float*>(out), vocab);
  else
    xent_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(logits), static_cast<const int64_t*>(labels),
        static_cast<float*>(out), vocab);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (rows,) f32 = per-row cross-entropy of logits (rows, vocab) of
// `dtype` against int64 labels (rows,).
extern "C" int repro_softmax_xent(const void* logits, const void* labels,
                                  void* out, int64_t rows, int64_t vocab,
                                  int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || rows > 0x7fffffff || vocab <= 0 || !logits || !labels || !out)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) return launch<float>(logits, labels, out, rows, vocab, s);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(logits, labels, out, rows, vocab, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
