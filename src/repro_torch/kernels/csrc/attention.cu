// Flash attention with an online softmax (prefill / forward): causal,
// sliding-window and full masks.
//
// Replaces the TPU kernel `_template_kernel` (shared body
// `_online_softmax_step`) reached through `attention_core` in
// src/repro/kernels/attn_template.py (pallas_call at :275): its causal
// fragment (the decoder LMs' prefill), its window fragment (spec "window",
// :431: the sliding-window `local` layers' prefill, causal and
// `qpos - kpos < window`) and its full fragment (spec "full": the
// encoders' self-attention, and the detector's query refinement through
// `kops.attn_full_template`, where Sq != Skv). One kernel body,
// instantiated three times over the compile-time mask kind MASK; the
// window's span is a runtime argument.
//
// q (B,Sq,Hq,Dk), k (B,Skv,Hkv,Dk), v (B,Skv,Hkv,Dv) -> o (B,Sq,Hq,Dv),
// read and written in the JAX layout, so the wrapper transposes nothing.
//
// Bound on the card: bytes at this slice's prefill lengths (a 256-token
// bucket moves 8 MB for 0.5 GFLOP, under the card's ~295 flop/byte), but
// this version runs the products as f32 FMAs out of shared memory, far
// below the tensor cores' rate, so in practice its FMAs and shared-memory
// loads bound it. What the design does:
//   * one CTA of 256 threads per (b*Hq, 64-row q tile); the TPU grid's
//     sequential KV axis becomes a loop inside the CTA, over 64-key tiles
//     staged in shared memory. Causal, the loop stops at the causal limit
//     of the tile, so the masked upper triangle is never loaded; window,
//     it also starts at the first tile any row of the q tile can see
//     (q_offset + q0 - window + 1, rounded down to a tile), so a 2048-token
//     prefill with a 1024 window visits at most 17 of 32 tiles; the TPU
//     grid's walk over every tile is not carried over. Full, it runs to
//     Skv and masks only the ragged last tile (Skv 196 and 197 are not
//     multiples of 64). q_offset has no effect on the full mask, as in the
//     JAX template;
//   * tiles are staged with 16-byte loads all in flight together
//     (common.cuh stage_rows), where the head dims allow it;
//   * register tiling: thread t owns 4 query rows (t/16) and every 16th
//     score and output column (t%16), so each shared-memory load feeds
//     4 FMAs in the products; a row's max and sum reduce over the 16
//     lanes of its row group with four shuffles;
//   * the running (m, l, acc) stay in registers in f32;
//   * GQA is an index: the KV head is h / (Hq/Hkv), nothing is replicated;
//   * shared-memory rows are padded by one float so the column walks hit
//     distinct banks;
//   * NEG_INF is the finite -1e30 of the JAX kernels. A tile in which a
//     row sees no key adds exp(0) terms while its max is still NEG_INF;
//     the first visible key rescales them by exp(NEG_INF - m) = 0, as in
//     the TPU body. A row that saw no key at all (Skv == 0, a window past
//     the keys) leaves the epilogue as exact zeros.
// mma/wgmma tiles, TMA staging and a split over KV come in later work.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per staged tile
constexpr int kThreads = 256;
constexpr int kRows = 4;       // query rows per thread
constexpr int kGroup = 16;     // threads per row group (one half warp)
constexpr int kDMax = 128;     // largest Dk and Dv taken
constexpr int kSCols = kBK / kGroup;    // score columns per thread
constexpr int kOCols = kDMax / kGroup;  // output columns per thread

// the mask fragments (MASK): causal, causal within a window, full
constexpr int kCausal = 0;
constexpr int kWindow = 1;
constexpr int kFull = 2;

size_t smem_bytes(int dk, int dv) {
  return sizeof(float) *
         (static_cast<size_t>(kBQ) * (dk + 1) + static_cast<size_t>(kBK) * (dk + 1) +
          static_cast<size_t>(kBK) * dv + static_cast<size_t>(kBQ) * (kBK + 1));
}

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 1; o < kGroup; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < kGroup; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, bool VEC, int MASK>
__global__ void __launch_bounds__(kThreads)
    attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Skv, int Hq, int Hkv, int Dk, int Dv, int q_offset,
                       int window, float scale) {
  extern __shared__ float smem[];
  const int ldq = Dk + 1, ldk = Dk + 1, ldp = kBK + 1;
  float* Qs = smem;              // kBQ x ldq
  float* Ks = Qs + kBQ * ldq;    // kBK x ldk
  float* Vs = Ks + kBK * ldk;    // kBK x Dv
  float* Ps = Vs + kBK * Dv;     // kBQ x ldp

  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int r0 = (tid / kGroup) * kRows;  // first query row of this thread
  const int cg = tid % kGroup;            // column phase

  repro::stage_rows<T, kBQ, kThreads, kDMax, VEC>(
      Qs, ldq, q + ((static_cast<int64_t>(b) * Sq + q0) * Hq + h) * Dk,
      static_cast<int64_t>(Hq) * Dk, min(kBQ, Sq - q0), Dk);

  float m_i[kRows], l_i[kRows], acc[kRows][kOCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_i[i] = repro::kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOCols; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + kBQ, Sq) - 1;  // last real row
  const int kv_end = MASK == kFull ? Skv
                                   : min(Skv, q_offset + q_last + 1);  // causal limit
  // window: the first tile the tile's first row (the earliest) can see
  const int kv_begin =
      MASK == kWindow ? max(0, q_offset + q0 - window + 1) / kBK * kBK : 0;
  const int64_t kv_stride_k = static_cast<int64_t>(Hkv) * Dk;
  const int64_t kv_stride_v = static_cast<int64_t>(Hkv) * Dv;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and Q is stored)
    const int valid = min(kBK, Skv - k0);
    const int64_t row0 = static_cast<int64_t>(b) * Skv + k0;
    repro::stage_rows<T, kBK, kThreads, kDMax, VEC>(
        Ks, ldk, k + (row0 * Hkv + hk) * Dk, kv_stride_k, valid, Dk);
    repro::stage_rows<T, kBK, kThreads, kDMax, VEC>(
        Vs, Dv, v + (row0 * Hkv + hk) * Dv, kv_stride_v, valid, Dv);
    __syncthreads();

    float s[kRows][kSCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kSCols; ++j) s[i][j] = 0.f;
    for (int dd = 0; dd < Dk; ++dd) {
      float qv[kRows], kv[kSCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(r0 + i) * ldq + dd];
#pragma unroll
      for (int j = 0; j < kSCols; ++j) kv[j] = Ks[(cg + kGroup * j) * ldk + dd];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kSCols; ++j) s[i][j] += qv[i] * kv[j];
    }

    float corr[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q_offset + q0 + r0 + i;
      float mt = repro::kNegInf;
#pragma unroll
      for (int j = 0; j < kSCols; ++j) {
        const int kpos = k0 + cg + kGroup * j;
        bool visible = kpos < Skv;  // the ragged last KV tile
        if constexpr (MASK != kFull) visible = visible && qpos >= kpos;
        if constexpr (MASK == kWindow) visible = visible && qpos - kpos < window;
        s[i][j] = visible ? s[i][j] * scale : repro::kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], group_max(mt));
      corr[i] = expf(m_i[i] - m_new);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < kSCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        ls += p;
        Ps[(r0 + i) * ldp + cg + kGroup * j] = p;
      }
      l_i[i] = l_i[i] * corr[i] + group_sum(ls);
      m_i[i] = m_new;
    }
    __syncwarp();  // a row group's 16 threads share one warp

#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kOCols; ++j) acc[i][j] *= corr[i];
    for (int c = 0; c < kBK; ++c) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = Ps[(r0 + i) * ldp + c];
#pragma unroll
      for (int j = 0; j < kOCols; ++j) {
        const int dd = cg + kGroup * j;
        if (dd < Dv) {
          const float vv = Vs[c * Dv + dd];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] += p[i] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int s_out = q0 + r0 + i;
    if (s_out >= Sq) continue;
    // a row that never saw a key keeps m at NEG_INF: emit zeros, not mean(v)
    const bool seen = m_i[i] > repro::kNegInf * 0.5f;
    const float l = fmaxf(l_i[i], 1e-30f);
    T* orow = o + ((static_cast<int64_t>(b) * Sq + s_out) * Hq + h) * Dv;
#pragma unroll
    for (int j = 0; j < kOCols; ++j) {
      const int dd = cg + kGroup * j;
      if (dd < Dv) orow[dd] = repro::from_f<T>(seen ? acc[i][j] / l : 0.f);
    }
  }
}

template <typename T, bool VEC, int MASK>
int launch_impl(const void* q, const void* k, const void* v, void* o, int B,
                int Sq, int Skv, int Hq, int Hkv, int Dk, int Dv,
                int q_offset, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(Dk, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<T, VEC, MASK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>(B) * Hq, (Sq + kBQ - 1) / kBQ);
  attn_kernel<T, VEC, MASK><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, Hq, Hkv, Dk, Dv,
      q_offset, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MASK>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int Hq, int Hkv, int Dk, int Dv, int q_offset,
           int window, float scale, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = Dk % V == 0 && Dv % V == 0 && repro::aligned16(q) &&
                   repro::aligned16(k) && repro::aligned16(v);
  return vec ? launch_impl<T, true, MASK>(q, k, v, o, B, Sq, Skv, Hq, Hkv, Dk,
                                          Dv, q_offset, window, scale, stream)
             : launch_impl<T, false, MASK>(q, k, v, o, B, Sq, Skv, Hq, Hkv, Dk,
                                           Dv, q_offset, window, scale, stream);
}

template <int MASK>
int entry(const void* q, const void* k, const void* v, void* o, int B, int Sq,
          int Skv, int Hq, int Hkv, int Dk, int Dv, int q_offset, int window,
          float scale, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || Sq <= 0 || Skv < 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv ||
      Dk <= 0 || Dk > kDMax || Dv <= 0 || Dv > kDMax || q_offset < 0 ||
      window <= 0 || (Sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch<float, MASK>(q, k, v, o, B, Sq, Skv, Hq, Hkv, Dk, Dv,
                               q_offset, window, scale, s);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16, MASK>(q, k, v, o, B, Sq, Skv, Hq, Hkv, Dk, Dv,
                                       q_offset, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// causal: query row i sits at q_offset + i and sees keys up to it
extern "C" int repro_attention_causal(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int Hq, int Hkv, int Dk, int Dv,
                                      int q_offset, float scale, int dtype,
                                      int device, void* stream) {
  return entry<kCausal>(q, k, v, o, B, Sq, Skv, Hq, Hkv, Dk, Dv, q_offset, 1,
                        scale, dtype, device, stream);
}

// window: causal, and query row i sees only keys at q_offset + i - kpos <
// window (the sliding-window `local` layers)
extern "C" int repro_attention_window(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int Hq, int Hkv, int Dk, int Dv,
                                      int q_offset, int window, float scale,
                                      int dtype, int device, void* stream) {
  return entry<kWindow>(q, k, v, o, B, Sq, Skv, Hq, Hkv, Dk, Dv, q_offset,
                        window, scale, dtype, device, stream);
}

// full: every key is visible (KV padding only); Sq != Skv allowed
extern "C" int repro_attention_full(const void* q, const void* k,
                                    const void* v, void* o, int B, int Sq,
                                    int Skv, int Hq, int Hkv, int Dk, int Dv,
                                    float scale, int dtype, int device,
                                    void* stream) {
  return entry<kFull>(q, k, v, o, B, Sq, Skv, Hq, Hkv, Dk, Dv, 0, 1, scale,
                      dtype, device, stream);
}
