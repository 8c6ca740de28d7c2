// The flash-attention backward: dQ, dK and dV from q, k, v, the forward's
// output o and its rows' log-sum-exp lse (attention_lse.cu), and dO.
//
// Replaces no Pallas kernel: the TPU side differentiates its attention with
// the flash custom VJP of the jnp twin, `_flash_core` (src/repro/models/
// attention.py:327-348), whose backward `_flash_bwd_impl` (:243-324) is a
// chunked, hand-scheduled recompute of the score tiles from (q, k, v, o,
// lse). This is its counterpart on the card, with its arithmetic:
//   delta = rowsum(dO * O) in f32;
//   p  = exp(s * scale - lse), s = q.k accumulated in f32;
//   dp = dO.v;  ds = p * (dp - delta) * scale, rounded to q's dtype before
//   its two products; p rounded to dO's dtype for dV;
//   dQ = ds.K, dK = ds^T.Q, dV = p^T.dO, every product accumulated in f32.
// A masked (q, k) pair gives exactly 0 (a select, not exp(NEG_INF - lse)),
// so a row that sees no key has zero gradients and a stale key past every
// row's limit gives no NaN.
//
// q (B,Sq,Hq,Dk), k (B,Skv,Hkv,Dk), v (B,Skv,Hkv,Dv), o and dO (B,Sq,Hq,Dv),
// lse (B,Hq,Sq) f32 -> dq, dk, dv in the inputs' layouts and dtypes; the
// masks of the forward: causal, window (causal and qpos - kpos < window) and
// full, query row i at position q_offset + i; GQA by index, KV head
// h / (Hq/Hkv). Head dims Dk, Dv up to 128 (the forward's common bodies);
// the entry refuses MLA's (192, 128), 256 and a softcap (JAX's flash VJP
// takes no cap: its capped path is plain autodiff).
//
// Bound on the card. At granite-3-8b's training shape (q [2,2048,32,128],
// kv [2,2048,8,128] bf16, causal) the five products over the 134.3 M
// visible (q, k) pairs are 171.9 GFLOP, 0.174 ms at the dense bf16 rate,
// against 170 MB of operands and results (0.051 ms): operations.
//
// Design: deterministic, no float atomics; three launches on one stream.
//   (a) delta_kernel: one warp a (row, head): delta = rowsum(dO * O) in f32,
//       to f32 scratch (B, Hq, Sq).
//   (b) dkdv_kernel: one CTA per (batch, KV head, 64-key block). The block's
//       K and V stay in shared memory; the CTA loops over every query head
//       of its GQA group and, within it, over every 64-row query block that
//       can see the key block (causal: from the block's first key on;
//       window: up to its last key + window), and keeps dK and dV of its
//       64 keys in registers, f32: the group-sum that JAX gets from autodiff
//       through its head gather (attention.py:370-376) happens here in one
//       CTA, in a fixed order.
//   (c) dq_kernel: one CTA per (batch, query head, 64-row query block),
//       looping over the key tiles its rows can see (the forward's range),
//       dQ in registers. Keys past the tile's causal limit are zero-filled,
//       not read (the forward's rule for stale KV rows).
// Both (b) and (c) recompute the scores and dp; (b) takes 4 products a
// visible pair, (c) 3: 7 against the 5 of the bound.
//
// Two bodies, as the forward's:
//
// bf16 (dkdv_mma_kernel, dq_mma_kernel): the tensor cores, mma.sync
//   m16n8k16 on bf16 operands with f32 accumulation, the fragments of
//   attention.cu's mma body. A CTA is 4 warps of 16 rows (keys in (b), query
//   rows in (c)); tiles stay bf16 in shared memory, rows padded by 16 bytes,
//   loaded by 16-byte cp.async and read by ldmatrix (.trans where the
//   operand's k runs down the tile's rows). (b): S^T = K Q^T and dP^T = V
//   dO^T over a step of 32 query rows, K's and V's rows as the A operand;
//   P^T and dS^T leave their accumulators as the A fragments of dV += P^T dO
//   and dK += dS^T Q (FlashAttention-2's register reuse, transposed), dK and
//   dV in registers for the CTA's 64 keys. (c): Q's and dO's fragments in
//   registers for the CTA's 64 rows; S = Q K^T and dP = dO V^T over 32-key
//   tiles, dS the A fragments of dQ += dS K. p and ds are f32 in registers,
//   rounded to bf16 only as operands. Head dims that are multiples of 16
//   (64, 80, 128); others take the FMA body.
// f32, and bf16 at other head dims (dkdv_kernel, dq_kernel): the FMA body,
//   the forward's f32 layout: 256 threads on a 64 x 64 tile, tiles widened
//   to f32 in shared memory with odd row pitches, thread t owning 4 rows
//   (t / 16) and every 16th column, p and ds through shared memory to the
//   second pair of products.
// What it leaves, for later work: wgmma and TMA, a ring of stages in
// place of the synchronous tile loads, and a split of (b)'s serial loop
// over the group and the query blocks, granite-3-8b's longest chain
// (32 x 4 steps of 32 rows for the first key block).
#include "common.cuh"

namespace {

constexpr int kB = 64;          // query rows or keys of a tile
constexpr int kThreads = 256;
constexpr int kRows = 4;        // tile rows per thread
constexpr int kGroup = 16;      // threads per row group (one half warp)
constexpr int kCols = kB / kGroup;       // tile columns per thread
constexpr int kDMax = 128;      // largest Dk and Dv
constexpr int kOCols = kDMax / kGroup;   // gradient columns per thread

// the mask fragments, as attention.cu's
constexpr int kCausal = 0;
constexpr int kWindow = 1;
constexpr int kFull = 2;

template <int MASK>
__device__ __forceinline__ bool visible(int qpos, int kpos, int window) {
  bool vis = true;
  if constexpr (MASK != kFull) vis = qpos >= kpos;
  if constexpr (MASK == kWindow) vis = vis && qpos - kpos < window;
  return vis;
}

// x rounded to T and widened again
template <typename T>
__device__ __forceinline__ float rounded(float x) {
  return repro::to_f(repro::from_f<T>(x));
}

// (a) delta[b, h, s] = sum_c dO[b, s, h, c] * O[b, s, h, c] in f32
template <typename T>
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, int rows, int Sq, int Hq, int Dv) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // a whole warp leaves together
  const T* orow = o + static_cast<int64_t>(row) * Dv;
  const T* drow = dout + static_cast<int64_t>(row) * Dv;
  float s = 0.f;
  for (int c = lane; c < Dv; c += 32) s += repro::to_f(orow[c]) * repro::to_f(drow[c]);
  s = repro::warp_sum(s);
  if (lane == 0) {
    const int h = row % Hq, bs = row / Hq;
    const int b = bs / Sq, t = bs % Sq;
    delta[(static_cast<int64_t>(b) * Hq + h) * Sq + t] = s;
  }
}

size_t dkdv_smem_bytes(int dk, int dv) {
  return sizeof(float) * (2 * static_cast<size_t>(kB) * (dk + 1) +
                          2 * static_cast<size_t>(kB) * (dv + 1) +
                          2 * static_cast<size_t>(kB) * (kB + 1) + 2 * kB);
}

size_t dq_smem_bytes(int dk, int dv) {
  return sizeof(float) * (2 * static_cast<size_t>(kB) * (dk + 1) +
                          2 * static_cast<size_t>(kB) * (dv + 1) +
                          static_cast<size_t>(kB) * (kB + 1) + 2 * kB);
}

// (b) one CTA per (b * Hkv + hk, key block): dK and dV of 64 keys
template <typename T, bool VEC, int MASK>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv,
                int Hq, int Hkv, int Dk, int Dv, int q_offset, int window,
                float scale) {
  extern __shared__ float smem[];
  const int ldk = Dk + 1, ldv = Dv + 1, ldp = kB + 1;
  float* Ks = smem;              // kB keys x ldk
  float* Vs = Ks + kB * ldk;     // kB keys x ldv
  float* Qs = Vs + kB * ldv;     // kB rows x ldk
  float* dOs = Qs + kB * ldk;    // kB rows x ldv
  float* Ps = dOs + kB * ldv;    // kB keys x ldp: p, rounded to T
  float* dSs = Ps + kB * ldp;    // kB keys x ldp: ds, rounded to T
  float* lse_s = dSs + kB * ldp; // kB
  float* delta_s = lse_s + kB;   // kB

  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.y * kB;
  const int kvalid = min(kB, Skv - k0);
  const int tid = threadIdx.x;
  const int r0 = (tid / kGroup) * kRows;  // first key row of this thread
  const int cg = tid % kGroup;            // column phase

  const int64_t sk = static_cast<int64_t>(Hkv) * Dk;
  const int64_t sv = static_cast<int64_t>(Hkv) * Dv;
  repro::stage_rows<T, kB, kThreads, kDMax, VEC>(
      Ks, ldk, k + (static_cast<int64_t>(b) * Skv + k0) * sk + hk * Dk, sk,
      kvalid, Dk);
  repro::stage_rows<T, kB, kThreads, kDMax, VEC>(
      Vs, ldv, v + (static_cast<int64_t>(b) * Skv + k0) * sv + hk * Dv, sv,
      kvalid, Dv);

  float gk[kRows][kOCols], gv[kRows][kOCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kOCols; ++j) gk[i][j] = gv[i][j] = 0.f;

  // the query rows that can see a key of the block: from the block's first
  // key on (causal, window), up to its last key + window (window)
  const int q_lo = MASK == kFull ? 0 : max(0, k0 - q_offset);
  const int k_last = k0 + kvalid - 1;
  const int q_hi = MASK == kWindow ? min(Sq, k_last + window - q_offset) : Sq;
  const int64_t sq = static_cast<int64_t>(Hq) * Dk;
  const int64_t so = static_cast<int64_t>(Hq) * Dv;

  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    for (int q0 = q_lo / kB * kB; q0 < q_hi; q0 += kB) {
      __syncthreads();  // the previous tile is consumed (and K, V stored)
      const int qvalid = min(kB, Sq - q0);
      repro::stage_rows<T, kB, kThreads, kDMax, VEC>(
          Qs, ldk, q + (static_cast<int64_t>(b) * Sq + q0) * sq + h * Dk, sq,
          qvalid, Dk);
      repro::stage_rows<T, kB, kThreads, kDMax, VEC>(
          dOs, ldv, dout + (static_cast<int64_t>(b) * Sq + q0) * so + h * Dv,
          so, qvalid, Dv);
      if (tid < kB) {
        const int64_t at = (static_cast<int64_t>(b) * Hq + h) * Sq + q0 + tid;
        lse_s[tid] = tid < qvalid ? lse[at] : 0.f;
        delta_s[tid] = tid < qvalid ? delta[at] : 0.f;
      }
      __syncthreads();

      // S^T (keys x rows) and dP^T, this thread's 4 x 4 of each
      float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int d = 0; d < Dk; ++d) {
        float kr[kRows], qr[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) kr[i] = Ks[(r0 + i) * ldk + d];
#pragma unroll
        for (int j = 0; j < kCols; ++j) qr[j] = Qs[(cg + kGroup * j) * ldk + d];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) s[i][j] += kr[i] * qr[j];
      }
      for (int d = 0; d < Dv; ++d) {
        float vr[kRows], dr[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) vr[i] = Vs[(r0 + i) * ldv + d];
#pragma unroll
        for (int j = 0; j < kCols; ++j) dr[j] = dOs[(cg + kGroup * j) * ldv + d];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) dp[i][j] += vr[i] * dr[j];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int kpos = k0 + r0 + i;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int r = cg + kGroup * j;
          const bool vis = kpos < Skv && q0 + r < Sq &&
                           visible<MASK>(q_offset + q0 + r, kpos, window);
          const float p = vis ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
          const float ds = vis ? p * (dp[i][j] - delta_s[r]) * scale : 0.f;
          Ps[(r0 + i) * ldp + r] = rounded<T>(p);
          dSs[(r0 + i) * ldp + r] = rounded<T>(ds);
        }
      }
      __syncwarp();  // a row group's 16 threads share one warp

      // dV += P^T dO, dK += dS^T Q over the tile's rows
      for (int r = 0; r < kB; ++r) {
        float pr[kRows], sr[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          pr[i] = Ps[(r0 + i) * ldp + r];
          sr[i] = dSs[(r0 + i) * ldp + r];
        }
#pragma unroll
        for (int j = 0; j < kOCols; ++j) {
          const int c = cg + kGroup * j;
          if (c < Dv) {
            const float x = dOs[r * ldv + c];
#pragma unroll
            for (int i = 0; i < kRows; ++i) gv[i][j] += pr[i] * x;
          }
          if (c < Dk) {
            const float x = Qs[r * ldk + c];
#pragma unroll
            for (int i = 0; i < kRows; ++i) gk[i][j] += sr[i] * x;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kpos = k0 + r0 + i;
    if (kpos >= Skv) continue;
    T* krow = dk + (static_cast<int64_t>(b) * Skv + kpos) * sk + hk * Dk;
    T* vrow = dv + (static_cast<int64_t>(b) * Skv + kpos) * sv + hk * Dv;
#pragma unroll
    for (int j = 0; j < kOCols; ++j) {
      const int c = cg + kGroup * j;
      if (c < Dk) krow[c] = repro::from_f<T>(gk[i][j]);
      if (c < Dv) vrow[c] = repro::from_f<T>(gv[i][j]);
    }
  }
}

// (c) one CTA per (b * Hq + h, query block): dQ of 64 rows
template <typename T, bool VEC, int MASK>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, int Dk,
              int Dv, int q_offset, int window, float scale) {
  extern __shared__ float smem[];
  const int ldk = Dk + 1, ldv = Dv + 1, ldp = kB + 1;
  float* Qs = smem;              // kB rows x ldk
  float* dOs = Qs + kB * ldk;    // kB rows x ldv
  float* Ks = dOs + kB * ldv;    // kB keys x ldk
  float* Vs = Ks + kB * ldk;     // kB keys x ldv
  float* dSs = Vs + kB * ldv;    // kB rows x ldp: ds, rounded to T
  float* lse_s = dSs + kB * ldp; // kB
  float* delta_s = lse_s + kB;   // kB

  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.y * kB;
  const int qvalid = min(kB, Sq - q0);
  const int tid = threadIdx.x;
  const int r0 = (tid / kGroup) * kRows;  // first query row of this thread
  const int cg = tid % kGroup;

  const int64_t sq = static_cast<int64_t>(Hq) * Dk;
  const int64_t so = static_cast<int64_t>(Hq) * Dv;
  repro::stage_rows<T, kB, kThreads, kDMax, VEC>(
      Qs, ldk, q + (static_cast<int64_t>(b) * Sq + q0) * sq + h * Dk, sq,
      qvalid, Dk);
  repro::stage_rows<T, kB, kThreads, kDMax, VEC>(
      dOs, ldv, dout + (static_cast<int64_t>(b) * Sq + q0) * so + h * Dv, so,
      qvalid, Dv);
  if (tid < kB) {
    const int64_t at = (static_cast<int64_t>(b) * Hq + h) * Sq + q0 + tid;
    lse_s[tid] = tid < qvalid ? lse[at] : 0.f;
    delta_s[tid] = tid < qvalid ? delta[at] : 0.f;
  }

  float g[kRows][kOCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kOCols; ++j) g[i][j] = 0.f;

  // the forward's key range: to the tile's causal limit, from the first
  // key its first row can see (window)
  const int q_last = q0 + qvalid - 1;
  const int kv_end = MASK == kFull ? Skv : min(Skv, q_offset + q_last + 1);
  const int kv_begin =
      MASK == kWindow ? max(0, q_offset + q0 - window + 1) / kB * kB : 0;
  const int64_t sk = static_cast<int64_t>(Hkv) * Dk;
  const int64_t sv = static_cast<int64_t>(Hkv) * Dv;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kB) {
    __syncthreads();  // the previous tile is consumed (and Q, dO stored)
    const int kvalid = min(kB, kv_end - k0);  // zeros past the causal limit
    repro::stage_rows<T, kB, kThreads, kDMax, VEC>(
        Ks, ldk, k + (static_cast<int64_t>(b) * Skv + k0) * sk + hk * Dk, sk,
        kvalid, Dk);
    repro::stage_rows<T, kB, kThreads, kDMax, VEC>(
        Vs, ldv, v + (static_cast<int64_t>(b) * Skv + k0) * sv + hk * Dv, sv,
        kvalid, Dv);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < Dk; ++d) {
      float qr[kRows], kr[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qr[i] = Qs[(r0 + i) * ldk + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kr[j] = Ks[(cg + kGroup * j) * ldk + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] += qr[i] * kr[j];
    }
    for (int d = 0; d < Dv; ++d) {
      float dr[kRows], vr[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dr[i] = dOs[(r0 + i) * ldv + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vr[j] = Vs[(cg + kGroup * j) * ldv + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) dp[i][j] += dr[i] * vr[j];
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r0 + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + cg + kGroup * j;
        const bool vis = kpos < Skv && q0 + r < Sq &&
                         visible<MASK>(q_offset + q0 + r, kpos, window);
        const float p = vis ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        const float ds = vis ? p * (dp[i][j] - delta_s[r]) * scale : 0.f;
        dSs[r * ldp + cg + kGroup * j] = rounded<T>(ds);
      }
    }
    __syncwarp();

    for (int c = 0; c < kB; ++c) {
      float sr[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) sr[i] = dSs[(r0 + i) * ldp + c];
#pragma unroll
      for (int j = 0; j < kOCols; ++j) {
        const int col = cg + kGroup * j;
        if (col < Dk) {
          const float x = Ks[c * ldk + col];
#pragma unroll
          for (int i = 0; i < kRows; ++i) g[i][j] += sr[i] * x;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + r0 + i;
    if (row >= Sq) continue;
    T* qrow = dq + (static_cast<int64_t>(b) * Sq + row) * sq + h * Dk;
#pragma unroll
    for (int j = 0; j < kOCols; ++j) {
      const int c = cg + kGroup * j;
      if (c < Dk) qrow[c] = repro::from_f<T>(g[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// the bf16 body: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMWarps = 4;                 // warps a CTA, 16 rows each
constexpr int kMThreads = kMWarps * 32;
constexpr int kMKeys = kMWarps * 16;       // keys of a dK/dV CTA
constexpr int kMRows = kMWarps * 16;       // query rows of a dQ CTA
constexpr int kMStep = 32;                 // query rows (b), keys (c) a step
constexpr int kPadE = 8;                   // row padding: 16 bytes

using repro::ldsm_x4;
using repro::ldsm_x4_t;
using repro::mma_bf16;

// Stage `rows` rows of `cols` bf16 (a multiple of 8; row stride `stride`)
// into shared memory at pitch `ld` by 16-byte cp.async; rows past `valid`
// are zero. The caller commits and waits.
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, int ld,
                                           const __nv_bfloat16* src,
                                           int64_t stride, int rows,
                                           int valid, int cols) {
  const int cpr = cols / 8;
  for (int i = threadIdx.x; i < rows * cpr; i += kMThreads) {
    const int r = i / cpr, c = (i - r * cpr) * 8;
    const bool ok = r < valid;
    repro::cp_async16(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// the A fragment of an m16n8k16 product over 16 rows at `base` (pitch ld),
// columns c0..c0+15
__device__ __forceinline__ void a_frag(uint32_t (&a)[4],
                                       const __nv_bfloat16* base, int ld,
                                       int c0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, base + (lane & 15) * ld + c0 + (lane >> 4) * 8);
}

// B fragments of two n8 tiles (rows n0..n0+15 of a tile stored [n][k]),
// k from c0: b[0], b[1] the first tile's, b[2], b[3] the second's
__device__ __forceinline__ void b_frag_nk(uint32_t (&b)[4],
                                          const __nv_bfloat16* base, int ld,
                                          int n0, int c0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, base + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + c0 +
                 ((lane >> 3) & 1) * 8);
}

// B fragments of two n8 tiles (columns n0..n0+15) of a tile stored [k][n],
// k rows k0..k0+15: ldmatrix.trans
__device__ __forceinline__ void b_frag_kn(uint32_t (&b)[4],
                                          const __nv_bfloat16* base, int ld,
                                          int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(b, base + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
                   (lane >> 4) * 8);
}

size_t dkdv_mma_smem_bytes(int dk, int dv) {
  return sizeof(__nv_bfloat16) *
             (static_cast<size_t>(kMKeys + kMStep) * (dk + kPadE) +
              static_cast<size_t>(kMKeys + kMStep) * (dv + kPadE)) +
         sizeof(float) * 2 * kMStep;
}

size_t dq_mma_smem_bytes(int dk, int dv) {
  return sizeof(__nv_bfloat16) *
         (static_cast<size_t>(kMRows + kMStep) * (dk + kPadE) +
          static_cast<size_t>(kMRows + kMStep) * (dv + kPadE));
}

// (b) on the tensor cores: one CTA per (b * Hkv + hk, 64-key block), warp
// w's 16 keys the M of every product; DMAX the largest padded head dim
template <int MASK, int DMAX>
__global__ void __launch_bounds__(kMThreads)
    dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int Hq,
                    int Hkv, int Dk, int Dv, int q_offset, int window,
                    float scale) {
  constexpr int KSTEPS = DMAX / 16, DTILES = DMAX / 8;
  constexpr int ST = kMStep / 8;  // n8 tiles of a step's scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldk = Dk + kPadE, ldv = Dv + kPadE;
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kMKeys x ldk
  __nv_bfloat16* Vs = Ks + kMKeys * ldk;                            // kMKeys x ldv
  __nv_bfloat16* Qs = Vs + kMKeys * ldv;                            // kMStep x ldk
  __nv_bfloat16* dOs = Qs + kMStep * ldk;                           // kMStep x ldv
  float* lse_s = reinterpret_cast<float*>(dOs + kMStep * ldv);      // kMStep
  float* delta_s = lse_s + kMStep;                                  // kMStep

  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.y * kMKeys;
  const int kvalid = min(kMKeys, Skv - k0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kw0 = k0 + warp * 16;  // the warp's first key
  const int g = lane >> 2, t = lane & 3;

  const int64_t sk = static_cast<int64_t>(Hkv) * Dk;
  const int64_t sv = static_cast<int64_t>(Hkv) * Dv;
  stage_bf16(Ks, ldk, k + (static_cast<int64_t>(b) * Skv + k0) * sk + hk * Dk,
             sk, kMKeys, kvalid, Dk);
  stage_bf16(Vs, ldv, v + (static_cast<int64_t>(b) * Skv + k0) * sv + hk * Dv,
             sv, kMKeys, kvalid, Dv);

  float gk[DTILES][4], gv[DTILES][4];
#pragma unroll
  for (int j = 0; j < DTILES; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[j][e] = gv[j][e] = 0.f;

  const int q_lo = MASK == kFull ? 0 : max(0, k0 - q_offset);
  const int k_last = k0 + kvalid - 1;
  const int q_hi = MASK == kWindow ? min(Sq, k_last + window - q_offset) : Sq;
  const int64_t sq = static_cast<int64_t>(Hq) * Dk;
  const int64_t so = static_cast<int64_t>(Hq) * Dv;

  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    for (int q0 = q_lo / kMStep * kMStep; q0 < q_hi; q0 += kMStep) {
      __syncthreads();  // the previous step's tiles are consumed
      const int qvalid = min(kMStep, Sq - q0);
      stage_bf16(Qs, ldk, q + (static_cast<int64_t>(b) * Sq + q0) * sq + h * Dk,
                 sq, kMStep, qvalid, Dk);
      stage_bf16(dOs, ldv,
                 dout + (static_cast<int64_t>(b) * Sq + q0) * so + h * Dv, so,
                 kMStep, qvalid, Dv);
      repro::cp_async_commit();
      if (threadIdx.x < kMStep) {
        const int64_t at =
            (static_cast<int64_t>(b) * Hq + h) * Sq + q0 + threadIdx.x;
        lse_s[threadIdx.x] = threadIdx.x < qvalid ? lse[at] : 0.f;
        delta_s[threadIdx.x] = threadIdx.x < qvalid ? delta[at] : 0.f;
      }
      repro::cp_async_wait<0>();
      __syncthreads();
      // a warp skips a step none of its keys is visible in: keys past the
      // step's last row (causal), or too old for its first row (window)
      bool skip = kw0 >= Skv;
      if constexpr (MASK != kFull) skip = skip || kw0 > q_offset + q0 + kMStep - 1;
      if constexpr (MASK == kWindow)
        skip = skip || kw0 + 15 + window <= q_offset + q0;
      if (skip) continue;

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 rows each
      float s[ST][4], dp[ST][4];
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        if (kk * 16 < Dk) {
          uint32_t a[4];
          a_frag(a, Ks + warp * 16 * ldk, ldk, kk * 16);
#pragma unroll
          for (int np = 0; np < ST / 2; ++np) {
            uint32_t bq[4];
            b_frag_nk(bq, Qs, ldk, np * 16, kk * 16);
            mma_bf16(s[2 * np], a, bq[0], bq[1]);
            mma_bf16(s[2 * np + 1], a, bq[2], bq[3]);
          }
        }
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        if (kk * 16 < Dv) {
          uint32_t a[4];
          a_frag(a, Vs + warp * 16 * ldv, ldv, kk * 16);
#pragma unroll
          for (int np = 0; np < ST / 2; ++np) {
            uint32_t bo[4];
            b_frag_nk(bo, dOs, ldv, np * 16, kk * 16);
            mma_bf16(dp[2 * np], a, bo[0], bo[1]);
            mma_bf16(dp[2 * np + 1], a, bo[2], bo[3]);
          }
        }
      // p and ds in f32; element (key g or g + 8, row 8j + 2t (+1))
      uint32_t pa[ST][2], da[ST][2];
#pragma unroll
      for (int j = 0; j < ST; ++j) {
        float pe[4], de[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = kw0 + g + (e >> 1) * 8;
          const int r = j * 8 + 2 * t + (e & 1);
          const bool vis = kpos < Skv && q0 + r < Sq &&
                           visible<MASK>(q_offset + q0 + r, kpos, window);
          pe[e] = vis ? expf(s[j][e] * scale - lse_s[r]) : 0.f;
          de[e] = vis ? pe[e] * (dp[j][e] - delta_s[r]) * scale : 0.f;
        }
        pa[j][0] = pack_bf16(pe[0], pe[1]);
        pa[j][1] = pack_bf16(pe[2], pe[3]);
        da[j][0] = pack_bf16(de[0], de[1]);
        da[j][1] = pack_bf16(de[2], de[3]);
      }
      // dV += P^T dO and dK += dS^T Q, k over the step's 32 rows
#pragma unroll
      for (int kk = 0; kk < kMStep / 16; ++kk) {
        const uint32_t ap[4] = {pa[2 * kk][0], pa[2 * kk][1],
                                pa[2 * kk + 1][0], pa[2 * kk + 1][1]};
        const uint32_t ad[4] = {da[2 * kk][0], da[2 * kk][1],
                                da[2 * kk + 1][0], da[2 * kk + 1][1]};
#pragma unroll
        for (int dd = 0; dd < DTILES / 2; ++dd) {
          if (dd * 16 < Dv) {
            uint32_t bo[4];
            b_frag_kn(bo, dOs, ldv, kk * 16, dd * 16);
            mma_bf16(gv[2 * dd], ap, bo[0], bo[1]);
            mma_bf16(gv[2 * dd + 1], ap, bo[2], bo[3]);
          }
          if (dd * 16 < Dk) {
            uint32_t bq[4];
            b_frag_kn(bq, Qs, ldk, kk * 16, dd * 16);
            mma_bf16(gk[2 * dd], ad, bq[0], bq[1]);
            mma_bf16(gk[2 * dd + 1], ad, bq[2], bq[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int kpos = kw0 + g + e2 * 8;
    if (kpos >= Skv) continue;
    __nv_bfloat16* krow =
        dk + (static_cast<int64_t>(b) * Skv + kpos) * sk + hk * Dk;
    __nv_bfloat16* vrow =
        dv + (static_cast<int64_t>(b) * Skv + kpos) * sv + hk * Dv;
#pragma unroll
    for (int j = 0; j < DTILES; ++j) {
      const int c = j * 8 + 2 * t;
      if (c < Dk) {
        krow[c] = __float2bfloat16_rn(gk[j][2 * e2]);
        krow[c + 1] = __float2bfloat16_rn(gk[j][2 * e2 + 1]);
      }
      if (c < Dv) {
        vrow[c] = __float2bfloat16_rn(gv[j][2 * e2]);
        vrow[c + 1] = __float2bfloat16_rn(gv[j][2 * e2 + 1]);
      }
    }
  }
}

// (c) on the tensor cores: one CTA per (b * Hq + h, 64-row query block),
// warp w's 16 rows the M of every product
template <int MASK, int DMAX>
__global__ void __launch_bounds__(kMThreads)
    dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int Hq,
                  int Hkv, int Dk, int Dv, int q_offset, int window,
                  float scale) {
  constexpr int KSTEPS = DMAX / 16, DTILES = DMAX / 8;
  constexpr int ST = kMStep / 8;  // n8 tiles of a step's scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldk = Dk + kPadE, ldv = Dv + kPadE;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kMRows x ldk
  __nv_bfloat16* dOs = Qs + kMRows * ldk;                           // kMRows x ldv
  __nv_bfloat16* Ks = dOs + kMRows * ldv;                           // kMStep x ldk
  __nv_bfloat16* Vs = Ks + kMStep * ldk;                            // kMStep x ldv

  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.y * kMRows;
  const int qvalid = min(kMRows, Sq - q0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qw0 = q0 + warp * 16;  // the warp's first row
  const int g = lane >> 2, t = lane & 3;

  const int64_t sq = static_cast<int64_t>(Hq) * Dk;
  const int64_t so = static_cast<int64_t>(Hq) * Dv;
  stage_bf16(Qs, ldk, q + (static_cast<int64_t>(b) * Sq + q0) * sq + h * Dk,
             sq, kMRows, qvalid, Dk);
  stage_bf16(dOs, ldv, dout + (static_cast<int64_t>(b) * Sq + q0) * so + h * Dv,
             so, kMRows, qvalid, Dv);
  repro::cp_async_commit();
  // each lane's rows g and g + 8: their lse and delta
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = qw0 + g + e2 * 8;
    const int64_t at = (static_cast<int64_t>(b) * Hq + h) * Sq + row;
    lse_r[e2] = row < Sq ? lse[at] : 0.f;
    delta_r[e2] = row < Sq ? delta[at] : 0.f;
  }
  repro::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KSTEPS][4], of[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    if (kk * 16 < Dk) a_frag(qf[kk], Qs + warp * 16 * ldk, ldk, kk * 16);
    if (kk * 16 < Dv) a_frag(of[kk], dOs + warp * 16 * ldv, ldv, kk * 16);
  }
  float gq[DTILES][4];
#pragma unroll
  for (int j = 0; j < DTILES; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gq[j][e] = 0.f;

  const int q_last = q0 + qvalid - 1;
  const int kv_end = MASK == kFull ? Skv : min(Skv, q_offset + q_last + 1);
  const int kv_begin =
      MASK == kWindow ? max(0, q_offset + q0 - window + 1) / kMStep * kMStep : 0;
  const int64_t sk = static_cast<int64_t>(Hkv) * Dk;
  const int64_t sv = static_cast<int64_t>(Hkv) * Dv;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kMStep) {
    __syncthreads();  // the previous tile is consumed (and Q, dO read)
    const int kvalid = min(kMStep, kv_end - k0);  // zeros past the limit
    stage_bf16(Ks, ldk, k + (static_cast<int64_t>(b) * Skv + k0) * sk + hk * Dk,
               sk, kMStep, kvalid, Dk);
    stage_bf16(Vs, ldv, v + (static_cast<int64_t>(b) * Skv + k0) * sv + hk * Dv,
               sv, kMStep, kvalid, Dv);
    repro::cp_async_commit();
    repro::cp_async_wait<0>();
    __syncthreads();
    bool skip = qw0 >= Sq;
    if constexpr (MASK != kFull) skip = skip || k0 > q_offset + qw0 + 15;
    if constexpr (MASK == kWindow)
      skip = skip || k0 + kMStep - 1 < q_offset + qw0 - window + 1;
    if (skip) continue;

    float s[ST][4], dp[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      if (kk * 16 < Dk) {
#pragma unroll
        for (int np = 0; np < ST / 2; ++np) {
          uint32_t bk[4];
          b_frag_nk(bk, Ks, ldk, np * 16, kk * 16);
          mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
        }
      }
      if (kk * 16 < Dv) {
#pragma unroll
        for (int np = 0; np < ST / 2; ++np) {
          uint32_t bv[4];
          b_frag_nk(bv, Vs, ldv, np * 16, kk * 16);
          mma_bf16(dp[2 * np], of[kk], bv[0], bv[1]);
          mma_bf16(dp[2 * np + 1], of[kk], bv[2], bv[3]);
        }
      }
    }
    // ds in f32, rounded to bf16 as dQ's A operand; element (row g or
    // g + 8, key 8j + 2t (+1))
    uint32_t da[ST][2];
#pragma unroll
    for (int j = 0; j < ST; ++j) {
      float de[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = qw0 + g + (e >> 1) * 8;
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        const bool vis = kpos < Skv && row < Sq &&
                         visible<MASK>(q_offset + row, kpos, window);
        const float p = vis ? expf(s[j][e] * scale - lse_r[e >> 1]) : 0.f;
        de[e] = vis ? p * (dp[j][e] - delta_r[e >> 1]) * scale : 0.f;
      }
      da[j][0] = pack_bf16(de[0], de[1]);
      da[j][1] = pack_bf16(de[2], de[3]);
    }
#pragma unroll
    for (int kk = 0; kk < kMStep / 16; ++kk) {
      const uint32_t ad[4] = {da[2 * kk][0], da[2 * kk][1], da[2 * kk + 1][0],
                              da[2 * kk + 1][1]};
#pragma unroll
      for (int dd = 0; dd < DTILES / 2; ++dd)
        if (dd * 16 < Dk) {
          uint32_t bk[4];
          b_frag_kn(bk, Ks, ldk, kk * 16, dd * 16);
          mma_bf16(gq[2 * dd], ad, bk[0], bk[1]);
          mma_bf16(gq[2 * dd + 1], ad, bk[2], bk[3]);
        }
    }
  }

#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = qw0 + g + e2 * 8;
    if (row >= Sq) continue;
    __nv_bfloat16* qrow = dq + (static_cast<int64_t>(b) * Sq + row) * sq + h * Dk;
#pragma unroll
    for (int j = 0; j < DTILES; ++j) {
      const int c = j * 8 + 2 * t;
      if (c < Dk) {
        qrow[c] = __float2bfloat16_rn(gq[j][2 * e2]);
        qrow[c + 1] = __float2bfloat16_rn(gq[j][2 * e2 + 1]);
      }
    }
  }
}

template <int MASK, int DMAX>
int launch_mma(const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               void* dq, void* dk, void* dv, int B, int Sq, int Skv, int Hq,
               int Hkv, int Dk, int Dv, int q_offset, int window, float scale,
               cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const size_t smem_kv = dkdv_mma_smem_bytes(Dk, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_mma_kernel<MASK, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_kv(static_cast<unsigned>(B) * Hkv, (Skv + kMKeys - 1) / kMKeys);
  dkdv_mma_kernel<MASK, DMAX><<<grid_kv, kMThreads, smem_kv, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, delta,
      static_cast<bf*>(dk), static_cast<bf*>(dv), Sq, Skv, Hq, Hkv, Dk, Dv,
      q_offset, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem_q = dq_mma_smem_bytes(Dk, Dv);
  err = cudaFuncSetAttribute(dq_mma_kernel<MASK, DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_q(static_cast<unsigned>(B) * Hq, (Sq + kMRows - 1) / kMRows);
  dq_mma_kernel<MASK, DMAX><<<grid_q, kMThreads, smem_q, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, delta,
      static_cast<bf*>(dq), Sq, Skv, Hq, Hkv, Dk, Dv, q_offset, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC, int MASK>
int launch_impl(const void* q, const void* k, const void* v, const void* o,
                const float* lse, const void* dout, void* dq, void* dk,
                void* dv, float* delta, int B, int Sq, int Skv, int Hq,
                int Hkv, int Dk, int Dv, int q_offset, int window, float scale,
                cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int rows = B * Sq * Hq;
  delta_kernel<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0,
                    stream>>>(static_cast<const T*>(o), dot, delta, rows, Sq,
                              Hq, Dv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // bf16 at head dims of whole k16 steps, 16-byte rows: the tensor cores
  if constexpr (sizeof(T) == 2 && VEC)
    if (Dk % 16 == 0 && Dv % 16 == 0)
      return Dk <= 64 && Dv <= 64
                 ? launch_mma<MASK, 64>(q, k, v, dout, lse, delta, dq, dk, dv,
                                        B, Sq, Skv, Hq, Hkv, Dk, Dv, q_offset,
                                        window, scale, stream)
                 : launch_mma<MASK, kDMax>(q, k, v, dout, lse, delta, dq, dk,
                                           dv, B, Sq, Skv, Hq, Hkv, Dk, Dv,
                                           q_offset, window, scale, stream);

  const size_t smem_kv = dkdv_smem_bytes(Dk, Dv);
  err = cudaFuncSetAttribute(dkdv_kernel<T, VEC, MASK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_kv(static_cast<unsigned>(B) * Hkv, (Skv + kB - 1) / kB);
  dkdv_kernel<T, VEC, MASK><<<grid_kv, kThreads, smem_kv, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Sq, Skv, Hq, Hkv, Dk, Dv, q_offset, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_q = dq_smem_bytes(Dk, Dv);
  err = cudaFuncSetAttribute(dq_kernel<T, VEC, MASK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_q(static_cast<unsigned>(B) * Hq, (Sq + kB - 1) / kB);
  dq_kernel<T, VEC, MASK><<<grid_q, kThreads, smem_q, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), Sq, Skv, Hq, Hkv, Dk,
      Dv, q_offset, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MASK>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           float* delta, int B, int Sq, int Skv, int Hq, int Hkv, int Dk,
           int Dv, int q_offset, int window, float scale,
           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = Dk % V == 0 && Dv % V == 0 && repro::aligned16(q) &&
                   repro::aligned16(k) && repro::aligned16(v) &&
                   repro::aligned16(dout);
  return vec ? launch_impl<T, true, MASK>(q, k, v, o, lse, dout, dq, dk, dv,
                                          delta, B, Sq, Skv, Hq, Hkv, Dk, Dv,
                                          q_offset, window, scale, stream)
             : launch_impl<T, false, MASK>(q, k, v, o, lse, dout, dq, dk, dv,
                                           delta, B, Sq, Skv, Hq, Hkv, Dk, Dv,
                                           q_offset, window, scale, stream);
}

template <typename T>
int launch_mask(int mask, const void* q, const void* k, const void* v,
                const void* o, const float* lse, const void* dout, void* dq,
                void* dk, void* dv, float* delta, int B, int Sq, int Skv,
                int Hq, int Hkv, int Dk, int Dv, int q_offset, int window,
                float scale, cudaStream_t s) {
  if (mask == kCausal)
    return launch<T, kCausal>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, Sq,
                              Skv, Hq, Hkv, Dk, Dv, q_offset, window, scale, s);
  if (mask == kWindow)
    return launch<T, kWindow>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, Sq,
                              Skv, Hq, Hkv, Dk, Dv, q_offset, window, scale, s);
  return launch<T, kFull>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, Sq,
                          Skv, Hq, Hkv, Dk, Dv, q_offset, window, scale, s);
}

}  // namespace

// mask: 0 causal, 1 window (`window` keys), 2 full; `delta`: f32 scratch of
// B * Hq * Sq. Returns cudaErrorInvalidValue for what it does not take.
extern "C" int repro_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const float* lse,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, float* delta, int B, int Sq,
                                   int Skv, int Hq, int Hkv, int Dk, int Dv,
                                   int mask, int q_offset, int window,
                                   float scale, int dtype, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv ||
      Dk <= 0 || Dv <= 0 || Dk > kDMax || Dv > kDMax || mask < kCausal ||
      mask > kFull || q_offset < 0 || window <= 0 ||
      (Sq + kB - 1) / kB > 65535 || (Skv + kB - 1) / kB > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch_mask<float>(mask, q, k, v, o, lse, dout, dq, dk, dv, delta,
                              B, Sq, Skv, Hq, Hkv, Dk, Dv, q_offset, window,
                              scale, s);
  if (dtype == repro::kBF16)
    return launch_mask<__nv_bfloat16>(mask, q, k, v, o, lse, dout, dq, dk, dv,
                                      delta, B, Sq, Skv, Hq, Hkv, Dk, Dv,
                                      q_offset, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
