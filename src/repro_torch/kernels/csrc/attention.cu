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
// `kops.attn_full_template`, where Sq != Skv). Each body is instantiated
// over the compile-time mask kind MASK; the window's span is a runtime
// argument.
//
// q (B,Sq,Hq,Dk), k (B,Skv,Hkv,Dk), v (B,Skv,Hkv,Dv) -> o (B,Sq,Hq,Dv),
// read and written in the JAX layout, so the wrapper transposes nothing.
//
// Bound on the card. At the decoders' 256-token prefill bucket, bytes:
// q, k, v, o of [1,256,32,128] bf16 move 8.4 MB (2.5 us at 3.35 TB/s) for
// 0.54 GFLOP of causal products (0.55 us at 989 TFLOP/s). At gemma3-27b's
// 2048-token window prefill (32/16 heads of 128, window 1024),
// operations: 25.8 GFLOP over the 1,573,376 visible (q, k) pairs a head
// take 26 us at the dense bf16 rate, against 50 MB (15 us). Both call for
// the tensor cores; the encoders' and the detector's full-mask shapes
// (12 or 6 heads of 64) add that they give few CTAs for 132 SMs.
//
// Two bodies:
//
// bf16, the serving path (attn_mma_kernel): the tensor-core body.
//   * both products are mma.sync.m16n8k16 on bf16 operands with f32
//     accumulation; a CTA holds WARPS warps of 16 query rows each (4 warps,
//     64 rows; 2 warps, 32 rows where 64-row tiles would leave SMs idle).
//     Q's fragments are loaded once by ldmatrix and stay in registers for
//     the whole KV loop; K's come by ldmatrix, V's by ldmatrix.trans;
//   * K and V tiles of 64 keys stay bf16 in shared memory, rows padded by
//     16 bytes so that ldmatrix's eight row addresses fall in distinct
//     banks, brought in by 16-byte cp.async copies into two stages: tile
//     j+1 loads while tile j computes. Head dims that are no multiple of
//     16 (34, 48 -> 48, 18 -> 32) are zero-padded in shared memory and
//     take the same body; a head dim or pointer that rules out 16-byte
//     copies is staged element by element, synchronously;
//   * S and P never touch shared memory: the S accumulator is scaled into
//     log2 units, masked, exponentiated in registers and repacked as bf16
//     into the A fragments of P.V (FlashAttention-2). P goes in as two
//     bf16 terms, its bf16 head and the bf16 of the remainder (16
//     significant bits; the TPU body multiplies f32 P), so P.V takes two
//     mma per fragment of V. bf16 P alone errs by up to 2^-9 of each
//     weight and leaves less than a 4x margin on chip_smoke.py's
//     RMS-scaled window rule (tests/test_torch_attn_design.py emulates
//     both). The row sum l adds the values the terms hold. A row's max
//     reduces over the 4 lanes that share it with two shuffles; m, l and
//     acc stay in f32 registers, l reduced across the 4 lanes once, at
//     the end;
//   * Q is staged once, in K's second stage, and leaves it for registers
//     before tile 1 arrives: two stages of K and V are all the shared
//     memory (70 KB at head dim 128), so 3 CTAs of 4 warps fit an SM;
//   * templated on the largest padded head dims (DKMAX, DVMAX): (64, 64),
//     (128, 128) and, causal only, MLA's prefill (192, 128), apart, since a (192, 192)
//     body would hold 24 output tiles of accumulators where Dv needs 16,
//     and on whether both head dims equal them: then every fragment loop
//     has a compile-time trip count, the body needs under 170 registers
//     and is bound to 3 CTAs an SM (12 warps; 2 CTAs at Dk 192, whose Q
//     fragments take 48 registers more); other dims up to 128 take the
//     same body with runtime trip counts, MLA's pair only its exact one;
//   * recurrentgemma's local layers, window mask only, at Dk = Dv = 256
//     (10 query heads over one KV head): a warp's 16 x 256 f32 output tile
//     would be 128 registers a thread beside Q's 64, so the output columns
//     are split over the grid's z: each CTA runs the whole Q.K^T and
//     softmax and P.V for 128 of the 256 columns (the (256, 128)
//     instantiation, V staged from its half of each row), at the cost of
//     the scores twice. Two stages of K (256) and V (128) take 100 KB, so 2
//     CTAs of 4 warps fit an SM. ptxas gives it all 255 registers a thread
//     and 56 bytes of spill stores (Q's fragments, the accumulators, the
//     scores and P's two terms).
// f32, Table 2's micro-benchmark path (attn_kernel): the FMA body. TF32
//   products would keep ~3 decimal digits, outside f32's 2e-5 limit, so
//   it stays on the CUDA cores: 256 threads per 64-row q tile, tiles
//   widened to f32 in shared memory (common.cuh stage_rows), thread t
//   owning 4 query rows (t/16) and every 16th score and output column;
//   instantiated for Dk and Dv up to 128 and, apart (its Q and K staging
//   runs more copies a thread), for Dk 192 with Dv 128 and, window only,
//   for Dk = Dv = 256 (4 x (64 x 257 + 64 x 257 + 64 x 256 + 64 x 65) =
//   213,760 bytes of shared memory: one CTA an SM).
//
// The head dims taken are both up to 128, or, with the causal mask only
// (MLA's prefill and chunked prefill; no window or full-mask model has
// them), Dk 192 with Dv 128, or, with the window mask only
// (recurrentgemma's local layers), Dk = Dv = 256 (dims_taken); the entry
// refuses any other pair.
//
// What both bodies do alike:
//   * one CTA per (b*Hq, q tile); the TPU grid's sequential KV axis
//     becomes a loop inside the CTA over 64-key tiles. Causal, the loop
//     stops at the tile's causal limit, so the masked upper triangle is
//     never loaded, and the keys of the last tile past that limit are
//     zero-filled, not read: a chunk of a prompt (chunked prefill, Sq <
//     Skv - q_offset) leaves stale rows of reused or scratch KV blocks
//     there, and a masked weight of 0 times a stale NaN would still be
//     NaN; window, it also starts at the first tile any row of
//     the q tile can see (q_offset + q0 - window + 1, rounded down to a
//     tile), so a 2048-token prefill with a 1024 window visits at most 17
//     of 32 tiles. Full, it runs to Skv and masks only the ragged last
//     tile. The bf16 body masks only the tiles that need it (the
//     diagonal, the window's edge, the KV tail) and lets a warp skip a
//     tile none of its rows can see; q_offset has no effect on the full
//     mask, as in the JAX template;
//   * GQA is an index: the KV head is h / (Hq/Hkv), nothing is replicated;
//   * NEG_INF is the finite -1e30 of the JAX kernels. A tile in which a
//     row sees no key adds exp(0) terms while its max is still NEG_INF;
//     the first visible key rescales them by exp(NEG_INF - m) = 0, as in
//     the TPU body. A row that saw no key at all (Skv == 0, a window past
//     the keys) leaves the epilogue as exact zeros.
//
// The softcap fragment (the TPU body's `softcap`, Gemma 2's attention
// logit cap): every body takes a compile-time CAP; where it is set the
// scores are capped, tanh(s / cap) * cap with tanhf and an IEEE division,
// on the natural-unit score s * scale, before the bf16 body folds log2(e)
// in and before the mask, so a masked score stays NEG_INF and a row that
// sees no key still leaves as zeros. The capped instantiations are the
// common ones alone (head dims up to 128, the three masks, both dtypes):
// no model caps MLA's (192, 128) or recurrentgemma's (256, 256), whose
// bodies already spend their registers. attention_softcap.cu builds them
// as a library of their own; an uncapped instantiation compiles to the
// code it had without the cap.
//
// What it still leaves, for later work: wgmma (the only way to the full
// tensor-core rate) fed by a warp-specialised TMA producer over a deeper
// ring of stages, and a split over KV for the shapes that fill few SMs
// even at 32-row tiles (the detector's 6-head refinement).
#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per staged tile
constexpr int kThreads = 256;
constexpr int kRows = 4;       // query rows per thread
constexpr int kGroup = 16;     // threads per row group (one half warp)
constexpr int kDMax = 128;     // largest Dk and Dv of the common instantiation
constexpr int kDkWide = 192;   // MLA's Dk (nope 128 + rope 64), with Dv 128
constexpr int kD256 = 256;     // recurrentgemma's Dk = Dv, window mask only
constexpr int kSCols = kBK / kGroup;    // score columns per thread

// the mask fragments (MASK): causal, causal within a window, full
constexpr int kCausal = 0;
constexpr int kWindow = 1;
constexpr int kFull = 2;

// The head dims an instantiation takes: both up to 128, or, for the
// causal mask (MLA's prefill and chunks), Dk 192 with Dv 128, or, for the
// window mask (recurrentgemma's local layers), Dk = Dv = 256; nothing
// else is computed
__host__ __device__ __forceinline__ bool dims_taken(int dk, int dv, int mask) {
  if (dk > 0 && dv > 0 && dk <= kDMax && dv <= kDMax) return true;
  if (mask == kWindow) return dk == kD256 && dv == kD256;
  return mask == kCausal && dk == kDkWide && dv == kDMax;
}

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

// DKMAX / DVMAX: the largest Dk / Dv the instantiation takes (the staging
// copies' trip counts and the output columns a thread owns); CAP: the
// scores capped at `cap` (repro::softcap) before the mask
template <typename T, bool VEC, int MASK, int DKMAX, int DVMAX, bool CAP>
__global__ void __launch_bounds__(kThreads)
    attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Skv, int Hq, int Hkv, int Dk, int Dv, int q_offset,
                       int window, float scale, float cap) {
  constexpr int kOCols = DVMAX / kGroup;  // output columns per thread
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

  repro::stage_rows<T, kBQ, kThreads, DKMAX, VEC>(
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
    const int valid = min(kBK, kv_end - k0);  // zeros past the causal limit
    const int64_t row0 = static_cast<int64_t>(b) * Skv + k0;
    repro::stage_rows<T, kBK, kThreads, DKMAX, VEC>(
        Ks, ldk, k + (row0 * Hkv + hk) * Dk, kv_stride_k, valid, Dk);
    repro::stage_rows<T, kBK, kThreads, DVMAX, VEC>(
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
        s[i][j] = visible ? repro::softcap<CAP>(s[i][j] * scale, cap) : repro::kNegInf;
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

// ---------------------------------------------------------------------------
// the bf16 body: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTK = 64;        // keys per staged tile
constexpr int kPadE = 8;       // row padding of a bf16 tile: 16 bytes
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ __forceinline__ int pad16(int d) {
  return (d + 15) / 16 * 16;
}

// two stages of K and two of V, bf16; Q (at most kTK rows) is staged in
// K's second stage, which it leaves before tile 1 is loaded there
size_t mma_smem_bytes(int dkp, int dvp) {
  return sizeof(__nv_bfloat16) * 2 * static_cast<size_t>(kTK) *
         (dkp + kPadE + dvp + kPadE);
}

// the tensor-core helpers of common.cuh
using repro::fast_exp2;
using repro::ldsm_x4;
using repro::ldsm_x4_t;
using repro::mma_bf16;
using repro::split_pack;

// Stage `rows` rows of `cols` bf16 (row stride `stride`) into shared memory
// at pitch `ld`; rows past `valid` and columns from `cols` to `cols_p` are
// zero. `vec`: 16-byte cp.async copies (cols % 8 == 0, 16-byte aligned
// rows), completed by the caller's cp_async_wait, thread t taking chunk
// t % CPR of every (NT / CPR)-th row (CPR = 16-byte chunks of the widest
// row, a power of two: no division); otherwise element by element,
// complete on return.
template <int NT, int CPR>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, int ld,
                                           const __nv_bfloat16* src,
                                           int64_t stride, int rows, int valid,
                                           int cols, int cols_p, bool vec) {
  if (vec) {
    const int c = (threadIdx.x % CPR) * 8;
    if (c >= cols_p) return;
    const bool in = c < cols;
    for (int r = threadIdx.x / CPR; r < rows; r += NT / CPR) {
      const bool ok = in && r < valid;
      repro::cp_async16(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols_p; i += NT) {
      const int r = i / cols_p, c = i - r * cols_p;
      dst[r * ld + c] = (r < valid && c < cols) ? src[r * stride + c]
                                                : __float2bfloat16_rn(0.f);
    }
  }
}

// the 16-byte chunks a staging thread cycles over: those of the widest
// row, rounded up to a power of two (no division; a thread past the row
// stages nothing)
__host__ __device__ constexpr int chunks_pow2(int dmax) {
  int c = 1;
  while (c < dmax / 8) c <<= 1;
  return c;
}

// DKMAX / DVMAX: the largest padded Dk / Dv a CTA takes. EXACT: both head
// dims equal them, so every fragment loop has a compile-time trip count
// and the body fits 3 CTAs of 4 warps (or 6 of 2) on an SM, 2 (or 4) at Dk
// 192 and 256, whose Q fragments take 48 and 96 registers more; otherwise
// the padded dims are runtime values. The grid's z splits Dv: CTA z
// computes the columns [z * Dv / gridDim.z, (z + 1) * Dv / gridDim.z) of
// the output (all of them where gridDim.z is 1). CAP: the scores capped at
// `cap` in natural units (s * scale, repro::softcap), then folded into log2
// units and masked; otherwise scaled by scale_log2 = scale * log2(e) alone
template <int MASK, int DKMAX, int DVMAX, int WARPS, bool EXACT, bool CAP>
__global__ void __launch_bounds__(WARPS * 32,
                                  EXACT ? (DKMAX > 128 ? 8 : 12) / WARPS : 1)
    attn_mma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, int Sq, int Skv, int Hq,
                    int Hkv, int Dk, int Dv, int q_offset, int window,
                    float scale_log2, float scale, float cap, bool vec) {
  constexpr int NT = WARPS * 32, BQ = WARPS * 16;
  constexpr int KSTEPS = DKMAX / 16;  // k16 steps of Q.K^T
  constexpr int DTILES = DVMAX / 8;   // n8 tiles of the output
  constexpr int KCPR = chunks_pow2(DKMAX), VCPR = chunks_pow2(DVMAX);
  constexpr int STILES = kTK / 8;    // n8 tiles of a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dvc = Dv / static_cast<int>(gridDim.z);  // this CTA's columns
  const int dv0 = static_cast<int>(blockIdx.z) * dvc;
  const int dkp = EXACT ? DKMAX : pad16(Dk), dvp = EXACT ? DVMAX : pad16(dvc);
  const int ldk = dkp + kPadE, ldv = dvp + kPadE;
  static_assert(BQ <= kTK, "Q is staged in a K stage");
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // 2 x kTK x ldk
  __nv_bfloat16* Vs = Ks + 2 * kTK * ldk;                           // 2 x kTK x ldv
  __nv_bfloat16* Qs = Ks + kTK * ldk;                               // BQ x ldk

  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  // causal and window: the q tiles with the most keys start first
  const int qt = MASK == kFull ? blockIdx.y : gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qw0 = q0 + warp * 16;  // the warp's first query row
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int hi = MASK == kFull ? Skv : min(Skv, q_offset + q_last + 1);
  const int first_key = MASK == kWindow ? max(0, q_offset + q0 - window + 1) : 0;
  const int lo = first_key - first_key % kTK;
  const int n_tiles = hi > lo ? (hi - lo + kTK - 1) / kTK : 0;

  const int64_t sk = static_cast<int64_t>(Hkv) * Dk;
  const int64_t sv = static_cast<int64_t>(Hkv) * Dv;
  const __nv_bfloat16* kb = k + (static_cast<int64_t>(b) * Skv * Hkv + hk) * Dk;
  const __nv_bfloat16* vb = v + (static_cast<int64_t>(b) * Skv * Hkv + hk) * Dv + dv0;
  auto stage_kv = [&](int stage, int k0) {
    const int valid = min(kTK, hi - k0);  // zeros past the causal limit
    stage_bf16<NT, KCPR>(Ks + stage * kTK * ldk, ldk, kb + k0 * sk, sk, kTK,
                         valid, Dk, dkp, vec);
    stage_bf16<NT, VCPR>(Vs + stage * kTK * ldv, ldv, vb + k0 * sv, sv, kTK,
                         valid, dvc, dvp, vec);
  };

  float acc[DTILES][4];
#pragma unroll
  for (int j = 0; j < DTILES; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_r[2] = {repro::kNegInf, repro::kNegInf};  // rows g and g + 8
  float l_r[2] = {0.f, 0.f};                        // this lane's part
  uint32_t qf[KSTEPS][4];

  if (n_tiles > 0) {
    stage_bf16<NT, KCPR>(
        Qs, ldk, q + ((static_cast<int64_t>(b) * Sq + q0) * Hq + h) * Dk,
        static_cast<int64_t>(Hq) * Dk, BQ, min(BQ, Sq - q0), Dk, dkp, vec);
    stage_kv(0, lo);
    repro::cp_async_commit();
    repro::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      if (kk * 16 < dkp)
        ldsm_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * ldk + kk * 16 +
                            (lane >> 4) * 8);
    __syncthreads();  // Q leaves K's second stage before tile 1 lands there
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = lo + it * kTK;
    if (it + 1 < n_tiles) {  // tile it + 1 loads while tile it computes
      stage_kv((it + 1) & 1, k0 + kTK);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();
    // a warp skips a tile none of its rows can see: rows past Sq, keys
    // past its causal limit or before its window
    bool skip = qw0 >= Sq;
    if constexpr (MASK != kFull) skip = skip || k0 > q_offset + qw0 + 15;
    if constexpr (MASK == kWindow)
      skip = skip || k0 + kTK - 1 < q_offset + qw0 - window + 1;
    if (!skip) {
      const __nv_bfloat16* Kt = Ks + (it & 1) * kTK * ldk;
      const __nv_bfloat16* Vt = Vs + (it & 1) * kTK * ldv;
      float s[STILES][4];
#pragma unroll
      for (int j = 0; j < STILES; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      // S = Q K^T: one ldmatrix.x4 gives two key tiles' B fragments; each
      // k step feeds the 8 independent accumulators of the score tile
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        if (kk * 16 < dkp) {
          uint32_t kf[STILES / 2][4];
#pragma unroll
          for (int np = 0; np < STILES / 2; ++np)
            ldsm_x4(kf[np],
                    Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldk +
                        kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int np = 0; np < STILES / 2; ++np) {
            mma_bf16(s[2 * np], qf[kk], kf[np][0], kf[np][1]);
            mma_bf16(s[2 * np + 1], qf[kk], kf[np][2], kf[np][3]);
          }
        }
      // into log2 units (capped first, in natural units); the mask only
      // where the tile needs it
      const int qpos0 = q_offset + qw0 + (lane >> 2);  // rows g, g + 8
      const bool tail = k0 + kTK > Skv;
      const bool diag = MASK != kFull && k0 + kTK - 1 > q_offset + qw0;
      const bool edge = MASK == kWindow && q_offset + qw0 + 15 - k0 >= window;
#pragma unroll
      for (int j = 0; j < STILES; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (CAP)
            s[j][e] = repro::softcap<CAP>(s[j][e] * scale, cap) * kLog2e;
          else
            s[j][e] *= scale_log2;
          if (tail || diag || edge) {
            const int kpos = k0 + j * 8 + 2 * (lane & 3) + (e & 1);
            const int qpos = qpos0 + (e >> 1) * 8;
            bool vis = kpos < Skv;  // the KV tail
            if constexpr (MASK != kFull) vis = vis && kpos <= qpos;
            if constexpr (MASK == kWindow) vis = vis && qpos - kpos < window;
            if (!vis) s[j][e] = repro::kNegInf;
          }
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = repro::kNegInf;
#pragma unroll
        for (int j = 0; j < STILES; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_r[r], mx);
        corr[r] = fast_exp2(m_r[r] - m_new);
        m_r[r] = m_new;
        l_r[r] *= corr[r];
      }
      // P in registers as two bf16 terms: the A fragments of P.V
      uint32_t ph[STILES][2], pr[STILES][2];
#pragma unroll
      for (int j = 0; j < STILES; ++j) {
        split_pack(fast_exp2(s[j][0] - m_r[0]), fast_exp2(s[j][1] - m_r[0]),
                   ph[j][0], pr[j][0], l_r[0]);
        split_pack(fast_exp2(s[j][2] - m_r[1]), fast_exp2(s[j][3] - m_r[1]),
                   ph[j][1], pr[j][1], l_r[1]);
      }
#pragma unroll
      for (int j = 0; j < DTILES; ++j) {
        acc[j][0] *= corr[0];
        acc[j][1] *= corr[0];
        acc[j][2] *= corr[1];
        acc[j][3] *= corr[1];
      }
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk) {
        const uint32_t pa[4] = {ph[2 * kk][0], ph[2 * kk][1], ph[2 * kk + 1][0],
                                ph[2 * kk + 1][1]};
        const uint32_t pb[4] = {pr[2 * kk][0], pr[2 * kk][1], pr[2 * kk + 1][0],
                                pr[2 * kk + 1][1]};
        // the head term into every output accumulator, then the remainder:
        // no two consecutive mma share an accumulator
        uint32_t vf[DTILES / 2][4];
#pragma unroll
        for (int dp = 0; dp < DTILES / 2; ++dp)
          if (dp * 16 < dvp)
            ldsm_x4_t(vf[dp], Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldv +
                                  dp * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int dp = 0; dp < DTILES / 2; ++dp)
          if (dp * 16 < dvp) {
            mma_bf16(acc[2 * dp], pa, vf[dp][0], vf[dp][1]);
            mma_bf16(acc[2 * dp + 1], pa, vf[dp][2], vf[dp][3]);
          }
#pragma unroll
        for (int dp = 0; dp < DTILES / 2; ++dp)
          if (dp * 16 < dvp) {
            mma_bf16(acc[2 * dp], pb, vf[dp][0], vf[dp][1]);
            mma_bf16(acc[2 * dp + 1], pb, vf[dp][2], vf[dp][3]);
          }
      }
    }
    __syncthreads();  // the stage is consumed before it is loaded again
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = qw0 + (lane >> 2) + 8 * r;
    if (row >= Sq) continue;
    // a row that never saw a key keeps m at NEG_INF: emit zeros, not mean(v)
    const bool seen = m_r[r] > repro::kNegInf * 0.5f;
    l = fmaxf(l, 1e-30f);
    __nv_bfloat16* orow =
        o + ((static_cast<int64_t>(b) * Sq + row) * Hq + h) * Dv + dv0;
#pragma unroll
    for (int j = 0; j < DTILES; ++j) {
      const int c = j * 8 + 2 * (lane & 3);
      if (c < dvc) orow[c] = __float2bfloat16_rn(seen ? acc[j][2 * r] / l : 0.f);
      if (c + 1 < dvc)
        orow[c + 1] = __float2bfloat16_rn(seen ? acc[j][2 * r + 1] / l : 0.f);
    }
  }
}

template <typename T, bool VEC, int MASK, bool CAP>
int launch_impl(const void* q, const void* k, const void* v, void* o, int B,
                int Sq, int Skv, int Hq, int Hkv, int Dk, int Dv,
                int q_offset, int window, float scale, float cap,
                cudaStream_t stream) {
  // Dk past 128 (MLA's causal prefill, recurrentgemma's window) stages
  // wider rows: instantiations of their own, so the common one keeps its
  // trip counts; capped, none (the entry refuses them)
  auto kernel = attn_kernel<T, VEC, MASK, kDMax, kDMax, CAP>;
  if constexpr (MASK == kCausal && !CAP)
    if (Dk > kDMax) kernel = attn_kernel<T, VEC, MASK, kDkWide, kDMax, false>;
  if constexpr (MASK == kWindow && !CAP)
    if (Dk > kDMax) kernel = attn_kernel<T, VEC, MASK, kD256, kD256, false>;
  const size_t smem = smem_bytes(Dk, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>(B) * Hq, (Sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, Hq, Hkv, Dk, Dv,
      q_offset, window, scale, cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MASK, bool CAP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int Hq, int Hkv, int Dk, int Dv, int q_offset,
           int window, float scale, float cap, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = Dk % V == 0 && Dv % V == 0 && repro::aligned16(q) &&
                   repro::aligned16(k) && repro::aligned16(v);
  return vec ? launch_impl<T, true, MASK, CAP>(q, k, v, o, B, Sq, Skv, Hq, Hkv,
                                               Dk, Dv, q_offset, window, scale,
                                               cap, stream)
             : launch_impl<T, false, MASK, CAP>(q, k, v, o, B, Sq, Skv, Hq, Hkv,
                                                Dk, Dv, q_offset, window, scale,
                                                cap, stream);
}

// DV_SPLIT: the CTAs (grid z) that share a row tile's output columns
template <int MASK, int DKMAX, int DVMAX, int WARPS, bool EXACT, bool CAP,
          int DV_SPLIT = 1>
int launch_mma_impl(const void* q, const void* k, const void* v, void* o,
                    int B, int Sq, int Skv, int Hq, int Hkv, int Dk, int Dv,
                    int q_offset, int window, float scale, float cap, bool vec,
                    cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(pad16(Dk), pad16(Dv / DV_SPLIT));
  cudaError_t err = cudaFuncSetAttribute(
      attn_mma_kernel<MASK, DKMAX, DVMAX, WARPS, EXACT, CAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = 16 * WARPS;
  dim3 grid(static_cast<unsigned>(B) * Hq, (Sq + rows - 1) / rows, DV_SPLIT);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  attn_mma_kernel<MASK, DKMAX, DVMAX, WARPS, EXACT, CAP>
      <<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq,
      Skv, Hq, Hkv, Dk, Dv, q_offset, window, scale * kLog2e, scale, cap, vec);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 body's instantiation: (DKMAX, DVMAX) from the padded head dims,
// (64, 64), (128, 128), causal only MLA's (192, 128), or, window only,
// recurrentgemma's (256, 256) as two CTAs of (256, 128); 2 warps a CTA where 4-warp
// tiles would fill at most half the SMs (the vit-b16 and detector shapes;
// llama's 128 CTAs at s256 run faster at 4 warps); capped, the common
// pairs alone (the entry refuses the wide ones)
template <int MASK, bool CAP>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Skv, int Hq, int Hkv, int Dk, int Dv, int q_offset,
               int window, float scale, float cap, int device,
               cudaStream_t stream) {
  const bool vec = Dk % 8 == 0 && Dv % 8 == 0 && repro::aligned16(q) &&
                   repro::aligned16(k) && repro::aligned16(v);
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool narrow =
      2 * static_cast<int64_t>(B) * Hq * ((Sq + 63) / 64) <= sms;
  const int dkp = pad16(Dk), dvp = pad16(Dv);
#define REPRO_MMA(DK, DV, W, X)                                              \
  launch_mma_impl<MASK, DK, DV, W, X, CAP>(q, k, v, o, B, Sq, Skv, Hq, Hkv,  \
                                           Dk, Dv, q_offset, window, scale,  \
                                           cap, vec, stream)
#define REPRO_MMA_DIMS(DK, DV, W)                                            \
  (Dk == DK && Dv == DV ? REPRO_MMA(DK, DV, W, true)                         \
                        : REPRO_MMA(DK, DV, W, false))
  if constexpr (MASK == kCausal && !CAP)
    if (Dk == kDkWide)  // MLA's (192, 128) alone: exact trip counts
      return narrow ? REPRO_MMA(192, 128, 2, true) : REPRO_MMA(192, 128, 4, true);
  if constexpr (MASK == kWindow && !CAP)
    if (Dk == kD256)  // (256, 256) alone: Dv over two CTAs of 128 columns
      return narrow
          ? launch_mma_impl<MASK, 256, 128, 2, true, false, 2>(
                q, k, v, o, B, Sq, Skv, Hq, Hkv, Dk, Dv, q_offset, window,
                scale, cap, vec, stream)
          : launch_mma_impl<MASK, 256, 128, 4, true, false, 2>(
                q, k, v, o, B, Sq, Skv, Hq, Hkv, Dk, Dv, q_offset, window,
                scale, cap, vec, stream);
  if (dkp > 64 || dvp > 64)
    return narrow ? REPRO_MMA_DIMS(128, 128, 2) : REPRO_MMA_DIMS(128, 128, 4);
  return narrow ? REPRO_MMA_DIMS(64, 64, 2) : REPRO_MMA_DIMS(64, 64, 4);
#undef REPRO_MMA_DIMS
#undef REPRO_MMA
}

// CAP: the capped instantiations, at the common head dims alone (both up
// to 128: no model caps MLA's or recurrentgemma's attention), cap > 0
template <int MASK, bool CAP>
int entry(const void* q, const void* k, const void* v, void* o, int B, int Sq,
          int Skv, int Hq, int Hkv, int Dk, int Dv, int q_offset, int window,
          float scale, float cap, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || Sq <= 0 || Skv < 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv ||
      !dims_taken(Dk, Dv, MASK) || q_offset < 0 || window <= 0 ||
      (Sq + kBQ - 1) / kBQ > 65535 ||
      (CAP && (Dk > kDMax || Dv > kDMax || !(cap > 0.f))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch<float, MASK, CAP>(q, k, v, o, B, Sq, Skv, Hq, Hkv, Dk, Dv,
                                    q_offset, window, scale, cap, s);
  if (dtype == repro::kBF16)
    return launch_mma<MASK, CAP>(q, k, v, o, B, Sq, Skv, Hq, Hkv, Dk, Dv,
                                 q_offset, window, scale, cap, device, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// attention_softcap.cu builds this source again with REPRO_ATTENTION_SOFTCAP
// defined: the capped entries (the same names with _softcap and a `cap`
// argument), in a library of their own, so that nvcc compiles the two sets
// of instantiations in parallel
#ifndef REPRO_ATTENTION_SOFTCAP

// causal: query row i sits at q_offset + i and sees keys up to it
extern "C" int repro_attention_causal(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int Hq, int Hkv, int Dk, int Dv,
                                      int q_offset, float scale, int dtype,
                                      int device, void* stream) {
  return entry<kCausal, false>(q, k, v, o, B, Sq, Skv, Hq, Hkv, Dk, Dv,
                               q_offset, 1, scale, 0.f, dtype, device, stream);
}

// window: causal, and query row i sees only keys at q_offset + i - kpos <
// window (the sliding-window `local` layers)
extern "C" int repro_attention_window(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int Hq, int Hkv, int Dk, int Dv,
                                      int q_offset, int window, float scale,
                                      int dtype, int device, void* stream) {
  return entry<kWindow, false>(q, k, v, o, B, Sq, Skv, Hq, Hkv, Dk, Dv,
                               q_offset, window, scale, 0.f, dtype, device,
                               stream);
}

// full: every key is visible (KV padding only); Sq != Skv allowed
extern "C" int repro_attention_full(const void* q, const void* k,
                                    const void* v, void* o, int B, int Sq,
                                    int Skv, int Hq, int Hkv, int Dk, int Dv,
                                    float scale, int dtype, int device,
                                    void* stream) {
  return entry<kFull, false>(q, k, v, o, B, Sq, Skv, Hq, Hkv, Dk, Dv, 0, 1,
                             scale, 0.f, dtype, device, stream);
}

#else

// the three masks with the scores capped at `cap` (> 0) before the mask;
// head dims up to 128
extern "C" int repro_attention_causal_softcap(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Skv, int Hq, int Hkv, int Dk, int Dv, int q_offset, float scale,
    float cap, int dtype, int device, void* stream) {
  return entry<kCausal, true>(q, k, v, o, B, Sq, Skv, Hq, Hkv, Dk, Dv,
                              q_offset, 1, scale, cap, dtype, device, stream);
}

extern "C" int repro_attention_window_softcap(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Skv, int Hq, int Hkv, int Dk, int Dv, int q_offset, int window,
    float scale, float cap, int dtype, int device, void* stream) {
  return entry<kWindow, true>(q, k, v, o, B, Sq, Skv, Hq, Hkv, Dk, Dv,
                              q_offset, window, scale, cap, dtype, device,
                              stream);
}

extern "C" int repro_attention_full_softcap(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Skv, int Hq, int Hkv, int Dk, int Dv, float scale, float cap,
    int dtype, int device, void* stream) {
  return entry<kFull, true>(q, k, v, o, B, Sq, Skv, Hq, Hkv, Dk, Dv, 0, 1,
                            scale, cap, dtype, device, stream);
}

#endif
