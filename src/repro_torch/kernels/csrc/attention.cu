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
//   * templated on the largest padded head dim (DMAX 64 or 128) and on
//     whether both head dims equal it: then every fragment loop has a
//     compile-time trip count, the body needs under 170 registers and is
//     bound to 3 CTAs an SM (12 warps); other dims take the same body
//     with runtime trip counts. A later head dim (192, 256) is another
//     instantiation, at more registers.
// f32, Table 2's micro-benchmark path (attn_kernel): the FMA body. TF32
//   products would keep ~3 decimal digits, outside f32's 2e-5 limit, so
//   it stays on the CUDA cores: 256 threads per 64-row q tile, tiles
//   widened to f32 in shared memory (common.cuh stage_rows), thread t
//   owning 4 query rows (t/16) and every 16th score and output column.
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
    const int valid = min(kBK, kv_end - k0);  // zeros past the causal limit
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane i gives the row address of matrix i / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4],
                                          const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 2^x by the SFU (ex2.approx.ftz: relative error ~2^-22, 3-4 % faster on
// these shapes than exp2f's denormal-safe sequence)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two probabilities, each as a bf16 head plus the bf16 of its remainder,
// packed in pairs (the first in the low half); the values the pairs hold
// are added to `sum`
__device__ __forceinline__ void split_pack(float a, float b, uint32_t& head,
                                           uint32_t& rest, float& sum) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float ha = __low2float(h), hb = __high2float(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(a - ha, b - hb);
  sum += (ha + __low2float(r)) + (hb + __high2float(r));
  head = *reinterpret_cast<const uint32_t*>(&h);
  rest = *reinterpret_cast<const uint32_t*>(&r);
}

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

// EXACT: both head dims equal DMAX, so every fragment loop has a
// compile-time trip count and the body fits 3 CTAs of 4 warps (or 6 of 2)
// on an SM; otherwise the padded dims are runtime values
template <int MASK, int DMAX, int WARPS, bool EXACT>
__global__ void __launch_bounds__(WARPS * 32, EXACT ? 12 / WARPS : 1)
    attn_mma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, int Sq, int Skv, int Hq,
                    int Hkv, int Dk, int Dv, int q_offset, int window,
                    float scale_log2, bool vec) {
  constexpr int NT = WARPS * 32, BQ = WARPS * 16;
  constexpr int KSTEPS = DMAX / 16;  // k16 steps of Q.K^T
  constexpr int DTILES = DMAX / 8;   // n8 tiles of the output
  constexpr int STILES = kTK / 8;    // n8 tiles of a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dkp = EXACT ? DMAX : pad16(Dk), dvp = EXACT ? DMAX : pad16(Dv);
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
  const __nv_bfloat16* vb = v + (static_cast<int64_t>(b) * Skv * Hkv + hk) * Dv;
  auto stage_kv = [&](int stage, int k0) {
    const int valid = min(kTK, hi - k0);  // zeros past the causal limit
    stage_bf16<NT, DMAX / 8>(Ks + stage * kTK * ldk, ldk, kb + k0 * sk, sk,
                             kTK, valid, Dk, dkp, vec);
    stage_bf16<NT, DMAX / 8>(Vs + stage * kTK * ldv, ldv, vb + k0 * sv, sv,
                             kTK, valid, Dv, dvp, vec);
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
    stage_bf16<NT, DMAX / 8>(
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
      // into log2 units; the mask only where the tile needs it
      const int qpos0 = q_offset + qw0 + (lane >> 2);  // rows g, g + 8
      const bool tail = k0 + kTK > Skv;
      const bool diag = MASK != kFull && k0 + kTK - 1 > q_offset + qw0;
      const bool edge = MASK == kWindow && q_offset + qw0 + 15 - k0 >= window;
#pragma unroll
      for (int j = 0; j < STILES; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
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
    __nv_bfloat16* orow = o + ((static_cast<int64_t>(b) * Sq + row) * Hq + h) * Dv;
#pragma unroll
    for (int j = 0; j < DTILES; ++j) {
      const int c = j * 8 + 2 * (lane & 3);
      if (c < Dv) orow[c] = __float2bfloat16_rn(seen ? acc[j][2 * r] / l : 0.f);
      if (c + 1 < Dv)
        orow[c + 1] = __float2bfloat16_rn(seen ? acc[j][2 * r + 1] / l : 0.f);
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

template <int MASK, int DMAX, int WARPS, bool EXACT>
int launch_mma_impl(const void* q, const void* k, const void* v, void* o,
                    int B, int Sq, int Skv, int Hq, int Hkv, int Dk, int Dv,
                    int q_offset, int window, float scale, bool vec,
                    cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(pad16(Dk), pad16(Dv));
  cudaError_t err = cudaFuncSetAttribute(
      attn_mma_kernel<MASK, DMAX, WARPS, EXACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = 16 * WARPS;
  dim3 grid(static_cast<unsigned>(B) * Hq, (Sq + rows - 1) / rows);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  attn_mma_kernel<MASK, DMAX, WARPS, EXACT>
      <<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq,
      Skv, Hq, Hkv, Dk, Dv, q_offset, window, scale * kLog2e, vec);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 body's instantiation: DMAX from the padded head dims; 2 warps a
// CTA where 4-warp tiles would fill at most half the SMs (the vit-b16
// and detector shapes; llama's 128 CTAs at s256 run faster at 4 warps)
template <int MASK>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Skv, int Hq, int Hkv, int Dk, int Dv, int q_offset,
               int window, float scale, int device, cudaStream_t stream) {
  const bool vec = Dk % 8 == 0 && Dv % 8 == 0 && repro::aligned16(q) &&
                   repro::aligned16(k) && repro::aligned16(v);
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool narrow =
      2 * static_cast<int64_t>(B) * Hq * ((Sq + 63) / 64) <= sms;
  const bool wide = pad16(Dk) > 64 || pad16(Dv) > 64;
#define REPRO_MMA(DM, W, X)                                                  \
  launch_mma_impl<MASK, DM, W, X>(q, k, v, o, B, Sq, Skv, Hq, Hkv, Dk, Dv,   \
                                  q_offset, window, scale, vec, stream)
#define REPRO_MMA_DIMS(DM, W)                                                \
  (Dk == DM && Dv == DM ? REPRO_MMA(DM, W, true) : REPRO_MMA(DM, W, false))
  if (wide) return narrow ? REPRO_MMA_DIMS(128, 2) : REPRO_MMA_DIMS(128, 4);
  return narrow ? REPRO_MMA_DIMS(64, 2) : REPRO_MMA_DIMS(64, 4);
#undef REPRO_MMA_DIMS
#undef REPRO_MMA
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
    return launch_mma<MASK>(q, k, v, o, B, Sq, Skv, Hq, Hkv, Dk, Dv, q_offset,
                            window, scale, device, s);
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
