// One-query decode attention over a per-row valid KV prefix, split over
// the cache.
//
// Replaces the TPU kernel `_decode_kernel` (shared body
// `_online_softmax_step`) reached through `decode_core` in
// src/repro/kernels/attn_template.py (pallas_call at :335).
//
// q (B,1,Hq,Dk), k (B,T,Hkv,Dk), v (B,T,Hkv,Dv), lengths (B,) int32
// -> o (B,1,Hq,Dv): row b attends keys [0, lengths[b]).
//
// Bound on the card: bytes. Every valid KV row is read once for about
// 4*G*D flops (G = Hq/Hkv queries share it), far under the card's ~295
// flop/byte balance: the design is about keeping every SM streaming. What
// every body does:
//   * the grid is (B*Hkv, n_split): split s of row b takes the keys
//     [s*C, min((s+1)*C, lengths[b])), C a whole number of the body's
//     tiles. The wrapper chooses n_split and C from the shapes and the SM
//     count alone (attn_template.decode_splits), never from lengths, which
//     the kernel reads on the card: a split past lengths[b] runs no tile
//     and exits. With n_split > 1 each split writes its partial (m, l, acc)
//     in f32 to scratch the wrapper allocates, and the last split of the
//     row and head to finish (a counter per (b, kv-head), which it sets
//     back to 0) merges them: m = max m_s, l = sum l_s e^(m_s - m),
//     o = sum acc_s e^(m_s - m) / l, reading the partials from L2; exact
//     zeros where no split saw a key (lengths[b] == 0). The merge is a
//     pass of the same launch: a second launch would cost about what the
//     splits do at the serve lengths. With n_split == 1 the kernel writes
//     o itself;
//   * a CTA holds the whole GQA group, so each K/V row is read from device
//     memory once for all G query heads (the TPU kernel padded each single
//     query row to an 8-row block per head);
//   * K and V stay in their storage type in shared memory (bf16 for the
//     serving path), brought in by 16-byte cp.async copies, the rows of a
//     tile past the split's keys zero-filled, not read; a head dim or
//     pointer that rules out 16-byte copies is staged element by element.
//
// The common body (decode_kernel; Dk, Dv <= 128, any group up to 32, f32
// and bf16) runs on the CUDA cores: at G <= 8 a key's products are too few
// for the tensor cores. Two stages of 64-key tiles, so tile j+1 loads
// while tile j computes; scores take two threads a key, each reading
// alternate 16-byte chunks of the row (rows padded so that a load phase
// hits distinct banks) and holding the G partial dots in registers (groups
// of 1, 2, 4 and 8 get bodies of their own, without branches in the
// loops), closed by one shuffle; P.V gives each thread two adjacent
// columns of every head and an interleaved share of the tile's keys, the
// shares added at the end; the online (m, l) live in shared memory in
// f32, one warp running a head's softmax update of 64 scores with two
// shuffles.
//
// The wide bodies take MLA's absorbed decode: Dk 576 (the 512-d latent and
// the 64-d rope key), Dv 512 (the latent), one KV head for a group of 16;
// and recurrentgemma's local layers: Dk = Dv = 256, one KV head for a
// group of 10; these dims at these groups alone (dims_taken). There G
// heads share every wide key, and a [16 x Dk] . [Dk x n] product is the
// shape of mma.sync.m16n8k16 with the heads as M (rows past G zero).
//
// bf16, the serving path (decode_mma_kernel): the tensor-core body,
// templated on (Dk, Dv, G, keys a tile): <576, 512, 16, 32> and <256, 256,
// 10, 32>. At G 10, M's rows 10-15 hold zero queries; their scores and
// outputs are computed and stored nowhere, neither in o nor in the
// partials. The layout below is MLA's; at 256 / 256 the three stages take
// 99 KB and each warp owns 32 columns.
//   * 8 warps; tiles of 32 keys, in three stages (two tiles in flight
//     while one computes): 3 x 32 x (584 + 520) bf16, rows padded by 16
//     bytes so that ldmatrix's eight row addresses fall in distinct banks,
//     207 KB, and the partial scores 5 KB: 212 KB of the 227 KB a block
//     may have, one CTA an SM;
//   * S = q K^T: warp w takes the tile's keys 8(w % 4) .. 8(w % 4) + 7 (an
//     n8 slice) over half of Dk (18 of the 36 k16 steps, w / 4), its q
//     fragments (the A operand: the 16 heads as rows, zero past G) loaded
//     from device memory once per CTA and held in registers over the
//     split's tiles, K's by ldmatrix, f32 accumulators; the two halves
//     meet in shared memory;
//   * the online softmax in f32, in log2 units, every warp reading the
//     whole 16 x 32 score tile and running it for itself (the same
//     arithmetic in every warp, so all hold the same m and l): a row's
//     max over the 4 lanes that share it with two shuffles; keys at or
//     past the split's end masked to NEG_INF;
//   * P.V: P (16 x 32) as the A operand straight from those registers, as
//     two bf16 terms, its bf16 head and the bf16 of the remainder (16
//     significant bits, as attention.cu's bf16 body; one term errs by up
//     to 2^-9 of each weight, tests/test_torch_attn_design.py), V's B
//     fragments by ldmatrix.trans; warp w owns output columns 64w .. 64w
//     + 63 of every head in f32 accumulators;
//   * the merge of a split plan: per-head weights e^(m_s - m) / l in
//     shared memory, then each thread adds its 8 float4 of the n_seen
//     partials, the loads of four splits in flight together.
// f32 (decode_kernel's wide instantiation): the FMA body, as prefill
//   keeps for f32 (TF32 products would miss f32's limit). Two stages of
//   16-key tiles of 576 / 512 f32, eight threads a key with three
//   shuffles closing each score, four adjacent P.V columns a thread;
//   q, the scores and the (m, l) state in f32: 179 KB (89 KB at 256 / 256
//   and G 10, its instantiation at that group).
//
// The softcap fragment (the TPU body's `softcap`, Gemma 2's attention
// logit cap): the common body takes a compile-time CAP; where it is set
// each score is capped, tanh(s / cap) * cap with tanhf and an IEEE
// division, on the natural-unit score before the mask (this body has no
// log2 fold), so a key past the length stays NEG_INF and a length of 0
// still gives zeros. The partials' (m, l) and the merge are those of the
// capped scores, unchanged. The wide bodies take no cap: no model caps
// MLA's absorbed decode or recurrentgemma's 256 / 256, and their registers
// are spent. decode_softcap.cu builds the capped instantiations as a
// library of their own; an uncapped one compiles to the code it had.
#include "common.cuh"

namespace {

using repro::fast_exp2;
using repro::ldsm_x4;
using repro::ldsm_x4_t;
using repro::mma_bf16;
using repro::split_pack;

constexpr int kBK = 64;        // keys per staged tile: two threads a key
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kDMax = 128;     // largest Dk and Dv of the common body
constexpr int kDkWide = 576;   // Dk of the wide bodies (MLA: 512 + 64)
constexpr int kDvWide = 512;   // Dv of the wide bodies (MLA's latent)
constexpr int kGWide = 16;     // the wide bodies' group (MLA's 16 heads)
constexpr int kD256 = 256;     // recurrentgemma's local layers: Dk = Dv
constexpr int kG256 = 10;      // and their group (10 query heads, 1 KV head)
constexpr int kPwWide = 4;     // P.V columns a thread owns in the f32 wide body
constexpr int kBKWideF32 = 16; // keys a tile of the f32 wide body
constexpr int kGMax = 32;      // largest GQA group taken

// the bf16 wide body (decode_mma_kernel)
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaBK = 32;         // keys a tile
constexpr int kMmaStages = 3;      // tiles in shared memory: two in flight
constexpr int kMmaPad = 8;         // row padding of a staged tile: 16 bytes
constexpr int kMmaM = 16;          // the heads of a CTA: mma's M, zero past G
constexpr int kMmaSPad = 8;        // row padding of the partial scores (f32)
constexpr int kMmaMaxSplits = 1024;  // the merge's weights fit the K stages
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A head dim past 128 (MLA's absorbed decode, 576 / 512; recurrentgemma's
// 256 / 256) runs a wide body
__host__ __device__ __forceinline__ bool wide_dims(int dk, int dv) {
  return dk > kDMax || dv > kDMax;
}

// the head dims and group taken: both dims up to 128 at any group up to
// kGMax, or the wide bodies' dims at their group: MLA's (576, 512) at 16,
// recurrentgemma's (256, 256) at 10
__host__ __device__ __forceinline__ bool dims_taken(int dk, int dv, int g) {
  if (dk <= 0 || dv <= 0) return false;
  if (!wide_dims(dk, dv)) return g <= kGMax;
  return (dk == kDkWide && dv == kDvWide && g == kGWide) ||
         (dk == kD256 && dv == kD256 && g == kG256);
}

// keys a staged tile of the body that runs (dk, dv) in `elem`-byte
// elements holds: a split plan's chunk must be a whole number of them
__host__ __device__ __forceinline__ int body_tile(int dk, int dv, int elem) {
  if (!wide_dims(dk, dv)) return kBK;
  return elem == 2 ? kMmaBK : kBKWideF32;
}

// Row pitch (elements) of a staged K or V tile. 16-byte copies: rows padded
// so that consecutive rows start two 16-byte bank groups apart, which puts
// the 8 lanes of a 16-byte load phase (4 keys x 2 halves) on distinct
// groups; element by element: unpadded.
__host__ __device__ __forceinline__ int row_pitch(int cols, int elem, bool vec) {
  if (!vec) return cols;
  const int groups = cols * elem / 16;
  return (groups + (10 - groups % 8) % 8) * (16 / elem);
}

// P.V: a thread owns pw adjacent output columns of every query head, over
// the keys ph, ph + nph, ... of a tile; nph >= 1 wherever dims_taken
__host__ __device__ __forceinline__ int pv_phases(int dv, int pw) {
  return kThreads / (dv / pw);
}

// P.V columns a thread of decode_kernel owns
__host__ __device__ __forceinline__ int pv_width(bool wide, bool vec) {
  return wide ? kPwWide : (vec ? 2 : 1);
}

// decode_kernel: two stages of K and V in the storage type, then q,
// scores, (m, l, corr) and the P.V phases' parts in f32
size_t smem_bytes(int g, int dk, int dv, int elem, bool vec) {
  const bool wide = wide_dims(dk, dv);
  const size_t bk = body_tile(dk, dv, elem);
  const size_t tiles = 2 * bk *
                       (row_pitch(dk, elem, vec) + row_pitch(dv, elem, vec)) * elem;
  const int nph = pv_phases(dv, pv_width(wide, vec));
  return tiles + sizeof(float) * (static_cast<size_t>(g) * dk +
                                  static_cast<size_t>(g) * bk + 3 * static_cast<size_t>(g) +
                                  static_cast<size_t>(nph - 1) * g * dv);
}

// BK rows of `cols` elements (row stride `stride`) into shared memory at
// pitch `ld`; rows past `valid` are zero. VEC: 16-byte cp.async copies, a
// warp per row, completed by the caller's cp_async_wait; otherwise
// element by element, complete on return.
template <typename T, bool VEC, int BK>
__device__ __forceinline__ void stage_tile(T* dst, int ld, const T* __restrict__ src,
                                           int64_t stride, int valid, int cols) {
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T);
    const int cpr = cols / V, lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < BK; r += kWarps) {
      const bool ok = r < valid;
      for (int c = lane; c < cpr; c += 32)
        repro::cp_async16(dst + r * ld + c * V, ok ? src + r * stride + c * V : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < BK * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      dst[r * ld + c] = r < valid ? src[r * stride + c] : repro::from_f<T>(0.f);
    }
  }
}

// GC: the group G = Hq / Hkv where it is 1, 2, 4 or 8 (16 in the f32 wide
// body: MLA's), known at compile time, so that a thread's G partial dots
// and accumulators stay in registers and its loops carry no branch; 0: any
// G up to kGMax, guarded. BK: keys a tile; PW: P.V columns a thread owns;
// CAP: the scores capped at `cap` (repro::softcap, natural units) before
// the mask
template <typename T, bool VEC, int GC, int BK, int PW, bool CAP>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ lengths,
                  T* __restrict__ o, float* __restrict__ part_acc,
                  float* __restrict__ part_ml, int* __restrict__ sem, int Tlen,
                  int Hq, int Hkv, int Dk, int Dv, float scale, float cap,
                  int chunk) {
  constexpr int VW = VEC ? 16 / sizeof(T) : 1;  // elements a score load reads
  constexpr int TPK = kThreads / BK;            // threads a key (2, 4, 8)
  constexpr int NPL = (BK + 31) / 32;           // scores a lane of the softmax
  constexpr int GM = GC ? GC : kGMax;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = GC ? GC : Hq / Hkv;
  const int ldk = row_pitch(Dk, sizeof(T), VEC), ldv = row_pitch(Dv, sizeof(T), VEC);
  T* Ks = reinterpret_cast<T*>(smem_raw);    // 2 stages of BK x ldk
  T* Vs = Ks + 2 * BK * ldk;                 // 2 stages of BK x ldv
  float* Qs = reinterpret_cast<float*>(Vs + 2 * BK * ldv);  // G x Dk
  float* Ss = Qs + G * Dk;     // G x BK: scores, then probabilities
  float* Ml = Ss + G * BK;     // G x (m, l, corr)
  float* Red = Ml + 3 * G;     // (nph - 1) x G x Dv: the P.V phases' parts

  const int bh = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int b = bh / Hkv, hk = bh % Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(lengths[b], 0), Tlen);
  const int begin = split * chunk;
  const int end = min(len, begin + chunk);
  const int64_t obase = (static_cast<int64_t>(b) * Hq + static_cast<int64_t>(hk) * G) * Dv;
  if (n_split > 1 && begin >= len) {  // no key here; the merge reads nothing
    if (len == 0 && split == 0)       // of it. No split sees a key: zeros
      for (int i = threadIdx.x; i < G * Dv; i += kThreads)
        o[obase + i] = repro::from_f<T>(0.f);
    return;
  }
  const int n_tiles = end > begin ? (end - begin + BK - 1) / BK : 0;

  const int64_t sk = static_cast<int64_t>(Hkv) * Dk;
  const int64_t sv = static_cast<int64_t>(Hkv) * Dv;
  const T* kb = k + (static_cast<int64_t>(b) * Tlen * Hkv + hk) * Dk;
  const T* vb = v + (static_cast<int64_t>(b) * Tlen * Hkv + hk) * Dv;
  auto stage = [&](int st, int k0) {
    const int valid = min(BK, end - k0);
    stage_tile<T, VEC, BK>(Ks + st * BK * ldk, ldk, kb + k0 * sk, sk, valid, Dk);
    stage_tile<T, VEC, BK>(Vs + st * BK * ldv, ldv, vb + k0 * sv, sv, valid, Dv);
  };
  if (n_tiles > 0) {
    stage(0, begin);
    repro::cp_async_commit();
  }

  // the group's G query heads are contiguous in q[b, 0, :, :]
  const int64_t qbase = (static_cast<int64_t>(b) * Hq + static_cast<int64_t>(hk) * G) * Dk;
  for (int i = tid; i < G * Dk; i += kThreads) Qs[i] = repro::to_f(q[qbase + i]);
  for (int g = tid; g < G; g += kThreads) {
    Ml[3 * g] = repro::kNegInf;
    Ml[3 * g + 1] = 0.f;
    Ml[3 * g + 2] = 1.f;
  }

  // scores: thread t takes key t / TPK and every TPK-th chunk from t % TPK
  const int key = tid / TPK, sub = tid % TPK;
  // P.V: columns [PW * col, PW * col + PW) of every head, keys ph + nph * i
  const int ncol = Dv / PW, nph = kThreads / ncol;
  const int col = tid % ncol, ph = tid / ncol;
  float acc[GM][PW];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < PW; ++e) acc[g][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = begin + it * BK;
    if (it + 1 < n_tiles) {  // tile it + 1 loads while tile it computes
      stage((it + 1) & 1, k0 + BK);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + (it & 1) * BK * ldk;
    const T* Vt = Vs + (it & 1) * BK * ldv;

    {  // the G queries reuse each K chunk from registers
      float part[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) part[g] = 0.f;
      const T* krow = Kt + key * ldk;
      if constexpr (VEC) {
#pragma unroll 4
        for (int i = sub; i < Dk / VW; i += TPK) {
          float kv[VW];
          repro::load_vec<T, VW>(kv, krow + i * VW);
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            if (GC == 0 && g >= G) break;
            const float4* qp = reinterpret_cast<const float4*>(Qs + g * Dk + i * VW);
#pragma unroll
            for (int e = 0; e < VW / 4; ++e) {
              const float4 qq = qp[e];
              part[g] += qq.x * kv[4 * e] + qq.y * kv[4 * e + 1] +
                         qq.z * kv[4 * e + 2] + qq.w * kv[4 * e + 3];
            }
          }
        }
      } else {
        for (int d = sub; d < Dk; d += TPK) {
          const float kd = repro::to_f(krow[d]);
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            if (GC == 0 && g >= G) break;
            part[g] += Qs[g * Dk + d] * kd;
          }
        }
      }
      const bool valid = k0 + key < end;
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (GC == 0 && g >= G) break;
        float sc = part[g];
#pragma unroll
        for (int o = 1; o < TPK; o <<= 1) sc += __shfl_xor_sync(0xffffffffu, sc, o);
        if (sub == 0)
          Ss[g * BK + key] = valid ? repro::softcap<CAP>(sc * scale, cap) : repro::kNegInf;
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      // lane holds scores lane, lane + 32, ...; a lane past a 16-key tile
      // holds none (NEG_INF and 0, which move neither max nor sum)
      float sv[NPL];
#pragma unroll
      for (int j = 0; j < NPL; ++j)
        sv[j] = lane + 32 * j < BK ? Ss[g * BK + lane + 32 * j] : repro::kNegInf;
      float mx = sv[0];
#pragma unroll
      for (int j = 1; j < NPL; ++j) mx = fmaxf(mx, sv[j]);
      const float m_old = Ml[3 * g];
      const float m_new = fmaxf(m_old, repro::warp_max(mx));
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        if (lane + 32 * j >= BK) break;
        const float p = expf(sv[j] - m_new);
        Ss[g * BK + lane + 32 * j] = p;
        ps = j ? ps + p : p;
      }
      const float ls = repro::warp_sum(ps);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        Ml[3 * g] = m_new;
        Ml[3 * g + 1] = Ml[3 * g + 1] * corr + ls;
        Ml[3 * g + 2] = corr;
      }
    }
    __syncthreads();

    if (ph < nph) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (GC == 0 && g >= G) break;
        const float corr = Ml[3 * g + 2];
#pragma unroll
        for (int e = 0; e < PW; ++e) acc[g][e] *= corr;
      }
      const T* vcol = Vt + PW * col;
#pragma unroll 4
      for (int c = ph; c < BK; c += nph) {
        float vv[PW];
        repro::load_vec<T, PW>(vv, vcol + c * ldv);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (GC == 0 && g >= G) break;
          const float p = Ss[g * BK + c];
#pragma unroll
          for (int e = 0; e < PW; ++e) acc[g][e] += p * vv[e];
        }
      }
    }
    __syncthreads();  // the stage, Ss and corr are consumed
  }

  if (nph > 1) {  // add the key phases' parts
    if (ph > 0 && ph < nph)
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (GC == 0 && g >= G) break;
#pragma unroll
        for (int e = 0; e < PW; ++e)
          Red[((ph - 1) * G + g) * Dv + PW * col + e] = acc[g][e];
      }
    __syncthreads();
    if (ph == 0)
      for (int p = 1; p < nph; ++p)
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (GC == 0 && g >= G) break;
#pragma unroll
          for (int e = 0; e < PW; ++e)
            acc[g][e] += Red[((p - 1) * G + g) * Dv + PW * col + e];
        }
  }
  __syncthreads();  // Ml is initialised where no tile ran

  if (n_split == 1) {
    if (ph != 0) return;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (GC == 0 && g >= G) break;
      const bool seen = Ml[3 * g] > repro::kNegInf * 0.5f;
      const float l = fmaxf(Ml[3 * g + 1], 1e-30f);
#pragma unroll
      for (int e = 0; e < PW; ++e)
        o[obase + g * Dv + PW * col + e] =
            repro::from_f<T>(seen ? acc[g][e] / l : 0.f);
    }
    return;
  }
  const int GD = G * Dv;
  float* pa = part_acc + static_cast<int64_t>(bh) * n_split * GD;
  float* pm = part_ml + static_cast<int64_t>(bh) * n_split * 2 * G;
  if (ph == 0)
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (GC == 0 && g >= G) break;
#pragma unroll
      for (int e = 0; e < PW; ++e)
        pa[split * GD + g * Dv + PW * col + e] = acc[g][e];
    }
  for (int g = tid; g < G; g += kThreads) {
    pm[split * 2 * G + 2 * g] = Ml[3 * g];
    pm[split * 2 * G + 2 * g + 1] = Ml[3 * g + 1];
  }

  // The merge: the last of the n_seen splits that saw a key to finish,
  // as the per-(b, kv-head) counter `sem` says, merges their partials and
  // sets the counter back to 0 for the next launch
  __shared__ int last;
  __threadfence();  // this split's partials are visible before it counts
  __syncthreads();
  const int n_seen = (len + chunk - 1) / chunk;
  if (tid == 0) last = atomicAdd(sem + bh, 1) == n_seen - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int oi = tid; oi < GD; oi += kThreads) {
    const int g = oi / Dv;
    float m = repro::kNegInf;
    for (int s = 0; s < n_seen; ++s) m = fmaxf(m, __ldcg(pm + s * 2 * G + 2 * g));
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_seen; ++s) {
      const float w = expf(__ldcg(pm + s * 2 * G + 2 * g) - m);
      l += w * __ldcg(pm + s * 2 * G + 2 * g + 1);
      a += w * __ldcg(pa + s * GD + oi);
    }
    o[obase + oi] = repro::from_f<T>(a / fmaxf(l, 1e-30f));
  }
  if (tid == 0) sem[bh] = 0;
}

// ---------------------------------------------------------------------------
// the bf16 wide body: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

// three stages of K and V tiles (bf16, rows padded), then the partial
// scores of the Dk parts (f32)
template <int DK, int DV, int BK>
constexpr size_t mma_smem_bytes() {
  constexpr int ksplit = kMmaWarps / (BK / 8);
  return sizeof(__nv_bfloat16) * kMmaStages * BK *
             static_cast<size_t>(DK + kMmaPad + DV + kMmaPad) +
         sizeof(float) * ksplit * kMmaM * (BK + kMmaSPad);
}

// ROWS rows of COLS bf16 (row stride `stride`) into shared memory at pitch
// `ld`; rows past `valid` are zero. `vec`: 16-byte cp.async copies,
// completed by the caller's cp_async_wait; otherwise element by element,
// complete on return
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_rows_bf16(__nv_bfloat16* dst, int ld,
                                                const __nv_bfloat16* src,
                                                int64_t stride, int valid,
                                                bool vec) {
  if (vec) {
    constexpr int CPR = COLS / 8, N = ROWS * CPR;
#pragma unroll
    for (int it = 0; it < (N + kMmaThreads - 1) / kMmaThreads; ++it) {
      const int i = threadIdx.x + it * kMmaThreads;
      if (N % kMmaThreads != 0 && i >= N) break;
      const int r = i / CPR, c = (i - r * CPR) * 8;
      const bool ok = r < valid;
      repro::cp_async16(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += kMmaThreads) {
      const int r = i / COLS, c = i - r * COLS;
      dst[r * ld + c] = r < valid ? src[r * stride + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// q[row, d] and q[row, d + 1] packed (d in the low half), zero past G: an
// A-fragment register. Two 16-bit loads, so q needs no 4-byte alignment
template <int DK, int G>
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* qb, int row, int d) {
  if (row >= G) return 0u;
  const unsigned short* p = reinterpret_cast<const unsigned short*>(qb + row * DK + d);
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 16);
}

// DK, DV: the head dims; G: the heads sharing a KV head (<= 16, the rows
// of mma's M); BK: keys a tile. scale_log2 = scale * log2(e)
template <int DK, int DV, int G, int BK>
__global__ void __launch_bounds__(kMmaThreads, 1)
    decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int* __restrict__ lengths,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ part_acc,
                      float* __restrict__ part_ml, int* __restrict__ sem,
                      int Tlen, int Hq, int Hkv, float scale_log2, int chunk,
                      bool vec) {
  constexpr int NTILE = BK / 8;                // n8 key slices of a tile
  constexpr int KSPLIT = kMmaWarps / NTILE;    // parts of Dk, a warp each
  constexpr int KSTEPS = DK / 16 / KSPLIT;     // k16 steps of a part
  constexpr int CW = DV / kMmaWarps;           // output columns of a warp
  constexpr int OT = CW / 8;                   // their n8 tiles
  constexpr int LDK = DK + kMmaPad, LDV = DV + kMmaPad, LDS = BK + kMmaSPad;
  static_assert(G <= kMmaM && BK % 16 == 0 && kMmaWarps % NTILE == 0, "tile");
  static_assert(DK % (32 * KSPLIT) == 0 && CW % 16 == 0, "head dims");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // stages x BK x LDK
  __nv_bfloat16* Vs = Ks + kMmaStages * BK * LDK;                   // stages x BK x LDV
  float* Ss = reinterpret_cast<float*>(Vs + kMmaStages * BK * LDV);  // KSPLIT x 16 x LDS

  const int bh = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int b = bh / Hkv, hk = bh % Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int len = min(max(lengths[b], 0), Tlen);
  const int begin = split * chunk;
  const int end = min(len, begin + chunk);
  const int64_t obase = (static_cast<int64_t>(b) * Hq + static_cast<int64_t>(hk) * G) * DV;
  if (n_split > 1 && begin >= len) {  // no key here; the merge reads nothing
    if (len == 0 && split == 0)       // of it. No split sees a key: zeros
      for (int i = threadIdx.x; i < G * DV; i += kMmaThreads)
        o[obase + i] = __float2bfloat16_rn(0.f);
    return;
  }
  const int n_tiles = end > begin ? (end - begin + BK - 1) / BK : 0;

  const int64_t sk = static_cast<int64_t>(Hkv) * DK;
  const int64_t sv = static_cast<int64_t>(Hkv) * DV;
  const __nv_bfloat16* kb = k + (static_cast<int64_t>(b) * Tlen * Hkv + hk) * DK;
  const __nv_bfloat16* vb = v + (static_cast<int64_t>(b) * Tlen * Hkv + hk) * DV;
  auto stage = [&](int st, int k0) {
    const int valid = min(BK, end - k0);  // zeros past the split's keys
    stage_rows_bf16<BK, DK>(Ks + st * BK * LDK, LDK, kb + k0 * sk, sk, valid, vec);
    stage_rows_bf16<BK, DV>(Vs + st * BK * LDV, LDV, vb + k0 * sv, sv, valid, vec);
  };
  // two tiles in flight before the first computes; a group per tile, empty
  // past the split, so that wait<1> always means "this tile has landed"
  if (n_tiles > 0) stage(0, begin);
  repro::cp_async_commit();
  if (n_tiles > 1) stage(1, begin + BK);
  repro::cp_async_commit();

  // this warp's key slice of a tile and part of Dk; a lane's fragment row
  // r (and r + 8) and column pair c2
  const int nt = warp % NTILE, kh = warp / NTILE;
  const int r = lane >> 2, c2 = (lane & 3) * 2;
  // the A fragments of q over the part: loaded once, held over the tiles
  uint32_t qf[KSTEPS][4];
  {
    const __nv_bfloat16* qb =
        q + (static_cast<int64_t>(b) * Hq + static_cast<int64_t>(hk) * G) * DK;
#pragma unroll
    for (int i = 0; i < KSTEPS; ++i) {
      const int d = (kh * KSTEPS + i) * 16 + c2;
      qf[i][0] = q_pair<DK, G>(qb, r, d);
      qf[i][1] = q_pair<DK, G>(qb, r + 8, d);
      qf[i][2] = q_pair<DK, G>(qb, r, d + 8);
      qf[i][3] = q_pair<DK, G>(qb, r + 8, d + 8);
    }
  }
  float acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_r[2] = {repro::kNegInf, repro::kNegInf};  // rows r and r + 8, log2 units
  float l_r[2] = {0.f, 0.f};                        // this lane's part

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = begin + it * BK;
    repro::cp_async_wait<1>();  // tile it has landed (this thread's copies)
    __syncthreads();            // everyone's; and tile it - 1 is consumed
    if (it + 2 < n_tiles) stage((it + 2) % kMmaStages, k0 + 2 * BK);
    repro::cp_async_commit();
    const __nv_bfloat16* Kt = Ks + (it % kMmaStages) * BK * LDK;
    const __nv_bfloat16* Vt = Vs + (it % kMmaStages) * BK * LDV;

    {  // S = q K^T over this warp's keys and part of Dk: one ldmatrix.x4
       // gives two k steps' B fragments, each feeding its own accumulator
      float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* kp =
          Kt + (nt * 8 + (lane & 7)) * LDK + kh * KSTEPS * 16 + (lane >> 3) * 8;
#pragma unroll
      for (int i = 0; i < KSTEPS; i += 2) {
        uint32_t kf[4];
        ldsm_x4(kf, kp + i * 16);
        mma_bf16(s0, qf[i], kf[0], kf[1]);
        mma_bf16(s1, qf[i + 1], kf[2], kf[3]);
      }
      float* sp = Ss + (kh * kMmaM + r) * LDS + nt * 8 + c2;
      *reinterpret_cast<float2*>(sp) = make_float2(s0[0] + s1[0], s0[1] + s1[1]);
      *reinterpret_cast<float2*>(sp + 8 * LDS) =
          make_float2(s0[2] + s1[2], s0[3] + s1[3]);
    }
    __syncthreads();

    // the online softmax, every warp over the whole tile: x[h][j][e] is
    // row r + 8h at key 16j + 8(e / 2) + c2 + e % 2, the A fragment order
    float x[2][BK / 16][4];
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = repro::kNegInf;
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int key = 16 * j + 8 * (e >> 1) + c2;
          float2 sc = make_float2(0.f, 0.f);
#pragma unroll
          for (int p = 0; p < KSPLIT; ++p) {
            const float2 part = *reinterpret_cast<const float2*>(
                Ss + (p * kMmaM + r + 8 * h) * LDS + key);
            sc.x += part.x;
            sc.y += part.y;
          }
          // keys at or past the split's end: NEG_INF (their rows are zero)
          x[h][j][e] = k0 + key < end ? sc.x * scale_log2 : repro::kNegInf;
          x[h][j][e + 1] = k0 + key + 1 < end ? sc.y * scale_log2 : repro::kNegInf;
          mx = fmaxf(mx, fmaxf(x[h][j][e], x[h][j][e + 1]));
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[h], mx);
      corr[h] = fast_exp2(m_r[h] - m_new);
      m_r[h] = m_new;
      l_r[h] *= corr[h];
    }
    // P as two bf16 terms, the A fragments of P.V
    uint32_t ph[BK / 16][4], pr[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
#pragma unroll
      for (int f = 0; f < 4; ++f) {  // a0: row r, a1: r + 8, a2 / a3: keys + 8
        const int h = f & 1, e = (f >> 1) * 2;
        split_pack(fast_exp2(x[h][j][e] - m_r[h]), fast_exp2(x[h][j][e + 1] - m_r[h]),
                   ph[j][f], pr[j][f], l_r[h]);
      }
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
    // P.V over this warp's columns: the head term into every output
    // accumulator, then the remainder
    const __nv_bfloat16* vp = Vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDV +
                              warp * CW + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t vf[OT / 2][4];
#pragma unroll
      for (int dp = 0; dp < OT / 2; ++dp) ldsm_x4_t(vf[dp], vp + kk * 16 * LDV + dp * 16);
#pragma unroll
      for (int dp = 0; dp < OT / 2; ++dp) {
        mma_bf16(acc[2 * dp], ph[kk], vf[dp][0], vf[dp][1]);
        mma_bf16(acc[2 * dp + 1], ph[kk], vf[dp][2], vf[dp][3]);
      }
#pragma unroll
      for (int dp = 0; dp < OT / 2; ++dp) {
        mma_bf16(acc[2 * dp], pr[kk], vf[dp][0], vf[dp][1]);
        mma_bf16(acc[2 * dp + 1], pr[kk], vf[dp][2], vf[dp][3]);
      }
    }
  }
  repro::cp_async_wait<0>();  // the empty groups past the split

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
  }
  const int col0 = warp * CW + c2;
  if (n_split == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      if (row >= G) continue;
      // a row that never saw a key keeps m at NEG_INF: zeros, not mean(v)
      const bool seen = m_r[h] > repro::kNegInf * 0.5f;
      const float inv = seen ? 1.f / fmaxf(l_r[h], 1e-30f) : 0.f;
#pragma unroll
      for (int j = 0; j < OT; ++j)
        *reinterpret_cast<__nv_bfloat162*>(o + obase + row * DV + col0 + j * 8) =
            __floats2bfloat162_rn(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
    }
    return;
  }
  constexpr int GD = G * DV;
  float* pa = part_acc + static_cast<int64_t>(bh) * n_split * GD;
  float* pm = part_ml + static_cast<int64_t>(bh) * n_split * 2 * G;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    if (row >= G) continue;
#pragma unroll
    for (int j = 0; j < OT; ++j)
      *reinterpret_cast<float2*>(pa + split * GD + row * DV + col0 + j * 8) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    if (warp == 0 && c2 == 0) {  // m in natural units, as the FMA bodies'
      pm[split * 2 * G + 2 * row] = m_r[h] * kLn2;
      pm[split * 2 * G + 2 * row + 1] = l_r[h];
    }
  }

  // The merge: the last of the n_seen splits that saw a key to finish, as
  // the per-(b, kv-head) counter `sem` says, merges their partials and
  // sets the counter back to 0 for the next launch
  __shared__ int last;
  __shared__ float m_g[G], inv_l[G];
  __threadfence();  // this split's partials are visible before it counts
  __syncthreads();
  const int n_seen = (len + chunk - 1) / chunk;
  if (threadIdx.x == 0) last = atomicAdd(sem + bh, 1) == n_seen - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float m = repro::kNegInf, l = 0.f;
    for (int s = 0; s < n_seen; ++s) m = fmaxf(m, __ldcg(pm + s * 2 * G + 2 * g));
    for (int s = 0; s < n_seen; ++s)
      l += expf(__ldcg(pm + s * 2 * G + 2 * g) - m) * __ldcg(pm + s * 2 * G + 2 * g + 1);
    m_g[g] = m;
    inv_l[g] = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  // w[s][g] = e^(m_s - m) / l over the K stages, consumed
  float* w = reinterpret_cast<float*>(smem_raw);
  for (int i = threadIdx.x; i < n_seen * G; i += kMmaThreads) {
    const int s = i / G, g = i - s * G;
    w[i] = expf(__ldcg(pm + s * 2 * G + 2 * g) - m_g[g]) * inv_l[g];
  }
  __syncthreads();
  constexpr int NV = (GD / 4 + kMmaThreads - 1) / kMmaThreads;  // float4 a thread
  float4 a[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) a[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = 0; s < n_seen; ++s) {  // four splits' loads in flight
    const float4* ps = reinterpret_cast<const float4*>(pa + s * GD);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int i4 = threadIdx.x + i * kMmaThreads;
      if (GD % (4 * kMmaThreads) != 0 && i4 >= GD / 4) break;
      const float ws = w[s * G + i4 * 4 / DV];
      const float4 x4 = __ldcg(ps + i4);
      a[i].x += ws * x4.x;
      a[i].y += ws * x4.y;
      a[i].z += ws * x4.z;
      a[i].w += ws * x4.w;
    }
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int i4 = threadIdx.x + i * kMmaThreads;
    if (GD % (4 * kMmaThreads) != 0 && i4 >= GD / 4) break;
    __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(o + obase + i4 * 4);
    op[0] = __floats2bfloat162_rn(a[i].x, a[i].y);
    op[1] = __floats2bfloat162_rn(a[i].z, a[i].w);
  }
  if (threadIdx.x == 0) sem[bh] = 0;
}

template <int DK, int DV, int G, int BK>
int launch_mma(const void* q, const void* k, const void* v, const void* lengths,
               void* o, void* part_acc, void* part_ml, void* sem, int B,
               int Tlen, int Hq, int Hkv, float scale, int chunk, int n_split,
               bool vec, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<DK, DV, BK>();
  static_assert(smem <= 232448, "a block's shared memory");
  static_assert(sizeof(float) * kMmaMaxSplits * G <=
                    sizeof(__nv_bfloat16) * kMmaStages * BK * (DK + kMmaPad),
                "the merge's weights fit the K stages");
  auto kernel = decode_mma_kernel<DK, DV, G, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B) * Hkv, n_split);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), static_cast<int*>(sem), Tlen, Hq, Hkv,
      scale * kLog2e, chunk, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC, int GC, int BK, int PW, bool CAP>
int launch_impl(const void* q, const void* k, const void* v,
                const void* lengths, void* o, void* part_acc, void* part_ml,
                void* sem, int B, int Tlen, int Hq, int Hkv, int Dk, int Dv,
                float scale, float cap, int chunk, int n_split,
                cudaStream_t stream) {
  const size_t smem = smem_bytes(Hq / Hkv, Dk, Dv, sizeof(T), VEC);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, VEC, GC, BK, PW, CAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B) * Hkv, n_split);
  decode_kernel<T, VEC, GC, BK, PW, CAP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(o), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), static_cast<int*>(sem), Tlen, Hq, Hkv, Dk,
      Dv, scale, cap, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC, bool CAP>
int launch_vec(const void* q, const void* k, const void* v,
               const void* lengths, void* o, void* part_acc, void* part_ml,
               void* sem, int B, int Tlen, int Hq, int Hkv, int Dk, int Dv,
               float scale, float cap, int chunk, int n_split,
               cudaStream_t stream) {
#define REPRO_DECODE_AT(GC, BK, PW)                                        \
  launch_impl<T, VEC, GC, BK, PW, CAP>(q, k, v, lengths, o, part_acc,      \
                                       part_ml, sem, B, Tlen, Hq, Hkv, Dk, \
                                       Dv, scale, cap, chunk, n_split,     \
                                       stream)
#define REPRO_DECODE(GC) REPRO_DECODE_AT(GC, kBK, VEC ? 2 : 1)
  if (wide_dims(Dk, Dv)) {  // f32: bf16's wide body is decode_mma_kernel;
    if constexpr (sizeof(T) == 4 && !CAP) {  // capped, none (entry refuses)
      if (Dk == kD256) return REPRO_DECODE_AT(kG256, kBKWideF32, kPwWide);
      return REPRO_DECODE_AT(kGWide, kBKWideF32, kPwWide);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (Hq / Hkv) {
    case 1: return REPRO_DECODE(1);
    case 2: return REPRO_DECODE(2);
    case 4: return REPRO_DECODE(4);
    case 8: return REPRO_DECODE(8);
    default: return REPRO_DECODE(0);
  }
#undef REPRO_DECODE
#undef REPRO_DECODE_AT
}

template <typename T, bool CAP>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* o, void* part_acc, void* part_ml, void* sem, int B, int Tlen,
           int Hq, int Hkv, int Dk, int Dv, float scale, float cap, int chunk,
           int n_split, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = Dk % V == 0 && Dv % V == 0 && repro::aligned16(k) &&
                   repro::aligned16(v);
  if constexpr (sizeof(T) == 2 && !CAP)
    if (wide_dims(Dk, Dv)) {  // dims_taken: (576, 512) at 16, (256, 256) at 10
      if (Dk == kD256)
        return launch_mma<kD256, kD256, kG256, kMmaBK>(
            q, k, v, lengths, o, part_acc, part_ml, sem, B, Tlen, Hq, Hkv,
            scale, chunk, n_split, vec, stream);
      return launch_mma<kDkWide, kDvWide, kGWide, kMmaBK>(
          q, k, v, lengths, o, part_acc, part_ml, sem, B, Tlen, Hq, Hkv, scale,
          chunk, n_split, vec, stream);
    }
  return vec ? launch_vec<T, true, CAP>(q, k, v, lengths, o, part_acc,
                                        part_ml, sem, B, Tlen, Hq, Hkv, Dk,
                                        Dv, scale, cap, chunk, n_split, stream)
             : launch_vec<T, false, CAP>(q, k, v, lengths, o, part_acc,
                                         part_ml, sem, B, Tlen, Hq, Hkv, Dk,
                                         Dv, scale, cap, chunk, n_split,
                                         stream);
}

// CAP: the capped instantiations, of the common body alone (both head dims
// up to 128: no model caps MLA's absorbed decode or recurrentgemma's 256),
// cap > 0
template <bool CAP>
int entry(const void* q, const void* k, const void* v, const void* lengths,
          void* o, void* part_acc, void* part_ml, void* sem, int B, int Tlen,
          int Hq, int Hkv, int Dk, int Dv, float scale, float cap, int chunk,
          int n_split, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype != repro::kF32 && dtype != repro::kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = body_tile(Dk, Dv, dtype == repro::kBF16 ? 2 : 4);
  const int max_split = dtype == repro::kBF16 && wide_dims(Dk, Dv) ? kMmaMaxSplits : 65535;
  if (B <= 0 || Tlen < 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv ||
      !dims_taken(Dk, Dv, Hq / Hkv) ||
      n_split < 1 || n_split > max_split || chunk < tile || chunk % tile ||
      static_cast<int64_t>(chunk) * n_split < Tlen ||
      (n_split > 1 && (part_acc == nullptr || part_ml == nullptr || sem == nullptr)) ||
      (CAP && (wide_dims(Dk, Dv) || !(cap > 0.f))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch<float, CAP>(q, k, v, lengths, o, part_acc, part_ml, sem, B,
                              Tlen, Hq, Hkv, Dk, Dv, scale, cap, chunk,
                              n_split, s);
  return launch<__nv_bfloat16, CAP>(q, k, v, lengths, o, part_acc, part_ml,
                                    sem, B, Tlen, Hq, Hkv, Dk, Dv, scale, cap,
                                    chunk, n_split, s);
}

}  // namespace

// decode_softcap.cu builds this source again with REPRO_DECODE_SOFTCAP
// defined: the capped entry (repro_decode_softcap, with a `cap` argument),
// in a library of its own, so that nvcc compiles it in parallel
#ifndef REPRO_DECODE_SOFTCAP

// n_split splits of `chunk` keys each (a whole number of the tiles of the
// body that runs: 64 keys, 32 for bf16's wide body, 16 for f32's; n_split
// * chunk >= Tlen; bf16's wide body merges at most kMmaMaxSplits). With
// n_split > 1, part_acc holds B*Hkv*n_split*G*Dv floats, part_ml
// B*Hkv*n_split*G*2, and sem B*Hkv ints that are 0 on entry and are left
// 0: launches that share `sem` run one after another (one stream)
extern "C" int repro_decode(const void* q, const void* k, const void* v,
                            const void* lengths, void* o, void* part_acc,
                            void* part_ml, void* sem, int B, int Tlen, int Hq,
                            int Hkv, int Dk, int Dv, float scale, int chunk,
                            int n_split, int dtype, int device, void* stream) {
  return entry<false>(q, k, v, lengths, o, part_acc, part_ml, sem, B, Tlen,
                      Hq, Hkv, Dk, Dv, scale, 0.f, chunk, n_split, dtype,
                      device, stream);
}

#else

// as repro_decode, the scores capped at `cap` (> 0) before the mask; the
// common body alone (head dims up to 128)
extern "C" int repro_decode_softcap(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* o, void* part_acc, void* part_ml,
                                    void* sem, int B, int Tlen, int Hq,
                                    int Hkv, int Dk, int Dv, float scale,
                                    float cap, int chunk, int n_split,
                                    int dtype, int device, void* stream) {
  return entry<true>(q, k, v, lengths, o, part_acc, part_ml, sem, B, Tlen, Hq,
                     Hkv, Dk, Dv, scale, cap, chunk, n_split, dtype, device,
                     stream);
}

#endif
