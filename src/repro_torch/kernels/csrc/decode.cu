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
// 4*G*D flops (G = Hq/Hkv queries share it, G <= 32), far under the
// card's ~295 flop/byte balance, so nothing here needs the tensor cores:
// the design is about keeping every SM streaming. What it does:
//   * the grid is (B*Hkv, n_split): split s of row b takes the keys
//     [s*C, min((s+1)*C, lengths[b])), C a whole number of 64-key tiles.
//     The wrapper chooses n_split and C from the shapes and the SM count
//     alone (attn_template.decode_splits), never from lengths, which the
//     kernel reads on the card: a split past lengths[b] runs no tile and
//     exits. With n_split > 1 each split writes its partial (m, l, acc) in
//     f32 to scratch the wrapper allocates, and the last split of the row
//     and head to finish (a counter per (b, kv-head), which it sets back
//     to 0) merges them: m = max m_s, l = sum l_s e^(m_s - m),
//     o = sum acc_s e^(m_s - m) / l, reading the partials from L2; exact
//     zeros where no split saw a key (lengths[b] == 0). The merge is a
//     pass of the same launch: a second launch would cost about what the
//     splits do at the serve lengths. With n_split == 1 the kernel writes
//     o itself;
//   * a CTA holds the whole GQA group, so each K/V row is read from device
//     memory once for all G query heads (the TPU kernel padded each single
//     query row to an 8-row block per head);
//   * K and V stay in their storage type in shared memory (bf16 for the
//     serving path), brought in by 16-byte cp.async copies into two
//     stages, so tile j+1 loads while tile j computes; a head dim that
//     rules out 16-byte copies is staged element by element;
//   * a split is latency-bound, so every step keeps independent work in
//     flight: scores take two threads a key, each reading alternate
//     16-byte chunks of the row (rows padded so that a load phase hits
//     distinct banks) and holding the G partial dots in registers (groups
//     of 1, 2, 4 and 8 get bodies of their own, without branches in the
//     loops), closed by one shuffle;
//     P.V gives each thread two adjacent columns of every head and an
//     interleaved share of the tile's keys, the shares added at the end;
//   * the online (m, l) live in shared memory in f32; one warp runs a
//     head's softmax update of 64 scores with two shuffles.
//
// The wide body takes MLA's absorbed decode: Dk 576 (the 512-d latent and
// the 64-d rope key), Dv 512 (the latent), one KV head for a group of 16,
// and these dims and this group alone (dims_taken). Two stages of
// 64-key tiles would take ~279 KB of shared memory, past a block's 227 KB,
// and two P.V columns a thread would leave no thread a key phase at Dv
// 512. So its tiles hold 32 keys in bf16 (16 in f32), still two stages,
// four threads a key (eight in f32) with two shuffles closing each score;
// each thread owns four adjacent columns of every head in P.V; q, the
// scores and the (m, l) state stay in f32, 182 KB in all at bf16 and G 16
// (179 KB at f32). The G = 16 group has a body of its own. The split and
// its merge are unchanged; the f32 scratch grows with Dv.
#include "common.cuh"

namespace {

constexpr int kBK = 64;        // keys per staged tile: two threads a key
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kDMax = 128;     // largest Dk and Dv of the common body
constexpr int kDkWide = 576;   // Dk of the wide body (MLA: 512 + 64)
constexpr int kDvWide = 512;   // Dv of the wide body (MLA's latent)
constexpr int kGWide = 16;     // the wide body's group (MLA's 16 heads)
constexpr int kPwWide = 4;     // P.V columns a thread owns in the wide body
constexpr int kGMax = 32;      // largest GQA group taken

// The wide body: a head dim past 128 (MLA's absorbed decode, 576 / 512).
// Two stages of 64-key K and V tiles at those dims would take ~279 KB of
// shared memory, past the 227 KB a block may have: its tiles hold 32 keys
// (bf16) or 16 (f32), four or eight threads a key, and each thread owns
// four columns of every head in P.V (two, as the common body, would need
// 256 threads at Dv 512)
__host__ __device__ __forceinline__ bool wide_dims(int dk, int dv) {
  return dk > kDMax || dv > kDMax;
}

// the head dims and group taken: both dims up to 128 at any group up to
// kGMax, or the wide body's dims at its group
__host__ __device__ __forceinline__ bool dims_taken(int dk, int dv, int g) {
  if (dk <= 0 || dv <= 0) return false;
  if (!wide_dims(dk, dv)) return g <= kGMax;
  return dk == kDkWide && dv == kDvWide && g == kGWide;
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

// keys a staged tile holds and P.V columns a thread owns, per body
__host__ __device__ __forceinline__ int tile_keys(bool wide, int elem) {
  return wide ? (elem == 2 ? 32 : 16) : kBK;
}
__host__ __device__ __forceinline__ int pv_width(bool wide, bool vec) {
  return wide ? kPwWide : (vec ? 2 : 1);
}

// two stages of K and V in the storage type, then q, scores, (m, l, corr)
// and the P.V phases' parts in f32
size_t smem_bytes(int g, int dk, int dv, int elem, bool vec) {
  const bool wide = wide_dims(dk, dv);
  const size_t bk = tile_keys(wide, elem);
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

// GC: the group G = Hq / Hkv where it is 1, 2, 4 or 8 (16 in the wide
// body: MLA's), known at compile time, so that a thread's G partial dots
// and accumulators stay in registers and its loops carry no branch; 0: any
// G up to kGMax, guarded. BK: keys a tile; PW: P.V columns a thread owns
template <typename T, bool VEC, int GC, int BK, int PW>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ lengths,
                  T* __restrict__ o, float* __restrict__ part_acc,
                  float* __restrict__ part_ml, int* __restrict__ sem, int Tlen,
                  int Hq, int Hkv, int Dk, int Dv, float scale, int chunk) {
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
        if (sub == 0) Ss[g * BK + key] = valid ? sc * scale : repro::kNegInf;
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

template <typename T, bool VEC, int GC, int BK, int PW>
int launch_impl(const void* q, const void* k, const void* v,
                const void* lengths, void* o, void* part_acc, void* part_ml,
                void* sem, int B, int Tlen, int Hq, int Hkv, int Dk, int Dv,
                float scale, int chunk, int n_split, cudaStream_t stream) {
  const size_t smem = smem_bytes(Hq / Hkv, Dk, Dv, sizeof(T), VEC);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, VEC, GC, BK, PW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B) * Hkv, n_split);
  decode_kernel<T, VEC, GC, BK, PW><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(o), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), static_cast<int*>(sem), Tlen, Hq, Hkv, Dk,
      Dv, scale, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int launch_vec(const void* q, const void* k, const void* v,
               const void* lengths, void* o, void* part_acc, void* part_ml,
               void* sem, int B, int Tlen, int Hq, int Hkv, int Dk, int Dv,
               float scale, int chunk, int n_split, cudaStream_t stream) {
#define REPRO_DECODE_AT(GC, BK, PW)                                        \
  launch_impl<T, VEC, GC, BK, PW>(q, k, v, lengths, o, part_acc, part_ml,  \
                                  sem, B, Tlen, Hq, Hkv, Dk, Dv, scale,    \
                                  chunk, n_split, stream)
#define REPRO_DECODE(GC) REPRO_DECODE_AT(GC, kBK, VEC ? 2 : 1)
  if (wide_dims(Dk, Dv)) {
    constexpr int kWideBK = sizeof(T) == 2 ? 32 : 16;
    return REPRO_DECODE_AT(kGWide, kWideBK, kPwWide);
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

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* o, void* part_acc, void* part_ml, void* sem, int B, int Tlen,
           int Hq, int Hkv, int Dk, int Dv, float scale, int chunk,
           int n_split, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = Dk % V == 0 && Dv % V == 0 && repro::aligned16(k) &&
                   repro::aligned16(v);
  return vec ? launch_vec<T, true>(q, k, v, lengths, o, part_acc, part_ml, sem,
                                   B, Tlen, Hq, Hkv, Dk, Dv, scale, chunk,
                                   n_split, stream)
             : launch_vec<T, false>(q, k, v, lengths, o, part_acc, part_ml,
                                    sem, B, Tlen, Hq, Hkv, Dk, Dv, scale,
                                    chunk, n_split, stream);
}

}  // namespace

// n_split splits of `chunk` keys each (a multiple of 64, n_split * chunk
// >= Tlen). With n_split > 1, part_acc holds B*Hkv*n_split*G*Dv floats,
// part_ml B*Hkv*n_split*G*2, and sem B*Hkv ints that are 0 on entry and
// are left 0: launches that share `sem` run one after another (one stream)
extern "C" int repro_decode(const void* q, const void* k, const void* v,
                            const void* lengths, void* o, void* part_acc,
                            void* part_ml, void* sem, int B, int Tlen, int Hq,
                            int Hkv, int Dk, int Dv, float scale, int chunk,
                            int n_split, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || Tlen < 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv ||
      !dims_taken(Dk, Dv, Hq / Hkv) ||
      n_split < 1 || n_split > 65535 || chunk < kBK || chunk % kBK ||
      static_cast<int64_t>(chunk) * n_split < Tlen ||
      (n_split > 1 && (part_acc == nullptr || part_ml == nullptr || sem == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch<float>(q, k, v, lengths, o, part_acc, part_ml, sem, B, Tlen,
                         Hq, Hkv, Dk, Dv, scale, chunk, n_split, s);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(q, k, v, lengths, o, part_acc, part_ml, sem,
                                 B, Tlen, Hq, Hkv, Dk, Dv, scale, chunk,
                                 n_split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
