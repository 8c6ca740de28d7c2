// Per-row softmax cross-entropy over a large vocabulary:
//   loss[i] = logsumexp(logits[i, :]) - logits[i, labels[i]]   (f32)
//
// Replaces the TPU kernel `_xent_kernel` (src/repro/kernels/softmax_xent.py
// :26), reached through `softmax_xent` (pallas_call at :69). As there, the
// row is read once with an online (m, l) logsumexp, and nothing of size V
// is written. The TPU's (rows, vocab-tiles) grid runs in order on one
// core; here the launch plan (kernels/softmax_xent.py `xent_plan`, from
// the shapes and the SM count alone) splits each row's vocabulary into
// `n_split` spans of whole tiles, one CTA a span, so that a few rows of
// gemma3's 262144 logits still give every SM work.
//
// Bound on the card: bytes. Each logit is read once; at (256, 32000) f32
// that is 32.8 MB, 9.8 us at 3.35 TB/s. The design:
//   * a span's bytes stream through a ring of kStages tiles of 8 KB in
//     shared memory, each filled by one 1-D bulk copy
//     (cp.async.bulk ... mbarrier::complete_tx::bytes) that one thread
//     issues; an mbarrier a stage says when its bytes have landed, and all
//     eight warps reduce a tile while the next three are in flight. 32 KB
//     a CTA leaves room for six CTAs an SM, so gemma3's loss chunk (512
//     rows of 262144 bf16) runs in one wave. (A ring of 16 KB stages ran
//     1.3 waves there and lost 10 %; a register double buffer, each
//     thread's next four vectors loaded before the current ones are
//     reduced, lost 1-5 % at three of the five shapes timed and won at
//     most 3 % at the other two: PERF.md, PR 20.) The bulk copy needs
//     16-byte-aligned addresses and sizes, so a span's unaligned head and
//     tail (a row start that is not 16-byte aligned, a vocabulary that is
//     not a multiple of the vector) take scalar loads, issued before the
//     first tile is waited for;
//   * base-2 exponentials: e^(x - m) = ex2(x log2e - m log2e), one FFMA and
//     one MUFU a logit; a thread rescales its l only when its running max
//     rises; ln 2 turns the base-2 log back once, at the end;
//   * the label logit is read once a row, by thread 0 of the span that
//     holds it, as logits[i, label] where 0 <= label < V: a label outside
//     [0, V) picks nothing and gives logsumexp, as the JAX kernel's compare
//     does (softmax_xent.py:39-43). int32 and int64 labels are read as they
//     are;
//   * with n_split > 1 each span writes its (m, l, pick) to f32 scratch and
//     counts itself on its row's counter, with one release / acquire
//     atomic and no full fence (two __threadfence() cost 0.5 us more at 8
//     rows of 262144: PERF.md, PR 20); the last span of a row to finish
//     merges the row's partials in split order, so that the loss does not
//     depend on which CTA finished last, writes it and sets the counter
//     back to 0 for the next launch on the stream (decode.cu's pattern).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileBytes = 8192;           // one stage of the ring
constexpr int kTileVec = kTileBytes / 16;  // 16-byte vectors a tile
constexpr int kStages = 4;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A thread's running max m and l = sum of e^(x - m), in base 2.
struct Online {
  float m = repro::kNegInf;
  float ml = repro::kNegInf * kLog2e;  // m log2e
  float l = 0.f;

  // fold in W values: l is rescaled only when the max rises
  template <int W>
  __device__ __forceinline__ void add(const float (&x)[W]) {
    float mx = x[0];
#pragma unroll
    for (int j = 1; j < W; ++j) mx = fmaxf(mx, x[j]);
    if (mx > m) {
      l *= ex2((m - mx) * kLog2e);
      m = mx;
      ml = mx * kLog2e;
    }
    float e[W];
#pragma unroll
    for (int j = 0; j < W; ++j) e[j] = ex2(fmaf(x[j], kLog2e, -ml));
#pragma unroll
    for (int w = 1; w < W; w *= 2)  // a pairwise sum: W / 2 chains, not W
#pragma unroll
      for (int j = 0; j + w < W; j += 2 * w) e[j] += e[j + w];
    l += e[0];
  }

  __device__ __forceinline__ void merge(float m2, float l2) {
    const float mx = fmaxf(m, m2);
    l = l * ex2((m - mx) * kLog2e) + l2 * ex2((m2 - mx) * kLog2e);
    m = mx;
  }
};

// fold in one 16-byte vector of 4 f32 or 8 bf16 logits, unpacked from
// the words (a bf16 is the high half of its f32), so that shared memory is
// read with one 16-byte load and not one load an element
template <typename T>
__device__ __forceinline__ void add_vec(Online& acc, const uint4 u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (sizeof(T) == 4) {
    float x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = __uint_as_float(w[j]);
    acc.add(x);
  } else {
    float x[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[2 * j] = __uint_as_float(w[j] << 16);
      x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
    acc.add(x);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "XENT_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra XENT_WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// atomically add 1 to *p at GPU scope, with release and acquire semantics;
// returns the old value
__device__ __forceinline__ int count_acq_rel(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

// one 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) into shared memory; `bar` completes when they have landed
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <typename T, typename L>
__global__ void __launch_bounds__(kThreads)
    xent_kernel(const T* __restrict__ logits, const L* __restrict__ labels,
                float* __restrict__ out, float* __restrict__ part,
                int* __restrict__ sem, int64_t vocab, int64_t span,
                int n_split) {
  extern __shared__ __align__(128) uint4 ring[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ float red_m[kThreads / 32], red_l[kThreads / 32];
  __shared__ int last;
  const int tid = threadIdx.x;
  const int64_t row_i = blockIdx.x / n_split;
  const int split = static_cast<int>(blockIdx.x - row_i * n_split);
  const T* row = logits + row_i * vocab;

  // the span [c0, c1); its 16-byte-aligned middle [a0, a1) streams, the
  // head [c0, a0) and tail [a1, c1) take scalar loads
  const int64_t c0 = split * span;
  const int64_t c1 = lmin(vocab, c0 + span);
  const int head = static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(row + c0) & 15)) & 15) / sizeof(T));
  const int tail =
      static_cast<int>((reinterpret_cast<uintptr_t>(row + c1) & 15) / sizeof(T));
  int64_t a0 = c0 + head, a1 = c1 - tail;
  if (a1 < a0) a0 = a1 = c1;  // the span lies inside one 16-byte block
  const int64_t nbytes = (a1 - a0) * static_cast<int64_t>(sizeof(T));
  const int ntiles = static_cast<int>((nbytes + kTileBytes - 1) / kTileBytes);
  const char* src = reinterpret_cast<const char*>(row + a0);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < min(kStages, ntiles); ++t)
      bulk_load(ring + t * kTileVec, src + static_cast<int64_t>(t) * kTileBytes,
                static_cast<uint32_t>(lmin(kTileBytes, nbytes - t * kTileBytes)),
                &full[t]);
  }

  // the label logit, read once a row by the span that holds it
  const int64_t lab = static_cast<int64_t>(labels[row_i]);
  float pick = 0.f;
  if (tid == 0 && lab >= 0 && lab < vocab && lab / span == split)
    pick = repro::to_f(row[lab]);

  Online acc;
  for (int64_t c = c0 + tid; c < a0; c += kThreads) {
    const float x[1] = {repro::to_f(row[c])};
    acc.add(x);
  }
  for (int64_t c = a1 + tid; c < c1; c += kThreads) {
    const float x[1] = {repro::to_f(row[c])};
    acc.add(x);
  }

  __syncthreads();  // the barriers are initialised
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % kStages;
    mbar_wait(&full[st], (t / kStages) & 1);
    const uint4* buf = ring + st * kTileVec;
    const int nvec = static_cast<int>(lmin(kTileBytes, nbytes - static_cast<int64_t>(t) * kTileBytes) / 16);
    if (nvec == kTileVec) {
#pragma unroll
      for (int k = 0; k < kTileVec / kThreads; ++k)
        add_vec<T>(acc, buf[tid + k * kThreads]);
    } else {  // the last tile of the span's aligned middle
      for (int i = tid; i < nvec; i += kThreads) add_vec<T>(acc, buf[i]);
    }
    __syncthreads();  // every warp is done with stage st
    if (tid == 0 && t + kStages < ntiles) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const int64_t off = static_cast<int64_t>(t + kStages) * kTileBytes;
      bulk_load(ring + st * kTileVec, src + off,
                static_cast<uint32_t>(lmin(kTileBytes, nbytes - off)), &full[st]);
    }
  }

  // the CTA's (m, l): a xor-shuffle tree in each warp, then the warps in
  // order
  const int lane = tid & 31, wid = tid >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, acc.m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, acc.l, o);
    acc.merge(m2, l2);
  }
  if (lane == 0) {
    red_m[wid] = acc.m;
    red_l[wid] = acc.l;
  }
  __syncthreads();
  if (tid == 0) {
    Online tot;
    for (int w = 0; w < kThreads / 32; ++w) tot.merge(red_m[w], red_l[w]);
    if (n_split == 1) {
      out[row_i] = tot.m + kLn2 * log2f(fmaxf(tot.l, 1e-30f)) - pick;
    } else {
      float* p = part + static_cast<int64_t>(blockIdx.x) * 3;
      p[0] = tot.m;
      p[1] = tot.l;
      p[2] = pick;
      // count this span with release (its partial is visible first) and
      // acquire (the last sees every span's) semantics, no full fence
      last = count_acq_rel(sem + row_i) == n_split - 1;
    }
  }
  if (n_split == 1) return;
  __syncthreads();
  if (!last) return;

  // the merge, by the row's last span to finish (ordered after its thread
  // 0's acquire by the barrier): thread s loads span s's partial from L2
  // and weighs its l by e^(m_s - M); thread 0 sums in split order
  const float* p = part + row_i * n_split * 3;
  float ms = repro::kNegInf, ls = 0.f, ps = 0.f;
  if (tid < n_split) {
    ms = __ldcg(p + 3 * tid);
    ls = __ldcg(p + 3 * tid + 1);
    ps = __ldcg(p + 3 * tid + 2);
  }
  const float wm = repro::warp_max(ms);
  if (lane == 0) red_m[wid] = wm;
  __syncthreads();
  float mx = red_m[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) mx = fmaxf(mx, red_m[w]);
  float* sw = reinterpret_cast<float*>(ring);  // the ring is free now
  float* sp = sw + kThreads;
  if (tid < n_split) {
    sw[tid] = ls * ex2((ms - mx) * kLog2e);
    sp[tid] = ps;
  }
  __syncthreads();
  if (tid == 0) {
    float l = 0.f, pk = 0.f;
    for (int s = 0; s < n_split; ++s) {
      l += sw[s];
      pk += sp[s];
    }
    out[row_i] = mx + kLn2 * log2f(fmaxf(l, 1e-30f)) - pk;
    sem[row_i] = 0;
  }
}

template <typename T, typename L>
int launch(const void* logits, const void* labels, void* out, void* part,
           void* sem, int64_t rows, int64_t vocab, int64_t span, int n_split,
           cudaStream_t stream) {
  const int smem = kStages * kTileBytes;  // the ring
  cudaError_t err = cudaFuncSetAttribute(
      xent_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  xent_kernel<T, L><<<static_cast<unsigned>(rows * n_split), kThreads, smem, stream>>>(
      static_cast<const T*>(logits), static_cast<const L*>(labels),
      static_cast<float*>(out), static_cast<float*>(part),
      static_cast<int*>(sem), vocab, span, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_labels(const void* logits, const void* labels, int label_bytes,
                  void* out, void* part, void* sem, int64_t rows, int64_t vocab,
                  int64_t span, int n_split, cudaStream_t s) {
  if (label_bytes == 4)
    return launch<T, int32_t>(logits, labels, out, part, sem, rows, vocab, span, n_split, s);
  if (label_bytes == 8)
    return launch<T, int64_t>(logits, labels, out, part, sem, rows, vocab, span, n_split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// out (rows,) f32 = per-row cross-entropy of logits (rows, vocab) of
// `dtype` against labels (rows,) of `label_bytes` (4: int32, 8: int64).
// Each row's vocabulary is cut into n_split spans of `span` columns, a
// multiple of the 16 KB tile, that cover it with none empty. With
// n_split > 1, part holds rows * n_split * 3 floats and sem `rows` ints
// that are 0 on entry and are left 0: launches that share `sem` run one
// after another (one stream).
extern "C" int repro_softmax_xent(const void* logits, const void* labels,
                                  int label_bytes, void* out, void* part,
                                  void* sem, int64_t rows, int64_t vocab,
                                  int64_t span, int n_split, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t esize = dtype == repro::kBF16 ? 2 : 4;
  if (rows <= 0 || vocab <= 0 || !logits || !labels || !out || n_split < 1 ||
      n_split > kThreads || rows * n_split > 0x7fffffff || span <= 0 ||
      span % (kTileBytes / esize) || span * n_split < vocab ||
      span * (n_split - 1) >= vocab ||
      (n_split > 1 && (!part || !sem)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch_labels<float>(logits, labels, label_bytes, out, part, sem,
                                rows, vocab, span, n_split, s);
  if (dtype == repro::kBF16)
    return launch_labels<__nv_bfloat16>(logits, labels, label_bytes, out, part,
                                        sem, rows, vocab, span, n_split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
