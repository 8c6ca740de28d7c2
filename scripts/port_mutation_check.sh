#!/bin/bash
# What chip_smoke.py's checks see of a kernel broken on purpose.
#
# Each mutation copies chip_smoke.py and src/ into build/mutants/<name>/,
# changes one kernel source there with sed, and runs the copy's
# chip_smoke.py on the card (phase 2 stops at the first kernel that
# disagrees with its plain version). The checkout is never modified.
#
#   bash scripts/port_mutation_check.sh             # every mutation
#   bash scripts/port_mutation_check.sh nms_ge ...  # the named ones
#
# from the repo root, on a GPU machine.
#
# Writes each run's output to build/mutants/<name>.txt and prints, per
# mutation, the exit code and the failing check.
set -u
ONLY="$*"
R=$(pwd)
OUT=$R/build/mutants
mkdir -p "$OUT"
mut() {  # name, source file under csrc/, sed script
  if [ -n "$ONLY" ] && ! [[ " $ONLY " == *" $1 "* ]]; then
    return
  fi
  local d=$OUT/$1 src=src/repro_torch/kernels/csrc/$2
  rm -rf "$d"; mkdir -p "$d"; cp -r "$R/chip_smoke.py" "$R/src" "$R/scripts" "$d/"
  sed -i "$3" "$d/$src"
  if cmp -s "$R/$src" "$d/$src"; then echo "mutation $1 NOT APPLIED"; return; fi
  diff "$R/$src" "$d/$src"
  (cd "$d" && timeout 400 python3 chip_smoke.py) > "$OUT/$1.txt" 2>&1
  echo "mutation $1: rc=$?"
  grep -E '"ok": false|RuntimeError' "$OUT/$1.txt" | head -3 | cut -c 1-400
}
# LayerNorm with the one-pass variance E[v^2] - E[v]^2 (bodies A and B)
mut ln_one_pass norms.cu \
  's/const float c = v\[k\]\[j\] - m1;/const float c = v[k][j];/; s/return make_float2(m1, rsqrtf(sum(acc2, 1) \/ static_cast<float>(d) + eps));/return make_float2(m1, rsqrtf(sum(acc2, 1) \/ static_cast<float>(d) - m1 * m1 + eps));/'
# body A summing over the whole warp where a row's group is G < 32 lanes
mut group_reduce_whole_warp norms.cu \
  's/for (int o = G \/ 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o, G);/for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o, 32);/'
# the lanes' last vectors read past the row (the K tail unpredicated)
mut group_tail_unmasked norms.cu \
  's/const bool in_row = c < n;  \/\/ the K tail/const bool in_row = true;  \/\/ the K tail/'
# rope with the fast sin / cos intrinsics
mut rope_fast_sincos rope.cu 's/= cosf(theta);/= __cosf(theta);/g; s/= sinf(theta);/= __sinf(theta);/g'
# rope rotating a walked row with the previous row's angles (the next
# step's position never loaded)
mut rope_next_row_stale rope.cu 's/pv = pos_at(nr0 + ar);/pv = pv;/'
# rope dividing by half instead of multiplying by its reciprocal
mut rope_true_division rope.cu \
  's/__fmul_rn(-static_cast<float>(\(a\?i\)), inv_half)/__fdiv_rn(-static_cast<float>(\1), static_cast<float>(half))/g'
# the bf16 body without the mask of the ragged last KV tile
mut full_no_tail_mask attention.cu \
  's/bool vis = kpos < Skv;  \/\/ the KV tail/bool vis = true;  \/\/ the KV tail/'
# NMS suppressing at an IoU equal to the threshold
mut nms_ge nms.cu 's/if (iou > thr) word |= 1ull << jj;/if (iou >= thr) word |= 1ull << jj;/'
# NMS resolving a block without its own earlier kept candidates (each
# block's kept set = valid and not removed by earlier blocks)
mut nms_reduce_unordered nms.cu 's/kept = cand \& ~warp_or(sup);/kept = cand;/'
# NMS computing the union with an FMA (the product iw * ih left unrounded
# in it). nvcc contracts nothing in the plain-operator form of these
# lines (its SASS has the same FFMA, FMUL and FADD), so the FMA is written out
mut nms_fma nms.cu \
  's/const float uni = rn_sub(rn_add(area\[jj\], ai), inter);/const float uni = __fmaf_rn(-iw, ih, rn_add(area[jj], ai));/'
# NMS fusing row i's area product into the area sum (area_j + w_i * h_i
# with w_i * h_i unrounded), the other FMA that FMA_PAIRS guard against
mut nms_area_fma nms.cu \
  's/const float uni = rn_sub(rn_add(area\[jj\], ai), inter);/const float uni = rn_sub(__fmaf_rn(fmaxf(rn_sub(bi.z, bi.x), 0.f), fmaxf(rn_sub(bi.w, bi.y), 0.f), area[jj]), inter);/'
# the bf16 body's window letting in the key exactly `window` positions back
mut window_le attention.cu \
  's/vis = vis \&\& qpos - kpos < window;/vis = vis \&\& qpos - kpos <= window;/'
# the bf16 body's window starting its KV loop one tile late
mut window_late_start attention.cu \
  's/const int lo = first_key - first_key % kTK;/const int lo = first_key - first_key % kTK + kTK;/'
# the bf16 body skipping the causal mask on the diagonal tile
mut attn_diag_unmasked attention.cu \
  's/const bool diag = MASK != kFull \&\& k0/const bool diag = false \&\& k0/'
# decode's merge adding the splits' accumulators without e^(m_s - m)
mut decode_combine_no_rescale decode.cu \
  's/a += w \* __ldcg(pa + s \* GD + oi);/a += __ldcg(pa + s * GD + oi);/'
# GeGLU without the cubic term of its tanh approximation
mut geglu_no_cubic swiglu.cu \
  's/ex2(kGeluArg \* (g + 0.044715f \* g \* g \* g))/ex2(kGeluArg * g)/'
# GeGLU through tanh.approx.f32 (error ~2^-11 near 0): must fail at f32
mut geglu_tanh_approx swiglu.cu \
  's/return __fdividef(g, 1.f + ex2(kGeluArg \* (g + 0.044715f \* g \* g \* g)));/float t; asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(0.7978845608028654f * (g + 0.044715f * g * g * g))); return 0.5f * g * (1.f + t);/'
# the last partial vector never written (its elements left as allocated)
mut glu_tail_skipped swiglu.cu 's/const int64_t t = nv \* W + i;/const int64_t t = n + i;/'
# the dequant epilogue normalising the unrounded sum instead of the rounded r
mut dequant_unrounded_r norms.cu \
  's/for (int j = 0; j < V; ++j) v\[k\]\[j\] = repro::to_f(repro::from_f<T>(v\[k\]\[j\]));/for (int j = 0; j < V; ++j) v[k][j] = kDequant ? v[k][j] : repro::to_f(repro::from_f<T>(v[k][j]));/'
# softmax_xent reducing the last tile of a span's aligned middle whole, past
# the bytes its bulk copy brought (stale or unset shared memory)
mut xent_no_tail_mask softmax_xent.cu \
  's/const int nvec = static_cast<int>(lmin(kTileBytes, nbytes - static_cast<int64_t>(t) \* kTileBytes) \/ 16);/const int nvec = kTileVec;/'
# softmax_xent's merge summing the spans' l without e^(m_s - M)
mut xent_merge_no_rescale softmax_xent.cu \
  's/sw\[tid\] = ls \* ex2((ms - mx) \* kLog2e);/sw[tid] = ls;/'
# the row's counter left at n_split after the merge (the next split launch
# on the stream merges early or never)
mut xent_counter_not_reset softmax_xent.cu 's/^    sem\[row_i\] = 0;$//'
# every span stopping one tile short of its end
mut xent_span_drops_last_tile softmax_xent.cu \
  's/const int64_t c1 = lmin(vocab, c0 + span);/const int64_t c1 = lmin(vocab, c0 + span - kTileBytes \/ static_cast<int64_t>(sizeof(T)));/'
# the label logit read as logits[i, label] without the bounds check
mut xent_label_unchecked softmax_xent.cu \
  's/if (tid == 0 \&\& lab >= 0 \&\& lab < vocab \&\& lab \/ span == split)/if (tid == 0 \&\& lab \/ span == split)/'
