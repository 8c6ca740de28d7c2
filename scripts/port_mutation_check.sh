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
  rm -rf "$d"; mkdir -p "$d"; cp -r "$R/chip_smoke.py" "$R/src" "$d/"
  sed -i "$3" "$d/$src"
  if cmp -s "$R/$src" "$d/$src"; then echo "mutation $1 NOT APPLIED"; return; fi
  diff "$R/$src" "$d/$src"
  (cd "$d" && timeout 400 python3 chip_smoke.py) > "$OUT/$1.txt" 2>&1
  echo "mutation $1: rc=$?"
  grep -E '"ok": false|RuntimeError' "$OUT/$1.txt" | head -3 | cut -c 1-400
}
# LayerNorm with the one-pass variance E[v^2] - E[v]^2
mut ln_one_pass norms.cu \
  's/const float c = row\[i \* V + j\] - mean;/const float c = row[i * V + j];/; s/inv = rsqrtf(block_sum(acc2, red) \/ static_cast<float>(d) + eps);/inv = rsqrtf(block_sum(acc2, red) \/ static_cast<float>(d) - mean * mean + eps);/'
# rope with the fast sin / cos intrinsics
mut rope_fast_sincos rope.cu \
  's/cs\[i\] = cosf(theta);/cs[i] = __cosf(theta);/; s/cs\[half + i\] = sinf(theta);/cs[half + i] = __sinf(theta);/'
# rope dividing by half instead of multiplying by its reciprocal
mut rope_true_division rope.cu \
  's/__fmul_rn(-static_cast<float>(i), inv_half)/__fdiv_rn(-static_cast<float>(i), static_cast<float>(half))/'
# the bf16 body without the mask of the ragged last KV tile
mut full_no_tail_mask attention.cu \
  's/bool vis = kpos < Skv;  \/\/ the KV tail/bool vis = true;  \/\/ the KV tail/'
# NMS suppressing at an IoU equal to the threshold
mut nms_ge nms.cu 's/if (iou > thr) keep_s\[j\] = 0;/if (iou >= thr) keep_s[j] = 0;/'
# NMS with plain operators, which nvcc contracts into FMAs
mut nms_fma nms.cu \
  's/return __fmul_rn(a, b);/return a * b;/; s/return __fadd_rn(a, b);/return a + b;/; s/return __fsub_rn(a, b);/return a - b;/; s/return __fdiv_rn(a, b);/return a \/ b;/'
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
  's/tanhf(kSqrt2OverPi \* (g + 0.044715f \* g \* g \* g))/tanhf(kSqrt2OverPi * g)/'
# the dequant epilogue normalising the unrounded sum instead of the rounded r
mut dequant_unrounded_r norms.cu \
  's/for (int j = 0; j < V; ++j) v\[j\] = repro::to_f(repro::from_f<T>(v\[j\]));/for (int j = 0; j < V; ++j) v[j] = kDequant ? v[j] : repro::to_f(repro::from_f<T>(v[j]));/'
# softmax_xent without the mask of the last tile's columns past the vocabulary
mut xent_no_tail_mask softmax_xent.cu \
  's/const float xv = in_vocab ? repro::to_f(row\[c\]) : repro::kNegInf;/const float xv = repro::to_f(row[c]);/'
