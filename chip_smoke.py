#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py               # from the repository root
    python3 chip_smoke.py --paths-only  # phase 1 and the path comparisons

Phases, each printing JSON lines:

1. device  - requires CUDA; prints the card's name and power limit (as
             ``nvidia-smi --query-gpu=name,power.limit`` gives them) and
             builds the hand-written kernels from ``src/repro_torch/kernels/csrc``;
2. kernels - holds each of the fourteen kernels against its plain PyTorch
             version on the card, in bf16 and f32, at the main paths' shapes
             (llama2-7b; stablelm-3b's LayerNorm at 2560, SwiGLU at 6912,
             rope on a quarter of 80 (half 10, scalar), attention at head
             dim 80 and at a 64-token chunk of a 512-deep cache;
             gpt2-xl's 25 heads of 64; gemma3-27b's 2048-token
             window prefill over 16 KV heads, its GeGLU rows and its
             qk-norm; the encoders' and the detector's full-mask attention;
             the detector's NMS; the Table-2 dequant row; the §4.5
             cross-entropy site and gemma3's 262144-token vocabulary, with
             few rows split over many CTAs) and
             odd ones (attention head dims 34, 48, 80, 96, Sq = 1, a causal
             q_offset with Sq < Skv, a chunk whose keys and values past it
             are NaN; decode over 4096 keys in 64 splits and
             lengths on and one past a split boundary; row norms at
             gemma3-27b's s2048 qk-norm and block norms, the Table-2
             Segformer rows, bert-base at b8 and a partial last row group,
             each naming the body of ``csrc/norms.cu`` it ran, every body
             reached; rope at gemma3-27b's prefill, rows walked by a grid
             stride with a ragged last step, a decode column near 4095,
             rows in chunks and half 6144, each naming its plan; swiglu
             and geglu at the decode steps, a prefill, tails, views 4 and 1
             elements into their storage and extremes of the gate, each
             naming its plan; NMS at the
             mask's word boundaries, 4663 and 8192 boxes, every third box
             invalid, IoU pairs at exactly 0.5 and one ulp above, pairs
             whose IoU an FMA would move across 0.5; softmax_xent on
             split plans with misaligned spans, int32 and int64 labels,
             labels in the first and last spans and outside [0, V), each
             naming its plan); NMS keep
             masks and the dequant kernel's ``r`` must be identical;
3. serve   - for each of llama2-7b, stablelm-3b, gpt2-xl and gemma3-27b at
             full width and depth in bf16 (random weights from a seeded
             generator on the card), the continuous-batching ``Engine``
             unfused and fused
             (``Engine(fused=True)``: ``nn.fuse()``) serves 6 requests of 16
             new tokens (gemma3-27b's prompts cross its 1024-token window in
             prefill and wrap its rings in decode); checks the outputs and
             that each path launched exactly its kernels, as many times as
             its forwards need; then holds the kernel path's prefill logits
             and one decode step's logits against the plain path's, and the
             fused path's against the unfused path's, and for llama2-7b and
             stablelm-3b a 300-token prompt's chunked prefill (``lm_prefill``
             of 128 tokens, then ``lm_extend`` chunks of 64 at their
             offsets) against its whole prefill and against the plain
             path's chunked prefill (``--paths-only`` runs only these
             comparisons, to read what they see of a kernel broken on
             purpose);
   paged   - llama2-7b and stablelm-3b through the ``PagedEngine``
             (``max_batch=4``, ``max_len=512``, 16-token blocks), unfused
             and fused: (a) cold, the serve phase's prompts, tokens
             identical to the ``Engine``'s from the same run; (b) chunks of
             64 and the prefix cache, four prompts sharing a 160-token
             prefix and two of 300-400 tokens: every request finished, a
             prefix-cache hit, the count of requests whose tokens equal the
             ``Engine``'s printed. Both: launches equal to what the cold
             prefills, extend chunks and decode steps need, every block
             back to the allocator or the prefix cache;
4. profile - a per-op measured profile of ``lm_forward`` (batch 1, seq 16)
             on the kernel path, unfused and fused, for the three models,
             and gemma3-27b at seq 2048, where its window bites, unfused
             and fused (its GeGLU kernel at the 2048 bucket): the measured
             GEMM / NonGEMM split;
   qdq     - for llama2-7b and gpt2-xl, the paper's §4.4 2x2 on one eager
             ``lm_forward`` (b1 s16, bf16): ``bf16`` / ``fused`` /
             ``int8-qdq`` / ``int8-qdq+fused`` (``nn.fake_quant("int8")``:
             both operands of every GEMM site round-trip through int8),
             each a measured split with its QDQ share; the QDQ kernel path
             against the QDQ plain path and QDQ fused against QDQ unfused,
             under the anchored logit rule;
   encode  - bert-base (b1 and b8, s128) and the vit-b16 embeddings stub
             (b1, s197) through ``lm_forward`` at full width and depth in
             bf16, unfused and fused: launches, the kernel path's logits
             against the plain path's and the fused path's against the
             unfused, and a measured profile of each (batch 1);
   vision  - vit-b16-cls (224 px) and detector-vit-s (256 px) through
             ``vision_forward``, same conditions: images/s at batch 1 and
             batch 8, the classifier's logits and the detector's backbone
             features and sorted top-K scores against the plain path, the
             NMS kernel against the plain NMS on the kernel path's own
             boxes, and a measured profile of each (batch 1) in which the
             detector must show RoI, Interpolation and Reduction time;
             then vit-b16-cls at b1 under ``int8-qdq``, unfused and fused
             (``conv2d``'s QDQ), checked and profiled the same way;
   micro   - the Table-2 NonGEMM micro-benchmark (``core/microbench``,
             f32): one line per operator, the fused dequant row through its
             kernel;
   kernel_sites - the §4.5 kernel-site table (``bench/sections``): per
             site the eager chain's bytes against the kernel's, and the
             kernel against its plain version (the cross-entropy site
             through softmax_xent);
5. timing  - kernel, plain version, one PyTorch library call computing the
             same function (where there is one) and the card's bound, at the
             main paths' shapes, gemma3-27b's global causal prefill and ring
             decode included; the attention rows name the body that ran
             (``mma bf16`` on the tensor cores, ``fma f32``); the row norms
             at their wider shapes and an empty kernel, the launch floor
             (``scripts/norm_timing.py``); rope at gemma3-27b's prefill q
             and k, NMS at the Table-2 row and at 8192 boxes
             (``scripts/rope_nms_timing.py``); swiglu and geglu at the
             decode steps and the served prefills beside ``torch.mul`` of
             the same operands (``scripts/glu_timing.py``); softmax_xent
             at gemma3-27b's vocabulary with 8 rows, its loss chunk and
             llama2-7b's 2048-token loss beside ``F.cross_entropy`` and
             ``torch.amax`` (``scripts/xent_timing.py``); rope at
             stablelm-3b's decode step (the scalar plan) and attention_core
             at the last 64-token chunk of a 512-deep cache beside SDPA with
             the causal-offset mask spelled out.

The line before the last is the per-kernel JSON record, the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before that line is printed.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

SEED = 0
ARCHS = ("llama2-7b", "stablelm-3b", "gpt2-xl", "gemma3-27b")
#: the served models' engine depth and prompt lengths (None: six seeded
#: lengths of 5-200 tokens). gemma3-27b's: two past its 1024-token window
#: (right-padded to the 2048 bucket, the rings fill from the true tail),
#: one of 1015 whose decode wraps its rings at 1024, one short;
#: compare_paths takes the first four
SERVE = {"llama2-7b": (512, None), "stablelm-3b": (512, None),
         "gpt2-xl": (512, None),
         "gemma3-27b": (2048, (1500, 1100, 1015, 37, 600, 250))}
#: the models phase ``paged`` serves through the PagedEngine (every layer
#: global: gemma3-27b's rings cannot page)
PAGED_ARCHS = ("llama2-7b", "stablelm-3b")
#: the paged engine's blocks and chunks; the chunked run's prompts: four
#: that share a 160-token prefix, each with its own 40-token suffix, and
#: two long ones (five to seven chunks), in the order (shared, long, long,
#: shared, shared, shared), so that the last two find the first one's
#: prefix cached
BLOCK_SIZE, CHUNK = 16, 64
SHARED_PREFIX, SUFFIX, LONG_PROMPTS = 160, 40, (300, 400)
#: compare_paths' chunked prefill: a prompt of EXTEND_PROMPT tokens as
#: lm_prefill of the first EXTEND_FIRST, then lm_extend in chunks of CHUNK
EXTEND_PROMPT, EXTEND_FIRST = 300, 128
#: (batch, seq) of the measured profiles of each served model
PROFILES = {"gemma3-27b": ((16, False), (16, True), (2048, False), (2048, True))}
NEW_TOKENS = 16
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,    # dense tensor-core rate
              "float32": 67e12}      # outside the tensor cores
# |kernel - plain| <= atol + rtol * |plain|: both compute in f32; bf16 output
# may round the other way by one ulp (2^-8 relative), f32 only differs in
# summation order and in the exp / rsqrt intrinsics. The window fragment's
# cases scale atol by the plain output's RMS (where below 1): a row over
# 1024 keys of randn q, k, v averages ~377 effective values, RMS ~0.05, so
# a flat 3e-2 could let through a key too many or too few; rtol still
# covers the ulp of each rounded output
TOL = {"bfloat16": (3e-2, 2 ** -7), "float32": (2e-5, 1e-5)}
# a LayerNorm row whose mean is 1e3 standard deviations from zero: either
# version's f32 mean carries ~2^-24 * 1e3 * log2(d) of summation-order
# error, which the normalized row shows unscaled (9.4e-5 read on an H100);
# a one-pass E[x^2] - E[x]^2 variance errs by ~0.1 there
LARGE_MEAN_TOL = {"bfloat16": TOL["bfloat16"], "float32": (1e-3, 1e-5)}
# logits, kernel path vs plain path (and fused vs unfused), all layers in
# bf16: each layer may round its outputs differently by an ulp and the
# differences compound, by how much depends on the model. The limit is
# anchored in what bf16 costs the model: the same plain path with f32
# activations (on the same bf16 weights) is computed too, and a pair may
# differ by at most F32_ANCHOR times the reference path's distance from it
# (the plain path, or the unfused kernel path for the fused comparison),
# LOGIT_ATOL at the least. On an H100 the sound paths of llama2-7b and
# gpt2-xl read at most 0.0625 and 0.0586, logits up to 4.2; for llama2-7b,
# decode_core dropping its newest key reads 0.25 on the decode step,
# attention_core masking the diagonal 2.1-2.8 on prefill. gemma3-27b's
# logits (to ~11) pass through 62 layers whose post-norms rescale each
# sub-block's output, rounding included, to unit RMS: its sound kernel
# path reads 0.19-0.28 against the plain path, both 0.17-0.23 from the f32
# run (readings per model: PERF.md)
LOGIT_ATOL = 0.125
F32_ANCHOR = 2.0
# finite extremes of the gate in phase 2's swiglu and geglu cases: e^-g and
# e^-2z overflow, g^3 overflows, the denominator of csrc/swiglu.cu's
# quotient passes 2^126 (-87.5 for SiLU, -9.7 for GeLU)
GLU_EXTREMES = [1e-30, -1e-30, 20.0, -20.0, -88.8, 100.0, -100.0, 1e4, -1e4,
                1e13, -1e13, -87.5, -9.7]
# the encoders' logits and the vision outputs, kernel path against plain
# path and fused against unfused, all 12 layers in bf16 (readings: PERF.md)
ENCODE_ATOL = 0.125
# the detector's top-K scores (sigmoid probabilities in [0, 1]) as value
# sets: every score of one path within this of a score of the other
SCORE_ATOL = 0.03

SOURCES = {
    "rms_norm": ("src/repro_torch/kernels/csrc/norms.cu",
                 "src/repro/kernels/norms.py:47"),
    "fused_add_rms_norm": ("src/repro_torch/kernels/csrc/norms.cu",
                           "src/repro/kernels/norms.py:79"),
    "layer_norm": ("src/repro_torch/kernels/csrc/norms.cu",
                   "src/repro/kernels/norms.py:226"),
    "fused_add_layer_norm": ("src/repro_torch/kernels/csrc/norms.cu",
                             "src/repro/kernels/norms.py:181"),
    "rope": ("src/repro_torch/kernels/csrc/rope.cu",
             "src/repro/kernels/rope.py:27"),
    "swiglu": ("src/repro_torch/kernels/csrc/swiglu.cu",
               "src/repro/kernels/swiglu.py:21"),
    "geglu": ("src/repro_torch/kernels/csrc/swiglu.cu",
              "src/repro/kernels/swiglu.py:27"),
    "attention_core": ("src/repro_torch/kernels/csrc/attention.cu",
                       "src/repro/kernels/attn_template.py:170"),
    "attention_window": ("src/repro_torch/kernels/csrc/attention.cu",
                         "src/repro/kernels/attn_template.py:170"),
    "decode_core": ("src/repro_torch/kernels/csrc/decode.cu",
                    "src/repro/kernels/attn_template.py:185"),
    "attention_full": ("src/repro_torch/kernels/csrc/attention.cu",
                       "src/repro/kernels/attn_template.py:170"),
    "nms": ("src/repro_torch/kernels/csrc/nms.cu",
            "src/repro/kernels/nms.py:25"),
    "dequant_add_rms_norm": ("src/repro_torch/kernels/csrc/norms.cu",
                             "src/repro/kernels/norms.py:125"),
    "softmax_xent": ("src/repro_torch/kernels/csrc/softmax_xent.cu",
                     "src/repro/kernels/softmax_xent.py:26"),
}
#: the served models the qdq phase measures (gemma3-27b is left out: weight
#: QDQ makes f32 temporaries of its 262144 x 5376 tied embedding, 5.6 GB
#: each, beside 54 GB of weights)
QDQ_ARCHS = ("llama2-7b", "gpt2-xl")
#: JAX's variant labels (core/workload.py ``Workload.variant``) of the 2x2:
#: (label, fake-quant mode, fused)
QDQ_VARIANTS = (("bf16", None, False), ("fused", None, True),
                ("int8-qdq", "int8", False), ("int8-qdq+fused", "int8", True))
# softmax_xent's output is f32 whatever the logits' dtype, from the same
# logits on both sides: JAX's sweep tolerance (tests/test_kernels.py)
XENT_TOL = {"bfloat16": (1e-5, 1e-5), "float32": (1e-5, 1e-5)}
# the dequant kernel in bf16: y may differ from the plain version's by an
# ulp only where the f32 row statistic's summation order tips a rounding
# (~1e-7 relative against a bf16 ulp of 2^-8: a few elements in 1e5); a
# kernel that normalised the unrounded r (off by up to half an ulp of r)
# tips a large share
Y_BITS_DIFFER_MAX = 0.01
ENCODERS = (("bert-base", ((1, 128), (8, 128))), ("vit-b16", ((1, 197),)))
VISION = ("vit-b16-cls", "detector-vit-s")
VISION_BATCH, VISION_FORWARDS = 8, 8


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def per_forward_launches(cfg, fused: bool, decode: bool = False,
                         extend: bool = False) -> dict:
    """Kernel launches of one forward on the kernel path: a prefill (or
    ``lm_forward``) runs ``attention_core`` in each global layer and
    ``attention_window`` in each local one (an encoder ``attention_full``),
    a decode step ``decode_core`` in every layer; a chunk of a chunked
    prefill (``lm_extend``, global layers only) runs what a prefill does.
    RMSNorm models launch one norm per pre-norm, post-norm and q/k-norm and
    the final one, of which fusion folds one a layer into
    ``fused_add_rms_norm``; LayerNorm models two a layer and the final one,
    of which fusion folds one into ``fused_add_layer_norm``. SwiGLU is a
    kernel fused or not; unfused GeGLU and rope are the plain op chains, as
    in the JAX package."""
    n = cfg.n_layers
    n_local = cfg.layer_kinds().count("local")
    if extend and n_local:
        fail(f"{cfg.name}: a local layer has no chunked prefill")
    if decode:
        out = {"decode_core": n}
    elif not cfg.causal:
        out = {"attention_full": n}
    else:
        out = {"attention_core": n - n_local, "attention_window": n_local}
    if cfg.norm == "rmsnorm":
        per_layer = 2 + 2 * cfg.post_norm + 2 * cfg.qk_norm
        out["rms_norm"] = n * (per_layer - fused) + 1
        if fused:
            out["fused_add_rms_norm"] = n
    else:
        out["layer_norm"] = n + 1 if fused else 2 * n + 1
        if fused:
            out["fused_add_layer_norm"] = n
    if cfg.ffn == "swiglu" or (fused and cfg.ffn == "geglu"):
        out[cfg.ffn] = n
    if fused and cfg.pos_emb == "rope":
        out["rope"] = 2 * n
    return {k: v for k, v in out.items() if v}


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def glu_sweep(torch, gen, dt, n: int = 1 << 16):
    """(gate, up) of phase 2's sweep case: 2^16 gates evenly over [-8, 8]
    against ups of +-8 with random signs. Where 1 + tanh(z) is small (g in
    [-4, -1]) an approximate tanh's error is many times the f32 limit, while
    the identity's stays under 7 % of it (numpy emulation,
    tests/test_torch_glu_design.py)."""
    g = torch.linspace(-8.0, 8.0, n, device="cuda")
    sign = torch.randint(0, 2, (n,), generator=gen, device="cuda") * 2 - 1
    return g.to(dt), (8.0 * sign).to(dt)


def check_kernels(torch, ops, ref, gen):
    """Every kernel vs its plain version at the main path's shapes and odd
    ones, bf16 and f32. Returns {kernel: max abs error over its cases}."""
    from repro_torch.kernels import attn_template, norms, rope
    from repro_torch.kernels import softmax_xent as xent
    from repro_torch.kernels import swiglu as glu

    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def split_chunk(b, hkv, t):
        """Keys per split of decode_core's plan on this card."""
        return attn_template.decode_chunk(
            t, attn_template.decode_splits(b, hkv, t, sms))

    def randn(shape, dt, scale=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                + mean).to(dt)

    def compare(name, got, want, dtname, case, tol=TOL, rms_scaled=False,
                body=None, **extra):
        """``rms_scaled``: atol times the plain output's RMS where that is
        below 1 (the window fragment's cases, see the note at TOL);
        ``body``: the row norms' plan body, printed with the case, as is
        ``extra`` (rope's plan)."""
        torch.cuda.synchronize()
        atol, rtol = tol[dtname]
        err = (got.float() - want.float()).abs()
        info = dict(extra) if body is None else dict(extra, body=body)
        if rms_scaled:
            rms = float(want.float().square().mean().sqrt())
            atol *= min(1.0, rms)
            info.update(plain_rms=rms, max_abs_err_over_rms=float(err.max()) / rms)
        lim = atol + rtol * want.float().abs()
        ok = bool((err <= lim).all()) and bool(torch.isfinite(got.float()).all())
        emit(phase="kernels", kernel=name, case=case, dtype=dtname,
             max_abs_err=float(err.max()), atol=atol, rtol=rtol, ok=ok, **info)
        if not ok:
            fail(f"{name} {case} {dtname}: kernel disagrees with plain version")
        worst[name] = max(worst[name], float(err.max()))

    def exact(name, got, want, dtname, case, body=None):
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        emit(phase="kernels", kernel=name, case=case, dtype=dtname,
             residual_bit_identical=same, **({} if body is None else {"body": body}))
        if not same:
            fail(f"{name} {case} {dtname}: r = x + res differs from the plain "
                 "version's (one f32 add, rounded once, on both sides)")

    worst = dict.fromkeys(SOURCES, 0.0)
    bodies = set()

    def body(x, dt, *others):
        """The body of csrc/norms.cu that a row norm on x runs."""
        b = norms.plan_for(x, dt, *others).body
        bodies.add(b)
        return b

    for dtname, dt in dts.items():
        # gemma3-27b's zero-centred norms (5376) and its qk-norm (128, off),
        # at the decode step and at s2048; a partial last row group (21
        # rows of 128, 16 a CTA); the widest rows of body B (bf16) and of
        # body C's 16-byte loads (f32)
        for shape, zc in [((4, 1, 4096), False), ((1, 256, 4096), False),
                          ((2, 33, 257), False), ((3, 7, 1000), True),
                          ((4, 1, 5376), True), ((1, 37, 32, 128), False),
                          ((3, 7, 128), False), ((1, 2048, 32, 128), False),
                          ((1, 2048, 5376), True), ((2, 1, 16384), False)]:
            x, w = randn(shape, dt), randn(shape[-1:], dt)
            bd = body(x, dt, w)
            compare("rms_norm", ops.rms_norm(x, w, zero_centered=zc),
                    ref.rms_norm(x, w, zero_centered=zc), dtname,
                    f"x{list(shape)} zero_centered={zc}", body=bd)
            res = randn(shape, dt, 4.0)
            (y, r), (wy, wr) = (f.fused_add_rms_norm(x, res, w, zero_centered=zc)
                                for f in (ops, ref))
            case = f"x,res{list(shape)} zero_centered={zc}"
            compare("fused_add_rms_norm", y, wy, dtname, case, body=bd)
            exact("fused_add_rms_norm", r, wr, dtname, case, body=bd)
        # gpt2-xl's width and stablelm-3b's; a row whose mean is far from
        # zero (1e3 + N(0,1)); the Table-2 Segformer rows (32 wide) and
        # bert-base at b8
        for shape, mean in [((4, 1, 1600), 0.0), ((1, 256, 1600), 3.0),
                            ((4, 1, 2560), 0.0), ((1, 256, 2560), 3.0),
                            ((2, 33, 257), 0.0), ((3, 7, 1000), 0.0),
                            ((2, 1600), 1e3), ((2, 16384, 32), 0.0),
                            ((8, 128, 768), 3.0)]:
            x = randn(shape, dt, mean=mean)
            w, b = randn(shape[-1:], dt), randn(shape[-1:], dt)
            tol = LARGE_MEAN_TOL if mean > 100 else TOL
            case = f"x{list(shape)} mean={mean}"
            bd = body(x, dt, w, b)
            compare("layer_norm", ops.layer_norm(x, w, b),
                    ref.layer_norm(x, w, b), dtname, case, tol, body=bd)
            res = randn(shape, dt, 4.0)
            (y, r), (wy, wr) = (f.fused_add_layer_norm(x, res, w, b)
                                for f in (ops, ref))
            compare("fused_add_layer_norm", y, wy, dtname, case, tol, body=bd)
            exact("fused_add_layer_norm", r, wr, dtname, case, body=bd)
        # (B, S, H, D, fraction, first position, positions as a (B, 1)
        # column): llama decode and prefill, partial rotary at 25 heads of
        # 64, an odd head dim at 4091+, and half 48, where -i / half and
        # -i * (1 / half) differ in f32; gemma3-27b's q at a 2048-token
        # prefill and k at 2049, whose last row group is ragged (rows
        # walked by a grid stride); a decode column near 4095; rows of
        # more vectors than a CTA's threads (in chunks); half at its 6144
        # limit, scalar; stablelm-3b's decode step and prefill (head dim 80,
        # a quarter rotated: half 10, scalar)
        for b, s, h, d, frac, p0, column in [(4, 1, 32, 80, 0.25, 215, True),
                                             (1, 256, 32, 80, 0.25, 0, False),
                                             (4, 1, 32, 128, 1.0, 186, False),
                                             (1, 256, 32, 128, 1.0, 0, False),
                                             (2, 7, 25, 64, 0.25, 500, False),
                                             (3, 7, 25, 64, 0.25, 500, False),
                                             (1, 5, 3, 34, 1.0, 4091, False),
                                             (1, 5, 3, 96, 1.0, 4091, False),
                                             (1, 2048, 32, 128, 1.0, 0, False),
                                             (1, 2049, 16, 128, 1.0, 0, False),
                                             (4, 1, 32, 128, 1.0, 4092, True),
                                             (2, 3, 72, 256, 1.0, 7, False),
                                             (1, 3, 2, 12289, 1.0, 4093, False)]:
            x = randn((b, s, h, d), dt)
            ar = p0 + torch.arange(b if column else s, dtype=torch.int32,
                                   device="cuda")
            pos = ar[:, None] if column else ar[None].expand(b, s)
            y = ops.rope(x, pos, fraction=frac)
            compare("rope", y, ref.rope(x, pos, fraction=frac), dtname,
                    f"x{[b, s, h, d]} fraction={frac} positions {p0}.."
                    f"{int(ar[-1])}{' (B, 1)' if column else ''}",
                    plan=rope.plan_for(x, frac, y)._asdict())
        # swiglu: llama2-7b's decode step and prefill bucket; geglu:
        # gemma3-27b's decode rows, a prefill and its fused prefill at the
        # 2048 bucket (the launch phase 5 times); no multiple of 4, a tail
        # of 1; both on a view 4 elements into its storage (8-byte aligned,
        # not 16), and one element in (the scalar body), and at finite
        # extremes of the gate (e^-g, e^-2z and g^3 overflowing, the
        # denominator past 2^126), each naming its plan
        for kernel, shapes in (("swiglu", [(4, 1, 11008), (1, 256, 11008),
                                           (4, 1, 6912), (1, 256, 6912),
                                           (2, 37, 257), (1, 13)]),
                               ("geglu", [(4, 1, 21504), (1, 256, 21504),
                                          (1, 2048, 21504), (2, 37, 257),
                                          (1, 17), (1, 1)])):
            fn, plain = getattr(ops, kernel), getattr(ref, kernel)
            cases = [(randn(s, dt, 3.0), randn(s, dt), f"{list(s)}") for s in shapes]
            gb, ub = randn((44036,), dt, 3.0), randn((44036,), dt)
            cases += [(gb[k:], ub[k:], f"[{44036 - k}] {k} elements into its storage")
                      for k in (4, 1)]
            ext = torch.tensor(GLU_EXTREMES, device="cuda").repeat(2, 8).to(dt)
            cases.append((ext, randn(tuple(ext.shape), dt), "extremes of the gate"))
            cases.append((*glu_sweep(torch, gen, dt), "gate swept over [-8, 8], |up| 8"))
            for g, u, case in cases:
                compare(kernel, fn(g, u), plain(g, u), dtname, case,
                        plan=glu.plan_for(g, u)._asdict())
        # window: (B, Sq, Skv, Hq, Hkv, D, q_offset, window): gemma3-27b's
        # prefill at the 2048 bucket and past the window at 1100; windows
        # of 1, 63, 64, 65 keys at 197 (no multiple of the 64-key tile),
        # GQA groups 1 and 2, a window longer than S, a q_offset, scalar
        # tile staging
        for b, sq, skv, hq, hkv, d, off, w in [
                (1, 2048, 2048, 32, 16, 128, 0, 1024),
                (1, 1100, 1100, 32, 16, 128, 0, 1024),
                (2, 197, 197, 4, 2, 64, 0, 1),
                (2, 197, 197, 4, 4, 64, 0, 63),
                (1, 197, 197, 8, 4, 128, 0, 64),
                (2, 197, 197, 4, 2, 64, 0, 65),
                (1, 37, 37, 4, 4, 64, 0, 1000),
                (1, 13, 140, 4, 2, 64, 127, 70),
                (1, 21, 21, 2, 2, 34, 0, 5)]:
            q = randn((b, sq, hq, d), dt)
            k, v = randn((b, skv, hkv, d), dt), randn((b, skv, hkv, d), dt)
            compare("attention_window",
                    ops.attention_window(q, k, v, w, q_offset=off),
                    ref.attention(q, k, v, q_offset=off, window=w), dtname,
                    f"q{[b, sq, hq, d]} kv{[b, skv, hkv]} q_offset={off} "
                    f"window={w}", rms_scaled=True)
        # (B, Sq, Skv, Hq, Hkv, Dk, Dv, q_offset)
        for b, sq, skv, hq, hkv, dk, dv, off in [
                (1, 256, 256, 32, 32, 128, 128, 0),   # llama prefill bucket
                (1, 256, 256, 25, 25, 64, 64, 0),     # gpt2-xl prefill bucket
                (1, 2048, 2048, 32, 16, 128, 128, 0),  # gemma3-27b global
                (2, 37, 37, 4, 4, 64, 64, 0),         # seq 37
                (1, 100, 100, 8, 2, 128, 128, 0),     # GQA 8/2
                (2, 35, 35, 4, 4, 48, 16, 0),         # Dv != Dk
                (1, 13, 40, 4, 2, 32, 32, 27),        # q_offset
                (1, 21, 21, 2, 2, 34, 18, 0),         # scalar tile staging
                (1, 50, 50, 4, 4, 80, 80, 0),         # head dims that are
                (1, 70, 70, 4, 2, 96, 96, 0),         # multiples of 16, no pow2
                (2, 1, 70, 4, 2, 128, 128, 69),       # Sq = 1
                (1, 100, 300, 8, 4, 128, 128, 200),   # q_offset, Sq < Skv
                (1, 256, 256, 32, 32, 80, 80, 0),     # stablelm-3b prefill
                (1, 64, 512, 32, 32, 80, 80, 448)]:   # its last 64-chunk
            q = randn((b, sq, hq, dk), dt)
            k, v = randn((b, skv, hkv, dk), dt), randn((b, skv, hkv, dv), dt)
            compare("attention_core", ops.attention_core(q, k, v, q_offset=off),
                    ref.attention(q, k, v, q_offset=off), dtname,
                    f"q{[b, sq, hq, dk]} kv{[b, skv, hkv]} dv={dv} q_offset={off}")
        # a chunk of a chunked prefill over a deeper cache whose rows past
        # the chunk are NaN (stale rows of a paged cache are finite, NaN
        # shows any of them read): the output stays finite and equals the
        # plain version over the keys up to the chunk's end
        for b, sq, skv, hq, hkv, dk, off in [(1, 64, 512, 32, 32, 80, 160),
                                             (1, 37, 512, 32, 32, 80, 160),
                                             (1, 44, 300, 8, 2, 128, 256),
                                             (2, 5, 140, 4, 4, 64, 70)]:
            q = randn((b, sq, hq, dk), dt)
            k, v = randn((b, skv, hkv, dk), dt), randn((b, skv, hkv, dk), dt)
            end = off + sq
            want = ref.attention(q, k[:, :end], v[:, :end], q_offset=off)
            k[:, end:], v[:, end:] = float("nan"), float("nan")
            compare("attention_core", ops.attention_core(q, k, v, q_offset=off),
                    want, dtname, f"q{[b, sq, hq, dk]} kv{[b, skv, hkv]} "
                    f"q_offset={off}, NaN keys and values from {end}")
        # the split over the cache: chunk C of this card's plan for one
        # row of one KV head over 4096 keys (the most splits) and for
        # gemma3's rings; lengths on a split boundary and one past it
        c1 = split_chunk(1, 1, 4096)
        c4 = split_chunk(4, 16, 1024)
        for b, t, hq, hkv, dk, dv, lens in [
                (4, 512, 32, 32, 128, 128, [1, 200, 512, 0]),   # llama, a dead slot
                (4, 512, 25, 25, 64, 64, [186, 512, 0, 72]),    # gpt2-xl
                (4, 512, 32, 32, 80, 80, [216, 20, 61, 512]),   # stablelm-3b
                (4, 1024, 32, 16, 128, 128, [1024, 1024, 1024, 53]),  # rings
                (4, 2048, 32, 16, 128, 128, [1516, 1116, 1031, 53]),  # gemma3
                (3, 100, 8, 2, 64, 64, [0, 37, 100]),           # GQA 8/2
                (2, 70, 4, 4, 48, 16, [70, 5]),                 # Dv != Dk
                (2, 30, 4, 2, 34, 18, [30, 7]),                 # scalar staging
                (1, 4096, 1, 1, 128, 128, [4096]),              # most splits
                (1, 4096, 8, 1, 128, 128, [c1 + 1]),
                (1, 4096, 8, 1, 64, 64, [c1]),
                (4, 1024, 32, 16, 128, 128, [c4, c4 + 1, 2 * c4, 0])]:
            q = randn((b, 1, hq, dk), dt)
            k, v = randn((b, t, hkv, dk), dt), randn((b, t, hkv, dv), dt)
            n = torch.tensor(lens, dtype=torch.int32, device="cuda")
            got = ops.decode_core(q, k, v, n)
            compare("decode_core", got, ref.decode_attention(q, k, v, n), dtname,
                    f"q{[b, 1, hq, dk]} kv{[b, t, hkv]} dv={dv} lengths={lens} "
                    f"n_split={attn_template.decode_splits(b, hkv, t, sms)}")
            if 0 in lens and got[lens.index(0)].float().abs().any():
                fail("decode_core: lengths 0 must give exact zeros")
        # full mask: (B, Sq, Skv, Hq, Hkv, Dk, Dv); 196 and 197 are not
        # multiples of the 64-key tile, 128 / 256 / 1024 are
        for b, sq, skv, hq, hkv, dk, dv in [
                (1, 197, 197, 12, 12, 64, 64),     # the vit-b16 stub
                (1, 196, 196, 12, 12, 64, 64),     # vit-b16-cls
                (8, 128, 128, 12, 12, 64, 64),     # bert-base b8
                (2, 256, 1024, 6, 6, 64, 64),      # detector refinement
                (1, 37, 301, 4, 2, 64, 32),        # GQA, Dv != Dk, odd
                (1, 21, 23, 2, 2, 34, 18),         # scalar tile staging
                (1, 50, 70, 4, 4, 80, 80),         # head 80
                (1, 1, 96, 4, 2, 96, 96)]:         # Sq = 1, head 96
            q = randn((b, sq, hq, dk), dt)
            k, v = randn((b, skv, hkv, dk), dt), randn((b, skv, hkv, dv), dt)
            compare("attention_full", ops.attention_full(q, k, v),
                    ref.attention(q, k, v, causal=False), dtname,
                    f"q{[b, sq, hq, dk]} kv{[b, skv, hkv]} dv={dv}")
        # dequant_add_rms_norm: the reference sweep's shapes, the Table-2
        # row and a decode step's
        for shape in [(4, 128), (2, 33, 257), (1, 7, 3, 64), (1, 10, 4096),
                      (4, 1, 4096)]:
            for zc in (False, True):
                q = torch.randint(-127, 128, shape, generator=gen,
                                  device="cuda", dtype=torch.int8)
                qs = torch.full((), 0.031, device="cuda")
                res, w = randn(shape, dt, 4.0), randn(shape[-1:], dt)
                (y, r), (wy, wr) = (f.dequant_add_rms_norm(
                    q, qs, res, w, zero_centered=zc) for f in (ops, ref))
                case = f"q,res{list(shape)} zero_centered={zc}"
                bd = body(q, dt, res, w)
                compare("dequant_add_rms_norm", y, wy, dtname, case, body=bd)
                exact("dequant_add_rms_norm", r, wr, dtname, case, body=bd)
                if dt == torch.bfloat16:
                    frac = float((y != wy).float().mean())
                    emit(phase="kernels", kernel="dequant_add_rms_norm",
                         case=case, dtype=dtname, y_bits_differ_frac=frac,
                         limit=Y_BITS_DIFFER_MAX)
                    if frac > Y_BITS_DIFFER_MAX:
                        fail(f"dequant_add_rms_norm {case}: {frac} of y "
                             "differs from the plain version's bits")
        # softmax_xent: the reference sweep's shapes, the §4.5 site and
        # gemma3-27b's vocabulary with 8 and 2 rows (split into many spans),
        # splits whose rows and span edges are misaligned ((5, 4099),
        # (3, 100003), (9, 24577)); labels in the first and last spans, int32
        # and int64 in turn, and from 4 rows up -1 and V in rows 1 and 2 (a
        # label outside [0, V) picks nothing: the row's logsumexp). Each
        # case runs with fresh logits, so a split plan whose counters were
        # left set, or a merge that read stale partials, disagrees
        for i, (rows, vocab) in enumerate([
                (7, 1000), (32, 50304), (3, 130), (256, 32000), (8, 262144),
                (5, 4099), (2, 262144), (3, 100003), (9, 24577)]):
            logits = randn((rows, vocab), dt, 5.0)
            ldt = (torch.int32, torch.int64)[i % 2]
            labels = torch.randint(0, vocab, (rows,), generator=gen,
                                   device="cuda", dtype=ldt)
            labels[0], labels[-1] = 0, vocab - 1
            outside = torch.zeros(rows, dtype=torch.bool, device="cuda")
            if rows >= 4:
                labels[1], labels[2] = -1, vocab
                outside[1:3] = True
            want = torch.where(
                outside, torch.logsumexp(logits.float(), -1),
                ref.softmax_xent(logits, labels.clamp(0, vocab - 1)))
            compare("softmax_xent", ops.softmax_xent(logits, labels), want,
                    dtname, f"logits[{rows},{vocab}] labels {str(ldt)[6:]}"
                    f"{' with -1 and V' if rows >= 4 else ''}", XENT_TOL,
                    plan=xent.xent_plan(rows, vocab, dt, sms)._asdict())
    if bodies != set(norms.BODY_CODE):
        fail(f"row norms: the cases reached the bodies {sorted(bodies)}, not "
             f"all of {sorted(norms.BODY_CODE)}")
    for case, (boxes, scores, thr, score_thr) in nms_cases(np.random.default_rng(SEED)):
        bt = torch.from_numpy(boxes).cuda()
        st = torch.from_numpy(scores).cuda()
        got = ops.nms(bt, st, thr, score_thr)
        want = ref.nms(bt, st, thr, score_thr)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        emit(phase="kernels", kernel="nms", case=case, n=len(boxes),
             iou_threshold=thr, score_threshold=score_thr,
             kept=int(got.sum()), plain_kept=int(want.sum()), identical=same)
        if not same:
            fail(f"nms {case}: keep mask differs from the plain version's in "
                 f"{int((got != want).sum())} of {len(boxes)} boxes")
        if case == "exact_threshold_pairs" and got.tolist() != [True, True,
                                                                 True, False]:
            fail("nms: IoU exactly 0.5 must keep, one ulp above suppress")
        if case == "fma_sensitive_pairs" and got.tolist() != fma_pairs()[1].tolist():
            fail("nms: a pair whose IoU an FMA would move across 0.5 fell the "
                 "wrong way")
    for case, (boxes, valid, thr, at, above) in nms_word_cases(
            np.random.default_rng(SEED)):
        bt, vt = torch.from_numpy(boxes).cuda(), torch.from_numpy(valid).cuda()
        got = ops.nms_sorted(bt, vt, thr)
        want = ref.nms_sorted(bt, vt, thr)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        emit(phase="kernels", kernel="nms", case=case, n=len(boxes),
             iou_threshold=thr, valid=int(valid.sum()), kept=int(got.sum()),
             plain_kept=int(want.sum()), identical=same)
        if not same:
            fail(f"nms {case}: keep mask differs from the plain version's in "
                 f"{int((got != want).sum())} of {len(boxes)} boxes")
        if not (got[at + 1] and not got[above + 1]):
            fail(f"nms {case}: IoU exactly 0.5 must keep (box {at + 1}), one "
                 f"ulp above suppress (box {above + 1})")
    return worst


def random_boxes(rng, n, span=60.0):
    centers = rng.uniform(size=(n, 2)) * span
    wh = rng.uniform(size=(n, 2)) * 12 + 1
    return (np.concatenate([centers - wh / 2, centers + wh / 2], -1)
            .astype(np.float32), rng.uniform(size=n).astype(np.float32))


def nms_cases(rng):
    """(name, (boxes (N, 4) f32, scores (N,) f32, iou threshold, score
    threshold)) of phase 2's NMS checks."""
    for n in (1, 37, 256, 1000, 4096):
        yield f"random-{n}", (*random_boxes(rng, n, span=2 * math.sqrt(n) + 20),
                              0.5, 0.0)
    boxes, scores = random_boxes(rng, 256)
    yield "duplicate_scores", (boxes, np.round(scores * 3) / 3, 0.5, 0.0)
    boxes[:2] = [[5, 5, 5, 5], [9, 9, 3, 3]]
    yield "zero_area", (boxes, scores, 0.5, 0.0)
    jitter = rng.uniform(size=(72, 4)).astype(np.float32) * 0.1
    yield "all_suppressed", (np.float32([10, 10, 20, 20]) + jitter,
                             np.linspace(0.9, 0.1, 72, dtype=np.float32), 0.3, 0.0)
    off = np.arange(40, dtype=np.float32) * 30
    yield "none_suppressed", (np.stack([off, off, off + 10, off + 10], -1),
                              rng.uniform(0.25, 0.75, 40).astype(np.float32),
                              0.5, 0.0)
    yield "score_threshold", (*random_boxes(rng, 1000), 0.5, 0.4)
    # f32 IoU exactly 0.5 (kept: only an IoU above the threshold
    # suppresses) and one ulp above it (suppressed)
    s = np.nextafter(np.float32(1 / 3), np.float32(0))
    yield "exact_threshold_pairs", (
        np.array([[10, 0, 13, 1], [11, 0, 14, 1], [0, 0, 1, 1],
                  [s, 0, np.float32(s + 1), 1]], np.float32),
        np.array([0.9, 0.8, 0.7, 0.6], np.float32), 0.5, 0.0)
    yield "fma_sensitive_pairs", (fma_pairs()[0],
                                  np.linspace(0.9, 0.1, 2 * len(FMA_PAIRS),
                                              dtype=np.float32), 0.5, 0.0)
    # 2048 pairs of equal boxes a third of their width apart: IoU 1/2 up
    # to rounding, so each pair's f32 IoU falls a few ulps either side
    x, y, w, h = rng.uniform(5, 40, (4, 2048))
    ox, oy = (np.arange(2048) % 64) * 100.0, (np.arange(2048) // 64) * 100.0
    a = np.stack([ox + x, oy + y, ox + x + w, oy + y + h], -1)
    pairs = np.stack([a, a + np.stack([w / 3, 0 * w, w / 3, 0 * w], -1)], 1)
    yield "near_threshold_pairs", (pairs.reshape(-1, 4).astype(np.float32),
                                   np.linspace(0.99, 0.5, 4096, dtype=np.float32),
                                   0.5, 0.0)


#: box pairs (a, b), a scored above b, whose f32 IoU falls on one side of
#: 0.5 with every product and sum rounded on its own and on the other side
#: where nvcc fuses a product into an FMA: the first four where
#: (area_j + area_i) - iw * ih is fused, the others where area_j + area_i
#: is fused with area_i's product (found by an exact search; the property
#: is checked in tests/test_torch_rope_nms_design.py). True: b suppressed
FMA_PAIRS = [
    (("0x1.92b46ep+4", "0x1.49090ap+4", "0x1.a43a12p+5", "0x1.259f7ep+5"),
     ("0x1.124f8p+5", "0x1.49090ap+4", "0x1.ed2f5cp+5", "0x1.259f7ep+5"), True),
    (("0x1.44f968p+4", "0x1.16d42p+5", "0x1.4c8accp+5", "0x1.0b1662p+6"),
     ("0x1.b65822p+4", "0x1.16d42p+5", "0x1.853a2ap+5", "0x1.0b1662p+6"), True),
    (("0x1.17b464p+5", "0x1.a7d144p+4", "0x1.6f161ap+5", "0x1.161158p+6"),
     ("0x1.34d4f6p+5", "0x1.a7d144p+4", "0x1.8c36acp+5", "0x1.161158p+6"), True),
    (("0x1.39b9fp+5", "0x1.49ef3cp+4", "0x1.0eac4ep+6", "0x1.07dc66p+6"),
     ("0x1.85997ep+5", "0x1.49ef3cp+4", "0x1.349c16p+6", "0x1.07dc66p+6"), True),
    (("0x1.5686fp+3", "0x1.19b4dp+5", "0x1.35280ep+5", "0x1.395716p+6"),
     ("0x1.4047aep+4", "0x1.19b4dp+5", "0x1.7faa2ap+5", "0x1.395716p+6"), True),
    (("0x1.2b58ecp+4", "0x1.5e7c8ep+4", "0x1.31a708p+5", "0x1.e5b862p+5"),
     ("0x1.93554ep+4", "0x1.5e7c8ep+4", "0x1.65a538p+5", "0x1.e5b862p+5"), True),
    (("0x1.6f9cd6p+4", "0x1.96639p+0", "0x1.0033e8p+6", "0x1.8e534p+5"),
     ("0x1.2556e2p+5", "0x1.96639p+0", "0x1.36f824p+6", "0x1.8e534p+5"), False),
    (("0x1.a0844ap+4", "0x1.12c91ep+3", "0x1.c331a2p+5", "0x1.c0d378p+5"),
     ("0x1.213ca4p+5", "0x1.12c91ep+3", "0x1.0a161p+6", "0x1.c0d378p+5"), False)]


def fma_pairs():
    """FMA_PAIRS as one set of score-sorted boxes (a0, b0, a1, b1, ...),
    pair k scaled by 16^k (a power of two: every rounding as at 1), so that
    no two pairs touch; and the keep mask the rounded IoUs give."""
    boxes, keep = [], []
    for k, (a, b, suppressed) in enumerate(FMA_PAIRS):
        for box in (a, b):
            boxes.append([float.fromhex(v) * 16.0 ** k for v in box])
        keep += [True, not suppressed]
    return np.array(boxes, np.float32), np.array(keep)


def nms_word_cases(rng):
    """(name, (score-sorted boxes (N, 4) f32, valid (N,), iou threshold,
    a, b)) at the mask's word boundaries and above, for ``nms_sorted``
    directly: every third box invalid, and two pairs far from the rest,
    one at an f32 IoU of exactly 0.5 at sorted places (a, a + 1), across a
    word boundary where N allows, one an ulp above it at (b, b + 1)."""
    s = np.nextafter(np.float32(1 / 3), np.float32(0))
    for n in (63, 64, 65, 129, 4663, 8192):
        boxes, _ = random_boxes(rng, n, span=2 * math.sqrt(n) + 20)
        valid = np.arange(n) % 3 != 1
        a = 63 if n > 64 else n // 2 - 1
        b = 127 if n > 128 else (a + 3 if a + 4 < n else a - 3)
        boxes[a:a + 2] = [[10010, 0, 10013, 1], [10011, 0, 10014, 1]]
        boxes[b:b + 2] = [[0, 1000, 1, 1001], [s, 1000, np.float32(s + 1), 1001]]
        valid[[a, a + 1, b, b + 1]] = True
        yield f"words-{n}", (boxes, valid, 0.5, a, b)


# ---------------------------------------------------------------------------
# phase 5: times at the main path's shapes
# ---------------------------------------------------------------------------

def time_kernels(torch, ops, ref, gen, decode_lengths, graph, nms_inputs):
    """Kernel, plain and library times at the serve phase's main-path shapes
    (bf16), with the bound each function's bytes and operations set. The
    row-wise kernels do their arithmetic in f32 on the CUDA cores, so their
    operations are bounded by the f32 rate; attention's products could run
    on the tensor cores, so theirs by the bf16 rate. Returns the kernels
    line's entries and prints the gpt2-xl attention shapes, the other
    full-mask ones, gemma3-27b's GeGLU prefill, global causal prefill and
    ring decode, the row norms' wider shapes and the empty kernel on lines
    of their own. The attention rows name the body that ran (``mma bf16``
    or ``fma f32``, attn_template.body), the row norms theirs (``warp``,
    ``cta`` or ``smem``, norms.row_norm_plan)."""
    import torch.nn.functional as F

    from repro_torch.kernels import attn_template, norms, rope
    from repro_torch.kernels import softmax_xent as xent
    from repro_torch.kernels import swiglu as glu

    timer = graph.Timer()
    dt = torch.bfloat16

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    def entry(shape, kernel, plain, library, nbytes, flops, peak="float32",
              body=None):
        row = dict(shape=shape, ms=timer(kernel), eager_ms=timer.eager(kernel),
                   plain_ms=None if plain is None else timer(plain),
                   library_ms=None if library is None else timer(library),
                   bound=bound_ms(nbytes, flops, peak))
        if body is not None:
            row["body"] = body
        return row

    body = attn_template.body(dt)

    # the row norms: the kernels line's five rows (the decode step's and
    # the Table-2 dequant row), then gemma3-27b's qk-norm and block norms at
    # s2048, the Table-2 Segformer row, bert-base at b8 and an empty
    # kernel (the launch floor), on lines of their own
    out, extra = {}, {}
    for key, row in _script("norm_timing").time_row_norms(
            torch, ops, ref, entry, gen, norms).items():
        (out if key in SOURCES else extra)[key] = row
    # rope at the decode step (the kernels line) and gemma3-27b's prefill
    # q and k; nms on the detector's first image (the kernels line), the
    # Table-2 RoI row and MAX_BOXES (scripts/rope_nms_timing.py)
    for key, row in _script("rope_nms_timing").time_rope_nms(
            torch, ops, ref, entry, gen, rope, nms_inputs,
            [[n - 1] for n in decode_lengths["llama2-7b"]], floor=False).items():
        (out if key in SOURCES else extra)[key] = row
    # stablelm-3b's decode step: head dim 80, rope on a quarter of it (half
    # 10: no 16-byte vector, the scalar plan), positions as a (4, 1) column
    x = randn((4, 1, 32, 80))
    col = torch.tensor([[n - 1] for n in decode_lengths["stablelm-3b"]],
                       dtype=torch.int32, device="cuda")
    rot = x.numel() // 4                        # the rotated quarter
    extra["rope stablelm"] = entry(
        "q[4,1,32,80] bf16, fraction 0.25 (half 10), positions (4,1) "
        "(stablelm-3b fused decode step)",
        lambda: ops.rope(x, col, fraction=0.25),
        lambda: ref.rope(x, col, fraction=0.25), None,
        2 * 2 * x.numel() + 4 * col.numel(), 3 * rot + 3 * 4 * 10)
    extra["rope stablelm"]["plan"] = rope.plan_for(
        x, 0.25, ops.rope(x, col, fraction=0.25))._asdict()
    # swiglu and geglu at the decode step (the kernels line) and the served
    # prefills, with torch.mul of the same operands (scripts/glu_timing.py)
    for key, row in _script("glu_timing").time_glu(
            torch, ops, ref, entry, gen, glu, floor=False).items():
        (out if key in SOURCES else extra)[key] = row
    # attention_window: gemma3-27b's local-layer prefill at the 2048 bucket;
    # the library call is SDPA over KV heads repeated to 32 with the band
    # mask spelled out
    b, s, hq, hkv, dh, w = 1, 2048, 32, 16, 128, 1024
    q = randn((b, s, hq, dh))
    k, v = randn((b, s, hkv, dh)), randn((b, s, hkv, dh))
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (a.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
              for a in (k, v))
    ar = torch.arange(s, device="cuda")
    band = (ar[:, None] >= ar[None, :]) & (ar[:, None] - ar[None, :] < w)
    visible = int(band.sum())               # (q, k) pairs per head
    out["attention_window"] = entry(
        f"q[1,{s},{hq},{dh}] kv[1,{s},{hkv},{dh}] bf16 window={w} "
        "(gemma3-27b local prefill, 2048 bucket)",
        lambda: ops.attention_window(q, k, v, w),
        lambda: ref.attention(q, k, v, window=w),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band),
        2 * b * s * dh * (2 * hq + 2 * hkv), 2 * b * hq * visible * 2 * dh,
        "bfloat16", body)
    # attention_core: gemma3-27b's global layers at the same bucket; the
    # library call is causal SDPA over the KV heads repeated to 32
    visible = s * (s + 1) // 2
    extra["attention_core gemma3"] = entry(
        f"q[1,{s},{hq},{dh}] kv[1,{s},{hkv},{dh}] bf16 causal "
        "(gemma3-27b global prefill, 2048 bucket)",
        lambda: ops.attention_core(q, k, v), lambda: ref.attention(q, k, v),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        2 * b * s * dh * (2 * hq + 2 * hkv), 2 * b * hq * visible * 2 * dh,
        "bfloat16", body)
    # decode_core: gemma3-27b's ring decode, its 4 slots' local caches of
    # depth 1024 at the serve run's lengths (min(pos + 1, 1024))
    b, t = 4, 1024
    lens_l = [min(n, t) for n in decode_lengths["gemma3-27b"]]
    q1 = randn((b, 1, hq, dh))
    k1, v1 = randn((b, t, hkv, dh)), randn((b, t, hkv, dh))
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    mask = (torch.arange(t, device="cuda")[None] < lens[:, None])[:, None, None, :]
    qt1 = q1.transpose(1, 2).contiguous()
    kt1, vt1 = (a.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
                for a in (k1, v1))
    kv = sum(lens_l)
    extra["decode_core gemma3 ring"] = entry(
        f"q[4,1,{hq},{dh}] kv[4,{t},{hkv},{dh}] bf16 lengths={lens_l} "
        "(gemma3-27b ring decode)",
        lambda: ops.decode_core(q1, k1, v1, lens),
        lambda: ref.decode_attention(q1, k1, v1, lens),
        lambda: F.scaled_dot_product_attention(qt1, kt1, vt1, attn_mask=mask),
        2 * (2 * b * hq * dh + 2 * kv * hkv * dh), 4 * kv * hq * dh, "bfloat16")

    # attention_core at the last 64-token chunk of a chunked prefill into a
    # 512-deep cache (stablelm-3b, q_offset 448); the library call is SDPA
    # with the causal-offset mask spelled out
    b, sq, t, h, dh, off = 1, 64, 512, 32, 80, 448
    q, k, v = randn((b, sq, h, dh)), randn((b, t, h, dh)), randn((b, t, h, dh))
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    mask = (torch.arange(t, device="cuda")[None, :]
            <= off + torch.arange(sq, device="cuda")[:, None])
    visible = sum(off + i + 1 for i in range(sq))
    extra["attention_core extend"] = entry(
        f"q[1,{sq},{h},{dh}] kv[1,{t},{h},{dh}] bf16 causal q_offset={off} "
        "(stablelm-3b, the last chunk of a chunked prefill)",
        lambda: ops.attention_core(q, k, v, q_offset=off),
        lambda: ref.attention(q, k, v, q_offset=off),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
        2 * b * h * dh * (2 * sq + 2 * t), 2 * b * h * visible * 2 * dh,
        "bfloat16", body)
    for arch, (h, dh) in (("llama2-7b", (32, 128)), ("gpt2-xl", (25, 64))):
        # attention_core: the serve phase's largest prefill bucket
        b, s = 1, 256
        q, k, v = randn((b, s, h, dh)), randn((b, s, h, dh)), randn((b, s, h, dh))
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        visible = s * (s + 1) // 2                 # causal (q, k) pairs per head
        attn = entry(
            f"q,k,v[1,256,{h},{dh}] bf16 causal ({arch} prefill bucket)",
            lambda: ops.attention_core(q, k, v), lambda: ref.attention(q, k, v),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
            4 * b * s * h * dh * 2, 2 * b * h * visible * 2 * dh, "bfloat16",
            body)
        # decode_core: the 4-slot cache of depth 512 at the serve run's lengths
        b, t = 4, 512
        lens_l = decode_lengths[arch]
        q = randn((b, 1, h, dh))
        k, v = randn((b, t, h, dh)), randn((b, t, h, dh))
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        mask = (torch.arange(t, device="cuda")[None] < lens[:, None])[:, None, None, :]
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        kv = sum(lens_l)
        dec = entry(
            f"q[4,1,{h},{dh}] kv[4,512,{h},{dh}] bf16 lengths={lens_l} ({arch})",
            lambda: ops.decode_core(q, k, v, lens),
            lambda: ref.decode_attention(q, k, v, lens),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
            2 * (2 * b * h * dh + 2 * kv * h * dh), 4 * kv * h * dh, "bfloat16")
        if arch == "llama2-7b":
            out["attention_core"], out["decode_core"] = attn, dec
        else:
            extra["attention_core"], extra["decode_core"] = attn, dec
    # attention_full: vit-b16-cls's 196 tokens (the kernels line), the
    # detector's refinement (K = 256 queries over its 1024 cells) and
    # bert-base at b8 s128 (lines of their own)
    for key, (b, sq, skv, h, what) in (
            ("attention_full", (1, 196, 196, 12, "vit-b16-cls, 224 px")),
            ("attention_full refine", (1, 256, 1024, 6,
                                       "detector-vit-s refinement")),
            ("attention_full bert", (8, 128, 128, 12, "bert-base b8 s128"))):
        dh = 64
        q = randn((b, sq, h, dh))
        k, v = randn((b, skv, h, dh)), randn((b, skv, h, dh))
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        row = entry(
            f"q[{b},{sq},{h},{dh}] kv[{b},{skv},{h},{dh}] bf16 full ({what})",
            lambda: ops.attention_full(q, k, v),
            lambda: ref.attention(q, k, v, causal=False),
            lambda: F.scaled_dot_product_attention(qt, kt, vt),
            2 * b * h * dh * (2 * sq + 2 * skv),
            2 * b * h * sq * skv * 2 * dh, "bfloat16", body)
        if key == "attention_full":
            out[key] = row
        else:
            extra[key] = row
    # softmax_xent at the §4.5 site, (256, 32000) f32 (the kernels line),
    # gemma3-27b's vocabulary with 8 rows, its loss chunk and llama2-7b's
    # loss over 2048 tokens; the library call is F.cross_entropy per row,
    # beside torch.amax of the same logits (scripts/xent_timing.py)
    for key, row in _script("xent_timing").time_xent(
            torch, ops, ref, entry, gen, xent, floor=False).items():
        (out if key in SOURCES else extra)[key] = row
    for name, tm in extra.items():
        emit(phase="timing", kernel=name, **{k: v for k, v in tm.items()
                                             if k != "bound"},
             bound_ms=tm["bound"][0], bound_by=tm["bound"][1])
    return out


def _script(name: str):
    """``scripts/<name>.py`` of this tree: the row norms' timed cases
    (``norm_timing``), rope's and NMS's (``rope_nms_timing``), the gated
    activations' (``glu_timing``), softmax_xent's (``xent_timing``)."""
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# phase 3: serve, and the paths against each other
# ---------------------------------------------------------------------------

def compare_paths(torch, nn, params, cfg, prompts, fused: bool,
                  max_len: int, extend_prompt=None):
    """The model's kernel path against another path of the same model, on
    the card, on the same weights: for the unfused model the plain path
    (``"torch"`` backend), for the fused one both the fused plain path and
    the unfused kernel path. Compared are the prefill logits of each prompt
    alone, then one decode step of all of them together from the kernel
    path's caches, each row at its own position (``decode_core``'s per-row
    lengths). With ``extend_prompt``, also its chunked prefill
    (``lm_prefill`` of the first EXTEND_FIRST tokens, then ``lm_extend`` of
    the rest in chunks of CHUNK at their absolute offsets: ``attention_core``
    at ``q_offset`` over the whole cache depth): the kernel path's last-token
    logits against ``lm_prefill`` of the whole prompt on the same path, and
    against the plain path's chunked prefill. Prints every reading, then
    fails if one is past its limit: F32_ANCHOR times the reference path's
    distance from the plain path run with f32 activations, LOGIT_ATOL at
    the least."""
    from repro_torch.models import lm_decode, lm_extend, lm_prefill

    kernel = ("cuda", fused)
    others = [("torch", fused)] + ([("cuda", False)] if fused else [])
    # the plain path with f32 activations, on the same bf16 weights
    cfg32 = cfg.replace(dtype="float32")

    def run(setting, fn, c=cfg):
        backend, fz = setting
        with nn.backend(backend), nn.fuse(fz):
            return fn(c)

    bad = []

    def check(step, vs, lk, lt, l32, **info):
        check_anchored("serve", step, bad, lk, lt, l32, model=cfg.name,
                       fused=fused, against=f"{vs[0]} fused={vs[1]}", **info)

    rows = []
    for p in prompts:
        toks = torch.tensor([p], device="cuda")

        def prefill(c):
            return lm_prefill(params, toks, c, max_len=max_len)
        lk, caches = run(kernel, prefill)
        l32 = run(("torch", False), prefill, cfg32)[0]
        for vs in others:
            check("prefill_logits", vs, lk, run(vs, prefill)[0], l32,
                  prompt_len=len(p))
        rows.append((lk, caches))
        del l32

    token = torch.cat([lk.argmax(-1) for lk, _ in rows])
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                       device="cuda")
    # every leaf: a ring's "pos" side-car too
    caches = [{n: torch.cat([c[i][n] for _, c in rows]) for n in rows[0][1][i]}
              for i in range(cfg.n_layers)]

    def decode(c):                      # each path writes its own copy
        fresh = [{n: t.to(c.activation_dtype, copy=True) if t.is_floating_point()
                  else t.clone() for n, t in layer.items()}
                 for layer in caches]
        return lm_decode(params, token, pos, fresh, c)[0]

    lk = run(kernel, decode)
    l32 = run(("torch", False), decode, cfg32)
    for vs in others:
        check("decode_logits", vs, lk, run(vs, decode), l32,
              positions=pos.tolist())
    if extend_prompt is not None:
        toks = torch.tensor([extend_prompt], device="cuda")
        starts = list(range(EXTEND_FIRST, len(extend_prompt), CHUNK))

        def chunked(c):
            _, cs = lm_prefill(params, toks[:, :EXTEND_FIRST], c,
                               max_len=max_len)
            for start in starts:
                logits, cs = lm_extend(params, toks[:, start:start + CHUNK],
                                       start, cs, c)
            return logits[:, -1]

        def whole(c):
            return lm_prefill(params, toks, c, max_len=max_len)[0]
        lk = run(kernel, chunked)
        l32 = run(("torch", False), whole, cfg32)
        info = dict(prompt_len=len(extend_prompt), first=EXTEND_FIRST,
                    chunk_starts=starts)
        check("extend_vs_whole_prefill", kernel, lk, run(kernel, whole), l32,
              **info)
        check("extend_logits", ("torch", fused), lk,
              run(("torch", fused), chunked), l32, **info)
    if bad:
        fail(f"serve: {cfg.name} fused={fused} logits past their limits: "
             + "; ".join(bad))


def serve(torch, ops, Engine, params, cfg, prompts, fused: bool,
          max_len: int, step: str = "engine"):
    """One engine run of the path; returns its launch counts and each
    request's tokens, in the order of ``prompts``. Fails unless every
    request finished with its tokens and the path launched exactly its
    kernels, as often as its prefills and decode steps need."""
    engine = Engine(cfg, params, max_batch=4, max_len=max_len, fused=fused)
    ops.reset_launches()
    t0 = time.perf_counter()
    uids = [engine.add_request(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    st = engine.stats
    emit(phase="serve", model=cfg.name, fused=fused, step=step,
         prompt_lens=[len(p) for p in prompts], completed=len(done),
         wall_s=round(wall, 4), tok_per_s=round(st.emitted_tokens / wall, 2),
         decode_tok_per_s=round(st.decode_tok_per_s, 2),
         mean_ttft_s=round(st.mean_ttft_s, 4),
         mean_decode_tok_latency_s=round(st.mean_decode_tok_latency_s, 5),
         prefill_s=round(st.prefill_s, 4), decode_s=round(st.decode_s, 4),
         decode_steps=st.decode_steps, launches=launches)
    if len(done) != len(prompts) or any(len(r.output) != NEW_TOKENS
                                        for r in done):
        fail(f"serve: {len(done)} of {len(prompts)} requests finished, "
             f"lengths {[len(r.output) for r in done]}")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.output):
        fail("serve: a token outside the vocabulary")
    want = {k: 0 for k in launches}
    for per, times in ((per_forward_launches(cfg, fused), len(prompts)),
                       (per_forward_launches(cfg, fused, decode=True),
                        st.decode_steps)):
        for k, n in per.items():
            want[k] += n * times
    if launches != want:
        fail(f"serve: {cfg.name} fused={fused} launched {launches}, its "
             f"{len(prompts)} prefills and {st.decode_steps} decode steps "
             f"need {want}")
    outputs = {r.uid: r.output for r in done}
    return launches, [outputs[u] for u in uids]


def paged_prompts(rng, cfg):
    """Phase ``paged`` (b)'s prompts: (shared, long, long, shared, shared,
    shared), the shared ones a common SHARED_PREFIX and SUFFIX tokens of
    their own, the long ones LONG_PROMPTS[0]..LONG_PROMPTS[1] tokens."""
    def draw(n):
        return [int(t) for t in rng.integers(1, cfg.vocab_size, n)]
    prefix = draw(SHARED_PREFIX)
    shared = [prefix + draw(SUFFIX) for _ in range(4)]
    long = [draw(int(n)) for n in rng.integers(*LONG_PROMPTS, 2, endpoint=True)]
    return [shared[0], *long, *shared[1:]]


def paged(torch, ops, PagedEngine, params, cfg, prompts, want, fused: bool,
          max_len: int, step: str, **engine_kw) -> dict:
    """One PagedEngine run (``max_batch=4``, BLOCK_SIZE-token blocks) of
    ``prompts``; returns its launch counts. Fails unless every request
    finished with NEW_TOKENS tokens, the path launched exactly what its
    cold prefills, extend chunks and decode steps need, and every block came
    back to the allocator or the prefix cache. ``want``: the contiguous
    Engine's tokens for the same prompts in the same run; with
    ``exact`` the paged tokens must equal them (the cold path), otherwise
    the number that do is printed (a bf16 chunk may move an argmax at a
    near-tie)."""
    exact = engine_kw.pop("exact")
    engine = PagedEngine(cfg, params, max_batch=4, max_len=max_len,
                         block_size=BLOCK_SIZE, fused=fused, **engine_kw)
    ops.reset_launches()
    t0 = time.perf_counter()
    uids = [engine.add_request(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in ops.launches.items() if v}
    st, alloc, pc = engine.stats, engine.allocator, engine.prefix_cache
    outputs = {r.uid: r.output for r in done}
    got = [outputs.get(u, []) for u in uids]
    same = sum(g == w for g, w in zip(got, want))
    emit(phase="paged", model=cfg.name, fused=fused, step=step,
         prompt_lens=[len(p) for p in prompts], completed=len(done),
         wall_s=round(wall, 4), tok_per_s=round(st.emitted_tokens / wall, 2),
         decode_tok_per_s=round(st.decode_tok_per_s, 2),
         mean_ttft_s=round(st.mean_ttft_s, 4),
         mean_decode_tok_latency_s=round(st.mean_decode_tok_latency_s, 5),
         prefill_s=round(st.prefill_s, 4), decode_s=round(st.decode_s, 4),
         decode_steps=st.decode_steps, cold_prefills=engine.cold_prefills,
         extend_chunks=engine.extend_chunks,
         prefix_hits=0 if pc is None else pc.hits,
         hit_rate=0.0 if pc is None else round(pc.hit_rate, 4),
         num_blocks=alloc.num_blocks, free_blocks=alloc.free_blocks,
         cached_blocks=0 if pc is None else len(pc),
         tokens_equal_contiguous=f"{same} of {len(prompts)}",
         first_differing_token=[next((i for i, (a, b) in enumerate(zip(g, w))
                                      if a != b), None)
                                for g, w in zip(got, want)],
         launches=launches)
    if len(done) != len(prompts) or any(len(o) != NEW_TOKENS for o in got):
        fail(f"paged: {cfg.name} {step}: {len(done)} of {len(prompts)} "
             f"requests finished, lengths {[len(o) for o in got]}")
    if exact and got != want:
        fail(f"paged: {cfg.name} fused={fused} {step}: the tokens of "
             f"{len(prompts) - same} requests differ from the contiguous "
             "Engine's")
    need = {}
    for per, times in ((per_forward_launches(cfg, fused), engine.cold_prefills),
                       (per_forward_launches(cfg, fused, extend=True),
                        engine.extend_chunks),
                       (per_forward_launches(cfg, fused, decode=True),
                        st.decode_steps)):
        for k, n in per.items():
            need[k] = need.get(k, 0) + n * times
    need = {k: v for k, v in need.items() if v}
    if launches != need:
        fail(f"paged: {cfg.name} fused={fused} {step} launched {launches}; "
             f"{engine.cold_prefills} cold prefills, {engine.extend_chunks} "
             f"chunks and {st.decode_steps} decode steps need {need}")
    if alloc.free_blocks + (0 if pc is None else len(pc)) != alloc.num_blocks - 1:
        fail(f"paged: {cfg.name} {step}: {alloc.free_blocks} blocks free and "
             f"{0 if pc is None else len(pc)} cached of {alloc.num_blocks - 1}")
    if pc is not None and not pc.hit_rate > 0:
        fail(f"paged: {cfg.name} {step}: no prefix-cache hit")
    return launches


# ---------------------------------------------------------------------------
# phase 4: profile
# ---------------------------------------------------------------------------

def profile(torch, nn, ops, params, cfg, fused: bool, rng, seq: int = 16):
    """Measured split of one eager ``lm_forward`` (b1, ``seq`` tokens) on
    the kernel path, beside its un-instrumented wall time; checks one
    forward's launches against the path's table on the way."""
    from repro_torch.models import lm_forward

    ptoks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, seq))).cuda()
    name = f"{cfg.name} {'fused' if fused else 'unfused'} b-1 s-{seq} bf16"
    prof, wall_ms, per = measured(torch, nn, ops, lm_forward,
                                  (params, ptoks, cfg), name, fused)
    want = per_forward_launches(cfg, fused)
    if per != want:
        fail(f"profile: {name}: launched {per} per forward, expected {want}")
    emit_profile("profile", prof, wall_ms, per)


def qdq_share(prof) -> dict:
    """Device ms and share of the QDQ ops of a profile: the quantization
    group (quantize, dequantize) and, under fusion, the ``fused_qdq`` site,
    to which fusion moves the same launches."""
    fused_qdq = prof.op_seconds.get(("fused", "fused_qdq"), 0.0)
    quant = prof.group_seconds.get("quantization", 0.0)
    t = quant + fused_qdq
    return dict(qdq_ms=round(t * 1e3, 4),
                qdq_frac=round(t / prof.total_seconds, 4),
                quantization_group_frac=round(quant / prof.total_seconds, 4),
                fused_qdq_ms=round(fused_qdq * 1e3, 4))


def check_anchored(phase, what, bad, got, vs, anchor, **info):
    """The anchored logit rule (PERF.md §2): ``got`` may lie at most
    F32_ANCHOR times the reference path ``vs``'s distance from the
    f32-activation run ``anchor`` from ``vs``, LOGIT_ATOL at the least.
    Prints the reading; appends a failure to ``bad``."""
    diff, ref_vs_anchor = _max_diff(got, vs), _max_diff(vs, anchor)
    lim = max(LOGIT_ATOL, F32_ANCHOR * ref_vs_anchor)
    emit(phase=phase, check=what, max_abs_diff=diff,
         mean_abs_diff=float((got.float() - vs.float()).abs().mean()),
         kernel_vs_f32=_max_diff(got, anchor), against_vs_f32=ref_vs_anchor,
         atol=lim, max_abs_logit=float(vs.float().abs().max()),
         same_argmax=bool((got.argmax(-1) == vs.argmax(-1)).all()),
         finite=bool(got.float().isfinite().all()), **info)
    if not (math.isfinite(diff) and diff <= lim):
        bad.append(f"{what} {info}: {diff} (limit {lim})")


def qdq(torch, nn, ops, fwd, args32, args, per_forward, name, launches,
        paths_only: bool = False):
    """Phase ``qdq`` for one model: ``fwd(*args)`` (``args32``: the same
    with f32 activations) under ``nn.fake_quant("int8")`` on the kernel
    path against the plain path, fused against unfused, under the anchored
    logit rule; then (not with ``paths_only``) the measured 2x2 of
    QDQ_VARIANTS. ``per_forward(fused)``: the kernel launches of one
    forward, which QDQ does not change."""
    out = {}
    with nn.fake_quant("int8"):
        for backend, fused in (("cuda", False), ("torch", False),
                               ("cuda", True)):
            ops.reset_launches()
            with nn.backend(backend), nn.fuse(fused):
                out[backend, fused] = fwd(*args)
            torch.cuda.synchronize()
            got = {k: v for k, v in ops.launches.items() if v}
            want = per_forward(fused) if backend == "cuda" else {}
            if got != want:
                fail(f"qdq: {name} {backend} fused={fused} launched {got}, "
                     f"expected {want}")
            for k, n in got.items():
                launches[k] += n
        with nn.backend("torch"), nn.fuse(False):
            l32 = fwd(*args32)
    bad = []
    plain, unfused = out["torch", False], out["cuda", False]
    check_anchored("qdq", "int8-qdq kernel vs plain", bad, unfused, plain,
                   l32, model=name)
    check_anchored("qdq", "int8-qdq+fused vs int8-qdq", bad, out["cuda", True],
                   unfused, l32, model=name)
    if bad:
        fail(f"qdq: {name} logits past their limits: " + "; ".join(bad))
    if paths_only:
        return
    for label, mode, fused in QDQ_VARIANTS:
        with nn.fake_quant(mode):
            prof, wall, per = measured(torch, nn, ops, fwd, args,
                                       f"{name} {label}", fused)
        if per != per_forward(fused):
            fail(f"qdq: {name} {label} launched {per} per forward")
        share = qdq_share(prof)
        emit_profile("qdq", prof, wall, per, variant=label, **share)
        if (share["qdq_ms"] > 0) != (mode is not None):
            fail(f"qdq: {name} {label}: QDQ time {share['qdq_ms']} ms")


def emit_profile(phase, prof, wall_ms, per_forward, **info):
    """One JSON line of a measured profile beside its eager wall time."""
    split = prof.split
    emit(phase=phase, model=prof.name, mode=prof.mode, n_ops=prof.n_ops,
         launches_per_forward=per_forward,
         device_ms=round(prof.total_seconds * 1e3, 4),
         eager_wall_ms=round(wall_ms, 4),
         device_busy_frac=round(prof.total_seconds * 1e3 / wall_ms, 4),
         gemm_ms=round(split["gemm_s"] * 1e3, 4),
         nongemm_ms=round(split["nongemm_s"] * 1e3, 4),
         gemm_frac=round(split["gemm_frac"], 4),
         nongemm_frac=round(split["nongemm_frac"], 4),
         group_ms={g: round(t * 1e3, 4) for g, t in
                   sorted(prof.group_seconds.items(), key=lambda kv: -kv[1])},
         group_frac={g: round(t / prof.total_seconds, 4) for g, t in
                     sorted(prof.group_seconds.items(), key=lambda kv: -kv[1])},
         top_nongemm_groups=[[g, round(t * 1e3, 4), round(p, 2)]
                             for g, t, p in prof.top_nongemm_groups(5)],
         top_op_sites=[[f"{g}:{s}", round(t * 1e3, 4), round(p, 2)]
                       for (g, s), t, p in prof.top_op_sites(10)],
         top_site_ops=_top_site_ops(prof, 15), **info)
    if prof.mode != "measured_cuda" or not split["gemm_s"] > 0:
        fail(f"{phase}: {prof.name}: no device time measured")


def measured(torch, nn, ops, fn, args, name, fused, n_warm=6):
    """(profile, median eager wall ms, launches per call) of ``fn(*args)``
    on the kernel path: ``n_warm`` timed calls on the host clock (the first,
    which warms cuBLAS, left out of the median), then the per-op profile."""
    from repro_torch.core import profile_measured

    walls = []
    ops.reset_launches()
    with nn.fuse(fused):
        for _ in range(n_warm):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        per = {k: v // n_warm for k, v in ops.launches.items() if v}
        prof = profile_measured(fn, *args, name=name, repeats=3)
    return prof, statistics.median(walls[1:]) * 1e3, per


def _max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _set_distance(a, b) -> float:
    """Largest Hausdorff distance between the value sets of matching rows
    of ``a`` and ``b`` (B, K): how far a value of one row lies from the
    nearest value of the other."""
    d = (a.float()[:, :, None] - b.float()[:, None, :]).abs()
    return max(float(d.amin(2).amax()), float(d.amin(1).amax()))


def encoder_launches(cfg, fused: bool, extra_full: int = 0) -> dict:
    """Kernel launches of one encoder forward on the kernel path: the
    LayerNorm blocks' norms, ``attention_full`` per layer (and once more
    for the detector's refinement)."""
    per = per_forward_launches(cfg, fused)
    per["attention_full"] += extra_full
    return per


def encode(torch, nn, ops, init_lm, lm_forward, arch, cases, launches,
           paths_only: bool = False):
    """Phase ``encode``: an encoder at full width and depth in bf16, unfused
    and fused, through ``lm_forward`` at each (batch, seq) case; then (not
    with ``paths_only``) the measured profile of the first case."""
    from repro_torch.configs import get_config

    cfg = get_config(arch).replace(dtype="bfloat16", param_dtype="bfloat16")
    gen = torch.Generator("cuda").manual_seed(SEED)
    params = init_lm(gen, cfg)
    emit(phase="encode", step="init", config=cfg.name,
         n_params=sum(t.numel() for t in _leaves(params)))

    def inputs(b, s):
        if cfg.input_mode == "tokens":
            return torch.randint(1, cfg.vocab_size, (b, s), generator=gen,
                                 device="cuda")
        return torch.randn((b, s, cfg.d_model), generator=gen,
                           device="cuda").to(torch.bfloat16)

    bad = []
    for b, s in cases:
        x = inputs(b, s)
        out = {}
        for backend, fused in (("cuda", False), ("torch", False),
                               ("cuda", True), ("torch", True)):
            ops.reset_launches()
            with nn.backend(backend), nn.fuse(fused):
                out[backend, fused] = lm_forward(params, x, cfg)
            torch.cuda.synchronize()
            got = {k: v for k, v in ops.launches.items() if v}
            want = encoder_launches(cfg, fused) if backend == "cuda" else {}
            if got != want:
                fail(f"encode: {arch} b{b} s{s} {backend} fused={fused} "
                     f"launched {got}, expected {want}")
            if backend == "cuda":
                for k, n in got.items():
                    launches[k] += n
        for (got, vs), label in (((("cuda", False), ("torch", False)), "plain"),
                                 ((("cuda", True), ("torch", True)), "plain"),
                                 ((("cuda", True), ("cuda", False)), "unfused")):
            diff = _max_diff(out[got], out[vs])
            emit(phase="encode", model=arch, batch=b, seq=s, fused=got[1],
                 against=f"{label} ({vs[0]} fused={vs[1]})",
                 max_abs_diff=diff,
                 max_abs_logit=float(out[vs].float().abs().max()),
                 atol=ENCODE_ATOL, shape=list(out[got].shape),
                 finite=bool(torch.isfinite(out[got].float()).all()))
            if not (math.isfinite(diff) and diff <= ENCODE_ATOL):
                bad.append(f"{arch} b{b} s{s} {got} vs {vs}: {diff}")
    if bad:
        fail("encode: outputs past their limit: " + "; ".join(bad))
    if paths_only:
        return
    b, s = cases[0]
    x = inputs(b, s)
    for fused in (False, True):
        name = f"{arch} {'fused' if fused else 'unfused'} b-{b} s-{s} bf16"
        prof, wall, per = measured(torch, nn, ops, lm_forward,
                                   (params, x, cfg), name, fused)
        if per != encoder_launches(cfg, fused):
            fail(f"encode: {name}: launched {per} per forward")
        emit_profile("encode", prof, wall, per)


def vision(torch, nn, ops, arch, launches, paths_only: bool = False):
    """Phase ``vision``: the classifier or the detector at full width and
    depth in bf16, unfused and fused, through ``vision_forward`` (with
    ``paths_only``, only the comparisons of the paths). Returns the
    detector kernel path's first image: its score-sorted top-K boxes, their
    validity and the IoU threshold (phase 5 times the NMS kernel on them)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.models.vision import (init_vision, vision_backbone,
                                           vision_forward)

    cfg = get_config(arch).replace(dtype="bfloat16", param_dtype="bfloat16")
    gen = torch.Generator("cuda").manual_seed(SEED)
    params = init_vision(gen, cfg)
    size = cfg.image_size
    emit(phase="vision", step="init", config=cfg.name,
         n_params=sum(t.numel() for t in _leaves(params)), image_size=size)
    imgs = torch.randn((VISION_BATCH, cfg.n_channels, size, size),
                       generator=gen, device="cuda")
    det = cfg.is_detector

    def per_forward(fused, b):
        per = encoder_launches(cfg, fused, extra_full=int(det))
        if det:
            per["nms"] = b
        return per

    bad, nms_inputs = [], None

    def check(what, diff, atol, **info):
        emit(phase="vision", model=arch, check=what, max_abs_diff=diff,
             atol=atol, **info)
        if not (math.isfinite(diff) and diff <= atol):
            bad.append(f"{arch} {what}: {diff}")

    for fused in (False, True):
        # throughput: batch 1 and batch 8 on the host clock
        rates = {}
        for b in () if paths_only else (1, VISION_BATCH):
            x = imgs[:b]
            with nn.fuse(fused):
                vision_forward(params, x, cfg)          # warm
                ops.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(VISION_FORWARDS):
                    vision_forward(params, x, cfg)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {k: v for k, v in ops.launches.items() if v}
            want = {k: n * VISION_FORWARDS for k, n in per_forward(fused, b).items()}
            if got != want:
                fail(f"vision: {arch} b{b} fused={fused} launched {got}, "
                     f"expected {want}")
            for k, n in got.items():
                launches[k] += n
            rates[b] = dict(images_per_s=b * VISION_FORWARDS / wall,
                            ms_per_forward=wall / VISION_FORWARDS * 1e3)
        if rates:
            emit(phase="vision", model=arch, fused=fused, step="throughput",
                 forwards=VISION_FORWARDS,
                 **{f"b{b}": r for b, r in rates.items()})

        # the kernel path against the plain path (and the unfused one)
        x = imgs
        with nn.fuse(fused):
            kern = vision_forward(params, x, cfg)
            with nn.backend("torch"):
                plain = vision_forward(params, x, cfg)
        with nn.fuse(False):
            unfused = vision_forward(params, x, cfg)
        if not det:
            check("logits", _max_diff(kern, plain), ENCODE_ATOL, fused=fused,
                  against="plain", shape=list(kern.shape),
                  max_abs_logit=float(plain.float().abs().max()),
                  finite=bool(torch.isfinite(kern.float()).all()))
            if fused:
                check("logits", _max_diff(kern, unfused), ENCODE_ATOL,
                      fused=fused, against="unfused")
            continue
        with nn.fuse(fused):
            hk = vision_backbone(params, x, cfg)[0]
            with nn.backend("torch"):
                hp = vision_backbone(params, x, cfg)[0]
        check("backbone_features", _max_diff(hk, hp), ENCODE_ATOL,
              fused=fused, against="plain", shape=list(hk.shape),
              max_abs=float(hp.float().abs().max()))
        (boxes, scores, keep), (_, pscores, pkeep) = kern, plain
        # Near-tied bf16 scores may swap places between the paths, so the
        # boxes are not compared row by row across them. Nor are the sorted
        # scores place by place: two neighbouring cells whose scores tie in
        # bf16 both pass the 3x3 peak test in one path and one of them not
        # in the other, which shifts the sorted list by a place (a shift
        # at the last nonzero score reads ~0.9). The scores are held as
        # value sets, and NMS to the plain NMS on the kernel path's boxes.
        check("top_scores", _set_distance(scores, pscores), SCORE_ATOL,
              measure="value-set distance", fused=fused, against="plain",
              shape=list(scores.shape),
              sorted_max_abs_diff=_max_diff(scores, pscores),
              nonzero=(scores > 0).sum(-1).tolist(),
              plain_nonzero=(pscores > 0).sum(-1).tolist(),
              kept=int(keep.sum()), plain_kept=int(pkeep.sum()),
              finite=bool(torch.isfinite(boxes.float()).all()))
        if fused:
            check("top_scores", _set_distance(scores, unfused[1]),
                  SCORE_ATOL, measure="value-set distance", fused=fused,
                  against="unfused",
                  sorted_max_abs_diff=_max_diff(scores, unfused[1]))
        for i in range(x.shape[0]):
            want = ref.nms(boxes[i].float(), scores[i], cfg.det_iou_threshold,
                           cfg.det_score_threshold)
            if not torch.equal(keep[i], want):
                fail(f"vision: {arch} image {i}: the NMS kernel's keep mask "
                     "differs from the plain NMS on the same boxes")
        emit(phase="vision", model=arch, fused=fused, check="nms_keep",
             images=x.shape[0], identical=True,
             kept_per_image=keep.sum(-1).tolist())
        if nms_inputs is None:
            order = ref.nms_order(scores[0])
            nms_inputs = (boxes[0].float()[order].contiguous(),
                          scores[0][order] > cfg.det_score_threshold,
                          cfg.det_iou_threshold)
    if bad:
        fail("vision: outputs past their limit: " + "; ".join(bad))

    for fused in () if paths_only else (False, True):
        name = f"{arch} {'fused' if fused else 'unfused'} b-1 {size}px bf16"
        prof, wall, per = measured(torch, nn, ops, vision_forward,
                                   (params, imgs[:1], cfg), name, fused)
        if per != per_forward(fused, 1):
            fail(f"vision: {name}: launched {per} per forward")
        g = prof.group_seconds
        pool_other = sorted({t.record.prim for t in prof.timed_ops
                             if t.record.group.value == "other"})
        emit_profile("vision", prof, wall, per, other_ops=pool_other)
        if any("pool" in p for p in pool_other):
            fail(f"vision: {name}: pooling classed OTHER: {pool_other}")
        need = ("roi", "interpolation", "reduction") if det else ("reduction",)
        if not all(g.get(k, 0) > 0 for k in need):
            fail(f"vision: {name}: no device time in {need}: {g}")
    return nms_inputs


def qdq_vision(torch, nn, ops, launches, paths_only: bool = False):
    """Phase ``qdq`` for vit-b16-cls at b1 (224 px): the patch ``conv2d``
    and every ``linear`` under ``nn.fake_quant("int8")``, as for the
    served models."""
    from repro_torch.configs import get_config
    from repro_torch.models.vision import init_vision, vision_forward

    cfg = get_config("vit-b16-cls").replace(dtype="bfloat16",
                                            param_dtype="bfloat16")
    gen = torch.Generator("cuda").manual_seed(SEED)
    params = init_vision(gen, cfg)
    imgs = torch.randn((1, cfg.n_channels, cfg.image_size, cfg.image_size),
                       generator=gen, device="cuda")
    qdq(torch, nn, ops, vision_forward,
        (params, imgs, cfg.replace(dtype="float32")), (params, imgs, cfg),
        lambda fused: encoder_launches(cfg, fused),
        f"vit-b16-cls b-1 {cfg.image_size}px bf16", launches, paths_only)


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths-only", action="store_true",
                    help="phase 1, then only the model-level comparisons of "
                         "the kernel paths with the plain and unfused paths; "
                         "prints their readings and no result line")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2

    from repro_torch import nn
    from repro_torch.configs import get_config
    from repro_torch.core import graph
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.models import init_lm, lm_forward
    from repro_torch.serving import Engine, PagedEngine

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: device ---------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[torch.cuda.current_device()]
    print(smi, flush=True)
    t0 = time.perf_counter()
    logs = _build.build()
    emit(phase="device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         built=sorted(logs), build_s=round(time.perf_counter() - t0, 3))

    # -- phase 2: kernels --------------------------------------------------
    gen = torch.Generator("cuda").manual_seed(SEED)
    if not args.paths_only:
        worst = check_kernels(torch, ops, ref, gen)

    # -- phases 3 and 4, one model at a time -------------------------------
    launches = dict.fromkeys(SOURCES, 0)
    nms_inputs = None
    decode_lengths = {}
    for arch in ARCHS:
        cfg = get_config(arch).replace(dtype="bfloat16", param_dtype="bfloat16")
        t0 = time.perf_counter()
        params = init_lm(torch.Generator("cuda").manual_seed(SEED), cfg)
        torch.cuda.synchronize()
        emit(phase="serve", step="init", config=cfg.name,
             n_params=sum(t.numel() for t in _leaves(params)),
             init_s=round(time.perf_counter() - t0, 3),
             mem_gb=round(torch.cuda.memory_allocated() / 1e9, 3))
        rng = np.random.default_rng(SEED)
        max_len, plens = SERVE[arch]
        plens = plens or [int(n) for n in rng.integers(5, 201, 6)]
        prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
                   for n in plens]
        extend_prompt = chunked_set = None
        if arch in PAGED_ARCHS:        # drawn apart: rng's later draws stay
            prng = np.random.default_rng(SEED + 1)
            extend_prompt = [int(t) for t in prng.integers(
                1, cfg.vocab_size, EXTEND_PROMPT)]
            chunked_set = paged_prompts(prng, cfg)
        for fused in (False, True):
            if not args.paths_only:
                runs, tokens = serve(torch, ops, Engine, params, cfg, prompts,
                                     fused, max_len)
                runs = [runs]
                if arch in PAGED_ARCHS:
                    # phase paged: (a) cold, tokens equal to the Engine's;
                    # (b) chunked prefill and prefix-cache hits, beside the
                    # Engine's tokens for the same prompts
                    runs.append(paged(torch, ops, PagedEngine, params, cfg,
                                      prompts, tokens, fused, max_len, "cold",
                                      prefix_caching=False, chunk_size=None,
                                      exact=True))
                    more, want = serve(torch, ops, Engine, params, cfg,
                                       chunked_set, fused, max_len,
                                       step="engine, the chunked run's prompts")
                    runs.append(more)
                    runs.append(paged(torch, ops, PagedEngine, params, cfg,
                                      chunked_set, want, fused, max_len,
                                      "chunked+cached", prefix_caching=True,
                                      chunk_size=CHUNK, exact=False))
                for run_launches in runs:
                    for k, n in run_launches.items():
                        launches[k] += n
            compare_paths(torch, nn, params, cfg, prompts[:4], fused, max_len,
                          extend_prompt)
        if not args.paths_only:
            for seq, fused in PROFILES.get(arch, ((16, False), (16, True))):
                profile(torch, nn, ops, params, cfg, fused, rng, seq)
        if arch in QDQ_ARCHS:
            toks = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                                 (1, 16))).cuda()
            qdq(torch, nn, ops, lm_forward,
                (params, toks, cfg.replace(dtype="float32")),
                (params, toks, cfg),
                lambda fused, c=cfg: per_forward_launches(c, fused),
                f"{arch} b-1 s-16 bf16", launches, args.paths_only)
        # the last step of the 4 slots serving the first 4 requests, cut off
        # at their 16th token
        decode_lengths[arch] = [n + NEW_TOKENS - 1 for n in plens[:4]]
        del params
        gc.collect()
        torch.cuda.empty_cache()

    # -- phase encode: bert-base and the vit-b16 stub -----------------------
    for arch, cases in ENCODERS:
        encode(torch, nn, ops, init_lm, lm_forward, arch, cases, launches,
               args.paths_only)
        gc.collect()
        torch.cuda.empty_cache()

    # -- phase vision: vit-b16-cls and detector-vit-s -----------------------
    for arch in VISION:
        nms_inputs = vision(torch, nn, ops, arch, launches,
                            args.paths_only) or nms_inputs
    qdq_vision(torch, nn, ops, launches, args.paths_only)
    if args.paths_only:
        return 0

    # -- phase micro: the Table-2 suite, f32 ----------------------------------
    from repro_torch.core.microbench import run_suite
    ops.reset_launches()
    rows = run_suite(repeats=20)
    for r in rows:
        emit(phase="micro", **dataclasses.asdict(r))
        if not (r.device == "cuda" and r.device_us > 0 and r.eager_us > 0):
            fail(f"micro: {r.name}: no device time measured ({r})")
    for k, n in ops.launches.items():
        launches[k] += n

    # -- phase kernel_sites: the §4.5 table -----------------------------------
    from repro_torch.bench.sections import section_kernels
    ops.reset_launches()
    sites = section_kernels("cuda")
    for row in sites:
        emit(phase="kernel_sites", **row)
    for k, n in ops.launches.items():
        launches[k] += n
    if len(sites) != 6 or not all(r["allclose"] for r in sites):
        fail(f"kernel_sites: a kernel disagrees with its plain version: {sites}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"kernels never launched on the main paths: {missing}")

    # -- phase 5: timing ---------------------------------------------------
    timing = time_kernels(torch, ops, ref, gen, decode_lengths, graph,
                          nms_inputs)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        tm = timing[name]
        b_ms, b_by = tm["bound"]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst[name], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": tm["library_ms"], "eager_ms": tm["eager_ms"],
            "shape": tm["shape"], **{k: tm[k] for k in ("body", "plan", "mul_ms",
                                                         "amax_ms")
                                     if k in tm}})
    emit(phase="done", seconds=round(time.perf_counter() - t_start, 2))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _top_site_ops(prof, k: int) -> list:
    """[site:op, ms, calls] of the costliest (op site, aten op) pairs."""
    ms, calls = {}, {}
    for t in prof.timed_ops:
        key = f"{t.record.op_site}:{t.record.prim}"
        ms[key] = ms.get(key, 0.0) + t.seconds * 1e3
        calls[key] = calls.get(key, 0) + 1
    top = sorted(ms, key=ms.get, reverse=True)[:k]
    return [[key, round(ms[key], 4), calls[key]] for key in top]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
