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
             (llama2-7b; gpt2-xl's 25 heads of 64; gemma3-27b's 2048-token
             window prefill over 16 KV heads, its GeGLU rows and its
             qk-norm; the encoders' and the detector's full-mask attention;
             the detector's NMS; the Table-2 dequant row; the §4.5
             cross-entropy site and gemma3's 262144-token vocabulary) and
             odd ones (attention head dims 34, 48, 80, 96, Sq = 1, a causal
             q_offset with Sq < Skv; decode over 4096 keys in 64 splits and
             lengths on and one past a split boundary); NMS keep masks and
             the dequant kernel's ``r`` must be identical;
3. serve   - for each of llama2-7b, gpt2-xl and gemma3-27b at full width
             and depth in bf16 (random weights from a seeded generator on
             the card), the continuous-batching ``Engine`` unfused and fused
             (``Engine(fused=True)``: ``nn.fuse()``) serves 6 requests of 16
             new tokens (gemma3-27b's prompts cross its 1024-token window in
             prefill and wrap its rings in decode); checks the outputs and
             that each path launched exactly its kernels, as many times as
             its forwards need; then holds the kernel path's prefill logits
             and one decode step's logits against the plain path's, and the
             fused path's against the unfused path's (``--paths-only`` runs
             only these comparisons, to read what they see of a kernel
             broken on purpose);
4. profile - a per-op measured profile of ``lm_forward`` (batch 1, seq 16)
             on the kernel path, unfused and fused, for the three models,
             and gemma3-27b unfused at seq 2048, where its window bites: the
             measured GEMM / NonGEMM split;
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
             (``mma bf16`` on the tensor cores, ``fma f32``).

The line before the last is the per-kernel JSON record, the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before that line is printed.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
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
ARCHS = ("llama2-7b", "gpt2-xl", "gemma3-27b")
#: the served models' engine depth and prompt lengths. gemma3-27b's: two
#: past its 1024-token window (right-padded to the 2048 bucket, the rings
#: fill from the true tail), one of 1015 whose decode wraps its rings at
#: 1024, one short; compare_paths takes the first four
SERVE = {"llama2-7b": (512, None), "gpt2-xl": (512, None),
         "gemma3-27b": (2048, (1500, 1100, 1015, 37, 600, 250))}
#: (batch, seq) of the measured profiles of each served model
PROFILES = {"gemma3-27b": ((16, False), (16, True), (2048, False))}
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


def per_forward_launches(cfg, fused: bool, decode: bool = False) -> dict:
    """Kernel launches of one forward on the kernel path: a prefill (or
    ``lm_forward``) runs ``attention_core`` in each global layer and
    ``attention_window`` in each local one (an encoder ``attention_full``),
    a decode step ``decode_core`` in every layer. RMSNorm models launch one
    norm per pre-norm, post-norm and q/k-norm and the final one, of which
    fusion folds one a layer into ``fused_add_rms_norm``; unfused GeGLU is
    the plain op chain, as in the JAX package."""
    n = cfg.n_layers
    n_local = cfg.layer_kinds().count("local")
    if decode:
        out = {"decode_core": n}
    elif not cfg.causal:
        out = {"attention_full": n}
    else:
        out = {"attention_core": n - n_local, "attention_window": n_local}
    if cfg.norm == "rmsnorm":
        per_layer = 2 + 2 * cfg.post_norm + 2 * cfg.qk_norm
        out["rms_norm"] = n * (per_layer - fused) + 1
        if cfg.ffn == "swiglu" or (fused and cfg.ffn == "geglu"):
            out[cfg.ffn] = n
        if fused:
            out.update(fused_add_rms_norm=n, rope=2 * n)
    else:
        out["layer_norm"] = n + 1 if fused else 2 * n + 1
        if fused:
            out["fused_add_layer_norm"] = n
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

def check_kernels(torch, ops, ref, gen):
    """Every kernel vs its plain version at the main path's shapes and odd
    ones, bf16 and f32. Returns {kernel: max abs error over its cases}."""
    from repro_torch.kernels import attn_template

    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def split_chunk(b, hkv, t):
        """Keys per split of decode_core's plan on this card."""
        return attn_template.decode_chunk(
            t, attn_template.decode_splits(b, hkv, t, sms))

    def randn(shape, dt, scale=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                + mean).to(dt)

    def compare(name, got, want, dtname, case, tol=TOL, rms_scaled=False):
        """``rms_scaled``: atol times the plain output's RMS where that is
        below 1 (the window fragment's cases, see the note at TOL)."""
        torch.cuda.synchronize()
        atol, rtol = tol[dtname]
        err = (got.float() - want.float()).abs()
        info = {}
        if rms_scaled:
            rms = float(want.float().square().mean().sqrt())
            atol *= min(1.0, rms)
            info = dict(plain_rms=rms, max_abs_err_over_rms=float(err.max()) / rms)
        lim = atol + rtol * want.float().abs()
        ok = bool((err <= lim).all()) and bool(torch.isfinite(got.float()).all())
        emit(phase="kernels", kernel=name, case=case, dtype=dtname,
             max_abs_err=float(err.max()), atol=atol, rtol=rtol, ok=ok, **info)
        if not ok:
            fail(f"{name} {case} {dtname}: kernel disagrees with plain version")
        worst[name] = max(worst[name], float(err.max()))

    def exact(name, got, want, dtname, case):
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        emit(phase="kernels", kernel=name, case=case, dtype=dtname,
             residual_bit_identical=same)
        if not same:
            fail(f"{name} {case} {dtname}: r = x + res differs from the plain "
                 "version's (one f32 add, rounded once, on both sides)")

    worst = dict.fromkeys(SOURCES, 0.0)
    for dtname, dt in dts.items():
        # gemma3-27b's zero-centred norms (5376) and its qk-norm (128, off)
        for shape, zc in [((4, 1, 4096), False), ((1, 256, 4096), False),
                          ((2, 33, 257), False), ((3, 7, 1000), True),
                          ((4, 1, 5376), True), ((1, 37, 32, 128), False)]:
            x, w = randn(shape, dt), randn(shape[-1:], dt)
            compare("rms_norm", ops.rms_norm(x, w, zero_centered=zc),
                    ref.rms_norm(x, w, zero_centered=zc), dtname,
                    f"x{list(shape)} zero_centered={zc}")
            res = randn(shape, dt, 4.0)
            (y, r), (wy, wr) = (f.fused_add_rms_norm(x, res, w, zero_centered=zc)
                                for f in (ops, ref))
            case = f"x,res{list(shape)} zero_centered={zc}"
            compare("fused_add_rms_norm", y, wy, dtname, case)
            exact("fused_add_rms_norm", r, wr, dtname, case)
        # gpt2-xl's width; a row whose mean is far from zero (1e3 + N(0,1))
        for shape, mean in [((4, 1, 1600), 0.0), ((1, 256, 1600), 3.0),
                            ((2, 33, 257), 0.0), ((3, 7, 1000), 0.0),
                            ((2, 1600), 1e3)]:
            x = randn(shape, dt, mean=mean)
            w, b = randn(shape[-1:], dt), randn(shape[-1:], dt)
            tol = LARGE_MEAN_TOL if mean > 100 else TOL
            case = f"x{list(shape)} mean={mean}"
            compare("layer_norm", ops.layer_norm(x, w, b),
                    ref.layer_norm(x, w, b), dtname, case, tol)
            res = randn(shape, dt, 4.0)
            (y, r), (wy, wr) = (f.fused_add_layer_norm(x, res, w, b)
                                for f in (ops, ref))
            compare("fused_add_layer_norm", y, wy, dtname, case, tol)
            exact("fused_add_layer_norm", r, wr, dtname, case)
        # (B, S, H, D, fraction, first position): llama decode and prefill,
        # partial rotary at 25 heads of 64, an odd head dim at 4091+, and
        # half 48, where -i / half and -i * (1 / half) differ in f32
        for b, s, h, d, frac, p0 in [(4, 1, 32, 128, 1.0, 186),
                                     (1, 256, 32, 128, 1.0, 0),
                                     (2, 7, 25, 64, 0.25, 500),
                                     (1, 5, 3, 34, 1.0, 4091),
                                     (1, 5, 3, 96, 1.0, 4091)]:
            x = randn((b, s, h, d), dt)
            pos = (p0 + torch.arange(s, dtype=torch.int32, device="cuda")
                   )[None].expand(b, s)
            compare("rope", ops.rope(x, pos, fraction=frac),
                    ref.rope(x, pos, fraction=frac), dtname,
                    f"x{[b, s, h, d]} fraction={frac} positions {p0}..{p0 + s - 1}")
        for shape in [(4, 1, 11008), (1, 256, 11008), (2, 37, 257), (1, 13)]:
            g, u = randn(shape, dt, 3.0), randn(shape, dt)
            compare("swiglu", ops.swiglu(g, u), ref.swiglu(g, u), dtname,
                    f"{list(shape)}")
        # gemma3-27b's decode rows and a prefill; no multiple of 8, a tail of 1
        for shape in [(4, 1, 21504), (1, 256, 21504), (2, 37, 257), (1, 17),
                      (1, 1)]:
            g, u = randn(shape, dt, 3.0), randn(shape, dt)
            compare("geglu", ops.geglu(g, u), ref.geglu(g, u), dtname,
                    f"{list(shape)}")
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
                (1, 100, 300, 8, 4, 128, 128, 200)]:  # q_offset, Sq < Skv
            q = randn((b, sq, hq, dk), dt)
            k, v = randn((b, skv, hkv, dk), dt), randn((b, skv, hkv, dv), dt)
            compare("attention_core", ops.attention_core(q, k, v, q_offset=off),
                    ref.attention(q, k, v, q_offset=off), dtname,
                    f"q{[b, sq, hq, dk]} kv{[b, skv, hkv]} dv={dv} q_offset={off}")
        # the split over the cache: chunk C of this card's plan for one
        # row of one KV head over 4096 keys (the most splits) and for
        # gemma3's rings; lengths on a split boundary and one past it
        c1 = split_chunk(1, 1, 4096)
        c4 = split_chunk(4, 16, 1024)
        for b, t, hq, hkv, dk, dv, lens in [
                (4, 512, 32, 32, 128, 128, [1, 200, 512, 0]),   # llama, a dead slot
                (4, 512, 25, 25, 64, 64, [186, 512, 0, 72]),    # gpt2-xl
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
                compare("dequant_add_rms_norm", y, wy, dtname, case)
                exact("dequant_add_rms_norm", r, wr, dtname, case)
                if dt == torch.bfloat16:
                    frac = float((y != wy).float().mean())
                    emit(phase="kernels", kernel="dequant_add_rms_norm",
                         case=case, dtype=dtname, y_bits_differ_frac=frac,
                         limit=Y_BITS_DIFFER_MAX)
                    if frac > Y_BITS_DIFFER_MAX:
                        fail(f"dequant_add_rms_norm {case}: {frac} of y "
                             "differs from the plain version's bits")
        # softmax_xent: the reference sweep's shapes, the §4.5 site and
        # gemma3-27b's vocabulary
        for rows, vocab in [(7, 1000), (32, 50304), (3, 130), (256, 32000),
                            (8, 262144)]:
            logits = randn((rows, vocab), dt, 5.0)
            labels = torch.randint(0, vocab, (rows,), generator=gen,
                                   device="cuda", dtype=torch.int32)
            compare("softmax_xent", ops.softmax_xent(logits, labels),
                    ref.softmax_xent(logits, labels), dtname,
                    f"logits[{rows},{vocab}]", XENT_TOL)
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
    # 2048 pairs of equal boxes a third of their width apart: IoU 1/2 up
    # to rounding, so each pair's f32 IoU falls a few ulps either side
    x, y, w, h = rng.uniform(5, 40, (4, 2048))
    ox, oy = (np.arange(2048) % 64) * 100.0, (np.arange(2048) // 64) * 100.0
    a = np.stack([ox + x, oy + y, ox + x + w, oy + y + h], -1)
    pairs = np.stack([a, a + np.stack([w / 3, 0 * w, w / 3, 0 * w], -1)], 1)
    yield "near_threshold_pairs", (pairs.reshape(-1, 4).astype(np.float32),
                                   np.linspace(0.99, 0.5, 4096, dtype=np.float32),
                                   0.5, 0.0)


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
    ring decode on lines of their own. The attention rows name the body
    that ran (``mma bf16`` or ``fma f32``, attn_template.body)."""
    import torch.nn.functional as F

    from repro_torch.kernels import attn_template

    timer = graph.Timer()
    dt = torch.bfloat16

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    def entry(shape, kernel, plain, library, nbytes, flops, peak="float32",
              body=None):
        row = dict(shape=shape, ms=timer(kernel), eager_ms=timer.eager(kernel),
                   plain_ms=timer(plain),
                   library_ms=None if library is None else timer(library),
                   bound=bound_ms(nbytes, flops, peak))
        if body is not None:
            row["body"] = body
        return row

    body = attn_template.body(dt)

    out = {}
    # row-wise kernels: the decode step's (4 slots, 1 token) rows
    rows, d = 4, 4096
    x, res, w = randn((rows, 1, d)), randn((rows, 1, d)), randn((d,))
    out["rms_norm"] = entry(
        "x[4,1,4096] bf16 (llama2-7b decode step)",
        lambda: ops.rms_norm(x, w), lambda: ref.rms_norm(x, w),
        (lambda: F.rms_norm(x, (d,), w, 1e-6)) if hasattr(F, "rms_norm") else None,
        2 * (2 * rows * d) + 2 * d, 4 * rows * d)
    out["fused_add_rms_norm"] = entry(
        "x,res[4,1,4096] bf16 (llama2-7b fused decode step)",
        lambda: ops.fused_add_rms_norm(x, res, w),
        lambda: ref.fused_add_rms_norm(x, res, w), None,
        2 * (4 * rows * d) + 2 * d, 5 * rows * d)
    d = 1600
    x, res, w, b = randn((rows, 1, d)), randn((rows, 1, d)), randn((d,)), randn((d,))
    out["layer_norm"] = entry(
        "x[4,1,1600] bf16 (gpt2-xl decode step)",
        lambda: ops.layer_norm(x, w, b), lambda: ref.layer_norm(x, w, b),
        lambda: F.layer_norm(x, (d,), w, b, 1e-5),
        2 * (2 * rows * d) + 2 * 2 * d, 8 * rows * d)
    out["fused_add_layer_norm"] = entry(
        "x,res[4,1,1600] bf16 (gpt2-xl fused decode step)",
        lambda: ops.fused_add_layer_norm(x, res, w, b),
        lambda: ref.fused_add_layer_norm(x, res, w, b), None,
        2 * (4 * rows * d) + 2 * 2 * d, 9 * rows * d)
    h, dh = 32, 128
    q = randn((rows, 1, h, dh))
    pos = torch.tensor(decode_lengths["llama2-7b"], dtype=torch.int32,
                       device="cuda")[:, None] - 1
    n = q.numel()
    out["rope"] = entry(
        "q[4,1,32,128] bf16, positions (4,1) (llama2-7b fused decode step)",
        lambda: ops.rope(q, pos), lambda: ref.rope(q, pos), None,
        2 * 2 * n + 4 * rows, 3 * n + 3 * rows * dh // 2)
    g, u = randn((rows, 1, 11008)), randn((rows, 1, 11008))
    n = g.numel()
    out["swiglu"] = entry(
        "gate,up[4,1,11008] bf16 (llama2-7b decode step)",
        lambda: ops.swiglu(g, u), lambda: ref.swiglu(g, u), None,
        3 * 2 * n, 6 * n)
    extra = {}
    # geglu: gemma3-27b's fused decode step (the kernels line) and a
    # 2048-token prefill (a line of its own); ~10 f32 ops and a tanh each
    for key, rows_s in (("geglu", (4, 1)), ("geglu prefill", (1, 2048))):
        g, u = randn((*rows_s, 21504)), randn((*rows_s, 21504))
        n = g.numel()
        extra[key] = entry(
            f"gate,up[{rows_s[0]},{rows_s[1]},21504] bf16 (gemma3-27b fused "
            f"{'decode step' if rows_s[1] == 1 else 'prefill'})",
            lambda: ops.geglu(g, u), lambda: ref.geglu(g, u), None,
            3 * 2 * n, 10 * n)
    out["geglu"] = extra.pop("geglu")
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
    # nms: the detector's first image, its 256 score-sorted candidates; the
    # serial pass computes one IoU row (~13 f32 ops an entry) per kept box
    boxes, valid, thr = nms_inputs
    n = boxes.shape[0]
    keep = ops.nms_sorted(boxes, valid, thr)
    kept = torch.nonzero(keep).flatten().tolist()
    out["nms"] = entry(
        f"boxes[{n},4] f32, {int(valid.sum())} valid, {len(kept)} kept "
        "(detector-vit-s, 256 px, image 0)",
        lambda: ops.nms_sorted(boxes, valid, thr),
        lambda: ref.nms_sorted(boxes, valid, thr), None,
        16 * n + 2 * n, 13 * sum(n - 1 - i for i in kept))
    # dequant_add_rms_norm: the Table-2 row (the micro phase's path) in bf16
    shape, d = (1, 10, 4096), 4096
    q = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                      dtype=torch.int8)
    qs = torch.full((), 0.02, device="cuda")
    res, w = randn(shape), randn((d,))
    n = q.numel()
    out["dequant_add_rms_norm"] = entry(
        "q[1,10,4096] int8, res[1,10,4096] bf16 (Table-2 micro row)",
        lambda: ops.dequant_add_rms_norm(q, qs, res, w),
        lambda: ref.dequant_add_rms_norm(q, qs, res, w), None,
        n + 3 * 2 * n + 2 * d + 4, 6 * n)
    # softmax_xent: the §4.5 site, (256, 32000) f32; the library call is
    # F.cross_entropy per row
    logits = torch.randn((256, 32000), generator=gen, device="cuda")
    labels = torch.randint(0, 32000, (256,), generator=gen, device="cuda",
                           dtype=torch.int32)
    labels64 = labels.long()
    n = logits.numel()
    out["softmax_xent"] = entry(
        "logits[256,32000] f32, labels int32 (§4.5 kernel site)",
        lambda: ops.softmax_xent(logits, labels),
        lambda: ref.softmax_xent(logits, labels),
        lambda: F.cross_entropy(logits, labels64, reduction="none"),
        4 * n + 4 * 256 + 4 * 256, 5 * n)
    for name, tm in extra.items():
        emit(phase="timing", kernel=name, **{k: v for k, v in tm.items()
                                             if k != "bound"},
             bound_ms=tm["bound"][0], bound_by=tm["bound"][1])
    return out


# ---------------------------------------------------------------------------
# phase 3: serve, and the paths against each other
# ---------------------------------------------------------------------------

def compare_paths(torch, nn, params, cfg, prompts, fused: bool,
                  max_len: int):
    """The model's kernel path against another path of the same model, on
    the card, on the same weights: for the unfused model the plain path
    (``"torch"`` backend), for the fused one both the fused plain path and
    the unfused kernel path. Compared are the prefill logits of each prompt
    alone, then one decode step of all of them together from the kernel
    path's caches, each row at its own position (``decode_core``'s per-row
    lengths). Prints every reading, then fails if one is past its limit:
    F32_ANCHOR times the reference path's distance from the plain path
    run with f32 activations, LOGIT_ATOL at the least."""
    from repro_torch.models import lm_decode, lm_prefill

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
    if bad:
        fail(f"serve: {cfg.name} fused={fused} logits past their limits: "
             + "; ".join(bad))


def serve(torch, ops, Engine, params, cfg, prompts, fused: bool,
          max_len: int):
    """One engine run of the path; returns its launch counts. Fails unless
    every request finished with its tokens and the path launched exactly its
    kernels, as often as its prefills and decode steps need."""
    engine = Engine(cfg, params, max_batch=4, max_len=max_len, fused=fused)
    ops.reset_launches()
    t0 = time.perf_counter()
    for p in prompts:
        engine.add_request(p, max_new_tokens=NEW_TOKENS)
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    st = engine.stats
    emit(phase="serve", model=cfg.name, fused=fused, step="engine",
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
    from repro_torch.serving import Engine

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
        for fused in (False, True):
            if not args.paths_only:
                for k, n in serve(torch, ops, Engine, params, cfg, prompts,
                                  fused, max_len).items():
                    launches[k] += n
            compare_paths(torch, nn, params, cfg, prompts[:4], fused, max_len)
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
            "shape": tm["shape"], **({"body": tm["body"]} if "body" in tm
                                     else {})})
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
