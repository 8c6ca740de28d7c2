#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py               # from the repository root
    python3 chip_smoke.py --paths-only  # phase 1 and the path comparisons

Phases, each printing JSON lines:

1. device  - requires CUDA; prints the card's name and power limit (as
             ``nvidia-smi --query-gpu=name,power.limit`` gives them) and
             builds the hand-written kernels from ``src/repro_torch/kernels/csrc``;
2. kernels - holds each of the eight kernels against its plain PyTorch
             version on the card, in bf16 and f32, at the main path's shapes
             (llama2-7b; gpt2-xl's 25 heads of 64) and odd ones;
3. serve   - for each of llama2-7b and gpt2-xl at full width and depth in
             bf16 (random weights from a seeded generator on the card), the
             continuous-batching ``Engine`` unfused and fused
             (``Engine(fused=True)``: ``nn.fuse()``) serves 6 requests of 16
             new tokens; checks the outputs and that each path launched
             exactly its kernels, as many times as its forwards need; then
             holds the kernel path's prefill logits and one decode step's
             logits against the plain path's, and the fused path's against
             the unfused path's (``--paths-only`` runs only these
             comparisons, to read what they see of a kernel broken on
             purpose);
4. profile - a per-op measured profile of ``lm_forward`` (batch 1, seq 16)
             on the kernel path, unfused and fused, for both models: the
             measured GEMM / NonGEMM split;
5. timing  - kernel, plain version, one PyTorch library call computing the
             same function (where there is one) and the card's bound, at the
             serve phase's shapes.

The line before the last is the per-kernel JSON record, the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before that line is printed.
"""

from __future__ import annotations

import argparse
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
ARCHS = ("llama2-7b", "gpt2-xl")
NEW_TOKENS = 16
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,    # dense tensor-core rate
              "float32": 67e12}      # outside the tensor cores
# |kernel - plain| <= atol + rtol * |plain|: both compute in f32; bf16 output
# may round the other way by one ulp (2^-8 relative), f32 only differs in
# summation order and in the exp / rsqrt intrinsics
TOL = {"bfloat16": (3e-2, 2 ** -7), "float32": (2e-5, 1e-5)}
# a LayerNorm row whose mean is 1e3 standard deviations from zero: either
# version's f32 mean carries ~2^-24 * 1e3 * log2(d) of summation-order
# error, which the normalized row shows unscaled (9.4e-5 read on an H100);
# a one-pass E[x^2] - E[x]^2 variance errs by ~0.1 there
LARGE_MEAN_TOL = {"bfloat16": TOL["bfloat16"], "float32": (1e-3, 1e-5)}
# logits, kernel path vs plain path (and fused vs unfused), all layers in
# bf16: each layer may round its outputs differently by an ulp and the
# differences compound. On an H100 the sound paths read at most 0.0625
# (llama2-7b) and 0.0586 (gpt2-xl), prefill and decode, logits up to 4.2;
# the fused kernel path reads 0 against the unfused one. For llama2-7b,
# decode_core dropping its newest key reads 0.25 on the decode step,
# attention_core masking the diagonal 2.1-2.8 on prefill
LOGIT_ATOL = 0.125

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
    "attention_core": ("src/repro_torch/kernels/csrc/attention.cu",
                       "src/repro/kernels/attn_template.py:170"),
    "decode_core": ("src/repro_torch/kernels/csrc/decode.cu",
                    "src/repro/kernels/attn_template.py:185"),
}


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def per_forward_launches(cfg, fused: bool) -> dict:
    """Kernel launches of one prefill or decode forward on the kernel path
    (``attention_core`` on prefill, ``decode_core`` on decode)."""
    n = cfg.n_layers
    out = {"attn": n}
    if cfg.norm == "rmsnorm":
        out.update(rms_norm=n + 1 if fused else 2 * n + 1, swiglu=n)
        if fused:
            out.update(fused_add_rms_norm=n, rope=2 * n)
    else:
        out["layer_norm"] = n + 1 if fused else 2 * n + 1
        if fused:
            out["fused_add_layer_norm"] = n
    return out


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Device time of one call in ms (median over runs), each run timed by
    ``graph.time_once`` as the per-op profile times an op (device time
    only, the empty event pair subtracted), with the L2 cache flushed
    before each run: the main path finds its operands cold, with GBs of
    weights passing between two launches of one layer's kernel.

    :meth:`eager` is the other view: host clock over back-to-back calls,
    synchronised once — what a call costs the eager serving loop, host
    dispatch included."""

    def __init__(self, torch, graph, iters: int = 20, warmup: int = 3):
        self.torch, self.graph = torch, graph
        self.floor = graph.empty_event_seconds()
        self.iters, self.warmup = iters, warmup
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        for _ in range(self.warmup):
            fn()
        ts = []
        for _ in range(self.iters):
            self.flush.zero_()
            ts.append(self.graph.time_once(fn, (), {}, self.floor)[1])
        return statistics.median(ts) * 1e3

    def eager(self, fn, n: int = 100) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3


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
    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}

    def randn(shape, dt, scale=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                + mean).to(dt)

    def compare(name, got, want, dtname, case, tol=TOL):
        torch.cuda.synchronize()
        atol, rtol = tol[dtname]
        err = (got.float() - want.float()).abs()
        lim = atol + rtol * want.float().abs()
        ok = bool((err <= lim).all()) and bool(torch.isfinite(got.float()).all())
        emit(phase="kernels", kernel=name, case=case, dtype=dtname,
             max_abs_err=float(err.max()), atol=atol, rtol=rtol, ok=ok)
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
        for shape, zc in [((4, 1, 4096), False), ((1, 256, 4096), False),
                          ((2, 33, 257), False), ((3, 7, 1000), True)]:
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
        # (B, Sq, Skv, Hq, Hkv, Dk, Dv, q_offset)
        for b, sq, skv, hq, hkv, dk, dv, off in [
                (1, 256, 256, 32, 32, 128, 128, 0),   # llama prefill bucket
                (1, 256, 256, 25, 25, 64, 64, 0),     # gpt2-xl prefill bucket
                (2, 37, 37, 4, 4, 64, 64, 0),         # seq 37
                (1, 100, 100, 8, 2, 128, 128, 0),     # GQA 8/2
                (2, 35, 35, 4, 4, 48, 16, 0),         # Dv != Dk
                (1, 13, 40, 4, 2, 32, 32, 27),        # q_offset
                (1, 21, 21, 2, 2, 34, 18, 0)]:        # scalar tile staging
            q = randn((b, sq, hq, dk), dt)
            k, v = randn((b, skv, hkv, dk), dt), randn((b, skv, hkv, dv), dt)
            compare("attention_core", ops.attention_core(q, k, v, q_offset=off),
                    ref.attention(q, k, v, q_offset=off), dtname,
                    f"q{[b, sq, hq, dk]} kv{[b, skv, hkv]} dv={dv} q_offset={off}")
        for b, t, hq, hkv, dk, dv, lens in [
                (4, 512, 32, 32, 128, 128, [1, 200, 512, 0]),   # llama, a dead slot
                (4, 512, 25, 25, 64, 64, [186, 512, 0, 72]),    # gpt2-xl
                (3, 100, 8, 2, 64, 64, [0, 37, 100]),           # GQA 8/2
                (2, 70, 4, 4, 48, 16, [70, 5]),                 # Dv != Dk
                (2, 30, 4, 2, 34, 18, [30, 7])]:                # scalar staging
            q = randn((b, 1, hq, dk), dt)
            k, v = randn((b, t, hkv, dk), dt), randn((b, t, hkv, dv), dt)
            n = torch.tensor(lens, dtype=torch.int32, device="cuda")
            got = ops.decode_core(q, k, v, n)
            compare("decode_core", got, ref.decode_attention(q, k, v, n), dtname,
                    f"q{[b, 1, hq, dk]} kv{[b, t, hkv]} dv={dv} lengths={lens}")
            if 0 in lens and got[lens.index(0)].float().abs().any():
                fail("decode_core: lengths 0 must give exact zeros")
    return worst


# ---------------------------------------------------------------------------
# phase 5: times at the main path's shapes
# ---------------------------------------------------------------------------

def time_kernels(torch, ops, ref, gen, decode_lengths, graph):
    """Kernel, plain and library times at the serve phase's main-path shapes
    (bf16), with the bound each function's bytes and operations set. The
    row-wise kernels do their arithmetic in f32 on the CUDA cores, so their
    operations are bounded by the f32 rate; attention's products could run
    on the tensor cores, so theirs by the bf16 rate. Returns the kernels
    line's entries and prints the gpt2-xl attention shapes on lines of
    their own."""
    import torch.nn.functional as F

    timer = Timer(torch, graph)
    dt = torch.bfloat16

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    def entry(shape, kernel, plain, library, nbytes, flops, peak="float32"):
        return dict(shape=shape, ms=timer(kernel), eager_ms=timer.eager(kernel),
                    plain_ms=timer(plain),
                    library_ms=None if library is None else timer(library),
                    bound=bound_ms(nbytes, flops, peak))

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
            4 * b * s * h * dh * 2, 2 * b * h * visible * 2 * dh, "bfloat16")
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
    for name, tm in extra.items():
        emit(phase="timing", kernel=name, **{k: v for k, v in tm.items()
                                             if k != "bound"},
             bound_ms=tm["bound"][0], bound_by=tm["bound"][1])
    return out


# ---------------------------------------------------------------------------
# phase 3: serve, and the paths against each other
# ---------------------------------------------------------------------------

def compare_paths(torch, nn, params, cfg, prompts, fused: bool,
                  max_len: int = 256):
    """The model's kernel path against another path of the same model, on
    the card, on the same weights: for the unfused model the plain path
    (``"torch"`` backend), for the fused one both the fused plain path and
    the unfused kernel path. Compared are the prefill logits of each prompt
    alone, then one decode step of all of them together from the kernel
    path's caches, each row at its own position (``decode_core``'s per-row
    lengths). Prints every reading, then fails if one is past LOGIT_ATOL."""
    from repro_torch.models import lm_decode, lm_prefill

    atol = LOGIT_ATOL
    kernel = ("cuda", fused)
    others = [("torch", fused)] + ([("cuda", False)] if fused else [])

    def run(setting, fn):
        backend, fz = setting
        with nn.backend(backend), nn.fuse(fz):
            return fn()

    bad = []

    def check(step, vs, lk, lt, **info):
        diff = float((lk.float() - lt.float()).abs().max())
        emit(phase="serve", model=cfg.name, fused=fused, step=step,
             against=f"{vs[0]} fused={vs[1]}", max_abs_diff=diff,
             max_abs_logit=float(lt.float().abs().max()), atol=atol,
             same_argmax=bool((lk.argmax(-1) == lt.argmax(-1)).all()), **info)
        if not (math.isfinite(diff) and diff <= atol):
            bad.append(f"{step} vs {vs} {info}: {diff}")

    rows = []
    for p in prompts:
        toks = torch.tensor([p], device="cuda")

        def prefill():
            return lm_prefill(params, toks, cfg, max_len=max_len)
        lk, caches = run(kernel, prefill)
        for vs in others:
            check("prefill_logits", vs, lk, run(vs, prefill)[0],
                  prompt_len=len(p))
        rows.append((lk, caches))

    token = torch.cat([lk.argmax(-1) for lk, _ in rows])
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                       device="cuda")
    caches = [{n: torch.cat([c[i][n] for _, c in rows]) for n in ("k", "v")}
              for i in range(cfg.n_layers)]

    def decode():                       # each path writes its own copy
        fresh = [{n: t.clone() for n, t in c.items()} for c in caches]
        return lm_decode(params, token, pos, fresh, cfg)[0]

    lk = run(kernel, decode)
    for vs in others:
        check("decode_logits", vs, lk, run(vs, decode), positions=pos.tolist())
    if bad:
        fail(f"serve: {cfg.name} fused={fused} logits past {atol}: "
             + "; ".join(bad))


def serve(torch, ops, Engine, params, cfg, prompts, fused: bool):
    """One engine run of the path; returns its launch counts. Fails unless
    every request finished with its tokens and the path launched exactly its
    kernels, as often as its prefills and decode steps need."""
    engine = Engine(cfg, params, max_batch=4, max_len=512, fused=fused)
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
    per = per_forward_launches(cfg, fused)
    forwards = len(prompts) + st.decode_steps
    want = {k: 0 for k in launches}
    want.update({k: n * forwards for k, n in per.items() if k != "attn"})
    want["attention_core"] = per["attn"] * len(prompts)
    want["decode_core"] = per["attn"] * st.decode_steps
    if launches != want:
        fail(f"serve: {cfg.name} fused={fused} launched {launches}, its "
             f"{len(prompts)} prefills and {st.decode_steps} decode steps "
             f"need {want}")
    return launches


# ---------------------------------------------------------------------------
# phase 4: profile
# ---------------------------------------------------------------------------

def profile(torch, nn, ops, params, cfg, fused: bool, rng):
    """Measured split of one eager ``lm_forward`` (b1 s16) on the kernel
    path, beside its un-instrumented wall time; checks one forward's
    launches against the path's table on the way."""
    from repro_torch.core import profile_measured
    from repro_torch.models import lm_forward

    ptoks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, 16))).cuda()
    walls = []
    ops.reset_launches()
    with nn.fuse(fused):
        for _ in range(6):                      # the first warms cuBLAS
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm_forward(params, ptoks, cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        per = {k: v for k, v in ops.launches.items() if v}
        want = {("attention_core" if k == "attn" else k): 6 * n
                for k, n in per_forward_launches(cfg, fused).items()}
        if per != want:
            fail(f"profile: {cfg.name} fused={fused}: 6 forwards launched "
                 f"{per}, expected {want}")
        wall_ms = statistics.median(walls[1:]) * 1e3
        name = f"{cfg.name} {'fused' if fused else 'unfused'} b-1 s-16 bf16"
        prof = profile_measured(lm_forward, params, ptoks, cfg, name=name,
                                repeats=3)
    split = prof.split
    emit(phase="profile", model=prof.name, mode=prof.mode, n_ops=prof.n_ops,
         launches_per_forward={k: v // 6 for k, v in per.items()},
         device_ms=round(prof.total_seconds * 1e3, 4),
         eager_wall_ms=round(wall_ms, 4),
         device_busy_frac=round(prof.total_seconds * 1e3 / wall_ms, 4),
         gemm_ms=round(split["gemm_s"] * 1e3, 4),
         nongemm_ms=round(split["nongemm_s"] * 1e3, 4),
         gemm_frac=round(split["gemm_frac"], 4),
         nongemm_frac=round(split["nongemm_frac"], 4),
         group_ms={g: round(t * 1e3, 4) for g, t in
                   sorted(prof.group_seconds.items(), key=lambda kv: -kv[1])},
         top_nongemm_groups=[[g, round(t * 1e3, 4), round(p, 2)]
                             for g, t, p in prof.top_nongemm_groups(5)],
         top_op_sites=[[f"{g}:{s}", round(t * 1e3, 4), round(p, 2)]
                       for (g, s), t, p in prof.top_op_sites(10)],
         top_site_ops=_top_site_ops(prof, 15))
    if prof.mode != "measured_cuda" or not split["gemm_s"] > 0:
        fail("profile: no device time measured")


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
    from repro_torch.models import init_lm
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
        plens = [int(n) for n in rng.integers(5, 201, 6)]
        prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
                   for n in plens]
        for fused in (False, True):
            if not args.paths_only:
                for k, n in serve(torch, ops, Engine, params, cfg, prompts,
                                  fused).items():
                    launches[k] += n
            compare_paths(torch, nn, params, cfg, prompts[:4], fused)
        if not args.paths_only:
            for fused in (False, True):
                profile(torch, nn, ops, params, cfg, fused, rng)
        # the last step of the 4 slots serving the first 4 requests, cut off
        # at their 16th token
        decode_lengths[arch] = [n + NEW_TOKENS - 1 for n in plens[:4]]
        del params
        gc.collect()
        torch.cuda.empty_cache()
    if args.paths_only:
        return 0
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"serve: kernels never launched on the main paths: {missing}")

    # -- phase 5: timing ---------------------------------------------------
    timing = time_kernels(torch, ops, ref, gen, decode_lengths, graph)

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
            "shape": tm["shape"]})
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
