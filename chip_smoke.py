#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py               # from the repository root
    python3 chip_smoke.py --paths-only  # phase 1 and the path comparison

Phases, each printing JSON lines:

1. device  - requires CUDA; prints the card's name and power limit (as
             ``nvidia-smi --query-gpu=name,power.limit`` gives them) and
             builds the hand-written kernels from ``src/repro_torch/kernels/csrc``;
2. kernels - holds each kernel against its plain PyTorch version on the
             card, in bf16 and f32, at llama2-7b's shapes and odd ones, and
             times kernel, plain version, one PyTorch library call computing
             the same function (where there is one) and the card's bound;
3. serve   - llama2-7b at full width and depth in bf16, random weights from
             a seeded generator on the card, served by the continuous-
             batching ``Engine`` (6 requests, 16 new tokens each); checks the
             outputs, that every kernel launched, and the kernel path's
             prefill logits and one decode step's logits against the plain
             path's (``--paths-only`` runs only this comparison, to read
             what it sees of a kernel broken on purpose);
4. profile - a per-op measured profile of ``lm_forward`` (batch 1, seq 16)
             on the kernel path: the measured GEMM / NonGEMM split.

The line before the last is the per-kernel JSON record, the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before that line is printed.
"""

from __future__ import annotations

import argparse
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
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,    # dense tensor-core rate
              "float32": 67e12}      # outside the tensor cores
# |kernel - plain| <= atol + rtol * |plain|: both compute in f32; bf16 output
# may round the other way by one ulp (2^-8 relative), f32 only differs in
# summation order and in the exp / rsqrt intrinsics
TOL = {"bfloat16": (3e-2, 2 ** -7), "float32": (2e-5, 1e-5)}
# logits, kernel path vs plain path, 32 bf16 layers: each layer may round
# its outputs differently by an ulp and the differences compound. On an
# H100 the sound path reads at most 0.0625 (prefill and decode, logits up
# to 4.2); decode_core dropping its newest key reads 0.25 on the decode
# step, attention_core masking the diagonal 2.1-2.8 on prefill
LOGIT_ATOL = 0.125

SOURCES = {
    "rms_norm": ("src/repro_torch/kernels/csrc/rms_norm.cu",
                 "src/repro/kernels/norms.py:47"),
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


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Device time of one call in ms (median over runs), each run timed by
    ``graph.time_once`` as the per-op profile times an op (device time
    only, the empty event pair subtracted), with the L2 cache flushed
    before each run: the main path finds its operands cold, with 13 GB of
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
    """Every kernel vs its plain version at llama2-7b's shapes and odd ones,
    bf16 and f32. Returns {kernel: max abs error over its cases}."""
    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}

    def randn(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dt)

    def compare(name, got, want, dtname, case):
        torch.cuda.synchronize()
        atol, rtol = TOL[dtname]
        err = (got.float() - want.float()).abs()
        lim = atol + rtol * want.float().abs()
        ok = bool((err <= lim).all()) and bool(torch.isfinite(got.float()).all())
        emit(phase="kernels", kernel=name, case=case, dtype=dtname,
             max_abs_err=float(err.max()), atol=atol, rtol=rtol, ok=ok)
        if not ok:
            fail(f"{name} {case} {dtname}: kernel disagrees with plain version")
        return float(err.max())

    worst = dict.fromkeys(SOURCES, 0.0)
    for dtname, dt in dts.items():
        for shape, zc in [((4, 1, 4096), False), ((1, 256, 4096), False),
                          ((2, 33, 257), False), ((3, 7, 1000), True)]:
            x, w = randn(shape, dt), randn(shape[-1:], dt)
            worst["rms_norm"] = max(worst["rms_norm"], compare(
                "rms_norm", ops.rms_norm(x, w, zero_centered=zc),
                ref.rms_norm(x, w, zero_centered=zc), dtname,
                f"x{list(shape)} zero_centered={zc}"))
        for shape in [(4, 1, 11008), (1, 256, 11008), (2, 37, 257), (1, 13)]:
            g, u = randn(shape, dt, 3.0), randn(shape, dt)
            worst["swiglu"] = max(worst["swiglu"], compare(
                "swiglu", ops.swiglu(g, u), ref.swiglu(g, u), dtname,
                f"{list(shape)}"))
        # (B, Sq, Skv, Hq, Hkv, Dk, Dv, q_offset)
        for b, sq, skv, hq, hkv, dk, dv, off in [
                (1, 256, 256, 32, 32, 128, 128, 0),   # llama prefill bucket
                (2, 37, 37, 4, 4, 64, 64, 0),         # seq 37
                (1, 100, 100, 8, 2, 128, 128, 0),     # GQA 8/2
                (2, 35, 35, 4, 4, 48, 16, 0),         # Dv != Dk
                (1, 13, 40, 4, 2, 32, 32, 27),        # q_offset
                (1, 21, 21, 2, 2, 34, 18, 0)]:        # scalar tile staging
            q = randn((b, sq, hq, dk), dt)
            k, v = randn((b, skv, hkv, dk), dt), randn((b, skv, hkv, dv), dt)
            worst["attention_core"] = max(worst["attention_core"], compare(
                "attention_core", ops.attention_core(q, k, v, q_offset=off),
                ref.attention(q, k, v, q_offset=off), dtname,
                f"q{[b, sq, hq, dk]} kv{[b, skv, hkv]} dv={dv} q_offset={off}"))
        for b, t, hq, hkv, dk, dv, lens in [
                (4, 512, 32, 32, 128, 128, [1, 200, 512, 0]),   # llama, a dead slot
                (3, 100, 8, 2, 64, 64, [0, 37, 100]),           # GQA 8/2
                (2, 70, 4, 4, 48, 16, [70, 5]),                 # Dv != Dk
                (2, 30, 4, 2, 34, 18, [30, 7])]:                # scalar staging
            q = randn((b, 1, hq, dk), dt)
            k, v = randn((b, t, hkv, dk), dt), randn((b, t, hkv, dv), dt)
            n = torch.tensor(lens, dtype=torch.int32, device="cuda")
            got = ops.decode_core(q, k, v, n)
            worst["decode_core"] = max(worst["decode_core"], compare(
                "decode_core", got, ref.decode_attention(q, k, v, n), dtname,
                f"q{[b, 1, hq, dk]} kv{[b, t, hkv]} dv={dv} lengths={lens}"))
            if 0 in lens and got[lens.index(0)].float().abs().any():
                fail("decode_core: lengths 0 must give exact zeros")
    return worst


def time_kernels(torch, ops, ref, gen, decode_lengths, graph):
    """Kernel, plain and library times at the serve phase's main-path shapes
    (bf16), with the bound each function's bytes and operations set."""
    import torch.nn.functional as F

    timer = Timer(torch, graph)
    dt, dtname = torch.bfloat16, "bfloat16"

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    out = {}
    # rms_norm and swiglu: the decode step's (4 slots, 1 token) rows
    x, w = randn((4, 1, 4096)), randn((4096,))
    rows, d = 4, 4096
    out["rms_norm"] = dict(
        shape="x[4,1,4096] bf16 (decode step)",
        ms=timer(lambda: ops.rms_norm(x, w)),
        eager_ms=timer.eager(lambda: ops.rms_norm(x, w)),
        plain_ms=timer(lambda: ref.rms_norm(x, w)),
        library_ms=(timer(lambda: F.rms_norm(x, (d,), w, 1e-6))
                    if hasattr(F, "rms_norm") else None),
        bound=bound_ms(2 * (2 * rows * d) + 2 * d, 4 * rows * d, dtname))
    g, u = randn((4, 1, 11008)), randn((4, 1, 11008))
    n = g.numel()
    out["swiglu"] = dict(
        shape="gate,up[4,1,11008] bf16 (decode step)",
        ms=timer(lambda: ops.swiglu(g, u)),
        eager_ms=timer.eager(lambda: ops.swiglu(g, u)),
        plain_ms=timer(lambda: ref.swiglu(g, u)),
        library_ms=None,
        bound=bound_ms(3 * 2 * n, 6 * n, dtname))
    # attention_core: the serve phase's largest prefill bucket
    b, s, h, dh = 1, 256, 32, 128
    q, k, v = randn((b, s, h, dh)), randn((b, s, h, dh)), randn((b, s, h, dh))
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    visible = s * (s + 1) // 2                     # causal (q, k) pairs per head
    out["attention_core"] = dict(
        shape="q,k,v[1,256,32,128] bf16 causal (prefill bucket)",
        ms=timer(lambda: ops.attention_core(q, k, v)),
        eager_ms=timer.eager(lambda: ops.attention_core(q, k, v)),
        plain_ms=timer(lambda: ref.attention(q, k, v)),
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        bound=bound_ms(4 * b * s * h * dh * 2, 2 * b * h * visible * 2 * dh,
                       dtname))
    # decode_core: the 4-slot cache of depth 512 at the serve run's lengths
    b, t = 4, 512
    q = randn((b, 1, h, dh))
    k, v = randn((b, t, h, dh)), randn((b, t, h, dh))
    lens = torch.tensor(decode_lengths, dtype=torch.int32, device="cuda")
    mask = (torch.arange(t, device="cuda")[None] < lens[:, None])[:, None, None, :]
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    kv = sum(decode_lengths)
    out["decode_core"] = dict(
        shape=f"q[4,1,32,128] kv[4,512,32,128] bf16 lengths={decode_lengths}",
        ms=timer(lambda: ops.decode_core(q, k, v, lens)),
        eager_ms=timer.eager(lambda: ops.decode_core(q, k, v, lens)),
        plain_ms=timer(lambda: ref.decode_attention(q, k, v, lens)),
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask)),
        bound=bound_ms(2 * (2 * b * h * dh + 2 * kv * h * dh), 4 * kv * h * dh,
                       dtname))
    return out


# ---------------------------------------------------------------------------
# phase 3: the model's kernel path against its plain path
# ---------------------------------------------------------------------------

def compare_paths(torch, nn, params, cfg, prompts, max_len: int = 256):
    """The model under the ``"cuda"`` backend (kernels) against the same
    model under ``"torch"`` (plain), on the card, on the same weights: the
    prefill logits of each prompt alone, then one decode step of all of
    them together from the kernel path's caches, each row at its own
    position (``decode_core``'s per-row lengths). Prints every reading,
    then fails if one is past LOGIT_ATOL."""
    from repro_torch.models import lm_decode, lm_prefill

    def both(fn):
        with nn.backend("cuda"):
            got = fn()
        with nn.backend("torch"):
            want = fn()
        return got, want

    bad = []

    def check(step, lk, lt, **info):
        diff = float((lk.float() - lt.float()).abs().max())
        emit(phase="serve", step=step, max_abs_diff=diff,
             max_abs_logit=float(lt.float().abs().max()), atol=LOGIT_ATOL,
             same_argmax=bool((lk.argmax(-1) == lt.argmax(-1)).all()), **info)
        if not (math.isfinite(diff) and diff <= LOGIT_ATOL):
            bad.append(f"{step} {info}: {diff}")

    rows = []
    for p in prompts:
        toks = torch.tensor([p], device="cuda")
        (lk, caches), (lt, _) = both(
            lambda: lm_prefill(params, toks, cfg, max_len=max_len))
        check("kernel_vs_plain_prefill_logits", lk, lt, prompt_len=len(p))
        rows.append((lk, caches))

    token = torch.cat([lk.argmax(-1) for lk, _ in rows])
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                       device="cuda")
    caches = [{n: torch.cat([c[i][n] for _, c in rows]) for n in ("k", "v")}
              for i in range(cfg.n_layers)]

    def decode():                       # each path writes its own copy
        fresh = [{n: t.clone() for n, t in c.items()} for c in caches]
        return lm_decode(params, token, pos, fresh, cfg)[0]

    lk, lt = both(decode)
    check("kernel_vs_plain_decode_logits", lk, lt, positions=pos.tolist())
    if bad:
        fail(f"serve: kernel-path logits differ from plain past {LOGIT_ATOL}: "
             + "; ".join(bad))


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths-only", action="store_true",
                    help="phase 1, then only the model-level comparison of "
                         "the kernel path with the plain path; prints its "
                         "readings and no result line")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2

    from repro_torch import nn
    from repro_torch.configs import get_config
    from repro_torch.core import graph, profile_measured
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

    # -- phase 3: serve ----------------------------------------------------
    cfg = get_config("llama2-7b").replace(dtype="bfloat16",
                                          param_dtype="bfloat16")
    t0 = time.perf_counter()
    params = init_lm(torch.Generator("cuda").manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    emit(phase="serve", step="init", config=cfg.name, n_params=n_params,
         init_s=round(time.perf_counter() - t0, 3),
         mem_gb=round(torch.cuda.memory_allocated() / 1e9, 3))

    rng = np.random.default_rng(SEED)
    plens = [int(n) for n in rng.integers(5, 201, 6)]
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in plens]
    if args.paths_only:
        compare_paths(torch, nn, params, cfg, prompts[:4])
        return 0
    new_tokens = 16
    engine = Engine(cfg, params, max_batch=4, max_len=512)
    ops.reset_launches()
    t0 = time.perf_counter()
    for p in prompts:
        engine.add_request(p, max_new_tokens=new_tokens)
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    st = engine.stats
    emit(phase="serve", step="engine", prompt_lens=plens,
         completed=len(done), wall_s=round(wall, 4),
         tok_per_s=round(st.emitted_tokens / wall, 2),
         decode_tok_per_s=round(st.decode_tok_per_s, 2),
         mean_ttft_s=round(st.mean_ttft_s, 4),
         mean_decode_tok_latency_s=round(st.mean_decode_tok_latency_s, 5),
         prefill_s=round(st.prefill_s, 4), decode_s=round(st.decode_s, 4),
         decode_steps=st.decode_steps, launches=launches)
    if len(done) != len(prompts) or any(len(r.output) != new_tokens
                                        for r in done):
        fail(f"serve: {len(done)} of {len(prompts)} requests finished, "
             f"lengths {[len(r.output) for r in done]}")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.output):
        fail("serve: a token outside the vocabulary")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"serve: kernels never launched on the main path: {missing}")

    compare_paths(torch, nn, params, cfg, prompts[:4])

    # decode lengths the main path reached: the last step of the 4 slots
    # serving the first 4 requests, cut off at their 16th token
    decode_lengths = [n + new_tokens - 1 for n in plens[:4]]
    timing = time_kernels(torch, ops, ref, gen, decode_lengths, graph)

    # -- phase 4: profile --------------------------------------------------
    ptoks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, 16))).cuda()
    walls = []
    for _ in range(6):                      # the first warms cuBLAS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm_forward(params, ptoks, cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = statistics.median(walls[1:]) * 1e3
    prof = profile_measured(lm_forward, params, ptoks, cfg,
                            name="llama2-7b b-1 s-16 bf16", repeats=3)
    split = prof.split
    emit(phase="profile", model=prof.name, mode=prof.mode, n_ops=prof.n_ops,
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
