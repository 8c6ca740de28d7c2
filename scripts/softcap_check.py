"""The attention kernels' softcap fragment on one GPU: build, registers,
agreement, refusals.

Builds the kernels (``csrc/attention_softcap.cu`` and
``csrc/decode_softcap.cu`` beside the uncapped sources), prints ``nvcc
-Xptxas -v``'s registers and spills of every capped instantiation and of
the uncapped ones of the same bodies, holds ``attention_core``,
``attention_window``, ``attention_full`` and ``decode_core`` with caps 50,
20 and 5 (5 saturates tanh over much of a row) at head dims 64, 80 and 128
against their plain versions in bf16 and f32 (:func:`softcap_cases`: a
chunk's ``q_offset``, rows that see no key, which must leave as exact
zeros, and decode split many ways over 4096 keys), and checks that the
wide instantiations (MLA's, head dim 256) refuse a cap; holds the library
call that computes the same function (:func:`flex_capped`, compiled
``flex_attention``) against the plain version at cap 5. A short first check
of the fragment, before ``chip_smoke.py``'s phase 2 holds the same cases
(it imports :func:`softcap_cases`) and phase 5 times the capped kernels.
Prints JSON lines and ``bad N`` last (N the comparisons and refusals that
failed); needs a GPU. Before it, one JSON line times PERF.md §6's row
9b-cap (:func:`full_row`: the capped full-mask kernel, its bound, the
plain version and compiled ``flex_attention``) with the card's name and
power limit.

    python3 scripts/softcap_check.py [--ptxas-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO / "scripts"))

#: the caps the cases run: Gemma 2's attention cap, a middle one, and one
#: that saturates tanh over much of a row of randn scores
CAPS = (50.0, 20.0, 5.0)
#: |kernel - plain| <= atol + rtol * |plain| (chip_smoke.py's TOL)
TOL = {"bfloat16": (3e-2, 2 ** -7), "float32": (2e-5, 1e-5)}


def softcap_cases(torch, ops, ref, randn, dt, sms: int) -> list:
    """The capped kernels' cases, as (kernel, launch, plain version, case,
    keywords: ``rms_scaled`` for the causal, window and decode cases, whose
    long rows average to outputs of about the size of bf16's atol,
    ``zero_rows`` the number of rows that see no key and must be exact
    zeros): caps 50, 20
    and 5 at head dims 64, 80 and 128; gemma3-27b's global and window
    prefill at the 2048 bucket (cap 50, its published one) and past the
    window; a chunk at ``q_offset``; queries scaled by 4, whose scores the
    cap of 5 flattens; rows that see no key (a window whose rows run past
    the keys, a window past the depth, decode lengths 0); decode split many
    ways over 4096 keys, and gemma3-27b's ring."""
    from repro_torch.kernels import attn_template

    cases = []

    def zeros(want):
        return int((want.float().abs().amax(-1) == 0).sum())

    # (B, Sq, Skv, Hq, Hkv, D, q_offset, cap, q scale)
    for b, sq, skv, hq, hkv, d, off, cap, qs in [
            (1, 2048, 2048, 32, 16, 128, 0, 50.0, 1.0),   # gemma3 global
            (1, 256, 256, 32, 32, 128, 0, 20.0, 4.0),
            (1, 64, 512, 32, 32, 80, 448, 20.0, 1.0),     # a chunk
            (2, 37, 37, 4, 4, 64, 0, 5.0, 4.0),
            (1, 100, 300, 8, 4, 128, 200, 5.0, 1.0),
            (1, 50, 50, 4, 2, 80, 0, 50.0, 4.0)]:
        q = randn((b, sq, hq, d), dt, qs)
        k, v = randn((b, skv, hkv, d), dt), randn((b, skv, hkv, d), dt)
        cases.append(("attention_core",
                      lambda q=q, k=k, v=v, o=off, c=cap:
                          ops.attention_core(q, k, v, q_offset=o, softcap=c),
                      lambda q=q, k=k, v=v, o=off, c=cap:
                          ref.attention(q, k, v, q_offset=o, softcap=c),
                      f"q{[b, sq, hq, d]} x{qs} kv{[b, skv, hkv]} "
                      f"q_offset={off} softcap={cap}", dict(rms_scaled=True)))
    # (B, Sq, Skv, Hq, Hkv, D, q_offset, window, cap, q scale): rows 47-63
    # of the 64 over 40 keys and every row of the 16 at q_offset 100 see
    # no key (the first inside a tile the body runs, the second none)
    for b, sq, skv, hq, hkv, d, off, w, cap, qs in [
            (1, 2048, 2048, 32, 16, 128, 0, 1024, 50.0, 1.0),  # gemma3 local
            (1, 1100, 1100, 32, 16, 128, 0, 1024, 20.0, 4.0),
            (1, 64, 40, 4, 2, 64, 0, 8, 5.0, 4.0),
            (1, 16, 20, 4, 4, 80, 100, 8, 20.0, 1.0),
            (2, 197, 197, 4, 2, 80, 0, 65, 5.0, 1.0),
            (1, 13, 140, 4, 2, 128, 127, 70, 50.0, 4.0)]:
        q = randn((b, sq, hq, d), dt, qs)
        k, v = randn((b, skv, hkv, d), dt), randn((b, skv, hkv, d), dt)
        want = ref.attention(q, k, v, q_offset=off, window=w, softcap=cap)
        cases.append(("attention_window",
                      lambda q=q, k=k, v=v, o=off, w=w, c=cap:
                          ops.attention_window(q, k, v, w, q_offset=o,
                                               softcap=c),
                      lambda want=want: want,
                      f"q{[b, sq, hq, d]} x{qs} kv{[b, skv, hkv]} "
                      f"q_offset={off} window={w} softcap={cap}",
                      dict(rms_scaled=True, zero_rows=zeros(want))))
    # (B, Sq, Skv, Hq, Hkv, D, cap, q scale)
    for b, sq, skv, hq, hkv, d, cap, qs in [
            (1, 196, 196, 12, 12, 64, 50.0, 1.0),
            (1, 37, 301, 4, 2, 80, 5.0, 4.0),
            (2, 50, 70, 4, 4, 128, 20.0, 1.0)]:
        q = randn((b, sq, hq, d), dt, qs)
        k, v = randn((b, skv, hkv, d), dt), randn((b, skv, hkv, d), dt)
        cases.append(("attention_full",
                      lambda q=q, k=k, v=v, c=cap:
                          ops.attention_full(q, k, v, softcap=c),
                      lambda q=q, k=k, v=v, c=cap:
                          ref.attention(q, k, v, causal=False, softcap=c),
                      f"q{[b, sq, hq, d]} x{qs} kv{[b, skv, hkv]} softcap={cap}",
                      {}))
    # decode: (B, T, Hq, Hkv, D, lengths, cap, q scale)
    for b, t, hq, hkv, d, lens, cap, qs in [
            (4, 1024, 32, 16, 128, [1024, 1024, 1024, 53], 50.0, 1.0),
            (4, 512, 32, 32, 80, [216, 20, 0, 512], 20.0, 4.0),
            (3, 100, 8, 2, 64, [0, 37, 100], 5.0, 1.0),
            (1, 4096, 8, 1, 128, [4096], 5.0, 4.0),
            (2, 4096, 4, 1, 64, [4095, 65], 20.0, 1.0),
            (4, 2048, 32, 32, 64, [1500, 750, 0, 37], 50.0, 4.0)]:
        q = randn((b, 1, hq, d), dt, qs)
        k, v = randn((b, t, hkv, d), dt), randn((b, t, hkv, d), dt)
        n = torch.tensor(lens, dtype=torch.int32, device="cuda")
        want = ref.decode_attention(q, k, v, n, softcap=cap)
        plan = attn_template.decode_plan(b, hq, hkv, t, d, d, sms)
        cases.append(("decode_core",
                      lambda q=q, k=k, v=v, n=n, c=cap:
                          ops.decode_core(q, k, v, n, softcap=c),
                      lambda want=want: want,
                      f"q{[b, 1, hq, d]} x{qs} kv{[b, t, hkv]} lengths={lens} "
                      f"softcap={cap}",
                      dict(plan=list(plan), rms_scaled=True,
                           zero_rows=zeros(want))))
    return cases


def flex_capped(torch, cap, q, k, v, mask_mod, batch=None):
    """The one PyTorch call that computes the capped attention of
    (B, S, H, D) ``q``, ``k``, ``v``: ``flex_attention``, compiled, with
    ``tanh(s / cap) * cap`` as its score modification (flex applies it to
    the scaled score, before the mask, where the kernels cap) and
    ``mask_mod(b, h, q_idx, kv_idx)`` as its block mask (``batch``: the
    mask's batch size where it reads the row, None where every row has the
    same; a mask function of its own for each mask; None: no mask, every
    key visible), GQA's groups by ``enable_gqa``. Returns the call, on
    (B, H, S, D) copies made here, and its output in (B, S, H, D). A
    library time only: the port's attention runs its own kernels.
    Inductor's and Triton's caches go under the repo's build/."""
    import os

    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(REPO / "build" / sub))
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    def score_mod(score, b, h, q_idx, kv_idx):
        return torch.tanh(score / cap) * cap

    block = None if mask_mod is None else create_block_mask(
        mask_mod, batch, None, q.shape[1], k.shape[1], device=str(q.device))
    flex = torch.compile(flex_attention, dynamic=False)
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))

    def call():
        return flex(qt, kt, vt, score_mod=score_mod, block_mask=block,
                    enable_gqa=True)
    return call, lambda: call().transpose(1, 2)


def flex_cases(torch, ref, randn) -> list:
    """(what, flex call in (B, S, H, D), plain capped version, plain
    uncapped version) at cap 5 with queries scaled by 4, where the cap
    moves the output by about a value's size: that the library call of
    :func:`flex_capped` computes the kernels' function (the window, the
    causal mask and ring decode at gemma3-27b's head dim, GQA)."""
    dt, cases = torch.bfloat16, []
    # a mask function of its own for each mask: the compiled call is reused
    # for a mask of the same code, whatever its defaults hold (one function
    # with w as a default ran the window case with the causal case's kernel
    # on an H100)
    for what, sq, hq, hkv, w, mask in (
            ("causal", 300, 8, 4, None, lambda b, h, qi, ki: qi >= ki),
            ("window 64", 300, 8, 4, 64,
             lambda b, h, qi, ki: (qi >= ki) & (qi - ki < 64))):
        q = randn((1, sq, hq, 128), dt, 4.0)
        k, v = randn((1, sq, hkv, 128), dt), randn((1, sq, hkv, 128), dt)
        cases.append((what, flex_capped(torch, 5.0, q, k, v, mask)[1],
                      lambda q=q, k=k, v=v, w=w:
                          ref.attention(q, k, v, window=w, softcap=5.0),
                      lambda q=q, k=k, v=v, w=w:
                          ref.attention(q, k, v, window=w)))
    lens = [300, 53, 1, 129]
    q = randn((4, 1, 8, 128), dt, 4.0)
    k, v = randn((4, 300, 2, 128), dt), randn((4, 300, 2, 128), dt)
    n = torch.tensor(lens, dtype=torch.int32, device="cuda")
    cases.append((f"decode lengths={lens}",
                  flex_capped(torch, 5.0, q, k, v,
                              lambda b, h, qi, ki: ki < n[b], batch=4)[1],
                  lambda: ref.decode_attention(q, k, v, n, softcap=5.0),
                  lambda: ref.decode_attention(q, k, v, n)))
    return cases


#: row 9b-cap of PERF.md §6: the full mask with the softcap fragment, at
#: the full-mask kernel's timed shape (vit-b16's 196 tokens, 12 heads of
#: 64) and Gemma 2's attention cap
FULL_ROW = dict(b=1, s=196, h=12, d=64, cap=50.0)
#: the H100's peaks the capped bound reads (chip_smoke.py's PEAK_FLOPS)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def full_row(torch, ops, ref, randn) -> dict:
    """Row 9b-cap: the capped full-mask kernel at q,k,v[1,196,12,64] bf16,
    cap 50, timed on ``graph.Timer`` (device median of 20 launches, the L2
    flushed before each) beside the uncapped kernel, the plain version,
    uncapped SDPA (a reference only) and its library call, compiled
    ``flex_attention`` with the cap as its score modification and no mask
    (:func:`flex_capped`), with its distance from the plain version. The
    bound is the largest of the bytes' time (q, k, v read once, the output
    written once), the products' at the bf16 rate and the cap's three f32
    operations a score (division, tanh, product) at the f32 rate, as
    chip_smoke.py's capped rows give theirs."""
    import torch.nn.functional as F

    from repro_torch.core.graph import Timer
    from repro_torch.core.hardware import H100

    b, s, h, d, cap = (FULL_ROW[k] for k in ("b", "s", "h", "d", "cap"))
    q, k, v = (randn((b, s, h, d), torch.bfloat16) for _ in range(3))
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    flex, flex_out = flex_capped(torch, cap, q, k, v, None)
    plain = ref.attention(q, k, v, causal=False, softcap=cap).float()
    got = ops.attention_full(q, k, v, softcap=cap).float()
    timer = Timer()
    nbytes = 2 * 4 * b * s * h * d
    flops = 2 * b * h * s * s * 2 * d
    t_bytes = nbytes / H100.hbm_bw
    t_ops = max(flops / PEAK_FLOPS["bfloat16"],
                3 * b * h * s * s / PEAK_FLOPS["float32"])
    row = dict(row="9b-cap", shape=f"q,k,v[{b},{s},{h},{d}] bf16 full "
               f"softcap={cap}",
               ms=timer(lambda: ops.attention_full(q, k, v, softcap=cap)),
               uncapped_ms=timer(lambda: ops.attention_full(q, k, v)),
               plain_ms=timer(lambda: ref.attention(q, k, v, causal=False,
                                                    softcap=cap)),
               library_ms=timer(flex),
               sdpa_uncapped_ms=timer(
                   lambda: F.scaled_dot_product_attention(qt, kt, vt)),
               eager_ms=timer.eager(
                   lambda: ops.attention_full(q, k, v, softcap=cap)),
               bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               max_abs_err=float((got - plain).abs().max()),
               library_max_abs_err=float(
                   (flex_out().float() - plain).abs().max()))
    return row


def refusals(torch, ops) -> list:
    """(what, launch) of the capped calls the kernels must refuse: the
    wide instantiations, MLA's prefill (192, 128) and absorbed decode (576,
    512 / G 16), recurrentgemma's window and decode at 256, and a cap <= 0."""
    def t(*shape):
        return torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
    n = torch.ones(4, dtype=torch.int32, device="cuda")
    return [
        ("attention_core (192, 128)", lambda: ops.attention_core(
            t(1, 16, 16, 192), t(1, 16, 16, 192), t(1, 16, 16, 128),
            softcap=50.0)),
        ("attention_window (256, 256)", lambda: ops.attention_window(
            t(1, 16, 10, 256), t(1, 16, 1, 256), t(1, 16, 1, 256), 8,
            softcap=50.0)),
        ("decode_core (576, 512) G 16", lambda: ops.decode_core(
            t(4, 1, 16, 576), t(4, 32, 1, 576), t(4, 32, 1, 512), n,
            softcap=50.0)),
        ("decode_core (256, 256) G 10", lambda: ops.decode_core(
            t(4, 1, 10, 256), t(4, 32, 1, 256), t(4, 32, 1, 256), n,
            softcap=50.0)),
        ("attention_core softcap 0", lambda: ops.attention_core(
            t(1, 16, 4, 64), t(1, 16, 4, 64), t(1, 16, 4, 64), softcap=0.0)),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas-dir", default="build",
                    help="where nvcc -Xptxas -v's reports are written")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("softcap_check: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import norm_timing as nt
    from repro_torch.kernels import _build, ops, ref

    t0 = time.time()
    _build.build()
    print(json.dumps({"build_s": round(time.time() - t0, 2)}), flush=True)
    out = Path(args.ptxas_dir)
    out.mkdir(parents=True, exist_ok=True)
    for src in ("attention", "attention_softcap", "decode", "decode_softcap"):
        for r in nt.ptxas_report(REPO / f"src/repro_torch/kernels/csrc/{src}.cu",
                                 out / f"ptxas_{src}.txt"):
            print(json.dumps(dict(source=src, **r)), flush=True)

    gen = torch.Generator("cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def randn(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dt)

    bad = 0
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[1]
        atol0, rtol = TOL[name]
        for kernel, fn, plain, case, kw in softcap_cases(torch, ops, ref, randn,
                                                         dt, sms):
            got, want = fn().float(), plain().float()
            torch.cuda.synchronize()
            err = (got - want).abs()
            atol = atol0
            if kw.get("rms_scaled"):
                atol *= min(1.0, float(want.square().mean().sqrt()))
            ok = bool((err <= atol + rtol * want.abs()).all())
            dead = want.abs().amax(-1) == 0
            zeros_ok = bool((got[dead] == 0).all())
            ok = ok and zeros_ok and bool(got.isfinite().all())
            bad += not ok
            print(json.dumps({"kernel": kernel, "case": case, "dtype": name,
                              "max_abs_err": float(err.max()), "atol": atol,
                              "zero_rows": int(dead.sum()),
                              "zero_rows_exact": zeros_ok, "ok": ok}),
                  flush=True)
    atol, rtol = TOL["bfloat16"]
    for what, fn, plain, uncapped in flex_cases(torch, ref, randn):
        got = fn().float()
        want, other = plain().float(), uncapped().float()
        err = float((got - want).abs().max())
        ok = bool(((got - want).abs() <= atol + rtol * want.abs()).all())
        bad += not ok
        print(json.dumps({"library": "flex_attention softcap=5.0", "case": what,
                          "max_abs_err": err,
                          "capped_vs_uncapped": float((want - other).abs().max()),
                          "ok": ok}), flush=True)
    for what, fn in refusals(torch, ops):
        try:
            fn()
            torch.cuda.synchronize()
            refused = None
        except (ValueError, RuntimeError) as e:
            refused = str(e)
        bad += refused is None
        print(json.dumps({"refusal": what, "refused": refused}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps(dict(full_row(torch, ops, ref, randn), nvidia_smi=smi)),
          flush=True)
    print(f"bad {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
