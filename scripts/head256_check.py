"""The attention kernels at head dim 256 (recurrentgemma-2b's local
layers) on one GPU: build, registers, agreement, time.

Builds the kernels, prints ``nvcc -Xptxas -v``'s registers and spills of
the (256, 256) instantiations of ``csrc/attention.cu`` (the window
fragment) and ``csrc/decode.cu`` (the wide bodies at a group of 10),
holds ``attention_window`` at q[1,S,10,256] kv[1,S,1,256], window 2048,
for S 7, 64, 300, 2048 and 2100, and ``decode_core`` at q[4,1,10,256]
over rings of 2048 at ragged lengths against their plain versions in
bf16 and f32, checks that the causal kernel and decode at a group of 8
refuse the pair, then times the window at S 2048 beside causal SDPA over
the one KV head expanded to 10, and decode over four full rings and four
short ones (``core/graph.Timer``: device time, L2 flushed, median of 20).
A short first check of a new instantiation, before ``chip_smoke.py``'s
phases 2 and 5 hold and time the same shapes. Prints JSON lines and
``bad N`` last (N the comparisons and refusals that failed); needs a GPU.

    python3 scripts/head256_check.py [--ptxas-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO / "scripts"))

#: |kernel - plain| limits of the checks: chip_smoke.py's atol, scaled
#: by the largest plain output (window) or by 4 (decode)
ATOL = {"bfloat16": 3e-2, "float32": 2e-5}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas-dir", default="build",
                    help="where nvcc -Xptxas -v's reports are written")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("head256_check: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import norm_timing as nt
    from repro_torch.core import graph
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import attn_template as attn

    t0 = time.time()
    _build.build()
    print(json.dumps({"build_s": round(time.time() - t0, 2)}), flush=True)
    out = Path(args.ptxas_dir)
    out.mkdir(parents=True, exist_ok=True)
    for src in ("attention", "decode"):
        for r in nt.ptxas_report(REPO / f"src/repro_torch/kernels/csrc/{src}.cu",
                                 out / f"ptxas_{src}.txt"):
            if "256" in r["kernel"] or "10, 32" in r["kernel"]:
                print(json.dumps(r), flush=True)

    gen = torch.Generator("cuda").manual_seed(0)
    bad = 0
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[1]
        for s in (7, 64, 300, 2048, 2100):
            q = torch.randn(1, s, 10, 256, generator=gen, device="cuda").to(dt)
            k = torch.randn(1, s, 1, 256, generator=gen, device="cuda").to(dt)
            v = torch.randn(1, s, 1, 256, generator=gen, device="cuda").to(dt)
            got = ops.attention_window(q, k, v, 2048).float()
            want = ref.attention(q.float(), k.float(), v.float(),
                                 window=2048).float()
            err = (got - want).abs().max().item()
            rms = want.pow(2).mean().sqrt().item()
            print(json.dumps({"window": [s, name], "err": err, "rms": rms}),
                  flush=True)
            bad += not err < ATOL[name] * max(1.0, want.abs().max().item())
        for lens in ([0, 1, 31, 32], [33, 2048, 1000, 5]):
            q = torch.randn(4, 1, 10, 256, generator=gen, device="cuda").to(dt)
            k = torch.randn(4, 2048, 1, 256, generator=gen, device="cuda").to(dt)
            v = torch.randn(4, 2048, 1, 256, generator=gen, device="cuda").to(dt)
            n = torch.tensor(lens, dtype=torch.int32, device="cuda")
            got = ops.decode_core(q, k, v, n).float()
            want = ref.decode_attention(q.float(), k.float(), v.float(),
                                        n).float()
            err = (got - want).abs().max().item()
            print(json.dumps({
                "decode": [lens, name], "err": err,
                "plan": attn.decode_plan(4, 10, 1, 2048, 256, 256,
                                         _build.sm_count(0)),
                "body": attn.decode_body(256, 256, dt)}), flush=True)
            bad += not err < ATOL[name] * 4
    q = torch.randn(1, 4, 10, 256, generator=gen, device="cuda")
    k = torch.randn(1, 4, 1, 256, generator=gen, device="cuda")
    n = torch.full((1,), 4, dtype=torch.int32, device="cuda")
    for what, call in (("causal 256", lambda: ops.attention_core(q, k, k)),
                       ("decode group 8", lambda: ops.decode_core(
                           q[:, :1, :8].contiguous(), k, k, n))):
        try:
            call()
            print(json.dumps({"not_refused": what}), flush=True)
            bad += 1
        except ValueError as e:
            print(json.dumps({"refused": what, "why": str(e)}), flush=True)

    timer = graph.Timer()
    dt, s, w = torch.bfloat16, 2048, 2048
    q = torch.randn(1, s, 10, 256, generator=gen, device="cuda").to(dt)
    k = torch.randn(1, s, 1, 256, generator=gen, device="cuda").to(dt)
    v = torch.randn(1, s, 1, 256, generator=gen, device="cuda").to(dt)
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (a.expand(1, s, 10, 256).transpose(1, 2).contiguous()
              for a in (k, v))
    print(json.dumps({
        "window_ms": timer(lambda: ops.attention_window(q, k, v, w)),
        "sdpa_ms": timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        "plain_ms": timer(lambda: ref.attention(q, k, v, window=w))}),
        flush=True)
    q1 = torch.randn(4, 1, 10, 256, generator=gen, device="cuda").to(dt)
    k1 = torch.randn(4, 2048, 1, 256, generator=gen, device="cuda").to(dt)
    v1 = torch.randn(4, 2048, 1, 256, generator=gen, device="cuda").to(dt)
    for lens in ([2048] * 4, [20, 30, 40, 50]):
        n = torch.tensor(lens, dtype=torch.int32, device="cuda")
        print(json.dumps({
            "decode_ms": timer(lambda: ops.decode_core(q1, k1, v1, n)),
            "lens": lens}), flush=True)
    torch.cuda.synchronize()
    print(f"bad {bad}", flush=True)
    return int(bad > 0)


if __name__ == "__main__":
    sys.exit(main())
