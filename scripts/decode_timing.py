"""Device times of decode's wide body (``csrc/decode.cu``, MLA's absorbed
decode) on one GPU.

Times ``decode_core`` at deepseek-v2-lite-16b's absorbed decode: q
[4,1,16,576] over one latent KV head, keys 576 and values 512 wide, scale
1/sqrt(192), a 512-deep cache at the serve run's lengths [186, 144, 120,
72] and full, and one row over 4096 keys. Each row gives, with
``core/graph.Timer`` (device time, L2 flushed, median of 20), the kernel,
its eager wrapper (host clock), the plain version, SDPA with the mask
spelled out and the KV head expanded to the 16 query heads, the bound of
the bytes, the body that ran and the launch plan (n_split, chunk).

    python3 scripts/decode_timing.py                        # this tree
    python3 scripts/decode_timing.py --src DIR/src --label parent
    python3 scripts/decode_timing.py --ptxas build/ptxas_decode.txt
    python3 scripts/decode_timing.py --plans                # candidate plans

``--src`` times another tree's kernel (an unpacked ``git archive`` of a
parent commit, say), so that two versions are compared in one run on one
card; run them in turns (parent, change, change, parent). ``--ptxas``
first compiles that tree's ``csrc/decode.cu`` with ``nvcc -Xptxas -v``,
writes the report to the file named and prints each kernel's registers
and spills. ``--plans`` times every candidate split of the serve lengths' 512-deep
cache and of the 4096-key row (one 32-key tile a split up to one split a
row) in three rounds, each
checked against the plain version first, and, beside the plan's own, its
no-merge twin: every split a row of its own (the same CTAs and bytes, one
split each), so that the difference is the cost of the merge. Prints JSON
lines; needs a GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SEED = 0
#: MLA's absorbed decode: heads, Dk (512 latent + 64 rope), Dv, cache depth
HEADS, DK, DV, DEPTH = 16, 576, 512, 512
SCALE = 1.0 / math.sqrt(192)
#: (key, rows, depth, lengths, what): the first is chip_smoke.py's row
CASES = [("decode_core mla", 4, DEPTH, [186, 144, 120, 72],
          "deepseek-v2-lite serve lengths"),
         ("decode_core mla full", 4, DEPTH, [DEPTH] * 4, "a full 512-deep cache"),
         ("decode_core mla 4096", 1, 4096, [4096], "one row over 4096 keys")]
#: chip_smoke.py's bf16 rule, |kernel - plain| <= atol + rtol * |plain|
TOL = (3e-2, 2 ** -7)
#: the H100's dense bf16 tensor-core peak (chip_smoke.py's PEAK_FLOPS)
BF16_FLOPS = 989e12


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, HERE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(torch, gen, b: int, t: int, lengths: list):
    """q, k, v ~ N(0, 1) in bf16 and int32 lengths on the card."""
    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    q = randn((b, 1, HEADS, DK))
    k, v = randn((b, t, 1, DK)), randn((b, t, 1, DV))
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device="cuda")


def nbytes(b: int, lengths: list) -> int:
    """q read once, the valid K and V rows read once, o written once."""
    return 2 * (b * HEADS * DK + sum(lengths) * (DK + DV) + b * HEADS * DV)


def flops(lengths: list) -> int:
    """The scores and P.V over the valid keys, every head."""
    return 2 * sum(lengths) * HEADS * (DK + DV)


def time_mla(torch, ops, ref, entry, gen, attn=None) -> dict:
    """{key: entry(...)} for every case of CASES; ``entry(shape, kernel,
    plain, library, nbytes, flops)`` times one (chip_smoke.py's, or
    :func:`main`'s). ``library`` is SDPA with the mask spelled out and the
    KV head expanded to the query heads. ``attn``: the tree's
    ``kernels.attn_template`` (each row then names its body and plan)."""
    import torch.nn.functional as F

    out = {}
    for key, b, t, lens, what in CASES:
        q, k, v, n = inputs(torch, gen, b, t, lens)
        mask = (torch.arange(t, device="cuda")[None] < n[:, None])[:, None, None, :]
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (a.expand(b, t, HEADS, a.shape[3]).transpose(1, 2).contiguous()
                  for a in (k, v))
        out[key] = entry(
            f"q[{b},1,{HEADS},{DK}] kv[{b},{t},1,{DK}/{DV}] bf16 lengths={lens} "
            f"scale=1/sqrt(192) ({what})",
            lambda: ops.decode_core(q, k, v, n, scale=SCALE),
            lambda: ref.decode_attention(q, k, v, n, scale=SCALE),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                   scale=SCALE),
            nbytes(b, lens), flops(lens), "bfloat16")
        if attn is not None and hasattr(attn, "decode_plan"):
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            out[key]["body"] = attn.decode_body(DK, DV, q.dtype)
            out[key]["plan"] = list(attn.decode_plan(b, HEADS, 1, t, DK, DV, sms))
        del q, k, v, n, mask, qt, kt, vt
    return out


def candidates(depth: int, tile: int = 32) -> dict:
    """{name: (n_split, chunk)} of a cache ``depth`` deep: from one tile a
    split to one split a row, doubling."""
    out, c = {}, tile
    while c < 2 * depth:
        c = min(c, depth)
        out[f"{c // tile} tiles a split"] = (-(-depth // c), c)
        c *= 2
    return out


def twin_lengths(lengths: list, n_split: int, chunk: int) -> list:
    """The keys each split of ``lengths`` sees, a row each: the no-merge twin."""
    return [max(0, min(chunk, n - s * chunk)) for n in lengths for s in range(n_split)]


def time_plans(torch, ops, ref, attn, timer, gen, rounds=3) -> list:
    """[row] of every candidate plan at the serve lengths and the 4096-key
    row of CASES, ``rounds`` times in turns, each first held against the
    plain version at TOL; ``pick`` marks the plan's own. Then each picked
    plan's no-merge twin."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for key, b, t, lens, _ in (CASES[0], CASES[2]):
        q, k, v, n = inputs(torch, gen, b, t, lens)
        want = ref.decode_attention(q, k, v, n, scale=SCALE).float()
        pick = tuple(attn.decode_plan(b, HEADS, 1, t, DK, DV, sms))
        for r in range(rounds):
            for name, plan in candidates(t, attn.DECODE_WIDE_TILE).items():
                def call(plan=plan):
                    return attn.decode_core(q, k, v, n, SCALE, plan=plan)
                if r == 0:
                    err = (call().float() - want).abs()
                    if not bool((err <= TOL[0] + TOL[1] * want.abs()).all()):
                        raise RuntimeError(f"decode_core under {name} {plan} "
                                           f"disagrees: max err {float(err.max())}")
                rows.append(dict(case=key, candidate=name, n_split=plan[0],
                                 chunk=plan[1], ctas=b * plan[0],
                                 pick=plan == pick, round=r, ms=timer(call)))
        if pick[0] > 1:
            tl = twin_lengths(lens, *pick)
            tq = q.repeat_interleave(pick[0], dim=0)
            tk, tv = (a.reshape(b * pick[0], pick[1], 1, a.shape[3])
                      for a in (k[:, :pick[0] * pick[1]], v[:, :pick[0] * pick[1]]))
            tn = torch.tensor(tl, dtype=torch.int32, device="cuda")
            for r in range(rounds):
                rows.append(dict(case=key, candidate=f"no-merge twin of "
                                 f"{list(pick)}: kv{list(tk.shape)}", n_split=1,
                                 chunk=pick[1], ctas=len(tl), pick=False, round=r,
                                 ms=timer(lambda: attn.decode_core(
                                     tq, tk, tv, tn, SCALE, plan=(1, pick[1])))))
        del q, k, v, n, want
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(HERE.parent / "src"),
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--ptxas", metavar="FILE",
                    help="first write nvcc -Xptxas -v's report on that tree's "
                         "csrc/decode.cu to FILE and print registers and spills")
    ap.add_argument("--plans", action="store_true",
                    help="also time every candidate plan and the no-merge twin")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("decode_timing: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    nt = _script("norm_timing")
    src = Path(args.src).resolve()
    if args.ptxas:
        for r in nt.ptxas_report(src / "repro_torch/kernels/csrc/decode.cu",
                                 Path(args.ptxas).resolve()):
            print(json.dumps({"label": args.label, "ptxas": r}), flush=True)
    sys.path.insert(0, str(src))
    from repro_torch.core import graph
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import attn_template as attn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    _build.build()
    timer = graph.Timer()

    def entry(shape, kernel, plain, library, nb, fl, peak):
        t_bytes, t_ops = nb / nt._h100().hbm_bw, fl / BF16_FLOPS
        return dict(shape=shape, ms=timer(kernel), eager_ms=timer.eager(kernel),
                    plain_ms=None if plain is None else timer(plain),
                    library_ms=None if library is None else timer(library),
                    bound=(max(t_bytes, t_ops) * 1e3,
                           "bytes" if t_bytes >= t_ops else "operations"))

    gen = torch.Generator("cuda").manual_seed(SEED)
    for key, tm in time_mla(torch, ops, ref, entry, gen, attn).items():
        b_ms, b_by = tm.pop("bound")
        print(json.dumps({"label": args.label, "kernel": key, "card": smi, **tm,
                          "bound_ms": b_ms, "bound_by": b_by}), flush=True)
    if args.plans and hasattr(attn, "decode_plan"):
        for row in time_plans(torch, ops, ref, attn, timer, gen):
            print(json.dumps({"label": args.label, "decode_plan": row["candidate"],
                              "card": smi, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
