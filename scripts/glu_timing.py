"""Device times of the gated activations (``csrc/swiglu.cu``) on one GPU.

Times ``swiglu`` and ``geglu`` at the main path's shapes: llama2-7b's
decode step gate,up[4,1,11008] and its served prefill bucket
[1,256,11008], gemma3-27b's fused decode step [4,1,21504] and its served
prefill at the 2048 bucket [1,2048,21504], all bf16, with
``core/graph.Timer`` (device time, L2 flushed, median of 20), beside the
plain version, the bound of the bytes, ``torch.mul`` of the same operands
(a yardstick of the same bytes: two reads and one write, not the same
function) and an empty kernel on the same timer (the launch floor). Each
row names the launch plan (``swiglu.glu_plan``, where the tree has one).
``chip_smoke.py`` phase 5 prints these rows through :func:`time_glu`.

    python3 scripts/glu_timing.py                        # this tree
    python3 scripts/glu_timing.py --src DIR/src --label parent
    python3 scripts/glu_timing.py --ptxas build/ptxas_glu.txt
    python3 scripts/glu_timing.py --plans                # candidate plans

``--src`` times another tree's kernels (an unpacked ``git archive`` of a
parent commit, say), so that two versions are compared in one run on one
card; run them in turns (parent, change, change, parent). ``--ptxas``
first compiles that tree's ``csrc/swiglu.cu`` with ``nvcc -Xptxas -v``,
writes the report to the file named and prints each kernel's registers
and spills, and, where the toolkit has ``cuobjdump``, the SASS
instructions of each kernel's vector step (:func:`sass_steps`).
``--plans`` times every candidate plan (:func:`candidate_plans`: the
8-byte accesses in CTAs of 64, 128 and 256) at each shape in three
rounds, each checked against the plain version first. Prints JSON lines;
needs a GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SEED = 0
#: (key, kernel, shape, what): the first two are the kernels line's rows
SHAPES = [("swiglu", "swiglu", (4, 1, 11008), "llama2-7b decode step"),
          ("geglu", "geglu", (4, 1, 21504), "gemma3-27b fused decode step"),
          ("swiglu prefill", "swiglu", (1, 256, 11008),
           "llama2-7b served prefill, 256 bucket"),
          ("geglu prefill", "geglu", (1, 2048, 21504),
           "gemma3-27b fused prefill, 2048 bucket")]
#: f32 operations an element, against the bound's operations term
FLOPS = {"swiglu": 6, "geglu": 10}


def _norm_timing():
    spec = importlib.util.spec_from_file_location("norm_timing",
                                                  HERE / "norm_timing.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_glu(torch, ops, ref, entry, gen, glu=None, floor=True) -> dict:
    """{key: entry(...)} for every shape of SHAPES; ``entry(shape, kernel,
    plain, library, nbytes, flops)`` times one (chip_smoke.py's, or
    :func:`main`'s). No one PyTorch call computes either function, so
    ``library`` is None; ``mul_ms`` is ``torch.mul`` of the same operands
    on the same timer. ``glu``: the tree's ``kernels.swiglu`` (each row
    then names its plan); ``floor``: add the empty kernel."""
    out = {}
    for key, kernel, shape, what in SHAPES:
        g = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        u = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        n = g.numel()
        fn, plain = getattr(ops, kernel), getattr(ref, kernel)
        out[key] = entry(f"gate,up{list(shape)} bf16 ({what})",
                         lambda: fn(g, u), lambda: plain(g, u), None,
                         3 * 2 * n, FLOPS[kernel] * n)
        out[key]["mul_ms"] = entry("torch.mul of the same operands",
                                   lambda: torch.mul(g, u), None, None, 0, 0)["ms"]
        if glu is not None and hasattr(glu, "plan_for"):
            out[key]["plan"] = glu.plan_for(g, u)._asdict()
    if floor:
        from repro_torch.kernels import norms
        dev = torch.device("cuda", torch.cuda.current_device())
        out["empty kernel"] = entry("<<<1, 32>>> of an empty kernel (launch floor)",
                                    lambda: norms.empty_kernel(dev), None, None, 0, 0)
    return out


def candidate_plans(glu, n: int) -> dict:
    """{name: GluPlan} of the launches timed for ``n`` bf16 elements: one
    step of 8-byte accesses at every CTA size the kernel takes, the plan's
    pick among them (16- and 4-byte accesses lost to 8: PERF.md §6)."""
    w = 8 // 2
    return {f"8 B x {threads}": glu.GluPlan(w, threads, max(1, -(-(n // w) // threads)))
            for threads in (64, 128, 256)}


def time_plans(torch, ops, ref, glu, timer, gen, tol, rounds=3) -> list:
    """[row] of every candidate plan at each shape of SHAPES, ``rounds``
    times in turns, each first held against the plain version at ``tol``
    = (atol, rtol); ``pick`` marks the plan's own."""
    planned = glu.glu_plan
    rows = []
    try:
        for _, kernel, shape, _ in SHAPES:
            g = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
            u = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
            fn = getattr(ops, kernel)
            want = getattr(ref, kernel)(g, u).float()
            pick = glu.plan_for(g, u)
            plans = candidate_plans(glu, g.numel())
            for r in range(rounds):
                for name, p in plans.items():
                    glu.glu_plan = lambda *a, p=p: p
                    if r == 0:
                        got = fn(g, u).float()
                        err = (got - want).abs()
                        if not bool((err <= tol[0] + tol[1] * want.abs()).all()):
                            raise RuntimeError(f"{kernel} {shape} under {p} disagrees: "
                                               f"max err {float(err.max())}")
                    rows.append(dict(kernel=kernel, shape=list(shape), candidate=name,
                                     pick=p == pick, round=r,
                                     ms=timer(lambda: fn(g, u)), **p._asdict()))
    finally:
        glu.glu_plan = planned
    return rows


def sass_steps(text: str) -> list:
    """{kernel, instructions, step, step_mufu, calls} per kernel of a
    ``cuobjdump -sass`` listing: ``step`` is the vector step, the
    instructions from the kernel's first global load to its first global
    store (in a walking kernel, its loop's body), ``step_mufu`` the MUFU
    among them, ``calls`` the subroutine calls in the kernel."""
    rows = []
    for f in re.split(r"\n\s*Function : ", text)[1:]:
        ops = [m.group(1) for m in
               re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", f)]
        ops = [op for op in ops if not op.startswith("NOP")]
        first = next((k for k, op in enumerate(ops) if "LDG" in op), None)
        last = next((k for k, op in enumerate(ops) if "STG" in op), None)
        step = ops[first:last + 1] if first is not None and last is not None else []
        rows.append({"kernel": f.split("\n", 1)[0].strip(), "instructions": len(ops),
                     "step": len(step), "step_mufu": sum("MUFU" in op for op in step),
                     "calls": sum("CALL" in op for op in ops)})
    return rows


def cuobjdump():
    """The toolkit's cuobjdump, or None."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return tool if Path(tool).exists() else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(HERE.parent / "src"),
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--ptxas", metavar="FILE",
                    help="first write nvcc -Xptxas -v's report on that tree's "
                         "csrc/swiglu.cu to FILE and print registers, spills "
                         "and the SASS instructions of each kernel's vector step")
    ap.add_argument("--plans", action="store_true",
                    help="also time every candidate plan at each shape")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("glu_timing: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    nt = _norm_timing()
    src = Path(args.src).resolve()
    if args.ptxas:
        dest = Path(args.ptxas).resolve()
        cu = src / "repro_torch/kernels/csrc/swiglu.cu"
        rows = nt.ptxas_report(cu, dest)
        for r in rows:
            print(json.dumps({"label": args.label, "ptxas": r}), flush=True)
        print(json.dumps({"label": args.label, "ptxas_kernels": len(rows),
                          "max_spill_bytes": max((r["spill_stores"] + r["spill_loads"]
                                                  for r in rows), default=0),
                          "max_registers": max((r.get("registers", 0) for r in rows),
                                               default=0)}), flush=True)
        so = src.parent / "build/repro_torch_kernels/ptxas-report.so"
        tool = cuobjdump()
        if tool:
            text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                                  text=True, check=True).stdout
            for r in sass_steps(text):
                print(json.dumps({"label": args.label, "sass": r}), flush=True)
    sys.path.insert(0, str(src))
    from repro_torch.core import graph
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import swiglu as glu

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    _build.build()
    timer = graph.Timer()

    def entry(shape, kernel, plain, library, nbytes, flops):
        return dict(shape=shape, ms=timer(kernel), eager_ms=timer.eager(kernel),
                    plain_ms=None if plain is None else timer(plain),
                    library_ms=None if library is None else timer(library),
                    bound=nt.bound_ms(nbytes, flops))

    gen = torch.Generator("cuda").manual_seed(SEED)
    for key, tm in time_glu(torch, ops, ref, entry, gen, glu).items():
        b_ms, b_by = tm.pop("bound")
        print(json.dumps({"label": args.label, "kernel": key, "card": smi, **tm,
                          "bound_ms": b_ms, "bound_by": b_by}), flush=True)
    if args.plans and hasattr(glu, "glu_plan"):
        tol = (3e-2, 2 ** -7)               # bf16: chip_smoke.py's TOL
        for row in time_plans(torch, ops, ref, glu, timer, gen, tol):
            print(json.dumps({"label": args.label, "glu_plan": row["candidate"],
                              "card": smi, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
