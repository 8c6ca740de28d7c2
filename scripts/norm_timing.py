"""Device times of the row-norm kernels of ``csrc/norms.cu`` on one GPU.

Times each row norm of the port (``rms_norm``, ``fused_add_rms_norm``,
``dequant_add_rms_norm``, ``layer_norm``, ``fused_add_layer_norm``) at the
main path's shapes with ``core/graph.Timer`` (device time, L2 flushed,
median of 20), beside its plain version, the one PyTorch call that
computes the same function where there is one (``F.rms_norm``,
``F.layer_norm``), its byte bound and the body the launch plan picked;
and an empty kernel on the same timer, the launch floor. ``chip_smoke.py``
phase 5 prints these rows through :func:`time_row_norms`.

    python3 scripts/norm_timing.py                       # this tree
    python3 scripts/norm_timing.py --src DIR/src --label parent
    python3 scripts/norm_timing.py --ptxas build/ptxas.txt

``--src`` times another tree's kernels (an unpacked ``git archive`` of a
parent commit, say), so that two versions are compared in one run on one
card; run them in turns (parent, change, change, parent). ``--ptxas``
first compiles this tree's ``csrc/norms.cu`` with ``nvcc -Xptxas -v``,
writes the compiler's report to the file named and prints each kernel's
registers and spills. Prints JSON lines; needs a GPU.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

F32_FLOPS = 67e12                  # outside the tensor cores


@functools.lru_cache(maxsize=None)
def _h100():
    """This tree's ``core/hardware.H100``, loaded from its file: ``--src``
    may put a tree without it first on the path, and the package import
    would pull in that tree's kernels."""
    path = Path(__file__).resolve().parents[1] / "src/repro_torch/core/hardware.py"
    spec = importlib.util.spec_from_file_location("_norm_timing_hardware", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod        # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod.H100


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / _h100().hbm_bw, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_row_norms(torch, ops, ref, entry, gen, norms=None) -> dict:
    """{key: entry(...)} for every case; ``entry(shape, kernel, plain,
    library, nbytes, flops)`` times one (chip_smoke.py's, or :func:`main`'s).
    The first five keys are the kernels line's rows (the decode step's
    shapes and the Table-2 dequant row); the others are the shapes where
    the old template lost most: gemma3-27b's qk-norm and block norms at
    s2048, the Table-2 Segformer row, bert-base at b8. ``norms``: the
    tree's ``kernels.norms``; with its ``empty_kernel`` an ``empty kernel``
    row is added, and every row names the plan's body."""
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    lib_rms = hasattr(F, "rms_norm")

    def randn(shape, dt=bf16, mean=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") + mean).to(dt)

    def body(x, dt):
        if norms is None or not hasattr(norms, "row_norm_plan"):
            return {}
        return {"body": norms.plan_for(x, dt).body}

    out = {}

    def rms(key, shape, what, zc=False, dt=bf16):
        x, w = randn(shape, dt), randn(shape[-1:], dt)
        d, n = shape[-1], x.numel()
        w1 = (1.0 + w.float()).to(dt)   # the scale F.rms_norm is given
        lib = (lambda: F.rms_norm(x, (d,), w1 if zc else w, 1e-6)) if lib_rms else None
        out[key] = entry(what, lambda: ops.rms_norm(x, w, zero_centered=zc),
                         lambda: ref.rms_norm(x, w, zero_centered=zc), lib,
                         2 * n * x.element_size() + d * w.element_size(), 4 * n)
        out[key].update(body(x, dt))

    def ln(key, shape, what, dt=bf16, mean=0.0):
        x = randn(shape, dt, mean)
        w, b = randn(shape[-1:], dt), randn(shape[-1:], dt)
        d, n = shape[-1], x.numel()
        out[key] = entry(what, lambda: ops.layer_norm(x, w, b),
                         lambda: ref.layer_norm(x, w, b),
                         lambda: F.layer_norm(x, (d,), w, b, 1e-5),
                         2 * n * x.element_size() + 2 * d * w.element_size(), 8 * n)
        out[key].update(body(x, dt))

    # the kernels line: the decode step's (4 slots, 1 token) rows
    rms("rms_norm", (4, 1, 4096), "x[4,1,4096] bf16 (llama2-7b decode step)")
    rows, d = 4, 4096
    x, res, w = randn((rows, 1, d)), randn((rows, 1, d)), randn((d,))
    out["fused_add_rms_norm"] = entry(
        "x,res[4,1,4096] bf16 (llama2-7b fused decode step)",
        lambda: ops.fused_add_rms_norm(x, res, w),
        lambda: ref.fused_add_rms_norm(x, res, w), None,
        2 * (4 * rows * d) + 2 * d, 5 * rows * d)
    out["fused_add_rms_norm"].update(body(x, bf16))
    ln("layer_norm", (4, 1, 1600), "x[4,1,1600] bf16 (gpt2-xl decode step)")
    d = 1600
    x, res, w, b = randn((rows, 1, d)), randn((rows, 1, d)), randn((d,)), randn((d,))
    out["fused_add_layer_norm"] = entry(
        "x,res[4,1,1600] bf16 (gpt2-xl fused decode step)",
        lambda: ops.fused_add_layer_norm(x, res, w, b),
        lambda: ref.fused_add_layer_norm(x, res, w, b), None,
        2 * (4 * rows * d) + 2 * 2 * d, 9 * rows * d)
    out["fused_add_layer_norm"].update(body(x, bf16))
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
    out["dequant_add_rms_norm"].update(body(q, bf16))
    # lines of their own
    rms("rms_norm qk-norm", (1, 2048, 32, 128),
        "q[1,2048,32,128] bf16 (gemma3-27b qk-norm, s2048)")
    rms("rms_norm block", (1, 2048, 5376),
        "x[1,2048,5376] bf16 zero_centered (gemma3-27b block norms, s2048)", zc=True)
    ln("layer_norm segformer", (2, 16384, 32),
       "x[2,16384,32] f32 (Table-2 Segformer row)", dt=torch.float32)
    ln("layer_norm bert", (8, 128, 768), "x[8,128,768] bf16 mean 3 (bert-base b8)",
       mean=3.0)
    if norms is not None and hasattr(norms, "empty_kernel"):
        dev = torch.device("cuda", torch.cuda.current_device())
        out["empty kernel"] = entry("<<<1, 32>>> of an empty kernel (launch floor)",
                                    lambda: norms.empty_kernel(dev), None, None, 0, 0)
    return out


#: (kernel, shape, dtype) that --bodies times under every body that can
#: take them: the decode step's, the short prefills', the encoders' and
#: vision's rows, gemma3-27b's s2048 rows, the Table-2 Segformer row
BODY_CASES = [("layer_norm", (4, 1, 1600), "bfloat16"),
              ("fused_add_layer_norm", (4, 1, 1600), "bfloat16"),
              ("layer_norm", (1, 16, 1600), "bfloat16"),
              ("layer_norm", (1, 256, 1600), "bfloat16"),
              ("layer_norm", (1, 128, 768), "bfloat16"),
              ("layer_norm", (8, 128, 768), "bfloat16"),
              ("layer_norm", (8, 197, 768), "bfloat16"),
              ("layer_norm", (1, 256, 384), "bfloat16"),
              ("layer_norm", (8, 256, 384), "bfloat16"),
              ("layer_norm", (2, 16384, 32), "float32"),
              ("rms_norm", (4, 1, 4096), "bfloat16"),
              ("fused_add_rms_norm", (4, 1, 4096), "bfloat16"),
              ("rms_norm", (1, 16, 4096), "bfloat16"),
              ("rms_norm", (4, 1, 5376), "bfloat16"),
              ("rms_norm", (1, 2048, 5376), "bfloat16"),
              ("rms_norm", (1, 2048, 32, 128), "bfloat16"),
              ("rms_norm", (1, 16, 32, 128), "bfloat16")]


def time_bodies(torch, ops, norms, timer, gen):
    """{(kernel, shape, dtype): {body: ms}} over BODY_CASES, each launch
    given the plan of every body that can take its rows (body_plan)."""
    planned = norms.row_norm_plan
    out = {}
    try:
        for kernel, shape, dtn in BODY_CASES:
            dt = getattr(torch, dtn)
            x = torch.randn(shape, generator=gen, device="cuda").to(dt)
            res = torch.randn(shape, generator=gen, device="cuda").to(dt)
            w, b = (torch.randn(shape[-1:], generator=gen, device="cuda").to(dt)
                    for _ in "wb")
            call = {"layer_norm": lambda: ops.layer_norm(x, w, b),
                    "fused_add_layer_norm": lambda: ops.fused_add_layer_norm(x, res, w, b),
                    "rms_norm": lambda: ops.rms_norm(x, w),
                    "fused_add_rms_norm": lambda: ops.fused_add_rms_norm(x, res, w)}[kernel]
            plan = norms.plan_for(x, dt, res, w, b)
            times = {}
            for body in norms.BODY_CODE:
                try:
                    norms.body_plan(body, 1, shape[-1], dt, plan.width > 1, 1)
                except ValueError:
                    continue
                norms.row_norm_plan = functools.partial(norms.body_plan, body)
                try:
                    times[body] = timer(call)
                finally:
                    norms.row_norm_plan = planned
            out[(kernel, shape, dtn)] = dict(times, plan=plan.body)
    finally:
        norms.row_norm_plan = planned
    return out


def ptxas_report(src: Path, dest: Path) -> list:
    """Compile ``src`` with ``nvcc -Xptxas -v`` and the build's own flags
    (``kernels/_build.py`` of this tree), write the report to ``dest``;
    one {kernel, spill_stores, spill_loads, registers} per entry function."""
    spec = importlib.util.spec_from_file_location("_norm_timing_build",
                                                  src.parents[1] / "_build.py")
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    nvcc = Path(build._nvcc())
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [str(nvcc), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
           str(build.BUILD_DIR / "ptxas-report.so"), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True, check=True)
    text = done.stdout + done.stderr
    dest.write_text(text)
    rows, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            rows.append({"kernel": name, "spill_stores": int(m.group(1)),
                         "spill_loads": int(m.group(2))})
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and rows[-1]["kernel"] == name and "registers" not in rows[-1]:
            rows[-1]["registers"] = int(m.group(1))
    filt = nvcc.with_name("cu++filt")
    if filt.exists():
        names = subprocess.run([str(filt)], input="\n".join(r["kernel"] for r in rows),
                               capture_output=True, text=True).stdout.splitlines()
        for r, nm in zip(rows, names):
            r["kernel"] = nm
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"),
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--ptxas", metavar="FILE",
                    help="first write nvcc -Xptxas -v's report on this tree's "
                         "csrc/norms.cu to FILE and print registers and spills")
    ap.add_argument("--bodies", action="store_true",
                    help="instead, time BODY_CASES under every body of "
                         "csrc/norms.cu that can take them")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("norm_timing: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.ptxas:
        here = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc/norms.cu"
        rows = ptxas_report(here, Path(args.ptxas).resolve())
        for r in rows:
            print(json.dumps({"ptxas": r}), flush=True)
        worst = max((r["spill_stores"] + r["spill_loads"] for r in rows), default=0)
        print(json.dumps({"ptxas_kernels": len(rows), "max_spill_bytes": worst,
                          "max_registers": max((r.get("registers", 0) for r in rows),
                                               default=0)}), flush=True)
    sys.path.insert(0, args.src)
    from repro_torch.core import graph
    from repro_torch.kernels import _build, norms, ops, ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    _build.build()
    timer = graph.Timer()

    def entry(shape, kernel, plain, library, nbytes, flops):
        return dict(shape=shape, ms=timer(kernel), eager_ms=timer.eager(kernel),
                    plain_ms=None if plain is None else timer(plain),
                    library_ms=None if library is None else timer(library),
                    bound=bound_ms(nbytes, flops))

    gen = torch.Generator("cuda").manual_seed(0)
    if args.bodies:
        for (kernel, shape, dtn), times in time_bodies(torch, ops, norms, timer,
                                                       gen).items():
            print(json.dumps({"label": args.label, "kernel": kernel,
                              "shape": list(shape), "dtype": dtn, "card": smi,
                              **times}), flush=True)
        return 0
    for key, tm in time_row_norms(torch, ops, ref, entry, gen, norms).items():
        b_ms, b_by = tm.pop("bound")
        print(json.dumps({"label": args.label, "kernel": key, "card": smi, **tm,
                          "bound_ms": b_ms, "bound_by": b_by}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
