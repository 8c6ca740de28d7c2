"""Device times of the softmax cross-entropy kernel (``csrc/softmax_xent.cu``)
on one GPU.

Times ``softmax_xent`` at five shapes: the §4.5 kernel site (256, 32000)
f32; gemma3-27b's vocabulary with few rows, (8, 262144) in f32 and bf16;
gemma3-27b's ``loss_chunk=512`` at batch 1, (512, 262144) bf16; and
llama2-7b's loss over one 2048-token sequence, (2048, 32000) bf16; labels
int32. Each row gives, with ``core/graph.Timer`` (device time, L2
flushed, median of 20), the kernel, the plain version, the bound of the
bytes, ``F.cross_entropy(logits, labels, reduction="none")`` (the same
function; on bf16 logits it returns bf16) and ``torch.amax(logits, -1)``
(a yardstick that reads the same bytes once, not the same function), and
the launch plan (``softmax_xent.xent_plan``, where the tree has one). The
timer's flush leaves the L2 full of dirty lines, which a kernel reading
less than the L2 writes back as it reads; ``clean_ms`` times the kernel
after a flush followed by a read, which leaves the lines clean. An empty
kernel on the same timer gives the launch floor. ``chip_smoke.py`` phase
5 prints these rows through :func:`time_xent`.

    python3 scripts/xent_timing.py                        # this tree
    python3 scripts/xent_timing.py --src DIR/src --label parent
    python3 scripts/xent_timing.py --ptxas build/ptxas_xent.txt
    python3 scripts/xent_timing.py --plans                # candidate plans

``--src`` times another tree's kernel (an unpacked ``git archive`` of a
parent commit, say), so that two versions are compared in one run on one
card; run them in turns (parent, change, change, parent). ``--ptxas``
first compiles that tree's ``csrc/softmax_xent.cu`` with ``nvcc -Xptxas
-v``, writes the report to the file named and prints each kernel's
registers and spills, and, where the toolkit has ``cuobjdump``, the SASS
instructions a logit of each kernel's streaming loop (:func:`sass_blocks`).
``--plans`` times every candidate (:func:`candidates`) at each shape in
three rounds, each checked against the plain version first. Prints JSON
lines; needs a GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SEED = 0
#: (key, (rows, vocab), dtype, what): the first is the kernels line's row
SHAPES = [("softmax_xent", (256, 32000), "float32", "§4.5 kernel site"),
          ("softmax_xent gemma3 8 rows f32", (8, 262144), "float32",
           "gemma3-27b vocabulary, few rows"),
          ("softmax_xent gemma3 8 rows bf16", (8, 262144), "bfloat16",
           "gemma3-27b vocabulary, few rows"),
          ("softmax_xent gemma3 loss chunk", (512, 262144), "bfloat16",
           "gemma3-27b loss_chunk=512, batch 1"),
          ("softmax_xent llama2 seq", (2048, 32000), "bfloat16",
           "llama2-7b loss over one 2048-token sequence")]
#: f32 operations a logit (max, FFMA, exp, add, convert), against the
#: bound's operations term
FLOPS_PER_LOGIT = 5
#: |kernel - plain| <= atol + rtol * |plain| (f32 losses from the same
#: logits on both sides: JAX's sweep tolerance, chip_smoke.py's XENT_TOL)
TOL = (1e-5, 1e-5)


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, HERE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(torch, gen, shape, dtype: str):
    """Logits (rows, vocab) ~ N(0, 1) of ``dtype`` and int32 labels."""
    rows, vocab = shape
    x = torch.randn(shape, generator=gen, device="cuda").to(getattr(torch, dtype))
    lab = torch.randint(0, vocab, (rows,), generator=gen, device="cuda",
                        dtype=torch.int32)
    return x, lab


def nbytes(x, lab) -> int:
    """Each input read once and the f32 losses written once."""
    return x.numel() * x.element_size() + lab.numel() * lab.element_size() \
        + 4 * x.shape[0]


def time_xent(torch, ops, ref, entry, gen, xent=None, floor=True,
              clean=None) -> dict:
    """{key: entry(...)} for every shape of SHAPES; ``entry(shape, kernel,
    plain, library, nbytes, flops)`` times one (chip_smoke.py's, or
    :func:`main`'s). ``library`` is ``F.cross_entropy`` per row;
    ``amax_ms`` is ``torch.amax(logits, -1)`` on the same timer. ``xent``:
    the tree's ``kernels.softmax_xent`` (each row then names its plan);
    ``floor``: add the empty kernel; ``clean``: a timer whose flush leaves
    the L2 clean (each row then has ``clean_ms``)."""
    import torch.nn.functional as F

    out = {}
    for key, shape, dtype, what in SHAPES:
        x, lab = inputs(torch, gen, shape, dtype)
        lab64 = lab.long()
        dt = "f32" if dtype == "float32" else "bf16"
        out[key] = entry(f"logits{list(shape)} {dt}, labels int32 ({what})",
                         lambda: ops.softmax_xent(x, lab),
                         lambda: ref.softmax_xent(x, lab),
                         lambda: F.cross_entropy(x, lab64, reduction="none"),
                         nbytes(x, lab), FLOPS_PER_LOGIT * x.numel())
        out[key]["amax_ms"] = entry("torch.amax of the same logits",
                                    lambda: torch.amax(x, -1), None, None, 0,
                                    0)["ms"]
        if clean is not None:
            out[key]["clean_ms"] = clean(lambda: ops.softmax_xent(x, lab))
        if xent is not None and hasattr(xent, "xent_plan"):
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            out[key]["plan"] = xent.xent_plan(*shape, x.dtype, sms)._asdict()
        del x, lab, lab64
    if floor:
        from repro_torch.kernels import norms
        dev = torch.device("cuda", torch.cuda.current_device())
        out["empty kernel"] = entry("<<<1, 32>>> of an empty kernel (launch floor)",
                                    lambda: norms.empty_kernel(dev), None, None, 0, 0)
    return out


def clean_timer(torch, graph):
    """A ``graph.Timer`` whose flush, after zeroing its 128 MB, reads them:
    the L2 then holds clean lines of the flush buffer, and a timed kernel
    writes nothing back as it reads."""
    class Clean(graph.Timer):
        def __call__(self, fn) -> float:
            import statistics
            for _ in range(self.warmup):
                fn()
            ts = []
            for _ in range(self.iters):
                self.flush.zero_()
                self.flush.sum(dtype=torch.int64)
                ts.append(graph.time_once(fn, (), {}, self.floor)[1])
            return statistics.median(ts) * 1e3
    return Clean()


def candidates(xent, rows: int, vocab: int, dtype, sms: int) -> dict:
    """{name: XentPlan} of the launches --plans times at (rows, vocab):
    one span a row, and the spans that put 1, 2 and 4 CTAs on every SM
    whatever the rows (the plan picks among these; the ring of 16 and
    4 KB stages and the register double buffer lost to the 8 KB ring:
    PERF.md, PR 20)."""
    tile = xent.TILE_BYTES // dtype.itemsize
    tiles = -(-vocab // tile)
    out = {"one span a row": xent.XentPlan(tile, tiles * tile, 1)}
    for ctas in (1, 2, 4):
        want = min(tiles, xent.THREADS, -(-ctas * sms // rows))
        n = -(-tiles // -(-tiles // want))
        out[f"spans for {ctas} CTA/SM"] = xent.XentPlan(tile, -(-tiles // n) * tile, n)
    return out


def time_plans(torch, ops, ref, xent, timer, gen, rounds=3) -> list:
    """[row] of every candidate at each shape of SHAPES, ``rounds`` times
    in turns, each first held against the plain version at TOL; ``pick``
    marks the plan's own. Where the plan splits, its no-merge twin too:
    (rows * n_split, span) logits, the same bytes and CTAs with one span a
    row, so the difference is the cost of the merge."""
    planned = xent.xent_plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    try:
        for _, shape, dtype, _ in SHAPES:
            x, lab = inputs(torch, gen, shape, dtype)
            want = ref.softmax_xent(x, lab)
            pick = planned(*shape, x.dtype, sms)
            cands = candidates(xent, *shape, x.dtype, sms)
            for r in range(rounds):
                for name, p in cands.items():
                    xent.xent_plan = lambda *a, p=p: p
                    if r == 0:
                        err = (ops.softmax_xent(x, lab) - want).abs()
                        if not bool((err <= TOL[0] + TOL[1] * want.abs()).all()):
                            raise RuntimeError(f"softmax_xent {shape} {dtype} under "
                                               f"{name} disagrees: max err "
                                               f"{float(err.max())}")
                    rows.append(dict(shape=list(shape), dtype=dtype, candidate=name,
                                     pick=p == pick, round=r,
                                     ms=timer(lambda: ops.softmax_xent(x, lab)),
                                     **p._asdict()))
            if pick.n_split > 1:
                # the same bytes and CTAs with no merge: each span a row
                tx, tl = inputs(torch, gen, (shape[0] * pick.n_split, pick.span), dtype)
                xent.xent_plan = planned
                for r in range(rounds):
                    rows.append(dict(shape=list(shape), dtype=dtype, round=r,
                                     candidate=f"no-merge twin {list(tx.shape)}",
                                     pick=False, ms=timer(lambda: ops.softmax_xent(tx, tl)),
                                     **planned(*tx.shape, tx.dtype, sms)._asdict()))
                del tx, tl
            del x, lab, want
    finally:
        xent.xent_plan = planned
    return rows


def sass_blocks(text: str) -> list:
    """{kernel, instructions, block, block_logits, block_rescales,
    block_vector_loads, per_logit} per kernel of a ``cuobjdump -sass``
    listing. ``block`` is the straight-line block (between branches and
    branch targets) with the most MUFU.EX2: the streaming loop's body of
    whole vectors. Its unpredicated MUFU.EX2 are its logits (one
    exponential each), the predicated ones the rescales of l where a
    thread's max rises; ``per_logit`` is its instructions over its
    logits."""
    rows = []
    for f in re.split(r"\n\s*Function : ", text)[1:]:
        name = f.split("\n", 1)[0].strip()
        ins = [(int(m.group(1), 16), m.group(2)) for m in
               re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", f)]
        ins = [(a, op) for a, op in ins if not op.startswith("NOP")]
        targets = {int(m.group(1), 16) for _, op in ins
                   for m in [re.search(r"BRA\S* (?:`\(\.L_x_\d+\) )?0x([0-9a-f]+)", op)]
                   if m}
        blocks, cur = [], []
        for addr, op in ins:
            if addr in targets and cur:
                blocks.append(cur)
                cur = []
            cur.append(op)
            if re.search(r"\b(BRA|EXIT|RET|BSYNC|WARPSYNC)\b", op):
                blocks.append(cur)
                cur = []
        blocks.append(cur)
        block = max(blocks, key=lambda b: sum("MUFU.EX2" in o for o in b))
        ex2 = [o for o in block if "MUFU.EX2" in o]
        logits = sum(not o.startswith("@") for o in ex2)
        rows.append({"kernel": name, "instructions": len(ins), "block": len(block),
                     "block_logits": logits, "block_rescales": len(ex2) - logits,
                     "block_vector_loads": sum(bool(re.search(r"LDS\.128|LDG\.E\.128", o))
                                               for o in block),
                     "per_logit": round(len(block) / logits, 3) if logits else None})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(HERE.parent / "src"),
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--ptxas", metavar="FILE",
                    help="first write nvcc -Xptxas -v's report on that tree's "
                         "csrc/softmax_xent.cu to FILE and print registers, "
                         "spills and the SASS instructions a logit")
    ap.add_argument("--plans", action="store_true",
                    help="also time every candidate at each shape")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("xent_timing: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    nt, gt = _script("norm_timing"), _script("glu_timing")
    src = Path(args.src).resolve()
    if args.ptxas:
        dest = Path(args.ptxas).resolve()
        rows = nt.ptxas_report(src / "repro_torch/kernels/csrc/softmax_xent.cu", dest)
        for r in rows:
            print(json.dumps({"label": args.label, "ptxas": r}), flush=True)
        so = src.parent / "build/repro_torch_kernels/ptxas-report.so"
        tool = gt.cuobjdump()
        if tool:
            text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                                  text=True, check=True).stdout
            for r in sass_blocks(text):
                print(json.dumps({"label": args.label, "sass": r}), flush=True)
    sys.path.insert(0, str(src))
    from repro_torch.core import graph
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import softmax_xent as xent

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    _build.build()
    timer = graph.Timer()

    def entry(shape, kernel, plain, library, nb, flops):
        return dict(shape=shape, ms=timer(kernel), eager_ms=timer.eager(kernel),
                    plain_ms=None if plain is None else timer(plain),
                    library_ms=None if library is None else timer(library),
                    bound=nt.bound_ms(nb, flops))

    gen = torch.Generator("cuda").manual_seed(SEED)
    for key, tm in time_xent(torch, ops, ref, entry, gen, xent,
                             clean=clean_timer(torch, graph)).items():
        b_ms, b_by = tm.pop("bound")
        print(json.dumps({"label": args.label, "kernel": key, "card": smi, **tm,
                          "bound_ms": b_ms, "bound_by": b_by}), flush=True)
    if args.plans and hasattr(xent, "xent_plan"):
        for row in time_plans(torch, ops, ref, xent, timer, gen):
            print(json.dumps({"label": args.label, "xent_plan": row["candidate"],
                              "card": smi, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
