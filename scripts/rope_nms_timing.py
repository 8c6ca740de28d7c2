"""Device times of the rope and NMS kernels (``csrc/rope.cu``, ``csrc/nms.cu``) on one GPU.

Times ``rope`` at the decode step (q[4,1,32,128], a (4, 1) position
column) and at gemma3-27b's served prefill (q[1,2048,32,128] and
k[1,2048,16,128]), and ``nms_sorted`` on the detector's first image (256
score-sorted candidates of detector-vit-s at 256 px, made here as
``chip_smoke.py`` makes them), on the Table-2 RoI row (4663 boxes as
``core/microbench.py`` makes them, score threshold 0) and at the wrapper's
8192 boxes, with ``core/graph.Timer`` (device time, L2 flushed, median of
20), beside the plain version (NMS's over NMS_PLAIN_RUNS runs), the bound of the bytes or operations and an
empty kernel on the same timer (the launch floor). Each rope row names the
launch plan (``rope.rope_plan``, where the tree has one); each NMS row the
boxes kept and the IoUs the kernel's mask phase computes.
``chip_smoke.py`` phase 5 prints these rows through :func:`time_rope_nms`.

    python3 scripts/rope_nms_timing.py                       # this tree
    python3 scripts/rope_nms_timing.py --src DIR/src --label parent
    python3 scripts/rope_nms_timing.py --ptxas build/ptxas_rope_nms.txt
    python3 scripts/rope_nms_timing.py --plans               # rope's plans
    python3 scripts/rope_nms_timing.py --roi                 # detector RoI ms

``--src`` times another tree's kernels (an unpacked ``git archive`` of a
parent commit, say), so that two versions are compared in one run on one
card; run them in turns (parent, change, change, parent). ``--ptxas`` first
compiles this tree's ``csrc/rope.cu`` and ``csrc/nms.cu`` with ``nvcc
-Xptxas -v``, writes the report to the file named and prints each kernel's
registers and spills. ``--plans`` times rope under its plan and, at the
prefill q and k, with one CTA a row and no walk. ``--roi``
adds the detector's RoI-group device ms (``profile_measured`` of
``vision_forward``, unfused) at batch 1 and 8. Prints JSON lines; needs a GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SEED = 0
#: the decode step's positions of chip_smoke.py's llama2-7b slots
DECODE_POSITIONS = [[186], [144], [120], [72]]
NMS_SIZES = (4663, 8192)
#: the plain NMS's runs (no warm-up), not the timer's 20: its greedy loop
#: takes ~0.3 s a run on an H100, a yardstick of arithmetic, not of speed
NMS_PLAIN_RUNS = 3


def _norm_timing():
    spec = importlib.util.spec_from_file_location("norm_timing",
                                                  HERE / "norm_timing.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def detector_nms_inputs(torch):
    """The detector kernel path's first image as chip_smoke.py's vision
    phase makes it: (score-sorted f32 boxes (256, 4), valid, IoU
    threshold) of detector-vit-s at 256 px, bf16, random weights (seed 0)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.models.vision import init_vision, vision_forward

    cfg = get_config("detector-vit-s").replace(dtype="bfloat16",
                                               param_dtype="bfloat16")
    gen = torch.Generator("cuda").manual_seed(SEED)
    params = init_vision(gen, cfg)
    imgs = torch.randn((8, cfg.n_channels, cfg.image_size, cfg.image_size),
                       generator=gen, device="cuda")
    boxes, scores, _ = vision_forward(params, imgs, cfg)
    order = ref.nms_order(scores[0])
    return (boxes[0].float()[order].contiguous(),
            scores[0][order] > cfg.det_score_threshold, cfg.det_iou_threshold)


def table2_nms_inputs(torch, n: int):
    """(score-sorted boxes (n, 4), valid, 0.5) from the Table-2 RoI row's
    maker (``core/microbench._mk_nms``, seed 0), score threshold 0."""
    from repro_torch.core import microbench
    from repro_torch.kernels import ref

    gen = torch.Generator("cuda").manual_seed(SEED)
    _, (boxes, scores) = microbench.registry()["nms"].make((n, 4), torch.float32, gen)
    order = ref.nms_order(scores)
    return boxes[order].float().contiguous(), scores[order] > 0.0, 0.5


def time_rope_nms(torch, ops, ref, entry, gen, rope=None, nms_inputs=None,
                  decode_positions=None, floor=True) -> dict:
    """{key: entry(...)} for every case; ``entry(shape, kernel, plain,
    library, nbytes, flops, plain_runs=None)`` times one (chip_smoke.py's,
    or :func:`main`'s), the plain version over ``plain_runs`` runs if given.
    The keys ``rope`` and ``nms`` are the kernels line's rows; the others
    print on lines of their own. ``rope``: the tree's ``kernels.rope``
    (each rope row then names its plan); ``nms_inputs``: the detector's
    first image (made here when None); ``floor``: add the empty kernel."""
    bf16 = torch.bfloat16
    out = {}

    def plan(x, pos):
        if rope is None or not hasattr(rope, "plan_for"):
            return {}
        return {"plan": rope.plan_for(x, 1.0, ops.rope(x, pos))._asdict()}

    def rope_row(key, shape, pos, what):
        x = torch.randn(shape, generator=gen, device="cuda").to(bf16)
        rows, half = shape[0] * shape[1], shape[3] // 2
        n = x.numel()
        out[key] = entry(what, lambda: ops.rope(x, pos), lambda: ref.rope(x, pos),
                         None, 2 * 2 * n + 4 * pos.numel(), 3 * n + 3 * rows * half)
        out[key].update(plan(x, pos))

    col = torch.tensor(decode_positions or DECODE_POSITIONS, dtype=torch.int32,
                       device="cuda")
    rope_row("rope", (4, 1, 32, 128), col,
             "q[4,1,32,128] bf16, positions (4,1) (llama2-7b fused decode step)")
    table = torch.arange(2048, dtype=torch.int32, device="cuda")[None]
    rope_row("rope prefill q", (1, 2048, 32, 128), table,
             "q[1,2048,32,128] bf16, positions (1,2048) (gemma3-27b prefill)")
    rope_row("rope prefill k", (1, 2048, 16, 128), table,
             "k[1,2048,16,128] bf16, positions (1,2048) (gemma3-27b prefill)")

    def nms_row(key, inputs, what, plain=True):
        boxes, valid, thr = inputs
        n = boxes.shape[0]
        keep = ops.nms_sorted(boxes, valid, thr)
        kept = torch.nonzero(keep).flatten().tolist()
        live = torch.nonzero(valid).flatten().tolist()
        out[key] = entry(
            f"boxes[{n},4] f32, {len(live)} valid, {len(kept)} kept ({what})",
            lambda: ops.nms_sorted(boxes, valid, thr),
            (lambda: ref.nms_sorted(boxes, valid, thr)) if plain else None, None,
            16 * n + 2 * n, 13 * sum(n - 1 - i for i in kept),
            plain_runs=NMS_PLAIN_RUNS)
        # the IoU rows the kept boxes need (the bound) and the IoUs the mask
        # phase computes: every valid row against every later box
        out[key].update(n=n, valid=len(live), kept=len(kept),
                        kept_iou=sum(n - 1 - i for i in kept),
                        mask_ious=sum(n - 1 - i for i in live))

    nms_row("nms", nms_inputs or detector_nms_inputs(torch),
            "detector-vit-s, 256 px, image 0")
    nms_row("nms table2", table2_nms_inputs(torch, NMS_SIZES[0]),
            "Table-2 RoI row, score threshold 0")
    nms_row("nms max", table2_nms_inputs(torch, NMS_SIZES[1]),
            "the wrapper's MAX_BOXES, Table-2 maker", plain=False)
    if floor:
        from repro_torch.kernels import norms
        dev = torch.device("cuda", torch.cuda.current_device())
        out["empty kernel"] = entry("<<<1, 32>>> of an empty kernel (launch floor)",
                                    lambda: norms.empty_kernel(dev), None, None, 0, 0)
    return out


def time_plans(torch, ops, ref, rope, timer, gen) -> dict:
    """{(shape, plan name): row} of rope under its plan at the decode step
    (q[4,1,32,128] bf16) and at gemma3-27b's prefill q and k, and there also
    with one CTA a row and no walk. Each variant is checked bit-identical to
    the plain version."""
    planned = rope.rope_plan
    out = {}
    cases = [((4, 1, 32, 128), torch.tensor(DECODE_POSITIONS, dtype=torch.int32,
                                            device="cuda")),
             ((1, 2048, 32, 128), None), ((1, 2048, 16, 128), None)]
    try:
        for shape, pos in cases:
            rope.rope_plan = planned
            b, s, h, d = shape
            if pos is None:
                pos = torch.arange(s, dtype=torch.int32, device="cuda")[None]
            x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
            base = rope.plan_for(x)
            hv = d // 2 // base.width
            variants = {"plan": base}
            if b * s > 4:
                variants["one CTA a row"] = base._replace(
                    rows_per_cta=1, threads=max(32, h * hv), grid=b * s)
            for name, p in variants.items():
                rope.rope_plan = lambda *a, p=p: p
                got = ops.rope(x, pos)
                torch.cuda.synchronize()
                if not torch.equal(got, ref.rope(x, pos)):
                    raise RuntimeError(f"rope {shape} under {p} disagrees")
                out[(str(list(shape)), name)] = dict(ms=timer(lambda: ops.rope(x, pos)),
                                                     **p._asdict())
    finally:
        rope.rope_plan = planned
    return out


def roi_ms(torch, nn) -> dict:
    """{batch: RoI-group device ms} of one unfused ``vision_forward`` of
    detector-vit-s (256 px, bf16, seed 0) at batch 1 and 8."""
    from repro_torch.configs import get_config
    from repro_torch.core import profile_measured
    from repro_torch.models.vision import init_vision, vision_forward

    cfg = get_config("detector-vit-s").replace(dtype="bfloat16",
                                               param_dtype="bfloat16")
    gen = torch.Generator("cuda").manual_seed(SEED)
    params = init_vision(gen, cfg)
    imgs = torch.randn((8, cfg.n_channels, cfg.image_size, cfg.image_size),
                       generator=gen, device="cuda")
    out = {}
    with nn.fuse(False):
        for b in (1, 8):
            for _ in range(3):
                vision_forward(params, imgs[:b], cfg)
            prof = profile_measured(vision_forward, params, imgs[:b], cfg,
                                    name=f"detector-vit-s b{b}", repeats=3)
            nms = sum(t.seconds for t in prof.timed_ops if "nms" in t.record.prim)
            out[b] = dict(roi_ms=prof.group_seconds.get("roi", 0.0) * 1e3,
                          nms_kernel_ms=nms * 1e3,
                          device_ms=prof.total_seconds * 1e3)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(HERE.parent / "src"),
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--ptxas", metavar="FILE",
                    help="first write nvcc -Xptxas -v's report on this tree's "
                         "csrc/rope.cu and csrc/nms.cu to FILE and print "
                         "registers and spills")
    ap.add_argument("--plans", action="store_true",
                    help="also time rope under its plan and the others")
    ap.add_argument("--roi", action="store_true",
                    help="also profile the detector's RoI group at b1 and b8")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("rope_nms_timing: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    nt = _norm_timing()
    if args.ptxas:
        rows, text = [], []
        dest = Path(args.ptxas).resolve()
        for name in ("rope", "nms"):
            src = HERE.parent / f"src/repro_torch/kernels/csrc/{name}.cu"
            rows += nt.ptxas_report(src, dest)
            text.append(dest.read_text())
        dest.write_text("\n".join(text))
        for r in rows:
            print(json.dumps({"ptxas": r}), flush=True)
        print(json.dumps({"ptxas_kernels": len(rows),
                          "max_spill_bytes": max((r["spill_stores"] + r["spill_loads"]
                                                  for r in rows), default=0),
                          "max_registers": max((r.get("registers", 0) for r in rows),
                                               default=0)}), flush=True)
    sys.path.insert(0, args.src)
    from repro_torch import nn
    from repro_torch.core import graph
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import rope as rope_mod

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    _build.build()
    timer = graph.Timer()

    def entry(shape, kernel, plain, library, nbytes, flops, plain_runs=None):
        plain_timer = timer if plain_runs is None else graph.Timer(
            iters=plain_runs, warmup=0)
        return dict(shape=shape, ms=timer(kernel), eager_ms=timer.eager(kernel),
                    plain_ms=None if plain is None else plain_timer(plain),
                    library_ms=None if library is None else timer(library),
                    bound=nt.bound_ms(nbytes, flops))

    gen = torch.Generator("cuda").manual_seed(SEED)
    for key, tm in time_rope_nms(torch, ops, ref, entry, gen, rope_mod).items():
        b_ms, b_by = tm.pop("bound")
        print(json.dumps({"label": args.label, "kernel": key, "card": smi, **tm,
                          "bound_ms": b_ms, "bound_by": b_by}), flush=True)
    if args.plans and hasattr(rope_mod, "rope_plan"):
        for (shape, name), row in time_plans(torch, ops, ref, rope_mod, timer,
                                             gen).items():
            print(json.dumps({"label": args.label, "rope_plan": name, "shape": shape,
                              "card": smi, **row}), flush=True)
    if args.roi:
        for b, row in roi_ms(torch, nn).items():
            print(json.dumps({"label": args.label, "detector_roi": f"b{b}",
                              "card": smi, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
