"""CLI entry point of the port's bench.

    python -m repro_torch.bench run [--quick | --full] [--out results/bench.json]
                                    [--sections ...] [--timeout-scale X]
                                    [--device cuda|cpu]
    python -m repro_torch.bench list [--json]
    python -m repro_torch.bench compare baseline.json new.json [--tolerance ...]

``run`` goes to the card unless ``--device cpu`` is given, and raises
where CUDA is absent. Its last line is ``kernel launches {...}``: each
hand-written kernel's launches during the run (JSON).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _cmd_run(args) -> int:
    from repro_torch.core import report

    from .runner import run_bench

    tier = "quick" if args.quick else "full"
    try:
        result = run_bench(tier=tier, section_names=args.sections,
                           timeout_scale=args.timeout_scale,
                           progress=lambda m: print(m, flush=True),
                           device=args.device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    result.dump(args.out)
    print(report.render_artifact(result))
    print(f"wrote {args.out}")
    bad = [s for s in result.sections if s.status in ("failed", "timeout")]
    for s in bad:
        print(f"section {s.name}: {s.status}\n{s.error}", file=sys.stderr)
    print("kernel launches " + json.dumps(result.meta["kernel_launches"]),
          flush=True)
    return 1 if bad else 0


def _cmd_compare(args, extra: List[str]) -> int:
    from .compare import main as compare_main

    return compare_main(extra)


def _cmd_list(args) -> int:
    """Print every bench/serving case with tiers + resolved Workload spec."""
    from repro_torch.core import Workload, list_backends

    from .cases import (CASES, SERVING_CASES, VISION_CASES, is_ported,
                        vision_case_workload, workload_for_case)

    def entries(kind, cases):
        out = []
        for c in cases:
            if not is_ported(c.arch):
                d = dict(name=c.alias, arch=c.arch, phase="-",
                         batch=c.batch, seq=c.seq, dtype="-",
                         builder="not ported yet")
            elif kind == "serving":
                # the serving section runs the engine on build_serving's
                # model (on the card at its published size, in f32): batch
                # is the slot-table size, seq the shared KV depth
                d = Workload(name=c.alias, arch=c.arch, phase="decode",
                             batch=c.batch, seq=c.seq,
                             dtype="float32").describe()
                d["builder"] = "serving-engine (build_serving)"
            elif kind == "vision":
                d = vision_case_workload(c.arch, c.batch,
                                         alias=c.alias).describe()
            else:
                d = workload_for_case(c).describe()
            d.update(kind=kind, tiers=list(c.tiers))
            out.append(d)
        return out

    rows = entries("zoo", CASES) + entries("serving", SERVING_CASES) \
        + entries("vision", VISION_CASES)

    # Table-2 micro operators (repro_torch.core.microbench registry),
    # including the attn_template:* kernel variants
    from repro_torch.core.microbench import TABLE2_SHAPES, registry

    micro = [{"name": n, "group": op.group.value,
              "shape": list(TABLE2_SHAPES.get(n, ()))}
             for n, op in sorted(registry().items())]
    if args.json:
        print(json.dumps({"cases": rows, "micro_ops": micro,
                          "backends": list_backends()},
                         indent=1))
        return 0
    hdr = (f"{'case':<24} {'kind':<8} {'arch':<22} {'tiers':<11} "
           f"{'phase':<8} {'batch':>5} {'seq':>5}  {'dtype':<8} builder")
    print(hdr)
    print("-" * len(hdr))
    for d in rows:
        print(f"{d['name']:<24} {d['kind']:<8} {d['arch']:<22} "
              f"{','.join(d['tiers']):<11} {d['phase']:<8} "
              f"{d['batch']:>5} {d['seq']:>5}  {d['dtype']:<8} "
              f"{d['builder']}")
    print(f"\n{len(rows)} case(s); profiler backends: "
          f"{', '.join(list_backends())}")
    mhdr = f"\n{'micro op':<32} {'group':<16} shape"
    print(mhdr)
    print("-" * 64)
    for m in micro:
        shape = "x".join(str(s) for s in m["shape"]) or "(harvested)"
        print(f"{m['name']:<32} {m['group']:<16} {shape}")
    print(f"\n{len(micro)} micro op(s) "
          f"({sum(1 for m in micro if m['name'].startswith('attn_template:'))}"
          f" attn_template variants)")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench")
    sub = ap.add_subparsers(dest="cmd", required=True)

    run_p = sub.add_parser("run", help="run the bench suite, write the "
                                       "JSON artifact, render the tables")
    tier = run_p.add_mutually_exclusive_group()
    tier.add_argument("--quick", action="store_true",
                      help="CI subset of cases + reduced repeats (default)")
    tier.add_argument("--full", action="store_true", help="the whole zoo")
    run_p.add_argument("--out", default="results/bench.json",
                       help="artifact path (default results/bench.json)")
    run_p.add_argument("--sections", nargs="*", default=None,
                       help="run only these section names")
    run_p.add_argument("--timeout-scale", type=float, default=1.0,
                       help="multiply every per-section timeout")
    run_p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="where every section runs (default: the card; "
                            "raises without CUDA)")

    list_p = sub.add_parser("list", help="print every bench/serving case "
                                         "with its tiers and resolved "
                                         "Workload spec")
    list_p.add_argument("--json", action="store_true",
                        help="machine-readable output")

    sub.add_parser("compare", add_help=False,
                   help="diff two artifacts (see python -m "
                        "repro_torch.bench.compare --help)")

    if argv and argv[0] == "compare":
        return _cmd_compare(None, argv[1:])
    args = ap.parse_args(argv)
    if args.cmd == "list":
        return _cmd_list(args)
    if not args.quick and not args.full:
        args.quick = True
    return _cmd_run(args)


if __name__ == "__main__":
    sys.exit(main())
