"""``python -m repro_torch.analyze`` — run nglint over the model zoo.

The port of ``repro.analysis.cli``. Sweeps every requested workload ×
variant (fp32 / int8-qdq / fused by default) at its reduced config, builds
an :class:`~repro_torch.analysis.rules.AnalysisContext` per cell (raw
capture + post-rewrite stream + modeled per-group shares), runs the
registered rules, and gates the findings against the committed baseline
(``repro_torch/analysis/analysis_baseline.json``) exactly like
``repro_torch.bench.compare`` gates the bench artifact:

* exit 0 — no findings above the baseline budget;
* exit 1 — new findings (printed, and appended to
  ``$GITHUB_STEP_SUMMARY`` when set);
* exit 2 — bad usage / unknown workload / unreadable baseline.

``--write-baseline`` snapshots the current run into the baseline file —
the one sanctioned way to accept a finding or re-anchor NG008's shares.

**Device.** The captures run on ``--device`` (``cuda`` by default, as
``python -m repro_torch.bench``): on the card the kernel-backed ops launch
the hand-written kernels, each one record. Asked for ``cuda`` with no card
the CLI exits 2; it never carries on on the CPU. On the CPU under
``nn.backend("cuda")`` the kernel ops stay single records too (their
wrappers take the plain versions inside the op), which is how the CPU
tests hold the baseline written on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.configs import ARCH_IDS
from repro_torch.core.fusion import FusionTransform
from repro_torch.core.graph import capture
from repro_torch.core.hardware import get_hardware
from repro_torch.core.profiler import model_records
from repro_torch.core.workload import (QuantizeDequantTransform, Workload,
                                       _compose_record_rewrites)

from . import builtin  # noqa: F401  (registers NG001..NG009 on import)
from .baseline import (DEFAULT_BASELINE, AnalysisBaseline, BaselineError,
                       build_baseline, gate_findings, load_baseline,
                       save_baseline)
from .rules import (AnalysisContext, Finding, all_rules, run_rules,
                    run_static_rules)

ARTIFACT_VERSION = 1

#: variant label -> transform chain factory (fresh instances per build)
VARIANTS = {
    "fp32": lambda: (),
    "int8-qdq": lambda: (QuantizeDequantTransform("int8"),),
    "fused": lambda: (FusionTransform(),),
    "int8-qdq+fused": lambda: (QuantizeDequantTransform("int8"),
                               FusionTransform()),
}

DEFAULT_VARIANTS = ("fp32", "int8-qdq", "fused")

DEVICES = ("cuda", "cpu")


def zoo_ids() -> List[str]:
    """Every registered workload the ``--all`` sweep covers."""
    return list(ARCH_IDS)


def build_context(arch: str, variant: str,
                  baseline: Optional[AnalysisBaseline] = None,
                  hw_name: str = "a100",
                  device: str = "cuda") -> AnalysisContext:
    """Capture one workload variant on ``device`` and assemble its analysis
    context."""
    try:
        transforms = VARIANTS[variant]()
    except KeyError:
        raise KeyError(f"unknown variant {variant!r}; known: "
                       f"{sorted(VARIANTS)}") from None
    workload = Workload(name=arch, arch=arch).with_transform(*transforms)
    fn, args = workload.build(device)
    records = capture(fn, *args)
    rewrite = _compose_record_rewrites(workload)
    rewritten = rewrite(records) if rewrite is not None else records
    hw = get_hardware(hw_name)
    profile = model_records(rewritten, name=workload.name, hw=hw)
    total = profile.total_seconds or 1.0
    shares = {g: t / total for g, t in profile.group_seconds.items()}
    key = f"{workload.name}/{workload.variant}"
    entry = baseline.entry(key) if baseline is not None else None
    return AnalysisContext(
        workload=workload, variant=workload.variant,
        records=records, rewritten=rewritten,
        fused=any(isinstance(t, FusionTransform)
                  for t in workload.transforms),
        group_shares=shares,
        baseline_shares=dict(entry.group_shares) if entry else {},
        share_tolerance=(baseline.share_tolerance
                         if baseline is not None else 0.03))


def analyze(arch_ids: Sequence[str],
            variants: Sequence[str] = DEFAULT_VARIANTS,
            baseline: Optional[AnalysisBaseline] = None,
            hw_name: str = "a100",
            progress=None,
            device: str = "cuda",
            ) -> Tuple[List[AnalysisContext], List[Finding]]:
    """Run the full pass: static rules once, graph rules per cell, every
    capture on ``device``."""
    findings = run_static_rules(device=device)
    contexts: List[AnalysisContext] = []
    for arch in arch_ids:
        for variant in variants:
            if progress is not None:
                progress(f"analyzing {arch}/{variant}")
            ctx = build_context(arch, variant, baseline=baseline,
                                hw_name=hw_name, device=device)
            contexts.append(ctx)
            findings.extend(run_rules(ctx))
    return contexts, findings


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

def _fmt_finding(f: Finding) -> str:
    return f"{f.rule} [{f.severity}] {f.workload} :: {f.where}\n" \
           f"    {f.message}" \
           + (f"\n    hint: {f.fix_hint}" if f.fix_hint else "")


def render_summary_markdown(contexts: Sequence[AnalysisContext],
                            findings: Sequence[Finding],
                            new_findings: Sequence[Finding]) -> str:
    """Markdown findings table for ``$GITHUB_STEP_SUMMARY``."""
    lines = ["## nglint — static NonGEMM analysis", ""]
    lines.append(f"{len(contexts)} workload×variant cells analyzed, "
                 f"{len(findings)} finding(s), "
                 f"{len(new_findings)} above baseline.")
    lines.append("")
    if new_findings:
        lines.append("| rule | severity | workload | where | message |")
        lines.append("|---|---|---|---|---|")
        for f in new_findings:
            msg = f.message if len(f.message) <= 120 \
                else f.message[:117] + "..."
            lines.append(f"| {f.rule} | {f.severity} | {f.workload} "
                         f"| `{f.where}` | {msg} |")
    else:
        lines.append("No new findings — all clear (or baseline-"
                     "suppressed).")
    lines.append("")
    return "\n".join(lines)


def write_github_summary(markdown: str,
                         path: Optional[str] = None) -> bool:
    """Append to ``--summary-path`` / ``$GITHUB_STEP_SUMMARY`` if set."""
    target = path or os.environ.get("GITHUB_STEP_SUMMARY")
    if not target:
        return False
    with open(target, "a") as fh:
        fh.write(markdown)
        if not markdown.endswith("\n"):
            fh.write("\n")
    return True


def artifact_dict(contexts: Sequence[AnalysisContext],
                  findings: Sequence[Finding],
                  new_findings: Sequence[Finding]) -> dict:
    """Serializable run result (the CI-uploaded JSON artifact)."""
    return {
        "version": ARTIFACT_VERSION,
        "rules": [{"id": r.id, "severity": r.severity, "title": r.title,
                   "scope": r.scope} for r in all_rules()],
        "workloads": {
            c.key: {
                "n_records": len(c.records),
                "n_rewritten": len(c.rewritten),
                "fused": c.fused,
                "group_shares": {g: round(s, 6)
                                 for g, s in sorted(c.group_shares.items())},
            } for c in contexts
        },
        "findings": [f.to_dict() for f in findings],
        "new_findings": [f.to_dict() for f in new_findings],
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analyze",
        description="nglint: static NonGEMM analysis over the port's "
                    "captured op graphs and CUDA kernel specs")
    p.add_argument("workloads", nargs="*",
                   help="workload ids (see --list); default: --all")
    p.add_argument("--all", action="store_true",
                   help="analyze every registered workload")
    p.add_argument("--list", action="store_true", dest="list_workloads",
                   help="list workload ids and exit")
    p.add_argument("--list-rules", action="store_true",
                   help="list registered rules and exit")
    p.add_argument("--variants", default=",".join(DEFAULT_VARIANTS),
                   help="comma-separated variant labels "
                        f"(default: {','.join(DEFAULT_VARIANTS)}; known: "
                        f"{','.join(sorted(VARIANTS))})")
    p.add_argument("--device", default="cuda", choices=DEVICES,
                   help="device the captures run on (default: cuda; "
                        "exits 2 where CUDA is absent)")
    p.add_argument("--hw", default="a100",
                   help="hardware spec for the NG008 share model "
                        "(default: a100)")
    p.add_argument("--baseline", default=None,
                   help=f"findings baseline (default: {DEFAULT_BASELINE} "
                        "when it exists)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any committed baseline (every finding "
                        "counts as new)")
    p.add_argument("--write-baseline", action="store_true",
                   help="snapshot this run into the baseline file and "
                        "exit 0")
    p.add_argument("--json", action="store_true",
                   help="print the JSON artifact to stdout")
    p.add_argument("--out", default=None,
                   help="write the JSON artifact to this path")
    p.add_argument("--summary-path", default=None,
                   help="append the markdown findings table here "
                        "(default: $GITHUB_STEP_SUMMARY when set)")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="suppress per-cell progress on stderr")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parser().parse_args(argv)

    if args.list_rules:
        for r in all_rules():
            print(f"{r.id}  [{r.severity:7s}] ({r.scope})  {r.title}")
        return 0
    if args.list_workloads:
        for name in zoo_ids():
            print(name)
        return 0

    variants = tuple(v.strip() for v in args.variants.split(",")
                     if v.strip())
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        print(f"error: unknown variant(s) {unknown}; known: "
              f"{sorted(VARIANTS)}", file=sys.stderr)
        return 2

    ids = list(args.workloads)
    if args.all or not ids:
        ids = zoo_ids()
    known = set(zoo_ids())
    bad = [w for w in ids if w not in known]
    if bad:
        print(f"error: unknown workload(s) {bad}; see --list",
              file=sys.stderr)
        return 2

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda asked for, but CUDA is not available; "
              "pass --device cpu to run on the CPU", file=sys.stderr)
        return 2

    baseline_path = args.baseline or DEFAULT_BASELINE
    baseline: Optional[AnalysisBaseline] = None
    if not args.no_baseline and not args.write_baseline:
        if args.baseline is not None or pathlib.Path(baseline_path).exists():
            try:
                baseline = load_baseline(baseline_path)
            except BaselineError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2

    progress = None if args.quiet else \
        (lambda msg: print(msg, file=sys.stderr))
    contexts, findings = analyze(ids, variants=variants, baseline=baseline,
                                 hw_name=args.hw, progress=progress,
                                 device=args.device)

    if args.write_baseline:
        shares = {c.key: c.group_shares for c in contexts}
        tol = baseline.share_tolerance if baseline is not None \
            else AnalysisBaseline().share_tolerance
        save_baseline(build_baseline(shares, findings,
                                     share_tolerance=tol), baseline_path)
        print(f"baseline written: {baseline_path} "
              f"({len(contexts)} cells, {len(findings)} accepted "
              "finding(s))")
        return 0

    new = gate_findings(findings, baseline)
    artifact = artifact_dict(contexts, findings, new)
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(artifact, indent=2) + "\n")
    if args.json:
        print(json.dumps(artifact, indent=2))
    else:
        for f in new:
            print(_fmt_finding(f))
        suppressed = len(findings) - len(new)
        print(f"nglint: {len(contexts)} cells, {len(findings)} finding(s)"
              f" ({suppressed} baseline-suppressed), {len(new)} new")
    write_github_summary(render_summary_markdown(contexts, findings, new),
                         args.summary_path)
    return 1 if new else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
