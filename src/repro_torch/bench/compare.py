"""Regression gate: diff two bench artifacts, exit nonzero on drift.

    python -m repro_torch.bench.compare baseline.json new.json [--tolerance 0.05]

The port of ``repro.bench.compare`` (a test pins its code to the
original's but for the ``kernels`` section's modeled keys, which read the
port's ``eager_mb`` / ``kernel_mb``). It reads an artifact of either
package.

What is gated, and how:

  * section health   — a section that was "ok" in the baseline must still
                       be "ok" (failed/timeout/missing is a regression;
                       "skipped" both sides is fine).
  * latency shares   — per (case, mode) row of the share sections
                       (breakdown/opgroups/top_table): |Δ gemm_frac| and
                       |Δ nongemm_frac| must stay within ``--tolerance``
                       (absolute, default 0.05 = five share points).
  * correctness      — kernels section: an ``allclose=true`` site turning
                       false is always a regression, no tolerance.
  * modeled numbers  — deterministic roofline/traffic models
                       (``tpu_model_us``, ``eager_mb``/``kernel_mb``,
                       roofline ``compute_s``/``memory_s``/``mfu``):
                       relative drift beyond ``--rel-tolerance``
                       (default 0.15).
  * wall-clock       — measured timings (``jit_us``, ``eager_us``,
                       section ``wall_s``) are noisy on shared CI runners,
                       so they are only checked when ``--time-tolerance``
                       is given (relative, e.g. 3.0 = up to 4x slower).

Five invariants are re-checked on the *candidate* artifact itself
(not just diffed against the baseline):

  * quantized §4.4  — per (case, mode), the int8-QDQ NonGEMM share must
                      not fall below fp32's;
  * fusion §6       — per (case, mode), every fused variant must have
                      strictly lower total modeled latency and NonGEMM
                      share than its unfused twin, and at least one case
                      must keep a NonGEMM share >= 0.15 after fusion
                      (fusion reduces but does not eliminate the
                      bottleneck);
  * vision          — the detection case must report nonzero RoI and
                      Interpolation shares, pooling must land in the
                      Reduction group (not OTHER), and the fused vision
                      variant must beat fp32 on total modeled latency.
  * platforms       — per case, all five platform models present, the
                      NPU-like point shows the highest NonGEMM share, and
                      NonGEMM share grows as GEMM gets cheaper (paper
                      Table 3); measured + calibrated host rows must carry
                      per-group drift maps.
  * traffic         — the paged-KV engine's outputs must stay bit-identical
                      to the contiguous engine's, the shared-prefix trace
                      must hit the prefix cache with warm service TTFT below
                      the cold run's, and the paged decode profile must
                      report a nonzero MEMORY-group / paged-bookkeeping
                      share;
  * serving_sharded — the manual-TP paged engine must keep token parity
                      with the single-device engine across the whole TP
                      sweep, with a strictly growing COLLECTIVE share and
                      a modeled per-device scaling efficiency inside the
                      stated band.

Rows present only in the *new* artifact are additions, never regressions.
Exit codes: 0 clean, 1 regressions found, 2 bad input.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Dict, List, Optional, Tuple

from .schema import (SHARE_SECTIONS, BenchResult, SchemaError,
                     check_fusion_invariant, check_platforms_invariant,
                     check_sharded_invariant, check_traffic_invariant,
                     check_vision_invariant)

SHARE_KEYS = ("gemm_frac", "nongemm_frac")

#: deterministic modeled quantities per section -> rel-tolerance gated
MODELED_KEYS = {
    "micro": ("tpu_model_us",),
    "micro_harvested": ("tpu_model_us",),
    "kernels": ("eager_mb", "kernel_mb"),
    "roofline": ("compute_s", "memory_s", "collective_s", "mfu",
                 "useful_ratio"),
    "serving_sharded": ("modeled_step_s", "modeled_eff", "collective_frac"),
}

#: measured (noisy) quantities -> only gated under --time-tolerance
MEASURED_KEYS = {
    "micro": ("jit_us", "eager_us"),
    "micro_harvested": ("jit_us", "eager_us"),
}

#: how rows are keyed for matching, per section
ROW_KEYS = {
    "breakdown": ("case", "mode"),
    "opgroups": ("case", "mode"),
    "top_table": ("case", "mode"),
    "micro": ("operator", "shape"),
    "micro_harvested": ("operator", "shape"),
    "kernels": ("site",),
    "roofline": ("arch", "shape", "mesh", "label", "model"),
    "serving": ("case", "phase"),
    "serving_sharded": ("case", "tp"),
    "traffic": ("case", "phase"),
    "quantized": ("case", "mode", "variant"),
    "fusion": ("case", "mode", "variant"),
    "vision": ("case", "mode", "variant"),
    "platforms": ("case", "platform", "kind"),
}


def _check_qdq_direction(sec, findings: List["Finding"]) -> None:
    """Paper §4.4 invariant on the *new* artifact: per (case, mode), the
    int8-QDQ NonGEMM share must not fall below the fp32 one."""
    pairs: Dict[Tuple[str, str], Dict[str, float]] = {}
    for row in sec.rows:
        v = row.get("nongemm_frac")
        if isinstance(v, (int, float)):
            pairs.setdefault((str(row.get("case")), str(row.get("mode"))),
                             {})[str(row.get("variant"))] = float(v)
    for (case, mode), by_variant in sorted(pairs.items()):
        fp32, int8 = by_variant.get("fp32"), by_variant.get("int8-qdq")
        if fp32 is not None and int8 is not None and int8 + 1e-9 < fp32:
            findings.append(Finding(
                "regression", f"quantized[{case}, {mode}]",
                f"int8-QDQ NonGEMM share {int8:.4f} < fp32 {fp32:.4f} — "
                f"quantization must not lower the NonGEMM share "
                f"(paper §4.4)"))


def _check_fusion_direction(sec, findings: List["Finding"]) -> None:
    """Paper §6 invariant on the *new* artifact — the same
    ``check_fusion_invariant`` the fusion section gates itself with."""
    for where, message in check_fusion_invariant(sec.rows):
        findings.append(Finding("regression", where, message))


def _check_vision_direction(sec, findings: List["Finding"]) -> None:
    """Vision invariant on the *new* artifact (detection RoI+Interpolation
    shares nonzero, pooling in Reduction, fused below fp32) — the same
    ``check_vision_invariant`` the vision section gates itself with."""
    for where, message in check_vision_invariant(sec.rows):
        findings.append(Finding("regression", where, message))


def _check_traffic_direction(sec, findings: List["Finding"]) -> None:
    """Traffic invariant on the *new* artifact (paged/contiguous output
    parity, prefix-cache hits with warm TTFT below cold, nonzero paged
    MEMORY bookkeeping share) — the same ``check_traffic_invariant`` the
    traffic section gates itself with."""
    for where, message in check_traffic_invariant(sec.rows):
        findings.append(Finding("regression", where, message))


def _check_sharded_direction(sec, findings: List["Finding"]) -> None:
    """Sharded-serving invariant on the *new* artifact (token parity with
    the single-device engine across the TP sweep, strictly growing
    COLLECTIVE share, modeled scaling efficiency in band) — the same
    ``check_sharded_invariant`` the serving_sharded section gates itself
    with."""
    for where, message in check_sharded_invariant(sec.rows):
        findings.append(Finding("regression", where, message))


def _check_platforms_direction(sec, findings: List["Finding"]) -> None:
    """Paper Table 3 invariant on the *new* artifact (full sweep present,
    NPU-like point highest NonGEMM share, share grows as GEMM gets
    cheaper, host drift rows present) — the same
    ``check_platforms_invariant`` the platforms section gates itself
    with."""
    for where, message in check_platforms_invariant(sec.rows):
        findings.append(Finding("regression", where, message))


@dataclasses.dataclass
class Finding:
    severity: str          # "regression" | "warning" | "info"
    where: str
    message: str

    def __str__(self) -> str:
        return f"[{self.severity.upper():<10}] {self.where}: {self.message}"


def _row_key(section: str, row: dict) -> Tuple[str, ...]:
    keys = ROW_KEYS.get(section)
    if not keys:
        # unknown section: identify rows by their scalar-ish fields
        return tuple(sorted(f"{k}={v}" for k, v in row.items()
                            if isinstance(v, (str, int))))
    return tuple(str(row.get(k)) for k in keys)


def _index_rows(section: str, rows: List[dict]) -> Dict[Tuple, dict]:
    return {_row_key(section, r): r for r in rows}


def _rel_delta(old: float, new: float) -> float:
    denom = max(abs(old), 1e-12)
    return abs(new - old) / denom


def compare_artifacts(old: BenchResult, new: BenchResult,
                      tolerance: float = 0.05,
                      rel_tolerance: float = 0.15,
                      time_tolerance: Optional[float] = None
                      ) -> List[Finding]:
    """Pure comparison — returns findings; CLI decides the exit code."""
    findings: List[Finding] = []

    if new.schema_version != old.schema_version:
        findings.append(Finding(
            "info", "artifact",
            f"schema_version {old.schema_version} -> {new.schema_version}"))
    if new.tier != old.tier:
        findings.append(Finding(
            "warning", "artifact",
            f"comparing different tiers: {old.tier!r} vs {new.tier!r}"))

    for old_sec in old.sections:
        new_sec = new.section(old_sec.name)
        where = f"section {old_sec.name}"

        if new_sec is None:
            if old_sec.status == "ok":
                findings.append(Finding("regression", where,
                                        "present in baseline, missing now"))
            continue
        if old_sec.status == "ok" and new_sec.status != "ok":
            err = (new_sec.error or "").strip().splitlines()
            findings.append(Finding(
                "regression", where,
                f"status ok -> {new_sec.status}"
                + (f" ({err[-1]})" if err else "")))
            continue
        if old_sec.status != "ok" and new_sec.status == "ok":
            findings.append(Finding("info", where,
                                    f"status {old_sec.status} -> ok"))
        if new_sec.status != "ok":
            continue

        if time_tolerance is not None and old_sec.wall_s > 0 and \
                new_sec.wall_s > old_sec.wall_s:
            d = _rel_delta(old_sec.wall_s, new_sec.wall_s)
            if d > time_tolerance:
                findings.append(Finding(
                    "regression", where,
                    f"wall_s slowed {old_sec.wall_s:.2f}s -> "
                    f"{new_sec.wall_s:.2f}s (rel Δ={d:.2f} > "
                    f"{time_tolerance})"))

        old_rows = _index_rows(old_sec.name, old_sec.rows)
        new_rows = _index_rows(old_sec.name, new_sec.rows)

        for key, orow in old_rows.items():
            nrow = new_rows.get(key)
            rwhere = f"{old_sec.name}[{', '.join(key)}]"
            if nrow is None:
                findings.append(Finding("regression", rwhere,
                                        "row present in baseline, missing "
                                        "now"))
                continue

            if old_sec.name in SHARE_SECTIONS:
                for k in SHARE_KEYS:
                    if k in orow and k in nrow:
                        d = abs(float(nrow[k]) - float(orow[k]))
                        if d > tolerance:
                            findings.append(Finding(
                                "regression", rwhere,
                                f"{k} moved {float(orow[k]):.4f} -> "
                                f"{float(nrow[k]):.4f} "
                                f"(|Δ|={d:.4f} > {tolerance})"))

            if old_sec.name == "top_table":
                if orow.get("top_group") != nrow.get("top_group"):
                    findings.append(Finding(
                        "warning", rwhere,
                        f"top NonGEMM group changed "
                        f"{orow.get('top_group')} -> "
                        f"{nrow.get('top_group')}"))

            if old_sec.name == "kernels":
                if orow.get("allclose") is True and \
                        nrow.get("allclose") is not True:
                    findings.append(Finding(
                        "regression", rwhere,
                        "kernel correctness check allclose true -> "
                        f"{nrow.get('allclose')}"))

            for k in MODELED_KEYS.get(old_sec.name, ()):
                ov, nv = orow.get(k), nrow.get(k)
                if isinstance(ov, (int, float)) and \
                        isinstance(nv, (int, float)):
                    d = _rel_delta(float(ov), float(nv))
                    if d > rel_tolerance:
                        findings.append(Finding(
                            "regression", rwhere,
                            f"modeled {k} moved {ov:.4g} -> {nv:.4g} "
                            f"(rel Δ={d:.2f} > {rel_tolerance})"))

            if time_tolerance is not None:
                for k in MEASURED_KEYS.get(old_sec.name, ()):
                    ov, nv = orow.get(k), nrow.get(k)
                    # ov == 0 means "not measured in this tier", not fast
                    if isinstance(ov, (int, float)) and \
                            isinstance(nv, (int, float)) and \
                            float(ov) > 0 and float(nv) > float(ov):
                        d = _rel_delta(float(ov), float(nv))
                        if d > time_tolerance:
                            findings.append(Finding(
                                "regression", rwhere,
                                f"measured {k} slowed {ov:.4g} -> {nv:.4g} "
                                f"(rel Δ={d:.2f} > {time_tolerance})"))

        added = set(new_rows) - set(old_rows)
        if added:
            findings.append(Finding(
                "info", f"section {old_sec.name}",
                f"{len(added)} new row(s) not in baseline"))

    for new_sec in new.sections:
        if old.section(new_sec.name) is None:
            findings.append(Finding("info", f"section {new_sec.name}",
                                    "new section not in baseline"))

    q = new.section("quantized")
    if q is not None and q.status == "ok":
        _check_qdq_direction(q, findings)
    fu = new.section("fusion")
    if fu is not None and fu.status == "ok":
        _check_fusion_direction(fu, findings)
    vi = new.section("vision")
    if vi is not None and vi.status == "ok":
        _check_vision_direction(vi, findings)
    pl = new.section("platforms")
    if pl is not None and pl.status == "ok":
        _check_platforms_direction(pl, findings)
    tr = new.section("traffic")
    if tr is not None and tr.status == "ok":
        _check_traffic_direction(tr, findings)
    sh = new.section("serving_sharded")
    if sh is not None and sh.status == "ok":
        _check_sharded_direction(sh, findings)
    return findings


def render_summary_markdown(old: BenchResult, new: BenchResult,
                            findings: List[Finding]) -> str:
    """GitHub-flavored summary of a compare run (``$GITHUB_STEP_SUMMARY``)."""
    regressions = [f for f in findings if f.severity == "regression"]
    warnings = [f for f in findings if f.severity == "warning"]
    infos = [f for f in findings if f.severity == "info"]
    verdict = "❌ regressions found" if regressions else "✅ no regressions"
    lines = [
        "## bench compare",
        "",
        f"**{verdict}** — {len(regressions)} regression(s), "
        f"{len(warnings)} warning(s), {len(infos)} info across "
        f"{len(old.sections)} baseline section(s) "
        f"(tier `{old.tier}` → `{new.tier}`)",
        "",
    ]
    if findings:
        lines += ["| severity | where | message |", "|---|---|---|"]
        for f in regressions + warnings + infos:
            msg = f.message.replace("|", "\\|")
            lines.append(f"| {f.severity} | `{f.where}` | {msg} |")
    else:
        lines.append("_baseline and candidate artifacts match._")
    fu = new.section("fusion")
    if fu is not None and fu.status == "ok" and fu.rows:
        lines += [
            "",
            "### fusion (§6: NonGEMM share before/after fusion, candidate)",
            "",
            "| case | mode | variant | total | GEMM% | NonGEMM% | fused% |",
            "|---|---|---|---:|---:|---:|---:|",
        ]
        for r in fu.rows:
            lines.append(
                f"| {r.get('case')} | {r.get('mode')} | {r.get('variant')} "
                f"| {float(r.get('total_s', 0.0))*1e3:.3f}ms "
                f"| {100*float(r.get('gemm_frac', 0.0)):.1f} "
                f"| {100*float(r.get('nongemm_frac', 0.0)):.1f} "
                f"| {100*float(r.get('fused_frac', 0.0)):.1f} |")
    vi = new.section("vision")
    if vi is not None and vi.status == "ok" and vi.rows:
        lines += [
            "",
            "### vision (RoI / Interpolation / Pooling shares, candidate)",
            "",
            "| case | kind | variant | total | GEMM% | NonGEMM% "
            "| RoI% | Interp% | Reduce% |",
            "|---|---|---|---:|---:|---:|---:|---:|---:|",
        ]
        for r in vi.rows:
            gf = r.get("group_fracs") or {}
            lines.append(
                f"| {r.get('case')} | {r.get('kind')} | {r.get('variant')} "
                f"| {float(r.get('total_s', 0.0))*1e3:.3f}ms "
                f"| {100*float(r.get('gemm_frac', 0.0)):.1f} "
                f"| {100*float(r.get('nongemm_frac', 0.0)):.1f} "
                f"| {100*float(r.get('roi_frac', 0.0)):.1f} "
                f"| {100*float(r.get('interp_frac', 0.0)):.1f} "
                f"| {100*float(gf.get('reduction', 0.0)):.1f} |")
    tr = new.section("traffic")
    if tr is not None and tr.status == "ok" and tr.rows:
        def _cell(row, key, fmt):
            v = row.get(key)
            return fmt.format(float(v)) if isinstance(v, (int, float)) and \
                not isinstance(v, bool) else "—"

        lines += [
            "",
            "### traffic (paged-KV engine under trace-driven load, "
            "candidate)",
            "",
            "| case | phase | parity | hit rate | p99 TTFT | goodput "
            "| NonGEMM% | paged% |",
            "|---|---|---|---:|---:|---:|---:|---:|",
        ]
        for r in tr.rows:
            parity = r.get("parity_ok")
            lines.append(
                f"| {r.get('case')} | {r.get('phase')} "
                f"| {'✅' if parity is True else '❌' if parity is False else '—'} "
                f"| {_cell(r, 'hit_rate', '{:.2f}')} "
                f"| {_cell(r, 'p99_ttft_s', '{:.4f}s')} "
                f"| {_cell(r, 'goodput_tok_per_s', '{:.1f} tok/s')} "
                f"| {_cell(r, 'nongemm_frac', '{:.2%}')} "
                f"| {_cell(r, 'paged_frac', '{:.2%}')} |")
    pl = new.section("platforms")
    if pl is not None and pl.status == "ok" and pl.rows:
        lines += [
            "",
            "### platforms (Table 3: NonGEMM share vs GEMM cost, candidate)",
            "",
            "| case | platform | kind | total | GEMM | GEMM% | NonGEMM% "
            "| max\\|log2 drift\\| |",
            "|---|---|---|---:|---:|---:|---:|---:|",
        ]
        for r in pl.rows:
            drift = r.get("max_abs_log2_drift")
            drift_cell = f"{float(drift):.2f}" if drift is not None else "—"
            lines.append(
                f"| {r.get('case')} | {r.get('platform')} | {r.get('kind')} "
                f"| {float(r.get('total_s', 0.0))*1e3:.3f}ms "
                f"| {float(r.get('gemm_s', 0.0))*1e3:.3f}ms "
                f"| {100*float(r.get('gemm_frac', 0.0)):.1f} "
                f"| {100*float(r.get('nongemm_frac', 0.0)):.1f} "
                f"| {drift_cell} |")
    sh = new.section("serving_sharded")
    if sh is not None and sh.status == "ok" and sh.rows:
        lines += [
            "",
            "### serving_sharded (TP scaling: per-device throughput and "
            "COLLECTIVE share, candidate)",
            "",
            "| case | tp | devices | tok/s | tok/s/device | modeled step "
            "| eff | COLLECTIVE% | parity |",
            "|---|---:|---:|---:|---:|---:|---:|---:|---|",
        ]
        for r in sh.rows:
            parity = r.get("parity_ok")
            lines.append(
                f"| {r.get('case')} | {r.get('tp')} | {r.get('devices')} "
                f"| {float(r.get('decode_tok_per_s', 0.0)):.1f} "
                f"| {float(r.get('per_device_tok_per_s', 0.0)):.1f} "
                f"| {float(r.get('modeled_step_s', 0.0))*1e6:.2f}us "
                f"| {float(r.get('modeled_eff', 0.0)):.3f} "
                f"| {100*float(r.get('collective_frac', 0.0)):.1f} "
                f"| {'✅' if parity is True else '❌' if parity is False else '—'} |")
    return "\n".join(lines) + "\n"


def write_github_summary(old: BenchResult, new: BenchResult,
                         findings: List[Finding],
                         path: Optional[str] = None) -> Optional[str]:
    """Append the markdown summary to ``path`` or ``$GITHUB_STEP_SUMMARY``
    (no-op outside CI). Returns the path written, if any."""
    path = path or os.environ.get("GITHUB_STEP_SUMMARY")
    if not path:
        return None
    with open(path, "a") as f:
        f.write(render_summary_markdown(old, new, findings))
    return path


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.compare",
        description="Diff two bench artifacts; exit 1 on regressions.")
    ap.add_argument("baseline", help="baseline bench.json")
    ap.add_argument("new", help="candidate bench.json")
    ap.add_argument("--tolerance", type=float, default=0.05,
                    help="abs tolerance on GEMM/NonGEMM share fractions "
                         "(default 0.05)")
    ap.add_argument("--rel-tolerance", type=float, default=0.15,
                    help="relative tolerance on deterministic modeled "
                         "numbers (default 0.15)")
    ap.add_argument("--time-tolerance", type=float, default=None,
                    help="relative tolerance on measured wall-clock "
                         "(unchecked unless given; e.g. 3.0)")
    ap.add_argument("--summary-path", default=None,
                    help="append a markdown summary to this file (defaults "
                         "to $GITHUB_STEP_SUMMARY when set, as on GitHub "
                         "Actions runners)")
    args = ap.parse_args(argv)

    try:
        old = BenchResult.load(args.baseline)
        new = BenchResult.load(args.new)
    except (OSError, ValueError, SchemaError) as e:
        print(f"error loading artifacts: {e}", file=sys.stderr)
        return 2

    findings = compare_artifacts(old, new, tolerance=args.tolerance,
                                 rel_tolerance=args.rel_tolerance,
                                 time_tolerance=args.time_tolerance)
    regressions = [f for f in findings if f.severity == "regression"]
    for f in findings:
        stream = sys.stderr if f.severity == "regression" else sys.stdout
        print(f, file=stream)
    print(f"compare: {len(regressions)} regression(s), "
          f"{sum(f.severity == 'warning' for f in findings)} warning(s) "
          f"across {len(old.sections)} baseline section(s)")
    written = write_github_summary(old, new, findings,
                                   path=args.summary_path)
    if written:
        print(f"summary appended to {written}")
    return 1 if regressions else 0


if __name__ == "__main__":
    sys.exit(main())
