"""The bench's shared gates, as far as the report renderers read them.

A copy of part of ``repro.bench.schema`` (a test pins each function's
code to the original's): the §6 fusion invariant, the vision invariant
and the platforms invariant, each with its constants. The report
renderers (``core/report.py``) print their verdicts; the rest of the
schema (cases, artifacts, the validator) comes with the port of the bench.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

#: fusion section (paper §6): unfused variant -> its fused twin, per
#: (case, mode). Both the section's own gate (repro.bench.sections) and
#: the compare CLI's candidate invariant read THIS table — one source.
FUSION_VARIANT_PAIRS = (("fp32", "fused"), ("int8-qdq", "int8-qdq+fused"))

#: the §6 residual bottleneck: at least one case must keep this much
#: NonGEMM share after fusion (fusion reduces, never eliminates)
FUSION_RESIDUAL_FLOOR = 0.15


#: the platforms section sweeps every quick case over these hardware specs
#: (must stay in sync with repro.core.hardware.BY_NAME; asserted by tests)
PLATFORM_SWEEP = ("tpu_v5e", "a100", "cpu", "npu_ryzen", "membound_dimm")

#: the paper's NonGEMM-share invariant is only enforced between platforms
#: whose modeled GEMM time differs by more than this relative margin —
#: near-ties carry no ordering signal
PLATFORM_GEMM_MARGIN = 0.10

#: the platform whose operating point makes GEMM cheapest relative to its
#: NonGEMM path — the paper's "NonGEMM share is highest where GEMM is
#: nearly free" extreme
PLATFORM_NPU = "npu_ryzen"


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def check_fusion_invariant(rows: Sequence[dict]) -> List[tuple]:
    """The §6 invariant over fusion-section rows; ``[(where, message)]``.

    Single implementation shared by the section's own gate
    (``repro.bench.sections.fusion_rows`` raises on any violation) and
    the compare CLI (``repro.bench.compare`` turns each into a
    regression Finding on the candidate artifact). Checks per
    (case, mode) pair of :data:`FUSION_VARIANT_PAIRS`: fused total
    modeled latency strictly below unfused, fused NonGEMM share strictly
    below unfused, and — across all pairs — at least one post-fusion
    NonGEMM share >= :data:`FUSION_RESIDUAL_FLOOR`.
    """
    violations: List[tuple] = []
    pairs: Dict[tuple, Dict[str, dict]] = {}
    for row in rows:
        pairs.setdefault((str(row.get("case")), str(row.get("mode"))),
                         {})[str(row.get("variant"))] = row
    max_fused_share = None
    for (case, mode), by_variant in sorted(pairs.items()):
        for unfused_v, fused_v in FUSION_VARIANT_PAIRS:
            u, f = by_variant.get(unfused_v), by_variant.get(fused_v)
            if u is None or f is None:
                continue
            where = f"fusion[{case}, {mode}]"
            ut, ft = u.get("total_s"), f.get("total_s")
            if _is_num(ut) and _is_num(ft) and not float(ft) < float(ut):
                violations.append((where, (
                    f"{fused_v} total modeled latency {ft:.4g}s is not "
                    f"below {unfused_v}'s {ut:.4g}s — fusion must reduce "
                    f"total latency (paper §6)")))
            un, fn = u.get("nongemm_frac"), f.get("nongemm_frac")
            if _is_num(un) and _is_num(fn):
                if not float(fn) < float(un):
                    violations.append((where, (
                        f"{fused_v} NonGEMM share {fn:.4f} is not below "
                        f"{unfused_v}'s {un:.4f} — fusion must lower the "
                        f"NonGEMM share (paper §6)")))
                max_fused_share = max(max_fused_share or 0.0, float(fn))
    if max_fused_share is not None and \
            max_fused_share < FUSION_RESIDUAL_FLOOR:
        violations.append(("section fusion", (
            f"max post-fusion NonGEMM share {max_fused_share:.4f} < "
            f"{FUSION_RESIDUAL_FLOOR} on every case — the paper's §6 "
            f"residual bottleneck is not reproduced")))
    return violations


def check_vision_invariant(rows: Sequence[dict]) -> List[tuple]:
    """The vision-family invariant over vision-section rows.

    Single implementation shared by the section's own gate
    (``repro.bench.sections.vision_rows`` raises on any violation) and the
    compare CLI (regression Findings on the candidate artifact). Checks:

    * at least one detection-kind row exists (the Torchvision detection
      half must actually run);
    * every detection ``fp32`` row has strictly positive RoI *and*
      Interpolation shares — the paper's headline detection bottleneck;
    * every ``fp32`` row has a strictly positive Reduction share — the
      pooling primitives must classify as Reduction, not fall into OTHER;
    * per (case, mode), the ``fused`` variant's total modeled latency is
      strictly below ``fp32``'s (the §6 story covers vision too).
    """
    violations: List[tuple] = []
    pairs: Dict[tuple, Dict[str, dict]] = {}
    n_detection = 0
    for row in rows:
        where = f"vision[{row.get('case')}, {row.get('mode')}]"
        variant = str(row.get("variant"))
        if row.get("kind") == "detection":
            n_detection += 1
        if variant == "fp32":
            if row.get("kind") == "detection":
                for key, label in (("roi_frac", "RoI"),
                                   ("interp_frac", "Interpolation")):
                    v = row.get(key)
                    if not (_is_num(v) and float(v) > 0.0):
                        violations.append((where, (
                            f"detection {label} share is {v!r} — must be "
                            f"nonzero (the paper's detection NonGEMM "
                            f"bottleneck)")))
            red = (row.get("group_fracs") or {}).get("reduction")
            if not (_is_num(red) and float(red) > 0.0):
                violations.append((where, (
                    f"reduction share is {red!r} — pooling ops must "
                    f"classify as Reduction, not OTHER")))
        pairs.setdefault((str(row.get("case")), str(row.get("mode"))),
                         {})[variant] = row
    if rows and not n_detection:
        violations.append(("section vision",
                           "no detection-kind row — the Torchvision "
                           "detection half is not exercised"))
    for (case, mode), by_variant in sorted(pairs.items()):
        u, f = by_variant.get("fp32"), by_variant.get("fused")
        if u is None or f is None:
            continue
        ut, ft = u.get("total_s"), f.get("total_s")
        if _is_num(ut) and _is_num(ft) and not float(ft) < float(ut):
            violations.append((f"vision[{case}, {mode}]", (
                f"fused total modeled latency {ft:.4g}s is not below "
                f"fp32's {ut:.4g}s — fusion must reduce total latency "
                f"(paper §6)")))
    return violations


def check_platforms_invariant(rows: Sequence[dict]) -> List[tuple]:
    """The cross-platform invariant over platforms-section rows.

    Single implementation shared by the section's own gate
    (``repro.bench.sections.platform_rows`` raises on any violation) and
    the compare CLI (regression Findings on the candidate artifact).
    Modeled rows (``kind == "modeled"``) must satisfy, per case:

    * all of :data:`PLATFORM_SWEEP` is present;
    * :data:`PLATFORM_NPU` has the strictly highest NonGEMM share — the
      NPU-like point makes GEMM nearly free, so what's left is NonGEMM;
    * pairwise concordance: when one platform's modeled GEMM time is
      cheaper than another's by more than :data:`PLATFORM_GEMM_MARGIN`,
      its NonGEMM share must not be lower (the paper's Table 3 trend:
      NonGEMM share grows as GEMM gets cheaper).

    Measured/calibrated host rows (``kind`` ``"measured"``/``"calibrated"``)
    must exist and carry a non-empty numeric ``drift`` map — the
    measured-vs-modeled evidence this section exists to provide.
    """
    violations: List[tuple] = []
    by_case: Dict[str, Dict[str, dict]] = {}
    drift_kinds = set()
    for row in rows:
        kind = str(row.get("kind"))
        if kind == "modeled":
            by_case.setdefault(str(row.get("case")), {})[
                str(row.get("platform"))] = row
        elif kind in ("measured", "calibrated"):
            drift = row.get("drift")
            if isinstance(drift, dict) and drift and \
                    all(_is_num(v) for v in drift.values()):
                drift_kinds.add(kind)
            else:
                violations.append((
                    f"platforms[{row.get('case')}, {kind}]",
                    f"{kind} row must carry a non-empty numeric 'drift' "
                    f"map, got {drift!r}"))
    for case, by_platform in sorted(by_case.items()):
        missing = [p for p in PLATFORM_SWEEP if p not in by_platform]
        if missing:
            violations.append((f"platforms[{case}]",
                               f"missing platforms {missing} (sweep "
                               f"requires all of {list(PLATFORM_SWEEP)})"))
            continue
        npu_share = by_platform[PLATFORM_NPU].get("nongemm_frac")
        for p, row in sorted(by_platform.items()):
            share = row.get("nongemm_frac")
            gemm = row.get("gemm_s")
            if not (_is_num(share) and _is_num(gemm)):
                violations.append((f"platforms[{case}, {p}]",
                                   f"row needs numeric nongemm_frac/gemm_s, "
                                   f"got {share!r}/{gemm!r}"))
                continue
            if p != PLATFORM_NPU and _is_num(npu_share) and \
                    not float(npu_share) > float(share):
                violations.append((f"platforms[{case}]", (
                    f"{PLATFORM_NPU} NonGEMM share {npu_share:.4f} is not "
                    f"above {p}'s {share:.4f} — the NPU-like point must "
                    f"show the highest NonGEMM share (paper Table 3)")))
            for q, other in sorted(by_platform.items()):
                og, os_ = other.get("gemm_s"), other.get("nongemm_frac")
                if q == p or not (_is_num(og) and _is_num(os_)):
                    continue
                if float(gemm) < float(og) * (1.0 - PLATFORM_GEMM_MARGIN) \
                        and float(share) < float(os_):
                    violations.append((f"platforms[{case}]", (
                        f"{p} has cheaper GEMM ({gemm:.4g}s vs {q}'s "
                        f"{og:.4g}s) but lower NonGEMM share "
                        f"({share:.4f} vs {os_:.4f}) — NonGEMM share "
                        f"must grow as GEMM gets cheaper (paper Table 3)")))
    if rows:
        for kind in ("measured", "calibrated"):
            if kind not in drift_kinds and not any(
                    v[0].endswith(f", {kind}]") for v in violations):
                violations.append(("section platforms", (
                    f"no {kind} host row with a drift map — the section "
                    f"must report measured-vs-modeled drift on the host "
                    f"CPU")))
    return violations
