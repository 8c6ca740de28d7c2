"""Versioned artifact schema of the port's benchmark pipeline.

A copy of ``repro.bench.schema`` (a test pins every constant, gate and
class to the original's, by value or by code). A bench run serializes to
ONE JSON document (``results/bench.json``) with the JAX package's
top-level keys, so the port loads and compares an artifact of either
package::

    {
      "schema_version": 1,
      "tier": "quick" | "full",
      "backend": "cuda" | "cpu",
      "jax_version": "torch 2.11.0+cu128",
      "cases": [{"alias": ..., "arch": ..., "batch": ..., "seq": ...,
                 "tiers": ["quick", "full"]}, ...],
      "sections": [{"name": ..., "title": ..., "status": "ok" | "failed"
                    | "timeout" | "skipped", "wall_s": ..., "rows": [...],
                    "error": null | "..."}, ...],
      "meta": {...}
    }

``backend`` names the device the sections ran on; ``jax_version`` keeps
the JAX key's name and holds ``"torch " + torch.__version__`` (the port
imports no JAX). ``meta`` carries the card's ``device_name`` and
``power_limit_w`` (``nvidia-smi``) on the card.

Rows are per-section records. Share-bearing sections carry
``case``/``mode``/``gemm_frac``/``nongemm_frac`` per row — the numbers the
paper is about, and the ones ``repro_torch.bench.compare`` gates on.

**The one difference by design:** the port's ``kernels`` rows carry
``kernel_mb``, the kernel-boundary traffic of the hand-written kernel,
where JAX's carry ``xla_mb`` and ``pallas_mb`` (the port has no XLA and no
Pallas kernel). The validator holds each artifact to the row keys of the
package that wrote it (:func:`section_row_keys`): an artifact whose
``jax_version`` does not start with ``"torch "`` to
:data:`JAX_SECTION_ROW_KEYS`. The JAX package's own validator holds every
artifact to its keys, so it refuses a port artifact whose ``kernels``
section ran.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence

SCHEMA_VERSION = 1

#: section.status values
STATUSES = ("ok", "failed", "timeout", "skipped")

#: the tiers a BenchCase may belong to
KNOWN_TIERS = ("quick", "full")

#: sections whose rows carry GEMM/NonGEMM shares (validated to [0, 1] when
#: present; the serving section's "engine" rows carry throughput instead)
SHARE_SECTIONS = ("breakdown", "opgroups", "top_table", "serving",
                  "quantized", "fusion", "vision", "platforms", "traffic",
                  "serving_sharded")

#: fusion section (paper §6): unfused variant -> its fused twin, per
#: (case, mode). Both the section's own gate (repro_torch.bench.sections) and
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
    (``repro_torch.bench.sections.fusion_rows`` raises on any violation) and
    the compare CLI (``repro_torch.bench.compare`` turns each into a
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
    (``repro_torch.bench.sections.vision_rows`` raises on any violation) and the
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

def check_traffic_invariant(rows: Sequence[dict]) -> List[tuple]:
    """The serving-traffic invariant over traffic-section rows.

    Single implementation shared by the section's own gate
    (``repro_torch.bench.sections.traffic_rows`` raises on any violation) and
    the compare CLI (regression Findings on the candidate artifact).
    Per case:

    * a ``phase="parity"`` row with ``parity_ok`` true — the paged-KV
      engine must emit bit-identical outputs to the contiguous engine;
    * a ``phase="prefix"`` row with prefix ``hit_rate`` strictly positive
      and warm (prefix-cached) mean service TTFT strictly below the cold
      (cache-disabled) run's — cached blocks must actually skip prefill
      work — and bit-identical warm/cold outputs (``parity_ok``);
    * a ``phase="profile"`` row whose MEMORY-group share and paged
      bookkeeping share (``paged_frac``: the block-table gather/scatter
      op sites) are both strictly positive — the "NonGEMM share of
      serving" evidence this section exists to report.
    """
    violations: List[tuple] = []
    by_case: Dict[str, Dict[str, dict]] = {}
    for row in rows:
        by_case.setdefault(str(row.get("case")), {})[
            str(row.get("phase"))] = row
    for case, by_phase in sorted(by_case.items()):
        missing = [p for p in ("parity", "prefix", "profile")
                   if p not in by_phase]
        if missing:
            violations.append((f"traffic[{case}]",
                               f"missing phase rows {missing}"))
        parity = by_phase.get("parity")
        if parity is not None and parity.get("parity_ok") is not True:
            violations.append((f"traffic[{case}, parity]", (
                "paged engine outputs are not bit-identical to the "
                "contiguous engine's (parity_ok is "
                f"{parity.get('parity_ok')!r})")))
        prefix = by_phase.get("prefix")
        if prefix is not None:
            where = f"traffic[{case}, prefix]"
            hit = prefix.get("hit_rate")
            if not (_is_num(hit) and float(hit) > 0.0):
                violations.append((where, (
                    f"prefix hit_rate is {hit!r} — the shared-prefix trace "
                    f"must produce cache hits")))
            warm = prefix.get("warm_service_ttft_s")
            cold = prefix.get("cold_service_ttft_s")
            if _is_num(warm) and _is_num(cold) and \
                    not float(warm) < float(cold):
                violations.append((where, (
                    f"warm mean service TTFT {warm:.4g}s is not below the "
                    f"cold run's {cold:.4g}s — prefix-cached blocks must "
                    f"skip prefill work")))
            if prefix.get("parity_ok") is not True:
                violations.append((where, (
                    "prefix-cached outputs are not bit-identical to the "
                    "cache-disabled run's (parity_ok is "
                    f"{prefix.get('parity_ok')!r})")))
        profile = by_phase.get("profile")
        if profile is not None:
            where = f"traffic[{case}, profile]"
            mem = (profile.get("group_fracs") or {}).get("memory")
            if not (_is_num(mem) and float(mem) > 0.0):
                violations.append((where, (
                    f"MEMORY-group share is {mem!r} — paged block-table "
                    f"gather/scatter must classify as MEMORY with nonzero "
                    f"share")))
            paged = profile.get("paged_frac")
            if not (_is_num(paged) and float(paged) > 0.0):
                violations.append((where, (
                    f"paged_frac is {paged!r} — the paged-KV bookkeeping "
                    f"op sites must carry a nonzero share")))
    return violations


#: the TP degrees the serving_sharded section sweeps (simulated host
#: devices; the subprocess pins 8 via XLA_FLAGS)
SHARDED_TP_SWEEP = (1, 2, 4, 8)

#: scaling-efficiency band for the modeled per-device decode step:
#: eff(tp) = t_model(1) / (tp * t_model(tp)) must stay at or above this
#: floor for every TP degree in the sweep (and never exceed 1 + slack —
#: super-linear modeled scaling would mean the capture lost work). The
#: floor is generous because the reduced-size bench model keeps full
#: d_model activations (norms, residuals) and the constant-size psum
#: payload on every device while the GEMM work shrinks by 1/tp.
SHARDED_EFF_FLOOR = 0.5
SHARDED_EFF_CEIL = 1.02


def check_sharded_invariant(rows: Sequence[dict]) -> List[tuple]:
    """The mesh-sharded serving invariant over serving_sharded rows.

    Single implementation shared by the section's own gate
    (``repro_torch.bench.sections.sharded_rows`` raises on any violation) and
    the compare CLI (regression Findings on the candidate artifact).
    Per case, over the :data:`SHARDED_TP_SWEEP` rows:

    * every TP degree of the sweep is present;
    * ``parity_ok`` is true on every row — the manual-TP engine must emit
      token streams identical to the single-device paged engine;
    * the tp=1 row has zero COLLECTIVE share and every tp>1 row a strictly
      positive one, strictly increasing with the TP degree — the
      communication horizon must appear, and grow, as the GEMM work
      per device shrinks;
    * ``modeled_eff`` stays within [:data:`SHARDED_EFF_FLOOR`,
      :data:`SHARDED_EFF_CEIL`] on every row.
    """
    violations: List[tuple] = []
    by_case: Dict[str, Dict[int, dict]] = {}
    for row in rows:
        tp = row.get("tp")
        if not isinstance(tp, int):
            violations.append((f"serving_sharded[{row.get('case')}]",
                               f"'tp' must be an int, got {tp!r}"))
            continue
        by_case.setdefault(str(row.get("case")), {})[tp] = row
    for case, by_tp in sorted(by_case.items()):
        where = f"serving_sharded[{case}]"
        missing = [t for t in SHARDED_TP_SWEEP if t not in by_tp]
        if missing:
            violations.append((where, (
                f"missing TP degrees {missing} (sweep requires all of "
                f"{list(SHARDED_TP_SWEEP)})")))
            continue
        prev_coll = None
        for tp in SHARDED_TP_SWEEP:
            row = by_tp[tp]
            rwhere = f"{where} tp={tp}"
            if row.get("parity_ok") is not True:
                violations.append((rwhere, (
                    "sharded token streams are not identical to the "
                    "single-device paged engine's (parity_ok is "
                    f"{row.get('parity_ok')!r})")))
            coll = row.get("collective_frac")
            if not _is_num(coll):
                violations.append((rwhere,
                                   f"collective_frac is {coll!r}"))
                continue
            coll = float(coll)
            if tp == 1 and coll != 0.0:
                violations.append((rwhere, (
                    f"collective_frac {coll:.4f} on one device — a "
                    f"single-device capture must contain no collectives")))
            if tp > 1 and not coll > 0.0:
                violations.append((rwhere, (
                    f"collective_frac is {coll:.4f} — the TP decode step "
                    f"must spend a nonzero share on COLLECTIVE ops")))
            if prev_coll is not None and not coll > prev_coll:
                violations.append((rwhere, (
                    f"collective_frac {coll:.4f} did not grow over the "
                    f"previous TP degree's {prev_coll:.4f} — the "
                    f"communication share must rise with TP")))
            prev_coll = coll
            eff = row.get("modeled_eff")
            if not _is_num(eff):
                violations.append((rwhere, f"modeled_eff is {eff!r}"))
            elif not SHARDED_EFF_FLOOR <= float(eff) <= SHARDED_EFF_CEIL:
                violations.append((rwhere, (
                    f"modeled per-device scaling efficiency {eff:.4f} "
                    f"outside [{SHARDED_EFF_FLOOR}, {SHARDED_EFF_CEIL}]")))
    return violations


def check_platforms_invariant(rows: Sequence[dict]) -> List[tuple]:
    """The cross-platform invariant over platforms-section rows.

    Single implementation shared by the section's own gate
    (``repro_torch.bench.sections.platform_rows`` raises on any violation) and
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


#: row keys required per known section (subset check; rows may carry more)
SECTION_ROW_KEYS: Dict[str, Sequence[str]] = {
    "breakdown": ("case", "mode", "total_s", "gemm_frac", "nongemm_frac",
                  "group_fracs"),
    "opgroups": ("case", "mode", "gemm_frac", "nongemm_frac", "group_fracs"),
    "top_table": ("case", "mode", "top_group", "top_pct", "gemm_frac",
                  "nongemm_frac"),
    "micro": ("operator", "group", "shape", "jit_us", "tpu_model_us"),
    "micro_harvested": ("operator", "group", "shape", "jit_us",
                        "tpu_model_us"),
    "kernels": ("site", "eager_mb", "kernel_mb", "allclose"),
    "roofline": ("arch", "shape", "mesh"),
    "serving": ("case", "phase"),
    "traffic": ("case", "phase"),
    "quantized": ("case", "mode", "variant", "gemm_frac", "nongemm_frac",
                  "group_fracs", "qdq_frac"),
    "fusion": ("case", "mode", "variant", "total_s", "gemm_frac",
               "nongemm_frac", "group_fracs", "fused_frac"),
    "vision": ("case", "mode", "variant", "kind", "total_s", "gemm_frac",
               "nongemm_frac", "group_fracs", "roi_frac", "interp_frac"),
    "platforms": ("case", "platform", "kind", "mode", "total_s", "gemm_s",
                  "gemm_frac", "nongemm_frac", "group_fracs"),
    "serving_sharded": ("case", "tp", "devices", "decode_tok_per_s",
                        "per_device_tok_per_s", "modeled_step_s",
                        "modeled_eff", "collective_frac", "parity_ok"),
}


#: the JAX package's row keys (``repro.bench.schema.SECTION_ROW_KEYS``),
#: which its artifacts are held to
JAX_SECTION_ROW_KEYS: Dict[str, Sequence[str]] = dict(
    SECTION_ROW_KEYS,
    kernels=("site", "eager_mb", "xla_mb", "pallas_mb", "allclose"))

#: the prefix of ``jax_version`` in an artifact the port wrote
PORT_VERSION_PREFIX = "torch "


def section_row_keys(d: dict) -> Dict[str, Sequence[str]]:
    """The row keys artifact ``d`` is held to: the port's, or the JAX
    package's for an artifact that package wrote."""
    version = d.get("jax_version")
    if isinstance(version, str) and not version.startswith(
            PORT_VERSION_PREFIX):
        return JAX_SECTION_ROW_KEYS
    return SECTION_ROW_KEYS


class SchemaError(ValueError):
    """Artifact failed schema validation."""


@dataclasses.dataclass(frozen=True)
class BenchCase:
    """One (model, batch, seq) point of the zoo, tagged with its tiers."""

    alias: str
    arch: str
    batch: int
    seq: int
    tiers: tuple = ("quick", "full")

    def __post_init__(self):
        # an unknown tier string would silently never run — fail loudly at
        # construction instead
        unknown = [t for t in self.tiers if t not in KNOWN_TIERS]
        if unknown or not self.tiers:
            raise ValueError(
                f"BenchCase {self.alias!r}: invalid tiers {self.tiers!r} "
                f"(known: {KNOWN_TIERS}, at least one required)")

    def __iter__(self):
        # unpacks like the legacy (alias, arch, batch, seq) tuples
        return iter((self.alias, self.arch, self.batch, self.seq))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["tiers"] = list(self.tiers)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "BenchCase":
        return cls(alias=d["alias"], arch=d["arch"], batch=int(d["batch"]),
                   seq=int(d["seq"]), tiers=tuple(d.get("tiers") or
                                                  ("quick", "full")))


@dataclasses.dataclass
class SectionResult:
    """One benchmark section's structured output."""

    name: str
    title: str
    status: str                      # one of STATUSES
    wall_s: float
    rows: List[dict] = dataclasses.field(default_factory=list)
    error: Optional[str] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SectionResult":
        return cls(name=d["name"], title=d.get("title", d["name"]),
                   status=d["status"], wall_s=float(d.get("wall_s", 0.0)),
                   rows=list(d.get("rows") or []), error=d.get("error"))


@dataclasses.dataclass
class BenchResult:
    """The whole artifact: one bench run, every section, versioned."""

    tier: str
    backend: str
    jax_version: str
    cases: List[BenchCase] = dataclasses.field(default_factory=list)
    sections: List[SectionResult] = dataclasses.field(default_factory=list)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    schema_version: int = SCHEMA_VERSION

    # -- access helpers ----------------------------------------------------

    def section(self, name: str) -> Optional[SectionResult]:
        for s in self.sections:
            if s.name == name:
                return s
        return None

    # -- (de)serialization -------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "schema_version": self.schema_version,
            "tier": self.tier,
            "backend": self.backend,
            "jax_version": self.jax_version,
            "cases": [c.to_dict() for c in self.cases],
            "sections": [s.to_dict() for s in self.sections],
            "meta": dict(self.meta),
        }

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=False)

    @classmethod
    def from_dict(cls, d: dict) -> "BenchResult":
        errs = validate_artifact(d)
        if errs:
            raise SchemaError("; ".join(errs))
        return cls(
            tier=d["tier"], backend=d["backend"],
            jax_version=d["jax_version"],
            cases=[BenchCase.from_dict(c) for c in d.get("cases", [])],
            sections=[SectionResult.from_dict(s) for s in d["sections"]],
            meta=dict(d.get("meta") or {}),
            schema_version=int(d["schema_version"]),
        )

    @classmethod
    def from_json(cls, text: str) -> "BenchResult":
        return cls.from_dict(json.loads(text))

    def dump(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.to_json())
            f.write("\n")
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "BenchResult":
        with open(path) as f:
            return cls.from_json(f.read())


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------

def _check_num(errs: list, where: str, row: dict, key: str) -> None:
    v = row.get(key)
    if not isinstance(v, (int, float)) or isinstance(v, bool):
        errs.append(f"{where}: '{key}' must be a number, got {v!r}")


def validate_artifact(d: Any) -> List[str]:
    """Return a list of human-readable schema violations (empty == valid)."""
    errs: List[str] = []
    if not isinstance(d, dict):
        return [f"artifact must be a JSON object, got {type(d).__name__}"]

    sv = d.get("schema_version")
    if not isinstance(sv, int):
        errs.append("schema_version missing or not an int")
    elif sv > SCHEMA_VERSION:
        errs.append(f"schema_version {sv} is newer than supported "
                    f"{SCHEMA_VERSION}")

    for key in ("tier", "backend", "jax_version"):
        if not isinstance(d.get(key), str):
            errs.append(f"'{key}' missing or not a string")
    if d.get("tier") not in (None, "quick", "full") and \
            isinstance(d.get("tier"), str):
        errs.append(f"tier must be 'quick' or 'full', got {d['tier']!r}")

    cases = d.get("cases", [])
    if not isinstance(cases, list):
        errs.append("'cases' must be a list")
        cases = []
    for i, c in enumerate(cases):
        if not isinstance(c, dict):
            errs.append(f"cases[{i}] must be an object")
            continue
        for key in ("alias", "arch"):
            if not isinstance(c.get(key), str):
                errs.append(f"cases[{i}].{key} missing or not a string")
        for key in ("batch", "seq"):
            if not isinstance(c.get(key), int):
                errs.append(f"cases[{i}].{key} missing or not an int")

    row_keys = section_row_keys(d)
    sections = d.get("sections")
    if not isinstance(sections, list) or not sections:
        errs.append("'sections' missing, not a list, or empty")
        sections = []
    for i, s in enumerate(sections):
        if not isinstance(s, dict):
            errs.append(f"sections[{i}] must be an object")
            continue
        name = s.get("name")
        where = f"sections[{i}]" + (f" ({name})" if name else "")
        if not isinstance(name, str) or not name:
            errs.append(f"{where}: 'name' missing or not a string")
            name = ""
        if s.get("status") not in STATUSES:
            errs.append(f"{where}: status {s.get('status')!r} not in "
                        f"{STATUSES}")
        if not isinstance(s.get("wall_s"), (int, float)):
            errs.append(f"{where}: 'wall_s' missing or not a number")
        rows = s.get("rows", [])
        if not isinstance(rows, list):
            errs.append(f"{where}: 'rows' must be a list")
            rows = []
        if s.get("status") == "ok" and name in row_keys:
            required = row_keys[name]
            for j, row in enumerate(rows):
                rwhere = f"{where}.rows[{j}]"
                if not isinstance(row, dict):
                    errs.append(f"{rwhere}: row must be an object")
                    continue
                for key in required:
                    if key not in row:
                        errs.append(f"{rwhere}: missing key '{key}'")
                if name in SHARE_SECTIONS:
                    for key in ("gemm_frac", "nongemm_frac"):
                        if key in row:
                            _check_num(errs, rwhere, row, key)
                            v = row.get(key)
                            if isinstance(v, (int, float)) and \
                                    not isinstance(v, bool) and \
                                    not -1e-6 <= v <= 1.0 + 1e-6:
                                errs.append(f"{rwhere}: '{key}'={v} outside "
                                            f"[0, 1]")
    return errs
