"""Committed findings baseline — the nglint suppression / drift gate.

The port of ``repro.analysis.baseline``: the same schema and gate over the
port's own file, ``analysis_baseline.json`` beside this module, written by
the port's CLI on the card. JAX's ``benchmarks/analysis_baseline.json`` is
the reference's and is never written from here.

The file records, per ``workload/variant``
key, (a) the modeled per-group latency shares (NG008's reference) and
(b) the accepted finding counts per rule (the suppression budget). CI
fails only on findings **above** the committed budget — the same gate
shape as ``repro.bench.compare`` vs ``benchmarks/baseline.json``:

* a key present in the run but absent from the baseline is *new
  coverage*: its findings all count as new (budget 0), its shares are
  not drift-checked;
* a (key, rule) count at or below the committed count is suppressed;
* ``--write-baseline`` regenerates the file from the current run, which
  is the one sanctioned way to accept a finding.

The port's baseline prices on the ``a100`` spec, as JAX's does; its shares
differ from JAX's where the captures do (aten ops, not jaxpr primitives).

Schema is versioned; :class:`BaselineError` on mismatch rather than a
silent misread.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from collections import Counter
from typing import Dict, List, Optional, Sequence

from .rules import Finding

BASELINE_VERSION = 1

#: default location: the port's own file, resolved from this module's path
DEFAULT_BASELINE = str(pathlib.Path(__file__).resolve().parent
                       / "analysis_baseline.json")

#: NG008 default: max absolute per-group share drift before a finding
DEFAULT_SHARE_TOLERANCE = 0.03


class BaselineError(ValueError):
    """Unreadable / wrong-version baseline artifact."""


@dataclasses.dataclass
class WorkloadBaseline:
    group_shares: Dict[str, float] = dataclasses.field(default_factory=dict)
    findings: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class AnalysisBaseline:
    version: int = BASELINE_VERSION
    share_tolerance: float = DEFAULT_SHARE_TOLERANCE
    workloads: Dict[str, WorkloadBaseline] = dataclasses.field(
        default_factory=dict)

    def entry(self, key: str) -> Optional[WorkloadBaseline]:
        return self.workloads.get(key)

    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "share_tolerance": self.share_tolerance,
            "workloads": {
                k: {"group_shares": dict(sorted(w.group_shares.items())),
                    "findings": dict(sorted(w.findings.items()))}
                for k, w in sorted(self.workloads.items())
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "AnalysisBaseline":
        if not isinstance(d, dict):
            raise BaselineError("baseline artifact is not a JSON object")
        version = d.get("version")
        if version != BASELINE_VERSION:
            raise BaselineError(
                f"baseline version {version!r} != supported "
                f"{BASELINE_VERSION}; regenerate with "
                "`python -m repro_torch.analyze --all --write-baseline`")
        workloads = {}
        for key, w in (d.get("workloads") or {}).items():
            workloads[key] = WorkloadBaseline(
                group_shares={str(g): float(s)
                              for g, s in (w.get("group_shares") or {}
                                           ).items()},
                findings={str(r): int(n)
                          for r, n in (w.get("findings") or {}).items()})
        return cls(version=version,
                   share_tolerance=float(d.get("share_tolerance",
                                               DEFAULT_SHARE_TOLERANCE)),
                   workloads=workloads)


def load_baseline(path) -> AnalysisBaseline:
    p = pathlib.Path(path)
    try:
        data = json.loads(p.read_text())
    except FileNotFoundError:
        raise BaselineError(f"baseline not found: {p}") from None
    except json.JSONDecodeError as e:
        raise BaselineError(f"baseline {p} is not valid JSON: {e}") from None
    return AnalysisBaseline.from_dict(data)


def save_baseline(baseline: AnalysisBaseline, path) -> None:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(baseline.to_dict(), indent=2, sort_keys=False)
                 + "\n")


def build_baseline(shares_by_key: Dict[str, Dict[str, float]],
                   findings: Sequence[Finding],
                   share_tolerance: float = DEFAULT_SHARE_TOLERANCE
                   ) -> AnalysisBaseline:
    """Snapshot a run into a committable baseline (``--write-baseline``)."""
    counts: Dict[str, Counter] = {}
    for f in findings:
        counts.setdefault(f.workload, Counter())[f.rule] += 1
    keys = set(shares_by_key) | set(counts)
    return AnalysisBaseline(
        share_tolerance=share_tolerance,
        workloads={
            k: WorkloadBaseline(
                group_shares=dict(shares_by_key.get(k, {})),
                findings=dict(counts.get(k, Counter())))
            for k in sorted(keys)
        })


def gate_findings(findings: Sequence[Finding],
                  baseline: Optional[AnalysisBaseline]
                  ) -> List[Finding]:
    """The CI gate: findings exceeding the committed per-(key, rule) budget.

    With no baseline, every finding is new. With one, each (workload key,
    rule) bucket gets ``baseline.findings[rule]`` suppressions; findings
    beyond that count — in stream order — are returned as new.
    """
    if baseline is None:
        return list(findings)
    budget: Dict[tuple, int] = {}
    new: List[Finding] = []
    for f in findings:
        k = (f.workload, f.rule)
        if k not in budget:
            entry = baseline.entry(f.workload)
            budget[k] = (entry.findings.get(f.rule, 0)
                         if entry is not None else 0)
        if budget[k] > 0:
            budget[k] -= 1
        else:
            new.append(f)
    return new
