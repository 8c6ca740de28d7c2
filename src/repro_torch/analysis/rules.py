"""nglint rule registry — Rule / Finding dataclasses and the runner.

The port of ``repro.analysis.rules`` over the port's captures
(:class:`~repro_torch.core.graph.OpRecord`), with the same names, fields
and behaviour.

A :class:`Rule` is a named, severity-tagged check over an
:class:`AnalysisContext` (one workload × variant capture, plus its
post-rewrite stream) that yields :class:`Finding`\\s. Rules register into
a module-level registry via :func:`register_rule` (or the :func:`rule`
decorator); :func:`run_rules` drives them and never lets one broken rule
take down the whole pass — a crashing check becomes an ``error`` finding
against the rule itself.

Two rule scopes:

* ``"graph"`` (the default) — runs once per workload × variant context;
* ``"static"`` — workload-independent (kernel tables, pattern/kernel
  cross-checks); runs once per analysis invocation with ``ctx=None``.
  A static rule that captures (NG009) runs on the analysis device,
  :func:`static_device`, which :func:`run_static_rules` sets.
"""

from __future__ import annotations

import contextvars
import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence

from repro_torch.core.graph import OpRecord
from repro_torch.core.workload import Workload

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass
class Finding:
    """One analyzer hit, carrying enough context to act on it."""

    rule: str           # "NG001"
    severity: str       # error | warning | info
    workload: str       # "<name>/<variant>", or "static" for static rules
    where: str          # op site / scope / kernel name the finding anchors to
    message: str
    fix_hint: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Finding":
        return cls(**{f.name: d.get(f.name, "") for f in
                      dataclasses.fields(cls)})


@dataclasses.dataclass
class AnalysisContext:
    """Everything a graph-scoped rule may inspect for one workload variant."""

    workload: Workload
    variant: str                     # "fp32" | "int8-qdq" | "fused" | ...
    records: List[OpRecord]          # raw captured stream
    rewritten: List[OpRecord]        # after the transforms' record rewrites
    fused: bool = False              # a FusionTransform is in the chain
    group_shares: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: committed per-group shares for this key (NG008), empty when the
    #: baseline has no entry yet
    baseline_shares: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    share_tolerance: float = 0.03

    @property
    def key(self) -> str:
        return f"{self.workload.name}/{self.variant}"


@dataclasses.dataclass(frozen=True)
class Rule:
    """One registered check. ``check`` yields Findings (may return None)."""

    id: str
    title: str
    severity: str
    check: Callable[[Optional[AnalysisContext]], Iterable[Finding]]
    scope: str = "graph"             # "graph" | "static"

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"rule {self.id}: severity {self.severity!r} not in "
                f"{SEVERITIES}")
        if self.scope not in ("graph", "static"):
            raise ValueError(f"rule {self.id}: unknown scope {self.scope!r}")


_RULES: Dict[str, Rule] = {}

_DEVICE = contextvars.ContextVar("nglint_static_device", default="cpu")


def static_device() -> str:
    """The device the running static rules capture on."""
    return _DEVICE.get()


def register_rule(r: Rule) -> Rule:
    if r.id in _RULES:
        raise ValueError(f"duplicate rule id {r.id!r}")
    _RULES[r.id] = r
    return r


def rule(id: str, title: str, severity: str = "warning",
         scope: str = "graph"):
    """Decorator form of :func:`register_rule`."""

    def deco(fn):
        register_rule(Rule(id=id, title=title, severity=severity,
                           check=fn, scope=scope))
        return fn

    return deco


def get_rule(rule_id: str) -> Rule:
    try:
        return _RULES[rule_id]
    except KeyError:
        raise KeyError(f"unknown rule {rule_id!r}; known: "
                       f"{sorted(_RULES)}") from None


def all_rules() -> List[Rule]:
    return [_RULES[k] for k in sorted(_RULES)]


def _run_one(r: Rule, ctx: Optional[AnalysisContext],
             where: str) -> List[Finding]:
    try:
        return list(r.check(ctx) or ())
    except Exception as e:  # a broken rule must not kill the pass
        return [Finding(rule=r.id, severity="error", workload=where,
                        where="<rule crashed>",
                        message=f"rule check raised {type(e).__name__}: {e}",
                        fix_hint="fix the rule implementation in "
                                 "repro_torch/analysis/builtin.py")]


def run_rules(ctx: AnalysisContext,
              rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    """Run every graph-scoped rule over one context."""
    findings: List[Finding] = []
    for r in (all_rules() if rules is None else rules):
        if r.scope != "graph":
            continue
        findings.extend(_run_one(r, ctx, ctx.key))
    return findings


def run_static_rules(rules: Optional[Sequence[Rule]] = None,
                     device: str = "cpu") -> List[Finding]:
    """Run every static-scoped rule (once per analysis invocation), those
    that capture on ``device``."""
    findings: List[Finding] = []
    token = _DEVICE.set(device)
    try:
        for r in (all_rules() if rules is None else rules):
            if r.scope != "static":
                continue
            findings.extend(_run_one(r, None, "static"))
    finally:
        _DEVICE.reset(token)
    return findings
