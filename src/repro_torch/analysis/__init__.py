"""nglint — rule-based static analysis over the port's captured artifacts.

The port of ``repro.analysis`` with its public names. The paper's method
attributes latency to a fixed operator taxonomy, so every silent taxonomy
hole, missed fusion, or estimator gap corrupts the headline numbers. This
package is the correctness tool for that surface: a rule registry
(:mod:`repro_torch.analysis.rules`) plus nine built-in rules
(:mod:`repro_torch.analysis.builtin`, NG001–NG009) that walk the captured
:class:`~repro_torch.core.graph.OpRecord` stream, the fusion-rewritten
graph, and the CUDA kernel specs (``repro_torch.kernels.ops.KERNEL_SPECS``).
Findings gate against the port's committed baseline
(:mod:`repro_torch.analysis.baseline`,
``repro_torch/analysis/analysis_baseline.json``).

Entry point: ``python -m repro_torch.analyze [--all|workload-ids]
[--device cuda|cpu] [--json] [--baseline PATH]`` (see
:mod:`repro_torch.analysis.cli`; ``python -m repro_torch.analysis`` is an
alias).
"""

from . import builtin  # noqa: F401  (registers the NG rules on import)
from .baseline import (AnalysisBaseline, BaselineError, build_baseline,
                       gate_findings, load_baseline, save_baseline)
from .builtin import rule_catalog
from .cli import analyze, build_context, main, render_summary_markdown
from .rules import (AnalysisContext, Finding, Rule, all_rules, get_rule,
                    register_rule, rule, run_rules, run_static_rules)

__all__ = [
    "AnalysisBaseline", "AnalysisContext", "BaselineError", "Finding",
    "Rule", "all_rules", "analyze", "build_baseline", "build_context",
    "gate_findings", "get_rule", "load_baseline", "main", "register_rule",
    "render_summary_markdown", "rule", "rule_catalog", "run_rules",
    "run_static_rules", "save_baseline",
]
