"""repro_torch.bench — the port's machine-readable benchmark pipeline.

The port of ``repro.bench``: everything the paper reproduction
*measures* on the card flows through here:

    cases.py     the model zoo cases profiled by every section
    schema.py    BenchCase / SectionResult / BenchResult dataclasses +
                 the versioned JSON artifact format and its validator
    sections.py  one registered section per paper table/figure, each
                 returning structured rows (never pre-rendered text)
    runner.py    tiered (--quick/--full) execution with per-section
                 timeouts, producing a single ``results/bench.json``
    compare.py   regression CLI: diff two artifacts, exit nonzero on
                 latency-share / correctness / modeled-number drift

Text tables are *renderers over the artifact*
(``repro_torch.core.report``), so CI and humans read the same numbers.
Runs go to the card unless the CPU is asked for (``--device cpu``)::

    python -m repro_torch.bench run --quick
    python -m repro_torch.bench list
    python -m repro_torch.bench compare baseline.json results/bench.json
"""

from .schema import (SCHEMA_VERSION, BenchCase, BenchResult, SectionResult,
                     SchemaError, validate_artifact)
from .cases import (CASES, bench_config, build, case_workload, profile_case,
                    profile_case_compiled, profile_case_quantized,
                    quick_cases, tier_cases, workload_for_case)
from .runner import (SECTIONS, BenchContext, register_section, run_bench,
                     run_section)

__all__ = [
    "SCHEMA_VERSION", "BenchCase", "BenchResult", "SectionResult",
    "SchemaError", "validate_artifact", "CASES", "bench_config", "build",
    "case_workload", "profile_case", "profile_case_compiled",
    "profile_case_quantized",
    "quick_cases", "tier_cases", "workload_for_case", "SECTIONS",
    "BenchContext", "register_section", "run_bench", "run_section",
]
