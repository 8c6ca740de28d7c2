"""repro_torch.core — capture -> classify -> measured per-op profile."""

from .taxonomy import (OpGroup, NONGEMM_GROUPS, scope_tag, parse_scope,
                       classify)
from .graph import OpRecord, TimedOp, capture, timed_run
from .profiler import ModelProfile, gemm_nongemm_split, profile_measured

__all__ = [
    "OpGroup", "NONGEMM_GROUPS", "scope_tag", "parse_scope", "classify",
    "OpRecord", "TimedOp", "capture", "timed_run",
    "ModelProfile", "gemm_nongemm_split", "profile_measured",
]
