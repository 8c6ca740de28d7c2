"""Measured per-op profiles: the paper's GEMM / NonGEMM split.

The port of ``repro.core.profiler.ModelProfile`` and of
``repro.core.roofline.gemm_nongemm_split``. :func:`profile_measured` runs a
function through :func:`repro_torch.core.graph.timed_run` — every op
dispatched and synchronised on its own, as eager PyTorch runs it in the
paper — and sums the per-op times by operator group and op site. On the
card the times are CUDA-event device times; on the CPU they are host
times, and the mode says which.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Callable, List, Optional

from .graph import TimedOp, timed_run
from .taxonomy import NONGEMM_GROUPS, OpGroup


def gemm_nongemm_split(group_seconds: dict) -> dict:
    gemm = group_seconds.get(OpGroup.GEMM.value, 0.0)
    nongemm = sum(t for g, t in group_seconds.items()
                  if OpGroup(g) in NONGEMM_GROUPS)
    other = sum(group_seconds.values()) - gemm - nongemm
    total = gemm + nongemm + other
    return {
        "gemm_s": gemm,
        "nongemm_s": nongemm,
        "other_s": other,
        "gemm_frac": gemm / total if total else 0.0,
        "nongemm_frac": nongemm / total if total else 0.0,
    }


@dataclasses.dataclass
class ModelProfile:
    name: str
    mode: str                              # "measured_cuda" | "measured_cpu"
    group_seconds: dict                    # group -> seconds
    total_seconds: float
    op_seconds: dict                       # (group, op_site) -> seconds
    n_ops: int
    timed_ops: Optional[List[TimedOp]] = None

    @property
    def split(self) -> dict:
        return gemm_nongemm_split(self.group_seconds)

    def top_nongemm_groups(self, k: int = 3) -> list:
        """Paper Table 5: most expensive NonGEMM operator groups."""
        items = [(g, t) for g, t in self.group_seconds.items()
                 if OpGroup(g) in NONGEMM_GROUPS]
        items.sort(key=lambda kv: kv[1], reverse=True)
        total = self.total_seconds or 1.0
        return [(g, t, 100.0 * t / total) for g, t in items[:k]]

    def top_op_sites(self, k: int = 10) -> list:
        items = sorted(self.op_seconds.items(), key=lambda kv: kv[1],
                       reverse=True)
        total = self.total_seconds or 1.0
        return [(site, t, 100.0 * t / total) for site, t in items[:k]]


def aggregate(name: str, mode: str, ops: List[TimedOp]) -> ModelProfile:
    group_s: dict = defaultdict(float)
    op_s: dict = defaultdict(float)
    for t in ops:
        group_s[t.record.group.value] += t.seconds
        op_s[(t.record.group.value, t.record.op_site)] += t.seconds
    return ModelProfile(name=name, mode=mode, group_seconds=dict(group_s),
                        total_seconds=sum(group_s.values()),
                        op_seconds=dict(op_s), n_ops=len(ops), timed_ops=ops)


def profile_measured(fn: Callable, *args, name: str = "model",
                     repeats: int = 3, **kwargs) -> ModelProfile:
    """Per-op measured profile of ``fn(*args, **kwargs)``."""
    _, ops = timed_run(fn, *args, repeats=repeats, **kwargs)
    on_card = any(op.record.device == "cuda" for op in ops)
    return aggregate(name, "measured_cuda" if on_card else "measured_cpu", ops)
