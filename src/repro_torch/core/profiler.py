"""Measured per-op profiles: the paper's GEMM / NonGEMM split.

The port of ``repro.core.profiler.ModelProfile`` and of
``repro.core.roofline.gemm_nongemm_split``. :func:`profile_measured` runs a
function through :func:`repro_torch.core.graph.timed_run` — every op
dispatched and synchronised on its own, as eager PyTorch runs it in the
paper — and sums the per-op times by operator group and op site. On the
card the times are CUDA-event device times; on the CPU they are host
times, and the mode says which.

Beside the measured views, the modeled eager view of JAX's
``repro.core.profiler``: :func:`model_records` prices a captured op stream
on one :class:`~repro_torch.core.hardware.HardwareSpec` (per-op group
roofline plus a launch overhead), and :func:`_accelerated_eager_profile`
captures, rewrites and models in one call. :func:`_wallclock` is the
un-instrumented end-to-end time. The ``Workload`` backends
(``core/workload.py``) are the public entry points to all of them.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from collections import defaultdict
from typing import Callable, List, Optional

import torch

from .graph import TimedOp, timed_run
from .roofline import gemm_nongemm_split
from .taxonomy import NONGEMM_GROUPS, OpGroup


@dataclasses.dataclass
class ModelProfile:
    name: str
    mode: str                  # "measured_cuda" | "measured_cpu" | "eager_<hw>" ...
    group_seconds: dict                    # group -> seconds
    total_seconds: float
    op_seconds: dict                       # (group, op_site) -> seconds
    n_ops: int
    timed_ops: Optional[List[TimedOp]] = None
    #: the compiled view's readings (``core/compiled.measure``): ``wall_s``
    #: (the un-instrumented call), ``compile_s``, ``launches`` per kernel
    #: of the profiled call, ``profiles`` (taken to find every counted
    #: kernel), ``guard`` (the output against the eager one)
    compiled: Optional[dict] = None

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


def model_records(records, name: str, hw,
                  launch_overhead_s: float = 5e-6,
                  mode: Optional[str] = None) -> ModelProfile:
    """Model an already-captured OpRecord stream on one platform.

    This is the modeling half of the eager-accelerated view, split out so a
    single capture can be swept across many :class:`HardwareSpec`s (the
    ``platforms`` bench section) or a
    :class:`~repro_torch.core.calibrate.CalibratedHardwareSpec` — ``hw``
    needs only a ``group_time(group, flops, nbytes)`` method. Per record:
    group-aware roofline + ``launch_overhead_s`` per trip.
    """
    group_s: dict = defaultdict(float)
    op_s: dict = defaultdict(float)
    link_bw = getattr(hw, "link_bw", 0.0)
    n = 0
    for r in records:
        if r.group is OpGroup.COLLECTIVE and link_bw:
            # collectives move bytes over the interconnect, not HBM
            t = r.bytes_accessed / link_bw \
                + launch_overhead_s * r.trip_count
        else:
            t = hw.group_time(r.group.value, r.flops, r.bytes_accessed) \
                + launch_overhead_s * r.trip_count
        group_s[r.group.value] += t
        op_s[(r.group.value, r.op_site)] += t
        n += 1
    total = sum(group_s.values())
    return ModelProfile(name=name, mode=mode or f"eager_{hw.name}",
                        group_seconds=dict(group_s), total_seconds=total,
                        op_seconds=dict(op_s), n_ops=n)


def _eager_profile(fn: Callable, *args, name: str = "model",
                   repeats: int = 3, **kwargs) -> ModelProfile:
    """Measured eager CPU: every op dispatched and wall-timed alone."""
    _, ops = timed_run(fn, *args, repeats=repeats, **kwargs)
    return aggregate(name, "eager_cpu", ops)


def _accelerated_eager_profile(fn: Callable, *args, name: str = "model",
                               hw=None,
                               launch_overhead_s: float = 5e-6,
                               record_rewrite: Optional[Callable] = None,
                               mode: Optional[str] = None,
                               **kwargs) -> ModelProfile:
    """The paper's GPU setting, modeled: *eager* accelerated execution.

    Each captured op dispatches as its own kernel: per-op max(flops/peak,
    bytes/bw) at the group's efficiency point + a fixed launch overhead,
    no fusion beyond what ``record_rewrite`` does to the capture.
    """
    from .graph import capture
    from .hardware import GPU_A100

    hw = hw or GPU_A100
    records = capture(fn, *args, **kwargs)
    if record_rewrite is not None:
        records = record_rewrite(records)
    return model_records(records, name=name, hw=hw,
                         launch_overhead_s=launch_overhead_s, mode=mode)


def _wallclock(fn: Callable, *args, repeats: int = 5, **kwargs) -> float:
    """End-to-end seconds of one un-instrumented call: the median of
    ``repeats`` calls after one untimed warm-up (``1 + repeats`` calls in
    all); with ``torch.cuda.synchronize()`` around each call on the card,
    so the host clock spans the device's work."""
    on_card = torch.cuda.is_available()
    fn(*args, **kwargs)
    ts = []
    for _ in range(repeats):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        if on_card:
            torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)
