"""Measured-vs-modeled calibration for the hardware platform models.

A copy of ``repro.core.calibrate`` (a test holds its pure functions to
the original's on the same inputs). The analytic
:class:`~repro_torch.core.hardware.HardwareSpec` rooflines are only
trustworthy insofar as they track something real. The port measures on
the card, so the loop closes there:

1. run the Table-2 NonGEMM micro suite (``core/microbench.py``) on the
   card and pair each row's *measured* device time (``device_us``, on the
   clean-L2 ``graph.Timer``) with the *modeled* bandwidth time of the same
   bytes on a chosen spec (``hw.group_mem_time(group, bytes_touched)``);
2. fit one correction factor per operator group — the ratio of measured to
   modeled time, pooled over the suite (ratio of sums, so big ops dominate
   rather than every tiny op voting equally);
3. emit a versioned :class:`CalibratedHardwareSpec` that the
   ``calibrated:<hw>`` profiler backend (``core/workload.py``) applies on
   top of the base roofline, so reports can show modeled, measured, and
   calibrated columns plus a drift metric.

Rows already measured (``chip_smoke.py``'s ``micro`` phase) are fitted
without measuring again: :func:`micro_row_samples`.
"""

from __future__ import annotations

import dataclasses
import json
import math
from collections import defaultdict
from functools import lru_cache
from typing import Dict, Iterable, Optional, Sequence, Tuple

from .hardware import HardwareSpec, get_hardware

#: Serialization format version; bump on incompatible factor semantics.
CALIBRATION_VERSION = 1

#: Default microbench subset for fitting: covers the NonGEMM groups the
#: bench workloads actually exercise, kept small so fitting stays cheap
#: (each op is a few timed runs on the card).
DEFAULT_CALIBRATION_OPS: Tuple[str, ...] = (
    "add", "mul", "softmax", "rms_norm", "layer_norm", "gelu", "silu",
    "reshape_permute",
)

#: One fitting sample: (group value, measured seconds, modeled seconds).
Sample = Tuple[str, float, float]


class CalibrationError(ValueError):
    """Raised on unusable calibration inputs or incompatible artifacts."""


def fit_factors(samples: Iterable[Sample]) -> Dict[str, float]:
    """Per-group correction factors: sum(measured) / sum(modeled).

    Groups whose pooled modeled time is zero are skipped — there is nothing
    to correct against. A profile synthesized from the spec's own model
    (measured == modeled) recovers factors of exactly 1.0.
    """
    meas: Dict[str, float] = defaultdict(float)
    model: Dict[str, float] = defaultdict(float)
    for group, measured_s, modeled_s in samples:
        meas[group] += measured_s
        model[group] += modeled_s
    return {g: meas[g] / model[g] for g in sorted(model) if model[g] > 0}


@dataclasses.dataclass(frozen=True)
class CalibratedHardwareSpec:
    """A base :class:`HardwareSpec` plus fitted per-group correction factors.

    Duck-types the spec's ``group_time``/``group_mem_time`` so the profiler
    backends can use either interchangeably; groups without a fitted factor
    fall back to 1.0 (the uncorrected roofline).
    """

    base: HardwareSpec
    factors: Tuple[Tuple[str, float], ...]   # ((group, factor), ...)
    version: int = CALIBRATION_VERSION
    source: str = ""                          # how/where the fit was made

    @property
    def name(self) -> str:
        return f"{self.base.name}+cal"

    def factor(self, group: str) -> float:
        for g, f in self.factors:
            if g == group:
                return f
        return 1.0

    def group_time(self, group: str, flops: float, nbytes: float,
                   dtype: str = "bf16") -> float:
        return self.base.group_time(group, flops, nbytes, dtype) \
            * self.factor(group)

    def group_mem_time(self, group: str, nbytes: float) -> float:
        return self.base.group_mem_time(group, nbytes) * self.factor(group)

    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "base": self.base.name,
            "factors": {g: f for g, f in self.factors},
            "source": self.source,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CalibratedHardwareSpec":
        version = d.get("version")
        if version != CALIBRATION_VERSION:
            raise CalibrationError(
                f"calibration artifact version {version!r} != supported "
                f"{CALIBRATION_VERSION}")
        return cls(base=get_hardware(d["base"]),
                   factors=tuple(sorted(d.get("factors", {}).items())),
                   version=version, source=d.get("source", ""))


def calibrate(hw: HardwareSpec, samples: Iterable[Sample],
              source: str = "") -> CalibratedHardwareSpec:
    factors = fit_factors(samples)
    if not factors:
        raise CalibrationError("no usable samples (all modeled times zero?)")
    return CalibratedHardwareSpec(
        base=hw, factors=tuple(sorted(factors.items())), source=source)


def save_calibration(cal: CalibratedHardwareSpec, path: str) -> None:
    with open(path, "w") as f:
        json.dump(cal.to_dict(), f, indent=2, sort_keys=True)
        f.write("\n")


def load_calibration(path: str) -> CalibratedHardwareSpec:
    with open(path) as f:
        return CalibratedHardwareSpec.from_dict(json.load(f))


# ---------------------------------------------------------------------------
# Fitting sources
# ---------------------------------------------------------------------------

def micro_row_samples(rows: Iterable, hw: HardwareSpec,
                      names: Optional[Sequence[str]] = None) -> list:
    """Measured-vs-modeled samples from Table-2 rows already measured
    (``microbench.MicroResult``): measured is the row's ``device_us``,
    modeled the spec's group-aware bandwidth time for the row's bytes.
    Only the rows named (default :data:`DEFAULT_CALIBRATION_OPS`)."""
    names = set(names or DEFAULT_CALIBRATION_OPS)
    return [(r.group, 1e-6 * r.device_us,
             hw.group_mem_time(r.group, r.bytes_touched))
            for r in rows if r.name in names]


def microbench_samples(hw: HardwareSpec,
                       names: Optional[Sequence[str]] = None,
                       repeats: int = 5) -> list:
    """Measured-vs-modeled samples from the Table-2 micro suite, measured
    now on the card (raises where CUDA is absent: the samples are the
    card's)."""
    import torch

    from .microbench import run_micro
    if not torch.cuda.is_available():
        raise RuntimeError("calibration measures the micro suite on the "
                           "card, and CUDA is not available")
    names = tuple(names or DEFAULT_CALIBRATION_OPS)
    rows = [run_micro(n, repeats=repeats, device="cuda", measure_eager=False)
            for n in names]
    return micro_row_samples(rows, hw, names)


def calibrate_from_microbench(hw: HardwareSpec,
                              names: Optional[Sequence[str]] = None,
                              repeats: int = 5,
                              rows: Optional[Sequence] = None
                              ) -> CalibratedHardwareSpec:
    """Fit ``hw`` from the micro suite: measured now on the card, or from
    ``rows`` already measured."""
    names = tuple(names or DEFAULT_CALIBRATION_OPS)
    if rows is None:
        samples = microbench_samples(hw, names, repeats=repeats)
        device = "cuda"
    else:
        samples = micro_row_samples(rows, hw, names)
        device = "+".join(sorted({r.device for r in rows}))
    return calibrate(hw, samples,
                     source=f"microbench:{','.join(names)}@{device}")


@lru_cache(maxsize=None)
def default_calibration(hw_name: str) -> CalibratedHardwareSpec:
    """Memoized default fit for ``calibrated:<hw>`` backends.

    Measuring happens once per spec per process; the cache key is the
    registry name so frozen-spec identity doesn't matter.
    """
    return calibrate_from_microbench(get_hardware(hw_name), repeats=3)


# ---------------------------------------------------------------------------
# Drift: how far apart two per-group time breakdowns are
# ---------------------------------------------------------------------------

def drift_by_group(measured: Dict[str, float],
                   modeled: Dict[str, float]) -> Dict[str, float]:
    """Per-group measured/modeled time ratios (1.0 == perfect model).

    Only groups the model assigns nonzero time to are comparable; others
    are omitted rather than reported as infinite drift.
    """
    return {g: measured.get(g, 0.0) / t
            for g, t in sorted(modeled.items()) if t > 0}


def max_abs_log2_drift(drift: Dict[str, float]) -> float:
    """Worst-group drift in doublings: max |log2(ratio)|, 0.0 if empty.

    Symmetric in over/under-prediction: a model 4x too fast and one 4x too
    slow both score 2.0.
    """
    vals = [abs(math.log2(r)) for r in drift.values() if r > 0]
    return max(vals) if vals else 0.0
