"""Roofline terms, the GEMM / NonGEMM split and the MODEL_FLOPS helpers.

A copy of the parts of ``repro.core.roofline`` that read no HLO:
:class:`RooflineTerms` (compute, memory and collective terms of one step),
:func:`gemm_nongemm_split` (the paper's split of per-group seconds) and
the MODEL_FLOPS helpers (6·N·D to train, 2·N·D to infer, attention's extra
score and value FLOPs). ``roofline_from_hlo`` and ``group_latency_model``
read a compiled module's ``HloAnalysis``; the port compiles none, so they
have no twin here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .taxonomy import NONGEMM_GROUPS, OpGroup


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    n_chips: int
    hw: str = "tpu_v5e"
    model_flops: float = 0.0          # whole-step useful FLOPs (all chips)
    hlo_flops_per_device: float = 0.0
    hlo_bytes_per_device: float = 0.0
    collective_bytes_per_device: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Lower-bound step time if the three terms overlap perfectly."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def serial_s(self) -> float:
        """Upper-bound step time with zero overlap."""
        return self.compute_s + self.memory_s + self.collective_s

    @property
    def useful_ratio(self) -> float:
        total = self.hlo_flops_per_device * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the overlapped roofline bound."""
        if self.bound_s <= 0:
            return 0.0
        peak = self.n_chips * 197e12 if self.hw == "tpu_v5e" else None
        if peak is None:
            return 0.0
        return self.model_flops / (self.bound_s * peak)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant, bound_s=self.bound_s,
                 serial_s=self.serial_s, useful_ratio=self.useful_ratio,
                 mfu=self.mfu)
        return d


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


# ---------------------------------------------------------------------------
# MODEL_FLOPS helpers
# ---------------------------------------------------------------------------

def train_model_flops(n_params_active: float, tokens: float) -> float:
    return 6.0 * n_params_active * tokens


def decode_model_flops(n_params_active: float, tokens: float,
                       kv_read_flops: float = 0.0) -> float:
    return 2.0 * n_params_active * tokens + kv_read_flops


def attention_flops(batch: int, seq: int, n_q_heads: int, head_dim: int,
                    causal: bool = True, window: Optional[int] = None,
                    train: bool = True) -> float:
    """Extra (non-6ND) attention score/value FLOPs for MODEL_FLOPS."""
    if window is not None and window < seq:
        eff = seq * window
    else:
        eff = seq * seq / (2 if causal else 1)
    fwd = 2 * 2.0 * batch * n_q_heads * head_dim * eff
    return fwd * (3.0 if train else 1.0)
