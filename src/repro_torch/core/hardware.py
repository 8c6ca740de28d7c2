"""Hardware platform models for the modeled eager views.

A copy of ``repro.core.hardware`` (a test pins the five JAX specs field
for field): the :class:`HardwareSpec` roofline with its per-OpGroup
efficiency table, the five operating points of the paper's platform
matrix (``tpu_v5e``, ``a100``, ``cpu``, ``npu_ryzen``, ``membound_dimm``;
``docs/hardware.md`` gives their provenance), and ``get_hardware`` /
``list_hardware``.

The port adds ``h100``, the card it runs on, from the NVIDIA H100 SXM5
80GB data sheet. It has no efficiency table: the measured corrections come
from ``calibrated:h100`` (``core/calibrate.py``, fitted on the card), not
from invented factors. Its ``hbm_bw`` is the one memory rate the port's
byte bounds divide by (``core/microbench.py``, ``chip_smoke.py``,
``scripts/norm_timing.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

#: Wildcard key in :attr:`HardwareSpec.group_efficiency` matching any group
#: without an explicit entry.
ANY_GROUP = "*"


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    #: Registry key (``get_hardware(name)``) and suffix of profile modes
    #: (``eager_<name>`` etc.).
    name: str
    #: Peak matrix throughput, FLOP/s per chip at bf16 (or the platform's
    #: closest low-precision matrix format).
    peak_flops_bf16: float
    #: Peak FLOP/s per chip at f32.
    peak_flops_f32: float
    #: Main-memory (HBM/DDR/LPDDR) bandwidth, bytes/s per chip.
    hbm_bw: float
    #: Interconnect bandwidth, bytes/s per link (ICI/NVLink/PCIe); only
    #: collectives are billed against it.
    link_bw: float
    #: Main-memory capacity per chip, bytes. Not used by the latency model;
    #: recorded so feasibility checks can reject configs that cannot fit.
    hbm_bytes: float
    #: On-chip scratchpad (TPU VMEM / GPU SMEM+L2 budget) per core, bytes.
    #: The fusion model (``analyze_partitioned``) keeps kernel-region
    #: intermediates resident when they fit in this budget.
    vmem_bytes: float = 128 * 2 ** 20
    #: Per-OpGroup efficiency overrides: ``(group, flops_eff, mem_eff)``
    #: entries (a tuple so the spec stays hashable). Effective peaks for a
    #: group are ``peak_flops * flops_eff`` and ``hbm_bw * mem_eff``. A
    #: ``"*"`` entry is the default for groups not named; groups absent
    #: entirely run at (1.0, 1.0), which keeps the classic single-roofline
    #: behaviour for the specs that don't set a table.
    group_efficiency: Tuple[Tuple[str, float, float], ...] = ()
    #: One-line source note for the constants (expanded in docs/hardware.md).
    provenance: str = ""

    def _efficiency(self, group: str) -> Tuple[float, float]:
        default = (1.0, 1.0)
        for g, fe, me in self.group_efficiency:
            if g == group:
                return (fe, me)
            if g == ANY_GROUP:
                default = (fe, me)
        return default

    def flops_time(self, flops: float, dtype: str = "bf16") -> float:
        peak = self.peak_flops_bf16 if dtype == "bf16" else self.peak_flops_f32
        return flops / peak

    def mem_time(self, nbytes: float) -> float:
        return nbytes / self.hbm_bw

    def roofline_time(self, flops: float, nbytes: float,
                      dtype: str = "bf16") -> float:
        return max(self.flops_time(flops, dtype), self.mem_time(nbytes))

    def group_time(self, group: str, flops: float, nbytes: float,
                   dtype: str = "bf16") -> float:
        """Roofline time with the group's efficiency factors applied.

        Identical to :meth:`roofline_time` for groups at (1.0, 1.0), which
        is every group on specs without an efficiency table.
        """
        fe, me = self._efficiency(group)
        return max(self.flops_time(flops, dtype) / fe,
                   self.mem_time(nbytes) / me)

    def group_mem_time(self, group: str, nbytes: float) -> float:
        """Bandwidth-only time at the group's effective bandwidth."""
        _, me = self._efficiency(group)
        return self.mem_time(nbytes) / me


TPU_V5E = HardwareSpec(
    name="tpu_v5e",
    peak_flops_bf16=197e12,
    peak_flops_f32=98.5e12,
    hbm_bw=819e9,
    link_bw=50e9,
    hbm_bytes=16 * 2 ** 30,
    provenance="assignment brief: 197 TFLOP/s bf16, 819 GB/s HBM, 50 GB/s ICI",
)

#: A100-80GB-like model, used to sanity-compare the reproduced shift against
#: the paper's GPU numbers (NOT a deployment target here).
GPU_A100 = HardwareSpec(
    name="a100",
    peak_flops_bf16=312e12,
    peak_flops_f32=19.5e12,
    hbm_bw=2039e9,
    link_bw=600e9 / 12,
    hbm_bytes=80 * 2 ** 30,
    vmem_bytes=40 * 2 ** 20,
    provenance="A100-80GB SXM datasheet",
)

#: Rough host-CPU model (per-socket) for the eager/unaccelerated view when an
#: analytic (rather than measured) CPU estimate is wanted.
CPU_HOST = HardwareSpec(
    name="cpu",
    peak_flops_bf16=2e12,
    peak_flops_f32=2e12,
    hbm_bw=100e9,
    link_bw=25e9,
    hbm_bytes=256 * 2 ** 30,
    vmem_bytes=64 * 2 ** 20,
    provenance="server-class socket: ~2 TFLOP/s AVX, ~100 GB/s DDR",
)

#: NPU-like operating point (PAPERS.md: "Striking the Balance: GEMM
#: Performance ... Ryzen AI NPUs"). The dedicated GEMM engine streams
#: weights through optimized DMA at full on-die bandwidth, so GEMM runs at
#: efficiency 1.0 against high nominal peaks; every NonGEMM group falls off
#: the array onto a scalar/vector path (the "*" entry: 5% of peak FLOPs, 2%
#: of the streaming bandwidth ~= an 80 GB/s LPDDR-class path). This is a
#: *stylized* point for compute/memory, not a datasheet model: it exists to
#: put a "GEMM-nearly-free" column in the platform sweep, where the paper's
#: NonGEMM share is highest.
#:
#: ``link_bw`` IS grounded in the platform: an XDNA NPU tile has no
#: dedicated interconnect — device-to-device collective traffic goes over
#: the SoC fabric through shared system DRAM. A Phoenix/Hawk-Point-class
#: socket runs dual-channel DDR5-5600: 2 ch x 8 B x 5.6 GT/s = 89.6 GB/s
#: peak. A collective payload crosses that DRAM twice (producer store +
#: consumer load), so the effective per-link bandwidth is half: 44.8 GB/s.
NPU_RYZEN = HardwareSpec(
    name="npu_ryzen",
    peak_flops_bf16=120e12,
    peak_flops_f32=60e12,
    hbm_bw=4e12,
    link_bw=44.8e9,
    hbm_bytes=32 * 2 ** 30,
    vmem_bytes=16 * 2 ** 20,
    group_efficiency=((ANY_GROUP, 0.05, 0.02),
                      ("gemm", 1.0, 1.0),
                      ("collective", 1.0, 1.0)),
    provenance="stylized NPU point grounded in the Ryzen AI NPU GEMM study; "
               "link = dual-channel DDR5-5600 (89.6 GB/s) / 2 store+load "
               "trips over the shared SoC fabric",
)

#: Bandwidth-bound near-memory accelerator (PAPERS.md: "Accelerating
#: Bandwidth-Bound Deep Learning Inference with Main-Memory Accelerators").
#: Aggregated across-DIMM internal bandwidth is decent (400 GB/s) but peak
#: compute is tiny (16/8 TFLOP/s), so even weight-streaming GEMMs sit on the
#: memory roof: the opposite extreme from npu_ryzen. Compute/memory are
#: stylized; ``link_bw`` is not: per-DIMM compute units have no sideband
#: network, so inter-DIMM collective traffic round-trips through the host
#: memory controller over the external DDR4-3200 interface — 8 B x 3.2 GT/s
#: = 25.6 GB/s per channel, halved to 12.8 GB/s for the store+load trip.
MEMBOUND_DIMM = HardwareSpec(
    name="membound_dimm",
    peak_flops_bf16=16e12,
    peak_flops_f32=8e12,
    hbm_bw=400e9,
    link_bw=12.8e9,
    hbm_bytes=512 * 2 ** 30,
    vmem_bytes=8 * 2 ** 20,
    provenance="stylized near-memory point from the main-memory-accelerator "
               "work; link = one DDR4-3200 channel (25.6 GB/s) / 2 "
               "store+load trips through the host memory controller",
)

#: The card the port runs on: NVIDIA H100 SXM5 80GB, dense rates (no
#: sparsity) at the 700 W power limit. ``link_bw`` is one NVLink 4 link
#: (900 GB/s over 18 links); ``vmem_bytes`` the 50 MB L2.
H100 = HardwareSpec(
    name="h100",
    peak_flops_bf16=989.4e12,
    peak_flops_f32=66.9e12,
    hbm_bw=3.35e12,
    link_bw=50e9,
    hbm_bytes=80e9,
    vmem_bytes=50 * 2 ** 20,
    provenance="NVIDIA H100 SXM5 80GB data sheet: 989.4 TFLOP/s bf16 dense, "
               "66.9 TFLOP/s f32, 3.35 TB/s HBM3, NVLink 4 900 GB/s over 18 "
               "links, 50 MB L2",
)

BY_NAME = {h.name: h for h in
           (TPU_V5E, GPU_A100, CPU_HOST, NPU_RYZEN, MEMBOUND_DIMM, H100)}


def list_hardware() -> list:
    """Sorted registry keys, mirroring ``workload.list_backends()``."""
    return sorted(BY_NAME)


def get_hardware(name: str) -> HardwareSpec:
    try:
        return BY_NAME[name]
    except KeyError:
        raise KeyError(f"unknown hardware spec {name!r}; "
                       f"known: {list_hardware()}") from None
