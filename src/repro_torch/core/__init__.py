"""repro_torch.core — the paper's contribution (NonGEMM Bench) in PyTorch.

Pipeline (paper Fig. 4): capture -> classify -> profile -> post-process:
the dispatch-mode capture and per-op timing (``graph``), the OpGroup
taxonomy, the measured and modeled profiles (``profiler``) over the
hardware specs (``hardware``, ``calibrate``), the fusion pass, the
``Workload`` x backend x transform API (``workload``), the compiled view
(``compiled``: a ``torch.compile``'d forward measured kernel by kernel,
each fused kernel given its group by JAX's vote) and the report renderers
(``report``). The port of ``repro.core`` less what reads XLA's HLO
(``hlo``, ``interpreter``, ``roofline_from_hlo``,
``group_latency_model``) and the deprecated ``profile_*`` shims.
"""

from .taxonomy import (OpGroup, NONGEMM_GROUPS, scope_tag, parse_scope,
                       classify, is_gemm, is_nongemm)
from .graph import OpRecord, TimedOp, capture, harvest_shapes, timed_run
from .hardware import (HardwareSpec, TPU_V5E, GPU_A100, CPU_HOST, NPU_RYZEN,
                       MEMBOUND_DIMM, H100, get_hardware, list_hardware)
from .roofline import (RooflineTerms, gemm_nongemm_split, train_model_flops,
                       decode_model_flops, attention_flops)
from .profiler import ModelProfile, model_records, profile_measured
from .calibrate import (CalibratedHardwareSpec, CalibrationError,
                        calibrate, calibrate_from_microbench, drift_by_group,
                        fit_factors, load_calibration, max_abs_log2_drift,
                        save_calibration)
from .workload import (Workload, ProfilerBackend, Transform,
                       QuantizeDequantTransform, CompiledBackend,
                       register_backend, get_backend, list_backends)
from .compiled import (CompiledForward, compile_forward, fusion_group,
                       profile_compiled)
from .fusion import (FusionPattern, FusionReport, FusionTransform,
                     FUSION_PATTERNS, find_fusable_chains, fuse_records,
                     fusion_report)
from . import microbench, report

__all__ = [
    "OpGroup", "NONGEMM_GROUPS", "scope_tag", "parse_scope", "classify",
    "is_gemm", "is_nongemm", "OpRecord", "TimedOp", "capture",
    "harvest_shapes", "timed_run", "HardwareSpec", "TPU_V5E", "GPU_A100",
    "CPU_HOST", "NPU_RYZEN", "MEMBOUND_DIMM", "H100", "get_hardware",
    "list_hardware", "RooflineTerms", "gemm_nongemm_split",
    "train_model_flops", "decode_model_flops", "attention_flops",
    "ModelProfile", "model_records", "profile_measured",
    "CalibratedHardwareSpec", "CalibrationError", "calibrate",
    "calibrate_from_microbench", "drift_by_group", "fit_factors",
    "load_calibration", "max_abs_log2_drift", "save_calibration",
    "Workload", "ProfilerBackend", "Transform", "QuantizeDequantTransform",
    "CompiledBackend", "CompiledForward", "compile_forward", "fusion_group",
    "profile_compiled",
    "FusionPattern", "FusionReport", "FusionTransform", "FUSION_PATTERNS",
    "find_fusable_chains", "fuse_records", "fusion_report",
    "register_backend", "get_backend", "list_backends",
    "microbench", "report",
]
