"""The benchmark zoo of the port: profile each case in the paper's setting.

The port of ``repro.bench.cases``. The case tables, the tiers and the
parameter budget are a copy of the original's (a test pins them field
for field), and :func:`bench_config` / :func:`vision_bench_config` are the
same arithmetic over the port's configs: every architecture at its TRUE
width and vocabulary (halved only past the f32 budget), depth cut to one
block-pattern repeat, since latency *shares* are depth-invariant for
homogeneous stacks. The quick LM cases stay at full width.

Three views per case, as JAX's:

    measured         per-op device time on the card (``measured``), or
                     per-op wall time on the CPU (``eager-cpu``)
    eager A100 model per-op roofline + 5us launch (the paper's GPU columns)
    compiled         the ``torch.compile``'d forward, measured: each kernel
                     Inductor emits or calls, its time on the card (host
                     time on the CPU) and its group (beyond-paper: the gap
                     fusion closes, §4.5; JAX's is an XLA-fused TPU
                     roofline)

Everything builds on ``device``: the card unless the caller asks for the
CPU. Params come from a ``torch.Generator(device)`` seeded 0, inputs from
one seeded 1. The builders and profiles are memoized per device, like
JAX's; :func:`clear_caches` drops them and the card's cached blocks.

The serving and traffic sections serve the case's model at its published
size on the card (:func:`build_serving`): the reduced model's widths
measure nothing on an H100. On the CPU they take JAX's reduced
:func:`serving_config`, so the rows can be held against JAX's. Both run
in f32, as JAX's do (its reduced configs are f32).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.core import (FusionTransform, ModelProfile,
                              QuantizeDequantTransform, Workload)
from repro_torch.models import init_lm, lm_forward

from .schema import BenchCase

_Q = ("quick", "full")
_F = ("full",)

#: serving-engine cases: (alias, arch, max_batch, max_len) — the batch is
#: the engine slot-table size, the seq is the shared KV-cache depth
SERVING_CASES: List[BenchCase] = [
    BenchCase("serve stablelm b-4", "stablelm-3b", 4, 64, _Q),
]

#: traffic cases: (alias, arch, max_batch, max_len) for the paged-KV
#: engine under trace-driven load (attention-only archs: the paged pools
#: page the per-layer KV leaves, so recurrent/local mixers are out)
TRAFFIC_CASES: List[BenchCase] = [
    BenchCase("traffic stablelm b-3", "stablelm-3b", 3, 64, _Q),
]

#: sharded-serving case: the paged engine's manual-TP sweep (the section
#: skips: tensor-parallel serving is not ported yet)
SHARDED_CASES: List[BenchCase] = [
    BenchCase("sharded stablelm b-4", "stablelm-3b", 4, 64, _Q),
]

#: vision cases (paper's Torchvision half): seq is the encoder token
#: count, derived from the config's patch grid so the case can never
#: drift from what vision_case_workload actually builds (the detector's
#: neck upsamples to det_upsample^2 x that many candidates)
VISION_CASES: List[BenchCase] = [
    BenchCase("vit-b16 cls b-1", "vit-b16-cls", 1,
              get_config("vit-b16-cls").patch_grid ** 2, _Q),
    BenchCase("detector-vit-s b-1", "detector-vit-s", 1,
              get_config("detector-vit-s").patch_grid ** 2, _Q),
]

#: the zoo — quick tier is the CI subset, full is the paper zoo
CASES: List[BenchCase] = [
    BenchCase("gpt2-xl b-1", "gpt2-xl", 1, 16, _Q),
    BenchCase("gpt2-xl b-8", "gpt2-xl", 8, 16, _Q),
    BenchCase("llama2-7b b-1", "llama2-7b", 1, 16, _Q),
    BenchCase("bert b-1", "bert-base", 1, 128, _Q),
    BenchCase("bert b-8", "bert-base", 8, 128, _F),
    BenchCase("vit-b16 b-1", "vit-b16", 1, 197, _F),
    BenchCase("granite-3-8b b-1", "granite-3-8b", 1, 16, _F),
    BenchCase("gemma3-27b b-1", "gemma3-27b", 1, 16, _F),
    BenchCase("qwen2-moe b-1", "qwen2-moe-a2.7b", 1, 16, _F),
    BenchCase("recurrentgemma b-1", "recurrentgemma-2b", 1, 16, _F),
    BenchCase("xlstm b-1", "xlstm-350m", 1, 16, _F),
    BenchCase("deepseek-v2 b-1", "deepseek-v2-lite-16b", 1, 16, _F),
]


def tier_cases(tier: str,
               cases: Optional[Sequence[BenchCase]] = None
               ) -> List[BenchCase]:
    return [c for c in (cases or CASES) if tier in c.tiers]


def quick_cases() -> List[BenchCase]:
    return tier_cases("quick")


def is_ported(arch: str) -> bool:
    """Whether the port has ``arch``'s config. Every arch of both tiers
    has one; the runner and ``list`` still name any case whose arch has
    none, as not ported."""
    try:
        get_config(arch)
    except KeyError:
        return False
    return True


#: f32 eager working set budget: params <= 1.2B (~5 GB)
_PARAM_BUDGET = 1.2e9


def bench_config(arch: str):
    cfg = get_config(arch)
    # one pattern repeat of depth (shares are depth-invariant)
    cfg = cfg.replace(n_layers=max(len(cfg.block_pattern), 2),
                      first_dense_layers=min(cfg.first_dense_layers, 1),
                      scan_layers=False, remat=False, loss_chunk=0,
                      dtype="float32", param_dtype="float32",
                      attn_chunk_q=512, attn_chunk_kv=512)
    while cfg.n_params() > _PARAM_BUDGET:
        cfg = cfg.replace(
            d_model=cfg.d_model // 2,
            d_ff=max(cfg.d_ff // 2, 0),
            moe_d_ff=max(cfg.moe_d_ff // 2, 0),
            n_heads=max(cfg.n_heads // 2, 1),
            n_kv_heads=max(cfg.n_kv_heads // 2, 1),
            vocab_size=max(cfg.vocab_size // 2, 1024),
            lru_width=(cfg.lru_width // 2 if cfg.lru_width else None),
        )
    return cfg


def _generators(device: str) -> Tuple[torch.Generator, torch.Generator]:
    """(params generator seeded 0, inputs generator seeded 1) on ``device``."""
    dev = torch.device(device)
    return (torch.Generator(dev).manual_seed(0),
            torch.Generator(dev).manual_seed(1))


@functools.lru_cache(maxsize=None)
def build(arch: str, batch: int, seq: int, device: str = "cuda"):
    """Returns (fwd(params, inputs), params, inputs) on ``device``."""
    cfg = bench_config(arch)
    gp, gi = _generators(device)
    params = init_lm(gp, cfg)
    if cfg.input_mode == "tokens":
        inputs = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gi,
                               device=device)
    else:
        inputs = torch.randn((batch, seq, cfg.d_model), generator=gi,
                             device=device)

    def fwd(params, inputs):
        return lm_forward(params, inputs, cfg)

    return fwd, params, inputs


def serving_config(arch: str):
    """Tiny same-family config the serving section can execute on CPU."""
    from repro_torch.configs import get_config as _get, reduced
    cfg = reduced(_get(arch))
    return cfg.replace(n_layers=min(cfg.n_layers, 2), loss_chunk=0)


@functools.lru_cache(maxsize=None)
def build_serving(arch: str, device: str = "cuda",
                  dtype: Optional[str] = None):
    """(cfg, params) for a serving bench case (memoized: a section runs
    its engines and profiles prefill/decode on one model).

    On the card: the published config at full size, in ``dtype`` (None:
    the config's own, bf16 for stablelm-3b); the reduced model's widths
    would measure nothing on an H100. On the CPU: JAX's
    :func:`serving_config`, so the rows hold against JAX's (``dtype`` is
    not read)."""
    if torch.device(device).type == "cuda":
        cfg = get_config(arch)
        if dtype is not None:
            cfg = cfg.replace(dtype=dtype, param_dtype=dtype)
    else:
        cfg = serving_config(arch)
    params = init_lm(_generators(device)[0], cfg)
    return cfg, params


def vision_bench_config(arch: str):
    """Full-width vision config at one block-pattern depth repeat (shares
    are depth-invariant for the homogeneous encoder stack, like
    :func:`bench_config`) — full image resolution, real head widths."""
    cfg = get_config(arch)
    return cfg.replace(n_layers=max(len(cfg.block_pattern), 2),
                       scan_layers=False, remat=False,
                       dtype="float32", param_dtype="float32",
                       attn_chunk_q=512, attn_chunk_kv=512)


@functools.lru_cache(maxsize=None)
def build_vision(arch: str, batch: int, device: str = "cuda"):
    """Returns (fwd(params, images), params, images) for a vision case."""
    from repro_torch.models.vision import init_vision, vision_forward

    cfg = vision_bench_config(arch)
    gp, gi = _generators(device)
    params = init_vision(gp, cfg)
    images = torch.randn(
        (batch, cfg.n_channels, cfg.image_size, cfg.image_size), generator=gi,
        device=device)

    def fwd(params, images):
        return vision_forward(params, images, cfg)

    return fwd, params, images


def _bench_builder(w: Workload, device):
    """Workload builder over the memoized full-width bench :func:`build`."""
    fwd, params, inputs = build(w.arch, w.batch, w.seq, str(device))
    return fwd, (inputs,), params


def _vision_bench_builder(w: Workload, device):
    """Workload builder over the memoized :func:`build_vision`."""
    fwd, params, images = build_vision(w.arch, w.batch, str(device))
    return fwd, (images,), params


def vision_case_workload(arch: str, batch: int,
                         alias: Optional[str] = None) -> Workload:
    """The vision bench regime as a :class:`Workload` (full-width encoder,
    one depth repeat, f32, full-resolution images)."""
    cfg = get_config(arch)
    return Workload(name=alias or f"{arch} b-{batch}", arch=arch,
                    phase="prefill", batch=batch, seq=cfg.patch_grid ** 2,
                    dtype="float32", builder=_vision_bench_builder)


def case_workload(arch: str, batch: int, seq: int,
                  alias: Optional[str] = None) -> Workload:
    """The bench regime as a :class:`Workload`: full-width arch, one
    block-pattern depth repeat, f32, generation-style (batch, seq) inputs."""
    return Workload(name=alias or f"{arch} b-{batch}", arch=arch,
                    phase="prefill", batch=batch, seq=seq, dtype="float32",
                    builder=_bench_builder)


def workload_for_case(case: BenchCase) -> Workload:
    return case_workload(case.arch, case.batch, case.seq, alias=case.alias)


def _on_card(device: str) -> bool:
    return torch.device(device).type == "cuda"


@functools.lru_cache(maxsize=None)
def _profile_case_modeled(alias: str, arch: str, batch: int, seq: int,
                          device: str = "cuda") -> ModelProfile:
    """Deterministic modeled eager-A100 profile, shared by profile_case and
    profile_case_quantized so the fp32 capture+model pass runs once."""
    return case_workload(arch, batch, seq, alias=alias).profile(
        "eager-modeled:a100", device=device)


@functools.lru_cache(maxsize=None)
def profile_case(alias: str, arch: str, batch: int, seq: int,
                 device: str = "cuda", eager_repeats: int = 3
                 ) -> Tuple[ModelProfile, ModelProfile]:
    """(measured, modeled eager-A100) — the paper's two columns.

    Measured is the card's per-op device time (``measured``, mode
    ``measured_cuda``): the paper's eager-GPU column, measured on a real
    GPU. On the CPU it is ``eager-cpu``, as in JAX. Cached: several
    sections read the same profiles, and re-measuring would let them
    disagree about the shares they serialize.
    """
    w = case_workload(arch, batch, seq, alias=alias)
    if _on_card(device):
        measured = w.profile("measured", repeats=eager_repeats, device=device)
    else:
        measured = w.profile("eager-cpu", repeats=eager_repeats)
    return measured, _profile_case_modeled(alias, arch, batch, seq, device)


@functools.lru_cache(maxsize=None)
def profile_case_compiled(alias: str, arch: str, batch: int, seq: int,
                          device: str = "cuda") -> ModelProfile:
    """Beyond-paper column: the case's forward compiled by Inductor and
    measured kernel by kernel (``compiled``, mode ``compiled_cuda`` on the
    card, ``compiled_cpu`` on the CPU), the hand-written kernels inside it
    as opaque calls."""
    return case_workload(arch, batch, seq, alias=alias).profile(
        "compiled", device=device)


@functools.lru_cache(maxsize=None)
def profile_case_quantized(alias: str, arch: str, batch: int, seq: int,
                           device: str = "cuda"
                           ) -> Tuple[ModelProfile, ModelProfile]:
    """(fp32, int8-QDQ) modeled eager-A100 pair — the paper's §4.4 setting.

    Both sides use the deterministic modeled backend so the comparison (and
    the CI gate over it) is noise-free; the int8 side wraps every tagged
    GEMM with simulated quantize/dequantize via the workload transform.
    """
    fp32 = _profile_case_modeled(alias, arch, batch, seq, device)
    int8 = case_workload(arch, batch, seq, alias=alias).with_transform(
        QuantizeDequantTransform("int8")).profile("eager-modeled:a100",
                                                  device=device)
    return fp32, int8


@functools.lru_cache(maxsize=None)
def profile_case_fused(alias: str, arch: str, batch: int, seq: int,
                       device: str = "cuda"
                       ) -> Tuple[ModelProfile, ModelProfile,
                                  ModelProfile, ModelProfile]:
    """The fusion 2×2: (fp32, fused, int8-qdq, int8-qdq+fused).

    All four are the deterministic modeled eager-A100 view (the paper's
    accelerated setting). The fused variants route through
    :class:`~repro_torch.core.fusion.FusionTransform`: the callable runs
    under ``nn.fuse()`` (on the card, through the fused kernels) and the
    captured stream goes through the graph-level rewriter (paper §6).
    """
    fp32, int8 = profile_case_quantized(alias, arch, batch, seq, device)
    base = case_workload(arch, batch, seq, alias=alias)
    fused = base.with_transform(FusionTransform()) \
        .profile("eager-modeled:a100", device=device)
    int8_fused = base.with_transform(QuantizeDequantTransform("int8"),
                                     FusionTransform()) \
        .profile("eager-modeled:a100", device=device)
    return fp32, fused, int8, int8_fused


@functools.lru_cache(maxsize=None)
def _case_records(alias: str, arch: str, batch: int, seq: int,
                  device: str = "cuda") -> tuple:
    """One capture of a case; the op stream is hardware-independent."""
    from repro_torch.core.graph import capture

    fn, args = case_workload(arch, batch, seq, alias=alias).build(device)
    return tuple(capture(fn, *args))


@functools.lru_cache(maxsize=None)
def profile_case_modeled_on(alias: str, arch: str, batch: int, seq: int,
                            hw: str, device: str = "cuda") -> ModelProfile:
    """The case's one capture modeled on spec ``hw`` (mode
    ``modeled_<hw>``)."""
    from repro_torch.core import get_hardware, model_records

    return model_records(_case_records(alias, arch, batch, seq, device),
                         name=alias, hw=get_hardware(hw),
                         mode=f"modeled_{hw}")


def profile_case_platforms(alias: str, arch: str, batch: int, seq: int,
                           device: str = "cuda"
                           ) -> Tuple[Tuple[str, ModelProfile], ...]:
    """One capture, modeled across the whole platform sweep.

    The case is captured once and re-modeled per
    :data:`~repro_torch.bench.schema.PLATFORM_SWEEP` spec via
    :func:`repro_torch.core.model_records` — five platforms for the price
    of one capture. Mode is ``modeled_<hw>`` (the ``cpu`` point here is
    the *analytic* CPU spec, not the measured eager view)."""
    from .schema import PLATFORM_SWEEP

    return tuple((hw, profile_case_modeled_on(alias, arch, batch, seq, hw,
                                              device))
                 for hw in PLATFORM_SWEEP)


def profile_case_measured(alias: str, arch: str, batch: int, seq: int,
                          device: str = "cuda") -> ModelProfile:
    """Measured profile of a case: :func:`profile_case`'s first column
    (``measured`` on the card, ``eager-cpu`` on the CPU), measured once."""
    return profile_case(alias, arch, batch, seq, device)[0]


@functools.lru_cache(maxsize=None)
def cpu_calibration():
    """``cpu`` fitted from the Table-2 rows run on the CPU (the card's
    calibration is ``core/calibrate.default_calibration``, which measures
    on the card)."""
    from repro_torch.core import calibrate_from_microbench, get_hardware
    from repro_torch.core.calibrate import DEFAULT_CALIBRATION_OPS
    from repro_torch.core.microbench import run_micro

    rows = [run_micro(n, repeats=3, device="cpu", measure_eager=False)
            for n in DEFAULT_CALIBRATION_OPS]
    return calibrate_from_microbench(get_hardware("cpu"), rows=rows)


@functools.lru_cache(maxsize=None)
def profile_case_calibrated(alias: str, arch: str, batch: int, seq: int,
                            device: str = "cuda") -> ModelProfile:
    """Calibrated modeled profile: ``calibrated:h100`` on the card (fitted
    from the Table-2 rows measured there, once a process), ``calibrated``
    ``cpu`` from :func:`cpu_calibration` on the CPU."""
    w = case_workload(arch, batch, seq, alias=alias)
    if _on_card(device):
        return w.profile("calibrated:h100", device=device)
    from repro_torch.core.workload import CalibratedBackend

    return w.profile(CalibratedBackend(cpu_calibration()), device=device)


@functools.lru_cache(maxsize=None)
def profile_case_vision(alias: str, arch: str, batch: int,
                        device: str = "cuda"
                        ) -> Tuple[ModelProfile, ModelProfile]:
    """(fp32, fused) modeled eager-A100 pair for a vision case.

    Deterministic like the quantized/fusion sections: the fp32 side is the
    paper's accelerated-eager Torchvision setting (RoI / Interpolation /
    pooling each their own launch train); the fused side routes the same
    capture through :class:`~repro_torch.core.fusion.FusionTransform`.
    """
    w = vision_case_workload(arch, batch, alias=alias)
    fp32 = w.profile("eager-modeled:a100", device=device)
    fused = w.with_transform(FusionTransform()).profile(
        "eager-modeled:a100", device=device)
    return fp32, fused


def clear_caches() -> None:
    """Drop memoized params/profiles (can hold GBs) and the card's cached
    blocks; the runner calls this after each bench run, and tests/REPLs
    may call it directly."""
    profile_case.cache_clear()
    profile_case_compiled.cache_clear()
    profile_case_quantized.cache_clear()
    profile_case_fused.cache_clear()
    profile_case_vision.cache_clear()
    profile_case_modeled_on.cache_clear()
    profile_case_calibrated.cache_clear()
    cpu_calibration.cache_clear()
    _case_records.cache_clear()
    _profile_case_modeled.cache_clear()
    build.cache_clear()
    build_serving.cache_clear()
    build_vision.cache_clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
