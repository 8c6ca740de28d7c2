"""Unified profiling surface: ``Workload`` x ``ProfilerBackend`` x transforms.

The port of ``repro.core.workload``. The paper's central finding is that
the NonGEMM share must be measured *per scenario* — eager on the card vs.
modeled, quantized vs. full-precision, fused vs. not. This module turns
"scenario" into data instead of parallel entry points:

* :class:`Workload` — a declarative spec (arch, phase ``prefill | decode |
  train``, batch, seq, dtype) plus a *builder* that materializes
  ``(fn, args, params)`` on a device from ``repro_torch.configs`` /
  ``repro_torch.models``. Every profile is ``workload.profile(backend)``
  and returns a :class:`~repro_torch.core.profiler.ModelProfile`.

* :class:`ProfilerBackend` — a string-keyed registry of profiling
  strategies:

      ``eager-cpu``           measured per-op wall time on the CPU
      ``eager-modeled:<hw>``  per-op roofline + launch overhead (capture)
      ``wallclock``           un-instrumented end-to-end time (median)
      ``measured``            per-op device time on the card (CUDA events)
      ``calibrated:<hw>``     eager-modeled with measured/modeled per-group
                              correction factors (``core/calibrate.py``)
      ``compiled``            the ``torch.compile``'d forward, measured: each
                              kernel's time, attributed to its group
                              (``core/compiled.py``)

  ``<hw>`` is a :mod:`repro_torch.core.hardware` spec name (``h100``,
  ``a100``, ``tpu_v5e``, ``cpu``, ``npu_ryzen``, ``membound_dimm``).
  JAX's ``compiled:<hw>`` prices XLA's fusions on a spec; the port's
  ``compiled`` measures Inductor's on the device, and takes no ``<hw>``.

* :class:`Transform` — composable workload rewrites applied by
  ``Workload.with_transform(...)`` at build time:
  :class:`QuantizeDequantTransform` (the paper's §4.4: simulated int8 QDQ
  around every tagged GEMM site raises the NonGEMM share) and
  :class:`~repro_torch.core.fusion.FusionTransform` (§6). Transforms may
  also implement :meth:`Transform.rewrite_records` to rewrite the captured
  op stream in capture-based backends. The two compose into the 2×2
  bf16 / fused / int8-qdq / int8-qdq+fused.

**Device.** ``Workload.build(device)`` passes the device to the builder
(``(workload, device) -> (fn, args, params)``). Every backend takes a
``device=`` option, ``"cuda"`` by default, except ``eager-cpu``, which
builds on the CPU. A backend asked for the card where CUDA is absent
raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from .hardware import BY_NAME as _HW_BY_NAME
from .hardware import GPU_A100, H100, HardwareSpec
from .profiler import (ModelProfile, _accelerated_eager_profile,
                       _eager_profile, _wallclock, profile_measured)

PHASES = ("prefill", "decode", "train")

#: dtype -> human variant label used in reports ("bf16" vs "int8-qdq" rows)
_DTYPE_LABEL = {"float32": "fp32", "bfloat16": "bf16", "float16": "fp16"}


def _check_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but CUDA is not "
                           f"available; pass device='cpu' to run on the CPU")
    return dev


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------

class Transform:
    """A composable workload rewrite: wraps the built callable.

    Subclasses set ``name`` (used in variant labels) and implement
    :meth:`wrap`.
    """

    name = "transform"

    def wrap(self, fn: Callable, workload: "Workload") -> Callable:
        raise NotImplementedError

    def rewrite_records(self, records, workload: "Workload"):
        """Optional post-capture rewrite of the OpRecord stream.

        Capture-based backends (``eager-modeled:<hw>``, ``calibrated``)
        run every transform's rewrite, in transform order, over the
        records they captured. The default is the identity.
        """
        return records

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"{type(self).__name__}({self.name!r})"


class QuantizeDequantTransform(Transform):
    """Simulated int8 quantize–dequantize around every tagged GEMM site.

    While the wrapped callable runs, ``repro_torch.nn.fake_quant`` is on:
    ``nn.linear`` / ``nn.einsum`` / ``nn.conv2d`` round-trip their operands
    through the int8 grid under ``ng:quantization:*`` tags, so the QDQ ops
    land in the NonGEMM ``quantization`` group — the paper's finding that
    quantization aggravates the NonGEMM bottleneck.
    """

    def __init__(self, mode: str = "int8"):
        self.mode = mode
        self.name = f"{mode}-qdq"

    def wrap(self, fn: Callable, workload: "Workload") -> Callable:
        mode = self.mode

        def quantized(*args, **kwargs):
            from repro_torch import nn
            with nn.fake_quant(mode):
                return fn(*args, **kwargs)

        return quantized


# ---------------------------------------------------------------------------
# Workload
# ---------------------------------------------------------------------------

def default_builder(w: "Workload", device="cuda"):
    """Materialize ``(fn, args, params)`` for a workload from the config zoo
    on ``device``.

    Uses the *reduced* config of ``w.arch`` (as JAX's builder does); params
    from a ``torch.Generator`` seeded 0, inputs from one seeded 1. Callers
    that want full width pass their own builder.
    """
    from repro_torch.configs import get_config, reduced

    cfg = reduced(get_config(w.arch)).replace(dtype=w.dtype,
                                              param_dtype=w.dtype)
    dev = torch.device(device)
    gen = torch.Generator(dev).manual_seed(1)

    if cfg.is_vision:
        from repro_torch.models.vision import init_vision, vision_forward

        if w.phase != "prefill":
            raise ValueError(f"vision workloads are encoder-only "
                             f"(phase='prefill'), got {w.phase!r}")
        params = init_vision(torch.Generator(dev).manual_seed(0), cfg)
        images = torch.randn((w.batch, cfg.n_channels, cfg.image_size,
                              cfg.image_size), generator=gen, device=dev)

        def vfn(params, images):
            return vision_forward(params, images, cfg)
        return vfn, (images,), params

    from repro_torch.models import (init_lm, init_lm_cache, lm_decode,
                                    lm_forward, lm_loss)

    params = init_lm(torch.Generator(dev).manual_seed(0), cfg)
    if cfg.input_mode == "tokens":
        inputs = torch.randint(0, cfg.vocab_size, (w.batch, w.seq),
                               generator=gen, device=dev)
    else:
        inputs = torch.randn((w.batch, w.seq, cfg.d_model), generator=gen,
                             device=dev)

    if w.phase == "prefill":
        def fn(params, inputs):
            return lm_forward(params, inputs, cfg)
        return fn, (inputs,), params

    if w.phase == "train":
        # forward and backward of the LM loss: its gradient with respect
        # to every param (JAX's jax.grad of lm_loss), labels the inputs
        from repro_torch.runtime import value_and_grad

        labels = inputs if cfg.input_mode == "tokens" else torch.randint(
            0, cfg.vocab_size, (w.batch, w.seq), generator=gen, device=dev)
        batch = {"inputs": inputs, "labels": labels}
        grad = value_and_grad(lambda p, b: lm_loss(p, b, cfg))

        def tfn(params, batch):
            return grad(params, batch)[1]
        return tfn, (batch,), params

    max_len = max(w.seq, 8)
    caches = init_lm_cache(cfg, w.batch, max_len, device=dev)
    token = torch.ones((w.batch,), dtype=torch.int32, device=dev)
    pos = torch.arange(w.batch, dtype=torch.int32, device=dev) \
        % max(w.seq - 1, 1)

    def fn(params, token, pos, caches):
        return lm_decode(params, token, pos, caches, cfg)[0]
    return fn, (token, pos, caches), params


@dataclasses.dataclass(frozen=True)
class Workload:
    """Declarative profiling spec; hashable, so memoization keys on it."""

    name: str
    arch: str
    phase: str = "prefill"
    batch: int = 1
    seq: int = 16
    dtype: str = "float32"
    #: (Workload, device) -> (fn, args, params); full call is fn(params, *args)
    builder: Optional[Callable] = None
    transforms: Tuple[Transform, ...] = ()

    def __post_init__(self):
        if self.phase not in PHASES:
            raise ValueError(f"unknown workload phase {self.phase!r}; "
                             f"known: {PHASES}")

    def replace(self, **kw) -> "Workload":
        return dataclasses.replace(self, **kw)

    def with_transform(self, *transforms: Transform) -> "Workload":
        """A new Workload with ``transforms`` appended (composable)."""
        for t in transforms:
            if not isinstance(t, Transform):
                raise TypeError(f"expected a Transform, got {t!r}")
        return self.replace(transforms=self.transforms + tuple(transforms))

    @property
    def variant(self) -> str:
        """Report label: transform chain, or the plain dtype (e.g. bf16)."""
        chain = "+".join(t.name for t in self.transforms)
        return chain or _DTYPE_LABEL.get(self.dtype, self.dtype)

    def build(self, device="cuda"):
        """Resolve the builder on ``device`` and apply transforms; returns
        ``(fn, args)`` where ``args`` already includes params (``fn(*args)``
        runs it). Raises where ``device`` is the card and CUDA is absent."""
        device = _check_device(device)
        builder = self.builder or default_builder
        fn, args, params = builder(self, device)
        for t in self.transforms:
            fn = t.wrap(fn, self)
        return fn, (params,) + tuple(args)

    def profile(self, backend="eager-cpu", **opts) -> ModelProfile:
        """Profile this workload on ``backend`` (name or instance)."""
        b = get_backend(backend) if isinstance(backend, str) else backend
        return b.profile(self, **opts)

    def describe(self) -> dict:
        """Serializable spec."""
        builder = self.builder
        return {
            "name": self.name, "arch": self.arch, "phase": self.phase,
            "batch": self.batch, "seq": self.seq, "dtype": self.dtype,
            "variant": self.variant,
            "builder": ("default" if builder is None else
                        getattr(builder, "__qualname__",
                                getattr(builder, "__name__", "custom"))),
            "transforms": [t.name for t in self.transforms],
        }


def _compose_record_rewrites(workload: Workload):
    """Chain the workload transforms' record rewrites (None when trivial)."""
    if not any(type(t).rewrite_records is not Transform.rewrite_records
               for t in workload.transforms):
        return None

    def rewrite(records):
        for t in workload.transforms:
            records = t.rewrite_records(records, workload)
        return records

    return rewrite


# ---------------------------------------------------------------------------
# Profiler backends + registry
# ---------------------------------------------------------------------------

class ProfilerBackend:
    """One profiling strategy: ``profile(workload, **opts) -> ModelProfile``.

    Anything with this shape can be registered; subclassing is convention,
    not a requirement.
    """

    name = "backend"

    def profile(self, workload: Workload, **opts) -> ModelProfile:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"{type(self).__name__}({self.name!r})"


class EagerCpuBackend(ProfilerBackend):
    """Measured eager CPU: each op dispatched and wall-timed alone, built
    on the CPU."""

    name = "eager-cpu"

    def profile(self, workload: Workload, repeats: int = 3,
                **opts) -> ModelProfile:
        fn, args = workload.build("cpu")
        return _eager_profile(fn, *args, name=workload.name,
                              repeats=repeats, **opts)


class EagerModeledBackend(ProfilerBackend):
    """Modeled eager accelerator: per-op roofline + kernel-launch overhead
    over the capture of one call on ``device``."""

    def __init__(self, hw: HardwareSpec = None):
        self.hw = hw or GPU_A100
        self.name = f"eager-modeled:{self.hw.name}"

    def profile(self, workload: Workload, launch_overhead_s: float = 5e-6,
                device="cuda", **opts) -> ModelProfile:
        fn, args = workload.build(device)
        return _accelerated_eager_profile(
            fn, *args, name=workload.name, hw=self.hw,
            launch_overhead_s=launch_overhead_s,
            record_rewrite=_compose_record_rewrites(workload), **opts)


class WallclockBackend(ProfilerBackend):
    """Un-instrumented end-to-end time (median of ``repeats`` calls after a
    warm-up, synchronised on the card), reported as an unattributed profile
    (``group_seconds`` empty; ``total_seconds`` is the median)."""

    name = "wallclock"

    def profile(self, workload: Workload, repeats: int = 5, device="cuda",
                **opts) -> ModelProfile:
        fn, args = workload.build(device)
        t = _wallclock(fn, *args, repeats=repeats, **opts)
        return ModelProfile(name=workload.name, mode="wallclock",
                            group_seconds={}, total_seconds=t,
                            op_seconds={}, n_ops=0)


class MeasuredBackend(ProfilerBackend):
    """Measured per-op profile: every op of one call dispatched and timed
    alone (``core/profiler.profile_measured``), mode ``measured_cuda`` on
    the card.

    Unlike JAX's host path, the profile is not rescaled to a measured wall
    total: the per-op CUDA-event times are the card's own device times,
    with the host's launch gaps padded away (``core/graph.py``); the
    ``wallclock`` backend gives the eager total beside them. JAX's
    ``hlo_profile=`` ingests an XLA dump and has no twin here.
    """

    name = "measured"

    def profile(self, workload: Workload,
                hlo_profile: Optional[str] = None,
                repeats: int = 3, device="cuda", **opts) -> ModelProfile:
        if hlo_profile is not None:
            raise NotImplementedError(
                "hlo_profile= ingests an XLA --xla_hlo_profile dump; the "
                "port measures per-op device time on the card instead")
        fn, args = workload.build(device)
        return profile_measured(fn, *args, name=workload.name,
                                repeats=repeats, **opts)


class CalibratedBackend(ProfilerBackend):
    """Eager-modeled view through a measured-correction lens.

    Identical to :class:`EagerModeledBackend` except per-group times are
    multiplied by the :class:`~repro_torch.core.calibrate.CalibratedHardwareSpec`
    factors (fitted measured/modeled ratios — by default from the Table-2
    micro suite on the card, memoized per process).
    """

    def __init__(self, cal):
        self.cal = cal
        self.name = f"calibrated:{cal.base.name}"

    def profile(self, workload: Workload, launch_overhead_s: float = 5e-6,
                device="cuda", **opts) -> ModelProfile:
        fn, args = workload.build(device)
        return _accelerated_eager_profile(
            fn, *args, name=workload.name, hw=self.cal,
            mode=f"calibrated_{self.cal.base.name}",
            launch_overhead_s=launch_overhead_s,
            record_rewrite=_compose_record_rewrites(workload), **opts)


class CompiledBackend(ProfilerBackend):
    """The compiled view, measured: the workload's callable through
    ``torch.compile`` (Inductor, ``fullgraph=True``, ``dynamic=False``),
    held to its eager output, then each kernel of one profiled call timed
    and given its group (``core/compiled.profile_compiled``); mode
    ``compiled_cuda`` on the card, ``compiled_cpu`` on the CPU. A
    transform changes the function that is compiled (the QDQ wrapper's
    ``nn.fake_quant`` is traced into the graph), as JAX's jit traces it.
    """

    name = "compiled"

    def profile(self, workload: Workload, repeats: int = 5, device="cuda",
                **opts) -> ModelProfile:
        from .compiled import profile_compiled

        fn, args = workload.build(device)
        return profile_compiled(fn, *args, name=workload.name, device=device,
                                repeats=repeats, **opts)


#: base key -> factory(param_or_None) -> ProfilerBackend
_BACKENDS: Dict[str, Callable[[Optional[str]], ProfilerBackend]] = {}


def register_backend(key: str,
                     factory: Callable[[Optional[str]], ProfilerBackend]
                     ) -> None:
    """Register a backend factory under ``key``.

    ``factory(param)`` receives the text after the first ``:`` of the
    requested spec (``None`` when absent), e.g. ``get_backend("eager-modeled:
    h100")`` calls the ``eager-modeled`` factory with ``"h100"``.
    """
    if not key or ":" in key:
        raise ValueError(f"backend key must be non-empty and ':'-free, "
                         f"got {key!r}")
    if key in _BACKENDS:
        raise ValueError(f"profiler backend {key!r} already registered")
    _BACKENDS[key] = factory


def list_backends() -> list:
    return sorted(_BACKENDS)


def get_backend(spec: str) -> ProfilerBackend:
    """Resolve ``"key"`` or ``"key:param"`` to a backend instance."""
    base, sep, param = spec.partition(":")
    factory = _BACKENDS.get(base)
    if factory is None:
        raise KeyError(f"unknown profiler backend {spec!r}; "
                       f"known: {', '.join(list_backends())}")
    return factory(param if sep else None)


def _hw(param: Optional[str], default: HardwareSpec) -> HardwareSpec:
    if param is None:
        return default
    hw = _HW_BY_NAME.get(param)
    if hw is None:
        raise KeyError(f"unknown hardware spec {param!r}; "
                       f"known: {sorted(_HW_BY_NAME)}")
    return hw


def _no_param(key: str, param: Optional[str]) -> None:
    if param is not None:
        raise ValueError(f"backend {key!r} takes no ':<param>' suffix")


def _register_builtins() -> None:
    register_backend(
        "eager-cpu",
        lambda p: (_no_param("eager-cpu", p), EagerCpuBackend())[1])
    register_backend(
        "eager-modeled", lambda p: EagerModeledBackend(_hw(p, GPU_A100)))
    register_backend(
        "wallclock",
        lambda p: (_no_param("wallclock", p), WallclockBackend())[1])
    register_backend(
        "measured",
        lambda p: (_no_param("measured", p), MeasuredBackend())[1])
    register_backend(
        "compiled",
        lambda p: (_no_param("compiled", p), CompiledBackend())[1])

    def _calibrated(p):
        # the default fit runs the micro suite on the card once per spec
        # per process: the port's samples come from the card
        from .calibrate import default_calibration
        return CalibratedBackend(default_calibration(_hw(p, H100).name))

    register_backend("calibrated", _calibrated)


_register_builtins()
