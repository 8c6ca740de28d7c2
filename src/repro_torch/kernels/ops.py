"""One wrapper per hand-written kernel: validation, dispatch, launch count.

Every wrapper

* checks device, dtype (float32 / bfloat16), shapes and contiguity, and
  raises on what its kernel does not take;
* takes the plain PyTorch version (``kernels/ref.py``) for CPU tensors —
  only because the tensor lies on the CPU — and for CUDA tensors launches
  its kernel on ``torch.cuda.current_stream()`` or raises: there is no
  fallback; either way its outputs are contiguous, as its fake says
  (Inductor plans a compiled program's buffers from the fakes);
* adds one to :data:`launches` ``[name]`` where it launches, and nowhere
  else; under CUDA graph capture, where nothing launches, to the graph's
  record instead (:func:`recording`), which every replay adds
  (:func:`add_launches`);
* is, or calls, a ``torch.library.custom_op`` (``repro_torch::<name>``)
  with a fake implementation, so a ``TorchDispatchMode`` (the capture and
  the timed profile of ``core/graph.py``) sees the kernel as one op, and
  ``torch.compile`` keeps it as one opaque call whose body, and count,
  run when the compiled program runs. A ctypes launch is invisible to
  dispatch modes; without the op its time would be lost;
* has a gradient (``register_autograd``) where a training forward reaches
  it: a prefill attention wrapper asked for a gradient runs
  :func:`attention_with_lse`, whose op returns the rows' log-sum-exp
  beside the output and differentiates through the flash backward,
  :func:`attention_bwd` (a kernel of its own, the counterpart of JAX's
  flash VJP backward); the row norms, rope and the gated
  activations through the gradient of their plain version, as JAX
  differentiates their ``jnp`` twins (its Pallas kernels never train);
  ``decode_core``, ``nms_sorted``, ``softmax_xent`` and
  ``dequant_add_rms_norm`` raise if a gradient is asked: no training path
  needs one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

from . import attn_template as _attn
from . import nms as _nms
from . import norms as _norms
from . import ref
from . import rope as _rope
from . import softmax_xent as _xent
from . import swiglu as _glu

KERNELS = ("rms_norm", "fused_add_rms_norm", "layer_norm",
           "fused_add_layer_norm", "rope", "swiglu", "geglu", "attention_core",
           "attention_window", "decode_core", "attention_full", "nms",
           "dequant_add_rms_norm", "softmax_xent", "attention_lse",
           "attention_bwd")

#: launches of each kernel since the last :func:`reset_launches`
launches = dict.fromkeys(KERNELS, 0)

_DTYPES = (torch.float32, torch.bfloat16)


#: the launches of the CUDA graph now being captured, or None
_recording: Optional[Dict[str, int]] = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@contextlib.contextmanager
def recording() -> Iterator[Dict[str, int]]:
    """Count the wrappers' launches into a fresh record instead of
    :data:`launches`: around a CUDA graph's capture, which launches
    nothing. Each replay then adds the record (:func:`add_launches`)."""
    global _recording
    prev, _recording = _recording, dict.fromkeys(KERNELS, 0)
    try:
        yield _recording
    finally:
        _recording = prev


def add_launches(counts: Dict[str, int]) -> None:
    """Add a captured graph's record to :data:`launches` (one replay)."""
    for name, n in counts.items():
        launches[name] += n


def _count(name: str) -> None:
    """One launch of ``name``'s kernel: into :data:`launches`, or into the
    record while a graph is captured under :func:`recording`. A capture
    outside it raises, since its replays would go uncounted."""
    if _recording is not None:
        _recording[name] += 1
    elif torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{name}: launched under CUDA graph capture outside "
                           "ops.recording(); its replays would go uncounted")
    else:
        launches[name] += 1


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """Validate the shared properties; True for CUDA, False for CPU."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.numel() == 0:
            raise ValueError(f"{name}: empty operand of shape {tuple(t.shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev.type == "cuda"


def _check_dtype(name: str, *tensors: torch.Tensor) -> None:
    dt = tensors[0].dtype
    if dt not in _DTYPES:
        raise TypeError(f"{name}: dtype {dt} not in {_DTYPES}")
    for t in tensors[1:]:
        if t.dtype != dt:
            raise TypeError(f"{name}: mixed dtypes {dt} and {t.dtype}")


# ---------------------------------------------------------------------------
# row norms: rms_norm, fused_add_rms_norm, layer_norm, fused_add_layer_norm,
# dequant_add_rms_norm
# ---------------------------------------------------------------------------

def _check_norm(name: str, x, residual, *vectors) -> bool:
    """Validate a row norm's operands; True for CUDA, False for CPU."""
    operands = [t for t in (x, residual, *vectors) if t is not None]
    on_card = _on_card(name, *operands)
    _check_dtype(name, *operands)
    d = x.shape[-1]
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"{name}: residual {tuple(residual.shape)} for x "
                         f"{tuple(x.shape)}")
    for v in vectors:
        if v.shape != (d,):
            raise ValueError(f"{name}: scale/bias {tuple(v.shape)} for width {d}")
    if on_card and d > _norms.MAX_WIDTH:
        raise ValueError(f"{name}: width {d} above the kernel's "
                         f"{_norms.MAX_WIDTH}")
    return on_card


@torch.library.custom_op("repro_torch::rms_norm", mutates_args=())
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = False) -> torch.Tensor:
    """RMSNorm over the last dim of ``x`` (..., d) with a (d,) scale."""
    if not _check_norm("rms_norm", x, None, scale):
        return ref.rms_norm(x, scale, eps=eps, zero_centered=zero_centered)
    _count("rms_norm")
    return _norms.rms_norm(x, scale, eps, zero_centered)


@rms_norm.register_fake
def _(x, scale, eps=1e-6, zero_centered=False):
    return torch.empty_like(x)


@torch.library.custom_op("repro_torch::fused_add_rms_norm", mutates_args=())
def fused_add_rms_norm(x: torch.Tensor, residual: torch.Tensor,
                       scale: torch.Tensor, eps: float = 1e-6,
                       zero_centered: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(rms_norm(r), r)`` with ``r = x + residual`` rounded once to the
    operands' dtype; the norm reads the rounded ``r``."""
    if not _check_norm("fused_add_rms_norm", x, residual, scale):
        return ref.fused_add_rms_norm(x, residual, scale, eps=eps,
                                      zero_centered=zero_centered)
    _count("fused_add_rms_norm")
    return _norms.fused_add_rms_norm(x, residual, scale, eps, zero_centered)


@fused_add_rms_norm.register_fake
def _(x, residual, scale, eps=1e-6, zero_centered=False):
    return torch.empty_like(x), torch.empty_like(x)


@torch.library.custom_op("repro_torch::layer_norm", mutates_args=())
def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim of ``x`` (..., d), two-pass variance."""
    if not _check_norm("layer_norm", x, None, scale, bias):
        return ref.layer_norm(x, scale, bias, eps=eps)
    _count("layer_norm")
    return _norms.layer_norm(x, scale, bias, eps)


@layer_norm.register_fake
def _(x, scale, bias, eps=1e-5):
    return torch.empty_like(x)


@torch.library.custom_op("repro_torch::fused_add_layer_norm", mutates_args=())
def fused_add_layer_norm(x: torch.Tensor, residual: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor,
                         eps: float = 1e-5
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(layer_norm(r), r)`` with ``r = x + residual`` rounded once."""
    if not _check_norm("fused_add_layer_norm", x, residual, scale, bias):
        return ref.fused_add_layer_norm(x, residual, scale, bias, eps=eps)
    _count("fused_add_layer_norm")
    return _norms.fused_add_layer_norm(x, residual, scale, bias, eps)


@fused_add_layer_norm.register_fake
def _(x, residual, scale, bias, eps=1e-5):
    return torch.empty_like(x), torch.empty_like(x)


@torch.library.custom_op("repro_torch::dequant_add_rms_norm", mutates_args=())
def dequant_add_rms_norm(q: torch.Tensor, qscale: torch.Tensor,
                         residual: torch.Tensor, scale: torch.Tensor,
                         eps: float = 1e-6, zero_centered: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(rms_norm(r), r)`` with ``r = q * qscale + residual`` rounded once
    to the residual's dtype: ``q`` int8, ``qscale`` a 0-d f32 tensor on the
    same device (the kernel reads it there), ``residual`` (q's shape) and
    the (d,) ``scale`` of one float dtype."""
    on_card = _on_card("dequant_add_rms_norm", q, qscale, residual, scale)
    if q.dtype != torch.int8:
        raise TypeError(f"dequant_add_rms_norm: q must be int8, got {q.dtype}")
    if qscale.dtype != torch.float32 or qscale.dim() != 0:
        raise TypeError(f"dequant_add_rms_norm: qscale must be a 0-d float32 "
                        f"tensor, got {qscale.dtype} of shape "
                        f"{tuple(qscale.shape)}")
    _check_norm("dequant_add_rms_norm", residual, None, scale)
    if residual.shape != q.shape:
        raise ValueError(f"dequant_add_rms_norm: residual "
                         f"{tuple(residual.shape)} for q {tuple(q.shape)}")
    if not on_card:
        return ref.dequant_add_rms_norm(q, qscale, residual, scale, eps=eps,
                                        zero_centered=zero_centered)
    _count("dequant_add_rms_norm")
    return _norms.dequant_add_rms_norm(q, qscale, residual, scale, eps,
                                       zero_centered)


@dequant_add_rms_norm.register_fake
def _(q, qscale, residual, scale, eps=1e-6, zero_centered=False):
    return torch.empty_like(residual), torch.empty_like(residual)


# ---------------------------------------------------------------------------
# softmax_xent
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::softmax_xent", mutates_args=())
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row cross-entropy: logits (R, V) f32 or bf16, integer labels
    (R,) in [0, V) -> (R,) f32. A label outside [0, V) picks nothing and
    gives the row's logsumexp on the card (the plain version raises)."""
    on_card = _on_card("softmax_xent", logits, labels)
    _check_dtype("softmax_xent", logits)
    if logits.dim() != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(f"softmax_xent: logits (R, V) and labels (R,), got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"softmax_xent: labels must be int32 or int64, got "
                        f"{labels.dtype}")
    if not on_card:
        return ref.softmax_xent(logits, labels)
    _count("softmax_xent")
    return _xent.softmax_xent(logits, labels)


@softmax_xent.register_fake
def _(logits, labels):
    return logits.new_empty(logits.shape[:1], dtype=torch.float32)


# ---------------------------------------------------------------------------
# rope
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::rope", mutates_args=())
def rope(x: torch.Tensor, positions: torch.Tensor, base: float = 10000.0,
         fraction: float = 1.0) -> torch.Tensor:
    """Rotate-halves rotary embedding of ``x`` (B, S, H, D) on the leading
    ``fraction`` of D; int32 ``positions`` (B, S), or (1, S) / (B, 1) that
    broadcast to it."""
    on_card = _on_card("rope", x)
    _check_dtype("rope", x)
    if x.dim() != 4:
        raise ValueError(f"rope: x must be (B, S, H, D), got {tuple(x.shape)}")
    b, s = x.shape[:2]
    if positions.device != x.device or positions.dtype != torch.int32:
        raise TypeError(f"rope: positions must be int32 on {x.device}, got "
                        f"{positions.dtype} on {positions.device}")
    if positions.dim() != 2 or positions.shape[0] not in (1, b) \
            or positions.shape[1] not in (1, s):
        raise ValueError(f"rope: positions {tuple(positions.shape)} do not "
                         f"broadcast to ({b}, {s})")
    if not 0.0 <= fraction <= 1.0:
        raise ValueError(f"rope: fraction {fraction} outside [0, 1]")
    if not on_card:
        return ref.rope(x, positions, base=base, fraction=fraction)
    _count("rope")
    return _rope.rope(x, positions, base, fraction)


@rope.register_fake
def _(x, positions, base=10000.0, fraction=1.0):
    return torch.empty_like(x)


# ---------------------------------------------------------------------------
# swiglu, geglu
# ---------------------------------------------------------------------------

def _check_glu(name: str, gate, up) -> bool:
    on_card = _on_card(name, gate, up)
    _check_dtype(name, gate, up)
    if gate.shape != up.shape:
        raise ValueError(f"{name}: shapes {tuple(gate.shape)} and "
                         f"{tuple(up.shape)}")
    return on_card


@torch.library.custom_op("repro_torch::swiglu", mutates_args=())
def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up`` in f32, rounded once to the operands' dtype."""
    if not _check_glu("swiglu", gate, up):
        return ref.swiglu(gate, up)
    _count("swiglu")
    return _glu.swiglu(gate, up)


@swiglu.register_fake
def _(gate, up):
    return torch.empty_like(gate)


@torch.library.custom_op("repro_torch::geglu", mutates_args=())
def geglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``gelu_tanh(gate) * up`` in f32, rounded once to the operands'
    dtype."""
    if not _check_glu("geglu", gate, up):
        return ref.geglu(gate, up)
    _count("geglu")
    return _glu.geglu(gate, up)


@geglu.register_fake
def _(gate, up):
    return torch.empty_like(gate)


# ---------------------------------------------------------------------------
# attention (causal, window and full) and decode
# ---------------------------------------------------------------------------

def _check_qkv(name: str, q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be (B, S, H, D)")
    b, _, hq, dk = q.shape
    if k.shape[0] != b or v.shape[0] != b or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} disagree")
    if k.shape[3] != dk or hq % k.shape[2]:
        raise ValueError(f"{name}: Dk {dk} vs {k.shape[3]}, or Hq {hq} not a "
                         f"multiple of Hkv {k.shape[2]}")


def _check_softcap(name: str, softcap: Optional[float]) -> None:
    if softcap is not None and not softcap > 0:
        raise ValueError(f"{name}: softcap {softcap} must be > 0")


def _check_kernel_dims(name: str, q, v, softcap: Optional[float] = None) -> None:
    dk, dv = q.shape[3], v.shape[3]
    if softcap is not None and not _attn.softcap_taken(dk, dv):
        raise ValueError(
            f"{name}: softcap {softcap} at head dims ({dk}, {dv}): the capped "
            f"instantiations take both up to {_attn.COMMON_MAX_DIM} alone (the "
            "wide ones, MLA's and recurrentgemma's, take no cap)")
    if name == "decode_core":
        group = q.shape[2] // v.shape[2]
        if group > _attn.MAX_GQA_GROUP:
            raise ValueError(f"decode_core: GQA group {group} above the "
                             f"kernel's {_attn.MAX_GQA_GROUP}")
        if not _attn.decode_dims_taken(dk, dv, group):
            wide = ", ".join(f"{d} at group {g}"
                             for d, g in _attn.DECODE_WIDE_DIMS.items())
            raise ValueError(
                f"decode_core: head dims ({dk}, {dv}) at group {group} have "
                f"no instantiation (the kernel takes both up to "
                f"{_attn.COMMON_MAX_DIM}, or {wide})")
        return
    common = (_attn.COMMON_MAX_DIM,) * 2
    if name == "attention_core":
        taken, limits = _attn.prefill_dims_taken(dk, dv), _attn.PREFILL_MAX_DIMS
    elif name == "attention_window":
        taken = _attn.prefill_dims_taken(dk, dv, causal=False, window=True)
        limits = f"{common}, or exactly {_attn.WINDOW_WIDE_DIMS}"
    else:
        taken, limits = _attn.prefill_dims_taken(dk, dv, causal=False), common
    if not taken:
        raise ValueError(f"{name}: head dims ({dk}, {dv}) have no "
                         f"instantiation (the kernel takes up to {limits})")


def _wants_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on these inputs: grad mode on and
    an input that requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _check_bwd(name: str, q, v, softcap: Optional[float]) -> None:
    """Raise for what the flash backward does not take: a softcap (JAX's
    flash VJP takes none; its capped path is plain autodiff) and, on the
    card, head dims past the forward's common bodies (MLA's (192, 128),
    256)."""
    if softcap is not None:
        raise ValueError(
            f"{name}: no gradient with softcap {softcap}: the flash backward "
            "takes no cap (JAX's flash VJP takes none either)")
    dk, dv = q.shape[3], v.shape[3]
    if q.is_cuda and not (dk <= _attn.COMMON_MAX_DIM
                          and dv <= _attn.COMMON_MAX_DIM):
        raise ValueError(
            f"{name}: no gradient at head dims ({dk}, {dv}): the flash "
            f"backward takes both up to {_attn.COMMON_MAX_DIM}")


@torch.library.custom_op("repro_torch::attention_lse", mutates_args=())
def attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: str, window: int = 1, q_offset: int = 0,
                       scale: Optional[float] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward of a prefill op, ``(out, lse)``, lse each
    row's log-sum-exp f32 (B, Hq, Sq), NEG_INF for a row that sees no key
    (JAX's ``_flash_fwd_impl``): on the card the lse entry of ``mask``
    (``csrc/attention_lse.cu``, counted ``attention_lse``), else the plain
    version. What the prefill ops run when a gradient is asked; its
    autograd formula saves (q, k, v, out, lse) and runs
    :func:`attention_bwd`. The lse carries no gradient."""
    name = f"attention_with_lse({mask})"
    on_card = _on_card(name, q, k, v)
    _check_dtype(name, q, k, v)
    _check_qkv(name, q, k, v)
    if mask not in _attn.MASK_CODE or q_offset < 0 or window <= 0:
        raise ValueError(f"{name}: mask not in {tuple(_attn.MASK_CODE)}, or "
                         f"q_offset {q_offset} < 0, or window {window} <= 0")
    _check_bwd(name, q, v, None)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if not on_card:
        return ref.attention_fwd_lse(
            q, k, v, causal=mask != "full",
            window=window if mask == "window" else None, q_offset=q_offset,
            scale=scale)
    _count("attention_lse")
    return _attn.attention_lse(q, k, v, mask, window, q_offset, scale)


@attention_with_lse.register_fake
def _(q, k, v, mask, window=1, q_offset=0, scale=None):
    b, sq, hq, _ = q.shape
    return (q.new_empty((b, sq, hq, v.shape[3]), dtype=v.dtype),
            q.new_empty((b, hq, sq), dtype=torch.float32))


def _lse_setup_context(ctx, inputs, output):
    q, k, v, mask, window, q_offset, scale = inputs
    out, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.mask, ctx.window, ctx.q_offset = mask, window, q_offset
    ctx.scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _lse_backward(ctx, grad, _lse_grad):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = attention_bwd(q, k, v, out, lse, grad.contiguous(),
                               ctx.mask, ctx.window, ctx.q_offset, ctx.scale)
    return dq, dk, dv, None, None, None, None


attention_with_lse.register_autograd(_lse_backward,
                                     setup_context=_lse_setup_context)


@torch.library.custom_op("repro_torch::attention_core", mutates_args=())
def _attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: int = 0, scale: Optional[float] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    on_card = _on_card("attention_core", q, k, v)
    _check_dtype("attention_core", q, k, v)
    _check_qkv("attention_core", q, k, v)
    _check_softcap("attention_core", softcap)
    if q_offset < 0:
        raise ValueError(f"attention_core: q_offset {q_offset} < 0")
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if not on_card:
        return ref.attention(q, k, v, q_offset=q_offset, scale=scale,
                             softcap=softcap).contiguous()
    _check_kernel_dims("attention_core", q, v, softcap)
    _count("attention_core")
    return _attn.attention_core(q, k, v, q_offset, scale, softcap)


@_attention_core.register_fake
def _(q, k, v, q_offset=0, scale=None, softcap=None):
    return q.new_empty((*q.shape[:3], v.shape[3]), dtype=v.dtype)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_offset: int = 0, scale: Optional[float] = None,
                   softcap: Optional[float] = None) -> torch.Tensor:
    """Causal GQA attention: q (B,Sq,Hq,Dk), k (B,Skv,Hkv,Dk),
    v (B,Skv,Hkv,Dv) -> (B,Sq,Hq,Dv); query row i sits at ``q_offset + i``.
    ``softcap``: the scores capped, ``tanh(s / cap) * cap``, before the
    mask (head dims up to 128 on the card). The op
    ``repro_torch::attention_core``, or, when a gradient is asked,
    :func:`attention_with_lse`'s output, which carries the gradient."""
    if _wants_grad(q, k, v):
        _check_bwd("attention_core", q, v, softcap)
        return attention_with_lse(q, k, v, "causal", 1, q_offset, scale)[0]
    return _attention_core(q, k, v, q_offset, scale, softcap)


@torch.library.custom_op("repro_torch::attention_window", mutates_args=())
def _attention_window(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      window: int, q_offset: int = 0,
                      scale: Optional[float] = None,
                      softcap: Optional[float] = None) -> torch.Tensor:
    on_card = _on_card("attention_window", q, k, v)
    _check_dtype("attention_window", q, k, v)
    _check_qkv("attention_window", q, k, v)
    _check_softcap("attention_window", softcap)
    if q_offset < 0 or window <= 0:
        raise ValueError(f"attention_window: q_offset {q_offset} < 0 or "
                         f"window {window} <= 0")
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if not on_card:
        return ref.attention(q, k, v, q_offset=q_offset, scale=scale,
                             window=window, softcap=softcap).contiguous()
    _check_kernel_dims("attention_window", q, v, softcap)
    _count("attention_window")
    return _attn.attention_window(q, k, v, window, q_offset, scale, softcap)


@_attention_window.register_fake
def _(q, k, v, window, q_offset=0, scale=None, softcap=None):
    return q.new_empty((*q.shape[:3], v.shape[3]), dtype=v.dtype)


def attention_window(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int, q_offset: int = 0,
                     scale: Optional[float] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """Sliding-window causal GQA attention: as :func:`attention_core`, and
    query row i (at position ``q_offset + i``) sees only the keys ``kpos``
    with ``q_offset + i - kpos < window``."""
    if _wants_grad(q, k, v):
        _check_bwd("attention_window", q, v, softcap)
        return attention_with_lse(q, k, v, "window", window, q_offset,
                                  scale)[0]
    return _attention_window(q, k, v, window, q_offset, scale, softcap)


@torch.library.custom_op("repro_torch::attention_full", mutates_args=())
def _attention_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    on_card = _on_card("attention_full", q, k, v)
    _check_dtype("attention_full", q, k, v)
    _check_qkv("attention_full", q, k, v)
    _check_softcap("attention_full", softcap)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if not on_card:
        return ref.attention(q, k, v, scale=scale, causal=False,
                             softcap=softcap).contiguous()
    _check_kernel_dims("attention_full", q, v, softcap)
    _count("attention_full")
    return _attn.attention_full(q, k, v, scale, softcap)


@_attention_full.register_fake
def _(q, k, v, scale=None, softcap=None):
    return q.new_empty((*q.shape[:3], v.shape[3]), dtype=v.dtype)


def attention_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: Optional[float] = None,
                   softcap: Optional[float] = None) -> torch.Tensor:
    """Full-mask GQA attention (every key visible): q (B,Sq,Hq,Dk),
    k (B,Skv,Hkv,Dk), v (B,Skv,Hkv,Dv) -> (B,Sq,Hq,Dv); Sq != Skv allowed
    (cross-attention). A gradient as :func:`attention_core`'s."""
    if _wants_grad(q, k, v):
        _check_bwd("attention_full", q, v, softcap)
        return attention_with_lse(q, k, v, "full", 1, 0, scale)[0]
    return _attention_full(q, k, v, scale, softcap)


@torch.library.custom_op("repro_torch::decode_core", mutates_args=())
def decode_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lengths: torch.Tensor, scale: Optional[float] = None,
                softcap: Optional[float] = None) -> torch.Tensor:
    """One-query attention: q (B,1,Hq,Dk) over k/v (B,T,Hkv,D) restricted
    to each row's first ``lengths[b]`` positions -> (B,1,Hq,Dv) in v's
    dtype. A row with ``lengths[b] == 0`` gives zeros. ``softcap``: the
    scores capped before the mask (head dims up to 128 on the card)."""
    on_card = _on_card("decode_core", q, k, v, lengths)
    _check_dtype("decode_core", q, k, v)
    _check_qkv("decode_core", q, k, v)
    _check_softcap("decode_core", softcap)
    b = q.shape[0]
    if q.shape[1] != 1:
        raise ValueError(f"decode_core: one query per row, got {q.shape[1]}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"decode_core: lengths must be int32 ({b},), got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if not on_card:
        return ref.decode_attention(q, k, v, lengths, scale=scale,
                                    softcap=softcap).to(v.dtype).contiguous()
    _check_kernel_dims("decode_core", q, v, softcap)
    _count("decode_core")
    return _attn.decode_core(q, k, v, lengths, scale, softcap=softcap)


@decode_core.register_fake
def _(q, k, v, lengths, scale=None, softcap=None):
    return q.new_empty((*q.shape[:3], v.shape[3]), dtype=v.dtype)


@torch.library.custom_op("repro_torch::attention_bwd", mutates_args=())
def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                  mask: str, window: int = 1, q_offset: int = 0,
                  scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flash backward of a prefill op: ``(dq, dk, dv)`` from q, k, v,
    the forward's ``out`` and its rows' ``lse`` (B, Hq, Sq) f32, and
    ``dout`` (out's shape); ``mask`` ``"causal"``, ``"window"`` (``window``
    keys) or ``"full"``, query row i at ``q_offset + i``. The counterpart
    of JAX's ``_flash_bwd_impl``; the plain version is
    ``ref.attention_bwd``."""
    on_card = _on_card("attention_bwd", q, k, v, out, lse, dout)
    _check_dtype("attention_bwd", q, k, v, out, dout)
    _check_qkv("attention_bwd", q, k, v)
    b, sq, hq, _ = q.shape
    if out.shape != (*q.shape[:3], v.shape[3]) or dout.shape != out.shape:
        raise ValueError(f"attention_bwd: out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} for q {tuple(q.shape)}, v "
                         f"{tuple(v.shape)}")
    if lse.dtype != torch.float32 or lse.shape != (b, hq, sq):
        raise ValueError(f"attention_bwd: lse must be float32 ({b}, {hq}, "
                         f"{sq}), got {lse.dtype} {tuple(lse.shape)}")
    if mask not in _attn.MASK_CODE or q_offset < 0 or window <= 0:
        raise ValueError(f"attention_bwd: mask {mask!r} not in "
                         f"{tuple(_attn.MASK_CODE)}, or q_offset {q_offset} "
                         f"< 0, or window {window} <= 0")
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if not on_card:
        return ref.attention_bwd(
            q, k, v, out, lse, dout, causal=mask != "full",
            window=window if mask == "window" else None, q_offset=q_offset,
            scale=scale)
    _check_bwd("attention_bwd", q, v, None)
    _count("attention_bwd")
    return _attn.attention_bwd(q, k, v, out, lse, dout, mask, window,
                               q_offset, scale)


@attention_bwd.register_fake
def _(q, k, v, out, lse, dout, mask, window=1, q_offset=0, scale=None):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)




# ---------------------------------------------------------------------------
# nms
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::nms_sorted", mutates_args=())
def nms_sorted(boxes: torch.Tensor, valid: torch.Tensor,
               iou_threshold: float = 0.5) -> torch.Tensor:
    """Greedy NMS over score-descending f32 xyxy boxes (N, 4) with a bool
    (N,) ``valid`` mask -> bool keep mask (N,)."""
    on_card = _on_card("nms", boxes, valid)
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"nms: boxes must be float32 and valid bool, got "
                        f"{boxes.dtype} and {valid.dtype}")
    n = boxes.shape[0]
    if boxes.shape != (n, 4) or valid.shape != (n,):
        raise ValueError(f"nms: boxes {tuple(boxes.shape)} and valid "
                         f"{tuple(valid.shape)}, expected (N, 4) and (N,)")
    if not on_card:
        return ref.nms_sorted(boxes, valid, iou_threshold)
    if n > _nms.MAX_BOXES:
        raise ValueError(f"nms: {n} boxes above the kernel's {_nms.MAX_BOXES}")
    _count("nms")
    return _nms.nms_sorted(boxes, valid, iou_threshold)


@nms_sorted.register_fake
def _(boxes, valid, iou_threshold=0.5):
    return torch.empty_like(valid)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
        score_threshold: float = 0.0) -> torch.Tensor:
    """torchvision-semantics NMS, (N, 4) xyxy boxes and (N,) scores -> keep
    (N,) bool in the input order, as ``repro.kernels.nms.nms``: a stable
    descending sort of the scores, :func:`nms_sorted` over the sorted f32
    boxes with ``valid = score > score_threshold``, and the keep mask
    scattered back."""
    order = ref.nms_order(scores)
    keep_sorted = nms_sorted(boxes[order].float().contiguous(),
                             scores[order] > score_threshold, iou_threshold)
    # out of place, as JAX's ``.at[order].set``: the scatter is then no
    # in-place op, which a timed run could time only once
    return torch.zeros_like(keep_sorted).scatter(0, order, keep_sorted)


# ---------------------------------------------------------------------------
# gradients of the other kernel-backed ops
# ---------------------------------------------------------------------------

def _plain_autograd(op, plain: Callable, n_tensors: int) -> None:
    """``op``'s gradient: that of its plain version ``plain`` with respect
    to its first ``n_tensors`` arguments (the floating ones; an int
    ``positions`` takes none), by autograd through ``plain`` recomputed
    in the backward from the saved inputs. JAX differentiates the ``jnp``
    twins of these ops; no Pallas kernel of them has a backward."""
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:n_tensors])
        ctx.rest = tuple(inputs[n_tensors:])

    def backward(ctx, *grads):
        xs = [t.detach().requires_grad_(t.is_floating_point())
              for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = plain(*xs, *ctx.rest)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        wrt = [x for x in xs if x.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                       [g for _, g in pairs],
                                       allow_unused=True))
        return (*(next(got) if x.requires_grad else None for x in xs),
                *(None,) * len(ctx.rest))

    op.register_autograd(backward, setup_context=setup_context)


def _no_autograd(op, name: str,
                 why: str = "no training path differentiates this kernel"
                 ) -> None:
    """``op`` raises if a gradient is asked: no training path needs one."""
    def backward(ctx, *grads):
        raise RuntimeError(f"{name}: no gradient: {why}")

    op.register_autograd(backward)


for _op, _plain, _n in ((rms_norm, ref.rms_norm, 2),
                        (fused_add_rms_norm, ref.fused_add_rms_norm, 3),
                        (layer_norm, ref.layer_norm, 3),
                        (fused_add_layer_norm, ref.fused_add_layer_norm, 4),
                        (rope, ref.rope, 2), (swiglu, ref.swiglu, 2),
                        (geglu, ref.geglu, 2)):
    _plain_autograd(_op, _plain, _n)
for _op, _name in ((decode_core, "decode_core"), (nms_sorted, "nms"),
                   (softmax_xent, "softmax_xent"),
                   (dequant_add_rms_norm, "dequant_add_rms_norm"),
                   (attention_bwd, "attention_bwd")):
    _no_autograd(_op, _name)
for _op, _name in ((_attention_core, "attention_core"),
                   (_attention_window, "attention_window"),
                   (_attention_full, "attention_full")):
    _no_autograd(_op, f"repro_torch::{_name}",
                 f"call ops.{_name}, which runs attention_with_lse when a "
                 "gradient is asked")


# ---------------------------------------------------------------------------
# Static kernel metadata (nglint NG005)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Static description of one hand-written kernel (the counterpart of
    ``repro.kernels.ops.KernelSpec``).

    ``op`` is its ``torch.ops.repro_torch`` op, whose fake lets the capture
    and ``torch.compile`` see the launch as one call; ``plain`` its plain
    version in ``kernels/ref.py``, which the wrapper takes for CPU tensors;
    ``sources`` the ``csrc/`` files ``_build`` compiles it from.
    ``handles_remainder`` says how a partial last tile is made legal, where
    JAX's kernels pad operands (``"pad"``) or clamp their blocks
    (``"clamp"``): every kernel here masks (``"mask"``), no operand is
    padded, and the kernel bounds its loads and stores by the operand's
    dims (the K tail of a row, the last key tile, the last split of a
    cache, the last 64-box word).
    """

    name: str
    op: str
    plain: Callable
    sources: Tuple[str, ...]
    handles_remainder: Optional[str] = "mask"

    @property
    def qualname(self) -> str:
        return f"repro_torch::{self.op}"


def _spec(name: str, plain: Callable, *sources: str,
          op: Optional[str] = None) -> Tuple[str, KernelSpec]:
    return name, KernelSpec(name=name, op=op or name, plain=plain,
                            sources=sources)


#: every kernel of :data:`KERNELS`, keyed by its launch-count name, which
#: is the name ``core/fusion.FUSION_PATTERNS`` entries use in ``kernel=``
#: (nglint NG005 cross-checks the two tables)
KERNEL_SPECS: Dict[str, KernelSpec] = dict((
    _spec("rms_norm", ref.rms_norm, "norms.cu"),
    _spec("fused_add_rms_norm", ref.fused_add_rms_norm, "norms.cu"),
    _spec("dequant_add_rms_norm", ref.dequant_add_rms_norm, "norms.cu"),
    _spec("layer_norm", ref.layer_norm, "norms.cu"),
    _spec("fused_add_layer_norm", ref.fused_add_layer_norm, "norms.cu"),
    _spec("rope", ref.rope, "rope.cu"),
    _spec("swiglu", ref.swiglu, "swiglu.cu"),
    _spec("geglu", ref.geglu, "swiglu.cu"),
    _spec("attention_core", ref.attention, "attention.cu",
          "attention_softcap.cu"),
    _spec("attention_window", ref.attention, "attention.cu",
          "attention_softcap.cu"),
    _spec("attention_full", ref.attention, "attention.cu",
          "attention_softcap.cu"),
    _spec("decode_core", ref.decode_attention, "decode.cu",
          "decode_softcap.cu"),
    _spec("softmax_xent", ref.softmax_xent, "softmax_xent.cu"),
    _spec("attention_lse", ref.attention_fwd_lse, "attention_lse.cu"),
    _spec("attention_bwd", ref.attention_bwd, "attention_bwd.cu"),
    _spec("nms", ref.nms_sorted, "nms.cu", op="nms_sorted"),
))
