"""One wrapper per hand-written kernel: validation, dispatch, launch count.

Every wrapper

* checks device, dtype (float32 / bfloat16), shapes and contiguity, and
  raises on what its kernel does not take;
* takes the plain PyTorch version (``kernels/ref.py``) for CPU tensors —
  only because the tensor lies on the CPU — and for CUDA tensors launches
  its kernel on ``torch.cuda.current_stream()`` or raises: there is no
  fallback;
* adds one to :data:`launches` ``[name]`` where it launches, and nowhere
  else;
* is a ``torch.library.custom_op`` (``repro_torch::<name>``) with a fake
  implementation, so a ``TorchDispatchMode`` (the capture and the timed
  profile of ``core/graph.py``) sees the kernel as one op. A ctypes launch
  is invisible to dispatch modes; without the op its time would be lost.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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
           "dequant_add_rms_norm", "softmax_xent")

#: launches of each kernel since the last :func:`reset_launches`
launches = dict.fromkeys(KERNELS, 0)

_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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
    launches["rms_norm"] += 1
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
    launches["fused_add_rms_norm"] += 1
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
    launches["layer_norm"] += 1
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
    launches["fused_add_layer_norm"] += 1
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
    launches["dequant_add_rms_norm"] += 1
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
    launches["softmax_xent"] += 1
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
    launches["rope"] += 1
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
    launches["swiglu"] += 1
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
    launches["geglu"] += 1
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


def _check_kernel_dims(name: str, q, v) -> None:
    dk, dv = q.shape[3], v.shape[3]
    if dk > _attn.MAX_HEAD_DIM or dv > _attn.MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dims ({dk}, {dv}) above the kernel's "
                         f"{_attn.MAX_HEAD_DIM}")


@torch.library.custom_op("repro_torch::attention_core", mutates_args=())
def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_offset: int = 0,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Causal GQA attention: q (B,Sq,Hq,Dk), k (B,Skv,Hkv,Dk),
    v (B,Skv,Hkv,Dv) -> (B,Sq,Hq,Dv); query row i sits at ``q_offset + i``."""
    on_card = _on_card("attention_core", q, k, v)
    _check_dtype("attention_core", q, k, v)
    _check_qkv("attention_core", q, k, v)
    if q_offset < 0:
        raise ValueError(f"attention_core: q_offset {q_offset} < 0")
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if not on_card:
        return ref.attention(q, k, v, q_offset=q_offset, scale=scale)
    _check_kernel_dims("attention_core", q, v)
    launches["attention_core"] += 1
    return _attn.attention_core(q, k, v, q_offset, scale)


@attention_core.register_fake
def _(q, k, v, q_offset=0, scale=None):
    return q.new_empty((*q.shape[:3], v.shape[3]), dtype=v.dtype)


@torch.library.custom_op("repro_torch::attention_window", mutates_args=())
def attention_window(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int, q_offset: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Sliding-window causal GQA attention: as :func:`attention_core`, and
    query row i (at position ``q_offset + i``) sees only the keys ``kpos``
    with ``q_offset + i - kpos < window``."""
    on_card = _on_card("attention_window", q, k, v)
    _check_dtype("attention_window", q, k, v)
    _check_qkv("attention_window", q, k, v)
    if q_offset < 0 or window <= 0:
        raise ValueError(f"attention_window: q_offset {q_offset} < 0 or "
                         f"window {window} <= 0")
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if not on_card:
        return ref.attention(q, k, v, q_offset=q_offset, scale=scale,
                             window=window)
    _check_kernel_dims("attention_window", q, v)
    launches["attention_window"] += 1
    return _attn.attention_window(q, k, v, window, q_offset, scale)


@attention_window.register_fake
def _(q, k, v, window, q_offset=0, scale=None):
    return q.new_empty((*q.shape[:3], v.shape[3]), dtype=v.dtype)


@torch.library.custom_op("repro_torch::attention_full", mutates_args=())
def attention_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Full-mask GQA attention (every key visible): q (B,Sq,Hq,Dk),
    k (B,Skv,Hkv,Dk), v (B,Skv,Hkv,Dv) -> (B,Sq,Hq,Dv); Sq != Skv allowed
    (cross-attention)."""
    on_card = _on_card("attention_full", q, k, v)
    _check_dtype("attention_full", q, k, v)
    _check_qkv("attention_full", q, k, v)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if not on_card:
        return ref.attention(q, k, v, scale=scale, causal=False)
    _check_kernel_dims("attention_full", q, v)
    launches["attention_full"] += 1
    return _attn.attention_full(q, k, v, scale)


@attention_full.register_fake
def _(q, k, v, scale=None):
    return q.new_empty((*q.shape[:3], v.shape[3]), dtype=v.dtype)


@torch.library.custom_op("repro_torch::decode_core", mutates_args=())
def decode_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lengths: torch.Tensor,
                scale: Optional[float] = None) -> torch.Tensor:
    """One-query attention: q (B,1,Hq,Dk) over k/v (B,T,Hkv,D) restricted
    to each row's first ``lengths[b]`` positions -> (B,1,Hq,Dv) in v's
    dtype. A row with ``lengths[b] == 0`` gives zeros."""
    on_card = _on_card("decode_core", q, k, v, lengths)
    _check_dtype("decode_core", q, k, v)
    _check_qkv("decode_core", q, k, v)
    b = q.shape[0]
    if q.shape[1] != 1:
        raise ValueError(f"decode_core: one query per row, got {q.shape[1]}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"decode_core: lengths must be int32 ({b},), got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if not on_card:
        return ref.decode_attention(q, k, v, lengths, scale=scale).to(v.dtype)
    _check_kernel_dims("decode_core", q, v)
    if q.shape[2] // k.shape[2] > _attn.MAX_GQA_GROUP:
        raise ValueError(f"decode_core: GQA group {q.shape[2] // k.shape[2]} "
                         f"above the kernel's {_attn.MAX_GQA_GROUP}")
    launches["decode_core"] += 1
    return _attn.decode_core(q, k, v, lengths, scale)


@decode_core.register_fake
def _(q, k, v, lengths, scale=None):
    return q.new_empty((*q.shape[:3], v.shape[3]), dtype=v.dtype)


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
    launches["nms"] += 1
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
