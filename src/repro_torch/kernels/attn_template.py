"""Attention on the card: the launches of ``csrc/attention.cu`` (causal,
sliding-window and full-mask prefill / forward) and ``csrc/decode.cu``
(one-query decode).

Replace ``repro.kernels.attn_template.attention_core`` (the causal,
window and full fragments of ``_template_kernel``) and ``decode_core``
(``_decode_kernel``). The JAX template generates every mask variant from
one spec; the port has the four its models run: causal (with
``q_offset``, GQA, Dv != Dk), window (causal within ``window`` keys: the
``local`` layers), full (encoders and cross-attention, Sq != Skv
allowed) and decode over per-row valid ``lengths`` (a ring cache's
``min(pos + 1, w)`` included).

Both kernels read and write the JAX layouts directly — q (B,S,Hq,Dk),
k (B,T,Hkv,Dk), v (B,T,Hkv,Dv) — so no operand is transposed or padded.
Callers go through ``repro_torch.kernels.ops``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: the largest head dims and GQA group the kernels take (csrc kDMax/kGMax)
MAX_HEAD_DIM = 128
MAX_GQA_GROUP = 32

_I = ctypes.c_int
_P = ctypes.c_void_p
_ATTN_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
              ctypes.c_float, _I, _I, _P]
_WINDOW_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                ctypes.c_float, _I, _I, _P]
_FULL_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,
              _I, _I, _P]
_DECODE_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                _I, _I, _P]


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_offset: int, scale: float) -> torch.Tensor:
    """Causal launch on validated, contiguous CUDA tensors."""
    b, sq, hq, dk = q.shape
    _, skv, hkv, dv = v.shape
    o = torch.empty((b, sq, hq, dv), dtype=v.dtype, device=q.device)
    dev, stream = _build.stream_and_device(q)
    fn = _build.entry("attention", "repro_attention_causal", _ATTN_ARGS)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    b, sq, skv, hq, hkv, dk, dv, q_offset, scale,
                    _build.DTYPE_CODE[q.dtype], dev, stream), "attention_core")
    return o


def attention_window(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int, q_offset: int, scale: float) -> torch.Tensor:
    """Sliding-window launch on validated, contiguous CUDA tensors."""
    b, sq, hq, dk = q.shape
    _, skv, hkv, dv = v.shape
    o = torch.empty((b, sq, hq, dv), dtype=v.dtype, device=q.device)
    dev, stream = _build.stream_and_device(q)
    fn = _build.entry("attention", "repro_attention_window", _WINDOW_ARGS)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    b, sq, skv, hq, hkv, dk, dv, q_offset, window, scale,
                    _build.DTYPE_CODE[q.dtype], dev, stream),
                 "attention_window")
    return o


def attention_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """Full-mask launch on validated, contiguous CUDA tensors."""
    b, sq, hq, dk = q.shape
    _, skv, hkv, dv = v.shape
    o = torch.empty((b, sq, hq, dv), dtype=v.dtype, device=q.device)
    dev, stream = _build.stream_and_device(q)
    fn = _build.entry("attention", "repro_attention_full", _FULL_ARGS)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    b, sq, skv, hq, hkv, dk, dv, scale,
                    _build.DTYPE_CODE[q.dtype], dev, stream), "attention_full")
    return o


def decode_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lengths: torch.Tensor, scale: float) -> torch.Tensor:
    """Decode launch on validated, contiguous CUDA tensors; ``lengths`` is
    int32 (B,) on the same card and is read by the kernel itself."""
    b, _, hq, dk = q.shape
    _, t, hkv, dv = v.shape
    o = torch.empty((b, 1, hq, dv), dtype=v.dtype, device=q.device)
    dev, stream = _build.stream_and_device(q)
    fn = _build.entry("decode", "repro_decode", _DECODE_ARGS)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    lengths.data_ptr(), o.data_ptr(), b, t, hq, hkv, dk, dv,
                    scale, _build.DTYPE_CODE[q.dtype], dev, stream),
                 "decode_core")
    return o
