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

In bf16 the prefill kernels run their products on the tensor cores
(``mma.sync``, P rounded to bf16 before P.V); in f32 they keep the FMA
body, which holds f32's limits (:func:`body`). Decode splits each row's
cache over ``n_split`` CTAs (:func:`decode_splits`) and merges the
partial softmaxes in a second pass.
"""

from __future__ import annotations

import ctypes
import functools

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
_DECODE_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                ctypes.c_float, _I, _I, _I, _I, _P]

#: keys per staged tile of csrc/decode.cu (kBK); a split covers whole tiles
DECODE_TILE = 64
#: CTAs per SM that decode_splits aims the split grid at: a split is
#: latency-bound, and a row's valid prefix, unseen on the host, may be a
#: small part of ``t``, so the grid aims at many short splits
DECODE_CTAS_PER_SM = 8


def body(dtype: torch.dtype) -> str:
    """Which body of ``csrc/attention.cu`` a prefill launch of ``dtype``
    runs: the tensor cores' in bf16, the CUDA cores' FMAs in f32."""
    return "mma bf16" if dtype == torch.bfloat16 else "fma f32"


def decode_splits(b: int, hkv: int, t: int, sms: int) -> int:
    """How many CTAs split each (row, KV head)'s cache of depth ``t``:
    from the shapes and the card's SM count alone, never from ``lengths``
    (a host read would stall the decode step). One where ``b * hkv``
    already gives every SM a CTA or the cache is one tile; else enough to
    put :data:`DECODE_CTAS_PER_SM` CTAs on each SM, at most one a tile,
    and no split left without a tile of the cache."""
    tiles = -(-t // DECODE_TILE)
    if b * hkv >= sms or tiles <= 1:
        return 1
    want = min(tiles, -(-DECODE_CTAS_PER_SM * sms // (b * hkv)))
    return -(-tiles // -(-tiles // want))


def decode_chunk(t: int, n_split: int) -> int:
    """Keys per split: whole tiles, ``n_split`` of them covering ``t``."""
    return max(1, -(-(-(-t // DECODE_TILE)) // n_split)) * DECODE_TILE


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
    int32 (B,) on the same card and is read by the kernel alone. With more
    than one split, the partial (m, l, acc) go to f32 scratch from
    ``torch.empty``, and the last split of each (row, KV head) to finish
    merges them, as its stream's counters (:func:`_counters`) say."""
    b, _, hq, dk = q.shape
    _, t, hkv, dv = v.shape
    o = torch.empty((b, 1, hq, dv), dtype=v.dtype, device=q.device)
    dev, stream = _build.stream_and_device(q)
    n_split = decode_splits(b, hkv, t, _sm_count(dev))
    chunk = decode_chunk(t, n_split)
    # held until the launch is enqueued: a tensor freed earlier could hand
    # its memory to the next allocation here
    scratch = ()
    if n_split > 1:
        scratch = (torch.empty((b * hkv, n_split, hq // hkv, dv),
                               dtype=torch.float32, device=q.device),
                   torch.empty((b * hkv, n_split, hq // hkv, 2),
                               dtype=torch.float32, device=q.device),
                   _counters(q.device, stream, b * hkv))
    ptrs = [x.data_ptr() for x in scratch] or [None, None, None]
    fn = _build.entry("decode", "repro_decode", _DECODE_ARGS)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    lengths.data_ptr(), o.data_ptr(), *ptrs,
                    b, t, hq, hkv, dk, dv, scale, chunk, n_split,
                    _build.DTYPE_CODE[q.dtype], dev, stream),
                 "decode_core")
    return o


@functools.lru_cache(maxsize=None)
def _sm_count(dev: int) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


_COUNTERS = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros on ``device``, one buffer per stream: the
    decode kernel counts its finished splits there and leaves it zeroed,
    so launches on one stream share it and it is set to zero once."""
    key = (device, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                           device=device)
    return buf
