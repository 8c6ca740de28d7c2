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

Head dims: both up to 128; MLA's: the causal prefill at Dk 192 / Dv 128
and the absorbed decode at Dk 576 / Dv 512 with one KV head for a group
of 16 (:data:`PREFILL_MAX_DIMS`, :data:`DECODE_MAX_DIMS`); and
recurrentgemma's local layers: the window prefill and the decode at Dk =
Dv = 256, decode with one KV head for a group of 10
(:data:`WINDOW_WIDE_DIMS`, :data:`DECODE_WIDE_DIMS`); a pair or group
outside raises.

In bf16 the prefill kernels run their products on the tensor cores
(``mma.sync``; P goes to P.V as two bf16 terms, its bf16 head and the
bf16 of the remainder, ``csrc/attention.cu``); in f32 they keep the FMA
body, which holds f32's limits (:func:`body`). Decode splits each row's
cache over ``n_split`` CTAs (:func:`decode_splits`); the last split of a
row and head to finish merges the partial softmaxes, in the same launch
(``csrc/decode.cu``). MLA's absorbed decode runs a wide body of its own,
in bf16 on the tensor cores with a plan of 32-key splits that fills the
card for its one KV head, in f32 on the FMA units (:func:`decode_body`).

The softcap fragment (``softcap=``, Gemma 2's attention logit cap): the
scores are capped, ``tanh(s / cap) * cap`` on the natural-unit score
before the mask, in instantiations of their own that
``csrc/attention_softcap.cu`` and ``csrc/decode_softcap.cu`` build beside
the uncapped ones, at the common head dims alone (:func:`softcap_taken`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

#: the (Dk, Dv) each kernel takes (csrc ``dims_taken``). Prefill: both up
#: to 128, or, causal only, MLA's pair, Dk 192 with Dv 128 (128 + 64 /
#: 128; the window and full masks have no such model).
#: Decode: both up to 128, or, in its wide body at a group of 16 alone,
#: MLA's absorbed decode, Dk 576 with Dv 512 (512 + 64 / 512)
PREFILL_MAX_DIMS = (192, 128)
DECODE_MAX_DIMS = (576, 512)
DECODE_WIDE_GROUP = 16
#: the window mask's wide pair (recurrentgemma's local layers); the causal
#: and full masks refuse it
WINDOW_WIDE_DIMS = (256, 256)
#: decode's wide bodies: each (Dk, Dv) and the one GQA group it takes
#: (MLA's absorbed decode; recurrentgemma's local layers)
DECODE_WIDE_DIMS = {DECODE_MAX_DIMS: DECODE_WIDE_GROUP, (256, 256): 10}
#: the largest head dims of the kernels' common instantiation
COMMON_MAX_DIM = 128
#: the largest GQA group decode takes (csrc kGMax)
MAX_GQA_GROUP = 32
#: the launch entries below, one a mask and decode: each has a spec of its
#: own in ``ops.KERNEL_SPECS`` (nglint NG005)
ENTRIES = ("attention_core", "attention_window", "attention_full",
           "decode_core", "attention_lse", "attention_bwd")


def prefill_dims_taken(dk: int, dv: int, causal: bool = True,
                       window: bool = False) -> bool:
    """Whether the prefill kernels have an instantiation for (Dk, Dv):
    both up to 128, MLA's (192, 128) for the causal mask, or
    :data:`WINDOW_WIDE_DIMS` for the window mask (``window``)."""
    if 0 < dk <= COMMON_MAX_DIM and 0 < dv <= COMMON_MAX_DIM:
        return True
    if window:
        return (dk, dv) == WINDOW_WIDE_DIMS
    return causal and (dk, dv) == PREFILL_MAX_DIMS


def decode_dims_taken(dk: int, dv: int, group: int) -> bool:
    """Whether ``csrc/decode.cu`` has a body for (Dk, Dv) at GQA group
    ``group``: its common one (both up to 128, a group up to
    :data:`MAX_GQA_GROUP`) or its wide ones (:func:`decode_wide`: the
    pairs of :data:`DECODE_WIDE_DIMS` at their groups)."""
    if dk <= 0 or dv <= 0:
        return False
    if not decode_wide(dk, dv):
        return group <= MAX_GQA_GROUP
    return DECODE_WIDE_DIMS.get((dk, dv)) == group


def softcap_taken(dk: int, dv: int) -> bool:
    """Whether the capped instantiations take (Dk, Dv): the common ones
    alone, both up to :data:`COMMON_MAX_DIM` (no model caps MLA's or
    recurrentgemma's wide attention)."""
    return 0 < dk <= COMMON_MAX_DIM and 0 < dv <= COMMON_MAX_DIM


def decode_wide(dk: int, dv: int) -> bool:
    """Whether (Dk, Dv) runs one of decode's wide bodies (a head dim past
    128: MLA's absorbed decode, recurrentgemma's 256), which
    :func:`decode_body` names."""
    return dk > COMMON_MAX_DIM or dv > COMMON_MAX_DIM

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


def _entry(source: str, symbol: str, args: list, softcap: Optional[float]):
    """(the C entry ``symbol`` of ``csrc/<source>.cu``, ()), or with
    ``softcap`` (its ``_softcap`` twin in ``<source>_softcap.cu``, which
    takes a ``float cap`` right after the scale, (the cap,)): what the call
    passes after the scale."""
    if softcap is None:
        return _build.entry(source, symbol, args), ()
    at = args.index(ctypes.c_float) + 1
    capped = args[:at] + [ctypes.c_float] + args[at:]
    return (_build.entry(f"{source}_softcap", f"{symbol}_softcap", capped),
            (float(softcap),))

#: keys per staged tile of csrc/decode.cu's common body (kBK) and of its
#: bf16 wide body (kMmaBK; the f32 wide body's 16 divide it): a split
#: covers whole tiles
DECODE_TILE = 64
DECODE_WIDE_TILE = 32
#: CTAs per SM that decode_splits aims the split grid at: a split is
#: latency-bound, and a row's valid prefix, unseen on the host, may be a
#: small part of ``t``, so the grid aims at many short splits. The bf16
#: wide body takes 212 KB of shared memory, one CTA an SM: its plan aims
#: at one CTA on every SM, at most one a 32-key tile
DECODE_CTAS_PER_SM = 8
DECODE_WIDE_CTAS_PER_SM = 1
#: the most splits the wide plan gives a row: its merge reads 32 KB of f32
#: partials a split in one CTA, ~0.33 us each on an H100, so that one row
#: over 4096 keys runs best in 32 splits of 4 tiles (0.0306 ms against
#: 0.0566 in 128 of one; ``scripts/decode_timing.py --plans``)
DECODE_WIDE_MAX_SPLITS = 32
#: the query heads a CTA of the wide bodies holds (mma's M in bf16)
DECODE_WIDE_HEADS_PER_CTA = 16


def body(dtype: torch.dtype) -> str:
    """Which body of ``csrc/attention.cu`` a prefill launch of ``dtype``
    runs: the tensor cores' in bf16, the CUDA cores' FMAs in f32."""
    return "mma bf16" if dtype == torch.bfloat16 else "fma f32"


def decode_body(dk: int, dv: int, dtype: torch.dtype) -> str:
    """Which body of ``csrc/decode.cu`` a launch at (Dk, Dv) in ``dtype``
    runs: the common one on the CUDA cores (both dims up to 128), or at
    the wide dims the tensor cores' in bf16 and the FMA units' in f32."""
    if not decode_wide(dk, dv):
        return "fma"
    return "wide mma bf16" if dtype == torch.bfloat16 else "wide fma f32"


def decode_splits(b: int, hkv: int, t: int, sms: int, wide: bool = False,
                  group: int = DECODE_WIDE_HEADS_PER_CTA) -> int:
    """How many CTAs split each (row, KV head)'s cache of depth ``t``:
    from the shapes and the card's SM count alone, never from ``lengths``
    (a host read would stall the decode step). One where the CTAs of a
    split already give every SM one or the cache is one tile; else enough
    to put :data:`DECODE_CTAS_PER_SM` CTAs on each SM, at most one a tile,
    and no split left without a tile of the cache. ``wide``: the plan of
    the wide bodies, from the rows and their query-head CTAs (``group``
    heads, :data:`DECODE_WIDE_HEADS_PER_CTA` a CTA), in tiles of
    :data:`DECODE_WIDE_TILE` keys, aimed at
    :data:`DECODE_WIDE_CTAS_PER_SM`, at most
    :data:`DECODE_WIDE_MAX_SPLITS` a row."""
    tile, per_sm = ((DECODE_WIDE_TILE, DECODE_WIDE_CTAS_PER_SM) if wide
                    else (DECODE_TILE, DECODE_CTAS_PER_SM))
    ctas = b * hkv * (-(-group // DECODE_WIDE_HEADS_PER_CTA) if wide else 1)
    tiles = -(-t // tile)
    if ctas >= sms or tiles <= 1:
        return 1
    want = min(tiles, -(-per_sm * sms // ctas))
    if wide:
        want = min(want, DECODE_WIDE_MAX_SPLITS)
    return -(-tiles // -(-tiles // want))


def decode_chunk(t: int, n_split: int, wide: bool = False) -> int:
    """Keys per split: whole tiles (of the wide bodies' with ``wide``),
    ``n_split`` of them covering ``t``."""
    tile = DECODE_WIDE_TILE if wide else DECODE_TILE
    return max(1, -(-(-(-t // tile)) // n_split)) * tile


def decode_plan(b: int, hq: int, hkv: int, t: int, dk: int, dv: int,
                sms: int) -> tuple:
    """(n_split, chunk) of a decode launch at these shapes: the wide
    bodies' plan at their dims, the common one elsewhere."""
    wide = decode_wide(dk, dv)
    n = decode_splits(b, hkv, t, sms, wide=wide, group=hq // hkv)
    return n, decode_chunk(t, n, wide=wide)


def _prefill(name: str, symbol: str, args: list, q, k, v, mask_args: tuple,
             scale: float, softcap: Optional[float]) -> torch.Tensor:
    """One launch of ``csrc/attention.cu``'s entry ``symbol`` (capped, of
    ``attention_softcap.cu``'s twin) on validated, contiguous CUDA
    tensors; ``mask_args``: the entry's q_offset and window, as it takes
    them."""
    b, sq, hq, dk = q.shape
    _, skv, hkv, dv = v.shape
    o = torch.empty((b, sq, hq, dv), dtype=v.dtype, device=q.device)
    dev, stream = _build.stream_and_device(q)
    fn, cap = _entry("attention", symbol, args, softcap)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    b, sq, skv, hq, hkv, dk, dv, *mask_args, scale, *cap,
                    _build.DTYPE_CODE[q.dtype], dev, stream), name)
    return o


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_offset: int, scale: float,
                   softcap: Optional[float] = None) -> torch.Tensor:
    """Causal launch on validated, contiguous CUDA tensors."""
    return _prefill("attention_core", "repro_attention_causal", _ATTN_ARGS,
                    q, k, v, (q_offset,), scale, softcap)


def attention_window(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int, q_offset: int, scale: float,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """Sliding-window launch on validated, contiguous CUDA tensors."""
    return _prefill("attention_window", "repro_attention_window",
                    _WINDOW_ARGS, q, k, v, (q_offset, window), scale, softcap)


def attention_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float,
                   softcap: Optional[float] = None) -> torch.Tensor:
    """Full-mask launch on validated, contiguous CUDA tensors."""
    return _prefill("attention_full", "repro_attention_full", _FULL_ARGS,
                    q, k, v, (), scale, softcap)


#: the training forward's entries of ``csrc/attention_lse.cu`` and their
#: arguments after (q, k, v, o, lse): each mask's as the plain entry's
_LSE_ARGS = {
    "causal": [_I] * 8 + [ctypes.c_float, _I, _I, _P],
    "window": [_I] * 9 + [ctypes.c_float, _I, _I, _P],
    "full": [_I] * 7 + [ctypes.c_float, _I, _I, _P],
}
#: csrc/attention_bwd.cu's mask codes
MASK_CODE = {"causal": 0, "window": 1, "full": 2}
_BWD_ARGS = [_P] * 10 + [_I] * 10 + [ctypes.c_float, _I, _I, _P]


def attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: str, window: int, q_offset: int, scale: float):
    """The training forward on validated, contiguous CUDA tensors:
    ``(o, lse)``, lse f32 (B, Hq, Sq), by ``csrc/attention_lse.cu``'s
    entry of ``mask``."""
    b, sq, hq, dk = q.shape
    _, skv, hkv, dv = v.shape
    o = torch.empty((b, sq, hq, dv), dtype=v.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    dev, stream = _build.stream_and_device(q)
    fn = _build.entry("attention_lse", f"repro_attention_{mask}_lse",
                      [_P] * 5 + _LSE_ARGS[mask])
    # after the head dims: the causal entry's q_offset, the window entry's
    # q_offset and window, nothing for the full one
    mask_args = {"causal": (q_offset,), "window": (q_offset, window),
                 "full": ()}[mask]
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), b, sq, skv, hq, hkv, dk, dv, *mask_args,
                    scale, _build.DTYPE_CODE[q.dtype], dev, stream),
                 "attention_lse")
    return o, lse


def attention_bwd(q, k, v, o, lse, dout, mask: str, window: int,
                  q_offset: int, scale: float):
    """The flash backward on validated, contiguous CUDA tensors: ``(dq,
    dk, dv)`` by ``csrc/attention_bwd.cu``, with delta = rowsum(dO * O) in
    f32 scratch from ``torch.empty``, held until the launches are
    enqueued."""
    b, sq, hq, dk = q.shape
    _, skv, hkv, dv = v.shape
    dq, dkk, dvv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    dev, stream = _build.stream_and_device(q)
    fn = _build.entry("attention_bwd", "repro_attention_bwd", _BWD_ARGS)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                    dkk.data_ptr(), dvv.data_ptr(), delta.data_ptr(),
                    b, sq, skv, hq, hkv, dk, dv, MASK_CODE[mask], q_offset,
                    window, scale, _build.DTYPE_CODE[q.dtype], dev, stream),
                 "attention_bwd")
    return dq, dkk, dvv


def decode_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lengths: torch.Tensor, scale: float,
                plan: Optional[tuple] = None,
                softcap: Optional[float] = None) -> torch.Tensor:
    """Decode launch on validated, contiguous CUDA tensors; ``lengths`` is
    int32 (B,) on the same card and is read by the kernel alone. With more
    than one split, the partial (m, l, acc) go to f32 scratch from
    ``torch.empty``, and the last split of each (row, KV head) to finish
    merges them, as its stream's counters (``_build.counters``) say.
    ``plan``: (n_split, chunk) in place of :func:`decode_plan`'s (a timing
    script's candidates; the entry refuses one its body cannot run).
    ``softcap``: the capped entry of ``csrc/decode_softcap.cu``."""
    b, _, hq, dk = q.shape
    _, t, hkv, dv = v.shape
    o = torch.empty((b, 1, hq, dv), dtype=v.dtype, device=q.device)
    dev, stream = _build.stream_and_device(q)
    n_split, chunk = plan or decode_plan(b, hq, hkv, t, dk, dv,
                                         _build.sm_count(dev))
    # held until the launch is enqueued: a tensor freed earlier could hand
    # its memory to the next allocation here
    scratch = ()
    if n_split > 1:
        scratch = (torch.empty((b * hkv, n_split, hq // hkv, dv),
                               dtype=torch.float32, device=q.device),
                   torch.empty((b * hkv, n_split, hq // hkv, 2),
                               dtype=torch.float32, device=q.device),
                   _build.counters(q.device, stream, b * hkv))
    ptrs = [x.data_ptr() for x in scratch] or [None, None, None]
    fn, cap = _entry("decode", "repro_decode", _DECODE_ARGS, softcap)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    lengths.data_ptr(), o.data_ptr(), *ptrs,
                    b, t, hq, hkv, dk, dv, scale, *cap, chunk, n_split,
                    _build.DTYPE_CODE[q.dtype], dev, stream),
                 "decode_core")
    return o
