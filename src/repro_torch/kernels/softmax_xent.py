"""Softmax cross-entropy on the card: the launch of ``csrc/softmax_xent.cu``.

Replaces ``repro.kernels.softmax_xent._xent_kernel`` (via
``softmax_xent``). Each launch runs the plan :func:`xent_plan` picks from
the shapes and the SM count alone: each row's vocabulary cut into
``n_split`` spans of whole 8 KB tiles, one CTA a span, the last span of
a row to finish merging the row's partials in the same launch. The kernel
reads int32 or int64 labels as they are. Callers go through
``repro_torch.kernels.ops.softmax_xent``, which validates, counts the
launch and takes the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

#: bytes of one tile (csrc kTileBytes): a stage of the kernel's ring, and
#: the unit a span is made of
TILE_BYTES = 8192
#: threads of a CTA (csrc kThreads); the merge loads one span's partial a
#: thread, so a row has at most this many spans
THREADS = 256
#: CTAs per SM the split aims at where the rows alone do not put one on
#: every SM (1, 2 and 4 lie within 6 % of each other at 8 rows of 262144,
#: none best in both dtypes: PERF.md, PR 20)
CTAS_PER_SM = 2

_I, _L, _P = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
_ARGS = [_P, _P, _I, _P, _P, _P, _L, _L, _L, _I, _I, _I, _P]


class XentPlan(NamedTuple):
    """How one launch covers (rows, vocab): ``rows * n_split`` CTAs, CTA
    (r, s) taking columns [s * span, min(vocab, (s + 1) * span)) of row r;
    ``span`` is a whole number of tiles of ``tile`` elements."""
    tile: int
    span: int
    n_split: int


def xent_plan(rows: int, vocab: int, dtype: torch.dtype, sms: int) -> XentPlan:
    """The launch over logits (rows, vocab) of ``dtype`` on a card of
    ``sms`` SMs, from the sizes alone (nothing here reads a tensor, so a
    launch never waits on the card). One span a row where the rows alone
    put a CTA on every SM or the row is one tile (splitting (256, 32000)
    f32 in two cost 8-10 %: PERF.md, PR 20); else enough spans to put
    :data:`CTAS_PER_SM` CTAs on every SM, at most one a tile and
    :data:`THREADS` a row, none left empty."""
    tile = TILE_BYTES // dtype.itemsize
    tiles = -(-vocab // tile)
    n_split = 1
    if rows < sms and tiles > 1:
        want = min(tiles, THREADS, -(-CTAS_PER_SM * sms // rows))
        n_split = -(-tiles // -(-tiles // want))
    return XentPlan(tile, -(-tiles // n_split) * tile, n_split)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row CE of validated, contiguous CUDA logits (R, V) and int32 or
    int64 labels (R,) -> (R,) f32. With more than one span a row, the
    spans' (m, l, pick) go to f32 scratch from ``torch.empty``, and the
    last span of each row to finish merges them, as its stream's counters
    (``_build.counters``) say."""
    rows, vocab = logits.shape
    out = torch.empty(rows, dtype=torch.float32, device=logits.device)
    dev, stream = _build.stream_and_device(logits)
    p = xent_plan(rows, vocab, logits.dtype, _build.sm_count(dev))
    # held until the launch is enqueued: a tensor freed earlier could hand
    # its memory to the next allocation here
    scratch = ()
    if p.n_split > 1:
        scratch = (torch.empty((rows, p.n_split, 3), dtype=torch.float32,
                               device=logits.device),
                   _build.counters(logits.device, stream, rows))
    ptrs = [x.data_ptr() for x in scratch] or [None, None]
    fn = _build.entry("softmax_xent", "repro_softmax_xent", _ARGS)
    _build.check(fn(logits.data_ptr(), labels.data_ptr(), labels.element_size(),
                    out.data_ptr(), *ptrs, rows, vocab, p.span, p.n_split,
                    _build.DTYPE_CODE[logits.dtype], dev, stream),
                 "softmax_xent")
    return out
