"""Row norms on the card: the launches of ``csrc/norms.cu``.

One template kernel replaces five Pallas kernels of
``repro.kernels.norms``: ``rms_norm``, ``fused_add_rms_norm``,
``dequant_add_rms_norm``, ``layer_norm`` and ``fused_add_layer_norm``. The source states what bounds
them on an H100 (bytes) and what the design does about that. Each launch
runs the body :func:`row_norm_plan` picks from the shapes alone. Callers go
through ``repro_torch.kernels.ops``, which validates, counts the launch and
takes the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import _build

#: the widest row the kernel takes (csrc/norms.cu kMaxWidth: body C keeps
#: the row in shared memory as f32)
MAX_WIDTH = 32768
#: threads of a body-A or body-C CTA, and the most of a body-B CTA
THREADS = 256
#: 16-byte vectors a thread holds in registers in body B (kMaxVecs)
MAX_VECS = 8
#: the most 256-thread CTAs an SM holds (2048 threads): body A's grid
CTAS_PER_SM = 8

#: body codes of the C entries (csrc/norms.cu kWarp, kCta, kSmem)
BODY_CODE = {"warp": 0, "cta": 1, "smem": 2}

_RMS, _LN = 0, 1
_I = ctypes.c_int
_P = ctypes.c_void_p
_PLAN_ARGS = [_I, _I, _I, _I, _I]
_ARGS = [_P, _P, _P, _P, _P, _P, ctypes.c_int64, _I, ctypes.c_float, _I, _I, _I,
         *_PLAN_ARGS, _I, _P]
_DEQUANT_ARGS = [_P, _P, _P, _P, _P, _P, ctypes.c_int64, _I, ctypes.c_float, _I,
                 _I, *_PLAN_ARGS, _I, _P]


class RowNormPlan(NamedTuple):
    """How one launch covers ``rows`` rows of width ``d``.

    ``lanes`` threads share a row, each holding ``vecs`` loads of ``width``
    values; a CTA of ``threads`` threads holds ``rows_per_cta`` rows at
    once, and ``grid`` CTAs walk all rows (body A with a grid stride)."""
    body: str           # "warp" (A), "cta" (B) or "smem" (C)
    lanes: int
    vecs: int
    width: int          # values a load: 16 bytes' worth, or 1 (scalar)
    threads: int
    rows_per_cta: int
    grid: int


@functools.lru_cache(maxsize=1024)
def row_norm_plan(rows: int, d: int, dtype: torch.dtype, vec: bool,
                  sms: int) -> RowNormPlan:
    """The body and launch of a row norm over ``rows`` rows of ``d``
    values of ``dtype``, from the shapes and the card's SM count alone
    (nothing here reads a tensor, so a launch never waits on the card).
    ``vec``: 16-byte loads are possible (``d`` a multiple of 16 bytes'
    worth and every pointer 16-byte aligned).

    A where a row is at most 32 vectors (one a lane of a warp), B up to
    THREADS * MAX_VECS vectors, C for the rest and every scalar row
    (:func:`body_plan`). Rows of 33 to 256 vectors would fit one warp at
    up to 8 vectors a lane, but B ran faster at every main-path shape
    timed, 4 to 2048 rows of 384, 768 and 1600 (PERF.md §6)."""
    width = 16 // dtype.itemsize if vec else 1
    n = d // width
    if vec and n <= 32:
        return body_plan("warp", rows, d, dtype, vec, sms)
    if vec and n <= THREADS * MAX_VECS:
        return body_plan("cta", rows, d, dtype, vec, sms)
    return body_plan("smem", rows, d, dtype, vec, sms)


def body_plan(body: str, rows: int, d: int, dtype: torch.dtype, vec: bool,
              sms: int) -> RowNormPlan:
    """The launch of ``body`` on these shapes, where it can take them.

    A "warp": G = the next power of two of the row's vectors, within
    4..32, lanes share a row, one vector a lane (rows of at most 32
    vectors); 256 / G rows a CTA, and a grid of at most CTAS_PER_SM CTAs
    an SM walking the rows. B "cta": one CTA per row with the fewest
    vectors a thread (the most threads) that keeps it within THREADS.
    C "smem": 256 threads a row."""
    width = 16 // dtype.itemsize if vec else 1
    n = d // width
    if body == "warp" and vec and n <= 32:
        g = min(32, max(4, 1 << (n - 1).bit_length()))
        per = THREADS // g
        grid = min(-(-rows // per), sms * CTAS_PER_SM)
        return RowNormPlan("warp", g, 1, width, THREADS, per, grid)
    if body == "cta" and vec and n <= THREADS * MAX_VECS:
        k = -(-n // THREADS)
        t = -(-(-(-n // k)) // 32) * 32
        return RowNormPlan("cta", t, k, width, t, 1, rows)
    if body == "smem":
        return RowNormPlan("smem", THREADS, -(-n // THREADS), width, THREADS, 1, rows)
    raise ValueError(f"row norm body {body!r} cannot take rows of {d} {dtype} "
                     f"(16-byte loads: {vec})")


def _vec_ok(d: int, dtype: torch.dtype, x_size: int, ptrs) -> bool:
    """16-byte loads: ``d`` a multiple of 16 bytes of ``dtype``, the first
    pointer (x, of ``x_size``-byte elements) aligned to its own share of
    such a load, the others (None: no tensor) to 16 bytes."""
    v = 16 // dtype.itemsize
    if d % v or ptrs[0] % (v * x_size):
        return False
    return all(p is None or p % 16 == 0 for p in ptrs[1:])


def plan_for(x: torch.Tensor, dtype: torch.dtype, *others) -> RowNormPlan:
    """The plan of a launch on ``x`` (rows over its last dim) whose float
    operands are of ``dtype``; ``others`` the launch's other tensors."""
    d = x.shape[-1]
    ptrs = [x.data_ptr(), *(None if t is None else t.data_ptr() for t in others)]
    return row_norm_plan(x.numel() // d, d, dtype, _vec_ok(d, dtype, x.element_size(), ptrs),
                         _build.sm_count(x.get_device()))


def _start(fn, name: str, x: torch.Tensor, dtype: torch.dtype, ptrs, args,
           loads=None):
    """Plan and launch: ``ptrs`` the entry's six pointers (x's first),
    ``args`` what follows rows and d up to the plan; ``loads`` the
    pointers read or written in 16-byte vectors (default: ``ptrs``)."""
    d = x.shape[-1]
    dev, stream = _build.stream_and_device(x)
    vec = _vec_ok(d, dtype, x.element_size(), ptrs if loads is None else loads)
    p = row_norm_plan(x.numel() // d, d, dtype, vec, _build.sm_count(dev))
    _build.check(fn(*ptrs, x.numel() // d, d, *args, BODY_CODE[p.body], p.lanes,
                    p.vecs, p.threads, p.grid, dev, stream), name)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()     # None: a null pointer


def _launch(name: str, kind: int, x: torch.Tensor,
            residual: Optional[torch.Tensor], scale: torch.Tensor,
            bias: Optional[torch.Tensor], eps: float, zero_centered: bool):
    y = torch.empty_like(x)
    r = None if residual is None else torch.empty_like(x)
    ptrs = [x.data_ptr(), _ptr(residual), scale.data_ptr(), _ptr(bias), y.data_ptr(),
            _ptr(r)]
    _start(_build.entry("norms", "repro_row_norm", _ARGS), name, x, x.dtype, ptrs,
           (eps, int(zero_centered), kind, _build.DTYPE_CODE[x.dtype]))
    return y if r is None else (y, r)


# Each takes validated, contiguous CUDA tensors of one dtype.

def rms_norm(x, scale, eps: float, zero_centered: bool) -> torch.Tensor:
    return _launch("rms_norm", _RMS, x, None, scale, None, eps, zero_centered)


def fused_add_rms_norm(x, residual, scale, eps: float, zero_centered: bool):
    return _launch("fused_add_rms_norm", _RMS, x, residual, scale, None, eps,
                   zero_centered)


def layer_norm(x, scale, bias, eps: float) -> torch.Tensor:
    return _launch("layer_norm", _LN, x, None, scale, bias, eps, False)


def fused_add_layer_norm(x, residual, scale, bias, eps: float):
    return _launch("fused_add_layer_norm", _LN, x, residual, scale, bias, eps,
                   False)


def dequant_add_rms_norm(q, qscale, residual, scale, eps: float,
                         zero_centered: bool):
    """``q`` int8, ``qscale`` a 0-d f32 tensor on the same card (read there,
    no host sync), ``residual`` and ``scale`` of one float dtype."""
    y = torch.empty_like(residual)
    r = torch.empty_like(residual)
    ptrs = [q.data_ptr(), qscale.data_ptr(), residual.data_ptr(), scale.data_ptr(),
            y.data_ptr(), r.data_ptr()]
    # qscale, one f32, is read as a scalar
    _start(_build.entry("norms", "repro_dequant_add_rms_norm", _DEQUANT_ARGS),
           "dequant_add_rms_norm", q, residual.dtype, ptrs,
           (eps, int(zero_centered), _build.DTYPE_CODE[residual.dtype]),
           loads=[ptrs[0], None, *ptrs[2:]])
    return y, r


def empty_kernel(device: torch.device) -> None:
    """Launch a kernel that does nothing on ``device``'s current stream:
    the floor under every kernel time a timer reads (no launch count; it
    is no kernel of the port)."""
    dev = device.index if device.index is not None else torch.cuda.current_device()
    fn = _build.entry("norms", "repro_empty_kernel", [_I, _P])
    _build.check(fn(dev, torch.cuda.current_stream(dev).cuda_stream),
                 "empty_kernel")
