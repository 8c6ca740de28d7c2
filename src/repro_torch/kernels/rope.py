"""Rotary embedding on the card: the launch of ``csrc/rope.cu``.

Replaces ``repro.kernels.rope.rope`` (``_rope_kernel``). The source states
what bounds it on an H100 (bytes) and what its design does about that.
Each launch runs the plan :func:`rope_plan` picks from the shapes alone.
Callers go through ``repro_torch.kernels.ops.rope``, which validates,
counts the launch and takes the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

#: threads of a CTA that packs whole rows (many rows), and the most a CTA has
THREADS = 256
MAX_THREADS = 1024
#: threads of this kernel an SM is taken to hold (its registers allow more:
#: PERF.md §6): the walking grid's CTAs are all resident at once
SM_THREADS = 1024
#: the most rows a CTA takes at a time, and its shared memory (the default
#: 48 KB, no opt-in): one angle table, or two where the CTA walks
MAX_ROWS_PER_CTA = 8
SMEM = 48 * 1024

_I, _L, _P = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
_ARGS = [_P, _P, _P, _L, _I, _I, _I, _I, _L, _L, ctypes.c_float,
         _I, _I, _I, _I, _I, _I, _P]


class RopePlan(NamedTuple):
    """How one launch covers ``rows`` rows of H heads.

    A CTA of ``threads`` threads takes ``rows_per_cta`` rows at a time over
    all their heads, one vector of ``width`` values (16 bytes' worth, or 1:
    scalar) from each half a thread, in chunks where a step has more
    vectors than threads; ``grid`` CTAs walk the rows by a grid stride."""
    width: int
    threads: int
    rows_per_cta: int
    grid: int


def smem_bytes(plan: RopePlan, rows: int, half: int) -> int:
    """The angle tables of a launch: two buffers where a CTA walks."""
    bufs = 2 if plan.grid * plan.rows_per_cta < rows else 1
    return 4 * bufs * plan.rows_per_cta * 2 * half


@functools.lru_cache(maxsize=1024)
def rope_plan(rows: int, h: int, d: int, half: int, dtype: torch.dtype,
              vec: bool, sms: int) -> RopePlan:
    """The launch of rope over ``rows`` rows of ``h`` heads of ``d``
    values of ``dtype``, rotating the leading ``2 * half``, from the shapes
    and the card's SM count alone (nothing here reads a tensor, so a launch
    never waits on the card). ``vec``: 16-byte loads are possible.

    A CTA's threads cover a row's vectors, one each (at most MAX_THREADS,
    in chunks beyond). Few rows (one wave of CTAs): one CTA a row. Many
    rows: whole rows packed into THREADS threads and a grid of the SMs
    times the CTAs an SM holds, walking the rows, where the two angle
    tables fit in SMEM (otherwise one CTA a row group)."""
    width = 16 // dtype.itemsize if vec else 1
    per_row = h * (half // width)           # vectors a row rotates
    threads = min(MAX_THREADS, max(32, -(-per_row // 32) * 32))
    r = 1
    if rows > sms * max(1, SM_THREADS // threads):
        r = max(1, min(MAX_ROWS_PER_CTA, THREADS // max(per_row, 1)))
        while r > 1 and 16 * r * half > SMEM:
            r -= 1
        threads = min(MAX_THREADS, max(32, -(-(r * per_row) // 32) * 32))
    steps = -(-rows // r)
    grid = min(steps, sms * max(1, SM_THREADS // threads))
    if grid < steps and 16 * r * half > SMEM:   # no room for two tables
        grid = steps
    return RopePlan(width, threads, r, grid)


def _vec_ok(half: int, d: int, dtype: torch.dtype, *ptrs: int) -> bool:
    v = 16 // dtype.itemsize
    return half % v == 0 and d % v == 0 and all(p % 16 == 0 for p in ptrs)


def plan_for(x: torch.Tensor, fraction: float = 1.0,
             out: torch.Tensor | None = None) -> RopePlan:
    """The plan of the launch on ``x`` (B, S, H, D) into ``out`` (by
    default taken as 16-byte aligned, as ``torch.empty_like`` gives it):
    the one :func:`rope` runs."""
    b, s, h, d = x.shape
    half = int(d * fraction) // 2
    ptrs = (x.data_ptr(),) if out is None else (x.data_ptr(), out.data_ptr())
    return rope_plan(b * s, h, d, half, x.dtype, _vec_ok(half, d, x.dtype, *ptrs),
                     _build.sm_count(x.get_device()))


def rope(x: torch.Tensor, positions: torch.Tensor, base: float,
         fraction: float) -> torch.Tensor:
    """Launch on a validated, contiguous CUDA ``x`` (B, S, H, D) and int32
    ``positions`` on the same card that broadcast to (B, S). The kernel
    reads the positions through their strides: a broadcast is not copied."""
    b, s, h, d = x.shape
    half = int(d * fraction) // 2
    p = positions.expand(b, s)
    out = torch.empty_like(x)
    dev, stream = _build.stream_and_device(x)
    plan = plan_for(x, fraction, out)
    fn = _build.entry("rope", "repro_rope", _ARGS)
    _build.check(fn(x.data_ptr(), p.data_ptr(), out.data_ptr(), b * s, s, h, d,
                    half, p.stride(0), p.stride(1), base, plan.width, plan.threads,
                    plan.rows_per_cta, plan.grid, _build.DTYPE_CODE[x.dtype], dev,
                    stream), "rope")
    return out
