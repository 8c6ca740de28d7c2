"""SwiGLU and GeGLU on the card: the launches of ``csrc/swiglu.cu``.

Replace ``repro.kernels.swiglu._swiglu_kernel`` and ``_geglu_kernel``
(via ``_glu_call`` / ``swiglu`` and ``geglu``). The kernels take the
flattened tensor, so the TPU kernel's 256x512 tile padding has no
counterpart. Each launch runs the plan :func:`glu_plan` picks from the
shapes alone. Callers go through ``repro_torch.kernels.ops.swiglu`` and
``ops.geglu``, which validate, count the launch and take the plain
version for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

#: bytes of one access where the pointers allow it (16-byte accesses lose
#: 3-5 % at the decode step and tie at prefill: PERF.md §6), and threads
#: of a CTA
ACCESS_BYTES = 8
THREADS = 128

_I, _L, _P = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
_ARGS = [_P, _P, _P, _L, _I, _I, _I, _I, _I, _P]


class GluPlan(NamedTuple):
    """How one launch covers ``n`` elements: ``grid`` CTAs of ``threads``
    threads, thread i taking vector i of ``width`` elements (8 bytes'
    worth, or 1: scalar) of each operand, and element n // width * width +
    i of the last partial vector."""
    width: int
    threads: int
    grid: int


def glu_plan(n: int, dtype: torch.dtype, vec: bool) -> GluPlan:
    """The launch over ``n`` elements of ``dtype`` from the sizes alone
    (nothing here reads a tensor, so a launch never waits on the card).
    ``vec``: the three pointers allow ACCESS_BYTES-byte accesses. One step
    at any size: as many CTAs as the vectors need."""
    width = max(1, ACCESS_BYTES // dtype.itemsize) if vec else 1
    return GluPlan(width, THREADS, max(1, -(-(n // width) // THREADS)))


def plan_for(gate: torch.Tensor, up: torch.Tensor,
             out: torch.Tensor | None = None) -> GluPlan:
    """The plan of the launch on ``gate`` and ``up`` into ``out`` (by
    default taken as aligned, as ``torch.empty_like`` gives it): the one
    :func:`swiglu` and :func:`geglu` run."""
    ptrs = [gate.data_ptr(), up.data_ptr()] + ([] if out is None else [out.data_ptr()])
    return glu_plan(gate.numel(), gate.dtype,
                    all(p % ACCESS_BYTES == 0 for p in ptrs))


def _glu(symbol: str, gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Launch ``symbol`` on validated, contiguous CUDA tensors of one shape
    and dtype."""
    out = torch.empty_like(gate)
    dev, stream = _build.stream_and_device(gate)
    p = plan_for(gate, up, out)
    fn = _build.entry("swiglu", symbol, _ARGS)
    _build.check(fn(gate.data_ptr(), up.data_ptr(), out.data_ptr(), gate.numel(),
                    p.width, p.threads, p.grid, _build.DTYPE_CODE[gate.dtype], dev,
                    stream), symbol)
    return out


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return _glu("repro_swiglu", gate, up)


def geglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return _glu("repro_geglu", gate, up)
