"""SwiGLU and GeGLU on the card: the launches of ``csrc/swiglu.cu``.

Replace ``repro.kernels.swiglu._swiglu_kernel`` and ``_geglu_kernel``
(via ``_glu_call`` / ``swiglu`` and ``geglu``). The kernels take the
flattened tensor, so the TPU kernel's 256x512 tile padding has no
counterpart. Callers go through ``repro_torch.kernels.ops.swiglu`` and
``ops.geglu``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _glu(symbol: str, gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Launch ``symbol`` on validated, contiguous CUDA tensors of one shape
    and dtype."""
    out = torch.empty_like(gate)
    dev, stream = _build.stream_and_device(gate)
    fn = _build.entry("swiglu", symbol, _ARGS)
    _build.check(fn(gate.data_ptr(), up.data_ptr(), out.data_ptr(),
                    gate.numel(), _build.DTYPE_CODE[gate.dtype], dev, stream),
                 symbol)
    return out


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return _glu("repro_swiglu", gate, up)


def geglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return _glu("repro_geglu", gate, up)
