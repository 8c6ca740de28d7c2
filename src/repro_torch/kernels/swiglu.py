"""SwiGLU on the card: the launch of ``csrc/swiglu.cu``.

Replaces ``repro.kernels.swiglu._swiglu_kernel`` (via ``_glu_call`` /
``swiglu``). The kernel takes the flattened tensor, so the TPU kernel's
256x512 tile padding has no counterpart. Callers go through
``repro_torch.kernels.ops.swiglu``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Launch on validated, contiguous CUDA tensors of one shape and dtype."""
    out = torch.empty_like(gate)
    dev, stream = _build.stream_and_device(gate)
    fn = _build.entry("swiglu", "repro_swiglu", _ARGS)
    _build.check(fn(gate.data_ptr(), up.data_ptr(), out.data_ptr(),
                    gate.numel(), _build.DTYPE_CODE[gate.dtype], dev, stream),
                 "swiglu")
    return out
