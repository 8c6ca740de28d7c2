"""RMSNorm on the card: the launch of ``csrc/rms_norm.cu``.

Replaces ``repro.kernels.norms._rms_kernel`` / ``rms_norm`` (the Pallas
kernel). The source states what bounds it on an H100 (bytes) and what its
design does about that. Callers go through ``repro_torch.kernels.ops
.rms_norm``, which validates, counts the launch and takes the plain
version for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             zero_centered: bool) -> torch.Tensor:
    """Launch on validated, contiguous CUDA tensors of one dtype."""
    d = x.shape[-1]
    y = torch.empty_like(x)
    dev, stream = _build.stream_and_device(x)
    fn = _build.entry("rms_norm", "repro_rms_norm", _ARGS)
    _build.check(fn(x.data_ptr(), scale.data_ptr(), y.data_ptr(),
                    x.numel() // d, d, eps, int(zero_centered),
                    _build.DTYPE_CODE[x.dtype], dev, stream), "rms_norm")
    return y
