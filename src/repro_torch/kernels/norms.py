"""Row norms on the card: the launches of ``csrc/norms.cu``.

One template kernel replaces five Pallas kernels of
``repro.kernels.norms``: ``rms_norm``, ``fused_add_rms_norm``,
``dequant_add_rms_norm``, ``layer_norm`` and ``fused_add_layer_norm``. The source states what bounds
them on an H100 (bytes) and what the design does about that. Callers go
through ``repro_torch.kernels.ops``, which validates, counts the launch and
takes the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

#: the widest row the kernel takes (csrc/norms.cu kMaxWidth: the row is
#: kept in shared memory as f32)
MAX_WIDTH = 32768

_RMS, _LN = 0, 1
_P = ctypes.c_void_p
_ARGS = [_P, _P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_float,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]
_DEQUANT_ARGS = [_P, _P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int,
                 ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()     # None: a null pointer


def _launch(name: str, kind: int, x: torch.Tensor,
            residual: Optional[torch.Tensor], scale: torch.Tensor,
            bias: Optional[torch.Tensor], eps: float, zero_centered: bool):
    d = x.shape[-1]
    y = torch.empty_like(x)
    r = None if residual is None else torch.empty_like(x)
    dev, stream = _build.stream_and_device(x)
    fn = _build.entry("norms", "repro_row_norm", _ARGS)
    _build.check(fn(x.data_ptr(), _ptr(residual), scale.data_ptr(), _ptr(bias),
                    y.data_ptr(), _ptr(r), x.numel() // d, d, eps,
                    int(zero_centered), kind, _build.DTYPE_CODE[x.dtype], dev,
                    stream), name)
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
    d = q.shape[-1]
    y = torch.empty_like(residual)
    r = torch.empty_like(residual)
    dev, stream = _build.stream_and_device(q)
    fn = _build.entry("norms", "repro_dequant_add_rms_norm", _DEQUANT_ARGS)
    _build.check(fn(q.data_ptr(), qscale.data_ptr(), residual.data_ptr(),
                    scale.data_ptr(), y.data_ptr(), r.data_ptr(), q.numel() // d,
                    d, eps, int(zero_centered),
                    _build.DTYPE_CODE[residual.dtype], dev, stream),
                 "dequant_add_rms_norm")
    return y, r
