"""Rotary embedding on the card: the launch of ``csrc/rope.cu``.

Replaces ``repro.kernels.rope.rope`` (``_rope_kernel``). The source states
what bounds it on an H100 (bytes) and what its design does about that.
Callers go through ``repro_torch.kernels.ops.rope``, which validates,
counts the launch and takes the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_I, _L, _P = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
_ARGS = [_P, _P, _P, _L, _I, _I, _I, _I, _L, _L, ctypes.c_float, _I, _I, _P]


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
    fn = _build.entry("rope", "repro_rope", _ARGS)
    _build.check(fn(x.data_ptr(), p.data_ptr(), out.data_ptr(), b * s, s, h, d,
                    half, p.stride(0), p.stride(1), base,
                    _build.DTYPE_CODE[x.dtype], dev, stream), "rope")
    return out
