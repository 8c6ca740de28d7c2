"""Softmax cross-entropy on the card: the launch of ``csrc/softmax_xent.cu``.

Replaces ``repro.kernels.softmax_xent._xent_kernel`` (via
``softmax_xent``). The kernel reads int64 labels; the wrapper widens int32
ones. Callers go through ``repro_torch.kernels.ops.softmax_xent``, which
validates, counts the launch and takes the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_P = ctypes.c_void_p
_ARGS = [_P, _P, _P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
         ctypes.c_int, _P]


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row CE of validated, contiguous CUDA logits (R, V) and labels
    (R,) -> (R,) f32."""
    rows, vocab = logits.shape
    labels = labels.to(torch.int64).contiguous()
    out = torch.empty(rows, dtype=torch.float32, device=logits.device)
    dev, stream = _build.stream_and_device(logits)
    fn = _build.entry("softmax_xent", "repro_softmax_xent", _ARGS)
    _build.check(fn(logits.data_ptr(), labels.data_ptr(), out.data_ptr(), rows,
                    vocab, _build.DTYPE_CODE[logits.dtype], dev, stream),
                 "softmax_xent")
    return out
