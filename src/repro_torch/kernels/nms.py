"""Greedy NMS on the card: the launch of ``csrc/nms.cu``.

Replaces ``repro.kernels.nms.nms_sorted`` (``_nms_kernel``): the greedy
pass over score-sorted boxes. The sort before it and the scatter of the
keep mask back to the input order stay torch ops (``ops.nms``), as they
stay jnp ops around the Pallas call. Callers go through
``repro_torch.kernels.ops``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: the most boxes one call takes: boxes, areas and flags sit in one CTA's
#: shared memory (22 bytes a box of the 227 KB)
MAX_BOXES = 8192

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def nms_sorted(boxes: torch.Tensor, valid: torch.Tensor,
               iou_threshold: float) -> torch.Tensor:
    """Launch on validated, contiguous CUDA tensors: f32 boxes (N, 4),
    bool valid (N,) -> bool keep (N,)."""
    keep = torch.empty_like(valid)
    dev, stream = _build.stream_and_device(boxes)
    fn = _build.entry("nms", "repro_nms", _ARGS)
    _build.check(fn(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                    boxes.shape[0], iou_threshold, dev, stream), "nms")
    return keep
