"""Greedy NMS on the card: the launch of ``csrc/nms.cu``.

Replaces ``repro.kernels.nms.nms_sorted`` (``_nms_kernel``): the greedy
pass over score-sorted boxes, as an IoU bitmask over many CTAs and a
blocked greedy reduce in the same launch. The sort before it and the
scatter of the keep mask back to the input order stay torch ops
(``ops.nms``), as they stay jnp ops around the Pallas call. Callers go
through ``repro_torch.kernels.ops``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: the most boxes one call takes: the reduce keeps the removed set, the
#: valid and the kept bits in shared memory, 64 boxes a word (csrc/nms.cu
#: kMaxWords); the mask scratch is then 8 MB
MAX_BOXES = 8192

_P = ctypes.c_void_p
_ARGS = [_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_float, ctypes.c_int, _P]


def nms_sorted(boxes: torch.Tensor, valid: torch.Tensor,
               iou_threshold: float) -> torch.Tensor:
    """Launch on validated, contiguous CUDA tensors: f32 boxes (N, 4),
    bool valid (N,) -> bool keep (N,). The IoU mask, N x ceil(N / 64)
    64-bit words, is scratch from ``torch.empty`` (each word read is
    written first), held until the launch is enqueued; the kernel's
    counter is its stream's (``_build.counters``)."""
    n = boxes.shape[0]
    keep = torch.empty_like(valid)
    mask = torch.empty((n, -(-n // 64)), dtype=torch.int64, device=boxes.device)
    dev, stream = _build.stream_and_device(boxes)
    counter = _build.counters(boxes.device, stream, 1)
    fn = _build.entry("nms", "repro_nms", _ARGS)
    _build.check(fn(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                    mask.data_ptr(), counter.data_ptr(), n, iou_threshold,
                    dev, stream), "nms")
    return keep
