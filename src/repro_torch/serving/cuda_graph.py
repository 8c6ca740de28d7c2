"""A serving step captured once as a CUDA graph and replayed.

The eager engines dispatch every op of a decode step from Python, about
a thousand to five thousand launches a step. JAX compiles the same step
once (``jax.jit`` with the cache donated) and runs the program; the port's
counterpart is a CUDA graph of the step, captured once and replayed, which
launches all of it from one host call. It replays the eager step's own
kernels on the same shapes and launch plans, so it gives the eager step's
results.

What a capture needs of the step, and how it is met here:

* its per-call inputs come from static device buffers, written before
  every replay from pinned host buffers. The engines read the next tokens
  back (``.cpu()``) at the end of each step, which waits for the copies,
  so a host buffer is never rewritten under a copy in flight;
* its state (the KV cache, the paged pools) is the engine's own tensors,
  updated in place: the graph writes where the eager step writes, and
  what the engine writes between replays (a refilled slot, a new block in
  a table) is seen by the next replay;
* nothing it launches reads the card from the host, and every launch plan
  comes from the shapes alone;
* the kernels' per-stream counters exist before the capture: the warm-up
  step runs eagerly on the capture stream and makes them
  (``kernels/_build.counters`` raises if one is first asked for while
  the stream is captured);
* the wrappers' launch counts: the capture launches nothing, so it counts
  into a record (``ops.recording``) that every replay adds.

Whatever the capture does not take raises; nothing falls back to the
eager step.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch

from repro_torch import nn
from repro_torch.kernels import ops


#: one capture stream per device, shared by every graph: a stream carries
#: state that lives as long as the process (the kernels' counter buffer,
#: cuBLAS's workspace for it), so the graphs of many engines, built one
#: after another, pay for it once
_CAPTURE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    stream = _CAPTURE_STREAMS.get(device)
    if stream is None:
        stream = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return stream


def _trace_switches() -> tuple:
    """The process-global switches the step reads while it is captured:
    they are fixed in the graph (``nn.fuse`` is the step's own)."""
    return nn.get_backend(), nn.debug_bounds_enabled()


class StepGraph:
    """``step(*inputs) -> out`` on the card, captured at the first call.

    ``inputs`` are host arrays of the step's per-call inputs, of any dtype
    numpy and torch share: int token ids, int32 positions and block
    tables, or float frames (B, d_model) for a model that takes frame
    embeddings (musicgen-large's decode step); a call takes arrays of the
    same shapes and dtypes. The first call copies them to the
    static device buffers, runs ``step`` eagerly on the capture stream (the
    warm-up: it builds the kernels, makes their counters, and its result is
    returned), then captures ``step`` on the same buffers. Every later call
    copies its arrays in, replays, and returns the graph's output tensor,
    which the next replay overwrites. Deleting the object frees the graph
    and its memory pool.
    """

    def __init__(self, step: Callable, inputs: Sequence[np.ndarray],
                 device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {device}")
        self._step = step
        self._host = [torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                                  pin_memory=True) for a in inputs]
        self._inputs = [torch.empty_like(h, device=device) for h in self._host]
        self._stream = _capture_stream(self._inputs[0].device)
        self._graph = None
        self._out = None
        self._launches = {}
        self._switches = None

    def __call__(self, *arrays: np.ndarray) -> torch.Tensor:
        for h, d, a in zip(self._host, self._inputs, arrays, strict=True):
            h.numpy()[...] = a
            d.copy_(h, non_blocking=True)
        if self._graph is None:
            return self._warm_up_and_capture()
        if _trace_switches() != self._switches:
            raise RuntimeError(
                "the decode step was captured under (backend, debug_bounds) = "
                f"{self._switches} and is replayed under {_trace_switches()}; "
                "build a new engine to change them")
        self._graph.replay()
        ops.add_launches(self._launches)
        return self._out

    def _warm_up_and_capture(self) -> torch.Tensor:
        cur = torch.cuda.current_stream(self._inputs[0].device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            out = self._step(*self._inputs)
        cur.wait_stream(self._stream)
        out.record_stream(cur)
        graph = torch.cuda.CUDAGraph()
        with ops.recording() as launched, \
                torch.cuda.graph(graph, stream=self._stream):
            self._out = self._step(*self._inputs)
        self._graph, self._launches = graph, launched
        self._switches = _trace_switches()
        return out
