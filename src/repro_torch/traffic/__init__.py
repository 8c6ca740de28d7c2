"""Trace-driven load subsystem: seeded synthetic request traces plus a
driver that replays them against a serving engine and reports TTFT
percentiles, queue wait, per-token latency, and goodput.

The port of ``repro.traffic`` over the port's ``Engine`` and
``PagedEngine``; ``traces`` is a pinned copy of the JAX package's."""

from repro_torch.traffic.traces import (Trace, TraceRequest, bursty_trace,
                                        load_trace, poisson_trace, save_trace,
                                        shadow_trace, shared_prefix_trace)
from repro_torch.traffic.driver import LoadReport, drive, prime, summarize

__all__ = [
    "Trace", "TraceRequest", "poisson_trace", "bursty_trace",
    "shared_prefix_trace", "shadow_trace", "save_trace", "load_trace",
    "LoadReport", "drive", "prime", "summarize",
]
