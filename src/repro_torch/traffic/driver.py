"""Trace-driven load harness: replay a trace against a serving engine.

The port of ``repro.traffic.driver`` over the port's ``Engine`` and
``PagedEngine``, with the same report fields and the same accounting.
``drive`` submits each :class:`TraceRequest` once its (scaled) arrival time
has passed, stepping the engine whenever work is pending, and summarizes
the run into a :class:`LoadReport` (TTFT percentiles, queue wait, per-token
decode latency, goodput). ``prime`` replays a token-remapped shadow of the
trace first, so that the measured run finds the kernels built and the
decode graph captured: without it, TTFT measures ``nvcc`` and the capture.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.serving import Engine, Request
from repro_torch.traffic.traces import TraceRequest, shadow_trace


@dataclasses.dataclass
class LoadReport:
    completed: int
    makespan_s: float
    emitted_tokens: int
    goodput_tok_per_s: float
    mean_ttft_s: float
    p50_ttft_s: float
    p99_ttft_s: float
    mean_service_ttft_s: float       # first token time minus admission time
    mean_queue_wait_s: float
    mean_decode_tok_latency_s: float
    prefix_hit_rate: float           # 0.0 when the engine has no prefix cache
    n_devices: int = 1               # TP degree of the engine (mesh-sharded)
    per_device_goodput_tok_per_s: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _percentile(xs: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


def summarize(engine: Engine, finished: Sequence[Request],
              makespan_s: float) -> LoadReport:
    ttfts = [r.ttft_s for r in finished if r.first_token_t > 0.0]
    service = [r.first_token_t - r.admit_t for r in finished
               if r.first_token_t > 0.0 and r.admit_t > 0.0]
    waits = [r.queue_wait_s for r in finished if r.admit_t > 0.0]
    tok_lat = [r.decode_tok_latency_s for r in finished if r.decode_tokens]
    emitted = sum(len(r.output) for r in finished)
    cache = getattr(engine, "prefix_cache", None)
    # an engine sharded over tp devices spends tp devices per emitted
    # token (the port serves on one device: tp is 1 unless set)
    n_devices = max(1, int(getattr(engine, "tp", 1) or 1))
    goodput = emitted / makespan_s if makespan_s > 0 else 0.0
    return LoadReport(
        completed=len(finished),
        makespan_s=makespan_s,
        emitted_tokens=emitted,
        goodput_tok_per_s=goodput,
        mean_ttft_s=float(np.mean(ttfts)) if ttfts else 0.0,
        p50_ttft_s=_percentile(ttfts, 50),
        p99_ttft_s=_percentile(ttfts, 99),
        mean_service_ttft_s=float(np.mean(service)) if service else 0.0,
        mean_queue_wait_s=float(np.mean(waits)) if waits else 0.0,
        mean_decode_tok_latency_s=float(np.mean(tok_lat)) if tok_lat else 0.0,
        prefix_hit_rate=cache.hit_rate if cache is not None else 0.0,
        n_devices=n_devices,
        per_device_goodput_tok_per_s=goodput / n_devices,
    )


def drive(engine: Engine, trace: Sequence[TraceRequest],
          time_scale: float = 1.0, max_wall_s: float = 300.0,
          ) -> Tuple[List[Request], LoadReport]:
    """Replay ``trace`` against ``engine``. Virtual time advances at
    ``time_scale`` virtual seconds per wall second, so a trace authored at
    realistic rates can be replayed quickly on a slow host. Returns the
    finished requests (trace order is not guaranteed) and a LoadReport."""
    pending = sorted(trace, key=lambda r: r.arrival_s)
    finished: List[Request] = []
    t0 = time.perf_counter()
    i = 0
    while i < len(pending) or engine.queue or engine.active:
        wall = time.perf_counter() - t0
        if wall > max_wall_s:
            raise RuntimeError(
                f"trace drive exceeded max_wall_s={max_wall_s} "
                f"({len(finished)}/{len(pending)} finished)")
        now = wall * time_scale
        while i < len(pending) and pending[i].arrival_s <= now:
            engine.add_request(pending[i].prompt, pending[i].max_new_tokens)
            i += 1
        if engine.queue or engine.active:
            finished.extend(engine.step())
        elif i < len(pending):
            gap = pending[i].arrival_s / time_scale - (time.perf_counter() - t0)
            if gap > 0:
                time.sleep(min(gap, 0.02))
    makespan = time.perf_counter() - t0
    return finished, summarize(engine, finished, makespan)


def prime(engine: Engine, trace: Sequence[TraceRequest],
          vocab_size: int, max_wall_s: float = 300.0) -> None:
    """Warm the engine by replaying a shadow of ``trace`` (same shapes and
    prefix structure, disjoint token values), then reset its stats so the
    measured run starts clean. On the card the shadow run builds the
    kernels (``nvcc``, at the first launch in the process), warms cuBLAS
    and captures the engine's decode graph, which is what JAX's ``prime``
    does for its jitted programs; on the CPU it only warms up."""
    drive(engine, shadow_trace(trace, vocab_size), time_scale=1e6,
          max_wall_s=max_wall_s)
    engine.reset_stats()
