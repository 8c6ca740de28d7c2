"""Synthetic request traces: seeded, replayable serving load.

A pinned copy of ``repro.traffic.traces`` (numpy only; the port imports
nothing of the JAX package): ``tests/test_torch_copies.py`` holds its code
equal to the original's, docstrings aside.

A trace is a list of :class:`TraceRequest` (arrival time in *virtual*
seconds, prompt token ids, decode budget), sorted by arrival. Generators
draw from ``np.random.RandomState(seed)`` only, so the same seed always
yields the same trace — byte-for-byte replayable, and dumpable to JSONL
for sharing across runs (see ``save_trace`` / ``load_trace``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class TraceRequest:
    arrival_s: float                 # virtual seconds from trace start
    prompt: List[int]
    max_new_tokens: int = 8

    def to_dict(self) -> dict:
        return {"arrival_s": self.arrival_s, "prompt": list(self.prompt),
                "max_new_tokens": self.max_new_tokens}

    @classmethod
    def from_dict(cls, d: dict) -> "TraceRequest":
        return cls(float(d["arrival_s"]), [int(t) for t in d["prompt"]],
                   int(d["max_new_tokens"]))


Trace = List[TraceRequest]


def _lengths(rng, n: int, bounds: Tuple[int, int]) -> np.ndarray:
    lo, hi = bounds
    return rng.randint(lo, hi + 1, size=n)


def _prompt(rng, length: int, vocab_size: int) -> List[int]:
    # token 0 is the engines' pad id — keep prompts in [1, vocab)
    return rng.randint(1, vocab_size, size=int(length)).tolist()


def poisson_trace(seed: int, n_requests: int, rate_rps: float,
                  vocab_size: int, prompt_len: Tuple[int, int] = (4, 32),
                  output_len: Tuple[int, int] = (2, 8)) -> Trace:
    """Memoryless arrivals: exponential inter-arrival gaps at ``rate_rps``
    requests per virtual second; prompt/output lengths uniform in bounds."""
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=n_requests)
    arrivals = np.cumsum(gaps)
    plens = _lengths(rng, n_requests, prompt_len)
    olens = _lengths(rng, n_requests, output_len)
    return [TraceRequest(float(arrivals[i]), _prompt(rng, plens[i], vocab_size),
                         int(olens[i])) for i in range(n_requests)]


def bursty_trace(seed: int, n_requests: int, vocab_size: int,
                 burst_len: int = 4, burst_gap_s: float = 0.001,
                 off_s: float = 0.05,
                 prompt_len: Tuple[int, int] = (4, 32),
                 output_len: Tuple[int, int] = (2, 8)) -> Trace:
    """On/off load: bursts of ``burst_len`` near-simultaneous requests
    separated by ``off_s`` idle gaps — the queue-depth stressor."""
    rng = np.random.RandomState(seed)
    plens = _lengths(rng, n_requests, prompt_len)
    olens = _lengths(rng, n_requests, output_len)
    out: Trace = []
    t = 0.0
    for i in range(n_requests):
        if i and i % burst_len == 0:
            t += off_s
        out.append(TraceRequest(t, _prompt(rng, plens[i], vocab_size),
                                int(olens[i])))
        t += burst_gap_s
    return out


def shared_prefix_trace(seed: int, n_requests: int, vocab_size: int,
                        prefix_len: int = 24,
                        suffix_len: Tuple[int, int] = (4, 8),
                        gap_s: float = 0.002,
                        output_len: Tuple[int, int] = (3, 6)) -> Trace:
    """Every prompt shares one ``prefix_len``-token prefix (a system
    prompt) with a per-request random suffix — the prefix-cache workload."""
    rng = np.random.RandomState(seed)
    prefix = _prompt(rng, prefix_len, vocab_size)
    slens = _lengths(rng, n_requests, suffix_len)
    olens = _lengths(rng, n_requests, output_len)
    return [TraceRequest(i * gap_s, prefix + _prompt(rng, slens[i], vocab_size),
                         int(olens[i])) for i in range(n_requests)]


def shadow_trace(trace: Sequence[TraceRequest], vocab_size: int) -> Trace:
    """Token-remapped copy for jit warmup: the remap is a bijection on
    [1, vocab), so shared-prefix structure (and therefore every admission
    shape: buckets, chunk widths, cache hits) is preserved while no shadow
    prompt ever matches a real one in the prefix cache."""
    delta = max((vocab_size - 1) // 2, 1)
    remap = lambda t: ((t - 1 + delta) % (vocab_size - 1)) + 1
    return [TraceRequest(r.arrival_s, [remap(t) for t in r.prompt],
                         r.max_new_tokens) for r in trace]


def save_trace(path: str, trace: Sequence[TraceRequest]) -> None:
    with open(path, "w") as f:
        for r in trace:
            f.write(json.dumps(r.to_dict()) + "\n")


def load_trace(path: str) -> Trace:
    with open(path) as f:
        return [TraceRequest.from_dict(json.loads(line))
                for line in f if line.strip()]
