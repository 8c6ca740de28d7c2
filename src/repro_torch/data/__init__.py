"""Deterministic, step-indexed synthetic token pipeline (restart-exact).

The port of ``repro.data``. The batch for step ``i`` is a pure function of
``(seed, i)``: no iterator state, no files, so a job that resumes from
step 1000 sees the batches of one that never stopped. Tokens follow a
Zipfian marginal with a Markov bigram shift (the loss falls under
training): each next token is drawn from ``bigram_weight`` times the Zipf
log-probabilities rolled by ``token * shift`` plus the rest times the Zipf
ones. Labels are the next tokens; as JAX's code does (its docstring says
otherwise), no position is masked.

The draws come from a ``torch.Generator`` on the batch's device seeded
from ``(seed, step)``, so a batch is a pure function of ``(seed, step)``
and the device type (the CPU's and the card's generators draw apart), and
the tokens differ from JAX's threefry draws of the same seed: a
divergence by design (ROADMAP queue 3). The distribution is JAX's. On the
card the 2048 dependent draws of a sequence take milliseconds where the
CPU takes seconds.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1
    bigram_weight: float = 0.7    # P(next | cur) mass on the bigram table
    embed_dim: int = 0            # >0: emit frame embeddings (musicgen stub)


def _zipf_logits(vocab: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return np.log(p / p.sum()).astype(np.float32)


#: odd multipliers that spread (seed, step) over a generator seed
_MIX = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9)


def _generator(seed: int, step: int, device) -> torch.Generator:
    mixed = (seed * _MIX[0] + step * _MIX[1] + 1) % (1 << 63)
    return torch.Generator(device).manual_seed(mixed)


def make_batch(cfg: DataConfig, step: int, device="cpu") -> dict:
    """The batch of ``step``, drawn on ``device``: ``{"inputs": (B, S)
    int64, "labels": (B, S) int64}``, labels the next tokens; with
    ``embed_dim``, ``"inputs"`` are the (B, S, D) f32 rows of a fixed
    Gaussian table (seeded ``seed + 2``, drawn on the CPU) and
    ``"token_inputs"`` the ids."""
    dev = torch.device(device)
    gen = _generator(cfg.seed, step, dev)
    zipf = torch.from_numpy(_zipf_logits(cfg.vocab_size,
                                         cfg.zipf_alpha)).to(dev)
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    shift = int(torch.randint(
        1, 97, (), generator=torch.Generator().manual_seed(cfg.seed + 1)))
    tok = torch.multinomial(torch.softmax(zipf, -1).expand(b, v), 1,
                            generator=gen)[:, 0]
    cols = [tok]
    idx = torch.arange(v, device=dev)
    for _ in range(s):
        # the Zipf logits rolled right by token * shift: row t's column c
        # reads zipf[(c - t * shift) mod V], as jnp.roll
        rolled = zipf[(idx[None, :] - (tok[:, None] * shift) % v) % v]
        logits = cfg.bigram_weight * rolled + (1 - cfg.bigram_weight) * zipf
        tok = torch.multinomial(torch.softmax(logits, -1), 1,
                                generator=gen)[:, 0]
        cols.append(tok)
    tokens = torch.stack(cols, dim=1)                       # (B, S + 1)
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    batch = {"inputs": inputs, "labels": labels}
    if cfg.embed_dim:
        table = torch.randn((v, cfg.embed_dim), dtype=torch.float32,
                            generator=torch.Generator().manual_seed(
                                cfg.seed + 2))
        batch["inputs"] = table[inputs.cpu()].to(dev)
        batch["token_inputs"] = inputs
    return batch


def host_slice(batch: dict, process_index: int, process_count: int) -> dict:
    """Each host's slice of the global batch (rows)."""
    def sl(x):
        per = x.shape[0] // process_count
        return x[process_index * per:(process_index + 1) * per]
    return {k: sl(v) for k, v in batch.items()}


class TokenStream:
    """Step-indexed iterator facade over :func:`make_batch`."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, device="cpu"):
        self.cfg = cfg
        self.step = start_step
        self.device = device

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = make_batch(self.cfg, self.step, self.device)
        self.step += 1
        return b
