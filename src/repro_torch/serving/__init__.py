"""Serving: continuous-batching KV-cache engine with per-slot positions.

The port of ``repro.serving.Engine``. A slot table of ``max_batch``
sequences shares ONE KV cache:

* admission is per slot: each request is prefilled alone, right-padded to
  a power-of-two bucket, with a length mask picking the last real token's
  logits (a model with a recurrent layer prefills at the exact prompt
  length instead: its state would consume the pads), and its cache rows (every leaf: a local layer's ring and its
  position side-car, MLA's latent ``c`` and rope key ``kr``) are copied
  into the slot;
* decode runs one step for the whole slot table with a per-slot position
  vector ``pos: (B,)``, so sequences of different depths coexist; a dead
  slot decodes a pad token at position 0 and its output is discarded;
* a finished slot (EOS / token budget / context full) is refilled from the
  FIFO queue at the next step;
* ``EngineStats`` counts throughput and per-request latency;
* ``fused=True`` runs prefill and decode under ``nn.fuse()``: the fused
  add+norm, SwiGLU or GeGLU, rope and decode-attention operators. The switch is
  process-global, so the engine sets it around its own model calls only;
* ``greedy=False`` samples each token from the softmax of its logits with
  a ``torch.Generator`` seeded by ``seed`` on the engine's device (torch
  cannot replay ``jax.random.categorical``'s stream: the same
  distribution, other draws);
* admission prefills through :func:`make_prefill_step` and the decode
  step is built once by :func:`make_serve_step`, the ports of JAX's jitted
  steps, and on the card it runs as a CUDA graph
  (``cuda_graph=``, ``serving/cuda_graph.py``): warmed up eagerly and
  captured at the first decode, replayed at every later one. Prefill,
  admission and chunked ``lm_extend`` stay eager: their shapes and the
  host-int ``start`` vary.

Where the JAX engine casts f32 params to the activation dtype inside every
jitted step, this eager engine casts once, at construction, by the same
rule. The card runs asynchronously, so the engine synchronises it before
every clock read, where the JAX engine blocks on its results. The request
timeline reads the injected ``clock`` at the points the JAX engine does;
the phase totals (``prefill_s``, ``decode_s``) read ``time.perf_counter``.

``PagedEngine`` (``serving/paged.py``) pages the same engine's KV cache
into blocks, with a prefix cache and chunked prefill.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import nn
from repro_torch.models import init_lm_cache, lm_decode, lm_prefill
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import check_supported
from repro_torch.serving.cuda_graph import StepGraph


def cast_params(params, dtype: torch.dtype):
    """Working copy: f32 tensors of rank >= 2 in ``dtype``, the rest as is
    (``repro.runtime.cast_params``'s rule)."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [cast_params(v, dtype) for v in params]
    if params.dtype == torch.float32 and params.dim() >= 2:
        return params.to(dtype)
    return params


def _next_or_logits(logits: torch.Tensor, greedy: bool) -> torch.Tensor:
    """A decode step's result: the (B,) argmax tokens, or the (B, V) logits
    the caller samples from."""
    return torch.argmax(logits.float(), dim=-1) if greedy else logits


def make_prefill_step(cfg: ModelConfig, max_len: int,
                      fused: bool = False) -> Callable:
    """prefill_step(params, tokens, lengths=None) -> (last_logits, caches).

    The port of ``repro.serving.make_prefill_step``: ``lm_prefill`` of a
    batch under ``nn.fuse(fused)`` into fresh caches of depth ``max_len``.
    ``tokens`` are (B, S) ids, or (B, S, d_model) frame embeddings for an
    ``input_mode == "embeddings"`` config (musicgen-large's EnCodec
    frames), right-padded with ``lengths`` (B,) the true lengths: the
    logits are each row's at its last real position. ``params`` is the
    working copy (``cast_params``), as for :func:`make_serve_step`; there
    is no ``mesh``: the port serves on one device.
    """
    def prefill_step(params, tokens, lengths=None):
        with nn.fuse(fused):
            return lm_prefill(params, tokens, cfg, max_len=max_len,
                              lengths=lengths)
    return prefill_step


def make_serve_step(cfg: ModelConfig, greedy: bool = True,
                    fused: bool = False) -> Callable:
    """serve_step(params, token, pos, caches) -> (token' or logits, caches).

    The port of ``repro.serving.make_serve_step``: one ``lm_decode`` of the
    slot table under ``nn.fuse(fused)``, ``pos`` a scalar or a per-slot
    ``(B,)`` vector; ``token`` (B,) ids or, for an ``input_mode ==
    "embeddings"`` config, (B, d_model) frames. The caches are updated in
    place
    (``nn.kv_cache_update``), where the JAX engine donates them. With
    ``greedy`` the step ends in the argmax and returns (B,) int64 tokens;
    otherwise it returns the (B, V) logits and the caller draws from them
    with its own generator (JAX draws inside the step, from a key), so a
    step captured as a CUDA graph and the eager step draw alike. ``params``
    is the working copy (``cast_params``): the engine casts once where JAX
    casts inside every step.
    """
    def serve_step(params, token, pos, caches):
        with nn.fuse(fused):
            logits, caches = lm_decode(params, token, pos, caches, cfg)
        return _next_or_logits(logits, greedy), caches
    return serve_step


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 32
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # wall-clock timeline (engine clock; seconds)
    enqueue_t: float = 0.0
    admit_t: float = 0.0
    first_token_t: float = 0.0
    finish_t: float = 0.0

    @property
    def queue_wait_s(self) -> float:
        return max(self.admit_t - self.enqueue_t, 0.0)

    @property
    def ttft_s(self) -> float:
        """Time-to-first-token: enqueue -> first (prefill-argmax) token."""
        return max(self.first_token_t - self.enqueue_t, 0.0)

    @property
    def decode_tokens(self) -> int:
        """Tokens emitted by decode steps (everything after the first)."""
        return max(len(self.output) - 1, 0)

    @property
    def decode_tok_latency_s(self) -> float:
        """Mean wall time per emitted decode token for this request."""
        n = self.decode_tokens
        return (self.finish_t - self.first_token_t) / n if n else 0.0


@dataclasses.dataclass
class EngineStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    prefill_tokens: int = 0           # real (unpadded) prompt tokens
    decode_tokens: int = 0            # tokens emitted by decode steps
    first_tokens: int = 0             # tokens emitted by prefill argmax
    decode_steps: int = 0             # decode dispatches
    completed: int = 0                # finished requests
    decoded_requests: int = 0         # completed requests that decoded > 0
    ttft_sum_s: float = 0.0
    queue_wait_sum_s: float = 0.0
    decode_tok_latency_sum_s: float = 0.0   # sum of per-request means

    @property
    def decode_tok_per_s(self) -> float:
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0

    @property
    def emitted_tokens(self) -> int:
        return self.first_tokens + self.decode_tokens

    @property
    def mean_ttft_s(self) -> float:
        return self.ttft_sum_s / self.completed if self.completed else 0.0

    @property
    def mean_queue_wait_s(self) -> float:
        return self.queue_wait_sum_s / self.completed if self.completed \
            else 0.0

    @property
    def mean_decode_tok_latency_s(self) -> float:
        """Mean of per-request per-token decode latency, over the requests
        that emitted decode tokens."""
        return self.decode_tok_latency_sum_s / self.decoded_requests \
            if self.decoded_requests else 0.0


#: token written into dead slots and prefill padding
PAD_ID = 0
#: smallest prefill bucket (prompts are right-padded to a power of two)
MIN_PREFILL_BUCKET = 8


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class Engine:
    """Continuous-batching serving engine over one shared KV cache.

    Runs on the device ``params`` live on: the hand-written kernels on the
    card, the plain PyTorch versions on the CPU (``repro_torch.nn``'s
    default backend).

    ``cuda_graph``: ``None`` runs the decode step as a CUDA graph on the
    card and eagerly on the CPU; ``False`` runs it eagerly (the counterpart
    of the JAX engine under ``jax.disable_jit()``, what the graph is held
    against); ``True`` on the CPU raises. A capture or replay that fails
    raises: nothing falls back to the eager step.

    Prompts are token ids: a config that takes frame embeddings
    (``input_mode == "embeddings"``, musicgen-large) raises, as JAX's
    ``launch/serve.py`` does; such a model is served through
    :func:`make_prefill_step` and :func:`make_serve_step`.
    """

    def __init__(self, cfg: ModelConfig, params, max_batch: int = 8,
                 max_len: int = 512, eos_id: Optional[int] = None,
                 greedy: bool = True, pad_id: int = PAD_ID, seed: int = 0,
                 min_prefill_bucket: int = MIN_PREFILL_BUCKET,
                 fused: bool = False,
                 clock: Callable[[], float] = time.perf_counter,
                 cuda_graph: Optional[bool] = None):
        check_supported(cfg, serving=True)      # an encoder raises first
        if cfg.input_mode != "tokens":
            raise ValueError(
                f"{cfg.name} takes frame embeddings (input_mode="
                f"{cfg.input_mode!r}); the engines serve token prompts: use "
                "make_prefill_step and make_serve_step")
        self.cfg = cfg
        self.fused = fused
        self.device = params["final_norm"]["scale"].device
        on_card = self.device.type == "cuda"
        if cuda_graph and not on_card:
            raise ValueError(f"cuda_graph=True needs the params on a CUDA "
                             f"device, not {self.device}")
        self.cuda_graph = on_card if cuda_graph is None else cuda_graph
        self._run_step: Optional[Callable] = None     # built at the first decode
        self.params = cast_params(params, cfg.activation_dtype)
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.greedy = greedy
        self.min_prefill_bucket = min_prefill_bucket
        self._prefill = make_prefill_step(cfg, max_len, fused=fused)
        self._gen = torch.Generator(self.device).manual_seed(seed)
        self._clock = clock
        self.queue: List[Request] = []
        self.stats = EngineStats()
        self._uid = 0
        # a recurrent prefill folds every input token, pads included, into
        # its running state, so bucketed right-padding would corrupt it:
        # such a model prefills at the exact prompt length
        self._pad_safe = not (set(cfg.layer_kinds())
                              & {"rec", "mlstm", "slstm"})
        # slot table
        self.slots: List[Optional[Request]] = [None] * max_batch
        self._pos = np.zeros((max_batch,), np.int32)
        self._cur = np.full((max_batch,), pad_id, np.int32)
        self._caches = self._new_caches()

    def _new_caches(self):
        """The shared (max_batch, max_len, ...) KV cache of the slots."""
        return init_lm_cache(self.cfg, self.max_batch, self.max_len,
                             device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def clock(self) -> float:
        """The injected clock, read after the card has finished its queued
        work."""
        self._sync()
        return self._clock()

    def _timer(self) -> float:
        """``time.perf_counter`` after a synchronize: the phase totals."""
        self._sync()
        return time.perf_counter()

    def _sample(self, logits) -> torch.Tensor:
        """(B, V) logits -> (B,) tokens: the argmax, or a draw from the
        softmax (``greedy=False``)."""
        lf = logits.float()
        if self.greedy:
            return torch.argmax(lf, dim=-1)
        return torch.multinomial(torch.softmax(lf, dim=-1), 1,
                                 generator=self._gen)[:, 0]

    def _first_token(self, logits) -> int:
        return int(self._sample(logits)[0])

    # -- queue -------------------------------------------------------------
    def add_request(self, prompt: Sequence[int],
                    max_new_tokens: int = 32) -> int:
        prompt = list(prompt)
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > self.max_len:
            raise ValueError(f"prompt length {len(prompt)} exceeds "
                             f"max_len={self.max_len}")
        self._uid += 1
        req = Request(self._uid, prompt, max_new_tokens,
                      enqueue_t=self.clock())
        self.queue.append(req)
        return self._uid

    # -- admission ---------------------------------------------------------
    def _bucket(self, plen: int) -> int:
        if not self._pad_safe:
            return plen
        return min(_next_pow2(max(plen, self.min_prefill_bucket)), self.max_len)

    def _admit(self, slot: int, req: Request) -> bool:
        """Prefill ``req`` alone and copy its cache rows into ``slot``.

        Returns True if the slot is now occupied (False when the request
        completed at admission: single-token budget or immediate EOS).
        """
        if req.admit_t == 0.0:
            req.admit_t = self.clock()      # first admission only
        return self._admit_whole(slot, req)

    def _live(self, req: Request, first: int) -> bool:
        """Whether a request decodes on after its first token."""
        return not ((self.eos_id is not None and first == self.eos_id)
                    or req.max_new_tokens <= 1
                    or len(req.prompt) >= self.max_len)

    def _admit_whole(self, slot: int, req: Request) -> bool:
        """The whole prompt in one prefill, right-padded to its bucket; a
        live request's cache rows go to the slot (``_store``), charged to
        prefill."""
        plen = len(req.prompt)
        bucket = self._bucket(plen)
        toks = np.full((1, bucket), self.pad_id, np.int64)
        toks[0, :plen] = req.prompt          # right-padded
        t0 = self._timer()
        logits, one = self._prefill(
            self.params, torch.from_numpy(toks).to(self.device),
            torch.tensor([plen], dtype=torch.int32, device=self.device))
        first = self._first_token(logits)
        live = self._live(req, first)
        if live:
            self._store(slot, req, one, bucket)
        self.stats.prefill_s += self._timer() - t0
        self.stats.prefill_tokens += plen

        req.output.append(first)
        self.stats.first_tokens += 1
        req.first_token_t = self.clock()
        if not live:
            self._finish(req)
            return False
        self.slots[slot] = req
        self._pos[slot] = plen               # next write index == prompt end
        self._cur[slot] = first
        return True

    def _store(self, slot: int, req: Request, one: List[dict],
               bucket: int) -> None:
        """Copy every leaf of the single-row caches into the slot (a
        ring's "pos" side-car included)."""
        for shared, c in zip(self._caches, one):
            for name, t in c.items():
                shared[name][slot] = t[0]

    def _admit_free_slots(self) -> List[Request]:
        """Fill every free slot from the queue; returns requests that
        completed at admission time."""
        done: List[Request] = []
        for i in range(self.max_batch):
            while self.queue and self.slots[i] is None:
                req = self.queue.pop(0)
                if not self._admit(i, req):
                    done.append(req)
        return done

    def _finish(self, req: Request) -> None:
        req.done = True
        req.finish_t = self.clock()
        s = self.stats
        s.completed += 1
        s.ttft_sum_s += req.ttft_s
        s.queue_wait_sum_s += req.queue_wait_s
        if req.decode_tokens:
            s.decoded_requests += 1
            s.decode_tok_latency_sum_s += req.decode_tok_latency_s

    def _free(self, slot: int) -> None:
        self.slots[slot] = None
        self._pos[slot] = 0
        self._cur[slot] = self.pad_id

    def reset_stats(self) -> None:
        """Zero the accounting (after warm-up runs): load drivers prime the
        engine with dummy requests, then measure cleanly."""
        self.stats = EngineStats()

    # -- the decode step ---------------------------------------------------
    def _decode_step(self) -> Callable:
        """The step over its device inputs (:meth:`_decode_inputs`): the
        slot table's next tokens, or its logits (``greedy=False``). It
        closes over the params and the cache, never over the engine, so a
        captured graph does not keep a deleted engine alive."""
        step = make_serve_step(self.cfg, greedy=self.greedy, fused=self.fused)
        params, caches = self.params, self._caches
        return lambda token, pos: step(params, token, pos, caches)[0]

    def _decode_inputs(self) -> List[np.ndarray]:
        """The host arrays the step reads: tokens and per-slot positions."""
        return [self._cur.astype(np.int64), self._pos]

    def _decode(self) -> np.ndarray:
        """One decode step of the whole slot table -> (B,) next tokens on
        the host. A graph engine's first call warms the step up and
        captures it (:class:`StepGraph`); later calls replay it."""
        inputs = self._decode_inputs()
        if self._run_step is None:
            step, dev = self._decode_step(), self.device
            self._run_step = StepGraph(step, inputs, dev) if self.cuda_graph \
                else lambda *a: step(*(torch.from_numpy(x).to(dev) for x in a))
        out = self._run_step(*inputs)
        if not self.greedy:
            out = self._sample(out)
        return out.cpu().numpy()

    # -- stepping ----------------------------------------------------------
    @property
    def active(self) -> int:
        return sum(r is not None for r in self.slots)

    def step(self) -> List[Request]:
        """One engine iteration: admit, decode one token per live slot,
        retire finished slots. Returns the requests finished in this call."""
        finished = self._admit_free_slots()
        if any(r is not None and self._pos[i] >= self.max_len
               for i, r in enumerate(self.slots)):
            raise RuntimeError("a live slot has no room for its next KV write")
        if self.active == 0:
            return finished

        t0 = self._timer()
        nxt_host = self._decode()
        self.stats.decode_s += self._timer() - t0
        self.stats.decode_steps += 1

        for i, r in enumerate(self.slots):
            if r is None:
                continue            # pad-fed dead slot: output discarded
            tok = int(nxt_host[i])
            r.output.append(tok)
            self.stats.decode_tokens += 1    # counted where emitted
            self._pos[i] += 1
            self._cur[i] = tok
            if (self.eos_id is not None and tok == self.eos_id) \
                    or len(r.output) >= r.max_new_tokens \
                    or self._pos[i] >= self.max_len:
                self._finish(r)
                finished.append(r)
                self._free(i)
        return finished

    def run(self) -> List[Request]:
        """Serve until the queue and the slot table are empty; returns the
        completed requests in completion order."""
        finished: List[Request] = []
        while self.queue or self.active:
            finished.extend(self.step())
        return finished


from repro_torch.serving.paged import (BlockAllocator, PagedEngine,  # noqa: E402
                                       PrefixCache, make_paged_decode_step,
                                       make_paged_extend_step)

__all__ = ["Engine", "EngineStats", "Request", "cast_params",
           "make_prefill_step", "make_serve_step", "BlockAllocator",
           "PagedEngine", "PrefixCache", "make_paged_decode_step",
           "make_paged_extend_step"]
