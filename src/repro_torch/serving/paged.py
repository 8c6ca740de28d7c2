"""Paged-KV serving: block allocator, prefix cache, chunked prefill.

The port of ``repro.serving.paged`` on one device. ``PagedEngine``
replaces the contiguous ``Engine``'s single ``(max_batch, max_len, ...)``
KV cache with a pool of fixed-size KV blocks (``(num_blocks, block_size,
...)`` per layer and leaf) managed by a free-list :class:`BlockAllocator`
and addressed through per-sequence block tables: the vLLM paging scheme,
append-only, so no copy-on-write is ever needed.

Three mechanisms ride on the block tables:

* **paged decode**: every step gathers each sequence's blocks into a
  contiguous ``(B, max_len, ...)`` view (``nn.paged_kv_gather``), runs the
  UNCHANGED ``lm_decode`` on it, then writes each sequence's one new KV row
  back into its block (``nn.paged_kv_write``). Stale rows in the view lie
  past each row's ``pos + 1`` valid keys, the same lengths the contiguous
  engine's decode reads, which is what makes paged decode bit-identical to
  it; under ``fused=True`` the decode attention is ``decode_core`` over
  the gathered view;
* **prefix cache**: full prompt blocks are registered in a hash-chain
  keyed :class:`PrefixCache`; later prompts sharing the prefix re-point
  their table at the cached blocks and prefill only the suffix. Shared
  blocks are protected by refcounts and by the scatter guard (``lo``) that
  diverts any overlapping write to the scratch block;
* **chunked prefill**: long prompts (and prefix hits) admit as a sequence
  of decode-interleaved ``lm_extend`` chunks, one chunk per engine step,
  each attending the full cached depth at its absolute offset (the causal
  ``attention_core`` at ``q_offset = start`` on the card).

Block 0 is reserved as a scratch block: unallocated table entries point at
it, so cache writes from dead or still-prefilling slots land harmlessly in
rows that no unmasked read ever consumes.

The JAX engine's tensor-parallel steps (``mesh=`` with a ``model`` axis
above 1) are not ported yet: a ``mesh`` raises ``NotImplementedError``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import nn
from repro_torch.models import init_lm_cache, lm_decode, lm_extend
from repro_torch.models.common import ModelConfig
from repro_torch.serving import Engine, Request, _next_pow2


# ---------------------------------------------------------------------------
# block allocator + prefix cache (host-side bookkeeping)
# ---------------------------------------------------------------------------

class BlockAllocator:
    """Free-list allocator over a fixed pool of KV blocks with refcounts.

    Block 0 is reserved as the scratch block (never handed out): zeroed
    block-table entries alias it, so writes from slots that own no block
    at that position divert there instead of corrupting a neighbour.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is reserved)")
        if block_size < 1:
            raise ValueError("block_size must be positive")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # pop() yields ascending ids: deterministic tables for replay
        self._free = list(range(num_blocks - 1, 0, -1))
        self.refcount: Dict[int, int] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def try_allocate(self) -> Optional[int]:
        """Take one free block (refcount 1), or None when exhausted."""
        if not self._free:
            return None
        bid = self._free.pop()
        self.refcount[bid] = 1
        return bid

    def allocate(self, n: int = 1) -> List[int]:
        if self.free_blocks < n:
            raise RuntimeError(
                f"paged KV pool exhausted: need {n} blocks, "
                f"{self.free_blocks} free of {self.num_blocks}")
        return [self.try_allocate() for _ in range(n)]

    def incref(self, bid: int) -> None:
        self.refcount[bid] += 1

    def decref(self, bid: int) -> None:
        rc = self.refcount[bid] - 1
        if rc == 0:
            del self.refcount[bid]
            self._free.append(bid)
        else:
            self.refcount[bid] = rc


class PrefixCache:
    """Hash-chain keyed map from full prompt-prefix blocks to pool blocks.

    Key ``i`` is ``hash((key_{i-1}, tokens_of_block_i))``: two prompts
    share key ``i`` iff their first ``(i+1) * block_size`` tokens agree.
    The cache holds one refcount on every registered block; ``evict_one``
    drops the least-recently-used entry nobody else references.
    """

    def __init__(self, allocator: BlockAllocator):
        self.allocator = allocator
        self._entries: "OrderedDict[int, int]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def _chain_keys(self, prompt):
        bs = self.allocator.block_size
        key = 0
        for i in range(len(prompt) // bs):
            key = hash((key, tuple(prompt[i * bs:(i + 1) * bs])))
            yield key

    def lookup(self, prompt) -> Tuple[int, List[int]]:
        """-> (cached_len, blocks); increfs every returned block.

        Reuse is capped at ``(len(prompt) - 1) // block_size`` blocks, so
        at least one suffix token always prefills (the first output token
        needs a forward pass over real query positions).
        """
        bs = self.allocator.block_size
        max_reuse = (len(prompt) - 1) // bs
        blocks: List[int] = []
        for i, key in enumerate(self._chain_keys(prompt)):
            if i >= max_reuse:
                break
            bid = self._entries.get(key)
            if bid is None:
                break
            self._entries.move_to_end(key)
            blocks.append(bid)
        for bid in blocks:
            self.allocator.incref(bid)
        if blocks:
            self.hits += 1
        else:
            self.misses += 1
        return len(blocks) * bs, blocks

    def insert(self, prompt, blocks: List[int]) -> None:
        """Register the prompt's full blocks (once its KV is written).
        Existing entries win: a concurrent admission of the same prefix
        keeps the first registered block."""
        for i, key in enumerate(self._chain_keys(prompt)):
            if key not in self._entries:
                self._entries[key] = blocks[i]
                self.allocator.incref(blocks[i])

    def evict_one(self) -> bool:
        """Drop the LRU entry whose block only the cache still references."""
        for key, bid in self._entries.items():
            if self.allocator.refcount.get(bid, 0) == 1:
                del self._entries[key]
                self.allocator.decref(bid)
                return True
        return False

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def reset_counters(self) -> None:
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class PagedEngine(Engine):
    """Continuous-batching engine over paged KV blocks (vLLM-style).

    Admission paths:

    * cold prompt, no chunking: the parent's whole-prompt prefill runs
      (first-token parity with the contiguous engine), then its single-row
      cache is scattered into blocks (``nn.paged_kv_scatter``, rows past
      the prompt to scratch);
    * prefix hit or long prompt: decode-interleaved ``lm_extend`` chunks,
      one chunk per engine step, the batch decoding in between.

    Only full-depth positional caches page, so every layer must be plain
    global attention (``"attn"``): gemma3-27b's ``local`` rings raise.
    Pools live on the params' device. ``cold_prefills`` and
    ``extend_chunks`` count the two admission programs run since the last
    ``reset_stats()``.
    """

    def __init__(self, cfg: ModelConfig, params, max_batch: int = 8,
                 max_len: int = 512, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 chunk_size: Optional[int] = None,
                 prefix_caching: bool = True, mesh=None, **kw):
        if mesh is not None:
            raise NotImplementedError(
                "PagedEngine: tensor-parallel serving (mesh=) is not ported "
                "yet; the port serves on one device")
        bad = set(cfg.layer_kinds()) - {"attn"}
        if bad:
            raise ValueError(
                f"PagedEngine needs full-depth positional caches on every "
                f"layer; kinds {sorted(bad)} cannot page")
        super().__init__(cfg, params, max_batch=max_batch, max_len=max_len,
                         **kw)
        self.block_size = block_size
        self.blocks_per_seq = -(-max_len // block_size)
        if num_blocks is None:
            # every slot's worst case + slack for the prefix cache + scratch
            num_blocks = 1 + (max_batch + 2) * self.blocks_per_seq
        self.allocator = BlockAllocator(num_blocks, block_size)
        self.prefix_cache = PrefixCache(self.allocator) \
            if prefix_caching else None
        self.chunk_size = chunk_size
        self._pools = init_lm_cache(cfg, num_blocks, block_size,
                                    device=self.device)
        self._tables = np.zeros((max_batch, self.blocks_per_seq), np.int32)
        self._seq_blocks: List[List[int]] = [[] for _ in range(max_batch)]
        self._prefilling: Dict[int, dict] = {}
        self.cold_prefills = 0
        self.extend_chunks = 0

    def _new_caches(self):
        return None             # the pools below take the contiguous cache's place

    # -- the paged programs: gather view -> unchanged model -> write back --
    def _gather(self, tables: torch.Tensor) -> List[dict]:
        """The contiguous (B, max_len, ...) view of every layer's pools."""
        return [{n: nn.paged_kv_gather(p, tables, self.max_len)
                 for n, p in pool.items()} for pool in self._pools]

    def _scatter(self, caches: List[dict], row: torch.Tensor, start: int,
                 width: int, lo: int, hi: int) -> None:
        """Rows [start, start + width) of a B=1 cache view into one
        sequence's blocks; positions outside [lo, hi) go to scratch."""
        for pool, c in zip(self._pools, caches):
            for n, p in pool.items():
                nn.paged_kv_scatter(p, c[n][0, start:start + width], row,
                                    start, lo, hi)

    # -- bookkeeping -------------------------------------------------------
    def _allocate(self, n: int) -> List[int]:
        out: List[int] = []
        for _ in range(n):
            bid = self.allocator.try_allocate()
            while bid is None and self.prefix_cache is not None \
                    and self.prefix_cache.evict_one():
                bid = self.allocator.try_allocate()
            if bid is None:
                raise RuntimeError(
                    "paged KV pool exhausted (and nothing evictable); "
                    "raise num_blocks or lower max_batch")
            out.append(bid)
        return out

    def _ensure_block(self, slot: int) -> None:
        """Guarantee the block for this slot's next KV write exists."""
        need = int(self._pos[slot]) // self.block_size
        blocks = self._seq_blocks[slot]
        while len(blocks) <= need:
            bid = self._allocate(1)[0]
            blocks.append(bid)
            self._tables[slot, len(blocks) - 1] = bid

    def _free(self, slot: int) -> None:
        for bid in self._seq_blocks[slot]:
            self.allocator.decref(bid)
        self._seq_blocks[slot] = []
        self._tables[slot, :] = 0
        super()._free(slot)

    def reset_stats(self) -> None:
        super().reset_stats()
        self.cold_prefills = 0
        self.extend_chunks = 0
        if self.prefix_cache is not None:
            self.prefix_cache.reset_counters()

    # -- admission ---------------------------------------------------------
    def _admit(self, slot: int, req: Request) -> bool:
        if req.admit_t == 0.0:
            req.admit_t = self.clock()
        plen = len(req.prompt)
        cached_len, reused = 0, []
        if self.prefix_cache is not None:
            cached_len, reused = self.prefix_cache.lookup(req.prompt)
        if cached_len == 0 and (self.chunk_size is None
                                or plen <= self.chunk_size):
            self.cold_prefills += 1
            return self._admit_whole(slot, req)
        return self._start_chunked(slot, req, cached_len, reused)

    def _store(self, slot: int, req: Request, one: List[dict],
               bucket: int) -> None:
        """A cold prefill's rows [0, bucket) into fresh blocks (the pad rows
        past the prompt to scratch); the prompt's full blocks into the
        prefix cache."""
        plen = len(req.prompt)
        blocks = self._allocate(-(-plen // self.block_size))
        self._seq_blocks[slot] = blocks
        self._tables[slot, :] = 0
        self._tables[slot, :len(blocks)] = blocks
        row = torch.from_numpy(self._tables[slot]).to(self.device)
        self._scatter(one, row, 0, bucket, 0, plen)
        if self.prefix_cache is not None:
            self.prefix_cache.insert(req.prompt, blocks)

    def _chunk_plan(self, cached: int, plen: int) -> List[Tuple[int, int]]:
        """-> [(start, width)] covering [cached, plen); never overlaps the
        cached prefix and never overruns max_len."""
        if self.chunk_size is None:
            rem = plen - cached
            w = min(_next_pow2(max(rem, self.min_prefill_bucket)),
                    self.max_len)
            if cached + w > self.max_len:
                w = rem                 # exact width near the context edge
            return [(cached, w)]
        chunks: List[Tuple[int, int]] = []
        pos = cached
        while pos < plen:
            w = self.chunk_size if pos + self.chunk_size <= self.max_len \
                else plen - pos
            chunks.append((pos, w))
            pos += w
        return chunks

    def _start_chunked(self, slot: int, req: Request, cached_len: int,
                       reused: List[int]) -> bool:
        """Begin a decode-interleaved chunked admission (prefix hits land
        here too: only the uncached suffix prefills)."""
        plen = len(req.prompt)
        blocks = list(reused)
        blocks += self._allocate(-(-plen // self.block_size) - len(blocks))
        row = np.zeros((self.blocks_per_seq,), np.int32)
        row[:len(blocks)] = blocks
        self._prefilling[slot] = {
            "req": req, "plen": plen, "cached": cached_len,
            "row": torch.from_numpy(row).to(self.device), "blocks": blocks,
            "chunks": self._chunk_plan(cached_len, plen), "next": 0,
        }
        # occupy the slot, but keep its table row zeroed: batch decode
        # treats it as dead (pad token, pos 0, writes to scratch) until the
        # last chunk lands
        self.slots[slot] = req
        self._seq_blocks[slot] = blocks
        self._pos[slot] = 0
        self._cur[slot] = self.pad_id
        return True

    def _prefill_chunk(self, slot: int) -> Optional[Request]:
        """Run ONE chunk for a prefilling slot; on the last chunk, emit the
        first token and promote the slot to decoding (or finish it).
        Returns the request if it completed at admission."""
        st = self._prefilling[slot]
        req: Request = st["req"]
        plen: int = st["plen"]
        start, w = st["chunks"][st["next"]]
        toks = np.full((1, w), self.pad_id, np.int64)
        real = req.prompt[start:min(start + w, plen)]
        toks[0, :len(real)] = real
        t0 = self._timer()
        with nn.fuse(self.fused):
            caches = self._gather(st["row"][None])
            logits, caches = lm_extend(
                self.params, torch.from_numpy(toks).to(self.device), start,
                caches, self.cfg)
            self._scatter(caches, st["row"], start, w, st["cached"], plen)
        self.extend_chunks += 1
        st["next"] += 1
        if st["next"] < len(st["chunks"]):
            self.stats.prefill_s += self._timer() - t0
            return None

        # last chunk: the prompt's final real token sits at row plen-1-start
        first = self._first_token(logits[:, plen - 1 - start])
        self.stats.prefill_s += self._timer() - t0
        self.stats.prefill_tokens += plen
        del self._prefilling[slot]

        req.output.append(first)
        self.stats.first_tokens += 1
        req.first_token_t = self.clock()
        if self.prefix_cache is not None:
            self.prefix_cache.insert(req.prompt, st["blocks"])
        if not self._live(req, first):
            self._finish(req)
            self._free(slot)
            return req
        self._tables[slot, :] = 0
        self._tables[slot, :len(st["blocks"])] = st["blocks"]
        self._pos[slot] = plen
        self._cur[slot] = first
        return None

    # -- stepping ----------------------------------------------------------
    def step(self) -> List[Request]:
        finished = self._admit_free_slots()

        # one chunk per prefilling slot per step (decode-interleaved)
        for slot in list(self._prefilling):
            done = self._prefill_chunk(slot)
            if done is not None:
                finished.append(done)

        live = [i for i, r in enumerate(self.slots)
                if r is not None and i not in self._prefilling]
        if not live:
            return finished
        for i in live:
            if self._pos[i] >= self.max_len:
                raise RuntimeError("a live slot has no room for its next KV "
                                   "write")
            self._ensure_block(i)

        t0 = self._timer()
        dev = self.device
        tables = torch.from_numpy(self._tables).to(dev)
        pos = torch.from_numpy(self._pos).to(dev)
        with nn.fuse(self.fused):
            caches = self._gather(tables)
            logits, caches = lm_decode(
                self.params, torch.from_numpy(self._cur.astype(np.int64)).to(dev),
                pos, caches, self.cfg)
            rows = torch.arange(self.max_batch, device=dev)
            at = pos.long()
            for pool, c in zip(self._pools, caches):
                for n, p in pool.items():
                    nn.paged_kv_write(p, c[n][rows, at][:, None], tables, pos)
        nxt_host = self._sample(logits).cpu().numpy()
        self.stats.decode_s += self._timer() - t0
        self.stats.decode_steps += 1

        for i in live:
            r = self.slots[i]
            tok = int(nxt_host[i])
            r.output.append(tok)
            self.stats.decode_tokens += 1
            self._pos[i] += 1
            self._cur[i] = tok
            if (self.eos_id is not None and tok == self.eos_id) \
                    or len(r.output) >= r.max_new_tokens \
                    or self._pos[i] >= self.max_len:
                self._finish(r)
                finished.append(r)
                self._free(i)
        return finished


__all__ = ["BlockAllocator", "PagedEngine", "PrefixCache"]
