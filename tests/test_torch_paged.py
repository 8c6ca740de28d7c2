"""The port's paged serving path against the JAX package, on the same
weights: bridged ``reduced(granite-3-8b)`` (RMSNorm, tied, cut to 2
layers as ``tests/test_paged_serving.py`` cuts it) and
``reduced(stablelm-3b)`` (LayerNorm, rope on a quarter of each head)
params from the JAX ``init_lm``, f32 on the CPU, each unfused and under
fusion.

Held against JAX: the paged KV ops element for element, ``lm_extend``'s
logits and caches, ``BlockAllocator`` and ``PrefixCache`` driven through
the same operations, and the ``PagedEngine``'s tokens and request
timeline (under an injected clock) on ``test_paged_serving.py``'s request
sets. Inside the port: paged tokens equal to the contiguous ``Engine``'s.
Sampling (``greedy=False``) is held to its distribution: torch cannot
replay ``jax.random.categorical``'s stream.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import nn as jnn  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import init_lm  # noqa: E402
from repro.models import init_lm_cache as jinit_lm_cache  # noqa: E402
from repro.models import lm_extend as jlm_extend  # noqa: E402
from repro.models import lm_prefill as jlm_prefill  # noqa: E402
from repro.serving import BlockAllocator as JBlockAllocator  # noqa: E402
from repro.serving import PagedEngine as JPagedEngine  # noqa: E402
from repro.serving import PrefixCache as JPrefixCache  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import init_lm_cache, lm_extend, lm_prefill  # noqa: E402
from repro_torch.serving import (BlockAllocator, Engine, PagedEngine,  # noqa: E402
                                 PrefixCache)

ARCHS = ["granite-3-8b", "stablelm-3b"]
MODELS = list(itertools.product(ARCHS, [False, True]))
IDS = [f"{a}-{'fused' if f else 'unfused'}" for a, f in MODELS]


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(jax config, port config, JAX params, bridged port params): granite
    cut to 2 layers, as test_paged_serving.py does."""
    cut = dict(n_layers=2, loss_chunk=0) if arch == "granite-3-8b" else {}
    jcfg = jreduced(jget_config(arch)).replace(**cut)
    cfg = reduced(get_config(arch)).replace(**cut)
    jparams = init_lm(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                    cfg, device="cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module", params=MODELS, ids=IDS)
def model(request):
    arch, fused = request.param
    return (*_setup(arch), fused)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- the paged KV ops, element for element ----------------------------------

def _pool(rng, n=7, bs=4, h=2, d=3):
    return rng.standard_normal((n, bs, h, d)).astype(np.float32)


#: (B, nb) block tables: rows that point at scratch block 0, at the same
#: block twice, and a row of nothing but scratch
GATHER_TABLES = [np.array([[1, 2, 3, 4], [5, 0, 0, 0], [0, 0, 0, 0]], np.int32),
                 np.array([[6, 6, 1, 0], [3, 2, 1, 5]], np.int32)]


@pytest.mark.parametrize("max_len", [16, 13, 1])
@pytest.mark.parametrize("table", range(len(GATHER_TABLES)))
def test_paged_kv_gather_equals_jax(table, max_len):
    pool = _pool(np.random.default_rng(0))
    bt = GATHER_TABLES[table]
    want = np.asarray(jref.paged_kv_gather(jnp.asarray(pool), jnp.asarray(bt),
                                           max_len))
    for fn in (ref.paged_kv_gather, tnn.paged_kv_gather):
        got = fn(torch.from_numpy(pool), torch.from_numpy(bt), max_len)
        # contiguous whatever max_len % bs is: decode_core takes it as it is
        assert got.is_contiguous() and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


#: (table (B, nb), positions (B,)): distinct blocks, a dead row at position
#: 0 of scratch, the last slot of the last block
WRITE_CASES = [(np.array([[1, 2, 3], [4, 5, 6]], np.int32), [5, 11]),
               (np.array([[1, 2, 3], [0, 0, 0], [6, 4, 0]], np.int32), [9, 0, 7]),
               (np.array([[3, 1, 0]], np.int32), [0])]


@pytest.mark.parametrize("case", range(len(WRITE_CASES)))
def test_paged_kv_write_equals_jax(case):
    rng = np.random.default_rng(1 + case)
    bt, index = WRITE_CASES[case]
    pool = _pool(rng)
    new = rng.standard_normal((bt.shape[0], 1, 2, 3)).astype(np.float32)
    idx = np.asarray(index, np.int32)
    want = np.asarray(jref.paged_kv_write(jnp.asarray(pool), jnp.asarray(new),
                                          jnp.asarray(bt), jnp.asarray(idx)))
    for fn in (ref.paged_kv_write, tnn.paged_kv_write):
        tp = torch.from_numpy(pool.copy())
        got = fn(tp, torch.from_numpy(new), torch.from_numpy(bt),
                 torch.from_numpy(idx))
        assert got is tp                        # in place
        np.testing.assert_array_equal(got.numpy(), want)


#: (R rows, start, lo, hi, table row): the reused prefix and the padding
#: cutting both ends, rows past the table's last block, every row kept,
#: every row diverted, a row table that points at scratch
SCATTER_CASES = [(10, 3, 5, 11, [2, 4, 6, 1]),
                 (8, 0, 0, 5, [3, 5, 0, 0]),
                 (6, 12, 12, 16, [1, 2, 3, 4]),
                 (16, 0, 0, 16, [4, 1, 6, 2]),
                 (5, 4, 9, 9, [1, 2, 3, 4]),
                 (9, 9, 10, 13, [0, 0, 5, 6])]


@pytest.mark.parametrize("case", SCATTER_CASES)
def test_paged_kv_scatter_equals_jax(case):
    n_rows, start, lo, hi, row = case
    rng = np.random.default_rng(n_rows + start)
    pool = _pool(rng)
    rows = rng.standard_normal((n_rows, 2, 3)).astype(np.float32)
    bt = np.asarray(row, np.int32)
    want = np.asarray(jref.paged_kv_scatter(
        jnp.asarray(pool), jnp.asarray(rows), jnp.asarray(bt), jnp.int32(start),
        jnp.int32(lo), jnp.int32(hi)))
    for fn in (ref.paged_kv_scatter, tnn.paged_kv_scatter):
        got = fn(torch.from_numpy(pool.copy()), torch.from_numpy(rows),
                 torch.from_numpy(bt), start, lo, hi).numpy()
        # scratch block 0 takes repeated writes, any of which may stay
        np.testing.assert_array_equal(got[1:], want[1:])


def test_paged_ops_check_bounds_under_debug_bounds():
    pool = torch.zeros(4, 2, 1, 1)
    with tnn.debug_bounds():
        assert tnn.debug_bounds_enabled()
        with pytest.raises(ValueError, match="block id"):
            tnn.paged_kv_gather(pool, torch.tensor([[1, 4]]), 4)
        with pytest.raises(ValueError, match="position"):
            tnn.paged_kv_write(pool, torch.ones(1, 1, 1, 1),
                               torch.tensor([[1, 2]]), torch.tensor([4]))
        with pytest.raises(ValueError, match="block id"):
            tnn.paged_kv_write(pool, torch.ones(1, 1, 1, 1),
                               torch.tensor([[1, -1]]), torch.tensor([1]))
        with pytest.raises(ValueError, match="kept position"):
            tnn.paged_kv_scatter(pool, torch.ones(3, 1, 1), torch.tensor([1, 2]),
                                 2, 0, 5)
        # in range, and a position past the table diverted to scratch: fine
        tnn.paged_kv_scatter(pool, torch.ones(3, 1, 1), torch.tensor([1, 2]),
                             2, 0, 4)
        assert pool[2].eq(1).all() and not pool[3].any()
    assert not tnn.debug_bounds_enabled()
    with pytest.raises(ValueError, match="max_len"):
        tnn.paged_kv_gather(pool, torch.tensor([[1, 2]]), 5)


# -- BlockAllocator and PrefixCache, driven like test_paged_serving.py -------

def _allocator_trace(Alloc):
    a = Alloc(num_blocks=5, block_size=8)
    out = [a.free_blocks]
    blocks = a.allocate(4)
    out += [blocks, a.free_blocks]
    for b in blocks:
        a.decref(b)
    out.append(a.free_blocks)
    b = a.allocate(1)[0]
    a.incref(b)
    a.decref(b)
    out.append(a.free_blocks)
    a.decref(b)
    out.append(a.free_blocks)
    a = Alloc(num_blocks=3, block_size=8)
    out += [a.allocate(2), a.try_allocate()]
    for call in (lambda: a.allocate(1), lambda: Alloc(num_blocks=1, block_size=8),
                 lambda: Alloc(num_blocks=3, block_size=0)):
        try:
            call()
            out.append(None)
        except (RuntimeError, ValueError) as e:
            out.append(type(e).__name__)
    return out


def _prefix_trace(Alloc, Cache):
    a = Alloc(num_blocks=8, block_size=4)
    c = Cache(a)
    prompt = list(range(1, 13))                    # 12 tokens = 3 blocks
    blocks = a.allocate(3)
    c.insert(prompt, blocks)
    out = [len(c)]
    for b in blocks:
        a.decref(b)
    cached, reused = c.lookup(prompt)              # capped: one suffix token
    out.append((cached, reused))
    for b in reused:
        a.decref(b)
    out.append(c.lookup([99, 98, 97, 96, 95]))
    out.append(c.hit_rate)
    free_before = a.free_blocks
    cached, reused = c.lookup(prompt)              # pins blocks[0:2]
    out += [c.evict_one(), a.free_blocks - free_before, dict(a.refcount)]
    for b in reused:
        a.decref(b)
    out += [c.evict_one(), c.evict_one(), c.evict_one(), len(c), a.free_blocks]
    c.reset_counters()
    out.append((c.hits, c.misses, c.hit_rate))
    # duplicates keep the first registered block
    first = a.allocate(2)
    c.insert(prompt[:8], first)
    c.insert(prompt[:8], a.allocate(2))
    out.append(c.lookup(prompt[:8] + [42, 43, 44, 45]))
    return out


def test_block_allocator_equals_jax():
    assert _allocator_trace(BlockAllocator) == _allocator_trace(JBlockAllocator)


def test_prefix_cache_equals_jax():
    assert _prefix_trace(BlockAllocator, PrefixCache) == \
        _prefix_trace(JBlockAllocator, JPrefixCache)


# -- lm_extend ----------------------------------------------------------------

@pytest.mark.parametrize("port_backend", ["torch", "cuda"])
def test_lm_extend_matches_jax(model, port_backend):
    """Prefill 16 tokens, then two chunks at absolute offsets, the second
    of an odd width: logits within 1e-4 of JAX's, caches within 1e-5."""
    jcfg, cfg, jparams, params, fused = model
    toks = np.random.default_rng(5).integers(1, cfg.vocab_size, (1, 45))
    max_len = 64
    with jnn.backend("jnp"), jnn.fuse(fused):
        _, jc = jlm_prefill(jparams, jnp.asarray(toks[:, :16], jnp.int32), jcfg,
                            max_len=max_len)
    caches = bridge.caches_from_jax(_np(jc), cfg, device="cpu")
    for start, width in ((16, 16), (32, 13)):
        chunk = toks[:, start:start + width]
        with jnn.backend("jnp"), jnn.fuse(fused):
            want, jc = jax.jit(lambda p, t, c, s=start: jlm_extend(
                p, t, s, c, jcfg))(jparams, jnp.asarray(chunk, jnp.int32), jc)
        with tnn.backend(port_backend), tnn.fuse(fused):
            got, caches = lm_extend(params, torch.from_numpy(chunk), start,
                                    caches, cfg)
        assert got.shape == (1, width, cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
        wc = bridge.caches_from_jax(_np(jc), cfg, device="cpu")
        for g, w in zip(caches, wc):
            for key in ("k", "v"):
                np.testing.assert_allclose(g[key].numpy(), w[key].numpy(),
                                           atol=1e-5)


def test_prefill_then_extend_gives_whole_prefill_logits(model):
    jcfg, cfg, jparams, params, fused = model
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        1, cfg.vocab_size, (2, 45)))
    with tnn.fuse(fused):
        want, _ = lm_prefill(params, toks, cfg, max_len=64)
        _, caches = lm_prefill(params, toks[:, :20], cfg, max_len=64)
        for start, width in ((20, 16), (36, 9)):
            got, caches = lm_extend(params, toks[:, start:start + width], start,
                                    caches, cfg)
    np.testing.assert_allclose(got[:, -1].numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_extend_raises_for_a_ring_and_past_the_cache():
    cfg = reduced(get_config("gemma3-27b"))
    params = bridge.params_from_jax(_np(init_lm(jax.random.PRNGKey(0),
                                                jreduced(jget_config("gemma3-27b")))),
                                    cfg, device="cpu")
    caches = init_lm_cache(cfg, 1, 64, device="cpu")
    with pytest.raises(ValueError, match="cannot extend|chunked prefill"):
        lm_extend(params, torch.ones(1, 4, dtype=torch.long), 8, caches, cfg)
    _, cfg, _, params = _setup("stablelm-3b")
    caches = init_lm_cache(cfg, 1, 32, device="cpu")
    with pytest.raises(ValueError, match="outside a cache"):
        lm_extend(params, torch.ones(1, 8, dtype=torch.long), 28, caches, cfg)
    with pytest.raises(TypeError, match="host int"):
        lm_extend(params, torch.ones(1, 8, dtype=torch.long),
                  torch.tensor(4), caches, cfg)


def test_bridge_carries_a_jax_pool_tree():
    jcfg, cfg, _, _ = _setup("stablelm-3b")
    tree = _np(jinit_lm_cache(jcfg, 13, 8))
    pools = bridge.caches_from_jax(tree, cfg, device="cpu")
    want = init_lm_cache(cfg, 13, 8, device="cpu")
    assert len(pools) == len(want) == cfg.n_layers
    for g, w in zip(pools, want):
        assert set(g) == set(w) == {"k", "v"}
        for key in g:
            assert g[key].shape == w[key].shape == (13, 8, cfg.n_kv_heads,
                                                    cfg.resolved_head_dim)
            assert g[key].dtype == w[key].dtype


# -- the PagedEngine against JAX's and the port's contiguous Engine ----------

def _request_set(kind, vocab):
    """test_paged_serving.py's three request sets: (prompt, budget) pairs
    and the engine arguments they run with."""
    if kind == "mixed":
        rng = np.random.RandomState(0)
        return [(rng.randint(1, vocab, size=rng.randint(3, 41)).tolist(),
                 int(rng.randint(2, 9))) for _ in range(8)], {}
    if kind == "chunked":
        rng = np.random.RandomState(1)
        return [(rng.randint(1, vocab, size=n).tolist(), 4)
                for n in (3, 17, 33, 40, 23, 9)], {"chunk_size": 16}
    rng = np.random.RandomState(2)
    prefix = rng.randint(1, vocab, size=24).tolist()
    return [(prefix + rng.randint(1, vocab, size=6).tolist(), 3)
            for _ in range(4)], {"chunk_size": 16}


def _serve(engine, reqs):
    uids = [engine.add_request(p, max_new_tokens=b) for p, b in reqs]
    done = {r.uid: r for r in engine.run()}
    return [done[u] for u in uids]


@pytest.mark.parametrize("kind,max_len", [("mixed", 64), ("chunked", 64),
                                          ("prefix", 64), ("mixed", 60)])
def test_paged_engine_tokens_match_jax_and_contiguous(model, kind, max_len):
    jcfg, cfg, jparams, params, fused = model
    reqs, kw = _request_set(kind, cfg.vocab_size)
    kw = dict(kw, max_batch=3, max_len=max_len, block_size=8, fused=fused)
    with jnn.backend("jnp"):
        jeng = JPagedEngine(jcfg, jparams, **kw)
        want = [r.output for r in _serve(jeng, reqs)]
    eng = PagedEngine(cfg, params, **kw)
    got = [r.output for r in _serve(eng, reqs)]
    contiguous = [r.output for r in _serve(
        Engine(cfg, params, max_batch=3, max_len=max_len, fused=fused), reqs)]
    assert not tnn.fusion_enabled()
    assert got == want == contiguous
    assert [len(o) for o in got] == [b for _, b in reqs]
    assert eng.prefix_cache.hit_rate == jeng.prefix_cache.hit_rate
    if kind == "prefix":
        assert eng.prefix_cache.hit_rate > 0
    # every block came back, to the free list or the prefix cache
    assert eng.allocator.free_blocks + len(eng.prefix_cache) == \
        eng.allocator.num_blocks - 1
    assert eng.stats.first_tokens == len(reqs)
    assert (eng.extend_chunks > 0) == (eng.cold_prefills < len(reqs))


def test_paged_engine_counts_its_admission_programs():
    _, cfg, _, params = _setup("granite-3-8b")
    reqs, kw = _request_set("chunked", cfg.vocab_size)
    eng = PagedEngine(cfg, params, max_batch=3, max_len=64, block_size=8,
                      prefix_caching=False, **kw)
    _serve(eng, reqs)
    # prompts of 3 and 9 tokens admit cold; 17, 33, 40, 23 in 2, 3, 3, 2
    # chunks of 16
    assert (eng.cold_prefills, eng.extend_chunks) == (2, 10)
    assert eng.allocator.free_blocks == eng.allocator.num_blocks - 1
    eng.reset_stats()
    assert (eng.cold_prefills, eng.extend_chunks) == (0, 0)
    assert eng.stats.completed == 0


def test_paged_eos_frees_blocks_for_refill():
    _, cfg, _, params = _setup("stablelm-3b")

    def mk(**kw):
        return PagedEngine(cfg, params, max_len=64, block_size=8, **kw)
    eos = _serve(mk(max_batch=1), [([5, 6, 7], 4)])[0].output[0]
    eng = mk(max_batch=2, eos_id=eos, prefix_caching=False)
    done = _serve(eng, [([5, 6, 7], 8)] + [([1 + i, 2 + i, 3 + i, 4 + i], 3)
                                           for i in range(4)])
    assert len(done) == 5 and all(r.done for r in done)
    assert done[0].output == [eos]
    assert eng.allocator.free_blocks == eng.allocator.num_blocks - 1


def test_paged_engine_refuses_rings_and_a_mesh():
    jcfg = jreduced(jget_config("gemma3-27b"))
    cfg = reduced(get_config("gemma3-27b"))
    params = bridge.params_from_jax(_np(init_lm(jax.random.PRNGKey(0), jcfg)),
                                    cfg, device="cpu")
    with pytest.raises(ValueError, match="cannot page"):
        PagedEngine(cfg, params, max_batch=2, max_len=64)
    with pytest.raises(ValueError):
        JPagedEngine(jcfg, init_lm(jax.random.PRNGKey(0), jcfg), max_batch=2,
                     max_len=64)
    _, cfg, _, params = _setup("stablelm-3b")
    with pytest.raises(NotImplementedError, match="mesh"):
        PagedEngine(cfg, params, max_batch=2, max_len=64, mesh=object())


# -- the request timeline under an injected clock ----------------------------

def _ticks():
    """A clock that advances by one at every read."""
    return itertools.count(1).__next__


def _timeline(done):
    return [(r.enqueue_t, r.admit_t, r.first_token_t, r.finish_t) for r in done]


@pytest.mark.parametrize("max_batch,chunk,seed,n", [(1, 8, 3, 1), (2, 16, 4, 6)])
def test_timeline_matches_jax_under_an_injected_clock(max_batch, chunk, seed, n):
    """test_paged_serving.py's queue-wait scenarios: admit_t stamped once,
    at the first admission (a chunked prompt's later chunks never restamp
    it), TTFT >= queue wait; every stamp equal to JAX's engine's under the
    same clock."""
    jcfg, cfg, jparams, params = _setup("granite-3-8b")
    rng = np.random.RandomState(seed)
    if n == 1:
        reqs = [(rng.randint(1, cfg.vocab_size, size=30).tolist(), 3)]
    else:
        reqs = [(rng.randint(1, cfg.vocab_size,
                             size=int(rng.randint(3, 36))).tolist(),
                 int(rng.randint(2, 5))) for _ in range(n)]
    kw = dict(max_batch=max_batch, max_len=64, block_size=8, chunk_size=chunk)
    with jnn.backend("jnp"):
        want = _serve(JPagedEngine(jcfg, jparams, clock=_ticks(), **kw), reqs)
    eng = PagedEngine(cfg, params, clock=_ticks(), **kw)
    if n == 1:
        eng.add_request(reqs[0][0], max_new_tokens=3)
        eng.step()                                   # admits: chunk 1 only
        req = next(r for r in eng.slots if r is not None)
        admit_t = req.admit_t
        done = eng.run()
        assert done[0].admit_t == admit_t            # never restamped
    else:
        done = _serve(eng, reqs)
    assert _timeline(done) == _timeline(want)
    for r in done:
        assert r.ttft_s >= r.queue_wait_s >= 0.0
        assert r.first_token_t >= r.admit_t >= r.enqueue_t
    assert eng.stats.mean_ttft_s >= eng.stats.mean_queue_wait_s


# -- sampling ------------------------------------------------------------------

def test_sampling_draws_from_the_softmax():
    """greedy=False: a chi-square of 40000 draws from fixed logits against
    their softmax (8 classes, 7 degrees of freedom; 24.32 is the 0.999
    quantile), and the same draws from the same seed."""
    _, cfg, _, params = _setup("stablelm-3b")
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, 0.25])
    p = torch.softmax(logits, -1).numpy()

    def draws(seed, n=40000):
        eng = Engine(cfg, params, max_batch=1, max_len=16, greedy=False,
                     seed=seed)
        return eng._sample(logits[None].expand(n, 8)).numpy()
    d = draws(3)
    counts = np.bincount(d, minlength=8)
    chi2 = float((((counts - p * len(d)) ** 2) / (p * len(d))).sum())
    assert chi2 < 24.32, (chi2, counts)
    np.testing.assert_array_equal(draws(3), d)
    assert not np.array_equal(draws(4), d)


def test_sampling_engines_serve_and_greedy_is_unchanged():
    _, cfg, _, params = _setup("granite-3-8b")
    reqs, _ = _request_set("mixed", cfg.vocab_size)

    def tokens(E, **kw):
        return [r.output for r in _serve(E(cfg, params, max_batch=3,
                                           max_len=64, **kw), reqs)]
    greedy = tokens(Engine)
    assert tokens(Engine, greedy=True, seed=7) == greedy
    assert tokens(PagedEngine, block_size=8, seed=7) == greedy
    sampled = tokens(Engine, greedy=False, seed=1)
    assert [len(o) for o in sampled] == [b for _, b in reqs]
    assert all(0 <= t < cfg.vocab_size for o in sampled for t in o)
    assert tokens(Engine, greedy=False, seed=1) == sampled
    assert tokens(PagedEngine, block_size=8, greedy=False, seed=1,
                  prefix_caching=False) == sampled
    assert sampled != greedy


def test_engine_pad_id_bucket_and_reset_stats():
    jcfg, cfg, jparams, params = _setup("stablelm-3b")
    reqs, _ = _request_set("mixed", cfg.vocab_size)
    kw = dict(max_batch=3, max_len=64, pad_id=7, min_prefill_bucket=32)
    eng = Engine(cfg, params, **kw)
    assert eng._bucket(3) == 32 and eng._bucket(40) == 64
    got = [r.output for r in _serve(eng, reqs)]
    from repro.serving import Engine as JEngine
    with jnn.backend("jnp"):
        want = [r.output for r in _serve(JEngine(jcfg, jparams, **kw), reqs)]
    assert got == want
    assert eng.stats.completed == len(reqs) and eng.stats.decode_steps > 0
    eng.reset_stats()
    assert eng.stats.completed == 0 and eng.stats.decode_steps == 0
