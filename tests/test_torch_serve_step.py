"""The port's serving steps against the JAX package's, and the bookkeeping
that lets them run as CUDA graphs.

``make_prefill_step``, ``make_serve_step``, ``make_paged_decode_step``
and ``make_paged_extend_step`` on bridged
``reduced(granite-3-8b)`` (2 layers) and ``reduced(stablelm-3b)`` params,
f32 on the CPU, unfused and fused: the same next tokens (or logits) and
the same written caches / pools as JAX's steps on the same inputs
(tolerance 1e-5:
both sides compute in f32, in other summation orders). The engines decode
through these steps on both devices; on the card as a graph, whose
capture and replay the card tests hold against the eager step.

The capture bookkeeping runs on the CPU with the capture state patched in:
launches counted into a graph's record while it is captured, added at each
replay; a kernel counter buffer refused when first asked for under
capture.
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
from repro.models import init_lm  # noqa: E402
from repro.models import init_lm_cache as jinit_lm_cache  # noqa: E402
from repro.serving import make_prefill_step as jmake_prefill_step  # noqa: E402
from repro.serving import make_serve_step as jmake_serve_step  # noqa: E402
from repro.serving.paged import \
    make_paged_decode_step as jmake_paged_decode_step  # noqa: E402
from repro.serving.paged import \
    make_paged_extend_step as jmake_paged_extend_step  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.models import lm_decode  # noqa: E402
from repro_torch.serving import (Engine, PagedEngine,  # noqa: E402
                                 make_paged_decode_step,
                                 make_paged_extend_step, make_prefill_step,
                                 make_serve_step)

MODELS = list(itertools.product(["granite-3-8b", "stablelm-3b"], [False, True]))
IDS = [f"{a}-{'fused' if f else 'unfused'}" for a, f in MODELS]
ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def _setup(arch):
    cut = dict(n_layers=2, loss_chunk=0) if arch == "granite-3-8b" else {}
    jcfg = jreduced(jget_config(arch)).replace(**cut)
    cfg = reduced(get_config(arch)).replace(**cut)
    jparams = init_lm(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                    cfg, device="cpu")
    return jcfg, cfg, jparams, params


def _random_tree(tree, rng):
    """Every float leaf of a JAX cache tree drawn from N(0, 1) (numpy)."""
    return jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.asarray(a).dtype)
        if jnp.issubdtype(a.dtype, jnp.floating) else np.asarray(a), tree)


def _assert_tree_close(got, want):
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for n in g:
            np.testing.assert_allclose(g[n].numpy(), w[n].numpy(), atol=ATOL,
                                       rtol=ATOL)


@pytest.mark.parametrize("arch,fused", MODELS, ids=IDS)
def test_serve_step_equals_jax(arch, fused):
    """One step of three slots at their own depths over a random cache: the
    same argmax tokens and the same caches as JAX's step; greedy=False
    returns lm_decode's logits."""
    jcfg, cfg, jparams, params = _setup(arch)
    rng = np.random.default_rng(0)
    b, max_len = 3, 32
    jcaches = _random_tree(jinit_lm_cache(jcfg, b, max_len), rng)
    token = rng.integers(1, cfg.vocab_size, b).astype(np.int32)
    pos = np.array([0, 17, max_len - 1], np.int32)
    with jnn.backend("jnp"):
        want, want_caches = jmake_serve_step(jcfg, greedy=True, fused=fused)(
            jparams, jnp.asarray(token), jnp.asarray(pos),
            jax.tree_util.tree_map(jnp.asarray, jcaches), jax.random.PRNGKey(0))
    caches = bridge.caches_from_jax(jcaches, cfg, device="cpu")
    got, got_caches = make_serve_step(cfg, greedy=True, fused=fused)(
        params, torch.from_numpy(token).long(), torch.from_numpy(pos), caches)
    assert got_caches is caches                     # updated in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_tree_close(got_caches, bridge.caches_from_jax(
        jax.tree_util.tree_map(np.asarray, want_caches), cfg, device="cpu"))

    fresh = bridge.caches_from_jax(jcaches, cfg, device="cpu")
    logits, _ = make_serve_step(cfg, greedy=False, fused=fused)(
        params, torch.from_numpy(token).long(), torch.from_numpy(pos), fresh)
    plain = bridge.caches_from_jax(jcaches, cfg, device="cpu")
    with tnn.fuse(fused):
        ref_logits, _ = lm_decode(params, torch.from_numpy(token).long(),
                                  torch.from_numpy(pos), plain, cfg)
    assert torch.equal(logits, ref_logits)
    np.testing.assert_array_equal(torch.argmax(logits, -1).numpy(), got.numpy())


@pytest.mark.parametrize("arch,fused", MODELS, ids=IDS)
def test_paged_decode_step_equals_jax(arch, fused):
    """Random pools, a table with scratch entries and rows sharing no
    block, rows at a block's first and last slot: the same tokens and the
    same pools as JAX's paged step."""
    jcfg, cfg, jparams, params = _setup(arch)
    rng = np.random.default_rng(1)
    bs, max_len = 8, 32
    nb = max_len // bs
    jpools = _random_tree(jinit_lm_cache(jcfg, 13, bs), rng)
    tables = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [7, 8, 9, 10],
                       [0, 0, 0, 0]], np.int32)
    assert tables.shape[1] == nb
    pos = np.array([31, 8, 23, 0], np.int32)
    token = rng.integers(1, cfg.vocab_size, 4).astype(np.int32)
    with jnn.backend("jnp"):
        want, want_pools = jmake_paged_decode_step(
            jcfg, max_len, greedy=True, fused=fused)(
            jparams, jnp.asarray(token), jnp.asarray(pos),
            jax.tree_util.tree_map(jnp.asarray, jpools), jnp.asarray(tables),
            jax.random.PRNGKey(0))
    pools = bridge.caches_from_jax(jpools, cfg, device="cpu")
    got, got_pools = make_paged_decode_step(cfg, max_len, greedy=True,
                                            fused=fused)(
        params, torch.from_numpy(token).long(), torch.from_numpy(pos), pools,
        torch.from_numpy(tables))
    assert got_pools is pools
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the dead row (table all 0) wrote scratch block 0, as JAX's did
    _assert_tree_close(got_pools, bridge.caches_from_jax(
        jax.tree_util.tree_map(np.asarray, want_pools), cfg, device="cpu"))


@pytest.mark.parametrize("fused", [False, True])
def test_prefill_step_equals_jax(fused):
    """A right-padded batch of two prompts: the same last-token logits and
    caches as JAX's prefill step (which casts its params inside; the
    port's takes the working copy, f32 here)."""
    jcfg, cfg, jparams, params = _setup("granite-3-8b")
    toks = np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 16))
    lengths = np.array([16, 9], np.int32)
    toks[1, 9:] = 0
    with jnn.backend("jnp"):
        want, jc = jmake_prefill_step(jcfg, 32, fused=fused)(
            jparams, jnp.asarray(toks, jnp.int32), jnp.asarray(lengths))
    got, caches = make_prefill_step(cfg, 32, fused=fused)(
        params, torch.from_numpy(toks), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)
    _assert_tree_close(caches, bridge.caches_from_jax(
        jax.tree_util.tree_map(np.asarray, jc), cfg, device="cpu"))


@pytest.mark.parametrize("fused", [False, True])
def test_paged_extend_step_equals_jax(fused):
    """One 12-token chunk of a sequence at ``start`` 8 over random pools:
    rows 8-9 (a reused prefix, below ``lo``) and 17-19 (bucket padding,
    from ``hi``) divert to scratch block 0; the same logits as JAX's
    extend step and the same pools but the scratch block, which no
    unmasked read consumes (two diverted rows land on one of its slots,
    and which one stays is the scatter's choice on either side)."""
    jcfg, cfg, jparams, params = _setup("stablelm-3b")
    rng = np.random.default_rng(4)
    bs, max_len = 8, 32
    jpools = _random_tree(jinit_lm_cache(jcfg, 9, bs), rng)
    row = np.array([3, 5, 7, 0], np.int32)
    start, lo, hi = 8, 10, 17
    toks = rng.integers(1, cfg.vocab_size, (1, 12)).astype(np.int32)
    with jnn.backend("jnp"):
        want, want_pools = jmake_paged_extend_step(jcfg, max_len, fused=fused)(
            jparams, jnp.asarray(toks), jnp.int32(start),
            jax.tree_util.tree_map(jnp.asarray, jpools), jnp.asarray(row),
            jnp.int32(lo), jnp.int32(hi))
    pools = bridge.caches_from_jax(jpools, cfg, device="cpu")
    got, got_pools = make_paged_extend_step(cfg, max_len, fused=fused)(
        params, torch.from_numpy(toks).long(), start, pools,
        torch.from_numpy(row), lo, hi)
    assert got_pools is pools and got.shape == (1, 12, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)
    want_pools = bridge.caches_from_jax(
        jax.tree_util.tree_map(np.asarray, want_pools), cfg, device="cpu")
    _assert_tree_close([{n: t[1:] for n, t in p.items()} for p in got_pools],
                       [{n: t[1:] for n, t in p.items()} for p in want_pools])


def test_engines_admit_through_the_step_builders(monkeypatch):
    """The Engine's and the cold PagedEngine's prefills run the step
    ``make_prefill_step`` built, the PagedEngine's chunks the one
    ``make_paged_extend_step`` built, each built once an engine."""
    _, cfg, _, params = _setup("granite-3-8b")
    import repro_torch.serving as serving
    import repro_torch.serving.paged as paged
    calls = []

    def spy(factory):
        def make(*a, **kw):
            step = factory(*a, **kw)
            calls.append(factory.__name__)

            def run(*args):
                calls.append(factory.__name__ + " call")
                return step(*args)
            return run
        return make
    monkeypatch.setattr(serving, "make_prefill_step", spy(make_prefill_step))
    monkeypatch.setattr(paged, "make_paged_extend_step",
                        spy(make_paged_extend_step))
    prompts = [[5, 6, 7], list(range(1, 21))]
    eng = PagedEngine(cfg, params, max_batch=2, max_len=32, block_size=8,
                      chunk_size=8)
    for p in prompts:
        eng.add_request(p, max_new_tokens=3)
    eng.run()
    assert calls.count("make_prefill_step") == 1
    assert calls.count("make_paged_extend_step") == 1
    assert calls.count("make_prefill_step call") == eng.cold_prefills == 1
    assert calls.count("make_paged_extend_step call") == eng.extend_chunks == 3


def test_engines_decode_through_the_steps(monkeypatch):
    """Both engines build their decode step by the factories, once."""
    _, cfg, _, params = _setup("granite-3-8b")
    import repro_torch.serving as serving
    import repro_torch.serving.paged as paged
    built = []

    def spy(factory):
        def make(*a, **kw):
            built.append(factory.__name__)
            return factory(*a, **kw)
        return make
    monkeypatch.setattr(serving, "make_serve_step", spy(make_serve_step))
    monkeypatch.setattr(paged, "make_paged_decode_step",
                        spy(make_paged_decode_step))
    prompts = [[5, 6, 7], [9, 10, 11, 12, 13]]
    for E, kw in ((Engine, {}), (PagedEngine, dict(block_size=8))):
        eng = E(cfg, params, max_batch=2, max_len=32, **kw)
        assert eng.cuda_graph is False
        for p in prompts:
            eng.add_request(p, max_new_tokens=4)
        eng.run()
        assert eng.stats.decode_steps > 1
    assert built == ["make_serve_step", "make_paged_decode_step"]


@pytest.mark.parametrize("E", [Engine, PagedEngine])
def test_cuda_graph_on_the_cpu_raises(E):
    _, cfg, _, params = _setup("granite-3-8b")
    with pytest.raises(ValueError, match="cuda_graph=True"):
        E(cfg, params, max_batch=2, max_len=32, cuda_graph=True)
    assert E(cfg, params, max_batch=2, max_len=32).cuda_graph is False
    assert E(cfg, params, max_batch=2, max_len=32,
             cuda_graph=False).cuda_graph is False


# -- the capture bookkeeping ---------------------------------------------------

def test_launches_count_a_capture_into_its_record(monkeypatch):
    """Under ops.recording() a launch goes to the record and not to
    ops.launches; add_launches adds the record once per replay; a launch
    under capture outside a recording raises."""
    ops.reset_launches()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with ops.recording() as rec:
        for name in ("rms_norm", "decode_core", "rms_norm"):
            ops._count(name)
    assert sum(ops.launches.values()) == 0
    assert {k: v for k, v in rec.items() if v} == {"rms_norm": 2,
                                                   "decode_core": 1}
    for _ in range(3):
        ops.add_launches(rec)
    assert {k: v for k, v in ops.launches.items() if v} == {"rms_norm": 6,
                                                            "decode_core": 3}
    with pytest.raises(RuntimeError, match="recording"):
        ops._count("rms_norm")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    ops._count("rms_norm")
    assert ops.launches["rms_norm"] == 7
    ops.reset_launches()


def test_counters_made_before_capture_only(monkeypatch):
    """A stream's counter buffer is made outside a capture; asked for under
    capture it is returned if it exists and large enough, else raises. A
    larger buffer keeps the one it replaced alive (a graph may hold it)."""
    dev, stream = torch.device("cpu"), -12345
    monkeypatch.setattr(_build, "_COUNTERS", {})
    monkeypatch.setattr(_build, "_RETIRED", [])
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="captured"):
        _build.counters(dev, stream, 8)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    buf = _build.counters(dev, stream, 8)
    assert buf.numel() >= 1024 and not buf.any()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert _build.counters(dev, stream, 1024) is buf
    with pytest.raises(RuntimeError, match="captured"):
        _build.counters(dev, stream, 1025)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    big = _build.counters(dev, stream, 4096)
    assert big.numel() == 4096 and _build._RETIRED == [buf]
