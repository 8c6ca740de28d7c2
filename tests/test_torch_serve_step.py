"""The port's serving steps against the JAX package's, and the bookkeeping
that lets them run as CUDA graphs.

``make_serve_step`` and ``make_paged_decode_step`` on bridged
``reduced(granite-3-8b)`` (2 layers) and ``reduced(stablelm-3b)`` params,
f32 on the CPU, unfused and fused: the same next tokens and the same
written caches / pools as JAX's steps on the same inputs (tolerance 1e-5:
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
from repro.serving import make_serve_step as jmake_serve_step  # noqa: E402
from repro.serving.paged import \
    make_paged_decode_step as jmake_paged_decode_step  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.models import lm_decode  # noqa: E402
from repro_torch.serving import (Engine, PagedEngine,  # noqa: E402
                                 make_paged_decode_step, make_serve_step)

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
