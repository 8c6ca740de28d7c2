"""The port's mixture-of-experts layer (``repro_torch/models/moe.py``)
against the JAX package's (``repro/models/moe.py``), and the whole reduced
MoE models (qwen2-moe-a2.7b, and deepseek-v2-lite-16b with its MLA and a
dense first layer) against JAX's, on bridged weights, f32 on the CPU.

Each test of ``tests/test_moe.py`` runs again on the port; ``moe_forward``
is held to JAX's at 1e-5 for ``y`` and ``aux``; the dispatch's ``dest`` and
``keep`` equal JAX's bit for bit, at a capacity that drops tokens too; the
top-k under exact ties picks JAX's experts (``jax.lax.top_k`` breaks ties
toward the lower index). The models: ``lm_forward`` / ``lm_prefill`` /
``lm_decode`` / ``lm_extend``, the ``Engine``'s and the cold
``PagedEngine``'s tokens, and the tagged sites of ``Workload.build()``'s
capture, against JAX's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis",
                    reason="property tests need the hypothesis dev extra")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro import nn as jnn  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import Workload as JWorkload  # noqa: E402
from repro.core.graph import capture as jcapture  # noqa: E402
from repro.core.taxonomy import parse_scope as jparse_scope  # noqa: E402
from repro.models import init_lm  # noqa: E402
from repro.models import lm_decode as jlm_decode  # noqa: E402
from repro.models import lm_extend as jlm_extend  # noqa: E402
from repro.models import lm_forward as jlm_forward  # noqa: E402
from repro.models import lm_prefill as jlm_prefill  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models.common import ModelConfig as JModelConfig  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving.paged import PagedEngine as JPagedEngine  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch import nn  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import Workload, capture, parse_scope  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.serving import Engine, PagedEngine  # noqa: E402


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def mkcfg(e=8, k=2, shared=1, cf=1.25, cls=ModelConfig):
    return cls(name="t", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
               d_ff=32, vocab_size=64, n_experts=e, top_k=k,
               n_shared_experts=shared, moe_d_ff=32, capacity_factor=cf,
               dtype="float32", param_dtype="float32", ffn="swiglu",
               remat=False)


def _moe_pair(seed=1, **kw):
    """(JAX config, port config, JAX params, bridged port params)."""
    jcfg, cfg = mkcfg(cls=JModelConfig, **kw), mkcfg(**kw)
    jp = JM.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, bridge.tensors_from_jax(_np(jp), device="cpu")


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# tests/test_moe.py again on the port
# ---------------------------------------------------------------------------

def test_moe_forward_shapes_and_finite():
    cfg = mkcfg()
    p = M.init_moe(torch.Generator().manual_seed(1), cfg)
    x = torch.from_numpy(_x((2, 12, 16)))
    y, aux = M.moe_forward(p, x, cfg)
    assert y.shape == x.shape
    assert torch.isfinite(aux) and torch.isfinite(y).all()


def test_moe_matches_dense_when_experts_identical():
    """All experts identical and no shared expert: MoE(x) equals the dense
    FFN with those weights (gates renormalize to 1, nothing drops)."""
    cfg = mkcfg(e=4, k=2, shared=0, cf=8.0)
    p = M.init_moe(torch.Generator().manual_seed(1), cfg)
    p["experts"] = {n: w[0:1].repeat(cfg.n_experts, *([1] * (w.dim() - 1)))
                    for n, w in p["experts"].items()}
    x = torch.from_numpy(_x((2, 8, 16)))
    y, _ = M.moe_forward(p, x, cfg)
    dense_p = {n: w[0] for n, w in p["experts"].items()}
    want = M.ffn_forward(dense_p, x.reshape(16, 16), cfg).reshape(x.shape)
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=1e-4)


def test_moe_capacity_drops_tokens():
    """A tiny capacity_factor: overflow tokens contribute exactly zero."""
    cfg = mkcfg(e=2, k=1, shared=0, cf=0.01)
    p = M.init_moe(torch.Generator().manual_seed(1), cfg)
    x = torch.from_numpy(_x((1, 64, 16)))
    y, _ = M.moe_forward(p, x, cfg)
    # capacity = max(64*1/2*0.01, 4) = 4 per expert -> at most 8 tokens kept
    assert int((y[0].abs() > 1e-9).any(-1).sum()) <= 8


def test_router_gate_normalized():
    probs = nn.router_gate(torch.from_numpy(_x((10, 8))) * 3)
    assert probs.dtype == torch.float32
    np.testing.assert_allclose(probs.sum(-1).numpy(), np.ones(10), rtol=1e-5)


@settings(max_examples=20, deadline=None)
@given(t=st.integers(2, 40), e=st.integers(2, 12), k=st.integers(1, 3),
       seed=st.integers(0, 2 ** 16))
def test_dispatch_position_property(t, e, k, seed):
    """Each kept (token, choice) gets a unique (expert, slot); the slots of
    an expert are dense 0..n-1; a dropped choice goes to the drop row."""
    k = min(k, e)
    ids = torch.from_numpy(np.random.default_rng(seed).integers(0, e, (1, t, k)))
    cap = max(t * k // e, 1)
    dest, keep = M.dispatch_plan(ids, e, cap)
    flat = ids.reshape(-1)
    pos = torch.where(keep[0], dest[0] - flat * cap, -1)
    pairs = [(i, p) for i, p in zip(flat.tolist(), pos.tolist()) if p >= 0]
    assert len(set(pairs)) == len(pairs), "slot collision"
    for ex in range(e):
        slots = sorted(s for i, s in pairs if i == ex)
        assert slots == list(range(len(slots))) and len(slots) <= cap
    assert (dest[0][~keep[0]] == e * cap).all()


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2 ** 16), cf=st.floats(0.5, 4.0))
def test_moe_output_finite_property(seed, cf):
    cfg = mkcfg(e=4, k=2, shared=1, cf=cf)
    p = M.init_moe(torch.Generator().manual_seed(1), cfg)
    y, aux = M.moe_forward(p, torch.from_numpy(_x((1, 16, 16), seed)), cfg)
    assert torch.isfinite(y).all() and torch.isfinite(aux)


# ---------------------------------------------------------------------------
# against JAX's moe.py
# ---------------------------------------------------------------------------

def _jax_dispatch(expert_ids, e, cap):
    """JAX's ``moe_forward`` dispatch lines on (S, T, k) expert ids."""
    n_sh = expert_ids.shape[0]
    flat_ids = expert_ids.reshape(n_sh, -1)
    onehot = jax.nn.one_hot(flat_ids, e, dtype=jnp.int32)
    pos_in_expert = jnp.cumsum(onehot, axis=1) - onehot
    pos = jnp.take_along_axis(pos_in_expert, flat_ids[..., None], axis=2)[..., 0]
    keep = pos < cap
    return np.asarray(jnp.where(keep, flat_ids * cap + pos, e * cap)), \
        np.asarray(keep)


@pytest.mark.parametrize("cf,with_aux", [(1.25, True), (0.3, True),
                                         (8.0, False)])
def test_moe_forward_matches_jax(cf, with_aux):
    """y and aux within 1e-5 of JAX's, at a capacity that drops tokens
    (0.3), the configs' 1.25 and one that drops none (8.0)."""
    jcfg, cfg, jp, p = _moe_pair(e=8, k=2, shared=1, cf=cf)
    x = _x((2, 24, 16), seed=3)
    want_y, want_aux = jax.jit(lambda p, x: JM.moe_forward(p, x, jcfg))(
        jp, jnp.asarray(x))
    y, aux = M.moe_forward(p, torch.from_numpy(x), cfg, with_aux=with_aux)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5,
                               rtol=1e-5)
    if with_aux:
        np.testing.assert_allclose(aux.item(), float(want_aux), atol=1e-5,
                                   rtol=1e-5)
    else:
        assert aux is None


@pytest.mark.parametrize("t,k,e,cf", [(48, 2, 8, 1.25), (48, 2, 8, 0.3),
                                      (64, 4, 60, 1.25), (7, 6, 64, 1.25)])
def test_dispatch_dest_and_keep_equal_jax(t, k, e, cf):
    """dest and keep bit for bit, from the same expert ids; the capacity
    from the shapes as JAX computes it."""
    ids = np.random.default_rng(t + k).integers(0, e, (1, t, k))
    cfg = mkcfg(e=e, k=k, cf=cf)
    cap = M.capacity(t, cfg)
    assert cap == max(int(t * k / e * cf), 4)
    dest, keep = M.dispatch_plan(torch.from_numpy(ids), e, cap)
    want_dest, want_keep = _jax_dispatch(jnp.asarray(ids, jnp.int32), e, cap)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(dest.numpy(), want_dest)
    if cf < 1:
        assert not keep.all()


def test_top_k_breaks_ties_as_jax():
    """Logits with exact ties (values from a few levels, as bf16 logits
    over 60 experts tie): the port's expert ids equal ``jax.lax.top_k``'s,
    which take the lower index first."""
    rng = np.random.default_rng(7)
    logits = rng.integers(-2, 3, (64, 60)).astype(np.float32)
    logits[0] = 1.0                                 # every expert tied
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    for k in (1, 4, 6):
        want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
        got_v, got_i = M.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert M.top_k(torch.from_numpy(probs), 4)[1][0].tolist() == [0, 1, 2, 3]


def test_moe_forward_matches_jax_on_tied_router():
    """A router with duplicated columns ties each token's logits in pairs:
    the same experts, slots and drops as JAX, so y and aux agree."""
    jcfg, cfg, jp, p = _moe_pair(e=8, k=2, shared=0, cf=0.5)
    w = np.asarray(jp["router"]).copy()
    w[:, 1::2] = w[:, 0::2]
    jp = dict(jp, router=jnp.asarray(w))
    p["router"] = torch.from_numpy(w)
    x = _x((1, 32, 16), seed=4)
    want_y, want_aux = JM.moe_forward(jp, jnp.asarray(x), jcfg)
    y, aux = M.moe_forward(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=1e-6)


# ---------------------------------------------------------------------------
# the whole reduced models against JAX
# ---------------------------------------------------------------------------

ARCHS = ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b"]
MAX_LEN = 48


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(jax config, port config, JAX params, bridged port params); JAX's
    ``init_lm`` jitted (a third of its eager time on the CPU)."""
    jcfg = jreduced(jget_config(arch))
    cfg = reduced(get_config(arch))
    jparams = jax.jit(init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(_np(jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


def _memo(compute):
    """A module fixture's getter: ``compute(*key)`` once per key."""
    memo = {}

    def get(*key):
        if key not in memo:
            memo[key] = compute(*key)
        return memo[key]
    return get


@pytest.fixture(scope="module")
def jax_forward():
    """JAX's ``lm_forward`` logits of the 2 x 13 tokens per (arch, JAX
    backend, fused), each computed once."""
    def compute(arch, backend, fused):
        jcfg, cfg, jparams, _ = _setup(arch)
        toks = _tokens(cfg, 2, 13)
        with jnn.backend(backend), jnn.fuse(fused):
            return np.asarray(jax.jit(lambda p, t: jlm_forward(p, t, jcfg))(
                jparams, jnp.asarray(toks, jnp.int32)))
    return _memo(compute)


@pytest.fixture(scope="module")
def jax_serve_chain():
    """JAX's prefill of the 2 x 9 tokens, 4 greedy decode steps and a
    7-token extend chunk at 13 per (arch, JAX backend, fused): (tokens,
    decode logits, extend logits, caches), each computed once."""
    def compute(arch, backend, fused):
        jcfg, cfg, jparams, _ = _setup(arch)
        toks = _tokens(cfg, 2, 9, seed=1)
        with jnn.backend(backend), jnn.fuse(fused):
            logits, jc = jax.jit(lambda p, t: jlm_prefill(p, t, jcfg,
                                                          max_len=MAX_LEN))(
                jparams, jnp.asarray(toks, jnp.int32))
            decode = jax.jit(lambda p, t, i, c: jlm_decode(p, t, i, c, jcfg))
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            want, want_logits = [np.asarray(tok)], []
            for i in range(4):
                logits, jc = decode(jparams, tok, jnp.int32(9 + i), jc)
                want_logits.append(np.asarray(logits))
                tok = jnp.argmax(logits, -1).astype(jnp.int32)
                want.append(np.asarray(tok))
            chunk = _tokens(cfg, 2, 7, seed=2)
            want_ext, jc = jax.jit(
                lambda p, t, c: jlm_extend(p, t, 13, c, jcfg))(
                    jparams, jnp.asarray(chunk, jnp.int32), jc)
        return (np.stack(want), np.stack(want_logits), np.asarray(want_ext),
                _np(jc))
    return _memo(compute)


@pytest.fixture(scope="module")
def jax_engines():
    """JAX's ``Engine`` tokens on the mixed request set per (arch, fused),
    and its ``PagedEngine``'s on the prefix set per (arch, "paged") with
    its hit rate: each served once."""
    def compute(arch, fused):
        jcfg, cfg, jparams, _ = _setup(arch)
        with jnn.backend("jnp"):
            if fused == "paged":
                reqs, extra = _request_set("prefix", cfg.vocab_size)
                jeng = JPagedEngine(jcfg, jparams, max_batch=3, max_len=64,
                                    block_size=8, **extra)
                return _serve(jeng, reqs), jeng.prefix_cache.hit_rate
            reqs, _ = _request_set("mixed", cfg.vocab_size)
            return _serve(JEngine(jcfg, jparams, max_batch=3, max_len=64,
                                  fused=fused), reqs)
    return _memo(compute)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (b, s))


def test_layer_structure_bridged():
    """deepseek's dense first layer and MoE rest, qwen2-moe's MoE layers:
    the bridged trees have the structure the port's ``init_lm`` draws."""
    for arch in ARCHS:
        _, cfg, _, params = _setup(arch)
        own = TT.init_lm(torch.Generator().manual_seed(0), cfg)

        def shapes(tree):
            return jax.tree_util.tree_map(lambda t: tuple(t.shape), tree)
        assert shapes(own["layers"]) == shapes(params["layers"])
        moe = ["moe" in layer for layer in params["layers"]]
        assert moe == [i >= cfg.first_dense_layers
                       for i in range(cfg.n_layers)]
        assert params["layers"][-1]["moe"]["experts"]["w_up"].shape == \
            (cfg.n_experts, cfg.d_model, cfg.moe_d_ff)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("port_backend,jax_backend",
                         [("torch", "jnp"), ("cuda", "pallas_interpret")])
@pytest.mark.parametrize("fused", [False, True])
def test_lm_forward_matches_jax(jax_forward, arch, port_backend, jax_backend,
                                fused):
    _, cfg, _, params = _setup(arch)
    toks = _tokens(cfg, 2, 13)
    want = jax_forward(arch, jax_backend, fused)
    with nn.backend(port_backend), nn.fuse(fused):
        got = TT.lm_forward(params, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("port_backend,jax_backend",
                         [("torch", "jnp"), ("cuda", "pallas_interpret")])
@pytest.mark.parametrize("fused", [False, True])
def test_prefill_decode_extend_match_jax(jax_serve_chain, arch, port_backend,
                                         jax_backend, fused):
    """lm_prefill's logits and caches, 4 greedy lm_decode steps (tokens
    identical, logits within 1e-4) and an lm_extend chunk, against JAX."""
    _, cfg, _, params = _setup(arch)
    toks = _tokens(cfg, 2, 9, seed=1)
    chunk = _tokens(cfg, 2, 7, seed=2)
    want, want_logits, want_ext, jc = jax_serve_chain(arch, jax_backend, fused)
    with nn.backend(port_backend), nn.fuse(fused):
        logits, caches = TT.lm_prefill(params, torch.from_numpy(toks), cfg,
                                       max_len=MAX_LEN)
        t = torch.argmax(logits, -1)
        got, got_logits = [t.numpy()], []
        for i in range(4):
            logits, caches = TT.lm_decode(params, t, 9 + i, caches, cfg)
            got_logits.append(logits.numpy())
            t = torch.argmax(logits, -1)
            got.append(t.numpy())
        got_ext, caches = TT.lm_extend(params, torch.from_numpy(chunk), 13,
                                       caches, cfg)
    np.testing.assert_array_equal(np.stack(got), want)
    np.testing.assert_allclose(np.stack(got_logits), want_logits,
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_ext.numpy(), want_ext,
                               atol=1e-4, rtol=1e-4)
    for g, w in zip(caches, bridge.caches_from_jax(jc, cfg,
                                                   device="cpu")):
        assert set(g) == set(w)
        for key in g:
            np.testing.assert_allclose(g[key].numpy(), w[key].numpy(),
                                       atol=1e-5)


def _request_set(kind, vocab):
    """test_torch_paged.py's request sets: (prompt, budget) pairs and the
    engine arguments they run with."""
    if kind == "mixed":
        rng = np.random.RandomState(0)
        return [(rng.randint(1, vocab, size=rng.randint(3, 41)).tolist(),
                 int(rng.randint(2, 9))) for _ in range(8)], {}
    rng = np.random.RandomState(2)
    prefix = rng.randint(1, vocab, size=24).tolist()
    return [(prefix + rng.randint(1, vocab, size=6).tolist(), 3)
            for _ in range(4)], {"chunk_size": 16}


def _serve(engine, reqs):
    uids = [engine.add_request(p, max_new_tokens=b) for p, b in reqs]
    done = {r.uid: r for r in engine.run()}
    return [done[u].output for u in uids]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fused", [False, True])
def test_engine_and_cold_paged_engine_tokens_match_jax(jax_engines, arch,
                                                       fused):
    """The mixed request set: the port's Engine and cold PagedEngine give
    JAX's Engine's tokens."""
    _, cfg, _, params = _setup(arch)
    reqs, _ = _request_set("mixed", cfg.vocab_size)
    kw = dict(max_batch=3, max_len=64, fused=fused)
    want = jax_engines(arch, fused)
    got = _serve(Engine(cfg, params, **kw), reqs)
    eng = PagedEngine(cfg, params, block_size=8, **kw)
    paged = _serve(eng, reqs)
    assert not nn.fusion_enabled()
    assert got == want and paged == want
    assert eng.cold_prefills == len(reqs) and eng.extend_chunks == 0
    assert eng.allocator.free_blocks + len(eng.prefix_cache) == \
        eng.allocator.num_blocks - 1


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_paged_engine_with_prefix_hits_matches_jax(jax_engines,
                                                           arch):
    """Chunked prefill with prefix-cache hits: the same chunks as JAX's
    PagedEngine (so the same capacities), the same tokens; every request
    finishes and every block comes back."""
    _, cfg, _, params = _setup(arch)
    reqs, extra = _request_set("prefix", cfg.vocab_size)
    kw = dict(max_batch=3, max_len=64, block_size=8, **extra)
    want, jhit_rate = jax_engines(arch, "paged")
    eng = PagedEngine(cfg, params, **kw)
    got = _serve(eng, reqs)
    assert got == want and [len(o) for o in got] == [b for _, b in reqs]
    assert eng.prefix_cache.hit_rate == jhit_rate > 0
    assert eng.allocator.free_blocks + len(eng.prefix_cache) == \
        eng.allocator.num_blocks - 1


def _tagged_pairs(records, parse):
    return {(r.group.value, r.op_site) for r in records if parse(r.scope)}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fused", [False, True])
def test_workload_capture_site_sets_equal_jax(arch, fused):
    """The tagged (group, op_site) pairs of Workload.build()'s lm_forward
    capture equal JAX's: the router, dispatch, expert products, combine
    and aux sites among them."""
    from repro.core import FusionTransform as JFusion

    from repro_torch.core import FusionTransform

    w = Workload(name=arch, arch=arch, seq=8)
    jw = JWorkload(name=arch, arch=arch, seq=8)
    if fused:
        w, jw = w.with_transform(FusionTransform()), \
            jw.with_transform(JFusion())
    fn, args = w.build("cpu")
    got = _tagged_pairs(capture(fn, *args), parse_scope)
    with jnn.backend("jnp"):
        jfn, jargs = jw.build()
        want = _tagged_pairs(jcapture(jfn, *jargs), jparse_scope)
    for site in [("logit", "router_gate"), ("memory", "moe_dispatch"),
                 ("gemm", "expert_ffn"), ("memory", "moe_combine"),
                 ("reduction", "router_aux")]:
        assert site in want
    assert got == want
