"""The port's RG-LRU recurrent mixer (``repro_torch/models/recurrent.py``)
and recurrentgemma-2b through the LM stack and the ``Engine``, against the
JAX package's (``repro/models/recurrent.py``, ``repro.models``,
``repro.serving.Engine``), on bridged weights, f32 on the CPU.

The mixer's functions are held to JAX's at 1e-5 (the tolerance of
``tests/test_mixers.py``), whose three RG-LRU tests run again on the port;
the parallel scan (JAX's associative-scan recursion) equals a loop of
``rglru_step``. The model is ``reduced(recurrentgemma-2b)``: 3 layers
(rec, rec, local), d 256, 4 heads of 64 over one KV head, window 64, and a
5-layer variant whose (rec, rec) trail crosses the bridge. Both port
backends (the kernel backend's wrappers take their plain versions for CPU
tensors) are held to JAX's plain (``jnp``) path, each JAX reference
computed once in a module fixture."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import nn as jnn  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core.graph import capture as jcapture  # noqa: E402
from repro.core.taxonomy import parse_scope as jparse_scope  # noqa: E402
from repro.models import init_lm, lm_decode, lm_forward, lm_prefill  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro.models.common import ModelConfig as JModelConfig  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import capture, parse_scope  # noqa: E402
from repro_torch.models import recurrent as R  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.serving import Engine, PagedEngine  # noqa: E402

ARCH = "recurrentgemma-2b"
ATOL = 1e-5                  # tests/test_mixers.py
LM_ATOL = 2e-5               # tests/test_kernels.py _tol(float32)
MAX_LEN = 128
BACKENDS = ["torch", "cuda"]
SCAN_LENGTHS = [1, 2, 7, 64, 1024]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@functools.lru_cache(maxsize=None)
def _setup(**overrides):
    """(jax config, port config, JAX params, bridged port params)."""
    jcfg = jreduced(jget_config(ARCH)).replace(**overrides)
    cfg = reduced(get_config(ARCH)).replace(**overrides)
    jparams = init_lm(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(_np(jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


@contextlib.contextmanager
def both(port_backend, fused):
    """JAX's plain path and the port's ``port_backend``, fused alike."""
    with jnn.backend("jnp"), tnn.backend(port_backend), jnn.fuse(fused), \
            tnn.fuse(fused):
        yield


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (b, s))


# ---------------------------------------------------------------------------
# the mixer's functions
# ---------------------------------------------------------------------------

def _jax_init_recurrent(jcfg):
    return jax.jit(JR.init_recurrent, static_argnums=1)(
        jax.random.PRNGKey(1), jcfg)


@pytest.fixture(scope="module")
def mixer():
    """(jax config, port config, JAX mixer params, bridged, input rows)."""
    jcfg, cfg = _setup()[:2]
    jp = _jax_init_recurrent(jcfg)
    p = bridge.tensors_from_jax(_np(jp), device="cpu")
    rng = np.random.default_rng(0)
    w = cfg.lru_width
    xs = {s: (rng.standard_normal((2, s, w)) * 0.5).astype(np.float32)
          for s in SCAN_LENGTHS}
    x = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, p, xs, x


@pytest.fixture(scope="module")
def jax_mixer(mixer):
    """JAX's prefill of the first 9 rows and its decode of the 10th, and
    its full forward: computed once."""
    jcfg, _, jp, _, _, x = mixer
    full = np.asarray(jax.jit(JR.recurrent_forward, static_argnums=2)(
        jp, jnp.asarray(x), jcfg))
    y_pre, cache = jax.jit(JR.recurrent_prefill, static_argnums=2)(
        jp, jnp.asarray(x[:, :9]), jcfg)
    y_dec, new = jax.jit(JR.recurrent_decode, static_argnums=2)(
        jp, jnp.asarray(x[:, 9:]), jcfg, cache, jnp.int32(9))
    return full, np.asarray(y_pre), _np(cache), np.asarray(y_dec), _np(new)


def test_init_recurrent_leaves_equal_jax(mixer):
    jcfg, cfg, jp, _, _, _ = mixer
    own = R.init_recurrent(torch.Generator().manual_seed(0), cfg)
    assert {n: tuple(t.shape) for n, t in own.items()} == \
        {n: tuple(a.shape) for n, a in jp.items()}
    # lam is the inverse softplus of -log(u) / 8, u in [0.001, 0.1]
    a = torch.exp(-8.0 * R._softplus(own["lam"]))
    assert float(a.min()) >= 0.001 - 1e-6 and float(a.max()) <= 0.1 + 1e-6


def test_causal_conv1d_matches_jax(mixer):
    _, _, jp, p, xs, _ = mixer
    x = xs[64]
    want = jax.jit(JR._causal_conv1d)(jnp.asarray(x), jp["conv_w"],
                                      jp["conv_b"])
    got = R._causal_conv1d(_t(x), p["conv_w"], p["conv_b"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_rglru_coeffs_match_jax(mixer):
    _, _, jp, p, xs, _ = mixer
    ja, jb = jax.jit(JR._rglru_coeffs)(jp, jnp.asarray(xs[7]))
    a, b = R._rglru_coeffs(p, _t(xs[7]))
    assert a.dtype == b.dtype == torch.float32
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=ATOL)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), atol=ATOL)


@pytest.mark.parametrize("s", SCAN_LENGTHS)
def test_rglru_scan_matches_jax(mixer, s):
    _, _, jp, p, xs, _ = mixer
    want = np.asarray(jax.jit(JR.rglru_scan)(jp, jnp.asarray(xs[s])))
    got = R.rglru_scan(p, _t(xs[s]))
    assert got.shape == (2, s, xs[s].shape[-1])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_rglru_step_matches_jax(mixer):
    _, _, jp, p, xs, _ = mixer
    x_t = xs[2][:, :1]
    h0 = np.random.default_rng(1).standard_normal(
        (2, x_t.shape[-1])).astype(np.float32)
    jo, jh = jax.jit(JR.rglru_step)(jp, jnp.asarray(x_t), jnp.asarray(h0))
    o, h = R.rglru_step(p, _t(x_t), _t(h0))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL)


@pytest.mark.parametrize("s", [1, 7, 64])
def test_scan_equals_a_loop_of_steps(mixer, s):
    """The parallel scan against the recurrence one token at a time."""
    _, _, _, p, xs, _ = mixer
    x = _t(xs[s])
    h = torch.zeros((2, x.shape[-1]))
    outs = []
    for t in range(s):
        o, h = R.rglru_step(p, x[:, t:t + 1], h)
        outs.append(o)
    np.testing.assert_allclose(R.rglru_scan(p, x).numpy(),
                               torch.cat(outs, dim=1).numpy(), atol=ATOL)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 64, 100])
def test_associative_scan_is_an_inclusive_scan(n):
    """JAX's recursion over addition and over (a, b) pairs, at even and odd
    lengths on every level."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((2, n, 3)))
    got = R.associative_scan(lambda u, v: [u[0] + v[0]], [x], dim=1)[0]
    np.testing.assert_allclose(got.numpy(), np.cumsum(x.numpy(), axis=1),
                               atol=1e-12)
    a = torch.from_numpy(rng.uniform(0.1, 0.9, (2, n, 3)))
    b = torch.from_numpy(rng.standard_normal((2, n, 3)))
    h, hs = torch.zeros(2, 3, dtype=torch.float64), []
    for t in range(n):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    got = R.associative_scan(R._combine, [a, b], dim=1)[1]
    np.testing.assert_allclose(got.numpy(), torch.stack(hs, 1).numpy(),
                               atol=1e-12)


def test_recurrent_forward_prefill_decode_match_jax(mixer, jax_mixer):
    _, cfg, _, p, _, x = mixer
    full, y_pre, cache, y_dec, new = jax_mixer
    np.testing.assert_allclose(R.recurrent_forward(p, _t(x), cfg).numpy(),
                               full, atol=ATOL)
    got, c = R.recurrent_prefill(p, _t(x[:, :9]), cfg)
    np.testing.assert_allclose(got.numpy(), y_pre, atol=ATOL)
    assert set(c) == set(cache) == {"h", "conv"}
    assert c["h"].dtype == torch.float32
    assert c["conv"].shape == (2, cfg.conv_width - 1, cfg.lru_width)
    for key in ("h", "conv"):
        np.testing.assert_allclose(c[key].numpy(), cache[key], atol=ATOL)
    ptrs = {k: t.data_ptr() for k, t in c.items()}
    got, c2 = R.recurrent_decode(p, _t(x[:, 9:]), cfg, c, 9)
    assert c2 is c and {k: t.data_ptr() for k, t in c.items()} == ptrs
    np.testing.assert_allclose(got.numpy(), y_dec, atol=ATOL)
    for key in ("h", "conv"):
        np.testing.assert_allclose(c[key].numpy(), new[key], atol=ATOL)


def test_prefill_shorter_than_the_conv_pads_its_tail(mixer):
    """A prompt shorter than the conv's K - 1 leaves zeros before its
    inputs in the tail, and decode from it equals the forward pass."""
    _, cfg, _, p, _, x = mixer
    _, c = R.recurrent_prefill(p, _t(x[:, :1]), cfg)
    assert c["conv"].shape == (2, cfg.conv_width - 1, cfg.lru_width)
    assert not c["conv"][:, :-1].any()
    y, _ = R.recurrent_decode(p, _t(x[:, 1:2]), cfg, c, 1)
    full = R.recurrent_forward(p, _t(x[:, :2]), cfg)
    np.testing.assert_allclose(y.numpy(), full[:, 1:].numpy(), atol=ATOL)


# -- tests/test_mixers.py's RG-LRU tests, on the port -------------------

def _mkcfg(**kw):
    base = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
                d_ff=64, vocab_size=64, dtype="float32",
                param_dtype="float32", conv_width=4, mlstm_chunk=8,
                remat=False, lru_width=32)
    base.update(kw)
    return ModelConfig(**base), JModelConfig(**base)


def _small_mixer():
    cfg, jcfg = _mkcfg()
    jp = _jax_init_recurrent(jcfg)
    return cfg, bridge.tensors_from_jax(_np(jp), device="cpu")


def test_mixers_rglru_scan_matches_step():
    _, p = _small_mixer()
    x = _t(np.random.default_rng(0).standard_normal((2, 10, 32)) * 0.5
           ).float()
    h_par = R.rglru_scan(p, x)
    h = torch.zeros((2, 32))
    outs = []
    for t in range(10):
        o, h = R.rglru_step(p, x[:, t:t + 1], h)
        outs.append(o)
    np.testing.assert_allclose(h_par.numpy(), torch.cat(outs, 1).numpy(),
                               atol=1e-5)


def test_mixers_recurrent_decode_matches_forward():
    cfg, p = _small_mixer()
    s = 9
    x = _t(np.random.default_rng(1).standard_normal((2, s + 1, 32)) * 0.5
           ).float()
    full = R.recurrent_forward(p, x, cfg)
    y_pre, cache = R.recurrent_prefill(p, x[:, :s], cfg)
    np.testing.assert_allclose(y_pre.numpy(), full[:, :s].numpy(), atol=1e-5)
    y, _ = R.recurrent_decode(p, x[:, s:s + 1], cfg, cache, s)
    np.testing.assert_allclose(y.numpy(), full[:, s:s + 1].numpy(),
                               atol=1e-5)


def test_mixers_rglru_stability_long_sequence():
    """|a| < 1 by construction: the state must not blow up over 1k steps."""
    _, p = _small_mixer()
    x = _t(np.random.default_rng(2).standard_normal((1, 1024, 32))).float()
    h = R.rglru_scan(p, x)
    assert bool(torch.isfinite(h).all())
    assert float(h.abs().max()) < 1e3


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

#: prefill of a prompt past the 64-token window, then decode steps
PROMPT, STEPS = 80, 4


@pytest.fixture(scope="module")
def jax_lm():
    """JAX's forward logits, and its prefill + decode logits and caches,
    per fused, each computed once."""
    jcfg, cfg, jparams, _ = _setup()
    toks = _tokens(cfg, 2, PROMPT + STEPS, seed=1)
    memo = {}

    def get(fused):
        if fused not in memo:
            with jnn.backend("jnp"), jnn.fuse(fused):
                fwd = jax.jit(lambda p, t: lm_forward(p, t, jcfg))(
                    jparams, jnp.asarray(toks, jnp.int32))
                prefill = jax.jit(lambda p, t: lm_prefill(p, t, jcfg,
                                                          max_len=MAX_LEN))
                decode = jax.jit(lambda p, t, i, c: lm_decode(p, t, i, c,
                                                              jcfg))
                logits, caches = prefill(
                    jparams, jnp.asarray(toks[:, :PROMPT], jnp.int32))
                steps, pre_caches = [np.asarray(logits)], _np(caches)
                for i in range(STEPS):
                    logits, caches = decode(
                        jparams, jnp.asarray(toks[:, PROMPT + i], jnp.int32),
                        jnp.int32(PROMPT + i), caches)
                    steps.append(np.asarray(logits))
            memo[fused] = (np.asarray(fwd), steps, pre_caches)
        return memo[fused]
    return toks, get


def test_reduced_config_and_params():
    jcfg, cfg, jparams, params = _setup()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.window_size, cfg.lru_width) == \
        (3, 256, 4, 1, 64, 64, 256)
    assert cfg.layer_kinds() == ("rec", "rec", "local")
    assert set(params["layers"][0]) == {"norm1", "mixer", "norm2", "ffn"}
    assert set(params["layers"][0]["mixer"]) == \
        set(jparams["scan"][0]["mixer"])
    own = TT.init_lm(torch.Generator().manual_seed(0), cfg)
    leaves = bridge._map(lambda t: t.numel(), own)
    total = sum(jax.tree_util.tree_leaves(leaves))
    assert total == cfg.n_params() == jcfg.n_params()
    assert get_config(ARCH).n_params() == jget_config(ARCH).n_params() \
        == 2_894_574_080


@pytest.mark.parametrize("port_backend", BACKENDS)
@pytest.mark.parametrize("fused", [False, True])
def test_lm_forward_matches_jax(jax_lm, port_backend, fused):
    toks, get = jax_lm
    _, cfg, _, params = _setup()
    with both(port_backend, fused):
        got = TT.lm_forward(params, _t(toks), cfg)
    np.testing.assert_allclose(got.numpy(), get(fused)[0], atol=LM_ATOL,
                               rtol=1e-5)


@pytest.mark.parametrize("port_backend", BACKENDS)
@pytest.mark.parametrize("fused", [False, True])
def test_prefill_past_the_window_and_decode_match_jax(jax_lm, port_backend,
                                                      fused):
    toks, get = jax_lm
    _, cfg, _, params = _setup()
    _, want, want_caches = get(fused)
    with both(port_backend, fused):
        logits, caches = TT.lm_prefill(params, _t(toks[:, :PROMPT]), cfg,
                                       max_len=MAX_LEN)
        np.testing.assert_allclose(logits.numpy(), want[0], atol=LM_ATOL,
                                   rtol=1e-5)
        bridged = bridge.caches_from_jax(want_caches, cfg, device="cpu")
        for kind, g, w in zip(cfg.layer_kinds(), caches, bridged):
            assert set(g) == set(w)
            for key in g:
                np.testing.assert_allclose(g[key].numpy(), w[key].numpy(),
                                           atol=ATOL)
        for i in range(STEPS):
            logits, caches = TT.lm_decode(params, _t(toks[:, PROMPT + i]),
                                          PROMPT + i, caches, cfg)
            np.testing.assert_allclose(logits.numpy(), want[i + 1],
                                       atol=LM_ATOL, rtol=1e-5)


def test_lm_decode_writes_the_recurrent_state_in_place():
    _, cfg, _, params = _setup()
    caches = TT.init_lm_cache(cfg, 2, MAX_LEN, device="cpu")
    assert [set(c) for c in caches] == [{"h", "conv"}, {"h", "conv"},
                                        {"k", "v", "pos"}]
    assert caches[0]["h"].shape == (2, cfg.lru_width)
    assert caches[0]["h"].dtype == torch.float32
    assert caches[0]["conv"].shape == (2, cfg.conv_width - 1, cfg.lru_width)
    ptrs = [{k: t.data_ptr() for k, t in c.items()} for c in caches]
    tok = torch.tensor([3, 7])
    for i in range(3):
        _, out = TT.lm_decode(params, tok, i, caches, cfg)
        assert [{k: t.data_ptr() for k, t in c.items()} for c in out] == ptrs
    assert caches[0]["h"].abs().sum() > 0 and caches[1]["conv"].abs().sum() > 0


def test_lm_extend_raises():
    _, cfg, _, params = _setup()
    caches = TT.init_lm_cache(cfg, 1, MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="rec"):
        TT.lm_extend(params, torch.ones((1, 8), dtype=torch.int64), 0, caches,
                     cfg)


# -- the engines ----------------------------------------------------------

#: prompt lengths: JAX's exact-prefill test's (5, 11) and one past the
#: window; their token budgets
ENGINE_PROMPTS, ENGINE_BUDGETS = (5, 11, 70), (4, 4, 6)


@pytest.fixture(scope="module")
def jax_engine():
    """JAX's ``Engine`` tokens per fused, each served once."""
    jcfg, cfg, jparams, _ = _setup()
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
               for n in ENGINE_PROMPTS]
    memo = {}

    def get(fused):
        if fused not in memo:
            with jnn.backend("jnp"):
                eng = JEngine(jcfg, jparams, max_batch=2, max_len=MAX_LEN,
                              fused=fused)
                assert not eng._pad_safe and eng._bucket(5) == 5
                memo[fused] = _serve(eng, prompts)
        return memo[fused]
    return prompts, get


def _serve(engine, prompts):
    uids = [engine.add_request(p, max_new_tokens=m)
            for p, m in zip(prompts, ENGINE_BUDGETS)]
    done = {r.uid: r.output for r in engine.run()}
    return [done[u] for u in uids]


@pytest.mark.parametrize("fused", [False, True])
def test_engine_tokens_match_jax_engine(jax_engine, fused):
    prompts, get = jax_engine
    _, cfg, _, params = _setup()
    eng = Engine(cfg, params, max_batch=2, max_len=MAX_LEN, fused=fused)
    assert not eng._pad_safe
    assert [eng._bucket(n) for n in ENGINE_PROMPTS] == list(ENGINE_PROMPTS)
    got = _serve(eng, prompts)
    assert got == get(fused)
    assert [len(o) for o in got] == list(ENGINE_BUDGETS)


def test_dense_engine_still_buckets():
    cfg = _mkcfg(lru_width=None)[0]
    params = TT.init_lm(torch.Generator().manual_seed(0), cfg)
    eng = Engine(cfg, params, max_batch=1, max_len=64)
    assert eng._pad_safe and eng._bucket(5) == 8


def test_paged_engine_refuses_recurrentgemma():
    _, cfg, _, params = _setup()
    with pytest.raises(ValueError, match="rec"):
        PagedEngine(cfg, params, max_batch=2, max_len=64)


# -- the capture and the bridge ---------------------------------------------

def _tagged_pairs(records, parse):
    return {(r.group.value, r.op_site) for r in records if parse(r.scope)}


@pytest.mark.parametrize("port_backend", BACKENDS)
@pytest.mark.parametrize("fused", [False, True])
def test_capture_tags_the_mixer_sites_as_jax(port_backend, fused):
    jcfg, cfg, jparams, params = _setup()
    toks = _tokens(cfg, 1, 8, seed=4)
    with both(port_backend, fused):
        jrecs = jcapture(lambda p, t: lm_forward(p, t, jcfg), jparams,
                         jnp.asarray(toks, jnp.int32))
        recs = capture(TT.lm_forward, params, _t(toks), cfg)
    want = _tagged_pairs(jrecs, jparse_scope)
    assert {("memory", "causal_conv1d"), ("activation", "rglru_gates"),
            ("elementwise", "rglru_scan")} <= want
    assert _tagged_pairs(recs, parse_scope) == want


def test_bridge_carries_a_recurrent_trail():
    """5 layers of the 3-layer pattern: JAX's layout is (lead 0, scan 3 x
    1, trail 2 rec layers), the port's 5 layers in order, the prefill's
    logits and caches agree."""
    jcfg, cfg, jparams, params = _setup(n_layers=5)
    assert len(jparams["trail"]) == 2 and not jparams["lead"]
    assert cfg.layer_kinds() == ("rec", "rec", "local", "rec", "rec")
    np.testing.assert_array_equal(
        params["layers"][4]["mixer"]["w_a"].numpy(),
        np.asarray(jparams["trail"][1]["mixer"]["w_a"]))
    toks = _tokens(cfg, 2, 72, seed=5)
    with both("torch", False):
        want, jc = jax.jit(lambda p, t: lm_prefill(p, t, jcfg,
                                                   max_len=MAX_LEN))(
            jparams, jnp.asarray(toks, jnp.int32))
        got, tc = TT.lm_prefill(params, _t(toks), cfg, max_len=MAX_LEN)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LM_ATOL,
                               rtol=1e-5)
    for g, w in zip(tc, bridge.caches_from_jax(_np(jc), cfg, device="cpu")):
        assert set(g) == set(w)
        for key in g:
            np.testing.assert_allclose(g[key].numpy(), w[key].numpy(),
                                       atol=ATOL)
