"""The port's xLSTM mixers (``repro_torch/models/xlstm.py``) and xlstm-350m
through the LM stack and the ``Engine``, against the JAX package's
(``repro/models/xlstm.py``, ``repro.models``, ``repro.serving.Engine``), on
bridged weights, f32 on the CPU.

The mixers run at ``tests/test_mixers.py``'s tiny widths (d 32, 4 heads,
chunk 8) and are held to JAX's at that file's tolerances: 2e-4 for the
mLSTM, 1e-4 for the sLSTM. The chunked cell is held to JAX's and to a loop
of ``mlstm_cell_step`` at lengths 1, 21 (the pad path), 32 (whole chunks)
and 70. The model is ``reduced(xlstm-350m)``: 8 layers (mlstm x 7,
slstm), d 256, 4 heads, chunk 32; both port backends (the kernel backend's
wrappers take their plain versions for CPU tensors), unfused and fused,
are held to JAX's plain (``jnp``) path at 2e-4 (the mLSTM's). The prefill's and the decode steps' logits are held to
JAX's forward at the same positions (JAX's decode after prefill is its
forward, ``tests/test_mixers.py``), the caches to JAX's at the mixers. The
model's one fusable site is the sLSTM's GeGLU, whose fused form in f32 is
the same function as the unfused one (JAX's two forwards are bit-identical
here, and the forward test holds both), so the ``Engine`` reference is
JAX's unfused ``Engine`` alone. Each JAX reference is computed once, in a
module fixture."""

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
from repro.models import init_lm, lm_forward  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro.models.common import ModelConfig as JModelConfig  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import capture, parse_scope  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models import xlstm as X  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.serving import Engine, PagedEngine  # noqa: E402

ARCH = "xlstm-350m"
M_ATOL = 2e-4                # tests/test_mixers.py, the mLSTM's
S_ATOL = 1e-4                # tests/test_mixers.py, the sLSTM's
LM_ATOL = 2e-4               # the stack is mostly mLSTM
MAX_LEN = 128
BACKENDS = ["torch", "cuda"]
CELL_LENGTHS = [1, 21, 32, 70]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


@functools.lru_cache(maxsize=None)
def _setup(**overrides):
    """(jax config, port config, JAX params, bridged port params)."""
    jcfg = jreduced(jget_config(ARCH)).replace(**overrides)
    cfg = reduced(get_config(ARCH)).replace(**overrides)
    jparams = jax.jit(init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
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
# the mixers, at tests/test_mixers.py's widths
# ---------------------------------------------------------------------------

def _mkcfg(**kw):
    base = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
                d_ff=64, vocab_size=64, dtype="float32",
                param_dtype="float32", conv_width=4, mlstm_chunk=8,
                remat=False)
    base.update(kw)
    return ModelConfig(**base), JModelConfig(**base)


@pytest.fixture(scope="module")
def mixer():
    """(port config, jax config, JAX mLSTM and sLSTM params, bridged, the
    inputs (2, 70, 32), JAX's qkvif of them)."""
    cfg, jcfg = _mkcfg()
    jm = jax.jit(JX.init_mlstm, static_argnums=1)(jax.random.PRNGKey(1), jcfg)
    js = jax.jit(JX.init_slstm, static_argnums=1)(jax.random.PRNGKey(2), jcfg)
    pm, ps = (bridge.tensors_from_jax(_np(p), device="cpu") for p in (jm, js))
    x = (np.random.default_rng(0).standard_normal((2, 70, 32)) * 0.5
         ).astype(np.float32)
    jq = _np(jax.jit(JX._mlstm_qkvif, static_argnums=2)(jm, jnp.asarray(x),
                                                          jcfg))
    return cfg, jcfg, jm, js, pm, ps, x, jq


@pytest.fixture(scope="module")
def jax_mixers(mixer):
    """JAX's mLSTM and sLSTM forwards of the 12 first rows, their prefill
    of the first 11 and decode of the 12th: computed once."""
    _, jcfg, jm, js, _, _, x, _ = mixer
    out = {}
    x12 = jnp.asarray(x[:, :12])
    for kind, p in (("mlstm", jm), ("slstm", js)):
        fwd, pre, dec = (getattr(JX, f"{kind}_{f}")
                         for f in ("forward", "prefill", "decode"))
        full = jax.jit(fwd, static_argnums=2)(p, x12, jcfg)
        y_pre, cache = jax.jit(pre, static_argnums=2)(p, x12[:, :11], jcfg)
        y_dec, new = jax.jit(dec, static_argnums=2)(p, x12[:, 11:], jcfg,
                                                    cache, jnp.int32(11))
        out[kind] = (np.asarray(full), np.asarray(y_pre), _np(cache),
                     np.asarray(y_dec), _np(new))
    return out


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_init_leaves_equal_jax(mixer, kind):
    cfg, _, jm, js, _, _, _, _ = mixer
    jp = jm if kind == "mlstm" else js
    own = getattr(X, f"init_{kind}")(torch.Generator().manual_seed(0), cfg)
    assert {n: (tuple(t.shape), str(t.dtype)[6:]) for n, t in own.items()} \
        == {n: (tuple(a.shape), str(a.dtype)) for n, a in jp.items()}
    # the constant leaves as JAX lays them out: b_f 3 a head, b_in the flat
    # [0]*d, [3]*d, [0]*2d, the norms' ones, the zero biases
    for name in ("b_f", "b_in", "out_norm", "b_i", "conv_b"):
        if name in own:
            np.testing.assert_array_equal(own[name].numpy(),
                                          np.asarray(jp[name]))


def test_slstm_forget_bias_lands_where_jax_reshapes_it(mixer):
    """b_in reshaped to (H, 4 dh) per head: the 3s fill head 1's whole row
    (d = 32, 4 heads of 8: [0]*32, [3]*32, ... is head 0's four gates zero,
    head 1's all 3)."""
    cfg, _, _, _, _, ps, _, _ = mixer
    per_head = ps["b_in"].reshape(cfg.n_heads, -1)
    assert per_head[1].eq(3.0).all() and not per_head[[0, 2, 3]].any()


def test_qkvif_matches_jax(mixer):
    cfg, _, _, _, pm, _, x, jq = mixer
    got = X._mlstm_qkvif(pm, _t(x), cfg)
    assert [tuple(t.shape) for t in got] == [a.shape for a in jq]
    assert got[3].dtype == got[4].dtype == torch.float32
    for g, w in zip(got, jq):
        _close(g, w, M_ATOL)


@pytest.mark.parametrize("s", CELL_LENGTHS)
def test_mlstm_cell_chunked_matches_jax_and_steps(mixer, s):
    """JAX's chunked cell and the port's loop of ``mlstm_cell_step``, the
    output and the final state (C, n, m)."""
    cfg, _, _, _, _, _, _, jq = mixer
    args = [a[:, :s] for a in jq[:5]]
    jh, jstate = jax.jit(JX.mlstm_cell_chunked, static_argnums=5)(
        *map(jnp.asarray, args), cfg.mlstm_chunk)
    targs = [_t(a) for a in args]
    h, state = X.mlstm_cell_chunked(*targs, cfg.mlstm_chunk)
    assert h.shape == (2, s, cfg.n_heads, 16) and h.is_contiguous()
    _close(h, jh, M_ATOL)
    for g, w in zip(state, jstate):
        _close(g, w, M_ATOL)
    st = (torch.zeros(2, 4, 16, 16), torch.zeros(2, 4, 16),
          torch.full((2, 4), X.M_INIT))
    outs = []
    for t in range(s):
        o, st = X.mlstm_cell_step(*[a[:, t:t + 1] for a in targs], st)
        outs.append(o)
    _close(h, torch.cat(outs, 1), M_ATOL)
    for g, w in zip(state, st):
        _close(g, w, M_ATOL)


def test_mlstm_cell_step_matches_jax(mixer):
    cfg, _, _, _, _, _, _, jq = mixer
    args = [a[:, 3:4] for a in jq[:5]]
    rng = np.random.default_rng(5)
    state = (rng.standard_normal((2, 4, 16, 16)).astype(np.float32),
             rng.standard_normal((2, 4, 16)).astype(np.float32),
             rng.standard_normal((2, 4)).astype(np.float32))
    jh, js = jax.jit(JX.mlstm_cell_step)(*map(jnp.asarray, args),
                                        tuple(map(jnp.asarray, state)))
    h, st = X.mlstm_cell_step(*map(_t, args), tuple(map(_t, state)))
    _close(h, jh, M_ATOL)
    for g, w in zip(st, js):
        _close(g, w, M_ATOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_forward_prefill_decode_match_jax_in_place(mixer, jax_mixers, kind):
    """The forward, the prefill's output and cache, and decode from it,
    against JAX's; decode writes every state tensor in place."""
    cfg, _, _, _, pm, ps, x, _ = mixer
    p, tol = (pm, M_ATOL) if kind == "mlstm" else (ps, S_ATOL)
    full, y_pre, cache, y_dec, new = jax_mixers[kind]
    fwd, pre, dec = (getattr(X, f"{kind}_{f}")
                     for f in ("forward", "prefill", "decode"))
    x12 = _t(x[:, :12])
    _close(fwd(p, x12, cfg), full, tol)
    got, c = pre(p, x12[:, :11], cfg)
    _close(got, y_pre, tol)
    assert set(c) == set(cache)
    for key in c:
        assert c[key].dtype == (torch.float32 if key != "conv"
                                else cfg.activation_dtype)
        assert c[key].is_contiguous()
        _close(c[key], cache[key], tol)
    ptrs = {k: t.data_ptr() for k, t in c.items()}
    got, c2 = dec(p, x12[:, 11:], cfg, c, 11)
    assert c2 is c and {k: t.data_ptr() for k, t in c.items()} == ptrs
    _close(got, y_dec, tol)
    for key in c:
        _close(c[key], new[key], tol)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_after_prefill_matches_forward(mixer, kind):
    """tests/test_mixers.py's decode tests, on the port: decode of the
    next token from the prefill's cache equals the forward's row."""
    cfg, _, _, _, pm, ps, x, _ = mixer
    p, s, tol = (pm, 16, M_ATOL) if kind == "mlstm" else (ps, 11, S_ATOL)
    fwd, pre, dec = (getattr(X, f"{kind}_{f}")
                     for f in ("forward", "prefill", "decode"))
    xs = _t(x[:, :s + 1])
    full = fwd(p, xs, cfg)
    _, cache = pre(p, xs[:, :s], cfg)
    y, _ = dec(p, xs[:, s:], cfg, cache, s)
    _close(y, full[:, s:], tol)


def test_slstm_normalizer_bounded(mixer):
    cfg, _, _, _, _, ps, _, _ = mixer
    x = _t(np.random.default_rng(3).standard_normal((1, 256, 32))).float()
    assert bool(torch.isfinite(X.slstm_forward(ps, x, cfg)).all())


def test_prefill_shorter_than_the_conv_pads_its_tail(mixer):
    """A 2-token prompt leaves a zero row before its inputs in the conv
    tail (JAX's slice would give two rows), and decode from it equals the
    forward pass."""
    cfg, _, _, _, pm, _, x, _ = mixer
    xs = _t(x[:, :3])
    _, c = X.mlstm_prefill(pm, xs[:, :2], cfg)
    assert c["conv"].shape == (2, cfg.conv_width - 1, 64)
    assert not c["conv"][:, 0].any() and c["conv"][:, 1:].abs().sum() > 0
    y, _ = X.mlstm_decode(pm, xs[:, 2:], cfg, c, 2)
    _close(y, X.mlstm_forward(pm, xs, cfg)[:, 2:], M_ATOL)


def test_init_caches_are_empty_states(mixer):
    cfg = mixer[0]
    mc, sc = X.init_mlstm_cache(cfg, 3, "cpu"), X.init_slstm_cache(cfg, 3, "cpu")
    assert {k: tuple(t.shape) for k, t in mc.items()} == {
        "C": (3, 4, 16, 16), "n": (3, 4, 16), "m": (3, 4),
        "conv": (3, cfg.conv_width - 1, 64)}
    assert {k: tuple(t.shape) for k, t in sc.items()} == dict.fromkeys(
        "cnmh", (3, 4, 8))
    assert float(mc["m"].max()) == float(sc["m"].max()) == X.M_INIT
    assert len({t.data_ptr() for t in sc.values()}) == 4


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

#: prefill of a prompt past one 32-token chunk (the pad path), then decode
PROMPT, STEPS = 40, 3


@pytest.fixture(scope="module")
def jax_lm():
    """JAX's forward logits per fused, each computed once."""
    jcfg, cfg, jparams, _ = _setup()
    toks = _tokens(cfg, 2, PROMPT + STEPS, seed=1)
    memo = {}

    def forward(fused):
        if fused not in memo:
            with jnn.backend("jnp"), jnn.fuse(fused):
                memo[fused] = np.asarray(jax.jit(
                    lambda p, t: lm_forward(p, t, jcfg))(
                    jparams, jnp.asarray(toks, jnp.int32)))
        return memo[fused]
    return toks, forward


def test_reduced_config_and_params():
    jcfg, cfg, jparams, params = _setup()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.mlstm_chunk) == \
        (8, 256, 4, 32)
    assert cfg.layer_kinds() == ("mlstm",) * 7 + ("slstm",)
    assert set(params["layers"][0]) == set(params["layers"][7]) == \
        {"norm1", "mixer"}
    assert set(params["layers"][0]["mixer"]) == \
        set(jparams["scan"][0]["mixer"])
    assert set(params["layers"][7]["mixer"]) == \
        set(jparams["scan"][7]["mixer"])
    own = TT.init_lm(torch.Generator().manual_seed(0), cfg)
    total = sum(jax.tree_util.tree_leaves(bridge._map(lambda t: t.numel(),
                                                      own)))
    assert total == cfg.n_params() == jcfg.n_params()


def test_full_config_counts_jax_parameters():
    cfg = get_config(ARCH)
    assert cfg.n_params() == jget_config(ARCH).n_params() == 528_361_640
    assert (int(cfg.d_model * cfg.mlstm_proj_factor) // cfg.n_heads,
            int(cfg.d_model * cfg.slstm_ff_factor)) == (512, 1365)


@pytest.mark.parametrize("port_backend", BACKENDS)
@pytest.mark.parametrize("fused", [False, True])
def test_lm_forward_matches_jax(jax_lm, port_backend, fused):
    toks, forward = jax_lm
    _, cfg, _, params = _setup()
    with both(port_backend, fused):
        got = TT.lm_forward(params, _t(toks), cfg)
    _close(got, forward(fused), LM_ATOL, 1e-5)


@pytest.mark.parametrize("port_backend", BACKENDS)
@pytest.mark.parametrize("fused", [False, True])
def test_prefill_and_decode_match_jax(jax_lm, port_backend, fused):
    """The prefill's last logits and each decode step's against JAX's
    forward at the same positions."""
    toks, forward = jax_lm
    _, cfg, _, params = _setup()
    want = forward(fused)
    with both(port_backend, fused):
        logits, caches = TT.lm_prefill(params, _t(toks[:, :PROMPT]), cfg,
                                       max_len=MAX_LEN)
        _close(logits, want[:, PROMPT - 1], LM_ATOL, 1e-5)
        for i in range(STEPS):
            logits, caches = TT.lm_decode(params, _t(toks[:, PROMPT + i]),
                                          PROMPT + i, caches, cfg)
            _close(logits, want[:, PROMPT + i], LM_ATOL, 1e-5)


def test_lm_decode_writes_the_state_in_place():
    _, cfg, _, params = _setup()
    caches = TT.init_lm_cache(cfg, 2, MAX_LEN, device="cpu")
    assert [set(c) for c in caches] == [{"C", "n", "m", "conv"}] * 7 + \
        [{"c", "n", "m", "h"}]
    ptrs = [{k: t.data_ptr() for k, t in c.items()} for c in caches]
    tok = torch.tensor([3, 7])
    for i in range(3):
        _, out = TT.lm_decode(params, tok, i, caches, cfg)
        assert [{k: t.data_ptr() for k, t in c.items()} for c in out] == ptrs
    assert caches[0]["C"].abs().sum() > 0 and caches[6]["conv"].abs().sum() > 0
    assert caches[7]["h"].abs().sum() > 0


def test_two_token_prompt_decodes_as_the_forward():
    """A prompt shorter than the conv's K - 1 through the whole stack:
    prefill, then decode of the third token, against the port's own
    forward (JAX's decode cannot take the short tail)."""
    _, cfg, _, params = _setup()
    toks = _t(_tokens(cfg, 2, 3, seed=6))
    _, caches = TT.lm_prefill(params, toks[:, :2], cfg, max_len=MAX_LEN)
    assert all(not c["conv"][:, 0].any() for c in caches[:7])
    logits, _ = TT.lm_decode(params, toks[:, 2], 2, caches, cfg)
    _close(logits, TT.lm_forward(params, toks, cfg)[:, 2], LM_ATOL, 1e-5)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_lm_extend_raises(kind):
    _, cfg, _, params = _setup()
    caches = TT.init_lm_cache(cfg, 1, MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match=kind):
        TT.block_extend(params["layers"][cfg.layer_kinds().index(kind)],
                        torch.zeros((1, 8, cfg.d_model)), cfg, kind,
                        caches[0], 0)
    with pytest.raises(ValueError, match="mlstm"):
        TT.lm_extend(params, torch.ones((1, 8), dtype=torch.int64), 0, caches,
                     cfg)


# -- the engines ----------------------------------------------------------

#: prompt lengths, past one 32-token chunk (the pad path), and their token
#: budgets: one length, since each distinct length compiles a JAX prefill
ENGINE_PROMPTS, ENGINE_BUDGETS = (40, 40, 40), (4, 3, 5)


def _serve(engine, prompts):
    uids = [engine.add_request(p, max_new_tokens=m)
            for p, m in zip(prompts, ENGINE_BUDGETS)]
    done = {r.uid: r.output for r in engine.run()}
    return [done[u] for u in uids]


@pytest.fixture(scope="module")
def jax_engine():
    """JAX's (unfused) ``Engine`` tokens, served once."""
    jcfg, cfg, jparams, _ = _setup()
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
               for n in ENGINE_PROMPTS]
    with jnn.backend("jnp"):
        eng = JEngine(jcfg, jparams, max_batch=2, max_len=MAX_LEN)
        assert not eng._pad_safe and eng._bucket(5) == 5
        return prompts, _serve(eng, prompts)


@pytest.mark.parametrize("fused", [False, True])
def test_engine_tokens_match_jax_engine(jax_engine, fused):
    prompts, want = jax_engine
    _, cfg, _, params = _setup()
    eng = Engine(cfg, params, max_batch=2, max_len=MAX_LEN, fused=fused)
    assert not eng._pad_safe
    assert [eng._bucket(n) for n in (5, 40)] == [5, 40]
    got = _serve(eng, prompts)
    assert got == want
    assert [len(o) for o in got] == list(ENGINE_BUDGETS)


def test_paged_engine_refuses_xlstm():
    _, cfg, _, params = _setup()
    with pytest.raises(ValueError, match="mlstm"):
        PagedEngine(cfg, params, max_batch=2, max_len=64)


# -- the capture and the bridge ---------------------------------------------

def _tagged_pairs(records, parse):
    return {(r.group.value, r.op_site) for r in records if parse(r.scope)}


@pytest.fixture(scope="module")
def jax_sites():
    """JAX's tagged (group, site) pairs of one forward, per fused."""
    jcfg, cfg, jparams, _ = _setup()
    toks = _tokens(cfg, 1, 8, seed=4)
    memo = {}

    def get(fused):
        if fused not in memo:
            with jnn.backend("jnp"), jnn.fuse(fused):
                memo[fused] = _tagged_pairs(
                    jcapture(lambda p, t: lm_forward(p, t, jcfg), jparams,
                             jnp.asarray(toks, jnp.int32)), jparse_scope)
        return memo[fused]
    return toks, get


@pytest.mark.parametrize("port_backend", BACKENDS)
@pytest.mark.parametrize("fused", [False, True])
def test_capture_tags_the_mixer_sites_as_jax(jax_sites, port_backend, fused):
    toks, get = jax_sites
    _, cfg, _, params = _setup()
    with tnn.backend(port_backend), tnn.fuse(fused):
        recs = capture(TT.lm_forward, params, _t(toks), cfg)
    want = get(fused)
    assert {("memory", "causal_conv1d"), ("activation", "mlstm_gates"),
            ("logit", "mlstm_dmatrix"), ("gemm", "mlstm_intra"),
            ("gemm", "mlstm_inter"), ("normalization", "mlstm_normalizer"),
            ("elementwise", "slstm_scan")} <= want
    assert ("fused", "fused_geglu") in want if fused else \
        ("activation", "geglu") in want
    assert _tagged_pairs(recs, parse_scope) == want


def test_bridge_carries_the_pattern_repeats():
    """16 layers: JAX's tree stacks two repeats of the 8-layer pattern in
    its scan (no lead, no trail; the second repeat the first one's weights
    scaled by 0.9); port layer i is the scan's entry i % 8 at repeat i // 8,
    every leaf."""
    jcfg, cfg, jparams, _ = _setup()
    assert not jparams["lead"] and not jparams["trail"]
    scan = _np(jax.tree_util.tree_map(lambda a: jnp.concatenate([a, a * 0.9]),
                                      jparams["scan"]))
    cfg16 = cfg.replace(n_layers=16)
    params = bridge.params_from_jax(dict(_np(jparams), scan=scan), cfg16,
                                    device="cpu")
    assert len(params["layers"]) == 16
    for i, layer in enumerate(params["layers"]):
        want = jax.tree_util.tree_map(lambda a, r=i // 8: a[r], scan[i % 8])
        got = bridge._map(lambda t: t.numpy(), layer)
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want)
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(g, w)
