"""gemma3-27b in the port against the JAX package, on the same weights:
bridged ``reduced(gemma3-27b)`` params from the JAX ``init_lm`` (6 layers,
5 local and 1 global, d 256, 4 heads of 64, window 64, vocab 512), f32 on
the CPU, each unfused and under fusion.

Sequences run past the reduced window of 64, so the local layers' window
bites in prefill, their rings fill from the true prompt tail under
right-padding and wrap in decode. The port's plain backend (``"torch"``)
is held against the JAX ``jnp`` backend, its kernel backend (``"cuda"``,
whose wrappers take their plain versions for CPU tensors) against
``pallas_interpret``: on the plain path a ring's decode mask comes from
its position side-car, on the kernel path from the prefix length
``min(pos + 1, w)``, and both must give JAX's tokens."""

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
from repro.serving import Engine as JEngine  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import capture, parse_scope  # noqa: E402
from repro_torch.core.taxonomy import OpGroup  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402

ARCH = "gemma3-27b"
BACKENDS = [("torch", "jnp"), ("cuda", "pallas_interpret")]
MAX_LEN = 128


@functools.lru_cache(maxsize=None)
def _setup(**overrides):
    """(jax config, port config, JAX params, bridged port params)."""
    jcfg = jreduced(jget_config(ARCH)).replace(**overrides)
    cfg = reduced(get_config(ARCH)).replace(**overrides)
    jparams = init_lm(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                    cfg, device="cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module", params=[False, True],
                ids=["unfused", "fused"])
def model(request):
    return (*_setup(), request.param)


@contextlib.contextmanager
def both(port_backend, jax_backend, fused):
    """Both packages' backend and fusion switches, set alike."""
    with jnn.backend(jax_backend), tnn.backend(port_backend), \
            jnn.fuse(fused), tnn.fuse(fused):
        yield


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def test_reduced_config_is_the_smoke_shape():
    _, cfg, _, params = _setup()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.window_size, cfg.vocab_size) == \
        (6, 256, 4, 4, 64, 64, 512)
    assert cfg.layer_kinds() == ("local",) * 5 + ("attn",)
    layer = params["layers"][0]
    assert {"post_norm1", "post_norm2"} <= set(layer)
    assert {"q_norm", "k_norm"} <= set(layer["mixer"])
    assert "w_gate" in layer["ffn"] and "head" not in params


def _logits_case(overrides, port_backend, jax_backend, fused, seq=96):
    jcfg, cfg, jparams, params = _setup(**overrides)
    toks = _tokens(cfg, 2, seq)
    with both(port_backend, jax_backend, fused):
        want = jax.jit(lambda p, t: lm_forward(p, t, jcfg))(
            jparams, jnp.asarray(toks, jnp.int32))
        got = TT.lm_forward(params, torch.from_numpy(toks), cfg)
    assert got.shape == (2, seq, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("port_backend,jax_backend", BACKENDS)
def test_lm_forward_logits_match(model, port_backend, jax_backend):
    _logits_case({}, port_backend, jax_backend, model[-1])


@pytest.mark.parametrize("port_backend,jax_backend", BACKENDS)
def test_lm_forward_logits_match_with_gqa(port_backend, jax_backend):
    _logits_case({"n_kv_heads": 2}, port_backend, jax_backend, False)


# (prompt lengths, padded width): one prompt of 56 whose decode wraps the
# ring at 64; a right-padded batch of 90 and 40 whose first ring fills
# from the true tail
DECODE_CASES = {"wrap_at_64": ((56,), 56), "padded_90_40": ((90, 40), 96)}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
@pytest.mark.parametrize("port_backend,jax_backend", BACKENDS)
def test_greedy_prefill_and_16_decode_tokens_identical(model, port_backend,
                                                       jax_backend, case):
    jcfg, cfg, jparams, params, fused = model
    lens, width = DECODE_CASES[case]
    toks = _tokens(cfg, len(lens), width, seed=1)
    for i, n in enumerate(lens):
        toks[i, n:] = 0                                  # right-padded
    lengths = np.array(lens, np.int32)
    n_steps = 16

    with both(port_backend, jax_backend, fused):
        prefill = jax.jit(lambda p, t, n: lm_prefill(p, t, jcfg,
                                                     max_len=MAX_LEN,
                                                     lengths=n))
        decode = jax.jit(lambda p, t, i, c: lm_decode(p, t, i, c, jcfg))
        logits, caches = prefill(jparams, jnp.asarray(toks, jnp.int32),
                                 jnp.asarray(lengths))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        want = [np.asarray(tok)]
        for i in range(n_steps):
            logits, caches = decode(jparams, tok, jnp.asarray(lengths + i),
                                    caches)
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            want.append(np.asarray(tok))

        logits, tcaches = TT.lm_prefill(params, torch.from_numpy(toks), cfg,
                                        max_len=MAX_LEN,
                                        lengths=torch.from_numpy(lengths))
        t = torch.argmax(logits, dim=-1)
        got = [t.numpy()]
        for i in range(n_steps):
            logits, tcaches = TT.lm_decode(params, t,
                                           torch.from_numpy(lengths + i),
                                           tcaches, cfg)
            t = torch.argmax(logits, dim=-1)
            got.append(t.numpy())
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    # each ring's side-car holds the last (up to) 64 positions written
    ring = tcaches[0]["pos"].numpy()
    for row, n in zip(ring, lengths + n_steps - 1):
        last = list(range(max(n - 63, 0), n + 1))
        assert sorted(row) == [-1] * (64 - len(last)) + last


def test_prefill_caches_match_bridged_jax_caches(model):
    jcfg, cfg, jparams, params, fused = model
    toks = _tokens(cfg, 2, 96, seed=2)
    lengths = np.array([90, 40], np.int32)
    with both("torch", "jnp", fused):
        _, jcaches = jax.jit(lambda p, t, n: lm_prefill(
            p, t, jcfg, max_len=MAX_LEN, lengths=n))(
                jparams, jnp.asarray(toks, jnp.int32), jnp.asarray(lengths))
        _, got = TT.lm_prefill(params, torch.from_numpy(toks), cfg,
                               max_len=MAX_LEN,
                               lengths=torch.from_numpy(lengths))
    want = bridge.caches_from_jax(jax.tree_util.tree_map(np.asarray, jcaches),
                                  cfg, device="cpu")
    assert len(got) == len(want) == cfg.n_layers
    for kind, g, w in zip(cfg.layer_kinds(), got, want):
        assert set(g) == set(w) == ({"k", "v", "pos"} if kind == "local"
                                    else {"k", "v"})
        depth = cfg.window_size if kind == "local" else MAX_LEN
        for key in ("k", "v"):
            assert g[key].shape == (2, depth, cfg.n_kv_heads,
                                    cfg.resolved_head_dim)
            np.testing.assert_allclose(g[key].numpy(), w[key].numpy(),
                                       atol=1e-5)
        if kind == "local":
            assert g["pos"].dtype == w["pos"].dtype == torch.int32
            np.testing.assert_array_equal(g["pos"].numpy(), w["pos"].numpy())
    # row 1 (40 tokens) holds positions 0..39 and 24 empty slots
    pos = got[0]["pos"].numpy()
    assert list(pos[1, :40]) == list(range(40)) and (pos[1, 40:] == -1).all()
    assert sorted(pos[0]) == list(range(26, 90))


def test_engine_tokens_match_jax_engine(model):
    jcfg, cfg, jparams, params, fused = model
    rng = np.random.default_rng(3)
    # buckets 128, 128, 8, 64: two prompts past the window, one that
    # wraps its ring while decoding, one short
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
               for n in (100, 70, 5, 60)]
    budgets = [6, 5, 7, 8]

    def serve(engine):
        uids = [engine.add_request(p, max_new_tokens=m)
                for p, m in zip(prompts, budgets)]
        done = {r.uid: r.output for r in engine.run()}
        return [done[u] for u in uids]

    with jnn.backend("jnp"):
        want = serve(JEngine(jcfg, jparams, max_batch=2, max_len=MAX_LEN,
                             fused=fused))
    got = serve(Engine(cfg, params, max_batch=2, max_len=MAX_LEN,
                       fused=fused))
    assert got == want and [len(o) for o in got] == budgets


def _tagged_pairs(records, parse):
    return {(r.group.value, r.op_site) for r in records if parse(r.scope)}


@pytest.mark.parametrize("port_backend", ["torch", "cuda"])
def test_capture_tagged_sites_match_jax_capture(model, port_backend):
    jcfg, cfg, jparams, params, fused = model
    toks = _tokens(cfg, 1, 8, seed=4)
    with jnn.backend("jnp"), jnn.fuse(fused):
        jrecs = jcapture(lambda p, t: lm_forward(p, t, jcfg), jparams,
                         jnp.asarray(toks, jnp.int32))
    with tnn.backend(port_backend), tnn.fuse(fused):
        recs = capture(TT.lm_forward, params, torch.from_numpy(toks), cfg)
    want = _tagged_pairs(jrecs, jparse_scope)
    assert ("fused", "fused_geglu") in want if fused else \
        ("activation", "geglu") in want
    assert ("elementwise", "scale") in want
    assert _tagged_pairs(recs, parse_scope) == want


def test_capture_sees_kernel_ops_per_forward_and_decode(model):
    """The kernel ops of one forward on the kernel backend, by site: the
    launch counts the card's wrappers count at full depth with n = 62
    layers, 52 of them local."""
    _, cfg, _, params, fused = model
    toks = torch.from_numpy(_tokens(cfg, 2, 80, seed=5))
    n, n_local = cfg.n_layers, cfg.layer_kinds().count("local")
    want = {"attention_window": (("gemm", "flash_attention"), n_local),
            "attention_core": (("gemm", "flash_attention"), n - n_local),
            # norm1, q/k-norm, post-norm1, (norm2), post-norm2, final
            "rms_norm": (("normalization", "rms_norm"),
                         5 * n + 1 if fused else 6 * n + 1)}
    if fused:
        want.update(geglu=(("fused", "fused_geglu"), n),
                    fused_add_rms_norm=(("fused", "fused_add_rms_norm"), n),
                    rope=(("fused", "fused_rope"), 2 * n))
    with tnn.backend("cuda"), tnn.fuse(fused):
        recs = capture(TT.lm_forward, params, toks, cfg)
        got = {}
        for r in recs:
            if r.prim.startswith("repro_torch."):
                name = r.prim.split(".", 1)[1]
                site, count = got.get(name, ((r.group.value, r.op_site), 0))
                assert site == (r.group.value, r.op_site)
                got[name] = (site, count + 1)
        assert got == want
        _, caches = TT.lm_prefill(params, toks, cfg, max_len=MAX_LEN)
        recs = capture(TT.lm_decode, params, toks[:, 0], 80, caches, cfg)
    dec = [r for r in recs if r.prim == "repro_torch.decode_core"]
    assert len(dec) == n
    # a ring's decode reads its w slots, a global layer's max_len
    assert sorted({r.in_shapes[1][1] for r in dec}) == [cfg.window_size,
                                                        MAX_LEN]
    assert all(r.group is OpGroup.FUSED for r in dec)
    # nothing of the ring bookkeeping is classed OTHER
    assert not [r.prim for r in recs if r.group is OpGroup.OTHER]


def test_bridge_carries_trailing_layers():
    """8 layers of a 6-layer pattern: JAX's layout is (lead 0, scan 6 x 1,
    trail 2), the port's 8 layers in order, and the logits agree."""
    jcfg, cfg, jparams, params = _setup(n_layers=8)
    assert len(jparams["trail"]) == 2 and not jparams["lead"]
    assert len(params["layers"]) == 8
    assert cfg.layer_kinds()[6:] == ("local", "local")
    np.testing.assert_array_equal(
        params["layers"][7]["mixer"]["wq"].numpy(),
        np.asarray(jparams["trail"][1]["mixer"]["wq"]))
    _logits_case({"n_layers": 8}, "torch", "jnp", False, seq=72)
