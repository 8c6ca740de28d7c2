"""musicgen-large in the port against the JAX package, on the CPU:
sinusoidal positions over precomputed frame embeddings (its EnCodec
frontend is a stub, as in JAX), served through the step builders.

``sinusoidal_embedding`` is held to JAX's table bit for bit in the
frequencies and to 1e-7 up to position 32768; bridged
``reduced(musicgen-large)`` params (2 layers, d 256, 4 heads of 64,
LayerNorm, GELU with biases, a 512-token head) from the JAX ``init_lm``,
f32, give JAX's forward logits, and ``make_prefill_step`` /
``make_serve_step`` on right-padded frame batches give JAX's prefill
logits and greedy codebook tokens, on the port's plain and kernel
backends (the wrappers take their plain versions here); the capture tags
the table ``pos_sinusoidal`` as JAX's does. The engines serve token
prompts only and refuse the model, as JAX's ``launch/serve.py`` does.
"""

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
from repro.models.transformer import sinusoidal_embedding as jsinusoidal  # noqa: E402
from repro.serving import make_prefill_step as jmake_prefill_step  # noqa: E402
from repro.serving import make_serve_step as jmake_serve_step  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import capture, parse_scope  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import (Engine, PagedEngine, make_prefill_step,  # noqa: E402
                                 make_serve_step)

ARCH = "musicgen-large"
TOL = 2e-5
MAX_LEN = 64
#: right-padded frame rows (the prefill's lengths), 8 greedy decode steps
LENGTHS = (40, 23, 7, 1)
STEPS = 8


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, cfg = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    jparams = init_lm(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                    cfg, device="cpu")
    return jcfg, cfg, jparams, params


def _frames(cfg, *shape, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)


def test_sinusoidal_table_matches_jax_to_32768():
    """The f32 table at the first 64 positions, every 7th up to 32767 and
    the last two (every frequency of d 2048, as musicgen-large's) within
    1e-7 of JAX's: the frequencies are rounded once from float64, which
    gives JAX's f32 ones exactly."""
    pos = np.concatenate([np.arange(64), np.arange(64, 32768, 7),
                          [32766, 32767]]).astype(np.int32).reshape(2, -1)
    want = np.asarray(jsinusoidal(jnp.asarray(pos), 2048))
    got = TT.sinusoidal_embedding(torch.from_numpy(pos), 2048)
    assert got.dtype == torch.float32 and got.shape == (*pos.shape, 2048)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7, rtol=0)
    # the frequencies themselves, equal bit for bit
    half = 1024
    freq = np.asarray(10000.0 ** (-jnp.arange(half, dtype=jnp.float32) / half))
    expo = -torch.arange(half, dtype=torch.float32) / half
    np.testing.assert_array_equal(
        torch.pow(10000.0, expo.double()).float().numpy(), freq)


def test_config_and_bridge():
    jcfg, cfg, jparams, params = _setup()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab_size,
            cfg.pos_emb, cfg.input_mode) == (2, 256, 4, 512, "sinusoidal",
                                             "embeddings")
    assert set(params) == {"final_norm", "head", "layers"}
    TT.check_supported(get_config(ARCH), serving=True)
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.resolved_head_dim) == (48, 2048, 64)


@pytest.mark.parametrize("port_backend,fused", [("torch", False),
                                                ("cuda", False),
                                                ("cuda", True)])
def test_forward_logits_match_jax(port_backend, fused):
    jcfg, cfg, jparams, params = _setup()
    x = _frames(cfg, 2, 40)
    with jnn.backend("jnp"), jnn.fuse(fused):
        want = jax.jit(lambda p, t: lm_forward(p, t, jcfg))(jparams,
                                                           jnp.asarray(x))
    with tnn.backend(port_backend), tnn.fuse(fused):
        got = TT.lm_forward(params, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.fixture(scope="module")
def served():
    """JAX's prefill_step on 4 right-padded frame rows, then STEPS greedy
    serve_steps each fed a fresh frame a row: (frames, lengths, each
    step's frames, the prefill logits, the tokens of every step)."""
    jcfg, cfg, jparams, _ = _setup()
    x = _frames(cfg, len(LENGTHS), max(LENGTHS))
    for i, n in enumerate(LENGTHS):
        x[i, n:] = 0.0                                   # right-padded
    lengths = np.array(LENGTHS, np.int32)
    feeds = _frames(cfg, STEPS, len(LENGTHS), seed=1)
    with jnn.backend("jnp"):
        prefill = jax.jit(jmake_prefill_step(jcfg, MAX_LEN))
        serve = jax.jit(jmake_serve_step(jcfg, greedy=True))
        logits, caches = prefill(jparams, jnp.asarray(x), jnp.asarray(lengths))
        toks = []
        key = jax.random.PRNGKey(0)
        for s in range(STEPS):
            nxt, caches = serve(jparams, jnp.asarray(feeds[s]),
                                jnp.asarray(lengths + s), caches, key)
            toks.append(np.asarray(nxt))
    return x, lengths, feeds, np.asarray(logits), np.stack(toks)


@pytest.mark.parametrize("port_backend,fused", [("torch", False),
                                                ("cuda", True)])
def test_prefill_and_serve_steps_match_jax(served, port_backend, fused):
    """``make_prefill_step``'s last logits (each row's own last frame) and
    ``make_serve_step``'s greedy codebook tokens over STEPS steps, each fed
    a (B, d_model) frame, equal JAX's step builders'."""
    _, cfg, _, params = _setup()
    x, lengths, feeds, want_logits, want_toks = served
    prefill = make_prefill_step(cfg, MAX_LEN, fused=fused)
    serve = make_serve_step(cfg, greedy=True, fused=fused)
    with tnn.backend(port_backend):
        logits, caches = prefill(params, torch.from_numpy(x),
                                 torch.from_numpy(lengths))
        toks = []
        for s in range(STEPS):
            nxt, caches = serve(params, torch.from_numpy(feeds[s]),
                                torch.from_numpy(lengths + s), caches)
            toks.append(nxt.numpy())
    assert logits.shape == (len(LENGTHS), cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(np.stack(toks), want_toks)


def test_capture_tags_the_sinusoidal_table_as_jax():
    jcfg, cfg, jparams, params = _setup()
    x = _frames(cfg, 1, 8)
    with jnn.backend("jnp"):
        jrecs = jcapture(lambda p, t: lm_forward(p, t, jcfg), jparams,
                         jnp.asarray(x))
    with tnn.backend("torch"):
        recs = capture(TT.lm_forward, params, torch.from_numpy(x), cfg)

    def pairs(rs, parse):
        return {(r.group.value, r.op_site) for r in rs if parse(r.scope)}
    want = pairs(jrecs, jparse_scope)
    assert ("memory", "pos_sinusoidal") in want
    assert pairs(recs, parse_scope) == want


def test_engines_refuse_frame_embeddings():
    _, cfg, _, params = _setup()
    for engine in (Engine, PagedEngine):
        with pytest.raises(ValueError, match="frame embeddings"):
            engine(cfg, params, max_batch=2, max_len=MAX_LEN)
