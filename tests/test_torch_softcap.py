"""Gemma 2's logit caps in the port against the JAX package, on the CPU.

The attention cap (``softcap``: ``tanh(s / cap) * cap`` on the scaled
scores, before the mask) in the plain versions the kernel wrappers take
for CPU tensors, against JAX's naive reference and its Pallas template
kernels in interpret mode; then whole models with the caps set through
``cfg.replace`` (no new config): reduced gemma3-27b with Gemma 2's
published caps (attention 50, final logits 30: google/gemma-2-27b's
``config.json``), past its 64-token window, and reduced llama2-7b's
chunked prefill (``lm_extend``) and ``PagedEngine``, each on bridged JAX
weights in f32. The port's kernel backend (``"cuda"``, whose wrappers
take their plain versions here) and its plain backend (``"torch"``) are
held against ``jnp``, the kernel-level cases against the Pallas kernels.
"""

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
from repro.kernels import attn_template as JT  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import init_lm, lm_decode, lm_forward, lm_prefill  # noqa: E402
from repro.models import lm_extend as jlm_extend  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import PagedEngine as JPagedEngine  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import Engine, PagedEngine  # noqa: E402

#: Gemma 2's published caps (google/gemma-2-27b config.json)
CAPS = dict(attn_logit_softcap=50.0, final_logit_softcap=30.0)
#: the plain versions against JAX's (tests/test_attn_template.py's limit)
KERNEL_ATOL = 3e-5
#: whole models in f32
MODEL_TOL = 2e-5
MAX_LEN = 128


def _qkv(rng, b, sq, skv, hq, hkv, d, dv=None):
    dv = d if dv is None else dv
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, dv))]


# (B, Sq, Skv, Hq, Hkv, D, Dv, mask, window, q_offset, cap): the shapes of
# tests/test_attn_template.py, the three masks, caps 50, 20 and 5
PREFILL_CASES = [(1, 40, 100, 4, 2, 32, 16, "causal", None, 60, 5.0),
                 (1, 40, 30, 4, 2, 32, 32, "window", 6, 0, 20.0),
                 (2, 30, 45, 4, 1, 32, 32, "full", None, 0, 50.0)]


@pytest.mark.parametrize("case", PREFILL_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_capped_attention_matches_jax_reference_and_pallas(case):
    """``ref.attention`` and ``ops.attention_*`` (their plain path on the
    CPU) with the cap against JAX's ``ref.attention`` and the Pallas
    template kernel in interpret mode; a row that sees no key (the window
    of 6 past the 30 keys) is zeros in all of them."""
    b, sq, skv, hq, hkv, d, dv, mask, window, off, cap = case
    q, k, v = _qkv(np.random.default_rng(0), b, sq, skv, hq, hkv, d, dv)
    causal = mask != "full"
    want = np.asarray(jref.attention(q, k, v, causal=causal, window=window,
                                     q_offset=off, softcap=cap))
    pallas = np.asarray(JT.attention_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_offset=off, softcap=cap, block_q=64, block_k=128,
        interpret=True))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    got = ref.attention(qt, kt, vt, q_offset=off, causal=causal,
                        window=window, softcap=cap)
    if mask == "causal":
        op = ops.attention_core(qt, kt, vt, q_offset=off, softcap=cap)
    elif mask == "window":
        op = ops.attention_window(qt, kt, vt, window, q_offset=off,
                                  softcap=cap)
    else:
        op = ops.attention_full(qt, kt, vt, softcap=cap)
    for w in (want, pallas):
        np.testing.assert_allclose(got.numpy(), w, atol=KERNEL_ATOL, rtol=0)
    np.testing.assert_array_equal(op.numpy(), got.numpy())
    uncapped = ref.attention(qt, kt, vt, q_offset=off, causal=causal,
                             window=window)
    assert float((uncapped - got).abs().max()) > 1e-4     # the cap bites
    dead = np.abs(want).max(-1) == 0
    assert not got.numpy()[dead].any()


@pytest.mark.parametrize("scale,cap", [(None, 50.0), (1.0, 5.0)])
def test_capped_decode_matches_jax_reference_and_pallas(scale, cap):
    """``ref.decode_attention`` / ``ops.decode_core`` with the cap against
    JAX's reference, its decode oracle and the Pallas decode kernel in
    interpret mode (tests/test_attn_template.py's shape, Dv != Dk); a row
    of length 0 is zeros."""
    q, k, v = _qkv(np.random.default_rng(1), 3, 1, 24, 4, 1, 32, 16)
    lengths = np.array([10, 24, 0], np.int32)
    want = np.asarray(jref.attention(q, k, v, causal=False, lengths=lengths,
                                     scale=scale, softcap=cap))
    oracle = np.asarray(jref.decode_attention(q, k, v, lengths, scale=scale,
                                              softcap=cap))
    pallas = np.asarray(JT.decode_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        scale=scale, softcap=cap, interpret=True))
    qt, kt, vt, n = map(torch.from_numpy, (q, k, v, lengths))
    got = ref.decode_attention(qt, kt, vt, n, scale=scale, softcap=cap)
    for w in (want, oracle, pallas):
        np.testing.assert_allclose(got.numpy(), w, atol=KERNEL_ATOL, rtol=0)
    np.testing.assert_array_equal(
        ops.decode_core(qt, kt, vt, n, scale=scale, softcap=cap).numpy(),
        got.numpy())
    np.testing.assert_array_equal(
        tnn.fused_attn_decode(qt, kt, vt, n, scale=scale, softcap=cap).numpy(),
        got.numpy())
    assert not got[2].any()


def test_wrappers_refuse_a_cap_they_cannot_take():
    """A cap <= 0 raises on any device; the wide instantiations' refusal
    (MLA's and head dim 256's) is held on the card (scripts/softcap_check.py,
    chip_smoke.py phase 2)."""
    q = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="softcap"):
        ops.attention_core(q, q, q, softcap=0.0)
    with pytest.raises(ValueError, match="softcap"):
        ops.decode_core(q[:, :1], q, q, torch.ones(1, dtype=torch.int32),
                        softcap=-1.0)


# -- reduced gemma3-27b with Gemma 2's caps ------------------------------------

@functools.lru_cache(maxsize=None)
def _setup(arch, **overrides):
    jcfg = jreduced(jget_config(arch)).replace(**overrides)
    cfg = reduced(get_config(arch)).replace(**overrides)
    jparams = init_lm(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                    cfg, device="cpu")
    return jcfg, cfg, jparams, params


@contextlib.contextmanager
def both(port_backend, jax_backend, fused=False):
    with jnn.backend(jax_backend), tnn.backend(port_backend), \
            jnn.fuse(fused), tnn.fuse(fused):
        yield


@pytest.fixture(scope="module")
def gemma():
    """Reduced gemma3-27b with the caps, and JAX's greedy prefill + 8
    decode tokens of a right-padded batch of 90 and 40 (past the 64-token
    window, one ring wrapping) on its ``jnp`` path, built once."""
    jcfg, cfg, jparams, params = _setup("gemma3-27b", **CAPS)
    rng = np.random.default_rng(7)
    lens = np.array([90, 40], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (2, 96))
    toks[1, 40:] = 0
    with jnn.backend("jnp"):
        logits, caches = jax.jit(lambda p, t, n: lm_prefill(
            p, t, jcfg, max_len=MAX_LEN, lengths=n))(
                jparams, jnp.asarray(toks, jnp.int32), jnp.asarray(lens))
        decode = jax.jit(lambda p, t, i, c: lm_decode(p, t, i, c, jcfg))
        steps = [np.asarray(logits)]
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        for i in range(8):
            logits, caches = decode(jparams, tok, jnp.asarray(lens + i), caches)
            steps.append(np.asarray(logits))
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
    return jcfg, cfg, jparams, params, toks, lens, steps


def test_gemma_forward_with_caps_matches_jax(gemma):
    jcfg, cfg, jparams, params, toks, _, _ = gemma
    with both("torch", "jnp"):
        want = jax.jit(lambda p, t: lm_forward(p, t, jcfg))(
            jparams, jnp.asarray(toks, jnp.int32))
        got = TT.lm_forward(params, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    assert float(got.abs().max()) < CAPS["final_logit_softcap"]


@pytest.mark.parametrize("port_backend,fused", [("cuda", False),
                                                ("torch", False),
                                                ("cuda", True)])
def test_gemma_prefill_and_decode_with_caps_match_jax(gemma, port_backend,
                                                      fused):
    """Prefill past the window and 8 greedy decode steps: every step's
    logits within f32's limit of JAX's (the chunked capped prefill, the
    capped decode chain), on the port's kernel path (``decode_core``'s
    plain version with the cap), its plain chain and its fused operator.
    The kernel-level tests above hold the capped plain versions to JAX's
    Pallas kernels."""
    _, cfg, _, params, toks, lens, steps = gemma
    with tnn.backend(port_backend), tnn.fuse(fused):
        logits, caches = TT.lm_prefill(params, torch.from_numpy(toks), cfg,
                                       max_len=MAX_LEN,
                                       lengths=torch.from_numpy(lens))
        got = [logits.numpy()]
        tok = torch.from_numpy(np.argmax(steps[0], -1))
        for i in range(8):
            logits, caches = TT.lm_decode(params, tok,
                                          torch.from_numpy(lens + i), caches,
                                          cfg)
            got.append(logits.numpy())
            tok = torch.from_numpy(np.argmax(steps[i + 1], -1))
    for g, w in zip(got, steps):
        np.testing.assert_allclose(g, w, atol=MODEL_TOL, rtol=MODEL_TOL)


def test_gemma_engine_tokens_with_caps_match_jax_engine(gemma):
    jcfg, cfg, jparams, params, _, _, _ = gemma
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
               for n in (100, 70)]

    def serve(engine):
        uids = [engine.add_request(p, max_new_tokens=5) for p in prompts]
        done = {r.uid: r.output for r in engine.run()}
        return [done[u] for u in uids]

    with jnn.backend("jnp"):
        want = serve(JEngine(jcfg, jparams, max_batch=2, max_len=MAX_LEN,
                             fused=True))
    got = serve(Engine(cfg, params, max_batch=2, max_len=MAX_LEN, fused=True))
    assert got == want and all(len(o) == 5 for o in got)


# -- reduced llama2-7b with the caps: chunked prefill and paging ---------------

def test_llama_extend_and_paged_tokens_with_caps_match_jax():
    """``lm_extend`` chunks at absolute offsets (the capped causal
    attention at ``q_offset``) against JAX's chunked capped attention, and
    the ``PagedEngine``'s chunked and prefix-hit admissions' tokens
    against JAX's ``PagedEngine`` on the same requests."""
    jcfg, cfg, jparams, params = _setup("llama2-7b", **CAPS)
    toks = np.random.default_rng(5).integers(1, cfg.vocab_size, (1, 45))
    with jnn.backend("jnp"):
        _, jc = lm_prefill(jparams, jnp.asarray(toks[:, :16], jnp.int32), jcfg,
                           max_len=64)
    caches = bridge.caches_from_jax(jax.tree_util.tree_map(np.asarray, jc),
                                    cfg, device="cpu")
    for start, width in ((16, 16), (32, 13)):
        chunk = toks[:, start:start + width]
        with jnn.backend("jnp"):
            want, jc = jax.jit(lambda p, t, c, s=start: jlm_extend(
                p, t, s, c, jcfg))(jparams, jnp.asarray(chunk, jnp.int32), jc)
        with tnn.backend("cuda"):
            got, caches = TT.lm_extend(params, torch.from_numpy(chunk), start,
                                       caches, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=MODEL_TOL, rtol=MODEL_TOL)
    rng = np.random.RandomState(2)
    prefix = rng.randint(1, cfg.vocab_size, size=24).tolist()
    reqs = [prefix + rng.randint(1, cfg.vocab_size, size=n).tolist()
            for n in (6, 20)]
    kw = dict(max_batch=1, max_len=64, block_size=8, chunk_size=16)

    def serve(engine):
        uids = [engine.add_request(p, max_new_tokens=4) for p in reqs]
        done = {r.uid: r.output for r in engine.run()}
        return [done[u] for u in uids], engine

    with jnn.backend("jnp"):
        want, _ = serve(JPagedEngine(jcfg, jparams, **kw))
    got, eng = serve(PagedEngine(cfg, params, **kw))
    assert got == want and eng.extend_chunks > 0
    assert eng.prefix_cache.hit_rate > 0
