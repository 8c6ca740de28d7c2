"""The port's dense LMs, engine and capture against the JAX package, on the
same weights: bridged ``reduced(llama2-7b)`` and ``reduced(gpt2-xl)``
params from the JAX ``init_lm``, f32 on the CPU (XLA:CPU cannot run bf16
dots), each unfused and under fusion (the port's ``nn.fuse()`` against
JAX's ``nn.fuse()``).

The port's plain backend (``"torch"``) is held against the JAX ``jnp``
backend, and its kernel backend (``"cuda"``, whose wrappers take their
plain versions for CPU tensors) against ``pallas_interpret``."""

import contextlib

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
from repro_torch.core import capture, parse_scope, profile_measured  # noqa: E402
from repro_torch.core.taxonomy import OpGroup  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402

BACKENDS = [("torch", "jnp"), ("cuda", "pallas_interpret")]
MAX_LEN = 48
MODELS = [("llama2-7b", False), ("llama2-7b", True), ("gpt2-xl", False),
          ("gpt2-xl", True)]


@pytest.fixture(scope="module", params=MODELS,
                ids=[f"{a}-{'fused' if f else 'unfused'}" for a, f in MODELS])
def model(request):
    arch, fused = request.param
    jcfg = jreduced(jget_config(arch))
    cfg = reduced(get_config(arch))
    jparams = init_lm(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                    cfg, device="cpu")
    return jcfg, cfg, jparams, params, fused


@contextlib.contextmanager
def both_fused(fused):
    """The fusion switch of both packages, set alike."""
    with jnn.fuse(fused), tnn.fuse(fused):
        yield


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


@pytest.mark.parametrize("port_backend,jax_backend", BACKENDS)
def test_lm_forward_logits_match(model, port_backend, jax_backend):
    jcfg, cfg, jparams, params, fused = model
    toks = _tokens(cfg, 2, 13)
    with jnn.backend(jax_backend), both_fused(fused):
        want = jax.jit(lambda p, t: lm_forward(p, t, jcfg))(
            jparams, jnp.asarray(toks, jnp.int32))
    with tnn.backend(port_backend), both_fused(fused):
        got = TT.lm_forward(params, torch.from_numpy(toks), cfg)
    assert got.shape == (2, 13, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("port_backend,jax_backend", BACKENDS)
def test_greedy_prefill_and_16_decode_tokens_identical(model, port_backend,
                                                       jax_backend):
    jcfg, cfg, jparams, params, fused = model
    toks = _tokens(cfg, 2, 9, seed=1)
    n_steps = 16

    with jnn.backend(jax_backend), both_fused(fused):
        prefill = jax.jit(lambda p, t: lm_prefill(p, t, jcfg, max_len=MAX_LEN))
        decode = jax.jit(lambda p, t, i, c: lm_decode(p, t, i, c, jcfg))
        logits, caches = prefill(jparams, jnp.asarray(toks, jnp.int32))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        want = [np.asarray(tok)]
        for i in range(n_steps):
            logits, caches = decode(jparams, tok, jnp.int32(9 + i), caches)
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            want.append(np.asarray(tok))

    with tnn.backend(port_backend), both_fused(fused):
        logits, tcaches = TT.lm_prefill(params, torch.from_numpy(toks), cfg,
                                        max_len=MAX_LEN)
        t = torch.argmax(logits, dim=-1)
        got = [t.numpy()]
        for i in range(n_steps):
            logits, tcaches = TT.lm_decode(params, t, 9 + i, tcaches, cfg)
            t = torch.argmax(logits, dim=-1)
            got.append(t.numpy())
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


def test_prefill_caches_match_bridged_jax_caches(model):
    jcfg, cfg, jparams, params, fused = model
    toks = _tokens(cfg, 1, 11, seed=2)
    lengths = np.array([7], np.int32)
    with jnn.backend("jnp"), both_fused(fused):
        _, jcaches = jax.jit(lambda p, t, n: lm_prefill(
            p, t, jcfg, max_len=MAX_LEN, lengths=n))(
                jparams, jnp.asarray(toks, jnp.int32), jnp.asarray(lengths))
    want = bridge.caches_from_jax(jax.tree_util.tree_map(np.asarray, jcaches),
                                  cfg, device="cpu")
    with tnn.backend("torch"), both_fused(fused):
        _, got = TT.lm_prefill(params, torch.from_numpy(toks), cfg,
                               max_len=MAX_LEN,
                               lengths=torch.from_numpy(lengths))
    assert len(got) == len(want) == cfg.n_layers
    for g, w in zip(got, want):
        for key in ("k", "v"):
            assert g[key].shape == (1, MAX_LEN, cfg.n_kv_heads,
                                    cfg.resolved_head_dim)
            np.testing.assert_allclose(g[key].numpy(), w[key].numpy(),
                                       atol=1e-5)


@pytest.mark.parametrize("with_eos", [False, True])
def test_engine_tokens_match_jax_engine(model, with_eos):
    jcfg, cfg, jparams, params, fused = model
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
               for n in (5, 12, 3, 9)]
    budgets = [6, 4, 7, 5]

    def serve(engine):
        uids = [engine.add_request(p, max_new_tokens=m)
                for p, m in zip(prompts, budgets)]
        done = {r.uid: r.output for r in engine.run()}
        return [done[u] for u in uids], engine.stats

    eos = None
    if with_eos:      # a token the first request emits mid-stream
        with jnn.backend("jnp"):
            first, _ = serve(JEngine(jcfg, jparams, max_batch=2,
                                     max_len=MAX_LEN, fused=fused))
        eos = first[0][2]
    with jnn.backend("jnp"):
        want, _ = serve(JEngine(jcfg, jparams, max_batch=2, max_len=MAX_LEN,
                                eos_id=eos, fused=fused))
    got, stats = serve(Engine(cfg, params, max_batch=2, max_len=MAX_LEN,
                              eos_id=eos, fused=fused))
    assert not tnn.fusion_enabled()     # the engine restores the switch
    assert got == want
    assert stats.completed == 4 and stats.first_tokens == 4
    assert stats.decode_tokens == sum(len(o) for o in got) - 4
    if with_eos:
        assert got[0][-1] == eos and len(got[0]) <= 3
    else:
        assert [len(o) for o in got] == budgets


def _tagged_pairs(records, parse):
    return {(r.group.value, r.op_site) for r in records if parse(r.scope)}


@pytest.mark.parametrize("port_backend", ["torch", "cuda"])
def test_capture_tagged_sites_match_jax_capture(model, port_backend):
    jcfg, cfg, jparams, params, fused = model
    toks = _tokens(cfg, 1, 8, seed=4)
    with jnn.backend("jnp"), both_fused(fused):
        jrecs = jcapture(lambda p, t: lm_forward(p, t, jcfg), jparams,
                         jnp.asarray(toks, jnp.int32))
    with tnn.backend(port_backend), both_fused(fused):
        recs = capture(TT.lm_forward, params, torch.from_numpy(toks), cfg)
    want = _tagged_pairs(jrecs, jparse_scope)
    assert ("gemm", "flash_attention") in want
    assert (("fused", "fused_attn_decode") not in want) and \
        any(g == "fused" for g, _ in want) == fused
    assert _tagged_pairs(recs, parse_scope) == want


def _kernel_sites(cfg, fused):
    """{kernel op: ((group, op_site), ops per forward)} of one forward on
    the kernel backend; ``n`` layers give the launch counts the card's
    wrappers count (n = 32 and 48 at full depth)."""
    n = cfg.n_layers
    sites = {"attention_core": (("gemm", "flash_attention"), n)}
    if cfg.norm == "rmsnorm":
        sites["swiglu"] = (("fused", "fused_swiglu") if fused
                           else ("activation", "swiglu"), n)
        sites["rms_norm"] = (("normalization", "rms_norm"),
                             n + 1 if fused else 2 * n + 1)
        if fused:
            sites["fused_add_rms_norm"] = (("fused", "fused_add_rms_norm"), n)
            sites["rope"] = (("fused", "fused_rope"), 2 * n)
    else:
        sites["layer_norm"] = (("normalization", "layer_norm"),
                               n + 1 if fused else 2 * n + 1)
        if fused:
            sites["fused_add_layer_norm"] = (("fused", "fused_add_layer_norm"),
                                             n)
    return sites


def test_capture_sees_kernel_ops_and_untagged_decode_is_fused(model):
    _, cfg, _, params, fused = model
    toks = torch.from_numpy(_tokens(cfg, 2, 6, seed=5))
    with tnn.backend("cuda"), tnn.fuse(fused):
        recs = capture(TT.lm_forward, params, toks, cfg)
        got = {}
        for r in recs:
            if r.prim.startswith("repro_torch."):
                name = r.prim.split(".", 1)[1]
                site, count = got.get(name, ((r.group.value, r.op_site), 0))
                assert site == (r.group.value, r.op_site)
                got[name] = (site, count + 1)
        assert got == _kernel_sites(cfg, fused)
        _, caches = TT.lm_prefill(params, toks, cfg, max_len=16)
        recs = capture(TT.lm_decode, params, toks[:, 0], 6, caches, cfg)
    dec = [r for r in recs if r.prim == "repro_torch.decode_core"]
    assert len(dec) == cfg.n_layers
    site = "fused_attn_decode" if fused else "repro_torch.decode_core"
    assert all(r.group is OpGroup.FUSED and r.op_site == site for r in dec)


def test_measured_profile_split_on_cpu(model):
    _, cfg, _, params, fused = model
    toks = torch.from_numpy(_tokens(cfg, 1, 8, seed=6))
    with tnn.backend("torch"), tnn.fuse(fused):
        prof = profile_measured(TT.lm_forward, params, toks, cfg,
                                name=cfg.name, repeats=1)
    split = prof.split
    assert prof.mode == "measured_cpu" and prof.n_ops > 0
    assert split["gemm_s"] > 0 and split["nongemm_s"] > 0
    assert abs(split["gemm_frac"] + split["nongemm_frac"] - 1.0) < 1e-9 \
        or split["other_s"] > 0
    assert prof.top_nongemm_groups(3)[0][0] in {g.value for g in OpGroup}
    assert sum(t for _, t, _ in prof.top_op_sites(1000)) == \
        pytest.approx(prof.total_seconds)


def test_kernel_backend_counts_no_cpu_launches(model):
    _, cfg, _, params, fused = model
    ops.reset_launches()
    with tnn.backend("cuda"), tnn.fuse(fused):
        TT.lm_forward(params, torch.from_numpy(_tokens(cfg, 1, 4)), cfg)
    assert sum(ops.launches.values()) == 0
