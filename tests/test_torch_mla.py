"""The port's MLA (``repro_torch/models/attention.py``: ``init_mla``,
``mla_forward``, ``mla_prefill``, ``mla_decode``, ``mla_extend``) against
the JAX package's (``repro/models/attention.py``), on bridged weights of
reduced deepseek-v2-lite-16b, f32 on the CPU.

The plain backend is held against JAX's ``jnp`` path, the kernel backend
(whose wrappers take their plain versions for CPU tensors) against
``pallas_interpret``, fused against fused; as in ``tests/test_attention.py``
and ``tests/test_attn_template.py``, decode agrees with the forward pass,
and the absorbed decode's three paths (the two-einsum chain, the decode
kernel's oracle, the fused operator) agree at the ulp level. The reduced
config's head dims (48 / 32 prefill, 80 / 64 absorbed decode) stay under
the narrow kernels' 128; the wide dims are held in
``tests/test_torch_attn_design.py`` and on the card."""

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
from repro.models import attention as JA  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch import nn  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import capture, parse_scope  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402

BACKENDS = [("torch", "jnp"), ("cuda", "pallas_interpret")]
S = 10


@pytest.fixture(scope="module")
def mla():
    jcfg = jreduced(jget_config("deepseek-v2-lite-16b"))
    cfg = reduced(get_config("deepseek-v2-lite-16b"))
    jp = JA.init_mla(jax.random.PRNGKey(1), jcfg)
    p = bridge.tensors_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    x = np.random.default_rng(0).standard_normal(
        (2, S + 1, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S + 1, dtype=np.int32), (2, 1))
    return jcfg, cfg, jp, p, x, pos


@pytest.fixture(scope="module")
def jax_forward(mla):
    """JAX's ``mla_forward`` over all S + 1 rows per (backend, fused), each
    computed once for the tests that hold the port against it."""
    jcfg, _, jp, _, x, pos = mla
    memo = {}

    def get(backend="jnp", fused=False):
        if (backend, fused) not in memo:
            with jnn.backend(backend), jnn.fuse(fused):
                memo[backend, fused] = np.asarray(JA.mla_forward(
                    jp, jnp.asarray(x), jcfg, jnp.asarray(pos)))
        return memo[backend, fused]
    return get


@pytest.fixture(scope="module")
def jax_prefill(mla):
    """JAX's ``mla_prefill`` of the first ``n`` rows (a cache of S + 2) per
    (backend, n): (output, cache), each computed once."""
    jcfg, _, jp, _, x, pos = mla
    memo = {}

    def get(backend="jnp", n=S):
        if (backend, n) not in memo:
            with jnn.backend(backend):
                memo[backend, n] = JA.mla_prefill(
                    jp, jnp.asarray(x[:, :n]), jcfg, jnp.asarray(pos[:, :n]),
                    max_len=S + 2)
        return memo[backend, n]
    return get


@pytest.fixture(scope="module")
def jax_extend(mla, jax_prefill):
    """JAX's ``mla_extend`` of rows 6..S after a prefill of 6 (jnp):
    (output, cache)."""
    jcfg, _, jp, _, x, _ = mla
    with jnn.backend("jnp"):
        return JA.mla_extend(jp, jnp.asarray(x[:, 6:S + 1]), jcfg,
                             jax_prefill("jnp", 6)[1], 6)


def test_init_mla_shapes_equal_jax(mla):
    jcfg, cfg, jp, p, _, _ = mla
    own = A.init_mla(torch.Generator().manual_seed(0), cfg)
    assert {n: tuple(t.shape) for n, t in own.items()} == \
        {n: tuple(a.shape) for n, a in jp.items()}
    assert cfg.qk_nope_dim + cfg.qk_rope_dim == 48
    assert cfg.kv_lora_rank + cfg.qk_rope_dim == 80


@pytest.mark.parametrize("port_backend,jax_backend", BACKENDS)
@pytest.mark.parametrize("fused", [False, True])
def test_mla_forward_matches_jax(mla, jax_forward, port_backend, jax_backend,
                                 fused):
    _, cfg, _, p, x, pos = mla
    want = jax_forward(jax_backend, fused)
    with nn.backend(port_backend), nn.fuse(fused):
        got = A.mla_forward(p, torch.from_numpy(x), cfg,
                            torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("port_backend,jax_backend", BACKENDS)
def test_mla_prefill_output_and_cache_match_jax(mla, jax_prefill,
                                                port_backend, jax_backend):
    _, cfg, _, p, x, pos = mla
    want, wc = jax_prefill(jax_backend)
    with nn.backend(port_backend):
        got, cache = A.mla_prefill(p, torch.from_numpy(x[:, :S]), cfg,
                                   torch.from_numpy(pos[:, :S]), max_len=S + 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)
    assert set(cache) == set(wc) == {"c", "kr"}
    for key in cache:
        assert cache[key].shape == wc[key].shape
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(wc[key]),
                                   atol=1e-5)


@pytest.mark.parametrize("port_setting,jax_setting", [
    (("torch", False), ("jnp", False)),
    (("cuda", False), ("pallas_interpret", False)),
    (("torch", True), ("jnp", True)),
    (("cuda", True), ("pallas_interpret", True))])
def test_mla_decode_matches_jax_and_forward(mla, jax_forward, jax_prefill,
                                            port_setting, jax_setting):
    """Each of the three decode paths (plain chain, decode kernel's
    oracle, fused) against JAX's same path (2e-5) and against the full
    forward's last row (2e-4, test_attention.py's limit), per-row
    positions included."""
    jcfg, cfg, jp, p, x, pos = mla
    (pb, pf), (jb, jf) = port_setting, jax_setting
    step = np.array([S, S - 3], np.int32)
    full, wc = jax_forward(), jax_prefill()[1]
    with jnn.backend(jb), jnn.fuse(jf):
        want, wc2 = JA.mla_decode(jp, jnp.asarray(x[:, S:]), jcfg, wc,
                                  jnp.asarray(step))
    cache = bridge.tensors_from_jax(jax.tree_util.tree_map(np.asarray, wc),
                                    device="cpu")
    with nn.backend(pb), nn.fuse(pf):
        got, cache = A.mla_decode(p, torch.from_numpy(x[:, S:]), cfg, cache,
                                  torch.from_numpy(step))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), full[0, S:S + 1], atol=2e-4)
    for key in ("c", "kr"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(wc2[key]),
                                   atol=1e-5)


def test_mla_decode_paths_agree_and_the_kernel_path_launches_decode_core(
        mla, jax_prefill):
    """test_attn_template.py's backend parity on the port: the chain, the
    kernel oracle and the fused path within 2e-4 of each other; the kernel
    path reaches decode_core (absorbed dims: Dk r+rope, Dv r, Hkv 1, the
    group H), the chain does not."""
    _, cfg, _, p, x, _ = mla
    wc = jax_prefill()[1]
    outs = {}
    for name, (backend, fused) in {"chain": ("torch", False),
                                   "kernel": ("cuda", False),
                                   "fused": ("cuda", True)}.items():
        cache = bridge.tensors_from_jax(jax.tree_util.tree_map(np.asarray, wc),
                                        device="cpu")
        with nn.backend(backend), nn.fuse(fused):
            recs = capture(A.mla_decode, p, torch.from_numpy(x[:, S:]), cfg,
                           cache, S)
            outs[name] = A.mla_decode(p, torch.from_numpy(x[:, S:]), cfg,
                                      bridge.tensors_from_jax(
                                          jax.tree_util.tree_map(np.asarray, wc),
                                          device="cpu"), S)[0]
        dec = [r for r in recs if r.prim == "repro_torch.decode_core"]
        assert len(dec) == (name != "chain")
        sites = {(r.group.value, r.op_site) for r in recs
                 if parse_scope(r.scope)}
        assert (("gemm", "attn_qk") in sites) == (name == "chain")
        if name == "fused":
            assert ("fused", "fused_attn_decode") in sites
    for a in ("kernel", "fused"):
        np.testing.assert_allclose(outs[a].numpy(), outs["chain"].numpy(),
                                   atol=2e-4)


def test_mla_decode_chain_sites_equal_jax(mla, jax_prefill):
    jcfg, cfg, jp, p, x, _ = mla
    wc = jax_prefill()[1]
    with jnn.backend("jnp"):
        jrecs = jcapture(lambda p_, x_, c_: JA.mla_decode(p_, x_, jcfg, c_,
                                                          jnp.int32(S)),
                         jp, jnp.asarray(x[:, S:]), wc)
    cache = bridge.tensors_from_jax(jax.tree_util.tree_map(np.asarray, wc),
                                    device="cpu")
    with nn.backend("torch"):
        recs = capture(A.mla_decode, p, torch.from_numpy(x[:, S:]), cfg,
                       cache, S)
    want = {(r.group.value, r.op_site) for r in jrecs if jparse_scope(r.scope)}
    got = {(r.group.value, r.op_site) for r in recs if parse_scope(r.scope)}
    assert ("gemm", "attn_pv") in want
    assert got == want


@pytest.mark.parametrize("port_backend", ["torch", "cuda"])
def test_mla_extend_matches_jax(mla, jax_forward, jax_prefill, jax_extend,
                                port_backend):
    """Prefill 6 tokens, then a chunk of 5 at offset 6: output and the
    latent cache against JAX's ``mla_extend``; the chunk's last row
    against the forward pass."""
    _, cfg, _, p, x, _ = mla
    wc = jax_prefill("jnp", 6)[1]
    want, wc2 = jax_extend
    full = jax_forward()
    cache = bridge.tensors_from_jax(jax.tree_util.tree_map(np.asarray, wc),
                                    device="cpu")
    ops.reset_launches()
    with nn.backend(port_backend):
        got, cache = A.mla_extend(p, torch.from_numpy(x[:, 6:S + 1]), cfg,
                                  cache, 6)
    assert sum(ops.launches.values()) == 0     # the CPU launches nothing
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), full[:, 6:], atol=2e-4)
    for key in ("c", "kr"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(wc2[key]),
                                   atol=1e-5)


def test_mla_extend_refuses_a_traced_start_and_a_chunk_past_the_cache(mla):
    _, cfg, _, p, x, _ = mla
    cache = A.init_mla_cache(cfg, 2, S + 2, device="cpu")
    with pytest.raises(TypeError, match="host int"):
        A.mla_extend(p, torch.from_numpy(x[:, :4]), cfg, cache,
                     torch.tensor(2))
    with pytest.raises(ValueError, match="outside a cache"):
        A.mla_extend(p, torch.from_numpy(x[:, :4]), cfg, cache, S)
