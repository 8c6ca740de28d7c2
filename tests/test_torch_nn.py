"""The port's tagged nn ops against ``repro.nn``'s jnp ops, op by op, on the
same numpy inputs (f32, the JAX reference's CPU dtype), and their tags."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import nn as jnn  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import capture  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

RNG = np.random.default_rng(0)
X4 = RNG.standard_normal((2, 5, 4, 16)).astype(np.float32)   # (B, S, H, D)
X3 = RNG.standard_normal((2, 5, 24)).astype(np.float32)
W = RNG.standard_normal((24, 12)).astype(np.float32)
POS = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
S0, S1 = W[:, 0].copy(), W[:, 1].copy()       # contiguous (d,) scale, bias
IDS = np.array([[3, 0, 9], [1, 1, 4]], np.int64)
TABLE = RNG.standard_normal((10, 6)).astype(np.float32)
IMG = RNG.standard_normal((2, 3, 12, 16)).astype(np.float32)      # NCHW
KER = RNG.standard_normal((8, 3, 4, 4)).astype(np.float32)        # OIHW
GRID = RNG.standard_normal((2, 6, 7, 5)).astype(np.float32)       # NHWC
RAW = RNG.standard_normal((2, 9, 4)).astype(np.float32) * 3
ANCHORS = np.abs(RNG.standard_normal((9, 4))).astype(np.float32) * 8 + 1
LABELS = RNG.integers(0, 24, (2, 5)).astype(np.int32)
Q8 = RNG.integers(-127, 128, (2, 5, 24)).astype(np.int8)

# name: (port call, JAX call), each on its own framework's arrays
CASES = {
    "silu": (lambda t: tnn.silu(t(X3)), lambda j: jnn.silu(j(X3))),
    "scale": (lambda t: tnn.scale(t(X3), 0.37), lambda j: jnn.scale(j(X3), 0.37)),
    "softmax": (lambda t: tnn.softmax(t(X3) * 4, dim=-1),
                lambda j: jnn.softmax(j(X3) * 4, axis=-1)),
    "apply_rope": (lambda t: tnn.apply_rope(t(X4), t(POS)),
                   lambda j: jnn.apply_rope(j(X4), j(POS))),
    "apply_rope_fraction": (
        lambda t: tnn.apply_rope(t(X4), t(POS), base=500.0, fraction=0.25),
        lambda j: jnn.apply_rope(j(X4), j(POS), base=500.0, fraction=0.25)),
    "split_heads": (lambda t: tnn.split_heads(t(X3), 3),
                    lambda j: jnn.split_heads(j(X3), 3)),
    "merge_heads": (lambda t: tnn.merge_heads(t(X4)),
                    lambda j: jnn.merge_heads(j(X4))),
    "embedding_lookup": (lambda t: tnn.embedding_lookup(t(TABLE), t(IDS)),
                         lambda j: jnn.embedding_lookup(j(TABLE), j(IDS))),
    "residual_add": (lambda t: tnn.residual_add(t(X3), t(X3[::-1].copy())),
                     lambda j: jnn.residual_add(j(X3), j(X3[::-1].copy()))),
    "linear": (lambda t: tnn.linear(t(X3), t(W)), lambda j: jnn.linear(j(X3), j(W))),
    "einsum": (lambda t: tnn.einsum("bsd,df->bfs", t(X3), t(W)),
               lambda j: jnn.einsum("bsd,df->bfs", j(X3), j(W))),
    "rms_norm": (lambda t: tnn.rms_norm(t(X3), t(W[:, 0])),
                 lambda j: jnn.rms_norm(j(X3), j(W[:, 0]))),
    "layer_norm": (lambda t: tnn.layer_norm(t(X3 + 2), t(W[:, 0]), t(W[:, 1])),
                   lambda j: jnn.layer_norm(j(X3 + 2), j(W[:, 0]), j(W[:, 1]))),
    "gelu": (lambda t: tnn.gelu(t(X3 * 3)), lambda j: jnn.gelu(j(X3 * 3))),
    "relu": (lambda t: tnn.relu(t(X3)), lambda j: jnn.relu(j(X3))),
    "swiglu": (lambda t: tnn.swiglu(t(X3), t(X3 * 0.5)),
               lambda j: jnn.swiglu(j(X3), j(X3 * 0.5))),
    "geglu": (lambda t: tnn.geglu(t(X3 * 3), t(X3 * 0.5)),
              lambda j: jnn.geglu(j(X3 * 3), j(X3 * 0.5))),
    # the vision ops
    "sigmoid": (lambda t: tnn.sigmoid(t(X3 * 3)), lambda j: jnn.sigmoid(j(X3 * 3))),
    "box_decode": (lambda t: tnn.box_decode(t(RAW), t(ANCHORS)),
                   lambda j: jnn.box_decode(j(RAW), j(ANCHORS))),
    "conv2d": (lambda t: tnn.conv2d(t(IMG), t(KER), t(W[:8, 0].copy()), stride=4),
               lambda j: jnn.conv2d(j(IMG), j(KER), j(W[:8, 0].copy()), stride=4)),
    "conv2d_stride_1": (lambda t: tnn.conv2d(t(IMG), t(KER)),
                        lambda j: jnn.conv2d(j(IMG), j(KER))),
    "interpolate_bilinear_up": (
        lambda t: tnn.interpolate_bilinear(t(IMG), (24, 32)),
        lambda j: jnn.interpolate_bilinear(j(IMG), (24, 32))),
    "interpolate_bilinear_off_grid": (
        lambda t: tnn.interpolate_bilinear(t(IMG), (7, 23)),
        lambda j: jnn.interpolate_bilinear(j(IMG), (7, 23))),
    "max_pool2d": (lambda t: tnn.max_pool2d(t(GRID), window=2),
                   lambda j: jnn.max_pool2d(j(GRID), window=2)),
    "max_pool2d_same": (
        lambda t: tnn.max_pool2d(t(GRID), window=3, stride=1, padding="SAME"),
        lambda j: jnn.max_pool2d(j(GRID), window=3, stride=1, padding="SAME")),
    "max_pool2d_same_even": (
        lambda t: tnn.max_pool2d(t(GRID), window=2, stride=2, padding="SAME"),
        lambda j: jnn.max_pool2d(j(GRID), window=2, stride=2, padding="SAME")),
    "avg_pool2d": (lambda t: tnn.avg_pool2d(t(GRID), window=2),
                   lambda j: jnn.avg_pool2d(j(GRID), window=2)),
    "avg_pool2d_same": (
        lambda t: tnn.avg_pool2d(t(GRID), window=3, stride=2, padding="SAME"),
        lambda j: jnn.avg_pool2d(j(GRID), window=3, stride=2, padding="SAME")),
    "global_avg_pool": (lambda t: tnn.global_avg_pool(t(GRID)),
                        lambda j: jnn.global_avg_pool(j(GRID))),
    "softmax_cross_entropy": (
        lambda t: tnn.softmax_cross_entropy(t(X3 * 4), t(LABELS)),
        lambda j: jnn.softmax_cross_entropy(j(X3 * 4), j(LABELS))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_nn_op_matches_jax_op(name):
    port, jax_op = CASES[name]
    with tnn.backend("torch"), jnn.backend("jnp"):
        got = port(torch.from_numpy)
        want = jax_op(jnp.asarray)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ops returning (y, x + residual), unfused and under fusion
PAIR_CASES = {
    "fused_add_rms_norm": (
        lambda t: tnn.fused_add_rms_norm(t(X3), t(X3[::-1].copy()), t(W[:, 0])),
        lambda j: jnn.fused_add_rms_norm(j(X3), j(X3[::-1].copy()), j(W[:, 0]))),
    "add_rms_norm": (
        lambda t: tnn.add_rms_norm(t(X3), t(X3[::-1].copy()), t(W[:, 0])),
        lambda j: jnn.add_rms_norm(j(X3), j(X3[::-1].copy()), j(W[:, 0]))),
    "add_layer_norm": (
        lambda t: tnn.add_layer_norm(t(X3), t(X3[::-1].copy()), t(W[:, 0]),
                                     t(W[:, 1])),
        lambda j: jnn.add_layer_norm(j(X3), j(X3[::-1].copy()), j(W[:, 0]),
                                     j(W[:, 1]))),
    "dequant_add_rms_norm": (
        lambda t: tnn.dequant_add_rms_norm(t(Q8), t(np.array(0.031, np.float32)), t(X3),
                                           t(W[:, 0])),
        lambda j: jnn.dequant_add_rms_norm(j(Q8), j(np.array(0.031, np.float32)), j(X3),
                                           j(W[:, 0]))),
}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", sorted(PAIR_CASES))
def test_nn_pair_op_matches_jax_op(name, fused):
    port, jax_op = PAIR_CASES[name]
    with tnn.backend("torch"), jnn.backend("jnp"), tnn.fuse(fused), \
            jnn.fuse(fused):
        got = port(torch.from_numpy)
        want = jax_op(jnp.asarray)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


# the fusable sites: (port call, JAX call, the tag of the op under fusion)
FUSED_SITES = {
    "add_rms_norm": (lambda t: tnn.add_rms_norm(t(X3), t(X3), t(S0)),
                     lambda j: jnn.add_rms_norm(j(X3), j(X3), j(S0)),
                     "ng:fused:fused_add_rms_norm"),
    "add_layer_norm": (
        lambda t: tnn.add_layer_norm(t(X3), t(X3), t(S0), t(S1)),
        lambda j: jnn.add_layer_norm(j(X3), j(X3), j(S0), j(S1)),
        "ng:fused:fused_add_layer_norm"),
    "swiglu": (lambda t: tnn.swiglu(t(X3), t(X3)),
               lambda j: jnn.swiglu(j(X3), j(X3)), "ng:fused:fused_swiglu"),
    "geglu": (lambda t: tnn.geglu(t(X3 * 3), t(X3)),
              lambda j: jnn.geglu(j(X3 * 3), j(X3)), "ng:fused:fused_geglu"),
    "apply_rope": (lambda t: tnn.apply_rope(t(X4), t(POS)),
                   lambda j: jnn.apply_rope(j(X4), j(POS)),
                   "ng:fused:fused_rope"),
}


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("name", sorted(FUSED_SITES))
def test_fused_site_is_one_fused_op_matching_jax(name, backend):
    port, jax_op, tag = FUSED_SITES[name]
    with tnn.backend(backend), tnn.fuse(), jnn.backend("jnp"), jnn.fuse():
        recs = [r for r in capture(lambda: port(torch.from_numpy))
                if r.prim != "aten.lift_fresh"]      # from_numpy's own op
        got = port(torch.from_numpy)
        want = jax_op(jnp.asarray)
    # the innermost tag of every op is the fused one: nothing shadows it
    assert recs and all(r.group.value == "fused" for r in recs)
    assert all(tag in r.scope for r in recs)
    if backend == "cuda":       # the wrapper is one op
        assert len(recs) == 1 and recs[0].prim.startswith("repro_torch.")
    for g, w in zip(*(t if isinstance(t, tuple) else (t,) for t in (got, want))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


def test_tagged_ops_push_tag_and_call_marker():
    x = torch.ones(3)
    recs = capture(lambda: tnn.residual_add(tnn.silu(x), x))
    scopes = [r.scope for r in recs]
    assert scopes[0].startswith("ng:activation:silu/c")
    assert scopes[-1].startswith("ng:elementwise:residual_add/c")
    assert scopes[0].split("/")[1] != scopes[-1].split("/")[1]
    assert tnn.scope_path() == ""


@pytest.mark.parametrize("ffn", ["gelu", "relu", "silu", "swiglu", "geglu"])
@pytest.mark.parametrize("bias", [False, True])
def test_ffn_forward_matches_jax(ffn, bias):
    jcfg = jreduced(jget_config("gpt2-xl")).replace(ffn=ffn, ffn_bias=bias)
    cfg = reduced(get_config("gpt2-xl")).replace(ffn=ffn, ffn_bias=bias)
    jp = jmoe.init_ffn(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(2)
    if bias:            # nonzero biases, so that their use is visible
        jp = {k: (jnp.asarray(rng.standard_normal(v.shape), v.dtype)
                  if k.startswith("b_") else v) for k, v in jp.items()}
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    assert set(p) == set(tmoe.init_ffn(torch.Generator().manual_seed(0), cfg))
    x = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    with tnn.backend("torch"), jnn.backend("jnp"):
        want = jmoe.ffn_forward(jp, jnp.asarray(x), jcfg)
        got = tmoe.ffn_forward(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# QDQ (paper §4.4): bit-exact against the JAX ops run eagerly (no jax.jit)
# ---------------------------------------------------------------------------

def _qdq_input(kind, dt):
    rng = np.random.default_rng(5)
    a = {"randn": rng.standard_normal((64, 257)),
         "wide": rng.standard_normal((33, 100)) * np.logspace(-3, 3, 100),
         "ties": np.arange(-300, 300).reshape(20, 30) / 2.0,
         "zeros": np.zeros((4, 8))}[kind].astype(np.float32)
    return jnp.asarray(a).astype(dt), torch.from_numpy(a).to(
        {"float32": torch.float32, "bfloat16": torch.bfloat16}[dt])


@pytest.mark.parametrize("kind", ["randn", "wide", "ties", "zeros"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_quantize_int8_bit_exact_against_jax(kind, dt):
    jx, tx = _qdq_input(kind, dt)
    jq, js = jnn.quantize_int8(jx)
    tq, ts = tnn.quantize_int8(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.dim() == 0
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js, np.float32).tobytes()
    if kind == "zeros":          # the 1e-8 floor of the scale
        assert float(ts) == float(np.float32(1e-8) / np.float32(127.0))
    # the round trip, in x's dtype, unfused and as the one fused op
    want = np.asarray(jnn.fake_quant_int8(jx).astype(jnp.float32))
    for fused in (False, True):
        with tnn.fuse(fused):
            got = tnn.fake_quant_int8(tx)
        assert got.dtype == tx.dtype
        np.testing.assert_array_equal(got.float().numpy(), want)


def _sites(recs):
    return {(r.group.value, r.op_site) for r in recs
            if r.prim != "aten.lift_fresh"}


def test_qdq_ops_are_tagged_as_in_jax():
    x = torch.from_numpy(X3)
    assert _sites(capture(tnn.fake_quant_int8, x)) == {
        ("quantization", "quantize"), ("quantization", "dequantize")}
    with tnn.fuse():
        assert _sites(capture(tnn.fake_quant_int8, x)) == {("fused", "fused_qdq")}
    assert (tnn.quantize_int8.op_tag, tnn.dequantize_int8.op_tag,
            tnn._fused_qdq.op_tag) == ("ng:quantization:quantize",
                                       "ng:quantization:dequantize",
                                       "ng:fused:fused_qdq")
    assert _sites(capture(tnn.dequant_add_rms_norm, torch.from_numpy(Q8),
                          torch.tensor(0.5), x, torch.ones(24))) == {
        ("fused", "fused_dequant_add_rms_norm")}


def test_fake_quant_state_restored_on_error():
    assert tnn.get_fake_quant() is None
    with pytest.raises(RuntimeError, match="boom"):
        with tnn.fake_quant("int8"):
            assert tnn.get_fake_quant() == "int8"
            raise RuntimeError("boom")
    assert tnn.get_fake_quant() is None
    with pytest.raises(ValueError, match="int4"):
        tnn.set_fake_quant("int4")
    with tnn.fake_quant(None):
        assert tnn.get_fake_quant() is None


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", ["linear", "einsum", "conv2d"])
def test_gemm_site_under_fake_quant_matches_jax(name, fused):
    port, jax_op = CASES[name]
    with tnn.fake_quant(), jnn.fake_quant(), tnn.fuse(fused), jnn.fuse(fused):
        recs = capture(lambda: port(torch.from_numpy))
        got = port(torch.from_numpy)
        want = jax_op(jnp.asarray)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # both operands round-trip: two quantize calls (or two fused_qdq) a site
    site = "ng:fused:fused_qdq/" if fused else "ng:quantization:quantize/"
    calls = {r.scope.split(site, 1)[1].split("/")[0] for r in recs
             if site in r.scope}
    assert len(calls) == 2
    with tnn.backend("torch"):
        plain = port(torch.from_numpy)
    assert not torch.equal(plain, got)     # QDQ off again, and it did act
