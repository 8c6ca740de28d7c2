"""The port's §4.4 QDQ path against the JAX package's: reduced llama2-7b,
gpt2-xl and vit-b16-cls under ``fake_quant("int8")``, unfused and fused,
on bridged weights, f32 on the CPU, the port's plain backend against JAX's
``jnp`` and its kernel backend against ``pallas_interpret``.

QDQ is discontinuous: a one-ulp difference upstream (a norm's summation
order) moves an activation across a rounding boundary, flips one int8 code
and reaches the logits at ~0.1. The model-level gate is therefore not the
1e-4 of the unquantized paths but, per token seed, argmax identical at
every position and the mean |Δlogit| at most 0.0125: twice the sound port's
worst reading (0.0062, reduced llama2-7b) and half the weakest broken QDQ's
(a scale of amax/128: mean 0.025 and more). The max |Δ| is reported, not
gated: it cannot separate the sound port (0.107) from that mutant (0.145).
The QDQ ops themselves are held bit-exact in ``test_torch_nn.py``."""

import re

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
from repro.models import init_lm as jinit_lm  # noqa: E402
from repro.models import lm_forward as jlm_forward  # noqa: E402
from repro.models.vision import init_vision as jinit_vision  # noqa: E402
from repro.models.vision import vision_forward as jvision_forward  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import capture, parse_scope  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models import vision as V  # noqa: E402

ARCHS = ["llama2-7b", "gpt2-xl", "vit-b16-cls"]
BACKENDS = [("torch", "jnp"), ("cuda", "pallas_interpret")]
SEEDS = (0, 1)
MEAN_GATE = 0.0125


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, JAX forward, port forward, inputs(seed) -> numpy) on bridged
    weights; each forward takes its framework's array of the inputs."""
    arch = request.param
    jcfg = jreduced(jget_config(arch))
    cfg = reduced(get_config(arch))
    if cfg.is_vision:
        jparams = jinit_vision(jax.random.PRNGKey(0), jcfg)
        params = bridge.vision_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")

        def inputs(seed):
            return np.random.default_rng(seed).standard_normal(
                (2, cfg.n_channels, cfg.image_size, cfg.image_size)
            ).astype(np.float32)
        jfwd = jax.jit(lambda p, x: jvision_forward(p, x, jcfg))
        return arch, (lambda x: jfwd(jparams, x)), \
            (lambda x: V.vision_forward(params, torch.from_numpy(x), cfg)), \
            inputs
    jparams = jinit_lm(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                    cfg, device="cpu")

    def inputs(seed):
        return np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 13))
    jfwd = jax.jit(lambda p, t: jlm_forward(p, t, jcfg))
    return arch, (lambda t: jfwd(jparams, jnp.asarray(t, jnp.int32))), \
        (lambda t: TT.lm_forward(params, torch.from_numpy(t), cfg)), inputs


def _gate(got, want, what):
    """Argmax equal everywhere and mean |Δ| <= MEAN_GATE; returns the
    (mean, max) reading."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    d = np.abs(got - want)
    print(f"{what}: mean |dlogit| {d.mean():.3g}, max {d.max():.3g}")
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert d.mean() <= MEAN_GATE, (what, d.mean(), d.max())
    return d.mean(), d.max()


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("port_backend,jax_backend", BACKENDS)
def test_qdq_logits_match_jax(model, port_backend, jax_backend, fused):
    arch, jfwd, fwd, inputs = model
    for seed in SEEDS:
        x = inputs(seed)
        with jnn.backend(jax_backend), jnn.fuse(fused), jnn.fake_quant():
            want = jfwd(x)
        with tnn.backend(port_backend), tnn.fuse(fused), tnn.fake_quant():
            got = fwd(x)
        _gate(got.numpy(), want, f"{arch} {port_backend} fused={fused} "
                                 f"seed {seed}")
    assert tnn.get_fake_quant() is None and jnn.get_fake_quant() is None


@pytest.mark.parametrize("port_backend", ["torch", "cuda"])
def test_qdq_fused_matches_unfused_in_the_port(model, port_backend):
    arch, _, fwd, inputs = model
    for seed in SEEDS:
        x = inputs(seed)
        with tnn.backend(port_backend), tnn.fake_quant():
            with tnn.fuse(False):
                unfused = fwd(x)
            with tnn.fuse(True):
                fused = fwd(x)
        _gate(fused.numpy(), unfused.numpy(),
              f"{arch} {port_backend} fused vs unfused seed {seed}")


def _calls(records):
    """{call key: trip count} of every quantize (or fused_qdq) call and
    every GEMM-site call: the scope prefix up to the call's ``c<N>``
    marker, weighted by the JAX capture's scan trip count."""
    quant, gemm = {}, {}
    for r in records:
        for m in re.finditer(r"ng:(quantization:quantize|fused:fused_qdq|"
                             r"gemm:(?:linear|einsum|conv2d))/c\d+", r.scope):
            key = r.scope[:m.end()]
            dst = gemm if m.group(1).startswith("gemm") else quant
            dst[key] = getattr(r, "trip_count", 1)
    return sum(quant.values()), sum(gemm.values())


def _tagged(records, parse):
    return {(r.group.value, r.op_site) for r in records if parse(r.scope)}


@pytest.mark.parametrize("fused", [False, True])
def test_qdq_sites_and_quantize_calls_match_jax_capture(model, fused):
    arch, jfwd, fwd, inputs = model
    x = inputs(0)
    cfg = reduced(get_config(arch))
    jcfg = jreduced(jget_config(arch))
    with jnn.backend("jnp"), jnn.fuse(fused), jnn.fake_quant():
        if cfg.is_vision:
            jparams = jinit_vision(jax.random.PRNGKey(0), jcfg)
            jrecs = jcapture(lambda p, a: jvision_forward(p, a, jcfg), jparams,
                             jnp.asarray(x))
        else:
            jparams = jinit_lm(jax.random.PRNGKey(0), jcfg)
            jrecs = jcapture(lambda p, t: jlm_forward(p, t, jcfg), jparams,
                             jnp.asarray(x, jnp.int32))
    with tnn.backend("torch"), tnn.fuse(fused), tnn.fake_quant():
        recs = capture(fwd, x)
    want = _tagged(jrecs, jparse_scope)
    qdq_sites = ({("fused", "fused_qdq")} if fused else
                 {("quantization", "quantize"), ("quantization", "dequantize")})
    assert qdq_sites <= want
    assert _tagged(recs, parse_scope) == want
    n_quant, n_gemm = _calls(recs)
    assert (n_quant, n_gemm) == _calls(jrecs)
    assert n_gemm > 0 and n_quant == 2 * n_gemm
