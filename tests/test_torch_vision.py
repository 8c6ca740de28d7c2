"""The port's encoders and vision family against the JAX package, on the
same weights: bridged reduced ``bert-base`` and ``vit-b16`` (the
embeddings stub) through ``lm_forward``, reduced ``vit-b16-cls`` and
``detector-vit-s`` through ``vision_forward``, f32 on the CPU, each
unfused and under fusion (the port's ``nn.fuse()`` against JAX's).

The port's plain backend (``"torch"``) is held against the JAX ``jnp``
backend, and its kernel backend (``"cuda"``, whose wrappers take their
plain versions for CPU tensors) against ``pallas_interpret``. Logits and
boxes at atol = rtol = 1e-4, as ``test_torch_model.py`` holds the LMs;
the detector's keep mask exactly."""

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
from repro.models import init_lm as jinit_lm  # noqa: E402
from repro.models import lm_forward as jlm_forward  # noqa: E402
from repro.models.vision import init_vision as jinit_vision  # noqa: E402
from repro.models.vision import vision_forward as jvision_forward  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import capture, parse_scope, profile_measured  # noqa: E402
from repro_torch.core.taxonomy import OpGroup  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models import vision as V  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402

BACKENDS = [("torch", "jnp"), ("cuda", "pallas_interpret")]
TOL = dict(atol=1e-4, rtol=1e-4)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@contextlib.contextmanager
def both(port_backend, jax_backend, fused):
    """Backend and fusion switches of both packages."""
    with tnn.backend(port_backend), jnn.backend(jax_backend), \
            tnn.fuse(fused), jnn.fuse(fused):
        yield


@pytest.fixture(scope="module", params=["bert-base", "vit-b16"])
def encoder(request):
    jcfg = jreduced(jget_config(request.param))
    cfg = reduced(get_config(request.param))
    jparams = jinit_lm(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(_numpy_tree(jparams), cfg, device="cpu")
    rng = np.random.default_rng(1)
    if cfg.input_mode == "tokens":
        inputs = rng.integers(0, cfg.vocab_size, (2, 13))
    else:
        inputs = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jparams, params, inputs


@pytest.fixture(scope="module", params=["vit-b16-cls", "detector-vit-s"])
def vision(request):
    jcfg = jreduced(jget_config(request.param))
    cfg = reduced(get_config(request.param))
    jparams = jinit_vision(jax.random.PRNGKey(0), jcfg)
    params = bridge.vision_params_from_jax(_numpy_tree(jparams), cfg,
                                           device="cpu")
    return jcfg, cfg, jparams, params


def _images(cfg, b=2, size=None, seed=0):
    size = size or cfg.image_size
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_channels, size, size)).astype(np.float32)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("port_backend,jax_backend", BACKENDS)
def test_encoder_logits_match(encoder, port_backend, jax_backend, fused):
    jcfg, cfg, jparams, params, inputs = encoder
    with both(port_backend, jax_backend, fused):
        want = jax.jit(lambda p, x: jlm_forward(p, x, jcfg))(
            jparams, jnp.asarray(inputs))
        got = TT.lm_forward(params, torch.from_numpy(inputs), cfg)
    assert got.shape == (2, 13, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("port_backend,jax_backend", BACKENDS)
def test_vision_forward_matches(vision, port_backend, jax_backend, fused):
    jcfg, cfg, jparams, params = vision
    imgs = _images(cfg)
    with both(port_backend, jax_backend, fused):
        want = jax.jit(lambda p, x: jvision_forward(p, x, jcfg))(
            jparams, jnp.asarray(imgs))
        got = V.vision_forward(params, torch.from_numpy(imgs), cfg)
    if not cfg.is_detector:
        assert got.shape == (2, cfg.n_classes)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return
    (boxes, scores, keep), (jboxes, jscores, jkeep) = got, want
    k = cfg.det_top_k
    assert boxes.shape == (2, k, 4) and scores.shape == (2, k)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), **TOL)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), **TOL)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    # NMS kept some boxes and dropped others on this input
    assert 0 < int(keep.sum()) < keep.numel()


@pytest.mark.parametrize("port_backend,jax_backend", BACKENDS)
def test_classifier_off_grid_resizes_positions(port_backend, jax_backend):
    # 80 px: a 5x5 patch grid against the stored 4x4 position grid
    jcfg = jreduced(jget_config("vit-b16-cls"))
    cfg = reduced(get_config("vit-b16-cls"))
    jparams = jinit_vision(jax.random.PRNGKey(2), jcfg)
    params = bridge.vision_params_from_jax(_numpy_tree(jparams), cfg,
                                           device="cpu")
    imgs = _images(cfg, size=80, seed=3)
    with both(port_backend, jax_backend, False):
        want = jax.jit(lambda p, x: jvision_forward(p, x, jcfg))(
            jparams, jnp.asarray(imgs))
        got = V.vision_forward(params, torch.from_numpy(imgs), cfg)
        recs = capture(V.vision_forward, params, torch.from_numpy(imgs), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert any(r.op_site == "interpolate_bilinear" for r in recs)


def _tagged_pairs(records, parse):
    return {(r.group.value, r.op_site) for r in records if parse(r.scope)}


# pairs the JAX capture of these paths loses (a non-inlined ``jit``
# equation recorded as one untagged OTHER op under jax 0.9.0): none on the
# jnp backend, which the gate reads
JAX_LOST_PAIRS = set()


@pytest.mark.parametrize("port_backend", ["torch", "cuda"])
def test_vision_capture_tagged_sites_match_jax_capture(vision, port_backend):
    jcfg, cfg, jparams, params = vision
    imgs = _images(cfg, seed=4)
    with jnn.backend("jnp"):
        jrecs = jcapture(lambda p, x: jvision_forward(p, x, jcfg), jparams,
                         jnp.asarray(imgs))
    with tnn.backend(port_backend):
        recs = capture(V.vision_forward, params, torch.from_numpy(imgs), cfg)
    want = _tagged_pairs(jrecs, jparse_scope)
    groups = {g for g, _ in want}
    assert ("gemm", "conv2d") in want and "reduction" in groups
    if cfg.is_detector:
        assert {"roi", "interpolation"} <= groups
    assert _tagged_pairs(recs, parse_scope) | JAX_LOST_PAIRS == want


def test_encoder_capture_tagged_sites_match_jax_capture(encoder):
    jcfg, cfg, jparams, params, inputs = encoder
    with jnn.backend("jnp"):
        jrecs = jcapture(lambda p, x: jlm_forward(p, x, jcfg), jparams,
                         jnp.asarray(inputs))
    with tnn.backend("torch"):
        recs = capture(TT.lm_forward, params, torch.from_numpy(inputs), cfg)
    want = _tagged_pairs(jrecs, jparse_scope)
    assert ("gemm", "flash_attention") in want
    assert ("memory", "embedding_lookup") in want or cfg.input_mode != "tokens"
    assert _tagged_pairs(recs, parse_scope) == want


def test_no_vision_op_falls_to_other(vision):
    """No op of the port's capture is classed OTHER (by tag or by the aten
    fallback) unless the JAX capture has one there too."""
    jcfg, cfg, jparams, params = vision
    imgs = _images(cfg, seed=5)
    with jnn.backend("jnp"):
        jrecs = jcapture(lambda p, x: jvision_forward(p, x, jcfg), jparams,
                         jnp.asarray(imgs))
    jax_other = [r.prim for r in jrecs if r.group.value == "other"]
    for backend in ("torch", "cuda"):
        with tnn.backend(backend):
            recs = capture(V.vision_forward, params, torch.from_numpy(imgs),
                           cfg)
        other = [(r.prim, r.scope) for r in recs if r.group is OpGroup.OTHER]
        assert not other or jax_other, other


def test_capture_sees_vision_kernel_ops(vision):
    _, cfg, _, params = vision
    b = 2
    with tnn.backend("cuda"):
        recs = capture(V.vision_forward, params,
                       torch.from_numpy(_images(cfg, b=b)), cfg)
    kernels = [r for r in recs if r.prim.startswith("repro_torch.")]
    full = [r for r in kernels if r.prim == "repro_torch.attention_full"]
    nms = [r for r in kernels if r.prim == "repro_torch.nms_sorted"]
    # every block, and the detector's refinement stage, once
    assert len(full) == cfg.n_layers + cfg.is_detector
    assert all((r.group.value, r.op_site) == ("gemm", "flash_attention")
               for r in full)
    assert len(nms) == (b if cfg.is_detector else 0)
    assert all((r.group.value, r.op_site) == ("roi", "nms") for r in nms)
    if cfg.is_detector:     # the refinement: K queries over the N cells
        q, kv = full[-1].in_shapes[:2]
        assert q[1] == cfg.det_top_k and kv[1] == (cfg.patch_grid * 2) ** 2
        # its operations from the shapes: 2 * B * H * Sq * Skv * (Dk + Dv)
        assert full[-1].flops == 2.0 * b * q[2] * q[1] * kv[1] * 2 * q[3]


def test_vision_kernel_backend_counts_no_cpu_launches(vision):
    _, cfg, _, params = vision
    ops.reset_launches()
    with tnn.backend("cuda"), tnn.fuse():
        V.vision_forward(params, torch.from_numpy(_images(cfg, b=1)), cfg)
    assert sum(ops.launches.values()) == 0


def test_measured_vision_profile_on_cpu(vision):
    _, cfg, _, params = vision
    with tnn.backend("torch"):
        prof = profile_measured(V.vision_forward, params,
                                torch.from_numpy(_images(cfg, b=1)), cfg,
                                name=cfg.name, repeats=1)
    groups = {g for g, t in prof.group_seconds.items() if t > 0}
    assert prof.mode == "measured_cpu" and {"gemm", "reduction"} <= groups
    if cfg.is_detector:
        assert {"roi", "interpolation"} <= groups
    assert "other" not in groups


@pytest.mark.parametrize("arch", ["bert-base", "vit-b16"])
def test_encoders_are_not_served(arch):
    cfg = reduced(get_config(arch))
    params = TT.init_lm(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(NotImplementedError, match="encoder"):
        TT.init_lm_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="encoder"):
        TT.lm_prefill(params, torch.zeros(1, 4, dtype=torch.long), cfg,
                      max_len=8)
    with pytest.raises(NotImplementedError, match="encoder"):
        Engine(cfg, params, max_batch=1, max_len=8)


def _shapes(tree):
    """The tree with each tensor replaced by its shape tuple."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def test_vision_init_builds_the_bridged_tree(vision):
    """The port's own init builds the tree the bridge carries."""
    _, cfg, _, params = vision
    got = V.init_vision(torch.Generator().manual_seed(0), cfg)
    assert _shapes(got) == _shapes(params)


def test_encoder_init_builds_the_bridged_tree(encoder):
    _, cfg, _, params, _ = encoder
    got = TT.init_lm(torch.Generator().manual_seed(0), cfg)
    assert _shapes(got) == _shapes(params)
    # tied bert reads its head from embed; the stub has no embed
    assert ("embed" in got) == (cfg.input_mode == "tokens")
    assert ("head" in got) == (cfg.input_mode != "tokens")


def test_vision_bridge_raises_on_an_unknown_entry():
    cfg = reduced(get_config("detector-vit-s"))
    tree = _numpy_tree(jinit_vision(jax.random.PRNGKey(0),
                                    jreduced(jget_config("detector-vit-s"))))
    params = bridge.vision_params_from_jax(tree, cfg, device="cpu")
    assert set(params) == set(tree) and len(params["blocks"]) == cfg.n_layers
    np.testing.assert_array_equal(params["neck_prior"].numpy(),
                                  tree["neck_prior"])
    with pytest.raises(ValueError, match="neck_extra"):
        bridge.vision_params_from_jax({**tree, "neck_extra": tree["pos2d"]},
                                      cfg, device="cpu")
