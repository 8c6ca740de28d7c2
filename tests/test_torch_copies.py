"""Pins of the port's copies to their JAX-package originals, the port's
import isolation, and the host-side checks of its nn ops."""

import ast
import dataclasses
import pathlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import taxonomy as jtax  # noqa: E402
from repro.models import init_lm as jinit_lm  # noqa: E402
from repro.models.common import ModelConfig as JModelConfig  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import taxonomy as ttax  # noqa: E402
from repro_torch.models import init_lm  # noqa: E402
from repro_torch.models.common import ModelConfig, dense_init  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_opgroup_copy_pinned():
    assert [(g.name, g.value) for g in ttax.OpGroup] == \
        [(g.name, g.value) for g in jtax.OpGroup]


def test_nongemm_groups_copy_pinned():
    assert {g.value for g in ttax.NONGEMM_GROUPS} == \
        {g.value for g in jtax.NONGEMM_GROUPS}


@pytest.mark.parametrize("path", ["", "ng:gemm:linear/c3",
                                  "ng:memory:kv_cache_update/c1/ng:fused:x",
                                  "outer/ng:bogus:x", "ng:logit:softmax"])
def test_scope_grammar_copy_pinned(path):
    want = jtax.parse_scope(path)
    got = ttax.parse_scope(path)
    assert (None if got is None else (got[0].value, got[1])) == \
        (None if want is None else (want[0].value, want[1]))
    assert ttax.scope_tag("gemm", "linear") == jtax.scope_tag("gemm", "linear")


def test_model_config_fields_pinned():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(ModelConfig) == fields(JModelConfig)


@pytest.mark.parametrize("arch", ["llama2-7b", "gpt2-xl", "bert-base",
                                  "vit-b16", "vit-b16-cls", "detector-vit-s",
                                  "gemma3-27b", "stablelm-3b", "granite-3-8b",
                                  "chameleon-34b", "qwen1.5-110b"])
@pytest.mark.parametrize("cut", [False, True])
def test_llama_config_copy_pinned(cut, arch):
    want = jget_config(arch)
    got = get_config(arch)
    if cut:
        want, got = jreduced(want), reduced(got)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_unknown_config_lists_known():
    with pytest.raises(KeyError, match="bert-base.*chameleon-34b.*gpt2-xl.*"
                       "granite-3-8b.*llama2-7b.*qwen1.5-110b.*stablelm-3b"):
        get_config("qwen2-moe-a2.7b")


@pytest.mark.parametrize("arch", ["vit-b16-cls", "detector-vit-s", "gpt2-xl"])
def test_vision_config_properties_pinned(arch):
    from repro.models.common import ModelConfig as J
    for cut in (False, True):
        got, want = get_config(arch), jget_config(arch)
        if cut:
            got, want = reduced(got), jreduced(want)
        for prop in ("is_vision", "is_detector", "patch_grid"):
            assert getattr(got, prop) == getattr(want, prop)
            assert isinstance(getattr(ModelConfig, prop), property) and \
                isinstance(getattr(J, prop), property)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _code_without_docstrings(path: pathlib.Path) -> str:
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            del body[0]
    return ast.dump(tree)


@pytest.mark.parametrize("module", ["traffic/traces.py"])
def test_verbatim_copy_pinned(module):
    """A module the port copies whole (numpy only) keeps the original's
    code; its docstrings may say where it came from."""
    got = _code_without_docstrings(REPO / "src" / "repro_torch" / module)
    assert got == _code_without_docstrings(REPO / "src" / "repro" / module)


def test_port_imports_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    bad = [(f.relative_to(REPO).as_posix(), m) for f in files
           for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_aten_fallback_and_kernel_rule():
    assert ttax.classify("aten.mm") == (ttax.OpGroup.GEMM, "aten.mm")
    assert ttax.classify("aten.view")[0] is ttax.OpGroup.MEMORY
    assert ttax.classify("repro_torch.decode_core")[0] is ttax.OpGroup.FUSED
    assert ttax.classify("aten.never_seen")[0] is ttax.OpGroup.OTHER
    # the vision ops' aten names
    assert ttax.classify("aten.upsample_bilinear2d")[0] is \
        ttax.OpGroup.INTERPOLATION
    for pool in ("max_pool2d_with_indices", "avg_pool2d", "max_pool2d"):
        assert ttax.classify(f"aten.{pool}")[0] is ttax.OpGroup.REDUCTION
    assert ttax.classify("aten.convolution")[0] is ttax.OpGroup.GEMM
    # a tag wins over the op name
    assert ttax.classify("aten.mm", "ng:activation:swiglu/c9") == \
        (ttax.OpGroup.ACTIVATION, "swiglu")


def test_dense_init_truncated_and_scaled():
    g = torch.Generator().manual_seed(0)
    w = dense_init(g, (256, 512))
    assert w.dtype == torch.float32 and w.shape == (256, 512)
    assert float(w.abs().max()) <= 2.0 / 16 + 1e-6
    assert abs(float(w.std()) * 16 - 0.88) < 0.05     # std of N(0,1) on [-2,2]
    w2 = dense_init(torch.Generator().manual_seed(0), (256, 512))
    assert torch.equal(w, w2)


@pytest.mark.parametrize("index", [17, -1, np.array([0, 17], np.int32),
                                   np.array([-1, 0], np.int32)])
def test_kv_cache_update_raises_instead_of_clamping(index):
    cache = torch.zeros(2, 16, 2, 4)
    new = torch.ones(2, 1, 2, 4)
    idx = torch.from_numpy(index) if isinstance(index, np.ndarray) else index
    with pytest.raises(ValueError, match="outside"):
        tnn.kv_cache_update(cache, new, idx)
    assert not cache.any()


def test_kv_cache_update_scalar_and_per_row():
    cache = torch.zeros(2, 8, 1, 1)
    tnn.kv_cache_update(cache, torch.full((2, 2, 1, 1), 5.0), 6)
    assert cache[:, 6:, 0, 0].eq(5).all() and not cache[:, :6].any()
    tnn.kv_cache_update(cache, torch.tensor([1.0, 2.0]).reshape(2, 1, 1, 1),
                        torch.tensor([0, 3], dtype=torch.int32))
    assert cache[0, 0, 0, 0] == 1 and cache[1, 3, 0, 0] == 2
    assert cache[0, 3, 0, 0] == 0 and cache[1, 0, 0, 0] == 0


def test_fusion_switch_restores():
    assert not tnn.fusion_enabled()
    with tnn.fuse():
        assert tnn.fusion_enabled()
        with tnn.fuse(False):
            assert not tnn.fusion_enabled()
        assert tnn.fusion_enabled()
    assert not tnn.fusion_enabled()


def test_bridge_raises_on_an_unknown_entry_and_carries_every_other():
    jcfg = jreduced(jget_config("gpt2-xl"))
    cfg = reduced(get_config("gpt2-xl"))
    tree = jax.tree_util.tree_map(np.asarray,
                                  jinit_lm(jax.random.PRNGKey(0), jcfg))
    params = bridge.params_from_jax(tree, cfg, device="cpu")
    assert set(params) == {"embed", "pos", "final_norm", "layers"}
    np.testing.assert_array_equal(params["pos"].numpy(), tree["pos"])
    assert {"bq", "bk", "bv"} <= set(params["layers"][0]["mixer"])
    assert {"b_up", "b_down"} <= set(params["layers"][0]["ffn"])
    with pytest.raises(ValueError, match="pos_extra"):
        bridge.params_from_jax({**tree, "pos_extra": tree["pos"]}, cfg,
                               device="cpu")


@pytest.mark.parametrize("unported", [dict(n_experts=8, top_k=2),
                                      dict(attn_logit_softcap=50.0),
                                      dict(pos_emb="sinusoidal"),
                                      dict(input_mode="audio")])
def test_unported_features_still_raise(unported):
    cfg = reduced(get_config("gpt2-xl")).replace(**unported)
    with pytest.raises(NotImplementedError, match="not ported"):
        init_lm(torch.Generator().manual_seed(0), cfg)


def test_backend_switch_validates_and_restores():
    assert tnn.get_backend() is None
    with tnn.backend("torch"):
        assert not tnn.use_kernels(torch.zeros(1))
    with tnn.backend("cuda"):
        assert tnn.use_kernels(torch.zeros(1))
    assert tnn.get_backend() is None and not tnn.use_kernels(torch.zeros(1))
    with pytest.raises(ValueError):
        tnn.set_backend("pallas")


@pytest.mark.parametrize("fn", ["quantize", "dequantize"])
def test_untagged_qdq_chain_has_an_aten_group(fn):
    # the QDQ chain's aten ops (abs, amax, new_full, div, round, clamp,
    # _to_copy, mul) run outside a tag: none is left in OTHER
    from repro_torch.core import capture
    x = torch.randn(4, 8)
    if fn == "quantize":
        recs = capture(tnn._quantize_int8_impl, x)
    else:
        q, s = tnn._quantize_int8_impl(x)
        recs = capture(tnn._dequantize_int8_impl, q, s, torch.bfloat16)
    assert recs and all(r.group is not ttax.OpGroup.OTHER for r in recs), \
        [(r.prim, r.group) for r in recs]
    for prim in ("abs", "amax", "max", "div", "round", "clamp", "_to_copy",
                 "new_full", "mul"):
        assert ttax.classify(f"aten.{prim}")[0] is not ttax.OpGroup.OTHER
