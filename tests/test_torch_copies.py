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


# ---------------------------------------------------------------------------
# the profiling API's copies (core/hardware, fusion, calibrate, report, and
# the bench gates the renderers read)
# ---------------------------------------------------------------------------

def test_the_five_jax_specs_copied_field_for_field():
    from repro.core import hardware as jhw

    from repro_torch.core import hardware as thw
    assert set(thw.BY_NAME) == set(jhw.BY_NAME) | {"h100"}
    assert [f.name for f in dataclasses.fields(thw.HardwareSpec)] == \
        [f.name for f in dataclasses.fields(jhw.HardwareSpec)]
    assert thw.ANY_GROUP == jhw.ANY_GROUP
    for name, spec in jhw.BY_NAME.items():
        assert dataclasses.asdict(thw.BY_NAME[name]) == \
            dataclasses.asdict(spec)


def test_fusion_patterns_copied():
    from repro.core import fusion as jfusion

    from repro_torch.core import fusion as tfusion
    from repro_torch.kernels import ops
    got = [(p.name, [(g.value, s) for g, s in p.sites], p.min_records)
           for p in tfusion.FUSION_PATTERNS]
    want = [(p.name, [(g.value, s) for g, s in p.sites], p.min_records)
            for p in jfusion.FUSION_PATTERNS]
    assert got == want
    renamed = {"attn_template:decode": "decode_core", "fused_rope": "rope"}
    for p, jp in zip(tfusion.FUSION_PATTERNS, jfusion.FUSION_PATTERNS):
        assert p.kernel == renamed.get(jp.kernel, jp.kernel)
        assert p.kernel is None or p.kernel in ops.KERNELS


@pytest.mark.parametrize("module,jmodule,names", [
    ("bench/schema.py", "bench/schema.py",
     ("_is_num", "check_fusion_invariant", "check_vision_invariant",
      "check_platforms_invariant")),
    ("core/calibrate.py", "core/calibrate.py",
     ("fit_factors", "calibrate", "save_calibration", "load_calibration",
      "drift_by_group", "max_abs_log2_drift")),
    ("core/fusion.py", "core/fusion.py",
     ("_out_bytes", "_in_bytes", "scope_prefix", "_site_runs",
      "_dataflow_connects", "_match", "find_fusable_chains",
      "fused_bytes_model", "_fused_record", "fuse_records", "fusion_report")),
    ("core/profiler.py", "core/profiler.py",
     ("model_records", "_accelerated_eager_profile")),
    ("core/roofline.py", "core/roofline.py",
     ("gemm_nongemm_split", "train_model_flops", "decode_model_flops",
      "attention_flops")),
])
def test_pure_functions_copied(module, jmodule, names):
    """Each function's code equals the original's but its docstring."""
    def strip(path):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            body = getattr(node, "body", None)
            if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                del body[0]
        return {n.name: ast.dump(n) for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name in names}
    got = strip(REPO / "src" / "repro_torch" / module)
    want = strip(REPO / "src" / "repro" / jmodule)
    assert set(got) == set(names) == set(want)
    for name in names:
        assert got[name] == want[name], name


def test_schema_gate_constants_copied():
    from repro.bench import schema as jschema

    from repro_torch.bench import schema as tschema
    for name in ("FUSION_VARIANT_PAIRS", "FUSION_RESIDUAL_FLOOR",
                 "PLATFORM_SWEEP", "PLATFORM_GEMM_MARGIN", "PLATFORM_NPU"):
        assert getattr(tschema, name) == getattr(jschema, name)


def _profiles(pkg):
    """Three ModelProfiles of the same numbers in package ``pkg``."""
    groups = [{"gemm": 2e-3, "normalization": 4e-4, "activation": 3e-4,
               "memory": 1e-4},
              {"gemm": 1e-3, "quantization": 9e-4, "fused": 2e-4,
               "control": 1e-5},
              {"gemm": 5e-4, "roi": 4e-4, "interpolation": 3e-4,
               "reduction": 2e-4}]
    return [pkg.ModelProfile(name=f"case{i}", mode=m,
                             group_seconds=dict(g),
                             total_seconds=sum(g.values()),
                             op_seconds={(k, k): v for k, v in g.items()},
                             n_ops=7 + i)
            for i, (g, m) in enumerate(zip(groups, ("eager_cpu", "eager_a100",
                                                    "accelerated_tpu_v5e")))]


def _rows():
    share = dict(total_s=1.5e-3, gemm_frac=0.6, nongemm_frac=0.35,
                 group_fracs={"gemm": 0.6, "reduction": 0.05, "memory": 0.1})
    breakdown = [dict(case="a", mode=m, **share) for m in
                 ("eager_cpu", "eager_a100", "accelerated_tpu")]
    top = [dict(r, top_group="memory", top_pct=12.5) for r in breakdown]
    micro = [dict(operator="rms_norm", group="normalization",
                  shape=[1, 8, 64], jit_us=3.25, eager_us=9.5,
                  tpu_model_us=0.12)]
    kernels = [dict(site="rms_norm", eager_mb=12.0, xla_mb=8.0, pallas_mb=4.0,
                    eager_over_pallas=3.0, xla_over_pallas=2.0, allclose=True)]
    roofline = [dict(mesh="16x16", label="baseline", model="kernels",
                     arch="llama", shape="s2k", compute_s=0.5, memory_s=0.25,
                     collective_s=0.125, dominant="compute",
                     useful_ratio=0.9, mfu=0.4),
                dict(mesh="16x16", label="baseline", model="xla_only",
                     arch="gpt", shape="s2k", status="skipped", skipped="oom"),
                dict(mesh="16x16", label="baseline", model="xla_only",
                     arch="gpt", shape="s4k", status="error")]
    quantized = [dict(case="a", mode="eager_a100", variant=v, qdq_frac=q,
                      **dict(share, nongemm_frac=n))
                 for v, q, n in (("fp32", 0.0, 0.3), ("int8-qdq", 0.2, 0.5))]
    fusion = [dict(case="a", mode="eager_a100", variant=v, fused_frac=f,
                   n_ops=n, **dict(share, nongemm_frac=s, total_s=t))
              for v, f, n, s, t in (("fp32", 0.0, 90, 0.4, 2e-3),
                                    ("fused", 0.1, 40, 0.2, 1e-3),
                                    ("int8-qdq", 0.0, 120, 0.6, 3e-3),
                                    ("int8-qdq+fused", 0.3, 70, 0.7, 2e-3))]
    vision = [dict(case="det", mode="eager_a100", kind="detection", variant=v,
                   roi_frac=0.1, interp_frac=0.05, **dict(share, total_s=t))
              for v, t in (("fp32", 2e-3), ("fused", 1e-3))]
    platforms = [dict(case="m", platform=p, kind="modeled", total_s=1e-3,
                      gemm_s=g, gemm_frac=0.5, nongemm_frac=s)
                 for p, g, s in (("cpu", 4e-2, 0.1), ("membound_dimm", 1.2e-2, 0.2),
                                 ("tpu_v5e", 6e-3, 0.3), ("a100", 2.4e-3, 0.35),
                                 ("npu_ryzen", 1.2e-3, 0.6))]
    platforms += [dict(case="m", platform="cpu", kind=k, total_s=1e-3,
                       gemm_s=1e-3, gemm_frac=0.5, nongemm_frac=0.5,
                       drift={"gemm": 1.5}, max_abs_log2_drift=0.58)
                  for k in ("measured", "calibrated")]
    serving = [dict(case="s", phase="engine", requests=4,
                    decode_tok_per_s=120.5, mean_ttft_s=0.05,
                    mean_queue_wait_s=0.01, mean_decode_tok_latency_s=0.008),
               dict(case="s", phase="decode", mode="eager_a100", **share)]
    sharded = [dict(case="s", tp=2, devices=2, decode_tok_per_s=90.0,
                    per_device_tok_per_s=45.0, modeled_step_s=1.2e-5,
                    modeled_eff=0.8, collective_frac=0.1, parity_ok=True)]
    return dict(breakdown=breakdown, opgroups=breakdown, top_table=top,
                micro=micro, micro_harvested=micro, kernels=kernels,
                roofline=roofline, serving=serving, serving_sharded=sharded,
                quantized=quantized, fusion=fusion, vision=vision,
                platforms=platforms)


def test_report_renderers_copied():
    """Every renderer gives JAX's text on the same profiles and rows."""
    from repro.core import profiler as jprofiler
    from repro.core import report as jreport

    from repro_torch.core import profiler as tprofiler
    from repro_torch.core import report as treport
    assert [g.value for g in treport.GROUP_ORDER] == \
        [g.value for g in jreport.GROUP_ORDER]
    tp, jp = _profiles(tprofiler), _profiles(jprofiler)
    for fn in ("breakdown_table", "group_table", "top_group_table",
               "breakdown_csv"):
        assert getattr(treport, fn)(tp) == getattr(jreport, fn)(jp), fn
    assert [treport.profile_row(p) for p in tp] == \
        [jreport.profile_row(p) for p in jp]
    assert treport.shift_summary(tp[:1], tp[1:]) == \
        jreport.shift_summary(jp[:1], jp[1:])
    assert set(treport.SECTION_RENDERERS) == set(jreport.SECTION_RENDERERS)
    rows = _rows()
    for name, renderer in treport.SECTION_RENDERERS.items():
        if name == "kernels":
            # the port's kernel rows carry its own keys (kernel_mb, not
            # xla_mb / pallas_mb): test_kernel_rows_render_the_ports_own_sites
            continue
        got = renderer(rows[name])
        assert got == jreport.SECTION_RENDERERS[name](rows[name]), name
        section = dict(name=name, title=name, status="ok", rows=rows[name],
                       wall_s=1.0)
        assert treport.render_section(section) == \
            jreport.render_section(section)
    sections = [dict(name=n, status="ok", rows=r, wall_s=0.5 + i)
                for i, (n, r) in enumerate(rows.items())]
    assert treport.render_timing_table(sections) == \
        jreport.render_timing_table(sections)
    failed = dict(name="x", status="failed", error="Traceback\nBoom", rows=[])
    assert treport.render_section(failed) == jreport.render_section(failed)
    assert treport.breakdown_csv(tp) != ""


def test_kernel_rows_render_the_ports_own_sites():
    """The §4.5 renderer reads the rows the port's kernels section gives,
    alone and through a whole artifact."""
    from repro_torch.bench.sections import section_kernels
    from repro_torch.core import report as treport

    rows = section_kernels("cpu")
    text = treport.render_kernel_rows(rows)
    lines = text.splitlines()
    assert lines[0].split() == ["kernel", "site", "eager_MB", "kernel_MB",
                                "eager/kernel", "allclose"]
    assert [ln.split()[0] for ln in lines[1:]] == [r["site"] for r in rows]
    assert all(ln.split()[-1] == "True" for ln in lines[1:])
    section = dict(name="kernels", title="§4.5", status="ok", rows=rows,
                   wall_s=1.0)
    assert treport.render_section(section) == "=== §4.5 ===\n" + text
    artifact = dict(schema_version=1, tier="quick", backend="cpu",
                    jax_version="torch " + torch.__version__, cases=[],
                    sections=[section])
    assert text in treport.render_artifact(artifact)


def test_profiling_api_modules_isolated():
    """The profiling API's and the bench's modules are among the files the
    import check reads, and none of them imports jax or repro."""
    names = ("calibrate.py", "fusion.py", "hardware.py", "report.py",
             "roofline.py", "workload.py")
    core = REPO / "src" / "repro_torch" / "core"
    bench = REPO / "src" / "repro_torch" / "bench"
    bench_modules = ("__init__.py", "__main__.py", "cases.py", "compare.py",
                     "runner.py", "schema.py", "sections.py")
    assert sorted(p.name for p in bench.glob("*.py")) == sorted(bench_modules)
    for f in [core / n for n in names] + [bench / n for n in bench_modules]:
        assert f.exists(), f
        assert not [m for m in _imports(f)
                    if m.split(".")[0] in ("jax", "jaxlib", "repro")], f
        assert "import jax" not in f.read_text()
