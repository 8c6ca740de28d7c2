"""The port's bench pipeline (``repro_torch.bench``) on the CPU, held
against ``repro.bench``: each case of ``test_bench_runner.py``,
``test_bench_schema.py`` and ``test_bench_compare.py`` again on the port;
JAX's artifacts (a built one, ``benchmarks/baseline.json`` read-only)
through the port's schema and compare CLI, with JAX's messages, findings
and exit codes; the case tables, ``bench_config`` and ``build``'s logits
against JAX's; the serving engine's token counts against JAX's; and a
whole ``run_bench("quick", device="cpu")`` on reduced configs (the same
``get_config`` patch in both packages) that validates, renders and
compares clean against itself. The card-only parts (the measured column,
``calibrated:h100``, the graphed engines) run in ``chip_smoke.py``'s
``bench`` phase."""

import ast
import copy
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.bench import cases as jcases  # noqa: E402
from repro.bench import compare as jcompare  # noqa: E402
from repro.bench import schema as jschema  # noqa: E402
from repro.bench import sections as jsections  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.bench import cases as tcases  # noqa: E402
from repro_torch.bench import compare as tcompare  # noqa: E402
from repro_torch.bench import schema as tschema  # noqa: E402
from repro_torch.bench import sections as tsections  # noqa: E402
from repro_torch.bench.runner import (SECTIONS, BenchContext,  # noqa: E402
                                      Section, SkipSection, run_bench,
                                      run_section)
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import report as treport  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
BASELINE = REPO / "benchmarks" / "baseline.json"
#: f32 tolerance of the kernel sweeps (tests/test_kernels.py ``_tol``)
F32_TOL = 2e-5


def _reduced_configs(mp):
    """Both packages' bench builders on the reduced configs."""
    mp.setattr(jcases, "get_config", lambda a: jreduced(jget_config(a)))
    mp.setattr(tcases, "get_config", lambda a: reduced(get_config(a)))


@pytest.fixture
def clean_caches():
    """Neither package's memoized builds leak into or out of a test that
    patches the configs."""
    jcases.clear_caches()
    tcases.clear_caches()
    yield
    jcases.clear_caches()
    tcases.clear_caches()


# ---------------------------------------------------------------------------
# runner (test_bench_runner.py on the port)
# ---------------------------------------------------------------------------

def ctx():
    return BenchContext(tier="quick", cases=[], device="cpu")


def test_ok_section():
    sec = Section(name="s", title="t", fn=lambda c: [{"a": 1}])
    r = run_section(sec, ctx())
    assert r.status == "ok" and r.rows == [{"a": 1}] and r.error is None
    assert r.wall_s >= 0.0


def test_failed_section_is_contained():
    def boom(c):
        raise RuntimeError("kaput")

    r = run_section(Section(name="s", title="t", fn=boom), ctx())
    assert r.status == "failed" and r.rows == []
    assert "kaput" in r.error


def test_skip_section():
    def skip(c):
        raise SkipSection("nothing to do")

    r = run_section(Section(name="s", title="t", fn=skip), ctx())
    assert r.status == "skipped" and r.error == "nothing to do"


def test_timeout_fires_and_is_cleared():
    def slow(c):
        time.sleep(5)
        return []

    sec = Section(name="s", title="t", fn=slow, timeout_s=0.2)
    t0 = time.perf_counter()
    r = run_section(sec, ctx())
    assert r.status == "timeout"
    assert time.perf_counter() - t0 < 3.0
    # the alarm must not linger past the section
    time.sleep(0.3)


def test_timeout_scale():
    def quickish(c):
        time.sleep(0.3)
        return [{"ok": True}]

    sec = Section(name="s", title="t", fn=quickish, timeout_s=0.1)
    assert run_section(sec, ctx()).status == "timeout"
    assert run_section(sec, ctx(), timeout_scale=10.0).status == "ok"


def test_sections_registered_in_jax_order():
    from repro.bench.runner import SECTIONS as JSECTIONS

    from repro_torch.bench.runner import SECTIONS
    assert list(SECTIONS) == list(JSECTIONS)
    for name, s in SECTIONS.items():
        j = JSECTIONS[name]
        assert (s.tiers, s.timeout_s) == (j.tiers, j.timeout_s), name
    assert "quick" in SECTIONS["serving"].tiers


def test_serving_rows_shape(clean_caches):
    """The serving section emits one engine row + share-bearing phase rows
    that satisfy the artifact schema."""
    rows = tsections.serving_rows(tcases.SERVING_CASES[0], requests=2,
                                  max_new_tokens=2, device="cpu")
    phases = {r["phase"] for r in rows}
    assert phases == {"engine", "prefill", "decode"}
    eng = next(r for r in rows if r["phase"] == "engine")
    assert eng["requests"] == 2
    assert eng["decode_tokens"] == 2    # 1 prefill + 1 decode token each
    for r in rows:
        if r["phase"] != "engine":
            assert 0.0 <= r["gemm_frac"] <= 1.0
            assert 0.0 <= r["nongemm_frac"] <= 1.0


# ---------------------------------------------------------------------------
# schema (test_bench_schema.py on the port, and JAX's artifacts)
# ---------------------------------------------------------------------------

def make_result() -> tschema.BenchResult:
    S = tschema
    return S.BenchResult(
        tier="quick",
        backend="cpu",
        jax_version="torch " + torch.__version__,
        cases=[S.BenchCase("gpt2-xl b-1", "gpt2-xl", 1, 16, ("quick", "full")),
               S.BenchCase("bert b-1", "bert-base", 1, 128, ("full",))],
        sections=[
            S.SectionResult(
                name="breakdown", title="Fig 1", status="ok", wall_s=1.5,
                rows=[{"case": "gpt2-xl b-1", "mode": "measured_cuda",
                       "total_s": 0.01, "gemm_frac": 0.62,
                       "nongemm_frac": 0.38,
                       "group_fracs": {"gemm": 0.62, "normalization": 0.2},
                       "n_ops": 123}]),
            S.SectionResult(
                name="kernels", title="§4.5", status="ok", wall_s=2.0,
                rows=[{"site": "rms_norm", "eager_mb": 50.3,
                       "kernel_mb": 16.8, "eager_over_kernel": 3.0,
                       "allclose": True}]),
            S.SectionResult(name="roofline", title="roofline",
                            status="skipped", wall_s=0.0,
                            error="no dry-run artifacts"),
        ],
        meta={"n_devices": 1},
    )


#: test_bench_schema.py's mutations, each with the fragment its message has
MUTATIONS = [
    (lambda d: d.pop("schema_version"), "schema_version"),
    (lambda d: d.update(schema_version=tschema.SCHEMA_VERSION + 1), "newer"),
    (lambda d: d.update(tier=7), "'tier'"),
    (lambda d: d.update(tier="warp"), "tier must be"),
    (lambda d: d.update(sections=[]), "sections"),
    (lambda d: d["sections"][0].update(status="exploded"), "status"),
    (lambda d: d["sections"][0].pop("wall_s"), "wall_s"),
    (lambda d: d["sections"][0]["rows"][0].pop("nongemm_frac"),
     "nongemm_frac"),
    (lambda d: d["sections"][0]["rows"][0].update(nongemm_frac="big"),
     "number"),
    (lambda d: d["sections"][0]["rows"][0].update(nongemm_frac=1.7),
     "outside"),
    (lambda d: d["sections"][1]["rows"][0].pop("allclose"), "allclose"),
    (lambda d: d["cases"][0].pop("arch"), "arch"),
]


def test_roundtrip_through_json():
    r = make_result()
    text = r.to_json()
    back = tschema.BenchResult.from_json(text)
    assert back == r
    assert json.loads(text) == r.to_dict()


def test_dump_and_load(tmp_path):
    path = str(tmp_path / "sub" / "bench.json")
    r = make_result()
    r.dump(path)
    assert tschema.BenchResult.load(path) == r


def test_valid_artifact_has_no_errors():
    assert tschema.validate_artifact(make_result().to_dict()) == []


def test_section_lookup():
    r = make_result()
    assert r.section("kernels").rows[0]["site"] == "rms_norm"
    assert r.section("nope") is None


def test_case_unpacks_like_legacy_tuple():
    alias, arch, batch, seq = tschema.BenchCase("a", "gpt2-xl", 2, 16)
    assert (alias, arch, batch, seq) == ("a", "gpt2-xl", 2, 16)
    with pytest.raises(ValueError, match="invalid tiers"):
        tschema.BenchCase("a", "gpt2-xl", 2, 16, ("nightly",))


@pytest.mark.parametrize("mutate,fragment", MUTATIONS)
def test_validator_catches(mutate, fragment):
    d = make_result().to_dict()
    mutate(d)
    errs = tschema.validate_artifact(d)
    assert errs and any(fragment in e for e in errs), errs


@pytest.mark.parametrize("mutate,fragment", MUTATIONS)
def test_validator_gives_jax_messages_on_a_jax_artifact(mutate, fragment):
    from test_bench_schema import make_result as jax_result

    d = jax_result().to_dict()
    mutate(d)
    want = jschema.validate_artifact(copy.deepcopy(d))
    assert want and tschema.validate_artifact(d) == want


def test_kernel_rows_held_to_their_package_keys():
    from test_bench_schema import make_result as jax_result

    d = make_result().to_dict()
    d["sections"][1]["rows"][0]["pallas_mb"] = \
        d["sections"][1]["rows"][0].pop("kernel_mb")
    assert tschema.validate_artifact(d) == [
        "sections[1] (kernels).rows[0]: missing key 'kernel_mb'"]
    assert tschema.validate_artifact(jax_result().to_dict()) == []


def test_from_dict_raises_schema_error():
    d = make_result().to_dict()
    d["sections"] = []
    with pytest.raises(tschema.SchemaError):
        tschema.BenchResult.from_dict(d)


def test_skipped_section_rows_not_key_checked():
    d = make_result().to_dict()
    assert d["sections"][2]["status"] == "skipped"
    assert tschema.validate_artifact(d) == []


def test_jax_artifacts_load_and_dump_back_equal(tmp_path):
    from test_bench_schema import make_result as jax_result

    for d in (jax_result().to_dict(), json.loads(BASELINE.read_text())):
        r = tschema.BenchResult.from_dict(copy.deepcopy(d))
        path = tmp_path / "back.json"
        r.dump(str(path))
        assert json.loads(path.read_text()) == d
        assert jschema.BenchResult.load(str(path)).to_dict() == d


@pytest.mark.parametrize("name", [
    "SCHEMA_VERSION", "STATUSES", "KNOWN_TIERS", "SHARE_SECTIONS",
    "FUSION_VARIANT_PAIRS", "FUSION_RESIDUAL_FLOOR", "PLATFORM_SWEEP",
    "PLATFORM_GEMM_MARGIN", "PLATFORM_NPU", "SHARDED_TP_SWEEP",
    "SHARDED_EFF_FLOOR", "SHARDED_EFF_CEIL"])
def test_schema_constants_copied(name):
    assert getattr(tschema, name) == getattr(jschema, name)


def test_section_row_keys_equal_jax_but_kernels():
    want = dict(jschema.SECTION_ROW_KEYS)
    assert want.pop("kernels") == tschema.JAX_SECTION_ROW_KEYS["kernels"]
    got = dict(tschema.SECTION_ROW_KEYS)
    assert got.pop("kernels") == ("site", "eager_mb", "kernel_mb", "allclose")
    assert got == want
    assert dict(tschema.JAX_SECTION_ROW_KEYS) == dict(
        jschema.SECTION_ROW_KEYS)


def _defs(path: pathlib.Path, names):
    """AST dumps of the named top-level functions and classes, docstrings
    stripped."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            del body[0]
    # the same code up to the package's name in an import
    return {n.name: ast.dump(n).replace("'repro_torch.", "'repro.")
            for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and n.name in names}


@pytest.mark.parametrize("module,names", [
    ("bench/schema.py",
     ("_is_num", "check_fusion_invariant", "check_vision_invariant",
      "check_traffic_invariant", "check_sharded_invariant",
      "check_platforms_invariant", "SchemaError", "BenchCase",
      "SectionResult", "BenchResult", "_check_num")),
    ("bench/compare.py",
     ("_check_qdq_direction", "_check_fusion_direction",
      "_check_vision_direction", "_check_traffic_direction",
      "_check_sharded_direction", "_check_platforms_direction", "Finding",
      "_row_key", "_index_rows", "_rel_delta", "compare_artifacts",
      "render_summary_markdown", "write_github_summary")),
    ("bench/cases.py",
     ("tier_cases", "quick_cases", "bench_config", "serving_config",
      "vision_bench_config", "vision_case_workload", "case_workload",
      "workload_for_case")),
    ("bench/runner.py",
     ("SkipSection", "SectionTimeout", "Section", "register_section",
      "_deadline")),
    ("bench/sections.py",
     ("_results_root", "load_dryrun", "_roofline_rows",
      "section_roofline")),
])
def test_bench_code_copied(module, names):
    """Each of these keeps the original's code but its docstring."""
    got = _defs(REPO / "src" / "repro_torch" / module, names)
    want = _defs(REPO / "src" / "repro" / module, names)
    assert set(got) == set(names) == set(want)
    for name in names:
        assert got[name] == want[name], name


def test_compare_modeled_and_row_keys_equal_jax_but_kernels():
    got, want = dict(tcompare.MODELED_KEYS), dict(jcompare.MODELED_KEYS)
    assert got.pop("kernels") == ("eager_mb", "kernel_mb")
    want.pop("kernels")
    assert got == want
    assert tcompare.MEASURED_KEYS == jcompare.MEASURED_KEYS
    assert tcompare.ROW_KEYS == jcompare.ROW_KEYS
    assert tcompare.SHARE_KEYS == jcompare.SHARE_KEYS


def test_model_config_param_counts_copied_and_exact():
    from repro.models.common import ModelConfig as J

    from repro_torch.models import init_lm
    from repro_torch.models.common import ModelConfig as T

    names = ("_ffn_params", "_mixer_params", "_block_params", "param_counts",
             "n_params", "is_moe")

    def methods(cls_path):
        tree = ast.parse(cls_path.read_text())
        cls = next(n for n in tree.body if isinstance(n, ast.ClassDef)
                   and n.name == "ModelConfig")
        return {n.name: ast.dump(n) for n in cls.body
                if isinstance(n, ast.FunctionDef) and n.name in names}
    got = methods(REPO / "src" / "repro_torch" / "models" / "common.py")
    assert got == methods(REPO / "src" / "repro" / "models" / "common.py")
    assert set(got) == set(names)
    assert J.n_params and T.n_params
    for arch in ("llama2-7b", "gpt2-xl", "stablelm-3b", "gemma3-27b"):
        cfg = reduced(get_config(arch))
        params = init_lm(torch.Generator().manual_seed(0), cfg)
        n = sum(t.numel() for t in _leaves(params))
        assert cfg.n_params() == n, arch


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# compare (test_bench_compare.py on the port, and JAX's baseline)
# ---------------------------------------------------------------------------

def make_artifact() -> tschema.BenchResult:
    S = tschema
    return S.BenchResult(
        tier="quick",
        backend="cuda",
        jax_version="torch " + torch.__version__,
        cases=[S.BenchCase("gpt2-xl b-1", "gpt2-xl", 1, 16)],
        sections=[
            S.SectionResult(
                name="breakdown", title="Fig 1", status="ok", wall_s=1.0,
                rows=[
                    {"case": "gpt2-xl b-1", "mode": "measured_cuda",
                     "total_s": 0.01, "gemm_frac": 0.60,
                     "nongemm_frac": 0.40, "group_fracs": {}, "n_ops": 10},
                    {"case": "gpt2-xl b-1", "mode": "eager_a100",
                     "total_s": 0.001, "gemm_frac": 0.45,
                     "nongemm_frac": 0.55, "group_fracs": {}, "n_ops": 10},
                ]),
            S.SectionResult(
                name="micro", title="Table 2", status="ok", wall_s=1.0,
                rows=[{"operator": "rms_norm", "group": "normalization",
                       "shape": [1, 10, 4096], "jit_us": 95.0,
                       "tpu_model_us": 0.40}]),
            S.SectionResult(
                name="kernels", title="§4.5", status="ok", wall_s=1.0,
                rows=[{"site": "swiglu", "eager_mb": 100.0,
                       "kernel_mb": 38.0, "eager_over_kernel": 2.6,
                       "allclose": True}]),
        ],
    )


def regressions(old, new, **kw):
    return [f for f in tcompare.compare_artifacts(old, new, **kw)
            if f.severity == "regression"]


def test_identical_artifacts_pass():
    a = make_artifact()
    assert regressions(a, copy.deepcopy(a)) == []


def test_share_within_tolerance_passes():
    old, new = make_artifact(), make_artifact()
    new.section("breakdown").rows[0]["nongemm_frac"] = 0.43
    new.section("breakdown").rows[0]["gemm_frac"] = 0.57
    assert regressions(old, new, tolerance=0.05) == []
    assert regressions(old, new, tolerance=0.01)


def test_share_beyond_tolerance_fails():
    old, new = make_artifact(), make_artifact()
    new.section("breakdown").rows[1]["nongemm_frac"] = 0.70
    found = regressions(old, new, tolerance=0.05)
    assert found and "nongemm_frac" in found[0].message


def test_missing_row_is_regression():
    old, new = make_artifact(), make_artifact()
    new.section("breakdown").rows.pop()
    assert any("missing" in f.message for f in regressions(old, new))


def test_extra_row_is_not_regression():
    old, new = make_artifact(), make_artifact()
    new.section("breakdown").rows.append(
        {"case": "llama2-7b b-1", "mode": "measured_cuda", "total_s": 0.02,
         "gemm_frac": 0.5, "nongemm_frac": 0.5, "group_fracs": {},
         "n_ops": 9})
    assert regressions(old, new) == []


def test_section_failure_is_regression():
    old, new = make_artifact(), make_artifact()
    sec = new.section("kernels")
    sec.status, sec.rows, sec.error = "failed", [], "boom"
    assert any("ok -> failed" in f.message for f in regressions(old, new))


def test_missing_section_is_regression():
    old, new = make_artifact(), make_artifact()
    new.sections = [s for s in new.sections if s.name != "micro"]
    assert any(f.where == "section micro" for f in regressions(old, new))


def test_allclose_flip_is_regression_regardless_of_tolerance():
    old, new = make_artifact(), make_artifact()
    new.section("kernels").rows[0]["allclose"] = False
    assert regressions(old, new, tolerance=1.0, rel_tolerance=1e9)


@pytest.mark.parametrize("section,key,value", [
    ("micro", "tpu_model_us", 0.50), ("kernels", "kernel_mb", 47.5),
    ("kernels", "eager_mb", 125.0)])
def test_modeled_number_gated_by_rel_tolerance(section, key, value):
    old, new = make_artifact(), make_artifact()
    new.section(section).rows[0][key] = value     # +25%
    assert regressions(old, new, rel_tolerance=0.15)
    assert regressions(old, new, rel_tolerance=0.30) == []


def test_measured_time_unchecked_by_default():
    old, new = make_artifact(), make_artifact()
    new.section("micro").rows[0]["jit_us"] = 5000.0
    assert regressions(old, new) == []
    assert regressions(old, new, time_tolerance=3.0)
    new.section("micro").rows[0]["jit_us"] = 1.0
    assert regressions(old, new, time_tolerance=3.0) == []


def test_section_wall_clock_gated_only_with_time_tolerance():
    old, new = make_artifact(), make_artifact()
    new.section("micro").wall_s = 100.0
    assert regressions(old, new) == []
    found = regressions(old, new, time_tolerance=3.0)
    assert found and "wall_s" in found[0].message


def test_unmeasured_eager_us_baseline_not_flagged():
    old, new = make_artifact(), make_artifact()
    old.section("micro").rows[0]["eager_us"] = 0.0
    new.section("micro").rows[0]["eager_us"] = 800.0
    assert regressions(old, new, time_tolerance=3.0) == []
    old.section("micro").rows[0]["eager_us"] = 10.0
    assert regressions(old, new, time_tolerance=3.0)


def test_traffic_invariant_rechecked_on_candidate():
    from test_bench_schema import traffic_rows_ok

    def with_traffic():
        a = make_artifact()
        a.sections.append(tschema.SectionResult(
            name="traffic", title="§Traffic", status="ok", wall_s=3.0,
            rows=traffic_rows_ok()))
        return a

    old, new = with_traffic(), with_traffic()
    assert regressions(old, new) == []
    new.section("traffic").rows[0]["parity_ok"] = False
    assert any("bit-identical" in f.message for f in regressions(old, new))
    old2, new2 = with_traffic(), with_traffic()
    new2.section("traffic").rows[2]["warm_service_ttft_s"] = 0.5
    assert any("not below" in f.message for f in regressions(old2, new2))


def test_traffic_table_rendered_in_summary():
    from test_bench_schema import traffic_rows_ok

    new = make_artifact()
    new.sections.append(tschema.SectionResult(
        name="traffic", title="§Traffic", status="ok", wall_s=3.0,
        rows=traffic_rows_ok()))
    text = tcompare.render_summary_markdown(make_artifact(), new, [])
    assert "### traffic" in text
    assert "| t | parity |" in text and "| t | profile |" in text


def test_cli_exit_codes(tmp_path, capsys):
    old, new = make_artifact(), make_artifact()
    old_p, new_p = str(tmp_path / "old.json"), str(tmp_path / "new.json")
    old.dump(old_p)
    new.dump(new_p)
    assert tcompare.main([old_p, new_p]) == 0
    new.section("breakdown").rows[1]["nongemm_frac"] = 0.95
    new.dump(new_p)
    assert tcompare.main([old_p, new_p]) == 1
    assert tcompare.main([old_p, new_p, "--tolerance", "0.9"]) == 0
    capsys.readouterr()
    assert tcompare.main([old_p, str(tmp_path / "nope.json")]) == 2
    (tmp_path / "broken.json").write_text("{\"schema_version\": 1}")
    assert tcompare.main([old_p, str(tmp_path / "broken.json")]) == 2
    capsys.readouterr()


def _perturb_share(d):
    sec = next(s for s in d["sections"] if s["name"] == "breakdown")
    sec["rows"][1]["nongemm_frac"] = min(1.0, sec["rows"][1]["nongemm_frac"]
                                         + 0.2)


def _perturb_status(d):
    sec = next(s for s in d["sections"] if s["name"] == "micro")
    sec.update(status="failed", rows=[], error="Traceback\nboom")


def _perturb_allclose(d):
    sec = next(s for s in d["sections"] if s["name"] == "kernels")
    sec["rows"][0]["allclose"] = False


@pytest.mark.parametrize("perturb", [None, _perturb_share, _perturb_status,
                                     _perturb_allclose])
def test_compare_on_the_baseline_gives_jax_findings_and_exit_codes(
        tmp_path, capsys, perturb):
    base = json.loads(BASELINE.read_text())
    new = copy.deepcopy(base)
    if perturb is not None:
        perturb(new)
    old_p, new_p = tmp_path / "old.json", tmp_path / "new.json"
    old_p.write_text(json.dumps(base))
    new_p.write_text(json.dumps(new))
    got = tcompare.compare_artifacts(tschema.BenchResult.from_dict(base),
                                     tschema.BenchResult.from_dict(new))
    want = jcompare.compare_artifacts(jschema.BenchResult.from_dict(base),
                                      jschema.BenchResult.from_dict(new))
    assert [str(f) for f in got] == [str(f) for f in want]
    assert any(f.severity == "regression" for f in got) == \
        (perturb is not None)
    assert tcompare.main([str(old_p), str(new_p)]) == \
        jcompare.main([str(old_p), str(new_p)])
    capsys.readouterr()


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("table", ["SERVING_CASES", "TRAFFIC_CASES",
                                   "SHARDED_CASES", "VISION_CASES", "CASES"])
def test_case_tables_copied(table):
    got = [dataclasses.asdict(c) for c in getattr(tcases, table)]
    assert got == [dataclasses.asdict(c) for c in getattr(jcases, table)]
    assert tcases._PARAM_BUDGET == jcases._PARAM_BUDGET
    for tier in ("quick", "full"):
        assert [c.alias for c in tcases.tier_cases(tier)] == \
            [c.alias for c in jcases.tier_cases(tier)]
    assert [c.alias for c in tcases.quick_cases()] == \
        [c.alias for c in jcases.quick_cases()]


@pytest.mark.parametrize("arch", sorted({c.arch for c in jcases.CASES}))
def test_bench_config_equals_jax(arch):
    if not tcases.is_ported(arch):
        with pytest.raises(KeyError):
            get_config(arch)
        return
    assert dataclasses.asdict(tcases.bench_config(arch)) == \
        dataclasses.asdict(jcases.bench_config(arch))


@pytest.mark.parametrize("arch", ["vit-b16-cls", "detector-vit-s"])
def test_vision_bench_config_equals_jax(arch):
    assert dataclasses.asdict(tcases.vision_bench_config(arch)) == \
        dataclasses.asdict(jcases.vision_bench_config(arch))


def test_quick_lm_cases_stay_at_full_width():
    for c in tcases.quick_cases():
        cfg, full = tcases.bench_config(c.arch), get_config(c.arch)
        assert (cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_heads) == \
            (full.d_model, full.d_ff, full.vocab_size, full.n_heads)
        assert cfg.dtype == "float32" and cfg.n_layers == 2
    assert 0.6e9 < tcases.bench_config("llama2-7b").n_params() \
        < tcases._PARAM_BUDGET


def test_full_tier_names_the_unported_archs():
    left = [c.arch for c in tcases.tier_cases("full")
            if not tcases.is_ported(c.arch)]
    assert left == ["qwen2-moe-a2.7b", "recurrentgemma-2b", "xlstm-350m",
                    "deepseek-v2-lite-16b"]
    assert not [c for c in tcases.quick_cases()
                if not tcases.is_ported(c.arch)]


@pytest.mark.parametrize("arch", ["llama2-7b", "gpt2-xl"])
def test_build_gives_jax_logits_on_bridged_params(monkeypatch, clean_caches,
                                                   arch):
    _reduced_configs(monkeypatch)
    jfwd, jparams, jinputs = jcases.build(arch, 1, 16)
    want = np.asarray(jax.jit(jfwd)(jparams, jinputs))
    fwd, params, inputs = tcases.build(arch, 1, 16, "cpu")
    assert inputs.shape == (1, 16) and inputs.device.type == "cpu"
    cfg = tcases.bench_config(arch)
    bridged = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    got = fwd(bridged, torch.from_numpy(np.array(jinputs)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)
    assert tcases.build(arch, 1, 16, "cpu")[1] is params      # memoized


# ---------------------------------------------------------------------------
# sections on the CPU, reduced configs in both packages
# ---------------------------------------------------------------------------

ENGINE_COUNTS = ("requests", "prefill_tokens", "decode_tokens",
                 "first_tokens", "decode_steps")


def test_serving_engine_row_counts_equal_jax(monkeypatch, clean_caches):
    case = tcases.SERVING_CASES[0]
    jrows = jsections.serving_rows(jcases.SERVING_CASES[0])
    jcfg, jparams = jcases.build_serving(case.arch)
    cfg = tcases.serving_config(case.arch)
    params = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    monkeypatch.setattr(tsections, "build_serving",
                        lambda arch, device: (cfg, params))
    rows = tsections.serving_rows(case, device="cpu")
    got, want = rows[0], jrows[0]
    assert got["phase"] == want["phase"] == "engine"
    assert {k: got[k] for k in ENGINE_COUNTS} == \
        {k: want[k] for k in ENGINE_COUNTS}
    assert [r["phase"] for r in rows] == [r["phase"] for r in jrows]


@pytest.fixture(scope="module")
def quick_run(tmp_path_factory):
    """One ``run_bench("quick", device="cpu")`` on reduced configs, with
    no dry-run artifacts."""
    with pytest.MonkeyPatch.context() as mp:
        _reduced_configs(mp)
        mp.setattr(tsections, "RESULTS_DRYRUN",
                   str(tmp_path_factory.mktemp("results") / "dryrun"))
        lines = []
        result = run_bench("quick", device="cpu", progress=lines.append)
    return result, lines


def test_quick_run_every_section_ok_but_the_two_skips(quick_run):
    result, _ = quick_run
    status = {s.name: s.status for s in result.sections}
    assert status.pop("serving_sharded") == "skipped"
    assert status.pop("roofline") == "skipped"
    assert set(status.values()) == {"ok"}, \
        [(s.name, s.error) for s in result.sections if s.status == "failed"]
    assert "tensor-parallel serving is not ported yet" in \
        result.section("serving_sharded").error
    assert result.backend == "cpu"
    assert result.jax_version == "torch " + torch.__version__
    assert result.meta["cases_not_ported"] == []
    assert set(result.meta["kernel_launches"]) == set(ops.KERNELS)


def test_quick_run_validates_renders_and_compares_clean(quick_run, tmp_path,
                                                       capsys):
    result, _ = quick_run
    d = result.to_dict()
    assert tschema.validate_artifact(d) == []
    path = tmp_path / "bench.json"
    result.dump(str(path))
    assert tschema.BenchResult.load(str(path)) == result
    text = treport.render_artifact(result)
    for s in result.sections:
        assert s.title in text
    assert "kernel_MB" in text and "section wall-clock" in text
    assert tcompare.main([str(path), str(path)]) == 0
    capsys.readouterr()


@pytest.mark.parametrize("section", ["quantized", "fusion", "vision",
                                     "platforms", "traffic"])
def test_quick_run_sections_pass_their_gates(quick_run, section):
    result, _ = quick_run
    rows = result.section(section).rows
    gate = {"quantized": None,
            "fusion": tschema.check_fusion_invariant,
            "vision": tschema.check_vision_invariant,
            "platforms": tschema.check_platforms_invariant,
            "traffic": tschema.check_traffic_invariant}[section]
    assert rows
    if gate is not None:
        assert gate(rows) == []
    else:
        by = {}
        for r in rows:
            by.setdefault(r["case"], {})[r["variant"]] = r["nongemm_frac"]
        assert all(v["int8-qdq"] > v["fp32"] for v in by.values())
    for r in rows:
        for key in tschema.SECTION_ROW_KEYS[section]:
            assert key in r, (section, key)


def test_quick_run_traffic_parity(quick_run):
    rows = {r["phase"]: r for r in quick_run[0].section("traffic").rows}
    assert rows["parity"]["parity_ok"] is True
    assert rows["prefix"]["parity_ok"] is True
    assert rows["prefix"]["hit_rate"] > 0
    assert rows["profile"]["paged_frac"] > 0


def test_quick_run_platform_drift_rows_on_the_cpu_spec(quick_run):
    rows = quick_run[0].section("platforms").rows
    drift = [r for r in rows if r["kind"] != "modeled"]
    assert [(r["kind"], r["platform"]) for r in drift] == \
        [("measured", "cpu"), ("calibrated", "cpu")]
    assert drift[0]["mode"] == "eager_cpu"
    assert drift[1]["mode"] == "calibrated_cpu"
    assert all(r["drift"] for r in drift)


def test_quick_run_breakdown_columns(quick_run):
    rows = quick_run[0].section("breakdown").rows
    cases = [c.alias for c in tcases.quick_cases()]
    assert [(r["case"], r["mode"]) for r in rows] == \
        [(c, "eager_cpu") for c in cases] + [(c, "eager_a100") for c in cases]


def test_harvested_rows_equal_jax(monkeypatch, clean_caches):
    """The harvested micro-bench runs the sites JAX's runs, at the shapes
    JAX's capture gives them (reduced llama2-7b)."""
    _reduced_configs(monkeypatch)
    want = [(r["operator"], r["group"], r["shape"])
            for r in jsections.harvested_rows()]
    got = tsections.harvested_rows(device="cpu")
    assert [(r["operator"], r["group"], r["shape"]) for r in got] == want
    assert want and all(r["device"] == "cpu" for r in got)


def test_harvested_section_fails_when_a_micro_run_fails(monkeypatch,
                                                        clean_caches):
    """A micro run that raises fails the section: no row is dropped
    while the section reports ok."""
    _reduced_configs(monkeypatch)

    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(tsections, "run_micro", broken)
    r = run_section(SECTIONS["micro_harvested"], ctx())
    assert r.status == "failed" and r.rows == []
    assert "kernel launch failed" in r.error


def test_full_run_leaves_out_the_unported_cases():
    """A full run names the archs the port cannot build yet, before any
    section runs."""
    lines = []
    result = run_bench("full", section_names=["roofline"], device="cpu",
                       progress=lines.append)
    names = [c["arch"] for c in result.meta["cases_not_ported"]]
    assert names == ["qwen2-moe-a2.7b", "recurrentgemma-2b", "xlstm-350m",
                     "deepseek-v2-lite-16b"]
    assert not {c.arch for c in result.cases} & set(names)
    assert any("not ported" in line and "xlstm-350m" in line
               for line in lines)


# ---------------------------------------------------------------------------
# the device rule
# ---------------------------------------------------------------------------

def test_run_bench_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the rule is for a machine without")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_bench()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_bench(device="cuda", section_names=["roofline"])


def test_cli_raises_without_cuda_unless_the_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the rule is for a machine without")
    env_py = [sys.executable, "-m", "repro_torch.bench", "run", "--sections",
              "roofline", "--out", str(tmp_path / "b.json")]
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    r = subprocess.run(env_py, capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode != 0 and "CUDA is not available" in r.stderr
    assert not (tmp_path / "b.json").exists()
    r = subprocess.run(env_py + ["--device", "cpu"], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    art = tschema.BenchResult.load(str(tmp_path / "b.json"))
    assert art.backend == "cpu" and art.section("roofline").status in (
        "skipped", "ok")
    assert r.stdout.splitlines()[-1].startswith("kernel launches {")


def test_list_names_every_case(capsys):
    from repro_torch.bench.__main__ import main

    assert main(["list", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert [r["name"] for r in out["cases"]] == \
        [c.alias for c in tcases.CASES + tcases.SERVING_CASES
         + tcases.VISION_CASES]
    assert sum(r["builder"] == "not ported yet" for r in out["cases"]) == 4


def test_package_exports_jax_names_but_the_compiled_view():
    import repro.bench as jbench

    import repro_torch.bench as tbench
    assert set(tbench.__all__) == set(jbench.__all__) - {
        "profile_case_compiled"}
    assert all(hasattr(tbench, n) for n in tbench.__all__)
