"""The port's nglint (``repro_torch.analysis``) on the CPU.

Each test of ``tests/test_analysis.py`` but NG010's two (the port has no
tensor-parallel collectives yet) again on the port's records: a planted
positive and a clean negative per rule, the registry, the baseline gate
and the CLI. Beside them:

* the rule table (ids, severities, titles, scopes) equals JAX's minus
  NG010;
* a baseline the port writes is read by JAX's ``load_baseline``, and the
  reverse;
* NG002, NG003, NG004 and NG007 give JAX's findings on the same synthetic
  streams, translated field by field (``"bfloat16"`` → ``"torch.bfloat16"``,
  ``convert_element_type`` ↔ ``aten._to_copy``, ``mul`` → ``aten.mul``):
  JAX's own captures are not compared (jax 0.9 records a ``jit`` equation
  as one untagged op);
* the rules over every reduced config of the zoo, captured on the CPU under
  both ``nn`` backends: no finding (NG001 failed on recurrentgemma-2b while
  ``aten.logaddexp`` / ``aten.rsub`` fell to OTHER, NG006 while
  ``estimate_flops`` priced ops by their site's group);
* ``estimate_flops`` by the op, held to JAX's ``estimate_flops`` of the
  same primitive;
* the CLI: one cell on ``--device cpu`` under ``nn.backend("cuda")`` clean
  against the committed baseline (written on the card; the card's records
  equal these, ``chip_smoke.py`` phase ``nglint`` (c)), ``--write-baseline``
  to a temporary path leaving both committed baselines as they were, and
  ``--device cuda`` without a card exiting 2.
"""

import dataclasses
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import baseline as jbaseline  # noqa: E402
from repro.analysis import rules as jrules  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.core.taxonomy import OpGroup as JOpGroup  # noqa: E402

from repro_torch import nn  # noqa: E402
from repro_torch.analysis import cli as A_cli  # noqa: E402
from repro_torch.analysis.baseline import (DEFAULT_BASELINE,  # noqa: E402
                                           AnalysisBaseline, BaselineError,
                                           WorkloadBaseline, build_baseline,
                                           gate_findings, load_baseline,
                                           save_baseline)
from repro_torch.analysis.rules import (AnalysisContext, Finding,  # noqa: E402
                                        Rule, all_rules, get_rule,
                                        register_rule, run_rules,
                                        run_static_rules)
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.core import fusion as F  # noqa: E402
from repro_torch.core.graph import OpRecord, capture, estimate_flops  # noqa: E402
from repro_torch.core.taxonomy import OpGroup, scope_tag  # noqa: E402
from repro_torch.core.workload import Workload  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_BASELINE = REPO / "benchmarks" / "analysis_baseline.json"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The captures run thousands of tiny ops: beside the other workers of
    a parallel test run, the intra-op thread pool makes each cost ~15x what
    it costs on one thread (reduced xlstm-350m: 52 s against 3 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rec(index, prim, group, op_site, scope="", *, out_shapes=((4, 8),),
         out_dtypes=("torch.float32",), in_shapes=((4, 8),),
         in_dtypes=("torch.float32",), flops=32.0, nbytes=256.0,
         in_vids=(), out_vids=()):
    return OpRecord(index=index, prim=prim, group=group, op_site=op_site,
                    scope=scope, in_shapes=in_shapes, in_dtypes=in_dtypes,
                    out_shapes=out_shapes, out_dtypes=out_dtypes,
                    flops=flops, bytes_accessed=nbytes,
                    in_var_ids=tuple(in_vids), out_var_ids=tuple(out_vids))


def _ctx(records, rewritten=None, fused=False, **kw):
    return AnalysisContext(
        workload=Workload(name="synthetic", arch="synthetic"),
        variant="fused" if fused else "fp32",
        records=list(records),
        rewritten=list(records if rewritten is None else rewritten),
        fused=fused, **kw)


def _run(rule_id, ctx):
    return run_rules(ctx, rules=[get_rule(rule_id)])


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_all_nine_builtin_rules_registered():
    ids = [r.id for r in all_rules()]
    assert [f"NG{i:03d}" for i in range(1, 10)] == ids


def test_rule_table_equals_jax_but_ng010():
    import repro.analysis  # noqa: F401  (registers JAX's rules)

    want = [(r.id, r.severity, r.title, r.scope) for r in jrules.all_rules()
            if r.id != "NG010"]
    assert [(r.id, r.severity, r.title, r.scope) for r in all_rules()] == want


def test_register_rule_rejects_duplicate_id():
    with pytest.raises(ValueError, match="duplicate"):
        register_rule(Rule(id="NG001", title="x", severity="error",
                           check=lambda ctx: []))


def test_rule_validates_severity_and_scope():
    with pytest.raises(ValueError, match="severity"):
        Rule(id="NGX", title="x", severity="fatal", check=lambda c: [])
    with pytest.raises(ValueError, match="scope"):
        Rule(id="NGX", title="x", severity="error", check=lambda c: [],
             scope="galactic")


def test_crashing_rule_becomes_error_finding_not_crash():
    def boom(ctx):
        raise RuntimeError("kaboom")

    bad = Rule(id="NG999", title="crash test", severity="info", check=boom)
    out = run_rules(_ctx([]), rules=[bad])
    assert len(out) == 1
    assert out[0].severity == "error"
    assert "kaboom" in out[0].message
    assert "repro_torch/analysis/builtin.py" in out[0].fix_hint


def test_finding_roundtrips_through_dict():
    f = Finding(rule="NG001", severity="error", workload="w/fp32",
                where="x", message="m", fix_hint="h")
    assert Finding.from_dict(f.to_dict()) == f


# ---------------------------------------------------------------------------
# NG001 — unknown primitive binned to OTHER
# ---------------------------------------------------------------------------

def test_ng001_flags_synthetically_unregistered_primitive():
    recs = [_rec(0, "aten.frobnicate", OpGroup.OTHER, "aten.frobnicate"),
            _rec(1, "aten.frobnicate", OpGroup.OTHER, "aten.frobnicate")]
    out = _run("NG001", _ctx(recs))
    assert len(out) == 1  # deduped per primitive
    assert out[0].rule == "NG001" and out[0].severity == "error"
    assert "aten.frobnicate" in out[0].message


def test_ng001_accepts_registered_and_deliberately_tagged_other():
    tagged_other = _rec(0, "aten.weird", OpGroup.OTHER, "custom",
                        scope=scope_tag(OpGroup.OTHER, "custom"))
    known = _rec(1, "aten.add", OpGroup.ELEMENTWISE, "aten.add")
    # registered under OTHER (a host read)
    item = _rec(2, "aten._local_scalar_dense", OpGroup.OTHER,
                "aten._local_scalar_dense")
    assert _run("NG001", _ctx([tagged_other, known, item])) == []


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_clean_on_every_reduced_config(arch, backend):
    """Every rule over the reduced config's f32 capture: no finding. NG001
    caught recurrentgemma-2b's softplus (``aten.logaddexp``) and
    ``1 - a**2`` (``aten.rsub``) binned OTHER; NG006 every op of a
    MEMORY / QUANT / INTERPOLATION / ROI site and ``aten.convolution``
    priced 0 FLOPs."""
    w = Workload(name=arch, arch=arch)
    with nn.backend(backend):
        fn, args = w.build("cpu")
        records = capture(fn, *args)
    assert records
    assert run_rules(_ctx(records)) == []


# ---------------------------------------------------------------------------
# NG002 — skipped FUSION_PATTERNS match
# ---------------------------------------------------------------------------

def _captured_add_norm_block():
    scale = torch.ones(32)
    x = torch.ones(4, 32)
    res = torch.ones(4, 32)

    def block(x, res, scale):
        return nn.rms_norm(nn.residual_add(x, res), scale)

    with nn.backend("torch"):
        return capture(block, x, res, scale)


def test_ng002_catches_deliberately_skipped_pattern_match():
    records = _captured_add_norm_block()
    subset = tuple(p for p in F.FUSION_PATTERNS
                   if p.name not in ("fused_add_rms_norm", "fused_rms_norm"))
    partially_fused, _ = F.fuse_records(records, patterns=subset)
    out = _run("NG002", _ctx(records, rewritten=partially_fused, fused=True))
    assert out, "NG002 missed the add->rms_norm chain the subset skipped"
    assert {f.rule for f in out} == {"NG002"}
    assert any("fused_add_rms_norm" in f.where for f in out)


def test_ng002_clean_on_fully_fused_stream():
    records = _captured_add_norm_block()
    fused, report = F.fuse_records(records)
    assert report.n_fused >= 1
    assert _run("NG002", _ctx(records, rewritten=fused, fused=True)) == []


def test_ng002_silent_on_unfused_variants():
    records = _captured_add_norm_block()
    assert _run("NG002", _ctx(records, fused=False)) == []


# ---------------------------------------------------------------------------
# NG003 — f32 leak out of a low-precision site
# ---------------------------------------------------------------------------

def test_ng003_flags_f32_leak_from_low_precision_site():
    site = scope_tag(OpGroup.INTERPOLATION, "interpolate_bilinear")
    prod = _rec(0, "aten.mul", OpGroup.INTERPOLATION, "interpolate_bilinear",
                scope=site, in_dtypes=("torch.bfloat16", "torch.bfloat16"),
                out_dtypes=("torch.float32",), out_vids=(101,))
    cons = _rec(1, "aten.add", OpGroup.ELEMENTWISE, "residual_add",
                scope=scope_tag(OpGroup.ELEMENTWISE, "residual_add"),
                in_vids=(101,))
    out = _run("NG003", _ctx([prod, cons]))
    assert len(out) == 1
    assert "interpolate_bilinear" in out[0].where


def test_ng003_clean_when_site_casts_back():
    site = scope_tag(OpGroup.INTERPOLATION, "interpolate_bilinear")
    prod = _rec(0, "aten.mul", OpGroup.INTERPOLATION, "interpolate_bilinear",
                scope=site, in_dtypes=("torch.bfloat16",),
                out_dtypes=("torch.bfloat16",), out_vids=(101,))
    cons = _rec(1, "aten.add", OpGroup.ELEMENTWISE, "residual_add",
                in_vids=(101,))
    assert _run("NG003", _ctx([prod, cons])) == []


# ---------------------------------------------------------------------------
# NG004 — cancelling quantize->dequantize
# ---------------------------------------------------------------------------

def _qdq_records(consumer_group, consumer_site):
    q_scope = scope_tag(OpGroup.QUANT, "quantize")
    d_scope = scope_tag(OpGroup.QUANT, "dequantize")
    recs = [
        _rec(0, "aten.round", OpGroup.QUANT, "quantize", scope=q_scope,
             out_vids=(1,)),
        _rec(1, "aten.mul", OpGroup.QUANT, "dequantize", scope=d_scope,
             in_vids=(1,), out_vids=(2,)),
    ]
    if consumer_group is not None:
        recs.append(_rec(2, "aten.mm" if consumer_group == OpGroup.GEMM
                         else "aten.add", consumer_group, consumer_site,
                         in_vids=(2,)))
    return recs


def test_ng004_flags_dequantize_feeding_no_gemm():
    out = _run("NG004", _ctx(_qdq_records(OpGroup.ELEMENTWISE, "add")))
    assert len(out) == 1
    assert "non-GEMM" in out[0].message


def test_ng004_flags_dead_dequantize():
    out = _run("NG004", _ctx(_qdq_records(None, None)))
    assert len(out) == 1
    assert "never consumed" in out[0].message


def test_ng004_clean_when_dequantize_feeds_gemm():
    assert _run("NG004", _ctx(_qdq_records(OpGroup.GEMM, "linear"))) == []


def test_ng004_flags_untagged_cancelling_cast_roundtrip():
    recs = [
        _rec(0, "aten._to_copy", OpGroup.MEMORY, "aten._to_copy",
             in_dtypes=("torch.float32",), out_dtypes=("torch.bfloat16",),
             out_vids=(5,)),
        _rec(1, "aten._to_copy", OpGroup.MEMORY, "aten._to_copy",
             in_dtypes=("torch.bfloat16",), out_dtypes=("torch.float32",),
             in_vids=(5,)),
    ]
    out = _run("NG004", _ctx(recs))
    assert len(out) == 1
    assert "round-trip" in out[0].message


# ---------------------------------------------------------------------------
# NG002 / NG003 / NG004 / NG007 against JAX's rules on the same streams
# ---------------------------------------------------------------------------

_JAX_PRIM = {"aten._to_copy": "convert_element_type", "aten.mm": "dot_general"}


def _to_jax(r: OpRecord):
    """The JAX twin of a synthetic port record, field by field."""
    prim = _JAX_PRIM.get(r.prim, r.prim.removeprefix("aten."))
    return jgraph.OpRecord(
        index=r.index, prim=prim, group=JOpGroup(r.group.value),
        op_site=_JAX_PRIM.get(r.op_site, r.op_site.removeprefix("aten.")),
        scope=r.scope, in_shapes=r.in_shapes,
        in_dtypes=tuple(d.removeprefix("torch.") for d in r.in_dtypes),
        out_shapes=r.out_shapes,
        out_dtypes=tuple(d.removeprefix("torch.") for d in r.out_dtypes),
        flops=r.flops, bytes_accessed=r.bytes_accessed,
        in_var_ids=r.in_var_ids, out_var_ids=r.out_var_ids)


def _streams():
    """(rule, records, rewritten or None, fused) cases, both verdicts."""
    add_norm = [
        _rec(0, "aten.add", OpGroup.ELEMENTWISE, "residual_add",
             scope=scope_tag(OpGroup.ELEMENTWISE, "residual_add"),
             in_vids=(1, 2), out_vids=(3,)),
        _rec(1, "aten.mul", OpGroup.NORMALIZATION, "rms_norm",
             scope=scope_tag(OpGroup.NORMALIZATION, "rms_norm"),
             in_vids=(3,), out_vids=(4,)),
        _rec(2, "aten.rsqrt", OpGroup.NORMALIZATION, "rms_norm",
             scope=scope_tag(OpGroup.NORMALIZATION, "rms_norm"),
             in_vids=(4,), out_vids=(5,)),
    ]
    site = scope_tag(OpGroup.INTERPOLATION, "interpolate_bilinear")
    leak = [
        _rec(0, "aten.mul", OpGroup.INTERPOLATION, "interpolate_bilinear",
             scope=site, in_dtypes=("torch.bfloat16", "torch.bfloat16"),
             out_dtypes=("torch.float32",), out_vids=(7,)),
        _rec(1, "aten.add", OpGroup.ELEMENTWISE, "residual_add",
             scope=scope_tag(OpGroup.ELEMENTWISE, "residual_add"),
             in_vids=(7,)),
        _rec(2, "aten.mul", OpGroup.ACTIVATION, "gelu",
             scope=scope_tag(OpGroup.ACTIVATION, "gelu"), in_vids=(7,)),
    ]
    cast_back = [dataclasses.replace(leak[0], out_dtypes=("torch.bfloat16",)),
                 *leak[1:]]
    casts = [
        _rec(0, "aten._to_copy", OpGroup.MEMORY, "aten._to_copy",
             scope="layer0", in_dtypes=("torch.float32",),
             out_dtypes=("torch.bfloat16",), out_vids=(5,)),
        _rec(1, "aten._to_copy", OpGroup.MEMORY, "aten._to_copy",
             scope="layer0", in_dtypes=("torch.bfloat16",),
             out_dtypes=("torch.float32",), in_vids=(5,), out_vids=(6,)),
        _rec(2, "aten._to_copy", OpGroup.MEMORY, "aten._to_copy",
             in_dtypes=("torch.float32",), out_dtypes=("torch.bfloat16",),
             out_vids=(8,)),
        _rec(3, "aten.mm", OpGroup.GEMM, "linear", in_vids=(8,)),
    ]
    tags = [_rec(0, "aten.add", OpGroup.ELEMENTWISE, "add",
                 scope="layer0/ng:notagroup:foo"),
            _rec(1, "aten.add", OpGroup.ELEMENTWISE, "residual_add",
                 scope=scope_tag(OpGroup.ELEMENTWISE, "residual_add")),
            _rec(2, "aten.add", OpGroup.ELEMENTWISE, "add",
                 scope="ng:elementwise:bad name")]
    return {
        "ng002-left": ("NG002", add_norm, None, True),
        "ng002-unfused": ("NG002", add_norm, None, False),
        "ng003-leak": ("NG003", leak, None, False),
        "ng003-cast-back": ("NG003", cast_back, None, False),
        "ng004-no-gemm": ("NG004", _qdq_records(OpGroup.ELEMENTWISE, "add"),
                          None, False),
        "ng004-dead": ("NG004", _qdq_records(None, None), None, False),
        "ng004-gemm": ("NG004", _qdq_records(OpGroup.GEMM, "linear"), None,
                       False),
        "ng004-casts": ("NG004", casts, None, False),
        "ng007-tags": ("NG007", tags, None, False),
    }


@pytest.mark.parametrize("case", sorted(_streams()))
def test_rule_agrees_with_jax_on_the_same_stream(case):
    import repro.analysis  # noqa: F401  (registers JAX's rules)
    from repro.core.workload import Workload as JWorkload

    rule_id, records, rewritten, fused = _streams()[case]
    got = _run(rule_id, _ctx(records, rewritten=rewritten, fused=fused))
    jrecs = [_to_jax(r) for r in records]
    jctx = jrules.AnalysisContext(
        workload=JWorkload(name="synthetic", arch="synthetic"),
        variant="fused" if fused else "fp32", records=jrecs,
        rewritten=[_to_jax(r) for r in rewritten] if rewritten else jrecs,
        fused=fused)
    want = jrules.run_rules(jctx, rules=[jrules.get_rule(rule_id)])

    def key(f, table):
        where = f.where
        for a, b in table.items():
            where = where.replace(a, b)
        return f.rule, f.severity, f.workload, where
    assert [key(f, _JAX_PRIM) for f in got] == [key(f, {}) for f in want]
    if case.endswith(("left", "leak", "no-gemm", "dead", "casts", "tags")):
        assert got, f"{case}: the planted defect went unflagged"


# ---------------------------------------------------------------------------
# NG005 — kernel spec soundness (static scope)
# ---------------------------------------------------------------------------

def test_static_rules_clean_on_this_repo():
    assert run_static_rules() == []


def test_kernel_specs_cover_every_kernel_and_pattern():
    from repro_torch.kernels import attn_template, ops

    assert set(ops.KERNEL_SPECS) == set(ops.KERNELS)
    assert {p.kernel for p in F.FUSION_PATTERNS if p.kernel} \
        <= set(ops.KERNEL_SPECS)
    assert set(attn_template.ENTRIES) <= set(ops.KERNEL_SPECS)
    assert ops.KERNEL_SPECS["nms"].qualname == "repro_torch::nms_sorted"


def test_ng005_flags_pattern_naming_missing_kernel(monkeypatch):
    bad = F.FusionPattern("fused_ghost",
                          ((OpGroup.NORMALIZATION, "rms_norm"),),
                          min_records=2, kernel="ghost_kernel")
    monkeypatch.setattr(F, "FUSION_PATTERNS", F.FUSION_PATTERNS + (bad,))
    out = run_static_rules(rules=[get_rule("NG005")])
    assert any("ghost_kernel" in f.message for f in out)


def test_ng005_flags_unsound_kernel_spec(monkeypatch):
    from repro_torch.kernels import attn_template
    from repro_torch.kernels import ops as K

    monkeypatch.setitem(
        K.KERNEL_SPECS, "bad_kernel",
        K.KernelSpec(name="bad_kernel", op="no_such_op", plain=None,
                     sources=("ghost.cu",), handles_remainder=None))
    monkeypatch.setattr(attn_template, "ENTRIES",
                        attn_template.ENTRIES + ("attention_ghost",))
    out = run_static_rules(rules=[get_rule("NG005")])
    msgs = [f.message for f in out if f.where == "kernel:bad_kernel"]
    assert any("not registered" in m for m in msgs)
    assert any("no plain version" in m for m in msgs)
    assert any("ghost.cu" in m for m in msgs)
    assert any("not counted" in m for m in msgs)
    assert any("partial-tile" in m for m in msgs)
    assert any(f.where == "attn_template:attention_ghost" for f in out)


# ---------------------------------------------------------------------------
# NG006 — estimator holes
# ---------------------------------------------------------------------------

def test_ng006_flags_zero_bytes_and_zero_flop_compute():
    recs = [
        _rec(0, "aten.mystery_move", OpGroup.MEMORY, "aten.mystery_move",
             nbytes=0.0, flops=0.0),
        _rec(1, "aten.tanh", OpGroup.ACTIVATION, "aten.tanh", flops=0.0),
    ]
    out = _run("NG006", _ctx(recs))
    assert len(out) == 2
    assert any("bytes_accessed == 0" in f.message for f in out)
    assert any("flops == 0" in f.message for f in out)


def test_ng006_accepts_zero_width_outputs_and_memory_ops():
    recs = [
        _rec(0, "aten.slice", OpGroup.MEMORY, "aten.slice",
             out_shapes=((4, 0),), nbytes=0.0, flops=0.0),
        _rec(1, "aten.view", OpGroup.MEMORY, "aten.view", flops=0.0),
    ]
    assert _run("NG006", _ctx(recs)) == []


@pytest.mark.parametrize("prim, jprim, group, ins, outs, params", [
    ("aten.mul", "mul", OpGroup.MEMORY, ((4, 8), (4, 8)), ((4, 8),), {}),
    ("aten.exp", "exp", OpGroup.QUANT, ((4, 8),), ((4, 8),), {}),
    ("aten.sum", "reduce_sum", OpGroup.MEMORY, ((4, 8),), ((4,),), {}),
    ("aten.sort", "sort", OpGroup.ROI, ((64,),), ((64,),), {}),
    ("aten.view", "reshape", OpGroup.ELEMENTWISE, ((4, 8),), ((32,),), {}),
    ("aten.convolution", "conv_general_dilated", OpGroup.GEMM,
     ((1, 3, 32, 32), (16, 3, 4, 4), (16,)), ((1, 16, 8, 8),),
     {"feature_group_count": 1}),
])
def test_estimate_flops_by_the_op_as_jax(prim, jprim, group, ins, outs,
                                         params):
    assert estimate_flops(prim, group, ins, outs) == \
        jgraph.estimate_flops(jprim, params, ins, outs)


# ---------------------------------------------------------------------------
# NG007 — scope-tag discipline
# ---------------------------------------------------------------------------

def test_ng007_flags_unparseable_ng_tag():
    recs = [_rec(0, "aten.add", OpGroup.ELEMENTWISE, "aten.add",
                 scope="layer0/ng:notagroup:foo")]
    out = _run("NG007", _ctx(recs))
    assert len(out) == 1 and out[0].severity == "error"


def test_ng007_clean_on_valid_tags_and_untagged_scopes():
    recs = [_rec(0, "aten.add", OpGroup.ELEMENTWISE, "residual_add",
                 scope=scope_tag(OpGroup.ELEMENTWISE, "residual_add")),
            _rec(1, "aten.add", OpGroup.ELEMENTWISE, "aten.add",
                 scope="layer0")]
    assert _run("NG007", _ctx(recs)) == []


# ---------------------------------------------------------------------------
# NG008 — share drift vs baseline
# ---------------------------------------------------------------------------

def test_ng008_flags_share_drift_beyond_tolerance():
    ctx = _ctx([], group_shares={"gemm": 0.50, "normalization": 0.20},
               baseline_shares={"gemm": 0.60, "normalization": 0.19},
               share_tolerance=0.03)
    out = _run("NG008", ctx)
    assert len(out) == 1
    assert out[0].where == "group:gemm"
    assert "repro_torch.analyze" in out[0].fix_hint


def test_ng008_silent_without_baseline_entry_or_within_tolerance():
    assert _run("NG008", _ctx([], group_shares={"gemm": 0.5})) == []
    ctx = _ctx([], group_shares={"gemm": 0.51},
               baseline_shares={"gemm": 0.50}, share_tolerance=0.03)
    assert _run("NG008", ctx) == []


# ---------------------------------------------------------------------------
# NG009 — paged-KV bookkeeping ops in MEMORY with nonzero bytes (static)
# ---------------------------------------------------------------------------

def test_ng009_clean_on_this_repo():
    assert run_static_rules(rules=[get_rule("NG009")]) == []


def test_ng009_flags_untagged_paged_op(monkeypatch):
    monkeypatch.setattr(nn, "paged_kv_gather",
                        nn.paged_kv_gather.__wrapped__)
    out = run_static_rules(rules=[get_rule("NG009")])
    assert any("paged_kv_gather" in f.where and "tag" in f.message
               for f in out)


# ---------------------------------------------------------------------------
# baseline gate
# ---------------------------------------------------------------------------

def _finding(rule="NG006", workload="w/fp32"):
    return Finding(rule=rule, severity="warning", workload=workload,
                   where="x", message="m")


def test_gate_without_baseline_everything_is_new():
    fs = [_finding(), _finding()]
    assert gate_findings(fs, None) == fs


def test_gate_consumes_per_rule_budget_in_stream_order():
    baseline = AnalysisBaseline(workloads={
        "w/fp32": WorkloadBaseline(findings={"NG006": 1})})
    fs = [_finding(), _finding(), _finding(workload="other/fp32")]
    new = gate_findings(fs, baseline)
    assert new == [fs[1], fs[2]]


def test_baseline_roundtrip_and_version_check(tmp_path):
    p = tmp_path / "b.json"
    b = build_baseline({"w/fp32": {"gemm": 0.5}}, [_finding()],
                       share_tolerance=0.05)
    save_baseline(b, p)
    loaded = load_baseline(p)
    assert loaded.share_tolerance == 0.05
    assert loaded.entry("w/fp32").findings == {"NG006": 1}
    assert loaded.entry("w/fp32").group_shares == {"gemm": 0.5}

    stale = b.to_dict()
    stale["version"] = 99
    p.write_text(json.dumps(stale))
    with pytest.raises(BaselineError, match="version"):
        load_baseline(p)
    with pytest.raises(BaselineError, match="not found"):
        load_baseline(tmp_path / "missing.json")


def test_baseline_files_read_by_the_other_package(tmp_path):
    ours = build_baseline({"w/fp32": {"gemm": 0.5, "memory": 0.25}},
                          [_finding(), _finding(rule="NG003")],
                          share_tolerance=0.04)
    save_baseline(ours, tmp_path / "port.json")
    read = jbaseline.load_baseline(tmp_path / "port.json")
    assert read.to_dict() == ours.to_dict()

    theirs = jbaseline.build_baseline(
        {"x/fused": {"fused": 0.125}},
        [jrules.Finding(rule="NG002", severity="error", workload="x/fused",
                        where="w", message="m")])
    jbaseline.save_baseline(theirs, tmp_path / "jax.json")
    assert load_baseline(tmp_path / "jax.json").to_dict() == theirs.to_dict()
    committed = jbaseline.load_baseline(DEFAULT_BASELINE)
    assert committed.to_dict() == load_baseline(DEFAULT_BASELINE).to_dict()


def test_committed_baseline_parses_and_covers_the_zoo():
    assert pathlib.Path(DEFAULT_BASELINE) == \
        REPO / "src" / "repro_torch" / "analysis" / "analysis_baseline.json"
    b = load_baseline(DEFAULT_BASELINE)
    keys = set(b.workloads)
    assert len(keys) == 48
    for arch in A_cli.zoo_ids():
        for variant in A_cli.DEFAULT_VARIANTS:
            assert f"{arch}/{variant}" in keys


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_list_rules_and_workloads(capsys):
    assert A_cli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert "NG001" in out and "NG009" in out and "NG010" not in out
    assert A_cli.main(["--list"]) == 0
    listed = capsys.readouterr().out.split()
    assert "gpt2-xl" in listed and len(listed) == 16


def test_cli_rejects_unknown_workload_and_variant(capsys):
    assert A_cli.main(["no_such_model", "--device", "cpu"]) == 2
    assert A_cli.main(["--variants", "fp99", "--device", "cpu"]) == 2


def test_cli_device_cuda_without_a_card_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert A_cli.main(["bert-base"]) == 2
    assert "CUDA is not available" in capsys.readouterr().err


def test_cli_single_cell_runs_clean_against_committed_baseline(tmp_path):
    art = tmp_path / "analysis.json"
    with nn.backend("cuda"):
        rc = A_cli.main(["bert-base", "--variants", "fp32", "--device",
                         "cpu", "-q", "--out", str(art)])
    assert rc == 0
    data = json.loads(art.read_text())
    assert data["new_findings"] == [] and data["findings"] == []
    assert "bert-base/fp32" in data["workloads"]
    assert data["workloads"]["bert-base/fp32"]["n_records"] > 0


def test_cli_write_baseline_leaves_the_committed_files(tmp_path):
    before = {p: p.read_bytes()
              for p in (JAX_BASELINE, pathlib.Path(DEFAULT_BASELINE))}
    out = tmp_path / "b.json"
    with nn.backend("cuda"):
        rc = A_cli.main(["gpt2-xl", "--variants", "fused", "--device",
                         "cpu", "-q", "--write-baseline", "--baseline",
                         str(out)])
    assert rc == 0
    assert set(load_baseline(out).workloads) == {"gpt2-xl/fused"}
    for p, data in before.items():
        assert p.read_bytes() == data


def test_render_summary_markdown_lists_new_findings():
    md = A_cli.render_summary_markdown([], [_finding()], [_finding()])
    assert "nglint" in md and "NG006" in md and "| rule |" in md
    clean = A_cli.render_summary_markdown([], [], [])
    assert "No new findings" in clean


def test_write_github_summary_appends(tmp_path, monkeypatch):
    target = tmp_path / "summary.md"
    monkeypatch.setenv("GITHUB_STEP_SUMMARY", str(target))
    assert A_cli.write_github_summary("hello")
    assert A_cli.write_github_summary("world")
    assert target.read_text() == "hello\nworld\n"
    monkeypatch.delenv("GITHUB_STEP_SUMMARY")
    assert not A_cli.write_github_summary("dropped")


def test_build_context_variant_labels_match_baseline_keys():
    assert set(A_cli.DEFAULT_VARIANTS) <= set(A_cli.VARIANTS)
    a = A_cli.VARIANTS["fused"]()
    b = A_cli.VARIANTS["fused"]()
    assert a is not b
