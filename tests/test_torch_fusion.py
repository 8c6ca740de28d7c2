"""The port's fusion pass (``repro_torch.core.fusion``) against JAX's.

* **Synthetic records.** The same OpRecord lists, built in both packages,
  give equal ``fuse_records`` streams and reports, equal
  ``find_fusable_chains`` results and equal ``model_records`` group
  seconds: every pattern, the scope, dataflow (serials and the shape
  fallback) and trip-count refusals, live intermediates, the executed-fused
  collapse. The port's fused records name ``ops.KERNELS`` entries where
  JAX's name its Pallas entry points (``"attn_template:decode"`` is
  ``"decode_core"``, ``"fused_rope"`` is ``"rope"``) and carry
  ``FUSED_PRIM``; records are compared with those mapped.
* **The port's captures** of ``test_fusion.py``'s small nn chains (the
  add→norm chains, the dequant epilogue, the QDQ round-trip, rope and
  SwiGLU collapses, adjacent invocations, the dataflow refusals, live
  intermediates, executed fusion) fire what JAX's capture fires.
  ``test_fusion.py``'s cases that read an untagged op by its jaxpr name
  (``silu(g) * u``, ``argmax(softmax(x))``) have no counterpart: an
  untagged op of the port is named by its aten op (``aten.mul``); the
  synthetic records cover those patterns. Its named-scope case needs a
  user scope the port's tag stack does not have (synthetic records cover
  the scope refusal), and its Pallas-interpret, bench-compare and
  microbench-registration cases have other homes or no twin.
* **Whole models.** Reduced llama2-7b and gpt2-xl on bridged weights: the
  pass on the port's capture equals JAX's pass on the same records; the
  fired pattern names equal those of JAX's own capture but for
  ``fused_gelu`` (JAX only: the port's GeLU is one ``aten.gelu``); fusion
  lowers the modeled NonGEMM share; fused equals unfused numerically.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import nn as jnn  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.core import taxonomy as jtax  # noqa: E402
from repro.core.fusion import FUSED_PRIM as JFUSED_PRIM  # noqa: E402
from repro.core.fusion import find_fusable_chains as jfind  # noqa: E402
from repro.core.fusion import fuse_records as jfuse  # noqa: E402
from repro.core import FusionTransform as JFusionTransform  # noqa: E402
from repro.core.hardware import HardwareSpec as JHardwareSpec  # noqa: E402
from repro.core.hardware import GPU_A100 as JA100  # noqa: E402
from repro.core.workload import Workload as JWorkload  # noqa: E402
from repro.models import init_lm as jinit_lm  # noqa: E402
from repro.models import lm_forward as jlm_forward  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch import nn  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import (GPU_A100, H100, FUSION_PATTERNS,  # noqa: E402
                              FusionPattern, FusionTransform, OpGroup,
                              OpRecord, QuantizeDequantTransform, Workload,
                              capture, find_fusable_chains, fuse_records,
                              model_records, parse_scope, scope_tag)
from repro_torch.core.fusion import FUSED_PRIM, scope_prefix  # noqa: E402
from repro_torch.models import lm_forward  # noqa: E402

jprofiler = importlib.import_module("repro.core.profiler")

KERNEL_OF_JAX = {"attn_template:decode": "decode_core", "fused_rope": "rope"}
W64 = torch.ones(64)


# ---------------------------------------------------------------------------
# synthetic records, built alike in both packages
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Spec:
    group: str
    site: str
    scope: str
    ins: tuple = ()            # serials read
    outs: tuple = ()           # serials written
    shape: tuple = (4, 64)
    in_shape: tuple = None     # default: shape
    trip: int = 1
    dtype: str = "float32"


class _Stream:
    """Specs with a fresh ``c<N>`` marker per site run."""

    def __init__(self, prefix="L0"):
        self.prefix, self.specs, self._n = prefix, [], 0

    def run(self, group, site, *chain, prefix=None, untagged=False, **kw):
        """One site run: each ``(ins, outs)`` of ``chain`` one record."""
        self._n += 1
        prefix = self.prefix if prefix is None else prefix
        scope = prefix if untagged else \
            f"{prefix}/ng:{group}:{site}/c{self._n}".lstrip("/")
        for ins, outs in chain:
            self.specs.append(Spec(group, site, scope, tuple(ins),
                                   tuple(outs), **kw))
        return self

    def gemm(self, ins, outs):
        return self.run("gemm", "linear", (ins, outs))


def _numel(s):
    return int(np.prod(s)) if s else 1


def _fields(i, s: Spec, ids: bool):
    in_shape = s.in_shape or s.shape
    n_in = max(len(s.ins), 1)
    return dict(
        index=i, prim=f"prim_{s.site}", op_site=s.site, scope=s.scope,
        in_shapes=(in_shape,) * n_in, in_dtypes=(s.dtype,) * n_in,
        out_shapes=(s.shape,), out_dtypes=(s.dtype,),
        flops=float(3 * _numel(s.shape)) * s.trip,
        bytes_accessed=4.0 * (n_in * _numel(in_shape) + _numel(s.shape))
        * s.trip,
        trip_count=s.trip,
        in_var_ids=s.ins if ids else (), out_var_ids=s.outs if ids else ())


def build(specs, ids=True):
    """(port records, JAX records) of the same specs."""
    port = [OpRecord(group=OpGroup(s.group), **_fields(i, s, ids))
            for i, s in enumerate(specs)]
    jax_ = [jgraph.OpRecord(group=jtax.OpGroup(s.group), **_fields(i, s, ids))
            for i, s in enumerate(specs)]
    return port, jax_


def _norm_dtypes(ds):
    return tuple(str(d).removeprefix("torch.") for d in ds)


def view(r, jax_side: bool):
    params = dict(r.params)
    if jax_side and params.get("kernel") is not None:
        params["kernel"] = KERNEL_OF_JAX.get(params["kernel"], params["kernel"])
    prim = "<fused>" if r.prim in (FUSED_PRIM, JFUSED_PRIM) else r.prim
    return (r.index, prim, r.group.value, r.op_site, r.scope, r.in_shapes,
            _norm_dtypes(r.in_dtypes), r.out_shapes, _norm_dtypes(r.out_dtypes),
            r.flops, r.bytes_accessed, r.trip_count, params, r.in_var_ids,
            r.out_var_ids)


def _cases():
    c = {}
    c["dequant_add_rms_norm"] = _Stream().run(
        "quantization", "dequantize", ((1, 2), (3,))).run(
        "elementwise", "residual_add", ((3, 4), (5,))).run(
        "normalization", "rms_norm", ((5,), (6,)), ((6,), (7,)))
    c["add_rms_norm"] = _Stream().run(
        "elementwise", "residual_add", ((1, 2), (3,))).run(
        "normalization", "rms_norm", ((3,), (4,)), ((4,), (5,)))
    c["add_layer_norm"] = _Stream().run(
        "elementwise", "residual_add", ((1, 2), (3,))).run(
        "normalization", "layer_norm", ((3,), (4,)), ((4,), (5,)))
    c["rms_norm_rope"] = _Stream().run(
        "normalization", "rms_norm", ((1,), (2,))).run(
        "memory", "apply_rope", ((2,), (3,)), ((3,), (4,)))
    c["qdq"] = _Stream().run(
        "quantization", "quantize", ((1,), (2,)), ((2,), (3,))).run(
        "quantization", "dequantize", ((2, 3), (4,)))
    c["silu_mul"] = _Stream().run("activation", "silu", ((1,), (2,))).run(
        "elementwise", "mul", ((2, 3), (4,)), untagged=True)
    c["interpolate_add"] = _Stream().run(
        "interpolation", "interpolate_bilinear", ((1,), (2,))).run(
        "elementwise", "residual_add", ((2, 3), (4,)))
    c["softmax_sample"] = _Stream().run(
        "logit", "softmax", ((1,), (2,)), ((2,), (3,))).run(
        "reduction", "argmax", ((3,), (4,)), untagged=True)
    c["attn_decode"] = _Stream().run("gemm", "attn_qk", ((1, 2), (3,))).run(
        "elementwise", "attn_mask", ((3,), (4,))).run(
        "logit", "softmax", ((4,), (5,))).run("gemm", "attn_pv", ((5, 6), (7,)))
    for group, site in (("activation", "swiglu"), ("activation", "geglu"),
                        ("normalization", "rms_norm"),
                        ("normalization", "layer_norm"), ("logit", "softmax"),
                        ("logit", "online_softmax"), ("activation", "gelu"),
                        ("activation", "silu"), ("memory", "apply_rope"),
                        ("interpolation", "interpolate_bilinear"),
                        ("elementwise", "box_decode")):
        c[f"collapse_{site}"] = _Stream().run(group, site, ((1, 2), (3,)),
                                              ((3,), (4,)), ((4, 2), (5,)))
    # refusals
    c["scope_boundary"] = _Stream().run(
        "elementwise", "residual_add", ((1, 2), (3,)), prefix="stage0").run(
        "normalization", "rms_norm", ((3,), (4,)), ((4,), (5,)),
        prefix="stage1")
    c["no_dataflow"] = _Stream().run(
        "elementwise", "residual_add", ((1, 2), (3,))).run(
        "normalization", "rms_norm", ((8,), (9,)), ((9,), (10,)))
    c["trip_count"] = _Stream().run(
        "elementwise", "residual_add", ((1, 2), (3,)), trip=2).run(
        "normalization", "rms_norm", ((3,), (4,)), ((4,), (5,)))
    c["live_intermediate"] = _Stream().run(
        "elementwise", "residual_add", ((1, 2), (3,))).run(
        "normalization", "rms_norm", ((3,), (4,)), ((4,), (5,))).gemm(
        (5,), (6,)).run("elementwise", "residual_add", ((3, 6), (7,)))
    c["executed_fused"] = _Stream().run(
        "fused", "fused_add_rms_norm", ((1, 2), (3,)), ((3,), (4,)),
        ((4,), (5,))).run("fused", "fused_rope", ((5,), (6,)))
    c["single_record_site"] = _Stream().run(
        "elementwise", "residual_add", ((1, 2), (3,)))
    c["adjacent_invocations"] = _Stream().run(
        "memory", "apply_rope", ((1,), (2,)), ((2,), (3,))).run(
        "memory", "apply_rope", ((4,), (5,)), ((5,), (6,)))
    c["norm_k_rope_q"] = _Stream().run(
        "normalization", "rms_norm", ((1,), (2,)), ((2,), (3,))).run(
        "normalization", "rms_norm", ((4,), (5,)), ((5,), (6,))).run(
        "memory", "apply_rope", ((3,), (7,)), ((7,), (8,))).run(
        "memory", "apply_rope", ((6,), (9,)), ((9,), (10,)))
    return {k: v.specs for k, v in c.items()}


CASES = _cases()


def _whole_stream():
    """Every case one after another, serials offset, a GEMM between."""
    specs, off = [], 0
    for name, case in CASES.items():
        for s in case:
            specs.append(dataclasses.replace(
                s, ins=tuple(i + off for i in s.ins),
                outs=tuple(o + off for o in s.outs),
                scope=s.scope.replace("/c", f"/c{name}_")))
        specs.append(Spec("gemm", "linear", f"gap/ng:gemm:linear/c{off}",
                          (off + 99,), (off + 98,)))
        off += 1000
    return specs


def _shape_fallback_cases():
    connect = [Spec("elementwise", "residual_add",
                    "ng:elementwise:residual_add/c1"),
               Spec("normalization", "rms_norm", "ng:normalization:rms_norm/c2"),
               Spec("normalization", "rms_norm", "ng:normalization:rms_norm/c2")]
    apart = [dataclasses.replace(s, in_shape=(8, 32), shape=(8, 32))
             if s.site == "rms_norm" else s for s in connect]
    return {"shapes_connect": connect, "shapes_apart": apart}


PARITY = {**{k: (v, True) for k, v in CASES.items()},
          "whole_stream": (_whole_stream(), True),
          **{k: (v, False) for k, v in _shape_fallback_cases().items()}}


@pytest.mark.parametrize("case", list(PARITY))
def test_fuse_records_equals_jax_on_synthetic_records(case):
    specs, ids = PARITY[case]
    port, jax_ = build(specs, ids)
    got, rep = fuse_records(port)
    want, jrep = jfuse(jax_)
    assert [view(r, False) for r in got] == [view(r, True) for r in want]
    assert rep.to_dict() == jrep.to_dict()
    chains = [(p.name, p.sites and [(g.value, s) for g, s in p.sites],
               p.min_records, [r.index for r in rs])
              for p, rs in find_fusable_chains(port)]
    jchains = [(p.name, p.sites and [(g.value, s) for g, s in p.sites],
                p.min_records, [r.index for r in rs])
               for p, rs in jfind(jax_)]
    assert chains == jchains
    for hw, jhw in ((GPU_A100, JA100),
                    (H100, JHardwareSpec(**dataclasses.asdict(H100)))):
        for a, b in ((port, jax_), (got, want)):
            m = model_records(a, "c", hw)
            jm = jprofiler.model_records(b, "c", jhw)
            assert (m.group_seconds, m.op_seconds, m.n_ops, m.mode) == \
                (jm.group_seconds, jm.op_seconds, jm.n_ops, jm.mode)


def test_every_pattern_fires_on_its_synthetic_case():
    fired = set()
    for specs, ids in PARITY.values():
        fired |= set(fuse_records(build(specs, ids)[0])[1].fired)
    assert {p.name for p in FUSION_PATTERNS} <= fired


@pytest.mark.parametrize("case,want", [
    ("scope_boundary", {"fused_rms_norm": 1}),
    ("no_dataflow", {"fused_rms_norm": 1}),
    ("trip_count", {"fused_rms_norm": 1}), ("single_record_site", {}),
    ("adjacent_invocations", {"fused_rope": 2}),
    ("norm_k_rope_q", {"fused_rms_norm": 2, "fused_rope": 2}),
    ("executed_fused", {"fused_add_rms_norm": 1}),
    ("dequant_add_rms_norm", {"fused_dequant_add_rms_norm": 1}),
    ("attn_decode", {"fused_attn_decode": 1})])
def test_refusals_and_fires(case, want):
    assert fuse_records(build(CASES[case])[0])[1].fired == want


def test_live_intermediate_bytes():
    dead = build(CASES["add_rms_norm"])[0]
    live = build(CASES["live_intermediate"])[0]
    fd = next(r for r in fuse_records(dead)[0] if r.group is OpGroup.FUSED)
    fl = next(r for r in fuse_records(live)[0] if r.group is OpGroup.FUSED)
    assert fl.bytes_accessed == fd.bytes_accessed + 4 * 64 * 4


def test_fused_records_name_port_kernels():
    recs, _ = fuse_records(build(_whole_stream())[0])
    kernels = {}
    for r in recs:
        if r.prim == FUSED_PRIM:
            kernels.setdefault(r.op_site, set()).add(r.params["kernel"])
    assert kernels["fused_attn_decode"] == {"decode_core"}
    # a pattern's match names its kernel; an executed-fused collapse none
    assert kernels["fused_rope"] == {"rope"}
    assert kernels["fused_add_rms_norm"] == {"fused_add_rms_norm", None}
    assert kernels["fused_qdq"] == {None}


# ---------------------------------------------------------------------------
# the port's captures of small nn chains
# ---------------------------------------------------------------------------

def fired(fn, *args):
    return fuse_records(capture(fn, *args))[1]


def jfired(fn, *args):
    return jfuse(jgraph.capture(fn, *args))[1]


def _t(*shape, dtype=torch.float32):
    return torch.ones(shape, dtype=dtype)


JW64 = jnp.ones((64,), jnp.float32)

CHAINS = {
    "add_rms_norm": (lambda x, r: nn.rms_norm(nn.residual_add(x, r), W64),
                     lambda x, r: jnn.rms_norm(jnn.residual_add(x, r), JW64),
                     ((4, 64), (4, 64)), {"fused_add_rms_norm": 1}),
    "add_layer_norm": (
        lambda x, r: nn.layer_norm(nn.residual_add(x, r), W64, W64),
        lambda x, r: jnn.layer_norm(jnn.residual_add(x, r), JW64, JW64),
        ((4, 64), (4, 64)), {"fused_add_layer_norm": 1}),
    "qdq": (nn.fake_quant_int8, jnn.fake_quant_int8, ((4, 64),),
            {"fused_qdq": 1}),
    "swiglu": (nn.swiglu, jnn.swiglu, ((4, 64), (4, 64)),
               {"fused_swiglu": 1}),
    "no_dataflow": (
        lambda x, r, z: (nn.residual_add(x, r), nn.rms_norm(z, torch.ones(32))),
        lambda x, r, z: (jnn.residual_add(x, r), jnn.rms_norm(z, jnp.ones((32,)))),
        ((4, 64), (4, 64), (8, 32)), None),
    "single_record_site": (nn.residual_add, jnn.residual_add,
                           ((4, 64), (4, 64)), {}),
}


@pytest.mark.parametrize("name", list(CHAINS))
def test_capture_fires_what_jax_fires(name):
    fn, jfn, shapes, want = CHAINS[name]
    rep = fired(fn, *(_t(*s) for s in shapes))
    jrep = jfired(jfn, *(jnp.ones(s) for s in shapes))
    assert rep.fired == jrep.fired
    if want is not None:
        assert rep.fired == want
    else:
        assert "fused_add_rms_norm" not in rep.fired
    if rep.fired:
        assert rep.records_after < rep.records_before
        assert rep.bytes_after < rep.bytes_before


def test_dequant_add_rms_norm_chain_fuses():
    def f(q, s, r):
        return nn.rms_norm(nn.residual_add(nn.dequantize_int8(q, s), r), W64)

    def jf(q, s, r):
        return jnn.rms_norm(jnn.residual_add(jnn.dequantize_int8(q, s), r), JW64)

    rep = fired(f, _t(4, 64, dtype=torch.int8), torch.tensor(0.1), _t(4, 64))
    jrep = jfired(jf, jnp.ones((4, 64), jnp.int8), jnp.float32(0.1),
                  jnp.ones((4, 64)))
    assert rep.fired == jrep.fired == {"fused_dequant_add_rms_norm": 1}


def test_rope_collapses_and_adjacent_invocations_stay_separate():
    pos = torch.arange(8)[None, :]
    rep = fired(lambda q, k: (nn.apply_rope(q, pos), nn.apply_rope(k, pos)),
                _t(1, 8, 4, 64), _t(1, 8, 4, 64))
    assert rep.fired == {"fused_rope": 2}


def test_no_fusion_without_dataflow_same_shapes():
    # norm(q), norm(k), rope(q), rope(k): norm(k) -> rope(q) coincide in
    # shape but share no tensor; the serials refuse the chain
    pos = torch.arange(8)[None, :]

    def f(q, k):
        qn, kn = nn.rms_norm(q, W64), nn.rms_norm(k, W64)
        return nn.apply_rope(qn, pos), nn.apply_rope(kn, pos)

    rep = fired(f, _t(1, 8, 4, 64), _t(1, 8, 4, 64))
    assert "fused_rms_norm_rope" not in rep.fired
    assert rep.fired == {"fused_rope": 2, "fused_rms_norm": 2}


def test_serials_survive_freed_tensors():
    """A temporary freed inside the capture leaves its id() to the next
    tensor CPython makes (here most times); the weak serial table gives
    that tensor its own serial, so the freed one's consumer-less output
    never looks like the new tensor's producer."""
    def f(x):
        for _ in range(50):
            y = x * 2.0                     # freed before z is made
            del y
            z = torch.from_numpy(np.ones((4, 64), np.float32))
            x = x + z
        return x

    recs = capture(f, _t(4, 64))
    assert [r.prim for r in recs[:3]] == ["aten.mul", "aten.lift_fresh",
                                          "aten.add"]
    for mul, lift, add in zip(recs[0::3], recs[1::3], recs[2::3]):
        assert add.in_var_ids[1] == lift.out_var_ids[0]
        assert add.in_var_ids[1] != mul.out_var_ids[0]
    outs = [o for r in recs for o in r.out_var_ids]
    assert len(set(outs)) == len(outs)
    assert all(r.trip_count == 1 for r in recs)


def test_live_intermediate_still_written():
    def dead(x, r):
        return nn.rms_norm(nn.residual_add(x, r), W64)

    def alive(x, r):
        s = nn.residual_add(x, r)
        return nn.rms_norm(s, W64), nn.residual_add(s, s)

    args = (_t(4, 64), _t(4, 64))
    recs_d, rep_d = fuse_records(capture(dead, *args))
    recs_a, rep_a = fuse_records(capture(alive, *args))
    assert rep_d.fired.get("fused_add_rms_norm") == 1
    assert rep_a.fired.get("fused_add_rms_norm") == 1
    bd = next(r for r in recs_d if r.group == OpGroup.FUSED)
    ba = next(r for r in recs_a if r.group == OpGroup.FUSED)
    assert ba.bytes_accessed == bd.bytes_accessed + 4 * 64 * 4


def test_fused_record_shape():
    recs, _ = fuse_records(capture(
        lambda x, r: nn.rms_norm(nn.residual_add(x, r), W64),
        _t(4, 64), _t(4, 64)))
    (rec,) = [r for r in recs if r.group == OpGroup.FUSED]
    assert rec.prim == FUSED_PRIM and rec.op_site == "fused_add_rms_norm"
    assert rec.params["fused_sites"] == ["residual_add", "rms_norm"]
    assert rec.params["kernel"] == "fused_add_rms_norm"
    assert rec.out_shapes == ((4, 64),)


def test_executed_fused_site_collapses_to_one_launch():
    def f(x, r):
        with nn.fuse():
            return nn.add_rms_norm(x, r, W64)[0]

    recs = capture(f, _t(4, 64), _t(4, 64))
    assert {r.group for r in recs} == {OpGroup.FUSED} and len(recs) > 1
    fused, rep = fuse_records(recs)
    assert len(fused) == 1 and rep.fired.get("fused_add_rms_norm") == 1


def test_fused_group_is_nongemm_and_scope_prefix():
    from repro_torch.core import NONGEMM_GROUPS
    assert OpGroup.FUSED in NONGEMM_GROUPS
    assert parse_scope(scope_tag(OpGroup.FUSED, "fused_add_rms_norm")) == \
        (OpGroup.FUSED, "fused_add_rms_norm")
    assert scope_prefix("ng:elementwise:residual_add") == ""
    assert scope_prefix("layer0/ng:normalization:rms_norm") == "layer0"
    assert scope_prefix("layer0") == "layer0"
    assert scope_prefix("untagged/argmax") == "untagged/argmax"


def test_empty_pattern_rejected():
    with pytest.raises(ValueError):
        FusionPattern("empty", ())


# ---------------------------------------------------------------------------
# whole models on bridged weights
# ---------------------------------------------------------------------------

ARCHS = ("llama2-7b", "gpt2-xl")


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    arch = request.param
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jparams = jinit_lm(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                    cfg, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 8))

    def builder(w, device):
        return (lambda p, t: lm_forward(p, t, cfg)), \
            (torch.from_numpy(toks).to(device),), params

    def jbuilder(w):
        return (lambda p, t: jlm_forward(p, t, jcfg)), \
            (jnp.asarray(toks, jnp.int32),), jparams

    return arch, Workload(name=arch, arch=arch, seq=8, builder=builder), \
        JWorkload(name=arch, arch=arch, seq=8, builder=jbuilder)


def _to_jax(r):
    return jgraph.OpRecord(
        index=r.index, prim=r.prim, group=jtax.OpGroup(r.group.value),
        op_site=r.op_site, scope=r.scope, in_shapes=r.in_shapes,
        in_dtypes=_norm_dtypes(r.in_dtypes), out_shapes=r.out_shapes,
        out_dtypes=_norm_dtypes(r.out_dtypes), flops=r.flops,
        bytes_accessed=r.bytes_accessed, trip_count=r.trip_count,
        params=dict(r.params), in_var_ids=r.in_var_ids,
        out_var_ids=r.out_var_ids)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_pass_on_the_port_capture_equals_jax_pass(bridged, fused):
    _, w, _ = bridged
    if fused:
        w = w.with_transform(FusionTransform())
    fn, args = w.build("cpu")
    recs = capture(fn, *args)
    got, rep = fuse_records(recs)
    want, jrep = jfuse([_to_jax(r) for r in recs])
    assert [view(r, False) for r in got] == [view(r, True) for r in want]
    assert rep.to_dict() == jrep.to_dict()
    assert (find_fusable_chains(got), jfind(want)) == ([], [])


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_fired_pattern_names_equal_jax(bridged, fused):
    arch, w, jw = bridged
    if fused:
        w = w.with_transform(FusionTransform())
        jw = jw.with_transform(JFusionTransform())
    fn, args = w.build("cpu")
    got = set(fuse_records(capture(fn, *args))[1].fired)
    with jnn.backend("jnp"):
        jfn, jargs = jw.build()
        want = set(jfuse(jgraph.capture(jfn, *jargs))[1].fired)
    # the one divergence by design: JAX's tanh GeLU is a primitive train,
    # the port's one aten.gelu, already one launch
    assert got == want - {"fused_gelu"}
    assert ("fused_gelu" in want) == (arch == "gpt2-xl")


def test_modeled_fusion_direction(bridged):
    _, w, _ = bridged
    p = w.profile("eager-modeled:a100", device="cpu")
    pf = w.with_transform(FusionTransform()).profile("eager-modeled:a100",
                                                     device="cpu")
    assert pf.total_seconds < p.total_seconds
    assert pf.split["nongemm_frac"] < p.split["nongemm_frac"]
    assert pf.group_seconds.get("fused", 0.0) > 0.0
    assert pf.n_ops < p.n_ops


def test_fused_matches_unfused(bridged):
    _, w, _ = bridged
    fn, args = w.build("cpu")
    for ts in ((FusionTransform(),),
               (QuantizeDequantTransform("int8"), FusionTransform())):
        fw = w.with_transform(*ts)
        ffn, fargs = fw.build("cpu")
        if len(ts) == 2:
            assert fw.variant == "int8-qdq+fused"
            fn, args = w.with_transform(ts[0]).build("cpu")
        np.testing.assert_allclose(ffn(*fargs).numpy(), fn(*args).numpy(),
                                   atol=1e-4, rtol=1e-4)


def test_eager_cpu_backend_attributes_executed_fusion():
    def builder(w, device):
        x = torch.ones((2, 64), device=device)
        return (lambda p, x, r: nn.add_rms_norm(x, r, p)[0]), (x, x), W64

    w = Workload(name="d", arch="tiny", builder=builder)
    p = w.profile("eager-cpu", repeats=1)
    pf = w.with_transform(FusionTransform()).profile("eager-cpu", repeats=1)
    assert p.group_seconds.get("fused", 0.0) == 0.0
    assert pf.group_seconds.get("fused", 0.0) > 0.0
