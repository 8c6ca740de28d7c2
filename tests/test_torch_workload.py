"""The port's ``Workload`` / ``ProfilerBackend`` / ``Transform`` API on the
CPU: the cases of ``test_workload.py`` again on ``repro_torch.core``
(registry semantics, the workload spec and its transforms, every backend
but the card-only ones, ``ModelProfile`` edge cases), the device rule (a
backend asked for the card without CUDA raises), ``default_builder``'s
phases, and the whole models against JAX: the tagged ``(group, op_site)``
sets of ``Workload.build()``'s capture, and int8 QDQ raising the modeled
NonGEMM share.

Left out, with no twin in the port: the ``hlo_profile=`` ingestion (XLA
HLO), the deprecated ``profile_*`` shims,
and the bench CLI / schema / compare cases (the bench is not ported yet).
The modeled GEMM share of the two captures differs by design (the port
records aten view ops, JAX its ``broadcast_in_dim``s):
``test_modeled_gemm_share_gap_against_jax`` prints the gap, which ROADMAP
records, and gates only its direction-free sanity."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import nn as jnn  # noqa: E402
from repro.core import QuantizeDequantTransform as JQDQ  # noqa: E402
from repro.core import Workload as JWorkload  # noqa: E402
from repro.core.graph import capture as jcapture  # noqa: E402
from repro.core.taxonomy import parse_scope as jparse_scope  # noqa: E402

from repro_torch import nn  # noqa: E402
from repro_torch.core import (ModelProfile, OpGroup, ProfilerBackend,  # noqa: E402
                              QuantizeDequantTransform, Transform, Workload,
                              capture, get_backend, list_backends,
                              model_records, parse_scope, register_backend)
from repro_torch.core.hardware import GPU_A100, H100  # noqa: E402
from repro_torch.core.roofline import gemm_nongemm_split  # noqa: E402
from repro_torch.core.workload import CalibratedBackend  # noqa: E402


def tiny_model(params, x):
    h = nn.linear(x, params["w1"])
    h = nn.gelu(h)
    h = nn.rms_norm(h, torch.ones(h.shape[-1], dtype=h.dtype, device=h.device))
    return nn.linear(h, params["w2"])


def tiny_builder(w, device):
    g = torch.Generator(device).manual_seed(0)
    x = torch.randn((w.batch, w.seq, 32), generator=g, device=device)
    params = {"w1": torch.randn((32, 64), generator=g, device=device) * 0.1,
              "w2": torch.randn((64, 32), generator=g, device=device) * 0.1}
    return tiny_model, (x,), params


@pytest.fixture(scope="module")
def tiny():
    return Workload(name="tiny", arch="tiny", batch=2, seq=8,
                    builder=tiny_builder)


# ---------------------------------------------------------------------------
# Backend registry
# ---------------------------------------------------------------------------

def test_builtin_backends_listed():
    assert [b for b in list_backends() if not b.startswith("_test")] == \
        ["calibrated", "compiled", "eager-cpu", "eager-modeled", "measured",
         "wallclock"]


def test_unknown_backend_raises_keyerror_with_listing():
    with pytest.raises(KeyError) as ei:
        get_backend("does-not-exist")
    msg = str(ei.value)
    assert "does-not-exist" in msg and "eager-cpu" in msg
    with pytest.raises(KeyError, match="unknown profiler backend"):
        get_backend("does-not-exist:h100")
    # the port's compiled view measures, and prices on no spec
    with pytest.raises(ValueError, match="no ':<param>'"):
        get_backend("compiled:h100")


def test_duplicate_registration_rejected():
    with pytest.raises(ValueError, match="already registered"):
        register_backend("eager-cpu", lambda p: None)


def test_bad_backend_key_rejected():
    with pytest.raises(ValueError):
        register_backend("", lambda p: None)
    with pytest.raises(ValueError):
        register_backend("a:b", lambda p: None)


def test_parameterized_hw_lookup():
    assert get_backend("eager-modeled").hw.name == "a100"
    assert get_backend("eager-modeled:tpu_v5e").hw.name == "tpu_v5e"
    assert get_backend("eager-modeled:h100").hw is H100
    with pytest.raises(KeyError, match="unknown hardware"):
        get_backend("eager-modeled:b200")
    with pytest.raises(ValueError, match="no ':<param>'"):
        get_backend("eager-cpu:3")
    with pytest.raises(ValueError, match="no ':<param>'"):
        get_backend("measured:h100")


def test_custom_backend_roundtrip(tiny):
    class CountingBackend(ProfilerBackend):
        name = "counting"

        def profile(self, workload, device="cpu", **opts):
            fn, args = workload.build(device)
            return ModelProfile(name=workload.name, mode="counting",
                                group_seconds={}, total_seconds=0.0,
                                op_seconds={}, n_ops=len(capture(fn, *args)))

    if "_test-counting" not in list_backends():
        register_backend("_test-counting", lambda p: CountingBackend())
    p = tiny.profile("_test-counting")
    assert p.n_ops > 0 and p.mode == "counting"


# ---------------------------------------------------------------------------
# Workload spec + transforms
# ---------------------------------------------------------------------------

def test_workload_phase_validated():
    with pytest.raises(ValueError, match="phase"):
        Workload(name="x", arch="a", phase="serve")


def test_with_transform_is_composable_and_typed(tiny):
    t = QuantizeDequantTransform("int8")
    w2 = tiny.with_transform(t)
    assert w2.transforms == (t,) and tiny.transforms == ()
    assert w2.variant == "int8-qdq" and tiny.variant == "fp32"
    assert tiny.replace(dtype="bfloat16").variant == "bf16"
    with pytest.raises(TypeError):
        tiny.with_transform("not-a-transform")


def test_describe_is_serializable(tiny):
    d = tiny.with_transform(QuantizeDequantTransform()).describe()
    assert json.loads(json.dumps(d)) == d
    assert d["builder"] == "tiny_builder"
    assert d["transforms"] == ["int8-qdq"]
    assert Workload(name="n", arch="gpt2-xl").describe()["builder"] == "default"


def test_qdq_transform_raises_nongemm_share_tiny(tiny):
    fp32 = tiny.profile("eager-modeled:a100", device="cpu")
    int8 = tiny.with_transform(QuantizeDequantTransform("int8")).profile(
        "eager-modeled:a100", device="cpu")
    assert OpGroup.QUANT.value not in fp32.group_seconds
    assert int8.group_seconds.get(OpGroup.QUANT.value, 0.0) > 0.0
    assert int8.split["nongemm_frac"] >= fp32.split["nongemm_frac"]
    fn, args = tiny.build("cpu")
    qfn, qargs = tiny.with_transform(QuantizeDequantTransform()).build("cpu")
    np.testing.assert_allclose(qfn(*qargs).numpy(), fn(*args).numpy(),
                               atol=0.5, rtol=0.5)


def test_fake_quant_state_restored_on_error():
    class Boom(Transform):
        name = "boom"

        def wrap(self, fn, workload):
            def wrapped(*a, **k):
                raise RuntimeError("boom")
            return wrapped

    w = Workload(name="t", arch="tiny", builder=tiny_builder,
                 transforms=(Boom(), QuantizeDequantTransform()))
    with pytest.raises(RuntimeError, match="boom"):
        w.profile("eager-modeled:a100", device="cpu")
    assert nn.get_fake_quant() is None


def test_eager_cpu_backend_builds_on_the_cpu(tiny):
    p = tiny.profile("eager-cpu", repeats=1)
    assert p.mode == "eager_cpu" and p.n_ops > 0 and p.total_seconds > 0
    assert {r.device for r in (t.record for t in p.timed_ops)} == {"cpu"}


def test_measured_backend_profile_on_the_cpu(tiny):
    p = tiny.profile("measured", device="cpu", repeats=1)
    assert p.mode == "measured_cpu" and p.total_seconds > 0
    # per-op times, summed: no rescale to a wall total
    assert sum(t.seconds for t in p.timed_ops) == pytest.approx(p.total_seconds)
    assert sum(p.group_seconds.values()) == pytest.approx(p.total_seconds)
    assert p.split["gemm_frac"] + p.split["nongemm_frac"] <= 1.0 + 1e-9
    with pytest.raises(NotImplementedError, match="hlo_profile"):
        tiny.profile("measured", hlo_profile="x", device="cpu")


def test_wallclock_backend_profile(tiny):
    p = tiny.profile("wallclock", repeats=2, device="cpu")
    assert p.mode == "wallclock" and p.total_seconds > 0
    assert p.group_seconds == {} and p.n_ops == 0


def test_wallclock_runs_one_warmup_and_repeats():
    calls = []

    def builder(w, device):
        return (lambda p: calls.append(1)), (), None

    Workload(name="c", arch="c", builder=builder).profile(
        "wallclock", repeats=4, device="cpu")
    assert len(calls) == 5


@pytest.mark.parametrize("backend", ["measured", "wallclock",
                                     "eager-modeled:h100"])
def test_card_request_without_cuda_raises(tiny, backend):
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the card path is a card test")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tiny.profile(backend)           # device="cuda" by default
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tiny.build()


def test_calibrated_backend_with_injected_factors(tiny):
    from repro_torch.core import CalibratedHardwareSpec

    base = tiny.profile("eager-modeled:h100", device="cpu")
    cal = CalibratedHardwareSpec(base=H100, factors=(("gemm", 1.0),))
    p = CalibratedBackend(cal).profile(tiny, device="cpu")
    assert p.mode == "calibrated_h100"
    assert p.total_seconds == pytest.approx(base.total_seconds)
    assert p.group_seconds == pytest.approx(base.group_seconds)
    p2 = CalibratedBackend(CalibratedHardwareSpec(
        base=H100, factors=(("gemm", 2.0),))).profile(tiny, device="cpu")
    assert p2.group_seconds["gemm"] > base.group_seconds["gemm"]
    assert p2.group_seconds["normalization"] == \
        pytest.approx(base.group_seconds["normalization"])


# ---------------------------------------------------------------------------
# default_builder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,phase,shape", [
    ("llama2-7b", "prefill", (2, 8, 512)), ("gpt2-xl", "decode", (2, 512)),
    ("vit-b16-cls", "prefill", None)])
def test_default_builder_phases(arch, phase, shape):
    w = Workload(name=arch, arch=arch, phase=phase, batch=2, seq=8)
    fn, args = w.build("cpu")
    out = fn(*args)
    assert torch.isfinite(out).all()
    if shape is not None:
        assert tuple(out.shape) == shape
    else:
        assert out.shape[0] == 2
    p = w.profile("eager-modeled:h100", device="cpu")
    assert p.mode == "eager_h100" and p.split["gemm_s"] > 0


def test_default_builder_train_and_vision_decode_raise():
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        Workload(name="t", arch="llama2-7b", phase="train").build("cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        Workload(name="v", arch="vit-b16-cls", phase="decode").build("cpu")


# ---------------------------------------------------------------------------
# ModelProfile / split edge cases
# ---------------------------------------------------------------------------

def _profile(groups, name="p", mode="m"):
    return ModelProfile(name=name, mode=mode, group_seconds=dict(groups),
                        total_seconds=sum(groups.values()), op_seconds={},
                        n_ops=0)


def test_split_empty_profile():
    p = _profile({})
    assert p.split == {"gemm_s": 0.0, "nongemm_s": 0, "other_s": 0.0,
                       "gemm_frac": 0.0, "nongemm_frac": 0.0}
    assert p.top_nongemm_groups() == []


def test_split_all_gemm():
    p = _profile({OpGroup.GEMM.value: 2.0})
    assert p.split["gemm_frac"] == 1.0 and p.split["nongemm_frac"] == 0.0
    assert p.top_nongemm_groups(k=3) == []


def test_split_control_is_neither_gemm_nor_nongemm():
    s = gemm_nongemm_split({OpGroup.GEMM.value: 1.0,
                            OpGroup.MEMORY.value: 1.0,
                            OpGroup.CONTROL.value: 2.0})
    assert s["gemm_frac"] == pytest.approx(0.25)
    assert s["nongemm_frac"] == pytest.approx(0.25)
    assert s["other_s"] == pytest.approx(2.0)


def test_top_nongemm_groups_tie_break_is_stable():
    p = _profile({OpGroup.MEMORY.value: 1.0, OpGroup.ACTIVATION.value: 1.0,
                  OpGroup.GEMM.value: 2.0})
    tops = p.top_nongemm_groups(k=2)
    assert [g for g, _, _ in tops] == [OpGroup.MEMORY.value,
                                       OpGroup.ACTIVATION.value]
    assert all(pct == pytest.approx(25.0) for _, _, pct in tops)
    assert p.top_nongemm_groups(k=1) == [tops[0]]


def test_quant_group_is_nongemm():
    from repro_torch.core import NONGEMM_GROUPS
    assert OpGroup.QUANT in NONGEMM_GROUPS
    s = gemm_nongemm_split({OpGroup.GEMM.value: 1.0, OpGroup.QUANT.value: 1.0})
    assert s["nongemm_frac"] == pytest.approx(0.5)


def test_model_records_prices_each_record_plus_a_launch(tiny):
    recs = _port_capture(tiny)
    p = model_records(recs, "t", H100, launch_overhead_s=0.0)
    want = sum(H100.group_time(r.group.value, r.flops, r.bytes_accessed)
               for r in recs)
    assert p.total_seconds == pytest.approx(want) and p.n_ops == len(recs)
    q = model_records(recs, "t", H100)
    assert q.total_seconds == pytest.approx(want + 5e-6 * len(recs))


# ---------------------------------------------------------------------------
# whole models against JAX
# ---------------------------------------------------------------------------

ARCHS = ("llama2-7b", "gpt2-xl")


def _tagged_pairs(records, parse):
    return {(r.group.value, r.op_site) for r in records if parse(r.scope)}


def _port_capture(w):
    fn, args = w.build("cpu")
    return capture(fn, *args)


def _jax_capture(w):
    with jnn.backend("jnp"):
        fn, args = w.build()
        return jcapture(fn, *args)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("variant", ["plain", "fused", "int8-qdq",
                                     "int8-qdq+fused"])
def test_capture_site_sets_equal_jax(arch, variant):
    from repro.core import FusionTransform as JFusion

    from repro_torch.core import FusionTransform

    w = Workload(name=arch, arch=arch, seq=8)
    jw = JWorkload(name=arch, arch=arch, seq=8)
    if "qdq" in variant:
        w, jw = w.with_transform(QuantizeDequantTransform()), \
            jw.with_transform(JQDQ())
    if "fused" in variant:
        w, jw = w.with_transform(FusionTransform()), jw.with_transform(JFusion())
    got = _tagged_pairs(_port_capture(w), parse_scope)
    want = _tagged_pairs(_jax_capture(jw), jparse_scope)
    assert ("gemm", "linear") in want
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_qdq_transform_raises_nongemm_share(arch):
    w = Workload(name=arch, arch=arch, seq=8)
    fp = w.profile("eager-modeled:a100", device="cpu")
    q = w.with_transform(QuantizeDequantTransform()).profile(
        "eager-modeled:a100", device="cpu")
    assert OpGroup.QUANT.value not in fp.group_seconds
    assert q.group_seconds[OpGroup.QUANT.value] > 0.0
    assert q.split["nongemm_frac"] > fp.split["nongemm_frac"]


@pytest.mark.parametrize("arch", ARCHS)
def test_modeled_gemm_share_gap_against_jax(arch, capsys):
    """Prints the modeled GEMM share of each capture on ``a100`` (with
    and without the 5 µs launch overhead): the captures differ in
    granularity by design, so the gap is recorded, not gated."""
    from repro.core import GPU_A100 as JA100
    from repro.core import model_records as jmodel_records

    recs = _port_capture(Workload(name=arch, arch=arch, seq=8))
    jrecs = _jax_capture(JWorkload(name=arch, arch=arch, seq=8))
    row = {"arch": arch, "records": len(recs), "jax_records": len(jrecs)}
    for lo in (5e-6, 0.0):
        got = model_records(recs, arch, GPU_A100, launch_overhead_s=lo)
        want = jmodel_records(jrecs, arch, JA100, launch_overhead_s=lo)
        row[f"gemm_frac@{lo}"] = (round(got.split["gemm_frac"], 3),
                                  round(want.split["gemm_frac"], 3))
        assert 0.0 < got.split["gemm_frac"] < 1.0
        assert 0.0 < want.split["gemm_frac"] < 1.0
    with capsys.disabled():
        print("\nmodeled GEMM share, port vs JAX:", json.dumps(row))
    assert len(recs) > 0 and len(jrecs) > 0
