"""The port's hardware specs, calibration and platforms gate on the CPU:
the cases of ``test_hardware.py`` and ``test_calibrate.py`` again on
``repro_torch.core`` (registry errors, the per-OpGroup efficiency model,
factor fitting, ``CalibratedHardwareSpec``, versioned save / load, drift),
the ``h100`` spec against the data sheet, the pure calibrate functions
against JAX's on the same samples, and ``micro_row_samples`` over
Table-2 rows measured on the CPU. Calibration's measuring side needs the
card: asked for it without CUDA, it raises."""

import dataclasses
import importlib
import math

import pytest

torch = pytest.importorskip("torch")

# the module, not the function ``repro.core`` exports under its name
jcal = importlib.import_module("repro.core.calibrate")
from repro.core import hardware as jhw  # noqa: E402

from repro_torch.bench.schema import (PLATFORM_NPU, PLATFORM_SWEEP,  # noqa: E402
                                      check_platforms_invariant)
from repro_torch.core import (CPU_HOST, H100, CalibratedHardwareSpec,  # noqa: E402
                              CalibrationError, calibrate, drift_by_group,
                              fit_factors, get_backend, load_calibration,
                              max_abs_log2_drift, save_calibration)
from repro_torch.core import microbench as micro  # noqa: E402
from repro_torch.core.calibrate import (CALIBRATION_VERSION,  # noqa: E402
                                        DEFAULT_CALIBRATION_OPS,
                                        calibrate_from_microbench,
                                        micro_row_samples,
                                        microbench_samples)
from repro_torch.core.hardware import (ANY_GROUP, BY_NAME, MEMBOUND_DIMM,  # noqa: E402
                                       NPU_RYZEN, HardwareSpec, get_hardware,
                                       list_hardware)

JAX_SPECS = ("tpu_v5e", "a100", "cpu", "npu_ryzen", "membound_dimm")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def test_unknown_hardware_lists_known_platforms():
    with pytest.raises(KeyError) as ei:
        get_hardware("b200")
    msg = str(ei.value)
    assert "b200" in msg
    for name in JAX_SPECS + ("h100",):
        assert name in msg


def test_registry_has_the_five_platforms_and_h100():
    assert set(BY_NAME) == set(JAX_SPECS) | {"h100"}
    assert list_hardware() == sorted(BY_NAME)
    for name, spec in BY_NAME.items():
        assert spec.name == name
        assert spec.provenance  # every spec documents its constants


def test_h100_is_the_data_sheet():
    assert get_hardware("h100") is H100
    assert (H100.peak_flops_bf16, H100.peak_flops_f32, H100.hbm_bw,
            H100.link_bw, H100.hbm_bytes, H100.vmem_bytes) == \
        (989.4e12, 66.9e12, 3.35e12, 50e9, 80e9, 50 * 2 ** 20)
    # NVLink 4's 900 GB/s over its 18 links
    assert H100.link_bw == pytest.approx(900e9 / 18)
    assert H100.group_efficiency == ()
    assert "data sheet" in H100.provenance and "H100" in H100.provenance


def test_h100_backends_resolve():
    assert get_backend("eager-modeled:h100").hw is H100
    assert get_backend("eager-modeled").hw.name == "a100"


def test_platform_sweep_is_registered():
    assert set(PLATFORM_SWEEP) <= set(BY_NAME)
    assert PLATFORM_NPU in PLATFORM_SWEEP


# ---------------------------------------------------------------------------
# Per-OpGroup efficiency
# ---------------------------------------------------------------------------

TABLED = HardwareSpec(
    name="tabled", peak_flops_bf16=1e12, peak_flops_f32=1e12,
    hbm_bw=1e11, link_bw=1e9, hbm_bytes=1e9,
    group_efficiency=((ANY_GROUP, 0.5, 0.25), ("gemm", 1.0, 1.0)))


def test_exact_entry_beats_wildcard():
    assert TABLED.group_time("gemm", 1e9, 1e6) == pytest.approx(
        TABLED.roofline_time(1e9, 1e6))


def test_wildcard_applies_to_unnamed_groups():
    assert TABLED.group_time("activation", 1e9, 1e6) == pytest.approx(2e-3)
    assert TABLED.group_mem_time("activation", 1e6) == pytest.approx(4e-5)


@pytest.mark.parametrize("spec", [CPU_HOST, MEMBOUND_DIMM, H100],
                         ids=lambda s: s.name)
def test_no_table_means_identity(spec):
    for g in ("gemm", "activation", "normalization", "anything"):
        assert spec.group_time(g, 1e9, 1e6) == spec.roofline_time(1e9, 1e6)


def test_npu_point_shape():
    assert NPU_RYZEN.group_time("gemm", 1e12, 1e6) == pytest.approx(
        NPU_RYZEN.roofline_time(1e12, 1e6))
    nbytes = 1e9
    assert NPU_RYZEN.group_mem_time("activation", nbytes) == pytest.approx(
        50.0 * NPU_RYZEN.mem_time(nbytes))


@pytest.mark.parametrize("name", JAX_SPECS + ("h100",))
@pytest.mark.parametrize("group", ["gemm", "activation", "collective", "fused"])
def test_spec_times_equal_jax_arithmetic(name, group):
    """The methods are copies: on JAX's five specs the same numbers as
    JAX's; ``h100`` priced by JAX's class on the same fields."""
    spec = get_hardware(name)
    want = jhw.BY_NAME[name] if name in jhw.BY_NAME else \
        jhw.HardwareSpec(**dataclasses.asdict(spec))
    for flops, nbytes in ((1e9, 1e6), (1e6, 1e9), (0.0, 3.35e9)):
        for dt in ("bf16", "f32"):
            assert spec.group_time(group, flops, nbytes, dt) == \
                want.group_time(group, flops, nbytes, dt)
        assert spec.group_mem_time(group, nbytes) == \
            want.group_mem_time(group, nbytes)


# ---------------------------------------------------------------------------
# check_platforms_invariant on synthetic rows (the renderers' gate)
# ---------------------------------------------------------------------------

def _modeled(case, platform, gemm_s, share):
    return {"case": case, "platform": platform, "kind": "modeled",
            "gemm_s": gemm_s, "nongemm_frac": share}


def _valid_rows(case="m"):
    rows = [_modeled(case, "cpu", 4.0e-2, 0.10),
            _modeled(case, "membound_dimm", 1.2e-2, 0.20),
            _modeled(case, "tpu_v5e", 6.0e-3, 0.30),
            _modeled(case, "a100", 2.4e-3, 0.35),
            _modeled(case, "npu_ryzen", 1.2e-3, 0.60)]
    rows.append({"case": case, "platform": "cpu", "kind": "measured",
                 "drift": {"gemm": 1.5, "activation": 0.8}})
    rows.append({"case": case, "platform": "cpu", "kind": "calibrated",
                 "drift": {"gemm": 1.0}})
    return rows


def test_valid_sweep_passes():
    assert check_platforms_invariant(_valid_rows()) == []


def test_missing_platform_flagged():
    rows = [r for r in _valid_rows()
            if r.get("platform") != "membound_dimm" or r["kind"] != "modeled"]
    assert any("missing platforms" in msg
               for _, msg in check_platforms_invariant(rows))


def test_npu_must_be_highest():
    rows = _valid_rows()
    for r in rows:
        if r.get("platform") == "npu_ryzen" and r["kind"] == "modeled":
            r["nongemm_frac"] = 0.05
    assert any("highest NonGEMM share" in msg
               for _, msg in check_platforms_invariant(rows))


def test_concordance_violation_flagged():
    rows = _valid_rows()
    for r in rows:
        if r.get("platform") == "a100" and r["kind"] == "modeled":
            r["nongemm_frac"] = 0.25
    assert any("share must grow as GEMM gets cheaper" in msg
               for _, msg in check_platforms_invariant(rows))


def test_near_tie_gemm_times_carry_no_ordering_signal():
    rows = _valid_rows()
    for r in rows:
        if r.get("platform") == "a100" and r["kind"] == "modeled":
            r["gemm_s"] = 5.7e-3
            r["nongemm_frac"] = 0.25
    assert check_platforms_invariant(rows) == []


def test_host_rows_require_drift_map():
    rows = _valid_rows()
    for r in rows:
        if r["kind"] == "measured":
            r["drift"] = {}
    assert any("drift" in msg for _, msg in check_platforms_invariant(rows))
    rows = [r for r in _valid_rows() if r["kind"] != "calibrated"]
    assert any("no calibrated host row" in msg
               for _, msg in check_platforms_invariant(rows))


def test_empty_rows_no_violations():
    assert check_platforms_invariant([]) == []


# ---------------------------------------------------------------------------
# fit_factors / calibrate (test_calibrate.py's cases)
# ---------------------------------------------------------------------------

def test_fit_factors_ratio_of_sums():
    samples = [("activation", 2.0, 1.0), ("activation", 6.0, 2.0),
               ("normalization", 1.0, 4.0)]
    f = fit_factors(samples)
    assert f["activation"] == pytest.approx(8.0 / 3.0)
    assert f["normalization"] == pytest.approx(0.25)


def test_fit_factors_skips_zero_modeled_groups():
    assert fit_factors([("weird", 1.0, 0.0)]) == {}
    assert "weird" not in fit_factors([("weird", 1.0, 0.0),
                                       ("activation", 1.0, 1.0)])


@pytest.mark.parametrize("hw", [CPU_HOST, H100], ids=lambda h: h.name)
def test_roundtrip_against_spec_synthesized_profile(hw):
    samples = []
    for g, flops, nbytes in [("activation", 1e9, 4e8),
                             ("normalization", 2e8, 6e8),
                             ("elementwise", 0.0, 1e9),
                             ("gemm", 5e10, 2e8)]:
        t = hw.group_time(g, flops, nbytes)
        samples.append((g, t, t))
    cal = calibrate(hw, samples, source="synthetic")
    assert len(cal.factors) == 4
    for _, factor in cal.factors:
        assert factor == pytest.approx(1.0)
    assert cal.group_time("activation", 1e9, 4e8) == pytest.approx(
        hw.group_time("activation", 1e9, 4e8))


def test_known_factor_recovered():
    t = H100.group_time("activation", 1e9, 4e8)
    cal = calibrate(H100, [("activation", 3.0 * t, t)])
    assert cal.factor("activation") == pytest.approx(3.0)


def test_calibrate_rejects_unusable_samples():
    with pytest.raises(CalibrationError):
        calibrate(CPU_HOST, [("activation", 1.0, 0.0)])
    with pytest.raises(CalibrationError):
        calibrate(CPU_HOST, [])


def test_calibrated_spec_applies_factor():
    cal = CalibratedHardwareSpec(base=H100, factors=(("activation", 2.0),))
    flops, nbytes = 1e12, 1e12
    assert cal.group_time("activation", flops, nbytes) == pytest.approx(
        2.0 * H100.group_time("activation", flops, nbytes))
    assert cal.group_mem_time("activation", nbytes) == pytest.approx(
        2.0 * H100.group_mem_time("activation", nbytes))


def test_unfitted_group_falls_back_to_identity():
    cal = CalibratedHardwareSpec(base=CPU_HOST, factors=(("activation", 2.0),))
    assert cal.factor("reduction") == 1.0
    assert cal.group_time("reduction", 1e12, 1e12) == pytest.approx(
        CPU_HOST.group_time("reduction", 1e12, 1e12))


def test_calibrated_spec_name_suffix():
    assert CalibratedHardwareSpec(base=H100, factors=()).name == "h100+cal"


def test_save_load_roundtrip(tmp_path):
    cal = calibrate(H100, [("activation", 2.0, 1.0),
                           ("normalization", 0.5, 1.0)], source="test")
    path = str(tmp_path / "h100.cal.json")
    save_calibration(cal, path)
    loaded = load_calibration(path)
    assert loaded.base is H100
    assert loaded.factors == cal.factors
    assert loaded.source == "test"
    assert loaded.version == CALIBRATION_VERSION


def test_version_mismatch_raises():
    with pytest.raises(CalibrationError, match="version"):
        CalibratedHardwareSpec.from_dict(
            {"version": CALIBRATION_VERSION + 1, "base": "h100",
             "factors": {}})
    with pytest.raises(CalibrationError, match="version"):
        CalibratedHardwareSpec.from_dict({"base": "h100", "factors": {}})


def test_drift_by_group_ratios():
    drift = drift_by_group({"gemm": 2.0, "activation": 1.0},
                           {"gemm": 1.0, "activation": 4.0, "ctrl": 0.0})
    assert drift == {"gemm": 2.0, "activation": 0.25}


def test_drift_missing_measured_group_is_zero_ratio():
    drift = drift_by_group({}, {"gemm": 1.0})
    assert drift == {"gemm": 0.0}
    assert max_abs_log2_drift(drift) == 0.0


def test_max_abs_log2_drift_symmetric():
    assert max_abs_log2_drift({"a": 4.0}) == pytest.approx(2.0)
    assert max_abs_log2_drift({"a": 0.25}) == pytest.approx(2.0)
    assert max_abs_log2_drift({"a": 1.0}) == 0.0
    assert max_abs_log2_drift({}) == 0.0


def test_perfect_model_has_zero_drift():
    groups = {"gemm": 1e-3, "activation": 2e-4}
    assert max_abs_log2_drift(drift_by_group(groups, dict(groups))) == 0.0
    assert not math.isnan(max_abs_log2_drift(drift_by_group(groups, groups)))


SAMPLES = [("activation", 2.0e-6, 1.0e-6), ("activation", 6.0e-6, 2.5e-6),
           ("normalization", 1.0e-6, 4.0e-6), ("weird", 1.0, 0.0),
           ("memory", 3.3e-6, 3.3e-6)]


def test_pure_functions_equal_jax():
    assert fit_factors(SAMPLES) == jcal.fit_factors(SAMPLES)
    got = calibrate(CPU_HOST, SAMPLES, source="s")
    want = jcal.calibrate(jhw.CPU_HOST, SAMPLES, source="s")
    assert got.to_dict() == want.to_dict()
    for g in ("activation", "normalization", "gemm"):
        assert got.group_time(g, 1e9, 3e8) == want.group_time(g, 1e9, 3e8)
    m = {"gemm": 2.0, "activation": 1.0, "fused": 0.5}
    d = {"gemm": 1.0, "activation": 4.0, "ctrl": 0.0, "fused": 3.0}
    assert drift_by_group(m, d) == jcal.drift_by_group(m, d)
    assert max_abs_log2_drift(drift_by_group(m, d)) == \
        jcal.max_abs_log2_drift(jcal.drift_by_group(m, d))
    assert DEFAULT_CALIBRATION_OPS == jcal.DEFAULT_CALIBRATION_OPS
    assert CALIBRATION_VERSION == jcal.CALIBRATION_VERSION


# ---------------------------------------------------------------------------
# the fitting source: Table-2 rows
# ---------------------------------------------------------------------------

def _cpu_rows():
    shape = (2, 64, 128)
    return [micro.run_micro(n, shape=shape, repeats=2, device="cpu",
                            measure_eager=False)
            for n in DEFAULT_CALIBRATION_OPS + ("relu",)]


def test_micro_row_samples_pair_device_time_with_the_byte_model():
    rows = _cpu_rows()
    samples = micro_row_samples(rows, H100)
    assert len(samples) == len(DEFAULT_CALIBRATION_OPS)       # relu left out
    for r, (g, measured, modeled) in zip(rows, samples):
        assert g == r.group
        assert measured == 1e-6 * r.device_us
        assert modeled == H100.group_mem_time(r.group, r.bytes_touched)
        # the model of a row is the row's own byte bound
        assert modeled == pytest.approx(1e-6 * r.bound_us)
    cal = calibrate_from_microbench(H100, rows=rows)
    assert cal.base is H100 and "microbench:add" in cal.source
    assert {g for g, _ in cal.factors} == {r.group for r in rows
                                           if r.name != "relu"}
    assert len(micro_row_samples(rows, H100, names=("relu",))) == 1


def test_calibration_measures_on_the_card_or_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the measuring side is a card test")
    with pytest.raises(RuntimeError, match="CUDA"):
        microbench_samples(H100, names=("add",), repeats=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_backend("calibrated:h100")
