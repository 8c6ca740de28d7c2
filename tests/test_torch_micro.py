"""The port's Table-2 micro-benchmark and §4.5 kernel-site table against
the JAX package's: the same operators, names, groups and shapes, every
entry run on the CPU at a reduced shape, and the kernel-site rows with
JAX's keys (minus the XLA columns, with ``pallas`` renamed ``kernel``)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.bench import sections as jsections  # noqa: E402
from repro.core import microbench as jmicro  # noqa: E402

from repro_torch.bench.sections import section_kernels  # noqa: E402
from repro_torch.core import microbench as micro  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

#: reduced shapes of the rows whose Table-2 shape is large on the CPU
REDUCED = {"nms": (64, 4), "interpolate": (1, 4, 8, 8),
           "cross_entropy": (8, 100), "rope": (1, 8, 2, 16),
           "fused_rope": (1, 8, 2, 16)}


def _reduced(name):
    shape = micro.TABLE2_SHAPES[name]
    if name.startswith("attn_template:"):
        b, _, h, d = shape
        return (b, 32, h, d)
    return REDUCED.get(name, tuple(min(n, 16) for n in shape))


def test_table2_shapes_pinned():
    assert micro.TABLE2_SHAPES == jmicro.TABLE2_SHAPES
    assert list(micro.TABLE2_SHAPES) == list(jmicro.TABLE2_SHAPES)


def test_registry_names_and_groups_pinned():
    got = [(op.name, op.group.value) for op in micro.registry().values()]
    want = [(op.name, op.group.value) for op in jmicro.registry().values()]
    assert got == want and len(got) == 29


@pytest.mark.parametrize("name", list(micro.TABLE2_SHAPES))
def test_every_entry_runs_on_the_cpu(name):
    r = micro.run_micro(name, shape=_reduced(name), repeats=2, device="cpu")
    assert (r.name, r.group) == (name, micro.registry()[name].group.value)
    assert r.device == "cpu" and r.dtype == "float32"
    assert r.device_us > 0 and r.eager_us > 0 and r.bytes_touched > 0
    assert math.isclose(r.bound_us, 1e6 * r.bytes_touched / 3.35e12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_dequant_row_equals_the_plain_version(dtype):
    gen = torch.Generator().manual_seed(3)
    dt = getattr(torch, dtype)
    fn, (q, res) = micro.registry()["fused_dequant_add_rms_norm"].make(
        (1, 10, 4096), dt, gen)
    assert q.dtype == torch.int8 and res.dtype == dt
    want, _ = ref.dequant_add_rms_norm(q, torch.tensor(0.02), res,
                                       torch.ones(4096, dtype=dt))
    assert torch.equal(fn(q, res), want)


def test_section_kernels_rows_match_jax_rows():
    rows = section_kernels("cpu")
    jrows = jsections.section_kernels(None)
    drop = {"xla_mb", "xla_over_pallas"}
    keys = [k.replace("pallas", "kernel") for k in jrows[0] if k not in drop]
    assert [list(r) for r in rows] == [keys] * len(jrows)
    assert [r["site"] for r in rows] == [r["site"] for r in jrows]
    for r, j in zip(rows, jrows):
        assert r["allclose"] and j["allclose"]
        # kernel-boundary IO: the same tensors at the same shapes and dtypes
        assert r["kernel_mb"] == pytest.approx(j["pallas_mb"], rel=1e-12)
        assert r["eager_mb"] > r["kernel_mb"]
        np.testing.assert_allclose(r["eager_over_kernel"],
                                   r["eager_mb"] / r["kernel_mb"])
