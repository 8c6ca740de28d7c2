"""The row-norm kernels' launch plan and arithmetic, held against the JAX
package on the CPU.

``csrc/norms.cu`` runs one of three bodies, picked on the host from the
shapes alone by ``repro_torch.kernels.norms.row_norm_plan``: A, a group
of G lanes of one warp per row, one 16-byte vector a lane, summed by an
xor-shuffle tree over the group; B, one CTA per row, K vectors a thread,
warp trees and then the warps' sums in order; C, the row in shared
memory. The plan's
properties are checked over a grid of shapes, and bodies A and B are
emulated in plain torch, step for step (per-lane f32 partial sums, the
shuffle tree, the two-pass variance), against the Pallas kernels of
``repro.kernels.norms`` in interpret mode and the port's plain versions,
on the same numpy inputs, within ``tests/test_torch_kernels.py``'s ATOL.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import norms as jnorms  # noqa: E402
from repro_torch.kernels import norms, ref  # noqa: E402

#: tests/test_kernels.py's ATOL, as tests/test_torch_kernels.py; a bf16
#: output may also round the other way by one ulp (RTOL, chip_smoke.py's
#: bf16 rtol): the 1e3-mean rows normalize to |y| ~ 5, where one ulp is 0.031
ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
RTOL = {"float32": 0.0, "bfloat16": 2 ** -7}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
SMS = 132                                   # an H100 SXM

ROWS = [1, 3, 21, 257, 4096, 65536]
WIDTHS = [4, 8, 16, 32, 64, 128, 200, 257, 384, 768, 1000, 1024, 1600, 2048,
          2056, 4096, 5376, 8192, 16384, 32768]


def _plans():
    for dt in (torch.float32, torch.bfloat16):
        for d in WIDTHS:
            for vec in (True, False):
                if vec and d % (16 // dt.itemsize):
                    continue
                for sms in (1, SMS):
                    yield dt, d, vec, sms


@pytest.mark.parametrize("dt,d,vec,sms", list(_plans()))
def test_row_norm_plan_properties(dt, d, vec, sms):
    v = 16 // dt.itemsize
    fits_warp = vec and d // v <= 32            # one vector a lane of a warp
    for rows in ROWS:
        p = norms.row_norm_plan(rows, d, dt, vec, sms)
        assert p.width == (v if vec else 1)
        assert p.lanes * p.vecs * p.width >= d             # G * K * V >= d
        assert (p.body == "warp") == fits_warp               # A where it fits
        if p.body == "warp":
            assert p.lanes in (4, 8, 16, 32) and p.threads == norms.THREADS
            assert p.vecs == 1
            assert p.rows_per_cta * p.lanes == p.threads
            assert 1 <= p.grid <= sms * norms.CTAS_PER_SM
        elif p.body == "cta":
            assert vec and p.lanes == p.threads and p.threads % 32 == 0
            assert p.threads <= norms.THREADS and p.grid == rows
        else:
            assert p.threads == norms.THREADS and p.grid == rows
        if p.body != "smem":
            assert p.vecs <= norms.MAX_VECS                  # K <= 8
            # no lane holds a vector slot that is past the row in every lane
            assert p.lanes * (p.vecs - 1) * p.width < d
        # every row is covered once, by the grid stride of body A or one
        # CTA a row in B and C
        seen = np.zeros(rows, np.int64)
        per, step = p.rows_per_cta, p.grid * p.rows_per_cta
        for cta in range(p.grid):
            for grp in range(per):
                seen[cta * per + grp:rows:step] += 1
        assert (seen == 1).all()


def test_row_norm_plan_reads_no_tensor():
    """The plan's arguments are shapes, a dtype, a flag and a count: it
    can read no tensor, and so cannot wait on the card. The wrapper's
    inputs to it come from shapes and pointers alone: a meta tensor, which
    holds no data, plans as a real one."""
    params = inspect.signature(norms.row_norm_plan).parameters
    assert list(params) == ["rows", "d", "dtype", "vec", "sms"]
    x = torch.empty((1, 2048, 32, 128), dtype=torch.bfloat16, device="meta")
    w = torch.empty((128,), dtype=torch.bfloat16, device="meta")
    assert norms._vec_ok(128, torch.bfloat16, 2, [x.data_ptr(), w.data_ptr(), None])
    assert norms.row_norm_plan(2048 * 32, 128, torch.bfloat16, True, SMS) == \
        norms.RowNormPlan("warp", 16, 1, 8, 256, 16, 1056)


@pytest.mark.parametrize("rows,d,dt,want", [
    (65536, 128, torch.bfloat16, ("warp", 16, 1)),    # gemma3-27b qk-norm
    (32768, 32, torch.float32, ("warp", 8, 1)),       # Table-2 Segformer
    (16, 256, torch.bfloat16, ("warp", 32, 1)),
    (4, 1600, torch.bfloat16, ("cta", 224, 1)),       # gpt2-xl, tail predicated
    (1024, 768, torch.bfloat16, ("cta", 96, 1)),      # bert-base, vit
    (1024, 384, torch.bfloat16, ("cta", 64, 1)),      # detector-vit-s
    (4, 4096, torch.bfloat16, ("cta", 256, 2)),       # llama2-7b
    (2048, 5376, torch.bfloat16, ("cta", 224, 3)),    # gemma3-27b
    (2, 16384, torch.bfloat16, ("cta", 256, 8)),
    (2, 16384, torch.float32, ("smem", 256, 16)),
])
def test_row_norm_plan_at_the_main_path_widths(rows, d, dt, want):
    p = norms.row_norm_plan(rows, d, dt, True, SMS)
    assert (p.body, p.lanes, p.vecs) == want


# -- emulation of bodies A and B ---------------------------------------------

def _xor_tree(s, width):
    """__shfl_xor_sync's tree over groups of ``width`` lanes (last dim):
    s += s[lane ^ o] for o = width / 2 .. 1, in f32; every lane of a group
    ends with the same total."""
    lanes = torch.arange(s.shape[-1])
    o = width // 2
    while o:
        s = s + s[..., lanes ^ o]
        o //= 2
    return s


def _row_sum(part, plan):
    """The row totals of per-lane partials (rows, lanes) as the body sums:
    A, the group's xor tree; B, each warp's tree, then the warps' sums
    added in order from 0 (cta_sum)."""
    if plan.body == "warp":
        return _xor_tree(part, plan.lanes)[:, 0]
    rows = part.shape[0]
    warps = _xor_tree(part.view(rows, -1, 32), 32)[..., 0]
    t = torch.zeros(rows)
    for i in range(warps.shape[1]):
        t = t + warps[:, i]
    return t


def emulate_row_norm(x, scale, bias=None, *, kind, eps, zero_centered=False,
                     residual=None):
    """Body A or B of ``csrc/norms.cu`` in plain torch on (rows, d) rows of
    ``x``'s dtype: each lane's K vectors (slot k holds the row's
    (k * stride + lane)-th, zeros past the row), an f32 partial sum a lane
    over its slots in order, the body's sum over the row's lanes, the mean
    (LayerNorm: the centred second pass over the held values), then
    y = v * rsqrt(.) * scale (+ bias) rounded once. With ``residual``, v is
    r = round(x + residual), and (y, r) is returned."""
    dt = x.dtype
    rows, d = x.shape
    plan = norms.row_norm_plan(rows, d, dt, True, SMS)
    assert plan.body in ("warp", "cta")
    v = x.float()
    r = None
    if residual is not None:
        r = (v + residual.float()).to(dt)
        v = r.float()
    lanes, k_n, width = plan.lanes, plan.vecs, plan.width
    held = torch.zeros(rows, k_n * lanes * width)
    held[:, :d] = v
    held = held.view(rows, k_n, lanes, width)          # slot (k, lane) = k*G + lane
    valid = (torch.arange(k_n)[:, None] * lanes + torch.arange(lanes)[None]
             < d // width)                              # (K, lanes)

    def partials(fn):
        acc = torch.zeros(rows, lanes)
        for k in range(k_n):
            for j in range(width):
                acc = acc + fn(held[:, k, :, j]) * valid[k]
        return acc

    if kind == "rms":
        m1 = _row_sum(partials(lambda t: t * t), plan) / d
        mean, inv = torch.zeros(rows), torch.rsqrt(m1 + eps)
    else:
        mean = _row_sum(partials(lambda t: t), plan) / d
        var = _row_sum(partials(lambda t: (t - mean[:, None]).square()), plan) / d
        inv = torch.rsqrt(var + eps)
    s = scale.float()
    if kind == "rms":
        y = v * inv[:, None] * ((1.0 + s) if zero_centered else s)
    else:
        y = (v - mean[:, None]) * inv[:, None] * s + bias.float()
    y = y.to(dt)
    return y if r is None else (y, r)


def _pair(rng, shape, dt, scale=1.0, mean=0.0):
    a = (rng.standard_normal(shape) * scale + mean).astype(np.float32)
    return jnp.asarray(a).astype(JAX_DT[dt]), torch.from_numpy(a).to(TORCH_DT[dt])


def _close(got, want, dt, atol=None):
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol or ATOL[dt], rtol=RTOL[dt])


#: (rows, d): body A at G 4, 8, 16 and 32 (bf16; f32 at twice the G),
#: body B at K 1 (with idle lanes at 384 and 1600), 2 and 3
EMULATED = [(3, 16), (2 * 64, 32), (5 * 16, 128), (6, 256), (5, 384), (6, 768),
            (10, 1600), (3, 4096), (2, 5376)]


@pytest.mark.parametrize("rows,d", EMULATED)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("zero_centered", [False, True])
def test_emulated_rms_norm_matches_pallas(rows, d, dt, zero_centered):
    rng = np.random.default_rng(d)
    xj, xt = _pair(rng, (rows, d), dt)
    wj, wt = _pair(rng, (d,), dt)
    got = emulate_row_norm(xt, wt, kind="rms", eps=1e-6, zero_centered=zero_centered)
    _close(got, jnorms.rms_norm(xj, wj, zero_centered=zero_centered, interpret=True), dt)
    _close(got, ref.rms_norm(xt, wt, zero_centered=zero_centered), dt)


@pytest.mark.parametrize("rows,d", EMULATED)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("mean", [0.0, 1e3])
def test_emulated_layer_norm_matches_pallas(rows, d, dt, mean):
    rng = np.random.default_rng(d + 1)
    xj, xt = _pair(rng, (rows, d), dt, mean=mean)
    (wj, wt), (bj, bt) = _pair(rng, (d,), dt), _pair(rng, (d,), dt)
    got = emulate_row_norm(xt, wt, bt, kind="layer", eps=1e-5)
    # the 1e3-mean row: each side's f32 mean carries summation-order error
    # that the normalized row shows unscaled (tests/test_torch_kernels.py)
    atol = ATOL[dt] if not mean else max(ATOL[dt], 1e-3)
    _close(got, jnorms.layer_norm(xj, wj, bj, interpret=True), dt, atol)
    _close(got, ref.layer_norm(xt, wt, bt), dt, atol)


@pytest.mark.parametrize("rows,d", EMULATED)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_emulated_fused_add_norm_matches_pallas(rows, d, dt, kind):
    rng = np.random.default_rng(d + 2)
    xj, xt = _pair(rng, (rows, d), dt)
    rj, rt = _pair(rng, (rows, d), dt, 4.0)
    (wj, wt), (bj, bt) = _pair(rng, (d,), dt), _pair(rng, (d,), dt)
    if kind == "rms":
        y, r = emulate_row_norm(xt, wt, kind="rms", eps=1e-6, residual=rt)
        want = jnorms.fused_add_rms_norm(xj, rj, wj, interpret=True)
    else:
        y, r = emulate_row_norm(xt, wt, bt, kind="layer", eps=1e-5, residual=rt)
        want = jnorms.fused_add_layer_norm(xj, rj, wj, bj, interpret=True)
    _close(y, want[0], dt)
    np.testing.assert_array_equal(r.float().numpy(), np.asarray(want[1], np.float32))


def test_emulated_one_pass_variance_fails_far_from_zero():
    """What the two-pass variance guards: E[v^2] - E[v]^2 over the same
    lanes and tree, on a row of mean 1e3 in f32, misses JAX by far more
    than the 1e-3 the 1e3-mean rows are held to (the ln_one_pass mutant)."""
    rng = np.random.default_rng(7)
    xj, xt = _pair(rng, (2, 1600), "float32", mean=1e3)
    (wj, wt), (bj, bt) = _pair(rng, (1600,), "float32"), _pair(rng, (1600,), "float32")
    plan = norms.row_norm_plan(2, 1600, torch.float32, True, SMS)
    v = xt.float()
    held = torch.zeros(2, plan.vecs * plan.lanes * plan.width)
    held[:, :1600] = v
    held = held.view(2, plan.vecs, plan.lanes, plan.width)
    acc, acc2 = torch.zeros(2, plan.lanes), torch.zeros(2, plan.lanes)
    for k in range(plan.vecs):
        for j in range(plan.width):
            acc, acc2 = acc + held[:, k, :, j], acc2 + held[:, k, :, j].square()
    mean = _row_sum(acc, plan) / 1600
    var = _row_sum(acc2, plan) / 1600 - mean * mean
    y = (v - mean[:, None]) * torch.rsqrt(var + 1e-5)[:, None] * wt + bt
    want = np.asarray(jnorms.layer_norm(xj, wj, bj, interpret=True))
    assert np.abs(y.numpy() - want).max() > 1e-2


def test_emulated_whole_warp_sum_mixes_rows():
    """What the group's own shuffle width guards: summing over the whole
    warp where G = 16 adds the neighbouring row's lanes (the
    group_reduce_whole_warp mutant), far outside the bf16 tolerance."""
    rng = np.random.default_rng(8)
    xj, xt = _pair(rng, (4, 128), "bfloat16")
    wj, wt = _pair(rng, (128,), "bfloat16")
    plan = norms.row_norm_plan(4, 128, torch.bfloat16, True, SMS)
    assert plan.lanes == 16
    good = emulate_row_norm(xt, wt, kind="rms", eps=1e-6)
    _close(good, jnorms.rms_norm(xj, wj, interpret=True), "bfloat16")
    # the row's partials, then a 32-lane tree over two rows' groups
    part = xt.float().view(4, 16, 8).square().sum(-1)       # (rows, G) lane sums
    mixed = _xor_tree(part.reshape(2, 32), 32)[:, 0].repeat_interleave(2)
    y = xt.float() * torch.rsqrt(mixed / 128 + 1e-6)[:, None] * wt.float()
    want = np.asarray(jnorms.rms_norm(xj, wj, interpret=True), np.float32)
    assert np.abs(y.to(torch.bfloat16).float().numpy() - want).max() > 3e-2
