"""Port kernels vs the JAX kernels: the CPU branch of each wrapper in
``repro_torch.kernels.ops`` against the Pallas kernel in interpret mode, on
the same numpy inputs, and each plain twin of ``repro_torch.kernels.ref``
against its ``repro.kernels.ref`` oracle. Tolerances are
``tests/test_kernels.py``'s ATOL (f32 2e-5, bf16 3e-2): both sides compute
in f32 and round once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import attn_template as T  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
DTYPES = ["float32", "bfloat16"]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(rng, shape, dt, scale=1.0):
    """The same values as a jax array and a torch CPU tensor of dtype dt."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return (jnp.asarray(a).astype(JAX_DT[dt]),
            torch.from_numpy(a).to(TORCH_DT[dt]))


def _close(got, want, dt):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=ATOL[dt])


# (2, 64, 32): narrow rows, 8 lanes a row on the card; (1, 5, 16, 128): a
# qk-norm, 16 lanes a row
@pytest.mark.parametrize("shape", [(4, 128), (2, 33, 257), (1, 7, 3, 64),
                                   (3, 4096), (2, 64, 32), (1, 5, 16, 128)])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("zero_centered", [False, True])
def test_rms_norm_matches_pallas(shape, dt, zero_centered):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, shape, dt)
    wj, wt = _pair(rng, (shape[-1],), dt)
    want = jops.rms_norm(xj, wj, zero_centered=zero_centered, interpret=True)
    got = ops.rms_norm(xt, wt, zero_centered=zero_centered)
    assert got.dtype == TORCH_DT[dt] and got.shape == xt.shape
    _close(got, want, dt)


@pytest.mark.parametrize("shape", [(4, 128), (2, 37, 257), (3, 1000)])
@pytest.mark.parametrize("dt", DTYPES)
def test_swiglu_matches_pallas(shape, dt):
    rng = np.random.default_rng(1)
    gj, gt = _pair(rng, shape, dt, scale=3.0)
    uj, ut = _pair(rng, shape, dt)
    want = jops.swiglu(gj, uj, interpret=True)
    got = ops.swiglu(gt, ut)
    assert got.dtype == TORCH_DT[dt]
    _close(got, want, dt)


@pytest.mark.parametrize("shape", [(4, 128), (2, 37, 257), (3, 1001), (1, 1)])
@pytest.mark.parametrize("dt", DTYPES)
def test_geglu_matches_pallas(shape, dt):
    rng = np.random.default_rng(9)
    gj, gt = _pair(rng, shape, dt, scale=3.0)
    uj, ut = _pair(rng, shape, dt)
    want = jops.geglu(gj, uj, interpret=True)
    got = ops.geglu(gt, ut)
    assert got.dtype == TORCH_DT[dt] and got.shape == gt.shape
    _close(got, want, dt)
    _close(ref.geglu(gt, ut), jref_geglu(gj, uj), dt)


def jref_geglu(gate, up):
    """The function of ``_geglu_kernel``, for the plain twin's check."""
    g = gate.astype(jnp.float32)
    return (jax.nn.gelu(g, approximate=True) * up.astype(jnp.float32)
            ).astype(gate.dtype)


# (B, Sq, Skv, Hq, Hkv, Dk, Dv, q_offset)
ATTN_CASES = [
    (2, 37, 37, 4, 4, 32, 32, 0),      # seq 37: ragged q and kv tiles
    (1, 37, 37, 8, 2, 32, 32, 0),      # GQA 8/2
    (2, 35, 35, 4, 4, 48, 16, 0),      # Dv != Dk
    (1, 13, 40, 4, 2, 32, 32, 27),     # q_offset: a chunk at the cache's end
    (1, 70, 70, 2, 2, 128, 128, 0),    # llama head width, two KV tiles
]


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dt", DTYPES)
def test_attention_core_matches_pallas(case, dt):
    b, sq, skv, hq, hkv, dk, dv, q_offset = case
    rng = np.random.default_rng(2)
    qj, qt = _pair(rng, (b, sq, hq, dk), dt)
    kj, kt = _pair(rng, (b, skv, hkv, dk), dt)
    vj, vt = _pair(rng, (b, skv, hkv, dv), dt)
    want = T.get("causal")(qj, kj, vj, q_offset=q_offset, block_q=32,
                           block_k=32, interpret=True)
    got = ops.attention_core(qt, kt, vt, q_offset=q_offset)
    assert got.shape == (b, sq, hq, dv) and got.dtype == TORCH_DT[dt]
    _close(got, want, dt)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("dt", DTYPES)
def test_decode_core_matches_pallas(hq, hkv, dt):
    rng = np.random.default_rng(3)
    b, t, d = 4, 40, 32
    qj, qt = _pair(rng, (b, 1, hq, d), dt)
    kj, kt = _pair(rng, (b, t, hkv, d), dt)
    vj, vt = _pair(rng, (b, t, hkv, d), dt)
    lengths = np.array([1, 17, 40, 0], np.int32)     # 0: a dead slot
    want = jops.attn_decode_template(qj, kj, vj, jnp.asarray(lengths),
                                     interpret=True)
    got = ops.decode_core(qt, kt, vt, torch.from_numpy(lengths))
    assert got.shape == (b, 1, hq, d) and got.dtype == TORCH_DT[dt]
    _close(got, want, dt)
    assert not got[3].float().abs().any(), "lengths 0 must give exact zeros"


# (B, Sq, Skv, Hq, Hkv, D, q_offset, window): windows shorter than a
# tile, of one tile, a key past it, longer than the sequence; GQA; an offset
WINDOW_CASES = [
    (2, 70, 70, 4, 4, 32, 0, 1),
    (1, 70, 70, 8, 2, 32, 0, 8),
    (1, 130, 130, 4, 2, 64, 0, 64),
    (2, 100, 100, 4, 4, 32, 0, 65),
    (1, 13, 40, 4, 2, 32, 27, 8),
    (1, 37, 37, 4, 4, 32, 0, 1000),
]


@pytest.mark.parametrize("case", WINDOW_CASES)
@pytest.mark.parametrize("dt", DTYPES)
def test_attention_window_matches_pallas(case, dt):
    b, sq, skv, hq, hkv, d, q_offset, window = case
    rng = np.random.default_rng(10)
    qj, qt = _pair(rng, (b, sq, hq, d), dt)
    kj, kt = _pair(rng, (b, skv, hkv, d), dt)
    vj, vt = _pair(rng, (b, skv, hkv, d), dt)
    want = jops.flash_attention(qj, kj, vj, window=window, q_offset=q_offset,
                                block_q=32, block_k=32, interpret=True)
    got = ops.attention_window(qt, kt, vt, window, q_offset=q_offset)
    assert got.shape == (b, sq, hq, d) and got.dtype == TORCH_DT[dt]
    _close(got, want, dt)
    # the plain version against the JAX oracle
    _close(ref.attention(qt, kt, vt, q_offset=q_offset, window=window),
           jref.attention(qj, kj, vj, window=window, q_offset=q_offset), dt)
    if window >= q_offset + sq:        # a window past every key is causal
        _close(got, T.get("causal")(qj, kj, vj, q_offset=q_offset,
                                    interpret=True), dt)


NORM_SHAPES = [(4, 128), (2, 33, 257), (1, 7, 3, 64), (2, 5, 1600), (2, 64, 32),
               (1, 5, 16, 128)]


def _norm_operands(rng, shape, dt, residual: bool, mean: float = 0.0):
    """x (with an offset mean, as a residual stream has), optional
    residual, scale and bias, as (jax, torch) pairs."""
    x = _pair(rng, shape, dt)
    if mean:
        a = (rng.standard_normal(shape) + mean).astype(np.float32)
        x = (jnp.asarray(a).astype(JAX_DT[dt]), torch.from_numpy(a).to(TORCH_DT[dt]))
    res = _pair(rng, shape, dt) if residual else (None, None)
    return x, res, _pair(rng, shape[-1:], dt), _pair(rng, shape[-1:], dt)


@pytest.mark.parametrize("shape", NORM_SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("mean", [0.0, 1e3])
def test_layer_norm_matches_pallas(shape, dt, mean):
    rng = np.random.default_rng(4)
    (xj, xt), _, (wj, wt), (bj, bt) = _norm_operands(rng, shape, dt, False, mean)
    want = jops.layer_norm(xj, wj, bj, interpret=True)
    got = ops.layer_norm(xt, wt, bt)
    assert got.dtype == TORCH_DT[dt] and got.shape == xt.shape
    # a row mean 1e3 standard deviations from zero: either side's f32 mean
    # carries ~2^-24 * 1e3 * log2(d) of summation-order error, which the
    # normalized row shows unscaled (2.5e-4 read here); a one-pass
    # E[x^2] - E[x]^2 variance would err by ~0.1
    atol = ATOL[dt] if not mean else max(ATOL[dt], 1e-3)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol)


@pytest.mark.parametrize("shape", NORM_SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_fused_add_norm_matches_pallas(shape, dt, kind):
    rng = np.random.default_rng(5)
    (xj, xt), (rj, rt), (wj, wt), (bj, bt) = _norm_operands(rng, shape, dt, True)
    if kind == "rms":
        want = jops.fused_add_rms_norm(xj, rj, wj, interpret=True)
        got = ops.fused_add_rms_norm(xt, rt, wt)
    else:
        want = jops.fused_add_layer_norm(xj, rj, wj, bj, interpret=True)
        got = ops.fused_add_layer_norm(xt, rt, wt, bt)
    for g, w in zip(got, want):
        assert g.dtype == TORCH_DT[dt] and g.shape == xt.shape
        _close(g, w, dt)
    # r: one f32 add, rounded once, on both sides
    np.testing.assert_array_equal(got[1].float().numpy(),
                                  np.asarray(want[1], np.float32))


ROPE_CASES = [  # (B, S, H, D, fraction, base, position offset)
    (2, 5, 4, 128, 1.0, 10000.0, 0),
    (1, 3, 25, 64, 1.0, 10000.0, 509),
    (2, 4, 3, 128, 0.25, 10000.0, 0),      # stablelm's partial rotary
    (1, 6, 2, 34, 1.0, 500.0, 4090),       # odd half: the scalar path
]


@pytest.mark.parametrize("case", ROPE_CASES)
@pytest.mark.parametrize("dt", DTYPES)
def test_rope_matches_pallas(case, dt):
    b, s, h, d, fraction, base, off = case
    rng = np.random.default_rng(6)
    xj, xt = _pair(rng, (b, s, h, d), dt)
    pos = (off + rng.integers(0, 8, (b, s))).astype(np.int32)
    want = jops.fused_rope(xj, jnp.asarray(pos), base=base, fraction=fraction,
                           interpret=True)
    got = ops.rope(xt, torch.from_numpy(pos), base=base, fraction=fraction)
    assert got.dtype == TORCH_DT[dt] and got.shape == xt.shape
    _close(got, want, dt)


@pytest.mark.parametrize("shape", [(4, 128), (2, 33, 257), (1, 7, 3, 64)])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("zero_centered", [False, True])
def test_dequant_add_rms_norm_matches_pallas(shape, dt, zero_centered):
    # the reference sweep (tests/test_kernels.py) at its tolerance, for y
    # and for r
    rng = np.random.default_rng(11)
    q = rng.integers(-127, 128, shape).astype(np.int8)
    rj, rt = _pair(rng, shape, dt, scale=4.0)
    wj, wt = _pair(rng, (shape[-1],), dt)
    want = jops.dequant_add_rms_norm(jnp.asarray(q), jnp.float32(0.031), rj, wj,
                                     zero_centered=zero_centered,
                                     interpret=True)
    got = ops.dequant_add_rms_norm(torch.from_numpy(q),
                                   torch.tensor(0.031, dtype=torch.float32),
                                   rt, wt, zero_centered=zero_centered)
    for g, w in zip(got, want):
        assert g.dtype == TORCH_DT[dt] and g.shape == rt.shape
        _close(g, w, dt)


@pytest.mark.parametrize("r,v,bv", [(7, 1000, 256), (32, 50304, 2048),
                                    (3, 130, 64)])
@pytest.mark.parametrize("dt", DTYPES)
def test_softmax_xent_matches_pallas(r, v, bv, dt):
    # the reference sweep (tests/test_kernels.py): rtol = atol = 1e-5 on the
    # f32 losses, from logits of either dtype
    rng = np.random.default_rng(12)
    lj, lt = _pair(rng, (r, v), dt, scale=5.0)
    labels = rng.integers(0, v, r).astype(np.int32)
    want = jops.softmax_xent(lj, jnp.asarray(labels), block_vocab=bv,
                             interpret=True)
    got = ops.softmax_xent(lt, torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.shape == (r,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


REF_TWINS = {
    "dequant_add_rms_norm": lambda m, x, r, w, b: m.dequant_add_rms_norm(
        (x * 40).round().clip(-127, 127).to(torch.int8) if m is ref else
        (x * 40).round().clip(-127, 127).astype(jnp.int8), 0.031, r, w),
    "softmax_xent": lambda m, x, r, w, b: m.softmax_xent(
        x.reshape(10, 32) * 5, (b[:10] % 32)),
    "layer_norm": lambda m, x, r, w, b: m.layer_norm(x, w, b),
    "fused_add_layer_norm": lambda m, x, r, w, b: m.fused_add_layer_norm(x, r, w, b),
    "fused_add_rms_norm": lambda m, x, r, w, b: m.fused_add_rms_norm(x, r, w),
    "rope": lambda m, x, r, w, b: m.rope(x.reshape(2, 5, 4, 8), b[:10].reshape(2, 5),
                                         base=300.0, fraction=0.5),
}


@pytest.mark.parametrize("name", sorted(REF_TWINS))
def test_ref_twin_matches_jax_oracle(name):
    rng = np.random.default_rng(7)
    x, r = (rng.standard_normal((2, 5, 32)).astype(np.float32) for _ in "xr")
    w, b = (rng.standard_normal(32).astype(np.float32) for _ in "wb")
    if name in ("rope", "softmax_xent"):
        b = rng.integers(0, 2048, 32).astype(np.int32)
    want = REF_TWINS[name](jref, *map(jnp.asarray, (x, r, w, b)))
    got = REF_TWINS[name](ref, *map(torch.from_numpy, (x, r, w, b)))
    for g, wv in zip(*(t if isinstance(t, tuple) else (t,) for t in (got, want))):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), atol=2e-5,
                                   rtol=1e-5)


# (B, Sq, Skv, Hq, Hkv, Dk, Dv, q_offset): full mask, Sq != Skv allowed;
# q_offset must have no effect
FULL_CASES = [
    (2, 37, 37, 4, 4, 32, 32, 0),      # ragged q and kv tiles
    (2, 20, 70, 4, 4, 32, 32, 0),      # cross-attention, Sq < Skv
    (1, 37, 61, 4, 2, 64, 32, 0),      # GQA 4/2, Dv != Dk, odd Sq / Skv
    (1, 13, 40, 4, 4, 32, 32, 27),     # a q_offset the mask ignores
]


@pytest.mark.parametrize("case", FULL_CASES)
@pytest.mark.parametrize("dt", DTYPES)
def test_attention_full_matches_pallas(case, dt):
    b, sq, skv, hq, hkv, dk, dv, q_offset = case
    rng = np.random.default_rng(8)
    qj, qt = _pair(rng, (b, sq, hq, dk), dt)
    kj, kt = _pair(rng, (b, skv, hkv, dk), dt)
    vj, vt = _pair(rng, (b, skv, hkv, dv), dt)
    want = T.attention_core(qj, kj, vj, causal=False, q_offset=q_offset,
                            block_q=32, block_k=32, interpret=True)
    got = ops.attention_full(qt, kt, vt)
    assert got.shape == (b, sq, hq, dv) and got.dtype == TORCH_DT[dt]
    _close(got, want, dt)
    # the plain version against the JAX oracle, the offset passed to both
    oracle = jref.attention(qj, kj, vj, causal=False, q_offset=q_offset)
    _close(ref.attention(qt, kt, vt, q_offset=q_offset, causal=False),
           oracle, dt)
    _close(got, T.get("full")(qj, kj, vj, interpret=True), dt)


def _random_boxes(rng, n, span=60.0):
    centers = rng.uniform(size=(n, 2)) * span
    wh = rng.uniform(size=(n, 2)) * 12 + 1
    return (np.concatenate([centers - wh / 2, centers + wh / 2], -1)
            .astype(np.float32), rng.uniform(size=n).astype(np.float32))


def threshold_pairs(rng, n_pairs: int = 512):
    """Pairs of equal boxes shifted by a third of their width, so that
    their IoU is 1/2 up to rounding: each pair's f32 IoU lands within a
    few ulps of the threshold, on either side. Pairs lie 100 px apart and
    never touch another pair."""
    x, y = rng.uniform(0, 40, (2, n_pairs))
    w, h = rng.uniform(5, 50, (2, n_pairs))
    ox = (np.arange(n_pairs) % 32) * 100.0
    oy = (np.arange(n_pairs) // 32) * 100.0
    a = np.stack([ox + x, oy + y, ox + x + w, oy + y + h], -1)
    b = a + np.stack([w / 3, 0 * w, w / 3, 0 * w], -1)
    boxes = np.stack([a, b], 1).reshape(-1, 4).astype(np.float32)
    scores = np.linspace(0.99, 0.5, 2 * n_pairs).astype(np.float32)
    return boxes, scores


def exact_threshold_pairs():
    """Two pairs: one whose f32 IoU is exactly 0.5 (kept: IoU must be
    *above* the threshold to suppress) and one whose f32 IoU is one ulp
    above 0.5 (suppressed)."""
    s = np.nextafter(np.float32(1 / 3), np.float32(0))
    boxes = np.array([[10, 0, 13, 1], [11, 0, 14, 1],
                      [0, 0, 1, 1], [s, 0, np.float32(s + 1), 1]], np.float32)
    return boxes, np.array([0.9, 0.8, 0.7, 0.6], np.float32)


def _nms_case(name):
    rng = np.random.default_rng(9)
    if name.startswith("random"):
        return (*_random_boxes(rng, int(name.split("-")[1])), 0.5, 0.0)
    if name == "zero_area":
        boxes, scores = _random_boxes(rng, 64)
        boxes[:2] = [[5, 5, 5, 5], [9, 9, 3, 3]]
        return boxes, scores, 0.5, 0.0
    if name == "duplicate_scores":
        return (_random_boxes(rng, 96)[0],
                np.array([0.5, 0.9, 0.1] * 32, np.float32), 0.5, 0.0)
    if name == "all_suppressed":
        boxes = (np.array([10, 10, 20, 20], np.float32)
                 + rng.uniform(size=(72, 4)).astype(np.float32) * 0.1)
        return boxes, np.linspace(0.9, 0.1, 72).astype(np.float32), 0.3, 0.0
    if name == "none_suppressed":
        off = np.arange(40, dtype=np.float32) * 30
        boxes = np.stack([off, off, off + 10, off + 10], -1)
        return boxes, rng.uniform(0.25, 0.75, 40).astype(np.float32), 0.5, 0.0
    if name == "threshold_above_one":
        return (*_random_boxes(rng, 64), 1.5, 0.0)
    if name == "score_threshold":
        return (*_random_boxes(rng, 200), 0.5, 0.4)
    if name == "near_threshold_pairs":
        return (*threshold_pairs(rng), 0.5, 0.0)
    return (*exact_threshold_pairs(), 0.5, 0.0)


NMS_CASES = ["random-1", "random-37", "random-130", "random-383",
             "random-1000", "zero_area", "duplicate_scores", "all_suppressed",
             "none_suppressed", "threshold_above_one", "score_threshold",
             "near_threshold_pairs", "exact_threshold_pairs"]


@pytest.mark.parametrize("name", NMS_CASES)
def test_nms_matches_pallas(name):
    boxes, scores, thr, score_thr = _nms_case(name)
    want = np.asarray(jops.nms(jnp.asarray(boxes), jnp.asarray(scores),
                               iou_threshold=thr, score_threshold=score_thr,
                               interpret=True))
    bt, st = torch.from_numpy(boxes), torch.from_numpy(scores)
    got = ops.nms(bt, st, iou_threshold=thr, score_threshold=score_thr)
    assert got.dtype == torch.bool and got.shape == (len(boxes),)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.nms(bt, st, iou_threshold=thr, score_threshold=score_thr).numpy(),
        np.asarray(jref.nms(jnp.asarray(boxes), jnp.asarray(scores),
                            iou_threshold=thr, score_threshold=score_thr)))
    if name == "exact_threshold_pairs":
        iou = ref.iou_matrix(bt)
        assert iou[0, 1] == 0.5
        assert iou[2, 3] == np.nextafter(np.float32(0.5), np.float32(1))
        assert got.tolist() == [True, True, True, False]
    if name == "near_threshold_pairs":      # both sides of the threshold
        assert 0 < int(got.sum()) - len(boxes) // 2 < len(boxes) // 2
    if name == "all_suppressed":
        assert int(got.sum()) == 1
    if name == "none_suppressed":
        assert bool(got.all())


@pytest.mark.parametrize("hw,out_hw", [((4, 4), (8, 8)), ((5, 7), (12, 9)),
                                       ((14, 14), (4, 6))])
def test_interpolate_bilinear_oracle_matches_jax(hw, out_hw):
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 3, *hw)).astype(np.float32)
    want = jref.interpolate_bilinear(jnp.asarray(x), out_hw)
    got = ref.interpolate_bilinear(torch.from_numpy(x), out_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_cpu_branch_launches_nothing():
    ops.reset_launches()
    x = torch.randn(3, 64)
    ops.rms_norm(x, torch.ones(64))
    ops.swiglu(x, x)
    ops.layer_norm(x, torch.ones(64), torch.zeros(64))
    ops.fused_add_rms_norm(x, x, torch.ones(64))
    ops.fused_add_layer_norm(x, x, torch.ones(64), torch.zeros(64))
    ops.rope(x.reshape(1, 3, 1, 64), torch.zeros(1, 3, dtype=torch.int32))
    q = x.reshape(1, 3, 1, 64)
    ops.attention_full(q, q, q)
    ops.attention_window(q, q, q, 2)
    ops.geglu(x, x)
    ops.nms(torch.rand(5, 4).cumsum(-1), torch.rand(5))
    ops.dequant_add_rms_norm(torch.zeros(3, 64, dtype=torch.int8),
                             torch.tensor(0.5), x, torch.ones(64))
    ops.softmax_xent(x, torch.zeros(3, dtype=torch.int32))
    assert set(ops.launches) == set(ops.KERNELS) and len(ops.KERNELS) == 14
    assert all(n == 0 for n in ops.launches.values())


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "shape", "device_mix",
                                 "residual_shape", "positions", "fraction",
                                 "nms_operands", "full_heads", "window",
                                 "glu_shapes", "dequant_operands",
                                 "xent_operands"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    x = torch.randn(4, 64)
    w = torch.ones(64)
    if bad == "dtype":
        with pytest.raises(TypeError):
            ops.rms_norm(x.half(), w.half())
    elif bad == "contiguity":
        with pytest.raises(ValueError):
            ops.swiglu(x.t(), x.t())
    elif bad == "shape":
        with pytest.raises(ValueError):
            ops.rms_norm(x, torch.ones(65))
    elif bad == "device_mix":
        with pytest.raises(ValueError):
            ops.decode_core(torch.randn(2, 1, 4, 8), torch.randn(2, 5, 4, 8),
                            torch.randn(2, 5, 4, 8),
                            torch.tensor([1, 2], dtype=torch.int64))
    elif bad == "residual_shape":
        with pytest.raises(ValueError):
            ops.fused_add_layer_norm(x, x[:2], w, w)
    elif bad == "positions":
        with pytest.raises(TypeError):
            ops.rope(x.reshape(1, 4, 1, 64), torch.zeros(1, 4, dtype=torch.int64))
        with pytest.raises(ValueError):
            ops.rope(x.reshape(1, 4, 1, 64), torch.zeros(1, 3, dtype=torch.int32))
    elif bad == "fraction":
        with pytest.raises(ValueError):
            ops.rope(x.reshape(1, 4, 1, 64), torch.zeros(1, 4, dtype=torch.int32),
                     fraction=1.5)
    elif bad == "nms_operands":
        with pytest.raises(TypeError):
            ops.nms_sorted(x.double(), torch.ones(4, dtype=torch.bool))
        with pytest.raises(ValueError):
            ops.nms_sorted(x[:, :4].contiguous(), torch.ones(3, dtype=torch.bool))
    elif bad == "window":
        q = x.reshape(1, 4, 4, 16)
        with pytest.raises(ValueError):
            ops.attention_window(q, q, q, 0)
        with pytest.raises(ValueError):
            ops.attention_window(q, q, q, 4, q_offset=-1)
    elif bad == "dequant_operands":
        q = torch.zeros(4, 64, dtype=torch.int8)
        qs = torch.tensor(0.1)
        with pytest.raises(TypeError, match="int8"):
            ops.dequant_add_rms_norm(x, qs, x, w)
        with pytest.raises(TypeError, match="0-d float32"):
            ops.dequant_add_rms_norm(q, qs.double(), x, w)
        with pytest.raises(TypeError, match="0-d float32"):
            ops.dequant_add_rms_norm(q, qs.reshape(1), x, w)
        with pytest.raises(ValueError, match="residual"):
            ops.dequant_add_rms_norm(q, qs, x[:2], w)
        with pytest.raises(TypeError, match="mixed dtypes"):
            ops.dequant_add_rms_norm(q, qs, x, w.bfloat16())
    elif bad == "xent_operands":
        with pytest.raises(TypeError, match="labels"):
            ops.softmax_xent(x, torch.zeros(4))
        with pytest.raises(ValueError, match=r"\(R, V\)"):
            ops.softmax_xent(x, torch.zeros(3, dtype=torch.int64))
        with pytest.raises(TypeError, match="dtype"):
            ops.softmax_xent(x.half(), torch.zeros(4, dtype=torch.int64))
    elif bad == "glu_shapes":
        with pytest.raises(ValueError):
            ops.geglu(x, x[:2])
        with pytest.raises(TypeError):
            ops.geglu(x, x.double())
    else:
        q = x.reshape(1, 4, 4, 16)
        with pytest.raises(ValueError):       # Hq 4 over Hkv 3
            ops.attention_full(q, q[:, :, :3].contiguous(),
                               q[:, :, :3].contiguous())
