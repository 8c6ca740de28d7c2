"""Kernel-on-card tests: each hand-written kernel against its plain PyTorch
version on an NVIDIA GPU, and the reduced model's kernel path against its
plain path. Marked ``cuda``; each test skips where torch sees no card.

On the card (where jax, which tests/conftest.py imports, may be absent):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import nn  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import attn_template as attn  # noqa: E402
from repro_torch.kernels import _build, norms, ops, ref, rope  # noqa: E402
from repro_torch.kernels import softmax_xent as xent  # noqa: E402
from repro_torch.kernels import swiglu as glu  # noqa: E402
from repro_torch.models import init_lm, lm_forward  # noqa: E402
from repro_torch.models.vision import init_vision, vision_forward  # noqa: E402
from repro_torch.serving import Engine, PagedEngine  # noqa: E402

pytestmark = pytest.mark.cuda

# |kernel - plain| <= atol + rtol * |plain|: f32 math on both sides, the
# bf16 output may round the other way by one ulp
TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (3e-2, 2 ** -7)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False      # f32 convolutions in f32
    return torch.Generator("cuda").manual_seed(0)


def _randn(gen, shape, dt, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dt)


def _assert_close(got, want, dt):
    torch.cuda.synchronize()
    atol, rtol = TOL[dt]
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def _launched(name, fn):
    before = ops.launches[name]
    out = fn()
    assert ops.launches[name] == before + 1
    return out


@pytest.mark.parametrize("shape", [(4, 1, 4096), (2, 33, 257), (5, 1000)])
@pytest.mark.parametrize("dt", DTYPES)
def test_rms_norm_on_card(card, shape, dt):
    x, w = _randn(card, shape, dt), _randn(card, shape[-1:], dt)
    got = _launched("rms_norm", lambda: ops.rms_norm(x, w))
    _assert_close(got, ref.rms_norm(x, w), dt)


#: the decode step, a served prefill, tails of 3 and 1 (the last partial
#: vector of csrc/swiglu.cu's 8-byte accesses)
@pytest.mark.parametrize("shape", [(4, 1, 11008), (1, 256, 11008), (2, 37, 257),
                                   (1, 13), (44035,)])
@pytest.mark.parametrize("dt", DTYPES)
def test_swiglu_on_card(card, shape, dt):
    g, u = _randn(card, shape, dt, 3.0), _randn(card, shape, dt)
    got = _launched("swiglu", lambda: ops.swiglu(g, u))
    _assert_close(got, ref.swiglu(g, u), dt)


@pytest.mark.parametrize("case", [(2, 37, 37, 4, 4, 64, 64, 0),
                                  (1, 100, 100, 8, 2, 128, 128, 0),
                                  (2, 35, 35, 4, 4, 48, 16, 0),
                                  (1, 13, 40, 4, 2, 32, 32, 27),
                                  (1, 21, 21, 2, 2, 34, 18, 0),   # scalar staging
                                  (1, 50, 50, 4, 4, 80, 80, 0),   # 80 and 96: multiples
                                  (1, 70, 70, 4, 2, 96, 96, 0),   # of 16, no power of 2
                                  (2, 1, 70, 4, 2, 128, 128, 69),  # Sq = 1
                                  (1, 100, 300, 8, 4, 128, 128, 200)])  # Sq < Skv
@pytest.mark.parametrize("dt", DTYPES)
def test_attention_core_on_card(card, case, dt):
    b, sq, skv, hq, hkv, dk, dv, off = case
    q = _randn(card, (b, sq, hq, dk), dt)
    k, v = _randn(card, (b, skv, hkv, dk), dt), _randn(card, (b, skv, hkv, dv), dt)
    got = _launched("attention_core",
                    lambda: ops.attention_core(q, k, v, q_offset=off))
    _assert_close(got, ref.attention(q, k, v, q_offset=off), dt)


# (B, Sq, Skv, Hq, Hkv, D, q_offset): a chunk of a chunked prefill over a
# deeper cache (stablelm-3b's 32 heads of 80 at 64 tokens and an odd 37,
# GQA at 128, a chunk inside one key tile)
@pytest.mark.parametrize("case", [(1, 64, 512, 32, 32, 80, 160),
                                  (1, 37, 512, 32, 32, 80, 160),
                                  (1, 44, 300, 8, 2, 128, 256),
                                  (2, 5, 140, 4, 4, 64, 70)])
@pytest.mark.parametrize("dt", DTYPES)
def test_attention_core_reads_no_key_past_the_chunk_on_card(card, case, dt):
    """Keys and values past the chunk's last query are NaN: the output stays
    finite and equals the plain version over the keys up to it."""
    b, sq, skv, hq, hkv, d, off = case
    q = _randn(card, (b, sq, hq, d), dt)
    k, v = _randn(card, (b, skv, hkv, d), dt), _randn(card, (b, skv, hkv, d), dt)
    end = off + sq
    want = ref.attention(q, k[:, :end], v[:, :end], q_offset=off)
    k[:, end:], v[:, end:] = float("nan"), float("nan")
    got = _launched("attention_core",
                    lambda: ops.attention_core(q, k, v, q_offset=off))
    assert torch.isfinite(got.float()).all()
    _assert_close(got, want, dt)


# (B, Sq, Skv, Hq, Hkv, D, q_offset, window): windows shorter than a tile,
# one tile, one key past it, gemma3's 1024 at 2048 tokens (32 heads over
# 16), a window longer than the sequence, Skv not a multiple of 64, an offset
@pytest.mark.parametrize("case", [(2, 100, 100, 4, 4, 64, 0, 1),
                                  (1, 130, 130, 8, 4, 128, 0, 63),
                                  (1, 130, 130, 4, 4, 128, 0, 64),
                                  (2, 197, 197, 4, 2, 64, 0, 65),
                                  (1, 2048, 2048, 32, 16, 128, 0, 1024),
                                  (1, 37, 37, 4, 4, 64, 0, 1000),
                                  (1, 13, 140, 4, 2, 64, 127, 70),
                                  (1, 21, 21, 2, 2, 34, 0, 5)])  # scalar staging
@pytest.mark.parametrize("dt", DTYPES)
def test_attention_window_on_card(card, case, dt):
    b, sq, skv, hq, hkv, d, off, w = case
    q = _randn(card, (b, sq, hq, d), dt)
    k, v = _randn(card, (b, skv, hkv, d), dt), _randn(card, (b, skv, hkv, d), dt)
    got = _launched("attention_window",
                    lambda: ops.attention_window(q, k, v, w, q_offset=off))
    _assert_close(got, ref.attention(q, k, v, q_offset=off, window=w), dt)


@pytest.mark.parametrize("shape", [(4, 1, 21504), (1, 256, 21504), (1, 2048, 21504),
                                   (2, 37, 257), (1, 13), (1, 1)])
@pytest.mark.parametrize("dt", DTYPES)
def test_geglu_on_card(card, shape, dt):
    g, u = _randn(card, shape, dt, 3.0), _randn(card, shape, dt)
    got = _launched("geglu", lambda: ops.geglu(g, u))
    _assert_close(got, ref.geglu(g, u), dt)


def _glu_call(kernel, g, u):
    return _launched(kernel, lambda: getattr(ops, kernel)(g, u))


@pytest.mark.parametrize("offset,width", [(4, {torch.float32: 2, torch.bfloat16: 4}),
                                          (1, {torch.float32: 1, torch.bfloat16: 1})])
@pytest.mark.parametrize("kernel", ["swiglu", "geglu"])
@pytest.mark.parametrize("dt", DTYPES)
def test_glu_view_into_its_storage_on_card(card, offset, width, kernel, dt):
    """A view 4 elements into its storage (8-byte aligned: the vector
    body) and one element in (the scalar body)."""
    n = 4 * 11008 + offset
    gb, ub = _randn(card, (n,), dt, 3.0), _randn(card, (n,), dt)
    g, u = gb[offset:], ub[offset:]
    assert glu.plan_for(g, u).width == width[dt]
    _assert_close(_glu_call(kernel, g, u), getattr(ref, kernel)(g, u), dt)


#: finite extremes of the gate: e^-g and e^-2z overflow, g^3 overflows,
#: the denominator passes 2^126
GLU_EXTREMES = [1e-30, -1e-30, 20.0, -20.0, -88.8, 100.0, -100.0, 1e4, -1e4,
                1e13, -1e13, -87.5, -9.7]


@pytest.mark.parametrize("kernel", ["swiglu", "geglu"])
@pytest.mark.parametrize("dt", DTYPES)
def test_glu_extremes_on_card(card, kernel, dt):
    ext = torch.tensor(GLU_EXTREMES, device="cuda")
    g = ext.repeat(2, 8).to(dt)
    u = _randn(card, tuple(g.shape), dt)
    _assert_close(_glu_call(kernel, g, u), getattr(ref, kernel)(g, u), dt)


@pytest.mark.parametrize("kernel", ["swiglu", "geglu"])
@pytest.mark.parametrize("dt", DTYPES)
def test_glu_gate_sweep_on_card(card, kernel, dt):
    """2^16 gates evenly over [-8, 8] against ups of +-8: an approximate
    tanh fails here at f32 where 1 + tanh(z) is small."""
    n = 1 << 16
    g = torch.linspace(-8.0, 8.0, n, device="cuda").to(dt)
    u = ((torch.randint(0, 2, (n,), generator=card, device="cuda") * 2 - 1) * 8.0).to(dt)
    _assert_close(_glu_call(kernel, g, u), getattr(ref, kernel)(g, u), dt)


def test_a_glu_plan_the_kernel_cannot_take_raises(card, monkeypatch):
    g, u = _randn(card, (256, 11008), torch.bfloat16), _randn(card, (256, 11008), torch.bfloat16)
    plan = glu.plan_for(g, u)
    for bad in (plan._replace(threads=48), plan._replace(threads=2048),
                plan._replace(width=3), plan._replace(width=16),
                plan._replace(width=8),                    # 16-byte accesses
                plan._replace(width=2, grid=2 * plan.grid),  # 4-byte accesses
                plan._replace(grid=0), plan._replace(grid=plan.grid - 1)):
        monkeypatch.setattr(glu, "glu_plan", lambda *a, q=bad: q)
        with pytest.raises(RuntimeError, match="cudaError_t"):
            ops.swiglu(g, u)
    gb = _randn(card, (4 * 11008 + 4,), torch.bfloat16)
    for k, w in ((2, 4), (1, 4)):               # accesses past the alignment
        v = gb[k:]
        monkeypatch.setattr(glu, "glu_plan", lambda *a, q=glu.GluPlan(w, 128, 344): q)
        with pytest.raises(RuntimeError, match="cudaError_t"):
            ops.geglu(v, v)
    torch.cuda.synchronize()


def test_glu_without_a_host_sync(card):
    """Neither wrapper reads the card: each launch passes under
    set_sync_debug_mode("error")."""
    ins = [(_randn(card, (n,), torch.bfloat16), _randn(card, (n,), torch.bfloat16))
           for n in (4 * 11008, 256 * 11008, 13)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")   # a host read would raise
    try:
        for g, u in ins:
            ops.swiglu(g, u)
            ops.geglu(g, u)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", [(1, 197, 197, 12, 12, 64, 64),   # vit stub
                                  (2, 128, 128, 12, 12, 64, 64),   # bert
                                  (2, 64, 256, 6, 6, 64, 64),      # refine
                                  (1, 37, 301, 4, 2, 64, 32),      # GQA, Dv != Dk
                                  (1, 21, 23, 2, 2, 34, 18),       # scalar staging
                                  (1, 50, 70, 4, 4, 80, 80),       # head 80
                                  (1, 1, 96, 4, 2, 96, 96)])       # Sq = 1, head 96
@pytest.mark.parametrize("dt", DTYPES)
def test_attention_full_on_card(card, case, dt):
    b, sq, skv, hq, hkv, dk, dv = case
    q = _randn(card, (b, sq, hq, dk), dt)
    k, v = _randn(card, (b, skv, hkv, dk), dt), _randn(card, (b, skv, hkv, dv), dt)
    got = _launched("attention_full", lambda: ops.attention_full(q, k, v))
    _assert_close(got, ref.attention(q, k, v, causal=False), dt)


def _boxes(gen, n, span=60.0):
    xy = torch.rand(n, 2, generator=gen, device="cuda") * span
    wh = torch.rand(n, 2, generator=gen, device="cuda") * 12 + 1
    return torch.cat([xy, xy + wh], 1), torch.rand(n, generator=gen, device="cuda")


@pytest.mark.parametrize("n", [1, 37, 256, 1000, 4096])
@pytest.mark.parametrize("kind", ["random", "duplicate_scores", "score_threshold"])
def test_nms_on_card(card, n, kind):
    boxes, scores = _boxes(card, n)
    score_thr = 0.4 if kind == "score_threshold" else 0.0
    if kind == "duplicate_scores":
        scores = torch.round(scores * 3) / 3
    got = _launched("nms", lambda: ops.nms(boxes, scores, 0.5, score_thr))
    assert torch.equal(got, ref.nms(boxes, scores, 0.5, score_thr))


def test_nms_on_card_at_the_threshold(card):
    # f32 IoU exactly 0.5 (kept), one ulp above (suppressed), and pairs a
    # third of a width apart whose IoU rounds to either side of 0.5
    s = np.nextafter(np.float32(1 / 3), np.float32(0))
    exact = np.array([[10, 0, 13, 1], [11, 0, 14, 1], [0, 0, 1, 1],
                      [s, 0, np.float32(s + 1), 1]], np.float32)
    rng = np.random.default_rng(0)
    x, y, w, h = rng.uniform(5, 40, (4, 512))
    off = np.arange(512) * 100.0
    a = np.stack([off + x, y, off + x + w, y + h], -1)
    pairs = np.stack([a, a + np.stack([w / 3, 0 * w, w / 3, 0 * w], -1)], 1)
    for boxes in (exact, pairs.reshape(-1, 4).astype(np.float32)):
        b = torch.from_numpy(boxes).cuda()
        sc = torch.linspace(0.99, 0.5, len(boxes), device="cuda")
        got = _launched("nms", lambda: ops.nms(b, sc, 0.5))
        assert torch.equal(got, ref.nms(b, sc, 0.5))
    assert got.sum() not in (len(boxes) // 2, len(boxes))


@pytest.mark.parametrize("hq,hkv,lens", [(32, 32, [1, 200, 512, 0]),
                                         (8, 2, [0, 37, 100, 512])])
@pytest.mark.parametrize("dt", DTYPES)
def test_decode_core_on_card(card, hq, hkv, lens, dt):
    q = _randn(card, (4, 1, hq, 128), dt)
    k, v = _randn(card, (4, 512, hkv, 128), dt), _randn(card, (4, 512, hkv, 128), dt)
    n = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = _launched("decode_core", lambda: ops.decode_core(q, k, v, n))
    _assert_close(got, ref.decode_attention(q, k, v, n).to(dt), dt)
    assert not got[lens.index(0)].any()


def _split_plan(b, hkv, t):
    n = attn.decode_splits(b, hkv, t, torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count)
    return n, attn.decode_chunk(t, n)


# (B, T, Hq, Hkv, D): one row over 4096 keys (the most splits, one tile
# each), gemma3's ring rows (32 heads over 16), llama's 32 heads
@pytest.mark.parametrize("case", [(1, 4096, 1, 1, 128), (1, 4096, 8, 1, 64),
                                  (4, 1024, 32, 16, 128), (3, 700, 32, 32, 128)])
@pytest.mark.parametrize("where", ["boundary", "past_boundary", "one", "all"])
@pytest.mark.parametrize("dt", DTYPES)
def test_decode_core_split_on_card(card, case, where, dt):
    b, t, hq, hkv, d = case
    n_split, chunk = _split_plan(b, hkv, t)
    lens = {"boundary": chunk, "past_boundary": min(chunk + 1, t), "one": 1,
            "all": t}[where]
    lens = ([lens, t, 0, 37] * b)[:b]
    q = _randn(card, (b, 1, hq, d), dt)
    k, v = _randn(card, (b, t, hkv, d), dt), _randn(card, (b, t, hkv, d), dt)
    n = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = _launched("decode_core", lambda: ops.decode_core(q, k, v, n))
    _assert_close(got, ref.decode_attention(q, k, v, n).to(dt), dt)
    if 0 in lens:
        assert not got[lens.index(0)].any()


@pytest.mark.parametrize("b,hkv,t", [(4, 16, 1024), (64, 32, 256)])
def test_decode_reads_lengths_on_the_card(card, b, hkv, t):
    # split (b, hkv = 4, 16) and unsplit (64, 32): no host read of lengths
    # or of anything else in the path
    q = _randn(card, (b, 1, 2 * hkv, 64), torch.bfloat16)
    k = _randn(card, (b, t, hkv, 64), torch.bfloat16)
    v = _randn(card, (b, t, hkv, 64), torch.bfloat16)
    n = torch.full((b,), t, dtype=torch.int32, device="cuda")
    short = torch.full((b,), 65, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")   # a host read would raise
    try:
        o1 = ops.decode_core(q, k, v, n)
        n.copy_(short)                        # changed on the card only
        o2 = ops.decode_core(q, k, v, n)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    full = torch.full((b,), t, dtype=torch.int32, device="cuda")
    _assert_close(o1, ref.decode_attention(q, k, v, full).bfloat16(), torch.bfloat16)
    _assert_close(o2, ref.decode_attention(q, k, v, short).bfloat16(), torch.bfloat16)


@pytest.mark.parametrize("dt", DTYPES)
def test_decode_core_scalar_staging_on_card(card, dt):
    # head dims that are no multiple of a 16-byte vector take the scalar path
    q = _randn(card, (2, 1, 4, 34), dt)
    k, v = _randn(card, (2, 30, 2, 34), dt), _randn(card, (2, 30, 2, 18), dt)
    n = torch.tensor([30, 7], dtype=torch.int32, device="cuda")
    got = _launched("decode_core", lambda: ops.decode_core(q, k, v, n))
    _assert_close(got, ref.decode_attention(q, k, v, n).to(dt), dt)


NORM_SHAPES = [(4, 1, 4096), (4, 1, 1600), (2, 33, 257), (5, 1000)]


@pytest.mark.parametrize("shape", NORM_SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
def test_layer_norm_on_card(card, shape, dt):
    x = _randn(card, shape, dt) + 3.0
    w, b = _randn(card, shape[-1:], dt), _randn(card, shape[-1:], dt)
    got = _launched("layer_norm", lambda: ops.layer_norm(x, w, b))
    _assert_close(got, ref.layer_norm(x, w, b), dt)


@pytest.mark.parametrize("shape", NORM_SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_fused_add_norm_on_card(card, shape, dt, kind):
    x, res = _randn(card, shape, dt), _randn(card, shape, dt, 4.0)
    w, b = _randn(card, shape[-1:], dt), _randn(card, shape[-1:], dt)
    if kind == "rms":
        name, fn = "fused_add_rms_norm", lambda m: m.fused_add_rms_norm(x, res, w)
    else:
        name = "fused_add_layer_norm"
        fn = lambda m: m.fused_add_layer_norm(x, res, w, b)   # noqa: E731
    (y, r), (want_y, want_r) = _launched(name, lambda: fn(ops)), fn(ref)
    _assert_close(y, want_y, dt)
    assert torch.equal(r, want_r)      # one f32 add, rounded once, both sides


#: (shape, dtype, the body of csrc/norms.cu its plan picks): every body,
#: G 4 / 8 / 16 / 32, K 1 to 8, idle tail lanes, a partial last row group
ROW_NORM_BODIES = [((3, 16), torch.bfloat16, "warp"),           # G 4, lanes idle
                   ((2, 16384, 32), torch.float32, "warp"),     # G 8
                   ((3, 7, 128), torch.bfloat16, "warp"),       # G 16, 21 rows of 16
                   ((1, 2048, 32, 128), torch.bfloat16, "warp"),
                   ((5, 256), torch.bfloat16, "warp"),          # G 32
                   ((8, 128, 768), torch.bfloat16, "cta"),      # K 1, 96 threads
                   ((4, 1, 1600), torch.bfloat16, "cta"),       # K 1, 24 lanes idle
                   ((3, 1024), torch.float32, "cta"),
                   ((4, 1, 4096), torch.bfloat16, "cta"),       # K 2
                   ((1, 2048, 5376), torch.bfloat16, "cta"),    # K 3, 224 threads
                   ((2, 16384), torch.bfloat16, "cta"),         # K 8
                   ((2, 8192), torch.float32, "cta"),
                   ((2, 16384), torch.float32, "smem"),
                   ((2, 33, 257), torch.bfloat16, "smem")]      # scalar loads


def _row_norm_call(kind, x, res, w, b, q, qs):
    """(kernel name, f(module)) of one row norm on the given operands."""
    return {
        "rms": ("rms_norm", lambda m: m.rms_norm(x, w)),
        "rms_zero_centered": ("rms_norm", lambda m: m.rms_norm(x, w, zero_centered=True)),
        "layer": ("layer_norm", lambda m: m.layer_norm(x, w, b)),
        "fused_rms": ("fused_add_rms_norm", lambda m: m.fused_add_rms_norm(x, res, w)),
        "fused_layer": ("fused_add_layer_norm",
                        lambda m: m.fused_add_layer_norm(x, res, w, b)),
        "dequant": ("dequant_add_rms_norm",
                    lambda m: m.dequant_add_rms_norm(q, qs, res, w)),
    }[kind]


@pytest.mark.parametrize("shape,dt,body", ROW_NORM_BODIES)
@pytest.mark.parametrize("kind", ["rms", "rms_zero_centered", "layer", "fused_rms",
                                  "fused_layer", "dequant"])
def test_row_norm_body_on_card(card, shape, dt, body, kind):
    x, res = _randn(card, shape, dt) + 1.0, _randn(card, shape, dt, 4.0)
    w, b = _randn(card, shape[-1:], dt), _randn(card, shape[-1:], dt)
    q = torch.randint(-127, 128, shape, generator=card, device="cuda",
                      dtype=torch.int8)
    qs = torch.full((), 0.031, device="cuda")
    assert norms.plan_for(q if kind == "dequant" else x, dt, res, w, b).body == body
    name, fn = _row_norm_call(kind, x, res, w, b, q, qs)
    got, want = _launched(name, lambda: fn(ops)), fn(ref)
    if isinstance(got, tuple):
        _assert_close(got[0], want[0], dt)
        assert torch.equal(got[1], want[1])    # r: rounded once, both sides
    else:
        _assert_close(got, want, dt)


@pytest.mark.parametrize("shape", [(2, 1600), (2, 4096), (2, 257), (3, 7, 128)])
@pytest.mark.parametrize("dt", DTYPES)
def test_layer_norm_far_from_zero_on_card(card, shape, dt):
    """Rows of mean 1e3: each version's f32 mean carries ~2^-24 * 1e3 *
    log2(d) of summation-order error, which the normalized row shows
    unscaled (f32 atol 1e-3, chip_smoke.py's LARGE_MEAN_TOL); a one-pass
    variance errs by ~0.1."""
    x = _randn(card, shape, dt) + 1e3
    w, b = _randn(card, shape[-1:], dt), _randn(card, shape[-1:], dt)
    for name, fn in (("layer_norm", lambda m: m.layer_norm(x, w, b)),
                     ("fused_add_layer_norm",
                      lambda m: m.fused_add_layer_norm(x, torch.zeros_like(x), w, b)[0])):
        got, want = _launched(name, lambda: fn(ops)), fn(ref)
        torch.cuda.synchronize()
        atol, rtol = (1e-3, 1e-5) if dt == torch.float32 else TOL[dt]
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_row_norm_plan_without_a_host_sync(card):
    """row_norm_plan reads shapes and pointers only: no launch of any body
    waits on the card."""
    ops_in = []
    for shape, dt, _ in ROW_NORM_BODIES:
        x = _randn(card, shape, dt)
        w, b = _randn(card, shape[-1:], dt), _randn(card, shape[-1:], dt)
        q = torch.randint(-127, 128, shape, generator=card, device="cuda",
                          dtype=torch.int8)
        ops_in.append((x, w, b, q, torch.full((), 0.5, device="cuda")))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")   # a host read would raise
    try:
        for x, w, b, q, qs in ops_in:
            ops.rms_norm(x, w)
            ops.layer_norm(x, w, b)
            ops.fused_add_rms_norm(x, x, w)
            ops.fused_add_layer_norm(x, x, w, b)
            ops.dequant_add_rms_norm(q, qs, x, w)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_a_plan_the_kernel_cannot_take_raises(card, monkeypatch):
    x, w = _randn(card, (4, 1600), torch.bfloat16), _randn(card, (1600,), torch.bfloat16)
    plan = norms.plan_for(x, torch.bfloat16, w)         # body B, 224 threads
    warp = norms.body_plan("warp", 64, 256, torch.bfloat16, True, 132)
    for bad in (plan._replace(lanes=192, threads=192), plan._replace(vecs=9),
                plan._replace(threads=200, lanes=200), plan._replace(grid=1),
                warp._replace(lanes=5), warp._replace(vecs=2),
                plan._replace(body="smem", grid=1)):
        monkeypatch.setattr(norms, "row_norm_plan", lambda *a, p=bad: p)
        with pytest.raises(RuntimeError, match="cudaError_t"):
            ops.rms_norm(x, w)
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", [(4, 1, 32, 128, 1.0, [[186], [144], [120], [72]]),
                                  (4, 1, 32, 80, 0.25, [[215], [19], [60], [511]]),
                                  (1, 16, 32, 128, 1.0, None),
                                  (2, 7, 25, 64, 0.25, None),
                                  (1, 5, 3, 34, 1.0, [[4091, 4092, 4093, 4094, 4095]]),
                                  (1, 5, 3, 96, 1.0, [[4091, 4092, 4093, 4094, 4095]])])
@pytest.mark.parametrize("dt", DTYPES)
def test_rope_on_card(card, case, dt):
    b, s, h, d, fraction, pos = case
    x = _randn(card, (b, s, h, d), dt)
    p = (torch.arange(s, dtype=torch.int32, device="cuda")[None].expand(b, s)
         if pos is None else torch.tensor(pos, dtype=torch.int32, device="cuda"))
    got = _launched("rope", lambda: ops.rope(x, p, fraction=fraction))
    _assert_close(got, ref.rope(x, p, fraction=fraction), dt)


# (B, S, H, D, fraction, first position, positions as a (B, 1) column):
# one CTA a row (the decode step, a column near 4095), rows walked by a
# grid stride one (gemma3-27b's q) and two at a time with a ragged last
# step (its k at 2049), rows in chunks (more vectors than threads), the
# scalar body at half 6144, partial rotary
ROPE_PLAN_CASES = [(4, 1, 32, 128, 1.0, 186, True), (4, 1, 32, 128, 1.0, 4092, True),
                   (1, 2048, 32, 128, 1.0, 0, False), (1, 2049, 16, 128, 1.0, 0, False),
                   (2, 3, 72, 256, 1.0, 7, False), (1, 3, 2, 12289, 1.0, 4093, False),
                   (3, 7, 25, 64, 0.25, 500, False), (700, 1, 8, 64, 1.0, 9, True),
                   (4, 1, 32, 80, 0.25, 215, True), (1, 256, 32, 80, 0.25, 0, False)]


def _rope_inputs(gen, case, dt):
    b, s, h, d, fraction, p0, column = case
    x = _randn(gen, (b, s, h, d), dt)
    ar = p0 + torch.arange(b if column else s, dtype=torch.int32, device="cuda")
    return x, (ar[:, None] if column else ar[None]), fraction


@pytest.mark.parametrize("case", ROPE_PLAN_CASES)
@pytest.mark.parametrize("dt", DTYPES)
def test_rope_plan_on_card(card, case, dt):
    """Each plan of csrc/rope.cu bit-identical to the plain version."""
    x, p, fraction = _rope_inputs(card, case, dt)
    got = _launched("rope", lambda: ops.rope(x, p, fraction=fraction))
    torch.cuda.synchronize()
    assert torch.equal(got, ref.rope(x, p, fraction=fraction)), \
        rope.plan_for(x, fraction, got)


def test_a_rope_plan_the_kernel_cannot_take_raises(card, monkeypatch):
    x, p, _ = _rope_inputs(card, (1, 2048, 32, 128, 1.0, 0, False), torch.bfloat16)
    plan = rope.plan_for(x)                     # walked: two angle tables
    for bad in (plan._replace(threads=48), plan._replace(threads=2048),
                plan._replace(width=4), plan._replace(width=3),
                plan._replace(grid=0), plan._replace(grid=-1),
                plan._replace(rows_per_cta=0), plan._replace(rows_per_cta=200)):
        monkeypatch.setattr(rope, "rope_plan", lambda *a, q=bad: q)
        with pytest.raises(RuntimeError, match="cudaError_t"):
            ops.rope(x, p)
    torch.cuda.synchronize()


def _nms_words(n, seed=0):
    """Score-sorted boxes at ``n`` with every third invalid and two pairs
    far from the rest: f32 IoU exactly 0.5 at (a, a + 1), across a word
    boundary where n allows (kept), one ulp above at (b, b + 1)
    (suppressed)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(size=(n, 2)) * (2 * np.sqrt(n) + 20)
    wh = rng.uniform(size=(n, 2)) * 12 + 1
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    valid = np.arange(n) % 3 != 1
    s = np.nextafter(np.float32(1 / 3), np.float32(0))
    a = 63 if n > 64 else n // 2 - 1
    b = 127 if n > 128 else (a + 3 if a + 4 < n else a - 3)
    boxes[a:a + 2] = [[10010, 0, 10013, 1], [10011, 0, 10014, 1]]
    boxes[b:b + 2] = [[0, 1000, 1, 1001], [s, 1000, np.float32(s + 1), 1001]]
    valid[[a, a + 1, b, b + 1]] = True
    return (torch.from_numpy(boxes).cuda(), torch.from_numpy(valid).cuda(), a, b)


@pytest.mark.parametrize("n", [63, 64, 65, 127, 128, 129, 4663])
def test_nms_word_boundaries_on_card(card, n):
    boxes, valid, a, b = _nms_words(n)
    got = _launched("nms", lambda: ops.nms_sorted(boxes, valid, 0.5))
    want = ref.nms_sorted(boxes, valid, 0.5)
    assert torch.equal(got, want)
    assert got[a + 1] and not got[b + 1]


def test_nms_fma_sensitive_pairs_on_card(card):
    """chip_smoke.py's pairs whose IoU an FMA would move across 0.5 fall as
    the rounded arithmetic has them (tests/test_torch_rope_nms_design.py
    checks the pairs)."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    boxes, keep = cs.fma_pairs()
    b = torch.from_numpy(boxes).cuda()
    valid = torch.ones(len(boxes), dtype=torch.bool, device="cuda")
    got = _launched("nms", lambda: ops.nms_sorted(b, valid, 0.5))
    assert got.tolist() == keep.tolist()
    assert torch.equal(got, ref.nms_sorted(b, valid, 0.5))


def test_nms_leaves_its_counter_zero(card):
    """The last mask CTA runs the reduce and sets the stream's counter back
    to 0: calls in a row, of other sizes between, give the same masks."""
    boxes, valid, _, _ = _nms_words(4663)
    small, svalid, _, _ = _nms_words(65, seed=1)
    first = ops.nms_sorted(boxes, valid, 0.5)
    masks = [ops.nms_sorted(small, svalid, 0.5), ops.nms_sorted(boxes, valid, 0.5),
             ops.nms_sorted(small, svalid, 0.5), ops.nms_sorted(boxes, valid, 0.5)]
    torch.cuda.synchronize()
    assert torch.equal(first, masks[1]) and torch.equal(first, masks[3])
    assert torch.equal(masks[0], masks[2])
    stream = torch.cuda.current_stream().cuda_stream
    assert int(_build.counters(boxes.device, stream, 1)[0]) == 0


def test_rope_and_nms_without_a_host_sync(card):
    """Neither wrapper reads the card: each launch passes under
    set_sync_debug_mode("error")."""
    inputs = [_rope_inputs(card, c, torch.bfloat16) for c in ROPE_PLAN_CASES]
    boxes, valid, _, _ = _nms_words(4663)
    scores = torch.rand(4663, generator=card, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")   # a host read would raise
    try:
        for x, p, fraction in inputs:
            ops.rope(x, p, fraction=fraction)
        ops.nms_sorted(boxes, valid, 0.5)
        ops.nms(boxes, scores, 0.5, 0.05)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


DEQUANT_SHAPES = [(4, 128), (2, 33, 257), (1, 7, 3, 64), (1, 10, 4096),
                  (4, 1, 4096)]


@pytest.mark.parametrize("shape", DEQUANT_SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("zero_centered", [False, True])
def test_dequant_add_rms_norm_on_card(card, shape, dt, zero_centered):
    q = torch.randint(-127, 128, shape, generator=card, device="cuda",
                      dtype=torch.int8)
    qs = torch.full((), 0.031, device="cuda")
    res = _randn(card, shape, dt, 4.0)
    w = _randn(card, shape[-1:], dt)
    y, r = _launched("dequant_add_rms_norm", lambda: ops.dequant_add_rms_norm(
        q, qs, res, w, zero_centered=zero_centered))
    want_y, want_r = ref.dequant_add_rms_norm(q, qs, res, w,
                                              zero_centered=zero_centered)
    _assert_close(y, want_y, dt)
    assert torch.equal(r, want_r)   # a multiply, an add, rounded once, both sides


def test_dequant_reads_its_scale_on_the_card(card):
    q = torch.randint(-127, 128, (3, 64), generator=card, device="cuda",
                      dtype=torch.int8)
    qs = torch.full((), 0.5, device="cuda")
    res = torch.zeros(3, 64, device="cuda")
    w = torch.ones(64, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")   # a host read of qs would raise
    try:
        _, r1 = ops.dequant_add_rms_norm(q, qs, res, w)
        qs.fill_(0.25)                        # changed on the card only
        _, r2 = ops.dequant_add_rms_norm(q, qs, res, w)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(r1, q.float() * 0.5) and torch.equal(r2, q.float() * 0.25)


#: the reference sweep's shapes, the §4.5 site, gemma3-27b's vocabulary
#: with 2 and 8 rows (split into many spans); (5, 4099), (3, 100003) and
#: (9, 24577) split with misaligned rows and span edges; one logit
@pytest.mark.parametrize("rows,vocab", [(7, 1000), (32, 50304), (3, 130),
                                        (256, 32000), (2, 262144), (1, 1),
                                        (5, 4099), (8, 262144), (3, 100003),
                                        (9, 24577)])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("ldt", [torch.int32, torch.int64])
def test_softmax_xent_on_card(card, rows, vocab, dt, ldt):
    logits = _randn(card, (rows, vocab), dt, 5.0)
    labels = torch.randint(0, vocab, (rows,), generator=card, device="cuda",
                           dtype=ldt)
    labels[0], labels[-1] = 0, vocab - 1      # in the first and last spans
    got = _launched("softmax_xent", lambda: ops.softmax_xent(logits, labels))
    # f32 out on both sides, from the same logits: JAX's sweep tolerance
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (rows,)
    torch.testing.assert_close(got, ref.softmax_xent(logits, labels),
                               atol=1e-5, rtol=1e-5)


def test_softmax_xent_split_twice_on_one_stream_and_on_another(card):
    """The split plan's row counters are left at 0: a second launch on the
    stream merges as the first did, and a launch on a second stream (its
    own counters) agrees."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert xent.xent_plan(8, 262144, torch.float32, sms).n_split > 1
    a, b = (_randn(card, (8, 262144), torch.float32, 5.0) for _ in range(2))
    labels = torch.randint(0, 262144, (8,), generator=card, device="cuda")
    got_a = ops.softmax_xent(a, labels)
    got_b = ops.softmax_xent(b, labels)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got_c = ops.softmax_xent(b, labels)
    torch.cuda.synchronize()
    for got, x in ((got_a, a), (got_b, b), (got_c, b)):
        torch.testing.assert_close(got, ref.softmax_xent(x, labels), atol=1e-5,
                                   rtol=1e-5)


def test_a_xent_plan_the_kernel_cannot_take_raises(card, monkeypatch):
    """A plan whose spans are not whole tiles, leave a span empty, miss
    the end of the row or outnumber the merge's threads is refused by the
    C entry, and the wrapper raises: no launch, no fallback."""
    logits = _randn(card, (8, 262144), torch.float32)
    labels = torch.zeros(8, dtype=torch.int32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = xent.xent_plan(8, 262144, torch.float32, sms)
    for bad in (plan._replace(span=plan.span + 1),
                plan._replace(n_split=plan.n_split + 1),
                plan._replace(n_split=plan.n_split - 1),
                plan._replace(n_split=0)):
        monkeypatch.setattr(xent, "xent_plan", lambda *a, q=bad: q)
        with pytest.raises(RuntimeError, match="cudaError_t"):
            ops.softmax_xent(logits, labels)
    wide = _randn(card, (1, 300 * plan.tile), torch.float32)   # 300 spans
    monkeypatch.setattr(xent, "xent_plan",
                        lambda *a: xent.XentPlan(plan.tile, plan.tile, 300))
    with pytest.raises(RuntimeError, match="cudaError_t"):
        ops.softmax_xent(wide, labels[:1])
    torch.cuda.synchronize()


def test_softmax_xent_without_a_host_sync(card):
    """The wrapper reads nothing of the card (the plan comes from the
    shapes): split and unsplit launches pass under
    set_sync_debug_mode("error")."""
    ins = [(_randn(card, (r, v), torch.bfloat16),
            torch.zeros(r, dtype=torch.int64, device="cuda"))
           for r, v in ((8, 262144), (256, 32000))]
    for x, lab in ins:
        ops.softmax_xent(x, lab)              # scratch and counters exist
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [ops.softmax_xent(x, lab) for x, lab in ins]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for (x, lab), got in zip(ins, outs):
        torch.testing.assert_close(got, ref.softmax_xent(x, lab), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("rows,vocab", [(4, 1000), (4, 262144)])
def test_softmax_xent_label_outside_the_vocab_picks_nothing(card, rows, vocab):
    # (4, 262144) runs a split plan: a label past the last span, or before
    # the first, is read by no span
    logits = _randn(card, (rows, vocab), torch.float32, 5.0)
    labels = torch.tensor([-1, vocab, vocab + 23, 3], device="cuda")
    got = ops.softmax_xent(logits, labels)
    lse = torch.logsumexp(logits, dim=-1)
    torch.testing.assert_close(got[:3], lse[:3], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[3], lse[3] - logits[3, 3], atol=1e-5,
                               rtol=1e-5)


def test_new_kernels_reject_what_they_do_not_take(card):
    x = _randn(card, (4, 64), torch.float32)
    w = torch.ones(64, device="cuda")
    qs = torch.full((), 0.1, device="cuda")
    q = torch.zeros(4, 64, dtype=torch.int8, device="cuda")
    with pytest.raises(TypeError, match="int8"):
        ops.dequant_add_rms_norm(x, qs, x, w)
    with pytest.raises(TypeError, match="0-d float32"):
        ops.dequant_add_rms_norm(q, qs.reshape(1), x, w)
    with pytest.raises(ValueError, match="operands on"):
        ops.dequant_add_rms_norm(q, qs.cpu(), x, w)
    with pytest.raises(TypeError, match="mixed dtypes"):
        ops.dequant_add_rms_norm(q, qs, x, w.bfloat16())
    with pytest.raises(TypeError, match="labels"):
        ops.softmax_xent(x, torch.zeros(4, device="cuda"))
    with pytest.raises(TypeError, match="dtype"):
        ops.softmax_xent(x.half(), torch.zeros(4, dtype=torch.int64,
                                               device="cuda"))
    with pytest.raises(ValueError, match=r"\(R, V\)"):
        ops.softmax_xent(x[None], torch.zeros(1, dtype=torch.int64,
                                              device="cuda"))


def test_kernels_raise_above_what_they_take(card):
    q = _randn(card, (1, 4, 2, 192), torch.float32)
    with pytest.raises(ValueError, match="head dims"):
        ops.attention_core(q, q, q)
    with pytest.raises(ValueError, match="head dims"):
        ops.attention_full(q, q, q)
    with pytest.raises(ValueError, match="boxes above"):
        ops.nms_sorted(_randn(card, (9000, 4), torch.float32),
                       torch.ones(9000, dtype=torch.bool, device="cuda"))
    with pytest.raises(ValueError, match="width"):
        ops.layer_norm(_randn(card, (1, 40000), torch.float32),
                       _randn(card, (40000,), torch.float32),
                       _randn(card, (40000,), torch.float32))
    with pytest.raises(ValueError, match="GQA group"):
        ops.decode_core(_randn(card, (1, 1, 64, 8), torch.float32),
                        _randn(card, (1, 4, 1, 8), torch.float32),
                        _randn(card, (1, 4, 1, 8), torch.float32),
                        torch.ones(1, dtype=torch.int32, device="cuda"))


#: MLA's prefill (Dk 192 = nope 128 + rope 64, Dv 128, 16 heads): the
#: 16- and 256-token buckets and the last 64-token chunk of a 512-deep
#: cache; GQA, a ragged chunk
MLA_PREFILL = [(1, 16, 16, 16, 16, 192, 128, 0), (1, 256, 256, 16, 16, 192, 128, 0),
               (1, 64, 512, 16, 16, 192, 128, 448), (2, 37, 200, 4, 2, 192, 128, 100)]


@pytest.mark.parametrize("case", MLA_PREFILL, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dt", DTYPES)
def test_attention_core_mla_dims_on_card(card, case, dt):
    b, sq, skv, hq, hkv, dk, dv, off = case
    q = _randn(card, (b, sq, hq, dk), dt)
    k, v = _randn(card, (b, skv, hkv, dk), dt), _randn(card, (b, skv, hkv, dv), dt)
    got = _launched("attention_core",
                    lambda: ops.attention_core(q, k, v, q_offset=off))
    _assert_close(got, ref.attention(q, k, v, q_offset=off), dt)


def _mla_decode_inputs(gen, dt, lens, t=512):
    """q [4,1,16,576] over one latent KV head of depth ``t``, keys 576 and
    values 512 wide, and int32 ``lens``."""
    b = len(lens)
    q = _randn(gen, (b, 1, 16, 576), dt)
    k, v = _randn(gen, (b, t, 1, 576), dt), _randn(gen, (b, t, 1, 512), dt)
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("lens", [[1, 0, 300, 512], [64, 65, 511, 129],
                                  [31, 32, 33, 0], [0, 1, 511, 512]])
@pytest.mark.parametrize("dt", DTYPES)
def test_decode_core_mla_absorbed_on_card(card, lens, dt):
    """The wide bodies (the tensor cores' in bf16, the FMA units' in f32):
    scale 1/sqrt(192), ragged lengths with 0 and 1, either side of a
    32-key tile, 511 and 512; exact zeros at length 0."""
    q, k, v, n = _mla_decode_inputs(card, dt, lens)
    scale = 192 ** -0.5
    assert attn.decode_body(576, 512, dt) == (
        "wide mma bf16" if dt == torch.bfloat16 else "wide fma f32")
    got = _launched("decode_core", lambda: ops.decode_core(q, k, v, n, scale=scale))
    _assert_close(got, ref.decode_attention(q, k, v, n, scale=scale).to(dt), dt)
    if 0 in lens:
        assert not got[lens.index(0)].any()
    assert _counters_zero()


@pytest.mark.parametrize("dt", DTYPES)
def test_decode_core_mla_reads_no_key_past_the_length_on_card(card, dt):
    """NaN keys and values past each row's length (a stale cache) reach no
    product: the output is finite and equals the clean cache's."""
    lens = [186, 0, 33, 511]
    q, k, v, n = _mla_decode_inputs(card, dt, lens)
    want = ref.decode_attention(q, k, v, n, scale=0.1).to(dt)
    for i, m in enumerate(lens):
        k[i, m:], v[i, m:] = float("nan"), float("nan")
    got = ops.decode_core(q, k, v, n, scale=0.1)
    assert bool(torch.isfinite(got).all())
    _assert_close(got, want, dt)
    assert not got[1].any()


def test_decode_core_mla_in_a_cuda_graph_on_card(card):
    """One capture of the bf16 wide body, replayed over new lengths and
    values in its static inputs, equals the eager launch on the same
    inputs; each replay leaves the split counters at 0."""
    dt = torch.bfloat16
    q, k, v, n = _mla_decode_inputs(card, dt, [186, 144, 120, 72])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # the eager warm-up makes the counters
        ops.decode_core(q, k, v, n, scale=0.1)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with ops.recording() as rec, torch.cuda.graph(graph, stream=side):
        out = ops.decode_core(q, k, v, n, scale=0.1)
    assert rec["decode_core"] == 1
    for lens in ([186, 144, 120, 72], [512, 1, 0, 300]):
        n.copy_(torch.tensor(lens, dtype=torch.int32))
        q.copy_(_randn(card, q.shape, dt))
        graph.replay()
        torch.cuda.synchronize()
        want = ops.decode_core(q, k, v, n, scale=0.1)
        assert torch.equal(out, want)
        _assert_close(out, ref.decode_attention(q, k, v, n, scale=0.1).to(dt), dt)
    assert _counters_zero()


def test_kernels_refuse_head_dims_they_have_no_instantiation_for(card):
    """Prefill takes both dims up to 128, MLA's (192, 128) causal alone and
    recurrentgemma's (256, 256) window alone; decode both up to 128, MLA's
    (576, 512) at a group of 16 alone and (256, 256) at a group of 10
    alone: the wrappers raise outside, and the C entries refuse what the
    wrappers let through."""
    from repro_torch.kernels import attn_template as at
    for dk, dv in ((256, 128), (192, 192), (200, 64), (136, 72)):
        q, v = _randn(card, (1, 4, 2, dk), torch.bfloat16), \
            _randn(card, (1, 4, 2, dv), torch.bfloat16)
        with pytest.raises(ValueError, match="no instantiation"):
            ops.attention_core(q, q, v)
        with pytest.raises(RuntimeError, match="cudaError_t"):
            at.attention_core(q, q, v, 0, 1.0)
    # MLA's dims are the causal kernel's alone
    q, v = _randn(card, (1, 4, 2, 192), torch.bfloat16), \
        _randn(card, (1, 4, 2, 128), torch.bfloat16)
    for call in (lambda: ops.attention_full(q, q, v),
                 lambda: ops.attention_window(q, q, v, 2)):
        with pytest.raises(ValueError, match="no instantiation"):
            call()
    with pytest.raises(RuntimeError, match="cudaError_t"):
        at.attention_full(q, q, v, 1.0)
    # recurrentgemma's (256, 256) is the window kernel's alone, and its
    # window takes that pair alone
    q = _randn(card, (1, 4, 2, 256), torch.bfloat16)
    for call in (lambda: ops.attention_core(q, q, q),
                 lambda: ops.attention_full(q, q, q)):
        with pytest.raises(ValueError, match="no instantiation"):
            call()
    for call in (lambda: at.attention_core(q, q, q, 0, 1.0),
                 lambda: at.attention_full(q, q, q, 1.0)):
        with pytest.raises(RuntimeError, match="cudaError_t"):
            call()
    v = _randn(card, (1, 4, 2, 128), torch.bfloat16)
    with pytest.raises(ValueError, match="no instantiation"):
        ops.attention_window(q, q, v, 2)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        at.attention_window(q, q, v, 2, 0, 1.0)
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    for dk, dv, g in ((640, 512, 16), (576, 514, 16), (576, 520, 16),
                      (576, 508, 16), (264, 256, 8), (576, 512, 8),
                      (576, 512, 32), (256, 256, 8), (256, 256, 16),
                      (256, 256, 1), (256, 128, 10)):
        q = _randn(card, (1, 1, g, dk), torch.float32)
        k, v = _randn(card, (1, 8, 1, dk), torch.float32), \
            _randn(card, (1, 8, 1, dv), torch.float32)
        with pytest.raises(ValueError, match="no instantiation"):
            ops.decode_core(q, k, v, one)
        with pytest.raises(RuntimeError, match="cudaError_t"):
            at.decode_core(q, k, v, one, 1.0)


# recurrentgemma-2b's local layers: (B, Sq, Hq, Hkv, D, window) at its
# 2048 window over 2048 and 2100 tokens (past it), a short prompt, a
# window of a tile
RG_WINDOW = [(1, 2048, 10, 1, 256, 2048), (1, 2100, 10, 1, 256, 2048),
             (1, 37, 10, 1, 256, 2048), (2, 130, 10, 1, 256, 64)]


@pytest.mark.parametrize("case", RG_WINDOW, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dt", DTYPES)
def test_attention_window_256_on_card(card, case, dt):
    """The window kernel's (256, 256) instantiation: bf16 as two CTAs of
    128 output columns each, f32 on the FMA body."""
    b, s, hq, hkv, d, w = case
    q = _randn(card, (b, s, hq, d), dt)
    k, v = _randn(card, (b, s, hkv, d), dt), _randn(card, (b, s, hkv, d), dt)
    got = _launched("attention_window", lambda: ops.attention_window(q, k, v, w))
    _assert_close(got, ref.attention(q, k, v, window=w), dt)


@pytest.mark.parametrize("lens", [[0, 1, 31, 32], [33, 2048, 2048, 5],
                                  [2048, 2048, 348, 52]])
@pytest.mark.parametrize("dt", DTYPES)
def test_decode_core_256_g10_on_card(card, lens, dt):
    """The wide bodies at recurrentgemma's (256, 256), one KV head for a
    group of 10 (M padded to 16 in bf16) over rings of 2048; exact zeros at
    length 0, the counters left at 0."""
    q = _randn(card, (4, 1, 10, 256), dt)
    k, v = _randn(card, (4, 2048, 1, 256), dt), _randn(card, (4, 2048, 1, 256), dt)
    n = torch.tensor(lens, dtype=torch.int32, device="cuda")
    assert attn.decode_body(256, 256, dt) == (
        "wide mma bf16" if dt == torch.bfloat16 else "wide fma f32")
    got = _launched("decode_core", lambda: ops.decode_core(q, k, v, n))
    _assert_close(got, ref.decode_attention(q, k, v, n).to(dt), dt)
    if 0 in lens:
        assert not got[lens.index(0)].any()
    assert _counters_zero()


@pytest.mark.parametrize("fused", [False, True])
def test_reduced_recurrentgemma_on_card(card, fused):
    """Reduced recurrentgemma-2b: the kernel path's logits against the
    plain path's; the Engine prefills at the exact prompt length and its
    tokens on the card equal the CPU's, graphed and eager alike (the
    graph replays against the recurrent state decode writes in place)."""
    cfg = reduced(get_config("recurrentgemma-2b"))
    params = init_lm(card, cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 70), generator=card,
                         device="cuda")
    with nn.backend("torch"), nn.fuse(fused):
        want = lm_forward(params, toks, cfg)
    ops.reset_launches()
    with nn.fuse(fused):
        got = lm_forward(params, toks, cfg)
    assert ops.launches["attention_window"] == 1
    assert ops.launches["attention_core"] == 0
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)

    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
               for n in (5, 70, 11)]

    def serve(p, **kw):
        eng = Engine(cfg, p, max_batch=2, max_len=128, fused=fused, **kw)
        assert eng._bucket(70) == 70
        uids = [eng.add_request(x, max_new_tokens=8) for x in prompts]
        done = {r.uid: r.output for r in eng.run()}
        return [done[u] for u in uids]

    ops.reset_launches()
    graphed = serve(params)
    assert ops.launches["decode_core"] > 0
    assert graphed == serve(params, cuda_graph=False) == serve(_to(params, "cpu"))
    with pytest.raises(ValueError):
        PagedEngine(cfg, params, max_batch=2, max_len=128)


@pytest.mark.parametrize("fused", [False, True])
def test_reduced_xlstm_on_card(card, fused):
    """Reduced xlstm-350m: the kernel path's logits against the plain
    path's (the fused path's GeGLU on ff_up's contiguous halves); the
    Engine prefills at the exact prompt length and its tokens on the card
    equal the CPU's, graphed and eager alike (the graph replays against
    the mLSTM and sLSTM states decode writes in place); one eager decode
    step reads nothing on the host."""
    from repro_torch.models import init_lm_cache
    from repro_torch.serving import make_serve_step
    cfg = reduced(get_config("xlstm-350m"))
    params = init_lm(card, cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 45), generator=card,
                         device="cuda")
    with nn.backend("torch"), nn.fuse(fused):
        want = lm_forward(params, toks, cfg)
    ops.reset_launches()
    with nn.fuse(fused):
        got = lm_forward(params, toks, cfg)
    assert ops.launches["layer_norm"] == cfg.n_layers + 1
    assert ops.launches["rms_norm"] == cfg.n_layers
    assert ops.launches["geglu"] == (1 if fused else 0)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)

    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
               for n in (5, 40, 2)]

    def serve(p, **kw):
        eng = Engine(cfg, p, max_batch=2, max_len=64, fused=fused, **kw)
        assert eng._bucket(40) == 40
        uids = [eng.add_request(x, max_new_tokens=8) for x in prompts]
        done = {r.uid: r.output for r in eng.run()}
        return [done[u] for u in uids]

    assert serve(params) == serve(params, cuda_graph=False) == \
        serve(_to(params, "cpu"))
    with pytest.raises(ValueError):
        PagedEngine(cfg, params, max_batch=2, max_len=64)
    token = torch.tensor([3, 4], device="cuda")
    pos = torch.tensor([5, 9], dtype=torch.int32, device="cuda")
    caches = init_lm_cache(cfg, 2, 64, device="cuda")
    step = make_serve_step(cfg, fused=fused)
    step(params, token, pos, caches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(params, token, pos, caches)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


MOE_MODELS = [(a, f) for a in ("qwen2-moe-a2.7b", "deepseek-v2-lite-16b")
              for f in (False, True)]


@pytest.mark.parametrize("arch,fused", MOE_MODELS)
def test_reduced_moe_model_on_card(card, arch, fused):
    """Reduced qwen2-moe and deepseek-v2-lite: the kernel path's logits
    against the plain path's; the Engine's tokens on the card equal the
    CPU's, graphed and eager alike, and one eager decode step reads nothing
    on the host (the dispatch and combine included)."""
    from repro_torch.models import init_lm_cache
    from repro_torch.serving import make_serve_step
    cfg = reduced(get_config(arch))
    params = init_lm(card, cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 37), generator=card,
                         device="cuda")
    with nn.backend("torch"), nn.fuse(fused):
        want = lm_forward(params, toks, cfg)
    ops.reset_launches()
    with nn.fuse(fused):
        got = lm_forward(params, toks, cfg)
    assert ops.launches["attention_core"] == cfg.n_layers
    assert ops.launches["swiglu"] == 2 * cfg.n_layers - cfg.first_dense_layers
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)

    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
               for n in (5, 20, 9)]

    def serve(p, **kw):
        eng = Engine(cfg, p, max_batch=2, max_len=64, fused=fused, **kw)
        uids = [eng.add_request(x, max_new_tokens=8) for x in prompts]
        done = {r.uid: r.output for r in eng.run()}
        return [done[u] for u in uids]

    ops.reset_launches()
    graphed = serve(params)
    assert ops.launches["decode_core"] > 0
    assert graphed == serve(params, cuda_graph=False) == serve(_to(params, "cpu"))
    token = torch.tensor([3, 4], device="cuda")
    pos = torch.tensor([5, 9], dtype=torch.int32, device="cuda")
    caches = init_lm_cache(cfg, 2, 64, device="cuda")
    step = make_serve_step(cfg, fused=fused)
    step(params, token, pos, caches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(params, token, pos, caches)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


MODELS = [("llama2-7b", False), ("llama2-7b", True), ("gpt2-xl", False),
          ("gpt2-xl", True)]


@pytest.mark.parametrize("arch,fused", MODELS)
def test_reduced_model_kernel_path_matches_plain_path(card, arch, fused):
    cfg = reduced(get_config(arch))
    params = init_lm(card, cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 37), generator=card,
                         device="cuda")
    with nn.backend("torch"), nn.fuse(fused):
        want = lm_forward(params, toks, cfg)
    ops.reset_launches()
    with nn.fuse(fused):
        got = lm_forward(params, toks, cfg)       # default: kernels on the card
    assert ops.launches["attention_core"] == cfg.n_layers
    if fused:
        assert ops.launches["fused_add_rms_norm" if cfg.norm == "rmsnorm"
                            else "fused_add_layer_norm"] == cfg.n_layers
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch,fused", MODELS)
def test_engine_on_card_matches_engine_on_cpu(card, arch, fused):
    cfg = reduced(get_config(arch))
    params = init_lm(card, cfg)
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n))) for n in (5, 20, 9)]

    def serve(p):
        eng = Engine(cfg, p, max_batch=2, max_len=64, fused=fused)
        uids = [eng.add_request(x, max_new_tokens=8) for x in prompts]
        done = {r.uid: r.output for r in eng.run()}
        return [done[u] for u in uids]

    cpu = _to(params, "cpu")
    ops.reset_launches()
    on_card = serve(params)
    assert ops.launches["decode_core"] > 0
    assert on_card == serve(cpu)


@pytest.mark.parametrize("fused", [False, True])
def test_reduced_gemma3_kernel_path_matches_plain_path(card, fused):
    """Past the reduced window of 64: 5 local layers through the window
    kernel, the global one through the causal kernel; the engine on the card
    gives the CPU engine's tokens with prompts that cross the window."""
    cfg = reduced(get_config("gemma3-27b"))
    params = init_lm(card, cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 100), generator=card,
                         device="cuda")
    with nn.backend("torch"), nn.fuse(fused):
        want = lm_forward(params, toks, cfg)
    ops.reset_launches()
    with nn.fuse(fused):
        got = lm_forward(params, toks, cfg)
    assert ops.launches["attention_window"] == 5
    assert ops.launches["attention_core"] == 1
    assert ops.launches["geglu"] == (cfg.n_layers if fused else 0)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)

    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
               for n in (100, 70, 5)]

    def serve(p):
        eng = Engine(cfg, p, max_batch=2, max_len=128, fused=fused)
        uids = [eng.add_request(x, max_new_tokens=8) for x in prompts]
        done = {r.uid: r.output for r in eng.run()}
        return [done[u] for u in uids]

    cpu = _to(params, "cpu")
    on_card = serve(params)
    assert on_card == serve(cpu)


@pytest.mark.parametrize("arch,fused", [("stablelm-3b", False),
                                        ("stablelm-3b", True),
                                        ("llama2-7b", True)])
def test_paged_engine_on_card_matches_engine_on_cpu(card, arch, fused):
    """Chunked prefill (attention_core at each chunk's q_offset), prefix
    hits and decode over the gathered blocks: the same tokens on the card
    as on the CPU, and as the contiguous engine's on the card."""
    cfg = reduced(get_config(arch))
    params = init_lm(card, cfg)
    rng = np.random.default_rng(1)
    prefix = list(map(int, rng.integers(1, cfg.vocab_size, 24)))
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
               for n in (3, 17, 40)]
    prompts += [prefix + list(map(int, rng.integers(1, cfg.vocab_size, 6)))
                for _ in range(3)]

    def serve(p, paged=True):
        kw = dict(block_size=8, chunk_size=16) if paged else {}
        eng = (PagedEngine if paged else Engine)(cfg, p, max_batch=2, max_len=64,
                                                 fused=fused, **kw)
        uids = [eng.add_request(x, max_new_tokens=6) for x in prompts]
        done = {r.uid: r.output for r in eng.run()}
        if paged:
            assert eng.prefix_cache.hit_rate > 0 and eng.extend_chunks > 0
        return [done[u] for u in uids]

    ops.reset_launches()
    on_card = serve(params)
    assert ops.launches["decode_core"] > 0 and ops.launches["attention_core"] > 0
    assert on_card == serve(_to(params, "cpu")) == serve(params, paged=False)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.parametrize("arch,fused", [("bert-base", False), ("bert-base", True),
                                        ("vit-b16", False)])
def test_reduced_encoder_kernel_path_matches_plain_path(card, arch, fused):
    cfg = reduced(get_config(arch))
    params = init_lm(card, cfg)
    if cfg.input_mode == "tokens":
        x = torch.randint(0, cfg.vocab_size, (2, 37), generator=card,
                          device="cuda")
    else:
        x = _randn(card, (2, 37, cfg.d_model), torch.float32)
    with nn.backend("torch"), nn.fuse(fused):
        want = lm_forward(params, x, cfg)
    ops.reset_launches()
    with nn.fuse(fused):
        got = lm_forward(params, x, cfg)
    assert ops.launches["attention_full"] == cfg.n_layers
    assert ops.launches["attention_core"] == 0
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["vit-b16-cls", "detector-vit-s"])
def test_reduced_vision_kernel_path_matches_plain_path(card, arch):
    cfg = reduced(get_config(arch))
    params = init_vision(card, cfg)
    imgs = _randn(card, (2, 3, cfg.image_size, cfg.image_size), torch.float32)
    with nn.backend("torch"):
        want = vision_forward(params, imgs, cfg)
    ops.reset_launches()
    got = vision_forward(params, imgs, cfg)
    assert ops.launches["attention_full"] == cfg.n_layers + cfg.is_detector
    assert ops.launches["nms"] == (2 if cfg.is_detector else 0)
    if not cfg.is_detector:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        return
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    boxes, scores, keep = got
    for i in range(2):      # the kernel against the plain NMS, same boxes
        assert torch.equal(keep[i], ref.nms(boxes[i].float(), scores[i], 0.5,
                                            cfg.det_score_threshold))


# -- the decode step as a CUDA graph ----------------------------------------

def _graph_serve(cfg, params, prompts, paged, graph, new_tokens=8, **kw):
    """(tokens in prompt order, launches, engine) of one run; max_batch 2
    over 5 prompts, so slots are freed and refilled between replays, and
    8-token blocks, so a sequence takes a new block mid-decode. A cache of
    256 splits decode_core over it: the split kernel's counters are used
    under the graph."""
    E = PagedEngine if paged else Engine
    extra = dict(block_size=8) if paged else {}
    eng = E(cfg, params, max_batch=2, max_len=256, cuda_graph=graph, **extra,
            **kw)
    ops.reset_launches()
    uids = [eng.add_request(p, max_new_tokens=new_tokens) for p in prompts]
    done = {r.uid: r.output for r in eng.run()}
    torch.cuda.synchronize()
    return [done[u] for u in uids], dict(ops.launches), eng


def _graph_prompts(cfg):
    rng = np.random.default_rng(4)
    # 5 + 8 and 7 + 8 tokens cross the first 8-token block while decoding
    return [list(map(int, rng.integers(1, cfg.vocab_size, n)))
            for n in (5, 7, 14, 3, 9)]


def _counters_zero():
    torch.cuda.synchronize()
    return all(not b.any() for b in _build._COUNTERS.values())


@pytest.mark.parametrize("greedy", [True, False])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_decode_graph_gives_the_eager_tokens_on_card(card, paged, fused,
                                                     greedy):
    """The graph replays the eager step's kernels: the same tokens (with
    greedy=False the same draws from the same seed: sampling stays outside
    the graph), the same launches, replays counted, and the kernels'
    counters zero after the replays."""
    cfg = reduced(get_config("stablelm-3b"))
    params = init_lm(card, cfg)
    prompts = _graph_prompts(cfg)
    kw = dict(fused=fused, greedy=greedy, seed=3)
    want, want_launches, eager = _graph_serve(cfg, params, prompts, paged,
                                              False, **kw)
    got, launches, eng = _graph_serve(cfg, params, prompts, paged, True, **kw)
    assert eng.cuda_graph and not eager.cuda_graph
    assert got == want
    assert launches == want_launches
    steps = eng.stats.decode_steps
    assert steps == eager.stats.decode_steps > len(prompts)
    assert launches["decode_core"] == cfg.n_layers * steps
    assert _counters_zero()
    if paged:
        assert eng.allocator.free_blocks + len(eng.prefix_cache) == \
            eng.allocator.num_blocks - 1


def test_decode_graph_counts_each_replay_on_card(card):
    """ops.launches after N more replays: N times the captured record."""
    cfg = reduced(get_config("llama2-7b"))
    params = init_lm(card, cfg)
    eng = Engine(cfg, params, max_batch=2, max_len=256)
    eng.add_request([5, 6, 7], max_new_tokens=3)
    eng.run()                                   # warm-up, capture, replay
    rec = {k: v for k, v in eng._run_step._launches.items() if v}
    assert rec["decode_core"] == cfg.n_layers and rec["rms_norm"] > 0
    ops.reset_launches()
    eng.add_request([8, 9], max_new_tokens=6)   # prefill, then 5 replays
    eng.run()
    assert eng.stats.decode_steps == 2 + 5
    assert ops.launches["decode_core"] == 5 * cfg.n_layers
    assert ops.launches["attention_core"] == cfg.n_layers   # the prefill
    # the eager prefill launches the norms a step does, 2 a layer + 1
    assert rec["rms_norm"] == 2 * cfg.n_layers + 1
    assert ops.launches["rms_norm"] == (1 + 5) * rec["rms_norm"]
    assert _counters_zero()


def test_no_counter_buffer_is_made_under_capture_on_card(card):
    """The warm-up step makes the capture stream's counters; one first
    asked for while a stream is captured raises."""
    cfg = reduced(get_config("llama2-7b"))
    params = init_lm(card, cfg)
    eng = Engine(cfg, params, max_batch=4, max_len=256)
    assert attn.decode_splits(4, cfg.n_kv_heads, 256, _build.sm_count(0)) > 1
    eng.add_request(list(range(1, 40)), max_new_tokens=3)
    eng.run()
    stream = eng._run_step._stream.cuda_stream
    assert (torch.device("cuda", 0), stream) in _build._COUNTERS
    unseen = max(k[1] for k in _build._COUNTERS) + 1
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    with pytest.raises(RuntimeError, match="captured"):
        with torch.cuda.graph(graph, stream=side):
            _build.counters(torch.device("cuda", 0), unseen, 8)
    assert (torch.device("cuda", 0), unseen) not in _build._COUNTERS
    assert _counters_zero()


@pytest.mark.parametrize("paged", [False, True])
def test_deleting_a_graph_engine_frees_its_memory_on_card(card, paged):
    cfg = reduced(get_config("stablelm-3b"))
    params = init_lm(card, cfg)
    prompts = _graph_prompts(cfg)
    _graph_serve(cfg, params, prompts, paged, True)  # the capture stream's state
    gc.collect()
    before = torch.cuda.memory_allocated()
    _, _, eng = _graph_serve(cfg, params, prompts, paged, True)
    held = torch.cuda.memory_allocated() - before
    del eng
    gc.collect()
    assert held > 0
    assert torch.cuda.memory_allocated() - before <= 1 << 20, held


def test_decode_step_reads_nothing_on_the_host_on_card(card):
    """One eager step of each engine's step under
    set_sync_debug_mode("error"): nothing waits for the card."""
    from repro_torch.models import init_lm_cache
    from repro_torch.serving import make_paged_decode_step, make_serve_step
    cfg = reduced(get_config("stablelm-3b"))
    params = init_lm(card, cfg)
    token = torch.tensor([3, 4], device="cuda")
    pos = torch.tensor([5, 9], dtype=torch.int32, device="cuda")
    caches = init_lm_cache(cfg, 2, 64, device="cuda")
    pools = init_lm_cache(cfg, 17, 8, device="cuda")
    tables = torch.arange(1, 17, dtype=torch.int32, device="cuda").reshape(2, 8)
    steps = [lambda f: make_serve_step(cfg, fused=f)(params, token, pos, caches),
             lambda f: make_paged_decode_step(cfg, 64, fused=f)(
                 params, token, pos, pools, tables)]
    for step in steps:
        for fused in (False, True):
            step(fused)                         # kernels built, counters made
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                with nn.debug_bounds():
                    step(fused)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_decode_graph_under_debug_bounds_on_card(card):
    """The paged ops' device-side bound checks (torch._assert_async)
    capture: the graph under debug_bounds gives the eager tokens. A replay
    under other switches than the capture's raises."""
    cfg = reduced(get_config("stablelm-3b"))
    params = init_lm(card, cfg)
    prompts = _graph_prompts(cfg)
    with nn.debug_bounds():
        want, _, _ = _graph_serve(cfg, params, prompts, True, False)
        got, _, eng = _graph_serve(cfg, params, prompts, True, True)
    assert got == want
    eng.add_request(prompts[0], max_new_tokens=4)
    with pytest.raises(RuntimeError, match="debug_bounds"):
        eng.run()


@pytest.mark.parametrize("fused", [False, True])
def test_decode_graph_replays_the_eager_logits_bit_for_bit_on_card(card, fused):
    """One step's logits: the graph's replay against its warm-up (the eager
    step) on the same inputs and cache, bit for bit."""
    from repro_torch.models import init_lm_cache
    from repro_torch.serving import make_serve_step
    from repro_torch.serving.cuda_graph import StepGraph
    cfg = reduced(get_config("llama2-7b"))
    params = init_lm(card, cfg)
    caches = init_lm_cache(cfg, 4, 256, device="cuda")
    for c in caches:
        for t in c.values():
            t.copy_(torch.randn(t.shape, generator=card, device="cuda"))
    step = make_serve_step(cfg, greedy=False, fused=fused)
    inputs = [np.array([3, 5, 7, 9], np.int64),
              np.array([200, 17, 0, 255], np.int32)]
    graph = StepGraph(lambda t, p: step(params, t, p, caches)[0], inputs,
                      torch.device("cuda", 0))
    eager = graph(*inputs).clone()
    assert torch.equal(graph(*inputs), eager)
    assert torch.equal(graph(*inputs), eager)


# ---------------------------------------------------------------------------
# the profiling API on the card
# ---------------------------------------------------------------------------

def _per_forward(cfg, fused):
    """Kernel launches of one reduced ``lm_forward`` on the kernel path
    (no qk-norm or post-norm in these configs); QDQ changes none."""
    n = cfg.n_layers
    out = {"attention_core": n}
    if cfg.norm == "rmsnorm":
        out.update(rms_norm=n * (2 - fused) + 1, swiglu=n)
        if fused:
            out.update(fused_add_rms_norm=n, rope=2 * n)
    else:
        out["layer_norm"] = n + 1 if fused else 2 * n + 1
        if fused:
            out["fused_add_layer_norm"] = n
    return out


@pytest.mark.parametrize("arch", ["llama2-7b", "gpt2-xl"])
def test_measured_2x2_through_the_api_on_card(card, arch):
    from repro_torch.core import (FusionTransform, QuantizeDequantTransform,
                                  Workload, drift_by_group, max_abs_log2_drift)

    base = Workload(name=arch, arch=arch, batch=1, seq=16, dtype="bfloat16")
    cfg = reduced(get_config(arch))
    for mode, fused in ((None, False), (None, True), ("int8", False),
                        ("int8", True)):
        w = base.with_transform(
            *([QuantizeDequantTransform(mode)] if mode else []),
            *([FusionTransform()] if fused else []))
        ops.reset_launches()
        wall = w.profile("wallclock", repeats=3)
        assert {k: v for k, v in ops.launches.items() if v} == \
            {k: 4 * v for k, v in _per_forward(cfg, fused).items()}, w.variant
        assert wall.total_seconds > 0
        prof = w.profile("measured")
        assert prof.mode == "measured_cuda" and prof.split["gemm_s"] > 0
        quant = prof.group_seconds.get("quantization", 0.0) + \
            prof.op_seconds.get(("fused", "fused_qdq"), 0.0)
        assert (quant > 0) == (mode is not None), w.variant
        modeled = w.profile("eager-modeled:h100")
        assert modeled.mode == "eager_h100" and modeled.n_ops > 0
        drift = drift_by_group(prof.group_seconds, modeled.group_seconds)
        assert drift and max_abs_log2_drift(drift) > 0
        # the capture runs on the card: its records say so
        assert {t.record.device for t in prof.timed_ops} == {"cuda"}


def test_calibrated_backend_fits_on_card(card):
    from repro_torch.core import Workload, get_backend

    b = get_backend("calibrated")
    assert b.name == "calibrated:h100"
    assert {g for g, _ in b.cal.factors} >= {"normalization", "activation",
                                             "elementwise"}
    assert all(f > 0 for _, f in b.cal.factors)
    p = Workload(name="g", arch="gpt2-xl", dtype="bfloat16").profile(b)
    assert p.mode == "calibrated_h100" and p.total_seconds > 0


def test_timer_flush_leaves_clean_lines_on_card(card):
    """Before each timed run the flush zeroes its 128 MB and then reads
    them (so the L2 holds clean lines); a read-only kernel timed after it
    is not slower than after a flush that only zeroes (dirty lines, each
    written back as the kernel's reads evict it)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.core import graph

    x = torch.randn(8 << 20, device="cuda")         # 32 MB, under the L2
    timer = graph.Timer(iters=4, warmup=1)
    seen = []

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    with Spy():
        timer(lambda: torch.amax(x))
    assert seen[:1] == ["aten.amax"]                  # the warm-up
    assert seen[1:] == ["aten.zero_", "aten.sum", "aten.amax"] * 4

    class Dirty(graph.Timer):
        def __call__(self, fn):
            import statistics
            for _ in range(self.warmup):
                fn()
            ts = []
            for _ in range(self.iters):
                self.flush.zero_()
                ts.append(graph.time_once(fn, (), {}, self.floor)[1])
            return statistics.median(ts) * 1e3

    clean, dirty = graph.Timer(iters=50), Dirty(iters=50)
    c1, d1, d2, c2 = (t(lambda: torch.amax(x)) for t in (clean, dirty, dirty,
                                                         clean))
    assert min(c1, c2) <= max(d1, d2), (c1, c2, d1, d2)


def test_bench_section_timeout_drains_the_card_on_card(card):
    """A section cut by its deadline while the card still has its work
    queued comes back ``timeout``; the runner waits for that work, so the
    next section starts on an idle card and runs."""
    from repro_torch.bench.runner import BenchContext, Section, run_section

    ctx = BenchContext(tier="quick", cases=[], device="cuda")
    x = torch.randn((4096, 4096), generator=card, device="cuda")

    def slow(c):
        for _ in range(100_000):         # ~2 ms each: far past the deadline
            torch.mm(x, x)
        return []

    r = run_section(Section(name="s", title="t", fn=slow, timeout_s=0.5), ctx)
    assert r.status == "timeout" and r.rows == []
    y = x[:2, :2].clone()
    nxt = run_section(Section(name="n", title="t",
                              fn=lambda c: [{"sum": float((y * 2).sum())}]),
                      ctx)
    assert nxt.status == "ok" and nxt.wall_s < 0.5
    assert nxt.rows[0]["sum"] == float(y.sum() * 2)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("cap", [50.0, 5.0])
def test_softcap_kernels_match_plain(card, dt, cap):
    """The capped instantiations of the three masks and decode against
    their capped plain versions, one launch each; a window row past the
    keys and a decode length of 0 leave exact zeros."""
    q = _randn(card, (1, 64, 4, 64), dt, 4.0)
    k, v = _randn(card, (1, 40, 2, 64), dt), _randn(card, (1, 40, 2, 64), dt)
    for name, got, want in (
            ("attention_core", lambda: ops.attention_core(q, k, v, softcap=cap),
             ref.attention(q, k, v, softcap=cap)),
            ("attention_window",
             lambda: ops.attention_window(q, k, v, 8, softcap=cap),
             ref.attention(q, k, v, window=8, softcap=cap)),
            ("attention_full", lambda: ops.attention_full(q, k, v, softcap=cap),
             ref.attention(q, k, v, causal=False, softcap=cap))):
        out = _launched(name, got)
        _assert_close(out, want, dt)
        dead = want.float().abs().amax(-1) == 0
        assert not out[dead].float().any()
    q1 = _randn(card, (3, 1, 8, 80), dt, 4.0)
    k1, v1 = _randn(card, (3, 512, 2, 80), dt), _randn(card, (3, 512, 2, 80), dt)
    n = torch.tensor([512, 0, 77], dtype=torch.int32, device="cuda")
    out = _launched("decode_core", lambda: ops.decode_core(q1, k1, v1, n,
                                                           softcap=cap))
    _assert_close(out, ref.decode_attention(q1, k1, v1, n, softcap=cap).to(dt),
                  dt)
    assert not out[1].float().any()


def test_softcap_wide_instantiations_refuse(card):
    """MLA's and recurrentgemma's wide instantiations take no cap: the
    wrappers raise naming it, and the capped C entries refuse the dims."""
    from repro_torch.kernels import attn_template as at
    q, v = _randn(card, (1, 4, 2, 192), torch.bfloat16), \
        _randn(card, (1, 4, 2, 128), torch.bfloat16)
    with pytest.raises(ValueError, match="softcap"):
        ops.attention_core(q, q, v, softcap=50.0)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        at.attention_core(q, q, v, 0, 1.0, softcap=50.0)
    q = _randn(card, (4, 1, 10, 256), torch.bfloat16)
    kv = _randn(card, (4, 64, 1, 256), torch.bfloat16)
    n = torch.full((4,), 64, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="softcap"):
        ops.decode_core(q, kv, kv, n, softcap=50.0)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        at.decode_core(q, kv, kv, n, 1.0, softcap=50.0)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_compiled_reduced_llama_on_card(card, fused):
    """The compiled view's forward on the card (``core/compiled.py``): a
    reduced llama2-7b through ``torch.compile``, its hand-written kernels
    opaque calls inside the program, gives the eager kernel path's logits
    (f32), and the launch counters count once per call: the compiling call
    (tracing launches nothing, then the program runs once) counts the eager
    forward's launches, and each later call as many again."""
    from repro_torch.core import compiled as C

    cfg = reduced(get_config("llama2-7b")).replace(n_layers=2)
    params = init_lm(card, cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=card,
                         device="cuda")

    def fwd(p, t):
        return lm_forward(p, t, cfg)

    with nn.fuse(fused):
        ops.reset_launches()
        want = fwd(params, toks)
        torch.cuda.synchronize()
        eager = {k: n for k, n in ops.launches.items() if n}
        ops.reset_launches()
        cf = C.compile_forward(fwd, params, toks)
        torch.cuda.synchronize()
        assert {k: n for k, n in ops.launches.items() if n} == eager
        ops.reset_launches()
        with torch._dynamo.config.patch(error_on_recompile=True):
            for _ in range(3):
                got = cf(params, toks)
        torch.cuda.synchronize()
    assert {k: n for k, n in ops.launches.items() if n} == \
        {k: 3 * n for k, n in eager.items()}
    assert set(eager) >= {"rms_norm", "swiglu", "attention_core"}
    _assert_close(got, want, torch.float32)
    _assert_close(cf.output, want, torch.float32)
    # the profiled call holds each hand-written kernel once a launch
    with nn.fuse(fused):
        p = C.measure(cf, fwd, (params, toks), name="llama", device="cuda",
                      repeats=2)
    assert p.mode == "compiled_cuda" and p.total_seconds > 0
    assert {k.split("::", 1)[1]: n for k, n in p.compiled["launches"].items()
            if k.startswith("repro_torch::")} == eager
    assert not [k for g, k in p.op_seconds if g == "other"]


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_tp_paged_engine_on_card(card, fused):
    """The tensor-parallel PagedEngine in 2 spawned ranks time-sharing the
    card (gloo): the reduced sharded config's tokens at tp 2 equal the
    one-device engine's, cold and through a prefix hit, and every rank
    launches the kernels the one-device engine does."""
    from repro_torch.launch import sharded_serving as S

    cfg = S.sharded_config()
    job = S.Job(cfg, 0, (1, 2),
                (S.Run("cold", (S.prompts(cfg, 6, 4, 20),)),
                 S.Run("prefix", S.prefix_waves(cfg),
                       engine=(("chunk_size", 8),))),
                engine=S.Job.engine + (("fused", fused),))
    ranks = S.run_jobs([job], "cuda", world=2, timeout_s=300.0)
    one, two = ranks[0][0][1], ranks[0][0][2]
    for run in ("cold", "prefix"):
        assert two["runs"][run]["tokens"] == one["runs"][run]["tokens"]
    assert one["runs"]["prefix"]["hits"] and two["runs"]["prefix"]["hits"]
    for rank in (0, 1):
        got = ranks[rank][0][2]["launches"]
        assert got == one["launches"] and got["decode_core"] > 0


def test_ng010_clean_on_card(card):
    """NG010's one-rank gloo group over CUDA tensors."""
    from repro_torch.analysis.rules import get_rule, run_static_rules

    assert run_static_rules(rules=[get_rule("NG010")]) == []


# ---------------------------------------------------------------------------
# the training pair: the lse forward and the flash backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [(2, 97, 97, 8, 1, 64, "causal", 1, 0),
                                  (1, 130, 200, 8, 2, 128, "causal", 1, 70),
                                  (2, 77, 77, 4, 4, 80, "window", 16, 0),
                                  (1, 33, 90, 4, 2, 64, "full", 1, 0),
                                  (1, 20, 40, 4, 2, 64, "window", 4, 60)])
@pytest.mark.parametrize("dt", DTYPES)
def test_attention_lse_and_bwd_on_card(card, case, dt):
    """The lse forward and attention_bwd against their plain twins, one
    launch each counted, two backward launches bit-identical; the last
    case's rows see no key: zeros, NEG_INF and zero gradients."""
    b, sq, skv, hq, hkv, d, mask, w, off = case
    q, do = _randn(card, (b, sq, hq, d), dt), _randn(card, (b, sq, hq, d), dt)
    k, v = _randn(card, (b, skv, hkv, d), dt), _randn(card, (b, skv, hkv, d), dt)
    kw = dict(causal=mask != "full", window=w if mask == "window" else None,
              q_offset=off)
    out, lse = _launched("attention_lse",
                         lambda: ops.attention_with_lse(q, k, v, mask, w, off))
    p_out, p_lse = ref.attention_fwd_lse(q, k, v, **kw)
    _assert_close(out, p_out, dt)
    torch.testing.assert_close(lse, p_lse, atol=TOL[dt][0], rtol=1e-5)
    grads = _launched("attention_bwd", lambda: ops.attention_bwd(
        q, k, v, out, lse, do, mask, w, off))
    again = ops.attention_bwd(q, k, v, out, lse, do, mask, w, off)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))
    for got, want in zip(grads, ref.attention_bwd(q, k, v, out, lse, do, **kw)):
        # atol scaled by the gradient's RMS, as phase 2's (chip_smoke.py)
        scale = float(want.float().square().mean().sqrt())
        atol, rtol = TOL[dt]
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=atol * scale, rtol=rtol)
        assert torch.isfinite(got.float()).all()
    if off >= skv + w - 1 and mask == "window":
        assert not out.float().any() and not any(g.float().any() for g in grads)


@pytest.mark.parametrize("bad", ["head_256", "softcap"])
def test_attention_bwd_refuses_on_card(card, bad):
    q = _randn(card, (1, 8, 2, 256 if bad == "head_256" else 64),
               torch.bfloat16).requires_grad_(True)
    k, v = (_randn(card, (1, 8, 1, q.shape[-1]), torch.bfloat16)
            for _ in range(2))
    with pytest.raises(ValueError):
        if bad == "head_256":
            ops.attention_window(q, k, v, 4)
        else:
            ops.attention_core(q, k, v, softcap=20.0)


def test_reduced_train_step_kernel_path_on_card(card):
    """A reduced granite-3-8b train step on the card's kernel path against
    the plain path, bf16 working copy over f32 masters: the loss within
    2^-7 relative and every leaf's gradient within 2^-5 of its largest."""
    from repro_torch.models import lm_loss
    from repro_torch.optim import tree_leaves
    from repro_torch.runtime import cast_params, value_and_grad

    cfg = reduced(get_config("granite-3-8b")).replace(
        n_kv_heads=2, dtype="bfloat16", remat=True, remat_policy="proj",
        loss_chunk=16)
    params = init_lm(torch.Generator("cuda").manual_seed(0), cfg)
    x = torch.randint(0, cfg.vocab_size, (2, 64), generator=card,
                      device="cuda")
    batch = {"inputs": x, "labels": x.roll(-1, 1)}
    fn = value_and_grad(lambda p, b: lm_loss(cast_params(p, torch.bfloat16),
                                             b, cfg))
    ops.reset_launches()
    (lk, _), gk = fn(params, batch)
    assert ops.launches["attention_bwd"] == cfg.n_layers
    with nn.backend("torch"):
        (lp, _), gp = fn(params, batch)
    assert float(lk) == pytest.approx(float(lp), rel=2 ** -7)
    for a, b in zip(tree_leaves(gk), tree_leaves(gp)):
        assert float((a - b).abs().max()) <= 2 ** -5 * float(b.abs().max())
