"""Kernel-on-card tests: each hand-written kernel against its plain PyTorch
version on an NVIDIA GPU, and the reduced model's kernel path against its
plain path. Marked ``cuda``; each test skips where torch sees no card.

On the card (where jax, which tests/conftest.py imports, may be absent):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

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
