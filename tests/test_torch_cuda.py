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
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import init_lm, lm_forward  # noqa: E402
from repro_torch.models.vision import init_vision, vision_forward  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402

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


@pytest.mark.parametrize("shape", [(4, 1, 11008), (2, 37, 257), (1, 13)])
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


@pytest.mark.parametrize("shape", [(4, 1, 21504), (2, 37, 257), (1, 13), (1, 1)])
@pytest.mark.parametrize("dt", DTYPES)
def test_geglu_on_card(card, shape, dt):
    g, u = _randn(card, shape, dt, 3.0), _randn(card, shape, dt)
    got = _launched("geglu", lambda: ops.geglu(g, u))
    _assert_close(got, ref.geglu(g, u), dt)


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


@pytest.mark.parametrize("case", [(4, 1, 32, 128, 1.0, [[186], [144], [120], [72]]),
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


@pytest.mark.parametrize("rows,vocab", [(7, 1000), (32, 50304), (3, 130),
                                        (256, 32000), (2, 262144), (1, 1),
                                        (5, 4099)])
@pytest.mark.parametrize("dt", DTYPES)
def test_softmax_xent_on_card(card, rows, vocab, dt):
    logits = _randn(card, (rows, vocab), dt, 5.0)
    labels = torch.randint(0, vocab, (rows,), generator=card, device="cuda",
                           dtype=torch.int32)
    got = _launched("softmax_xent", lambda: ops.softmax_xent(logits, labels))
    # f32 out on both sides, from the same logits: JAX's sweep tolerance
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (rows,)
    torch.testing.assert_close(got, ref.softmax_xent(logits, labels),
                               atol=1e-5, rtol=1e-5)


def test_softmax_xent_label_outside_the_vocab_picks_nothing(card):
    logits = _randn(card, (4, 1000), torch.float32, 5.0)
    labels = torch.tensor([-1, 1000, 1023, 3], device="cuda")
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
