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
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import init_lm, lm_forward  # noqa: E402
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
                                  (1, 21, 21, 2, 2, 34, 18, 0)])  # scalar staging
@pytest.mark.parametrize("dt", DTYPES)
def test_attention_core_on_card(card, case, dt):
    b, sq, skv, hq, hkv, dk, dv, off = case
    q = _randn(card, (b, sq, hq, dk), dt)
    k, v = _randn(card, (b, skv, hkv, dk), dt), _randn(card, (b, skv, hkv, dv), dt)
    got = _launched("attention_core",
                    lambda: ops.attention_core(q, k, v, q_offset=off))
    _assert_close(got, ref.attention(q, k, v, q_offset=off), dt)


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


def test_kernels_raise_above_what_they_take(card):
    q = _randn(card, (1, 4, 2, 192), torch.float32)
    with pytest.raises(ValueError, match="head dims"):
        ops.attention_core(q, q, q)
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


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)
