"""The arithmetic of the card's attention kernels, held against the JAX
package on the CPU.

``csrc/attention.cu``'s bf16 body runs both products on the tensor cores
and feeds P to P.V as two bf16 terms, where the TPU body multiplies f32 P;
``csrc/decode.cu`` splits each row's cache over several CTAs and merges
their partial softmaxes in a combine pass. Neither runs here, so each is
emulated in plain torch, step for step, and held against the JAX kernels
in interpret mode and against the port's plain versions, on the same
numpy inputs. The tolerances are those ``chip_smoke.py`` holds the
kernels to on the card.
"""

import math
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import attn_template as T  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import attn_template as attn  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

NEG_INF = -1e30
LOG2E = 1.4426950408889634
#: chip_smoke.py's bf16 rule, |kernel - plain| <= atol + rtol * |plain|
BF16_ATOL, BF16_RTOL = 3e-2, 2 ** -7
#: the bf16 rule must hold this many times over for the rounding of P
MARGIN = 4.0
#: tests/test_kernels.py's ATOL, as tests/test_torch_kernels.py
ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(rng, shape, dt):
    a = rng.standard_normal(shape).astype(np.float32)
    return (jnp.asarray(a).astype(JAX_DT[dt]),
            torch.from_numpy(a).to(TORCH_DT[dt]))


def emulate_mma_attention(q, k, v, *, q_offset=0, causal=True, window=None,
                          scale=None, tile=64, p_terms=2):
    """The bf16 body of ``csrc/attention.cu`` in plain torch, in f32 (its
    output before the last rounding): 64-key tiles; S = Q K^T in f32 from
    the bf16 operands (their products are exact in f32), scaled into log2
    units and masked to the finite NEG_INF; the online max and rescale;
    P = 2^(S - m) fed to the f32-accumulated P V as ``p_terms`` bf16 terms
    (2: the kernel's head plus the bf16 of the remainder; 1: P rounded to
    bf16), and l the sum of the values the terms hold; a row that saw no
    key gives zeros."""
    b, sq, hq, dk = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    g = hq // hkv
    c = (1.0 / math.sqrt(dk) if scale is None else scale) * LOG2E
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    m = torch.full((b, hq, sq, 1), NEG_INF)
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, dv))
    qpos = q_offset + torch.arange(sq)[:, None]
    for k0 in range(0, skv, tile):
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        s = (qf @ kt.transpose(-1, -2)) * c
        kpos = k0 + torch.arange(kt.shape[2])[None, :]
        vis = torch.ones((sq, kt.shape[2]), dtype=torch.bool)
        if causal:
            vis &= kpos <= qpos
        if window is not None:
            vis &= qpos - kpos < window
        s = torch.where(vis, s, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        terms = [p.to(torch.bfloat16).float()]
        if p_terms == 2:
            terms.append((p - terms[0]).to(torch.bfloat16).float())
        l = l * corr + sum(terms).sum(-1, keepdim=True)
        acc = acc * corr
        for term in terms:
            acc = acc + term @ vt
        m = m_new
    out = torch.where(m > NEG_INF * 0.5, acc / l.clamp_min(1e-30),
                      torch.zeros(()))
    return out.permute(0, 2, 1, 3)


def _within_rule(got, want, atol, margin):
    """The largest |got - want| / (atol + rtol |want|), over margin: <= 1
    passes the bf16 rule ``margin`` times over."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    lim = (atol + BF16_RTOL * np.abs(want)) / margin
    return float((np.abs(got - want) / lim).max())


# (B, Sq, Skv, Hq, Hkv, Dk, Dv, q_offset, mask, window): phase 2's cases,
# reduced
MMA_CASES = [
    (1, 256, 256, 4, 4, 128, 128, 0, "causal", None),   # llama prefill bucket
    (2, 37, 37, 4, 4, 64, 64, 0, "causal", None),       # seq 37
    (1, 100, 100, 8, 2, 128, 128, 0, "causal", None),   # GQA 8/2
    (2, 35, 35, 4, 4, 48, 16, 0, "causal", None),       # Dv != Dk
    (1, 13, 40, 4, 2, 32, 32, 27, "causal", None),      # q_offset
    (1, 100, 300, 4, 2, 80, 80, 200, "causal", None),   # q_offset, Sq < Skv
    (1, 21, 21, 2, 2, 34, 18, 0, "causal", None),       # pads 34 -> 48, 18 -> 32
    (1, 1, 70, 4, 4, 96, 96, 69, "causal", None),       # Sq = 1, head 96
    (1, 512, 512, 4, 2, 128, 128, 0, "window", 256),    # gemma3's window, halved
    (2, 197, 197, 4, 2, 64, 64, 0, "window", 1),
    (2, 197, 197, 4, 4, 64, 64, 0, "window", 63),
    (2, 197, 197, 4, 2, 64, 64, 0, "window", 65),
    (1, 13, 140, 4, 2, 64, 64, 127, "window", 70),
    (1, 197, 197, 4, 4, 64, 64, 0, "full", None),       # the vit-b16 stub
    (1, 64, 256, 2, 2, 64, 64, 0, "full", None),        # refinement, Sq != Skv
    (1, 37, 301, 4, 2, 64, 32, 0, "full", None),        # GQA, Dv != Dk, odd
]


def _jax_attention(qj, kj, vj, mask, q_offset, window):
    if mask == "causal":
        return T.get("causal")(qj, kj, vj, q_offset=q_offset, block_q=32,
                               block_k=32, interpret=True)
    if mask == "window":
        return jops.flash_attention(qj, kj, vj, window=window,
                                    q_offset=q_offset, block_q=32,
                                    block_k=32, interpret=True)
    return T.get("full")(qj, kj, vj, interpret=True)


def _case_inputs(case, seed=16):
    b, sq, skv, hq, hkv, dk, dv, off, mask, window = case
    rng = np.random.default_rng(seed)
    qj, qt = _pair(rng, (b, sq, hq, dk), "bfloat16")
    kj, kt = _pair(rng, (b, skv, hkv, dk), "bfloat16")
    vj, vt = _pair(rng, (b, skv, hkv, dv), "bfloat16")
    plain = ref.attention(qt.float(), kt.float(), vt.float(), q_offset=off,
                          causal=mask != "full", window=window)
    atol = BF16_ATOL
    if mask == "window":
        atol *= min(1.0, float(plain.square().mean().sqrt()))
    return (qj, kj, vj), (qt, kt, vt), plain, atol


@pytest.mark.parametrize("case", MMA_CASES, ids=lambda c: "-".join(map(str, c)))
def test_mma_body_keeps_the_rule_four_times_over(case):
    """The bf16 body's arithmetic uses less than a quarter of chip_smoke's
    bf16 rule: the emulated body against the plain version and the JAX
    kernel, both in f32 on the same bf16 values (the window's atol scaled
    by the plain output's RMS where below 1, as chip_smoke scales it);
    and, rounded to bf16, against the JAX kernel in bf16 at the rule."""
    b, sq, skv, hq, hkv, dk, dv, off, mask, window = case
    (qj, kj, vj), (qt, kt, vt), plain, atol = _case_inputs(case)
    emu = emulate_mma_attention(qt, kt, vt, q_offset=off,
                                causal=mask != "full", window=window)
    assert emu.shape == (b, sq, hq, dv)
    jax32 = _jax_attention(qj.astype(jnp.float32), kj.astype(jnp.float32),
                           vj.astype(jnp.float32), mask, off, window)
    for name, want in (("plain", plain.numpy()), ("jax f32", jax32)):
        worst = _within_rule(emu.numpy(), want, atol, MARGIN)
        assert worst <= 1.0, f"{name}: {worst:.3f} of the rule / {MARGIN}"
    jax16 = _jax_attention(qj, kj, vj, mask, off, window)
    assert _within_rule(emu.to(torch.bfloat16).float().numpy(),
                        np.asarray(jax16, np.float32), atol, 1.0) <= 1.0


@pytest.mark.parametrize("case", [c for c in MMA_CASES if c[8] == "window"
                                  and c[9] > 64 and c[1] > 100],
                         ids=lambda c: "-".join(map(str, c)))
def test_bf16_p_alone_would_miss_the_margin(case):
    """Why the body feeds P as two bf16 terms: P rounded once to bf16 (2^-9
    of each weight) holds the window's RMS-scaled rule, but not four times
    over, on the prefills whose windows are longer than a tile."""
    _, (qt, kt, vt), plain, atol = _case_inputs(case)
    one = emulate_mma_attention(qt, kt, vt, q_offset=case[7], window=case[9],
                                p_terms=1)
    worst = _within_rule(one.numpy(), plain.numpy(), atol, 1.0)
    assert 1.0 / MARGIN < worst <= 1.0, worst


def test_row_that_sees_no_key_is_zero():
    """A window past every key and Skv 0 leave exact zeros, as the body's
    guarded epilogue emits them."""
    rng = np.random.default_rng(17)
    _, q = _pair(rng, (1, 5, 2, 32), "bfloat16")
    _, k = _pair(rng, (1, 0, 2, 32), "bfloat16")
    assert not emulate_mma_attention(q, k, k, causal=False).any()


def emulate_split_decode(q, k, v, lengths, n_split, chunk, scale=None,
                         tile=64, rescale=True):
    """``csrc/decode.cu`` in plain torch, in f32: split s of row b runs the
    online softmax over 64-key tiles of keys [s*C, min((s+1)*C, len)) into a
    partial (m, l, acc); a split past len runs nothing. The combine takes
    m = max m_s, l = sum l_s e^(m_s - m), o = sum acc_s e^(m_s - m) / l, and
    zeros where no split saw a key. ``rescale=False`` is the
    decode_combine_no_rescale mutant: acc_s added without e^(m_s - m)."""
    b, _, hq, dk = q.shape
    t, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    g = hq // hkv
    scale = 1.0 / math.sqrt(dk) if scale is None else scale
    qf = q.float().reshape(b, hkv, g, dk)
    kf, vf = k.float(), v.float()
    out = torch.zeros((b, hkv, g, dv))
    for bi in range(b):
        n = min(max(int(lengths[bi]), 0), t)
        parts = []
        for s in range(n_split):
            begin, end = s * chunk, min(n, (s + 1) * chunk)
            if begin >= end:
                continue
            m = torch.full((hkv, g, 1), NEG_INF)
            l = torch.zeros((hkv, g, 1))
            acc = torch.zeros((hkv, g, dv))
            for k0 in range(begin, end, tile):
                kt = kf[bi, k0:min(k0 + tile, end)]
                vt = vf[bi, k0:min(k0 + tile, end)]
                sc = torch.einsum("hgd,nhd->hgn", qf[bi], kt) * scale
                m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                p = torch.exp(sc - m_new)
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + torch.einsum("hgn,nhd->hgd", p, vt)
                m = m_new
            parts.append((m, l, acc))
        if parts:
            mm = torch.stack([p[0] for p in parts]).amax(0)
            w = [torch.exp(p[0] - mm) for p in parts]
            ll = sum(wi * p[1] for wi, p in zip(w, parts))
            aa = sum((wi if rescale else 1.0) * p[2] for wi, p in zip(w, parts))
            out[bi] = aa / ll.clamp_min(1e-30)
    return out.reshape(b, 1, hq, dv)


# (B, T, Hq, Hkv, D, SMs): the SM count sets the split; 64- and 128-key
# chunks, and one split where B*Hkv fills the SMs
DECODE_CASES = [(5, 320, 4, 2, 32, 132), (5, 512, 4, 2, 32, 16),
                (4, 320, 8, 2, 32, 8), (6, 200, 8, 1, 32, 132)]


def _lengths(t, chunk, b):
    """0, 1, a split boundary, one past it, T, then T again."""
    return np.array(([0, 1, chunk, chunk + 1, t] + [t] * b)[:b], np.int32)


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_split_decode_matches_jax(case, dt):
    b, t, hq, hkv, d, sms = case
    n_split = attn.decode_splits(b, hkv, t, sms)
    chunk = attn.decode_chunk(t, n_split)
    rng = np.random.default_rng(18)
    qj, qt = _pair(rng, (b, 1, hq, d), dt)
    kj, kt = _pair(rng, (b, t, hkv, d), dt)
    vj, vt = _pair(rng, (b, t, hkv, d), dt)
    lengths = _lengths(t, chunk, b)
    emu = emulate_split_decode(qt, kt, vt, lengths, n_split, chunk)
    want = jops.attn_decode_template(qj, kj, vj, jnp.asarray(lengths),
                                     interpret=True)
    plain = ref.decode_attention(qt, kt, vt, torch.from_numpy(lengths))
    if dt == "float32":
        for w in (np.asarray(want), plain.numpy()):
            np.testing.assert_allclose(emu.numpy(), w, rtol=0, atol=1e-6)
    else:
        got = emu.to(torch.bfloat16).float().numpy()
        for w in (np.asarray(want, np.float32), plain.float().numpy()):
            np.testing.assert_allclose(got, w, rtol=0, atol=ATOL[dt])
    assert not emu[0].any(), "lengths 0 must give exact zeros"


@pytest.mark.parametrize("case", [c for c in DECODE_CASES
                                  if attn.decode_splits(c[0], c[3], c[1], c[5]) > 1],
                         ids=lambda c: "-".join(map(str, c)))
def test_combine_without_rescale_is_caught(case):
    """The decode_combine_no_rescale mutant, emulated: on the rows whose
    keys span splits it misses the f32 limit by orders of magnitude."""
    b, t, hq, hkv, d, sms = case
    n_split = attn.decode_splits(b, hkv, t, sms)
    chunk = attn.decode_chunk(t, n_split)
    assert n_split > 1
    rng = np.random.default_rng(19)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((b, 1, hq, d), (b, t, hkv, d), (b, t, hkv, d)))
    lengths = _lengths(t, chunk, b)
    bad = emulate_split_decode(q, k, v, lengths, n_split, chunk, rescale=False)
    plain = ref.decode_attention(q, k, v, torch.from_numpy(lengths))
    assert float((bad - plain).abs().max()) > 1e-3


@pytest.mark.parametrize("b,hkv", [(1, 1), (1, 8), (4, 16), (4, 32), (8, 16),
                                   (33, 4), (64, 4)])
@pytest.mark.parametrize("t", [0, 1, 63, 64, 65, 512, 1024, 2048, 4096, 4097])
@pytest.mark.parametrize("sms", [1, 8, 132])
def test_decode_splits_properties(b, hkv, t, sms):
    n = attn.decode_splits(b, hkv, t, sms)
    chunk = attn.decode_chunk(t, n)
    tiles = -(-t // attn.DECODE_TILE)
    assert isinstance(n, int) and n >= 1
    if b * hkv >= sms or tiles <= 1:
        assert n == 1
    assert n <= max(1, tiles)
    assert chunk % attn.DECODE_TILE == 0 and chunk > 0
    assert n * chunk >= t                        # the splits cover the cache
    assert t == 0 or -(-t // chunk) == n         # and none is left empty
    assert (n - 1) * b * hkv < attn.DECODE_CTAS_PER_SM * sms or n == 1


def test_decode_splits_reads_no_tensor():
    """Shapes and an SM count in, a split count out: with every host read
    of a tensor made to raise, the plan is computed all the same."""
    boom = mock.Mock(side_effect=AssertionError("host read of a tensor"))
    with mock.patch.multiple(torch.Tensor, item=boom, tolist=boom,
                             __int__=boom, __index__=boom, __bool__=boom,
                             __float__=boom, numpy=boom):
        plans = [(attn.decode_splits(b, 16, t, 132), attn.decode_chunk(t, 4))
                 for b in (1, 4) for t in (512, 1024)]
    assert boom.call_count == 0 and all(n >= 1 for n, _ in plans)


def test_prefill_body_by_dtype():
    assert attn.body(torch.bfloat16) == "mma bf16"
    assert attn.body(torch.float32) == "fma f32"
