"""The arithmetic of the card's attention kernels, held against the JAX
package on the CPU.

``csrc/attention.cu``'s bf16 body runs both products on the tensor cores
and feeds P to P.V as two bf16 terms, where the TPU body multiplies f32 P;
``csrc/decode.cu`` splits each row's cache over several CTAs and merges
their partial softmaxes in a combine pass, and its bf16 wide body (MLA's
absorbed decode) runs both products on the tensor cores as the prefill
body does. Neither runs here, so each is
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
                          scale=None, tile=64, p_terms=2, softcap=None,
                          cap_after_mask=False):
    """The bf16 body of ``csrc/attention.cu`` in plain torch, in f32 (its
    output before the last rounding): 64-key tiles; S = Q K^T in f32 from
    the bf16 operands (their products are exact in f32), scaled into log2
    units (with ``softcap``: scaled in natural units, capped, then times
    log2(e); ``cap_after_mask``: the attn_softcap_after_mask mutant, the
    cap after the mask) and masked to the finite NEG_INF; the online max
    and rescale;
    P = 2^(S - m) fed to the f32-accumulated P V as ``p_terms`` bf16 terms
    (2: the kernel's head plus the bf16 of the remainder; 1: P rounded to
    bf16), and l the sum of the values the terms hold; a row that saw no
    key gives zeros."""
    b, sq, hq, dk = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    g = hq // hkv
    scale = 1.0 / math.sqrt(dk) if scale is None else scale
    c = scale * LOG2E
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    m = torch.full((b, hq, sq, 1), NEG_INF)
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, dv))
    qpos = q_offset + torch.arange(sq)[:, None]
    for k0 in range(0, skv, tile):
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        s = qf @ kt.transpose(-1, -2)
        if softcap is None:
            s = s * c
        elif not cap_after_mask:
            s = torch.tanh(s * scale / softcap) * softcap * LOG2E
        else:
            s = s * scale
        kpos = k0 + torch.arange(kt.shape[2])[None, :]
        vis = torch.ones((sq, kt.shape[2]), dtype=torch.bool)
        if causal:
            vis &= kpos <= qpos
        if window is not None:
            vis &= qpos - kpos < window
        s = torch.where(vis, s, torch.tensor(NEG_INF))
        if softcap is not None and cap_after_mask:
            s = torch.tanh(s / softcap) * softcap * LOG2E
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
                         tile=64, rescale=True, softcap=None,
                         cap_log2_units=False):
    """``csrc/decode.cu`` in plain torch, in f32: split s of row b runs the
    online softmax over 64-key tiles of keys [s*C, min((s+1)*C, len)) into a
    partial (m, l, acc); a split past len runs nothing. The combine takes
    m = max m_s, l = sum l_s e^(m_s - m), o = sum acc_s e^(m_s - m) / l, and
    zeros where no split saw a key. ``rescale=False`` is the
    decode_combine_no_rescale mutant: acc_s added without e^(m_s - m).
    ``softcap``: each score capped in natural units (the body has no log2
    fold); ``cap_log2_units`` is the decode_softcap_log2_units mutant: tanh
    of the log2-unit score, taken back to natural units."""
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
                if softcap is not None and cap_log2_units:
                    sc = torch.tanh(sc * LOG2E / softcap) * softcap / LOG2E
                elif softcap is not None:
                    sc = torch.tanh(sc / softcap) * softcap
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


# (case, cap): the softcap fragment at caps 50, 20 and 5 over the three
# masks: a q_offset, a window whose rows run past the keys (rows 47-63 of
# 64 over 40 keys see none), Dv != Dk
SOFTCAP_MMA_CASES = [
    ((1, 100, 300, 4, 2, 80, 80, 200, "causal", None), 50.0),
    ((1, 64, 40, 4, 2, 64, 64, 0, "window", 8), 5.0),
    ((1, 30, 45, 4, 2, 64, 32, 0, "full", None), 20.0),
]


def _jax_capped(qj, kj, vj, mask, q_offset, window, cap):
    """JAX's template kernel with the cap, in interpret mode."""
    return T.attention_core(qj, kj, vj, causal=mask != "full", window=window,
                            q_offset=q_offset, softcap=cap, block_q=32,
                            block_k=32, interpret=True)


@pytest.mark.parametrize("case,cap", SOFTCAP_MMA_CASES,
                         ids=lambda c: "-".join(map(str, c))
                         if isinstance(c, tuple) else str(c))
def test_mma_body_with_softcap_keeps_the_rule(case, cap):
    """The bf16 body's softcap fragment: the scores capped in natural units
    before the log2 fold and the mask, against the capped plain version
    and JAX's capped kernel in f32 on the same bf16 values, four times
    inside chip_smoke's rule; rows that see no key are exact zeros."""
    b, sq, skv, hq, hkv, dk, dv, off, mask, window = case
    (qj, kj, vj), (qt, kt, vt), _, atol = _case_inputs(case)
    plain = ref.attention(qt.float(), kt.float(), vt.float(), q_offset=off,
                          causal=mask != "full", window=window, softcap=cap)
    emu = emulate_mma_attention(qt, kt, vt, q_offset=off,
                                causal=mask != "full", window=window,
                                softcap=cap)
    jax32 = _jax_capped(qj.astype(jnp.float32), kj.astype(jnp.float32),
                        vj.astype(jnp.float32), mask, off, window, cap)
    for name, want in (("plain", plain.numpy()), ("jax f32", jax32)):
        worst = _within_rule(emu.numpy(), want, atol, MARGIN)
        assert worst <= 1.0, f"{name}: {worst:.3f} of the rule / {MARGIN}"
    dead = plain.abs().amax(-1) == 0
    assert not emu[dead].any()


def test_softcap_after_mask_is_caught():
    """The attn_softcap_after_mask mutant, emulated: a masked score becomes
    -cap, so the rows that see no key leave as a mean of the values, not
    zeros, and chip_smoke's zero-row check fails."""
    case = (1, 64, 40, 4, 2, 64, 64, 0, "window", 8)
    _, (qt, kt, vt), _, _ = _case_inputs(case)
    plain = ref.attention(qt.float(), kt.float(), vt.float(), window=8,
                          softcap=5.0)
    bad = emulate_mma_attention(qt, kt, vt, window=8, softcap=5.0,
                                cap_after_mask=True)
    dead = plain.abs().amax(-1) == 0
    assert int(dead.sum()) == 17 * 4 and bad[dead].abs().amax() > 1e-2


# (B, T, Hq, Hkv, D, SMs, cap): split several ways, caps 50 and 5
SOFTCAP_DECODE_CASES = [(5, 200, 4, 2, 32, 132, 50.0), (4, 256, 8, 2, 32, 8, 5.0)]


@pytest.mark.parametrize("case", SOFTCAP_DECODE_CASES,
                         ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_split_decode_with_softcap_matches_jax(case, dt):
    """decode's capped split and merge against JAX's capped decode kernel
    in interpret mode and the capped plain version; lengths 0 give zeros.
    Queries scaled by 3 push the scores into the cap's bend."""
    b, t, hq, hkv, d, sms, cap = case
    n_split = attn.decode_splits(b, hkv, t, sms)
    chunk = attn.decode_chunk(t, n_split)
    rng = np.random.default_rng(21)
    qj, qt = _pair(rng, (b, 1, hq, d), dt)
    qj, qt = qj * 3, qt * 3
    kj, kt = _pair(rng, (b, t, hkv, d), dt)
    vj, vt = _pair(rng, (b, t, hkv, d), dt)
    lengths = _lengths(t, chunk, b)
    emu = emulate_split_decode(qt, kt, vt, lengths, n_split, chunk,
                               softcap=cap)
    want = jops.attn_decode_template(qj, kj, vj, jnp.asarray(lengths),
                                     softcap=cap, interpret=True)
    plain = ref.decode_attention(qt, kt, vt, torch.from_numpy(lengths),
                                 softcap=cap)
    if dt == "float32":
        for w in (np.asarray(want), plain.numpy()):
            np.testing.assert_allclose(emu.numpy(), w, rtol=0, atol=2e-6)
    else:
        got = emu.to(torch.bfloat16).float().numpy()
        for w in (np.asarray(want, np.float32), plain.float().numpy()):
            np.testing.assert_allclose(got, w, rtol=0, atol=ATOL[dt])
    assert not emu[0].any(), "lengths 0 must give exact zeros"


def test_softcap_in_log2_units_is_caught():
    """The decode_softcap_log2_units mutant, emulated: tanh of the log2-unit
    score moves every score past a few units (by 0.25 at 3 with a cap of
    5), far outside f32's limit."""
    b, t, hq, hkv, d, sms, cap = SOFTCAP_DECODE_CASES[1]
    n_split = attn.decode_splits(b, hkv, t, sms)
    chunk = attn.decode_chunk(t, n_split)
    rng = np.random.default_rng(22)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((b, 1, hq, d), (b, t, hkv, d), (b, t, hkv, d)))
    lengths = _lengths(t, chunk, b)
    bad = emulate_split_decode(q * 3, k, v, lengths, n_split, chunk,
                               softcap=cap, cap_log2_units=True)
    plain = ref.decode_attention(q * 3, k, v, torch.from_numpy(lengths),
                                 softcap=cap)
    assert float((bad - plain).abs().max()) > 1e-2


@pytest.mark.parametrize("b,hkv", [(1, 1), (1, 8), (4, 16), (4, 32), (8, 16),
                                   (33, 4), (64, 4)])
@pytest.mark.parametrize("t", [0, 1, 63, 64, 65, 512, 1024, 2048, 4096, 4097])
@pytest.mark.parametrize("sms", [1, 8, 132])
def test_decode_splits_properties(b, hkv, t, sms):
    """The common plan, and the wide bodies' (a CTA for every 16 query
    heads of a KV head: one here, MLA's G 16), each in whole tiles of its
    body, no split left without a tile of the cache."""
    for wide, tile, per_sm in (
            (False, attn.DECODE_TILE, attn.DECODE_CTAS_PER_SM),
            (True, attn.DECODE_WIDE_TILE, attn.DECODE_WIDE_CTAS_PER_SM)):
        n = attn.decode_splits(b, hkv, t, sms, wide=wide)
        chunk = attn.decode_chunk(t, n, wide=wide)
        tiles = -(-t // tile)
        assert isinstance(n, int) and n >= 1
        if b * hkv >= sms or tiles <= 1:
            assert n == 1
        assert n <= max(1, tiles)
        assert chunk % tile == 0 and chunk > 0
        assert n * chunk >= t                        # the splits cover the cache
        assert t == 0 or -(-t // chunk) == n         # and none is left empty
        assert (n - 1) * b * hkv < per_sm * sms or n == 1
        if wide:
            assert n <= attn.DECODE_WIDE_MAX_SPLITS
            # as many CTAs as a split of one tile each gives, to the cap
            want = min(tiles, attn.DECODE_WIDE_MAX_SPLITS, -(-per_sm * sms // (b * hkv)))
            assert b * hkv >= sms or tiles <= 1 or -(-tiles // -(-tiles // want)) == n
    # the serve step of MLA's absorbed decode: B 4 rows of one KV head over
    # 512 keys put at least 64 CTAs on the card's 132 SMs
    assert 4 * attn.decode_splits(4, 1, 512, 132, wide=True) >= 64


def test_decode_splits_reads_no_tensor():
    """Shapes and an SM count in, a split count out: with every host read
    of a tensor made to raise, the plan is computed all the same."""
    boom = mock.Mock(side_effect=AssertionError("host read of a tensor"))
    with mock.patch.multiple(torch.Tensor, item=boom, tolist=boom,
                             __int__=boom, __index__=boom, __bool__=boom,
                             __float__=boom, numpy=boom):
        plans = [(attn.decode_splits(b, 16, t, 132), attn.decode_chunk(t, 4))
                 for b in (1, 4) for t in (512, 1024)]
        plans += [attn.decode_plan(b, 16, 1, t, 576, 512, 132)
                  for b in (1, 4) for t in (512, 1024)]
    assert boom.call_count == 0 and all(n >= 1 for n, _ in plans)
    assert plans[-2] == (16, 32) and 4 * plans[-2][0] >= 64   # B 4, T 512


def test_prefill_body_by_dtype():
    assert attn.body(torch.bfloat16) == "mma bf16"
    assert attn.body(torch.float32) == "fma f32"


# ---------------------------------------------------------------------------
# decode's wide bodies: MLA's absorbed decode (Dk 576, Dv 512, Hkv 1, G 16)
# ---------------------------------------------------------------------------

#: csrc/decode.cu's f32 wide body (the FMA units'): keys a tile, threads a
#: key, the elements a score load reads; four P.V columns a thread of 128
WIDE = {"float32": (16, 8, 4)}
THREADS, PW_WIDE = 128, 4
#: its bf16 wide body (the tensor cores'): 8 warps; warp w takes the n8 key
#: slice w % 4 of a 32-key tile over the Dk part w // 4, and output
#: columns 64w .. 64w + 63; P goes to P.V as this many bf16 terms
MMA_WARPS, MMA_M, P_TERMS = 8, 16, 2
LN2 = math.log(2.0)


def pv_map(dv, pw=PW_WIDE, threads=THREADS):
    """The f32 wide body's P.V mapping: thread t owns columns [pw*col,
    pw*col + pw) of every head, col = t % ncol, over the keys ph, ph + nph,
    ... of a tile, ph = t // ncol; threads with ph >= nph idle."""
    ncol = dv // pw
    nph = threads // ncol
    return [(t % ncol, t // ncol) for t in range(threads) if t // ncol < nph], nph


def mma_acc_map(g, dv, warps=MMA_WARPS):
    """The bf16 wide body's P.V accumulators: (head, column) of register e
    of n8 tile j in lane l of warp w (the m16n8 C fragment: rows l // 4
    and l // 4 + 8, columns 2 (l % 4) and + 1), over its warp's columns;
    rows past G are padding and stored nowhere."""
    cw = dv // warps
    out = []
    for w in range(warps):
        for j in range(cw // 8):
            for lane in range(32):
                for e in range(4):
                    row = lane // 4 + 8 * (e // 2)
                    if row < g:
                        out.append((row, w * cw + j * 8 + 2 * (lane % 4) + e % 2))
    return out


def emulate_wide_decode(q, k, v, lengths, n_split, chunk, scale, dt,
                        drop_last_group=False):
    """The f32 wide body in plain torch, f32: each split's keys in tiles of
    WIDE[dt][0]; a key's score as TPK partial dots over interleaved
    load-width chunks of Dk, closed by the shuffle butterfly; the online
    softmax per tile; P.V accumulated per (column group, key phase) as
    :func:`pv_map` assigns them, the phases added at the end; the splits
    merged. ``drop_last_group``: the mutant whose last column group never
    runs (its columns stay zero)."""
    tile, tpk, vw = WIDE[dt]
    b, _, hq, dk = q.shape
    t, dv = k.shape[1], v.shape[3]
    g = hq                                           # Hkv 1
    qf, kf, vf = q.float()[:, 0], k.float()[:, :, 0], v.float()[:, :, 0]
    groups, nph = pv_map(dv)
    ncol = dv // PW_WIDE
    out = torch.zeros((b, 1, hq, dv))
    for bi in range(b):
        n = min(max(int(lengths[bi]), 0), t)
        parts = []
        for s in range(n_split):
            begin, end = s * chunk, min(n, (s + 1) * chunk)
            if begin >= end:
                continue
            m = torch.full((g, 1), NEG_INF)
            l = torch.zeros((g, 1))
            acc = torch.zeros((nph, g, dv))
            for k0 in range(begin, end, tile):
                keys = range(k0, min(k0 + tile, end))
                sc = torch.full((g, tile), NEG_INF)
                for j, key in enumerate(keys):
                    dots = []
                    for sub in range(tpk):
                        cols = [c for i in range(sub, dk // vw, tpk)
                                for c in range(i * vw, i * vw + vw)]
                        dots.append(qf[bi][:, cols] @ kf[bi, key, cols])
                    while len(dots) > 1:             # xor 1, then xor 2, ...
                        dots = [dots[i] + dots[i + 1]
                                for i in range(0, len(dots), 2)]
                    sc[:, j] = dots[0] * scale
                m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                p = torch.exp(sc - m_new)
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr
                for col, ph in groups:
                    if drop_last_group and col == ncol - 1:
                        continue
                    c0 = PW_WIDE * col
                    for j in range(ph, len(keys), nph):
                        acc[ph, :, c0:c0 + PW_WIDE] += \
                            p[:, j:j + 1] * vf[bi, k0 + j, c0:c0 + PW_WIDE]
                m = m_new
            parts.append((m, l, acc.sum(0)))
        if parts:
            mm = torch.stack([p[0] for p in parts]).amax(0)
            w = [torch.exp(p[0] - mm) for p in parts]
            ll = sum(wi * p[1] for wi, p in zip(w, parts))
            aa = sum(wi * p[2] for wi, p in zip(w, parts))
            out[bi, 0] = aa / ll.clamp_min(1e-30)
    return out


def emulate_mma_decode(q, k, v, lengths, n_split, chunk, scale, *,
                       tile=None, p_terms=P_TERMS, drop_last_slice=False,
                       skip_last_k_step=False, store_padded_rows=False):
    """The bf16 wide body of ``csrc/decode.cu`` in plain torch, f32 (its
    output before the last rounding): each split's keys in tiles of
    ``tile`` (DECODE_WIDE_TILE) keys, zero past the split; the 16 heads as
    mma's M (zero past G); S = q K^T from the bf16 operands in f32 (their
    products exact), as the two Dk halves' partial sums added; scaled into
    log2 units, keys past the split masked to NEG_INF; the online max and
    rescale in f32; P = 2^(S - m) fed to the f32-accumulated P.V as
    ``p_terms`` bf16 terms (2: the kernel's head plus the bf16 of the
    remainder; 1: P rounded to bf16), l the sum of the values the terms
    hold; a split's m leaves in natural units; the merge weighs each split
    by e^(m_s - m) / l. Rows of M past G are computed and stored nowhere.
    ``drop_last_slice``: the decode_wide_drops_last_group mutant (the last
    warp's 64 output columns never accumulate); ``skip_last_k_step``:
    decode_wide_skips_last_k_step (the scores miss Dk's last 16 dims);
    ``store_padded_rows``: decode_g10_stores_padded_rows (split s stores
    its rows G..15 too, onto split s + 1's partials of heads 0..15-G,
    after split s + 1 has stored its own)."""
    tile = tile or attn.DECODE_WIDE_TILE
    b, _, g, dk = q.shape
    t, dv = k.shape[1], v.shape[3]
    c = scale / LN2                                   # scale * log2(e)
    qf = torch.zeros((b, MMA_M, dk))
    qf[:, :g] = q.float()[:, 0]
    kf, vf = k.float()[:, :, 0], v.float()[:, :, 0]
    half = dk // 2
    kept = dk - 16 if skip_last_k_step else dk
    cw = dv // MMA_WARPS
    out = torch.zeros((b, 1, g, dv))
    for bi in range(b):
        n = min(max(int(lengths[bi]), 0), t)
        parts = []
        for s in range(n_split):
            begin, end = s * chunk, min(n, (s + 1) * chunk)
            if begin >= end:
                continue
            m = torch.full((MMA_M, 1), NEG_INF)
            l = torch.zeros((MMA_M, 1))
            acc = torch.zeros((MMA_M, dv))
            for k0 in range(begin, end, tile):
                kt = torch.zeros((tile, dk))
                vt = torch.zeros((tile, dv))
                nk = min(tile, end - k0)
                kt[:nk], vt[:nk] = kf[bi, k0:k0 + nk], vf[bi, k0:k0 + nk]
                sc = (qf[bi, :, :half] @ kt[:, :half].T
                      + qf[bi, :, half:kept] @ kt[:, half:kept].T) * c
                sc[:, nk:] = NEG_INF
                m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                corr = torch.exp2(m - m_new)
                p = torch.exp2(sc - m_new)
                terms = [p.to(torch.bfloat16).float()]
                if p_terms == 2:
                    terms.append((p - terms[0]).to(torch.bfloat16).float())
                l = l * corr + sum(terms).sum(-1, keepdim=True)
                acc = acc * corr
                for term in terms:
                    acc = acc + term @ vt
                if drop_last_slice:
                    acc[:, dv - cw:] = 0.0
                m = m_new
            parts.append((m * LN2, l, acc))
        if store_padded_rows:
            for i in range(len(parts) - 1):
                nxt = [x.clone() for x in parts[i + 1]]
                for x, y in zip(nxt, parts[i]):
                    x[:MMA_M - g] = y[g:]
                parts[i + 1] = tuple(nxt)
        if parts:
            mm = torch.stack([p[0] for p in parts]).amax(0)
            ll = sum(torch.exp(p[0] - mm) * p[1] for p in parts)
            aa = sum(torch.exp(p[0] - mm) / ll.clamp_min(1e-30) * p[2]
                     for p in parts)
            out[bi, 0] = aa[:g]
    return out


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_wide_pv_map_covers_every_column_and_key_once(dt):
    """Every (key, column) of a tile reaches P.V once: in f32 by the FMA
    body's thread map; in bf16 every (head, column) of the output is one
    register of one lane of one warp (each mma takes all 16 keys of a k
    step), and no warp's column slice overlaps another's."""
    dv = attn.DECODE_MAX_DIMS[1]
    if dt == "bfloat16":
        owned = mma_acc_map(attn.DECODE_WIDE_GROUP, dv)
        assert sorted(owned) == [(h, c) for h in range(attn.DECODE_WIDE_GROUP)
                                 for c in range(dv)]
        assert attn.DECODE_WIDE_TILE % 16 == 0 and dv % (16 * MMA_WARPS) == 0
        return
    groups, nph = pv_map(dv)
    assert nph >= 1
    tile, seen = WIDE[dt][0], {}
    for col, ph in groups:
        for key in range(ph, tile, nph):
            for c in range(PW_WIDE * col, PW_WIDE * col + PW_WIDE):
                seen[(key, c)] = seen.get((key, c), 0) + 1
    assert seen == {(key, c): 1 for key in range(tile) for c in range(dv)}


def test_wide_tiles_fit_a_block_and_the_split_covers_the_cache():
    """The bf16 wide body's shared memory at MLA's dims and G 16 (three
    stages of 32-key K and V tiles, rows padded by 16 bytes, and the two
    Dk parts' f32 scores) stays under a block's 227 KB where a fourth stage
    would not; the f32 body's two stages of 16-key tiles too. The serve
    step's wide plan (B 4, Hkv 1, T 512, 132 SMs) is 16 splits of one
    32-key tile: 64 CTAs, where the common plan would give 8 of 64 keys."""
    limit = 227 * 1024
    dk, dv = attn.DECODE_MAX_DIMS
    tile = attn.DECODE_WIDE_TILE

    def mma_smem(stages):
        ksplit = MMA_WARPS // (tile // 8)
        return (2 * stages * tile * (dk + 8 + dv + 8)
                + 4 * ksplit * MMA_M * (tile + 8))

    def pitch(cols, elem):
        groups = cols * elem // 16
        return (groups + (10 - groups % 8) % 8) * (16 // elem)

    def fma_smem(g, bk, elem, nph=1):
        return (2 * bk * (pitch(dk, elem) + pitch(dv, elem)) * elem
                + 4 * (g * dk + g * bk + 3 * g + (nph - 1) * g * dv))
    assert mma_smem(3) <= limit < mma_smem(4)
    assert mma_smem(3) == 217088                     # the file's 212 KB
    assert fma_smem(16, 64, 2) > limit
    assert fma_smem(attn.DECODE_WIDE_GROUP, WIDE["float32"][0], 4) <= limit
    n = attn.decode_splits(4, 1, 512, 132, wide=True)
    chunk = attn.decode_chunk(512, n, wide=True)
    assert (n, chunk) == (16, 32) and 4 * n >= 64
    assert attn.decode_plan(4, 16, 1, 512, dk, dv, 132) == (16, 32)
    assert attn.decode_plan(4, 32, 32, 512, 128, 128, 132) == (8, 64)
    assert all(chunk % WIDE[dt][0] == 0 for dt in WIDE)
    assert attn.decode_wide(576, 512) and not attn.decode_wide(128, 128)
    assert attn.decode_dims_taken(576, 512, 16)
    assert attn.decode_dims_taken(128, 64, 1)
    assert attn.decode_dims_taken(128, 128, 32)
    assert not attn.decode_dims_taken(128, 128, 64)
    for dk_, dv_, g in ((640, 512, 16), (576, 514, 16), (576, 508, 16),
                        (264, 256, 8), (576, 512, 8), (576, 512, 32)):
        assert not attn.decode_dims_taken(dk_, dv_, g)
    assert attn.prefill_dims_taken(192, 128)
    assert not attn.prefill_dims_taken(192, 128, causal=False)
    assert not attn.prefill_dims_taken(192, 192)
    assert not attn.prefill_dims_taken(256, 128)
    assert not attn.prefill_dims_taken(136, 72)
    assert attn.prefill_dims_taken(80, 80, causal=False)


def test_decode_body_by_dims_and_dtype():
    assert attn.decode_body(576, 512, torch.bfloat16) == "wide mma bf16"
    assert attn.decode_body(576, 512, torch.float32) == "wide fma f32"
    assert attn.decode_body(128, 128, torch.bfloat16) == "fma"
    assert attn.decode_body(80, 80, torch.float32) == "fma"


#: the MLA cases: B 6 rows over T 80 keys, lengths 0, 1, a tile's edge
#: either side and a full row, scale 1/sqrt(192)
MLA_T, MLA_LENGTHS, MLA_SCALE = 80, [0, 1, 31, 32, 33, 80], 1.0 / math.sqrt(192)


@pytest.fixture(scope="module")
def mla_case():
    """The inputs of the MLA cases in both dtypes (numpy, seed 20), JAX's
    decode kernel on them in interpret mode and the port's plain version,
    computed once for the module's tests."""
    rng = np.random.default_rng(20)
    b, hq = len(MLA_LENGTHS), attn.DECODE_WIDE_GROUP
    dk, dv = attn.DECODE_MAX_DIMS
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, 1, hq, dk), (b, MLA_T, 1, dk), (b, MLA_T, 1, dv))]
    lengths = np.array(MLA_LENGTHS, np.int32)
    out = {"lengths": lengths}
    for dt in ("float32", "bfloat16"):
        js = [jnp.asarray(a).astype(JAX_DT[dt]) for a in arrays]
        ts = [torch.from_numpy(a).to(TORCH_DT[dt]) for a in arrays]
        want = jops.attn_decode_template(*js, jnp.asarray(lengths),
                                         scale=MLA_SCALE, interpret=True)
        out[dt] = dict(
            torch=ts, jax=np.asarray(want, np.float32),
            plain=ref.decode_attention(*ts, torch.from_numpy(lengths),
                                       scale=MLA_SCALE).float().numpy())
    # JAX's kernel on the bf16 values in f32: the arithmetic's reference
    js = [jnp.asarray(t.float().numpy()) for t in out["bfloat16"]["torch"]]
    out["bf16 values, f32"] = np.asarray(jops.attn_decode_template(
        *js, jnp.asarray(lengths), scale=MLA_SCALE, interpret=True))
    out["bf16 values, plain f32"] = ref.decode_attention(
        *[t.float() for t in out["bfloat16"]["torch"]],
        torch.from_numpy(lengths), scale=MLA_SCALE).numpy()
    return out


#: (n_split, chunk) of the MLA cases: the wide plan's at 132 SMs (3 splits
#: of one tile), one split a row (6 rows on 4 SMs) and two tiles a split
MLA_PLANS = [attn.decode_plan(len(MLA_LENGTHS), 16, 1, MLA_T, 576, 512, 132),
             attn.decode_plan(len(MLA_LENGTHS), 16, 1, MLA_T, 576, 512, 4),
             (2, 64)]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_wide_decode_matches_jax_at_mla_dims(mla_case, dt):
    """At Dk 576 / Dv 512 / Hkv 1 / G 16, scale 1/sqrt(192), lengths 0, 1,
    31, 32, 33 and T: the emulated wide body of ``dt`` against JAX's
    decode kernel in interpret mode and the port's plain version. f32 (the
    FMA body) split in 2 of 64 keys; bf16 (the tensor cores' body) under
    each of MLA_PLANS."""
    case = mla_case[dt]
    qt, kt, vt = case["torch"]
    lengths = mla_case["lengths"]
    if dt == "float32":
        emus = [emulate_wide_decode(qt, kt, vt, lengths, 2, 64, MLA_SCALE, dt)]
        # 576-term dots in another order: within half the card's f32 limit
        for emu in emus:
            for w in (case["jax"], case["plain"]):
                np.testing.assert_allclose(emu.numpy(), w, rtol=0,
                                           atol=ATOL[dt] / 2)
    else:
        emus = [emulate_mma_decode(qt, kt, vt, lengths, n, c, MLA_SCALE)
                for n, c in MLA_PLANS]
        assert MLA_PLANS[0][0] > 1 and MLA_PLANS[1][0] == 1
        for emu in emus:
            got = emu.to(torch.bfloat16).float().numpy()
            for w in (case["jax"], case["plain"]):
                np.testing.assert_allclose(got, w, rtol=0, atol=ATOL[dt])
    for emu in emus:
        assert not emu[0].any(), "lengths 0 must give exact zeros"
    if dt == "float32":
        bad = emulate_wide_decode(qt, kt, vt, lengths, 2, 64, MLA_SCALE, dt,
                                  drop_last_group=True)
        assert float(np.abs(bad.numpy() - case["plain"]).max()) > ATOL[dt]


def test_mma_decode_keeps_the_rule_four_times_over(mla_case):
    """The bf16 wide body's arithmetic uses less than a quarter of
    chip_smoke's bf16 rule: the emulated body in f32 against JAX's kernel
    and the plain version in f32 on the same bf16 values, under every plan
    of MLA_PLANS; the plans agree with one another to f32 rounding."""
    qt, kt, vt = mla_case["bfloat16"]["torch"]
    lengths = mla_case["lengths"]
    emus = [emulate_mma_decode(qt, kt, vt, lengths, n, c, MLA_SCALE).numpy()
            for n, c in MLA_PLANS]
    for emu in emus:
        for name in ("bf16 values, f32", "bf16 values, plain f32"):
            worst = _within_rule(emu, mla_case[name], BF16_ATOL, MARGIN)
            assert worst <= 1.0, f"{name}: {worst:.3f} of the rule / {MARGIN}"
        np.testing.assert_allclose(emu, emus[0], rtol=0, atol=1e-5)


def test_mma_decode_needs_p_as_two_bf16_terms(mla_case):
    """Why P goes to P.V as two bf16 terms: with them the emulated body's
    f32 output is within 2e-5 of JAX's kernel in f32 on the same bf16
    values (P carries 16 significant bits), where P rounded once to bf16
    (2^-9 of each weight) misses that by far."""
    qt, kt, vt = mla_case["bfloat16"]["torch"]
    lengths = mla_case["lengths"]
    n, c = MLA_PLANS[0]
    want = mla_case["bf16 values, f32"]
    two = emulate_mma_decode(qt, kt, vt, lengths, n, c, MLA_SCALE).numpy()
    one = emulate_mma_decode(qt, kt, vt, lengths, n, c, MLA_SCALE,
                             p_terms=1).numpy()
    assert P_TERMS == 2
    assert float(np.abs(two - want).max()) <= 2e-5
    assert float(np.abs(one - want).max()) > 10 * 2e-5


@pytest.mark.parametrize("mutant", ["drop_last_slice", "skip_last_k_step"])
def test_wide_mutants_are_caught(mla_case, mutant):
    """The bf16 wide body's mutants (scripts/port_mutation_check.sh),
    emulated: each misses the bf16 limit against the plain version."""
    qt, kt, vt = mla_case["bfloat16"]["torch"]
    n, c = MLA_PLANS[0]
    bad = emulate_mma_decode(qt, kt, vt, mla_case["lengths"], n, c, MLA_SCALE,
                             **{mutant: True})
    got = bad.to(torch.bfloat16).float().numpy()
    assert float(np.abs(got - mla_case["bfloat16"]["plain"]).max()) > ATOL["bfloat16"]


# ---------------------------------------------------------------------------
# recurrentgemma-2b's local layers: Dk = Dv = 256, one KV head for 10
# ---------------------------------------------------------------------------

#: the window body's cases at head dim 256 (B, Sq, Skv, Hq, Hkv, Dk, Dv,
#: q_offset, mask, window): a window of two tiles over 150 keys, and one
#: longer than the sequence (recurrentgemma's 2048 at a short prompt)
RG_WINDOW_CASES = [(1, 150, 150, 10, 1, 256, 256, 0, "window", 128),
                   (2, 70, 70, 10, 1, 256, 256, 0, "window", 2048)]


@pytest.mark.parametrize("case", RG_WINDOW_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_window_body_at_256_splits_dv_and_keeps_the_rule(case):
    """The (256, 256) window instantiation: two CTAs each run the whole
    Q.K^T and softmax and P.V for 128 of the 256 output columns. Emulated
    that way, it equals the body over all 256 columns bit for bit, and
    keeps the bf16 rule four times over against the plain version and the
    JAX kernel in interpret mode (f32 on the same bf16 values), and the
    rule itself against the JAX kernel in bf16."""
    b, sq, skv, hq, hkv, dk, dv, off, mask, window = case
    assert attn.prefill_dims_taken(dk, dv, causal=False, window=True)
    (qj, kj, vj), (qt, kt, vt), plain, atol = _case_inputs(case)
    half = dv // 2
    emu = torch.cat([emulate_mma_attention(qt, kt, vt[..., c:c + half],
                                           window=window)
                     for c in (0, half)], dim=-1)
    assert torch.equal(emu, emulate_mma_attention(qt, kt, vt, window=window))
    jax32 = _jax_attention(qj.astype(jnp.float32), kj.astype(jnp.float32),
                           vj.astype(jnp.float32), mask, off, window)
    for name, want in (("plain", plain.numpy()), ("jax f32", jax32)):
        worst = _within_rule(emu.numpy(), want, atol, MARGIN)
        assert worst <= 1.0, f"{name}: {worst:.3f} of the rule / {MARGIN}"
    jax16 = _jax_attention(qj, kj, vj, mask, off, window)
    assert _within_rule(emu.to(torch.bfloat16).float().numpy(),
                        np.asarray(jax16, np.float32), atol, 1.0) <= 1.0


#: the decode cases at (256, 256), G 10: B 6 rows over T 80 keys, lengths
#: 0, 1, a tile's edge either side and a full row, the default scale
RG_G, RG_D = 10, 256
RG_T, RG_LENGTHS = 80, [0, 1, 31, 32, 33, 80]
RG_SCALE = 1.0 / math.sqrt(RG_D)
#: (n_split, chunk): the wide plan at 132 SMs, one split a row, two tiles a
#: split
RG_PLANS = [attn.decode_plan(len(RG_LENGTHS), RG_G, 1, RG_T, RG_D, RG_D, 132),
            attn.decode_plan(len(RG_LENGTHS), RG_G, 1, RG_T, RG_D, RG_D, 4),
            (2, 64)]


@pytest.fixture(scope="module")
def rg_case():
    """The inputs of the (256, 256, G 10) decode cases in both dtypes
    (numpy, seed 21), JAX's decode kernel on them in interpret mode and
    the port's plain version, computed once."""
    rng = np.random.default_rng(21)
    b = len(RG_LENGTHS)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, 1, RG_G, RG_D), (b, RG_T, 1, RG_D),
                        (b, RG_T, 1, RG_D))]
    lengths = np.array(RG_LENGTHS, np.int32)
    out = {"lengths": lengths}
    for dt in ("float32", "bfloat16"):
        js = [jnp.asarray(a).astype(JAX_DT[dt]) for a in arrays]
        ts = [torch.from_numpy(a).to(TORCH_DT[dt]) for a in arrays]
        out[dt] = dict(
            torch=ts,
            jax=np.asarray(jops.attn_decode_template(
                *js, jnp.asarray(lengths), scale=RG_SCALE, interpret=True),
                np.float32),
            plain=ref.decode_attention(*ts, torch.from_numpy(lengths),
                                       scale=RG_SCALE).float().numpy())
    out["bf16 values, plain f32"] = ref.decode_attention(
        *[t.float() for t in out["bfloat16"]["torch"]],
        torch.from_numpy(lengths), scale=RG_SCALE).numpy()
    return out


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_wide_decode_matches_jax_at_256_g10(rg_case, dt):
    """At Dk = Dv = 256, Hkv 1, G 10: the emulated wide body of ``dt``
    against JAX's decode kernel in interpret mode and the port's plain
    version, lengths 0, 1, 31, 32, 33 and T. bf16 (the tensor cores'
    body, M padded from 10 to 16) under each of RG_PLANS, and four times
    within the rule against the plain version in f32; f32 (the FMA body at
    its G 10 instantiation) split in 2 of 64 keys."""
    case = rg_case[dt]
    qt, kt, vt = case["torch"]
    lengths = rg_case["lengths"]
    assert attn.decode_dims_taken(RG_D, RG_D, RG_G)
    if dt == "float32":
        emus = [emulate_wide_decode(qt, kt, vt, lengths, 2, 64, RG_SCALE, dt)]
        for w in (case["jax"], case["plain"]):
            np.testing.assert_allclose(emus[0].numpy(), w, rtol=0,
                                       atol=ATOL[dt] / 2)
    else:
        emus = [emulate_mma_decode(qt, kt, vt, lengths, n, c, RG_SCALE)
                for n, c in RG_PLANS]
        assert RG_PLANS[0][0] > 1 and RG_PLANS[1][0] == 1
        for emu in emus:
            assert emu.shape == (len(RG_LENGTHS), 1, RG_G, RG_D)
            got = emu.to(torch.bfloat16).float().numpy()
            for w in (case["jax"], case["plain"]):
                np.testing.assert_allclose(got, w, rtol=0, atol=ATOL[dt])
            worst = _within_rule(emu.numpy(), rg_case["bf16 values, plain f32"],
                                 BF16_ATOL, MARGIN)
            assert worst <= 1.0, worst
    for emu in emus:
        assert not emu[0].any(), "lengths 0 must give exact zeros"


def test_padded_rows_mutant_is_caught(rg_case):
    """decode_g10_stores_padded_rows (scripts/port_mutation_check.sh),
    emulated under the wide plan on queries scaled by 4 (phase 2's peaked
    case: each head's softmax dominated by a few keys): a split's padded
    rows 10-15 (zero queries, m = 0) land on the next split's heads 0-5,
    whose keys then drop out of the merge, and the output misses the bf16
    limit; the sound body keeps it on the same inputs."""
    qt, kt, vt = rg_case["bfloat16"]["torch"]
    lengths = rg_case["lengths"]
    q4 = (qt.float() * 4.0).to(torch.bfloat16)
    plain = ref.decode_attention(q4, kt, vt, torch.from_numpy(lengths),
                                 scale=RG_SCALE).float().numpy()
    n, c = RG_PLANS[0]
    errs = {}
    for mutant in (False, True):
        emu = emulate_mma_decode(q4, kt, vt, lengths, n, c, RG_SCALE,
                                 store_padded_rows=mutant)
        errs[mutant] = np.abs(emu.to(torch.bfloat16).float().numpy() - plain)
    assert float(errs[False].max()) <= ATOL["bfloat16"]
    assert float(errs[True].max()) > ATOL["bfloat16"]
    assert float(errs[True][:, :, RG_G - 4:].max()) == \
        float(errs[False][:, :, RG_G - 4:].max())      # heads 6-9 untouched


def test_256_tiles_fit_a_block_and_the_plan():
    """At (256, 256), G 10: the bf16 wide body's three stages of 32-key
    tiles and the f32 body's two stages of 16-key tiles fit a block; the
    serve step's plan (4 slots, rings of 2048, 132 SMs) is 32 splits of 64
    keys; the merge's weights fit the K stages; only this group is taken,
    and the window mask alone takes the pair in prefill."""
    limit, tile = 227 * 1024, attn.DECODE_WIDE_TILE
    ksplit = MMA_WARPS // (tile // 8)
    mma = 2 * 3 * tile * 2 * (RG_D + 8) + 4 * ksplit * MMA_M * (tile + 8)
    assert mma == 106496 and mma <= limit
    assert 4 * 1024 * RG_G <= 2 * 3 * tile * (RG_D + 8)
    bk, _, _ = WIDE["float32"]
    _, nph = pv_map(RG_D)
    pitch = 264                            # 256 f32, padded by 2 groups
    fma = 2 * bk * 2 * pitch * 4 + 4 * (RG_G * RG_D + RG_G * bk + 3 * RG_G
                                        + (nph - 1) * RG_G * RG_D)
    assert fma <= limit
    assert attn.decode_plan(4, RG_G, 1, 2048, RG_D, RG_D, 132) == (32, 64)
    assert attn.DECODE_WIDE_DIMS[(RG_D, RG_D)] == RG_G
    for g in (8, 16, 1):
        assert not attn.decode_dims_taken(RG_D, RG_D, g)
    assert not attn.decode_dims_taken(256, 128, RG_G)
    assert attn.decode_body(RG_D, RG_D, torch.bfloat16) == "wide mma bf16"
    assert attn.decode_body(RG_D, RG_D, torch.float32) == "wide fma f32"
    assert attn.prefill_dims_taken(256, 256, causal=False, window=True)
    assert not attn.prefill_dims_taken(256, 256)
    assert not attn.prefill_dims_taken(256, 256, causal=False)
    assert not attn.prefill_dims_taken(256, 128, causal=False, window=True)
    assert attn.prefill_dims_taken(80, 80, causal=False, window=True)
