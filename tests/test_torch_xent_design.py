"""The softmax cross-entropy kernel's launch plan and arithmetic, held
against the JAX package on the CPU.

``csrc/softmax_xent.cu`` runs the plan ``repro_torch.kernels.softmax_xent
.xent_plan`` picks from the shapes and the SM count alone: each row's
vocabulary cut into ``n_split`` spans of whole tiles, one CTA a span. Its
properties are checked over a grid of shapes.

A CTA streams its span's 16-byte-aligned middle through its ring, vector
j of it going to thread j % 256, and the unaligned head and tail to
threads 0.. as scalars. Each thread keeps a running max m and l = sum of
e^(x - m) computed as ex2(x log2e - m log2e), rescaling l only when its
max rises; the CTA combines its threads by a xor-shuffle tree in each warp
and then the warps in order; with more than one span a row, the last span
to finish merges the spans' (m, l) in split order, each l weighed by
e^(m_s - M). The label logit is read once, by the span that holds it.
That arithmetic is emulated here in numpy f32 and held against the Pallas
kernel ``repro.kernels.softmax_xent.softmax_xent`` in interpret mode and
against the port's plain version, on the same numpy inputs.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import softmax_xent as jxent  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import softmax_xent as xent  # noqa: E402

F32 = np.float32
LOG2E, LN2 = F32(1.4426950408889634), F32(0.6931471805599453)
NEG_INF = F32(-1e30)
THREADS = 256
SMS = 132
# the reference sweep's tolerance (tests/test_kernels.py): f32 losses
RTOL = ATOL = 1e-5
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# -- the plan ----------------------------------------------------------------

VOCABS = [1, 7, 130, 1000, 2048, 2049, 4099, 8193, 32000, 50304, 100003,
          262144, 262145]
ROWS = [1, 2, 3, 5, 8, 100, 131, 132, 256, 512, 2048]


@pytest.mark.parametrize("vocab", VOCABS)
@pytest.mark.parametrize("dt", list(DTYPES.values()))
def test_xent_plan_properties(vocab, dt):
    for sms in (SMS, 114, 16):
        for rows in ROWS:
            p = xent.xent_plan(rows, vocab, dt, sms)
            tiles = -(-vocab // p.tile)
            # spans of whole tiles (a tile is one stage of the ring)
            assert p.tile * dt.itemsize == xent.TILE_BYTES
            assert p.span > 0 and p.span % p.tile == 0
            # the spans cover [0, V) exactly once, none empty
            starts = np.arange(p.n_split) * p.span
            ends = np.minimum(vocab, starts + p.span)
            assert starts[0] == 0 and ends[-1] == vocab
            assert (ends[:-1] == starts[1:]).all() and (ends > starts).all()
            # a partial for each span fits the merge (one a thread)
            assert 1 <= p.n_split <= min(tiles, xent.THREADS)
            # one span a row where the rows put a CTA on every SM
            if rows >= sms or tiles == 1:
                assert p.n_split == 1
            else:
                # else every SM gets a CTA where the row has the tiles
                assert rows * p.n_split >= min(sms, rows * min(tiles, xent.THREADS) // 2)


def test_xent_plan_splits_the_few_row_case():
    """gemma3-27b's vocabulary with 8 rows: 32 spans a row, 256 CTAs on
    132 SMs (one CTA a row put 8 SMs to work); the §4.5 site, 256 rows,
    keeps one span a row."""
    for dt in DTYPES.values():
        p = xent.xent_plan(8, 262144, dt, SMS)
        assert p.n_split == 32 and 8 * p.n_split >= SMS
    assert xent.xent_plan(256, 32000, torch.float32, SMS).n_split == 1
    assert xent.xent_plan(512, 262144, torch.bfloat16, SMS).n_split == 1


def test_xent_plan_reads_no_tensor():
    """The plan's arguments are sizes, a dtype and the SM count: it reads
    no tensor, so it cannot wait on the card, and a meta tensor, which
    holds no data, plans as a real one."""
    assert list(inspect.signature(xent.xent_plan).parameters) == [
        "rows", "vocab", "dtype", "sms"]
    x = torch.empty((8, 262144), dtype=torch.bfloat16, device="meta")
    assert xent.xent_plan(*x.shape, x.dtype, SMS) == xent.xent_plan(
        8, 262144, torch.bfloat16, SMS)


# -- the arithmetic ------------------------------------------------------------

def _fma(a, b, c):
    """f32 a * b + c rounded once (the product is exact in f64)."""
    return (np.asarray(a, np.float64) * np.float64(b) + np.asarray(c, np.float64)).astype(F32)


def _ex2(x):
    with np.errstate(over="ignore"):          # lanes masked out afterwards
        return np.exp2(np.asarray(x, F32)).astype(F32)


class _Threads:
    """The running (m, m log2e, l) of a CTA's 256 threads."""

    def __init__(self):
        self.m = np.full(THREADS, NEG_INF, F32)
        self.ml = np.full(THREADS, F32(NEG_INF * LOG2E), F32)
        self.l = np.zeros(THREADS, F32)

    def add(self, x, valid):
        """Thread t folds in x[t] (W values) where valid[t]: l rescaled only
        where the max rises, then a pairwise sum of the exponentials."""
        mx = x.max(axis=1)
        rise = valid & (mx > self.m)
        self.l = np.where(rise, self.l * _ex2((self.m - mx) * LOG2E), self.l).astype(F32)
        self.m = np.where(rise, mx, self.m)
        self.ml = np.where(rise, (mx * LOG2E).astype(F32), self.ml)
        e = _ex2(_fma(x, LOG2E, -self.ml[:, None]))
        w = 1
        while w < e.shape[1]:
            e[:, 0::2 * w] = e[:, 0::2 * w] + e[:, w::2 * w]
            w *= 2
        self.l = np.where(valid, self.l + e[:, 0], self.l).astype(F32)


def _merge(m, l, m2, l2):
    mx = np.maximum(m, m2)
    return mx, (l * _ex2((m - mx) * LOG2E) + l2 * _ex2((m2 - mx) * LOG2E)).astype(F32)


def _cta(x, c0, c1, itemsize, row_byte):
    """(m, l) of the CTA that takes columns [c0, c1) of the row x (f32
    values), whose first element lies at byte ``row_byte`` of a 16-byte
    aligned allocation."""
    w = 16 // itemsize
    head = ((16 - (row_byte + c0 * itemsize) % 16) % 16) // itemsize
    tail = ((row_byte + c1 * itemsize) % 16) // itemsize
    a0, a1 = c0 + head, c1 - tail
    if a1 < a0:
        a0 = a1 = c1
    th = _Threads()
    lanes = np.arange(THREADS)
    for lo, hi in ((c0, a0), (a1, c1)):       # the scalar head, then tail
        vals = np.full((THREADS, 1), NEG_INF, F32)
        vals[:hi - lo, 0] = x[lo:hi]
        th.add(vals, lanes < hi - lo)
    vec = x[a0:a1].reshape(-1, w)             # vector j -> thread j % 256
    for k in range(0, len(vec), THREADS):
        step = np.full((THREADS, w), NEG_INF, F32)
        n = min(THREADS, len(vec) - k)
        step[:n] = vec[k:k + n]
        th.add(step, lanes < n)
    m, l = th.m, th.l
    for o in (16, 8, 4, 2, 1):                # a xor-shuffle tree a warp
        m, l = _merge(m, l, m[lanes ^ o], l[lanes ^ o])
    tm, tl = NEG_INF, F32(0)
    for wid in range(THREADS // 32):          # then the warps in order
        tm, tl = _merge(tm, tl, m[32 * wid], l[32 * wid])
    return F32(tm), F32(tl)


def emulate(x, labels, itemsize, sms=SMS, rescale=True):
    """Per-row losses of the kernel's arithmetic on x (R, V) f32 values of
    a tensor of ``itemsize``-byte elements, under the plan for ``sms``.
    ``rescale=False``: the merge sums the spans' l without e^(m_s - M)."""
    rows, vocab = x.shape
    dt = torch.float32 if itemsize == 4 else torch.bfloat16
    p = xent.xent_plan(rows, vocab, dt, sms)
    out = np.zeros(rows, F32)
    for r in range(rows):
        lab = int(labels[r])
        parts = []
        for s in range(p.n_split):
            c0, c1 = s * p.span, min(vocab, (s + 1) * p.span)
            m, l = _cta(x[r], c0, c1, itemsize, r * vocab * itemsize)
            # the label logit, read once, by the span that holds it
            pick = x[r, lab] if 0 <= lab < vocab and lab // p.span == s else F32(0)
            parts.append((m, l, F32(pick)))
        if p.n_split == 1:
            m, l, pick = parts[0]
        else:                                 # the merge, in split order
            m = max(q[0] for q in parts)
            l, pick = F32(0), F32(0)
            for ms, ls, ps in parts:
                l = F32(l + (ls * _ex2((ms - m) * LOG2E) if rescale else ls))
                pick = F32(pick + ps)
        out[r] = F32(m + LN2 * F32(np.log2(max(l, F32(1e-30)))) - pick)
    return out


def _inputs(rows, vocab, dtname, outside, seed=20):
    """Logits 5 * N(0, 1) as f32 values of a ``dtname`` tensor, and int32
    labels; with ``outside`` row 0's label is -1 and row 1's is V."""
    rng = np.random.default_rng(seed)
    t = torch.from_numpy((5.0 * rng.standard_normal((rows, vocab))).astype(F32))
    t = t.to(DTYPES[dtname])
    labels = rng.integers(0, vocab, rows).astype(np.int32)
    labels[0], labels[-1] = 0, vocab - 1          # the first and last spans
    if outside:
        labels[0] = -1
        labels[1 % rows] = vocab
    return t, t.float().numpy(), labels


#: the reference sweep's shapes, gemma3-27b's vocabulary split, a split
#: whose spans and rows are misaligned; each with a Pallas vocab tile
#: that divides V (a padded tile would make label V pick the padding)
CASES = [((7, 1000), 250), ((32, 50304), 12576), ((3, 130), 65),
         ((2, 262144), 16384), ((5, 4099), 4099)]


@pytest.mark.parametrize("shape,bv", CASES)
@pytest.mark.parametrize("dtname", list(DTYPES))
@pytest.mark.parametrize("outside", [False, True])
def test_emulated_kernel_matches_pallas_and_plain(shape, bv, dtname, outside):
    rows, vocab = shape
    t, x, labels = _inputs(rows, vocab, dtname, outside)
    got = emulate(x, labels, t.element_size())
    want = np.asarray(jxent.softmax_xent(jnp.asarray(x).astype(dtname),
                                         jnp.asarray(labels), block_vocab=bv,
                                         interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    inside = (labels >= 0) & (labels < vocab)
    plain = ref.softmax_xent(t[inside], torch.from_numpy(labels[inside])).numpy()
    np.testing.assert_allclose(got[inside], plain, rtol=RTOL, atol=ATOL)
    if outside:
        # a label outside the vocabulary picks nothing: the logsumexp
        lse = torch.logsumexp(t.float(), -1).numpy()
        np.testing.assert_allclose(got[~inside], lse[~inside], rtol=RTOL, atol=ATOL)


def test_the_split_cases_split():
    """The emulation above runs split plans with misaligned spans, and
    labels in the first and in the last span."""
    p = xent.xent_plan(2, 262144, torch.float32, SMS)
    assert p.n_split > 1
    q = xent.xent_plan(5, 4099, torch.bfloat16, SMS)
    assert q.n_split > 1 and (4099 * 2) % 16 and q.span % 8 == 0
    assert xent.xent_plan(32, 50304, torch.float32, SMS).n_split > 1


@pytest.mark.parametrize("dtname", list(DTYPES))
def test_merge_without_the_rescale_fails(dtname):
    """Summing the spans' l without e^(m_s - M) misses the tolerance: the
    emulation and its tolerance see the merge's rescale."""
    t, x, labels = _inputs(2, 262144, dtname, False)
    plain = ref.softmax_xent(t, torch.from_numpy(labels)).numpy()
    good = emulate(x, labels, t.element_size())
    bad = emulate(x, labels, t.element_size(), rescale=False)
    np.testing.assert_allclose(good, plain, rtol=RTOL, atol=ATOL)
    assert not np.allclose(bad, plain, rtol=RTOL, atol=ATOL)
