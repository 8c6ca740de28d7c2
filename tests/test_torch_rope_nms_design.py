"""The rope kernel's launch plan and the NMS kernel's design, held against
the JAX package on the CPU.

``csrc/rope.cu`` runs the plan ``repro_torch.kernels.rope.rope_plan``
picks from the shapes alone: a CTA of T threads takes R rows at a time
over all their heads, one vector a thread (in chunks beyond T), and walks
the rows by a grid stride where they are many. Its properties are checked
over a grid of shapes by emulating the kernel's mapping of threads to
(row, head, vector).

``csrc/nms.cu`` computes an IoU bitmask (bit j of row i's word j / 64 set
iff j > i and iou(i, j) > thr, valid rows only) and then a blocked greedy
reduce: per block of 64 candidates, the kept set iterated to its fixpoint
from the block's diagonal words, and the kept rows' words ORed into the
removed set of the later blocks. Both are emulated here in numpy f32, the
IoU one rounded operation at a time, and the keep masks held bit-identical
to the Pallas kernel ``repro.kernels.nms.nms_sorted`` in interpret mode
and to the port's plain version, on the same numpy inputs.
"""

import importlib.util
import inspect
from fractions import Fraction
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import nms as jnms  # noqa: E402
from repro_torch.kernels import ref, rope  # noqa: E402

SMS = 132                                   # an H100 SXM

# -- rope's plan ---------------------------------------------------------------

ROWS = [1, 3, 4, 21, 257, 2048, 2049, 5000]
HEADS = [1, 3, 16, 25, 32, 72]
#: (D, half): llama / gemma3 heads, gpt2-xl's 64 at fraction 0.25 and 1,
#: odd head dims (scalar), half 48, wide heads, the 6144 limit, no rotation
DIMS = [(128, 64), (64, 8), (64, 32), (34, 17), (96, 48), (256, 128),
        (12289, 6144), (8192, 4096), (64, 0)]


def _plans():
    for dt in (torch.float32, torch.bfloat16):
        v = 16 // dt.itemsize
        for d, half in DIMS:
            for vec in (True, False):
                if vec and (half % v or d % v):
                    continue
                for sms in (1, SMS):
                    yield dt, d, half, vec, sms


def _coverage(rows, h, half, p):
    """How often the kernel's threads visit each (row, head, vector) under
    plan ``p``, flattened: CTA b walks the steps r0 = b * R, b * R +
    grid * R, ...; in each step, thread t of chunk c takes idx = c * T + t
    while idx < R * h * hv, as (row r0 + idx // (h * hv), head, vector)."""
    hv = half // p.width
    items = p.rows_per_cta * h * hv
    if items == 0:
        return np.zeros(0, np.int64)
    n_chunk = max(1, -(-items // p.threads))
    idx = np.arange(n_chunk * p.threads)
    idx = idx[idx < items]
    r, rem = np.divmod(idx, h * hv)
    hh, iv = np.divmod(rem, hv)
    hits = []
    for b in range(p.grid):
        r0 = np.arange(b * p.rows_per_cta, rows, p.grid * p.rows_per_cta)
        row = (r0[:, None] + r[None]).ravel()
        flat = (row * h + np.tile(hh, len(r0))) * hv + np.tile(iv, len(r0))
        hits.append(flat[row < rows])
    flat = np.concatenate(hits) if hits else np.zeros(0, np.int64)
    return np.bincount(flat, minlength=rows * h * hv)


@pytest.mark.parametrize("dt,d,half,vec,sms", list(_plans()))
def test_rope_plan_properties(dt, d, half, vec, sms):
    v = 16 // dt.itemsize if vec else 1
    for rows in ROWS:
        for h in HEADS:
            if rows * h * half > 1 << 22:    # keep the emulation small
                continue
            p = rope.rope_plan(rows, h, d, half, dt, vec, sms)
            assert p.width == v
            assert 32 <= p.threads <= rope.MAX_THREADS and p.threads % 32 == 0
            assert 1 <= p.rows_per_cta <= rope.MAX_ROWS_PER_CTA
            assert p.grid >= 1
            assert rope.smem_bytes(p, rows, half) <= 48 * 1024
            steps = -(-rows // p.rows_per_cta)
            assert p.grid <= steps
            if p.grid < steps:        # a walking grid is all resident at once
                assert p.grid <= sms * max(1, rope.SM_THREADS // p.threads)
            # every (row, head, vector) once
            seen = _coverage(rows, h, half, p)
            assert (seen == 1).all()


def test_rope_plan_reads_no_tensor():
    """The plan's arguments are shapes, a dtype, a flag and a count: it
    can read no tensor, and so cannot wait on the card. A meta tensor,
    which holds no data, plans as a real one."""
    params = inspect.signature(rope.rope_plan).parameters
    assert list(params) == ["rows", "h", "d", "half", "dtype", "vec", "sms"]
    x = torch.empty((1, 2048, 32, 128), dtype=torch.bfloat16, device="meta")
    assert rope._vec_ok(64, 128, torch.bfloat16, x.data_ptr())
    assert rope.rope_plan(2048, 32, 128, 64, torch.bfloat16, True, SMS) == \
        rope.RopePlan(8, 256, 1, 528)


@pytest.mark.parametrize("rows,h,d,half,dt,want", [
    (4, 32, 128, 64, torch.bfloat16, (256, 1, 4)),        # the decode step
    (2048, 32, 128, 64, torch.bfloat16, (256, 1, 528)),   # gemma3-27b q, walked
    (2048, 16, 128, 64, torch.bfloat16, (256, 2, 528)),   # its k, two rows a step
    (256, 32, 128, 64, torch.bfloat16, (256, 1, 256)),    # llama2-7b prefill
    (2048, 32, 128, 64, torch.float32, (512, 1, 264)),
    (3, 2, 12289, 6144, torch.float32, (1024, 1, 3)),     # half 6144, in chunks
])
def test_rope_plan_at_the_main_path_shapes(rows, h, d, half, dt, want):
    p = rope.rope_plan(rows, h, d, half, dt, d % 2 == 0, SMS)
    assert (p.threads, p.rows_per_cta, p.grid) == want


# -- NMS: the mask and the blocked reduce ------------------------------------

def _area(b):
    return (np.maximum(b[..., 2] - b[..., 0], np.float32(0))
            * np.maximum(b[..., 3] - b[..., 1], np.float32(0)))


def _mask(boxes, valid, thr):
    """(n, W) uint64 words: bit j of word j // 64 of row i is set iff
    valid[i], j > i and iou(i, j) > thr, the IoU as the kernel's mask
    phase rounds it (fminf / fmaxf, then one f32 op at a time)."""
    n = len(boxes)
    w = -(-n // 64)
    area = _area(boxes)
    words = np.zeros((n, w), np.uint64)
    thr = np.float32(thr)
    zero = np.float32(0)
    for i in np.nonzero(valid)[0]:
        b = boxes[i]
        j = np.arange(i + 1, n)
        c = boxes[j]
        iw = np.maximum(np.minimum(c[:, 2], b[2]) - np.maximum(c[:, 0], b[0]), zero)
        ih = np.maximum(np.minimum(c[:, 3], b[3]) - np.maximum(c[:, 1], b[1]), zero)
        inter = iw * ih
        uni = (area[j] + area[i]) - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = np.where(uni > zero, inter / uni, zero)
        hit = j[iou > thr]
        np.bitwise_or.at(words[i], hit // 64, np.uint64(1) << (hit % 64).astype(np.uint64))
    return words


def _blocked_reduce(words, valid):
    """The kernel's reduce: per block c, K = valid & ~removed[c] &
    ~OR{diag[k] : k in K} iterated to its fixpoint, then the kept rows'
    words for the later blocks ORed into the removed set."""
    n, w = words.shape
    vbits = np.zeros(w, np.uint64)
    for i in np.nonzero(valid)[0]:
        vbits[i // 64] |= np.uint64(1) << np.uint64(i % 64)
    removed = np.zeros(w, np.uint64)
    keep = np.zeros(n, bool)
    for c in range(w):
        rows = np.arange(c * 64, min(n, c * 64 + 64))
        diag = np.where(valid[rows], words[rows, c], np.uint64(0))
        cand = vbits[c] & ~removed[c]
        kept = cand
        while True:
            sup = np.uint64(0)
            for k in range(len(rows)):
                if kept >> np.uint64(k) & np.uint64(1):
                    sup |= diag[k]
            new = cand & ~sup
            if new == kept:
                break
            kept = new
        ks = [k for k in range(len(rows)) if kept >> np.uint64(k) & np.uint64(1)]
        for k in ks:
            keep[c * 64 + k] = True
            removed[c + 1:] |= words[c * 64 + k, c + 1:]
    return keep


def _random_boxes(rng, n, span=60.0):
    centers = rng.uniform(size=(n, 2)) * span
    wh = rng.uniform(size=(n, 2)) * 12 + 1
    return (np.concatenate([centers - wh / 2, centers + wh / 2], -1)
            .astype(np.float32), rng.uniform(size=n).astype(np.float32))


def _case(kind, n):
    """tests/test_torch_kernels.py's NMS cases at ``n`` boxes: (boxes,
    scores, iou threshold, score threshold)."""
    rng = np.random.default_rng(n)
    boxes, scores = _random_boxes(rng, n, span=2 * np.sqrt(n) + 20)
    thr, score_thr = 0.5, 0.0
    if kind == "zero_area":
        boxes[:2] = [[5, 5, 5, 5], [9, 9, 3, 3]][:n]
    elif kind == "duplicate_scores":
        scores = np.array([0.5, 0.9, 0.1] * n, np.float32)[:n]
    elif kind == "all_suppressed":
        boxes = (np.array([10, 10, 20, 20], np.float32)
                 + rng.uniform(size=(n, 4)).astype(np.float32) * 0.1)
        scores, thr = np.linspace(0.9, 0.1, n).astype(np.float32), 0.3
    elif kind == "none_suppressed":
        off = np.arange(n, dtype=np.float32) * 30
        boxes = np.stack([off, off, off + 10, off + 10], -1)
    elif kind == "threshold_above_one":
        thr = 1.5
    elif kind == "score_threshold":
        score_thr = 0.4
    elif kind == "near_threshold_pairs":
        # pairs a third of their width apart: IoU 1/2 up to rounding
        x, y = rng.uniform(0, 40, (2, n))
        w, h = rng.uniform(5, 50, (2, n))
        ox, oy = (np.arange(n) % 32) * 100.0, (np.arange(n) // 32) * 100.0
        a = np.stack([ox + x, oy + y, ox + x + w, oy + y + h], -1)
        b = a + np.stack([w / 3, 0 * w, w / 3, 0 * w], -1)
        boxes = np.stack([a, b], 1).reshape(-1, 4)[:n].astype(np.float32)
        scores = np.linspace(0.99, 0.5, n).astype(np.float32)
    elif kind == "exact_threshold_pairs" and n >= 4:
        # f32 IoU exactly 0.5 (kept) and one ulp above (suppressed), far
        # from the rest, at sorted places across word boundaries where n
        # allows
        s = np.nextafter(np.float32(1 / 3), np.float32(0))
        scores = np.linspace(0.99, 0.01, n).astype(np.float32)
        a = 63 if n > 64 else 0
        b = 127 if n > 128 else 2
        boxes[a:a + 2] = [[10010, 0, 10013, 1], [10011, 0, 10014, 1]]
        boxes[b:b + 2] = [[0, 1000, 1, 1001], [s, 1000, np.float32(s + 1), 1001]]
    return boxes, scores, thr, score_thr


NMS_KINDS = ["random", "zero_area", "duplicate_scores", "all_suppressed",
             "none_suppressed", "threshold_above_one", "score_threshold",
             "near_threshold_pairs", "exact_threshold_pairs"]
NMS_SIZES = [1, 63, 64, 65, 127, 128, 129, 383]


@pytest.mark.parametrize("n", NMS_SIZES)
@pytest.mark.parametrize("kind", NMS_KINDS)
def test_nms_design_matches_pallas(kind, n):
    boxes, scores, thr, score_thr = _case(kind, n)
    order = np.argsort(-scores, kind="stable")
    sb = boxes[order]
    # every third sorted candidate invalid besides the score threshold,
    # the exact-threshold pairs kept valid
    valid = (scores[order] > score_thr) & (np.arange(n) % 3 != 1)
    if kind == "exact_threshold_pairs" and n >= 4:
        pairs = [63, 64] if n > 64 else [0, 1]
        pairs += [127, 128] if n > 128 else [2, 3]
        valid[pairs] = True
    want = np.asarray(jnms.nms_sorted(jnp.asarray(sb), jnp.asarray(valid),
                                      iou_threshold=thr, interpret=True))
    words = _mask(sb, valid, thr)
    got = _blocked_reduce(words, valid)
    np.testing.assert_array_equal(got, want)
    plain = ref.nms_sorted(torch.from_numpy(sb), torch.from_numpy(valid), thr)
    np.testing.assert_array_equal(plain.numpy(), want)
    if kind == "exact_threshold_pairs" and n >= 4:
        assert got[pairs[1]] and not got[pairs[3]]


# -- NMS: pairs an FMA would move across the threshold -------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _exact_iou(a, b, fuse):
    """iou(a, b), a the higher-scored box, in exact arithmetic rounded to
    f32 after each op, as the kernel rounds it; ``fuse`` names a product
    left unrounded in its sum, as nvcc's FMA contraction would leave it:
    "uni" in (area_b + area_a) - iw * ih, "area" in area_b + area_a."""
    r = _round32

    def area(x):
        p, q = r(max(r(x[2] - x[0]), 0)), r(max(r(x[3] - x[1]), 0))
        return p, q, r(p * q)

    a, b = [list(map(Fraction, map(float, x))) for x in (a, b)]
    pa, qa, aa = area(a)
    _, _, ab = area(b)
    iw = r(max(r(min(b[2], a[2]) - max(b[0], a[0])), 0))
    ih = r(max(r(min(b[3], a[3]) - max(b[1], a[1])), 0))
    inter = r(iw * ih)
    s = r(ab + pa * qa) if fuse == "area" else r(ab + aa)
    uni = r(s - iw * ih) if fuse == "uni" else r(s - inter)
    return r(inter / uni) if uni > 0 else Fraction(0)


def _round32(v):
    """Round a Fraction to the nearest f32, ties to even (24-bit mantissa)."""
    if v == 0:
        return Fraction(0)
    sign, v = (-1 if v < 0 else 1), abs(v)
    e = v.numerator.bit_length() - v.denominator.bit_length()
    if Fraction(2) ** e > v:
        e -= 1
    ulp = Fraction(2) ** (e - 23)
    m, rem = divmod(v, ulp)
    if rem > ulp / 2 or (rem == ulp / 2 and m % 2):
        m += 1
    return sign * m * ulp


def test_fma_sensitive_pairs_fall_both_ways():
    """chip_smoke.py's FMA_PAIRS: with each op rounded, each pair's IoU
    falls on the side the pair says; with the product fused (the first four
    in the union, the others in the area sum) on the other side. So the
    keep mask of a kernel whose arithmetic nvcc contracts differs."""
    cs = _chip_smoke()
    half = Fraction(1, 2)
    for k, (a, b, suppressed) in enumerate(cs.FMA_PAIRS):
        a = [float.fromhex(v) for v in a]
        b = [float.fromhex(v) for v in b]
        assert (_exact_iou(a, b, None) > half) == suppressed
        assert (_exact_iou(a, b, "uni" if k < 4 else "area") > half) != suppressed


def test_fma_sensitive_pairs_match_pallas():
    cs = _chip_smoke()
    boxes, keep = cs.fma_pairs()
    valid = np.ones(len(boxes), bool)
    want = np.asarray(jnms.nms_sorted(jnp.asarray(boxes), jnp.asarray(valid),
                                      iou_threshold=0.5, interpret=True))
    np.testing.assert_array_equal(want, keep)
    np.testing.assert_array_equal(_blocked_reduce(_mask(boxes, valid, 0.5), valid), keep)
