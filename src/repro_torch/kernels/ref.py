"""Plain PyTorch versions of the hand-written kernels (the correctness
ground truth).

Each mirrors its ``repro.kernels.ref`` twin operation for operation. The
CPU tests hold them against the JAX oracles, the kernel wrappers take them
for CPU tensors, and ``chip_smoke.py`` holds every kernel against them on
the card. They carry no scope tags and no backend switch.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

#: finite, so ``exp(m_prev - m_new)`` never meets ``-inf - -inf``
NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = False) -> torch.Tensor:
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    s = scale.float()
    y = y * (1.0 + s) if zero_centered else y * s
    return y.to(x.dtype)


def fused_add_rms_norm(x, residual, scale, eps: float = 1e-6,
                       zero_centered: bool = False):
    """``(rms_norm(r), r)`` with ``r = x + residual`` added in f32 and
    rounded once to ``x``'s dtype; the norm reads the rounded ``r``."""
    r = (x.float() + residual.float()).to(x.dtype)
    return rms_norm(r, scale, eps=eps, zero_centered=zero_centered), r


def dequant_add_rms_norm(q, qscale, residual, scale, eps: float = 1e-6,
                         zero_centered: bool = False):
    """``(rms_norm(r), r)`` with ``r = q * qscale + residual``: the int8
    ``q`` dequantized by the scalar f32 ``qscale`` and added to the residual
    in f32 (a multiply, then an add, each rounded in f32), the sum rounded
    once to ``residual``'s dtype; the norm reads the rounded ``r``."""
    qs = torch.as_tensor(qscale, dtype=torch.float32, device=q.device)
    r = (q.float() * qs + residual.float()).to(residual.dtype)
    return rms_norm(r, scale, eps=eps, zero_centered=zero_centered), r


def layer_norm(x, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 with the two-pass variance ``mean((x - mean)^2)``."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def fused_add_layer_norm(x, residual, scale, bias, eps: float = 1e-5):
    """LayerNorm twin of :func:`fused_add_rms_norm`: ``(layer_norm(r), r)``."""
    r = (x.float() + residual.float()).to(x.dtype)
    return layer_norm(r, scale, bias, eps=eps), r


def rope(x, positions, base: float = 10000.0,
         fraction: float = 1.0) -> torch.Tensor:
    """Rotate-halves rotary embedding on (B, S, H, D) over the leading
    ``fraction`` of D, angles ``pos * base^(-i/half)`` in f32; the tail
    passes through. ``positions`` is (B, S) (or broadcasts to it)."""
    d = x.shape[-1]
    rot = int(d * fraction) // 2 * 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    freq = base ** (-torch.arange(0, half, dtype=torch.float32,
                                  device=x.device) / half)
    theta = positions[..., None].float() * freq
    cos = torch.cos(theta)[:, :, None, :]
    sin = torch.sin(theta)[:, :, None, :]
    x1 = x_rot[..., :half].float()
    x2 = x_rot[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1) \
        if rot < d else out.to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    gf = gate.float()
    return (gf * torch.sigmoid(gf) * up.float()).to(gate.dtype)


def geglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``gelu_tanh(gate) * up`` in f32, rounded once to ``gate``'s dtype:
    the function of ``repro.kernels.swiglu._geglu_kernel``."""
    gf = gate.float()
    return (F.gelu(gf, approximate="tanh") * up.float()).to(gate.dtype)


def cap_scores(s: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """``tanh(s / cap) * cap`` (scores as they are where ``cap`` is None):
    the logit cap of ``repro.kernels.ref`` and ``_online_softmax_step``,
    on natural-unit scores, after the scale and before the mask."""
    return s if cap is None else torch.tanh(s / cap) * cap


def attention(q, k, v, q_offset: int = 0, scale: Optional[float] = None,
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None) -> torch.Tensor:
    """Naive full-matrix GQA attention (the causal, window and full
    fragments of ``repro.kernels.ref.attention``).

    q: (B,Sq,Hq,Dk); k: (B,Skv,Hkv,Dk); v: (B,Skv,Hkv,Dv) -> (B,Sq,Hq,Dv).
    ``causal``: query row i sits at position ``q_offset + i`` and sees keys
    up to it; ``window`` further limits it to keys with
    ``qpos - kpos < window`` (the sliding window of the ``local`` layers).
    ``causal=False`` is the full mask (encoders, cross-attention with
    ``Sq != Skv``): every key is visible and ``q_offset`` has no effect.
    ``softcap``: the scores are capped (:func:`cap_scores`) before the mask. A
    query row with no visible key yields exact zeros.
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    dv = v.shape[-1]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qf = q.reshape(b, sq, hkv, g, d).float()
    s = cap_scores(torch.einsum("bqkgd,btkd->bkgqt", qf, k.float()) * scale,
             softcap)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    if causal:
        mask = mask & (qpos[:, None] >= kpos[None, :])
    if window is not None:
        mask = mask & ((qpos[:, None] - kpos[None, :]) < window)
    mb = mask[None, None, None]                    # (1,1,1,Sq,Skv)
    s = torch.where(mb, s, NEG_INF)
    p = torch.where(mb.any(dim=-1, keepdim=True), torch.softmax(s, dim=-1),
                    0.0)
    o = torch.einsum("bkgqt,btkd->bkgqd", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dv).to(v.dtype)


def _flash_mask(sq: int, skv: int, causal: bool, window: Optional[int],
                q_offset: int, device) -> torch.Tensor:
    """(Sq, Skv) bool: which key each query row sees, as ``mask_for`` of
    ``repro.models.attention._flash_fwd_impl`` (query row i at position
    ``q_offset + i``)."""
    qpos = q_offset + torch.arange(sq, device=device)
    kpos = torch.arange(skv, device=device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (qpos[:, None] >= kpos[None, :])
    if window is not None:
        mask = mask & ((qpos[:, None] - kpos[None, :]) < window)
    return mask


def _grouped(t: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, S, Hq, D) -> (B, Hkv, G, S, D) f32: query heads by KV head."""
    b, s, hq, d = t.shape
    return t.float().reshape(b, s, hkv, hq // hkv, d).permute(0, 2, 3, 1, 4)


def _ungrouped(t: torch.Tensor) -> torch.Tensor:
    """(B, Hkv, G, S, D) -> (B, S, Hq, D), contiguous."""
    b, hkv, g, s, d = t.shape
    return t.permute(0, 3, 1, 2, 4).reshape(b, s, hkv * g, d).contiguous()


def attention_fwd_lse(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None, q_offset: int = 0,
                      scale: Optional[float] = None):
    """Attention and each row's log-sum-exp: ``(out (B,Sq,Hq,Dv) in v's
    dtype, lse (B,Hq,Sq) f32)``, the values of
    ``repro.models.attention._flash_fwd_impl`` (GQA by index, KV head
    ``h // (Hq / Hkv)``). ``lse = m + log(l)`` of the row's masked scores;
    a row that sees no key gives zeros and ``lse`` :data:`NEG_INF`."""
    b, sq, hq, dk = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(dk) if scale is None else scale
    mask = _flash_mask(sq, skv, causal, window, q_offset, q.device)
    s = torch.einsum("bkgqd,bktd->bkgqt", _grouped(q, hkv),
                     k.float().permute(0, 2, 1, 3)) * scale
    s = torch.where(mask, s, NEG_INF)
    seen = mask.any(dim=-1)                                  # (Sq,)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bkgqt,bktd->bkgqd", p, v.float().permute(0, 2, 1, 3))
    o = torch.where(seen[:, None], o / torch.clamp(l, min=1e-30)[..., None],
                    0.0)
    lse = torch.where(seen, m[..., 0] + torch.log(torch.clamp(l, min=1e-30)),
                      NEG_INF)
    return _ungrouped(o).to(v.dtype), lse.reshape(b, hq, sq).contiguous()


def attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                  window: Optional[int] = None, q_offset: int = 0,
                  scale: Optional[float] = None):
    """The flash backward: ``(dq, dk, dv)`` in q's, k's and v's dtypes, with
    the arithmetic of ``repro.models.attention._flash_bwd_impl``: delta =
    rowsum(dO * O) in f32, p = exp(s - lse) of the f32 scores, dp = dO V^T,
    ds = p * (dp - delta) * scale rounded to q's dtype before its two
    products, p rounded to dO's dtype for dV, every product accumulated in
    f32. GQA: dK and dV of a KV head sum its query heads' in f32, rounded
    once (JAX rounds each head's before its head gather's transpose sums
    them). A masked (q, k) pair gives exactly 0, so a row that sees no key
    has zero gradients (JAX's exp(NEG_INF - lse) reads 1 there)."""
    b, sq, hq, dk = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(dk) if scale is None else scale
    mask = _flash_mask(sq, skv, causal, window, q_offset, q.device)
    qg, dog, og = _grouped(q, hkv), _grouped(dout, hkv), _grouped(out, hkv)
    kf = k.float().permute(0, 2, 1, 3)                       # (B,Hkv,T,D)
    vf = v.float().permute(0, 2, 1, 3)
    g = hq // hkv
    lse_g = lse.float().reshape(b, hkv, g, sq)
    delta = torch.sum(dog * og, dim=-1)                      # (B,Hkv,G,Sq)
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, kf) * scale
    p = torch.where(mask, torch.exp(s - lse_g[..., None]), 0.0)
    dp = torch.einsum("bkgqd,bktd->bkgqt", dog, vf)
    ds = torch.where(mask, p * (dp - delta[..., None]) * scale, 0.0)
    dsb = ds.to(q.dtype).float()
    dq = torch.einsum("bkgqt,bktd->bkgqd", dsb, kf)
    dkf = torch.einsum("bkgqt,bkgqd->bktd", dsb, qg)
    dvf = torch.einsum("bkgqt,bkgqd->bktd", p.to(dout.dtype).float(), dog)
    return (_ungrouped(dq).to(q.dtype),
            dkf.permute(0, 2, 1, 3).contiguous().to(k.dtype),
            dvf.permute(0, 2, 1, 3).contiguous().to(v.dtype))


def decode_attention(q, k, v, lengths: torch.Tensor,
                     scale: Optional[float] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """One-query decode over a per-row valid KV prefix -> f32 (B,1,Hq,Dv).

    Mirrors the unfused decode chain of ``models.attention.attn_decode``
    (grouped einsums, the cap where ``softcap`` is given, the max-shift
    softmax).
    """
    b, _, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qh = q.reshape(b, hkv, g, d)
    s = cap_scores(torch.einsum("bkgd,btkd->bkgt", qh.float(), k.float())
                   * scale, softcap)
    lv = lengths.to(device=q.device, dtype=torch.int64).reshape(b)
    valid = torch.arange(t, device=q.device)[None, :] < lv[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / torch.sum(e, dim=-1, keepdim=True)
    p = torch.where(valid.any(dim=-1)[:, None, None, None], p, 0.0)
    o = torch.einsum("bkgt,btkd->bkgd", p.to(v.dtype).float(), v.float())
    return o.reshape(b, 1, hq, dv)


def paged_kv_gather(pool, block_table, max_len: int) -> torch.Tensor:
    """The contiguous (B, max_len, ...) view of paged KV blocks: pool
    (N, bs, ...), block_table (B, nb) int pool block ids (0, the scratch
    block, where a sequence owns none). One gather of the view's rows, so
    the result is contiguous whatever ``max_len % bs`` is (the kernels
    refuse strided operands)."""
    bs = pool.shape[1]
    b, nb = block_table.shape
    if not 0 < max_len <= nb * bs:
        raise ValueError(f"paged_kv_gather: max_len {max_len} outside "
                         f"[1, {nb * bs}]")
    pos = torch.arange(max_len, device=pool.device)
    flat = block_table.long()[:, pos // bs] * bs + pos % bs      # (B, max_len)
    return pool.reshape(-1, *pool.shape[2:])[flat]


def paged_kv_write(pool, new, block_table, index):
    """Write one decode row per sequence into its paged block, in place,
    and return ``pool``: row b of ``new`` (B, 1, ...) lands in block
    ``block_table[b, index[b] // bs]`` at offset ``index[b] % bs``. Rows
    whose table entry is 0 all land in the scratch block; which of them
    stays there is unspecified, and no unmasked read ever touches it."""
    bs = pool.shape[1]
    index = torch.as_tensor(index, device=pool.device).long().reshape(-1)
    rows = torch.arange(block_table.shape[0], device=pool.device)
    block_ids = block_table.long()[rows, index // bs]
    pool[block_ids, index % bs] = new[:, 0].to(pool.dtype)
    return pool


def paged_kv_scatter(pool, rows, block_table, start, lo, hi):
    """Write a prefill chunk ``rows`` (R, ...) at positions start + arange(R)
    of one sequence's table row (nb,), in place, and return ``pool``.
    Positions outside [lo, hi) (the reused prefix on the left, padding past
    the prompt on the right) divert to the scratch block 0, at offset
    ``position % bs``; several may land on one slot there."""
    bs, n = pool.shape[1], pool.shape[0]
    nb = block_table.shape[0]
    idx = start + torch.arange(rows.shape[0], device=pool.device)
    blk = block_table.long()[torch.clamp(idx // bs, 0, nb - 1)]
    keep = (idx >= lo) & (idx < hi)
    flat = torch.where(keep, blk * bs + idx % bs, idx % bs)
    pool.view(n * bs, *pool.shape[2:])[flat] = rows.to(pool.dtype)
    return pool


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row cross-entropy, logits (R, V) of any float dtype and labels
    (R,) integers in [0, V) -> (R,) f32: ``logsumexp(row) - row[label]``."""
    lf = logits.float()
    m = torch.amax(lf, dim=-1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    picked = torch.gather(lf, -1, labels.long()[:, None])[:, 0]
    return lse - picked


def interpolate_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear NCHW resize, align_corners=False: the naive four-corner
    form (each corner gathered on its own), f32 math, ``x.dtype`` out.
    The oracle of ``nn.interpolate_bilinear``'s hoisted-gather version."""
    _, _, h, w = x.shape
    oh, ow = out_hw
    y0, y1, x0, x1, wy, wx = bilinear_taps(h, w, oh, ow, x.device)
    xf = x.float()
    top = xf[:, :, y0][:, :, :, x0] * (1 - wx) + xf[:, :, y0][:, :, :, x1] * wx
    bot = xf[:, :, y1][:, :, :, x0] * (1 - wx) + xf[:, :, y1][:, :, :, x1] * wx
    return (top * (1 - wy) + bot * wy).to(x.dtype)


def bilinear_taps(h: int, w: int, oh: int, ow: int, device):
    """Corner indices and weights of an align_corners=False resize from
    (h, w) to (oh, ow), in f32 as the JAX ops compute them:
    ``(y0, y1, x0, x1, wy (OH, 1), wx (OW,))``."""
    ys = (torch.arange(oh, dtype=torch.float32, device=device) + 0.5) \
        * (h / oh) - 0.5
    xs = (torch.arange(ow, dtype=torch.float32, device=device) + 0.5) \
        * (w / ow) - 0.5
    y0 = torch.clamp(torch.floor(ys), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0)[:, None]
    wx = torch.clamp(xs - x0, 0.0, 1.0)
    y0, y1, x0, x1 = (a.long() for a in (y0, y1, x0, x1))
    return y0, y1, x0, x1, wy, wx


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(N, N) IoU of xyxy boxes in f32, each product and sum rounded on its
    own; 0 where the union is not positive."""
    b = boxes.float()
    x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    ix1 = torch.maximum(x1[:, None], x1[None, :])
    iy1 = torch.maximum(y1[:, None], y1[None, :])
    ix2 = torch.minimum(x2[:, None], x2[None, :])
    iy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    union = area[:, None] + area[None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def nms_sorted(boxes_sorted: torch.Tensor, valid: torch.Tensor,
               iou_threshold: float = 0.5) -> torch.Tensor:
    """Greedy NMS over score-descending xyxy boxes (N, 4) with a (N,) bool
    ``valid`` mask -> keep mask (N,) bool: box i, while kept and valid,
    suppresses every later box whose IoU with it is above the threshold."""
    n = boxes_sorted.shape[0]
    iou = iou_matrix(boxes_sorted)
    idx = torch.arange(n, device=boxes_sorted.device)
    keep = valid.clone()
    for i in range(n):
        alive = keep[i] & valid[i]
        keep &= ~((iou[i] > iou_threshold) & (idx > i) & alive)
    return keep


def nms_order(scores: torch.Tensor) -> torch.Tensor:
    """Indices of ``scores`` in descending order, ties in index order.

    A stable sort, as ``jnp.argsort(-scores)``; ``torch.topk`` and an
    unstable sort promise no order among equal scores, and the detector's
    peak mask makes ties (zeroed cells) certain."""
    return torch.sort(scores, descending=True, stable=True).indices


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
        score_threshold: float = 0.0) -> torch.Tensor:
    """Greedy NMS keep mask (N,), torchvision semantics, boxes (N, 4) xyxy."""
    order = nms_order(scores)
    keep_sorted = nms_sorted(boxes[order], scores[order] > score_threshold,
                             iou_threshold)
    # out of place, as JAX's ``.at[order].set``
    return torch.zeros_like(keep_sorted).scatter(0, order, keep_sorted)
