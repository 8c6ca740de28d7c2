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


def attention(q, k, v, q_offset: int = 0,
              scale: Optional[float] = None) -> torch.Tensor:
    """Naive full-matrix causal GQA attention (the causal fragment of
    ``repro.kernels.ref.attention``).

    q: (B,Sq,Hq,Dk); k: (B,Skv,Hkv,Dk); v: (B,Skv,Hkv,Dv) -> (B,Sq,Hq,Dv);
    query row i sits at position ``q_offset + i``. A query row with no
    visible key yields exact zeros.
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    dv = v.shape[-1]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qf = q.reshape(b, sq, hkv, g, d).float()
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, k.float()) * scale
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    mask = (qpos[:, None] >= kpos[None, :])[None]
    mb = mask[:, None, None]                       # (1,1,1,Sq,Skv)
    s = torch.where(mb, s, NEG_INF)
    p = torch.where(mb.any(dim=-1, keepdim=True), torch.softmax(s, dim=-1),
                    0.0)
    o = torch.einsum("bkgqt,btkd->bkgqd", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dv).to(v.dtype)


def decode_attention(q, k, v, lengths: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One-query decode over a per-row valid KV prefix -> f32 (B,1,Hq,Dv).

    Mirrors the unfused decode chain of ``models.attention.attn_decode``
    (grouped einsums, the max-shift softmax).
    """
    b, _, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qh = q.reshape(b, hkv, g, d)
    s = torch.einsum("bkgd,btkd->bkgt", qh.float(), k.float()) * scale
    lv = lengths.to(device=q.device, dtype=torch.int64).reshape(b)
    valid = torch.arange(t, device=q.device)[None, :] < lv[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / torch.sum(e, dim=-1, keepdim=True)
    p = torch.where(valid.any(dim=-1)[:, None, None, None], p, 0.0)
    o = torch.einsum("bkgt,btkd->bkgd", p.to(v.dtype).float(), v.float())
    return o.reshape(b, 1, hq, dv)
