"""Standard (MHA/GQA) attention with a full-depth KV cache.

The port of the full-cache path of ``repro.models.attention``:
``init_attention``, ``_qkv``, ``attn_forward``, ``attn_prefill`` and
``attn_decode``. Prefill and forward attention run under the
``ng:gemm:flash_attention`` tag on both backends, as the JAX jnp twin is
tagged: the causal mask for the decoders, the full mask for the encoders
(``cfg.causal`` False) and the detector's cross-attention. Unfused decode on the kernel path is one untagged launch (classed
``fused``); on the plain path it is the tagged qk / mask / softmax / pv
chain of the JAX reference, op for op. Under ``nn.fuse()`` decode is the
one ``ng:fused:fused_attn_decode`` operator on both backends.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch import nn
from repro_torch.core.taxonomy import OpGroup
from repro_torch.kernels import ref
from repro_torch.models.common import ModelConfig, dense_init

NEG_INF = ref.NEG_INF


def pos_vector(pos, batch: int, device) -> torch.Tensor:
    """Normalize a decode position to a per-row ``(B,)`` int32 tensor.

    A scalar (all rows in lockstep) broadcasts; a ``(B,)`` vector
    (continuous batching: each slot at its own depth) passes through.
    """
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    if pos.dim() == 0:
        return pos.expand(batch)
    if pos.shape != (batch,):
        raise ValueError(f"pos must be scalar or ({batch},), got {tuple(pos.shape)}")
    return pos


def init_attention(generator: torch.Generator, cfg: ModelConfig) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    pd = cfg.torch_param_dtype
    p = {
        "wq": dense_init(generator, (d, hq * hd), dtype=pd),
        "wk": dense_init(generator, (d, hkv * hd), dtype=pd),
        "wv": dense_init(generator, (d, hkv * hd), dtype=pd),
        "wo": dense_init(generator, (hq * hd, d), dtype=pd),
    }
    if cfg.qkv_bias:
        dev = generator.device
        p["bq"] = torch.zeros((hq * hd,), dtype=pd, device=dev)
        p["bk"] = torch.zeros((hkv * hd,), dtype=pd, device=dev)
        p["bv"] = torch.zeros((hkv * hd,), dtype=pd, device=dev)
    return p


def _qkv(params, x, cfg: ModelConfig, positions):
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    q = nn.linear(x, params["wq"].to(x.dtype), params.get("bq"))
    k = nn.linear(x, params["wk"].to(x.dtype), params.get("bk"))
    v = nn.linear(x, params["wv"].to(x.dtype), params.get("bv"))
    q = nn.split_heads(q, hq)
    k = nn.split_heads(k, hkv)
    v = nn.split_heads(v, hkv)
    if cfg.pos_emb == "rope":
        q = nn.apply_rope(q, positions, base=cfg.rope_base,
                          fraction=cfg.rope_fraction)
        k = nn.apply_rope(k, positions, base=cfg.rope_base,
                          fraction=cfg.rope_fraction)
    return q, k, v


def _attention_impl(q, k, v, q_offset: int = 0, causal: bool = True):
    """Causal attention (the attention_core kernel) or full-mask attention
    (the attention_full kernel), or their plain version."""
    with nn.scope(OpGroup.GEMM, "flash_attention"):
        if nn.use_kernels(q):
            from repro_torch.kernels import ops as kops
            if causal:
                return kops.attention_core(q, k, v, q_offset=q_offset)
            return kops.attention_full(q, k, v)
        return ref.attention(q, k, v, q_offset=q_offset, causal=causal)


def attn_forward(params, x, cfg: ModelConfig, positions):
    """Full-sequence attention, causal or full as ``cfg.causal``.
    x: (B, S, D)."""
    q, k, v = _qkv(params, x, cfg, positions)
    out = _attention_impl(q, k, v, causal=cfg.causal)
    return nn.linear(nn.merge_heads(out), params["wo"].to(x.dtype))


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                    device="cuda") -> dict:
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    dt = cfg.activation_dtype
    return {
        "k": torch.zeros((batch, max_len, hkv, hd), dtype=dt, device=device),
        "v": torch.zeros((batch, max_len, hkv, hd), dtype=dt, device=device),
    }


def attn_prefill(params, x, cfg: ModelConfig, positions,
                 max_len: int) -> Tuple[torch.Tensor, dict]:
    """Full-sequence forward that also materializes the decode cache.

    x: (B, S, D) with S <= max_len. Under right-padding the pad KV past a
    row's length is never attended: decode masks ``arange <= pos`` per row
    and overwrites pads in place.
    """
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, cfg, positions)
    out = _attention_impl(q, k, v)
    y = nn.linear(nn.merge_heads(out), params["wo"].to(x.dtype))
    cache = init_attn_cache(cfg, b, max_len, device=x.device)
    cache["k"][:, :s] = k
    cache["v"][:, :s] = v
    return y, cache


def attn_decode(params, x, cfg: ModelConfig, cache: dict,
                pos) -> Tuple[torch.Tensor, dict]:
    """One-token decode. x: (B, 1, D); pos: scalar or per-row (B,).

    The cache is updated in place and returned.
    """
    b = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = hq // hkv
    pos = pos_vector(pos, b, x.device)
    positions = pos[:, None]
    q, k_new, v_new = _qkv(params, x, cfg, positions)
    k = nn.kv_cache_update(cache["k"], k_new, pos)
    v = nn.kv_cache_update(cache["v"], v_new, pos)
    wo = params["wo"].to(x.dtype)

    if nn.fusion_enabled():
        o = nn.fused_attn_decode(q, k, v, (pos + 1).to(torch.int32))
        o = o.reshape(b, 1, hq * hd).to(x.dtype)
        return nn.linear(o, wo), cache
    if nn.use_kernels(q):
        from repro_torch.kernels import ops as kops
        o = kops.decode_core(q, k, v, (pos + 1).to(torch.int32))
        o = o.reshape(b, 1, hq * hd).to(x.dtype)
        return nn.linear(o, wo), cache

    t = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qh = q.reshape(b, hkv, g, hd)
    with nn.scope(OpGroup.GEMM, "attn_qk"):
        s = torch.einsum("bkgd,btkd->bkgt", qh.float(), k.float()) * scale
    with nn.scope(OpGroup.ELEMENTWISE, "attn_mask"):
        valid = torch.arange(t, device=x.device)[None, :] <= pos[:, None]
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = nn.softmax(s, dim=-1)
    with nn.scope(OpGroup.GEMM, "attn_pv"):
        o = torch.einsum("bkgt,btkd->bkgd", p.to(v.dtype).float(), v.float())
    o = o.reshape(b, 1, hq * hd).to(x.dtype)
    return nn.linear(o, wo), cache
