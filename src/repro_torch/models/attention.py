"""Standard (MHA/GQA) attention: global layers with a full-depth KV cache,
sliding-window (``local``) layers with a ring cache.

The port of the standard-attention path of ``repro.models.attention``:
``init_attention``, ``_qkv`` (with qk-norm), ``attn_forward``,
``init_attn_cache``, ``attn_prefill``, ``attn_decode`` and ``attn_extend``
(a chunk of a prompt against a cache that holds what came before it).
Prefill, extend and forward attention run under the
``ng:gemm:flash_attention`` tag on both backends, as the JAX jnp twin is
tagged: the causal mask for the decoders' global layers, the causal mask
within ``cfg.window_size`` keys for their ``local`` layers, the full mask for the encoders (``cfg.causal`` False) and
the detector's cross-attention. Unfused decode on the kernel path is one
untagged launch (classed ``fused``); on the plain path it is the tagged qk
/ mask / softmax / pv chain of the JAX reference, op for op. Under
``nn.fuse()`` decode is the one ``ng:fused:fused_attn_decode`` operator on
both backends.

A ``local`` layer's cache is a ring of ``w = min(window, max_len)`` slots
with a per-row position side-car ``"pos"`` (-1 where empty): slot j holds
the row's last position p with ``p mod w == j``. The kernel and fused
decode paths read that invariant as a valid prefix of ``min(pos + 1, w)``
slots; the plain path masks with the side-car itself, as JAX's jnp path
does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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
    dev = generator.device
    p = {
        "wq": dense_init(generator, (d, hq * hd), dtype=pd),
        "wk": dense_init(generator, (d, hkv * hd), dtype=pd),
        "wv": dense_init(generator, (d, hkv * hd), dtype=pd),
        "wo": dense_init(generator, (hq * hd, d), dtype=pd),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq * hd,), dtype=pd, device=dev)
        p["bk"] = torch.zeros((hkv * hd,), dtype=pd, device=dev)
        p["bv"] = torch.zeros((hkv * hd,), dtype=pd, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=pd, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=pd, device=dev)
    return p


def _qkv(params, x, cfg: ModelConfig, positions):
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    q = nn.linear(x, params["wq"].to(x.dtype), params.get("bq"))
    k = nn.linear(x, params["wk"].to(x.dtype), params.get("bk"))
    v = nn.linear(x, params["wv"].to(x.dtype), params.get("bv"))
    q = nn.split_heads(q, hq)
    k = nn.split_heads(k, hkv)
    v = nn.split_heads(v, hkv)
    if cfg.qk_norm:
        # a plain scale, whatever cfg.zero_centered_norm says (as JAX)
        q = nn.rms_norm(q, params["q_norm"].to(x.dtype))
        k = nn.rms_norm(k, params["k_norm"].to(x.dtype))
    if cfg.pos_emb == "rope":
        q = nn.apply_rope(q, positions, base=cfg.rope_base,
                          fraction=cfg.rope_fraction)
        k = nn.apply_rope(k, positions, base=cfg.rope_base,
                          fraction=cfg.rope_fraction)
    return q, k, v


def _attention_impl(q, k, v, q_offset: int = 0, causal: bool = True,
                    window: Optional[int] = None):
    """Causal attention (the attention_core kernel), causal within
    ``window`` keys (attention_window) or full-mask attention
    (attention_full), or their plain version."""
    with nn.scope(OpGroup.GEMM, "flash_attention"):
        if nn.use_kernels(q):
            from repro_torch.kernels import ops as kops
            if window is not None:
                return kops.attention_window(q, k, v, window,
                                             q_offset=q_offset)
            if causal:
                return kops.attention_core(q, k, v, q_offset=q_offset)
            return kops.attention_full(q, k, v)
        return ref.attention(q, k, v, q_offset=q_offset, causal=causal,
                             window=window)


def _window(cfg: ModelConfig, kind: str) -> Optional[int]:
    return cfg.window_size if kind == "local" else None


def attn_forward(params, x, cfg: ModelConfig, kind: str, positions):
    """Full-sequence attention, causal or full as ``cfg.causal``, within
    ``cfg.window_size`` keys for a ``local`` layer. x: (B, S, D)."""
    q, k, v = _qkv(params, x, cfg, positions)
    out = _attention_impl(q, k, v, causal=cfg.causal,
                          window=_window(cfg, kind))
    return nn.linear(nn.merge_heads(out), params["wo"].to(x.dtype))


def init_attn_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                    device="cuda") -> dict:
    """A global layer's ``{"k", "v"}`` of (batch, max_len, Hkv, Dh); a local
    layer's ring of ``w = min(window, max_len)`` slots and its int32
    ``"pos"`` side-car (batch, w), -1 where a slot is empty."""
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    dt = cfg.activation_dtype
    t = min(cfg.window_size, max_len) if kind == "local" else max_len
    cache = {
        "k": torch.zeros((batch, t, hkv, hd), dtype=dt, device=device),
        "v": torch.zeros((batch, t, hkv, hd), dtype=dt, device=device),
    }
    if kind == "local":
        cache["pos"] = torch.full((batch, t), -1, dtype=torch.int32,
                                  device=device)
    return cache


def attn_prefill(params, x, cfg: ModelConfig, kind: str, positions,
                 max_len: int, lengths=None) -> Tuple[torch.Tensor, dict]:
    """Full-sequence forward that also materializes the decode cache.

    x: (B, S, D) with S <= max_len. ``lengths`` (B,): true prompt lengths
    of a right-padded batch. A global layer ignores it (decode masks
    ``arange <= pos`` per row and overwrites pads in place); a local layer
    fills its ring from each row's true prompt tail, so the padded tail
    never evicts in-window real keys.
    """
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, cfg, positions)
    out = _attention_impl(q, k, v, window=_window(cfg, kind))
    y = nn.linear(nn.merge_heads(out), params["wo"].to(x.dtype))
    cache = init_attn_cache(cfg, kind, b, max_len, device=x.device)
    if kind != "local":
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
        return y, cache
    w = cache["k"].shape[1]
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=x.device)
    last = torch.as_tensor(lengths, device=x.device).to(torch.int32)
    last = last.reshape(-1, 1) - 1
    # slot j holds the last real position p = j (mod w); floor mod, as jnp
    j = torch.arange(w, dtype=torch.int32, device=x.device)
    p = last - torch.remainder(last - j, w)                   # (B, w)
    idx = torch.clamp(p, min=0).long()[:, :, None, None]
    cache["k"] = torch.take_along_dim(k, idx, dim=1).to(cache["k"].dtype)
    cache["v"] = torch.take_along_dim(v, idx, dim=1).to(cache["v"].dtype)
    cache["pos"] = torch.where(p >= 0, p, -1).to(torch.int32)
    return y, cache


def attn_decode(params, x, cfg: ModelConfig, kind: str, cache: dict,
                pos) -> Tuple[torch.Tensor, dict]:
    """One-token decode. x: (B, 1, D); pos: scalar or per-row (B,).

    The cache is updated in place and returned: a global layer's at
    ``pos``, a local layer's ring (and side-car) at ``pos mod w``.
    """
    b = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = hq // hkv
    pos = pos_vector(pos, b, x.device)
    positions = pos[:, None]
    q, k_new, v_new = _qkv(params, x, cfg, positions)
    if kind == "local":
        k, v = cache["k"], cache["v"]
        w = k.shape[1]
        rows = torch.arange(b, device=x.device)
        slot = torch.remainder(pos, w).long()
        k[rows, slot] = k_new[:, 0].to(k.dtype)
        v[rows, slot] = v_new[:, 0].to(v.dtype)
        cache["pos"][rows, slot] = pos
        # the ring invariant makes the valid slots the first min(pos+1, w)
        lengths = torch.clamp(pos + 1, max=w).to(torch.int32)
    else:
        k = nn.kv_cache_update(cache["k"], k_new, pos)
        v = nn.kv_cache_update(cache["v"], v_new, pos)
        lengths = (pos + 1).to(torch.int32)
    wo = params["wo"].to(x.dtype)

    if nn.fusion_enabled():
        o = nn.fused_attn_decode(q, k, v, lengths)
        o = o.reshape(b, 1, hq * hd).to(x.dtype)
        return nn.linear(o, wo), cache
    if nn.use_kernels(q):
        from repro_torch.kernels import ops as kops
        o = kops.decode_core(q, k, v, lengths)
        o = o.reshape(b, 1, hq * hd).to(x.dtype)
        return nn.linear(o, wo), cache

    t = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qh = q.reshape(b, hkv, g, hd)
    with nn.scope(OpGroup.GEMM, "attn_qk"):
        s = torch.einsum("bkgd,btkd->bkgt", qh.float(), k.float()) * scale
    with nn.scope(OpGroup.ELEMENTWISE, "attn_mask"):
        if kind == "local":     # the side-car, op for op as JAX's jnp path
            cpos, p = cache["pos"], pos[:, None]
            valid = (cpos >= 0) & (cpos <= p) & (p - cpos < t)
        else:
            valid = torch.arange(t, device=x.device)[None, :] <= pos[:, None]
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = nn.softmax(s, dim=-1)
    with nn.scope(OpGroup.GEMM, "attn_pv"):
        o = torch.einsum("bkgt,btkd->bkgd", p.to(v.dtype).float(), v.float())
    o = o.reshape(b, 1, hq * hd).to(x.dtype)
    return nn.linear(o, wo), cache


def attn_extend(params, x, cfg: ModelConfig, kind: str, cache: dict,
                start: int) -> Tuple[torch.Tensor, dict]:
    """Chunked-prefill step: extend a global layer's cache by a (B, C)
    chunk whose first token sits at position ``start``.

    x: (B, C, D); ``start`` is a host int (a tensor would have to be read
    back to launch the kernel with it). K/V of the chunk land at
    ``[start, start + C)`` of the cache, in place; the cache is returned,
    as ``attn_decode`` does. The chunk attends the full cache depth (the
    earlier chunks or a reused prefix are already there) through
    ``q_offset=start``: on the card the causal ``attention_core`` kernel,
    on the CPU ``ref.attention``. Rows past the chunk are stale (reused or
    scratch blocks of a paged cache) and causally masked. A ring cannot
    re-enter at an arbitrary depth, so a ``local`` layer raises, as in JAX.

    The capture tags differ from JAX's: its extend runs
    ``chunked_attention`` (``attn_qk`` / ``attn_mask`` / ``online_softmax``
    / ``attn_pv`` / ``softmax_norm``), only because its ``start`` is traced
    and the Pallas kernel takes a static ``q_offset``; here the attention
    is the one ``flash_attention`` site, as in prefill.
    """
    if kind == "local":
        raise ValueError("chunked prefill requires a full-depth cache; "
                         "sliding-window layers cannot extend")
    if not isinstance(start, int):
        raise TypeError(f"attn_extend: start must be a host int, got "
                        f"{type(start).__name__}")
    b, c_len, _ = x.shape
    positions = (start + torch.arange(c_len, dtype=torch.int32,
                                      device=x.device))[None].expand(b, c_len)
    t = cache["k"].shape[1]
    if not 0 <= start <= t - c_len:
        # JAX's dynamic_update_slice would clamp the chunk into the cache
        raise ValueError(f"attn_extend: chunk [{start}, {start + c_len}) "
                         f"outside a cache of {t}")
    q, k_new, v_new = _qkv(params, x, cfg, positions)
    k, v = cache["k"], cache["v"]
    k[:, start:start + c_len] = k_new.to(k.dtype)
    v[:, start:start + c_len] = v_new.to(v.dtype)
    out = _attention_impl(q, k, v, q_offset=start, causal=cfg.causal)
    y = nn.linear(nn.merge_heads(out), params["wo"].to(x.dtype))
    return y, cache
