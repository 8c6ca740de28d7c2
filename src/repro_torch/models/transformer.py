"""LM assembly: the dense decoder stack, forward / prefill / decode.

The port of ``repro.models.transformer`` for the configs the port runs:
pre-norm blocks (RMSNorm or LayerNorm) of MHA/GQA attention and a dense
FFN, with RoPE (Llama-2, Gemma 3), learned positions (GPT-2, BERT, the
ViT stub) or none (the vision backbone). Each layer's kind comes from
``cfg.layer_kinds()``: ``"attn"`` (global) or ``"local"`` (sliding-window
attention over a ring cache, Gemma 3's 5:1 pattern). Gemma 3 adds
qk-norm, post-norms around each sub-block (``cfg.post_norm``), zero-centred
norm scales, GeGLU and sqrt(d)-scaled tied embeddings. Decoders attend
causally; encoders
(``cfg.causal`` False: bert-base, the ``vit-b16`` stub) with the full
mask, through ``lm_forward`` only: the JAX package serves no encoder, so
``lm_prefill``, ``lm_decode``, ``init_lm_cache`` and the engine reject
them. Inputs are token ids, or precomputed embeddings where
``cfg.input_mode == "embeddings"`` (the stub's frontend). Layers are a
Python list: PyTorch runs eagerly, so the JAX package's ``lax.scan`` over
stacked layers has no counterpart.

Public API (functions over a params dict of tensors):

    init_lm(generator, cfg)                 -> params
    lm_forward(params, inputs, cfg)         -> logits (B, S, V)
    init_lm_cache(cfg, batch, max_len)      -> caches
    lm_prefill(params, tokens, cfg, max_len, lengths=None)
                                            -> (last_logits (B, V), caches)
    lm_decode(params, token, pos, caches, cfg) -> (logits (B, V), caches)
    lm_extend(params, tokens, start, caches, cfg)
                                            -> (logits (B, C, V), caches)

``pos`` may be a scalar or a per-row ``(B,)`` vector; ``lm_decode`` and
``lm_extend`` write the caches in place and return them.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import nn
from repro_torch.core.taxonomy import OpGroup
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models.common import ModelConfig, dense_init


#: the attention block kinds: global (full cache) and sliding-window (ring)
ATTN_KINDS = ("attn", "local")


def check_supported(cfg: ModelConfig, serving: bool = False) -> None:
    """Raise for a config that uses a part of the JAX zoo not ported yet;
    with ``serving`` (prefill, decode, caches, the engine) also for an
    encoder, which the JAX package does not serve either."""
    kinds = set(cfg.layer_kinds())
    unported = {
        f"block kinds {sorted(kinds - set(ATTN_KINDS))}":
            not kinds <= set(ATTN_KINDS),
        f"norm {cfg.norm!r}": cfg.norm not in ("rmsnorm", "layernorm"),
        f"ffn {cfg.ffn!r}": cfg.ffn not in M.FFN_KINDS,
        f"pos_emb {cfg.pos_emb!r}": cfg.pos_emb not in ("rope", "learned",
                                                        "none"),
        "MoE": cfg.n_experts > 0,
        "MLA": cfg.mla,
        "softcaps": bool(cfg.attn_logit_softcap or cfg.final_logit_softcap),
        f"input_mode {cfg.input_mode!r}": cfg.input_mode not in ("tokens",
                                                                 "embeddings"),
    }
    missing = [what for what, hit in unported.items() if hit]
    if missing:
        raise NotImplementedError(f"{cfg.name}: not ported yet: {missing}")
    if serving and not cfg.causal:
        raise NotImplementedError(
            f"{cfg.name}: an encoder (non-causal attention) has no prefill, "
            "decode or cache; the JAX package serves no encoder either: "
            "use lm_forward")


def _init_norm(cfg: ModelConfig, device):
    shape, pd = (cfg.d_model,), cfg.torch_param_dtype
    p = {"scale": torch.ones(shape, dtype=pd, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=pd, device=device)
    return p


def _apply_norm(p, x, cfg: ModelConfig):
    if cfg.norm == "layernorm":
        return nn.layer_norm(x, p["scale"].to(x.dtype), p["bias"].to(x.dtype))
    return nn.rms_norm(x, p["scale"].to(x.dtype),
                       zero_centered=cfg.zero_centered_norm)


def _add_norm(p, a, x, cfg: ModelConfig):
    """``h = norm(a + x)``; returns ``(h, a + x)``: the pre-norm boundary,
    one fused operator under ``nn.fuse()``."""
    if cfg.norm == "layernorm":
        return nn.add_layer_norm(a, x, p["scale"].to(x.dtype),
                                 p["bias"].to(x.dtype))
    return nn.add_rms_norm(a, x, p["scale"].to(x.dtype),
                           zero_centered=cfg.zero_centered_norm)


def init_block(generator: torch.Generator, cfg: ModelConfig) -> dict:
    dev = generator.device
    p = {"norm1": _init_norm(cfg, dev),
         "mixer": A.init_attention(generator, cfg),
         "norm2": _init_norm(cfg, dev),
         "ffn": M.init_ffn(generator, cfg)}
    if cfg.post_norm:
        p["post_norm1"] = _init_norm(cfg, dev)
        p["post_norm2"] = _init_norm(cfg, dev)
    return p


def init_lm(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Random params on ``generator``'s device, drawn from it in order."""
    check_supported(cfg)
    pd = cfg.torch_param_dtype
    params = {}
    if cfg.input_mode == "tokens":
        params["embed"] = dense_init(generator, (cfg.vocab_size, cfg.d_model),
                                     in_axis=1, dtype=pd)
    if cfg.pos_emb == "learned":
        params["pos"] = dense_init(generator, (cfg.max_position, cfg.d_model),
                                   in_axis=1, dtype=pd)
    params["layers"] = [init_block(generator, cfg) for _ in range(cfg.n_layers)]
    params["final_norm"] = _init_norm(cfg, generator.device)
    if not cfg.tie_embeddings or cfg.input_mode != "tokens":
        params["head"] = dense_init(generator, (cfg.d_model, cfg.vocab_size),
                                    dtype=pd)
    return params


def _block_rest(params, a, x, cfg: ModelConfig):
    """The block after its mixer: (post-norm,) add + norm, FFN
    (, post-norm), residual add."""
    if cfg.post_norm:
        a = _apply_norm(params["post_norm1"], a, cfg)
    h, x = _add_norm(params["norm2"], a, x, cfg)
    f = M.ffn_forward(params["ffn"], h, cfg)
    if cfg.post_norm:
        f = _apply_norm(params["post_norm2"], f, cfg)
    return nn.residual_add(x, f)


def block_forward(params, x, cfg: ModelConfig, kind: str, positions):
    h = _apply_norm(params["norm1"], x, cfg)
    a = A.attn_forward(params["mixer"], h, cfg, kind, positions)
    return _block_rest(params, a, x, cfg)


def block_prefill(params, x, cfg: ModelConfig, kind: str, positions,
                  max_len: int, lengths=None):
    h = _apply_norm(params["norm1"], x, cfg)
    a, cache = A.attn_prefill(params["mixer"], h, cfg, kind, positions,
                              max_len, lengths=lengths)
    return _block_rest(params, a, x, cfg), cache


def block_decode(params, x, cfg: ModelConfig, kind: str, cache, pos):
    h = _apply_norm(params["norm1"], x, cfg)
    a, cache = A.attn_decode(params["mixer"], h, cfg, kind, cache, pos)
    return _block_rest(params, a, x, cfg), cache


def block_extend(params, x, cfg: ModelConfig, kind: str, cache, start: int):
    """Chunked-prefill step of one block (see ``attention.attn_extend``):
    only a full-depth cache can re-enter at an arbitrary position, so a
    ``local`` layer raises."""
    if kind == "local":
        raise ValueError(f"block kind {kind!r} does not support chunked "
                         "prefill (needs a full-depth positional cache)")
    h = _apply_norm(params["norm1"], x, cfg)
    a, cache = A.attn_extend(params["mixer"], h, cfg, kind, cache, start)
    return _block_rest(params, a, x, cfg), cache


def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (nearest even), as the JAX package's
    ``jnp.asarray(value, dtype)``: sqrt(5376) = 73.32 is 73.5 in bf16. On
    the host, so no tensor op enters a capture or the card's stream."""
    if dtype == torch.float16:
        return float(np.float16(value))
    f = np.float32(value)
    if dtype == torch.bfloat16:
        bits = int(f.view(np.uint32))
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16
        f = np.uint32(bits).view(np.float32)
    return float(f)


def embed_inputs(params, inputs, cfg: ModelConfig, positions):
    """Tokens (B, S) int -> (B, S, D), or precomputed embeddings (B, S, D)
    passed through, in the activation dtype; scaled by sqrt(d_model)
    (rounded to that dtype first, as JAX) where the config says so; plus
    the learned position rows where the config has them."""
    if cfg.input_mode == "tokens":
        x = nn.embedding_lookup(params["embed"], inputs)
        x = x.to(cfg.activation_dtype)
    else:      # precomputed modality-frontend embeddings (the ViT stub)
        x = inputs.to(cfg.activation_dtype)
    if cfg.scale_embeddings:
        x = nn.scale(x, _rounded(math.sqrt(cfg.d_model), x.dtype))
    if cfg.pos_emb == "learned":
        with nn.scope(OpGroup.MEMORY, "pos_learned"):
            x = x + F.embedding(positions, params["pos"]).to(x.dtype)
    return x


def logits_from_hidden(params, h, cfg: ModelConfig):
    if "head" in params:
        return nn.linear(h, params["head"].to(h.dtype))
    # tied head: contract against the embedding table directly
    return nn.einsum("...d,vd->...v", h, params["embed"].to(h.dtype))


def _default_positions(tokens):
    b, s = tokens.shape[:2]
    return torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)


def lm_forward(params, inputs, cfg: ModelConfig, positions=None):
    """Full-sequence logits (B, S, V) of token ids (B, S) or, for
    ``input_mode == "embeddings"``, of embeddings (B, S, D)."""
    check_supported(cfg)
    positions = _default_positions(inputs) if positions is None else positions
    x = embed_inputs(params, inputs, cfg, positions)
    for p, kind in zip(params["layers"], cfg.layer_kinds()):
        x = block_forward(p, x, cfg, kind, positions)
    h = _apply_norm(params["final_norm"], x, cfg)
    return logits_from_hidden(params, h, cfg)


def init_lm_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device="cuda") -> List[dict]:
    """One cache per layer: ``{"k", "v"}`` of (batch, max_len, Hkv, Dh)
    for a global layer, a ring with its ``"pos"`` side-car for a local
    one (``attention.init_attn_cache``)."""
    check_supported(cfg, serving=True)
    return [A.init_attn_cache(cfg, kind, batch, max_len, device=device)
            for kind in cfg.layer_kinds()]


def lm_prefill(params, tokens, cfg: ModelConfig, max_len: int,
               positions=None, lengths=None) -> Tuple[torch.Tensor, List[dict]]:
    """Process the prompt; return (logits_last (B, V), caches).

    ``lengths`` (B,): true prompt length per row of a right-padded batch.
    The logits are read at position ``lengths - 1`` instead of the pad
    tail; with a causal mask no real token attends a pad. The local
    layers fill their rings from each row's true prompt tail.
    """
    check_supported(cfg, serving=True)
    positions = _default_positions(tokens) if positions is None else positions
    x = embed_inputs(params, tokens, cfg, positions)
    caches = []
    for p, kind in zip(params["layers"], cfg.layer_kinds()):
        x, c = block_prefill(p, x, cfg, kind, positions, max_len,
                             lengths=lengths)
        caches.append(c)
    h = _apply_norm(params["final_norm"], x, cfg)
    if lengths is None:
        h_last = h[:, -1:]
    else:
        idx = torch.as_tensor(lengths, device=h.device).long().reshape(-1) - 1
        h_last = torch.take_along_dim(h, idx[:, None, None], dim=1)
    return logits_from_hidden(params, h_last, cfg)[:, 0], caches


def lm_decode(params, token, pos, caches: List[dict], cfg: ModelConfig):
    """One decode step. token: (B,) int; pos: scalar or (B,) absolute
    positions. Returns (logits (B, V), caches), the caches updated in
    place."""
    check_supported(cfg, serving=True)
    b = token.shape[0]
    pos = A.pos_vector(pos, b, token.device)
    x = embed_inputs(params, token[:, None], cfg, pos[:, None])
    for i, (p, kind) in enumerate(zip(params["layers"], cfg.layer_kinds())):
        x, caches[i] = block_decode(p, x, cfg, kind, caches[i], pos)
    h = _apply_norm(params["final_norm"], x, cfg)
    return logits_from_hidden(params, h, cfg)[:, 0], caches


def lm_extend(params, tokens, start: int, caches: List[dict],
              cfg: ModelConfig):
    """Chunked-prefill step: run a (B, C) token chunk at absolute position
    ``start`` (a host int) against caches that already hold [0, start).

    The decode-path twin of ``lm_prefill`` for a chunk in the middle of a
    prompt: returns (logits (B, C, V), caches), the caches written in
    place; the caller picks the row of the prompt's last real token (a
    chunk may be right-padded).
    """
    check_supported(cfg, serving=True)
    b, c_len = tokens.shape[:2]
    positions = (start + torch.arange(c_len, dtype=torch.int32,
                                      device=tokens.device))[None].expand(b, c_len)
    x = embed_inputs(params, tokens, cfg, positions)
    for i, (p, kind) in enumerate(zip(params["layers"], cfg.layer_kinds())):
        x, caches[i] = block_extend(p, x, cfg, kind, caches[i], start)
    h = _apply_norm(params["final_norm"], x, cfg)
    return logits_from_hidden(params, h, cfg), caches
