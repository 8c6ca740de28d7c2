"""LM assembly: the decoder stack, forward / prefill / decode.

The port of ``repro.models.transformer`` for the configs the port runs:
pre-norm blocks (RMSNorm or LayerNorm) of MHA/GQA attention or MLA
(``cfg.mla``: DeepSeek-V2's compressed-latent attention) and a dense or
mixture-of-experts FFN (``models/moe.py``: every layer of an MoE config
past its ``first_dense_layers``), with RoPE (Llama-2, Gemma 3), learned
positions (GPT-2, BERT, the ViT stub), sinusoidal ones (MusicGen) or none
(the vision backbone). Each layer's kind comes from
``cfg.layer_kinds()``: ``"attn"`` (global), ``"local"`` (sliding-window
attention over a ring cache, Gemma 3's 5:1 pattern) or ``"rec"`` (the
RG-LRU recurrent mixer, ``models/recurrent.py``: RecurrentGemma's two
recurrent blocks to each local one), ``"mlstm"`` or ``"slstm"`` (the
xLSTM mixers, ``models/xlstm.py``: a block of one pre-norm and the mixer,
which carries the sLSTM's own FFN, with no second norm and no block FFN).
A recurrent or xLSTM state consumes every token, so the engine prefills
such a model at the exact prompt length. Gemma 3 adds
qk-norm, post-norms around each sub-block (``cfg.post_norm``), zero-centred
norm scales, GeGLU and sqrt(d)-scaled tied embeddings. Decoders attend
causally; encoders
(``cfg.causal`` False: bert-base, the ``vit-b16`` stub) with the full
mask, through ``lm_forward`` only: the JAX package serves no encoder, so
``lm_prefill``, ``lm_decode``, ``init_lm_cache`` and the engine reject
them. Inputs are token ids, or precomputed embeddings where
``cfg.input_mode == "embeddings"`` (the ViT stub's frontend, MusicGen's
EnCodec frames). Gemma 2's logit caps (``cfg.attn_logit_softcap``,
``cfg.final_logit_softcap``) cap the attention scores
(``models/attention.py``) and the final logits. Layers are a
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

import torch
import torch.nn.functional as F

from repro_torch import nn
from repro_torch.core.taxonomy import OpGroup
from repro_torch.kernels.attn_template import softcap_taken
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import recurrent as R
from repro_torch.models import xlstm as X
from repro_torch.models.common import ModelConfig, dense_init, rounded


#: the attention block kinds: global (full cache) and sliding-window (ring)
ATTN_KINDS = ("attn", "local")
#: the xLSTM block kinds: a pre-norm, the mixer and the residual add alone
XLSTM_KINDS = ("mlstm", "slstm")
#: every block kind the port runs: attention, the RG-LRU recurrence and
#: the xLSTM mixers
BLOCK_KINDS = ATTN_KINDS + ("rec",) + XLSTM_KINDS


#: the positional schemes the port runs (rope inside attention)
POS_EMBS = ("rope", "learned", "sinusoidal", "none")


def check_supported(cfg: ModelConfig, serving: bool = False) -> None:
    """Raise for a config that uses a part of the JAX zoo not ported yet;
    with ``serving`` (prefill, decode, caches, the engine) also for an
    encoder, which the JAX package does not serve either. An attention
    logit cap is taken where every (Dk, Dv) the attention runs is one the
    capped kernels take (``attn_template.softcap_taken``); on MLA or a
    wider head (the wide instantiations, which take no cap) it raises."""
    kinds = set(cfg.layer_kinds())
    if cfg.mla:     # prefill's (nope + rope, v) and the absorbed decode's
        head = "MLA"
        dims = [(cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim),
                (cfg.kv_lora_rank + cfg.qk_rope_dim, cfg.kv_lora_rank)]
    else:
        head = f"head dim {cfg.resolved_head_dim}"
        dims = [(cfg.resolved_head_dim, cfg.resolved_head_dim)]
    capped_wide = (bool(cfg.attn_logit_softcap) and bool(kinds & set(ATTN_KINDS))
                   and not all(softcap_taken(dk, dv) for dk, dv in dims))
    unported = {
        f"block kinds {sorted(kinds - set(BLOCK_KINDS))}":
            not kinds <= set(BLOCK_KINDS),
        f"norm {cfg.norm!r}": cfg.norm not in ("rmsnorm", "layernorm"),
        f"ffn {cfg.ffn!r}": cfg.ffn not in M.FFN_KINDS,
        f"pos_emb {cfg.pos_emb!r}": cfg.pos_emb not in POS_EMBS,
        f"attn_logit_softcap {cfg.attn_logit_softcap} on {head} (the wide "
        "attention instantiations take no cap)": capped_wide,
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


def _is_moe_layer(cfg: ModelConfig, layer_idx: int) -> bool:
    """Whether layer ``layer_idx`` has the MoE FFN: every layer of an MoE
    config past its ``first_dense_layers`` dense leaders."""
    return cfg.is_moe and layer_idx >= cfg.first_dense_layers


def init_block(generator: torch.Generator, cfg: ModelConfig,
               layer_idx: int = 0, kind: str = "attn") -> dict:
    dev = generator.device
    if kind in XLSTM_KINDS:
        init = X.init_mlstm if kind == "mlstm" else X.init_slstm
        return {"norm1": _init_norm(cfg, dev), "mixer": init(generator, cfg)}
    if kind == "rec":
        mixer = R.init_recurrent(generator, cfg)
    elif cfg.mla:
        mixer = A.init_mla(generator, cfg)
    else:
        mixer = A.init_attention(generator, cfg)
    p = {"norm1": _init_norm(cfg, dev), "mixer": mixer,
         "norm2": _init_norm(cfg, dev)}
    if _is_moe_layer(cfg, layer_idx):
        p["moe"] = M.init_moe(generator, cfg)
    else:
        p["ffn"] = M.init_ffn(generator, cfg)
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
    params["layers"] = [init_block(generator, cfg, i, kind)
                        for i, kind in enumerate(cfg.layer_kinds())]
    params["final_norm"] = _init_norm(cfg, generator.device)
    if not cfg.tie_embeddings or cfg.input_mode != "tokens":
        params["head"] = dense_init(generator, (cfg.d_model, cfg.vocab_size),
                                    dtype=pd)
    return params


def _block_rest(params, a, x, cfg: ModelConfig, with_aux: bool = False):
    """The block after its mixer: (post-norm,) add + norm, the FFN, dense
    or MoE (, post-norm), residual add. Returns (x, the MoE layer's aux
    loss, or None: a dense layer, or ``with_aux`` False)."""
    if cfg.post_norm:
        a = _apply_norm(params["post_norm1"], a, cfg)
    h, x = _add_norm(params["norm2"], a, x, cfg)
    aux = None
    if "moe" in params:
        f, aux = M.moe_forward(params["moe"], h, cfg, with_aux=with_aux)
    else:
        f = M.ffn_forward(params["ffn"], h, cfg)
    if cfg.post_norm:
        f = _apply_norm(params["post_norm2"], f, cfg)
    return nn.residual_add(x, f), aux


def block_forward(params, x, cfg: ModelConfig, kind: str, positions):
    """-> (x, aux): aux the MoE layer's load-balance loss, None for a dense
    or an xLSTM layer."""
    h = _apply_norm(params["norm1"], x, cfg)
    if kind in XLSTM_KINDS:
        fwd = X.mlstm_forward if kind == "mlstm" else X.slstm_forward
        return nn.residual_add(x, fwd(params["mixer"], h, cfg)), None
    if kind == "rec":
        a = R.recurrent_forward(params["mixer"], h, cfg)
    elif cfg.mla:
        a = A.mla_forward(params["mixer"], h, cfg, positions)
    else:
        a = A.attn_forward(params["mixer"], h, cfg, kind, positions)
    return _block_rest(params, a, x, cfg, with_aux=True)


def block_prefill(params, x, cfg: ModelConfig, kind: str, positions,
                  max_len: int, lengths=None):
    """As :func:`block_forward`, and the layer's decode cache. A ``rec``,
    ``mlstm`` or ``slstm`` layer's state consumes every token of ``x``,
    pads included: its caller prefills the exact prompt (``lengths`` is
    for the ring)."""
    h = _apply_norm(params["norm1"], x, cfg)
    if kind in XLSTM_KINDS:
        pre = X.mlstm_prefill if kind == "mlstm" else X.slstm_prefill
        a, cache = pre(params["mixer"], h, cfg)
        return nn.residual_add(x, a), cache
    if kind == "rec":
        a, cache = R.recurrent_prefill(params["mixer"], h, cfg)
    elif cfg.mla:
        a, cache = A.mla_prefill(params["mixer"], h, cfg, positions, max_len)
    else:
        a, cache = A.attn_prefill(params["mixer"], h, cfg, kind, positions,
                                  max_len, lengths=lengths)
    return _block_rest(params, a, x, cfg)[0], cache


def block_decode(params, x, cfg: ModelConfig, kind: str, cache, pos):
    h = _apply_norm(params["norm1"], x, cfg)
    if kind in XLSTM_KINDS:
        dec = X.mlstm_decode if kind == "mlstm" else X.slstm_decode
        a, cache = dec(params["mixer"], h, cfg, cache, pos)
        return nn.residual_add(x, a), cache
    if kind == "rec":
        a, cache = R.recurrent_decode(params["mixer"], h, cfg, cache, pos)
    elif cfg.mla:
        a, cache = A.mla_decode(params["mixer"], h, cfg, cache, pos)
    else:
        a, cache = A.attn_decode(params["mixer"], h, cfg, kind, cache, pos)
    return _block_rest(params, a, x, cfg)[0], cache


def block_extend(params, x, cfg: ModelConfig, kind: str, cache, start: int):
    """Chunked-prefill step of one block (see ``attention.attn_extend``):
    only a full-depth cache can re-enter at an arbitrary position, so a
    ``local`` layer (a ring) and a ``rec``, ``mlstm`` or ``slstm`` layer (a
    running state) raise."""
    if kind in ("rec", "local") + XLSTM_KINDS:
        raise ValueError(f"block kind {kind!r} does not support chunked "
                         "prefill (needs a full-depth positional cache)")
    h = _apply_norm(params["norm1"], x, cfg)
    if cfg.mla:
        a, cache = A.mla_extend(params["mixer"], h, cfg, cache, start)
    else:
        a, cache = A.attn_extend(params["mixer"], h, cfg, kind, cache, start)
    return _block_rest(params, a, x, cfg)[0], cache


def sinusoidal_embedding(positions: torch.Tensor, d_model: int,
                         base: float = 10000.0) -> torch.Tensor:
    """(B, S) int positions -> (B, S, D) f32 sinusoidal table (MusicGen's):
    ``[sin(p * f), cos(p * f)]`` at the frequencies ``f_i = base **
    (-i / half)``, as ``repro.models.transformer.sinusoidal_embedding``.
    The exponent is JAX's f32 quotient; the power is taken in float64 and
    rounded once to f32, which gives every one of JAX's f32 frequencies
    where ``torch.pow`` in f32 misses some by an ulp (a table up to 2e-3
    apart at position 32768). The table goes straight into the residual."""
    half = d_model // 2
    expo = -torch.arange(half, dtype=torch.float32,
                         device=positions.device) / half
    freq = torch.pow(base, expo.double()).float()
    theta = positions[..., None].float() * freq
    return torch.cat([torch.sin(theta), torch.cos(theta)], dim=-1)


def _add_positional(x, positions, params, cfg: ModelConfig):
    """The position rows the config adds to the embeddings (tagged
    ``MEMORY`` as JAX's); rope is applied inside attention, "none" adds
    nothing."""
    if cfg.pos_emb == "sinusoidal":
        with nn.scope(OpGroup.MEMORY, "pos_sinusoidal"):
            return x + sinusoidal_embedding(positions, cfg.d_model).to(x.dtype)
    if cfg.pos_emb == "learned":
        with nn.scope(OpGroup.MEMORY, "pos_learned"):
            return x + F.embedding(positions, params["pos"]).to(x.dtype)
    return x


def embed_inputs(params, inputs, cfg: ModelConfig, positions):
    """Tokens (B, S) int -> (B, S, D), or precomputed embeddings (B, S, D)
    passed through, in the activation dtype; scaled by sqrt(d_model)
    (rounded to that dtype first, as JAX) where the config says so; plus
    the learned or sinusoidal position rows where the config has them."""
    if cfg.input_mode == "tokens":
        x = nn.embedding_lookup(params["embed"], inputs)
        x = x.to(cfg.activation_dtype)
    else:      # precomputed frontend embeddings (the ViT stub, EnCodec frames)
        x = inputs.to(cfg.activation_dtype)
    if cfg.scale_embeddings:
        x = nn.scale(x, rounded(math.sqrt(cfg.d_model), x.dtype))
    return _add_positional(x, positions, params, cfg)


def logits_from_hidden(params, h, cfg: ModelConfig):
    """The head (or the tied embedding), then Gemma 2's final logit cap
    ``tanh(logits / c) * c`` where the config sets one (untagged, as
    JAX's)."""
    if "head" in params:
        logits = nn.linear(h, params["head"].to(h.dtype))
    else:
        # tied head: contract against the embedding table directly
        logits = nn.einsum("...d,vd->...v", h, params["embed"].to(h.dtype))
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


def _default_positions(tokens):
    b, s = tokens.shape[:2]
    return torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)


def forward_hidden(params, x, cfg: ModelConfig, positions):
    """Every block, then the final norm: (B, S, D) -> (hidden, aux), aux
    the sum of the MoE layers' load-balance losses (None without MoE)."""
    aux = None
    for p, kind in zip(params["layers"], cfg.layer_kinds()):
        x, a = block_forward(p, x, cfg, kind, positions)
        if a is not None:
            aux = a if aux is None else aux + a
    return _apply_norm(params["final_norm"], x, cfg), aux


def lm_forward(params, inputs, cfg: ModelConfig, positions=None):
    """Full-sequence logits (B, S, V) of token ids (B, S) or, for
    ``input_mode == "embeddings"``, of embeddings (B, S, D). The MoE aux
    loss is computed and dropped, as JAX's ``lm_forward`` does."""
    check_supported(cfg)
    positions = _default_positions(inputs) if positions is None else positions
    x = embed_inputs(params, inputs, cfg, positions)
    h, _ = forward_hidden(params, x, cfg, positions)
    return logits_from_hidden(params, h, cfg)


def init_lm_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device="cuda") -> List[dict]:
    """One cache per layer: ``{"k", "v"}`` of (batch, max_len, Hkv, Dh)
    for a global layer, a ring with its ``"pos"`` side-car for a local
    one (``attention.init_attn_cache``), MLA's compressed ``{"c", "kr"}``
    (``attention.init_mla_cache``), a recurrent layer's ``{"h": (batch, W)
    f32, "conv": (batch, conv_width - 1, W)}``
    (``recurrent.init_recurrent_cache``), an mLSTM layer's ``{"C", "n",
    "m"}`` f32 and its conv tail (``xlstm.init_mlstm_cache``), an sLSTM
    layer's ``{"c", "n", "m", "h"}`` f32 (``xlstm.init_slstm_cache``)."""
    check_supported(cfg, serving=True)

    def one(kind):
        if kind == "mlstm":
            return X.init_mlstm_cache(cfg, batch, device=device)
        if kind == "slstm":
            return X.init_slstm_cache(cfg, batch, device=device)
        if kind == "rec":
            return R.init_recurrent_cache(cfg, batch, device=device)
        if cfg.mla:
            return A.init_mla_cache(cfg, batch, max_len, device=device)
        return A.init_attn_cache(cfg, kind, batch, max_len, device=device)
    return [one(kind) for kind in cfg.layer_kinds()]


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
    """One decode step. token: (B,) int, or a (B, D) frame embedding for
    ``input_mode == "embeddings"``; pos: scalar or (B,) absolute
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
