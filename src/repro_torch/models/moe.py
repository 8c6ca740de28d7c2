"""The FFNs (the port of ``repro.models.moe``): the dense FFN
(``init_ffn`` / ``ffn_forward``: SwiGLU or GeGLU, or one activation
between two projections, with optional biases) and the mixture-of-experts
layer (``init_moe`` / ``moe_forward``): a top-k router and the
capacity-bounded scatter dispatch of the JAX package.

Tokens are scattered into an (E, C, D) buffer by (expert, position in the
expert), the position an exclusive cumulative sum over the flat token
stream; every expert runs on its C rows as one batched product; the
results gather back weighted by the renormalised router probabilities.
Tokens past an expert's capacity C are dropped (GShard / Switch
semantics; ``capacity_factor`` sets C). Every shape is static and nothing
is read back to the host, so a decode step with MoE layers captures as a
CUDA graph. The port runs on one device: JAX's shard-local dispatch has
one shard (``_batch_shards`` is 1).

The router softmax is Logit Computation (``nn.router_gate``), the dispatch
and combine Memory (``moe_dispatch`` / ``moe_combine`` scopes), the
load-balance loss Reduction (``router_aux``); the expert products run
under ``ng:gemm:expert_ffn`` as plain ``torch.einsum`` (JAX leaves them to
XLA), their SwiGLU through ``nn.swiglu`` (the kernel on the card).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import nn
from repro_torch.core.taxonomy import OpGroup
from repro_torch.models.common import ModelConfig, dense_init

#: the FFN kinds ported so far (``cfg.ffn``)
FFN_KINDS = ("swiglu", "geglu", "gelu", "relu", "silu")
#: the gated kinds, with a ``w_gate`` projection
_GLU = {"swiglu": nn.swiglu, "geglu": nn.geglu}

_ACTIVATIONS = {"gelu": nn.gelu, "relu": nn.relu, "silu": nn.silu}


def init_ffn(generator: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None, n_experts: int = 0) -> dict:
    """The dense FFN's weights (``n_experts`` 0) or the experts' stacked
    along a leading (E,) dim; width ``d_ff`` (``cfg.d_ff`` by default);
    ``w_gate`` for SwiGLU and GeGLU, biases with ``cfg.ffn_bias``."""
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    pd = cfg.torch_param_dtype
    dev = generator.device
    lead = (n_experts,) if n_experts else ()
    axis = len(lead)
    p = {
        "w_up": dense_init(generator, (*lead, d, ff), in_axis=axis, dtype=pd),
        "w_down": dense_init(generator, (*lead, ff, d), in_axis=axis, dtype=pd),
    }
    if cfg.ffn in _GLU:
        p["w_gate"] = dense_init(generator, (*lead, d, ff), in_axis=axis,
                                 dtype=pd)
    if cfg.ffn_bias:
        p["b_up"] = torch.zeros((*lead, ff), dtype=pd, device=dev)
        p["b_down"] = torch.zeros((*lead, d), dtype=pd, device=dev)
    return p


def ffn_forward(params, x, cfg: ModelConfig):
    """Dense FFN on (..., D)."""
    up = nn.linear(x, params["w_up"].to(x.dtype), params.get("b_up"))
    if cfg.ffn in _GLU:
        gate = nn.linear(x, params["w_gate"].to(x.dtype))
        h = _GLU[cfg.ffn](gate, up)
    else:
        h = _ACTIVATIONS[cfg.ffn](up)
    return nn.linear(h, params["w_down"].to(x.dtype), params.get("b_down"))


def init_moe(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """The router (D, E), the experts' stacked FFNs of width
    ``moe_d_ff`` and, with ``n_shared_experts``, one shared FFN of width
    ``moe_d_ff * n_shared_experts``."""
    pd = cfg.torch_param_dtype
    p = {
        "router": dense_init(generator, (cfg.d_model, cfg.n_experts), dtype=pd),
        "experts": init_ffn(generator, cfg, d_ff=cfg.moe_d_ff,
                            n_experts=cfg.n_experts),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_ffn(generator, cfg,
                               d_ff=cfg.moe_d_ff * cfg.n_shared_experts)
    return p


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: the k largest values and their
    indices, equal values in ascending index order. ``torch.topk``
    guarantees no order among ties, and bf16 router logits over 60 experts
    tie often; a stable descending sort keeps the lower index first."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Rows per expert in the dispatch buffer, from shapes alone (host)."""
    return max(int(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor),
               4)


def dispatch_plan(expert_ids: torch.Tensor, n_experts: int,
                  cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dest, keep) of the flat (S, T*k) choice stream of ``expert_ids``
    (S, T, k): choice i of the stream goes to buffer row ``expert * cap +
    position``, its position the count of earlier choices of the same
    expert (an exclusive cumulative sum of the one-hot stream); a choice
    at position ``cap`` or later is dropped (``keep`` False) and its
    ``dest`` is the drop row ``n_experts * cap``. The one-hot is a
    comparison with ``arange``: no host read, so it captures in a graph."""
    s = expert_ids.shape[0]
    flat = expert_ids.reshape(s, -1).long()                       # (S, T*k)
    experts = torch.arange(n_experts, device=flat.device)
    onehot = (flat[..., None] == experts).to(torch.int32)        # (S, T*k, E)
    pos_in_expert = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    pos = torch.gather(pos_in_expert, 2, flat[..., None])[..., 0]
    keep = pos < cap
    dest = torch.where(keep, flat * cap + pos, n_experts * cap)
    return dest, keep


def _expert_ffn(params, x, cfg: ModelConfig):
    """Every expert on its rows: (S, E, C, D) with (E, D, F) weights."""
    with nn.scope(OpGroup.GEMM, "expert_ffn"):
        up = torch.einsum("secd,edf->secf", x, params["w_up"].to(x.dtype))
        if cfg.ffn in _GLU:
            gate = torch.einsum("secd,edf->secf", x,
                                params["w_gate"].to(x.dtype))
            h = _GLU[cfg.ffn](gate.contiguous(), up.contiguous())
        else:
            h = _ACTIVATIONS[cfg.ffn](up)
        return torch.einsum("secf,efd->secd", h, params["w_down"].to(x.dtype))


def moe_forward(params, x, cfg: ModelConfig, with_aux: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B, S, D) -> (y, aux_loss), the top-k dispatch of every token.

    ``with_aux`` False skips the Switch load-balance loss and returns None
    for it: prefill, decode and extend drop it, where JAX's jit removes it
    as dead code; ``lm_forward`` computes it, as JAX's capture of it
    records it.
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s                                              # one shard
    xs = x.reshape(1, t, d)

    logits = nn.linear(xs, params["router"].to(x.dtype))
    probs = nn.router_gate(logits)                        # (1, T, E) f32
    gate_vals, expert_ids = top_k(probs, k)               # (1, T, k)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)

    cap = capacity(t, cfg)

    with nn.scope(OpGroup.MEMORY, "moe_dispatch"):
        dest, keep = dispatch_plan(expert_ids, e, cap)    # (1, T*k)
        token_idx = torch.arange(t, device=x.device).repeat_interleave(k)
        # the kept rows are distinct; every dropped choice lands on the
        # drop row e*C, which is sliced off
        buf = x.new_zeros((e * cap + 1, d))
        buf.index_copy_(0, dest[0], xs[0, token_idx])
        buf = buf[:-1].reshape(1, e, cap, d)

    out_buf = _expert_ffn(params["experts"], buf, cfg)    # (1, E, C, D)

    with nn.scope(OpGroup.MEMORY, "moe_combine"):
        flat_out = out_buf.reshape(e * cap, d)
        safe = torch.clamp(dest[0], max=e * cap - 1)
        gathered = flat_out[safe]                         # (T*k, D)
        gathered = torch.where(keep[0, :, None], gathered, 0.0)
        weighted = gathered * gate_vals.reshape(t * k, 1).to(x.dtype)
        y = torch.sum(weighted.reshape(1, t, k, d), dim=2)

    if cfg.n_shared_experts:
        y = nn.residual_add(y, ffn_forward(params["shared"], xs, cfg))

    aux = None
    if with_aux:
        with nn.scope(OpGroup.REDUCTION, "router_aux"):
            me = torch.mean(probs, dim=(0, 1))                   # (E,)
            experts = torch.arange(e, device=x.device)
            ce = torch.mean((expert_ids[..., None] == experts).float(),
                            dim=(0, 1, 2))
            aux = e * torch.sum(me * ce) * cfg.router_aux_weight

    return y.reshape(b, s, d), aux
