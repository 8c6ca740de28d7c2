"""Dense FFN (the port of ``repro.models.moe``'s ``init_ffn`` and
``ffn_forward``): SwiGLU or GeGLU, or one activation (GELU, ReLU, SiLU)
between two projections, with optional biases. The mixture-of-experts
layer is not ported yet."""

from __future__ import annotations

import torch

from repro_torch import nn
from repro_torch.models.common import ModelConfig, dense_init

#: the FFN kinds ported so far (``cfg.ffn``)
FFN_KINDS = ("swiglu", "geglu", "gelu", "relu", "silu")
#: the gated kinds, with a ``w_gate`` projection
_GLU = {"swiglu": nn.swiglu, "geglu": nn.geglu}

_ACTIVATIONS = {"gelu": nn.gelu, "relu": nn.relu, "silu": nn.silu}


def init_ffn(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """The dense FFN's weights: ``w_gate`` for SwiGLU and GeGLU, biases
    with ``cfg.ffn_bias``."""
    d, ff = cfg.d_model, cfg.d_ff
    pd = cfg.torch_param_dtype
    dev = generator.device
    p = {
        "w_up": dense_init(generator, (d, ff), dtype=pd),
        "w_down": dense_init(generator, (ff, d), dtype=pd),
    }
    if cfg.ffn in _GLU:
        p["w_gate"] = dense_init(generator, (d, ff), dtype=pd)
    if cfg.ffn_bias:
        p["b_up"] = torch.zeros((ff,), dtype=pd, device=dev)
        p["b_down"] = torch.zeros((d,), dtype=pd, device=dev)
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
