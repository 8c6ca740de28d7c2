"""Dense FFN (the port of ``repro.models.moe``'s ``init_ffn`` and
``ffn_forward`` for the SwiGLU FFN). The mixture-of-experts layer and the
other FFN kinds are not ported yet."""

from __future__ import annotations

import torch

from repro_torch import nn
from repro_torch.models.common import ModelConfig, dense_init


def init_ffn(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """The SwiGLU FFN's weights (the only FFN kind ported so far)."""
    d, ff = cfg.d_model, cfg.d_ff
    pd = cfg.torch_param_dtype
    return {
        "w_up": dense_init(generator, (d, ff), dtype=pd),
        "w_down": dense_init(generator, (ff, d), dtype=pd),
        "w_gate": dense_init(generator, (d, ff), dtype=pd),
    }


def ffn_forward(params, x, cfg: ModelConfig):
    """SwiGLU FFN on (..., D)."""
    up = nn.linear(x, params["w_up"].to(x.dtype))
    gate = nn.linear(x, params["w_gate"].to(x.dtype))
    return nn.linear(nn.swiglu(gate, up), params["w_down"].to(x.dtype))
