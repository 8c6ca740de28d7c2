"""Architecture registry of the port: the configs the port runs so far.

``get_config(name)`` returns the full published config (a copy of the JAX
zoo's entry; a test pins them equal); ``reduced(cfg)`` returns the same
tiny same-family config ``repro.configs.reduced`` does, for CPU tests.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.models.common import ModelConfig

_CONFIGS: Dict[str, ModelConfig] = {
    # the paper's GPT-2 XL and Llama-2 7B (repro/configs/paper_zoo.py)
    "gpt2-xl": ModelConfig(
        name="gpt2-xl",
        family="dense",
        n_layers=48,
        d_model=1600,
        n_heads=25,
        n_kv_heads=25,
        d_ff=6400,
        vocab_size=50257,
        block_pattern=("attn",),
        pos_emb="learned",
        max_position=1024,
        norm="layernorm",
        ffn="gelu",
        ffn_bias=True,
        qkv_bias=True,
        causal=True,
        tie_embeddings=True,
    ),
    "llama2-7b": ModelConfig(
        name="llama2-7b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_ff=11008,
        vocab_size=32000,
        block_pattern=("attn",),
        pos_emb="rope",
        norm="rmsnorm",
        ffn="swiglu",
        causal=True,
        tie_embeddings=False,
    ),
}

ARCH_IDS = sorted(_CONFIGS)


def get_config(name: str) -> ModelConfig:
    key = name.replace("_", "-")
    if key not in _CONFIGS:
        raise KeyError(f"unknown architecture {name!r}; known: {ARCH_IDS}")
    return _CONFIGS[key]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU tests (as ``repro.configs.reduced``)."""
    pat = cfg.block_pattern
    n_layers = len(pat) if len(pat) > 1 else 2
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    d_model = 64 * n_heads if cfg.resolved_head_dim >= 64 else 32 * n_heads
    kw = dict(
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=min(cfg.resolved_head_dim, 64),
        d_ff=4 * d_model if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        max_position=4096,
        attn_chunk_q=64,
        attn_chunk_kv=64,
        mlstm_chunk=32,
        loss_chunk=0,
        fsdp=False,
        remat=False,
        # the JAX reference runs its reduced configs in f32 on the CPU
        dtype="float32",
        param_dtype="float32",
    )
    kw["window_size"] = min(cfg.window_size, 64)
    kw["name"] = cfg.name + "-smoke"
    return cfg.replace(**kw)


__all__ = ["ARCH_IDS", "get_config", "reduced", "ModelConfig"]
