"""Architecture registry of the port: the configs the port runs so far.

``get_config(name)`` returns the full published config (a copy of the JAX
zoo's entry; a test pins them equal); ``reduced(cfg)`` returns the same
tiny same-family config ``repro.configs.reduced`` does, for CPU tests.

The paper's four models (``repro/configs/paper_zoo.py``: gpt2-xl,
llama2-7b, bert-base and the ``vit-b16`` embeddings stub), gemma3-27b
(``repro/configs/gemma3_27b.py``) and the dense configs that use only
ported features, stablelm-3b (the serving case: LayerNorm, MHA of head
dim 80, rope on a quarter of it), granite-3-8b (GQA 32/8, tied),
chameleon-34b (qk-norm, GQA 64/8) and qwen1.5-110b (QKV biases, GQA 64/8;
220 GB of bf16 weights, so it runs reduced, on the CPU only), and the
mixture-of-experts configs qwen2-moe-a2.7b
(``repro/configs/qwen2_moe_a2_7b.py``) and deepseek-v2-lite-16b (MLA,
``repro/configs/deepseek_v2_lite_16b.py``), and the hybrid recurrent
recurrentgemma-2b (``repro/configs/recurrentgemma_2b.py``: RG-LRU blocks
beside sliding-window attention) and xlstm-350m
(``repro/configs/xlstm_350m.py``: mLSTM and sLSTM blocks), and the audio
decoder musicgen-large (``repro/configs/musicgen_large.py``: sinusoidal
positions over precomputed EnCodec frame embeddings), run through the LM
stack;
the vision family (``vit-b16-cls``, ``repro/configs/vit_b16.py``, and
``detector-vit-s``, ``repro/configs/detector_vit_s.py``) through
``repro_torch.models.vision``.
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
    # Gemma 3 27B (repro/configs/gemma3_27b.py): 5:1 local:global layers
    # (window 1024), GQA 32/16 of 128, qk-norm, pre+post zero-centred
    # RMSNorms, GeGLU, sqrt(d)-scaled tied embeddings
    "gemma3-27b": ModelConfig(
        remat_policy="proj",
        name="gemma3-27b",
        family="dense",
        n_layers=62,
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=21504,
        vocab_size=262144,
        block_pattern=("local", "local", "local", "local", "local", "attn"),
        window_size=1024,
        pos_emb="rope",
        norm="rmsnorm",
        post_norm=True,
        zero_centered_norm=True,
        qk_norm=True,
        ffn="geglu",
        causal=True,
        tie_embeddings=True,
        scale_embeddings=True,
        loss_chunk=512,
        fsdp=True,
    ),
    # StableLM 3B (repro/configs/stablelm_3b.py): LayerNorm, MHA 32/32 of
    # head dim 80, partial rotary on 25 % of it, SwiGLU, untied
    "stablelm-3b": ModelConfig(
        remat_policy="proj",
        name="stablelm-3b",
        family="dense",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=6912,
        vocab_size=50304,
        block_pattern=("attn",),
        pos_emb="rope",
        rope_fraction=0.25,
        norm="layernorm",
        ffn="swiglu",
        causal=True,
        tie_embeddings=False,
    ),
    # Granite 3.0 8B (repro/configs/granite_3_8b.py): Llama-style, GQA
    # 32/8, tied embeddings
    "granite-3-8b": ModelConfig(
        remat_policy="proj",
        name="granite-3-8b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=12800,
        vocab_size=49155,
        block_pattern=("attn",),
        pos_emb="rope",
        norm="rmsnorm",
        ffn="swiglu",
        causal=True,
        tie_embeddings=True,
        fsdp=True,
    ),
    # Chameleon 34B (repro/configs/chameleon_34b.py): the early-fusion
    # token backbone, qk-norm, GQA 64/8
    "chameleon-34b": ModelConfig(
        name="chameleon-34b",
        family="vlm",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=22016,
        vocab_size=65536,
        block_pattern=("attn",),
        qk_norm=True,
        pos_emb="rope",
        norm="rmsnorm",
        ffn="swiglu",
        causal=True,
        tie_embeddings=False,
        loss_chunk=512,
        fsdp=True,
    ),
    # Qwen1.5 110B (repro/configs/qwen1_5_110b.py): QKV biases, GQA 64/8
    "qwen1.5-110b": ModelConfig(
        name="qwen1.5-110b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=49152,
        vocab_size=152064,
        block_pattern=("attn",),
        pos_emb="rope",
        norm="rmsnorm",
        ffn="swiglu",
        qkv_bias=True,
        causal=True,
        tie_embeddings=False,
        loss_chunk=512,
        fsdp=True,
    ),
    "bert-base": ModelConfig(
        name="bert-base",
        family="dense",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=30522,
        block_pattern=("attn",),
        pos_emb="learned",
        max_position=512,
        norm="layernorm",
        ffn="gelu",
        ffn_bias=True,
        qkv_bias=True,
        causal=False,               # encoder-only: no decode shapes
        tie_embeddings=True,
    ),
    # Qwen1.5-MoE-A2.7B (repro/configs/qwen2_moe_a2_7b.py): every layer
    # MoE, 60 routed experts top-4 and 4 shared, of width 1408
    "qwen2-moe-a2.7b": ModelConfig(
        remat_policy="proj",
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=151936,
        block_pattern=("attn",),
        n_experts=60,
        top_k=4,
        n_shared_experts=4,
        moe_d_ff=1408,
        capacity_factor=1.25,
        first_dense_layers=0,
        pos_emb="rope",
        norm="rmsnorm",
        ffn="swiglu",
        qkv_bias=True,
        causal=True,
        tie_embeddings=False,
        fsdp=True,
    ),
    # DeepSeek-V2-Lite (repro/configs/deepseek_v2_lite_16b.py): MLA over a
    # 512-d latent and a 64-d rope key; a dense first layer (d_ff 10944),
    # then MoE, 64 routed experts top-6 and 2 shared, of width 1408
    "deepseek-v2-lite-16b": ModelConfig(
        remat_policy="proj",
        name="deepseek-v2-lite-16b",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=10944,
        vocab_size=102400,
        block_pattern=("attn",),
        mla=True,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        n_experts=64,
        top_k=6,
        n_shared_experts=2,
        moe_d_ff=1408,
        capacity_factor=1.25,
        first_dense_layers=1,
        pos_emb="rope",
        norm="rmsnorm",
        ffn="swiglu",
        causal=True,
        tie_embeddings=False,
        fsdp=True,
    ),
    # RecurrentGemma 2B (repro/configs/recurrentgemma_2b.py): two RG-LRU
    # recurrent blocks to each local-attention block (window 2048), 10
    # query heads over one KV head of 256, GeGLU, sqrt(d)-scaled tied
    # embeddings; 26 layers, the last two a (rec, rec) trail
    "recurrentgemma-2b": ModelConfig(
        remat_policy="proj",
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        block_pattern=("rec", "rec", "local"),
        window_size=2048,
        lru_width=2560,
        conv_width=4,
        pos_emb="rope",
        norm="rmsnorm",
        ffn="geglu",
        causal=True,
        tie_embeddings=True,
        scale_embeddings=True,
        loss_chunk=512,
    ),
    # xLSTM 350M (repro/configs/xlstm_350m.py): seven mLSTM blocks to each
    # sLSTM block, 24 layers; chunkwise-parallel mLSTM (inner width 2048,
    # chunk 256, conv 4), a sequential sLSTM with a GeGLU FFN tail of 1365;
    # LayerNorm pre-norms, no positions, untied head
    "xlstm-350m": ModelConfig(
        remat_policy="proj",
        name="xlstm-350m",
        family="ssm",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        block_pattern=("mlstm",) * 7 + ("slstm",),
        mlstm_proj_factor=2.0,
        slstm_ff_factor=4.0 / 3.0,
        mlstm_chunk=256,
        conv_width=4,
        pos_emb="none",
        norm="layernorm",
        ffn="gelu",
        causal=True,
        tie_embeddings=False,
    ),
    # repro/configs/musicgen_large.py: the audio decoder over precomputed
    # EnCodec frame embeddings (the frontend is a stub), one codebook head
    "musicgen-large": ModelConfig(
        remat_policy="proj",
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=2048,
        block_pattern=("attn",),
        pos_emb="sinusoidal",
        norm="layernorm",
        ffn="gelu",
        ffn_bias=True,
        qkv_bias=False,
        causal=True,
        tie_embeddings=False,
        input_mode="embeddings",
        loss_chunk=0,
    ),
    # the embeddings stub: the LM stack on precomputed patch embeddings
    "vit-b16": ModelConfig(
        name="vit-b16",
        family="dense",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=1000,            # classifier head over ImageNet classes
        block_pattern=("attn",),
        pos_emb="learned",
        max_position=1024,
        norm="layernorm",
        ffn="gelu",
        ffn_bias=True,
        qkv_bias=True,
        causal=False,               # encoder-only
        tie_embeddings=False,
        input_mode="embeddings",    # patch-embedding frontend is the stub
    ),
    # ViT-B/16 classifier: conv patchify, 2D positions, pooled head
    "vit-b16-cls": ModelConfig(
        name="vit-b16-cls",
        family="vision",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=1000,            # unused by the vision path (head=n_classes)
        block_pattern=("attn",),
        pos_emb="none",             # 2D learned grid lives in the vision params
        norm="layernorm",
        ffn="gelu",
        ffn_bias=True,
        qkv_bias=True,
        causal=False,               # encoder-only
        tie_embeddings=False,
        input_mode="embeddings",
        image_size=224,
        patch_size=16,
        n_channels=3,
        n_classes=1000,
        pool="avg",
    ),
    # ViT-S single-stage detector: 16x16 grid upsampled to 32x32 candidate
    # cells, peak pooling, top-256 score sort, greedy NMS
    "detector-vit-s": ModelConfig(
        name="detector-vit-s",
        family="vision",
        n_layers=12,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_ff=1536,
        vocab_size=91,              # unused by the vision path (head=n_classes)
        block_pattern=("attn",),
        pos_emb="none",
        norm="layernorm",
        ffn="gelu",
        ffn_bias=True,
        qkv_bias=True,
        causal=False,
        tie_embeddings=False,
        input_mode="embeddings",
        image_size=256,
        patch_size=16,
        n_channels=3,
        n_classes=91,               # COCO categories
        det_top_k=256,
        det_upsample=2,
        det_iou_threshold=0.5,
        det_score_threshold=0.05,
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
    if cfg.is_moe and cfg.first_dense_layers:
        n_layers += cfg.first_dense_layers
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
    if cfg.is_moe:
        kw.update(n_experts=8, top_k=min(cfg.top_k, 2), moe_d_ff=2 * d_model,
                  n_shared_experts=min(cfg.n_shared_experts, 1))
    if cfg.mla:
        kw.update(kv_lora_rank=64, qk_nope_dim=32, qk_rope_dim=16,
                  v_head_dim=32, head_dim=48)
    if cfg.lru_width:
        kw.update(lru_width=d_model)
    kw["window_size"] = min(cfg.window_size, 64)
    if cfg.is_vision:
        # a 4x4 patch grid (16 tokens) keeps the CPU forward tiny while
        # still running interpolate / pool / top-k / NMS end to end
        kw.update(image_size=min(cfg.image_size, 4 * cfg.patch_size),
                  n_classes=min(cfg.n_classes, 16),
                  det_top_k=min(cfg.det_top_k, 32))
    kw["name"] = cfg.name + "-smoke"
    return cfg.replace(**kw)


__all__ = ["ARCH_IDS", "get_config", "reduced", "ModelConfig"]
