"""Model configuration and parameter init for the port.

:class:`ModelConfig` is a copy of ``repro.models.common.ModelConfig``'s
fields (a test pins the two field lists equal), so a config of the JAX zoo
reads the same here. The derived helpers kept are the ones the port uses.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # block layout; entries: "attn" | "local" | "rec" | "mlstm" | "slstm"
    block_pattern: Tuple[str, ...] = ("attn",)
    head_dim: Optional[int] = None          # default d_model // n_heads
    window_size: int = 1024                 # for "local" blocks

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_logit_softcap: Optional[float] = None
    causal: bool = True                     # False => encoder (BERT/ViT)

    # positions
    pos_emb: str = "rope"                   # rope|sinusoidal|learned|none
    rope_base: float = 10000.0
    rope_fraction: float = 1.0
    max_position: int = 1 << 19

    # norms
    norm: str = "rmsnorm"                   # rmsnorm|layernorm
    post_norm: bool = False                 # gemma-style post-block norms
    zero_centered_norm: bool = False        # gemma-style (1 + scale)

    # FFN
    ffn: str = "swiglu"                     # swiglu|geglu|gelu|relu|silu
    ffn_bias: bool = False

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0
    router_aux_weight: float = 0.01

    # MLA (deepseek)
    mla: bool = False
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # recurrent (RG-LRU / griffin)
    lru_width: Optional[int] = None
    conv_width: int = 4

    # xLSTM
    mlstm_proj_factor: float = 2.0
    slstm_ff_factor: float = 4.0 / 3.0
    mlstm_chunk: int = 256

    # vision
    image_size: int = 0
    patch_size: int = 16
    n_channels: int = 3
    n_classes: int = 0
    pool: str = "avg"

    # detection head
    det_top_k: int = 0
    det_upsample: int = 2
    det_iou_threshold: float = 0.5
    det_score_threshold: float = 0.05

    # embeddings / head
    tie_embeddings: bool = True
    scale_embeddings: bool = False          # gemma: x *= sqrt(d_model)
    final_logit_softcap: Optional[float] = None
    input_mode: str = "tokens"              # tokens | embeddings (stub frontend)

    # numerics / execution
    dtype: str = "bfloat16"                 # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True
    remat_policy: str = "full"              # full | dots | none
    scan_layers: bool = True
    loss_chunk: int = 0
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    attn_triangular_schedule: bool = False
    fused_loss: bool = False

    # sharding hints
    fsdp: bool = False
    seq_shard: bool = False
    family: str = "dense"                   # dense|moe|hybrid|ssm|audio|vlm

    # --- derived -----------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_rep(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def is_vision(self) -> bool:
        return self.image_size > 0

    @property
    def is_detector(self) -> bool:
        return self.is_vision and self.det_top_k > 0

    @property
    def patch_grid(self) -> int:
        """Patches per side (the encoder sees ``patch_grid ** 2`` tokens)."""
        return self.image_size // self.patch_size

    def layer_kinds(self) -> Tuple[str, ...]:
        return (self.block_pattern * ((self.n_layers // len(self.block_pattern)) + 1)
                )[: self.n_layers]

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def torch_param_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


def dense_init(generator: torch.Generator, shape, in_axis: int = 0,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Truncated normal in [-2, 2], std ``1/sqrt(fan_in)``, drawn in f32 on
    ``generator``'s device and cast to ``dtype``."""
    fan_in = shape[in_axis] if shape else 1
    std = 1.0 / math.sqrt(max(fan_in, 1))
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(dtype)
