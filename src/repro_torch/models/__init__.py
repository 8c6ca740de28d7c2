"""The dense decoder LM of the port (see transformer.py)."""

from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import (init_lm, init_lm_cache, lm_decode,
                                            lm_extend, lm_forward, lm_prefill)

__all__ = ["ModelConfig", "init_lm", "init_lm_cache", "lm_decode",
           "lm_extend", "lm_forward", "lm_prefill"]
