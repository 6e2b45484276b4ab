from cmgan_torch.ops.flash_attention import (
    flash_rel_attention,
    flash_rel_attention_at,
    make_rel_band,
    reference_attention,
    reference_attention_grads,
)
from cmgan_torch.ops.fused_norm import fused_layernorm

__all__ = [
    "flash_rel_attention",
    "flash_rel_attention_at",
    "fused_layernorm",
    "make_rel_band",
    "reference_attention",
    "reference_attention_grads",
]
