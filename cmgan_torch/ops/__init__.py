from cmgan_torch.ops.flash_attention import (
    flash_rel_attention,
    flash_rel_attention_at,
    make_rel_band,
    reference_attention,
)

__all__ = [
    "flash_rel_attention",
    "flash_rel_attention_at",
    "make_rel_band",
    "reference_attention",
]
