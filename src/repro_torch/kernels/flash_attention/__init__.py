from repro_torch.kernels.flash_attention.ops import (
    FlashAttentionFunction, flash_attention, flash_attention_bwd,
    flash_attention_bwd_plain, flash_attention_fwd, flash_attention_plain,
    flash_lse_plain)

__all__ = ["FlashAttentionFunction", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_fwd", "flash_attention_plain", "flash_lse_plain"]
