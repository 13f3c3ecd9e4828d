from repro_torch.kernels.flash_attention.kernel import (  # noqa: F401
    LAUNCHES, FlashAttention, flash_attention, flash_attention_backward,
    flash_attention_backward_plain, flash_attention_forward,
    flash_attention_plain, reset_launches,
)
