from repro_torch.kernels.flash_attention.kernel import (  # noqa: F401
    LAUNCHES, flash_attention, flash_attention_plain, reset_launches,
)
