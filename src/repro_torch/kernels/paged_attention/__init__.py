from repro_torch.kernels.paged_attention.kernel import (  # noqa: F401
    LAUNCHES, paged_attention, paged_attention_plain, reset_launches,
)
