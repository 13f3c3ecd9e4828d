from repro_torch.kernels.quant_matmul.kernel import (  # noqa: F401
    KERNELS, LAUNCHES, build, fp16_matmul, fp16_matmul_plain, int8_matmul,
    int8_matmul_plain, nf4_matmul, nf4_matmul_plain, reset_launches,
)
