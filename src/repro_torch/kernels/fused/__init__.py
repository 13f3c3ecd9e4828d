from repro_torch.kernels.fused.kernel import (  # noqa: F401
    LAUNCHES, reset_launches, rms_norm, rms_norm_plain, rope_qk,
    rope_qk_plain, silu_mul, silu_mul_plain, ssd_step, ssd_step_plain,
    ssm_conv_step, ssm_conv_step_plain,
)
