"""Mamba2-2.7B SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,               # attention-free
    num_kv_heads=0,
    d_ff=0,                    # no MLP; mamba2 block only
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv_width=4,
    ssm_ngroups=1,
    source="arXiv:2405.21060",
)
