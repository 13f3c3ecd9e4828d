"""Zamba2-1.2B hybrid: Mamba2 backbone + shared attention blocks
[arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,             # mamba2 layers
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,           # shared attn block is MHA
    d_ff=8192,                 # shared block MLP width
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    attn_period=6,             # shared attn after every 6th mamba layer
    source="arXiv:2411.15242",
)
