"""Qwen3-30B-A3B MoE [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,            # GQA kv=4
    d_ff=768,                  # per-expert intermediate
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,       # top-8
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-30B-A3B",
)
