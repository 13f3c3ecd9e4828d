"""Phi-3-vision-4.2B: phi3-mini decoder + CLIP frontend (stubbed)
[hf:microsoft/Phi-3-vision-128k-instruct].

The reference stubs the vision encoder and projector: the decoder takes
pre-projected patch embeddings of shape (batch, num_patches, d_model).
The port does not run the vlm family yet (ROADMAP A4).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    num_patches=576,           # 24x24 CLIP-style patch grid (stub frontend)
    rope_theta=10000.0,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)
