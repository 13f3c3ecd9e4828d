"""SeamlessM4T-large-v2 encoder-decoder backbone [arXiv:2308.11596].

The reference stubs the audio frontend (mel-spectrogram and conv
feature extractor): the encoder takes precomputed frame embeddings
(batch, seq_len // enc_frames_ratio, d_model). The port does not run the
audio family yet (ROADMAP A4).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,             # decoder layers
    enc_layers=24,             # encoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    enc_frames_ratio=4,
    source="arXiv:2308.11596",
)
