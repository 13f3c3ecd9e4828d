"""The paper's §2 benchmark model zoo, copied from
``repro.configs.paper_zoo`` with the reference's own values (for
example ``rope_theta=10000`` for llama-3.1-8b): the point is parity with
the reference, not with the published checkpoints."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig


def _dense(name, L, d, H, kv, ff, V=151936) -> ModelConfig:
    return ModelConfig(name=name, family="dense", num_layers=L, d_model=d,
                       num_heads=H, num_kv_heads=kv, d_ff=ff, vocab_size=V,
                       source="paper §2 benchmark zoo")


PAPER_MODELS: Dict[str, ModelConfig] = {
    "qwen2.5-0.5b": _dense("qwen2.5-0.5b", 24, 896, 14, 2, 4864),
    "qwen2.5-1.5b": _dense("qwen2.5-1.5b", 28, 1536, 12, 2, 8960),
    "qwen2.5-3b": _dense("qwen2.5-3b", 36, 2048, 16, 2, 11008),
    "qwen2.5-7b": _dense("qwen2.5-7b", 28, 3584, 28, 4, 18944),
    "qwen2.5-14b": _dense("qwen2.5-14b", 48, 5120, 40, 8, 13824),
    "mistral-7b": _dense("mistral-7b", 32, 4096, 32, 8, 14336, 32768),
    "llama-3.1-8b": _dense("llama-3.1-8b", 32, 4096, 32, 8, 14336,
                           128256),
    "llama-3.1-70b": _dense("llama-3.1-70b", 80, 8192, 64, 8, 28672,
                            128256),
}
