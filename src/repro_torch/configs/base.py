"""Model configuration: the port's own copy of ``repro.configs.base``.

The fields, the ``head_dim`` derivation, ``reduced()`` and
``param_count`` are the reference's, so a config means the same model in
both packages, and so are the ten architecture ids (:data:`ARCH_IDS`,
:func:`get_config`), each a module of this package, and the four input
shapes of the launch analysis (:data:`INPUT_SHAPES`). All six families
run in the port.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

FAMILIES = ("dense", "moe", "ssm", "vlm", "audio", "hybrid")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int            # 0 for attention-free (ssm)
    num_kv_heads: int
    d_ff: int                 # dense FFN width; for MoE: per-expert width
    vocab_size: int
    source: str = ""          # provenance citation

    # --- attention ---
    head_dim: int = 0          # 0 -> d_model // num_heads
    sliding_window: Optional[int] = None
    rope_theta: float = 10000.0
    use_bias: bool = False

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv_width: int = 4
    ssm_ngroups: int = 1

    # --- hybrid (zamba2) ---
    attn_period: int = 0

    # --- enc-dec (audio) ---
    enc_layers: int = 0
    enc_frames_ratio: int = 4

    # --- vlm ---
    num_patches: int = 0

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"bad family {self.family}")
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def has_attention(self) -> bool:
        return self.num_heads > 0

    @property
    def subquadratic(self) -> bool:
        """Natively supports 500k-token decode without a full KV cache."""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)

    def param_count(self, active_only: bool = False) -> int:
        d, L = self.d_model, self.num_layers
        embed = self.vocab_size * d
        unembed = self.vocab_size * d   # untied head
        hd = self.head_dim
        attn = (d * self.num_heads * hd          # Q
                + 2 * d * self.num_kv_heads * hd  # K,V
                + self.num_heads * hd * d)        # O
        if self.family == "ssm":
            return embed + unembed + L * self._ssm_layer_params()
        if self.family == "hybrid":
            shared_attn = attn + 3 * d * self.d_ff
            return embed + unembed + L * self._ssm_layer_params() \
                + shared_attn
        ffn_dense = 3 * d * self.d_ff            # gated MLP
        if self.is_moe:
            n_e = (self.experts_per_token if active_only
                   else self.num_experts)
            ffn = n_e * 3 * d * self.d_ff + d * self.num_experts
        else:
            ffn = ffn_dense
        total = embed + unembed + L * (attn + ffn)
        if self.enc_layers:
            total += self.enc_layers * (attn + ffn_dense)
            total += L * attn                     # cross-attention blocks
        return int(total)

    def _ssm_layer_params(self) -> int:
        d, di, ds = self.d_model, self.d_inner, self.ssm_state
        in_proj = d * (2 * di + 2 * self.ssm_ngroups * ds + self.ssm_nheads)
        conv = (di + 2 * self.ssm_ngroups * ds) * self.ssm_conv_width
        return in_proj + conv + di * d + 2 * self.ssm_nheads

    def reduced(self) -> "ModelConfig":
        """<=2 layers, d_model<=256: the same family, small enough for
        the CPU tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=2,
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4) if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            moe_capacity_factor=8.0,
            ssm_state=min(self.ssm_state, 16),
            ssm_headdim=min(self.ssm_headdim, 32),
            enc_layers=2 if self.enc_layers else 0,
            num_patches=16 if self.num_patches else 0,
            attn_period=2 if self.attn_period else 0,
            sliding_window=64 if self.sliding_window else None,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


#: the four input shapes of the launch analysis (:mod:`repro_torch.launch.
#: dryrun`), the reference's
INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = (
    "qwen3-moe-30b-a3b",
    "stablelm-1.6b",
    "mamba2-2.7b",
    "phi-3-vision-4.2b",
    "granite-moe-1b-a400m",
    "seamless-m4t-large-v2",
    "zamba2-1.2b",
    "command-r-35b",
    "minitron-8b",
    "h2o-danube-3-4b",
)


def get_config(arch: str) -> ModelConfig:
    mod_name = arch.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return INPUT_SHAPES[name]


def list_archs() -> Tuple[str, ...]:
    return ARCH_IDS
