"""Phase-aware profiling harness (paper takeaway #4): the port's own
copy of ``repro.core.profiler``.

Wraps the analytic energy model with the prefill/decode split the paper
insists on: callers register phase workloads and get a per-phase +
aggregate report, in the exact decomposition of the paper (§2):

    generate = prefill + decode

with prefill isolated as "generation stopped at the first token" and
decode as the remainder — mirrored here by construction.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.energy import EnergyModel, EnergyReport, combine
from repro_torch.core.hardware import DeviceSpec, H100_SXM
from repro_torch.core.precision import PrecisionPolicy


@dataclasses.dataclass
class GenerateProfile:
    prefill: EnergyReport
    decode: EnergyReport
    generate: EnergyReport
    batch: int
    prompt_len: int
    new_tokens: int

    def energy_per_request_wh(self) -> float:
        return self.generate.energy_wh / self.batch

    def energy_per_output_token_j(self, phase: str = "generate") -> float:
        r = getattr(self, phase)
        return r.energy_j / (self.batch * self.new_tokens)

    def energy_per_input_token_j(self, phase: str = "generate",
                                 effective_tokens: Optional[int] = None) -> float:
        n = effective_tokens if effective_tokens is not None \
            else self.batch * self.prompt_len
        r = getattr(self, phase)
        return r.energy_j / n


class PhaseProfiler:
    """Phase-aware profiler for one (model, device, policy).

    Backend-agnostic: phase costs come from any backend exposing the
    ``*_report`` surface (:class:`~repro_torch.serving.backend.AnalyticBackend`
    by default, built from the legacy kwargs for bit-identical
    results)."""

    def __init__(self, cfg: ModelConfig, device: DeviceSpec = H100_SXM,
                 policy: Optional[PrecisionPolicy] = None,
                 energy_model_cls=EnergyModel, n_chips: int = 1,
                 stack: str = "eager", backend=None):
        from repro_torch.core.precision import make_policy
        if backend is None:
            from repro_torch.serving.backend import AnalyticBackend
            backend = AnalyticBackend(
                cfg, device=device,
                policy=policy or make_policy("bfloat16"),
                n_chips=n_chips, energy_model_cls=energy_model_cls)
        self.backend = backend
        self.cfg = cfg
        self.device = getattr(backend, "device", device)
        self.policy = getattr(backend, "policy",
                              policy or make_policy("bfloat16"))
        self.model = getattr(backend, "energy", None)
        self.n_chips = n_chips
        self.stack = stack

    def profile_prefill(self, batch: int, seq: int) -> EnergyReport:
        return self.backend.prefill_report(batch, seq, stack=self.stack)

    def profile_decode(self, batch: int, prompt_len: int,
                       new_tokens: int) -> EnergyReport:
        return self.backend.decode_report(batch, prompt_len, new_tokens,
                                          stack=self.stack)

    def profile_decode_step(self, batch: int, cache_len: int) -> EnergyReport:
        return self.backend.decode_step_report(batch, cache_len,
                                               stack=self.stack)

    def profile_train_step(self, batch: int, seq: int) -> EnergyReport:
        return self.backend.train_report(batch, seq, stack=self.stack)

    def profile_generate(self, batch: int, prompt_len: int,
                         new_tokens: int) -> GenerateProfile:
        pre = self.profile_prefill(batch, prompt_len)
        dec = self.profile_decode(batch, prompt_len, new_tokens)
        gen = combine({"prefill": pre, "decode": dec})
        return GenerateProfile(prefill=pre, decode=dec, generate=gen,
                               batch=batch, prompt_len=prompt_len,
                               new_tokens=new_tokens)


class WallClock:
    """Tiny wall-clock context for CPU-relative latency comparisons."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False
