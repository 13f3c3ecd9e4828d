"""Service-level objectives: the port's own copy of
``repro.serving.slo``.

Latency SLO tiers (priority + deadline), their assignment to request
streams, attainment scoring and the latency aggregates the serving
report reads, plus the analytic service-time and service-rate estimates
(through :class:`~repro_torch.core.energy.EnergyModel`) that the
reference's deadline and energy-budget schedulers admit by.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import workload as W
from repro_torch.core.energy import EnergyModel
from repro_torch.core.hardware import DeviceSpec, H100_SXM
from repro_torch.core.precision import make_policy
from repro_torch.serving.requests import Request


@dataclasses.dataclass(frozen=True)
class SLOTier:
    """A latency service class: higher priority wins contention, the
    deadline is the per-request latency budget from arrival."""

    name: str
    priority: int
    deadline_s: float


INTERACTIVE = SLOTier("interactive", priority=2, deadline_s=5.0)
STANDARD = SLOTier("standard", priority=1, deadline_s=30.0)
BATCH = SLOTier("batch", priority=0, deadline_s=math.inf)

TIERS: Dict[str, SLOTier] = {t.name: t for t in
                             (INTERACTIVE, STANDARD, BATCH)}


def get_tier(name: str) -> SLOTier:
    try:
        return TIERS[name]
    except KeyError:
        raise ValueError(f"unknown SLO tier {name!r}; known: {list(TIERS)}")


def assign_slos(requests: Iterable[Request],
                tiers: Sequence[SLOTier] = (INTERACTIVE, STANDARD, BATCH),
                weights: Optional[Sequence[float]] = None,
                seed: int = 0) -> List[Request]:
    """Tag each request with a tier drawn from ``weights`` (defaults to
    uniform). Deterministic under a fixed seed. Returns the requests."""
    reqs = list(requests)
    rng = np.random.default_rng(seed)
    w = np.asarray(weights if weights is not None
                   else [1.0] * len(tiers), float)
    w = w / w.sum()
    picks = rng.choice(len(tiers), size=len(reqs), p=w)
    for r, k in zip(reqs, picks):
        t = tiers[int(k)]
        r.priority = t.priority
        r.deadline_s = t.deadline_s
        r.slo_tier = t.name
    return reqs


# ---------------------------------------------------------------------------
# attainment scoring / latency aggregates
# ---------------------------------------------------------------------------
def completed(requests: Sequence[Request]) -> List[Request]:
    """Requests that actually finished (guards every latency aggregate
    against empty or fully-shed runs)."""
    return [r for r in requests if r.t_done >= 0.0]


def percentile_dict(values: Sequence[float],
                    qs: Sequence[float] = (50, 90, 99)
                    ) -> Dict[str, float]:
    """``{"p50": ..., ...}`` over raw values, 0.0-valued and NaN-free on
    the empty sequence: the one percentile implementation, which
    :class:`~repro_torch.serving.engine.ServeReport` reads."""
    vals = list(values)
    return {f"p{int(q)}": (float(np.percentile(vals, q)) if vals
                           else 0.0) for q in qs}


def percentiles(requests: Sequence[Request], *, field: str = "latency",
                qs: Sequence[float] = (50, 90, 99)) -> Dict[str, float]:
    """:func:`percentile_dict` over completed requests' ``field``
    (latency/ttft); 0.0-valued and NaN-free when nothing completed."""
    return percentile_dict([getattr(r, field)
                            for r in completed(requests)], qs)


def attainment(requests: Sequence[Request],
               shed: Sequence[Request] = ()) -> float:
    """Fraction of the offered load (completed + shed) that met its
    latency SLO. Shed requests count as misses: admission control is
    only honest if rejections are charged against attainment."""
    total = len(requests) + len(shed)
    if total == 0:
        return 1.0
    return sum(r.met_deadline for r in requests) / total


def slo_summary(requests: Sequence[Request],
                shed: Sequence[Request] = ()) -> Dict[str, float]:
    """Attainment overall and per tier, plus shed accounting."""
    out: Dict[str, float] = {
        "n_offered": len(requests) + len(shed),
        "n_shed": len(shed),
        "attainment": attainment(requests, shed),
    }
    tiers = sorted({r.slo_tier for r in list(requests) + list(shed)
                    if r.slo_tier is not None})
    for name in tiers:
        got = [r for r in requests if r.slo_tier == name]
        lost = [r for r in shed if r.slo_tier == name]
        out[f"attainment_{name}"] = attainment(got, lost)
        out[f"n_shed_{name}"] = len(lost)
    return out


# ---------------------------------------------------------------------------
# analytic service estimates (admission-control predictors)
# ---------------------------------------------------------------------------
def estimate_request_latency(cfg: ModelConfig, *, prompt_len: int,
                             new_tokens: int, batch: int = 8,
                             fmt: str = "bfloat16",
                             device: DeviceSpec = H100_SXM,
                             n_chips: int = 1, stack: str = "fused",
                             energy_model: Optional[EnergyModel] = None
                             ) -> float:
    """Predicted engine-side latency of one request served inside a
    steady decode batch of ``batch`` (prefill + its decode steps)."""
    em = energy_model or EnergyModel(device, make_policy(fmt))
    pre = em.evaluate(W.prefill_workload(cfg, 1, prompt_len, stack=stack),
                      n_chips)
    ctx = prompt_len + max(new_tokens, 1) // 2
    step = em.evaluate(W.decode_step_workload(cfg, max(batch, 1), ctx,
                                              stack=stack), n_chips)
    return pre.latency + max(new_tokens - 1, 0) * step.latency


def estimate_service_rate(cfg: ModelConfig, *, prompt_len: int,
                          new_tokens: int, batch: int = 8,
                          fmt: str = "bfloat16",
                          device: DeviceSpec = H100_SXM,
                          n_chips: int = 1, stack: str = "fused",
                          energy_model: Optional[EnergyModel] = None
                          ) -> float:
    """Sustainable requests/s of one engine running a steady decode
    batch of ``batch`` on the given workload shape. Used by the
    deadline scheduler to pace releases at what the engine can absorb."""
    em = energy_model or EnergyModel(device, make_policy(fmt))
    b = max(batch, 1)
    pre = em.evaluate(W.prefill_workload(cfg, b, prompt_len, stack=stack),
                      n_chips)
    ctx = prompt_len + max(new_tokens, 1) // 2
    step = em.evaluate(W.decode_step_workload(cfg, b, ctx, stack=stack),
                       n_chips)
    per_request_s = (pre.latency + max(new_tokens, 1) * step.latency) / b
    return 1.0 / max(per_request_s, 1e-12)
