"""Roofline terms of one step on a mesh of chips.

Counterpart of ``repro.core.roofline``:

    compute term    = FLOPs / (chips * peak_FLOP/s)
    memory term     = bytes / (chips * HBM_bw)
    collective term = collective_bytes / (chips * link_bw)

The reference reads its FLOPs and bytes from compiled XLA artifacts
(``terms_from_compiled``); the port counts them on the operations a step
actually dispatches (:mod:`repro_torch.core.op_analysis`) and builds the
terms from those counts (:func:`terms_from_counts`). The terms are priced
on the H100 SXM, the one card of the port's registry.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.hardware import DeviceSpec, H100_SXM


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    collective_breakdown: Dict[str, float]
    model_flops: float                      # 6ND / 2ND yardstick
    device: DeviceSpec = H100_SXM
    peak_bits: int = 16

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.n_chips
                                 * self.device.peak_flops(self.peak_bits))

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.n_chips * self.device.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.n_chips * self.device.link_bw)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flop_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs: catches remat/redundancy waste."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def step_time(self) -> float:
        return max(self.t_compute, self.t_memory) + self.t_collective

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the step the dominant *useful* term explains: 1.0
        is the best step the useful model FLOPs allow; lower is waste
        (redundant compute, spilled bytes, serial collectives)."""
        ideal = self.model_flops / (self.n_chips
                                    * self.device.peak_flops(self.peak_bits))
        return ideal / self.step_time if self.step_time else 0.0

    def row(self) -> Dict[str, object]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.n_chips,
            "hlo_gflops": self.hlo_flops / 1e9,
            "hlo_gbytes": self.hlo_bytes / 1e9,
            "coll_gbytes": self.collective_bytes / 1e9,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_gflops": self.model_flops / 1e9,
            "useful_ratio": self.useful_flop_ratio,
            "roofline_frac": self.roofline_fraction,
        }


def terms_from_counts(cost, *, arch: str, shape: str, mesh: str,
                      n_chips: int, model_flops: float,
                      device: DeviceSpec = H100_SXM,
                      peak_bits: int = 16) -> RooflineTerms:
    """The terms of a step whose per-chip counts are ``cost`` (an
    :class:`~repro_torch.core.op_analysis.OpCost`): FLOPs, dot plus
    argument bytes and collective bytes, each times the chip count."""
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh, n_chips=n_chips,
        hlo_flops=cost.dot_flops * n_chips,
        hlo_bytes=(cost.dot_bytes + cost.parameter_bytes) * n_chips,
        collective_bytes=cost.collective_bytes * n_chips,
        collective_breakdown={k: v * n_chips for k, v in
                              cost.collective_breakdown.items()},
        model_flops=model_flops, device=device, peak_bits=peak_bits)
