"""Phase-aware analytic energy model: the port's own copy of
``repro.core.energy``, the paper's core methodology.

The paper measures that LLM-inference energy is governed by *which regime
a phase is in*, not by headline format width:

* compute-bound phases (large-model prefill) ride the tensor-core fast
  path: lower precision gives real energy wins (up to 4x fp32 -> 16-bit,
  at up to 10x latency gain; Tensor Cores draw more power, limiting the
  energy saving relative to the speedup);
* memory-bound phases (decode) are dominated by weight/KV traffic and by
  idle power burned in dispatch gaps between small fragmented kernels;
  there, int8/int4 dequant overhead makes energy *worse* (2-3x fp32);
* batching amortizes both weight traffic and launch overhead, so energy
  per output token falls about logarithmically with batch size.

The model, evaluated on the host with numpy floats in the reference's
order of operations (so both packages give the same bits):

    t_compute    = FLOPs / peak(format)
    t_memory     = effective_bytes / HBM_bw
    t_collective = collective_bytes / link_bw
    t_busy       = max(t_compute, t_memory) + t_collective
    t_idle       = n_kernel_launches * launch_overhead(stack)
    P_busy       = power(regime, format)
    E            = P_busy * t_busy + P_idle * t_idle

``effective_bytes`` folds in the paper's §3.2 observations:
dequantization re-materializes 16-bit weights (extra traffic), and
sub-byte formats do not reduce bandwidth proportionally because
transactions have a fixed minimum width.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.core.hardware import DeviceSpec
from repro_torch.core.precision import INT8, NF4, PrecisionPolicy

# Bandwidth efficiency of reading packed quantized weights relative to a
# contiguous 16-bit stream (paper: "4-bit formats do not reduce memory
# bandwidth proportionally ... combined with misalignment and suboptimal
# coalescing").
_QUANT_READ_EFFICIENCY = {INT8: 0.90, NF4: 0.60}
# Extra kernel launches a quantized matmul incurs on the bitsandbytes-style
# path. int8 (LLM.int8): quantize activations, outlier extract, int8 GEMM
# epilogue dequant, fp16 outlier GEMM, merge, scale bookkeeping -> ~6.
# nf4: bitsandbytes ships a fused 4-bit dequant-gemv for inference, so
# only ~1 extra launch (absmax state load).
_DEQUANT_LAUNCHES_PER_MATMUL = {INT8: 6, NF4: 1}


@dataclasses.dataclass(frozen=True)
class PhaseWorkload:
    """Everything the energy model needs to know about one phase
    (:mod:`repro_torch.core.workload` produces it)."""

    phase: str                 # "prefill" | "decode" | "train"
    flops: float               # useful matmul FLOPs
    weight_bytes_16: float     # weight traffic if stored in 16-bit
    act_bytes: float           # activation + KV-cache traffic
    n_matmuls: int             # weight matmuls executed (dequant sites)
    n_kernel_launches: int     # kernels dispatched (pre-quantization)
    collective_bytes: float = 0.0
    n_steps: int = 1           # autoregressive steps folded into this phase
    stack: str = "eager"       # "eager" (transformers) | "fused" (TGI-like)

    def scaled(self, k: float) -> "PhaseWorkload":
        return dataclasses.replace(
            self, flops=self.flops * k,
            weight_bytes_16=self.weight_bytes_16 * k,
            act_bytes=self.act_bytes * k, n_matmuls=int(self.n_matmuls * k),
            n_kernel_launches=int(self.n_kernel_launches * k),
            collective_bytes=self.collective_bytes * k)


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    phase: str
    t_compute: float
    t_memory: float
    t_collective: float
    t_busy: float
    t_idle: float
    latency: float             # t_busy + t_idle
    energy_j: float
    bound: str                 # "compute" | "memory" | "collective" | "idle"

    @property
    def energy_wh(self) -> float:
        return self.energy_j / 3600.0

    def per(self, n: float) -> "EnergyReport":
        """Normalize (e.g. per token, per request)."""
        if n <= 0:
            raise ValueError("normalizer must be positive")
        return dataclasses.replace(
            self, t_compute=self.t_compute / n, t_memory=self.t_memory / n,
            t_collective=self.t_collective / n, t_busy=self.t_busy / n,
            t_idle=self.t_idle / n, latency=self.latency / n,
            energy_j=self.energy_j / n)


def _dominant(t_compute, t_memory, t_collective, t_idle) -> str:
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_collective, "idle": t_idle}
    return max(terms, key=terms.get)


class EnergyModel:
    """Phase-aware energy model for one device and precision policy."""

    def __init__(self, device: DeviceSpec, policy: PrecisionPolicy):
        self.device = device
        self.policy = policy

    # -- traffic / launch adjustments for the precision format ----------
    def weight_traffic_bytes(self, weight_bytes_16: float) -> float:
        """HBM bytes moved to stream the weights once."""
        p = self.policy
        stored = weight_bytes_16 * (p.weight_bits / 16.0)
        if not p.is_quantized:
            return stored
        eff = _QUANT_READ_EFFICIENCY[p.fmt]
        # bitsandbytes-style path: read packed ints (reduced coalescing
        # efficiency), write the 16-bit dequantized tensor, read it back
        # into the matmul; FusedDequantEnergyModel removes the round trip
        return stored / eff + 2.0 * weight_bytes_16

    def extra_launches(self, n_matmuls: int) -> int:
        if not self.policy.is_quantized:
            return 0
        return n_matmuls * _DEQUANT_LAUNCHES_PER_MATMUL[self.policy.fmt]

    # -- main entry ------------------------------------------------------
    def evaluate(self, w: PhaseWorkload, n_chips: int = 1) -> EnergyReport:
        d, p = self.device, self.policy
        t_compute = w.flops / (d.peak_flops(p.weight_bits) * n_chips)
        bytes_moved = (self.weight_traffic_bytes(w.weight_bytes_16)
                       + w.act_bytes)
        t_memory = bytes_moved / (d.hbm_bw * n_chips)
        t_collective = (w.collective_bytes / (d.link_bw * n_chips)
                        if w.collective_bytes else 0.0)
        launches = w.n_kernel_launches + self.extra_launches(w.n_matmuls)
        t_idle = launches * d.launch_overhead(w.stack)
        t_busy = max(t_compute, t_memory) + t_collective
        # regime-dependent instantaneous power (paper §3.1 mechanism)
        if t_compute >= t_memory:
            p_busy = d.compute_power(p.weight_bits)
        else:
            p_busy = d.power_memory
        energy_per_chip = p_busy * t_busy + d.idle_power * t_idle
        bound = _dominant(t_compute, t_memory, t_collective, t_idle)
        return EnergyReport(
            phase=w.phase, t_compute=t_compute, t_memory=t_memory,
            t_collective=t_collective, t_busy=t_busy, t_idle=t_idle,
            latency=t_busy + t_idle,
            energy_j=energy_per_chip * n_chips, bound=bound)

    # -- vectorized entry (decode runs) ----------------------------------
    def evaluate_steps(self, w: PhaseWorkload, flops, act_bytes,
                       n_chips: int = 1):
        """Evaluate a run of same-shaped phases whose only varying inputs
        are per-step ``flops`` / ``act_bytes`` arrays
        (:func:`repro_torch.core.workload.decode_step_arrays`).

        Returns ``(latency_s, energy_j)`` arrays and the first step's
        regime tag, bit-identical to :meth:`evaluate` once per step: the
        elementwise float64 operations are the scalar code's, in its
        order."""
        if w.collective_bytes:
            raise ValueError("evaluate_steps assumes no collective "
                             "traffic (decode-step workloads)")
        d, p = self.device, self.policy
        flops = np.asarray(flops, dtype=np.float64)
        act_bytes = np.asarray(act_bytes, dtype=np.float64)
        t_compute = flops / (d.peak_flops(p.weight_bits) * n_chips)
        bytes_moved = (self.weight_traffic_bytes(w.weight_bytes_16)
                       + act_bytes)
        t_memory = bytes_moved / (d.hbm_bw * n_chips)
        launches = w.n_kernel_launches + self.extra_launches(w.n_matmuls)
        t_idle = launches * d.launch_overhead(w.stack)
        t_busy = np.maximum(t_compute, t_memory)    # t_collective == 0
        compute_bound = t_compute >= t_memory
        p_busy = np.where(compute_bound,
                          d.compute_power(p.weight_bits), d.power_memory)
        energy = (p_busy * t_busy + d.idle_power * t_idle) * n_chips
        latency = t_busy + t_idle
        bound0 = _dominant(float(t_compute[0]), float(t_memory[0]),
                           0.0, t_idle)
        return latency, energy, bound0


class FusedDequantEnergyModel(EnergyModel):
    """Dequantization fused into the matmul kernel, as the port's
    int8/nf4 kernels do it (``kernels/quant_matmul``): the packed weight
    is dequantized on chip and fed to the tensor cores, with no 16-bit
    round trip through HBM and no extra launches."""

    def weight_traffic_bytes(self, weight_bytes_16: float) -> float:
        p = self.policy
        stored = weight_bytes_16 * (p.weight_bits / 16.0)
        if not p.is_quantized:
            return stored
        # the packed weight read in whole tiles: high efficiency for both
        # widths
        return stored / 0.95

    def extra_launches(self, n_matmuls: int) -> int:
        return 0


def idle_energy(device: DeviceSpec, seconds: float) -> float:
    """Joules burned by a device sitting idle (serving-gap accounting)."""
    return device.idle_power * max(seconds, 0.0)


def combine(reports: Dict[str, EnergyReport]) -> EnergyReport:
    """Sum phase reports into a 'generate' aggregate (prefill + decode)."""
    vals = list(reports.values())
    if not vals:
        raise ValueError("no reports to combine")
    t_c = sum(r.t_compute for r in vals)
    t_m = sum(r.t_memory for r in vals)
    t_x = sum(r.t_collective for r in vals)
    t_b = sum(r.t_busy for r in vals)
    t_i = sum(r.t_idle for r in vals)
    e = sum(r.energy_j for r in vals)
    return EnergyReport(phase="generate", t_compute=t_c, t_memory=t_m,
                        t_collective=t_x, t_busy=t_b, t_idle=t_i,
                        latency=t_b + t_i, energy_j=e,
                        bound=_dominant(t_c, t_m, t_x, t_i))
