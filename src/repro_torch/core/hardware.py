"""Hardware specification registry: the port's own copy of
``repro.core.hardware``, holding the H100 SXM only.

``h100-sxm`` is the paper's measurement platform and the card the port
runs on. Its constants are the reference's, so the analytic clock and
energy of a phase mean the same number in both packages. The reference's
other device stays in its own registry; :func:`get_device` names it.

Power is regime-dependent (paper §3.1: Tensor Cores "complete the
computation faster, but at a higher instantaneous power draw"):

* ``power_mxu``    — compute-bound on the tensor-core fast path,
* ``power_scalar`` — compute-bound on the slow (fp32/CUDA-core) path,
* ``power_memory`` — memory-bound kernels (bandwidth saturated, ALUs idle),
* ``idle_power``   — dispatch gaps between kernels (~120 W on H100, §3.2).

Dispatch overhead is stack-dependent (paper §2 "Idle time": the CPU thread
issuing kernels can be slower than the GPU): the eager ``transformers``
path pays ~40 us of host work per kernel; a fused serving stack (TGI-like)
pays a few us.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class PowerState:
    """One device power state on the serving timeline. Busy phases draw
    regime-dependent power from the energy model; the non-serving states
    here have a single nominal wattage charged for gaps."""

    name: str
    power_w: float
    serves: bool = False            # can phases execute in this state?
    wake_latency_s: float = 0.0     # ramp back to a serving state


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    name: str
    # peak dense matmul throughput for 16-bit formats (FLOP/s)
    peak_flops_16: float
    # peak throughput of the fp32 path (FLOP/s): the TF32/CUDA-core mix
    # the eager stack achieves
    peak_flops_32: float
    hbm_bw: float                   # HBM bandwidth (bytes/s)
    link_bw: float                  # inter-chip link bandwidth (bytes/s)
    # regime-dependent power draw (W), see the module docstring
    power_mxu: float
    power_scalar: float
    power_memory: float
    idle_power: float
    # host dispatch overhead per kernel launch (s), by serving stack
    launch_overhead_eager: float
    launch_overhead_fused: float
    # smallest efficient memory transaction (bytes): 32-64 B coalescing
    min_transaction_bytes: int
    hbm_capacity: float             # bytes
    # power (W) of a power-gated chip, and the ramp back to serving
    gated_power: float = 40.0
    wake_latency_s: float = 0.25
    # DVFS operating point (1.0: nominal boost clock). Compute throughput
    # scales linearly with the core clock, dynamic power (above the idle
    # floor) as f**dvfs_exponent; HBM runs on its own clock domain.
    freq_scale: float = 1.0
    dvfs_exponent: float = 3.0
    # fleet transitions: spin-up and drain latency and energy
    spinup_latency_s: float = 20.0
    spinup_energy_j: float = 2400.0
    drain_latency_s: float = 5.0
    drain_energy_j: float = 600.0
    # interconnect energy (pJ/byte) for moving state between chips
    link_pj_per_byte: float = 80.0

    def peak_flops(self, bits: float) -> float:
        """Matmul peak for a given operand width. Integer formats are
        dequantized to 16-bit before the product, so every format but
        fp32 runs at the 16-bit peak."""
        return self.peak_flops_32 if bits >= 32 else self.peak_flops_16

    def compute_power(self, bits: float) -> float:
        return self.power_scalar if bits >= 32 else self.power_mxu

    def launch_overhead(self, stack: str) -> float:
        return (self.launch_overhead_fused if stack == "fused"
                else self.launch_overhead_eager)

    def power_states(self) -> Dict[str, PowerState]:
        """The serving ``active`` state (regime-dependent draw; the listed
        wattage is the tensor-core ceiling) and the non-serving ``idle``,
        ``gated`` and ``off`` states charged for gaps."""
        return {
            "active": PowerState("active", self.power_mxu, serves=True),
            "idle": PowerState("idle", self.idle_power),
            "gated": PowerState("gated", self.gated_power,
                                wake_latency_s=self.wake_latency_s),
            "off": PowerState("off", 0.0,
                              wake_latency_s=self.spinup_latency_s),
        }

    def state_power(self, state: str) -> float:
        """Nominal power draw (W) of a non-busy power state. Busy states
        carry their own energy, so they have no single wattage here."""
        st = self.power_states().get(state)
        if st is None or st.serves:
            raise ValueError(f"no nominal power for state {state!r}")
        return st.power_w

    def with_freq_scale(self, scale: float) -> "DeviceSpec":
        """The spec at ``scale`` of the current core clock: compute
        throughput scales linearly, busy power as ``idle + (P - idle) *
        scale**dvfs_exponent``; HBM bandwidth, launch overhead and the
        idle and gated states are unchanged. Applications compose
        multiplicatively; the combined point stays within [0.1, 1.5]."""
        if scale <= 0:
            raise ValueError(f"freq_scale must be positive, got {scale}")
        if scale == 1.0:
            return self
        combined = self.freq_scale * scale
        if not 0.1 <= combined <= 1.5:
            raise ValueError(
                f"freq_scale {combined:g} (= {self.freq_scale:g} * "
                f"{scale:g}) outside [0.1, 1.5]")

        def dyn(p: float) -> float:
            return (self.idle_power
                    + (p - self.idle_power) * scale ** self.dvfs_exponent)

        base = self.name.split("@f")[0]
        name = base if combined == 1.0 else f"{base}@f{combined:g}"
        return dataclasses.replace(
            self, name=name,
            peak_flops_16=self.peak_flops_16 * scale,
            peak_flops_32=self.peak_flops_32 * scale,
            power_mxu=dyn(self.power_mxu),
            power_scalar=dyn(self.power_scalar),
            power_memory=dyn(self.power_memory),
            freq_scale=combined)


H100_SXM = DeviceSpec(
    name="h100-sxm",
    peak_flops_16=989e12,       # dense bf16/fp16 tensor core
    peak_flops_32=99e12,        # eager fp32 path (TF32-assisted, ~10x
                                # slower than the tensor-core path)
    hbm_bw=3.35e12,
    link_bw=450e9 / 18,         # NVLink per link
    power_mxu=700.0,
    power_scalar=280.0,         # paper: ~4x energy gain at ~10x latency
    power_memory=350.0,
    idle_power=120.0,           # paper §3.2: "typically around 120 W"
    launch_overhead_eager=40e-6,  # transformers host loop per kernel
    launch_overhead_fused=5e-6,   # TGI/CUDA-graph-like dispatch
    min_transaction_bytes=64,
    hbm_capacity=80e9,
    gated_power=45.0,           # deep low-power state
    wake_latency_s=0.25,        # clock/power ramp back to serving
    spinup_latency_s=30.0,      # weights load + runtime warm-up
    spinup_energy_j=3600.0,     # ~idle-class draw over the ramp window
    drain_latency_s=5.0,
    drain_energy_j=600.0,
    link_pj_per_byte=80.0,      # NVLink end to end (~10 pJ/bit)
)

DEVICES = {d.name: d for d in (H100_SXM,)}

#: devices of the reference's registry that the port does not hold
_REFERENCE_ONLY = ("tpu-v5e",)


def get_device(name: str) -> DeviceSpec:
    if name in _REFERENCE_ONLY:
        raise KeyError(f"device {name!r} is in the JAX reference's "
                       "registry (repro.core.hardware) only; the port "
                       f"holds {list(DEVICES)}")
    try:
        return DEVICES[name]
    except KeyError:
        raise ValueError(f"unknown device {name!r}; known: {list(DEVICES)}")
