"""Multi-region geo layer: time-varying carbon/price signals.
The port's own copy of ``repro.fleet.regions``.

A :class:`Region` is where a slice of the fleet's replicas physically
run. It carries two piecewise-linear time signals — grid carbon
intensity (gCO2/kWh) and energy price ($/kWh) — plus the network facts
the router and the report need (client RTT, egress price). Signals are
exact: :meth:`Signal.integral` evaluates the closed-form piecewise-
quadratic antiderivative, so gCO2/$ accounting has no quadrature error
and the fleet's energy-carbon ledger closes exactly.

Regions are JSON-serializable dicts (the reference's
``repro.api.ExperimentSpec`` carries them as ``regions=``);
:func:`load_regions` builds the runtime objects from dicts or a JSON
file, and :func:`sinusoid_region` manufactures a
diurnal region dict (sinusoidal carbon/price over a 24 h period) for
examples and benchmarks.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

__all__ = ["Signal", "Region", "load_regions", "sinusoid_region",
           "assign_replicas"]


class Signal:
    """Piecewise-linear time-varying scalar, optionally periodic.

    ``times`` must be strictly increasing. Outside the breakpoint span
    the signal extends as a constant (first/last value) — unless
    ``period_s`` is given, in which case the signal wraps: the final
    segment interpolates from the last breakpoint back to the first
    value at ``period_s``, and ``f(t) = f(t mod period_s)``.
    """

    def __init__(self, times: Sequence[float], values: Sequence[float],
                 period_s: Optional[float] = None):
        t = np.asarray(times, dtype=np.float64)
        v = np.asarray(values, dtype=np.float64)
        if t.ndim != 1 or t.shape != v.shape or t.size == 0:
            raise ValueError("signal needs matching non-empty "
                             "times/values")
        if t.size > 1 and not np.all(np.diff(t) > 0):
            raise ValueError("signal times must be strictly increasing")
        self.period_s = float(period_s) if period_s is not None else None
        if self.period_s is not None:
            if t[0] < 0 or t[-1] >= self.period_s:
                raise ValueError("periodic signal needs breakpoints "
                                 "inside [0, period_s)")
            # close the loop: wrap the last segment back to value[0]
            t = np.concatenate([t, [self.period_s]])
            v = np.concatenate([v, [v[0]]])
        self.times = t
        self.values = v
        # exact antiderivative at each breakpoint (trapezoid prefix)
        if t.size > 1:
            self._F = np.concatenate(
                [[0.0], np.cumsum(0.5 * (v[1:] + v[:-1]) * np.diff(t))])
        else:
            self._F = np.zeros(1)

    # -- evaluation ----------------------------------------------------
    def _wrap(self, t: np.ndarray) -> np.ndarray:
        if self.period_s is None:
            return t
        return np.mod(t, self.period_s)

    def at(self, t) -> np.ndarray:
        """Signal value at time(s) ``t`` (scalar in, scalar out)."""
        arr = np.asarray(t, dtype=np.float64)
        out = np.interp(self._wrap(arr), self.times, self.values)
        return float(out) if np.isscalar(t) else out

    def _F_at(self, t: np.ndarray) -> np.ndarray:
        """Exact antiderivative F(t) = ∫₀ᵗ f(u) du, vectorized."""
        if self.period_s is not None:
            n_per = np.floor_divide(t, self.period_s)
            frac = t - n_per * self.period_s
            return n_per * self._F[-1] + self._F_base(frac)
        return self._F_base(t)

    def _F_base(self, t: np.ndarray) -> np.ndarray:
        ts, vs, F = self.times, self.values, self._F
        t = np.asarray(t, dtype=np.float64)
        if ts.size == 1:
            return vs[0] * (t - ts[0])
        idx = np.clip(np.searchsorted(ts, t, side="right") - 1,
                      0, ts.size - 2)
        t0, t1 = ts[idx], ts[idx + 1]
        v0, v1 = vs[idx], vs[idx + 1]
        slope = (v1 - v0) / (t1 - t0)
        # clamp into the span; constant extension outside it
        below = t < ts[0]
        above = t > ts[-1]
        tc = np.clip(t, ts[0], ts[-1])
        dt = tc - t0
        out = F[idx] + v0 * dt + 0.5 * slope * dt * dt
        out = np.where(below, vs[0] * (t - ts[0]), out)
        out = np.where(above, F[-1] + vs[-1] * (t - ts[-1]), out)
        return out

    def integral(self, t0, t1) -> np.ndarray:
        """∫ f over [t0, t1], exact (vectorized over window arrays)."""
        a = np.asarray(t0, dtype=np.float64)
        b = np.asarray(t1, dtype=np.float64)
        out = self._F_at(b) - self._F_at(a)
        return float(out) if np.isscalar(t0) and np.isscalar(t1) else out

    def mean(self, t0, t1) -> np.ndarray:
        """Mean of f over [t0, t1]; the point value when the window has
        zero (or negative) width."""
        a = np.asarray(t0, dtype=np.float64)
        b = np.asarray(t1, dtype=np.float64)
        w = b - a
        with np.errstate(divide="ignore", invalid="ignore"):
            out = np.where(w > 0.0,
                           self.integral(a, b) / np.where(w > 0, w, 1.0),
                           self.at(a))
        return float(out) if np.isscalar(t0) and np.isscalar(t1) else out

    def to_dict(self) -> Dict:
        n = self.times.size - (1 if self.period_s is not None else 0)
        d = {"times": self.times[:n].tolist(),
             "values": self.values[:n].tolist()}
        if self.period_s is not None:
            d["period_s"] = self.period_s
        return d


def _signal_from(obj, default: float) -> Signal:
    """Signal from a dict / scalar / [[t, v], ...] pair list."""
    if obj is None:
        return Signal([0.0], [default])
    if isinstance(obj, Signal):
        return obj
    if isinstance(obj, (int, float)):
        return Signal([0.0], [float(obj)])
    if isinstance(obj, dict):
        return Signal(obj["times"], obj["values"],
                      period_s=obj.get("period_s"))
    pairs = list(obj)
    return Signal([p[0] for p in pairs], [p[1] for p in pairs])


@dataclasses.dataclass
class Region:
    """One geography the fleet serves from."""

    name: str
    carbon: Signal                  # grid intensity, gCO2 per kWh
    price: Signal                   # energy price, $ per kWh
    rtt_s: float = 0.0              # client round-trip to this region
    egress_usd_per_gb: float = 0.0  # network egress price
    replicas: Optional[int] = None  # fleet slice size (None: even split)

    def to_dict(self) -> Dict:
        d = {"name": self.name, "carbon": self.carbon.to_dict(),
             "price": self.price.to_dict(), "rtt_s": self.rtt_s,
             "egress_usd_per_gb": self.egress_usd_per_gb}
        if self.replicas is not None:
            d["replicas"] = self.replicas
        return d


def load_regions(obj: Union[str, Sequence]) -> List[Region]:
    """Build :class:`Region` objects from a JSON file path or a list
    of region dicts (the ``regions=`` spec axis)."""
    if isinstance(obj, str):
        with open(obj) as f:
            obj = json.load(f)
    if isinstance(obj, dict):
        obj = obj.get("regions", [])
    out = []
    for i, r in enumerate(obj):
        if isinstance(r, Region):
            out.append(r)
            continue
        if not isinstance(r, dict) or "name" not in r:
            raise ValueError(f"region #{i} needs a dict with a 'name'")
        out.append(Region(
            name=str(r["name"]),
            carbon=_signal_from(r.get("carbon"), 400.0),
            price=_signal_from(r.get("price"), 0.10),
            rtt_s=float(r.get("rtt_s", 0.0)),
            egress_usd_per_gb=float(r.get("egress_usd_per_gb", 0.0)),
            replicas=(int(r["replicas"]) if "replicas" in r else None)))
    names = [r.name for r in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate region names: {names}")
    return out


def assign_replicas(regions: Sequence[Region], n_replicas: int
                    ) -> List[int]:
    """Region index per replica. Explicit per-region ``replicas`` counts
    must cover the whole fleet; with none given the fleet splits as
    evenly as possible (remainder to the earliest regions)."""
    if not regions:
        return [0] * n_replicas
    counts = [r.replicas for r in regions]
    if any(c is not None for c in counts):
        if any(c is None for c in counts):
            raise ValueError("either every region or no region may set "
                             "'replicas'")
        if sum(counts) != n_replicas:
            raise ValueError(
                f"region replica counts {counts} must sum to the "
                f"fleet size {n_replicas}")
    else:
        base, rem = divmod(n_replicas, len(regions))
        counts = [base + (1 if i < rem else 0)
                  for i in range(len(regions))]
    out: List[int] = []
    for i, c in enumerate(counts):
        out.extend([i] * c)
    return out


def sinusoid_region(name: str, *, carbon_mean: float = 400.0,
                    carbon_amp: float = 150.0, price_mean: float = 0.10,
                    price_amp: float = 0.04, phase_h: float = 0.0,
                    rtt_s: float = 0.0, egress_usd_per_gb: float = 0.0,
                    replicas: Optional[int] = None,
                    period_s: float = 86400.0,
                    points_per_period: int = 48) -> Dict:
    """A diurnal region dict (JSON-serializable, spec-embeddable):
    carbon and price follow ``mean + amp * sin(2π(t/T + phase))``,
    sampled at ``points_per_period`` piecewise-linear breakpoints."""
    ts = [period_s * k / points_per_period
          for k in range(points_per_period)]
    phase = phase_h * 3600.0 / period_s

    def wave(mean: float, amp: float) -> Dict:
        vals = [mean + amp * math.sin(2 * math.pi * (t / period_s + phase))
                for t in ts]
        return {"times": ts, "values": vals, "period_s": period_s}

    d = {"name": name, "carbon": wave(carbon_mean, carbon_amp),
         "price": wave(price_mean, price_amp), "rtt_s": rtt_s,
         "egress_usd_per_gb": egress_usd_per_gb}
    if replicas is not None:
        d["replicas"] = replicas
    return d
