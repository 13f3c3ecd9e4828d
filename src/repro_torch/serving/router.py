"""Request routing policies for multi-replica cluster serving.
The port's own copy of ``repro.serving.router``.

The paper's single-device result — orchestration (batching, timing)
moves per-request energy by orders of magnitude — compounds at fleet
scale: *where* a request lands decides which replicas batch well and
which burn idle power. Routers see the live replica states at each
arrival and pick a replica; the energy-aware policy additionally
power-gates idle replicas (they accrue ``DeviceSpec.gated_power``
instead of ``idle_power`` during gaps).

Policies:

* ``round_robin``      — classic fair spreading (the fleet baseline),
* ``least_loaded``     — fewest unfinished requests (queue depth),
* ``shortest_work``    — join-shortest-expected-work: outstanding
                         prompt + decode tokens, so long prompts count
                         for what they cost (JSQ refined by size),
* ``energy_aware``     — minimize *predicted marginal fleet energy* of
                         the assignment under the replica's own
                         :class:`~repro_torch.core.energy.EnergyModel`
                         (heterogeneous fleets: each replica may have
                         its own precision format, device, max_batch),
                         and gate idle replicas,
* ``carbon_aware``     — geo-routing: among replicas with free decode
                         slots, prefer the region whose grid carbon
                         intensity (gCO2/kWh) is lowest *right now*
                         (requires ``regions=`` on the spec),
* ``price_aware``      — same, minimizing the spot energy price.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, List

from repro_torch.core import workload as W

if TYPE_CHECKING:   # engine imports stay runtime-light
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.requests import Request


class Router:
    """Base router: pick a replica index for each arriving request."""

    name = "base"
    #: whether idle replicas are power-gated under this policy
    gates_idle = False
    #: what select() observes about replicas — lets the vectorized
    #: fleet loop decide how far a replica may advance between
    #: arrivals without changing routing decisions:
    #:   "none"  reads nothing (round robin),
    #:   "load"  reads only stream_load (queue depths),
    #:   "work"  reads per-token outstanding work,
    #:   "state" reads arbitrary engine state (the conservative
    #:           default for custom routers).
    reads = "state"

    def select(self, req: "Request", replicas: List["ServeEngine"],
               now: float) -> int:
        raise NotImplementedError

    def gated(self) -> "Router":
        """Variant of this policy that also power-gates idle replicas
        (lets benchmarks separate the gating discount from routing
        quality, e.g. round_robin vs round_robin+gating vs
        energy_aware)."""
        self.gates_idle = True
        self.name = self.name + "_gated"
        return self


class RoundRobinRouter(Router):
    name = "round_robin"
    reads = "none"

    def __init__(self):
        self._next = 0

    def select(self, req, replicas, now) -> int:
        i = self._next % len(replicas)
        self._next += 1
        return i


class LeastLoadedRouter(Router):
    name = "least_loaded"
    reads = "load"

    def select(self, req, replicas, now) -> int:
        return min(range(len(replicas)),
                   key=lambda i: (replicas[i].stream_load, i))


class ShortestWorkRouter(Router):
    """Join-shortest-expected-work, prompt-length aware."""

    name = "shortest_work"
    reads = "work"

    def select(self, req, replicas, now) -> int:
        return min(range(len(replicas)),
                   key=lambda i: (replicas[i].stream_outstanding_work(),
                                  i))


class EnergyAwareRouter(Router):
    """Route to minimize predicted marginal energy; gate idle replicas.

    The marginal cost of landing ``req`` on a replica is the request's
    own prefill energy plus the *increase* in decode-step energy from
    growing that replica's decode batch by one, over the request's
    decode steps. Batching amortizes weight traffic and launch
    overhead, so the marginal decode term collapses on already-warm
    replicas — the policy therefore consolidates load onto few warm
    replicas and leaves the rest power-gated, which is exactly the
    fleet-level version of the paper's batching result.
    """

    name = "energy_aware"
    gates_idle = True

    def select(self, req, replicas, now) -> int:
        scores = [self._marginal_energy_j(eng, req)
                  for eng in replicas]
        return min(range(len(replicas)),
                   key=lambda i: (scores[i], replicas[i].stream_load, i))

    @staticmethod
    def _marginal_energy_j(eng: "ServeEngine", req: "Request") -> float:
        load = eng.stream_load
        ctx = req.prompt_len + req.max_new_tokens // 2
        pre = eng.energy.evaluate(W.prefill_workload(
            eng.cfg, 1, req.prompt_len, stack=eng.stack), eng.n_chips)

        def step(batch: int):
            b = min(batch, eng.max_batch)
            return eng.energy.evaluate(W.decode_step_workload(
                eng.cfg, b, ctx, stack=eng.stack), eng.n_chips)

        new = step(load + 1)
        if load < eng.max_batch:
            marginal_decode = (new.energy_j
                               - (step(load).energy_j if load else 0.0)) \
                * req.max_new_tokens
        else:
            # replica saturated: the queued request still costs its fair
            # share of a full decode batch (it is NOT free — without
            # this, a saturated replica outranks every warm one and the
            # fleet starves), and deeper queues cost proportionally more
            # so overload eventually spills to the next-best replica
            share = new.energy_j / eng.max_batch * req.max_new_tokens
            queue_pressure = 1.0 + (load - eng.max_batch + 1) \
                / eng.max_batch
            marginal_decode = share * queue_pressure
        # waking a gated replica holds it out of the gated state for the
        # request's service window: charge the idle-vs-gated power delta
        # over that window, plus the wake ramp itself, to this assignment
        wake = 0.0
        if load == 0:
            service_t = pre.latency + new.latency * req.max_new_tokens
            wake = (eng.device.idle_power
                    - eng.device.gated_power) * service_t \
                + eng.device.idle_power * eng.device.wake_latency_s
        return pre.energy_j + marginal_decode + wake


class _SignalAwareRouter(Router):
    """Shared machinery for geo-routing on a per-region time signal.

    Needs the region layer bound (:meth:`bind_regions`) before the
    first ``select`` (the reference's ``repro.fleet.FleetEngine`` does
    this from the spec's ``regions=`` axis; a cluster's caller binds
    them). Among replicas with a free decode
    slot the policy picks the lowest (signal, load, index); when every
    replica is saturated it degrades to least-loaded, so low-carbon
    regions can't starve the fleet by queueing unboundedly.
    """

    reads = "load"
    #: Region attribute holding the Signal this policy minimizes
    signal_attr = "carbon"

    def __init__(self):
        self._regions = None
        self._region_of = None

    def bind_regions(self, regions, region_of) -> None:
        """Attach the region layer: ``regions`` is a list of
        :class:`repro_torch.fleet.Region`, ``region_of[i]`` the region index
        serving replica ``i``."""
        self._regions = list(regions)
        self._region_of = list(region_of)

    def signal_value(self, region_idx: int, now: float) -> float:
        sig = getattr(self._regions[region_idx], self.signal_attr)
        return float(sig.at(now))

    def select(self, req, replicas, now) -> int:
        if self._regions is None:
            raise ValueError(
                f"{self.name!r} routing needs a bound region layer; "
                "set regions= on the ExperimentSpec (or call "
                "bind_regions)")
        vals = [self.signal_value(self._region_of[i], now)
                for i in range(len(replicas))]
        free = [i for i in range(len(replicas))
                if replicas[i].stream_load < replicas[i].max_batch]
        pool = free if free else range(len(replicas))
        return min(pool, key=lambda i: (vals[i],
                                        replicas[i].stream_load, i))


class CarbonAwareRouter(_SignalAwareRouter):
    name = "carbon_aware"
    signal_attr = "carbon"


class PriceAwareRouter(_SignalAwareRouter):
    name = "price_aware"
    signal_attr = "price"


_ROUTERS = {cls.name: cls for cls in
            (RoundRobinRouter, LeastLoadedRouter, ShortestWorkRouter,
             EnergyAwareRouter, CarbonAwareRouter, PriceAwareRouter)}

POLICIES = tuple(_ROUTERS)
#: policies that only work with a bound region layer (regions= on the
#: spec) — single-cluster sweeps should exclude these
GEO_POLICIES = ("carbon_aware", "price_aware")


def make_router(policy: str) -> Router:
    """Build a router; a ``_gated`` suffix (e.g. ``round_robin_gated``)
    adds idle power gating to any base policy."""
    base = policy
    gated = False
    if base.endswith("_gated") and base[:-len("_gated")] in _ROUTERS:
        base, gated = base[:-len("_gated")], True
    try:
        r = _ROUTERS[base]()
    except KeyError:
        raise ValueError(
            f"unknown routing policy {policy!r}; known: {list(_ROUTERS)}")
    return r.gated() if gated else r
