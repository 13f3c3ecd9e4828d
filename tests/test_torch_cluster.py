"""The port's router and cluster co-simulation (repro_torch.serving.
{router,cluster}) against the JAX package's, float for float (==):
every router in POLICIES, the _gated variants and the signal routers
with regions bound, over a seeded grid of arrival patterns and fleets
(homogeneous, and mixed in format and batch size); ClusterReport field
for field and per replica, with each request's record and the power
trace; disaggregated analytic runs with handoffs and link_degrade;
make_cluster; the constructors' and run's refusals."""
import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_orchestration import PKG, both, fields  # noqa: E402

PATTERNS = {
    "poisson": lambda a: a.poisson_arrivals(24, 20.0, seed=1),
    "burst": lambda a: a.burst_arrivals(24, 8, 1.0),
    "fixed": lambda a: a.fixed_arrivals(24, 0.1),
    "simultaneous": lambda a: [0.0] * 24,
}
GATED = ("round_robin_gated", "least_loaded_gated", "shortest_work_gated")
SIGNAL = ("carbon_aware", "price_aware")
REGIONS = [
    {"name": "west", "carbon": {"times": [0.0, 1.0, 2.0],
                                "values": [250.0, 600.0, 300.0]},
     "price": {"times": [0.0, 1.5], "values": [0.2, 0.05]}},
    {"name": "east", "carbon": 420.0, "price": 0.1},
]


def _reqs(P, pattern, seed=2, n=24):
    arr = PATTERNS[pattern](P.arrival)
    rng = np.random.default_rng(seed)
    return [P.requests.Request(
        req_id=i, prompt=None, prompt_len=int(rng.integers(64, 2049)),
        max_new_tokens=int(rng.integers(4, 97)),
        arrival_time=float(arr[i])) for i in range(n)]


def _replicas(P, fleet):
    if fleet == "homogeneous":
        return [P.engine.ServeEngine(
            P.llama, page_size=64,
            batch_policy=P.policy.SlotCountPolicy(max_batch=8,
                                                  max_prefill_batch=4))
            for _ in range(3)]
    return [P.engine.ServeEngine(
        P.llama, fmt=fmt, page_size=64,
        batch_policy=P.policy.SlotCountPolicy(max_batch=mb,
                                              max_prefill_batch=2))
        for fmt, mb in (("bfloat16", 8), ("int8", 4), ("nf4", 16))]


def _router(P, policy):
    router = P.router.make_router(policy)
    if policy in SIGNAL:
        regs = P.regions.load_regions(REGIONS)
        router.bind_regions(regs, P.regions.assign_replicas(regs, 3))
    return router


def _serve(P, policy, pattern, fleet):
    cl = P.cluster.ClusterEngine(_replicas(P, fleet), _router(P, policy))
    trace = P.trace.PowerTrace()
    rep = cl.run(_reqs(P, pattern), trace=trace)
    return fields(rep, trace), trace.coverage(rep.total_energy_j)


def test_router_registries_match():
    j, t = PKG["jax"].router, PKG["torch"].router
    assert t.POLICIES == j.POLICIES and t.GEO_POLICIES == j.GEO_POLICIES
    for name in j.POLICIES + GATED + ("energy_aware_gated",):
        a, b = j.make_router(name), t.make_router(name)
        assert (b.name, b.gates_idle) == (a.name, a.gates_idle)


@pytest.mark.parametrize("fleet", ["homogeneous", "mixed"])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("policy", PKG["jax"].router.POLICIES + GATED)
def test_cluster_equals_reference(policy, pattern, fleet):
    want, got = both(_serve, policy, pattern, fleet)
    assert got == want
    assert want[0][0][0]["n_completed"] == 24


def test_scheduler_in_front_of_the_router_equals_reference():
    def run(P):
        cl = P.cluster.ClusterEngine(_replicas(P, "homogeneous"),
                                     _router(P, "least_loaded"))
        trace = P.trace.PowerTrace()
        rep = cl.run(_reqs(P, "poisson"), trace=trace,
                     scheduler=P.scheduler.make_scheduler(
                         "window", window_s=0.3))
        return fields(rep, trace)
    want, got = both(run)
    assert got == want


@pytest.mark.parametrize("policy", ["round_robin", "energy_aware"])
def test_make_cluster_equals_reference(policy):
    def run(P):
        cl = P.cluster.make_cluster(P.llama, 2, policy=policy,
                                    fmt="int8", max_batch=6,
                                    max_prefill_batch=3)
        trace = P.trace.PowerTrace()
        rep = cl.run(_reqs(P, "burst"), trace=trace)
        return fields(rep, trace), [
            (e.max_batch, e.batch_policy.max_prefill_batch,
             e.policy.fmt) for e in cl.replicas]
    want, got = both(run)
    assert got == want


@pytest.mark.parametrize("n_prefill", [1, 2])
@pytest.mark.parametrize("link", [None, 4.0])
@pytest.mark.parametrize("pattern", ["poisson", "simultaneous"])
def test_disaggregated_cluster_equals_reference(pattern, link, n_prefill):
    def run(P):
        eng = [P.engine.ServeEngine(
            P.llama, pool=pool, page_size=64,
            batch_policy=P.policy.SlotCountPolicy(max_batch=8,
                                                  max_prefill_batch=4))
            for pool in ["prefill"] * n_prefill + ["decode", "decode"]]
        cl = P.cluster.ClusterEngine(eng, P.router.make_router(
            "least_loaded"))
        faults = None if link is None else P.schedule.FaultSchedule([
            dict(t=0.2, kind="link_degrade", link_factor=link,
                 duration_s=1.0)])
        trace = P.trace.PowerTrace()
        rep = cl.run(_reqs(P, pattern), trace=trace, faults=faults)
        return fields(rep, trace)
    want, got = both(run)
    assert got == want
    assert want[0][0]["n_handoffs"] == 24
    assert want[0][0]["handoff_energy_j"] > 0


def _error(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except Exception as e:      # noqa: BLE001 - the type is compared
        return type(e).__name__, str(e)
    return None


def test_refusals_equal_reference():
    def run(P):
        E, C = P.engine.ServeEngine, P.cluster.ClusterEngine
        S = P.schedule.FaultSchedule
        mixed = [E(P.llama) for _ in range(2)]
        split = [E(P.llama, pool="prefill"), E(P.llama, pool="decode")]
        reqs = _reqs(P, "fixed", n=2)
        crash = S([dict(t=0.1, kind="crash", downtime_s=1.0)])
        link = S([dict(t=0.1, kind="link_degrade", link_factor=2.0,
                       duration_s=1.0)])
        ctl = P.controllers.make_controller("static")
        out = [
            _error(C, []),
            _error(C, [E(P.llama, mode="sequential")]),
            _error(C, [E(P.llama), E(P.llama, pool="decode")]),
            _error(C, [E(P.llama, pool="prefill")]),
            _error(P.router.make_router, "nope"),
            _error(P.cluster.make_cluster, P.llama, 2,
                   batch_policy=P.policy.SlotCountPolicy()),
            _error(C(mixed).run, reqs, faults=crash, controller=ctl),
            _error(C(mixed).run, reqs, faults=S([dict(
                t=0.1, kind="crash", replica=5)])),
            _error(C(split).run, reqs, faults=crash),
            _error(C(split).run, reqs, faults=link,
                   retry=P.faults.make_retry("backoff")),
            _error(C(mixed).run, reqs, faults=link),
            _error(C(mixed).run, reqs,
                   retry=P.faults.make_retry("backoff")),
            _error(C(split).run, reqs, controller=ctl),
        ]
        _router(P, "carbon_aware")
        out.append(_error(C(mixed, P.router.make_router("carbon_aware"))
                          .run, reqs))
        return out
    want, got = both(run)
    assert got == want
    assert all(e is not None for e in want)
