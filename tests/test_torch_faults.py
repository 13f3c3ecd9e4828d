"""The port's fault layer (repro_torch.faults: schedules, retry policies,
the run invariants) and the engines' fault paths against the JAX
package's, float for float (==): random_fault_schedule and make_faults
give equal schedules and boundaries; single-engine and cluster runs
under every FAULT_KINDS entry, with no retry, backoff and hedged
retries, give equal reports, per-request records and power traces,
macro-stepped and single-stepped; check_run_invariants passes on both
packages' runs, and fails on both for the same broken report."""
import dataclasses
import math

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_orchestration import PKG, both, fields  # noqa: E402

# one event of each replica kind on replica 0 (the cluster also runs
# them on replica 1); link_degrade runs on a disaggregated cluster
EVENTS = {
    "crash": dict(t=1.0, kind="crash", downtime_s=3.0),
    "preempt": dict(t=0.5, kind="preempt", notice_s=1.0, downtime_s=3.0),
    "slowdown": dict(t=0.5, kind="slowdown", freq_scale=0.5,
                     duration_s=2.0),
    "power_cap": dict(t=0.8, kind="power_cap", freq_scale=0.7,
                      duration_s=1.5),
    "link_degrade": dict(t=0.5, kind="link_degrade", link_factor=4.0,
                         duration_s=5.0),
}
RETRIES = {"none": None, "backoff": ("backoff", {}),
           "hard_kill": ("backoff", {"drain_on_notice": False}),
           "hedged": ("hedged", {}),
           "timeout": ("backoff", {"timeout_s": 2.0, "backoff_s": 1.5})}


def test_fault_kinds_and_retry_names_match():
    j, t = PKG["jax"], PKG["torch"]
    assert t.schedule.FAULT_KINDS == j.schedule.FAULT_KINDS
    assert set(EVENTS) == set(j.schedule.FAULT_KINDS)
    assert t.faults.RETRY_POLICIES == j.faults.RETRY_POLICIES


def _schedule_fields(fs):
    out = [dataclasses.astuple(e) + (e.t_kill, e.t_restart, e.t_end)
           for e in fs.events]
    bounds = [[(b.t, b.action, b.event.kind) for b in fs.boundaries(i)]
              for i in range(max(fs.max_replica, 0) + 1)]
    links = [fs.link_factor(t) for t in np.linspace(0.0, 60.0, 31)]
    return out, bounds, links, fs.to_spec(), fs.max_replica, len(fs)


@pytest.mark.parametrize("kinds", [("crash", "preempt", "slowdown"),
                                   ("power_cap", "link_degrade")])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_fault_schedule_equals_reference(seed, kinds):
    def run(P):
        fs = P.schedule.random_fault_schedule(
            60.0, n_replicas=3, seed=seed, rate_per_replica_hour=900.0,
            kinds=kinds, mean_downtime_s=4.0, notice_s=1.5,
            mean_slow_s=4.0)
        again = P.schedule.FaultSchedule.from_spec(fs.to_spec())
        return _schedule_fields(fs), again == fs
    want, got = both(run)
    assert got == want
    assert want[1] and len(want[0][0]) > 0


@pytest.mark.parametrize("events", [
    None, [EVENTS["crash"], EVENTS["slowdown"] | {"t": 6.0}],
    [dict(EVENTS["preempt"], replica=1), EVENTS["link_degrade"]]])
def test_make_faults_equals_reference(events):
    def run(P):
        fs = P.schedule.make_faults(events)
        if fs is None:
            return None
        assert P.schedule.make_faults(fs) is fs
        return _schedule_fields(fs)
    want, got = both(run)
    assert got == want


def _error(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except Exception as e:      # noqa: BLE001 - the type is compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", [
    dict(t=-1.0, kind="crash"), dict(t=0.0, kind="meteor"),
    dict(t=0.0, kind="slowdown", freq_scale=0.0, duration_s=1.0),
    dict(t=0.0, kind="preempt", notice_s=-1.0)])
def test_fault_event_validation_equals_reference(case):
    want, got = both(lambda P: _error(P.schedule.FaultEvent, **case))
    assert want is not None and got == want


def test_overlapping_schedule_and_retry_validation_equal_reference():
    overlap = [EVENTS["crash"], dict(EVENTS["slowdown"], t=2.0)]
    want, got = both(lambda P: (
        _error(P.schedule.FaultSchedule, overlap),
        _error(P.faults.make_retry, "nope"),
        _error(P.faults.make_retry, "backoff", max_retries=-1),
        _error(P.faults.make_retry, "backoff", backoff_mult=0.5),
        [P.faults.make_retry("backoff").backoff(a) for a in range(8)],
        dataclasses.astuple(P.faults.make_retry("hedged"))))
    assert got == want
    assert all(e is not None for e in want[:4])


def _reqs(P, n, rate=4.0, seed=0, out=128):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(1.0 / rate, n))
    return [P.requests.Request(req_id=i, prompt=None, prompt_len=256,
                               max_new_tokens=out,
                               arrival_time=float(t[i]))
            for i in range(n)]


def _engine(P, macro, pool="mixed"):
    return P.engine.ServeEngine(
        P.llama, macro_step=macro, pool=pool,
        batch_policy=P.policy.SlotCountPolicy(max_batch=8,
                                              max_prefill_batch=4))


def _retry(P, name):
    spec = RETRIES[name]
    return None if spec is None else P.faults.make_retry(spec[0],
                                                         **spec[1])


def _single(P, kind, retry, macro):
    fs = P.schedule.FaultSchedule([EVENTS[kind]])
    eng = _engine(P, macro)
    trace = P.trace.PowerTrace()
    rp = _retry(P, retry)
    rep = eng.run(_reqs(P, 12), faults=fs, retry=rp, trace=trace)
    P.invariants.check_run_invariants(rep, engines=[eng], retry=rp,
                                      trace=trace)
    return fields(rep, trace)


@pytest.mark.parametrize("macro", [True, False])
@pytest.mark.parametrize("retry", sorted(RETRIES))
@pytest.mark.parametrize("kind", ["crash", "preempt", "slowdown",
                                  "power_cap"])
def test_single_engine_faults_equal_reference(kind, retry, macro):
    want, got = both(_single, kind, retry, macro)
    assert got == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_single_engine_chaos_equals_reference(seed):
    def run(P):
        fs = P.schedule.random_fault_schedule(
            20.0, seed=seed, rate_per_replica_hour=1200.0,
            mean_downtime_s=4.0, notice_s=1.5, mean_slow_s=4.0)
        eng = _engine(P, True)
        trace = P.trace.PowerTrace()
        rp = P.faults.RetryPolicy(backoff_s=0.2)
        rep = eng.run(_reqs(P, 16, seed=seed), faults=fs, retry=rp,
                      trace=trace)
        P.invariants.check_run_invariants(rep, engines=[eng], retry=rp,
                                          trace=trace)
        return fields(rep, trace)
    want, got = both(run)
    assert got == want


def _cluster(P, kind, retry, macro, replica):
    fs = P.schedule.FaultSchedule([dict(EVENTS[kind], replica=replica)])
    cl = P.cluster.ClusterEngine([_engine(P, macro) for _ in range(2)],
                                 P.router.make_router("least_loaded"))
    trace = P.trace.PowerTrace()
    rp = _retry(P, retry)
    rep = cl.run(_reqs(P, 14), faults=fs, retry=rp, trace=trace)
    P.invariants.check_run_invariants(rep, engines=cl.replicas, retry=rp,
                                      trace=trace)
    return fields(rep, trace)


@pytest.mark.parametrize("macro", [True, False])
@pytest.mark.parametrize("retry", ["none", "backoff", "hedged"])
@pytest.mark.parametrize("kind", ["crash", "preempt", "slowdown",
                                  "power_cap"])
def test_cluster_faults_equal_reference(kind, retry, macro):
    want, got = both(_cluster, kind, retry, macro, 0)
    assert got == want


@pytest.mark.parametrize("retry", ["none", "backoff", "hedged"])
def test_cluster_crash_without_return_equals_reference(retry):
    def run(P):
        fs = P.schedule.FaultSchedule([dict(
            t=0.8, kind="crash", replica=1, downtime_s=math.inf)])
        cl = P.cluster.ClusterEngine(
            [_engine(P, True) for _ in range(2)],
            P.router.make_router("round_robin"))
        trace = P.trace.PowerTrace()
        rp = _retry(P, retry)
        rep = cl.run(_reqs(P, 14), faults=fs, retry=rp, trace=trace)
        P.invariants.check_run_invariants(rep, engines=cl.replicas,
                                          retry=rp, trace=trace)
        return fields(rep, trace)
    want, got = both(run)
    assert got == want


@pytest.mark.parametrize("seed", [0, 1])
def test_cluster_chaos_equals_reference(seed):
    def run(P):
        fs = P.schedule.random_fault_schedule(
            18.0, n_replicas=2, seed=seed, rate_per_replica_hour=1600.0,
            mean_downtime_s=4.0, notice_s=1.5, mean_slow_s=4.0)
        cl = P.cluster.ClusterEngine([_engine(P, True) for _ in range(2)])
        trace = P.trace.PowerTrace()
        rep = cl.run(_reqs(P, 16, rate=3.0, seed=seed), faults=fs,
                     retry=P.faults.make_retry("hedged"), trace=trace)
        P.invariants.check_run_invariants(rep, engines=cl.replicas,
                                          trace=trace)
        return fields(rep, trace)
    want, got = both(run)
    assert got == want


@pytest.mark.parametrize("macro", [True, False])
def test_disaggregated_link_degrade_equals_reference(macro):
    def run(P):
        fs = P.schedule.FaultSchedule([EVENTS["link_degrade"]])
        cl = P.cluster.ClusterEngine([_engine(P, macro, pool="prefill"),
                                      _engine(P, macro, pool="decode")])
        trace = P.trace.PowerTrace()
        rep = cl.run(_reqs(P, 12, out=64), faults=fs, trace=trace)
        # the handoff joules are a fleet line item the trace does not
        # carry (in the reference too), so coverage is not checked here
        P.invariants.check_run_invariants(rep, engines=cl.replicas)
        return fields(rep, trace)
    want, got = both(run)
    assert got == want
    assert want[0][0]["n_handoffs"] == 12


def test_invariants_fail_alike_on_a_broken_report():
    def run(P):
        eng = _engine(P, True)
        rep = eng.run(_reqs(P, 6), faults=P.schedule.FaultSchedule(
            [EVENTS["crash"]]), retry=P.faults.make_retry("backoff"))
        rep.requests[0].energy_j += 1.0
        return _error(P.invariants.check_run_invariants, rep,
                      engines=[eng])
    want, got = both(run)
    assert want is not None and got == want
    assert want[0] == "InvariantViolation"
