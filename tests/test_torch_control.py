"""The port's control and fleet leaf layers (repro_torch.control,
repro_torch.fleet.{autoscale,regions}) against the JAX package's, float
for float (==): the admission bucket, the control view's aggregates and
staging, the three controllers on the same views, ControlHook driving
one engine and a cluster (macro-stepped and single-stepped), the
autoscalers and ControllerAutoscaler on the same FleetViews, and the
regions' signals and replica assignments."""
import math

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_orchestration import PKG, both, fields  # noqa: E402

CONTROLLERS = {
    "static": {}, "static_slow": {"freq_scale": 0.7},
    "static_admit": {"admission_rate": 3.0},
    "reactive": {"freq_levels": (0.5, 0.7, 1.0), "queue_high": 2},
    "mpc": {}, "mpc_tight": {"slo_p99_s": 3.0},
}


def _error(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except Exception as e:      # noqa: BLE001 - the type is compared
        # a message may name its own package
        return type(e).__name__, str(e).replace("repro_torch.", "repro.")
    return None


def test_registries_match():
    j, t = PKG["jax"], PKG["torch"]
    assert sorted(t.controllers.CONTROLLERS) == \
        sorted(j.controllers.CONTROLLERS)
    assert sorted(t.autoscale.AUTOSCALERS) == \
        sorted(j.autoscale.AUTOSCALERS)


def test_admission_bucket_equals_reference():
    def run(P):
        b = P.view.AdmissionBucket(rate_per_s=2.0, burst=3)
        out = []
        rng = np.random.default_rng(0)
        t = 0.0
        for k in range(40):
            t += float(rng.exponential(0.3))
            rel = b.release_time(t)
            b.take(rel)
            out.append((rel, b.tokens, b.t_last))
            if k == 10:
                b.set_rate(5.0, now=rel, burst=2)
            if k == 25:
                b.set_rate(None, now=rel)
            if k == 30:
                b.set_rate(1.5, now=rel)
        out.append((_error(P.view.AdmissionBucket, burst=0),
                    _error(P.view.AdmissionBucket, rate_per_s=-1.0),
                    _error(b.set_rate, 0.0, now=t)))
        return out
    want, got = both(run)
    assert got == want


def _view(P, n=2, live=4, queue=0, energy=0.05, slo=1.0, **kw):
    obs = [P.view.ReplicaObs(replica=i, freq_scale=1.0 - 0.1 * i,
                             queue_depth=queue + i,
                             tokens_in_flight=100.0 * (i + 1),
                             live=live, max_batch=8,
                             energy_wh_per_request=energy,
                             slo_attainment=slo)
           for i in range(n)]
    kw.setdefault("interval_s", 1.0)
    kw.setdefault("arrival_rate_per_s", 2.0)
    kw.setdefault("admission_rate", None)
    kw.setdefault("n_active", n)
    return P.view.ControlView(0.0, obs, **kw)


def _view_fields(v):
    freq, adm, rep = v.staged()
    return (v.queue_depth, v.tokens_in_flight, v.live, v.mean_occupancy,
            v.freq_scale, v.energy_wh_per_request, v.slo_attainment,
            # an unstaged admission target is each package's own sentinel
            freq, adm if isinstance(adm, (int, float, type(None)))
            else "unset", rep)


def test_control_view_equals_reference():
    def run(P):
        out = [_view_fields(_view(P, n=3, live=5, queue=2))]
        nan = _view(P, n=1, energy=math.nan, slo=math.nan)
        out.append((math.isnan(nan.energy_wh_per_request),
                    math.isnan(nan.slo_attainment)))
        v = _view(P, can_scale=True, min_replicas=1, max_replicas=3)
        out.append((_error(v.set_freq_scale, 0.05),
                    _error(v.set_freq_scale, 0.5, replica=9)))
        v.set_replica_target(99)
        out.append(v.replica_target)
        v.set_freq_scale(0.5)
        v.set_freq_scale(0.8, replica=1)
        v.set_admission_rate(4.0)
        out.append(_view_fields(v))
        for kw, call in (({"can_freq": False}, lambda v: v.set_freq_scale(
                0.5)), ({"can_admit": False},
                        lambda v: v.set_admission_rate(4.0)),
                ({"can_scale": False},
                 lambda v: v.set_replica_target(2))):
            out.append(_error(call, _view(P, **kw)))
        return out
    want, got = both(run)
    assert got == want


def _planner_context(P):
    cfg = P.llama
    from_backend = P.backend.AnalyticBackend(cfg)
    return P.controllers.PlannerContext(
        cfg=cfg, device=from_backend.device, policy=from_backend.policy,
        n_chips=1, max_batch=16, stack="fused", mean_prompt=1500.0,
        mean_output=100.0)


@pytest.mark.parametrize("name", sorted(CONTROLLERS))
def test_controllers_on_equal_views_equal_reference(name):
    base = name.split("_")[0]

    def run(P):
        c = P.controllers.make_controller(base, **CONTROLLERS[name])
        c.prepare(_planner_context(P))
        out = []
        for live, queue, rate in ((0, 0, 0.5), (8, 5, 6.0), (4, 1, 3.0),
                                  (8, 12, 12.0), (2, 0, 1.0)):
            v = _view(P, live=live, queue=queue, arrival_rate_per_s=rate)
            c.act(v)
            out.append(_view_fields(v))
        return out
    want, got = both(run)
    assert got == want


def test_controller_errors_equal_reference():
    want, got = both(lambda P: (
        _error(P.controllers.make_controller, "pid"),
        _error(P.controllers.make_controller, "static", freq_scale=2.0),
        _error(P.controllers.make_controller, "reactive",
               freq_levels=(0.01,)),
        _error(P.controllers.make_controller, "mpc", slo_p99_s=0.0),
        _error(P.controllers.make_controller("mpc").act, _view(P)),
        _error(P.hook.ControlHook, P.controllers.make_controller(
            "static"), 0.0),
        _error(P.hook.ControlHook, object())))
    assert got == want
    assert all(e is not None for e in want)


def _mix(P, seed, n=30, rate=6.0):
    return P.arrival.paper_requests(
        n, P.arrival.poisson_arrivals(n, rate, seed=seed), seed=seed,
        prompt_range=(150, 3000), output_range=(5, 200))


def _controlled(P, name, macro, interval):
    c = P.controllers.make_controller(name.split("_")[0],
                                      **CONTROLLERS[name])
    eng = P.engine.ServeEngine(
        P.llama, macro_step=macro,
        batch_policy=P.policy.SlotCountPolicy(max_batch=16))
    trace = P.trace.PowerTrace()
    rep = eng.run(_mix(P, 3), controller=c, control_interval_s=interval,
                  trace=trace)
    return fields(rep, trace), eng.freq_scale


@pytest.mark.parametrize("macro", [True, False])
@pytest.mark.parametrize("name", sorted(CONTROLLERS))
def test_controlled_engine_equals_reference(name, macro):
    want, got = both(_controlled, name, macro, 0.5)
    assert got == want
    if name != "static":        # the identity policy never acts
        assert want[0][0][7]["n_control_actions"] >= 1


def _controlled_cluster(P, name, policy):
    c = P.controllers.make_controller(name.split("_")[0],
                                      **CONTROLLERS[name])
    cl = P.cluster.make_cluster(P.llama, 3, policy=policy, max_batch=8)
    trace = P.trace.PowerTrace()
    rep = cl.run(_mix(P, 4, n=36, rate=10.0), controller=c,
                 control_interval_s=0.75, trace=trace)
    return fields(rep, trace), [e.freq_scale for e in cl.replicas]


@pytest.mark.parametrize("policy", ["round_robin", "energy_aware_gated"])
@pytest.mark.parametrize("name", ["static_admit", "reactive", "mpc"])
def test_controlled_cluster_equals_reference(name, policy):
    want, got = both(_controlled_cluster, name, policy)
    assert got == want


def _fleet_views(P):
    rng = np.random.default_rng(11)
    return [P.autoscale.FleetView(
        t=float(k), n_active=int(rng.integers(1, 6)), n_total=8,
        queued=int(rng.integers(0, 120)), busy=int(rng.integers(0, 5)),
        max_batch=16) for k in range(25)]


@pytest.mark.parametrize("name,params", [
    ("target_util", None), ("target_util", {"target": 0.4, "band": 0.05,
                                            "max_replicas": 5}),
    ("queue_depth", None), ("queue_depth", {"high": 10.0, "low": 2.0,
                                            "min_replicas": 2})])
def test_autoscalers_equal_reference(name, params):
    def run(P):
        a = P.autoscale.make_autoscaler(name, params)
        return [(v.utilization, a.desired(v),
                 a.clamp(a.desired(v), v.n_total))
                for v in _fleet_views(P)]
    want, got = both(run)
    assert got == want


def test_autoscaler_errors_equal_reference():
    want, got = both(lambda P: (
        _error(P.autoscale.make_autoscaler, "nope"),
        _error(P.autoscale.make_autoscaler, "target_util",
               {"min_replicas": 0}),
        _error(P.autoscale.make_autoscaler, "target_util",
               {"target": 3.0}),
        _error(P.autoscale.make_autoscaler, "queue_depth",
               {"high": 1.0, "low": 2.0})))
    assert got == want
    assert all(e is not None for e in want)


@pytest.mark.parametrize("name", ["static", "reactive", "mpc"])
def test_controller_autoscaler_equals_reference(name):
    """ControllerAutoscaler fires its hook on each FleetView, over a
    cluster's replicas as the plant."""
    def run(P):
        c = P.controllers.make_controller(
            name, **({"n_replicas": 3} if name == "static" else {}))
        hook = P.hook.ControlHook(c, 0.5)
        cl = P.cluster.make_cluster(P.llama, 4, max_batch=16)
        for e in cl.replicas:
            e.stream_start()
        hook.attach(list(enumerate(cl.replicas)), _mix(P, 5),
                    can_admit=False, can_scale=True, max_replicas=4)
        auto = P.hook.ControllerAutoscaler(hook, max_replicas=4)
        out = [auto.initial_replicas, auto.check_interval_s]
        for v in _fleet_views(P):
            out.append((auto.desired(v), hook.replica_target,
                        [e.freq_scale for e in cl.replicas]))
        return out, [{k: a[k] for k in sorted(a)} for a in hook.actions]
    want, got = both(run)
    assert got == want


REGIONS = [
    {"name": "a", "carbon": {"times": [0.0, 10.0, 20.0],
                             "values": [300.0, 500.0, 200.0]},
     "price": 0.12, "rtt_s": 0.02},
    {"name": "b", "carbon": 450.0,
     "price": {"times": [0.0, 5.0], "values": [0.05, 0.2],
               "period_s": 30.0}},
]


def test_regions_equal_reference():
    def run(P):
        R = P.regions
        regs = R.load_regions(REGIONS + [R.sinusoid_region(
            "c", phase_h=6.0, period_s=120.0, points_per_period=12)])
        ts = np.linspace(-5.0, 95.0, 41)
        out = [[(r.name, r.carbon.at(ts).tolist(), r.price.at(ts).tolist(),
                 float(r.carbon.at(7.5)),
                 np.asarray(r.carbon.integral(1.0, 61.0)).tolist(),
                 np.asarray(r.price.mean(0.0, 45.0)).tolist(),
                 r.to_dict())
                for r in regs]]
        out.append([R.assign_replicas(regs, n) for n in (3, 4, 7)])
        out.append(R.assign_replicas([], 3))
        explicit = R.load_regions([dict(REGIONS[0], replicas=1),
                                   dict(REGIONS[1], replicas=2)])
        out.append(R.assign_replicas(explicit, 3))
        out.append((_error(R.assign_replicas, explicit, 4),
                    _error(R.load_regions, [REGIONS[0], REGIONS[0]]),
                    _error(R.load_regions, [{"carbon": 1.0}]),
                    _error(R.Signal, [1.0, 0.0], [1.0, 2.0]),
                    _error(R.Signal, [0.0, 40.0], [1.0, 2.0],
                           period_s=30.0)))
        return out
    want, got = both(run)
    assert got == want
