"""The port's vectorized fleet engine (repro_torch.fleet.engine): twins of
tests/test_fleet.py's engine tests, with the port's FleetEngine held
against the port's ClusterEngine field for field (per-replica trace
segments included), and against the reference's FleetEngine (==) on the
same runs, the autoscaler, region and geo-routing runs, the controller
and fault paths, and the spec's fleet axes; then an executed two-replica
``fleet="vector"`` spec on reduced llama-3.1-8b in float32 on the CPU,
its record equal to the reference's and its tokens identical on the
reference's carried weights. (The Signal, region and diurnal-arrival
leaves are held by test_torch_control.py, test_torch_arrival.py and
test_torch_cluster.py.)"""
import json
import math

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

from repro.models import build_model as jax_build_model  # noqa: E402

from _torch_orchestration import PKG, both, fields  # noqa: E402
from _torch_parity import carry_params  # noqa: E402

T = PKG["torch"]
POLICIES = ["round_robin", "least_loaded", "shortest_work", "energy_aware",
            "round_robin_gated"]


def _reqs(P, n, seed=0, rate=10.0, arrivals=None):
    arr = arrivals if arrivals is not None \
        else P.arrival.poisson_arrivals(n, rate, seed=seed)
    return P.arrival.paper_requests(n, arr, seed=seed)


def _fields(rep):
    """test_fleet.py's parity fields: every scalar, per-request and
    per-replica field the fleet and the serial loop share."""
    return {
        "total": rep.total_energy_j, "busy": rep.busy_energy_j,
        "idle": rep.idle_energy_j, "gated": rep.gated_energy_j,
        "wall": rep.wall_time_s, "n": rep.n, "shed": rep.n_shed,
        "per_replica_n": rep.requests_per_replica,
        "replica_scalars": [(r.total_energy_j, r.busy_energy_j,
                             r.idle_energy_j, r.gated_energy_j,
                             r.wall_time_s, r.busy_time_s, r.mean_batch)
                            for r in rep.replica_reports],
        "requests": sorted((r.req_id, r.t_prefill_start, r.t_first_token,
                            r.t_done, r.energy_j, r.tokens_generated)
                           for rep_ in rep.replica_reports
                           for r in rep_.requests),
    }


def _segs(trace):
    # each replica's own timeline; the two loops interleave replicas in
    # different global orders
    return sorted((s.replica, s.t0, s.t1, s.state, s.energy_j, s.batch)
                  for s in trace.segments)


def _fleet_fields(rep):
    """Every compared field of a FleetReport: the cluster's, the
    transition ledger and the region layer's."""
    return (fields(rep), rep.transition_energy_j, rep.transition_time_s,
            rep.n_transitions, rep.region_names, rep.region_of,
            rep.rtt_s_of, rep.gco2_total_g, rep.usd_total,
            rep.egress_usd_total, rep.gco2_per_request_g,
            rep.usd_per_request, rep.client_latency_percentiles(),
            rep.client_ttft_percentiles(), rep.summary())


def _fleet_run(P, n_rep, policy, max_batch, reqs, **kw):
    trace = P.trace.PowerTrace()
    rep = P.fleet_engine.make_fleet(P.llama, n_rep, policy=policy,
                                    max_batch=max_batch, **kw).run(
        reqs, trace=trace)
    return _fleet_fields(rep), trace.as_dict()


class TestFleetParity:
    @pytest.mark.parametrize("policy", POLICIES)
    @pytest.mark.parametrize("n_rep", [1, 3])
    def test_report_and_trace_parity(self, policy, n_rep):
        tr_a, tr_b = T.trace.PowerTrace(), T.trace.PowerTrace()
        cl = T.cluster.make_cluster(T.llama, n_rep, policy=policy,
                                    max_batch=8)
        fl = T.fleet_engine.make_fleet(T.llama, n_rep, policy=policy,
                                       max_batch=8)
        ra = cl.run(_reqs(T, 60, seed=11, rate=12.0), trace=tr_a)
        rb = fl.run(_reqs(T, 60, seed=11, rate=12.0), trace=tr_b)
        assert _fields(ra) == _fields(rb)
        assert _segs(tr_a) == _segs(tr_b)

    @pytest.mark.parametrize("policy", POLICIES)
    @pytest.mark.parametrize("n_rep", [1, 3])
    def test_fleet_equals_reference(self, policy, n_rep):
        want, got = both(lambda P: _fleet_run(
            P, n_rep, policy, 8, _reqs(P, 60, seed=11, rate=12.0)))
        assert got == want

    def test_parity_on_bursts(self):
        def run(P, make):
            arr = P.arrival.burst_arrivals(48, 12, 2.0)
            return make(P.llama, 4, policy="least_loaded",
                        max_batch=6).run(_reqs(P, 48, seed=3, arrivals=arr))
        ra = run(T, T.cluster.make_cluster)
        rb = run(T, T.fleet_engine.make_fleet)
        assert _fields(ra) == _fields(rb)
        want, got = both(lambda P: _fleet_fields(
            run(P, P.fleet_engine.make_fleet)))
        assert got == want

    def test_api_vector_result_identical(self):
        base = dict(model="llama-3.1-8b", pipeline="serve",
                    mode="continuous", n_requests=80, replicas=3,
                    router="least_loaded", arrival="poisson",
                    arrival_params={"rate_per_s": 10.0}, seed=5)
        d1 = T.api.ExperimentSpec(**base).run().to_dict()
        res = T.api.ExperimentSpec(fleet="vector", **base).run()
        assert type(res.report).__name__ == "FleetReport"
        d2 = res.to_dict()
        d1.pop("spec_hash"), d2.pop("spec_hash")
        assert d1 == d2

    def test_rejects_sequential_replicas(self):
        eng = T.cluster.make_cluster(T.llama, 1,
                                     policy="round_robin").replicas[0]
        eng.mode = "sequential"
        with pytest.raises(ValueError, match="continuous"):
            T.fleet_engine.FleetEngine([eng])

    def test_refusals_equal_reference(self):
        def run(P):
            out = []
            eng = P.cluster.make_cluster(P.llama, 2, policy="round_robin")
            for kw in (dict(replicas=[]), dict(router=None)):
                try:
                    P.fleet_engine.FleetEngine(**{"replicas": eng.replicas,
                                                  **kw})
                    out.append(None)
                except ValueError as e:
                    out.append(str(e))
            pooled = P.engine.ServeEngine(P.llama, pool="prefill")
            for make in (
                    lambda: P.fleet_engine.FleetEngine([pooled]),
                    lambda: P.fleet_engine.FleetEngine(
                        eng.replicas, P.router.make_router("carbon_aware")),
                    lambda: P.fleet_engine.make_fleet(
                        P.llama, 2, batch_policy=P.policy.SlotCountPolicy()),
                    lambda: P.fleet_engine.make_fleet(P.llama, 1).run(
                        [], source=object()),
                    lambda: P.fleet_engine.make_fleet(
                        P.llama, 2, autoscaler=P.autoscale.make_autoscaler(
                            "queue_depth", {})).run(
                        [], faults=P.faults.make_faults(
                            [{"t": 0.1, "kind": "crash"}]))):
                try:
                    make()
                    out.append(None)
                except ValueError as e:
                    out.append(str(e))
            return out
        want, got = both(run)
        assert got == want
        assert all(e is not None for e in want[2:])


class TestAutoscaler:
    def _autoscaled(self, P, trace=None):
        auto = P.autoscale.TargetUtilizationAutoscaler(check_interval_s=5.0,
                                                       min_replicas=1)
        fl = P.fleet_engine.make_fleet(P.llama, 6, policy="least_loaded",
                                       max_batch=4, autoscaler=auto)
        reqs = _reqs(P, 160, seed=7, arrivals=P.arrival.diurnal_arrivals(
            160, 30.0, period_s=120.0, amp_frac=0.9, seed=7))
        return fl.run(reqs, trace=trace)

    def test_scales_and_conserves_energy(self):
        tr = T.trace.PowerTrace()
        rep = self._autoscaled(T, trace=tr)
        assert rep.n_transitions > 0
        assert rep.transition_energy_j > 0
        assert tr.total_energy_j == pytest.approx(rep.total_energy_j,
                                                  rel=1e-9)
        by_state = tr.energy_by_state()
        trans = by_state.get("spinup", 0.0) + by_state.get("drain", 0.0)
        assert trans == pytest.approx(rep.transition_energy_j, rel=1e-9)
        parts = (rep.busy_energy_j + rep.idle_energy_j
                 + rep.gated_energy_j + rep.transition_energy_j)
        assert parts == pytest.approx(rep.total_energy_j, rel=1e-9)
        assert rep.n == 160
        assert all(r.t_done >= r.arrival_time for r in rep.requests)

    def test_autoscaled_run_equals_reference(self):
        def run(P):
            tr = P.trace.PowerTrace()
            return _fleet_fields(self._autoscaled(P, trace=tr)), \
                tr.as_dict()
        want, got = both(run)
        assert got == want

    def test_zero_request_replicas_no_nan(self):
        def run(P):
            auto = P.autoscale.TargetUtilizationAutoscaler(
                check_interval_s=5.0)
            fl = P.fleet_engine.make_fleet(P.llama, 6, policy="least_loaded",
                                           autoscaler=auto)
            return fl.run(_reqs(P, 30, seed=1, rate=4.0))
        rep = run(T)
        assert 0 in rep.requests_per_replica
        for row in rep.per_replica_summary():
            for v in row.values():
                assert not (isinstance(v, float) and math.isnan(v))
        for d in (rep.latency_percentiles_per_replica()
                  + rep.ttft_percentiles_per_replica()):
            assert all(not math.isnan(v) for v in d.values())
        assert all(not (isinstance(v, float) and math.isnan(v))
                   for v in rep.summary().values())
        want, got = both(lambda P: _fleet_fields(run(P)))
        assert got == want

    @pytest.mark.parametrize("name", ["static", "reactive", "mpc"])
    def test_controlled_fleet_equals_reference(self, name):
        def run(P):
            c = P.controllers.make_controller(
                name, **({"n_replicas": 2} if name == "static" else {}))
            fl = P.fleet_engine.make_fleet(P.llama, 3, policy="least_loaded",
                                           max_batch=8)
            tr = P.trace.PowerTrace()
            rep = fl.run(_reqs(P, 40, seed=2, rate=15.0), trace=tr,
                         controller=c, control_interval_s=0.5)
            return _fleet_fields(rep), tr.as_dict()
        want, got = both(run)
        assert got == want

    def test_fault_path_equals_reference(self):
        def run(P):
            fl = P.fleet_engine.make_fleet(P.llama, 2, policy="least_loaded",
                                           max_batch=8)
            tr = P.trace.PowerTrace()
            rep = fl.run(_reqs(P, 30, seed=3, rate=10.0), trace=tr,
                         faults=P.faults.make_faults(
                             [{"t": 1.0, "kind": "crash", "replica": 1,
                               "downtime_s": 2.0}]),
                         retry=P.faults.make_retry("backoff"))
            return _fleet_fields(rep), tr.as_dict()
        want, got = both(run)
        assert got == want


class TestRegions:
    def test_geo_accounting_closes(self):
        regs = [{"name": "flat", "carbon": 500.0, "price": 0.20}]
        fl = T.fleet_engine.make_fleet(T.llama, 2, policy="carbon_aware",
                                       max_batch=8, regions=regs)
        rep = fl.run(_reqs(T, 40, seed=2, rate=10.0))
        expect_g = rep.total_energy_j * 500.0 / 3.6e6
        expect_usd = rep.total_energy_j * 0.20 / 3.6e6
        assert rep.gco2_total_g == pytest.approx(expect_g, rel=1e-6)
        assert rep.usd_total == pytest.approx(expect_usd, rel=1e-6)
        assert rep.gco2_per_request_g == pytest.approx(expect_g / 40,
                                                       rel=1e-6)

    def test_carbon_router_prefers_low_carbon_region(self):
        regs = [{"name": "dirty", "carbon": 600.0, "replicas": 2},
                {"name": "clean", "carbon": 100.0, "replicas": 2}]
        want, got = both(lambda P: _fleet_run(
            P, 4, "carbon_aware", 8, _reqs(P, 30, seed=4, rate=2.0),
            regions=regs))
        assert got == want
        per = got[0][0][0][0]["requests_per_replica"]
        assert sum(per[2:]) > sum(per[:2])

    @pytest.mark.parametrize("policy", ["carbon_aware", "price_aware",
                                        "carbon_aware_gated"])
    def test_geo_routing_equals_reference(self, policy):
        def run(P):
            regs = [P.regions.sinusoid_region("us", replicas=2,
                                              period_s=60.0,
                                              egress_usd_per_gb=0.09),
                    P.regions.sinusoid_region("eu", phase_h=60.0 / 7200,
                                              period_s=60.0, replicas=1,
                                              rtt_s=0.08)]
            arr = P.arrival.diurnal_arrivals(50, 6.0, period_s=60.0, seed=5)
            return _fleet_run(P, 3, policy, 8, _reqs(P, 50, seed=5,
                                                     arrivals=arr),
                              regions=regs)
        want, got = both(run)
        assert got == want
        assert got[0][7] is not None        # gco2_total_g

    def test_rtt_shifts_client_latency(self):
        regs = [{"name": "far", "rtt_s": 0.5}]
        fl = T.fleet_engine.make_fleet(T.llama, 2, policy="carbon_aware",
                                       max_batch=8, regions=regs)
        rep = fl.run(_reqs(T, 20, seed=6, rate=5.0))
        lat = rep.latency_percentiles()["p50"]
        client = rep.client_latency_percentiles()["p50"]
        assert client == pytest.approx(lat + 0.5)


class TestFleetSpec:
    BASE = dict(model="llama-3.1-8b", pipeline="serve", mode="continuous",
                n_requests=10, replicas=2)

    def test_defaults_keep_serialization(self):
        d = json.loads(T.api.ExperimentSpec(**self.BASE).to_json())
        for k in ("fleet", "autoscaler", "autoscaler_params", "regions"):
            assert k not in d

    def test_fleet_spec_round_trips(self):
        def spec(P):
            return P.api.ExperimentSpec(**dict(
                self.BASE, n_requests=40, replicas=4,
                router="carbon_aware",
                regions=[P.regions.sinusoid_region("us", replicas=2),
                         P.regions.sinusoid_region("eu", phase_h=9.0,
                                                   replicas=2)],
                autoscaler="queue_depth",
                autoscaler_params={"high": 16.0}, arrival="diurnal",
                arrival_params={"base_rate_per_s": 5.0}))
        s = spec(T)
        s2 = T.api.ExperimentSpec.from_json(s.to_json())
        assert s2.spec_hash() == s.spec_hash()
        ref = spec(PKG["jax"])
        assert ref.to_json() == s.to_json()
        assert s.run().to_json() == ref.run().to_json()

    @pytest.mark.parametrize("kw,msg", [
        (dict(router="carbon_aware"), "region"),
        (dict(fleet="legacy", autoscaler="target_util"), "legacy"),
        (dict(autoscaler_params={"high": 3.0}), "autoscaler"),
        (dict(fleet="wat"), "fleet"),
        (dict(mode="sequential", fleet="vector"), "continuous"),
        (dict(autoscaler="nope"), "unknown autoscaler"),
    ])
    def test_validation(self, kw, msg):
        with pytest.raises(ValueError, match=msg):
            T.api.ExperimentSpec(**dict(self.BASE, **kw))

    def test_geo_run_populates_fleet_fields(self):
        def run(P):
            return P.api.ExperimentSpec(**dict(
                self.BASE, n_requests=60, router="price_aware",
                regions=[P.regions.sinusoid_region("us", replicas=1),
                         P.regions.sinusoid_region("eu", phase_h=12.0,
                                                   replicas=1)],
                arrival="poisson", arrival_params={"rate_per_s": 8.0},
                seed=9)).run().to_dict()
        want, got = both(run)
        assert got == want
        for k in ("gco2_total_g", "gco2_per_request_g", "usd_total",
                  "usd_per_request", "client_latency_p99_s"):
            assert k in got and got[k] is not None


# ---------------------------------------------------------------------------
# executed replicas behind the vectorized fleet
# ---------------------------------------------------------------------------
EXEC_FLEET = dict(model="llama-3.1-8b", reduced=True, backend="executed",
                  fmt="float32", fleet="vector", replicas=2,
                  router="round_robin", n_requests=8, max_batch=4,
                  max_prefill_batch=2, prompt_range=(6, 40),
                  output_range=(2, 10), buf_len=64, arrival="poisson",
                  arrival_params={"rate_per_s": 40.0}, seed=2)


def _tokens(res):
    return sorted((r.req_id, list(r.generated))
                  for rep in res.report.replica_reports
                  for r in rep.requests)


def test_executed_vector_fleet_equals_reference(tmp_path, monkeypatch):
    cfg = PKG["jax"].llama.reduced()
    params = jax_build_model(cfg, fmt="float32").init(jax.random.PRNGKey(0))
    carried = carry_params(params, tmp_path)
    ref = PKG["jax"].api.ExperimentSpec(**EXEC_FLEET).run()
    spec = T.api.ExperimentSpec(**EXEC_FLEET)
    monkeypatch.setattr(T.api, "executed_params", lambda model: carried)
    got = spec.run(torch_device="cpu")
    assert type(got.report).__name__ == "FleetReport"
    assert got.to_json() == ref.to_json()
    assert _tokens(got) == _tokens(ref)
    assert all(len(r.generated) == r.max_new_tokens
               for rep in got.report.replica_reports for r in rep.requests)
    assert all(n > 0 for n in got.requests_per_replica)
    twin = spec.derive(backend="analytic").run().to_dict()
    mine = got.to_dict()
    mine.pop("spec_hash"), twin.pop("spec_hash")
    assert mine == twin
