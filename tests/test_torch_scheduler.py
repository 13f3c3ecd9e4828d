"""The port's schedulers and power traces (repro_torch.serving.scheduler,
repro_torch.serving.trace) against the JAX package's: on the same seeded
arrival streams every scheduler releases the same requests at the same
times (==) and sheds the same ones for the same reasons; the horizon
stops cut the same step counts; the same accruals give the same
segments."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs.paper_zoo import PAPER_MODELS as JAX_ZOO  # noqa: E402
from repro.serving import arrival as jax_arrival  # noqa: E402
from repro.serving import scheduler as jax_sched  # noqa: E402
from repro.serving import slo as jax_slo  # noqa: E402
from repro.serving import trace as jax_trace  # noqa: E402
from repro.serving.requests import Request as JaxRequest  # noqa: E402

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.serving import scheduler as pt_sched  # noqa: E402
from repro_torch.serving import slo as pt_slo  # noqa: E402
from repro_torch.serving import trace as pt_trace  # noqa: E402
from repro_torch.serving.requests import Request  # noqa: E402

JCFG = JAX_ZOO["llama-3.1-8b"]
CFG = ModelConfig(**dataclasses.asdict(JCFG))

ARRIVALS = {
    "burst": lambda: jax_arrival.burst_arrivals(40, 10, 0.8),
    "fixed": lambda: jax_arrival.fixed_arrivals(40, 0.05),
    "uniform": lambda: jax_arrival.uniform_random_arrivals(40, 0.0, 0.2,
                                                           seed=3),
    "poisson": lambda: jax_arrival.poisson_arrivals(40, 15.0, seed=1),
    "diurnal": lambda: jax_arrival.diurnal_arrivals(40, 0.02, seed=2),
}

# (registry name, kwargs); the energy-budget caps bracket the marginal
# Wh of a burst member and of a straggler
SCHEDULERS = [
    ("passthrough", {}),
    ("paced", {"rate_per_s": 25.0, "burst": 3}),
    ("paced", {"rate_per_s": 4.0}),
    ("window", {"window_s": 0.3}),
    ("deadline", {"service_rate_per_s": 50.0}),
    ("deadline", {"service_rate_per_s": 2.0, "est_latency_s": 3.0}),
    ("energy_budget", {"max_wh_per_request": 6e-3}),
    ("energy_budget", {"max_wh_per_request": 2e-2, "coalesce_s": 0.2}),
]


def _reqs(cls, arrivals, tiers=True):
    rng = np.random.default_rng(5)
    reqs = [cls(req_id=i, prompt=None,
                prompt_len=int(rng.integers(64, 2000)),
                max_new_tokens=int(rng.integers(4, 200)), arrival_time=t)
            for i, t in enumerate(arrivals)]
    if tiers:
        (pt_slo if cls is Request else jax_slo).assign_slos(reqs, seed=7)
    return reqs


def _make(mod, cfg, name, kw):
    if name == "energy_budget":
        kw = dict(kw, cfg=cfg)
    return mod.make_scheduler(name, **kw)


def _outcome(res, requests):
    return ([(r.req_id, r.release_time) for r in res.released],
            [(r.req_id, r.shed_reason, r.status.name, r.release_time)
             for r in res.shed],
            res.n_released, res.n_shed, res.shed_fraction,
            sorted((r.req_id, r.priority, r.deadline_s) for r in requests))


@pytest.mark.parametrize("pattern", sorted(ARRIVALS))
@pytest.mark.parametrize("name,kw", SCHEDULERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SCHEDULERS)])
def test_schedules_equal_reference(name, kw, pattern):
    arrivals = ARRIVALS[pattern]()
    got_reqs, want_reqs = _reqs(Request, arrivals), _reqs(JaxRequest,
                                                          arrivals)
    got = _make(pt_sched, CFG, name, kw).schedule(got_reqs)
    want = _make(jax_sched, JCFG, name, kw).schedule(want_reqs)
    assert _outcome(got, got_reqs) == _outcome(want, want_reqs)
    assert (pt_sched.SCHEDULERS[name].plans_gaps
            == jax_sched.SCHEDULERS[name].plans_gaps)
    order = [(r.req_id, r.effective_arrival) for r in
             pt_sched.apply_schedule(_reqs(Request, arrivals),
                                     _make(pt_sched, CFG, name, kw))[0]]
    assert order == [(r.req_id, r.effective_arrival) for r in
                     jax_sched.apply_schedule(
                         _reqs(JaxRequest, arrivals),
                         _make(jax_sched, JCFG, name, kw))[0]]


def test_energy_budget_predictions_equal_reference():
    got = pt_sched.EnergyBudgetScheduler(1e-3, CFG, max_batch=8)
    want = jax_sched.EnergyBudgetScheduler(1e-3, JCFG, max_batch=8)
    for inflight, group in ((0, 1), (3, 4), (7, 2), (12, 1)):
        r = Request(req_id=0, prompt=None, prompt_len=900,
                    max_new_tokens=77)
        jr = JaxRequest(req_id=0, prompt=None, prompt_len=900,
                        max_new_tokens=77)
        assert got.predicted_marginal_wh(r, inflight, group) \
            == want.predicted_marginal_wh(jr, inflight, group)


def test_refusals_and_registry_match_reference():
    assert list(pt_sched.SCHEDULERS) == list(jax_sched.SCHEDULERS)
    for name, kw in (("nope", {}), ("paced", {"rate_per_s": 0.0}),
                     ("paced", {"rate_per_s": 1.0, "burst": 0}),
                     ("window", {"window_s": 0.0}),
                     ("deadline", {"service_rate_per_s": -1.0})):
        with pytest.raises(ValueError):
            jax_sched.make_scheduler(name, **kw)
        with pytest.raises(ValueError):
            pt_sched.make_scheduler(name, **kw)
    with pytest.raises(ValueError):
        pt_sched.EnergyBudgetScheduler(0.0, CFG)
    with pytest.raises(ValueError):
        pt_sched.HorizonStop(1.0, mode="later")


@pytest.mark.parametrize("mode", ["admit", "clock", "control"])
@pytest.mark.parametrize("t_stop", [0.0, 0.25, 0.3, 0.3 + 1e-13, 9.0])
def test_horizon_stop_equals_reference(mode, t_stop):
    ends = np.add.accumulate(np.full(40, 0.05))
    got = pt_sched.HorizonStop(t_stop, mode=mode)
    want = jax_sched.HorizonStop(t_stop, mode=mode)
    assert got.n_steps(ends) == want.n_steps(ends)
    assert [got.hit(t) for t in ends] == [want.hit(t) for t in ends]
    other = pt_sched.HorizonStop(0.27, mode="clock")
    assert got.merged(other).t_stop == want.merged(
        jax_sched.HorizonStop(0.27, mode="clock")).t_stop
    assert got.merged(None) is got


def _fill(mod):
    """The same accruals on both packages' traces: contiguous merges,
    gaps, zero-length and DVFS segments, a coalesced run, action markers
    and the fault and transition states."""
    tr = mod.PowerTrace()
    tr.record(0, "prefill", 0.0, 0.1, 50.0, 4.0)
    tr.record(0, "decode", 0.1, 0.15, 10.0, 4.0)
    tr.record(0, "decode", 0.15, 0.2, 9.0, 3.0)
    tr.record_run(0, "decode", 0.2, [0.01, 0.0, 0.02, 0.015],
                  [1.0, 0.5, 2.0, 1.5], 2.0)
    tr.record_action(0, 0.245, freq_scale=0.8)
    tr.record(0, "decode", 0.245, 0.3, 3.0, 2.0, freq_scale=0.8)
    tr.record(0, "idle", 0.3, 1.0, 70.0)
    tr.record(0, "gated", 1.0, 2.0, 45.0)
    tr.record(1, "spinup", 0.0, 0.5, 20.0)
    tr.record(1, "down", 0.5, 0.9, 0.0)
    tr.record(1, "prefill", 0.9, 0.9, 0.0, 1.0)
    tr.record(1, "drain", 0.95, 1.2, 5.0)
    return tr


def test_power_trace_equals_reference():
    got, want = _fill(pt_trace), _fill(jax_trace)
    assert got.as_dict() == want.as_dict()
    assert got.to_json() == want.to_json()
    assert got.time_by_state(replica=1) == want.time_by_state(replica=1)
    for e in (0.0, 1.0, got.total_energy_j):
        assert got.coverage(e) == want.coverage(e)
    assert pt_trace.STATES == jax_trace.STATES
    with pytest.raises(ValueError):
        got.record(0, "busy", 0.0, 1.0, 1.0)
    with pytest.raises(ValueError):
        got.record(0, "idle", 1.0, 0.5, 1.0)
