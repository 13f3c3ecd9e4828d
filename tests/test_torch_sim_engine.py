"""The port's serving simulator (repro_torch.serving.engine.ServeEngine on
the analytic, replay and recording backends, and
repro_torch.core.profiler) against the JAX package's, float for float
(==): a grid of mode x batch policy x scheduler x arrival pattern x
macro-stepping, each report field, each request's times and energy and
each power-trace segment; the replayed fixture; the recorded trace; the
profiler; the stream primitives."""
import dataclasses
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.batching import policy as jax_policy  # noqa: E402
from repro.configs.paper_zoo import PAPER_MODELS as JAX_ZOO  # noqa: E402
from repro.core import profiler as jax_profiler  # noqa: E402
from repro.serving import arrival as jax_arrival  # noqa: E402
from repro.serving import backend as jax_backend  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro.serving import scheduler as jax_sched  # noqa: E402
from repro.serving import trace as jax_trace  # noqa: E402
from repro.serving.requests import Request as JaxRequest  # noqa: E402

from repro_torch.batching import policy as pt_policy  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import profiler as pt_profiler  # noqa: E402
from repro_torch.core.hardware import H100_SXM  # noqa: E402
from repro_torch.serving import arrival as pt_arrival  # noqa: E402
from repro_torch.serving import backend as pt_backend  # noqa: E402
from repro_torch.serving import engine as pt_engine  # noqa: E402
from repro_torch.serving import scheduler as pt_sched  # noqa: E402
from repro_torch.serving import trace as pt_trace  # noqa: E402
from repro_torch.serving.requests import Request  # noqa: E402

JCFG = JAX_ZOO["llama-3.1-8b"]
CFG = ModelConfig(**dataclasses.asdict(JCFG))
FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "replay_h100_small.json")
# both packages' modules, in the order (engine, backend, scheduler,
# policy, arrival, trace, request class, config)
PT = (pt_engine, pt_backend, pt_sched, pt_policy, pt_arrival, pt_trace,
      Request, CFG)
JAX = (jax_engine, jax_backend, jax_sched, jax_policy, jax_arrival,
       jax_trace, JaxRequest, JCFG)

PATTERNS = {
    "burst": lambda a: a.burst_arrivals(16, 6, 0.7),
    "fixed": lambda a: a.fixed_arrivals(16, 0.05),
    "uniform": lambda a: a.uniform_random_arrivals(16, 0.0, 0.3, seed=2),
    "poisson": lambda a: a.poisson_arrivals(16, 8.0, seed=4),
    "diurnal": lambda a: a.diurnal_arrivals(16, 0.5, period_s=30.0,
                                            seed=1),
}
POLICIES = {"slot_count": {}, "token_budget": {"token_budget": 4000},
            "length_sorted": {"window": 8},
            "chunked_prefill": {"chunk_tokens": 384}}
SCHEDULERS = {"passthrough": {}, "paced": {"rate_per_s": 6.0, "burst": 2},
              "window": {"window_s": 0.25},
              "deadline": {"service_rate_per_s": 5.0},
              "energy_budget": {"max_wh_per_request": 0.01}}
MODES = [("continuous", name) for name in POLICIES] \
    + [("sequential", None)]


def _requests(mods, pattern):
    arrival = mods[4]
    return arrival.paper_requests(16, PATTERNS[pattern](arrival), seed=3,
                                  prompt_range=(64, 1500),
                                  output_range=(4, 120))


def _serve(mods, mode, policy, sched, pattern, macro_step):
    engine, _, sched_mod, pol_mod, _, trace_mod, _, cfg = mods
    kw = {}
    if policy is not None:
        kw["batch_policy"] = pol_mod.make_batch_policy(
            policy, max_batch=6, max_prefill_batch=3, **POLICIES[policy])
    eng = engine.ServeEngine(cfg, mode=mode, kv_pages=256, page_size=16,
                             macro_step=macro_step, **kw)
    if sched == "energy_budget":
        scheduler = sched_mod.EnergyBudgetScheduler.for_engine(
            eng, **SCHEDULERS[sched])
    else:
        scheduler = sched_mod.make_scheduler(sched, **SCHEDULERS[sched])
    trace = trace_mod.PowerTrace()
    rep = eng.run(_requests(mods, pattern), scheduler=scheduler,
                  trace=trace)
    return rep, trace


REPORT_FIELDS = (
    "total_energy_j", "busy_energy_j", "idle_energy_j", "wall_time_s",
    "busy_time_s", "mean_batch", "n_prefill_batches", "n_decode_steps",
    "gated_energy_j", "gated_time_s", "idle_time_s",
    "transition_energy_j", "transition_time_s", "prefill_computed_tokens",
    "prefill_effective_tokens", "prefill_chunks", "n_relayed",
    "prefix_reused_tokens", "n_failures", "n_retries", "wasted_energy_j",
    "down_time_s", "n", "n_shed", "n_completed", "utilization",
    "prefill_padding_fraction", "slo_attainment", "tokens_per_s",
    "mean_energy_per_request_wh", "mean_energy_per_token_wh")


def _request_fields(r):
    return (r.req_id, r.status.name, r.arrival_time, r.release_time,
            r.t_prefill_start, r.t_first_token, r.t_done, r.energy_j,
            r.tokens_generated, r.prefilled_tokens, r.shed_reason,
            r.priority, r.deadline_s)


def _fields(rep, trace):
    return ({name: getattr(rep, name) for name in REPORT_FIELDS},
            rep.summary(), rep.latency_percentiles(),
            [_request_fields(r) for r in rep.requests],
            [_request_fields(r) for r in rep.shed], trace.as_dict())


@pytest.mark.parametrize("macro_step", [True, False],
                         ids=["macro", "single"])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("sched", sorted(SCHEDULERS))
@pytest.mark.parametrize("mode,policy", MODES,
                         ids=[p or m for m, p in MODES])
def test_engine_grid_equals_reference(mode, policy, sched, pattern,
                                      macro_step):
    """llama-3.1-8b at full width on the analytic backend, 16 of the
    paper's requests (prompts 64-1500, outputs 4-120), max_batch 6 over
    a pool of 256 pages of 16 tokens (small enough that pages clip
    decode horizons), with a power trace."""
    got = _fields(*_serve(PT, mode, policy, sched, pattern, macro_step))
    want = _fields(*_serve(JAX, mode, policy, sched, pattern, macro_step))
    assert got == want
    if macro_step:
        # the single-step twin, segment for segment; the trace's
        # total_energy_j is left out: Python's sum() compensates a list
        # of floats, not one of the macro-step's numpy floats, in both
        # packages alike
        single = _fields(*_serve(PT, mode, policy, sched, pattern, False))
        for fields in (got, single):
            del fields[5]["total_energy_j"]
        assert got == single


def test_engine_grid_covers_idle_gating_shedding_and_chunks():
    """The grid reaches what it is meant to hold: idle gaps, gated
    planned gaps, shed requests and chunked prefills."""
    seen = set()
    for sched in ("paced", "deadline", "energy_budget", "window"):
        for policy in ("slot_count", "chunked_prefill"):
            rep, _ = _serve(PT, "continuous", policy, sched, "burst", True)
            seen |= {k for k, v in (("idle", rep.idle_energy_j),
                                    ("gated", rep.gated_energy_j),
                                    ("shed", rep.n_shed),
                                    ("chunks", rep.prefill_chunks)) if v}
    assert seen == {"idle", "gated", "shed", "chunks"}


# --------------------------------------------------------------------------
# replay and recording
# --------------------------------------------------------------------------
def _engine_on(mods, backend, **kw):
    engine, _, _, pol_mod, *_, cfg = mods
    return engine.ServeEngine(cfg, backend=backend,
                              batch_policy=pol_mod.SlotCountPolicy(
                                  max_batch=8), **kw)


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("mode", ["continuous", "sequential"])
def test_replay_fixture_equals_reference(mode, pattern):
    """The recorded H100 phase trace of tests/data replayed through both
    engines: reports, requests and traces equal."""
    out = []
    for mods in (PT, JAX):
        backend = mods[1].ReplayBackend.from_json(FIXTURE)
        engine, *_, cfg = mods
        kw = ({"batch_policy": mods[3].SlotCountPolicy(max_batch=8)}
              if mode == "continuous" else {})
        trace = mods[5].PowerTrace()
        rep = engine.ServeEngine(cfg, backend=backend, mode=mode, **kw).run(
            _requests(mods, pattern), trace=trace)
        out.append(_fields(rep, trace))
    assert out[0] == out[1]


def test_replay_backend_phases_and_refusals_equal_reference():
    with open(FIXTURE) as f:
        trace = json.load(f)
    got = pt_backend.ReplayBackend(trace)
    want = jax_backend.ReplayBackend(trace)
    for n, pad in ((1, 100), (3, 700), (8, 4096), (2, 0)):
        picks = [(i, None) for i in range(n)]
        a = got.prefill(pt_backend.PrefillBatch(picks, pad))
        b = want.prefill(jax_backend.PrefillBatch(picks, pad))
        assert dataclasses.astuple(a)[:6] == dataclasses.astuple(b)
    for lens in ([10], [900, 1200, 40], [5000] * 16):
        args = (list(range(len(lens))), [None] * len(lens), lens)
        a = got.decode_step(pt_backend.DecodeBatch(*args))
        b = want.decode_step(jax_backend.DecodeBatch(*args))
        assert dataclasses.astuple(a)[:6] == dataclasses.astuple(b)
    r = Request(req_id=0, prompt=None, prompt_len=333, max_new_tokens=9)
    jr = JaxRequest(req_id=0, prompt=None, prompt_len=333, max_new_tokens=9)
    assert dataclasses.astuple(got.decode_tail(r, 40))[:6] \
        == dataclasses.astuple(want.decode_tail(jr, 40))
    for state in ("idle", "gated"):
        assert dataclasses.astuple(got.idle(2.0, state))[:6] \
            == dataclasses.astuple(want.idle(2.0, state))
    got.set_freq_scale(0.7)
    want.set_freq_scale(0.7)
    assert got.prefill_samples == want.prefill_samples
    assert got.decode_samples == want.decode_samples
    for bad in (dict(trace, schema="v0"), dict(trace, decode=[]),
                {k: v for k, v in trace.items() if k != "idle_power_w"},
                dict(trace, prefill=[{"batch": 1, "pad_len": 8}])):
        with pytest.raises(ValueError):
            jax_backend.ReplayBackend(bad)
        with pytest.raises(ValueError):
            pt_backend.ReplayBackend(bad)
    with pytest.raises(ValueError):
        got.set_freq_scale(2.0)


@pytest.mark.parametrize("mode", ["continuous", "sequential"])
def test_recording_backend_trace_equals_reference(mode, tmp_path):
    """RecordingBackend over the analytic backend: the exported replay
    trace, with and without idle gaps; its dump; and the round trip
    (record, replay) within the reference's own selfcheck bound."""
    out = []
    for mods in (PT, JAX):
        _, backend_mod, *_, cfg = mods
        rec = backend_mod.RecordingBackend(backend_mod.AnalyticBackend(cfg),
                                           cache_len_bucket=32)
        engine = mods[0]
        kw = ({"batch_policy": mods[3].SlotCountPolicy(max_batch=8)}
              if mode == "continuous" else {})
        engine.ServeEngine(cfg, backend=rec, mode=mode, **kw).run(
            _requests(mods, "fixed"))
        out.append(rec.to_trace(device="h100-sxm", model=cfg.name))
        assert rec.cfg is cfg and rec.device is rec.inner.device
    assert out[0] == out[1]
    assert pt_backend.RecordingBackend(
        pt_backend.AnalyticBackend(CFG)).to_trace() \
        == jax_backend.RecordingBackend(
            jax_backend.AnalyticBackend(JCFG)).to_trace()
    path = tmp_path / "trace.json"
    rec = pt_backend.RecordingBackend(pt_backend.AnalyticBackend(CFG))
    _engine_on(PT, rec).run(_requests(PT, "burst"))
    assert rec.dump(str(path)) == json.loads(path.read_text()) \
        == rec.to_trace()
    replayed = _engine_on(PT, pt_backend.ReplayBackend.from_json(
        str(path))).run(_requests(PT, "burst"))
    analytic = _engine_on(PT, None).run(_requests(PT, "burst"))
    assert 0.9 < replayed.total_energy_j / analytic.total_energy_j < 1.1


def test_make_backend_equals_reference():
    assert pt_backend.BACKENDS == jax_backend.BACKENDS
    assert pt_backend.REPLAY_SCHEMA == jax_backend.REPLAY_SCHEMA
    assert isinstance(pt_backend.make_backend("analytic", CFG, fmt="int8"),
                      pt_backend.AnalyticBackend)
    rep = pt_backend.make_backend("replay", CFG, replay_path=FIXTURE)
    assert isinstance(rep, pt_backend.ReplayBackend)
    with pytest.raises(ValueError):
        pt_backend.make_backend("simulated", CFG)


def test_selfcheck_passes_on_the_cpu(capsys):
    assert pt_backend.selfcheck(device="cpu") == 0
    assert "all backends conform" in capsys.readouterr().out


# --------------------------------------------------------------------------
# the profiler
# --------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["bfloat16", "int8", "nf4"])
@pytest.mark.parametrize("stack", ["eager", "fused"])
def test_phase_profiler_equals_reference(fmt, stack):
    from repro.core.precision import make_policy as jax_make_policy
    from repro_torch.core.precision import make_policy
    got = pt_profiler.PhaseProfiler(CFG, policy=make_policy(fmt),
                                    stack=stack, n_chips=2)
    want = jax_profiler.PhaseProfiler(JCFG, policy=jax_make_policy(fmt),
                                      stack=stack, n_chips=2)

    def same(a, b):
        assert dataclasses.astuple(a) == dataclasses.astuple(b)

    same(got.profile_prefill(4, 512), want.profile_prefill(4, 512))
    same(got.profile_decode(4, 512, 64), want.profile_decode(4, 512, 64))
    same(got.profile_decode_step(8, 1000),
         want.profile_decode_step(8, 1000))
    same(got.profile_train_step(2, 1024), want.profile_train_step(2, 1024))
    g, w = got.profile_generate(3, 700, 50), want.profile_generate(3, 700,
                                                                   50)
    for phase in ("prefill", "decode", "generate"):
        same(getattr(g, phase), getattr(w, phase))
        assert g.energy_per_output_token_j(phase) \
            == w.energy_per_output_token_j(phase)
        assert g.energy_per_input_token_j(phase) \
            == w.energy_per_input_token_j(phase)
    assert g.energy_per_request_wh() == w.energy_per_request_wh()
    assert g.energy_per_input_token_j(effective_tokens=1000) \
        == w.energy_per_input_token_j(effective_tokens=1000)
    replay = pt_backend.ReplayBackend.from_json(FIXTURE)
    assert pt_profiler.PhaseProfiler(CFG, backend=replay).model is None
    with pt_profiler.WallClock() as clock:
        pass
    assert clock.elapsed >= 0.0


# --------------------------------------------------------------------------
# the stream primitives and helpers
# --------------------------------------------------------------------------
def _stream_run(mods):
    """A stream stepped by hand: submissions, steps, a cancel of a queued
    and of a live request, a dead period, a crash, more steps, then the
    report."""
    engine, *_, cfg = mods
    eng = engine.ServeEngine(cfg, batch_policy=mods[3].SlotCountPolicy(
        max_batch=4, max_prefill_batch=2))
    reqs = _requests(mods, "burst")
    eng.stream_start()
    for r in reqs[:10]:
        eng.stream_submit(r)
    log = [(eng.stream_load, eng.stream_outstanding_work())]
    for _ in range(3):
        log.append(eng.stream_step())
    log.append(eng.stream_cancel(reqs[9]))          # queued
    live = next(r for r in reqs if r.status.name == "RUNNING")
    log.append(eng.stream_cancel(live))
    log.append(eng.stream_cancel(reqs[9]))          # already gone
    eng.stream_down(eng.stream_now + 0.5)
    failed = eng.stream_crash()
    log.append(sorted(r.req_id for r in failed))
    for r in reqs[10:]:
        eng.stream_submit(r)
    while eng.stream_can_step():
        log.append(eng.stream_step())
    log.append((eng.stream_stuck(), eng.stream_now))
    rep = eng.stream_report()
    return log, _fields(rep, mods[5].PowerTrace()), [
        (r.req_id, r.status.name, r.fail_reason, r.wasted_energy_j)
        for r in reqs]


def test_stream_primitives_equal_reference():
    got, want = _stream_run(PT), _stream_run(JAX)
    assert got == want
    assert got[1][0]["n_failures"] > 0 and got[1][0]["down_time_s"] == 0.5


def test_fold_and_pending_helpers_equal_reference():
    rng = np.random.default_rng(0)
    for k in (0, 5, 63, 64, 300):
        vals = rng.random(k) * 1e-3
        assert pt_engine._fold(0.1, vals) == jax_engine._fold(0.1, vals)
        inits = rng.random(5)
        np.testing.assert_array_equal(pt_engine._fold_many(inits, vals),
                                      jax_engine._fold_many(inits, vals))
    for mods in (PT, JAX):
        engine, req_cls = mods[0], mods[6]
        pending = [req_cls(req_id=i, prompt=None, prompt_len=8,
                           max_new_tokens=1, arrival_time=t)
                   for i, t in enumerate((0.0, 0.5, 0.5, 1.0))]
        late = req_cls(req_id=9, prompt=None, prompt_len=8,
                       max_new_tokens=1, arrival_time=0.5)
        engine._insert_pending(pending, 1, late)
        assert [r.req_id for r in pending] == [0, 1, 2, 9, 3]
        assert engine._remove_identity(pending, late)
        assert not engine._remove_identity(pending, late)


# --------------------------------------------------------------------------
# what the engine refuses
# --------------------------------------------------------------------------
def test_engine_refuses_the_paths_of_a4b_and_contradictions():
    eng = pt_engine.ServeEngine(CFG)
    for kw in ({"source": object()}, {"controller": object()},
               {"faults": object()}, {"retry": object()}):
        with pytest.raises(ValueError, match="A4\\(b\\)"):
            eng.run([], **kw)
    for pool in ("prefill", "decode"):
        with pytest.raises(ValueError, match="A4\\(b\\)"):
            pt_engine.ServeEngine(CFG, pool=pool)
    with pytest.raises(ValueError):
        pt_engine.ServeEngine(CFG, mode="static")
    with pytest.raises(ValueError):
        pt_engine.ServeEngine(CFG, mode="sequential",
                              batch_policy=pt_policy.TokenBudgetPolicy(
                                  token_budget=100))
    analytic = pt_backend.AnalyticBackend(CFG, fmt="int8")
    with pytest.raises(ValueError, match="conflicts"):
        pt_engine.ServeEngine(CFG, backend=analytic, fmt="nf4")
    with pytest.raises(ValueError, match="conflicts"):
        pt_engine.ServeEngine(CFG, backend=analytic,
                              device=H100_SXM.with_freq_scale(0.5))
    with pytest.raises(ValueError, match="execute"):
        pt_engine.ServeEngine(CFG, backend=analytic, execute=True)
    assert pt_engine.ServeEngine(CFG, backend=analytic).policy.fmt == "int8"
    empty = pt_engine.ServeEngine(CFG).run([])
    assert empty.total_energy_j == 0.0 and empty.n == 0
    with pytest.raises(RuntimeError, match="deadlock"):
        pt_engine.ServeEngine(CFG, kv_pages=2, page_size=16).run(
            _requests(PT, "burst"))
