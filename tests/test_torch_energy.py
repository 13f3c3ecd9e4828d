"""The port's analytic clock and energy (repro_torch.core.{hardware,
energy,workload}, repro_torch.serving.{slo,backend,engine}) against the
JAX package's, float for float: both sides are numpy, so every field is
compared with ==. The slice end to end: the port's ServeEngine against
the reference ServeEngine(execute=True) on the same weights and
requests, in continuous and sequential modes."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.batching.policy import SlotCountPolicy  # noqa: E402
from repro.configs.base import ARCH_IDS, get_config  # noqa: E402
from repro.configs.paper_zoo import PAPER_MODELS as JAX_ZOO  # noqa: E402
from repro.core import energy as jax_energy  # noqa: E402
from repro.core import hardware as jax_hw  # noqa: E402
from repro.core import workload as jax_wl  # noqa: E402
from repro.core.precision import make_policy as jax_policy  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serving import backend as jax_backend  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro.serving import slo as jax_slo  # noqa: E402
from repro.serving.scheduler import HorizonStop  # noqa: E402

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.paper_zoo import PAPER_MODELS  # noqa: E402
from repro_torch.core import energy as pt_energy  # noqa: E402
from repro_torch.core import hardware as pt_hw  # noqa: E402
from repro_torch.core import workload as pt_wl  # noqa: E402
from repro_torch.core.precision import ALL_FORMATS, make_policy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import Request, RequestStatus, ServeEngine  # noqa: E402,E501
from repro_torch.serving import backend as pt_backend  # noqa: E402
from repro_torch.serving import engine as pt_engine  # noqa: E402
from repro_torch.serving import slo as pt_slo  # noqa: E402

from _torch_parity import carry_params  # noqa: E402

REF_CONFIGS = {a: get_config(a) for a in ARCH_IDS}
REF_CONFIGS.update(JAX_ZOO)
MODEL_CLASSES = ["EnergyModel", "FusedDequantEnergyModel"]


def _port_cfg(ref_cfg) -> ModelConfig:
    """The port's ModelConfig with the reference config's fields."""
    return ModelConfig(**dataclasses.asdict(ref_cfg))


def _same(a, b) -> None:
    """Dataclasses field for field, exactly."""
    assert dataclasses.astuple(a) == dataclasses.astuple(b), (a, b)


# --------------------------------------------------------------------------
# hardware
# --------------------------------------------------------------------------
@pytest.mark.parametrize("scale", [0.6, 1.0])
def test_device_spec_matches_reference(scale):
    got = pt_hw.H100_SXM.with_freq_scale(scale)
    want = jax_hw.H100_SXM.with_freq_scale(scale)
    _same(got, want)
    back = got.with_freq_scale(1.0 / scale)
    _same(back, want.with_freq_scale(1.0 / scale))
    for state in ("idle", "gated", "off"):
        assert got.state_power(state) == want.state_power(state)
    with pytest.raises(ValueError):
        got.state_power("active")
    assert {k: dataclasses.astuple(v) for k, v in got.power_states().items()} \
        == {k: dataclasses.astuple(v) for k, v in want.power_states().items()}
    for bits in (4.25, 8.0, 16.0, 32.0):
        assert got.peak_flops(bits) == want.peak_flops(bits)
        assert got.compute_power(bits) == want.compute_power(bits)
    for stack in ("eager", "fused"):
        assert got.launch_overhead(stack) == want.launch_overhead(stack)


def test_device_registry_holds_the_h100_only():
    assert pt_hw.get_device("h100-sxm") is pt_hw.H100_SXM
    assert list(pt_hw.DEVICES) == ["h100-sxm"]
    with pytest.raises(KeyError, match="reference"):
        pt_hw.get_device("tpu-v5e")
    with pytest.raises(ValueError):
        pt_hw.get_device("a100")
    with pytest.raises(ValueError):
        pt_hw.H100_SXM.with_freq_scale(2.0)


# --------------------------------------------------------------------------
# workload
# --------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", sorted(REF_CONFIGS))
def test_workload_matches_reference(arch, reduced):
    """Every workload function, field for field, for all ten ARCH_IDS and
    the paper zoo at full width and reduced."""
    ref = REF_CONFIGS[arch].reduced() if reduced else REF_CONFIGS[arch]
    cfg = _port_cfg(ref)
    assert cfg.param_count() == ref.param_count()
    assert cfg.param_count(active_only=True) \
        == ref.param_count(active_only=True)
    for stack in ("eager", "fused"):
        for batch, seq in ((1, 1), (1, 81), (4, 256), (2, 5000)):
            _same(pt_wl.prefill_workload(cfg, batch, seq, stack),
                  jax_wl.prefill_workload(ref, batch, seq, stack))
            _same(pt_wl.train_step_workload(cfg, batch, seq, stack),
                  jax_wl.train_step_workload(ref, batch, seq, stack))
        for batch, chunk, ctx in ((1, 64, 0), (1, 64, 4000), (3, 128, 70)):
            _same(pt_wl.prefill_chunk_workload(cfg, batch, chunk, ctx,
                                               stack),
                  jax_wl.prefill_chunk_workload(ref, batch, chunk, ctx,
                                                stack))
        for batch, cache_len in ((1, 1), (4, 300), (8, 5000)):
            for kvb in (2.0, 1.1):
                _same(pt_wl.decode_step_workload(cfg, batch, cache_len,
                                                 stack, kvb),
                      jax_wl.decode_step_workload(ref, batch, cache_len,
                                                  stack, kvb))
            _same(pt_wl.decode_workload(cfg, batch, cache_len, 17, stack),
                  jax_wl.decode_workload(ref, batch, cache_len, 17, stack))
        lens = np.array([1, 5, 64, 65, 4095, 4096, 4097, 9000])
        for batch in (1, 3):
            got = pt_wl.decode_step_arrays(cfg, batch, lens, stack, 1.1)
            want = jax_wl.decode_step_arrays(ref, batch, lens, stack, 1.1)
            _same(got[0], want[0])
            assert np.array_equal(got[1], want[1])
            assert np.array_equal(got[2], want[2])
    for tokens in (0, 1, 300, 70000):
        assert pt_wl.kv_cache_bytes(cfg, tokens) \
            == jax_wl.kv_cache_bytes(ref, tokens)
        for train in (False, True):
            assert pt_wl.model_flops_6nd(cfg, tokens, train) \
                == jax_wl.model_flops_6nd(ref, tokens, train)
    with pytest.raises(ValueError):
        pt_wl.decode_workload(cfg, 1, 8, 0)


# --------------------------------------------------------------------------
# energy model
# --------------------------------------------------------------------------
def _workloads(ref_cfg, stack):
    yield jax_wl.prefill_workload(ref_cfg, 2, 464, stack)
    yield jax_wl.prefill_workload(ref_cfg, 1, 7, stack)
    yield jax_wl.decode_step_workload(ref_cfg, 4, 300, stack)
    yield jax_wl.decode_step_workload(ref_cfg, 64, 8000, stack)
    yield jax_wl.decode_workload(ref_cfg, 1, 200, 31, stack)
    yield jax_wl.train_step_workload(ref_cfg, 8, 2048, stack)
    yield dataclasses.replace(jax_wl.prefill_workload(ref_cfg, 4, 128,
                                                      stack),
                              collective_bytes=3e8)


def _as_port(w) -> pt_energy.PhaseWorkload:
    return pt_energy.PhaseWorkload(**dataclasses.asdict(w))


@pytest.mark.parametrize("scale", [0.6, 1.0])
@pytest.mark.parametrize("fmt", ALL_FORMATS)
@pytest.mark.parametrize("model_cls", MODEL_CLASSES)
def test_energy_model_matches_reference(model_cls, fmt, scale):
    """evaluate and evaluate_steps under the five formats, both energy
    models, at the nominal clock and at 0.6 of it; idle_energy, combine
    and per."""
    dev = pt_hw.H100_SXM.with_freq_scale(scale)
    jdev = jax_hw.H100_SXM.with_freq_scale(scale)
    em = getattr(pt_energy, model_cls)(dev, make_policy(fmt))
    jem = getattr(jax_energy, model_cls)(jdev, jax_policy(fmt))
    for arch in ("llama-3.1-8b", "qwen3-moe-30b-a3b", "zamba2-1.2b"):
        ref = REF_CONFIGS[arch]
        for stack in ("eager", "fused"):
            reports = {}
            for i, w in enumerate(_workloads(ref, stack)):
                for n_chips in (1, 4):
                    got = em.evaluate(_as_port(w), n_chips)
                    want = jem.evaluate(w, n_chips)
                    _same(got, want)
                    assert got.energy_wh == want.energy_wh
                    _same(got.per(7), want.per(7))
                reports[f"p{i}"] = got
            jreports = {k: jem.evaluate(w, 4)
                        for k, w in zip(reports, _workloads(ref, stack))}
            _same(pt_energy.combine(reports), jax_energy.combine(jreports))
            lens = np.arange(1, 400, 37)
            for batch in (1, 4):
                tmpl, flops, act = jax_wl.decode_step_arrays(
                    ref, batch, lens, stack)
                got = em.evaluate_steps(_as_port(tmpl), flops, act, 2)
                want = jem.evaluate_steps(tmpl, flops, act, 2)
                assert np.array_equal(got[0], want[0])
                assert np.array_equal(got[1], want[1])
                assert got[2] == want[2]
    for sec in (-1.0, 0.0, 2.5):
        assert pt_energy.idle_energy(dev, sec) \
            == jax_energy.idle_energy(jdev, sec)
    with pytest.raises(ValueError):
        pt_energy.combine({})


# --------------------------------------------------------------------------
# slo
# --------------------------------------------------------------------------
def _finished(cls, n=9):
    rng = np.random.default_rng(3)
    reqs = []
    for i in range(n):
        r = cls(req_id=i, prompt=None, prompt_len=int(rng.integers(4, 90)),
                max_new_tokens=5, arrival_time=float(rng.uniform(0, 2)))
        if i % 4:       # one in four never finishes
            r.t_first_token = r.arrival_time + float(rng.uniform(0, 1))
            r.t_done = r.t_first_token + float(rng.uniform(0, 30))
            r.tokens_generated = 5
            r.energy_j = float(rng.uniform(0, 50))
        reqs.append(r)
    return reqs


def test_slo_matches_reference():
    reqs, jreqs = _finished(Request), _finished(JaxRequest)
    pt_slo.assign_slos(reqs, seed=4)
    jax_slo.assign_slos(jreqs, seed=4)
    assert [(r.priority, r.deadline_s, r.slo_tier) for r in reqs] \
        == [(r.priority, r.deadline_s, r.slo_tier) for r in jreqs]
    shed, jshed = reqs[-2:], jreqs[-2:]
    assert pt_slo.slo_summary(reqs[:-2], shed) \
        == jax_slo.slo_summary(jreqs[:-2], jshed)
    assert pt_slo.attainment(reqs) == jax_slo.attainment(jreqs)
    assert pt_slo.attainment([]) == jax_slo.attainment([]) == 1.0
    for field in ("latency", "ttft"):
        assert pt_slo.percentiles(reqs, field=field, qs=(10, 50, 99)) \
            == jax_slo.percentiles(jreqs, field=field, qs=(10, 50, 99))
    assert pt_slo.percentile_dict([]) == jax_slo.percentile_dict([])
    assert [r.req_id for r in pt_slo.completed(reqs)] \
        == [r.req_id for r in jax_slo.completed(jreqs)]
    assert pt_slo.get_tier("standard") == pt_slo.STANDARD
    with pytest.raises(ValueError):
        pt_slo.get_tier("gold")


@pytest.mark.parametrize("fmt", ALL_FORMATS)
def test_slo_estimates_match_reference(fmt):
    for arch in ("llama-3.1-8b", "h2o-danube-3-4b"):
        ref = REF_CONFIGS[arch]
        cfg = _port_cfg(ref)
        for kw in (dict(prompt_len=128, new_tokens=64),
                   dict(prompt_len=7, new_tokens=1, batch=1,
                        stack="eager", n_chips=2)):
            assert pt_slo.estimate_request_latency(cfg, fmt=fmt, **kw) \
                == jax_slo.estimate_request_latency(ref, fmt=fmt, **kw)
            assert pt_slo.estimate_service_rate(cfg, fmt=fmt, **kw) \
                == jax_slo.estimate_service_rate(ref, fmt=fmt, **kw)


# --------------------------------------------------------------------------
# AnalyticBackend with no model
# --------------------------------------------------------------------------
def _phase(res):
    return (res.phase, res.latency_s, res.energy_j, res.tokens, res.batch,
            res.bound, res.power_w)


def _run(run):
    return (run.latencies_s.tolist(), run.energies_j.tolist(), run.t_end,
            run.tokens_per_step, run.bound, run.t_penult, run.n_steps,
            run.tokens)


def _backends(arch, fmt, model_cls="EnergyModel"):
    ref = REF_CONFIGS[arch]
    got = pt_backend.AnalyticBackend(
        _port_cfg(ref), fmt=fmt,
        energy_model_cls=getattr(pt_energy, model_cls))
    want = jax_backend.AnalyticBackend(
        ref, fmt=fmt, energy_model_cls=getattr(jax_energy, model_cls))
    return got, want


def _picks(cls, lens):
    return [(i, cls(req_id=i, prompt=None, prompt_len=n, max_new_tokens=9))
            for i, n in enumerate(lens)]


@pytest.mark.parametrize("fmt", ALL_FORMATS)
@pytest.mark.parametrize("arch", ["llama-3.1-8b", "h2o-danube-3-4b",
                                  "qwen3-moe-30b-a3b"])
def test_analytic_backend_matches_reference(arch, fmt):
    """prefill (plain and chunked), decode_step, decode_run (with and
    without a stop, t_start != 0), decode_tail, idle, the report entry
    points, and set_freq_scale to 0.6 and back."""
    got, want = _backends(arch, fmt)
    for scale in (1.0, 0.6, 1.0):
        got.set_freq_scale(scale)
        want.set_freq_scale(scale)
        _same(got.device, want.device)
        for stack in ("eager", "fused"):
            for lens, pad in (([81], 88), ([100, 130], 256), ([4000], 4096)):
                _, r = _picks(Request, lens)[0]
                _, jr = _picks(JaxRequest, lens)[0]
                assert _phase(got.prefill(pt_backend.PrefillBatch(
                    _picks(Request, lens), pad, stack))) \
                    == _phase(want.prefill(jax_backend.PrefillBatch(
                        _picks(JaxRequest, lens), pad, stack)))
                assert _phase(got.prefill(pt_backend.PrefillBatch(
                    _picks(Request, lens[:1]), 64, stack, 128, 64))) \
                    == _phase(want.prefill(jax_backend.PrefillBatch(
                        _picks(JaxRequest, lens[:1]), 64, stack, 128, 64)))
                assert _phase(got.decode_tail(r, 31, stack)) \
                    == _phase(want.decode_tail(jr, 31, stack))
            for cache_lens in ([82], [101, 131, 7], [4000, 5000, 1, 9]):
                n = len(cache_lens)
                args = (list(range(n)), [None] * n, cache_lens, stack)
                batch = pt_backend.DecodeBatch(*args)
                jbatch = jax_backend.DecodeBatch(*args)
                assert _phase(got.decode_step(batch)) \
                    == _phase(want.decode_step(jbatch))
                for t_start in (0.0, 3.25):
                    assert _run(got.decode_run(batch, 40,
                                               t_start=t_start)) \
                        == _run(want.decode_run(jbatch, 40,
                                                t_start=t_start))
                    for mode in ("admit", "clock"):
                        one = want.decode_step(jbatch).latency_s
                        stop = HorizonStop(t_start + 5.5 * one, mode=mode)
                        a = got.decode_run(batch, 40, t_start=t_start,
                                           stop=stop)
                        assert _run(a) == _run(want.decode_run(
                            jbatch, 40, t_start=t_start, stop=stop))
                        assert 1 < a.n_steps < 40
                        # the protocol's stepwise loop gives the same run
                        assert _run(pt_backend.InferenceBackend.decode_run(
                            got, batch, 40, t_start=t_start, stop=stop)) \
                            == _run(a)
        for state in ("idle", "gated"):
            assert _phase(got.idle(2.5, state)) \
                == _phase(want.idle(2.5, state))
        _same(got.prefill_report(3, 200), want.prefill_report(3, 200))
        _same(got.decode_step_report(3, 200),
              want.decode_step_report(3, 200))
        _same(got.decode_report(2, 100, 33), want.decode_report(2, 100, 33))
        _same(got.train_report(4, 1024), want.train_report(4, 1024))
    assert got.device is got._nominal_device
    with pytest.raises(ValueError):
        got.decode_run(pt_backend.DecodeBatch([0], [None], [5]), 0)


def test_analytic_backend_from_a_scaled_device():
    """Built at 0.6 of the clock, retargeted to 0.8 and 1.0: the same
    nominal spec recovered as the reference's."""
    ref = REF_CONFIGS["llama-3.1-8b"]
    got = pt_backend.AnalyticBackend(
        _port_cfg(ref), device=pt_hw.H100_SXM.with_freq_scale(0.6))
    want = jax_backend.AnalyticBackend(
        ref, device=jax_hw.H100_SXM.with_freq_scale(0.6))
    for target in (0.8, 1.0):
        got.set_freq_scale(target)
        want.set_freq_scale(target)
        _same(got.device, want.device)
        assert _phase(got.idle(1.0)) == _phase(want.idle(1.0))


def test_serve_report_properties_match_reference():
    """ServeReport's properties and summary() over the same requests and
    totals, fault fields included."""
    kw = dict(total_energy_j=812.5, busy_energy_j=700.25,
              idle_energy_j=112.25, wall_time_s=31.0, busy_time_s=27.5,
              mean_batch=3.4, n_prefill_batches=5, n_decode_steps=60,
              prefill_computed_tokens=900, prefill_effective_tokens=611)
    for extra in ({}, dict(n_failures=1, wasted_energy_j=3.0,
                           down_time_s=2.0)):
        got = pt_engine.ServeReport(requests=_finished(Request), **kw,
                                    **extra)
        want = jax_engine.ServeReport(requests=_finished(JaxRequest), **kw,
                                      **extra)
        assert got.summary() == want.summary()
        for name in ("prefill_padding_fraction", "n", "n_completed",
                     "availability", "goodput_wh_per_request",
                     "utilization", "mean_energy_per_request_wh",
                     "mean_attributed_energy_wh", "mean_latency_s",
                     "mean_ttft_s", "tokens_per_s",
                     "mean_energy_per_token_wh"):
            assert getattr(got, name) == getattr(want, name), name
        assert got.ttft_percentiles() == want.ttft_percentiles()
    empty = pt_engine.ServeReport([], 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    assert empty.summary() == jax_engine.ServeReport(
        [], 0.0, 0.0, 0.0, 0.0, 0.0, 0.0).summary()


# --------------------------------------------------------------------------
# the slice end to end
# --------------------------------------------------------------------------
CFG = PAPER_MODELS["llama-3.1-8b"].reduced()
JCFG = JAX_ZOO["llama-3.1-8b"].reduced()
REPORT_FIELDS = ("total_energy_j", "busy_energy_j", "idle_energy_j",
                 "wall_time_s", "busy_time_s", "mean_batch",
                 "n_prefill_batches", "n_decode_steps", "gated_energy_j",
                 "gated_time_s", "idle_time_s", "prefill_computed_tokens",
                 "prefill_effective_tokens", "mean_energy_per_request_wh",
                 "mean_attributed_energy_wh", "mean_latency_s",
                 "mean_ttft_s", "tokens_per_s", "mean_energy_per_token_wh")
REQUEST_FIELDS = ("energy_j", "t_prefill_start", "t_first_token", "t_done",
                  "tokens_generated", "prefilled_tokens")


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def weights(request, tmp_path_factory):
    fmt = request.param
    jm = jax_build_model(JCFG, fmt=fmt)
    params = jm.init(jax.random.PRNGKey(1))
    return fmt, jm, params, carry_params(params, tmp_path_factory.mktemp(fmt))


def _reqs(cls):
    rng = np.random.default_rng(7)
    out = []
    for i in range(8):
        n = int(rng.integers(4, 40))
        out.append(cls(req_id=i, prompt=rng.integers(0, CFG.vocab_size, n)
                       .astype(np.int32), prompt_len=n,
                       max_new_tokens=int(rng.integers(1, 6)),
                       arrival_time=0.0))
    return out


@pytest.mark.parametrize("mode", ["continuous", "sequential"])
def test_serve_report_matches_reference_engine(weights, mode):
    """Reduced llama-3.1-8b, 8 requests at t=0, max_batch=4,
    max_prefill_batch=2, buf_len=64: every report energy and time field,
    each request's energy and times and summary() equal the reference
    ServeEngine(execute=True)'s float for float; float32 greedy tokens
    are identical."""
    fmt, jm, jparams, tparams = weights
    jreqs = _reqs(JaxRequest)
    want = JaxServeEngine(JCFG, fmt=fmt, mode=mode, execute=True, model=jm,
                          params=jparams, buf_len=64,
                          batch_policy=SlotCountPolicy(max_batch=4,
                                                       max_prefill_batch=2)
                          ).run(jreqs)
    treqs = _reqs(Request)
    eng = ServeEngine(build_model(CFG, fmt=fmt, device="cpu"), tparams,
                      mode=mode, max_batch=4, max_prefill_batch=2,
                      buf_len=64, fmt=fmt)
    got = eng.run(treqs)
    assert len(got.requests) == 8
    assert all(a is b for a, b in zip(got.requests, treqs))
    for name in REPORT_FIELDS:
        assert getattr(got, name) == getattr(want, name), name
    assert got.summary() == want.summary()
    assert got.latency_percentiles() == want.latency_percentiles()
    for a, b in zip(got.requests, want.requests):
        for name in REQUEST_FIELDS:
            assert getattr(a, name) == getattr(b, name), (a.req_id, name)
        assert a.status is RequestStatus.DONE
        assert len(a.generated) == a.max_new_tokens
        if fmt == "float32":
            assert a.generated == b.generated, a.req_id
    assert got.total_energy_j > 0 and got.idle_energy_j == 0.0
    phases = [p for p in eng.phases if p.phase in ("prefill", "decode")]
    assert len(phases) == len(eng.phases)
    if mode == "continuous":
        assert [p.phase for p in phases].count("decode") \
            == want.n_decode_steps
        assert all(p.wall_s is not None and p.wall_s >= 0 for p in phases)
    else:
        assert all(p.wall_s is None for p in phases)   # costed only


def test_executed_decode_run_steps_the_model(weights):
    """ExecutedBackend.decode_run runs the model once a step (a token per
    live slot each step) and returns the analytic fused run."""
    fmt, _, _, tparams = weights
    model = build_model(CFG, fmt=fmt, device="cpu")
    b = pt_backend.ExecutedBackend(model, tparams, max_batch=2, buf_len=32)
    reqs = [r for _, r in _picks(Request, [5, 9])]
    for r in reqs:
        r.prompt = np.arange(r.prompt_len) % CFG.vocab_size
    b.prefill(pt_backend.PrefillBatch([(0, reqs[0]), (1, reqs[1])], 16))
    batch = pt_backend.DecodeBatch([0, 1], reqs, [6, 10])
    run = b.decode_run(batch, 4, t_start=1.5)
    assert [len(r.generated) for r in reqs] == [5, 5]
    fused = pt_backend.AnalyticBackend(CFG, policy=model.policy) \
        .decode_run(batch, 4, t_start=1.5)
    assert _run(run) == _run(fused)
    with pytest.raises(ValueError, match="chunked"):
        b.prefill(pt_backend.PrefillBatch([(0, reqs[0])], 16, "fused", 0, 4))


def test_engine_refuses_a_late_arrival_and_another_format(weights):
    fmt, _, _, tparams = weights
    model = build_model(CFG, fmt=fmt, device="cpu")
    other = "bfloat16" if fmt == "float32" else "float32"
    with pytest.raises(ValueError, match="conflicts"):
        ServeEngine(model, tparams, fmt=other)
    reqs = _reqs(Request)
    reqs[3].arrival_time = 0.5
    with pytest.raises(ValueError, match="arrive after"):
        ServeEngine(model, tparams).run(reqs)
