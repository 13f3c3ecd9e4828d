"""The port's declarative experiment API (repro_torch.api) against the
JAX package's: the golden records byte for byte (spec hash included),
twins of tests/test_api.py on the same specs (every record also equal to
the reference's, ==), the executed backend on reduced llama-3.1-8b in
float32 on the CPU (its record equal to the reference's executed record,
and with the reference's PRNGKey(0) weights carried in, its tokens
identical), the executed backend's refusals (no CUDA device without
torch_device="cpu"; a disaggregated fleet, ROADMAP C6), and the package's
exports."""
import dataclasses
import json
import math
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch import ExperimentSpec, RunResult  # noqa: E402
from repro_torch.api import result_from_report  # noqa: E402
from repro_torch.serving import PowerTrace  # noqa: E402
from repro_torch.serving.slo import percentile_dict  # noqa: E402

from _torch_orchestration import PKG  # noqa: E402
from _torch_parity import carry_params  # noqa: E402

SMALL = dict(model="qwen2.5-0.5b", n_requests=12)
DATA = os.path.join(os.path.dirname(__file__), "data")
with open(os.path.join(DATA, "golden_pre_refactor.json")) as f:
    GOLDEN = json.load(f)["records"]


def _ref(spec: ExperimentSpec):
    """The reference's spec of the same fields."""
    return repro.ExperimentSpec.from_dict(spec.to_dict())


def _same_record(spec: ExperimentSpec):
    """Run ``spec`` in both packages; the records must be byte-equal."""
    got = spec.run()
    assert got.to_json() == _ref(spec).run().to_json()
    return got


# ---------------------------------------------------------------------------
# golden records (the reference's check: tests/test_backend.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_record_reproduces(name):
    rec = GOLDEN[name]
    spec = ExperimentSpec.from_dict(rec["spec"])
    assert spec.spec_hash() == rec["spec_hash"]
    assert spec.run().to_json() == rec["result"]


def test_package_exports_equal_reference():
    assert repro_torch.__all__ == repro.__all__
    assert repro_torch.__version__ == repro.__version__
    for name in repro_torch.__all__:
        assert hasattr(repro_torch, name), name


# ---------------------------------------------------------------------------
# twins of tests/test_api.py
# ---------------------------------------------------------------------------
class TestSpecValidation:
    def test_defaults_valid(self):
        assert ExperimentSpec().to_json() == repro.ExperimentSpec().to_json()

    @pytest.mark.parametrize("bad", [
        {"model": "gpt-17"},
        {"fmt": "int3"},
        {"device": "b300"},
        {"mode": "batch"},
        {"pipeline": "train"},
        {"router": "magic"},
        {"scheduler": "magic"},
        {"arrival": "chaotic"},
        {"energy_model": "spice"},
        {"replicas": 0},
        {"n_requests": -1},
        {"max_batch": 0},
        {"profile_seeds": 0},
        {"prompt_range": (0, 100)},
        {"prompt_range": (200, 100)},
        {"output_range": (0, 10)},
    ])
    def test_unknown_axis_values_raise(self, bad):
        with pytest.raises(ValueError):
            ExperimentSpec(**bad)

    def test_reference_only_device_is_refused(self):
        # the port's registry holds the H100 only: the reference's TPU
        # device is refused, naming the reference
        with pytest.raises(KeyError, match="reference"):
            ExperimentSpec(device="tpu-v5e")

    def test_replica_overrides_validation(self):
        with pytest.raises(ValueError):    # wrong count
            ExperimentSpec(replicas=3,
                           replica_overrides=({"fmt": "int8"},))
        with pytest.raises(ValueError):    # unknown override field
            ExperimentSpec(replicas=1,
                           replica_overrides=({"vocab_size": 3},))
        ExperimentSpec(replicas=2,
                       replica_overrides=({"fmt": "int8"},
                                          {"max_batch": 4}))

    def test_frozen(self):
        with pytest.raises(dataclasses.FrozenInstanceError):
            ExperimentSpec().model = "other"

    def test_hashable_by_content(self):
        a = ExperimentSpec(scheduler_params={"x": 1.0})
        b = ExperimentSpec(scheduler_params={"x": 1.0})
        assert hash(a) == hash(b) and len({a, b}) == 1
        assert len({a, a.derive(seed=1)}) == 2

    def test_explicit_arrivals_length_checked(self):
        spec = ExperimentSpec(n_requests=3, arrival="explicit",
                              arrival_params={"times": (0.0, 1.0)})
        with pytest.raises(ValueError):
            spec.arrivals()


class TestSpecSerialization:
    def _rich_spec(self):
        # the reference's rich spec names device="tpu-v5e", which the
        # port's registry refuses (see TestSpecValidation): its twin
        # names the H100, every other field as the reference's
        return ExperimentSpec(
            model="llama-3.1-8b", fmt="int8", device="h100-sxm",
            replicas=2, router="energy_aware",
            replica_overrides=({"fmt": "bfloat16"}, {"fmt": "int8"}),
            scheduler="window", scheduler_params={"window_s": 2.0},
            arrival="burst",
            arrival_params={"burst_size": 4, "burst_gap_s": 2.0},
            prompt_range=(100, 200), output_range=(5, 10),
            slo_tiers=(("gold", 2, 1.5), ("bulk", 0, math.inf)),
            slo_weights=(0.5, 0.5), trace=True, seed=3)

    def test_json_round_trip_equality(self):
        spec = self._rich_spec()
        back = ExperimentSpec.from_json(spec.to_json())
        assert back == spec
        assert back.spec_hash() == spec.spec_hash()
        ref = _ref(spec)
        assert ref.to_json() == spec.to_json()
        assert ref.spec_hash() == spec.spec_hash()

    def test_rich_spec_record_equals_reference(self):
        _same_record(self._rich_spec().derive(n_requests=12))

    def test_round_trip_default_spec(self):
        spec = ExperimentSpec()
        assert ExperimentSpec.from_json(spec.to_json()) == spec

    def test_hash_sensitive_to_every_changed_axis(self):
        spec = ExperimentSpec()
        for change in [{"fmt": "float32"}, {"max_batch": 16},
                       {"seed": 1}, {"arrival": "fixed",
                                     "arrival_params":
                                         {"interval_s": 0.1}}]:
            d = spec.derive(**change)
            assert d.spec_hash() != spec.spec_hash()
            assert d.spec_hash() == _ref(d).spec_hash()

    def test_unknown_field_rejected(self):
        with pytest.raises(ValueError):
            ExperimentSpec.from_dict({"modle": "typo"})

    def test_derive_dotted_params(self):
        spec = ExperimentSpec(arrival="fixed",
                              arrival_params={"interval_s": 0.1,
                                              "start": 1.0})
        d = spec.derive(**{"arrival_params.interval_s": 0.2})
        assert d.arrival_params == {"interval_s": 0.2, "start": 1.0}
        assert spec.arrival_params["interval_s"] == 0.1


class TestRunResult:
    def test_serve_field_parity(self):
        spec = ExperimentSpec(**SMALL)
        res = _same_record(spec)
        rep = res.report
        assert res.kind == "serve"
        assert res.n_requests == rep.n
        assert res.total_energy_j == rep.total_energy_j
        assert res.mean_energy_wh == rep.mean_energy_per_request_wh
        assert res.mean_latency_s == rep.mean_latency_s
        assert res.mean_ttft_s == rep.mean_ttft_s
        assert res.latency_p99_s == rep.latency_percentiles()["p99"]
        assert res.ttft_p50_s == rep.ttft_percentiles()["p50"]
        assert res.slo_attainment == rep.slo_attainment
        assert res.mean_batch == rep.mean_batch
        assert res.utilization == rep.utilization
        assert res.tokens_per_s == rep.tokens_per_s
        assert res.idle_fraction == pytest.approx(
            rep.idle_energy_j / rep.total_energy_j)

    def test_cluster_field_parity(self):
        spec = ExperimentSpec(replicas=2, router="least_loaded",
                              arrival="fixed",
                              arrival_params={"interval_s": 0.05},
                              **SMALL)
        res = _same_record(spec)
        rep = res.report
        assert res.kind == "cluster"
        assert res.router == "least_loaded"
        assert res.replicas == 2
        assert res.n_requests == rep.n == SMALL["n_requests"]
        assert res.total_energy_j == rep.total_energy_j
        assert res.gated_energy_j == rep.gated_energy_j
        assert res.mean_energy_wh == rep.mean_energy_per_request_wh
        assert res.latency_p90_s == rep.latency_percentiles()["p90"]
        assert tuple(rep.requests_per_replica) \
            == res.requests_per_replica

    def test_result_json_round_trip(self):
        res = ExperimentSpec(**SMALL).run()
        back = RunResult.from_json(res.to_json())
        assert back.report is None
        assert back.to_json() == res.to_json()
        assert back == dataclasses.replace(res, report=None)
        ref = repro.RunResult.from_json(res.to_json())
        assert ref.to_json() == res.to_json()

    def test_rerun_from_spec_json_is_byte_identical(self):
        spec = ExperimentSpec(arrival="burst",
                              arrival_params={"burst_size": 4,
                                              "burst_gap_s": 1.0},
                              scheduler="window",
                              scheduler_params={"window_s": 0.5},
                              trace=True, **SMALL)
        r1 = _same_record(spec)
        r2 = ExperimentSpec.from_json(spec.to_json()).run()
        assert r1.to_json() == r2.to_json()

    def test_trace_coverage_recorded(self):
        res = _same_record(ExperimentSpec(trace=True, **SMALL))
        assert res.trace_coverage == pytest.approx(1.0)
        assert set(res.energy_by_state_j) == {"prefill", "decode",
                                              "idle", "gated"}
        assert (sum(res.energy_by_state_j.values())
                == pytest.approx(res.total_energy_j))

    def test_metric_lookup(self):
        res = ExperimentSpec(**SMALL).run()
        assert res.metric("mean_energy_wh") == res.mean_energy_wh
        with pytest.raises(AttributeError):
            res.metric("nonexistent_metric")
        with pytest.raises(ValueError):    # unset profile field
            res.metric("prefill_energy_j")


class TestProfilePipeline:
    def test_profile_metrics(self):
        spec = ExperimentSpec(pipeline="profile", model="qwen2.5-0.5b",
                              fmt="float32", max_batch=4,
                              prompt_range=(200, 400),
                              output_range=(16, 16), profile_seeds=2)
        res = _same_record(spec)
        assert res.kind == "profile"
        assert res.prefill_energy_j > 0
        assert res.decode_j_per_tok > 0
        assert 0.0 <= res.padding_fraction < 1.0
        assert res.computed_tokens >= res.effective_tokens
        assert res.gen_j_per_out == pytest.approx(
            (res.prefill_energy_j + res.decode_energy_j) / (4 * 16))

    def test_pinned_prompt_has_no_padding(self):
        res = _same_record(ExperimentSpec(
            pipeline="profile", model="qwen2.5-0.5b", max_batch=2,
            prompt_range=(256, 256), output_range=(8, 8)))
        assert res.padding_fraction == 0.0
        assert res.effective_tokens == 2 * 256


class TestSchedulerAndSloResolution:
    def test_scheduler_axis_resolves(self):
        spec = ExperimentSpec(scheduler="paced",
                              scheduler_params={"rate_per_s": 50},
                              **SMALL)
        assert _same_record(spec).n_requests == SMALL["n_requests"]

    def test_deadline_auto_estimates(self):
        spec = ExperimentSpec(scheduler="deadline", **SMALL)
        sched = spec.build_scheduler()
        assert sched.rate > 0 and sched.est_latency_s > 0
        ref = _ref(spec).build_scheduler()
        assert (sched.rate, sched.est_latency_s) \
            == (ref.rate, ref.est_latency_s)

    def test_energy_budget_wired_to_spec(self):
        spec = ExperimentSpec(
            scheduler="energy_budget",
            scheduler_params={"max_wh_per_request": 1e-6}, **SMALL)
        sched = spec.build_scheduler()
        assert sched.max_batch == spec.max_batch
        res = _same_record(spec)    # absurdly low cap: everything shed
        assert res.n_shed == SMALL["n_requests"]
        assert len(res.shed_arrival_times) == res.n_shed

    def test_scheduler_predictor_matches_spec_energy_model(self):
        from repro_torch.core.energy import FusedDequantEnergyModel
        spec = ExperimentSpec(
            fmt="int8", energy_model="fused_dequant",
            scheduler="energy_budget",
            scheduler_params={"max_wh_per_request": 0.01}, **SMALL)
        sched = spec.build_scheduler()
        assert isinstance(sched.energy, FusedDequantEnergyModel)
        assert isinstance(spec.build_engine().energy,
                          FusedDequantEnergyModel)
        _same_record(spec)

    def test_slo_assignment(self):
        spec = ExperimentSpec(slo_tiers=(("fast", 1, 0.001),
                                         ("slow", 0, math.inf)),
                              slo_weights=(1.0, 1.0), **SMALL)
        res = _same_record(spec)
        assert set(res.tier_attainment) == {"fast", "slow"}
        assert res.tier_attainment["slow"] == 1.0
        assert res.slo_attainment < 1.0


class TestHelpers:
    def test_percentile_dict_empty_guard(self):
        out = percentile_dict([])
        assert out == {"p50": 0.0, "p90": 0.0, "p99": 0.0}

    def test_percentile_dict_values(self):
        out = percentile_dict([1.0, 2.0, 3.0], qs=(50,))
        assert out == {"p50": 2.0}

    def test_result_from_report_with_trace(self):
        spec = ExperimentSpec(**SMALL)
        trace = PowerTrace()
        rep = spec.build_engine().run(spec.requests(), trace=trace)
        res = result_from_report(spec, rep, trace)
        assert res.trace_coverage == pytest.approx(1.0)
        ref, ref_trace = _ref(spec), repro.serving.PowerTrace()
        ref_rep = ref.build_engine().run(ref.requests(), trace=ref_trace)
        assert res.to_json() == repro.api.result_from_report(
            ref, ref_rep, ref_trace).to_json()

    def test_package_exports(self):
        assert repro_torch.__version__
        for name in ("ExperimentSpec", "RunResult", "sweep", "Claim",
                     "PAPER_MODELS", "Option", "run_spec"):
            assert hasattr(repro_torch, name), name


# ---------------------------------------------------------------------------
# the executed backend (ROADMAP C, differences a and d)
# ---------------------------------------------------------------------------
EXEC = dict(model="llama-3.1-8b", reduced=True, backend="executed",
            fmt="float32", n_requests=6, max_batch=4, max_prefill_batch=2,
            prompt_range=(6, 40), output_range=(2, 10), buf_len=64,
            arrival="poisson", arrival_params={"rate_per_s": 60.0},
            seed=1)


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """The reference's executed weights (PRNGKey(0), reduced llama,
    float32) and their copy in the port."""
    cfg = PKG["jax"].llama.reduced()
    params = jax_build_model(cfg, fmt="float32").init(
        jax.random.PRNGKey(0))
    return carry_params(params, tmp_path_factory.mktemp("api"))


def _tokens(res):
    reps = getattr(res.report, "replica_reports", [res.report])
    return sorted((r.req_id, list(r.generated))
                  for rep in reps for r in rep.requests)


def test_executed_record_equals_reference_and_analytic_twin():
    spec = ExperimentSpec(**EXEC)
    got = spec.run(torch_device="cpu")
    ref = _ref(spec).run()
    assert got.to_json() == ref.to_json()
    twin = spec.derive(backend="analytic").run().to_dict()
    mine = got.to_dict()
    assert mine.pop("spec_hash") != twin.pop("spec_hash")
    assert mine == twin
    for _, toks in _tokens(got):
        assert toks and all(0 <= t < spec.model_config().vocab_size
                            for t in toks)


def test_executed_tokens_equal_reference_on_carried_weights(carried,
                                                            monkeypatch):
    spec = ExperimentSpec(**EXEC)
    ref = _ref(spec).run()
    monkeypatch.setattr(PKG["torch"].api, "executed_params",
                        lambda model: carried)
    got = spec.run(torch_device="cpu")
    assert got.to_json() == ref.to_json()
    assert _tokens(got) == _tokens(ref)
    assert all(len(t) == r.max_new_tokens
               for (_, t), r in zip(_tokens(got), sorted(
                   got.report.requests, key=lambda r: r.req_id)))


def test_executed_replicas_share_one_model_per_format(monkeypatch):
    built = []
    real = PKG["torch"].api.executed_params

    def count(model):
        built.append(model)
        return real(model)

    monkeypatch.setattr(PKG["torch"].api, "executed_params", count)
    spec = ExperimentSpec(**dict(EXEC, replicas=3,
                                 replica_overrides=({"fmt": "float32"},
                                                    {"fmt": "bfloat16"},
                                                    {"fmt": "float32"})))
    eng = spec.build_engine(torch_device="cpu")
    assert [m.policy.fmt for m in built] == ["float32", "bfloat16"]
    models = [e.backend.model for e in eng.replicas]
    assert models[0] is models[2] is built[0] and models[1] is built[1]
    assert all(m.device == torch.device("cpu") for m in models)


def test_executed_spec_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ExperimentSpec(**EXEC)
    for call in (spec.run, spec.build_engine,
                 lambda: repro_torch.run_spec(spec, cache=False),
                 lambda: repro_torch.sweep(spec, cache=False)):
        with pytest.raises(ValueError, match="torch_device"):
            call()
    # the legacy alias too, and never for an analytic spec
    with pytest.raises(ValueError, match="torch_device"):
        ExperimentSpec(**dict(EXEC, backend="analytic",
                              execute=True)).run()
    ExperimentSpec(**dict(EXEC, backend="analytic")).run()


def test_torch_device_is_not_a_spec_field():
    spec = ExperimentSpec(**EXEC)
    assert "torch_device" not in spec.to_dict()
    with pytest.raises(ValueError, match="unknown spec fields"):
        ExperimentSpec.from_dict(dict(spec.to_dict(), torch_device="cpu"))


def test_executed_disaggregated_fleet_is_refused():
    # ROADMAP C6: the reference's decode replica never receives the
    # prefill replica's KV cache, and serves other tokens; the port's
    # ServeEngine refuses an executed replica in such a pool
    spec = ExperimentSpec(**dict(EXEC, replicas=2, disaggregate=1))
    with pytest.raises(ValueError, match="disaggregated pool"):
        spec.run(torch_device="cpu")
    spec.derive(backend="analytic").run()
