"""The port's sweeps, claims and memoization (repro_torch.sweep): twins of
tests/test_sweep.py, each sweep's records also equal to the reference's
(==), plus the port's own cache directory (its specs hash as the
reference's, so a shared directory would serve the reference's records),
a cold cache that runs every point, and parallel sweeps equal to serial
ones and to the reference's byte for byte.

tests/test_sweep.py's TestBenchmarkIntegration has no twin:
``benchmarks/`` is not ported in this round."""
import importlib
import json
import os

import pytest

pytest.importorskip("torch")

import repro  # noqa: E402
from repro_torch import (Claim, ExperimentSpec, Option, RunResult,  # noqa: E402
                         expand_grid, run_spec, select, sweep)

SW = importlib.import_module("repro_torch.sweep")
REF_SW = importlib.import_module("repro.sweep")
SMALL = dict(model="qwen2.5-0.5b", n_requests=8)


def _ref_sweep(base, axes, **kw):
    """The reference's sweep of the same spec and axes, uncached."""
    return repro.sweep(repro.ExperimentSpec.from_dict(base.to_dict()),
                       axes, cache=False, **kw)


def _equal_records(got, want):
    assert list(got.results) == list(want.results)
    for label in want.results:
        assert got[label].to_json() == want[label].to_json()


class TestGridExpansion:
    def test_no_axes_single_point(self):
        pts = expand_grid(ExperimentSpec(), None, tag="solo")
        assert [lbl for lbl, _ in pts] == ["solo"]

    def test_cartesian_counts(self):
        axes = {"fmt": ["bfloat16", "float32", "int8"], "max_batch": [8, 16]}
        pts = expand_grid(ExperimentSpec(), axes)
        assert len(pts) == 6
        labels = [lbl for lbl, _ in pts]
        assert labels[0] == "fmt=bfloat16/max_batch=8"
        assert len(set(labels)) == 6
        specs = {s.spec_hash() for _, s in pts}
        assert len(specs) == 6
        ref = repro.expand_grid(repro.ExperimentSpec(), axes)
        assert [(lbl, s.spec_hash()) for lbl, s in pts] \
            == [(lbl, s.spec_hash()) for lbl, s in ref]

    def test_option_axis_sets_multiple_fields(self):
        pts = expand_grid(ExperimentSpec(), {"arrival": [
            Option("burst", arrival="burst",
                   arrival_params={"burst_size": 2, "burst_gap_s": 1.0}),
            Option("steady", arrival="fixed",
                   arrival_params={"interval_s": 0.1}),
        ]}, tag="t")
        assert [lbl for lbl, _ in pts] == ["t/burst", "t/steady"]
        assert pts[0][1].arrival == "burst"
        assert pts[1][1].arrival_params == {"interval_s": 0.1}

    def test_dotted_axis(self):
        base = ExperimentSpec(arrival="fixed",
                              arrival_params={"interval_s": 0.1})
        pts = expand_grid(base,
                          {"arrival_params.interval_s": [0.1, 0.2]})
        assert [lbl for lbl, _ in pts] == ["interval_s=0.1",
                                          "interval_s=0.2"]
        assert pts[1][1].arrival_params["interval_s"] == 0.2

    def test_label_collision_rejected(self):
        with pytest.raises(ValueError):
            expand_grid(ExperimentSpec(),
                        {"x": [Option("same"), Option("same")]})

    def test_invalid_grid_point_fails_before_running(self):
        with pytest.raises(ValueError):
            expand_grid(ExperimentSpec(), {"fmt": ["bfloat16", "int3"]})


class TestMemoization:
    def test_cache_hit_on_identical_spec(self, tmp_path):
        spec = ExperimentSpec(**SMALL)
        r1, hit1 = run_spec(spec, cache_dir=str(tmp_path))
        r2, hit2 = run_spec(spec, cache_dir=str(tmp_path))
        assert (hit1, hit2) == (False, True)
        assert r2.report is None          # cached: no live report
        assert r2.to_json() == r1.to_json()
        files = os.listdir(tmp_path)
        assert files == [spec.spec_hash() + ".json"]

    def test_axis_change_misses(self, tmp_path):
        run_spec(ExperimentSpec(**SMALL), cache_dir=str(tmp_path))
        _, hit = run_spec(ExperimentSpec(**{**SMALL, "seed": 9}),
                          cache_dir=str(tmp_path))
        assert not hit

    def test_corrupt_cache_entry_reruns(self, tmp_path):
        spec = ExperimentSpec(**SMALL)
        run_spec(spec, cache_dir=str(tmp_path))
        path = tmp_path / (spec.spec_hash() + ".json")
        path.write_text("{not json")
        _, hit = run_spec(spec, cache_dir=str(tmp_path))
        assert not hit

    def test_spec_mismatch_in_cache_file_reruns(self, tmp_path):
        spec = ExperimentSpec(**SMALL)
        run_spec(spec, cache_dir=str(tmp_path))
        path = tmp_path / (spec.spec_hash() + ".json")
        blob = json.loads(path.read_text())
        blob["spec"]["seed"] = 1234       # simulated hash collision
        path.write_text(json.dumps(blob))
        _, hit = run_spec(spec, cache_dir=str(tmp_path))
        assert not hit

    def test_stale_code_version_reruns(self, tmp_path):
        spec = ExperimentSpec(**SMALL)
        run_spec(spec, cache_dir=str(tmp_path))
        path = tmp_path / (spec.spec_hash() + ".json")
        blob = json.loads(path.read_text())
        blob["version"] = "0.0.0-older-code"
        path.write_text(json.dumps(blob))
        _, hit = run_spec(spec, cache_dir=str(tmp_path))
        assert not hit                     # stale results not served

    def test_cache_disabled_writes_nothing(self, tmp_path):
        run_spec(ExperimentSpec(**SMALL), cache=False,
                 cache_dir=str(tmp_path))
        assert not os.listdir(tmp_path)

    def test_sweep_counts_hits(self, tmp_path):
        spec = ExperimentSpec(**SMALL)
        axes = {"max_batch": [4, 8]}
        s1 = sweep(spec, axes, cache_dir=str(tmp_path))
        s2 = sweep(spec, axes, cache_dir=str(tmp_path))
        assert (s1.cache_misses, s1.cache_hits) == (2, 0)
        assert (s2.cache_misses, s2.cache_hits) == (0, 2)
        _equal_records(s1, _ref_sweep(spec, axes))
        _equal_records(s2, s1)

    def test_cold_cache_runs_every_point(self, tmp_path):
        spec = ExperimentSpec(**SMALL)
        axes = {"max_batch": [4, 8], "fmt": ["bfloat16", "int8"]}
        cold = sweep(spec, axes, cache_dir=str(tmp_path / "cold"))
        assert (cold.cache_misses, cold.cache_hits) == (4, 0)
        assert all(r.report is not None for r in cold.results.values())
        assert sorted(os.listdir(tmp_path / "cold")) == sorted(
            s.spec_hash() + ".json" for _, s in expand_grid(spec, axes))

    def test_own_cache_directory(self, tmp_path, monkeypatch):
        assert SW.DEFAULT_CACHE_DIR != REF_SW.DEFAULT_CACHE_DIR
        assert SW.DEFAULT_CACHE_DIR == os.path.join(
            "experiments", "bench", "speccache_torch")
        # a reference record under the reference's directory (same hash)
        # is never read by the port's default cache
        monkeypatch.chdir(tmp_path)
        spec = ExperimentSpec(**SMALL)
        REF_SW.run_spec(repro.ExperimentSpec.from_dict(spec.to_dict()),
                        cache_dir=REF_SW.DEFAULT_CACHE_DIR)
        assert os.listdir(REF_SW.DEFAULT_CACHE_DIR) \
            == [spec.spec_hash() + ".json"]
        _, hit = run_spec(spec)
        assert not hit
        assert os.listdir(SW.DEFAULT_CACHE_DIR) \
            == [spec.spec_hash() + ".json"]


def _fake(label_to_wh):
    return {k: RunResult(spec_hash=k, mean_energy_wh=v,
                         total_energy_j=v * 3600,
                         tier_attainment={"gold": 0.5})
            for k, v in label_to_wh.items()}


class TestParallelSweep:
    AXES = {"max_batch": [4, 8, 16]}

    def test_workers_match_serial_byte_for_byte(self, tmp_path):
        serial = sweep(ExperimentSpec(**SMALL), self.AXES, tag="p",
                       cache=False, workers=1)
        par = sweep(ExperimentSpec(**SMALL), self.AXES, tag="p",
                    cache_dir=str(tmp_path), workers=3)
        _equal_records(par, serial)
        assert par.cache_misses == 3
        _equal_records(par, _ref_sweep(ExperimentSpec(**SMALL), self.AXES,
                                       tag="p", workers=1))

    def test_two_workers_equal_one_and_reference(self):
        base = ExperimentSpec(**SMALL, replicas=2, fleet="vector",
                              arrival="poisson",
                              arrival_params={"rate_per_s": 20.0})
        axes = {"fmt": ["bfloat16", "int8"]}
        one = sweep(base, axes, cache=False, workers=1)
        two = sweep(base, axes, cache=False, workers=2)
        _equal_records(two, one)
        _equal_records(two, _ref_sweep(base, axes, workers=1))

    def test_cache_hits_served_in_process(self, tmp_path):
        sweep(ExperimentSpec(**SMALL), self.AXES, tag="p",
              cache_dir=str(tmp_path), workers=2)
        again = sweep(ExperimentSpec(**SMALL), self.AXES, tag="p",
                      cache_dir=str(tmp_path), workers=2)
        assert again.cache_hits == 3 and again.cache_misses == 0

    def test_workers_env_default(self, monkeypatch):
        from repro_torch.sweep import WORKERS_ENV, _resolve_workers
        assert WORKERS_ENV == repro.WORKERS_ENV
        monkeypatch.setenv(WORKERS_ENV, "4")
        assert _resolve_workers(None) == 4
        monkeypatch.delenv(WORKERS_ENV)
        assert _resolve_workers(None) == 1
        assert _resolve_workers(0) == 1

    def test_worker_failure_propagates(self, tmp_path):
        # unknown replay path fails inside the pool, not silently
        bad = ExperimentSpec(**SMALL, backend="replay",
                             replay_path=str(tmp_path / "missing.json"))
        with pytest.raises(Exception):
            sweep(bad, {"max_batch": [4, 8]}, cache_dir=str(tmp_path),
                  workers=2)


class TestAtomicCacheWrites:
    def test_cache_file_is_complete_json(self, tmp_path):
        spec = ExperimentSpec(**SMALL)
        run_spec(spec, cache_dir=str(tmp_path))
        entries = [p for p in os.listdir(tmp_path)
                   if p.endswith(".json")]
        assert entries == [spec.spec_hash() + ".json"]
        with open(tmp_path / entries[0]) as f:
            blob = json.load(f)          # parses => not truncated
        assert blob["spec"] == spec.to_dict()
        assert not [p for p in os.listdir(tmp_path)
                    if p.endswith(".tmp")]

    def test_interrupted_write_leaves_no_entry(self, tmp_path,
                                               monkeypatch):
        spec = ExperimentSpec(**SMALL)

        def boom(blob, f, **kw):
            f.write('{"version": "x", "spec"')   # simulate a crash
            raise KeyboardInterrupt

        monkeypatch.setattr(SW.json, "dump", boom)
        with pytest.raises(KeyboardInterrupt):
            run_spec(spec, cache_dir=str(tmp_path))
        monkeypatch.undo()
        assert os.listdir(tmp_path) == []
        _, hit = run_spec(spec, cache_dir=str(tmp_path))
        assert not hit
        _, hit = run_spec(spec, cache_dir=str(tmp_path))
        assert hit


class TestClaims:
    def test_ratio_claim(self):
        rs = _fake({"naive": 1.0, "shaped": 0.05})
        c = Claim("x", ratio_of=("naive", "shaped"), threshold=10.0)
        out = c.evaluate(rs)
        assert out.passed and out.value == pytest.approx(20.0)

    def test_glob_aggregation(self):
        rs = _fake({"naive": 1.0, "shaped/a": 0.5, "shaped/b": 0.1})
        best = Claim("x", ratio_of=("naive", "shaped/*"), agg_den="min",
                     threshold=10.0)
        assert best.evaluate(rs).value == pytest.approx(10.0)
        worst = Claim("x", ratio_of=("naive", "shaped/*"), agg_den="max",
                      threshold=10.0)
        assert worst.evaluate(rs).value == pytest.approx(2.0)
        assert not worst.evaluate(rs).passed

    def test_select_unknown_label(self):
        with pytest.raises(KeyError):
            select(_fake({"a": 1.0}), "missing-*")

    def test_range_op(self):
        rs = _fake({"a": 0.12})
        assert Claim("x", value_of="a", op="range",
                     threshold=(0.04, 0.4)).evaluate(rs).passed
        assert not Claim("x", value_of="a", op="range",
                         threshold=(0.2, 0.4)).evaluate(rs).passed

    def test_where_guard(self):
        rs = _fake({"a": 1.0, "b": 0.1})
        c = Claim("x", ratio_of=("a", "b"), threshold=5.0,
                  where=lambda r: False)
        assert not c.evaluate(rs).passed

    def test_value_fn_and_dotted_metric(self):
        rs = _fake({"a": 1.0})
        c = Claim("x", value_fn=lambda r: r["a"].metric(
            "tier_attainment.gold"), op=">", threshold=0.4)
        assert c.evaluate(rs).passed

    def test_exactly_one_source_required(self):
        with pytest.raises(ValueError):
            Claim("x")
        with pytest.raises(ValueError):
            Claim("x", ratio_of=("a", "b"), value_of="a")
        with pytest.raises(ValueError):
            Claim("x", value_of="a", op="~=")

    def test_sweep_evaluates_claims(self, tmp_path):
        res = sweep(ExperimentSpec(**SMALL), {"max_batch": [4, 8]},
                    claims=[Claim("nonempty", value_of="max_batch=4",
                                  metric="n_requests", op=">",
                                  threshold=0.0)],
                    cache_dir=str(tmp_path))
        assert [c.name for c in res.claims] == ["nonempty"]
        assert not res.failed_claims

    def test_claim_verdicts_equal_reference(self):
        base = ExperimentSpec(**SMALL)
        axes = {"max_batch": [1, 8]}
        claims = dict(name="batching", ratio_of=("max_batch=1",
                                                 "max_batch=*"),
                      agg_den="min", threshold=1.0)
        got = sweep(base, axes, cache=False, claims=[Claim(**claims)])
        want = _ref_sweep(base, axes, claims=[repro.Claim(**claims)])
        assert [(c.name, c.value, c.passed) for c in got.claims] \
            == [(c.name, c.value, c.passed) for c in want.claims]

    def test_merge_rejects_duplicate_labels(self, tmp_path):
        a = sweep(ExperimentSpec(**SMALL), None, tag="one",
                  cache_dir=str(tmp_path))
        with pytest.raises(ValueError):
            a.merge(a)
        b = sweep(ExperimentSpec(**SMALL), None, tag="two",
                  cache_dir=str(tmp_path))
        assert set(a.merge(b).results) == {"one", "two"}
