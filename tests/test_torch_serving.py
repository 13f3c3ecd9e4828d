"""The port's serving path (repro_torch.serving, repro_torch.batching)
against the JAX ServeEngine(execute=True) on the same weights: the twin
of tests/test_serving.py's execute-mode tests."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.batching.policy import SlotCountPolicy  # noqa: E402
from repro.configs.paper_zoo import PAPER_MODELS  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServeEngine as JaxServeEngine  # noqa: E402

from repro_torch.batching.continuous import (  # noqa: E402
    CACHE_BATCH_AXIS, evict_cache_slot, insert_cache_slot)
from repro_torch.batching.policy import (  # noqa: E402
    SlotCountPolicy as PtSlotCountPolicy)
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import Request, RequestStatus, ServeEngine  # noqa: E402,E501

from _torch_parity import carry_params  # noqa: E402

CFG = PAPER_MODELS["llama-3.1-8b"].reduced()


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jm = jax_build_model(CFG, fmt="float32")
    params = jm.init(jax.random.PRNGKey(0))
    return jm, params, carry_params(params, tmp_path_factory.mktemp("w"))


def _prompts(seed=0, n=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, rng.integers(4, 12))
            .astype(np.int32) for _ in range(n)]


def _engine(tm, tparams, buf_len, mode="continuous", **policy):
    return ServeEngine(tm.cfg, mode=mode, execute=True, model=tm,
                       params=tparams, buf_len=buf_len,
                       batch_policy=PtSlotCountPolicy(**policy))


def _reqs(cls, prompts, new=(5, 3, 7, 5, 1, 6)):
    return [cls(req_id=i, prompt=p, prompt_len=len(p),
                max_new_tokens=new[i], arrival_time=0.0)
            for i, p in enumerate(prompts)]


@pytest.mark.parametrize("mode", ["continuous", "sequential"])
def test_tokens_match_jax_engine(weights, mode):
    """float32, max_batch=4, max_prefill_batch=2, buf_len=32, 6 requests
    of mixed lengths: every request gets the JAX engine's tokens."""
    jm, jparams, tparams = weights
    prompts = _prompts()
    jreqs = _reqs(JaxRequest, prompts)
    rep = JaxServeEngine(CFG, mode=mode, execute=True, model=jm,
                         params=jparams, buf_len=32,
                         batch_policy=SlotCountPolicy(max_batch=4,
                                                      max_prefill_batch=2)
                         ).run(jreqs)
    treqs = _reqs(Request, prompts)
    tm = build_model(CFG, fmt="float32", device="cpu")
    eng = _engine(tm, tparams, 32, mode, max_batch=4, max_prefill_batch=2)
    report = eng.run(treqs)
    assert len(report.requests) == len(treqs)
    assert all(a is b for a, b in zip(report.requests, treqs))
    for a, b in zip(treqs, jreqs):
        assert a.generated == b.generated, f"req {a.req_id}"
        assert len(a.generated) == a.max_new_tokens
        assert a.status is RequestStatus.DONE
        assert a.tokens_generated == a.max_new_tokens
    if mode == "continuous":
        # the same schedule: as many prefill phases and decode steps
        kinds = [p.phase for p in eng.backend.phases]
        assert kinds.count("prefill") == rep.n_prefill_batches
        assert kinds.count("decode") == rep.n_decode_steps
        assert all(p.latency_s >= 0 and p.wall_s >= 0
                   for p in eng.backend.phases)


def test_prefill_groups_by_length_bucket(weights):
    """SlotCountPolicy's bucket grouping: a 200-token prompt does not
    share a prefill phase with 10-token ones."""
    _, _, tparams = weights
    rng = np.random.default_rng(1)
    lens = [10, 200, 12, 9]
    prompts = [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
               for n in lens]
    reqs = _reqs(Request, prompts, new=(2, 2, 2, 2))
    tm = build_model(CFG, fmt="float32", device="cpu")
    eng = _engine(tm, tparams, 256, max_batch=4, max_prefill_batch=4)
    eng.run(reqs)
    prefills = [p for p in eng.backend.phases if p.phase == "prefill"]
    assert [p.batch for p in prefills] == [3.0, 1.0]


def test_continuous_matches_sequential_logits(weights):
    """record_logits: each request's batched prefill logits equal its own
    sequential prefill (f32, 1e-5)."""
    _, _, tparams = weights
    tm = build_model(CFG, fmt="float32", device="cpu")
    kw = dict(n=5, max_batch=2, max_prefill_batch=2, buf_len=64,
              record_logits=True, model=tm, params=tparams)
    con = serve(mode="continuous", **kw)
    seq = serve(mode="sequential", **kw)
    for a, b in zip(con.requests, seq.requests):
        assert a.generated == b.generated
        np.testing.assert_allclose(
            con.engine.backend.first_logits[a.req_id].numpy(),
            seq.engine.backend.first_logits[b.req_id].numpy(),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_insert_and_evict_leave_other_lanes(kv_quant):
    tm = build_model(CFG, fmt="float32", kv_quant=kv_quant, device="cpu")
    cache = tm.init_cache(4, 16)
    gen = torch.Generator().manual_seed(0)
    for key, val in cache.items():
        if val.is_floating_point():
            val.copy_(torch.randn(val.shape, generator=gen))
        else:
            val.copy_(torch.randint(-5, 5, val.shape, generator=gen))
    # a prefill cache of 2 rows, every value 7
    pcache = {k: torch.full_like(torch.narrow(v, CACHE_BATCH_AXIS[k], 0, 2),
                                 7)
              for k, v in cache.items()}
    before = {k: v.clone() for k, v in cache.items()}
    insert_cache_slot(cache, pcache, row=1, slot=2)
    for key, val in cache.items():
        ax = CACHE_BATCH_AXIS[key]
        assert torch.all(torch.select(val, ax, 2) == 7), key
        for lane in (0, 1, 3):
            assert torch.equal(torch.select(val, ax, lane),
                               torch.select(before[key], ax, lane)), key
    snap = {k: v.clone() for k, v in cache.items()}
    evict_cache_slot(cache, 2)
    for key, val in cache.items():
        ax = CACHE_BATCH_AXIS[key]
        assert torch.all(torch.select(val, ax, 2) == 0), key
        for lane in (0, 1, 3):
            assert torch.equal(torch.select(val, ax, lane),
                               torch.select(snap[key], ax, lane)), key


def test_kv_quant_serves_prefills_smaller_than_max_batch(weights):
    """ROADMAP C1's case, which the reference's engine refuses: an int8
    KV cache with prefill batches (2) smaller than max_batch (4). Every
    request gets its tokens, and the report's energy and time fields are
    finite and positive."""
    _, _, tparams = weights
    tm = build_model(CFG, fmt="float32", kv_quant=True, device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, CFG.vocab_size, 8).astype(np.int32)
               for _ in range(4)]
    reqs = _reqs(Request, prompts, new=(3, 4, 2, 5))
    report = _engine(tm, tparams, 32, max_batch=4,
                     max_prefill_batch=2).run(reqs)
    assert [len(r.generated) for r in reqs] == [3, 4, 2, 5]
    assert report.n_prefill_batches == 2
    for value in (report.total_energy_j, report.busy_energy_j,
                  report.wall_time_s, report.busy_time_s,
                  report.mean_energy_per_token_wh,
                  *(r.energy_j for r in reqs)):
        assert np.isfinite(value) and value > 0


def test_engine_rejects_bad_arguments(weights):
    _, _, tparams = weights
    tm = build_model(CFG, fmt="float32", device="cpu")
    with pytest.raises(ValueError):
        _engine(tm, tparams, 32, mode="static")
    with pytest.raises(ValueError):
        _engine(tm, tparams, 32, max_batch=0)
