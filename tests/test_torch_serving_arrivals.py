"""Executed serving with arrivals over time, a scheduler and chunked
prefill: the port's ServeEngine(execute=True) on reduced llama-3.1-8b
against the reference ServeEngine(execute=True) on the same weights and
requests. float32: greedy tokens identical and every report, request and
trace field equal (==). int8: the report equal and each request's logits
at every step, teacher-forced on the reference's tokens, within
TEACHER_TOL of the reference's own."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.batching import policy as jax_policy  # noqa: E402
from repro.configs.paper_zoo import PAPER_MODELS as JAX_ZOO  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serving import arrival as jax_arrival  # noqa: E402
from repro.serving import scheduler as jax_sched  # noqa: E402
from repro.serving import trace as jax_trace  # noqa: E402

from repro_torch.batching import policy as pt_policy  # noqa: E402
from repro_torch.configs.paper_zoo import PAPER_MODELS  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402
from repro_torch.serving import arrival as pt_arrival  # noqa: E402
from repro_torch.serving import scheduler as pt_sched  # noqa: E402
from repro_torch.serving import trace as pt_trace  # noqa: E402
from repro_torch.serving.backend import ExecutedBackend  # noqa: E402
from repro_torch.serving.requests import RequestStatus  # noqa: E402

from _torch_parity import carry_params, rel_err  # noqa: E402

CFG = PAPER_MODELS["llama-3.1-8b"].reduced()
JCFG = JAX_ZOO["llama-3.1-8b"].reduced()
BUF_LEN = 64
TEACHER_TOL = 5e-2          # as tests/test_torch_archs.py
PT = (ServeEngine, pt_arrival, pt_sched, pt_policy, pt_trace)
JAX = (JaxServeEngine, jax_arrival, jax_sched, jax_policy, jax_trace)

# (run, arrival pattern, scheduler, batch policy). Reduced llama's
# analytic phases take about 2.6 ms, so the 50 ms pattern serves each
# request alone between idle gaps, and the tighter ones overlap prefills
# with live decodes.
RUNS = {
    "fixed_50ms": (lambda a: a.fixed_arrivals(8, 0.05), None, None),
    "burst_paced": (lambda a: [0.0] * 8,
                    ("paced", {"rate_per_s": 100.0}), None),
    "fixed_5ms_chunked": (lambda a: a.fixed_arrivals(8, 0.005), None,
                          ("chunked_prefill", {"chunk_tokens": 16})),
    "poisson_window": (lambda a: a.poisson_arrivals(8, 200.0, seed=1),
                       ("window", {"window_s": 0.01}), None),
}


def _serve(mods, model, params, run, fmt, backend=None):
    engine, arrival, sched_mod, pol_mod, trace_mod = mods
    times, sched, policy = RUNS[run]
    name, kw = policy or ("slot_count", {})
    cfg = CFG if mods is PT else JCFG
    reqs = arrival.paper_requests(8, times(arrival), seed=2,
                                  prompt_range=(6, 40),
                                  output_range=(2, 12),
                                  vocab_size=cfg.vocab_size)
    eng = engine(cfg, fmt=fmt, execute=True, model=model, params=params,
                 buf_len=BUF_LEN, backend=backend,
                 batch_policy=pol_mod.make_batch_policy(
                     name, max_batch=4, max_prefill_batch=2, **kw))
    trace = trace_mod.PowerTrace()
    rep = eng.run(reqs, scheduler=sched and sched_mod.make_scheduler(
        sched[0], **sched[1]), trace=trace)
    return rep, trace


def _fields(rep, trace):
    return ({f.name: getattr(rep, f.name)
             for f in dataclasses.fields(rep)
             if f.name not in ("requests", "shed", "tasks")},
            rep.summary(),
            [(r.req_id, r.status.name, r.release_time, r.t_prefill_start,
              r.t_first_token, r.t_done, r.energy_j, r.tokens_generated,
              r.prefilled_tokens) for r in rep.requests],
            trace.as_dict())


@pytest.fixture(scope="module")
def f32_weights(tmp_path_factory):
    jm = jax_build_model(JCFG, fmt="float32")
    params = jm.init(jax.random.PRNGKey(3))
    return jm, params, carry_params(params, tmp_path_factory.mktemp("f32"))


@pytest.mark.parametrize("run", sorted(RUNS))
def test_float32_serving_with_arrivals_equals_reference(f32_weights, run):
    jm, jparams, tparams = f32_weights
    want, want_trace = _serve(JAX, jm, jparams, run, "float32")
    model = build_model(CFG, fmt="float32", device="cpu")
    got, trace = _serve(PT, model, tparams, run, "float32")
    assert _fields(got, trace) == _fields(want, want_trace)
    for a, b in zip(got.requests, want.requests):
        assert a.status is RequestStatus.DONE
        assert len(a.generated) == a.max_new_tokens
        assert a.generated == b.generated, a.req_id
    assert abs(trace.coverage(got.total_energy_j) - 1.0) <= 1e-12
    if run == "fixed_5ms_chunked":
        assert got.prefill_chunks > 0
    if run == "fixed_50ms":
        assert got.idle_energy_j > 0
    if run == "burst_paced":
        assert got.requests[-1].release_time > 0


def test_chunked_run_executes_one_prefill_a_request(f32_weights):
    """Under ChunkedPrefillPolicy a prefill phase is a chunk; the model
    runs once a request, on its final chunk."""
    _, _, tparams = f32_weights
    model = build_model(CFG, fmt="float32", device="cpu")
    backend = ExecutedBackend(CFG, model, tparams, max_batch=4,
                              buf_len=BUF_LEN)
    rep, _ = _serve(PT, model, tparams, "fixed_5ms_chunked", "float32",
                    backend=backend)
    executed = [p for p in backend.phases
                if p.phase == "prefill" and p.wall_s is not None]
    assert len(executed) == len(backend.prefill_shapes)
    assert sum(r for r, _ in backend.prefill_shapes) == rep.n
    assert rep.n_prefill_batches == len(executed) + rep.prefill_chunks \
        - sum(1 for r in rep.requests if r.prompt_len > 16)


class Forced(ExecutedBackend):
    """The executed backend fed each request's ``tokens`` (the
    reference's greedy tokens) instead of its own argmax, keeping every
    step's logits."""

    def __init__(self, *args, tokens, **kw):
        self.tokens = tokens
        super().__init__(*args, record_logits=True, **kw)

    def start(self):
        super().start()
        self.step_logits = {}

    def _execute_prefill(self, picks, exec_pad):
        super()._execute_prefill(picks, exec_pad)
        for slot, r in picks:
            r.generated = [self.tokens[r.req_id][0]]
            self.slot_tokens[slot, 0] = r.generated[0]
            self.step_logits[r.req_id] = [self.first_logits[r.req_id]]

    def _execute_decode(self, batch):
        logits, self.cache = self.model.decode_step(
            self.params, self.slot_tokens, self.cache)
        for slot, r in zip(batch.slots, batch.requests):
            self.step_logits[r.req_id].append(logits[slot].float())
            tok = self.tokens[r.req_id][len(r.generated)]
            r.generated.append(tok)
            self.slot_tokens[slot, 0] = tok


def test_int8_serving_teacher_forced(tmp_path):
    """int8, the 5 ms pattern under chunked prefill: the report equals
    the reference's; each request's prefill and decode logits, fed the
    reference's tokens, within TEACHER_TOL of the reference model's own
    on that request alone."""
    jm = jax_build_model(JCFG, fmt="int8")
    jparams = jm.quantize(jm.init(jax.random.PRNGKey(4)))
    want, want_trace = _serve(JAX, jm, jparams, "fixed_5ms_chunked", "int8")
    tparams = carry_params(jparams, tmp_path)
    model = build_model(CFG, fmt="int8", device="cpu")
    backend = Forced(CFG, model, tparams, max_batch=4, buf_len=BUF_LEN,
                     tokens={r.req_id: r.generated for r in want.requests})
    got, trace = _serve(PT, model, tparams, "fixed_5ms_chunked", "int8",
                        backend=backend)
    assert _fields(got, trace) == _fields(want, want_trace)
    prefill = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t},
                                              buf_len=BUF_LEN))
    decode = jax.jit(jm.decode_step)
    for r in want.requests:
        logits, cache = prefill(jparams, jnp.asarray(r.prompt[None, :]))
        ref = [np.asarray(logits[0])]
        for tok in r.generated[:-1]:
            logits, cache = decode(jparams, jnp.asarray([[tok]], jnp.int32),
                                   cache)
            ref.append(np.asarray(logits[0]))
        ours = backend.step_logits[r.req_id]
        assert len(ours) == len(ref) == r.max_new_tokens
        for i, (a, b) in enumerate(zip(ours, ref)):
            assert rel_err(a, b) < TEACHER_TOL, (r.req_id, i)
