"""Executed orchestration on reduced llama-3.1-8b in float32: the port's
ServeEngine/ClusterEngine with ExecutedBackend replicas against the
reference's execute=True engines on the same weights and requests. An
agent_loop workflow with prefix reuse, a 2-replica cluster, a crash with
backoff retries and an MPC controller each give greedy tokens identical
to the reference's and reports, per-request records, task reports and
power traces equal to them (==), and to the same run on the analytic
backend. Also the disaggregated fault of the reference's executed
backend (ROADMAP C6) and the port's refusal of it."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.models import build_model as jax_build_model  # noqa: E402

from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.backend import ExecutedBackend  # noqa: E402

from _torch_orchestration import PKG, fields  # noqa: E402
from _torch_parity import carry_params  # noqa: E402

BUF_LEN = 64
PAGE = 8        # small pages so a workflow child forks its parent's KV


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    cfg = PKG["jax"].llama.reduced()
    jm = jax_build_model(cfg, fmt="float32")
    params = jm.init(jax.random.PRNGKey(3))
    tparams = carry_params(params, tmp_path_factory.mktemp("orch"))
    model = build_model(PKG["torch"].llama.reduced(), fmt="float32",
                        device="cpu")
    return {"jax": (jm, params), "torch": (model, tparams)}


def _engine(P, weights, executed, cfg=None, **kw):
    """An engine priced for ``cfg`` (the reduced config by default)
    that, if ``executed``, runs the reduced model."""
    cfg = cfg or P.llama.reduced()
    kw.setdefault("batch_policy", P.policy.SlotCountPolicy(
        max_batch=4, max_prefill_batch=2))
    if executed:
        model, params = weights[P.name.replace("repro_torch", "torch")
                                .replace("repro", "jax")]
        kw.update(execute=True, model=model, params=params,
                  buf_len=BUF_LEN)
    return P.engine.ServeEngine(cfg, fmt="float32", page_size=PAGE, **kw)


def _requests(P, n=8, rate=60.0):
    cfg = P.llama.reduced()
    return P.arrival.paper_requests(
        n, P.arrival.poisson_arrivals(n, rate, seed=1), seed=2,
        prompt_range=(6, 40), output_range=(2, 12),
        vocab_size=cfg.vocab_size)


def _agent_source(P):
    rng = np.random.default_rng(5)
    wfs = [P.templates.make_workflow(
        "agent_loop", rng, rounds=3, base_prompt=(10, 18), tool_tokens=4,
        round_out=(3, 6)) for _ in range(3)]
    return P.source.WorkflowSource(
        wfs, [0.0, 0.01, 0.02], reuse_prefix=True,
        vocab_size=P.llama.reduced().vocab_size, seed=4)


def _run_workflow(P, weights, executed):
    src = _agent_source(P)
    eng = _engine(P, weights, executed)
    trace = P.trace.PowerTrace()
    rep = eng.run(src.initial(), source=src, trace=trace)
    return rep, trace, eng


def _run_cluster(P, weights, executed):
    eng = [_engine(P, weights, executed) for _ in range(2)]
    cl = P.cluster.ClusterEngine(eng, P.router.make_router("round_robin"))
    trace = P.trace.PowerTrace()
    return cl.run(_requests(P, n=10), trace=trace), trace, cl


def _run_fault(P, weights, executed):
    # the crash lands halfway through the longest request of the same
    # run without faults, so it kills work in flight
    calm = _engine(P, weights, False).run(_requests(P))
    r = max(calm.requests, key=lambda r: r.t_done - r.t_prefill_start)
    eng = _engine(P, weights, executed)
    trace = P.trace.PowerTrace()
    faults = P.schedule.FaultSchedule([dict(
        t=0.5 * (r.t_prefill_start + r.t_done), kind="crash",
        downtime_s=0.05)])
    rep = eng.run(_requests(P), faults=faults,
                  retry=P.faults.make_retry("backoff", backoff_s=0.01),
                  trace=trace)
    P.invariants.check_run_invariants(rep, engines=[eng], trace=trace)
    return rep, trace, eng


def _run_mpc(P, weights, executed):
    # priced at full width: on the reduced config's tiny phases the
    # planner never leaves the top frequency
    eng = _engine(P, weights, executed, cfg=P.llama)
    trace = P.trace.PowerTrace()
    rep = eng.run(_requests(P, rate=200.0),
                  controller=P.controllers.make_controller("mpc"),
                  control_interval_s=0.01, trace=trace)
    return rep, trace, eng


RUNS = {"workflow": _run_workflow, "cluster": _run_cluster,
        "fault": _run_fault, "mpc": _run_mpc}


def _tokens(rep):
    return {r.req_id: list(r.generated) for r in rep.requests
            if r.status.name == "DONE"}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_executed_run_equals_reference(weights, run):
    """Greedy tokens identical to the reference's executed run, and
    every compared field equal to it and to the port's analytic twin."""
    want, want_trace, _ = RUNS[run](PKG["jax"], weights, True)
    got, trace, _ = RUNS[run](PKG["torch"], weights, True)
    twin, twin_trace, _ = RUNS[run](PKG["torch"], weights, False)
    assert fields(got, trace) == fields(want, want_trace)
    assert fields(got, trace) == fields(twin, twin_trace)
    assert _tokens(got) == _tokens(want)
    vocab = PKG["torch"].llama.reduced().vocab_size
    for r in got.requests:
        if r.status.name == "DONE":
            assert len(r.generated) == r.max_new_tokens, r.req_id
            assert all(0 <= t < vocab for t in r.generated)
    assert abs(trace.coverage(got.total_energy_j) - 1.0) <= 1e-9
    if run == "workflow":
        assert got.prefix_reused_tokens > 0
        assert all(t.completed for t in got.tasks)
    if run == "fault":
        assert got.n_failures > 0 and got.n_retries > 0
    if run == "mpc":
        assert got.control["n_control_actions"] >= 1
        assert got.control["mean_freq_scale"] != 1.0


def test_workflow_children_extend_their_parents(weights):
    """Each child's prompt starts with its parent's prompt and greedy
    output; its first-token logits equal its own single-request
    prefill's (a forked prefix is accounting only: the executed prefill
    runs the child's whole prompt)."""
    P = PKG["torch"]
    model, params = weights["torch"]
    src = _agent_source(P)
    backend = ExecutedBackend(P.llama.reduced(), model, params,
                              max_batch=4, buf_len=BUF_LEN,
                              record_logits=True)
    eng = P.engine.ServeEngine(
        P.llama.reduced(), backend=backend, page_size=PAGE,
        batch_policy=P.policy.SlotCountPolicy(max_batch=4,
                                              max_prefill_batch=2))
    rep = eng.run(src.initial(), source=src)
    by_id = {r.req_id: r for r in rep.requests}
    forked = 0
    for r in rep.requests:
        if r.step != "round_0":
            parent = next(p for p in rep.requests
                          if p.task_id == r.task_id
                          and p.step == f"round_{int(r.step[-1]) - 1}")
            ctx = list(parent.prompt) + list(parent.generated)
            assert list(r.prompt[:len(ctx)]) == ctx, r.req_id
            forked += r.kv_parent is not None
        toks = torch.as_tensor(r.prompt[None, :], dtype=torch.long)
        logits, _ = model.prefill(params, {"tokens": toks},
                                  buf_len=BUF_LEN)
        torch.testing.assert_close(backend.first_logits[r.req_id],
                                   logits[0].float(), rtol=0, atol=1e-5)
    assert forked > 0 and len(by_id) == 9


def _disaggregated(P, weights):
    eng = [_engine(P, weights, True, pool=pool)
           for pool in ("prefill", "decode")]
    cl = P.cluster.ClusterEngine(eng, P.router.make_router("round_robin"))
    return cl.run(_requests(P, n=4))


def test_reference_executed_disaggregated_fleet_decodes_foreign_state(
        weights):
    """ROADMAP C6: the reference's decode replica never receives the
    prefill replica's KV cache or first token, so past the first token
    its greedy output is not the request's own (a mixed engine's)."""
    P = PKG["jax"]
    split = _disaggregated(P, weights)
    mixed = _engine(P, weights, True).run(_requests(P, n=4))
    got, want = _tokens(split), _tokens(mixed)
    assert got.keys() == want.keys()
    assert all(got[i][0] == want[i][0] for i in want)
    assert any(got[i][1:] != want[i][1:] for i in want)


def test_port_refuses_an_executed_disaggregated_fleet(weights):
    P = PKG["torch"]
    for pool in ("prefill", "decode"):
        with pytest.raises(ValueError, match="C6"):
            _engine(P, weights, True, pool=pool)
        model, params = weights["torch"]
        backend = ExecutedBackend(P.llama.reduced(), model, params,
                                  max_batch=4, buf_len=BUF_LEN)
        with pytest.raises(ValueError, match="KV handoff"):
            P.engine.ServeEngine(P.llama.reduced(), backend=backend,
                                 pool=pool)
    # the analytic disaggregated fleet runs
    eng = [_engine(P, weights, False, pool=pool)
           for pool in ("prefill", "decode")]
    rep = P.cluster.ClusterEngine(eng).run(_requests(P, n=4))
    assert rep.n_handoffs == 4 and rep.n_completed == 4
