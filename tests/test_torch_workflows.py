"""The port's workflow layer (repro_torch.workflows: the task DAG, the
templates and WorkflowSource) against the JAX package's, float for
float (==): graph validation raises the same exception types, every
template gives equal Workflows from the same rng, and WorkflowSource on
one engine (both modes, prefix reuse on and off) and on a cluster gives
equal reports, per-request records, power traces and task reports."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_orchestration import PKG, both, fields  # noqa: E402

TEMPLATES = ("rag_chain", "agent_loop", "fan_out", "speculative")

# (name, steps) of graphs both packages must refuse; a step is
# (name, deps, prefix_of, prompt_len, max_new_tokens, think_time_s)
BAD_GRAPHS = {
    "empty": (),
    "duplicate": (("a", (), None, 8, 2, 0.0), ("a", (), None, 8, 2, 0.0)),
    "unknown_dep": (("a", ("ghost",), None, 8, 2, 0.0),),
    "self_dep": (("a", ("a",), None, 8, 2, 0.0),),
    "cycle": (("a", ("b",), None, 8, 2, 0.0),
              ("b", ("a",), None, 8, 2, 0.0)),
    "prefix_not_dep": (("a", (), None, 8, 2, 0.0),
                       ("b", (), None, 8, 2, 0.0),
                       ("c", ("a",), "b", 8, 2, 0.0)),
    "zero_prompt": (("a", (), None, 0, 2, 0.0),),
    "zero_output": (("a", (), None, 8, 0, 0.0),),
    "negative_think": (("a", (), None, 8, 2, -0.1),),
}


def _graph(P, steps):
    g = P.graph
    return g.Workflow(name="w", steps=tuple(
        g.WorkflowStep(n, prompt_len=pl, max_new_tokens=out, deps=deps,
                       prefix_of=pre, think_time_s=think)
        for n, deps, pre, pl, out, think in steps))


def _raised(P, steps):
    try:
        _graph(P, steps)
    except Exception as e:      # noqa: BLE001 - the type is compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", sorted(BAD_GRAPHS))
def test_graph_validation_raises_as_the_reference(case):
    want, got = both(_raised, BAD_GRAPHS[case])
    assert want is not None and got == want


def _wf_fields(wf):
    return (wf.name, [dataclasses.astuple(s) for s in wf.steps],
            wf.topo_order, [s.name for s in wf.roots], wf.successors(),
            wf.total_prompt_tokens, wf.total_new_tokens,
            wf.critical_path({s.name: 0.1 * i
                              for i, s in enumerate(wf.steps)}))


def _template_draws(P, name, seed):
    rng = np.random.default_rng(seed)
    wfs = [P.templates.make_workflow(name, rng) for _ in range(4)]
    return [_wf_fields(wf) for wf in wfs], float(rng.random())


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", TEMPLATES)
def test_templates_draw_equal_workflows(name, seed):
    want, got = both(_template_draws, name, seed)
    assert got == want
    assert sorted(PKG["torch"].templates.WORKFLOW_TEMPLATES) == \
        sorted(PKG["jax"].templates.WORKFLOW_TEMPLATES)


def _template_error(P, name, params):
    try:
        P.templates.make_workflow(name, np.random.default_rng(0), **params)
    except Exception as e:      # noqa: BLE001 - the type is compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("name,params", [
    ("nope", {}), ("agent_loop", {"bogus": 1}), ("agent_loop",
                                                 {"rounds": 0}),
    ("fan_out", {"n": 0}), ("speculative", {"acceptance": 1.5})])
def test_template_errors_as_the_reference(name, params):
    want, got = both(_template_error, name, params)
    assert want is not None and got == want


def _source(P, template, n=5, seed=0, rate=3.0, reuse=True, vocab=None,
            **params):
    rng = np.random.default_rng(seed)
    wfs = [P.templates.make_workflow(template, rng, **params)
           for _ in range(n)]
    arr = [float(t) for t in P.arrival.poisson_arrivals(n, rate,
                                                        seed=seed)]
    return P.source.WorkflowSource(wfs, arr, reuse_prefix=reuse,
                                   vocab_size=vocab, seed=seed)


def _serve(P, template, mode, reuse, macro_step, policy="slot_count"):
    src = _source(P, template, reuse=reuse, vocab=1000)
    kw = {}
    if mode == "continuous":
        kw["batch_policy"] = P.policy.make_batch_policy(
            policy, max_batch=8, max_prefill_batch=4,
            **({"chunk_tokens": 512} if policy == "chunked_prefill"
               else {}))
    eng = P.engine.ServeEngine(P.llama, mode=mode, page_size=64,
                               macro_step=macro_step, **kw)
    trace = P.trace.PowerTrace()
    rep = eng.run(src.initial(), source=src, trace=trace)
    prompts = [r.prompt.tolist() for r in rep.requests]
    return fields(rep, trace), prompts, src.n_unreleased(), \
        eng.batcher.kv.free_pages if mode == "continuous" else None


@pytest.mark.parametrize("macro_step", [True, False])
@pytest.mark.parametrize("reuse", [True, False])
@pytest.mark.parametrize("mode", ["continuous", "sequential"])
@pytest.mark.parametrize("template", TEMPLATES)
def test_source_on_one_engine_equals_reference(template, mode, reuse,
                                               macro_step):
    want, got = both(_serve, template, mode, reuse, macro_step)
    assert got == want
    rep = want[0][0]
    assert all(t[4] for t in rep[6]), "every task completes"


def test_source_with_chunked_prefill_and_scheduler_equals_reference():
    def run(P):
        src = _source(P, "agent_loop", n=6, seed=3, rate=4.0)
        eng = P.engine.ServeEngine(
            P.llama, page_size=64,
            batch_policy=P.policy.make_batch_policy(
                "chunked_prefill", max_batch=8, max_prefill_batch=4,
                chunk_tokens=512))
        trace = P.trace.PowerTrace()
        rep = eng.run(src.initial(), source=src, trace=trace,
                      scheduler=P.scheduler.make_scheduler(
                          "window", window_s=0.2))
        return fields(rep, trace)
    want, got = both(run)
    assert got == want
    assert want[0][0]["prefix_reused_tokens"] > 0


def _cluster(P, template, policy, reuse):
    src = _source(P, template, n=6, seed=1, rate=5.0, reuse=reuse)
    cl = P.cluster.make_cluster(P.llama, 3, policy=policy, max_batch=8,
                                max_prefill_batch=4, page_size=64)
    trace = P.trace.PowerTrace()
    rep = cl.run(src.initial(), source=src, trace=trace)
    affinity = [(r.req_id, src.route_affinity(r)) for r in rep.requests]
    return fields(rep, trace), affinity, \
        [e.batcher.kv.free_pages for e in cl.replicas]


@pytest.mark.parametrize("reuse", [True, False])
@pytest.mark.parametrize("policy", ["round_robin", "least_loaded",
                                    "energy_aware"])
@pytest.mark.parametrize("template", ["agent_loop", "fan_out"])
def test_source_on_a_cluster_equals_reference(template, policy, reuse):
    want, got = both(_cluster, template, policy, reuse)
    assert got == want


def test_source_on_a_disaggregated_cluster_equals_reference():
    def run(P):
        src = _source(P, "rag_chain", n=4, seed=2)
        eng = [P.engine.ServeEngine(
            P.llama, pool=pool, page_size=64,
            batch_policy=P.policy.SlotCountPolicy(max_batch=8,
                                                  max_prefill_batch=4))
            for pool in ("prefill", "prefill", "decode")]
        cl = P.cluster.ClusterEngine(eng, P.router.make_router(
            "least_loaded"))
        trace = P.trace.PowerTrace()
        rep = cl.run(src.initial(), source=src, trace=trace)
        return fields(rep, trace)
    want, got = both(run)
    assert got == want
    assert want[0][0]["n_handoffs"] > 0


def test_source_protocol_equals_reference():
    """bind/on_finish/on_shed/route_affinity driven by hand."""
    def run(P):
        src = _source(P, "agent_loop", n=3, seed=5, vocab=500)
        src.bind(page_size=16)
        out = []
        roots = src.initial()
        out.append([(r.req_id, r.prompt.tolist()) for r in roots])
        r0 = roots[0]
        r0.generated = list(range(r0.max_new_tokens))
        r0.tokens_generated = r0.max_new_tokens
        r0.t_prefill_start = 0.1
        kids = src.on_finish(r0, 1.5, replica=2)
        out.append([(k.req_id, k.release_time, k.kv_parent,
                     k.prefilled_tokens, k.prompt.tolist(),
                     src.route_affinity(k)) for k in kids])
        src.on_shed(roots[1])
        out.append(src.n_unreleased())
        out.append([dataclasses.astuple(t) for t in src.task_reports()])
        return out
    want, got = both(run)
    assert got == want
