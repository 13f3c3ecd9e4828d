"""Built-in task-graph templates (test-time-compute workloads).
The port's own copy of ``repro.workflows.templates``.

Each template is a function ``(rng, **params) -> Workflow`` drawing its
shape deterministically from the supplied ``numpy`` Generator — the
same rng state always yields the same task graph.  Registry:
``WORKFLOW_TEMPLATES``; construct via :func:`make_workflow`, which
validates parameter names the same way the other experiment axes do.

* ``rag_chain``    — retrieve -> synthesize over long grounded prompts
* ``agent_loop``   — N tool-call rounds with monotonically growing
  context (each round extends the previous round's context verbatim,
  so its KV prefix is reusable)
* ``fan_out``      — best-of-N parallel sampling joined by a ranker
* ``speculative``  — draft/verify pairs under an acceptance-rate
  model; the draft model's cheaper forward pass is approximated as
  ``draft_scale`` fewer tokens on the target model
"""
from __future__ import annotations

import inspect
import math
from typing import Callable, Dict, List, Tuple

from .graph import Workflow, WorkflowStep


def _draw(rng, rng_range: Tuple[int, int]) -> int:
    lo, hi = rng_range
    if lo > hi or lo < 1:
        raise ValueError(f"bad token range {rng_range}")
    return int(rng.integers(lo, hi + 1))


def rag_chain(rng, *, n_docs: int = 4,
              doc_tokens: Tuple[int, int] = (192, 512),
              query_tokens: Tuple[int, int] = (24, 96),
              retrieve_out: Tuple[int, int] = (8, 32),
              synth_out: Tuple[int, int] = (96, 256),
              think_time_s: float = 0.05) -> Workflow:
    """Retrieve (short query pass) then synthesize over the query plus
    ``n_docs`` grounded documents; synthesis extends the retrieval
    context, so the query/plan prefix KV is reusable."""
    if n_docs < 1:
        raise ValueError(f"n_docs must be >= 1, got {n_docs}")
    q = _draw(rng, query_tokens)
    r_out = _draw(rng, retrieve_out)
    docs = sum(_draw(rng, doc_tokens) for _ in range(n_docs))
    return Workflow(name="rag_chain", steps=(
        WorkflowStep("retrieve", prompt_len=q, max_new_tokens=r_out),
        WorkflowStep("synthesize", prompt_len=q + r_out + docs,
                     max_new_tokens=_draw(rng, synth_out),
                     deps=("retrieve",), prefix_of="retrieve",
                     think_time_s=think_time_s),
    ))


def agent_loop(rng, *, rounds: int = 4,
               base_prompt: Tuple[int, int] = (1536, 3072),
               tool_tokens: int = 384,
               round_out: Tuple[int, int] = (48, 128),
               think_time_s: float = 0.1) -> Workflow:
    """``rounds`` sequential tool-call rounds: every round's prompt is
    the previous round's full context plus the tool result, so all but
    the new tokens can ride the parent's KV pages."""
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    if tool_tokens < 1:
        raise ValueError(f"tool_tokens must be >= 1, got {tool_tokens}")
    steps: List[WorkflowStep] = []
    prompt = _draw(rng, base_prompt)
    for i in range(rounds):
        out = _draw(rng, round_out)
        steps.append(WorkflowStep(
            f"round_{i}", prompt_len=prompt, max_new_tokens=out,
            deps=(f"round_{i - 1}",) if i else (),
            prefix_of=f"round_{i - 1}" if i else None,
            think_time_s=think_time_s if i else 0.0))
        prompt += out + tool_tokens
    return Workflow(name="agent_loop", steps=tuple(steps))


def fan_out(rng, *, n: int = 4,
            prompt: Tuple[int, int] = (512, 2048),
            sample_out: Tuple[int, int] = (96, 256),
            join_out: Tuple[int, int] = (48, 128),
            think_time_s: float = 0.02) -> Workflow:
    """Best-of-``n``: n parallel samples of one prompt, then a join
    step that reads every candidate and answers.  The join extends
    ``sample_0``'s context, so that branch's KV prefix is reusable."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    p = _draw(rng, prompt)
    outs = [_draw(rng, sample_out) for _ in range(n)]
    steps = [WorkflowStep(f"sample_{i}", prompt_len=p,
                          max_new_tokens=outs[i]) for i in range(n)]
    steps.append(WorkflowStep(
        "join", prompt_len=p + sum(outs),
        max_new_tokens=_draw(rng, join_out),
        deps=tuple(f"sample_{i}" for i in range(n)),
        prefix_of="sample_0", think_time_s=think_time_s))
    return Workflow(name="fan_out", steps=tuple(steps))


def speculative(rng, *, k: int = 4, acceptance: float = 0.7,
                draft_scale: float = 0.25,
                prompt: Tuple[int, int] = (256, 1024),
                target_tokens: int = 128,
                think_time_s: float = 0.0) -> Workflow:
    """Draft/verify round pairs: each round drafts ``k`` tokens (the
    draft model's cheaper pass approximated as ``k * draft_scale``
    tokens on the target model), then one verification pass scores all
    ``k`` at once.  ``max(1, round(k * acceptance)) + 1`` tokens land
    per round (the bonus token is the verifier's own sample); rounds
    repeat until ``target_tokens`` are emitted.  Verification reuses
    the draft's KV; the next draft reuses the verified context with
    rejected tokens dropped."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if not 0.0 <= acceptance <= 1.0:
        raise ValueError(f"acceptance must be in [0, 1], got {acceptance}")
    if not 0.0 < draft_scale <= 1.0:
        raise ValueError(
            f"draft_scale must be in (0, 1], got {draft_scale}")
    if target_tokens < 1:
        raise ValueError(
            f"target_tokens must be >= 1, got {target_tokens}")
    accepted = min(max(1, round(k * acceptance)) + 1, k + 1)
    rounds = math.ceil(target_tokens / accepted)
    draft_out = max(1, round(k * draft_scale))
    ctx = _draw(rng, prompt)
    steps: List[WorkflowStep] = []
    for i in range(rounds):
        steps.append(WorkflowStep(
            f"draft_{i}", prompt_len=ctx, max_new_tokens=draft_out,
            deps=(f"verify_{i - 1}",) if i else (),
            prefix_of=f"verify_{i - 1}" if i else None,
            think_time_s=think_time_s if i else 0.0))
        steps.append(WorkflowStep(
            f"verify_{i}", prompt_len=ctx + k, max_new_tokens=1,
            deps=(f"draft_{i}",), prefix_of=f"draft_{i}"))
        ctx += min(accepted, target_tokens - i * accepted)
    return Workflow(name="speculative", steps=tuple(steps))


WORKFLOW_TEMPLATES: Dict[str, Callable[..., Workflow]] = {
    "rag_chain": rag_chain,
    "agent_loop": agent_loop,
    "fan_out": fan_out,
    "speculative": speculative,
}


def make_workflow(name: str, rng, **params) -> Workflow:
    """Instantiate a template by registry name.

    Unknown template names and unknown parameters raise ``ValueError``
    in the same structured style as the other experiment axes."""
    try:
        fn = WORKFLOW_TEMPLATES[name]
    except KeyError:
        raise ValueError(
            f"unknown workflow template {name!r}; "
            f"known: {list(WORKFLOW_TEMPLATES)}") from None
    known = {p for p in inspect.signature(fn).parameters
             if p != "rng"}
    bad = sorted(set(params) - known)
    if bad:
        raise ValueError(
            f"unknown workflow_params for {name!r}: {bad}; "
            f"known: {sorted(known)}")
    return fn(rng, **params)
