"""Workflow DAGs: multi-request *tasks* over the serving simulator.
The port's own copy of ``repro.workflows.graph``.

A :class:`Workflow` is a DAG of :class:`WorkflowStep` nodes.  Each step
materializes one :class:`~repro_torch.serving.requests.Request`; a step's
completion releases its successors onto the arrival clock (via
``Request.release_time``), so orchestration latency — not just model
latency — shows up in the timeline and the energy bill.

Steps that extend a dependency's context verbatim declare
``prefix_of=`` so the KV layer can fork the parent's cache pages
instead of re-prefilling the shared prefix (see
:meth:`repro_torch.batching.kvcache.PagedKVAllocator.fork_prefix`).

:class:`TaskReport` aggregates one served task: end-to-end latency,
attributed energy, Wh/task, Wh/token, and the DAG's critical-path
service time (the latency floor the task graph itself imposes,
queueing excluded).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class WorkflowStep:
    """One node of a task graph; materializes exactly one request.

    ``deps`` are step names that must complete before this step is
    released; ``think_time_s`` is orchestrator latency added between
    the last dependency's completion and this step's release (tool
    execution, retrieval, ranking).  ``prefix_of`` names the single
    dependency whose serving context this step's prompt extends
    token-for-token — the KV layer may then reuse that parent's cache
    pages for the shared prefix.
    """
    name: str
    prompt_len: int
    max_new_tokens: int
    deps: Tuple[str, ...] = ()
    prefix_of: Optional[str] = None
    think_time_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class Workflow:
    """A validated DAG of steps (one task template instance).

    Validation (at construction): non-empty, unique step names, deps
    exist and exclude self-loops, acyclic (Kahn), ``prefix_of`` must be
    one of the step's own deps, and all lengths/delays positive.
    """
    name: str
    steps: Tuple[WorkflowStep, ...]

    def __post_init__(self):
        if isinstance(self.steps, list):
            object.__setattr__(self, "steps", tuple(self.steps))
        if not self.steps:
            raise ValueError(f"workflow {self.name!r} has no steps")
        names = [s.name for s in self.steps]
        dup = {n for n in names if names.count(n) > 1}
        if dup:
            raise ValueError(
                f"workflow {self.name!r}: duplicate step names {sorted(dup)}")
        known = set(names)
        for s in self.steps:
            if s.prompt_len < 1:
                raise ValueError(
                    f"step {s.name!r}: prompt_len must be >= 1, "
                    f"got {s.prompt_len}")
            if s.max_new_tokens < 1:
                raise ValueError(
                    f"step {s.name!r}: max_new_tokens must be >= 1, "
                    f"got {s.max_new_tokens}")
            if s.think_time_s < 0:
                raise ValueError(
                    f"step {s.name!r}: think_time_s must be >= 0, "
                    f"got {s.think_time_s}")
            for d in s.deps:
                if d == s.name:
                    raise ValueError(f"step {s.name!r} depends on itself")
                if d not in known:
                    raise ValueError(
                        f"step {s.name!r}: unknown dep {d!r}")
            if s.prefix_of is not None and s.prefix_of not in s.deps:
                raise ValueError(
                    f"step {s.name!r}: prefix_of={s.prefix_of!r} must "
                    f"be one of its deps {list(s.deps)}")
        object.__setattr__(self, "_topo", tuple(self._kahn()))

    def _kahn(self) -> List[str]:
        indeg = {s.name: len(s.deps) for s in self.steps}
        succ: Dict[str, List[str]] = {s.name: [] for s in self.steps}
        for s in self.steps:
            for d in s.deps:
                succ[d].append(s.name)
        order = [n for n in indeg if indeg[n] == 0]
        i = 0
        while i < len(order):
            for m in succ[order[i]]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    order.append(m)
            i += 1
        if len(order) != len(self.steps):
            cyc = sorted(n for n, d in indeg.items() if d > 0)
            raise ValueError(
                f"workflow {self.name!r} has a cycle through {cyc}")
        return order

    # ------------------------------------------------------------------
    @property
    def topo_order(self) -> Tuple[str, ...]:
        """Step names in one deterministic topological order."""
        return self._topo

    def step(self, name: str) -> WorkflowStep:
        for s in self.steps:
            if s.name == name:
                return s
        raise KeyError(name)

    @property
    def roots(self) -> Tuple[WorkflowStep, ...]:
        return tuple(s for s in self.steps if not s.deps)

    def successors(self) -> Dict[str, Tuple[str, ...]]:
        succ: Dict[str, List[str]] = {s.name: [] for s in self.steps}
        for s in self.steps:
            for d in s.deps:
                succ[d].append(s.name)
        return {k: tuple(v) for k, v in succ.items()}

    @property
    def total_prompt_tokens(self) -> int:
        return sum(s.prompt_len for s in self.steps)

    @property
    def total_new_tokens(self) -> int:
        return sum(s.max_new_tokens for s in self.steps)

    def critical_path(self, service_s: Dict[str, float]) -> float:
        """Longest dependency path, weighting each step by its service
        time (``service_s[name]``) plus its think time — the task's
        latency floor with infinite capacity and zero queueing."""
        best: Dict[str, float] = {}
        for name in self._topo:
            s = self.step(name)
            base = max((best[d] for d in s.deps), default=0.0)
            best[name] = base + s.think_time_s \
                + float(service_s.get(name, 0.0))
        return max(best.values())


@dataclasses.dataclass
class TaskReport:
    """One served task (a workflow instance): per-task latency/energy
    aggregation over its step requests."""
    task_id: int
    workflow: str
    n_steps: int
    n_done: int
    completed: bool
    t_start: float                  # first root release
    t_done: float                   # last step completion (-1 if not)
    energy_j: float                 # sum of attributed step energies
    tokens_generated: int
    prompt_tokens: int
    prefix_reused_tokens: int       # prompt tokens served via KV fork
    critical_path_s: float          # DAG latency floor (service+think)

    @property
    def latency_s(self) -> float:
        """End-to-end task latency (queueing + service + think)."""
        if not self.completed:
            return float("nan")
        return self.t_done - self.t_start

    @property
    def energy_wh(self) -> float:
        """Attributed Wh per task."""
        return self.energy_j / 3600.0

    @property
    def energy_per_token_wh(self) -> float:
        """Attributed Wh per generated token within the task."""
        if self.tokens_generated == 0:
            return 0.0
        return self.energy_j / 3600.0 / self.tokens_generated
