"""WorkflowSource: interleaves task graphs into an arrival stream.
The port's own copy of ``repro.workflows.source``.

The source materializes every step of every task up front (one
:class:`~repro_torch.serving.requests.Request` per step, deterministic ids),
hands the engine the root steps via :meth:`initial`, and is called
back on every completion (:meth:`on_finish`): steps whose dependencies
are all done are *released* onto the arrival clock at

    ``max(dep completion times) + think_time_s``

via ``Request.release_time`` — exactly the mechanism shaped schedulers
already use, so completion-triggered release composes with every
scheduler, batch policy, router, and backend.

Prefix reuse: a step with ``prefix_of=`` is released carrying
``kv_parent`` (the parent's req id) and ``prefilled_tokens`` (the
page-aligned shared prefix).  The batcher then forks the parent's KV
pages instead of re-prefilling (see ``ContinuousBatcher._take``), and
the engine bills only the remainder as a chunked prefill.  Parents
carry ``kv_pin`` so their pages outlive request completion until every
child has forked.  Reuse is disabled (pins cleared) in sequential mode
(no KV slots) and on disaggregated fleets (a child's prefill pool
never holds the parent's decode-side KV).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.serving.requests import Request
from .graph import TaskReport, Workflow


class _Task:
    """Mutable serving state for one workflow instance."""

    __slots__ = ("wf", "arrival", "reqs", "indeg", "succ", "done_t",
                 "service", "n_done", "aborted", "reused")

    def __init__(self, wf: Workflow, arrival: float):
        self.wf = wf
        self.arrival = arrival
        self.reqs: Dict[str, Request] = {}
        self.indeg = {s.name: len(s.deps) for s in wf.steps}
        self.succ = wf.successors()
        self.done_t: Dict[str, float] = {}
        self.service: Dict[str, float] = {}
        self.n_done = 0
        self.aborted = False
        self.reused = 0


class WorkflowSource:
    """Feeds dependent-request DAGs to a serving engine or cluster.

    One source instance drives one run (requests are mutated by the
    engine); build a fresh source per run.
    """

    def __init__(self, workflows: List[Workflow],
                 arrival_times: List[float], *,
                 start_req_id: int = 0, reuse_prefix: bool = True,
                 vocab_size: Optional[int] = None, seed: int = 0):
        if len(workflows) != len(arrival_times):
            raise ValueError(
                f"{len(workflows)} workflows vs "
                f"{len(arrival_times)} arrival times")
        self._vocab = vocab_size
        self._rng = np.random.default_rng(seed)
        self._reuse_requested = bool(reuse_prefix)
        self._reuse = self._reuse_requested
        self._page_size = 128
        self._kv_get: Optional[Callable] = None
        self._replica_of: Dict[int, int] = {}
        self._by_req_id: Dict[int, Request] = {}
        self._tasks: List[_Task] = []
        self._n_unreleased = 0
        rid = start_req_id
        for j, (wf, t0) in enumerate(zip(workflows, arrival_times)):
            task = _Task(wf, float(t0))
            for name in wf.topo_order:
                step = wf.step(name)
                r = Request(req_id=rid, prompt=None,
                            prompt_len=step.prompt_len,
                            max_new_tokens=step.max_new_tokens,
                            arrival_time=float(t0),
                            task_id=j, step=name)
                rid += 1
                task.reqs[name] = r
                self._by_req_id[r.req_id] = r
                if step.deps:
                    self._n_unreleased += 1
            # parents carry a pin per prefix child so their KV pages
            # survive completion until every child has forked
            for step in wf.steps:
                if step.prefix_of is not None:
                    task.reqs[step.prefix_of].kv_pin += 1
            for root in wf.roots:
                self._materialize_prompt(task.reqs[root.name], None)
            self._tasks.append(task)
        self.next_req_id = rid

    # -- engine protocol ----------------------------------------------
    def bind(self, *, sequential: bool = False,
             disaggregated: bool = False, page_size: int = 128,
             kv_get: Optional[Callable] = None) -> None:
        """Called by the engine/cluster before serving starts.
        ``kv_get(replica) -> PagedKVAllocator`` lets the source release
        a parent pin when page alignment leaves nothing to reuse."""
        self._page_size = int(page_size)
        self._kv_get = kv_get
        self._reuse = (self._reuse_requested
                       and not sequential and not disaggregated)
        if not self._reuse:
            for task in self._tasks:
                for r in task.reqs.values():
                    r.kv_pin = 0

    def initial(self) -> List[Request]:
        """Root-step requests of every task, in arrival order — the
        request list handed to ``run()``."""
        roots = [task.reqs[s.name]
                 for task in self._tasks for s in task.wf.roots]
        roots.sort(key=lambda r: (r.effective_arrival, r.req_id))
        return roots

    def on_shed(self, req: Request) -> None:
        """A step terminally left the run — shed by an admission
        scheduler, or failed by a fault with retries exhausted. Root
        or mid-DAG, the task can never complete: abort it (descendants
        are never released), drop surviving siblings' pins, and free
        any KV pages completed parents kept pinned for forks that will
        now never come."""
        if req.task_id is None:
            return
        task = self._tasks[req.task_id]
        if not task.aborted:
            task.aborted = True
            for name, r in task.reqs.items():
                if name in task.done_t:
                    # a completed parent may hold lingering pinned KV
                    # for prefix forks; no child will consume it now
                    self._unpin_all(r)
                    continue
                r.kv_pin = 0
                if task.indeg[name] > 0:
                    self._n_unreleased -= 1

    def on_finish(self, req: Request, t_done: float,
                  replica: int = 0) -> List[Request]:
        """Report a completion; returns the newly released successor
        requests (sorted by release time)."""
        if req.task_id is None or req.step is None:
            return []
        task = self._tasks[req.task_id]
        task.done_t[req.step] = float(t_done)
        if req.t_prefill_start >= 0:
            task.service[req.step] = float(t_done - req.t_prefill_start)
        task.n_done += 1
        self._replica_of[req.req_id] = replica
        if task.aborted:
            # a sibling still in flight when the task aborted: its
            # pinned KV will never be forked
            self._unpin_all(req)
            return []
        released: List[Request] = []
        for child_name in task.succ[req.step]:
            task.indeg[child_name] -= 1
            if task.indeg[child_name] > 0 or task.aborted:
                continue
            released.append(self._release(task, child_name))
            self._n_unreleased -= 1
        released.sort(key=lambda r: (r.effective_arrival, r.req_id))
        return released

    def _release(self, task: _Task, name: str) -> Request:
        step = task.wf.step(name)
        child = task.reqs[name]
        t_rel = max(task.done_t[d] for d in step.deps) \
            + step.think_time_s
        child.release_time = t_rel
        child.arrival_time = t_rel      # latency counts from release
        parent = (task.reqs[step.prefix_of]
                  if step.prefix_of is not None else None)
        if parent is not None and self._reuse:
            ps = self._page_size
            parent_kv = parent.prompt_len + parent.tokens_generated - 1
            share = min(parent_kv // ps,
                        (child.prompt_len - 1) // ps) * ps
            if share > 0:
                child.kv_parent = parent.req_id
                child.prefilled_tokens = share
                task.reused += share
            else:
                # nothing page-aligned to fork: consume the pin now so
                # the parent's pages do not linger
                self._unpin(parent)
        self._materialize_prompt(child, parent)
        return child

    def _unpin(self, parent: Request) -> None:
        if self._kv_get is None:
            return
        kv = self._kv_get(self._replica_of.get(parent.req_id, 0))
        kv.unpin(parent.req_id)

    def _unpin_all(self, parent: Request) -> None:
        """Drop every outstanding fork reservation a (completed)
        parent still holds — its task aborted, so the forks will
        never happen."""
        if self._kv_get is None:
            return
        kv = self._kv_get(self._replica_of.get(parent.req_id, 0))
        kv.unpin_all(parent.req_id)

    def _materialize_prompt(self, req: Request,
                            parent: Optional[Request]) -> None:
        """Real token ids for executed backends (``vocab_size`` set):
        a child's prompt extends the parent's prompt + generation, the
        remainder is fresh random tokens."""
        if self._vocab is None:
            return
        if parent is not None and parent.prompt is not None:
            ctx = np.concatenate([
                np.asarray(parent.prompt, dtype=np.int32),
                np.asarray(parent.generated, dtype=np.int32)])
            ctx = ctx[:req.prompt_len]
        else:
            ctx = np.empty((0,), np.int32)
        fill = req.prompt_len - len(ctx)
        if fill > 0:
            ctx = np.concatenate([
                ctx, self._rng.integers(0, self._vocab, fill)
                .astype(np.int32)])
        req.prompt = ctx.astype(np.int32)

    # -- cluster routing ----------------------------------------------
    def route_affinity(self, req: Request) -> Optional[int]:
        """Replica that holds this request's forked parent KV, or None
        when the router is free to choose."""
        if req.kv_parent is None:
            return None
        return self._replica_of.get(req.kv_parent)

    def n_unreleased(self) -> int:
        """Dependent steps not yet released (live tasks only)."""
        return self._n_unreleased

    # -- reporting -----------------------------------------------------
    def task_reports(self) -> List[TaskReport]:
        out = []
        for j, task in enumerate(self._tasks):
            n_steps = len(task.wf.steps)
            completed = (not task.aborted) and task.n_done == n_steps
            reqs = list(task.reqs.values())
            out.append(TaskReport(
                task_id=j, workflow=task.wf.name, n_steps=n_steps,
                n_done=task.n_done, completed=completed,
                t_start=task.arrival,
                t_done=(max(task.done_t.values()) if completed
                        else -1.0),
                energy_j=float(sum(r.energy_j for r in reqs)),
                tokens_generated=sum(r.tokens_generated for r in reqs),
                prompt_tokens=sum(r.prompt_len for r in reqs),
                prefix_reused_tokens=task.reused,
                critical_path_s=task.wf.critical_path(task.service)))
        return out
