"""Shared pieces of the orchestration parity tests: both packages'
router, cluster, workflow, fault, control, fleet, API and sweep modules
side by side (``PKG["jax"]``, ``PKG["torch"]``), and the report fields
those tests compare with ``==``."""
import dataclasses
import importlib
from types import SimpleNamespace

_MODULES = {
    "engine": "serving.engine", "cluster": "serving.cluster",
    "router": "serving.router", "arrival": "serving.arrival",
    "requests": "serving.requests", "scheduler": "serving.scheduler",
    "trace": "serving.trace", "backend": "serving.backend",
    "policy": "batching.policy", "workflows": "workflows",
    "templates": "workflows.templates", "graph": "workflows.graph",
    "source": "workflows.source", "faults": "faults",
    "schedule": "faults.schedule", "invariants": "faults.invariants",
    "control": "control", "view": "control.view",
    "controllers": "control.controllers", "hook": "control.hook",
    "autoscale": "fleet.autoscale", "regions": "fleet.regions",
    "fleet_engine": "fleet.engine", "api": "api", "sweep": "sweep",
    "zoo": "configs.paper_zoo",
}


def _package(root):
    ns = SimpleNamespace(**{k: importlib.import_module(f"{root}.{m}")
                            for k, m in _MODULES.items()})
    ns.name = root
    ns.llama = ns.zoo.PAPER_MODELS["llama-3.1-8b"]
    return ns


PKG = {"jax": _package("repro"), "torch": _package("repro_torch")}

SERVE_FIELDS = (
    "total_energy_j", "busy_energy_j", "idle_energy_j", "wall_time_s",
    "busy_time_s", "mean_batch", "n_prefill_batches", "n_decode_steps",
    "gated_energy_j", "gated_time_s", "idle_time_s",
    "transition_energy_j", "transition_time_s", "prefill_computed_tokens",
    "prefill_effective_tokens", "prefill_chunks", "n_relayed",
    "prefix_reused_tokens", "n_failures", "n_retries", "wasted_energy_j",
    "down_time_s", "n", "n_shed", "n_completed", "n_failed",
    "availability", "goodput_wh_per_request", "utilization",
    "prefill_padding_fraction", "slo_attainment", "tokens_per_s",
    "mean_energy_per_request_wh", "mean_energy_per_token_wh",
    "mean_latency_s", "mean_ttft_s")

CLUSTER_FIELDS = (
    "policy", "wall_time_s", "handoff_energy_j", "n_handoffs",
    "total_energy_j", "busy_energy_j", "idle_energy_j", "gated_energy_j",
    "n_failures", "n_retries", "wasted_energy_j", "down_time_s",
    "n_failed", "n_completed", "availability", "goodput_wh_per_request",
    "n", "n_shed", "mean_energy_per_request_wh",
    "mean_energy_per_token_wh", "prefix_reused_tokens", "slo_attainment",
    "requests_per_replica", "utilization_per_replica",
    "idle_fraction_per_replica")


def request_fields(r):
    return (r.req_id, r.status.name, r.arrival_time, r.release_time,
            r.t_prefill_start, r.t_first_token, r.t_done, r.energy_j,
            r.wasted_energy_j, r.tokens_generated, r.prefilled_tokens,
            r.n_attempts, r.fail_reason, r.shed_reason, r.hedge_of,
            r.task_id, r.step, r.kv_parent, r.prompt_len,
            r.max_new_tokens)


def control_fields(control):
    """A run's control telemetry without its host wall time."""
    if control is None:
        return None
    return {k: v for k, v in control.items()
            if k != "controller_overhead_s"}


def task_fields(tasks):
    return [dataclasses.astuple(t) + (t.latency_s, t.energy_wh,
                                      t.energy_per_token_wh)
            for t in tasks]


def serve_fields(rep):
    return ({name: getattr(rep, name) for name in SERVE_FIELDS},
            rep.summary(), rep.latency_percentiles(),
            rep.ttft_percentiles(),
            [request_fields(r) for r in rep.requests],
            [request_fields(r) for r in rep.shed],
            task_fields(rep.tasks), control_fields(rep.control))


def cluster_fields(rep):
    return ({name: getattr(rep, name) for name in CLUSTER_FIELDS},
            rep.summary(), rep.per_replica_summary(),
            rep.latency_percentiles(), rep.ttft_percentiles(),
            rep.latency_percentiles_per_replica(),
            [serve_fields(r) for r in rep.replica_reports],
            [request_fields(r) for r in rep.failed],
            [request_fields(r) for r in rep.shed],
            task_fields(rep.tasks), control_fields(rep.control))


def fields(rep, trace=None):
    """Every compared field of a ServeReport or a ClusterReport, with
    its power trace's segments when one was recorded."""
    out = (cluster_fields(rep) if hasattr(rep, "replica_reports")
           else serve_fields(rep))
    return out, (trace.as_dict() if trace is not None else None)


def both(fn, *args, **kw):
    """``fn(P, ...)`` for the reference's package and the port's."""
    return fn(PKG["jax"], *args, **kw), fn(PKG["torch"], *args, **kw)
