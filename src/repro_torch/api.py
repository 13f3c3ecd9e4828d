"""Declarative experiment API: one frozen spec for every axis the stack
supports.

The paper's central claim is that system-level design choices —
precision, batching, serving configuration, arrival shaping — *compose*
into orders-of-magnitude energy differences. :class:`ExperimentSpec`
names every such axis declaratively (model, precision, device, serving
mode, batch limit, scheduler, router, fleet composition, arrival
pattern, workload distribution, seed), round-trips through JSON, and
``spec.run()`` resolves it into the right engine stack:

* ``pipeline="serve"``   — the discrete-event serving simulation
  (:class:`~repro_torch.serving.engine.ServeEngine`, or
  :class:`~repro_torch.serving.cluster.ClusterEngine` when ``replicas > 1``),
* ``pipeline="profile"`` — the analytic phase profiler
  (:class:`~repro_torch.core.profiler.PhaseProfiler`) over a padded static
  batch, for the Fig 1/2 precision and batching studies.

Every run returns a :class:`RunResult` — one flat, JSON-serializable
record subsuming ``ServeReport``/``ClusterReport`` (energy / latency /
TTFT percentiles, Wh/request, SLO attainment, trace coverage) — keyed by
the spec's content hash so results stay comparable across commits.
Sweeping the cartesian product of axes is :func:`repro_torch.sweep.sweep`.

Everything is deterministic under the spec's seeds: re-running a spec
reconstructed from its own JSON yields a byte-identical result record.

The port's own copy of ``repro.api``. An executed spec (``backend=
"executed"`` or ``execute=True``) runs its model on the torch device
named by the run-time keyword ``torch_device=`` of :meth:`ExperimentSpec.run`
and :meth:`ExperimentSpec.build_engine` (``"cuda"`` by default). It is not a
spec field: the record holds analytic fields only, so it and the spec's
hash do not depend on the device. With no CUDA device visible an executed
spec raises unless the caller passes ``torch_device="cpu"``; it never
falls back to the host on its own. The replicas of a spec share one model
and its weights (:func:`executed_params`) per precision format.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.batching.policy import (BATCH_POLICIES, BatchPolicy,
                                   make_batch_policy)
from repro_torch.configs.base import ModelConfig, get_config, list_archs
from repro_torch.configs.paper_zoo import PAPER_MODELS
from repro_torch.control import CONTROLLERS, make_controller
from repro_torch.core.energy import EnergyModel, FusedDequantEnergyModel, combine
from repro_torch.core.hardware import DeviceSpec, get_device
from repro_torch.core.precision import make_policy
from repro_torch.core.profiler import PhaseProfiler
from repro_torch.fleet import (AUTOSCALERS, FleetEngine, FleetReport,
                         assign_replicas, load_regions, make_autoscaler)
from repro_torch.serving.arrival import (burst_arrivals, diurnal_arrivals,
                                   fixed_arrivals, paper_requests,
                                   poisson_arrivals,
                                   uniform_random_arrivals)
from repro_torch.serving.backend import BACKENDS, ReplayBackend
from repro_torch.serving.cluster import ClusterEngine, ClusterReport
from repro_torch.serving.engine import ServeEngine, ServeReport
from repro_torch.serving.requests import Request
from repro_torch.serving.router import make_router
from repro_torch.serving.scheduler import (SCHEDULERS, EnergyBudgetScheduler,
                                     Scheduler, make_scheduler)
from repro_torch.serving.slo import (SLOTier, assign_slos, attainment,
                               estimate_request_latency,
                               estimate_service_rate, percentile_dict)
from repro_torch.serving.trace import PowerTrace

#: arrival pattern names -> required parameter hints (for error messages)
ARRIVALS: Dict[str, Tuple[str, ...]] = {
    "all_at_once": (),
    "fixed": ("interval_s",),
    "uniform": ("low_s", "high_s"),
    "poisson": ("rate_per_s",),
    "burst": ("burst_size", "burst_gap_s"),
    "diurnal": ("base_rate_per_s",),
    "explicit": ("times",),
}

PIPELINES = ("serve", "profile")
MODES = ("continuous", "sequential")
ENERGY_MODELS = ("phase", "fused_dequant")

#: spec fields added after v0.3 serialize only when set off-default, so
#: every pre-existing spec keeps its byte-identical JSON and content
#: hash (cache keys / bench-row provenance stay comparable)
_LATE_FIELD_DEFAULTS = {"backend": "analytic", "freq_scale": 1.0,
                        "replay_path": None, "batch_policy": "slot_count",
                        "policy_params": {}, "disaggregate": 0,
                        "workflow": None, "workflow_params": {},
                        "workflow_reuse": True,
                        "fleet": None, "autoscaler": None,
                        "autoscaler_params": {}, "regions": [],
                        "controller": None, "controller_params": {},
                        "control_interval_s": 1.0,
                        "faults": None, "retry": None,
                        "retry_params": {}}

#: spec fields a per-replica override mapping may set (heterogeneous fleets)
REPLICA_OVERRIDE_FIELDS = ("fmt", "device", "max_batch", "n_chips")

#: the torch device an executed spec runs on unless ``torch_device=``
#: names another (a run-time keyword, never a spec field)
DEFAULT_TORCH_DEVICE = "cuda"


def executed_params(model):
    """The weights every replica of an executed spec serves with: random
    masters from seed 0 under the model's format (the counterpart of the
    reference's ``model.init(jax.random.PRNGKey(0))``, drawn there once
    per replica, identical across replicas)."""
    from repro_torch.launch.serve import build_params
    return build_params(model, seed=0)


def _check_torch_device(torch_device) -> None:
    """Refuse a CUDA device that is not there, naming the keyword that
    moves an executed spec to the host."""
    import torch
    if (torch.device(torch_device).type == "cuda"
            and not torch.cuda.is_available()):
        raise ValueError(
            f"an executed spec runs its model on torch_device="
            f"{str(torch_device)!r}, and no CUDA device is visible; pass "
            "torch_device='cpu' to run it on the host")


def _freeze(value):
    """Recursively convert lists to tuples so a spec reconstructed from
    JSON compares equal to the original."""
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    if isinstance(value, dict):
        return {k: _freeze(v) for k, v in value.items()}
    return value


def _thaw(value):
    """Inverse of :func:`_freeze` for JSON export (tuples -> lists)."""
    if isinstance(value, tuple):
        return [_thaw(v) for v in value]
    if isinstance(value, dict):
        return {k: _thaw(v) for k, v in value.items()}
    return value


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One point in the cross-product of every axis the stack supports.

    Frozen, validated at construction, JSON-round-trippable
    (``ExperimentSpec.from_json(spec.to_json()) == spec``), and content-
    addressed via :meth:`spec_hash`. See the README axis table for the
    full reference.
    """

    # -- model / precision / hardware -----------------------------------
    model: str = "llama-3.1-8b"        # paper_zoo name (or any repro arch)
    fmt: str = "bfloat16"              # precision format / policy
    device: str = "h100-sxm"           # DeviceSpec registry name
    n_chips: int = 1
    energy_model: str = "phase"        # "phase" | "fused_dequant"
    # DVFS operating point: fraction of the nominal core clock (compute
    # scales linearly, dynamic power ~f^3; HBM domain unchanged)
    freq_scale: float = 1.0
    # -- phase-execution backend ----------------------------------------
    backend: str = "analytic"          # "analytic" | "executed" | "replay"
    replay_path: Optional[str] = None  # recorded trace (backend="replay")
    # -- pipeline / engine ----------------------------------------------
    pipeline: str = "serve"            # "serve" | "profile"
    mode: str = "continuous"           # serving mode
    max_batch: int = 32                # batch limit; profile batch size
    max_prefill_batch: int = 8
    # -- batch formation (repro_torch.batching.policy) ------------------------
    batch_policy: str = "slot_count"   # BATCH_POLICIES registry name
    policy_params: Mapping[str, Any] = dataclasses.field(
        default_factory=dict)
    stack: Optional[str] = None        # profile-stack override
    # -- fleet (replicas > 1 resolves to a ClusterEngine) ---------------
    replicas: int = 1
    router: str = "round_robin"
    replica_overrides: Tuple = ()      # per-replica field overrides
    # disaggregated serving: first N replicas form the prefill pool,
    # the rest decode; finished prefills hand their KV cache across
    # the interconnect (latency + pJ/byte billed per request)
    disaggregate: int = 0
    # -- vectorized fleet path / autoscaling / geo-routing --------------
    # fleet=None auto-selects: the legacy ClusterEngine loop unless an
    # autoscaler/region axis demands the vectorized FleetEngine;
    # "vector" forces the vectorized path (field-for-field identical
    # on stock routers), "legacy" pins the serial loop
    fleet: Optional[str] = None
    autoscaler: Optional[str] = None   # AUTOSCALERS registry name
    autoscaler_params: Mapping[str, Any] = dataclasses.field(
        default_factory=dict)
    # region dicts (see repro_torch.fleet.load_regions / sinusoid_region):
    # time-varying carbon/price signals, RTT, egress price, fleet slice
    regions: Tuple = ()
    # -- closed-loop control (repro_torch.control): a controller observes and
    #    actuates DVFS / admission / replica count every
    #    control_interval_s of simulated time ---------------------------
    controller: Optional[str] = None   # CONTROLLERS registry name
    controller_params: Mapping[str, Any] = dataclasses.field(
        default_factory=dict)
    control_interval_s: float = 1.0
    # -- fault injection & resilience (repro_torch.faults): a deterministic
    #    schedule of crash/preempt/slowdown/power_cap/link_degrade
    #    events (tuple of FaultEvent.to_spec() dicts), plus the retry
    #    policy that re-queues failed work ------------------------------
    faults: Optional[Tuple] = None
    retry: Optional[str] = None        # RETRY_POLICIES registry name
    retry_params: Mapping[str, Any] = dataclasses.field(
        default_factory=dict)
    # -- scheduling -----------------------------------------------------
    scheduler: Optional[str] = None
    scheduler_params: Mapping[str, Any] = dataclasses.field(
        default_factory=dict)
    # -- arrival process ------------------------------------------------
    arrival: str = "all_at_once"
    arrival_params: Mapping[str, Any] = dataclasses.field(
        default_factory=dict)
    # -- workflow workload (repro_torch.workflows template; when set,
    #    n_requests counts *tasks* and the arrival process spaces task
    #    graphs whose steps release on dependency completion) ----------
    workflow: Optional[str] = None
    workflow_params: Mapping[str, Any] = dataclasses.field(
        default_factory=dict)
    # prefix_of= KV forking on/off (the reuse-ablation axis; reuse is
    # auto-disabled in sequential mode and on disaggregated fleets)
    workflow_reuse: bool = True
    # -- workload distribution (paper §2/§3.1 defaults) -----------------
    n_requests: int = 64
    prompt_range: Tuple[int, int] = (200, 4000)
    output_range: Tuple[int, int] = (10, 300)
    seed: int = 0
    # -- SLO assignment (optional) --------------------------------------
    slo_tiers: Optional[Tuple] = None  # ((name, priority, deadline_s), ...)
    slo_weights: Optional[Tuple] = None
    slo_seed: int = 0
    # -- telemetry ------------------------------------------------------
    trace: bool = False
    # -- profile pipeline -----------------------------------------------
    profile_seeds: int = 1             # padded batches averaged per point
    # -- real execution (examples / integration tests) ------------------
    execute: bool = False
    reduced: bool = False              # cfg.reduced() for CPU-sized runs
    buf_len: int = 256

    # ------------------------------------------------------------------
    def __post_init__(self):
        set_ = object.__setattr__
        set_(self, "scheduler_params",
             _freeze(dict(self.scheduler_params)))
        set_(self, "arrival_params", _freeze(dict(self.arrival_params)))
        set_(self, "policy_params", _freeze(dict(self.policy_params)))
        set_(self, "workflow_params", _freeze(dict(self.workflow_params)))
        set_(self, "autoscaler_params",
             _freeze(dict(self.autoscaler_params)))
        set_(self, "controller_params",
             _freeze(dict(self.controller_params)))
        set_(self, "retry_params", _freeze(dict(self.retry_params)))
        if self.faults is not None:
            # canonicalize through the schedule (sorted, non-default
            # fields only) so equal schedules hash equally
            from repro_torch.faults import make_faults
            set_(self, "faults",
                 _freeze(make_faults(
                     _thaw(list(self.faults))).to_spec()))
        set_(self, "regions", _freeze(tuple(self.regions)))
        set_(self, "replica_overrides",
             _freeze(tuple(dict(o) for o in self.replica_overrides)))
        set_(self, "prompt_range", tuple(self.prompt_range))
        set_(self, "output_range", tuple(self.output_range))
        if self.slo_tiers is not None:
            set_(self, "slo_tiers", _freeze(tuple(self.slo_tiers)))
        if self.slo_weights is not None:
            set_(self, "slo_weights", tuple(self.slo_weights))
        self.validate()

    def validate(self) -> None:
        """Raise ``ValueError`` on any unknown axis value. Called at
        construction so a sweep fails before its first run."""
        if self.model not in PAPER_MODELS and self.model not in list_archs():
            raise ValueError(
                f"unknown model {self.model!r}; known: "
                f"{sorted(PAPER_MODELS)} + {sorted(list_archs())}")
        make_policy(self.fmt)                      # raises on unknown fmt
        get_device(self.device)                    # raises on unknown device
        if self.pipeline not in PIPELINES:
            raise ValueError(f"unknown pipeline {self.pipeline!r}; "
                             f"known: {PIPELINES}")
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; known: {MODES}")
        if self.energy_model not in ENERGY_MODELS:
            raise ValueError(f"unknown energy_model "
                             f"{self.energy_model!r}; known: "
                             f"{ENERGY_MODELS}")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"known: {BACKENDS}")
        if not 0.1 <= self.freq_scale <= 1.5:
            raise ValueError(
                f"freq_scale {self.freq_scale} outside [0.1, 1.5]")
        if self.replay_path is not None and self.backend != "replay":
            raise ValueError(
                "replay_path= is set but backend is "
                f"{self.backend!r}; did you mean backend='replay'?")
        if self.backend == "replay":
            if self.replay_path is None:
                raise ValueError("backend='replay' needs replay_path=")
            if self.execute:
                raise ValueError(
                    "backend='replay' and execute=True conflict: replay "
                    "has no model to execute")
            if self.freq_scale != 1.0:
                raise ValueError(
                    "freq_scale has no effect on replayed traces (their "
                    "costs are measurements, not model evaluations); "
                    "record the trace at the target operating point "
                    "instead")
        if self.pipeline == "profile" \
                and self.effective_backend() != "analytic":
            raise ValueError(
                "the profile pipeline supports analytic backends only; "
                "use pipeline='serve' for "
                f"backend={self.effective_backend()!r}")
        make_router(self.router)                   # raises on unknown policy
        if (self.scheduler is not None
                and self.scheduler not in SCHEDULERS):
            raise ValueError(f"unknown scheduler {self.scheduler!r}; "
                             f"known: {list(SCHEDULERS)}")
        if self.arrival not in ARRIVALS:
            raise ValueError(f"unknown arrival pattern {self.arrival!r}; "
                             f"known: {list(ARRIVALS)}")
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        if self.n_requests < 0:
            raise ValueError("n_requests must be >= 0")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.batch_policy not in BATCH_POLICIES:
            raise ValueError(
                f"unknown batch_policy {self.batch_policy!r}; known: "
                f"{list(BATCH_POLICIES)}")
        reserved = {"max_batch", "max_prefill_batch"} & set(
            self.policy_params)
        if reserved:
            raise ValueError(
                f"policy_params may not set {sorted(reserved)}; use the "
                "spec fields max_batch= / max_prefill_batch=")
        if self.batch_policy != "slot_count":
            if self.mode != "continuous":
                raise ValueError(
                    f"batch_policy={self.batch_policy!r} requires "
                    "mode='continuous' (sequential serving forms no "
                    "batches)")
            if self.pipeline != "serve":
                raise ValueError(
                    f"batch_policy={self.batch_policy!r} requires "
                    "pipeline='serve' (the profile pipeline pads one "
                    "static batch)")
        if self.batch_policy != "slot_count" or self.policy_params:
            self.build_batch_policy()  # surfaces bad params early
        if self.workflow_params and self.workflow is None:
            raise ValueError(
                "workflow_params= is set but workflow is None; name a "
                "template via workflow=")
        if not self.workflow_reuse and self.workflow is None:
            raise ValueError(
                "workflow_reuse=False is set but workflow is None; "
                "name a template via workflow=")
        if self.workflow is not None:
            if self.pipeline != "serve":
                raise ValueError(
                    "workflow= requires pipeline='serve' (the profile "
                    "pipeline pads one static batch)")
            from repro_torch.workflows import make_workflow
            # surfaces unknown templates / bad params at construction
            make_workflow(self.workflow, np.random.default_rng(0),
                          **dict(self.workflow_params))
        if self.disaggregate < 0:
            raise ValueError("disaggregate must be >= 0 (the prefill "
                             "pool size)")
        if self.disaggregate:
            if self.replicas < 2:
                raise ValueError(
                    "disaggregate needs replicas >= 2 (one pool each "
                    f"for prefill and decode, got replicas="
                    f"{self.replicas})")
            if self.disaggregate >= self.replicas:
                raise ValueError(
                    f"disaggregate={self.disaggregate} leaves no decode "
                    f"replicas out of replicas={self.replicas}")
            if self.mode != "continuous" or self.pipeline != "serve":
                raise ValueError(
                    "disaggregate requires pipeline='serve' and "
                    "mode='continuous'")
        if self.fleet not in (None, "vector", "legacy"):
            raise ValueError(f"unknown fleet {self.fleet!r}; known: "
                             "None (auto), 'vector', 'legacy'")
        if self.autoscaler_params and self.autoscaler is None:
            raise ValueError(
                "autoscaler_params= is set but autoscaler is None; "
                f"name a policy via autoscaler= ({sorted(AUTOSCALERS)})")
        if self.autoscaler is not None:
            # surfaces unknown names / bad params at construction
            make_autoscaler(self.autoscaler,
                            dict(self.autoscaler_params))
        if self.regions:
            # surfaces malformed region dicts and replica-count
            # mismatches at construction
            assign_replicas(load_regions(_thaw(list(self.regions))),
                            self.replicas)
        if self.control_interval_s <= 0:
            raise ValueError("control_interval_s must be positive")
        if self.controller is None:
            if self.controller_params:
                raise ValueError(
                    "controller_params= is set but controller is None; "
                    f"name a policy via controller= "
                    f"({sorted(CONTROLLERS)})")
            if self.control_interval_s != 1.0:
                raise ValueError(
                    "control_interval_s= is set but controller is "
                    "None; name a policy via controller=")
        else:
            # surfaces unknown names / bad params at construction
            make_controller(self.controller,
                            **dict(self.controller_params))
            if self.pipeline != "serve" or self.mode != "continuous":
                raise ValueError(
                    "controller= requires pipeline='serve' and "
                    "mode='continuous'")
            if self.workflow is not None:
                raise ValueError(
                    "controller= does not compose with workflow= yet; "
                    "control a plain request stream")
            if self.disaggregate:
                raise ValueError(
                    "controller= does not compose with disaggregated "
                    "prefill/decode fleets")
            if self.autoscaler is not None:
                raise ValueError(
                    "controller= and autoscaler= are both replica-"
                    "count authorities; pick one (MPCController and "
                    "StaticController(n_replicas=) scale the fleet "
                    "themselves)")
        if self.retry_params and self.retry is None:
            raise ValueError(
                "retry_params= is set but retry is None; name a "
                "policy via retry=")
        if self.retry is not None:
            from repro_torch.faults import make_retry
            # surfaces unknown names / bad params at construction
            make_retry(self.retry, **dict(self.retry_params))
            if self.faults is None:
                raise ValueError(
                    "retry= without faults= has no effect; attach a "
                    "fault schedule via faults=")
        if self.faults is not None:
            from repro_torch.faults import make_faults
            sched = make_faults(_thaw(list(self.faults)))
            if not len(sched):
                raise ValueError("faults= is an empty schedule; use "
                                 "faults=None")
            if self.pipeline != "serve" or self.mode != "continuous":
                raise ValueError(
                    "faults= requires pipeline='serve' and "
                    "mode='continuous'")
            if self.controller is not None:
                raise ValueError(
                    "faults= cannot be combined with controller= "
                    "(controlling a faulty fleet is future work)")
            if self.autoscaler is not None or self.regions:
                raise ValueError(
                    "faults= does not compose with autoscaler= or "
                    "regions= (failure-aware autoscaling is future "
                    "work)")
            if sched.max_replica >= self.replicas:
                raise ValueError(
                    f"fault schedule names replica "
                    f"{sched.max_replica} but replicas="
                    f"{self.replicas}")
            if self.disaggregate:
                if not sched.only_kinds("link_degrade"):
                    raise ValueError(
                        "disaggregated fleets only support "
                        "link_degrade faults")
                if self.retry is not None:
                    raise ValueError(
                        "retry= has no effect on a link_degrade-only "
                        "schedule")
            elif sched.has_kind("link_degrade"):
                raise ValueError(
                    "link_degrade faults require a disaggregated "
                    "fleet (set disaggregate=)")
            if self.workflow is not None and self.replicas > 1:
                raise ValueError(
                    "faults= with workflow= requires replicas=1 (the "
                    "cluster loop does not co-simulate workflow "
                    "sources under faults)")
        from repro_torch.serving.router import _SignalAwareRouter
        if (isinstance(make_router(self.router), _SignalAwareRouter)
                and not self.regions):
            raise ValueError(
                f"router={self.router!r} is geo-aware and needs a "
                "region layer; set regions=")
        if self.fleet == "legacy" and (self.autoscaler is not None
                                       or self.regions):
            raise ValueError(
                "autoscaler=/regions= need the vectorized fleet path; "
                "remove fleet='legacy'")
        if self._wants_fleet():
            if self.pipeline != "serve" or self.mode != "continuous":
                raise ValueError(
                    "the fleet path requires pipeline='serve' and "
                    "mode='continuous'")
            if self.disaggregate:
                raise ValueError(
                    "the vectorized fleet path does not support "
                    "disaggregated pools; use fleet='legacy' replicas "
                    "without autoscaler=/regions=")
            if self.workflow is not None:
                raise ValueError(
                    "the vectorized fleet path does not support "
                    "workflow sources yet; drop fleet/autoscaler/"
                    "regions or workflow=")
        for name in ("prompt_range", "output_range"):
            lo, hi = getattr(self, name)
            if lo < 1 or hi < lo:
                raise ValueError(f"{name} must satisfy 1 <= lo <= hi, "
                                 f"got ({lo}, {hi})")
        if self.profile_seeds < 1:
            raise ValueError("profile_seeds must be >= 1")
        for o in self.replica_overrides:
            bad = set(o) - set(REPLICA_OVERRIDE_FIELDS)
            if bad:
                raise ValueError(
                    f"replica_overrides may only set "
                    f"{REPLICA_OVERRIDE_FIELDS}, got {sorted(bad)}")
        if (self.replica_overrides
                and len(self.replica_overrides) != self.replicas):
            raise ValueError(
                f"replica_overrides has {len(self.replica_overrides)} "
                f"entries for {self.replicas} replicas")

    # -- serialization --------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = _thaw(dataclasses.asdict(self))
        for key, default in _LATE_FIELD_DEFAULTS.items():
            if d.get(key) == default:
                del d[key]
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        bad = set(d) - known
        if bad:
            raise ValueError(f"unknown spec fields: {sorted(bad)}")
        kw = dict(d)
        for key in ("slo_tiers", "slo_weights"):
            if kw.get(key) is not None:
                kw[key] = _freeze(kw[key])
        return cls(**{k: _freeze(v) if isinstance(v, list) else v
                      for k, v in kw.items()})

    @classmethod
    def from_json(cls, blob: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(blob))

    def spec_hash(self) -> str:
        """Content address of this spec (12 hex chars of SHA-256 over
        the canonical JSON). Memoization and bench-row provenance key."""
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:12]

    def __hash__(self) -> int:
        # the generated dataclass hash would choke on the mapping
        # fields; hash by content so specs work in sets/dict keys
        return hash(self.to_json())

    def derive(self, **changes) -> "ExperimentSpec":
        """A new spec with ``changes`` applied (axis-style overrides;
        dotted keys reach into mapping fields, e.g.
        ``derive(**{"arrival_params.interval_s": 0.02})``)."""
        flat: Dict[str, Any] = {}
        nested: Dict[str, Dict[str, Any]] = {}
        for key, val in changes.items():
            if "." in key:
                field, sub = key.split(".", 1)
                nested.setdefault(field, {})[sub] = val
            else:
                flat[key] = val
        for field, subs in nested.items():
            cur = dict(flat.get(field, getattr(self, field)))
            cur.update(subs)
            flat[field] = cur
        return dataclasses.replace(self, **flat)

    # -- resolution -----------------------------------------------------
    def model_config(self) -> ModelConfig:
        cfg = (PAPER_MODELS[self.model] if self.model in PAPER_MODELS
               else get_config(self.model))
        return cfg.reduced() if self.reduced else cfg

    def device_spec(self) -> DeviceSpec:
        """The (possibly DVFS-scaled) device operating point every part
        of the stack — engine billing, scheduler pricing, router
        prediction — consults, so they never disagree."""
        return get_device(self.device).with_freq_scale(self.freq_scale)

    def effective_backend(self) -> str:
        """The backend axis with the legacy ``execute=True`` alias
        folded in."""
        return "executed" if (self.execute
                              or self.backend == "executed") \
            else self.backend

    def _wants_fleet(self) -> bool:
        """Whether this spec resolves to the vectorized
        :class:`~repro_torch.fleet.FleetEngine` path."""
        if self.fleet == "legacy":
            return False
        return (self.fleet == "vector" or self.autoscaler is not None
                or bool(self.regions))

    def arrivals(self) -> list:
        """Materialize the arrival time list for this spec."""
        n, p = self.n_requests, dict(self.arrival_params)
        if self.arrival == "all_at_once":
            return [p.get("start", 0.0)] * n
        if self.arrival == "fixed":
            return fixed_arrivals(n, p["interval_s"],
                                  start=p.get("start", 0.0))
        if self.arrival == "uniform":
            return uniform_random_arrivals(
                n, p["low_s"], p["high_s"],
                seed=p.get("seed", self.seed), start=p.get("start", 0.0))
        if self.arrival == "poisson":
            return poisson_arrivals(n, p["rate_per_s"],
                                    seed=p.get("seed", self.seed),
                                    start=p.get("start", 0.0))
        if self.arrival == "burst":
            return burst_arrivals(n, p["burst_size"], p["burst_gap_s"],
                                  start=p.get("start", 0.0))
        if self.arrival == "diurnal":
            rate = p.pop("base_rate_per_s")
            p.setdefault("seed", self.seed)
            return diurnal_arrivals(n, rate, **p)
        times = list(p["times"])           # "explicit"
        if len(times) != n:
            raise ValueError(
                f"explicit arrival list has {len(times)} entries for "
                f"n_requests={n}")
        return [float(t) for t in times]

    def requests(self) -> list:
        """Sample this spec's request list (workload x arrivals x SLOs)."""
        cfg = self.model_config()
        materialize = self.effective_backend() == "executed"
        reqs = paper_requests(
            self.n_requests, self.arrivals(), seed=self.seed,
            prompt_range=self.prompt_range, output_range=self.output_range,
            vocab_size=cfg.vocab_size if materialize else None)
        if self.slo_tiers is not None or self.slo_weights is not None:
            tiers = tuple(SLOTier(name, int(prio), float(dl))
                          for name, prio, dl in
                          (self.slo_tiers or
                           (("interactive", 2, 5.0), ("standard", 1, 30.0),
                            ("batch", 0, float("inf")))))
            assign_slos(reqs, tiers=tiers, weights=self.slo_weights,
                        seed=self.slo_seed)
        return reqs

    def build_workflow_source(self):
        """Materialize the workflow axis: ``n_requests`` task graphs
        drawn from the template (seeded), spaced by the spec's arrival
        process. Fresh source per run — engines mutate its requests."""
        from repro_torch.workflows import WorkflowSource, make_workflow
        rng = np.random.default_rng(self.seed)
        wfs = [make_workflow(self.workflow, rng,
                             **dict(self.workflow_params))
               for _ in range(self.n_requests)]
        cfg = self.model_config()
        materialize = self.effective_backend() == "executed"
        return WorkflowSource(
            wfs, self.arrivals(), seed=self.seed,
            reuse_prefix=self.workflow_reuse,
            vocab_size=cfg.vocab_size if materialize else None)

    def _engine_stack(self) -> str:
        return "fused" if self.mode == "continuous" else "eager"

    def _energy_model_cls(self):
        return (FusedDequantEnergyModel
                if self.energy_model == "fused_dequant" else EnergyModel)

    def build_energy_model(self) -> EnergyModel:
        """The analytic energy model this spec's engine bills with —
        also handed to admission-control schedulers so their pricing
        matches the engine's accounting."""
        return self._energy_model_cls()(self.device_spec(),
                                        make_policy(self.fmt))

    def build_scheduler(self) -> Optional[Scheduler]:
        """Resolve the scheduler axis. ``deadline`` auto-estimates its
        service rate / latency from the spec's mean workload shape when
        the params omit them; ``energy_budget`` is wired to the spec's
        model / precision / device / batch limit."""
        if self.scheduler is None:
            return None
        params = dict(self.scheduler_params)
        cfg = self.model_config()
        if self.scheduler == "deadline":
            plen = int(np.mean(self.prompt_range))
            out = int(np.mean(self.output_range))
            common = dict(prompt_len=plen, new_tokens=out,
                          batch=self.max_batch,
                          n_chips=self.n_chips,
                          stack=self._engine_stack(),
                          energy_model=self.build_energy_model())
            params.setdefault("service_rate_per_s",
                              estimate_service_rate(cfg, **common))
            params.setdefault("est_latency_s",
                              estimate_request_latency(cfg, **common))
        if self.scheduler == "energy_budget":
            return EnergyBudgetScheduler(
                params.pop("max_wh_per_request"), cfg,
                n_chips=self.n_chips, stack=self._engine_stack(),
                max_batch=self.max_batch,
                energy_model=self.build_energy_model(), **params)
        return make_scheduler(self.scheduler, **params)

    def build_autoscaler(self):
        """Resolve the autoscaler axis (``None`` when unset)."""
        if self.autoscaler is None:
            return None
        return make_autoscaler(self.autoscaler,
                               dict(self.autoscaler_params))

    def build_controller(self):
        """Resolve the controller axis (``None`` when unset). Fresh
        instance per run — controllers keep planning state."""
        if self.controller is None:
            return None
        return make_controller(self.controller,
                               **dict(self.controller_params))

    def build_faults(self):
        """Resolve the fault-schedule axis (``None`` when unset)."""
        if self.faults is None:
            return None
        from repro_torch.faults import make_faults
        return make_faults(_thaw(list(self.faults)))

    def build_retry(self):
        """Resolve the retry-policy axis (``None`` when unset)."""
        if self.retry is None:
            return None
        from repro_torch.faults import make_retry
        return make_retry(self.retry, **dict(self.retry_params))

    def build_batch_policy(self,
                           max_batch: Optional[int] = None
                           ) -> BatchPolicy:
        """Construct a fresh batch-formation policy for one replica.

        Policies are stateful, so every engine replica gets its own
        instance (``max_batch=`` lets a replica override carry its own
        batch limit)."""
        return make_batch_policy(
            self.batch_policy,
            max_batch=self.max_batch if max_batch is None else max_batch,
            max_prefill_batch=self.max_prefill_batch,
            **dict(self.policy_params))

    def build_engine(self, *, torch_device=DEFAULT_TORCH_DEVICE):
        """Resolve the engine axes into a :class:`ServeEngine` (one
        replica) or :class:`ClusterEngine` (fleet). An executed spec's
        models run on ``torch_device``; its replicas share one model
        and its weights per format."""
        emodel = self._energy_model_cls()
        cfg = self.model_config()

        backend = self.effective_backend()
        if backend == "executed":
            _check_torch_device(torch_device)
        models: Dict[str, Tuple[Any, Any]] = {}
        # parse + validate the trace once; without a controller the
        # ReplayBackend is stateless (nearest-sample lookup), so one
        # instance serves every replica. A controller actuates
        # ``set_freq_scale`` — per-replica state — so each replica then
        # gets its own instance.
        replay = (ReplayBackend.from_json(self.replay_path)
                  if backend == "replay" else None)

        def one(overrides: Mapping[str, Any],
                pool: str = "mixed") -> ServeEngine:
            kw = dict(fmt=self.fmt, device=self.device_spec(),
                      n_chips=self.n_chips, max_batch=self.max_batch)
            kw.update({k: (get_device(v).with_freq_scale(self.freq_scale)
                           if k == "device" else v)
                       for k, v in overrides.items()})
            pol = self.build_batch_policy(max_batch=kw.pop("max_batch"))
            exec_kw = {}
            if backend == "executed":
                from repro_torch.models import build_model
                if kw["fmt"] not in models:
                    model = build_model(cfg, fmt=kw["fmt"],
                                        device=torch_device)
                    models[kw["fmt"]] = (model, executed_params(model))
                model, params = models[kw["fmt"]]
                exec_kw = dict(execute=True, model=model, params=params,
                               buf_len=self.buf_len)
            elif backend == "replay":
                exec_kw = dict(
                    backend=(ReplayBackend.from_json(self.replay_path)
                             if self.controller is not None else replay))
            return ServeEngine(cfg, mode=self.mode, batch_policy=pol,
                               pool=pool, energy_model_cls=emodel,
                               **kw, **exec_kw)

        if self._wants_fleet():
            overrides = (self.replica_overrides
                         or ({},) * self.replicas)
            fleet = [one(o) for o in overrides]
            return FleetEngine(
                fleet, make_router(self.router),
                autoscaler=self.build_autoscaler(),
                regions=_thaw(list(self.regions)) or None)
        if self.replicas == 1 and not self.replica_overrides:
            return one({})
        overrides = (self.replica_overrides
                     or ({},) * self.replicas)
        pools = (["prefill"] * self.disaggregate
                 + ["decode"] * (self.replicas - self.disaggregate)
                 if self.disaggregate else ["mixed"] * self.replicas)
        fleet = [one(o, pool=p) for o, p in zip(overrides, pools)]
        return ClusterEngine(fleet, make_router(self.router))

    # ------------------------------------------------------------------
    def run(self, *, torch_device=DEFAULT_TORCH_DEVICE) -> "RunResult":
        """Resolve and execute this spec, returning its flat record (an
        executed spec's models run on ``torch_device``)."""
        if self.pipeline == "profile":
            return _run_profile(self)
        return _run_serve(self, torch_device)


# ---------------------------------------------------------------------------
# RunResult
# ---------------------------------------------------------------------------
#: result fields added with the batch-formation axes; serialized only
#: when set so every pre-existing record (golden-parity files, sweep
#: caches) keeps its byte-identical JSON
_FORMATION_RESULT_FIELDS = ("prefill_padding_fraction", "prefill_chunks",
                            "handoff_energy_j", "n_handoffs")

#: result fields added with the workflow axis; same omit-when-None rule
_WORKFLOW_RESULT_FIELDS = ("n_tasks", "n_tasks_completed",
                           "mean_task_latency_s",
                           "mean_task_critical_path_s",
                           "mean_energy_per_task_wh",
                           "prefix_reused_tokens")

#: result fields added with the fleet axes (autoscaler / regions);
#: same omit-when-None rule, so a bare fleet="vector" run serializes
#: field-identically to its legacy ClusterEngine twin
_FLEET_RESULT_FIELDS = ("transition_energy_j", "n_transitions",
                        "gco2_total_g", "gco2_per_request_g",
                        "usd_total", "usd_per_request",
                        "client_latency_p99_s", "client_ttft_p99_s")

#: result fields added with the controller axis; same omit-when-None
#: rule. ``controller_overhead_s`` is host wall-clock spent inside
#: ``controller.act`` — the one documented non-deterministic field on
#: an otherwise byte-reproducible record.
_CONTROL_RESULT_FIELDS = ("n_control_actions", "mean_freq_scale",
                          "controller_overhead_s", "control_actions")

#: result fields added with the fault-injection axes; same
#: omit-when-None rule, so fault-free records stay byte-identical
_RESILIENCE_RESULT_FIELDS = ("n_failures", "n_retries", "n_failed",
                             "n_completed", "wasted_energy_j",
                             "goodput_wh_per_request", "availability")


@dataclasses.dataclass
class RunResult:
    """One flat record per executed spec — the unified schema subsuming
    :class:`~repro_torch.serving.engine.ServeReport` and
    :class:`~repro_torch.serving.cluster.ClusterReport` (plus the profile
    pipeline's phase metrics). JSON-round-trippable and deterministic:
    the same spec always produces a byte-identical ``to_json()``.

    ``report`` keeps a reference to the underlying engine report on
    fresh runs (``None`` after a cache hit or JSON round-trip) — claims
    and sweeps must only consume the serialized fields.
    """

    spec_hash: str = ""
    kind: str = "serve"                # serve | cluster | profile
    # -- offered load ---------------------------------------------------
    n_requests: int = 0
    n_shed: int = 0
    # -- energy ---------------------------------------------------------
    total_energy_j: float = 0.0
    busy_energy_j: float = 0.0
    idle_energy_j: float = 0.0
    gated_energy_j: float = 0.0
    mean_energy_wh: float = 0.0        # total energy / request, in Wh
    mean_attributed_wh: float = 0.0
    idle_fraction: float = 0.0
    gated_fraction: float = 0.0
    # -- time / throughput ----------------------------------------------
    wall_time_s: float = 0.0
    mean_batch: float = 0.0
    utilization: float = 0.0
    tokens_per_s: float = 0.0
    # -- latency / TTFT -------------------------------------------------
    mean_latency_s: float = 0.0
    mean_ttft_s: float = 0.0
    latency_p50_s: float = 0.0
    latency_p90_s: float = 0.0
    latency_p99_s: float = 0.0
    ttft_p50_s: float = 0.0
    ttft_p90_s: float = 0.0
    ttft_p99_s: float = 0.0
    # -- SLO ------------------------------------------------------------
    slo_attainment: float = 1.0
    admitted_attainment: float = 1.0   # met_deadline over served only
    tier_attainment: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    shed_arrival_times: Tuple[float, ...] = ()
    # -- fleet ----------------------------------------------------------
    replicas: int = 1
    router: Optional[str] = None
    requests_per_replica: Tuple[int, ...] = ()
    # -- power-state telemetry (when spec.trace) ------------------------
    trace_coverage: Optional[float] = None
    energy_by_state_j: Optional[Dict[str, float]] = None
    time_by_state_s: Optional[Dict[str, float]] = None
    # -- profile pipeline (None for serve/cluster) ----------------------
    prefill_energy_j: Optional[float] = None
    prefill_latency_s: Optional[float] = None
    prefill_bound: Optional[str] = None
    decode_energy_j: Optional[float] = None
    decode_latency_s: Optional[float] = None
    decode_bound: Optional[str] = None
    decode_j_per_tok: Optional[float] = None
    decode_ms_per_tok: Optional[float] = None
    effective_tokens: Optional[float] = None
    computed_tokens: Optional[float] = None
    padding_fraction: Optional[float] = None
    pre_j_per_eff_in: Optional[float] = None
    dec_j_per_eff_in: Optional[float] = None
    gen_j_per_eff_in: Optional[float] = None
    pre_j_per_comp_in: Optional[float] = None
    dec_j_per_comp_in: Optional[float] = None
    pre_j_per_out: Optional[float] = None
    dec_j_per_out: Optional[float] = None
    gen_j_per_out: Optional[float] = None
    # -- batch formation (set when the spec names a formation axis;
    #    omitted from to_dict when None so pre-existing records keep
    #    their byte-identical JSON) ---------------------------------------
    prefill_padding_fraction: Optional[float] = None
    prefill_chunks: Optional[int] = None
    handoff_energy_j: Optional[float] = None
    n_handoffs: Optional[int] = None
    # -- workflow serving (set when the spec names a workflow template;
    #    omitted from to_dict when None, same byte-stability rule) ------
    n_tasks: Optional[int] = None
    n_tasks_completed: Optional[int] = None
    mean_task_latency_s: Optional[float] = None
    mean_task_critical_path_s: Optional[float] = None
    mean_energy_per_task_wh: Optional[float] = None
    prefix_reused_tokens: Optional[int] = None
    # -- fleet path (set when the spec names an autoscaler or region
    #    axis; omitted from to_dict when None, same byte-stability rule)
    transition_energy_j: Optional[float] = None
    n_transitions: Optional[int] = None
    gco2_total_g: Optional[float] = None
    gco2_per_request_g: Optional[float] = None
    usd_total: Optional[float] = None
    usd_per_request: Optional[float] = None
    client_latency_p99_s: Optional[float] = None
    client_ttft_p99_s: Optional[float] = None
    # -- closed-loop control (set when the spec names a controller;
    #    omitted from to_dict when None, same byte-stability rule) ------
    n_control_actions: Optional[int] = None
    mean_freq_scale: Optional[float] = None
    controller_overhead_s: Optional[float] = None
    control_actions: Optional[Tuple] = None   # (t, freq, adm, replicas)
    # -- fault injection & resilience (set when the spec carries a
    #    fault schedule; omitted from to_dict when None, same
    #    byte-stability rule) -------------------------------------------
    n_failures: Optional[int] = None
    n_retries: Optional[int] = None
    n_failed: Optional[int] = None            # terminally failed requests
    n_completed: Optional[int] = None
    wasted_energy_j: Optional[float] = None
    goodput_wh_per_request: Optional[float] = None
    availability: Optional[float] = None
    # -- non-serialized engine report (fresh runs only) -----------------
    report: Optional[Any] = dataclasses.field(
        default=None, compare=False, repr=False)

    # ------------------------------------------------------------------
    @property
    def mean_energy_per_token_wh(self) -> float:
        """Total energy per generated token, in Wh — 0.0 on an empty
        run (same guard as ``tokens_per_s``). Derived, never
        serialized, so pre-existing records stay byte-identical."""
        toks = self.tokens_per_s * self.wall_time_s
        if toks <= 0:
            return 0.0
        return self.total_energy_j / 3600.0 / toks

    def metric(self, name: str) -> float:
        """Look up a metric by (possibly dotted) name, e.g.
        ``"mean_energy_wh"`` or ``"tier_attainment.interactive"``."""
        obj: Any = self
        for part in name.split("."):
            if isinstance(obj, Mapping):
                obj = obj[part]
            else:
                obj = getattr(obj, part)
        if obj is None:
            raise ValueError(f"metric {name!r} is unset on this "
                             f"{self.kind!r} result")
        return obj

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.pop("report")
        for key in (_FORMATION_RESULT_FIELDS + _WORKFLOW_RESULT_FIELDS
                    + _FLEET_RESULT_FIELDS + _CONTROL_RESULT_FIELDS
                    + _RESILIENCE_RESULT_FIELDS):
            if d[key] is None:
                del d[key]
        return _thaw(d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "RunResult":
        kw = {k: _freeze(v) if isinstance(v, list) else v
              for k, v in d.items() if k != "report"}
        return cls(**kw)

    @classmethod
    def from_json(cls, blob: str) -> "RunResult":
        return cls.from_dict(json.loads(blob))


# ---------------------------------------------------------------------------
# resolution: serve / cluster
# ---------------------------------------------------------------------------
def _tier_attainment(report) -> Dict[str, float]:
    tiers = sorted({r.slo_tier for r in
                    list(report.requests) + list(report.shed)
                    if r.slo_tier is not None})
    return {name: attainment(
        [r for r in report.requests if r.slo_tier == name],
        [r for r in report.shed if r.slo_tier == name])
        for name in tiers}


def _run_serve(spec: ExperimentSpec, torch_device) -> RunResult:
    engine = spec.build_engine(torch_device=torch_device)
    trace = PowerTrace() if spec.trace else None
    # the controller kwargs are only passed when set, so uncontrolled
    # runs execute the byte-identical legacy call path
    ctl_kw: Dict[str, Any] = (
        dict(controller=spec.build_controller(),
             control_interval_s=spec.control_interval_s)
        if spec.controller is not None else {})
    # the fault kwargs are only passed when set, so fault-free runs
    # execute the byte-identical legacy call path
    if spec.faults is not None:
        ctl_kw["faults"] = spec.build_faults()
        if spec.retry is not None:
            ctl_kw["retry"] = spec.build_retry()
    if spec.workflow is not None:
        source = spec.build_workflow_source()
        report = engine.run(source.initial(),
                            scheduler=spec.build_scheduler(),
                            trace=trace, source=source, **ctl_kw)
    else:
        report = engine.run(spec.requests(),
                            scheduler=spec.build_scheduler(), trace=trace,
                            **ctl_kw)
    return result_from_report(spec, report, trace)


def result_from_report(spec: ExperimentSpec, report,
                       trace: Optional[PowerTrace] = None) -> RunResult:
    """Flatten a ``ServeReport`` or ``ClusterReport`` into the unified
    record (field-parity is pinned by tests/test_api.py)."""
    cluster = isinstance(report, ClusterReport)
    lat = percentile_dict([r.latency for r in report.completed])
    ttft = percentile_dict([r.ttft for r in report.completed])
    served = report.requests
    admitted = (float(np.mean([r.met_deadline for r in served]))
                if served else 1.0)
    total = max(report.total_energy_j, 1e-12)
    # formation telemetry is recorded only when the spec asks for a
    # non-default formation axis, keeping default records byte-stable
    formation = (spec.batch_policy != "slot_count"
                 or bool(spec.policy_params) or spec.disaggregate > 0)
    kw: Dict[str, Any] = {}
    if cluster:
        reps: Sequence[ServeReport] = report.replica_reports
        toks = sum(r.tokens_per_s * max(r.wall_time_s, 1e-12)
                   for r in reps)
        kw = dict(
            kind="cluster", replicas=len(reps), router=report.policy,
            requests_per_replica=tuple(report.requests_per_replica),
            mean_batch=float(np.mean([r.mean_batch for r in reps])),
            utilization=float(np.mean(report.utilization_per_replica)),
            tokens_per_s=toks / max(report.wall_time_s, 1e-12),
            mean_attributed_wh=float(
                np.mean([r.energy_j for r in report.requests]))
            / 3600.0 if report.requests else 0.0,
        )
        if formation:
            comp = sum(r.prefill_computed_tokens for r in reps)
            eff = sum(r.prefill_effective_tokens for r in reps)
            kw.update(
                prefill_padding_fraction=(0.0 if comp == 0
                                          else 1.0 - eff / comp),
                prefill_chunks=sum(r.prefill_chunks for r in reps),
                handoff_energy_j=report.handoff_energy_j,
                n_handoffs=report.n_handoffs)
        if isinstance(report, FleetReport):
            # telemetry appears only when a fleet axis is actually set,
            # so fleet="vector" alone stays field-identical to legacy
            if spec.autoscaler is not None or spec.controller is not None:
                kw.update(
                    transition_energy_j=report.transition_energy_j,
                    n_transitions=report.n_transitions)
            if spec.regions:
                kw.update(
                    gco2_total_g=report.gco2_total_g,
                    gco2_per_request_g=report.gco2_per_request_g,
                    usd_total=report.usd_total,
                    usd_per_request=report.usd_per_request,
                    client_latency_p99_s=report
                    .client_latency_percentiles()["p99"],
                    client_ttft_p99_s=report
                    .client_ttft_percentiles()["p99"])
    else:
        kw = dict(
            kind="serve", replicas=1,
            mean_batch=report.mean_batch,
            utilization=report.utilization,
            tokens_per_s=report.tokens_per_s,
            mean_attributed_wh=report.mean_attributed_energy_wh,
        )
        if formation:
            kw.update(
                prefill_padding_fraction=report.prefill_padding_fraction,
                prefill_chunks=report.prefill_chunks,
                handoff_energy_j=0.0, n_handoffs=0)
    ctl = getattr(report, "control", None)
    if spec.controller is not None and ctl is not None:
        kw.update(
            n_control_actions=ctl["n_control_actions"],
            mean_freq_scale=ctl["mean_freq_scale"],
            controller_overhead_s=ctl["controller_overhead_s"],
            control_actions=_freeze(tuple(ctl["control_actions"])))
    if spec.faults is not None:
        kw.update(
            n_failures=report.n_failures,
            n_retries=report.n_retries,
            n_failed=report.n_failed,
            n_completed=report.n_completed,
            wasted_energy_j=report.wasted_energy_j,
            goodput_wh_per_request=report.goodput_wh_per_request,
            availability=report.availability)
    if spec.workflow is not None:
        tasks = report.tasks
        done = [t for t in tasks if t.completed]
        kw.update(
            n_tasks=len(tasks), n_tasks_completed=len(done),
            mean_task_latency_s=(float(np.mean(
                [t.latency_s for t in done])) if done else 0.0),
            mean_task_critical_path_s=(float(np.mean(
                [t.critical_path_s for t in done])) if done else 0.0),
            # total energy (idle and handoffs included) over offered
            # tasks: the fleet-level "Wh per unit of work" the paper's
            # serving sections argue about
            mean_energy_per_task_wh=(report.total_energy_j
                                     / len(tasks) / 3600.0
                                     if tasks else 0.0),
            prefix_reused_tokens=report.prefix_reused_tokens)
    mean_lat = (float(np.mean([r.latency for r in report.completed]))
                if report.completed else 0.0)
    mean_ttft = (float(np.mean([r.ttft for r in report.completed]))
                 if report.completed else 0.0)
    return RunResult(
        spec_hash=spec.spec_hash(),
        n_requests=report.n, n_shed=report.n_shed,
        total_energy_j=report.total_energy_j,
        busy_energy_j=report.busy_energy_j,
        idle_energy_j=report.idle_energy_j,
        gated_energy_j=report.gated_energy_j,
        mean_energy_wh=report.mean_energy_per_request_wh,
        idle_fraction=report.idle_energy_j / total,
        gated_fraction=report.gated_energy_j / total,
        wall_time_s=report.wall_time_s,
        mean_latency_s=mean_lat, mean_ttft_s=mean_ttft,
        latency_p50_s=lat["p50"], latency_p90_s=lat["p90"],
        latency_p99_s=lat["p99"],
        ttft_p50_s=ttft["p50"], ttft_p90_s=ttft["p90"],
        ttft_p99_s=ttft["p99"],
        slo_attainment=report.slo_attainment,
        admitted_attainment=admitted,
        tier_attainment=_tier_attainment(report),
        shed_arrival_times=tuple(r.arrival_time for r in report.shed),
        trace_coverage=(trace.coverage(report.total_energy_j)
                        if trace is not None else None),
        energy_by_state_j=(trace.energy_by_state()
                           if trace is not None else None),
        time_by_state_s=(trace.time_by_state()
                         if trace is not None else None),
        report=report, **kw)


# ---------------------------------------------------------------------------
# resolution: profile
# ---------------------------------------------------------------------------
def _profile_lengths(spec: ExperimentSpec, seed: int) -> np.ndarray:
    """Prompt lengths of one padded profile batch: log-uniform over
    ``prompt_range`` (the §2 sampler), exact when the range is pinned."""
    lo, hi = spec.prompt_range
    if lo == hi:
        return np.full(spec.max_batch, int(lo), dtype=int)
    rng = np.random.default_rng(seed)
    return np.exp(rng.uniform(np.log(lo), np.log(hi),
                              size=spec.max_batch)).astype(int)


def _run_profile(spec: ExperimentSpec) -> RunResult:
    from repro_torch.batching.static import pad_batch
    prof = PhaseProfiler(spec.model_config(), spec.device_spec(),
                         make_policy(spec.fmt),
                         energy_model_cls=spec._energy_model_cls(),
                         n_chips=spec.n_chips,
                         stack=spec.stack or "eager")
    out_lo, out_hi = spec.output_range
    out_tokens = int(round((out_lo + out_hi) / 2))
    b = spec.max_batch
    recs = []
    bounds = None
    for k in range(spec.profile_seeds):
        lens = _profile_lengths(spec, spec.seed + k)
        batch = pad_batch([np.zeros(n, np.int32) for n in lens])
        s_pad = batch.tokens.shape[1]
        pre = prof.profile_prefill(b, s_pad)
        dec = prof.profile_decode(b, s_pad, out_tokens)
        gen = combine({"prefill": pre, "decode": dec})
        if bounds is None:
            bounds = (pre.bound, dec.bound)
        recs.append({
            "eff": batch.effective_tokens, "comp": batch.computed_tokens,
            "pre_j": pre.energy_j, "dec_j": dec.energy_j,
            "gen_j": gen.energy_j, "pre_t": pre.latency,
            "dec_t": dec.latency,
        })
    m = {k: float(np.mean([r[k] for r in recs])) for k in recs[0]}
    out_total = b * out_tokens
    return RunResult(
        spec_hash=spec.spec_hash(), kind="profile",
        n_requests=b,
        total_energy_j=m["gen_j"], busy_energy_j=m["gen_j"],
        mean_energy_wh=m["gen_j"] / b / 3600.0,
        wall_time_s=m["pre_t"] + m["dec_t"], mean_batch=float(b),
        prefill_energy_j=m["pre_j"], prefill_latency_s=m["pre_t"],
        prefill_bound=bounds[0],
        decode_energy_j=m["dec_j"], decode_latency_s=m["dec_t"],
        decode_bound=bounds[1],
        decode_j_per_tok=m["dec_j"] / out_total,
        decode_ms_per_tok=m["dec_t"] / out_tokens * 1e3,
        effective_tokens=m["eff"], computed_tokens=m["comp"],
        padding_fraction=1.0 - m["eff"] / m["comp"],
        pre_j_per_eff_in=m["pre_j"] / m["eff"],
        dec_j_per_eff_in=m["dec_j"] / m["eff"],
        gen_j_per_eff_in=m["gen_j"] / m["eff"],
        pre_j_per_comp_in=m["pre_j"] / m["comp"],
        dec_j_per_comp_in=m["dec_j"] / m["comp"],
        pre_j_per_out=m["pre_j"] / out_total,
        dec_j_per_out=m["dec_j"] / out_total,
        gen_j_per_out=m["gen_j"] / out_total)


#: re-exported so `repro_torch.api` alone covers the common surface
__all__ = ["ExperimentSpec", "RunResult", "result_from_report",
           "ARRIVALS", "PIPELINES", "MODES", "ENERGY_MODELS", "BACKENDS",
           "BATCH_POLICIES", "AUTOSCALERS", "CONTROLLERS", "PAPER_MODELS",
           "Request", "ServeReport", "ClusterReport", "FleetReport"]
