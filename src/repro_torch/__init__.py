"""PyTorch/CUDA port of the ``repro`` package, for one NVIDIA H100.

Module paths mirror ``repro``'s, so each counterpart is found by name.
The port imports ``torch`` and never ``jax`` or anything under
``repro``: the JAX package is the reference the tests hold it against.

Public surface (the declarative experiment API, as the reference's)::

    import repro_torch

    spec = repro_torch.ExperimentSpec(model="llama-3.1-8b",
                                      fmt="bfloat16", arrival="burst",
                                      arrival_params={"burst_size": 20,
                                                      "burst_gap_s": 6.0})
    grid = repro_torch.sweep(spec, axes={"scheduler": [None, "window"]})

A spec with ``backend="executed"`` serves its model for real, on the
torch device named by ``torch_device=`` (``"cuda"`` by default) of
``ExperimentSpec.run``, ``run_spec`` and ``sweep``; without a CUDA device
it raises unless the caller passes ``torch_device="cpu"``. The int8 and
nf4 projections and the prefill and decode attention run through
hand-written CUDA kernels (:mod:`repro_torch.kernels`). Lower layers
remain importable directly (``repro_torch.serving``,
``repro_torch.models``, ...).
"""
from repro_torch.api import (ExperimentSpec, RunResult,  # noqa: F401
                             result_from_report, ARRIVALS, PIPELINES, MODES,
                             ENERGY_MODELS, BACKENDS, BATCH_POLICIES)
from repro_torch.batching.policy import (BatchPolicy, SlotCountPolicy,  # noqa: F401
                                         TokenBudgetPolicy, LengthSortedPolicy,
                                         ChunkedPrefillPolicy,
                                         make_batch_policy)
from repro_torch.configs.paper_zoo import PAPER_MODELS  # noqa: F401
from repro_torch.control import (Controller, ControlView,  # noqa: F401
                                 StaticController, ReactiveController,
                                 MPCController, CONTROLLERS, make_controller)
from repro_torch.faults import (FaultEvent, FaultSchedule,  # noqa: F401
                                FAULT_KINDS, RetryPolicy, RETRY_POLICIES,
                                make_faults, make_retry,
                                random_fault_schedule, check_run_invariants,
                                InvariantViolation)
from repro_torch.serving.backend import (InferenceBackend, PhaseResult,  # noqa: F401
                                         DecodeRun, AnalyticBackend,
                                         ExecutedBackend, ReplayBackend,
                                         RecordingBackend, make_backend)
from repro_torch.serving.scheduler import HorizonStop  # noqa: F401
from repro_torch.sweep import (sweep, run_spec, expand_grid, Option,  # noqa: F401
                               Claim, ClaimResult, SweepResult, select,
                               check_claims, WORKERS_ENV)
from repro_torch.workflows import (Workflow, WorkflowStep,  # noqa: F401
                                   TaskReport, WorkflowSource,
                                   WORKFLOW_TEMPLATES, make_workflow)

__version__ = "0.10.0"

__all__ = [
    "__version__",
    "ExperimentSpec", "RunResult", "result_from_report",
    "ARRIVALS", "PIPELINES", "MODES", "ENERGY_MODELS", "BACKENDS",
    "BATCH_POLICIES", "PAPER_MODELS",
    "BatchPolicy", "SlotCountPolicy", "TokenBudgetPolicy",
    "LengthSortedPolicy", "ChunkedPrefillPolicy", "make_batch_policy",
    "Controller", "ControlView", "StaticController", "ReactiveController",
    "MPCController", "CONTROLLERS", "make_controller",
    "InferenceBackend", "PhaseResult", "DecodeRun", "AnalyticBackend",
    "ExecutedBackend", "ReplayBackend", "RecordingBackend",
    "make_backend", "HorizonStop",
    "sweep", "run_spec", "expand_grid", "Option",
    "Claim", "ClaimResult", "SweepResult", "select", "check_claims",
    "WORKERS_ENV",
    "Workflow", "WorkflowStep", "TaskReport", "WorkflowSource",
    "WORKFLOW_TEMPLATES", "make_workflow",
    "FaultEvent", "FaultSchedule", "FAULT_KINDS",
    "RetryPolicy", "RETRY_POLICIES", "make_faults", "make_retry",
    "random_fault_schedule", "check_run_invariants",
    "InvariantViolation",
]
