"""The port's serving stack: the reference's exports, except the router
and the cluster, which wait for ROADMAP A4(b)."""
from repro_torch.serving.requests import Request, RequestStatus  # noqa: F401
from repro_torch.serving.arrival import (fixed_arrivals,  # noqa: F401
                                         uniform_random_arrivals,
                                         poisson_arrivals, burst_arrivals,
                                         diurnal_arrivals, paper_requests)
from repro_torch.serving.backend import (InferenceBackend, PhaseResult,  # noqa: F401
                                         PrefillBatch, DecodeBatch,
                                         AnalyticBackend, ExecutedBackend,
                                         ReplayBackend, RecordingBackend,
                                         make_backend, BACKENDS)
from repro_torch.serving.engine import ServeEngine, ServeReport  # noqa: F401
from repro_torch.serving.scheduler import (Scheduler, ScheduleResult,  # noqa: F401
                                           PassthroughScheduler,
                                           PacedScheduler, WindowScheduler,
                                           DeadlineScheduler,
                                           EnergyBudgetScheduler,
                                           make_scheduler, SCHEDULERS)
from repro_torch.serving.slo import (SLOTier, INTERACTIVE, STANDARD,  # noqa: F401
                                     BATCH, TIERS, get_tier, assign_slos,
                                     attainment, slo_summary,
                                     percentile_dict,
                                     estimate_request_latency,
                                     estimate_service_rate)
from repro_torch.serving.trace import PowerTrace, Segment, STATES  # noqa: F401
