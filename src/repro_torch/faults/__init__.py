"""Fault injection & resilience for the serving stack.
The port's own copy of ``repro.faults``.

Deterministic, seeded fault schedules (:class:`FaultSchedule`) drive
crash/preempt/slowdown/power-cap/link-degrade events through the
serving engines; :class:`RetryPolicy` adds the resilience side —
timeouts, exponential-backoff retries, graceful drain on preemption
notices, health-aware failover routing, and hedged re-submission.
:func:`check_run_invariants` is the chaos harness: any run, under any
schedule, must terminate every request, free every KV page, and
account for 100% of its energy — including the joules wasted on
failed attempts.
"""
from repro_torch.faults.invariants import (InvariantViolation,
                                     check_run_invariants)
from repro_torch.faults.policies import (RETRY_POLICIES, RetryPolicy,
                                   make_retry)
from repro_torch.faults.schedule import (FAULT_KINDS, FaultBoundary,
                                   FaultEvent, FaultSchedule,
                                   make_faults, random_fault_schedule)

__all__ = [
    "FAULT_KINDS",
    "FaultBoundary",
    "FaultEvent",
    "FaultSchedule",
    "InvariantViolation",
    "RETRY_POLICIES",
    "RetryPolicy",
    "check_run_invariants",
    "make_faults",
    "make_retry",
    "random_fault_schedule",
]
