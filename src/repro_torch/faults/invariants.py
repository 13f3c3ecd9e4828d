"""Resilience invariants every fault-injected run must satisfy.
The port's own copy of ``repro.faults.invariants``.

:func:`check_run_invariants` is the chaos-testing harness the fault
subsystem is validated against: under *any* seeded schedule the serving
stack must (1) terminate every request in a terminal state, (2) leak no
KV page across crashes, and (3) account for 100% of the energy it
billed — including the joules wasted on failed attempts. The checks are
pure post-conditions over a report (plus, optionally, the engines and
power trace of the run), so benchmarks and CI smoke tests can assert
them without knowing anything about the schedule that ran.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np

from repro_torch.serving.requests import RequestStatus

__all__ = ["InvariantViolation", "check_run_invariants"]

#: terminal request states — everything an engine may leave behind
_TERMINAL = (RequestStatus.DONE, RequestStatus.SHED,
             RequestStatus.FAILED)


class InvariantViolation(AssertionError):
    """A fault-injected run broke a resilience post-condition."""


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise InvariantViolation(msg)


def _close(a: float, b: float, atol: float) -> bool:
    return bool(np.isclose(a, b, rtol=1e-9, atol=atol))


def _check_requests(requests: Iterable, retry) -> None:
    for r in requests:
        _check(r.status in _TERMINAL,
               f"request {r.req_id} ended non-terminal: {r.status}")
        if r.status is RequestStatus.FAILED:
            _check(r.fail_reason is not None,
                   f"request {r.req_id} FAILED without a fail_reason")
            if (retry is not None
                    and r.fail_reason in ("crash", "preempt")):
                _check(r.n_attempts >= retry.max_retries,
                       f"request {r.req_id} FAILED terminally on "
                       f"{r.fail_reason!r} with only {r.n_attempts} "
                       f"attempts (< max_retries="
                       f"{retry.max_retries}: it should have been "
                       "retried)")


def _check_engine(i: int, eng) -> None:
    b = eng.batcher
    _check(b.n_live == 0,
           f"engine {i}: {b.n_live} requests still live after the run")
    _check(b.n_waiting == 0,
           f"engine {i}: {b.n_waiting} requests still queued")
    kv = b.kv
    kv.check_invariants()
    _check(kv.used_pages == 0,
           f"engine {i}: {kv.used_pages} KV pages leaked "
           "(crash/retry left pages allocated)")
    _check(not kv.lingering,
           f"engine {i}: lingering pinned tables "
           f"{sorted(kv.lingering)} survived the run")


def _check_ledger(rep, atol: float) -> None:
    """State-ledger closure: busy + idle + gated + transition joules
    sum to the reported total (down time draws nothing)."""
    ledger = (rep.busy_energy_j + rep.idle_energy_j
              + rep.gated_energy_j + rep.transition_energy_j)
    _check(_close(rep.total_energy_j, ledger, atol),
           f"energy ledger does not close: total={rep.total_energy_j} "
           f"!= busy+idle+gated+transition={ledger}")


def check_run_invariants(report, *, engines: Sequence = (),
                         retry=None, trace=None,
                         atol: float = 1e-6) -> None:
    """Assert the resilience post-conditions on a finished run.

    ``report`` is a :class:`~repro_torch.serving.engine.ServeReport` or a
    :class:`~repro_torch.serving.cluster.ClusterReport`; pass the engines
    that ran (``[engine]`` or ``cluster.replicas``) to also verify KV
    hygiene, and the run's :class:`~repro_torch.serving.trace.PowerTrace` to
    verify the timeline accounts for the full energy bill. Raises
    :class:`InvariantViolation` (an ``AssertionError``) on the first
    violated post-condition.
    """
    _check_requests(report.requests, retry)
    _check_requests(report.shed, retry)
    reps = getattr(report, "replica_reports", None)
    if reps is not None:
        for rep in reps:
            _check_ledger(rep, atol)
        # attribution is fleet-wide: a retried request's final-attempt
        # joules land on a different replica than the waste its failed
        # attempts left behind, and disaggregated handoff energy is a
        # fleet-level line item
        busy = report.busy_energy_j + report.handoff_energy_j
    else:
        _check_ledger(report, atol)
        busy = report.busy_energy_j
    attributed = sum(r.energy_j for r in report.requests)
    _check(_close(attributed + report.wasted_energy_j, busy, atol),
           "busy energy not fully attributed: "
           f"requests={attributed} + wasted="
           f"{report.wasted_energy_j} != busy={busy}")
    for i, eng in enumerate(engines):
        _check_engine(i, eng)
    if trace is not None:
        cov = trace.coverage(report.total_energy_j)
        _check(abs(cov - 1.0) <= 1e-6,
               f"power trace covers {cov:.9f} of the energy bill "
               "(faulty runs must still account for 100%)")
