"""Resilience policies: what the serving stack does about faults.
The port's own copy of ``repro.faults.policies``.

A :class:`RetryPolicy` bundles every client-side resilience knob the
engines understand:

* **retry budget + exponential backoff** — a request failed by a
  crash/preemption is re-queued at ``t_fail + backoff(attempt)`` until
  ``max_retries`` attempts are exhausted, after which it is terminal
  ``FAILED`` (the invariant checker's "FAILED-exhausted").
* **per-request timeout** — a request still queued ``timeout_s`` after
  arrival is failed instead of delivered (bounds the energy a dying
  fleet can sink into one request).
* **graceful drain** — on a preemption *notice*, stop admitting and
  evict the replica's queue so waiting work re-routes instead of
  dying with the replica at kill time.
* **hedged requests** — on clusters, a *retried* request is duplicated
  to a second healthy replica; first completion wins, the loser is
  cancelled and its joules are tallied as waste.

Failover routing (skipping dead/draining replicas) is not a knob —
any fault-aware cluster run does it.
"""
from __future__ import annotations

import dataclasses
import math

RETRY_POLICIES = ("backoff", "hedged")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    name: str = "backoff"
    max_retries: int = 3
    backoff_s: float = 0.5           # first-retry delay
    backoff_mult: float = 2.0        # exponential growth per attempt
    backoff_cap_s: float = 30.0
    timeout_s: float = math.inf      # queueing timeout (from arrival)
    drain_on_notice: bool = True     # graceful drain on preempt notice
    hedge: bool = False              # duplicate retries to 2 replicas

    def __post_init__(self):
        if self.name not in RETRY_POLICIES:
            raise ValueError(
                f"unknown retry policy {self.name!r}; "
                f"expected one of {RETRY_POLICIES}")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_s < 0 or self.backoff_cap_s < 0:
            raise ValueError("backoff delays must be >= 0")
        if self.backoff_mult < 1.0:
            raise ValueError("backoff_mult must be >= 1.0")
        if not (self.timeout_s > 0):
            raise ValueError("timeout_s must be > 0")

    def backoff(self, attempt: int) -> float:
        """Delay before re-queueing attempt ``attempt`` (0-based count
        of prior failures)."""
        return min(self.backoff_s * self.backoff_mult ** attempt,
                   self.backoff_cap_s)


def make_retry(name: str, **params) -> RetryPolicy:
    """Registry constructor mirroring ``make_policy``/``make_router``:
    ``hedged`` is ``backoff`` with request hedging on."""
    if name == "hedged":
        params.setdefault("hedge", True)
    return RetryPolicy(name=name, **params)
