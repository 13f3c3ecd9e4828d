"""Request lifecycle objects for the serving engine: the port's own copy
of ``repro.serving.requests``."""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional

import numpy as np


class RequestStatus(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    SHED = "shed"           # rejected by an admission-control scheduler
    FAILED = "failed"       # lost to a fault (crash/preempt/timeout)


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: Optional[np.ndarray]        # token ids; None in sim-only mode
    prompt_len: int
    max_new_tokens: int
    arrival_time: float = 0.0
    # SLO
    priority: int = 0                   # higher = more important
    deadline_s: float = math.inf        # latency SLO relative to arrival
    slo_tier: Optional[str] = None
    # scheduling
    release_time: Optional[float] = None
    shed_reason: Optional[str] = None
    # workflow membership
    task_id: Optional[int] = None
    step: Optional[str] = None
    kv_parent: Optional[int] = None
    kv_pin: int = 0
    # lifecycle
    status: RequestStatus = RequestStatus.QUEUED
    t_prefill_start: float = -1.0
    t_first_token: float = -1.0
    t_done: float = -1.0
    prefilled_tokens: int = 0           # prompt tokens whose KV exists
    tokens_generated: int = 0
    generated: list = dataclasses.field(default_factory=list)
    # accounting
    energy_j: float = 0.0
    # resilience
    n_attempts: int = 0
    wasted_energy_j: float = 0.0
    fail_reason: Optional[str] = None
    hedge_of: Optional[int] = None

    @property
    def effective_arrival(self) -> float:
        return (self.release_time if self.release_time is not None
                else self.arrival_time)

    @property
    def abs_deadline(self) -> float:
        return self.arrival_time + self.deadline_s

    @property
    def latency(self) -> float:
        if self.t_done < 0:
            return math.nan
        return self.t_done - self.arrival_time

    @property
    def ttft(self) -> float:
        if self.t_first_token < 0:
            return math.nan
        return self.t_first_token - self.arrival_time

    @property
    def met_deadline(self) -> bool:
        if self.t_done < 0:
            return False
        return self.latency <= self.deadline_s + 1e-12

    @property
    def energy_wh(self) -> float:
        return self.energy_j / 3600.0
