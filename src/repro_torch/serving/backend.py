"""Inference backends: phase costing and execution behind one protocol.

Counterpart of ``repro.serving.backend`` without its replay and
recording backends (ROADMAP A4(a)). The engine decides which phase runs
next; a backend owns what the phase costs and, optionally, what it
computes:

* :class:`AnalyticBackend`: the paper's phase-aware analytic energy model
  (:mod:`repro_torch.core.energy` over :mod:`repro_torch.core.workload`),
  float for float the reference's;
* :class:`ExecutedBackend`: the analytic costing plus the real model
  steps (greedy decoding) on the device, with the decode-cache slot
  management of :mod:`repro_torch.batching.continuous`.

Every phase returns a :class:`PhaseResult`: the analytic clock
(``latency_s``), energy and regime, and for an executed phase the host
wall time it took (``wall_s``, read after the argmax is on the host, so
the device work is in it). The reference's executed choices are kept:

* a prefill batch is right-padded to a multiple of 8 tokens, capped at
  ``buf_len``;
* ``release_slot`` zeroes the slot's feed token and does not evict the
  cache lane (lanes are independent);
* ``finish_request`` (sequential mode) is a fresh greedy run per request.
"""
from __future__ import annotations

import abc
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.batching.continuous import insert_cache_slot
from repro_torch.configs.base import ModelConfig
from repro_torch.core import workload as W
from repro_torch.core.energy import EnergyModel, EnergyReport
from repro_torch.core.hardware import H100_SXM, DeviceSpec
from repro_torch.core.precision import PrecisionPolicy, make_policy


# ---------------------------------------------------------------------------
# protocol data types
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PhaseResult:
    """What one phase cost (and produced)."""

    phase: str                  # "prefill" | "decode" | "idle" | "gated"
    latency_s: float            # analytic clock
    energy_j: float             # analytic energy
    tokens: int = 0             # new tokens this phase produced
    batch: float = 0.0          # live batch during the phase
    bound: Optional[str] = None  # analytic regime, when the backend knows
    # host wall time of the real execution, device work included (None
    # for a phase that was only costed)
    wall_s: Optional[float] = None

    @property
    def power_w(self) -> float:
        return self.energy_j / max(self.latency_s, 1e-12)


@dataclasses.dataclass
class PrefillBatch:
    """One prefill iteration as the scheduler formed it: ``(slot,
    request)`` pairs (slot None in sequential mode) and the padded length
    the batch computes. Chunked prefill (``chunk_len > 0``) covers
    ``chunk_len`` prompt tokens of one request attending to the
    ``chunk_start`` tokens already in its cache."""

    picks: List[Tuple[Optional[int], Any]]
    pad_len: int
    stack: str = "fused"
    chunk_start: int = 0
    chunk_len: int = 0

    @property
    def n(self) -> int:
        return len(self.picks)

    @property
    def requests(self) -> List[Any]:
        return [r for _, r in self.picks]


@dataclasses.dataclass
class DecodeBatch:
    """One decode step over the live slots."""

    slots: List[int]
    requests: List[Any]
    cache_lens: List[int]       # per-request prompt + generated tokens
    stack: str = "fused"

    @property
    def n(self) -> int:
        return len(self.slots)


@dataclasses.dataclass
class DecodeRun:
    """A run of decode steps over a frozen live batch. ``t_end`` is
    ``t_start`` folded left with the per-step latencies, the additions a
    per-step loop makes; ``t_penult`` is the start of the final step."""

    latencies_s: np.ndarray     # (n_steps,)
    energies_j: np.ndarray      # (n_steps,)
    t_end: float
    tokens_per_step: int        # == batch size (one token per live slot)
    bound: Optional[str] = None
    t_penult: float = 0.0

    @property
    def n_steps(self) -> int:
        return len(self.latencies_s)

    @property
    def tokens(self) -> int:
        return self.n_steps * self.tokens_per_step


# ---------------------------------------------------------------------------
# protocol
# ---------------------------------------------------------------------------
class InferenceBackend(abc.ABC):
    """Phase execution and costing behind the serving loop: ``prefill``,
    ``decode_step``, ``decode_tail`` (sequential mode's bulk decode) and
    ``idle``, with the optional hooks ``start``, ``release_slot`` and
    ``finish_request``."""

    name: str = "base"

    def start(self) -> None:
        """Per-run reset."""

    @abc.abstractmethod
    def prefill(self, batch: PrefillBatch) -> PhaseResult:
        """Execute one (possibly batched, padded) prefill."""

    @abc.abstractmethod
    def decode_step(self, batch: DecodeBatch) -> PhaseResult:
        """Execute ONE decode step for all live slots."""

    def decode_run(self, batch: DecodeBatch, max_steps: int, *,
                   t_start: float = 0.0, stop=None) -> DecodeRun:
        """Up to ``max_steps`` decode steps for a frozen live batch.
        ``batch.cache_lens`` describes the first step; each later step
        sees every cache one token longer. ``stop`` (an object with the
        reference's ``HorizonStop.hit(now)`` and ``n_steps(ends)``) ends
        the run after the first step whose end time reaches it. This
        default loops :meth:`decode_step`."""
        if max_steps < 1:
            raise ValueError("decode_run needs max_steps >= 1")
        lats: List[float] = []
        ens: List[float] = []
        now = t_start
        penult = t_start
        bound = None
        cur = batch
        for j in range(max_steps):
            if j:
                cur = dataclasses.replace(
                    batch, cache_lens=[c + j for c in batch.cache_lens])
            res = self.decode_step(cur)
            lats.append(res.latency_s)
            ens.append(res.energy_j)
            if bound is None:
                bound = res.bound
            penult = now
            now += res.latency_s
            if stop is not None and stop.hit(now):
                break
        return DecodeRun(latencies_s=np.asarray(lats, dtype=np.float64),
                         energies_j=np.asarray(ens, dtype=np.float64),
                         t_end=float(now), tokens_per_step=batch.n,
                         bound=bound, t_penult=penult)

    @abc.abstractmethod
    def decode_tail(self, request: Any, n_steps: int,
                    stack: str = "eager") -> PhaseResult:
        """Cost ``n_steps`` sequential decode steps for one request."""

    @abc.abstractmethod
    def idle(self, dt: float, state: str = "idle") -> PhaseResult:
        """Account ``dt`` seconds in a non-serving power state."""

    def release_slot(self, slot: int) -> None:
        """A decode slot was freed (its request finished)."""

    def finish_request(self, request: Any) -> None:
        """Sequential-mode hook after a request's phases were costed."""


_ARANGE = np.arange(1024, dtype=np.float64)
_ARANGE.flags.writeable = False


def _arange_f64(k: int) -> np.ndarray:
    """Read-only ``0..k-1`` float64 view, grown on demand (an in-place op
    on it raises instead of corrupting later runs)."""
    global _ARANGE
    if k > len(_ARANGE):
        _ARANGE = np.arange(max(k, 2 * len(_ARANGE)), dtype=np.float64)
        _ARANGE.flags.writeable = False
    return _ARANGE[:k]


# ---------------------------------------------------------------------------
# analytic
# ---------------------------------------------------------------------------
class AnalyticBackend(InferenceBackend):
    """The paper's phase-aware analytic model as a backend: workloads from
    :mod:`repro_torch.core.workload` evaluated by an
    :class:`~repro_torch.core.energy.EnergyModel` for this (device,
    policy, n_chips)."""

    name = "analytic"

    def __init__(self, cfg: ModelConfig, *,
                 device: DeviceSpec = H100_SXM,
                 policy: Optional[PrecisionPolicy] = None,
                 fmt: str = "bfloat16", n_chips: int = 1,
                 energy_model_cls=EnergyModel,
                 energy_model: Optional[EnergyModel] = None):
        self.cfg = cfg
        self.device = device
        self.policy = policy if policy is not None else make_policy(fmt)
        self.n_chips = n_chips
        self.energy = (energy_model if energy_model is not None
                       else energy_model_cls(device, self.policy))
        # nominal-clock anchor for the DVFS actuator
        self._nominal_device = device if device.freq_scale == 1.0 else None

    def set_freq_scale(self, target: float) -> None:
        """Move every later phase to the operating point at ``target`` of
        the nominal clock, rebuilt from the nominal spec (not composed
        onto the current point), so repeated changes cannot drift."""
        if target == self.device.freq_scale:
            return
        base = self._nominal_device
        if base is None:
            # constructed at a scaled point: recover the nominal spec once
            unwound = self.device.with_freq_scale(
                1.0 / self.device.freq_scale)
            base = dataclasses.replace(
                unwound, name=self.device.name.split("@f")[0],
                freq_scale=1.0)
            self._nominal_device = base
        self.device = base.with_freq_scale(target)
        self.energy = type(self.energy)(self.device, self.policy)

    # -- EnergyReport-level entry points --------------------------------
    def prefill_report(self, batch: int, seq: int,
                       stack: str = "eager") -> EnergyReport:
        return self.energy.evaluate(
            W.prefill_workload(self.cfg, batch, seq, stack=stack),
            self.n_chips)

    def decode_step_report(self, batch: int, cache_len: int,
                           stack: str = "eager") -> EnergyReport:
        return self.energy.evaluate(
            W.decode_step_workload(self.cfg, batch, cache_len,
                                   stack=stack), self.n_chips)

    def decode_report(self, batch: int, prompt_len: int, new_tokens: int,
                      stack: str = "eager") -> EnergyReport:
        return self.energy.evaluate(
            W.decode_workload(self.cfg, batch, prompt_len, new_tokens,
                              stack=stack), self.n_chips)

    def train_report(self, batch: int, seq: int,
                     stack: str = "fused") -> EnergyReport:
        return self.energy.evaluate(
            W.train_step_workload(self.cfg, batch, seq, stack=stack),
            self.n_chips)

    # -- protocol -------------------------------------------------------
    def prefill(self, batch: PrefillBatch) -> PhaseResult:
        if batch.chunk_len:
            # chunk_len new prompt tokens attending to the chunk_start
            # tokens already cached (the weights are read again a chunk)
            rep = self.energy.evaluate(
                W.prefill_chunk_workload(self.cfg, batch.n,
                                         batch.chunk_len,
                                         batch.chunk_start,
                                         stack=batch.stack),
                self.n_chips)
        else:
            rep = self.prefill_report(batch.n, batch.pad_len,
                                      stack=batch.stack)
        return PhaseResult(phase="prefill", latency_s=rep.latency,
                           energy_j=rep.energy_j, tokens=batch.n,
                           batch=float(batch.n), bound=rep.bound)

    def decode_step(self, batch: DecodeBatch) -> PhaseResult:
        rep = self.decode_step_report(
            batch.n, int(np.mean(batch.cache_lens)), stack=batch.stack)
        return PhaseResult(phase="decode", latency_s=rep.latency,
                           energy_j=rep.energy_j, tokens=batch.n,
                           batch=float(batch.n), bound=rep.bound)

    def decode_run(self, batch: DecodeBatch, max_steps: int, *,
                   t_start: float = 0.0, stop=None) -> DecodeRun:
        """All ``max_steps`` steps in one vectorized evaluation, float for
        float the :meth:`decode_step` loop: per-step mean cache lengths,
        workload terms and the ``t_start`` latency fold repeat the scalar
        arithmetic."""
        if max_steps < 1:
            raise ValueError("decode_run needs max_steps >= 1")
        n = batch.n
        # per-step int(np.mean(cache_lens)): every cache grows by one a
        # step, so the exact-integer sum grows by n; the division is the
        # one np.mean performs
        s0 = sum(batch.cache_lens)
        sums = (np.float64(s0)
                + np.float64(n) * _arange_f64(max_steps))
        ctx = (sums / np.float64(n)).astype(np.int64)
        template, flops, act = W.decode_step_arrays(
            self.cfg, n, ctx, stack=batch.stack)
        lat, en, bound = self.energy.evaluate_steps(
            template, flops, act, self.n_chips)
        buf = np.empty(max_steps + 1)
        buf[0] = t_start
        buf[1:] = lat
        nows = np.add.accumulate(buf)[1:]   # strict left fold
        j = max_steps if stop is None else stop.n_steps(nows)
        return DecodeRun(latencies_s=lat[:j], energies_j=en[:j],
                         t_end=float(nows[j - 1]), tokens_per_step=n,
                         bound=bound,
                         t_penult=(float(nows[j - 2]) if j > 1
                                   else t_start))

    def decode_tail(self, request: Any, n_steps: int,
                    stack: str = "eager") -> PhaseResult:
        rep = self.decode_report(1, request.prompt_len, n_steps,
                                 stack=stack)
        return PhaseResult(phase="decode", latency_s=rep.latency,
                           energy_j=rep.energy_j, tokens=n_steps,
                           batch=1.0, bound=rep.bound)

    def idle(self, dt: float, state: str = "idle") -> PhaseResult:
        return PhaseResult(phase=state, latency_s=dt,
                           energy_j=self.device.state_power(state) * dt)


# ---------------------------------------------------------------------------
# executed
# ---------------------------------------------------------------------------
class ExecutedBackend(AnalyticBackend):
    """Analytic costing plus greedy execution of prefill and decode
    phases on a model. The clock stays analytic (what the paper measures
    per phase); each executed phase also carries its host wall time.

    The precision policy is the model's, and so is the config the
    phases are priced for unless ``cost_cfg`` names another (a reduced
    model priced at full width). ``record_logits``:
    keep each request's first-token logits (f32, on the host) in
    ``first_logits[req_id]``, for checks against a sequential run. An
    audio model is refused: the serving path carries no frames (the
    reference's backend fails on it at its first prefill with
    ``KeyError: 'frames'``).
    ``prefill_shapes`` holds the (rows, padded length) of each batched
    prefill, in order, and for an MoE model ``prefill_aux`` its
    layer-mean router metrics (``dropped_fraction`` among them)."""

    name = "executed"

    def __init__(self, model, params, *, max_batch: int,
                 buf_len: int = 256, record_logits: bool = False,
                 cost_cfg: Optional[ModelConfig] = None, **analytic_kw):
        if model.cfg.family == "audio":
            raise ValueError(
                f"{model.cfg.name}: the serving path carries no frames, and "
                f"an audio model's prefill needs batch['frames'] (the "
                f"reference's ExecutedBackend raises KeyError: 'frames'); "
                f"run it through Model.prefill and Model.decode_step")
        super().__init__(cost_cfg or model.cfg, policy=model.policy,
                         **analytic_kw)
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.buf_len = buf_len
        self.record_logits = record_logits
        self.first_logits: Dict[int, torch.Tensor] = {}
        self.prefill_shapes: List[Tuple[int, int]] = []
        self.prefill_aux: List[Dict[str, float]] = []
        self.start()

    def start(self) -> None:
        self.cache = self.model.init_cache(self.max_batch, self.buf_len)
        self.slot_tokens = torch.zeros((self.max_batch, 1),
                                       dtype=torch.long,
                                       device=self.model.device)

    # -- protocol -------------------------------------------------------
    def prefill(self, batch: PrefillBatch) -> PhaseResult:
        if batch.chunk_len:
            raise ValueError("chunked prefill is costed but not executed "
                             "(its scheduler waits for ROADMAP A4(a))")
        res = super().prefill(batch)
        if all(slot is None for slot, _ in batch.picks):
            return res                  # sequential: finish_request runs it
        t0 = time.perf_counter()
        self._execute_prefill(batch.picks)
        return dataclasses.replace(res, wall_s=time.perf_counter() - t0)

    def decode_step(self, batch: DecodeBatch) -> PhaseResult:
        res = super().decode_step(batch)
        t0 = time.perf_counter()
        self._execute_decode(batch)
        return dataclasses.replace(res, wall_s=time.perf_counter() - t0)

    def decode_run(self, batch: DecodeBatch, max_steps: int, *,
                   t_start: float = 0.0, stop=None) -> DecodeRun:
        # real execution is stepwise: the protocol's decode_step loop
        # (its analytic clock equals the fused path's)
        return InferenceBackend.decode_run(self, batch, max_steps,
                                           t_start=t_start, stop=stop)

    def release_slot(self, slot: int) -> None:
        # zeroing just the feed token keeps freed lanes deterministic;
        # the full lane evict is not run per finish (lanes are
        # independent, so stale state cannot change live outputs)
        self.slot_tokens[slot, 0] = 0

    def finish_request(self, request: Any) -> None:
        """Sequential mode: the real greedy generation end to end, with a
        fresh per-request cache and no slot machinery."""
        r = request
        toks = torch.as_tensor(r.prompt[None, :], dtype=torch.long,
                               device=self.model.device)
        logits, cache = self.model.prefill(
            self.params, {"tokens": toks},
            buf_len=r.prompt_len + r.max_new_tokens + 1)
        self._record(r, logits[0])
        tok = torch.argmax(logits, -1)[:, None]
        r.generated = [int(tok[0, 0])]
        for _ in range(r.max_new_tokens - 1):
            logits, cache = self.model.decode_step(self.params, tok, cache)
            tok = torch.argmax(logits, -1)[:, None]
            r.generated.append(int(tok[0, 0]))

    # -- real execution -------------------------------------------------
    def _record(self, r, logits: torch.Tensor) -> None:
        if self.record_logits:
            self.first_logits[r.req_id] = logits.float().cpu()

    def _execute_prefill(self, picks) -> None:
        exec_pad = max(r.prompt_len for _, r in picks)
        exec_pad = min(((exec_pad + 7) // 8) * 8, self.buf_len)
        toks = np.zeros((len(picks), exec_pad), np.int64)
        lens = np.zeros((len(picks),), np.int32)
        for j, (_, r) in enumerate(picks):
            toks[j, :r.prompt_len] = r.prompt[:exec_pad]
            lens[j] = r.prompt_len
        dev = self.model.device
        logits, pcache, aux = self.model.prefill(
            self.params, {"tokens": torch.from_numpy(toks).to(dev)},
            buf_len=self.buf_len, lengths=torch.from_numpy(lens).to(dev),
            with_aux=True)
        first = torch.argmax(logits, -1).cpu().numpy()
        self.prefill_shapes.append(toks.shape)
        if self.model.cfg.is_moe:
            self.prefill_aux.append({k: float(v) for k, v in aux.items()})
        for j, (slot, r) in enumerate(picks):
            self._record(r, logits[j])
            r.generated = [int(first[j])]
            insert_cache_slot(self.cache, pcache, j, slot)
            self.slot_tokens[slot, 0] = int(first[j])

    def _execute_decode(self, batch: DecodeBatch) -> None:
        logits, self.cache = self.model.decode_step(
            self.params, self.slot_tokens, self.cache)
        nxt = torch.argmax(logits, -1)
        self.slot_tokens = nxt[:, None]
        arr = nxt.cpu().numpy()
        for slot, req in zip(batch.slots, batch.requests):
            req.generated.append(int(arr[slot]))
