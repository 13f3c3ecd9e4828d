"""Inference backends: phase costing and execution behind one protocol.

Counterpart of ``repro.serving.backend``. The engine decides which phase
runs next; a backend owns what the phase costs and, optionally, what it
computes:

* :class:`AnalyticBackend`: the paper's phase-aware analytic energy model
  (:mod:`repro_torch.core.energy` over :mod:`repro_torch.core.workload`),
  float for float the reference's;
* :class:`ExecutedBackend`: the analytic costing plus the real model
  steps (greedy decoding) on the device, with the decode-cache slot
  management of :mod:`repro_torch.batching.continuous`;
* :class:`ReplayBackend`: a recorded per-phase latency and power trace
  (the reference's ``repro-replay/v1`` JSON schema) replayed through
  the live scheduler;
* :class:`RecordingBackend`: wraps any backend and records its phase
  stream into that format.

Every phase returns a :class:`PhaseResult`: the analytic clock
(``latency_s``), energy and regime, and for an executed phase the host
wall time it took (``wall_s``, read after the argmax is on the host, so
the device work is in it). The reference's executed choices are kept:

* a prefill batch is right-padded to a multiple of 8 tokens, capped at
  ``buf_len``;
* a chunked prefill is costed a chunk at a time; the model runs once,
  on the final chunk, over the full prompt;
* ``release_slot`` zeroes the slot's feed token and does not evict the
  cache lane (lanes are independent);
* ``finish_request`` (sequential mode) is a fresh greedy run per request.

Lookup in a replayed trace is the nearest recorded sample in log space
over (batch, length); prefill latency scales linearly with the padded
tokens relative to the chosen sample, decode steps replay the sample's
latency as it is. ``python -m repro_torch.serving.backend --selfcheck
[--device cpu]`` runs the protocol conformance check.
"""
from __future__ import annotations

import abc
import dataclasses
import json
import math
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.batching.continuous import insert_cache_slot
from repro_torch.batching.policy import SlotCountPolicy
from repro_torch.configs.base import ModelConfig
from repro_torch.core import workload as W
from repro_torch.core.energy import EnergyModel, EnergyReport
from repro_torch.core.hardware import H100_SXM, DeviceSpec
from repro_torch.core.precision import PrecisionPolicy, make_policy

REPLAY_SCHEMA = "repro-replay/v1"
BACKENDS = ("analytic", "executed", "replay")


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
def executed_prefill_shape(batch: PrefillBatch, buf_len: int
                           ) -> Optional[Tuple[int, int]]:
    """(rows, padded length) of the model prefill :class:`ExecutedBackend`
    runs for a continuous-mode ``batch``: the longest prompt rounded up
    to a multiple of 8, capped at ``buf_len``. None for a chunk before a
    prompt's last, which is costed only."""
    _, r = batch.picks[0]
    if batch.chunk_len and batch.chunk_start + batch.chunk_len < r.prompt_len:
        return None
    pad = max(r.prompt_len for _, r in batch.picks)
    return batch.n, min(((pad + 7) // 8) * 8, buf_len)


class ExecutedBackend(AnalyticBackend):
    """Analytic costing plus greedy execution of prefill and decode
    phases on a model. The clock stays analytic (what the paper measures
    per phase); each executed phase also carries its host wall time.

    The phases are priced for ``cfg`` (the model's own config, or the
    full-width one of a reduced model served on the CPU) under the
    model's precision policy: a ``fmt`` or ``policy`` of another format
    is refused. ``record_logits``: keep each request's first-token
    logits (f32, on the host) in ``first_logits[req_id]``, for checks
    against a sequential run. An audio model is refused: the serving
    path carries no frames (the reference's backend fails on it at its
    first prefill with ``KeyError: 'frames'``).

    Per run (reset by :meth:`start`): ``phases`` holds every phase's
    :class:`PhaseResult` in order (``wall_s`` set where the model ran),
    ``prefill_shapes`` the (rows, padded length) of each executed
    batched prefill, and for an MoE model ``prefill_aux`` its layer-mean
    router metrics (``dropped_fraction`` among them)."""

    name = "executed"

    def __init__(self, cfg: ModelConfig, model, params, *, max_batch: int,
                 buf_len: int = 256, record_logits: bool = False,
                 **analytic_kw):
        if model is None or params is None:
            raise ValueError("ExecutedBackend needs a model and its params")
        if model.cfg.family == "audio":
            raise ValueError(
                f"{model.cfg.name}: the serving path carries no frames, and "
                f"an audio model's prefill needs batch['frames'] (the "
                f"reference's ExecutedBackend raises KeyError: 'frames'); "
                f"run it through Model.prefill and Model.decode_step")
        policy = analytic_kw.pop("policy", None)
        fmt = analytic_kw.pop("fmt", None)
        for given in (fmt, policy.fmt if policy is not None else None):
            if given is not None and given != model.policy.fmt:
                raise ValueError(f"fmt={given!r} conflicts with the model's "
                                 f"precision policy ({model.policy.fmt!r})")
        super().__init__(cfg, policy=model.policy, **analytic_kw)
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.buf_len = buf_len
        self.record_logits = record_logits
        self.start()

    def start(self) -> None:
        self.cache = self.model.init_cache(self.max_batch, self.buf_len)
        self.slot_tokens = torch.zeros((self.max_batch, 1),
                                       dtype=torch.long,
                                       device=self.model.device)
        self.phases: List[PhaseResult] = []
        self.first_logits: Dict[int, torch.Tensor] = {}
        self.prefill_shapes: List[Tuple[int, int]] = []
        self.prefill_aux: List[Dict[str, float]] = []

    def _log(self, res: PhaseResult) -> PhaseResult:
        self.phases.append(res)
        return res

    # -- protocol -------------------------------------------------------
    def prefill(self, batch: PrefillBatch) -> PhaseResult:
        res = super().prefill(batch)
        if all(slot is None for slot, _ in batch.picks):
            return self._log(res)       # sequential: finish_request runs it
        shape = executed_prefill_shape(batch, self.buf_len)
        if shape is None:
            # a chunk is costed only; the model prefill runs once, on the
            # final chunk, over the full prompt (the same computed tokens
            # and greedy outputs)
            return self._log(res)
        t0 = time.perf_counter()
        self._execute_prefill(batch.picks, shape[1])
        return self._log(dataclasses.replace(
            res, wall_s=time.perf_counter() - t0))

    def decode_step(self, batch: DecodeBatch) -> PhaseResult:
        res = super().decode_step(batch)
        t0 = time.perf_counter()
        self._execute_decode(batch)
        return self._log(dataclasses.replace(
            res, wall_s=time.perf_counter() - t0))

    def decode_run(self, batch: DecodeBatch, max_steps: int, *,
                   t_start: float = 0.0, stop=None) -> DecodeRun:
        # real execution is stepwise: the protocol's decode_step loop
        # (its analytic clock equals the fused path's)
        return InferenceBackend.decode_run(self, batch, max_steps,
                                           t_start=t_start, stop=stop)

    def decode_tail(self, request: Any, n_steps: int,
                    stack: str = "eager") -> PhaseResult:
        return self._log(super().decode_tail(request, n_steps, stack=stack))

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

    def _execute_prefill(self, picks, exec_pad: int) -> None:
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


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------
def _nearest(samples: List[Mapping[str, float]], keys: Tuple[str, str],
             batch: float, length: float) -> Mapping[str, float]:
    """Nearest recorded sample in log space over (batch, length) —
    deterministic: ties resolve to the earliest sample in file order."""
    def dist(s) -> float:
        return (math.log(max(batch, 1) / max(s[keys[0]], 1)) ** 2
                + math.log(max(length, 1) / max(s[keys[1]], 1)) ** 2)
    return min(samples, key=dist)


class ReplayBackend(InferenceBackend):
    """Replay a recorded per-phase latency/power trace.

    The scheduler stays fully live (queueing, batching, KV paging);
    only the *cost source* is swapped for measurements — so a set of
    real H100 phase samples can drive every serving experiment the
    simulator supports (arrival shaping, routing, admission control).
    """

    name = "replay"

    def __init__(self, trace: Mapping[str, Any]):
        if trace.get("schema") != REPLAY_SCHEMA:
            raise ValueError(
                f"unsupported replay schema {trace.get('schema')!r}; "
                f"expected {REPLAY_SCHEMA!r}")
        for phase in ("prefill", "decode"):
            if not trace.get(phase):
                raise ValueError(f"replay trace has no {phase!r} samples")
        if "idle_power_w" not in trace:
            raise ValueError(
                "replay trace missing 'idle_power_w' — idle/gated gaps "
                "would silently be billed at 0 W")
        self.trace = trace
        self.prefill_samples = [dict(s) for s in trace["prefill"]]
        self.decode_samples = [dict(s) for s in trace["decode"]]
        self.idle_power_w = float(trace.get("idle_power_w", 0.0))
        self.gated_power_w = float(
            trace.get("gated_power_w", self.idle_power_w))
        for s in self.prefill_samples:
            self._check_sample(s, "pad_len")
        for s in self.decode_samples:
            self._check_sample(s, "cache_len")
        # DVFS actuation state: pristine recorded samples + the current
        # operating point relative to the recorded clock
        self._prefill_recorded = [dict(s) for s in self.prefill_samples]
        self._decode_recorded = [dict(s) for s in self.decode_samples]
        self.freq_scale = 1.0

    def set_freq_scale(self, target: float) -> None:
        """DVFS actuator for replayed traces: extrapolate the recorded
        samples to the operating point at ``target`` of the recorded
        clock. Measurements only exist at the recorded point, so this
        is an explicit model-based extrapolation using the same
        dynamic-power law as :meth:`DeviceSpec.with_freq_scale` —
        prefill is treated as compute-bound (latency scales ``1/f``,
        power above the idle floor scales ``f^3``), decode as
        memory-bound (latency unchanged, dynamic power ``f^3``), and
        the idle/gated floors are unchanged. It exists so closed-loop
        controllers can be evaluated against recorded hardware traces;
        static replay sweeps should instead record the trace at the
        target operating point."""
        if target <= 0:
            raise ValueError(f"freq_scale must be positive, got {target}")
        if not 0.1 <= target <= 1.5:
            raise ValueError(f"freq_scale {target:g} outside [0.1, 1.5]")
        if target == self.freq_scale:
            return
        self.freq_scale = float(target)
        u = float(target)
        floor = self.idle_power_w

        def dyn(p: float) -> float:
            return floor + max(p - floor, 0.0) * u ** 3

        self.prefill_samples = [
            dict(s, latency_s=s["latency_s"] / u,
                 power_w=dyn(s["power_w"]))
            for s in self._prefill_recorded]
        self.decode_samples = [
            dict(s, power_w=dyn(s["power_w"]))
            for s in self._decode_recorded]

    @staticmethod
    def _check_sample(s: Mapping[str, float], length_key: str) -> None:
        for field in ("batch", length_key, "latency_s", "power_w"):
            if field not in s:
                raise ValueError(f"replay sample missing {field!r}: {s}")
            if not s[field] >= 0:
                raise ValueError(f"replay sample field {field!r} must "
                                 f"be >= 0: {s}")

    @classmethod
    def from_json(cls, path: str) -> "ReplayBackend":
        with open(path) as f:
            return cls(json.load(f))

    # -- protocol -------------------------------------------------------
    def prefill(self, batch: PrefillBatch) -> PhaseResult:
        s = _nearest(self.prefill_samples, ("batch", "pad_len"),
                     batch.n, batch.pad_len)
        # prefill cost is ~linear in computed tokens: scale the sample's
        # latency by the padded-token ratio, keep its measured power
        tokens = batch.n * batch.pad_len
        ref = max(s["batch"] * s["pad_len"], 1.0)
        latency = s["latency_s"] * tokens / ref
        return PhaseResult(phase="prefill", latency_s=latency,
                           energy_j=s["power_w"] * latency,
                           tokens=batch.n, batch=float(batch.n),
                           bound="replay")

    def decode_step(self, batch: DecodeBatch) -> PhaseResult:
        s = _nearest(self.decode_samples, ("batch", "cache_len"),
                     batch.n, float(np.mean(batch.cache_lens)))
        return PhaseResult(phase="decode", latency_s=s["latency_s"],
                           energy_j=s["power_w"] * s["latency_s"],
                           tokens=batch.n, batch=float(batch.n),
                           bound="replay")

    def decode_tail(self, request: Any, n_steps: int,
                    stack: str = "eager") -> PhaseResult:
        s = _nearest(self.decode_samples, ("batch", "cache_len"),
                     1, request.prompt_len + n_steps / 2)
        latency = s["latency_s"] * n_steps
        return PhaseResult(phase="decode", latency_s=latency,
                           energy_j=s["power_w"] * latency,
                           tokens=n_steps, batch=1.0, bound="replay")

    def idle(self, dt: float, state: str = "idle") -> PhaseResult:
        p = self.gated_power_w if state == "gated" else self.idle_power_w
        return PhaseResult(phase=state, latency_s=dt, energy_j=p * dt)


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------
class RecordingBackend(InferenceBackend):
    """Record another backend's phase stream into the replay format.

    Samples are aggregated per (batch, length) operating point (mean
    latency/power; decode cache lengths bucketed to
    ``cache_len_bucket``), so a long run collapses into a compact
    trace — the same shape a real NVML phase sweep produces.
    """

    name = "recording"

    def __init__(self, inner: InferenceBackend, *,
                 cache_len_bucket: int = 64):
        self.inner = inner
        self.cache_len_bucket = max(int(cache_len_bucket), 1)
        # forward the inner cost model's identity so engines (and their
        # routers/schedulers) price with what is actually being billed
        for attr in ("device", "energy", "cfg", "policy"):
            if hasattr(inner, attr):
                setattr(self, attr, getattr(inner, attr))
        self._prefill: Dict[Tuple[int, int], List[PhaseResult]] = {}
        self._decode: Dict[Tuple[int, int], List[PhaseResult]] = {}
        self._idle_power: Dict[str, float] = {}

    def start(self) -> None:
        self.inner.start()

    def prefill(self, batch: PrefillBatch) -> PhaseResult:
        res = self.inner.prefill(batch)
        self._prefill.setdefault((batch.n, batch.pad_len),
                                 []).append(res)
        return res

    def _decode_key(self, batch: int, cache_len: float) -> Tuple[int, int]:
        b = self.cache_len_bucket
        return (batch, max(int(round(cache_len / b)) * b, 1))

    def decode_step(self, batch: DecodeBatch) -> PhaseResult:
        res = self.inner.decode_step(batch)
        key = self._decode_key(batch.n, float(np.mean(batch.cache_lens)))
        self._decode.setdefault(key, []).append(res)
        return res

    def decode_tail(self, request: Any, n_steps: int,
                    stack: str = "eager") -> PhaseResult:
        res = self.inner.decode_tail(request, n_steps, stack=stack)
        key = self._decode_key(1, request.prompt_len + n_steps / 2)
        # one tail = n_steps steps at the mid-cache point
        self._decode.setdefault(key, []).append(
            PhaseResult(phase="decode",
                        latency_s=res.latency_s / max(n_steps, 1),
                        energy_j=res.energy_j / max(n_steps, 1),
                        tokens=1, batch=1.0))
        return res

    def idle(self, dt: float, state: str = "idle") -> PhaseResult:
        res = self.inner.idle(dt, state)
        self._idle_power[state] = res.power_w
        return res

    def release_slot(self, slot: int) -> None:
        self.inner.release_slot(slot)

    def finish_request(self, request: Any) -> None:
        self.inner.finish_request(request)

    # -- export ---------------------------------------------------------
    def _state_power(self, state: str) -> float:
        """Recorded gap wattage; a run with no idle/gated gaps falls
        back to the inner backend's device so the trace never exports a
        silent 0 W idle state."""
        if state in self._idle_power:
            return self._idle_power[state]
        if state == "gated" and "idle" in self._idle_power:
            return self._idle_power["idle"]
        dev = getattr(self.inner, "device", None)
        if dev is not None:
            try:
                return dev.state_power(state)
            except ValueError:
                pass
        return 0.0

    def to_trace(self, device: str = "", model: str = "",
                 source: str = "recorded by RecordingBackend") -> Dict:
        def agg(table, length_key):
            return [{"batch": b, length_key: ln,
                     "latency_s": float(np.mean(
                         [r.latency_s for r in rs])),
                     "power_w": float(np.mean([r.power_w for r in rs]))}
                    for (b, ln), rs in sorted(table.items())]
        return {
            "schema": REPLAY_SCHEMA,
            "device": device, "model": model, "source": source,
            "idle_power_w": self._state_power("idle"),
            "gated_power_w": self._state_power("gated"),
            "prefill": agg(self._prefill, "pad_len"),
            "decode": agg(self._decode, "cache_len"),
        }

    def dump(self, path: str, **meta) -> Dict:
        trace = self.to_trace(**meta)
        with open(path, "w") as f:
            json.dump(trace, f, indent=1, sort_keys=True)
        return trace


# ---------------------------------------------------------------------------
# factory
# ---------------------------------------------------------------------------
def make_backend(name: str, cfg: ModelConfig, **kw) -> InferenceBackend:
    """Resolve a backend axis value. ``executed`` needs ``model`` /
    ``params`` / ``max_batch``; ``replay`` needs ``replay_path``."""
    if name == "analytic":
        return AnalyticBackend(cfg, **kw)
    if name == "executed":
        return ExecutedBackend(cfg, kw.pop("model"), kw.pop("params"),
                               **kw)
    if name == "replay":
        return ReplayBackend.from_json(kw.pop("replay_path"))
    raise ValueError(f"unknown backend {name!r}; known: {BACKENDS}")


# ---------------------------------------------------------------------------
# selfcheck (python -m repro_torch.serving.backend --selfcheck)
# ---------------------------------------------------------------------------
def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _finite_result(res: PhaseResult, phase: str) -> None:
    _check(isinstance(res, PhaseResult),
           f"{phase}: backend must return PhaseResult, got {type(res)}")
    _check(res.phase in ("prefill", "decode", "idle", "gated"),
           f"{phase}: bad phase tag {res.phase!r}")
    for field in ("latency_s", "energy_j"):
        v = getattr(res, field)
        _check(np.isfinite(v) and v >= 0.0,
               f"{phase}: non-finite/negative {field}={v}")


def _conformance(backend: InferenceBackend, reqs) -> None:
    """Drive the raw protocol surface once and validate every result."""
    backend.start()
    r = reqs[0]
    _finite_result(backend.prefill(
        PrefillBatch(picks=[(None, r)], pad_len=r.prompt_len,
                     stack="eager")), "prefill")
    _finite_result(backend.decode_step(
        DecodeBatch(slots=[0], requests=[r],
                    cache_lens=[r.prompt_len + 1])), "decode_step")
    run = backend.decode_run(
        DecodeBatch(slots=[0], requests=[r],
                    cache_lens=[r.prompt_len + 2]), 4, t_start=1.0)
    _check(isinstance(run, DecodeRun) and run.n_steps == 4,
           f"decode_run must return a 4-step DecodeRun, got {run}")
    _check(np.isfinite(run.t_end) and run.t_end >= 1.0,
           f"decode_run t_end must fold from t_start, got {run.t_end}")
    _finite_result(backend.decode_tail(r, 4), "decode_tail")
    for state in ("idle", "gated"):
        res = backend.idle(0.5, state)
        _finite_result(res, f"idle[{state}]")
        _check(res.phase == state, f"idle must tag state {state!r}")
    backend.release_slot(0)


def selfcheck(verbose: bool = True, device: str = "cuda") -> int:
    """Protocol conformance and parity smoke over all shipped backends;
    the executed backend runs reduced stablelm-1.6b on ``device``."""
    from repro_torch.configs.base import get_config
    from repro_torch.configs.paper_zoo import PAPER_MODELS
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.requests import Request

    def log(msg: str) -> None:
        if verbose:
            print(f"[backend-selfcheck] {msg}")

    cfg = PAPER_MODELS["llama-3.1-8b"]
    reqs = lambda: [Request(req_id=i, prompt=None, prompt_len=256,  # noqa: E731
                            max_new_tokens=8, arrival_time=0.05 * i)
                    for i in range(8)]

    def engine(**kw):
        return ServeEngine(cfg, batch_policy=SlotCountPolicy(max_batch=4),
                           **kw)

    # 1. analytic: conformance + default-engine parity
    analytic = AnalyticBackend(cfg)
    _conformance(analytic, reqs())
    rep_default = engine().run(reqs())
    rep_explicit = engine(backend=AnalyticBackend(cfg)).run(reqs())
    _check(rep_default.total_energy_j == rep_explicit.total_energy_j
           and rep_default.wall_time_s == rep_explicit.wall_time_s,
           "explicit AnalyticBackend diverges from the default engine")
    log(f"analytic ok ({rep_default.total_energy_j:.1f} J)")

    # 1b. macro-step fusion: the vectorized decode_run must equal the
    # protocol's stepwise fallback bit for bit
    rs = reqs()[:2]
    batch = DecodeBatch(slots=[0, 1], requests=rs,
                        cache_lens=[r.prompt_len + 1 for r in rs])
    fused = analytic.decode_run(batch, 16, t_start=0.25)
    stepped = InferenceBackend.decode_run(analytic, batch, 16,
                                          t_start=0.25)
    _check(bool((fused.latencies_s == stepped.latencies_s).all()
                and (fused.energies_j == stepped.energies_j).all()
                and fused.t_end == stepped.t_end),
           "vectorized decode_run diverges from the stepwise fallback")
    log(f"decode_run ok (16 fused steps, t_end {fused.t_end:.4f}s)")

    # 2. replay: record the analytic run, replay it, compare
    rec = RecordingBackend(AnalyticBackend(cfg))
    engine(backend=rec).run(reqs())
    replay = ReplayBackend(rec.to_trace(device="h100-sxm",
                                        model=cfg.name))
    _conformance(replay, reqs())
    rep_replay = engine(backend=replay).run(reqs())
    drift = (rep_replay.total_energy_j
             / max(rep_default.total_energy_j, 1e-12))
    _check(0.9 < drift < 1.1,
           f"replay round trip drifted {drift:.3f}x from analytic")
    log(f"replay ok (round-trip drift {drift:.4f}x)")

    # 3. executed: real model steps through the scheduler (reduced model)
    rcfg = get_config("stablelm-1.6b").reduced()
    model = build_model(rcfg, fmt="float32", device=device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    rng = np.random.default_rng(0)
    ereqs = [Request(req_id=i,
                     prompt=rng.integers(0, rcfg.vocab_size, 8)
                     .astype(np.int32),
                     prompt_len=8, max_new_tokens=3, arrival_time=0.0)
             for i in range(3)]
    backend = ExecutedBackend(rcfg, model, params, max_batch=4,
                              buf_len=32, fmt="float32")
    rep = ServeEngine(rcfg, fmt="float32", buf_len=32, backend=backend,
                      batch_policy=SlotCountPolicy(max_batch=4)).run(ereqs)
    _check(all(len(r.generated) == r.max_new_tokens
               for r in rep.requests),
           "executed backend did not generate real tokens")
    log(f"executed ok (real tokens generated through the scheduler on "
        f"{model.device})")

    # 4. DVFS: scaled device spec keeps the protocol honest
    dev = H100_SXM.with_freq_scale(0.7)
    _check(dev.peak_flops_16 < H100_SXM.peak_flops_16
           and dev.power_memory < H100_SXM.power_memory
           and dev.hbm_bw == H100_SXM.hbm_bw,
           "with_freq_scale must scale compute/power but not HBM")
    scaled = AnalyticBackend(cfg, device=dev)
    _conformance(scaled, reqs())
    log(f"dvfs ok ({dev.name}: {dev.power_memory:.0f} W memory-bound)")

    log("all backends conform")
    return 0


def _main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="InferenceBackend protocol utilities")
    ap.add_argument("--selfcheck", action="store_true",
                    help="run the protocol-conformance check")
    ap.add_argument("--device", default="cuda",
                    help="where the executed backend's model runs")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    if args.selfcheck:
        return selfcheck(verbose=not args.quiet, device=args.device)
    ap.print_help()
    return 2


if __name__ == "__main__":
    # `python -m` executes a second copy of this module body; re-enter
    # through the canonical import so the selfcheck's backend classes
    # share identity with the ones the engine isinstance-checks
    from repro_torch.serving import backend as _canonical
    raise SystemExit(_canonical._main())
