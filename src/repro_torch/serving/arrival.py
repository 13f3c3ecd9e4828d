"""Arrival shaping — the paper's §5 lever: the port's own copy of
``repro.serving.arrival``.

Patterns evaluated in the paper:
* random delays:  t_i = sum of U(k, l) gaps   (Fig 3a/3b)
* fixed intervals: constant spacing (50/300/500 ms)  (Fig 3c)
plus Poisson (the standard open-loop model) and burst for completeness.

Also home of :func:`paper_requests`, the §2/§3.1 workload sampler
(prompts 200–4000 log-uniform, outputs 10–300), so library users can
sample the paper's request distribution without importing from
``benchmarks/``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def fixed_arrivals(n: int, interval_s: float, start: float = 0.0
                   ) -> List[float]:
    return [start + i * interval_s for i in range(n)]


def uniform_random_arrivals(n: int, low_s: float, high_s: float,
                            seed: int = 0, start: float = 0.0
                            ) -> List[float]:
    rng = np.random.default_rng(seed)
    gaps = rng.uniform(low_s, high_s, size=n)
    t = start + np.cumsum(gaps)
    return list(t - gaps[0])           # first request at start


def poisson_arrivals(n: int, rate_per_s: float, seed: int = 0,
                     start: float = 0.0) -> List[float]:
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_per_s, size=n)
    t = start + np.cumsum(gaps)
    return list(t - gaps[0])


def burst_arrivals(n: int, burst_size: int, burst_gap_s: float,
                   start: float = 0.0) -> List[float]:
    return [start + (i // burst_size) * burst_gap_s for i in range(n)]


def diurnal_arrivals(n: int, base_rate_per_s: float, *,
                     amp_frac: float = 0.6, period_s: float = 86400.0,
                     phase_h: float = 0.0, bursts_per_day: float = 0.0,
                     burst_size: int = 32, seed: int = 0,
                     start: float = 0.0) -> List[float]:
    """Multi-day diurnal arrivals: a non-homogeneous Poisson process
    whose rate follows ``base * (1 + amp_frac * sin(2π(t/T + φ)))``,
    optionally spiked with same-instant bursts (traffic flash crowds).

    The process is sampled by exact inversion of the closed-form
    cumulative rate Λ(t) — unit-exponential increments are mapped back
    through Λ⁻¹ on a dense grid — so day-scale sweeps with millions of
    arrivals materialize vectorized, without a per-event Python loop.
    Arrival times keep their absolute phase (``t=0`` is midnight):
    unlike :func:`poisson_arrivals` the stream is *not* shifted to put
    the first event at ``start``, because the fleet layer aligns these
    times against time-of-day carbon/price signals.
    """
    if base_rate_per_s <= 0:
        raise ValueError("base_rate_per_s must be positive")
    if not 0.0 <= amp_frac < 1.0:
        raise ValueError("amp_frac must be in [0, 1) — the rate must "
                         "stay positive at the trough")
    if n <= 0:
        return []
    rng = np.random.default_rng(seed)
    n_burst_arr = 0
    n_bursts = 0
    if bursts_per_day > 0 and burst_size > 0:
        est_days = n / base_rate_per_s / period_s
        n_bursts = max(1, int(round(bursts_per_day * max(est_days,
                                                         1.0 / 24.0))))
        n_burst_arr = min(n_bursts * burst_size, n // 2)
        n_bursts = max(1, n_burst_arr // max(burst_size, 1)) \
            if n_burst_arr else 0
    n_main = n - n_burst_arr
    targets = np.cumsum(rng.exponential(1.0, size=n_main))
    # Λ(t) = r·(t + A·T/2π · (cos(2πφ) − cos(2π(t/T + φ)))), exact
    phi = phase_h * 3600.0 / period_s
    w = 2.0 * np.pi
    t_hi = targets[-1] / (base_rate_per_s * (1.0 - amp_frac)) + period_s
    npts = int(min(2_000_000, max(4096, 2 * n_main)))
    grid = np.linspace(0.0, t_hi, npts)
    lam = base_rate_per_s * (
        grid + amp_frac * period_s / w
        * (np.cos(w * phi) - np.cos(w * (grid / period_s + phi))))
    t_main = np.interp(targets, lam, grid)
    if n_burst_arr:
        t_b = np.repeat(rng.uniform(0.0, float(t_main[-1]),
                                    size=n_bursts), burst_size)
        t_all = np.sort(np.concatenate([t_main, t_b[:n_burst_arr]]),
                        kind="stable")
    else:
        t_all = t_main
    return list(start + t_all)


def paper_requests(n: int, arrivals: Sequence[float], seed: int = 0,
                   prompt_range=None, output_range=None,
                   vocab_size: Optional[int] = None) -> List:
    """Serving requests sampled from the paper's §2/§3.1 workload
    distribution (the reference's sampler, draw for draw).

    ``vocab_size`` additionally materializes real prompt token ids (for
    ``execute=True`` engines) without perturbing the sim-only length
    sampling stream — sim and real runs of the same seed therefore see
    identical request shapes.
    """
    from repro_torch.serving.requests import Request
    from repro_torch.training.data import RequestDistribution
    kw = {"seed": seed}
    if prompt_range is not None:
        kw["prompt_range"] = tuple(prompt_range)
    if output_range is not None:
        kw["output_range"] = tuple(output_range)
    dist = RequestDistribution(**kw)
    tok_rng = (np.random.default_rng(seed + 1)
               if vocab_size is not None else None)
    out = []
    for i in range(n):
        s = dist.sample()
        prompt = (tok_rng.integers(0, vocab_size, s.prompt_len)
                  .astype(np.int32) if tok_rng is not None else None)
        out.append(Request(req_id=i, prompt=prompt,
                           prompt_len=s.prompt_len,
                           max_new_tokens=s.output_len,
                           arrival_time=float(arrivals[i])))
    return out
