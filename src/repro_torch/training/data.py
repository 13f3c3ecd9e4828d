"""Synthetic data pipeline: the port's own copy of
``repro.training.data`` (numpy only).

Generates a deterministic, reproducible token stream with a Zipf-like
marginal (matching natural-language token frequency) plus learnable
bigram structure so the LM loss actually decreases. Also provides the
paper-style request sampler (prompt 200–4000 tokens, output 10–300) used
by the serving benchmarks (§2: UltraChat-derived distribution).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticLM:
    """Deterministic bigram-structured token stream."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        ranks = np.arange(1, V + 1, dtype=np.float64)
        self.marginal = ranks ** -cfg.zipf_a
        self.marginal /= self.marginal.sum()
        # each token deterministically prefers a successor band: makes the
        # stream compressible so training loss falls below unigram entropy
        self.succ = rng.integers(0, V, size=V)

    def batches(self, n: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed + 1)
        i = 0
        while n is None or i < n:
            toks = self._sample_tokens(rng, cfg.batch_size, cfg.seq_len + 1)
            yield {"tokens": toks[:, :-1].astype(np.int32),
                   "labels": toks[:, 1:].astype(np.int32)}
            i += 1

    def _sample_tokens(self, rng, b, s) -> np.ndarray:
        V = self.cfg.vocab_size
        out = np.empty((b, s), np.int64)
        out[:, 0] = rng.choice(V, size=b, p=self.marginal)
        mix = rng.random((b, s)) < 0.5     # 50% bigram-follow
        draws = rng.choice(V, size=(b, s), p=self.marginal)
        for t in range(1, s):
            follow = self.succ[out[:, t - 1]]
            out[:, t] = np.where(mix[:, t], follow, draws[:, t])
        return out


@dataclasses.dataclass
class RequestSample:
    prompt_len: int
    output_len: int


class RequestDistribution:
    """Paper §2 workload: prompts 200–4000 tokens, outputs 10–300."""

    def __init__(self, seed: int = 0, prompt_range=(200, 4000),
                 output_range=(10, 300)):
        self.rng = np.random.default_rng(seed)
        self.prompt_range = prompt_range
        self.output_range = output_range

    def sample(self) -> RequestSample:
        # log-uniform: most prompts short, tail long (chat-like)
        lo, hi = self.prompt_range
        p = int(np.exp(self.rng.uniform(np.log(lo), np.log(hi))))
        lo, hi = self.output_range
        o = int(np.exp(self.rng.uniform(np.log(lo), np.log(hi))))
        return RequestSample(prompt_len=p, output_len=o)

    def sample_n(self, n: int):
        return [self.sample() for _ in range(n)]
