"""Static batching with padding — the paper's §4 setting: the port's
own copy of ``repro.batching.static`` (numpy only).

The paper's key observation: padding inflates *computed* tokens over
*effective* tokens in prefill (compute-bound => pure waste), while decode
drops completed sequences so output tokens are always effective. We track
both counts so benchmarks can reproduce Fig. 2a/2b exactly.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


def bucket_length(n: int, buckets: Sequence[int] = (128, 256, 512, 1024,
                                                    2048, 4096)) -> int:
    """Round a length up to the nearest bucket (padding mitigation the
    paper recommends in §9 'careful shaping (e.g., bucketing)')."""
    for b in buckets:
        if n <= b:
            return b
    return int(np.ceil(n / buckets[-1]) * buckets[-1])


@dataclasses.dataclass
class PaddedBatch:
    tokens: np.ndarray          # (B, S_pad) int32
    lengths: np.ndarray         # (B,) true prompt lengths
    effective_tokens: int       # sum(lengths)
    computed_tokens: int        # B * S_pad
    pad_id: int = 0

    @property
    def padding_fraction(self) -> float:
        return 1.0 - self.effective_tokens / max(self.computed_tokens, 1)


def pad_batch(prompts: List[np.ndarray], pad_id: int = 0,
              bucket: bool = False, pad_multiple: int = 1) -> PaddedBatch:
    """Left-align prompts into a right-padded (B, S) batch."""
    if not prompts:
        raise ValueError("empty batch")
    lengths = np.array([len(p) for p in prompts], np.int32)
    s = int(lengths.max())
    if bucket:
        s = bucket_length(s)
    if pad_multiple > 1:
        s = int(np.ceil(s / pad_multiple) * pad_multiple)
    out = np.full((len(prompts), s), pad_id, np.int32)
    for i, p in enumerate(prompts):
        out[i, :len(p)] = p
    return PaddedBatch(tokens=out, lengths=lengths,
                       effective_tokens=int(lengths.sum()),
                       computed_tokens=int(out.size), pad_id=pad_id)


class StaticBatcher:
    """Groups a request list into fixed-size padded batches (the
    transformers-library static mode the paper benchmarks in §4)."""

    def __init__(self, batch_size: int, bucket: bool = False):
        self.batch_size = batch_size
        self.bucket = bucket

    def batches(self, prompts: List[np.ndarray]):
        for i in range(0, len(prompts), self.batch_size):
            yield pad_batch(prompts[i:i + self.batch_size],
                            bucket=self.bucket)
