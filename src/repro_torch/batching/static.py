"""Prompt-length bucketing: the port's copy of
``repro.batching.static.bucket_length``."""
from __future__ import annotations

import math
from typing import Sequence

PREFILL_BUCKETS = (128, 256, 512, 1024, 2048, 4096)


def bucket_length(n: int, buckets: Sequence[int] = PREFILL_BUCKETS) -> int:
    """Round a length up to the nearest bucket (the padding mitigation
    the paper recommends in §9)."""
    for b in buckets:
        if n <= b:
            return b
    return int(math.ceil(n / buckets[-1]) * buckets[-1])
