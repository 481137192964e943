"""Wall-clock instrumentation: stopwatch spans, percentiles, StatsTracker.

The counterpart of the JAX package's ``utils/timing.py``. CUDA kernels
return before the card finishes, so a timed span that ends on device work
calls ``force_completion`` first: ``torch.cuda.synchronize`` for CUDA
tensors, nothing for CPU tensors. ``device_stopwatch`` does that for the
outputs its span appends.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch


def force_completion(x: torch.Tensor) -> None:
    """Wait until the device work that produced ``x`` has finished."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


class Stopwatch:
    """Accumulates seconds per named key across ``span`` context entries."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextmanager
    def span(self, key: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[key] += time.perf_counter() - t0
            self.counts[key] += 1


@contextmanager
def stopwatch(store: dict, key: str):
    """Accumulate the span's seconds into ``store[key]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        store[key] = store.get(key, 0.0) + (time.perf_counter() - t0)


@contextmanager
def device_stopwatch(store: dict, key: str, outputs: list):
    """Time device work: wait for every tensor appended to ``outputs``
    before the clock stops."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        for x in outputs:
            force_completion(x)
        store[key] = store.get(key, 0.0) + (time.perf_counter() - t0)


def percentiles(values, qs=(50, 95)) -> dict[str, float]:
    """Empirical percentiles of a sample; {} for empty input."""
    arr = np.asarray(list(values), dtype=np.float64)
    if arr.size == 0:
        return {}
    return {f"p{q}": float(np.percentile(arr, q)) for q in qs}


@dataclass
class StatsTracker:
    """Build/search accounting with reset semantics (per-retriever):
    cumulative build seconds, cumulative search seconds, number of search
    calls, and a per-query latency sample in milliseconds."""

    build_time_s: float = 0.0
    search_time_s: float = 0.0
    search_calls: int = 0
    per_query_ms: list = field(default_factory=list)

    def add_build(self, seconds: float) -> None:
        self.build_time_s += seconds

    def add_search_batch(self, seconds: float, n_queries: int) -> None:
        self.search_time_s += seconds
        self.search_calls += 1
        if n_queries > 0:
            self.per_query_ms.extend([seconds * 1000.0 / n_queries] * n_queries)

    def get(self, reset: bool = False) -> dict:
        out = {
            "build_time_s": self.build_time_s,
            "search_time_s": self.search_time_s,
            "search_calls": self.search_calls,
            "per_query_ms": list(self.per_query_ms),
        }
        out.update(percentiles(self.per_query_ms))
        if reset:
            self.reset()
        return out

    def reset(self) -> None:
        self.build_time_s = 0.0
        self.search_time_s = 0.0
        self.search_calls = 0
        self.per_query_ms = []
