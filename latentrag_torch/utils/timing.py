"""Wall-clock instrumentation: percentiles and the retriever's StatsTracker.

The counterpart of the JAX package's ``utils/timing.py``. CUDA kernels
return before the card finishes, so a timed span that ends on device work
calls ``force_completion`` first: ``torch.cuda.synchronize`` for CUDA
tensors, nothing for CPU tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


def force_completion(x: torch.Tensor) -> None:
    """Wait until the device work that produced ``x`` has finished."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


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
