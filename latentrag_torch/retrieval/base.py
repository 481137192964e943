"""Retriever protocols: the JAX package's ``retrieval/base.py``."""

from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

import numpy as np


@runtime_checkable
class BaseRetriever(Protocol):
    """The text-in surface of the baselines (BM25, DPR)."""

    def build_index(self, corpus: Sequence[str]) -> None: ...

    def retrieve(self, query, top_k: int = 5): ...


@runtime_checkable
class DenseSearchAPI(Protocol):
    """The batch-first, embedding-in surface of the dense tiers."""

    def search(
        self, queries: np.ndarray, k: int
    ) -> tuple[np.ndarray, np.ndarray]: ...

    def retrieve(self, query_emb: np.ndarray, top_k: int = 5): ...

    def get_stats(self, reset: bool = False) -> dict: ...
