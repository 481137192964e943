"""Retrieval quality metrics (Recall@k, MRR@k, nDCG@k) over a batch.

The port of the JAX package's ``evaluation/retrieval_metrics.py``: the
same metric definitions (binary relevance; nDCG = 1/log2(rank+1) for the
hits, normalised by the ideal DCG), the same ``"Metric@k"`` parsing and
the same ``{metric: {mean, std(ddof=1)}}`` output. The per-query vectors
are fp32, as the JAX version computes them; this is host work on a
[Q, K] boolean matrix, done in numpy.
"""

from __future__ import annotations

import re
from typing import Mapping, Sequence

import numpy as np

_METRIC_RE = re.compile(r"^\s*([A-Za-z]+)\s*@\s*(\d+)\s*$")


def parse_metric(name: str) -> tuple[str, int]:
    m = _METRIC_RE.match(name)
    if not m:
        raise ValueError(f"metric {name!r} must look like 'Recall@10'")
    return m.group(1).lower(), int(m.group(2))


def hit_matrix(
    retrieved_ids: Sequence[Sequence], relevant_ids: Sequence
) -> np.ndarray:
    """[Q, K] boolean: retrieved j is relevant for query i. ``relevant_ids[i]``
    may be one id or a collection; duplicate retrieved ids count once."""
    nq = len(retrieved_ids)
    k = max((len(r) for r in retrieved_ids), default=0)
    out = np.zeros((nq, k), dtype=bool)
    for i, row in enumerate(retrieved_ids):
        rel = relevant_ids[i]
        if isinstance(rel, (str, bytes)) or not hasattr(rel, "__iter__"):
            rel = {rel}
        else:
            rel = set(rel)
        seen: set = set()
        for j, rid in enumerate(row):
            out[i, j] = rid in rel and rid not in seen
            seen.add(rid)
    return out


def _metrics_from_hits(hits: np.ndarray, n_relevant: np.ndarray, k: int):
    """Per-query fp32 metric vectors from the [Q, K] hit matrix."""
    h = hits[:, :k].astype(np.float32)
    nrel = np.maximum(n_relevant.astype(np.float32), np.float32(1.0))
    recall = np.sum(h, axis=1) / nrel
    ranks = np.arange(1, k + 1, dtype=np.float32)[None, :]
    has_hit = np.any(h > 0, axis=1)
    first = np.argmax(h, axis=1).astype(np.float32)
    mrr = np.where(has_hit, np.float32(1.0) / (first + np.float32(1.0)),
                   np.float32(0.0)).astype(np.float32)
    discounts = np.float32(1.0) / np.log2(ranks + np.float32(1.0))
    dcg = np.sum(h * discounts, axis=1)
    ideal_n = np.minimum(nrel, np.float32(k))
    idcg = np.sum((ranks <= ideal_n[:, None]) * discounts, axis=1)
    ndcg = dcg / np.maximum(idcg, np.float32(1e-12))
    return {"recall": recall, "mrr": mrr, "ndcg": ndcg}


def evaluate_retrieval(
    retrieved_ids: Sequence[Sequence],
    relevant_ids: Sequence,
    metrics: Sequence[str] = ("Recall@10", "MRR@10", "nDCG@10"),
    return_per_query: bool = False,
) -> Mapping[str, dict]:
    """Batch evaluation -> {metric_name: {"mean": .., "std": ..}}."""
    if retrieved_ids and not isinstance(retrieved_ids[0], (list, tuple, np.ndarray)):
        retrieved_ids = [retrieved_ids]
        relevant_ids = [relevant_ids]
    hits = hit_matrix(retrieved_ids, relevant_ids)
    n_rel = np.array(
        [
            len(r) if hasattr(r, "__len__") and not isinstance(r, (str, bytes)) else 1
            for r in relevant_ids
        ],
        dtype=np.int32,
    )
    out: dict[str, dict] = {}
    per_query: dict[str, np.ndarray] = {}
    for name in metrics:
        kind, k = parse_metric(name)
        if kind not in ("recall", "mrr", "ndcg"):
            raise ValueError(f"unknown metric kind {kind!r}")
        k_eff = min(k, hits.shape[1]) if hits.shape[1] else k
        vec = _metrics_from_hits(hits, n_rel, k_eff)[kind]
        std = float(np.std(vec, ddof=1)) if len(vec) > 1 else 0.0
        out[name] = {"mean": float(np.mean(vec)) if len(vec) else 0.0, "std": std}
        per_query[name] = vec
    if return_per_query:
        return out, per_query
    return out
