"""Host-side exact rescore for two-stage cascades (numpy).

The port's own copy of the JAX package's ``retrieval/rescore.py``; the
binary store's stage 2 rescores its stage-1 candidates here against the
SQ8 codes it keeps on the host.

Conventions: candidate id -1 marks an empty stage-1 slot; invalid or
missing outputs carry score ``-inf`` and id ``-1``, so a raw-score merge
can never rank a sentinel above a genuine negative-score hit.
"""

from __future__ import annotations

import numpy as np


def exact_rescore_topk(
    queries: np.ndarray,
    rows_of,
    cand: np.ndarray,
    k: int,
    *,
    metric: str = "dot",
    scale: float = 1.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact-rescore stage-1 candidates and return the top ``k``.

    ``queries``: [Q, D] float; ``cand``: [Q, K1] int candidate ids with -1
    empty-slot sentinels; ``rows_of(idx)`` gathers candidate vectors for an
    [Q, K1] index array (values at masked positions are gathered from row
    0 and discarded). ``metric``: 'dot' (cosine on pre-normalized vectors;
    scores scaled by ``scale``) or 'euclidean' (-||q-c||^2, higher is
    better). Fewer than ``k`` candidates pad with (-inf, -1)."""
    qf = np.asarray(queries, dtype=np.float32)
    cand = np.asarray(cand)
    valid = cand >= 0
    rows = rows_of(np.where(valid, cand, 0)).astype(np.float32)  # [Q,K1,D]
    dots = np.einsum("qd,qkd->qk", qf, rows)
    if metric == "euclidean":
        q_sq = np.sum(qf * qf, axis=1, keepdims=True)
        c_sq = np.sum(rows * rows, axis=2)
        dots = 2.0 * dots - c_sq - q_sq
    else:
        dots = dots * float(scale)
    dots = np.where(valid, dots, -np.inf)
    k_out = min(k, cand.shape[1])
    sel = np.argpartition(-dots, k_out - 1, axis=1)[:, :k_out]
    ssel = np.take_along_axis(dots, sel, axis=1)
    order = np.argsort(-ssel, axis=1)
    scores = np.take_along_axis(ssel, order, axis=1).astype(np.float32)
    ids = np.take_along_axis(
        np.take_along_axis(cand, sel, axis=1), order, axis=1
    )
    ids = np.where(np.isfinite(scores), ids, -1)
    if k_out < k:  # pad to the requested width with sentinels
        pad = ((0, 0), (0, k - k_out))
        scores = np.pad(scores, pad, constant_values=-np.inf)
        ids = np.pad(ids, pad, constant_values=-1)
    return scores, ids.astype(np.int32)
