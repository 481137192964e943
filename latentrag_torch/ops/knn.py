"""All-pairs k-NN lists on the device: the HNSW build's assist.

The port of the JAX package's ``ops/knn.py``. Finding every row's nearest
neighbours is one [N, N] top-k problem, tiled as blocks of query rows over
the corpus resident on the device; the graph's assembly from those lists
(diversity pruning, reverse links, the upper levels) is linear host work
in C++ (``retrieval.ann.HNSWIndex.from_knn``).

The corpus goes to the device once and each query block is a row slice of
it. With ``exact=False`` (the default) a block's search is
``ops.topk.approx_topk``, which on the card is the fold kernel at the plan
``recall_target`` sets (at k + 1 = 65: 128 candidates; tile 4096 at 1M
rows, 128 on a corpus of 2000), rescored exactly; ``exact=True`` is the
blocked plain search ``ops.topk.exact_topk``, as the JAX package's is
XLA. A block's ids come back to the host once and ``strip_self`` drops the
row itself there, in numpy.

With more than one visible card the HNSW build takes
``parallel.sharded_knn_graph`` instead (the same lists, the corpus
sharded over a ring of the cards), as the JAX package's does.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..utils.device import as_tensor
from .topk import approx_topk, exact_topk

log = logging.getLogger("latentrag_torch.ops")

# the latest knn_graph's split: seconds in the searches, in the ids'
# copies to the host and in strip_self, and the number of query blocks
last_split: dict = {}


def strip_self(idx: np.ndarray, row_start: int, k: int) -> np.ndarray:
    """Drop each row's own id (and invalid < 0 ids) from candidate lists.

    ``idx`` is [rows, kk] best-first candidate ids for corpus rows
    ``row_start .. row_start + rows``; returns [rows, k] int32 with the
    first k kept entries a row, -1 where fewer exist."""
    rows = np.arange(row_start, row_start + idx.shape[0],
                     dtype=idx.dtype)[:, None]
    keep = (idx != rows) & (idx >= 0)
    keep_rank = np.cumsum(keep, axis=1) - 1  # position among kept
    take = keep & (keep_rank < k)
    out = np.full((idx.shape[0], k), -1, dtype=np.int32)
    r, c = np.nonzero(take)
    out[r, keep_rank[r, c]] = idx[r, c]
    return out


def knn_graph(
    corpus,
    k: int,
    *,
    metric: str = "cosine",
    query_block: int = 4096,
    block_size: int = 1048576,
    exact: bool = False,
    recall_target: float = 0.95,
) -> np.ndarray:
    """[N, k] int32 neighbour ids a row, self excluded, best first.

    ``corpus`` (a tensor, searched on its device, or numpy, which goes to
    the card once) must be prepared for ``metric`` (normalized for
    cosine), as the top-k functions require; its rows are the queries,
    ``query_block`` at a time."""
    c = as_tensor(corpus).contiguous()
    dev = c.device
    n = int(c.shape[0])
    if n == 0:
        return np.zeros((0, k), np.int32)
    kk = min(k + 1, n)  # +1: the row itself ranks first and is dropped
    out = np.empty((n, k), dtype=np.int32)
    split = {"search_s": 0.0, "d2h_s": 0.0, "strip_s": 0.0,
             "blocks": 0}
    t_all = time.perf_counter()
    for qs in range(0, n, query_block):
        t0 = time.perf_counter()
        qb = c[qs : qs + query_block]
        if exact:
            _, idx = exact_topk(qb, c, k=kk, metric=metric,
                                block_size=min(block_size, 8192))
        else:
            _, idx = approx_topk(qb, c, k=kk, metric=metric,
                                 block_size=block_size,
                                 recall_target=recall_target)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        ids = idx.cpu().numpy()
        t2 = time.perf_counter()
        out[qs : qs + qb.shape[0]] = strip_self(ids, qs, k)
        t3 = time.perf_counter()
        split["search_s"] += t1 - t0
        split["d2h_s"] += t2 - t1
        split["strip_s"] += t3 - t2
        split["blocks"] += 1
    last_split.clear()
    last_split.update(split, total_s=time.perf_counter() - t_all)
    log.info(
        "knn_graph: %d x %d (k=%d, %s) in %.1fs on %s", n, int(c.shape[1]),
        k, "exact" if exact else "approx", last_split["total_s"], dev,
    )
    return out
