"""The k-NN graph over a sharded corpus: the shards travel a ring.

The port of the JAX package's ``parallel/knn.py``. The corpus is
row-sharded (``shard_rows``); every shard's rows are the queries for its
own lists. The ring is P steps: at step t, shard ``me`` scores its rows
against the shard that started at ring position ``(me - t) mod P``, folds
the result into a running top ``carry_k`` (one select over the running
list and the step's candidates, ties to the lower position, as
``lax.top_k``), then hands the shard it holds to the next position
(``.to(next device)``, a no-op on a virtual mesh; across processes one
send to the next rank and one receive from the previous). Each step asks
``local_k = kk + P - 1`` candidates (kk = k + 1: the row itself ranks
first and is dropped), and pad rows (global id >= n) are masked before
the final cut, as in ``sharded_topk``; ``ops.knn.strip_self`` then drops
each row's own id on the host.

The approximate step is ``ops.topk.approx_topk``, on the card the fp32
fold kernel at the plan ``recall_target`` sets, as ``ops.knn`` runs it on
one card; ``exact=True`` is the blocked plain ``exact_topk``, as the JAX
package's exact step is XLA.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..ops.knn import strip_self
from ..ops.topk import NEG_INF, approx_topk, exact_topk
from .mesh import DATA_AXIS, Mesh, shard_rows
from .sharded_topk import lax_top_k

log = logging.getLogger("latentrag_torch.parallel")


def _rotate(held: list, mesh: Mesh) -> list:
    """Every held shard one ring position on: local position j takes
    j - 1's; position 0 takes the previous rank's last (its own last
    without a process group)."""
    last = held[-1]
    if mesh.world > 1:
        import torch.distributed as dist

        from .distributed import collective_device

        cdev = collective_device(mesh)
        out = last.to(cdev).contiguous()
        inc = torch.empty_like(out)
        ops = [dist.P2POp(dist.isend, out, (mesh.rank + 1) % mesh.world),
               dist.P2POp(dist.irecv, inc, (mesh.rank - 1) % mesh.world)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        last = inc
    return [last.to(mesh.devices[0])] + [
        held[j - 1].to(mesh.devices[j]) for j in range(1, len(held))]


def sharded_knn_graph(
    corpus,
    k: int,
    mesh: Mesh,
    *,
    metric: str = "cosine",
    exact: bool = False,
    recall_target: float = 0.95,
    block_size: int = 1048576,
    axis: str = DATA_AXIS,
) -> np.ndarray:
    """[N, k] int32 neighbour ids a row, self excluded, best first: the
    contract of ``ops.knn.knn_graph`` (corpus prepared for ``metric``; -1
    where fewer than k neighbours exist), computed over ``mesh``. The
    corpus (a host array or a tensor) is row-sharded here; every process
    passes the same corpus and gets the whole graph."""
    n = int(corpus.shape[0])
    if n == 0:
        return np.zeros((0, k), np.int32)
    c_shard = shard_rows(corpus, mesh, axis)
    p = mesh.size
    shard_n = c_shard.rows_per_shard
    padded = shard_n * p
    kk = min(k + 1, n)  # +1: self ranks first and is dropped on the host
    local_k = min(kk + p - 1, shard_n)  # candidates a step
    carry_k = min(kk + p - 1, padded)  # the running list's width

    def local_search(q, c):
        if exact:
            return exact_topk(q, c, k=local_k, metric=metric,
                              block_size=min(block_size, 8192))
        return approx_topk(q, c, k=local_k, metric=metric,
                           block_size=block_size,
                           recall_target=recall_target)

    t0 = time.perf_counter()
    rows = c_shard.shards
    run_s = [torch.full((shard_n, carry_k), NEG_INF, dtype=torch.float32,
                        device=r.device) for r in rows]
    run_i = [torch.full((shard_n, carry_k), -1, dtype=torch.int64,
                        device=r.device) for r in rows]
    held = list(rows)
    for t in range(p):
        for j, r in enumerate(rows):
            me = mesh.global_index(j)
            src = (me - t) % p  # the shard this position holds after t turns
            s, i = local_search(r, held[j])
            gi = torch.where(i >= 0, i.long() + src * shard_n, -1)
            cat_s = torch.cat([run_s[j], s.float()], dim=1)
            cat_i = torch.cat([run_i[j], gi], dim=1)
            run_s[j], sel = lax_top_k(cat_s, carry_k)
            run_i[j] = torch.gather(cat_i, 1, sel)
        if t + 1 < p:
            held = _rotate(held, mesh)
    out = []
    for s, i in zip(run_s, run_i):
        # pad rows (global id >= n) must never survive the final cut
        s = torch.where((i >= 0) & (i < n), s, NEG_INF)
        top_s, sel = lax_top_k(s, min(kk, carry_k))
        top_i = torch.gather(i, 1, sel)
        out.append(torch.where(top_s > NEG_INF * 0.5, top_i, -1).cpu())
    ids = torch.cat(out)
    if mesh.world > 1:
        from .distributed import all_gather_cat

        ids = all_gather_cat(ids, mesh).cpu()
    graph = strip_self(ids.numpy()[:n], 0, k)
    log.info(
        "sharded_knn_graph: %d x %d (k=%d, %s) over %d devices in %.1fs",
        n, int(c_shard.shape[1]), k, "exact" if exact else "approx", p,
        time.perf_counter() - t0,
    )
    return graph
