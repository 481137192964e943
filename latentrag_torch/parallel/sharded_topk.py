"""Top-k over a corpus sharded on the mesh: each shard searched with the
single-device kernels, the candidates gathered and merged.

The port of the JAX package's ``parallel/sharded_topk.py``. Every shard
searches the (replicated) queries with its store's own route
(``ops.store_search.store_topk``) at ``local_k = k + P - 1``: the at most
P - 1 zero pad rows of ``shard_rows`` can outscore real rows (a zero row
scores 0 under dot, -|q|^2 under euclidean), so masking them afterwards
must never leave a real top-k member behind. The local ids are offset by
the shard's global start in int64, ids at or past ``n_valid`` are masked
to NEG_INF, the [Q, local_k] pairs go to the mesh's first device (across
processes one ``all_gather``: directly on NCCL, through the host on gloo,
which moves no CUDA tensors), and one select merges them in
``lax.top_k``'s order, ties to the lower position of the shard-major
concatenation. Slots whose score is NEG_INF come back as id -1.

The shards' searches are queued without a host sync between them, so
shards on separate cards run at once. A filter's mask is row-sharded
exactly like the corpus (``shard_rows`` of the bool rows, pads False) and
each shard packs the words of its own rows, since a shard's first row
need not start a 32-row word.
"""

from __future__ import annotations

import torch

from ..ops.store_search import prepare_queries, store_topk
from ..ops.topk import NEG_INF, decode_keys, order_keys
from .mesh import DATA_AXIS, Mesh, ShardedRows

# make_sharded_topk's backends: (store, route) of ops.store_search
_BACKENDS = {
    "approx": ("float", "xla"),
    "exact": ("float", "exact"),
    "sq8": ("int8", None),
    "sq4": ("int4", None),
    "binary": ("binary", None),
}


def lax_top_k(scores: torch.Tensor, k: int):
    """(values, positions) of the k best of each row, ties to the lower
    position, as ``lax.top_k`` orders them."""
    cols = torch.arange(scores.shape[1], device=scores.device)
    keys = torch.topk(order_keys(scores, cols[None, :]), k, dim=1)[0]
    vals, pos = decode_keys(keys)
    return vals, pos


def merge_candidates(scores: list, ids: list, k: int):
    """One select over the shards' candidates (each [Q, kk], ids global
    int64, in shard order): the best k, lax order, -1 where the score is
    NEG_INF."""
    cat_s = torch.cat(scores, dim=1)
    cat_i = torch.cat(ids, dim=1)
    top_s, sel = lax_top_k(cat_s, min(k, cat_s.shape[1]))
    top_i = torch.gather(cat_i, 1, sel)
    return top_s, torch.where(top_s > NEG_INF * 0.5, top_i, -1)


def sharded_search(search, q, sharded: ShardedRows, n_valid: int, k: int,
                   mask_shard: ShardedRows | None = None):
    """The sharded top-k with ``search(q_on_device, shard, local_k,
    mask_or_None) -> (scores, ids)`` as each shard's route: (scores [Q, k']
    f32, ids [Q, k'] int64 global, -1 in empty slots) on the mesh's first
    device, the same on every process. ``q``: a tensor, or a tuple of them
    (``prepare_queries``' codes and scale), copied once to each distinct
    device."""
    mesh = sharded.mesh
    dev0 = mesh.devices[0]
    local_k = k + mesh.size - 1
    q_on = {}
    parts_s, parts_i = [], []
    for j, shard in enumerate(sharded.shards):
        dev = shard.device
        if dev not in q_on:
            q_on[dev] = (tuple(t.to(dev) for t in q) if isinstance(q, tuple)
                         else q.to(dev))
        m = None if mask_shard is None else mask_shard.shards[j]
        s, i = search(q_on[dev], shard, local_k, m)
        gi = torch.where(i >= 0, i.long() + sharded.offset(j), -1)
        s = torch.where((gi >= 0) & (gi < n_valid), s.float(), NEG_INF)
        parts_s.append(s.to(dev0))
        parts_i.append(gi.to(dev0))
    if mesh.world > 1:
        from .distributed import all_gather_cat

        # [L, Q, kk] a process -> [P, Q, kk] in global shard order
        all_s = all_gather_cat(torch.stack(parts_s), mesh).to(dev0)
        all_i = all_gather_cat(torch.stack(parts_i), mesh).to(dev0)
        parts_s, parts_i = list(all_s), list(all_i)
    return merge_candidates(parts_s, parts_i, k)


def make_sharded_topk(
    mesh: Mesh,
    *,
    k: int,
    metric: str = "cosine",
    backend: str = "approx",
    block_size: int = 1048576,
    recall_target: float = 0.99,
    axis: str = DATA_AXIS,
    d: int | None = None,
    filtered: bool = False,
):
    """``(queries, corpus_sharded, n_valid, scale=None, mask_shard=None)
    -> (scores, ids)``, the JAX function's contract.

    ``corpus_sharded`` comes from ``shard_rows``; ``n_valid`` is the true
    row count (pad rows are masked in the merge); ids are global corpus
    rows, -1 in slots no row fills. ``backend``: ``approx`` (the
    approximate route), ``exact``, ``sq8`` (int8 codes, ``scale`` their
    SQ8 scale), ``sq4`` (packed int4 nibbles, ``scale`` theirs) and
    ``binary`` (packed sign words; the cascade's stage 1); the last two
    need ``d``, the vectors' width. ``filtered=True`` takes ``mask_shard``,
    a bool row mask row-sharded exactly like the corpus."""
    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    if backend not in _BACKENDS:
        raise ValueError(f"backend {backend!r} not in {tuple(_BACKENDS)}")
    store, route = _BACKENDS[backend]
    if store in ("int4", "binary") and d is None:
        raise ValueError(f"backend={backend!r} requires d (true vector dim)")

    def call(q, c_shard, n_valid, scale=None, mask_shard=None):
        if filtered and mask_shard is None:
            raise ValueError(
                "this sharded top-k was built with filtered=True; "
                "pass the row-sharded mask"
            )
        if not filtered and mask_shard is not None:
            raise ValueError(
                "mask_shard passed to a sharded top-k built without "
                "filtered=True; the mask would be silently ignored"
            )

        def search(qd, shard, kk, m):
            return store_topk(qd, shard, kk, store=store, backend=route,
                              metric=metric, recall_target=recall_target,
                              block_size=block_size, mask=m,
                              scale=1.0 if scale is None else scale, d=d)

        return sharded_search(search, prepare_queries(q, store), c_shard,
                              int(n_valid), k, mask_shard)

    return call
