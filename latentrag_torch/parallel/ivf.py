"""The device IVF over a corpus sharded on the mesh: an inverted file a
shard, every shard probed, the candidates gathered and merged.

The port of the JAX package's ``parallel/ivf.py``. The corpus rows are
row-sharded (``shard_rows``, zero pad rows at the end) and each shard
builds its own inverted file over ITS rows, on its device: ``max(1, nlist
// P)`` lists trained on the shard (``nlist`` is the total budget, so the
mean list size stays), by ``ops.ivf``'s build functions (``ivf_build``, and for
the packed stores ``ivf_build_binary`` / ``ivf_build_sq4``, which need
``dim``). No shard's inverted file crosses to another device.

Every shard is padded to the largest shard's block count ``nb`` (across
processes, the largest over all of them), the pad blocks owned by list -1,
so every shard has the JAX package's padded geometry: ``nb`` decides the
auto probe budget, the clamp of a request's ``nprobe`` and the wide-index
switch (``nblocks > 8192``) inside ``ops.ivf.ivf_search`` on every shard,
as the padded ``sivf.nblocks`` decides them in the JAX search, and a pad
block is never probed ahead of a real one.

A search probes each shard with ``ops.ivf.ivf_search`` (the
``ivf_scan_kernel`` on the card, one launch a shard) at ``local_k = k + P
- 1``, as ``sharded_topk`` does for the pad rows; the local ids are offset
by the shard's global index x ``rows_per_shard``, ids at or past
``n_valid`` score NEG_INF, and one select merges the [P, Q, local_k]
candidates in ``lax.top_k``'s order over the shard-major concatenation
(``sharded_topk.merge_shards``); slots whose score is NEG_INF come back as
id -1. A filter's mask is row-sharded like the corpus, each shard's words
its own rows'.

Departure from the JAX package: every shard's ``ivf_search`` gets
``max_list_blocks``, the largest list in blocks over all shards, computed
once at build. The JAX search passes none, so a shard wider than 8192
blocks clips a skewed list to 4x the average + 8 blocks; the answers are
the JAX package's wherever the JAX search does not clip.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.ivf import (
    IVFIndex,
    ivf_assignments,
    ivf_build,
    ivf_build_binary,
    ivf_build_from_assign,
    ivf_build_sq4,
    ivf_search,
    largest_list_blocks,
)
from ..ops.topk import pack_row_mask
from .mesh import Mesh, ShardedRows
from .sharded_topk import merge_shards


@dataclass
class ShardedIVF:
    """This process's shards' inverted files: ``shards[j]`` is global shard
    ``mesh.global_index(j)``'s, on ``mesh.devices[j]``, padded to
    ``nblocks`` blocks; block ids are LOCAL rows of the shard."""

    shards: list  # [IVFIndex], local shard order
    rows_per_shard: int
    max_list_blocks: int  # the largest list in blocks over every shard
    mesh: Mesh

    @property
    def nblocks(self) -> int:
        """The padded block count every shard has."""
        return self.shards[0].nblocks

    @property
    def cap(self) -> int:
        return self.shards[0].cap


def _pad_index(idx: IVFIndex, nb: int) -> IVFIndex:
    """``idx`` padded to ``nb`` blocks: zero rows, ids -1, list -1 (pad
    blocks are never probed ahead of a real one and hold no row)."""
    extra = nb - idx.nblocks
    if extra <= 0:
        return idx
    dev = idx.blocks.device
    cap, w = idx.cap, idx.row_width
    return IVFIndex(
        idx.centroids,
        torch.cat([idx.blocks, torch.zeros((extra, cap, w),
                                           dtype=idx.blocks.dtype,
                                           device=dev)]),
        torch.cat([idx.block_ids, torch.full((extra, cap), -1,
                                             dtype=torch.int32, device=dev)]),
        torch.cat([idx.block2list, torch.full((extra,), -1,
                                              dtype=torch.int32,
                                              device=dev)]),
    )


def _global_max(value: int, mesh: Mesh) -> int:
    """The largest ``value`` over the mesh's processes."""
    if mesh.world == 1:
        return int(value)
    import torch.distributed as dist

    from .distributed import collective_device

    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=collective_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def _assemble(built: list, corpus: ShardedRows, mesh: Mesh) -> ShardedIVF:
    """Pad this process's built shards to the global block count and keep
    the global largest list."""
    nb = _global_max(max(b.nblocks for b in built), mesh)
    mlb = _global_max(max(largest_list_blocks(b) for b in built), mesh)
    return ShardedIVF([_pad_index(b, nb) for b in built],
                      corpus.rows_per_shard, mlb, mesh)


def build_sharded_ivf(
    corpus_sharded: ShardedRows,
    mesh: Mesh,
    nlist: int,
    cap: int = 512,
    *,
    dim: int = 0,
    seed: int = 0,
    timings: dict | None = None,
) -> ShardedIVF:
    """Per-shard inverted files over a row-sharded corpus (``shard_rows``:
    its pad rows are masked at the merge by ``n_valid``). ``nlist`` is the
    total budget: each shard trains ``max(1, nlist // P)`` lists over its
    own rows. ``dim`` (the vectors' width) marks a packed corpus (int32
    sign words or uint8 int4 nibbles). ``timings`` sums the shards' build
    seconds by stage (``ivf_build``'s keys). Every process of a process
    group calls it (the block counts are agreed across them)."""
    nls = max(1, nlist // mesh.size)
    packed = corpus_sharded.dtype in (torch.int32, torch.uint8)
    if packed and not dim:
        raise ValueError("packed corpus requires dim=<vector dim>")
    built = []
    for shard in corpus_sharded.shards:  # each on its own device
        if corpus_sharded.dtype == torch.int32:
            built.append(ivf_build_binary(shard, dim, nls, cap, seed=seed,
                                          timings=timings))
        elif corpus_sharded.dtype == torch.uint8:
            built.append(ivf_build_sq4(shard, dim, nls, cap, seed=seed,
                                       timings=timings))
        else:
            built.append(ivf_build(shard, nls, cap, seed=seed,
                                   timings=timings))
    return _assemble(built, corpus_sharded, mesh)


def local_shard_index(sivf: ShardedIVF, pos: int = 0) -> IVFIndex:
    """This process's ``pos``-th shard's inverted file (mesh order), on its
    device, as it lies: the per-shard recall probe's index."""
    return sivf.shards[pos]


def sharded_ivf_assignments(sivf: ShardedIVF) -> np.ndarray:
    """[P, rows_per_shard] int32 LOCAL list of every shard-local row (pad
    rows included), recovered from each shard's layout: with the [P,
    nlist_shard, d] centroids, the state a warm boot regroups from
    (``build_sharded_ivf_from_assign``). Across processes the shards'
    rows are all-gathered, so every process returns all P."""
    rps = sivf.rows_per_shard
    local = torch.stack([ivf_assignments(idx, rps).cpu()
                         for idx in sivf.shards])
    if sivf.mesh.world > 1:
        from .distributed import all_gather_cat

        local = all_gather_cat(local, sivf.mesh).cpu()
    return local.numpy().astype(np.int32)


def sharded_ivf_centroids(sivf: ShardedIVF) -> np.ndarray:
    """[P, nlist_shard, d] fp32 centroids of every shard (across
    processes, all-gathered)."""
    local = torch.stack([idx.centroids.float().cpu() for idx in sivf.shards])
    if sivf.mesh.world > 1:
        from .distributed import all_gather_cat

        local = all_gather_cat(local, sivf.mesh).cpu()
    return local.numpy()


def build_sharded_ivf_from_assign(
    corpus_sharded: ShardedRows,
    mesh: Mesh,
    centroids: np.ndarray,
    assign: np.ndarray,
    cap: int,
) -> ShardedIVF:
    """A ``ShardedIVF`` from persisted per-shard centroids [P,
    nlist_shard, d] and assignments [P, rows_per_shard]: no k-means, no
    assignment sweep. Each shard regroups by ``ops.ivf.
    ivf_build_from_assign``'s deterministic gather, so the index serves the
    saved one's candidates (same sharded corpus, same cap). The mesh must
    have the saved size."""
    p = mesh.size
    if centroids.shape[0] != p or assign.shape[0] != p:
        raise ValueError(
            f"sidecar geometry ({centroids.shape[0]} shards) does not "
            f"match the mesh ({p} devices)")
    built = []
    for j, shard in enumerate(corpus_sharded.shards):
        g = mesh.global_index(j)
        built.append(ivf_build_from_assign(
            shard, np.asarray(centroids[g], dtype=np.float32),
            np.ascontiguousarray(assign[g], dtype=np.int32), cap))
    return _assemble(built, corpus_sharded, mesh)


def make_sharded_ivf_topk(
    mesh: Mesh,
    *,
    k: int,
    nprobe: int,
    metric: str = "cosine",
    dim: int = 0,
    filtered: bool = False,
):
    """``(q, sivf, n_valid, scale=None, mask_shard=None) -> (scores [Q, k]
    f32, GLOBAL row ids [Q, k] int64)``, (NEG_INF, -1) in empty slots, on
    the mesh's first device, the same on every process. ``q``: prepared
    fp32 queries; ``scale``: the int8 codes' or int4 nibbles' scale;
    ``mask_shard`` (with ``filtered``): the allowed rows, row-sharded like
    the corpus, as bools or each shard's packed int32 words. It takes no
    ``recall_target``: the port's IVF select is always exact."""
    local_k = k + mesh.size - 1

    def search(q, sivf: ShardedIVF, n_valid, scale=None, mask_shard=None):
        if filtered and mask_shard is None:
            raise ValueError(
                "this sharded IVF was built with filtered=True; pass the "
                "row-sharded mask")
        if not filtered and mask_shard is not None:
            raise ValueError(
                "mask_shard passed to a sharded IVF built without "
                "filtered=True; the mask would be silently ignored")
        q_on: dict = {}
        parts_s, parts_i = [], []
        for j, idx in enumerate(sivf.shards):
            dev = idx.blocks.device
            if dev not in q_on:
                q_on[dev] = q.to(dev)
            m = None if mask_shard is None else mask_shard.shards[j]
            if m is not None and m.dtype == torch.bool:
                m = pack_row_mask(m)  # the scan reads the packed words
            s, i = ivf_search(q_on[dev], idx, k=local_k, nprobe=nprobe,
                              metric=metric, scale=scale, mask=m, dim=dim,
                              max_list_blocks=sivf.max_list_blocks)
            parts_s.append(s)
            parts_i.append(i)
        return merge_shards(mesh, parts_s, parts_i, sivf.rows_per_shard,
                            int(n_valid), k)

    return search
