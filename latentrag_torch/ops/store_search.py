"""One search over one (queries, corpus) pair, by the store's route.

The dense retriever searches its whole store through ``store_topk``, and
the sharded search (``parallel.sharded_topk``) each shard of it, so one
device and a mesh take the same kernels at the same k:

* float stores (bf16 / fp32 rows), by ``backend``: ``xla`` is
  ``approx_topk`` (on CUDA the fold kernel up to 128 candidates, the exact
  kernel to 2048, the blocked route past it; on the CPU ``exact_topk``),
  ``xla_exact`` is ``exact_topk`` (the plain oracle), ``pallas`` /
  ``pallas_exact`` the fused kernel in fold / exact mode (they refuse a
  row mask, as in the JAX package), and ``exact`` the exact search of the
  JAX package's sharded backend of that name: on CUDA the exact kernel to
  2048 and the exact select past it (with a row mask past 2048, the
  blocked route), on the CPU ``exact_topk``;
* the int8 store (``scale``: the codes' SQ8 scale): on CUDA
  ``approx_sq8_fused_topk``, on the CPU the plain exact ``sq8_topk``;
* the cascades' stage 1 (``d``: the vectors' width): the int4 store's
  packed nibbles (``scale``: their scale) by ``approx_sq4_fused_topk`` /
  ``sq4_topk``, the binary store's sign words by
  ``approx_binary_fused_topk`` / ``binary_topk``; slots no allowed row
  fills hold id -1.

``mask`` is the allowed rows' packed int32 words (``ops.topk.
pack_row_mask``) or a bool row mask. The queries are the prepared fp32
rows or, for the int8 and int4 stores, ``prepare_queries``' SQ8 (codes,
scale) of them: a sharded search quantizes once for all of its shards.
Returns (scores [Q, k'], ids [Q, k']) on the corpus's device,
k' = min(k, N).
"""

from __future__ import annotations

import torch

from .binary import binary_topk
from .fused_topk import (
    EXACT_MAX_K,
    approx_binary_fused_topk,
    approx_fused_topk,
    approx_sq4_fused_topk,
    approx_sq8_fused_topk,
    fused_topk,
)
from .quantization import sq4_topk, sq8_queries, sq8_topk
from .topk import NEG_INF, approx_topk, exact_topk, pack_row_mask

STORES = ("float", "int8", "int4", "binary")


def prepare_queries(q: torch.Tensor, store: str = "float"):
    """The queries as ``store_topk`` takes them for ``store``: the int8
    and int4 stores' SQ8 (codes, scale), one scale over the batch; the
    others' as they are (and a pair already prepared)."""
    if store in ("int8", "int4") and not isinstance(q, tuple):
        return sq8_queries(q.float().contiguous())
    return q


def store_topk(
    q: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    *,
    store: str = "float",
    backend: str = "xla",
    metric: str = "cosine",
    recall_target: float = 0.99,
    block_size: int = 1048576,
    mask: torch.Tensor | None = None,
    scale=None,
    d: int | None = None,
):
    """The top k of ``corpus`` for the prepared queries ``q`` by the
    route of ``store`` and ``backend`` (see the module docstring)."""
    cuda = corpus.device.type == "cuda"
    if cuda and mask is not None and mask.dtype == torch.bool:
        mask = pack_row_mask(mask)  # the kernels read the packed words
    q = prepare_queries(q, store)
    if store == "int8":
        if cuda:
            return approx_sq8_fused_topk(
                q, corpus, scale, k=k, recall_target=recall_target,
                mask=mask, block_size=block_size)
        return sq8_topk(q, corpus, scale, k, block_size=block_size,
                        mask=mask)
    if store in ("int4", "binary"):
        if store == "binary":
            q = q.float().contiguous()
        return _stage1(q, corpus, k, store=store,
                       recall_target=recall_target, block_size=block_size,
                       mask=mask, scale=scale, d=d)
    if store != "float":
        raise ValueError(f"store {store!r} not in {STORES}")
    q = q.to(corpus.dtype).contiguous()
    if backend == "xla":
        return approx_topk(q, corpus, k=k, metric=metric,
                           block_size=block_size,
                           recall_target=recall_target, mask=mask)
    if backend == "xla_exact" or (backend == "exact" and not cuda):
        return exact_topk(q, corpus, k=k, metric=metric,
                          block_size=min(block_size, 8192), mask=mask)
    if backend == "exact":
        if mask is not None and min(k, corpus.shape[0]) > EXACT_MAX_K:
            # the exact select past 2048 takes no mask; the blocked route
            # is exact too
            return approx_fused_topk(q, corpus, k=k, metric=metric,
                                     mask=mask)
        return fused_topk(q, corpus, k=k, metric=metric, mode="exact",
                          mask=mask)
    if mask is not None:
        raise ValueError(
            "pallas backends do not support filtered search; use "
            "backend='xla'/'xla_exact'"
        )
    if backend not in ("pallas", "pallas_exact"):
        raise ValueError(f"unknown backend {backend!r}")
    mode = "fold" if backend == "pallas" else "exact"
    return fused_topk(q, corpus, k=k, metric=metric, mode=mode)


def _stage1(q, corpus, k, *, store, recall_target, block_size, mask, scale,
            d):
    """The cascades' exhaustive stage 1: ``k`` candidates by int4 score or
    sign-dot (the fold or exact kernels on the card, the plain exact
    search on the CPU); slots no allowed row fills are -1."""
    int4 = store == "int4"
    if corpus.device.type == "cuda":  # empty slots come back as -1
        if int4:
            return approx_sq4_fused_topk(
                q, corpus, scale, d=d, k=k, recall_target=recall_target,
                mask=mask, block_size=block_size)
        return approx_binary_fused_topk(q, corpus, d=d, k=k,
                                        recall_target=recall_target,
                                        mask=mask)
    if int4:
        s1, cand = sq4_topk(q, corpus, scale, d, k, block_size=block_size,
                            mask=mask)
    else:
        s1, cand = binary_topk(q, corpus, d=d, k=k, mask=mask)
    if mask is not None:  # its NEG_INF slots hold arbitrary rows
        cand = torch.where(s1 > NEG_INF * 0.5, cand, -1)
    return s1, cand
