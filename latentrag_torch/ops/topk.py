"""Exact dense top-k (the plain oracle), the approximate route, MaxSim.

The port of the JAX package's ``ops/topk.py``:

* ``exact_topk``: the corpus streams in blocks through one matmul and a
  running top-k merge, so the [Q, N] score matrix never exists beyond one
  block. It is the oracle the kernels are held against, and like the JAX
  version it runs outside the kernels (``torch.matmul`` + ``torch.topk``).
  Its order is ``lax.top_k``'s, ties to the lower row: it selects on
  ``order_keys``, as ``torch.topk`` alone leaves the order of equal
  scores open (identical chunks of templated documents tie exactly).
  ``lax_order=False`` selects on the float scores alone, which is faster
  on the card at large k; the approximate route past the fused kernels'
  k takes it, as its JAX counterpart has no tie order to match.
* ``approx_topk`` keeps its signature. XLA's ``approx_max_k`` has no CUDA
  counterpart, so on the card it routes to the fused kernel in fold mode,
  with ``recall_target`` setting the fold's tile width and candidate count
  (candidate set quasi-exact, returned scores exact); on the CPU it routes
  to ``exact_topk``.
* ``maxsim_aggregate``: doc-level MaxSim over the candidate chunks.
* ``unpack_row_mask`` / ``pack_row_mask``: a row mask's little-endian
  packed bits (bytes, or the int32 words the kernels read) and its bool
  form. ``exact_topk`` and ``approx_topk`` take either form.
"""

from __future__ import annotations

import torch

from .distances import pairwise_scores

NEG_INF = float(-3.4e38)
_INT_MAX = 2**31 - 1


def order_keys(scores: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """int64 keys whose descending order is (score desc, row asc), the
    order of ``lax.top_k``: the scores' order-preserving int32 bits above
    ``INT_MAX - row``."""
    bits = scores.float().contiguous().view(torch.int32)
    mono = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    return (mono << 32) | (_INT_MAX - rows.to(torch.int64))


def decode_keys(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``order_keys``' keys back to (scores f32, rows i64), bit for bit."""
    mono = (keys >> 32).to(torch.int32)
    scores = torch.where(mono >= 0, mono, mono ^ 0x7FFFFFFF).view(
        torch.float32)
    return scores, _INT_MAX - (keys & 0xFFFFFFFF)


def unpack_row_mask(packed: torch.Tensor, n: int) -> torch.Tensor:
    """uint8 [ceil(n/8)] little-endian bits, or the same bits as int32
    words [ceil(n/32)] (bit ``r & 31`` of word ``r >> 5`` is row r) -> bool
    [n] row mask."""
    if packed.dtype == torch.int32:
        packed = packed.contiguous().view(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, None] >> shifts[None, :]) & 1
    return bits.reshape(-1)[:n].to(torch.bool)


def pack_row_mask(mask: torch.Tensor) -> torch.Tensor:
    """bool [n] -> int32 words [ceil(n/32)], bit ``r & 31`` of word
    ``r >> 5`` set iff row r is allowed (pad bits 0)."""
    n = mask.shape[0]
    bits = torch.nn.functional.pad(mask.to(torch.int64), (0, (-n) % 32))
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    words = torch.sum(bits.reshape(-1, 32) << shifts, dim=1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def as_bool_mask(mask: torch.Tensor | None, n: int) -> torch.Tensor | None:
    """A row mask in either form as bool [n] (None stays None)."""
    if mask is None or mask.dtype == torch.bool:
        return mask
    return unpack_row_mask(mask, n)


def _apply_mask(scores: torch.Tensor, mask_block) -> torch.Tensor:
    if mask_block is None:
        return scores
    return torch.where(mask_block[None, :], scores, NEG_INF)


def exact_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    metric: str = "cosine",
    block_size: int = 8192,
    mask: torch.Tensor | None = None,
    lax_order: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the full corpus: (scores [Q, k] f32, indices [Q, k] i64),
    best first, ties to the lower row (``lax_order=False``: equal scores
    in no set order).

    Inputs must be prepared for ``metric``. k is clipped to N. ``mask``
    (bool [N], or its packed int32 words) restricts eligibility; excluded
    rows score NEG_INF."""
    n_total = corpus.shape[0]
    mask = as_bool_mask(mask, n_total)
    k = min(k, n_total)
    if not lax_order:
        return _float_topk(queries, corpus, k, metric, block_size, mask)
    run = torch.zeros((queries.shape[0], 0), dtype=torch.int64,
                      device=queries.device)
    for base in range(0, n_total, block_size):
        block = corpus[base : base + block_size]
        m_blk = None if mask is None else mask[base : base + block_size]
        scores = _apply_mask(pairwise_scores(queries, block, metric), m_blk)
        rows = torch.arange(base, base + block.shape[0],
                            device=scores.device)
        keys = order_keys(scores, rows[None, :])
        run = torch.topk(torch.cat([run, keys], dim=1), k, dim=1)[0]
    return decode_keys(run)


def _float_topk(queries, corpus, k, metric, block_size, mask):
    """``exact_topk(lax_order=False)``: ``torch.topk`` of each block's
    float scores, merged with the running list."""
    n_total = corpus.shape[0]
    if n_total <= block_size:
        scores = _apply_mask(pairwise_scores(queries, corpus, metric), mask)
        return torch.topk(scores, k, dim=1)
    nq = queries.shape[0]
    run_s = torch.full((nq, k), NEG_INF, dtype=torch.float32,
                       device=queries.device)
    run_i = torch.zeros((nq, k), dtype=torch.int64, device=queries.device)
    for base in range(0, n_total, block_size):
        block = corpus[base : base + block_size]
        m_blk = None if mask is None else mask[base : base + block_size]
        scores = _apply_mask(pairwise_scores(queries, block, metric), m_blk)
        blk_s, blk_i = torch.topk(scores, min(k, block.shape[0]), dim=1)
        cat_s = torch.cat([run_s, blk_s], dim=1)
        cat_i = torch.cat([run_i, blk_i + base], dim=1)
        run_s, sel = torch.topk(cat_s, k, dim=1)
        run_i = torch.gather(cat_i, 1, sel)
    return run_s, run_i


def approx_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    metric: str = "cosine",
    block_size: int = 1048576,
    recall_target: float = 0.99,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The production top-k. On CUDA: ``approx_fused_topk``, the fused
    fold kernel at a tile width and candidate count chosen from
    ``recall_target``, rescored exactly (the exact kernel above k=128);
    ``block_size`` is the JAX signature's and unused there. On the CPU:
    ``exact_topk``. ``mask`` (bool [N] or its packed int32 words) restricts
    eligibility; on CUDA the kernels read the packed words, and slots no
    allowed row fills are (NEG_INF, -1)."""
    if queries.device.type == "cuda":
        from .fused_topk import approx_fused_topk

        if mask is not None and mask.dtype == torch.bool:
            mask = pack_row_mask(mask)
        return approx_fused_topk(queries, corpus, k=k, metric=metric,
                                 recall_target=recall_target, mask=mask)
    return exact_topk(queries, corpus, k=k, metric=metric,
                      block_size=min(block_size, 8192), mask=mask)


def maxsim_aggregate(
    chunk_scores: torch.Tensor,
    chunk_doc_ids: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Doc-level MaxSim over retrieved chunk candidates: each doc scores
    the max over its chunks; later duplicates of a doc are forced to
    NEG_INF so a doc appears once; returns top-k (doc_scores, doc_ids)
    [Q, k]. The order is ``lax.top_k``'s: descending over the floats'
    total order (+0.0 above -0.0), ties to the earlier candidate."""
    same = chunk_doc_ids[:, :, None] == chunk_doc_ids[:, None, :]
    s = chunk_scores.float()
    agg = torch.where(same, s[:, None, :], NEG_INF).amax(dim=-1)
    c = chunk_scores.shape[1]
    earlier = torch.tril(
        torch.ones((c, c), dtype=torch.bool, device=s.device), diagonal=-1
    )[None]
    is_dup = torch.any(same & earlier, dim=-1)
    agg = torch.where(is_dup, NEG_INF, agg)
    kk = min(k, c)
    bits = agg.contiguous().view(torch.int32)
    key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)  # order-preserving
    sel = torch.sort(key, dim=1, descending=True, stable=True)[1][:, :kk]
    return torch.gather(agg, 1, sel), torch.gather(chunk_doc_ids, 1, sel)
