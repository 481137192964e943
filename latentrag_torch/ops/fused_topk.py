"""Fused distance + top-k: hand-written CUDA kernels and their plain versions.

The port of the JAX package's ``ops/pallas_topk.py``:

* ``fused_topk_raw`` is ``pallas_topk_raw``: (scores [Q, k] f32, ids
  [Q, k] i32) over prepared inputs, without the [Q, N] score matrix.
  ``mode="fold"`` replaces ``_fold_kernel`` (pallas_topk.py:162-179) and
  returns 19-bit-quantized scores; ``mode="exact"`` replaces
  ``_exact_kernel`` (pallas_topk.py:182-221) and returns exact scores,
  ties to the lower corpus row.
* ``fused_topk`` is ``pallas_topk`` (pallas_topk.py:515-559): the raw
  search, then an fp32 rescore of the k winners and a stable sort.
* ``approx_fused_topk`` is the approximate route on the card (the part
  XLA's ``approx_max_k`` played on the TPU): the fold kernel at a tile
  width and candidate count chosen from ``recall_target``
  (``fold_plan``), then the exact rescore, keeping the best k.
* ``binary_fused_topk_raw`` replaces ``_binary_fold_kernel``
  (pallas_topk.py:354-401): the fold over a packed sign-bit store, scored
  against bf16 queries. ``binary_fused_topk`` adds the exact sign-dot
  rescore of the winners (``pallas_binary_topk``, pallas_topk.py:404-508,
  which is also the name here for the transposed layout), and
  ``approx_binary_fused_topk`` is the binary store's stage 1 on the card,
  planned by ``fold_plan`` as the float route is.

On a CUDA tensor ``fused_topk_raw`` and ``binary_fused_topk_raw`` launch
the kernels of ``csrc/fused_topk.cu`` (a partial kernel per query tile and
corpus slab, then a merge kernel across slabs) or raise; on a CPU tensor
they run their plain versions, which repeat the JAX algorithm step by
step, fold included. The kernel source says what bounds it on the H100 and
what its design does about that.

``launches`` counts kernel launches per kernel (``fold``, ``exact``,
``binary_fold``; a call that launches the partial and the merge kernel
counts once); plain-version calls do not count.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

_MIN_I32 = -(2**31) + 1
_IDX_BITS = 13  # tile-local column bits => block_n <= 8192
_IDX_MASK = (1 << _IDX_BITS) - 1
_LANES = 128
FOLD_MAX_K = _LANES
EXACT_MAX_K = 2048  # list of 8 queries x 2048 x 8 B fits one block's shared memory
_SMEM_LIMIT = 227 * 1024  # bytes of shared memory one H100 block may use
_TQ_CHOICES = (32, 16, 8)
_EXACT_SLAB_UNIT = 512  # exact slabs need no fold alignment
_DIM_STAGE = 64  # feature dims per shared-memory stage (DCH in the source)
FOLD_OVERSAMPLE = 4  # candidates per wanted row on the approximate route

launches = {"fold": 0, "exact": 0, "binary_fold": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def _metric_kind(metric: str) -> str:
    if metric in ("cosine", "dot"):
        return "dot"
    if metric in ("euclidean", "mahalanobis"):
        return "euclidean"
    raise ValueError(f"unsupported metric {metric!r}")


def _monotone_i32(s: torch.Tensor) -> torch.Tensor:
    """Order-preserving f32 -> int32 bit map (negatives: flip value bits)."""
    bits = s.contiguous().view(torch.int32)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def _unmonotone_f32(m: torch.Tensor) -> torch.Tensor:
    bits = torch.where(m >= 0, m, m ^ 0x7FFFFFFF).to(torch.int32)
    return bits.contiguous().view(torch.float32)


def _validate(queries, corpus, corpus_sq, k, mode, block_n):
    if mode not in ("fold", "exact"):
        raise ValueError(f"mode must be 'fold' or 'exact', got {mode!r}")
    if block_n > (1 << _IDX_BITS):
        raise ValueError(f"block_n must be <= {1 << _IDX_BITS}")
    if block_n % _LANES != 0:
        raise ValueError(f"block_n must be a multiple of {_LANES}")
    if queries.ndim != 2 or corpus.ndim != 2:
        raise ValueError("queries and corpus must be 2-D")
    if queries.shape[1] != corpus.shape[1]:
        raise ValueError(
            f"queries dim {queries.shape[1]} != corpus dim {corpus.shape[1]}"
        )
    if queries.device != corpus.device:
        raise ValueError("queries and corpus must be on one device")
    if queries.dtype != corpus.dtype or corpus.dtype not in (
        torch.float32, torch.bfloat16,
    ):
        raise ValueError(
            "queries and corpus must share a dtype, float32 or bfloat16 "
            f"(got {queries.dtype}, {corpus.dtype})"
        )
    n = corpus.shape[0]
    if n == 0:
        raise ValueError("empty corpus")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    k_eff = min(k, n)
    if mode == "fold" and k_eff > FOLD_MAX_K:
        # the fold keeps one candidate per lane per tile: beyond 128 it
        # would have to emit fabricated sentinel candidates
        raise ValueError(
            f"fold mode supports k <= {FOLD_MAX_K} (got {k_eff}); use exact mode"
        )
    if mode == "exact" and k_eff > EXACT_MAX_K:
        raise ValueError(
            f"exact mode supports k <= {EXACT_MAX_K} (got {k_eff})"
        )
    if corpus_sq is not None and (
        corpus_sq.shape != (n,) or corpus_sq.device != corpus.device
    ):
        raise ValueError("corpus_sq must be [N] on the corpus's device")
    return k_eff


def _corpus_sq(corpus, corpus_sq):
    """Row norms² from the STORED values (a bf16 store's bf16 rows), as
    ``pallas_topk_raw`` computes them."""
    if corpus_sq is None:
        return torch.sum(torch.square(corpus.float()), dim=1)
    return corpus_sq.float()


def _plain_topk(score_tile, nq, n, k_eff, mode, block_n, dev):
    """The JAX kernels' tile loop in PyTorch: ``score_tile(base, end)``
    gives the [Q, block_n] fp32 scores of rows [base, base + block_n)
    (rows from ``end`` on are padding and never win). A stable descending
    sort stands for the TPU's max-extraction passes (both keep the first
    occurrence of a tie)."""
    run_v = torch.full((nq, k_eff), _MIN_I32, dtype=torch.int32, device=dev)
    run_i = torch.zeros((nq, k_eff), dtype=torch.int32, device=dev)
    local = torch.arange(block_n, dtype=torch.int32, device=dev)
    for base in range(0, n, block_n):
        s = score_tile(base, min(base + block_n, n))
        valid = (local + base) < n
        mono = _monotone_i32(s)
        if mode == "fold":
            packed = (mono & ~_IDX_MASK) | local[None, :]
            packed = torch.where(valid[None, :], packed, _MIN_I32)
            folded = packed.view(nq, block_n // _LANES, _LANES).amax(dim=1)
            tile_v = torch.sort(folded, dim=1, descending=True, stable=True)[
                0
            ][:, :k_eff]
            cand_i = (tile_v & _IDX_MASK) + base
            cand_v = tile_v & ~_IDX_MASK
        else:
            cand_v = torch.where(valid[None, :], mono, _MIN_I32)
            cand_i = (local + base)[None, :].expand(nq, -1)
        comb_v = torch.cat([run_v, cand_v.to(torch.int32)], dim=1)
        comb_i = torch.cat([run_i, cand_i.to(torch.int32)], dim=1)
        order = torch.sort(comb_v, dim=1, descending=True, stable=True)[1]
        order = order[:, :k_eff]
        run_v = torch.gather(comb_v, 1, order)
        run_i = torch.gather(comb_i, 1, order)
    return _unmonotone_f32(run_v), run_i


def fused_topk_raw_reference(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    corpus_sq: torch.Tensor | None = None,
    *,
    k: int,
    metric: str = "cosine",
    mode: str = "fold",
    block_n: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernels: the JAX algorithm tile by
    tile, on any device."""
    k_eff = _validate(queries, corpus, corpus_sq, k, mode, block_n)
    euclid = _metric_kind(metric) == "euclidean"
    nq, d = queries.shape
    n = corpus.shape[0]
    dev = queries.device
    q = queries.float()
    if euclid:
        q_sq = torch.sum(torch.square(q), dim=1, keepdim=True)
        csq = _corpus_sq(corpus, corpus_sq)

    def score_tile(base, end):
        tile = torch.zeros((block_n, d), dtype=torch.float32, device=dev)
        tile[: end - base] = corpus[base:end].float()
        s = q @ tile.T
        if euclid:
            cs = torch.zeros(block_n, dtype=torch.float32, device=dev)
            cs[: end - base] = csq[base:end]
            s = 2.0 * s - q_sq - cs[None, :]
        return s

    return _plain_topk(score_tile, nq, n, k_eff, mode, block_n, dev)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from .cuda_build import load_library

    lib = load_library("fused_topk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lr_topk_partial_smem.restype = ctypes.c_size_t
    lib.lr_topk_partial_smem.argtypes = [i, i, i]
    lib.lr_topk_partial.restype = i
    lib.lr_topk_partial.argtypes = [p, p, p] + [i] * 12 + [p, p, p]
    lib.lr_topk_merge.restype = i
    lib.lr_topk_merge.argtypes = [p, p] + [i] * 5 + [p, p, p]
    lib.lr_error_string.restype = ctypes.c_char_p
    lib.lr_error_string.argtypes = [i]
    return lib


def _pick_tq(lib, d: int, k: int) -> int:
    """The widest query tile whose block fits in shared memory."""
    for tq in _TQ_CHOICES:
        if lib.lr_topk_partial_smem(tq, d, k) <= _SMEM_LIMIT:
            return tq
    raise ValueError(
        f"d={d}, k={k} needs more shared memory than one block has"
    )


def _check(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.lr_error_string(code).decode() if code > 0 else "bad tile"
        raise RuntimeError(f"{what} launch failed: {msg} (code {code})")


def _launch(queries, corpus, csq, *, d, k_eff, block_n, fold, euclid=False,
            vec=False, binary=False):
    """Run the partial kernel over query tiles x corpus slabs, then the
    merge kernel across slabs; returns the [Q, k] (keys, rows) as int32.
    Queries are bf16 or fp32; the corpus has their dtype, or is the
    packed sign words when ``binary``."""
    for name, t in (("queries", queries), ("corpus", corpus)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _library()
    nq = queries.shape[0]
    n = corpus.shape[0]
    dev = queries.device
    tq = _pick_tq(lib, d, k_eff)
    unit = block_n if fold else _EXACT_SLAB_UNIT
    n_units = -(-n // unit)
    q_tiles = -(-nq // tq)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # enough blocks for two per SM; each slab a whole number of fold tiles
    want = max(1, math.ceil(2 * sms / q_tiles))
    slab_rows = -(-n_units // min(n_units, want)) * unit
    n_slabs = -(-n // slab_rows)

    out_k = torch.empty((nq, k_eff), dtype=torch.int32, device=dev)
    out_i = torch.empty((nq, k_eff), dtype=torch.int32, device=dev)
    if n_slabs == 1:
        part_k, part_i = out_k, out_i
    else:
        part_k = torch.empty((n_slabs, nq, k_eff), dtype=torch.int32, device=dev)
        part_i = torch.empty_like(part_k)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.lr_topk_partial(
            queries.data_ptr(), corpus.data_ptr(),
            csq.data_ptr() if csq is not None else None,
            nq, n, d, k_eff, int(queries.dtype == torch.bfloat16),
            int(euclid), int(fold), block_n, slab_rows, tq, int(vec),
            int(binary), part_k.data_ptr(), part_i.data_ptr(), stream,
        )
        _check(lib, code, "fused top-k partial kernel")
        if n_slabs > 1:
            code = lib.lr_topk_merge(
                part_k.data_ptr(), part_i.data_ptr(), n_slabs, nq, k_eff,
                int(fold), block_n, out_k.data_ptr(), out_i.data_ptr(), stream,
            )
            _check(lib, code, "fused top-k merge kernel")
    return out_k, out_i


def _fused_topk_raw_cuda(queries, corpus, corpus_sq, k_eff, euclid, mode,
                         block_n):
    d = queries.shape[1]
    csq = _corpus_sq(corpus, corpus_sq).contiguous() if euclid else None
    # 16-byte corpus loads need whole 64-dim stages and an aligned base
    vec = d % _DIM_STAGE == 0 and corpus.data_ptr() % 16 == 0
    out_k, out_i = _launch(queries, corpus, csq, d=d, k_eff=k_eff,
                           block_n=block_n, fold=mode == "fold",
                           euclid=euclid, vec=vec)
    launches[mode] += 1
    return _unmonotone_f32(out_k), out_i


def fused_topk_raw(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    corpus_sq: torch.Tensor | None = None,
    *,
    k: int,
    metric: str = "cosine",
    mode: str = "fold",
    block_n: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused top-k search. Returns (scores [Q, k] f32, ids [Q, k] i32).

    Inputs must be prepared for ``metric`` (cosine: normalized; euclidean:
    raw, with optional ``corpus_sq`` row norms²; mahalanobis: whitened,
    scored as euclidean in the whitened space). ``mode='fold'`` scores are
    19-bit-quantized (``fused_topk`` rescores them); ``mode='exact'``
    scores are exact. k is clipped to N; fold takes k <= 128, exact
    k <= 2048."""
    k_eff = _validate(queries, corpus, corpus_sq, k, mode, block_n)
    if queries.device.type == "cpu":
        return fused_topk_raw_reference(
            queries, corpus, corpus_sq, k=k, metric=metric, mode=mode,
            block_n=block_n,
        )
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    euclid = _metric_kind(metric) == "euclidean"
    return _fused_topk_raw_cuda(
        queries, corpus, corpus_sq, k_eff, euclid, mode, block_n
    )


def fused_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    corpus_sq: torch.Tensor | None = None,
    *,
    k: int,
    metric: str = "cosine",
    mode: str = "fold",
    block_n: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``fused_topk_raw`` + an fp32 rescore of the winning rows.

    The [Q, k] candidate rows are gathered and rescored against the
    queries as given (a bf16 store's queries arrive bf16-rounded), so the
    returned scores are exact and the order within the candidate set is
    exact even in fold mode. The rescore is elementwise work on Q*k*d
    values, left to PyTorch as the JAX package left it to XLA."""
    _, idx = fused_topk_raw(
        queries, corpus, corpus_sq, k=k, metric=metric, mode=mode,
        block_n=block_n,
    )
    return rescore_candidates(queries, corpus, idx, metric)


def rescore_candidates(
    queries: torch.Tensor, corpus: torch.Tensor, idx: torch.Tensor,
    metric: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 scores of the candidate rows ``idx`` [Q, k], sorted best first
    (stable, so equal scores keep the search's order)."""
    cand = corpus[idx.long()].float()  # [Q, k, D]
    qf = queries.float()
    dots = torch.sum(qf[:, None, :] * cand, dim=2)
    if _metric_kind(metric) == "euclidean":
        scores = (
            2.0 * dots
            - torch.sum(torch.square(qf), dim=1, keepdim=True)
            - torch.sum(torch.square(cand), dim=2)
        )
    else:
        scores = dots
    order = torch.sort(scores, dim=1, descending=True, stable=True)[1]
    return torch.gather(scores, 1, order), torch.gather(idx, 1, order)


def fold_plan(n: int, k: int, recall_target: float) -> tuple[int, int]:
    """(block_n, candidates) for the fold on the approximate route.

    A true top-k row is lost when a better row lands in its lane of its
    tile; with the top k spread over T tiles of 128 lanes the expected
    lost fraction is (k-1)/(256 T). The plan keeps that under a quarter of
    the allowed miss rate 1 - recall_target (the margin covers 19-bit key
    ties, which can hand a lane to the worse row) by narrowing the tile
    below 4096 rows on small corpora, and asks the fold for
    ``FOLD_OVERSAMPLE`` x k candidates (at most 128) so the exact rescore,
    not the quantized key, decides the order at the k-th place."""
    cand = min(FOLD_MAX_K, n, FOLD_OVERSAMPLE * k)
    miss = max(1.0 - float(recall_target), 1e-6)
    t_min = max(1, math.ceil(4 * (k - 1) / (2 * _LANES * miss)))
    block_n = (n // t_min) // _LANES * _LANES
    return min(max(block_n, _LANES), 4096), cand


def approx_fused_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    *,
    k: int,
    metric: str = "cosine",
    recall_target: float = 0.99,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The approximate route: fold candidates per ``fold_plan``, rescored
    exactly; k above the fold's 128 takes the exact kernel. Returned
    scores are exact fp32 scores of the selected rows."""
    k_eff = min(k, corpus.shape[0])
    if k_eff > FOLD_MAX_K:
        return fused_topk(queries, corpus, k=k, metric=metric, mode="exact")
    block_n, cand = fold_plan(corpus.shape[0], k_eff, recall_target)
    _, idx = fused_topk_raw(queries, corpus, k=cand, metric=metric,
                            mode="fold", block_n=block_n)
    scores, idx = rescore_candidates(queries, corpus, idx, metric)
    return scores[:, :k_eff], idx[:, :k_eff]


# ---------------------------------------------------------------- binary


def _validate_binary(queries, packed, d, k, block_n):
    if block_n > (1 << _IDX_BITS) or block_n % _LANES:
        raise ValueError(
            f"block_n must be <= {1 << _IDX_BITS} and a multiple of {_LANES}"
        )
    if queries.ndim != 2 or packed.ndim != 2:
        raise ValueError("queries and packed must be 2-D")
    if queries.shape[1] != d:
        raise ValueError(f"queries dim {queries.shape[1]} != d {d}")
    if packed.dtype != torch.int32 or packed.shape[1] != -(-d // 32):
        raise ValueError(
            f"packed must be int32 sign words [N, {-(-d // 32)}] "
            f"(got {packed.dtype} {tuple(packed.shape)})"
        )
    if queries.device != packed.device:
        raise ValueError("queries and packed must be on one device")
    n = packed.shape[0]
    if n == 0:
        raise ValueError("empty corpus")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    k_eff = min(k, n)
    if k_eff > FOLD_MAX_K:
        raise ValueError(
            f"the binary fold supports k <= {FOLD_MAX_K} (got {k_eff})"
        )
    return k_eff


def binary_fused_topk_raw_reference(
    queries: torch.Tensor, packed: torch.Tensor, *, d: int, k: int,
    block_n: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the binary kernel, on any device:
    ``pallas_binary_topk``'s fold tile by tile, each tile unpacked to +-1
    and scored against the bf16-rounded queries in fp32."""
    from .binary import binary_unpack

    k_eff = _validate_binary(queries, packed, d, k, block_n)
    dev = queries.device
    q = queries.to(torch.bfloat16).float()

    def score_tile(base, end):
        tile = torch.zeros((block_n, d), dtype=torch.float32, device=dev)
        tile[: end - base] = binary_unpack(packed[base:end], d).float()
        return q @ tile.T

    return _plain_topk(score_tile, queries.shape[0], packed.shape[0], k_eff,
                       "fold", block_n, dev)


def binary_fused_topk_raw(
    queries: torch.Tensor, packed: torch.Tensor, *, d: int, k: int,
    block_n: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused packed-binary fold top-k. ``packed`` is the row-major store
    ``ops.binary.binary_quantize`` makes ([N, ceil(d/32)] int32 words).
    Returns (19-bit-quantized sign-dot scores [Q, k] f32, ids [Q, k] i32):
    the fold keys mapped back to fp32. k clips to N and must be <= 128.

    On a CUDA tensor this launches the binary flavour of the partial
    kernel in ``csrc/fused_topk.cu`` (the corpus unpacks to +-1 in shared
    memory, so neither the [Q, N] scores nor an unpacked corpus ever
    exists in device memory) or raises; on a CPU tensor it runs
    ``binary_fused_topk_raw_reference``."""
    k_eff = _validate_binary(queries, packed, d, k, block_n)
    if queries.device.type == "cpu":
        return binary_fused_topk_raw_reference(queries, packed, d=d, k=k,
                                               block_n=block_n)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    q = queries.to(torch.bfloat16).contiguous()
    out_k, out_i = _launch(q, packed, None, d=d, k_eff=k_eff,
                           block_n=block_n, fold=True, binary=True)
    launches["binary_fold"] += 1
    return _unmonotone_f32(out_k), out_i


def rescore_binary_candidates(
    queries: torch.Tensor, packed: torch.Tensor, idx: torch.Tensor, d: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact sign-dot scores of the candidate rows ``idx`` [Q, k] against
    the bf16-rounded queries (the estimator the search used), sorted best
    first (stable)."""
    from .binary import binary_unpack

    nq, kk = idx.shape
    rows = binary_unpack(packed[idx.reshape(-1).long()], d).float()
    qf = queries.to(torch.bfloat16).float()
    scores = torch.sum(qf[:, None, :] * rows.reshape(nq, kk, d), dim=2)
    order = torch.sort(scores, dim=1, descending=True, stable=True)[1]
    return torch.gather(scores, 1, order), torch.gather(idx, 1, order)


def binary_fused_topk(
    queries: torch.Tensor, packed: torch.Tensor, *, d: int, k: int,
    block_n: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``binary_fused_topk_raw`` + the exact sign-dot rescore of the k
    winners and a stable sort (``pallas_binary_topk``'s wrapper)."""
    _, idx = binary_fused_topk_raw(queries, packed, d=d, k=k,
                                   block_n=block_n)
    return rescore_binary_candidates(queries, packed, idx, d)


def pallas_binary_topk(
    queries: torch.Tensor, packed_t: torch.Tensor, *, d: int, k: int,
    block_n: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's name and layout: ``binary_fused_topk`` over the
    transposed store [ceil(d/32), N] (``binary_quantize_t``). The kernel
    reads rows, so the store is transposed back first."""
    return binary_fused_topk(queries, packed_t.T.contiguous(), d=d, k=k,
                             block_n=block_n)


def approx_binary_fused_topk(
    queries: torch.Tensor, packed: torch.Tensor, *, d: int, k: int,
    recall_target: float = 0.99,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The binary store's stage 1 on the card (the part XLA's
    ``approx_max_k`` played on the TPU): the binary fold at the tile width
    and candidate count ``fold_plan`` sets, the candidates rescored to
    exact sign-dots, the best k kept. The fold holds at most 128
    candidates and there is no exact binary kernel, so k above 128
    raises (the store asks for binary_oversample x k)."""
    n = packed.shape[0]
    k_eff = min(k, n)
    if k_eff > FOLD_MAX_K:
        raise ValueError(
            f"the binary store's stage 1 on CUDA takes at most {FOLD_MAX_K} "
            f"candidates (asked for {k_eff}); lower top_k or "
            "retrieval.binary_oversample"
        )
    block_n, cand = fold_plan(n, k_eff, recall_target)
    _, idx = binary_fused_topk_raw(queries, packed, d=d, k=cand,
                                   block_n=block_n)
    scores, idx = rescore_binary_candidates(queries, packed, idx, d)
    return scores[:, :k_eff], idx[:, :k_eff]
