"""Fused distance + top-k: hand-written CUDA kernels and their plain versions.

The port of the JAX package's ``ops/pallas_topk.py``:

* ``fused_topk_raw`` is ``pallas_topk_raw``: (scores [Q, k] f32, ids
  [Q, k] i32) over prepared inputs, without the [Q, N] score matrix.
  ``mode="fold"`` replaces ``_fold_kernel`` (pallas_topk.py:162-179) and
  returns 19-bit-quantized scores; ``mode="exact"`` replaces
  ``_exact_kernel`` (pallas_topk.py:182-221) and returns exact scores,
  ties to the lower corpus row, at any k <= N as the TPU kernel does: on
  the card through the exact kernel's lists up to ``EXACT_MAX_K``, and
  past it ``csrc/exact_select.cuh``: a threshold from a strided sample of
  the corpus, one pass that keeps the keys at or above it, and a radix
  select for the queries it does not serve (``_exact_select``).
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
  planned by ``fold_plan`` as the float route is; above the fold's 128
  candidates it takes ``binary_exact_topk_raw``, the exact sign-dot search
  (``ops/binary.py``'s ``binary_topk`` in a kernel), as the float route
  takes the exact kernel.
* Past ``EXACT_MAX_K`` (2048) the two approximate routes take a blocked
  search on any device: the corpus scored in blocks by ``torch.matmul``
  and each block's top k merged with the running list
  (``ops.topk.exact_topk``; the binary store's ``ops.binary.binary_topk``),
  so the [Q, N] score matrix never exists beyond one block. That is the
  port of the JAX package's own route there, XLA's ``approx_max_k`` over a
  ``dot_general`` outside any Pallas kernel (the JAX package's
  ``ops/topk.py:209-277`` and ``ops/binary.py:151-177``). Routes are
  chosen by k, never by a failure. ``binary_exact_topk_raw``, whose JAX
  counterpart ``binary_topk`` is XLA and not Pallas, raises past it on the
  card.

On a CUDA tensor the raw functions launch the kernels of
``csrc/fused_topk.cu`` or raise; on a CPU tensor they run their plain
versions, which repeat the JAX algorithm step by step, fold included.
Every store runs tensor-core kernels that write the scores and ids
themselves: the folds in ``csrc/fold_mma.cuh``, the exact searches in
``csrc/exact_mma.cuh`` (batched list upkeep in both), each instantiated
for bf16, packed binary and fp32 operands, and the float stores' exact
search past 2048 in ``csrc/exact_select.cuh``. fp32 stores multiply in
3xTF32 (each operand split into rounded tf32 hi and lo parts, three
products a pair), within ~3 x 2^-22 of each exact product, the size of
fp32 sum-order differences. The kernel sources say what bounds them on
the H100 and what their designs do about that.

``launches`` counts kernel launches per kernel (``fold``, ``exact``,
``binary_fold``, ``binary_exact``; a call that launches several kernels,
a partial and a merge or the select's passes and sort, counts once) and
the blocked route's calls on the card (``blocked``, ``binary_blocked``);
plain-version calls and the blocked route on the CPU do not count.
``last_kernel`` names the C kernels the latest launch ran.

Euclidean scores are 2 q.c - |q|^2 - |c|^2. Every kernel and the plain
version sum |q|^2 in one order (``row_sq``: column by column from 0, each
product and each sum rounded to fp32, no fused multiply-add), so the
kernels' scores differ from the plain version's only by the order of the
q.c sums.
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
EXACT_MAX_K = 2048  # the exact kernels' lists; the routes block past it
FOLD_OVERSAMPLE = 4  # candidates per wanted row on the approximate route

# operand kinds of the tensor-core kernels (OP_* in csrc/fused_topk.cu) and
# the suffix each gives a kernel's name in ``last_kernel``
_OP_BF16, _OP_BIN, _OP_F32 = 0, 1, 2
_OP_TAG = {_OP_BF16: "", _OP_BIN: "<bin>", _OP_F32: "<f32>"}

_FM_TQ = 64  # queries per block of the fold kernel (FM_TQ)
_ES_TQ = 16  # queries per block of the radix select's passes (EM_QROWS)
# the exact tensor-core kernel splits the corpus into slabs only while each
# keeps at least this many 128-row sub-tiles: a smaller slab does not pay
# for the merge launch after it
_EM_MIN_SLAB_SUBTILES = 8

# the exact select's buffer routes (csrc/exact_select.cuh): the keys a
# sort block holds in shared memory (ES_SORT_SMEM), the sampled
# threshold's rank at most (a 256-entry list of exact_mma_kernel), and the
# buffers' device memory at most
_ES_SORT_SMEM = 16384
_ES_SAMPLE_RANK = 256
_ES_BUFFER_BYTES = 1 << 30

launches = {"fold": 0, "exact": 0, "binary_fold": 0, "binary_exact": 0,
            "blocked": 0, "binary_blocked": 0}
last_kernel: str | None = None
# the latest exact select's plan: route, sample stride and rank, capacity
last_select: dict | None = None
_select_fell: torch.Tensor | None = None  # its device count of fallbacks


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
    if corpus_sq is not None and (
        corpus_sq.shape != (n,) or corpus_sq.device != corpus.device
    ):
        raise ValueError("corpus_sq must be [N] on the corpus's device")
    return k_eff


def row_sq(x: torch.Tensor) -> torch.Tensor:
    """fp32 norms² of the rows of ``x`` [R, d] in the kernels' order:
    column by column from 0, each product and each sum rounded to fp32
    (the kernels use ``__fmul_rn`` / ``__fadd_rn``, so no fused
    multiply-add), so a kernel and its plain version agree bit for bit."""
    x = x.float()
    s = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for j in range(x.shape[1]):
        s = s + x[:, j] * x[:, j]
    return s


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
        q_sq = row_sq(q)[:, None]
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
    lib.lr_fold_mma_smem.restype = ctypes.c_size_t
    lib.lr_fold_mma_smem.argtypes = [i, i, i]
    lib.lr_fold_mma_occupancy.restype = i
    lib.lr_fold_mma_occupancy.argtypes = [i, i, i]
    lib.lr_fold_mma.restype = i
    lib.lr_fold_mma.argtypes = [p, p, p] + [i] * 9 + [p, p, p, p]
    lib.lr_exact_mma_queries.restype = i
    lib.lr_exact_mma_queries.argtypes = [i]
    lib.lr_exact_mma_smem.restype = ctypes.c_size_t
    lib.lr_exact_mma_smem.argtypes = [i, i, i]
    lib.lr_exact_mma_occupancy.restype = i
    lib.lr_exact_mma_occupancy.argtypes = [i, i, i]
    lib.lr_exact_mma.restype = i
    lib.lr_exact_mma.argtypes = [p, p, p] + [i] * 8 + [p, p, p, p]
    lib.lr_exact_select_smem.restype = ctypes.c_size_t
    lib.lr_exact_select_smem.argtypes = [i, i]
    lib.lr_exact_select_scratch.restype = ctypes.c_size_t
    lib.lr_exact_select_scratch.argtypes = [i, i, i]
    lib.lr_exact_select_occupancy.restype = i
    lib.lr_exact_select_occupancy.argtypes = [i, i]
    lib.lr_exact_select.restype = i
    lib.lr_exact_select.argtypes = [p, p, p] + [i] * 9 + [p, i] + [p] * 4
    lib.lr_error_string.restype = ctypes.c_char_p
    lib.lr_error_string.argtypes = [i]
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.lr_error_string(code).decode() if code > 0 else "bad tile"
        raise RuntimeError(f"{what} launch failed: {msg} (code {code})")


def _require_contiguous(queries, corpus) -> None:
    for name, t in (("queries", queries), ("corpus", corpus)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _vec(corpus, d: int, op: int) -> bool:
    """Whether the corpus stages may load by 16-byte ``cp.async``: whole
    chunks (8 bf16 or 4 fp32 values) a row and an aligned base. The binary
    stages move 4-byte words."""
    per_chunk = {_OP_BF16: 8, _OP_F32: 4}.get(op)
    return (per_chunk is not None and d % per_chunk == 0
            and corpus.data_ptr() % 16 == 0)


@functools.cache
def _slots(index: int, kernel: str, d: int, k: int, op: int) -> int:
    """Resident blocks of ``kernel`` (``fold_mma``, ``exact_mma`` or
    ``exact_select``, whose shared memory does not depend on k) for operand
    kind ``op`` the card holds at (d, k)."""
    lib = _library()
    args = (d, op) if kernel == "exact_select" else (d, k, op)
    with torch.cuda.device(index):
        per_sm = getattr(lib, f"lr_{kernel}_occupancy")(*args)
    if per_sm < 0:
        _check(lib, -per_sm, f"{kernel} occupancy")
    if per_sm == 0:
        raise ValueError(
            f"d={d}, k={k} needs more shared memory than one block has "
            f"({getattr(lib, f'lr_{kernel}_smem')(*args)} bytes)"
        )
    return per_sm * _sm_count(index)


def _fold_mma(queries, corpus, csq, *, d, k_eff, block_n, euclid, op):
    """The fold on the tensor cores (``csrc/fold_mma.cuh``) over bf16 or
    fp32 stores, or packed sign words (``op``): the corpus in slabs of
    whole tiles, as many as fill the card's resident block slots for the
    query tiles at hand; the kernels write the fp32 scores and int32 ids."""
    _require_contiguous(queries, corpus)
    nq = queries.shape[0]
    n = corpus.shape[0]
    dev = queries.device
    lib = _library()
    slots = _slots(dev.index, "fold_mma", d, k_eff, op)
    n_tiles = -(-n // block_n)
    want = min(n_tiles, max(1, slots // -(-nq // _FM_TQ)))
    slab_rows = -(-n_tiles // want) * block_n
    n_slabs = -(-n // slab_rows)
    scores = torch.empty((nq, k_eff), dtype=torch.float32, device=dev)
    ids = torch.empty((nq, k_eff), dtype=torch.int32, device=dev)
    part = (torch.empty((n_slabs, nq, k_eff), dtype=torch.int64, device=dev)
            if n_slabs > 1 else None)
    with torch.cuda.device(dev):
        code = lib.lr_fold_mma(
            queries.data_ptr(), corpus.data_ptr(),
            csq.data_ptr() if csq is not None else None,
            nq, n, d, k_eff, int(euclid), block_n, slab_rows,
            int(_vec(corpus, d, op)), op,
            part.data_ptr() if part is not None else None,
            scores.data_ptr(), ids.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check(lib, code, f"fold_mma_kernel{_OP_TAG[op]}")
    global last_kernel
    last_kernel = f"fold_mma_kernel{_OP_TAG[op]}" + (
        "+fold_merge_kernel" if n_slabs > 1 else "")
    return scores, ids


def _exact_slab_rows(n: int, q_tiles: int, slots: int) -> int:
    """Rows of a corpus slab of the exact searches: whole 128-row
    sub-tiles, as many slabs as fill the card's resident block slots for
    the query tiles at hand while each keeps ``_EM_MIN_SLAB_SUBTILES``."""
    n_sub = -(-n // _LANES)
    want = max(1, min(n_sub // _EM_MIN_SLAB_SUBTILES, slots // q_tiles))
    return -(-n_sub // want) * _LANES


def _exact_mma(queries, corpus, csq, *, d, k_eff, euclid, op):
    """The exact search over bf16 or fp32 stores, or the exact sign-dot
    search over packed sign words (``op``), on the tensor cores
    (``csrc/exact_mma.cuh``), k <= 2048, the corpus in slabs
    (``_exact_slab_rows``); the kernels write the fp32 scores and int32
    ids."""
    _require_contiguous(queries, corpus)
    nq = queries.shape[0]
    n = corpus.shape[0]
    dev = queries.device
    lib = _library()
    slab_rows = _exact_slab_rows(
        n, -(-nq // lib.lr_exact_mma_queries(k_eff)),
        _slots(dev.index, "exact_mma", d, k_eff, op))
    n_slabs = -(-n // slab_rows)
    scores = torch.empty((nq, k_eff), dtype=torch.float32, device=dev)
    ids = torch.empty((nq, k_eff), dtype=torch.int32, device=dev)
    part = (torch.empty((n_slabs, nq, k_eff), dtype=torch.int64, device=dev)
            if n_slabs > 1 else None)
    with torch.cuda.device(dev):
        code = lib.lr_exact_mma(
            queries.data_ptr(), corpus.data_ptr(),
            csq.data_ptr() if csq is not None else None,
            nq, n, d, k_eff, int(euclid), slab_rows,
            int(_vec(corpus, d, op)), op,
            part.data_ptr() if part is not None else None,
            scores.data_ptr(), ids.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check(lib, code, f"exact_mma_kernel{_OP_TAG[op]}")
    global last_kernel
    last_kernel = f"exact_mma_kernel{_OP_TAG[op]}" + (
        "+exact_merge_kernel" if n_slabs > 1 else "")
    return scores, ids


def _blocked_topk(queries, corpus, k_eff, metric):
    """``approx_fused_topk``'s route past ``EXACT_MAX_K``: ``exact_topk``
    (one ``torch.matmul`` and ``torch.topk`` a block, merged with the
    running list), fp32 scores of the stored values. Counts ``blocked`` on
    the card."""
    from .topk import exact_topk

    s, i = exact_topk(queries, corpus, k=k_eff, metric=metric)
    if queries.device.type == "cuda":
        launches["blocked"] += 1
    return s, i.to(torch.int32)


def _select_plan(nq: int, n: int, k: int) -> tuple[str, int, int, int]:
    """(route, sample stride s, sample rank m, capacity C) of the exact
    search past ``EXACT_MAX_K`` at Q=nq, N=n, k, from the shapes alone
    (``csrc/exact_select.cuh`` states the arithmetic). C = 2 es_width(k)
    keys a query. ``"radix"`` (s = m = C = 0) where C passes the 16384
    keys a sort block holds (k > 8192) or Q C 8 bytes pass 1 GiB;
    ``"all"`` (s = m = 0) where N <= C: the buffer takes every row;
    else ``"sampled"``: the threshold is the m-th best score of every s-th
    row, with T = (9k + 7C) / 16 the count aimed at, s = ceil(T / 256),
    m = ceil(T / s)."""
    cap = 2 * (1 << (k - 1).bit_length())
    if cap > _ES_SORT_SMEM or nq * cap * 8 > _ES_BUFFER_BYTES:
        return "radix", 0, 0, 0
    if n <= cap:
        return "all", 0, 0, cap
    target = (9 * k + 7 * cap) // 16
    stride = -(-target // _ES_SAMPLE_RANK)
    return "sampled", stride, -(-target // stride), cap


def select_fallbacks() -> int | None:
    """Queries of the latest exact search past ``EXACT_MAX_K`` on the card
    that fell back from its buffer to the radix passes (None on the radix
    route). Reads a device counter, so it waits for that search."""
    if _select_fell is None:
        return None
    return int(_select_fell.item())


def _exact_select(queries, corpus, csq, *, d, k_eff, euclid, op,
                  route="auto"):
    """The exact search at k past ``EXACT_MAX_K`` over bf16 or fp32 stores
    (``csrc/exact_select.cuh``), the corpus in slabs (``_exact_slab_rows``);
    the kernels write the fp32 scores and int32 ids. ``_select_plan``
    picks the route from the shapes: on ``"sampled"`` the exact kernel
    (``_exact_mma``) takes the m best scores of a contiguous copy of every
    s-th row, and the m-th places each query's threshold; one pass on the
    tensor cores keeps the keys at or above it in a buffer of C keys and
    counts them; a query whose count is not in [k, C] (a sample that
    misplaced its threshold: storage-ordered rows, ties at it) falls back
    to the radix select of its k-th key (histogram passes, a collect) on
    the card, without the host waiting; a per-query sort writes the best
    k. ``"all"`` keeps every row (N <= C); ``"radix"`` runs the radix
    select for every query (k > 8192, or buffers past 1 GiB). The private
    ``route="radix"`` forces it, so that checks can hold the routes to
    each other bit for bit."""
    _require_contiguous(queries, corpus)
    nq = queries.shape[0]
    n = corpus.shape[0]
    dev = queries.device
    lib = _library()
    name, stride, rank, cap = (_select_plan(nq, n, k_eff) if route == "auto"
                               else ("radix", 0, 0, 0))
    thr = None
    if name == "sampled":  # the sample's m best scores, best first
        thr = _exact_mma(
            queries, corpus[::stride].contiguous(),
            csq[::stride].contiguous() if csq is not None else None,
            d=d, k_eff=rank, euclid=euclid, op=op)[0]
    slab_rows = _exact_slab_rows(
        n, -(-nq // _ES_TQ), _slots(dev.index, "exact_select", d, k_eff, op))
    scratch = torch.empty(lib.lr_exact_select_scratch(nq, k_eff, cap),
                          dtype=torch.uint8, device=dev)
    scores = torch.empty((nq, k_eff), dtype=torch.float32, device=dev)
    ids = torch.empty((nq, k_eff), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = lib.lr_exact_select(
            queries.data_ptr(), corpus.data_ptr(),
            csq.data_ptr() if csq is not None else None,
            nq, n, d, k_eff, int(euclid), slab_rows,
            int(_vec(corpus, d, op)), op, cap,
            thr.data_ptr() if thr is not None else None, rank,
            scratch.data_ptr(), scores.data_ptr(), ids.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check(lib, code, f"exact_select_kernel{_OP_TAG[op]}")
    global last_kernel, last_select, _select_fell
    last_kernel = f"exact_select_kernel{_OP_TAG[op]}" + (
        f"+exact_mma_kernel{_OP_TAG[op]}" if thr is not None else "")
    last_select = {"route": name, "stride": stride, "rank": rank,
                   "capacity": cap}
    _select_fell = scratch[:4].view(torch.int32) if cap else None
    return scores, ids


def _fused_topk_raw_cuda(queries, corpus, corpus_sq, k_eff, euclid, mode,
                         block_n, route="auto"):
    """The kernels' side of ``fused_topk_raw``; ``route`` is
    ``_exact_select``'s private switch, for the checks."""
    d = queries.shape[1]
    csq = _corpus_sq(corpus, corpus_sq).contiguous() if euclid else None
    op = _OP_BF16 if corpus.dtype == torch.bfloat16 else _OP_F32
    if mode == "fold":
        out = _fold_mma(queries, corpus, csq, d=d, k_eff=k_eff,
                        block_n=block_n, euclid=euclid, op=op)
    elif k_eff <= EXACT_MAX_K:
        out = _exact_mma(queries, corpus, csq, d=d, k_eff=k_eff,
                         euclid=euclid, op=op)
    else:
        out = _exact_select(queries, corpus, csq, d=d, k_eff=k_eff,
                            euclid=euclid, op=op, route=route)
    launches[mode] += 1
    return out


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
    scores are exact. k is clipped to N; fold takes k <= 128, exact mode
    any k (on a CUDA tensor the exact kernel's lists up to
    ``EXACT_MAX_K``, the radix select past it)."""
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
    exactly; k above the fold's 128 takes the exact kernel, and above
    ``EXACT_MAX_K`` the blocked route. Returned scores are exact fp32
    scores of the selected rows."""
    k_eff = min(k, corpus.shape[0])
    if k_eff > EXACT_MAX_K:
        return _blocked_topk(queries, corpus, k_eff, metric)
    if k_eff > FOLD_MAX_K:
        return fused_topk(queries, corpus, k=k, metric=metric, mode="exact")
    block_n, cand = fold_plan(corpus.shape[0], k_eff, recall_target)
    _, idx = fused_topk_raw(queries, corpus, k=cand, metric=metric,
                            mode="fold", block_n=block_n)
    scores, idx = rescore_candidates(queries, corpus, idx, metric)
    return scores[:, :k_eff], idx[:, :k_eff]


# ---------------------------------------------------------------- binary


def _validate_binary(queries, packed, d, k, block_n=_LANES,
                     max_k=FOLD_MAX_K):
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
    if max_k is not None and k_eff > max_k:
        raise ValueError(f"the binary {'fold' if max_k == FOLD_MAX_K else 'exact'}"
                         f" kernel takes k <= {max_k} (got {k_eff})")
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

    On a CUDA tensor this launches the binary fold of
    ``csrc/fold_mma.cuh`` (each stage of sign words unpacks to +-1 bf16 in
    shared memory for the tensor cores, so neither the [Q, N] scores nor
    an unpacked corpus ever exists in device memory) or raises; on a CPU
    tensor it runs ``binary_fused_topk_raw_reference``."""
    k_eff = _validate_binary(queries, packed, d, k, block_n)
    if queries.device.type == "cpu":
        return binary_fused_topk_raw_reference(queries, packed, d=d, k=k,
                                               block_n=block_n)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    q = queries.to(torch.bfloat16).contiguous()
    out = _fold_mma(q, packed, None, d=d, k_eff=k_eff, block_n=block_n,
                    euclid=False, op=_OP_BIN)
    launches["binary_fold"] += 1
    return out


def binary_exact_topk_raw(
    queries: torch.Tensor, packed: torch.Tensor, *, d: int, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact packed-binary top-k: (sign-dot scores [Q, k] f32, ids [Q, k]
    i32) against the bf16-rounded queries, best first, ties to the lower
    row. k clips to N.

    On a CUDA tensor this launches the exact binary kernel of
    ``csrc/exact_mma.cuh`` (``exact_mma_kernel<KP, true>``, the slab merge
    after it, k <= ``EXACT_MAX_K``) or raises; on a CPU tensor it runs its
    plain version, ``ops.binary.binary_topk``, at any k."""
    from .binary import binary_topk

    if queries.device.type == "cpu":
        k_eff = _validate_binary(queries, packed, d, k, max_k=None)
        s, i = binary_topk(queries, packed, d, k_eff)
        return s, i.to(torch.int32)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    k_eff = _validate_binary(queries, packed, d, k, max_k=EXACT_MAX_K)
    q = queries.to(torch.bfloat16).contiguous()
    out = _exact_mma(q, packed, None, d=d, k_eff=k_eff, euclid=False,
                     op=_OP_BIN)
    launches["binary_exact"] += 1
    return out


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
    exact sign-dots, the best k kept. k above the fold's 128 candidates
    (the store asks for binary_oversample x k) takes the exact binary
    search, whose scores are already exact, and above ``EXACT_MAX_K`` the
    blocked route: ``binary_topk`` itself, counted as ``binary_blocked`` on
    the card."""
    from .binary import binary_topk

    n = packed.shape[0]
    k_eff = min(k, n)
    if k_eff > EXACT_MAX_K:
        s, i = binary_topk(queries, packed, d, k_eff)
        if queries.device.type == "cuda":
            launches["binary_blocked"] += 1
        return s, i.to(torch.int32)
    if k_eff > FOLD_MAX_K:
        return binary_exact_topk_raw(queries, packed, d=d, k=k_eff)
    block_n, cand = fold_plan(n, k_eff, recall_target)
    _, idx = binary_fused_topk_raw(queries, packed, d=d, k=cand,
                                   block_n=block_n)
    scores, idx = rescore_binary_candidates(queries, packed, idx, d)
    return scores[:, :k_eff], idx[:, :k_eff]
