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
* ``sq8_fused_topk_raw`` / ``sq4_fused_topk_raw`` run the fold and exact
  kernels over the int8 store's codes and the int4 store's packed nibbles
  against int8 query codes, scoring ``float32(int32 dot) * factor`` as the
  JAX package's ``sq8_topk`` / ``sq4_topk`` do (XLA there, not Pallas), and
  ``approx_sq8_fused_topk`` / ``approx_sq4_fused_topk`` are those stores'
  searches on the card: the queries quantized with one SQ8 scale over the
  batch, the fold at ``fold_plan``'s width and candidates, the candidates
  rescored exactly in int32 and ranked with ties to the lower row (as
  ``lax.top_k`` ranks them), the exact kernel above 128 (up to
  ``EXACT_I8_MAX_K``: ``exact_i8_wgmma_kernel``, the int4 store's through
  ``lr_exact_i4``; past it to ``EXACT_MAX_K``: ``exact_i8_select_kernel``,
  a sampled threshold, one buffer pass and a sort, ``_exact_i8_select``)
  and a blocked plain search past ``EXACT_MAX_K``.
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

Filtered search. Every function above except the exact select past
``EXACT_MAX_K`` takes ``mask``: the allowed rows' packed bits, int32 words
[ceil(N/32)] (bit ``r & 31`` of word ``r >> 5`` is row r:
``ops.topk.pack_row_mask``, or the dense retriever's cached filter). The
fold and exact kernels read it in their epilogue (``fold_mma_kernel<E, OP,
true>``, ``exact_mma_kernel<KP, OP, true>``) and drop a masked-out row
before it can enter a list; the plain versions unpack it
(``ops.topk.unpack_row_mask``) and treat a masked-out row as the kernels
treat a row past N. A slot that no allowed row fills comes back as
(``NEG_INF``, -1) from the kernels and the plain versions alike, and the
rescores keep it so, never gathering row -1 as the last row. The exact
select past 2048 takes no mask (the JAX package's Pallas backends refuse
filters); the approximate routes there take the blocked search, which
masks.

On a CUDA tensor the raw functions launch the kernels of
``csrc/fused_topk.cu`` (built into two libraries, ``LIBRARIES``: without
the row mask, and the row-mask instances) or raise; on a CPU tensor they
run their plain versions, which repeat the JAX algorithm step by step,
fold included.
Every store runs tensor-core kernels that write the scores and ids
themselves: the folds in ``csrc/fold_mma.cuh``, the exact searches in
``csrc/exact_mma.cuh`` (batched list upkeep in both), each instantiated
for bf16, packed binary and fp32 operands, and the int8 and int4 stores'
kernels on Hopper's TMA and ``wgmma`` s8: the folds in
``csrc/fold_i8_wgmma.cuh`` (a TMA producer warp, ``wgmma`` s8 consumers,
the exact int-to-float conversion; for the int4 store the producer
warpgroup sign-extends the nibbles into the s8 stages), the exact search
up to k = 256 in ``csrc/exact_i8_wgmma.cuh`` (the same machinery,
``csrc/wgmma_i8.cuh``, with a skip test on the raw int32 dot and lists
kept by each warp) and past it in ``csrc/exact_i8_select.cuh`` (the same
machinery with no lists: a sampled threshold, one buffer pass, a sort);
the float stores' exact search past 2048 is ``csrc/exact_select.cuh``.
fp32 stores multiply in 3xTF32 (each operand split into rounded tf32 hi
and lo parts, three products a pair), within ~3 x 2^-22 of each exact
product, the size of fp32 sum-order differences. The kernel sources say
what bounds them on the H100 and what their designs do about that.

``launches`` counts kernel launches per kernel (``fold``, ``exact``,
``binary_fold``, ``binary_exact``, ``int8_fold``, ``int8_exact``,
``int4_fold``, ``int4_exact``, and ``ivf_scan``, the device IVF's scan in
``ops.ivf``; a call that launches several kernels, a
partial and a merge or the select's passes and sort, counts once) and the
blocked routes' calls on the card (``blocked``, ``binary_blocked``,
``int8_blocked``, ``int4_blocked``); ``masked`` counts, beside them, the
kernel launches that read a row mask; plain-version calls and the blocked
routes on the CPU do not count.
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

from .quantization import (
    quantized_scores,
    quantized_topk,
    score_factor,
    sq4_unpack,
    sq8_queries,
)
from .topk import (
    NEG_INF,
    as_bool_mask,
    decode_keys,
    order_keys,
    pack_row_mask,
)

_MIN_I32 = -(2**31) + 1
_IDX_BITS = 13  # tile-local column bits => block_n <= 8192
_IDX_MASK = (1 << _IDX_BITS) - 1
_LANES = 128
FOLD_MAX_K = _LANES
EXACT_MAX_K = 2048  # the exact kernels' lists; the routes block past it
# the int8 and int4 exact search's lists on the SM (exact_i8_wgmma_kernel);
# past it the stores' exact search is exact_i8_select_kernel's
EXACT_I8_MAX_K = 256
FOLD_OVERSAMPLE = 4  # candidates per wanted row on the approximate route

# operand kinds of the tensor-core kernels (OP_* in csrc/fused_topk.cu) and
# the suffix each gives a kernel's name in ``last_kernel``
_OP_BF16, _OP_BIN, _OP_F32, _OP_I8, _OP_I4 = 0, 1, 2, 3, 4
_OP_TAG = {_OP_BF16: "", _OP_BIN: "<bin>", _OP_F32: "<f32>", _OP_I8: "<i8>",
           _OP_I4: "<i4>"}
_OP_STORE = {_OP_I8: "int8", _OP_I4: "int4"}  # the launch counters' prefix

_FM_TQ = 64  # queries per block of the fold kernel (FM_TQ)
_FW_TQ = 64  # queries per block of the int8 fold and exact search (FW_TQ)
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
# the int stores' exact search past EXACT_I8_MAX_K (exact_i8_select.cuh):
# buffers of 8192 keys a query at every k up to EXACT_MAX_K, so that the
# sample stays 1/15-1/19 of the rows (quantized_select_plan)
_EI_CAPACITY = 8192
_EMPTY64 = -(2**63)  # an empty key (EMPTY64)

launches = {"fold": 0, "exact": 0, "binary_fold": 0, "binary_exact": 0,
            "int8_fold": 0, "int8_exact": 0, "int4_fold": 0, "int4_exact": 0,
            "blocked": 0, "binary_blocked": 0, "int8_blocked": 0,
            "int4_blocked": 0, "ivf_scan": 0, "masked": 0}
last_kernel: str | None = None
# the latest exact select's plan (float past EXACT_MAX_K, int8 / int4 past
# EXACT_I8_MAX_K): route, sample stride and rank, capacity
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


def _validate_mask(mask, n: int, device) -> None:
    """A row mask is int32 words [ceil(n/32)] on the corpus's device."""
    if mask is None:
        return
    if (mask.dtype != torch.int32 or mask.ndim != 1
            or mask.numel() != -(-n // 32) or not mask.is_contiguous()):
        raise ValueError(
            f"mask must be contiguous int32 words [{-(-n // 32)}] (the "
            f"packed bits of the N={n} rows), got {mask.dtype} "
            f"{tuple(mask.shape)}")
    if mask.device != device:
        raise ValueError("mask must be on the corpus's device")


def _sentinel(scores: torch.Tensor, ids: torch.Tensor):
    """Slots without a candidate (score at NEG_INF: a filter allowed fewer
    rows than k) carry id -1, as the kernels write them."""
    return scores, torch.where(scores > NEG_INF * 0.5, ids,
                               torch.full_like(ids, -1))


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


def _plain_topk(score_tile, nq, n, k_eff, mode, block_n, dev, mask=None):
    """The JAX kernels' tile loop in PyTorch: ``score_tile(base, end)``
    gives the [Q, block_n] fp32 scores of rows [base, base + block_n)
    (rows from ``end`` on are padding and never win). A stable descending
    sort stands for the TPU's max-extraction passes (both keep the first
    occurrence of a tie). ``mask`` (bool [n]) drops a row as a padding row
    is dropped; a slot left without a candidate is (NEG_INF, -1)."""
    run_v = torch.full((nq, k_eff), _MIN_I32, dtype=torch.int32, device=dev)
    run_i = torch.zeros((nq, k_eff), dtype=torch.int32, device=dev)
    local = torch.arange(block_n, dtype=torch.int32, device=dev)
    if mask is not None:  # padded to whole tiles with dropped rows
        mask = torch.nn.functional.pad(
            mask, (0, -(-n // block_n) * block_n - n))
    for base in range(0, n, block_n):
        s = score_tile(base, min(base + block_n, n))
        valid = (local + base) < n
        if mask is not None:
            valid = valid & mask[base : base + block_n]
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
    empty = run_v == _MIN_I32
    return (torch.where(empty, NEG_INF, _unmonotone_f32(run_v)),
            torch.where(empty, -1, run_i))


def fused_topk_raw_reference(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    corpus_sq: torch.Tensor | None = None,
    *,
    k: int,
    metric: str = "cosine",
    mode: str = "fold",
    block_n: int = 4096,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernels: the JAX algorithm tile by
    tile, on any device."""
    k_eff = _validate(queries, corpus, corpus_sq, k, mode, block_n)
    _validate_mask(mask, corpus.shape[0], corpus.device)
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

    return _plain_topk(score_tile, nq, n, k_eff, mode, block_n, dev,
                       as_bool_mask(mask, n))


# the kernels' two libraries, one source: without the row mask (and with the
# exact select), and the row-mask instances of the fold and exact kernels
LIBRARIES = (("fused_topk", ()), ("fused_topk", ("LR_MASKED=1",)))


@functools.cache
def _libraries() -> tuple:
    """Both kernel libraries, built at once at the first launch, with
    their C signatures declared."""
    from .cuda_build import load_libraries

    libs = load_libraries(LIBRARIES)
    for lib, (_, defines) in zip(libs, LIBRARIES):
        _declare(lib, select=not defines)
    return tuple(libs)


def _library(masked: bool = False) -> ctypes.CDLL:
    """The library of the row-mask instances if ``masked``, else the
    other."""
    return _libraries()[int(masked)]


def _declare(lib, select: bool) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lr_fold_mma_smem.restype = ctypes.c_size_t
    lib.lr_fold_mma_smem.argtypes = [i, i, i]
    lib.lr_fold_mma_occupancy.restype = i
    lib.lr_fold_mma_occupancy.argtypes = [i, i, i]
    lib.lr_fold_mma.restype = i
    lib.lr_fold_mma.argtypes = [p, p, p] + [i] * 9 + [p] * 5
    lib.lr_fold_i8_smem.restype = ctypes.c_size_t
    lib.lr_fold_i8_smem.argtypes = [i, i, i]
    lib.lr_fold_i8_occupancy.restype = i
    lib.lr_fold_i8_occupancy.argtypes = [i, i, i]
    for fn in (lib.lr_fold_i8, lib.lr_fold_i4):
        fn.restype = i
        fn.argtypes = [p, p, p] + [i] * 6 + [p] * 5
    lib.lr_exact_i8_smem.restype = ctypes.c_size_t
    lib.lr_exact_i8_smem.argtypes = [i, i, i]
    lib.lr_exact_i8_occupancy.restype = i
    lib.lr_exact_i8_occupancy.argtypes = [i, i, i]
    for fn in (lib.lr_exact_i8, lib.lr_exact_i4):
        fn.restype = i
        fn.argtypes = [p, p, p] + [i] * 5 + [p] * 5
    lib.lr_exact_mma_queries.restype = i
    lib.lr_exact_mma_queries.argtypes = [i]
    lib.lr_exact_mma_smem.restype = ctypes.c_size_t
    lib.lr_exact_mma_smem.argtypes = [i, i, i]
    lib.lr_exact_mma_occupancy.restype = i
    lib.lr_exact_mma_occupancy.argtypes = [i, i, i]
    lib.lr_exact_mma.restype = i
    lib.lr_exact_mma.argtypes = [p, p, p] + [i] * 8 + [p] * 5
    lib.lr_exact_i8_select_smem.restype = ctypes.c_size_t
    lib.lr_exact_i8_select_smem.argtypes = [i, i]
    lib.lr_exact_i8_select_occupancy.restype = i
    lib.lr_exact_i8_select_occupancy.argtypes = [i, i, i]
    lib.lr_exact_i8_select_scratch.restype = ctypes.c_size_t
    lib.lr_exact_i8_select_scratch.argtypes = [i, i, i]
    lib.lr_exact_i8_select.restype = i
    lib.lr_exact_i8_select.argtypes = [p, p, p] + [i] * 4 + [p, i, i] \
        + [p, i, p, i] + [p] * 4
    lib.lr_error_string.restype = ctypes.c_char_p
    lib.lr_error_string.argtypes = [i]
    if not select:  # the masked library has no float exact select
        return
    lib.lr_exact_select_smem.restype = ctypes.c_size_t
    lib.lr_exact_select_smem.argtypes = [i, i]
    lib.lr_exact_select_scratch.restype = ctypes.c_size_t
    lib.lr_exact_select_scratch.argtypes = [i, i, i]
    lib.lr_exact_select_occupancy.restype = i
    lib.lr_exact_select_occupancy.argtypes = [i, i]
    lib.lr_exact_select.restype = i
    lib.lr_exact_select.argtypes = [p, p, p] + [i] * 9 + [p, i] + [p] * 4


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
    16-byte chunks a row (8 bf16, 4 fp32 or 16 int8 values, 32 int4 codes)
    and an aligned base. The binary stages move 4-byte words."""
    row_bytes = {_OP_BF16: 2 * d, _OP_F32: 4 * d, _OP_I8: d,
                 _OP_I4: -(-d // 2)}.get(op)
    return (row_bytes is not None and row_bytes % 16 == 0
            and corpus.data_ptr() % 16 == 0)


@functools.cache
def _slots(index: int, kernel: str, d: int, k: int, op: int,
           masked: bool = False) -> int:
    """Resident blocks of ``kernel`` (``fold_mma``, ``fold_i8`` and
    ``exact_i8`` (int8 and int4), ``exact_mma``, ``exact_select`` or
    ``exact_i8_select`` (its buffer pass), the last two with shared memory
    that does not depend on k) for operand kind ``op`` the card holds at
    (d, k), the row-mask instance if ``masked``."""
    lib = _library(masked)
    args, smem_args = {"exact_select": ((d, op), (d, op)),
                       "exact_i8_select": ((d, op, 0), (d, 0))}.get(
        kernel, ((d, k, op), (d, k, op)))
    with torch.cuda.device(index):
        per_sm = getattr(lib, f"lr_{kernel}_occupancy")(*args)
    if per_sm < 0:
        _check(lib, -per_sm, f"{kernel} occupancy")
    if per_sm == 0:
        raise ValueError(
            f"d={d}, k={k} needs more shared memory than one block has "
            f"({getattr(lib, f'lr_{kernel}_smem')(*smem_args)} bytes)"
        )
    return per_sm * _sm_count(index)


def _launched(name: str, mask) -> str:
    """Count a launch that read the row mask; the C kernel's name as
    ``last_kernel`` gives it (``<mask>`` marks the row-mask instance)."""
    if mask is None:
        return name
    launches["masked"] += 1
    return name + "<mask>"


def fold_slab_plan(nq: int, n: int, block_n: int, slots: int,
                   q_tile: int) -> tuple[int, int]:
    """(slab_rows, n_slabs) of a fold launch: the corpus in slabs of whole
    ``block_n`` tiles, as many as fill ``slots`` resident blocks for the
    ceil(nq / q_tile) query tiles at hand, at least one and at most one a
    tile. Every slab but the last holds ``slab_rows`` rows."""
    n_tiles = -(-n // block_n)
    want = min(n_tiles, max(1, slots // -(-nq // q_tile)))
    slab_rows = -(-n_tiles // want) * block_n
    return slab_rows, -(-n // slab_rows)


def _slab_outputs(nq: int, k_eff: int, n_slabs: int, dev):
    """A slabbed search's fp32 scores and int32 ids [nq, k_eff], and past
    one slab the slabs' int64 lists [n_slabs, nq, k_eff] (else None)."""
    scores = torch.empty((nq, k_eff), dtype=torch.float32, device=dev)
    ids = torch.empty((nq, k_eff), dtype=torch.int32, device=dev)
    part = (torch.empty((n_slabs, nq, k_eff), dtype=torch.int64, device=dev)
            if n_slabs > 1 else None)
    return scores, ids, part


def _fold_mma(queries, corpus, csq, *, d, k_eff, block_n, euclid, op,
              mask=None):
    """The fold on the tensor cores (``csrc/fold_mma.cuh``) over bf16 or
    fp32 stores or packed sign words (``op``), with the row mask when
    ``mask`` is given: the corpus in ``fold_slab_plan``'s slabs; the
    kernels write the fp32 scores and int32 ids."""
    _require_contiguous(queries, corpus)
    nq = queries.shape[0]
    n = corpus.shape[0]
    dev = queries.device
    lib = _library(mask is not None)
    slots = _slots(dev.index, "fold_mma", d, k_eff, op, mask is not None)
    slab_rows, n_slabs = fold_slab_plan(nq, n, block_n, slots, _FM_TQ)
    scores, ids, part = _slab_outputs(nq, k_eff, n_slabs, dev)
    with torch.cuda.device(dev):
        code = lib.lr_fold_mma(
            queries.data_ptr(), corpus.data_ptr(),
            csq.data_ptr() if csq is not None else None,
            nq, n, d, k_eff, int(euclid), block_n, slab_rows,
            int(_vec(corpus, d, op)), op,
            mask.data_ptr() if mask is not None else None,
            part.data_ptr() if part is not None else None,
            scores.data_ptr(), ids.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check(lib, code, f"fold_mma_kernel{_OP_TAG[op]}")
    global last_kernel
    last_kernel = _launched(f"fold_mma_kernel{_OP_TAG[op]}", mask) + (
        "+fold_merge_kernel" if n_slabs > 1 else "")
    return scores, ids


def _fold_i8(q_codes, corpus, factor, *, d, k_eff, block_n, op=_OP_I8,
             mask=None):
    """The int8 and int4 stores' fold on Hopper
    (``csrc/fold_i8_wgmma.cuh``: a TMA producer warp and a wgmma consumer
    warpgroup; ``op`` = ``_OP_I4``: ``lr_fold_i4``, whose producer
    warpgroup sign-extends the packed nibbles into the s8 stages), with the
    row mask when ``mask`` is given: 64 queries a block, the corpus in
    ``fold_slab_plan``'s slabs; the kernels write the fp32 scores and int32
    ids. ``last_kernel`` names the int4 route
    ``fold_i8_wgmma_kernel<i4>``."""
    _require_contiguous(q_codes, corpus)
    nq = q_codes.shape[0]
    n = corpus.shape[0]
    dev = q_codes.device
    lib = _library(mask is not None)
    slots = _slots(dev.index, "fold_i8", d, k_eff, op, mask is not None)
    slab_rows, n_slabs = fold_slab_plan(nq, n, block_n, slots, _FW_TQ)
    scores, ids, part = _slab_outputs(nq, k_eff, n_slabs, dev)
    fold = lib.lr_fold_i8 if op == _OP_I8 else lib.lr_fold_i4
    name = "fold_i8_wgmma_kernel" + ("" if op == _OP_I8 else _OP_TAG[op])
    with torch.cuda.device(dev):
        code = fold(
            q_codes.data_ptr(), corpus.data_ptr(), factor.data_ptr(),
            nq, n, d, k_eff, block_n, slab_rows,
            mask.data_ptr() if mask is not None else None,
            part.data_ptr() if part is not None else None,
            scores.data_ptr(), ids.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check(lib, code, name)
    global last_kernel
    last_kernel = _launched(name, mask) + (
        "+fold_merge_kernel" if n_slabs > 1 else "")
    return scores, ids


def exact_i8_slab_plan(nq: int, n: int, slots: int) -> tuple[int, int]:
    """(slab_rows, n_slabs) of an int8 exact launch: the corpus in slabs
    of whole 128-row sub-tiles, as many as fill ``slots`` resident blocks
    for the ceil(nq / 64) query tiles at hand, at least one and at most one
    a sub-tile (``fold_slab_plan`` with 128-row tiles). Every slab but the
    last holds ``slab_rows`` rows."""
    return fold_slab_plan(nq, n, _LANES, slots, _FW_TQ)


def _exact_i8(q_codes, corpus, factor, *, d, k_eff, op=_OP_I8, mask=None):
    """The int8 and int4 stores' exact search on Hopper, k <=
    ``EXACT_I8_MAX_K`` (``csrc/exact_i8_wgmma.cuh``: a TMA producer warp, a
    wgmma consumer warpgroup, a skip test on the raw dot; ``op`` =
    ``_OP_I4``: ``lr_exact_i4``, whose producer warpgroup sign-extends the
    packed nibbles into the s8 stages), with the row mask when ``mask`` is
    given: 64 queries a block, the corpus in ``exact_i8_slab_plan``'s
    slabs; the kernels write the fp32 scores and int32 ids.
    ``last_kernel`` names the int4 route ``exact_i8_wgmma_kernel<i4>``."""
    _require_contiguous(q_codes, corpus)
    nq = q_codes.shape[0]
    n = corpus.shape[0]
    dev = q_codes.device
    lib = _library(mask is not None)
    slots = _slots(dev.index, "exact_i8", d, k_eff, op, mask is not None)
    slab_rows, n_slabs = exact_i8_slab_plan(nq, n, slots)
    scores, ids, part = _slab_outputs(nq, k_eff, n_slabs, dev)
    exact = lib.lr_exact_i8 if op == _OP_I8 else lib.lr_exact_i4
    name = "exact_i8_wgmma_kernel" + ("" if op == _OP_I8 else _OP_TAG[op])
    with torch.cuda.device(dev):
        code = exact(
            q_codes.data_ptr(), corpus.data_ptr(), factor.data_ptr(),
            nq, n, d, k_eff, slab_rows,
            mask.data_ptr() if mask is not None else None,
            part.data_ptr() if part is not None else None,
            scores.data_ptr(), ids.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check(lib, code, name)
    global last_kernel
    last_kernel = _launched(name, mask) + (
        "+exact_merge_kernel" if n_slabs > 1 else "")
    return scores, ids


def _exact_slab_rows(n: int, q_tiles: int, slots: int) -> int:
    """Rows of a corpus slab of the exact searches: whole 128-row
    sub-tiles, as many slabs as fill the card's resident block slots for
    the query tiles at hand while each keeps ``_EM_MIN_SLAB_SUBTILES``."""
    n_sub = -(-n // _LANES)
    want = max(1, min(n_sub // _EM_MIN_SLAB_SUBTILES, slots // q_tiles))
    return -(-n_sub // want) * _LANES


def _exact_mma(queries, corpus, csq, *, d, k_eff, euclid, op, mask=None):
    """The exact search over bf16 or fp32 stores, or the exact sign-dot
    search over packed sign words (``op``), on the tensor cores
    (``csrc/exact_mma.cuh``), with the row mask when ``mask`` is given,
    k <= 2048, the corpus in slabs (``_exact_slab_rows``); the kernels
    write the fp32 scores and int32 ids."""
    _require_contiguous(queries, corpus)
    nq = queries.shape[0]
    n = corpus.shape[0]
    dev = queries.device
    lib = _library(mask is not None)
    slab_rows = _exact_slab_rows(
        n, -(-nq // lib.lr_exact_mma_queries(k_eff)),
        _slots(dev.index, "exact_mma", d, k_eff, op, mask is not None))
    n_slabs = -(-n // slab_rows)
    scores, ids, part = _slab_outputs(nq, k_eff, n_slabs, dev)
    with torch.cuda.device(dev):
        code = lib.lr_exact_mma(
            queries.data_ptr(), corpus.data_ptr(),
            csq.data_ptr() if csq is not None else None,
            nq, n, d, k_eff, int(euclid), slab_rows,
            int(_vec(corpus, d, op)), op,
            mask.data_ptr() if mask is not None else None,
            part.data_ptr() if part is not None else None,
            scores.data_ptr(), ids.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check(lib, code, f"exact_mma_kernel{_OP_TAG[op]}")
    global last_kernel
    last_kernel = _launched(f"exact_mma_kernel{_OP_TAG[op]}", mask) + (
        "+exact_merge_kernel" if n_slabs > 1 else "")
    return scores, ids


def _blocked_topk(queries, corpus, k_eff, metric, mask=None):
    """``approx_fused_topk``'s route past ``EXACT_MAX_K``: ``exact_topk``
    (one ``torch.matmul`` and ``torch.topk`` a block, merged with the
    running list, masked rows at NEG_INF), fp32 scores of the stored
    values, on the float select (the JAX route is approximate, so no tie
    order to match). Counts ``blocked`` on the card."""
    from .topk import exact_topk

    s, i = exact_topk(queries, corpus, k=k_eff, metric=metric,
                      mask=as_bool_mask(mask, corpus.shape[0]),
                      lax_order=False)
    if queries.device.type == "cuda":
        launches["blocked"] += 1
    return _sentinel(s, i.to(torch.int32))


def _buffer_plan(nq: int, n: int, k: int,
                 cap: int) -> tuple[str, int, int, int]:
    """(route, sample stride s, sample rank m, capacity C) of an exact
    select with buffers of ``cap`` keys a query at Q=nq over n rows:
    ``"radix"`` (s = m = C = 0) where C passes the 16384 keys a sort block
    holds or Q C 8 bytes pass 1 GiB; ``"all"`` (s = m = 0) where N <= C:
    the buffer takes every row; else ``"sampled"``: the threshold is the
    m-th best score of every s-th row, with T = (9k + 7C) / 16 the count
    aimed at, s = ceil(T / 256), m = ceil(T / s)."""
    if cap > _ES_SORT_SMEM or nq * cap * 8 > _ES_BUFFER_BYTES:
        return "radix", 0, 0, 0
    if n <= cap:
        return "all", 0, 0, cap
    target = (9 * k + 7 * cap) // 16
    stride = -(-target // _ES_SAMPLE_RANK)
    return "sampled", stride, -(-target // stride), cap


def _select_plan(nq: int, n: int, k: int) -> tuple[str, int, int, int]:
    """The plan of the float stores' exact search past ``EXACT_MAX_K``
    (``csrc/exact_select.cuh`` states the arithmetic): ``_buffer_plan``
    with C = 2 es_width(k) keys a query, so k > 8192 takes the radix
    route."""
    return _buffer_plan(nq, n, k, 2 * (1 << (k - 1).bit_length()))


def select_fallbacks() -> int | None:
    """Queries of the latest exact select on the card (a float store's
    search past ``EXACT_MAX_K``, an int8 / int4 store's past
    ``EXACT_I8_MAX_K``) that fell back from its buffer to the radix passes
    (None on the radix route). Reads a device counter, so it waits for that
    search."""
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
                         block_n, route="auto", mask=None):
    """The kernels' side of ``fused_topk_raw``; ``route`` is
    ``_exact_select``'s private switch, for the checks."""
    d = queries.shape[1]
    csq = _corpus_sq(corpus, corpus_sq).contiguous() if euclid else None
    op = _OP_BF16 if corpus.dtype == torch.bfloat16 else _OP_F32
    if mode == "fold":
        out = _fold_mma(queries, corpus, csq, d=d, k_eff=k_eff,
                        block_n=block_n, euclid=euclid, op=op, mask=mask)
    elif k_eff <= EXACT_MAX_K:
        out = _exact_mma(queries, corpus, csq, d=d, k_eff=k_eff,
                         euclid=euclid, op=op, mask=mask)
    elif mask is not None:
        raise ValueError(
            f"the exact select past k = {EXACT_MAX_K} takes no row mask (a "
            "filtered search past it takes approx_fused_topk's blocked "
            "route)")
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
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused top-k search. Returns (scores [Q, k] f32, ids [Q, k] i32).

    Inputs must be prepared for ``metric`` (cosine: normalized; euclidean:
    raw, with optional ``corpus_sq`` row norms²; mahalanobis: whitened,
    scored as euclidean in the whitened space). ``mode='fold'`` scores are
    19-bit-quantized (``fused_topk`` rescores them); ``mode='exact'``
    scores are exact. k is clipped to N; fold takes k <= 128, exact mode
    any k (on a CUDA tensor the exact kernel's lists up to
    ``EXACT_MAX_K``, the radix select past it). ``mask`` (the allowed
    rows' int32 words, see the module's docstring) restricts the search;
    on a CUDA tensor exact mode takes it up to ``EXACT_MAX_K``."""
    k_eff = _validate(queries, corpus, corpus_sq, k, mode, block_n)
    _validate_mask(mask, corpus.shape[0], corpus.device)
    if queries.device.type == "cpu":
        return fused_topk_raw_reference(
            queries, corpus, corpus_sq, k=k, metric=metric, mode=mode,
            block_n=block_n, mask=mask,
        )
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    euclid = _metric_kind(metric) == "euclidean"
    return _fused_topk_raw_cuda(
        queries, corpus, corpus_sq, k_eff, euclid, mode, block_n, mask=mask
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
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``fused_topk_raw`` + an fp32 rescore of the winning rows.

    The [Q, k] candidate rows are gathered and rescored against the
    queries as given (a bf16 store's queries arrive bf16-rounded), so the
    returned scores are exact and the order within the candidate set is
    exact even in fold mode. The rescore is elementwise work on Q*k*d
    values, left to PyTorch as the JAX package left it to XLA."""
    _, idx = fused_topk_raw(
        queries, corpus, corpus_sq, k=k, metric=metric, mode=mode,
        block_n=block_n, mask=mask,
    )
    return rescore_candidates(queries, corpus, idx, metric)


def rescore_candidates(
    queries: torch.Tensor, corpus: torch.Tensor, idx: torch.Tensor,
    metric: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 scores of the candidate rows ``idx`` [Q, k], sorted best first
    (stable, so equal scores keep the search's order); an empty slot (id
    -1) stays (NEG_INF, -1), after every real row."""
    live = idx >= 0
    cand = corpus[idx.clamp_min(0).long()].float()  # [Q, k, D]
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
    scores = torch.where(live, scores, NEG_INF)
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
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The approximate route: fold candidates per ``fold_plan``, rescored
    exactly; k above the fold's 128 takes the exact kernel, and above
    ``EXACT_MAX_K`` the blocked route. Returned scores are exact fp32
    scores of the selected rows; ``mask`` restricts every route, and slots
    no allowed row fills are (NEG_INF, -1)."""
    k_eff = min(k, corpus.shape[0])
    if k_eff > EXACT_MAX_K:
        _validate_mask(mask, corpus.shape[0], corpus.device)
        return _blocked_topk(queries, corpus, k_eff, metric, mask)
    if k_eff > FOLD_MAX_K:
        return fused_topk(queries, corpus, k=k, metric=metric, mode="exact",
                          mask=mask)
    block_n, cand = fold_plan(corpus.shape[0], k_eff, recall_target)
    _, idx = fused_topk_raw(queries, corpus, k=cand, metric=metric,
                            mode="fold", block_n=block_n, mask=mask)
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
    block_n: int = 4096, mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the binary kernel, on any device:
    ``pallas_binary_topk``'s fold tile by tile, each tile unpacked to +-1
    and scored against the bf16-rounded queries in fp32."""
    from .binary import binary_unpack

    k_eff = _validate_binary(queries, packed, d, k, block_n)
    _validate_mask(mask, packed.shape[0], packed.device)
    dev = queries.device
    q = queries.to(torch.bfloat16).float()

    def score_tile(base, end):
        tile = torch.zeros((block_n, d), dtype=torch.float32, device=dev)
        tile[: end - base] = binary_unpack(packed[base:end], d).float()
        return q @ tile.T

    return _plain_topk(score_tile, queries.shape[0], packed.shape[0], k_eff,
                       "fold", block_n, dev, as_bool_mask(mask, packed.shape[0]))


def binary_fused_topk_raw(
    queries: torch.Tensor, packed: torch.Tensor, *, d: int, k: int,
    block_n: int = 4096, mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused packed-binary fold top-k. ``packed`` is the row-major store
    ``ops.binary.binary_quantize`` makes ([N, ceil(d/32)] int32 words).
    Returns (19-bit-quantized sign-dot scores [Q, k] f32, ids [Q, k] i32):
    the fold keys mapped back to fp32. k clips to N and must be <= 128.

    On a CUDA tensor this launches the binary fold of
    ``csrc/fold_mma.cuh`` (each stage of sign words unpacks to +-1 bf16 in
    shared memory for the tensor cores, so neither the [Q, N] scores nor
    an unpacked corpus ever exists in device memory) or raises; on a CPU
    tensor it runs ``binary_fused_topk_raw_reference``. ``mask`` restricts
    the search to the allowed rows (see the module's docstring)."""
    k_eff = _validate_binary(queries, packed, d, k, block_n)
    _validate_mask(mask, packed.shape[0], packed.device)
    if queries.device.type == "cpu":
        return binary_fused_topk_raw_reference(queries, packed, d=d, k=k,
                                               block_n=block_n, mask=mask)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    q = queries.to(torch.bfloat16).contiguous()
    out = _fold_mma(q, packed, None, d=d, k_eff=k_eff, block_n=block_n,
                    euclid=False, op=_OP_BIN, mask=mask)
    launches["binary_fold"] += 1
    return out


def binary_exact_topk_raw(
    queries: torch.Tensor, packed: torch.Tensor, *, d: int, k: int,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact packed-binary top-k: (sign-dot scores [Q, k] f32, ids [Q, k]
    i32) against the bf16-rounded queries, best first, ties to the lower
    row. k clips to N.

    On a CUDA tensor this launches the exact binary kernel of
    ``csrc/exact_mma.cuh`` (``exact_mma_kernel<KP, true>``, the slab merge
    after it, k <= ``EXACT_MAX_K``) or raises; on a CPU tensor it runs its
    plain version, ``ops.binary.binary_topk``, at any k. ``mask``
    restricts the search to the allowed rows; slots no allowed row fills
    are (NEG_INF, -1)."""
    from .binary import binary_topk

    _validate_mask(mask, packed.shape[0], packed.device)
    if queries.device.type == "cpu":
        k_eff = _validate_binary(queries, packed, d, k, max_k=None)
        s, i = binary_topk(queries, packed, d, k_eff,
                           mask=as_bool_mask(mask, packed.shape[0]))
        return _sentinel(s, i.to(torch.int32))
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    k_eff = _validate_binary(queries, packed, d, k, max_k=EXACT_MAX_K)
    q = queries.to(torch.bfloat16).contiguous()
    out = _exact_mma(q, packed, None, d=d, k_eff=k_eff, euclid=False,
                     op=_OP_BIN, mask=mask)
    launches["binary_exact"] += 1
    return out


def rescore_binary_candidates(
    queries: torch.Tensor, packed: torch.Tensor, idx: torch.Tensor, d: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact sign-dot scores of the candidate rows ``idx`` [Q, k] against
    the bf16-rounded queries (the estimator the search used), sorted best
    first (stable); an empty slot (id -1) stays (NEG_INF, -1)."""
    from .binary import binary_unpack

    nq, kk = idx.shape
    rows = binary_unpack(packed[idx.reshape(-1).clamp_min(0).long()],
                         d).float()
    qf = queries.to(torch.bfloat16).float()
    scores = torch.sum(qf[:, None, :] * rows.reshape(nq, kk, d), dim=2)
    scores = torch.where(idx >= 0, scores, NEG_INF)
    order = torch.sort(scores, dim=1, descending=True, stable=True)[1]
    return torch.gather(scores, 1, order), torch.gather(idx, 1, order)


def binary_fused_topk(
    queries: torch.Tensor, packed: torch.Tensor, *, d: int, k: int,
    block_n: int = 4096, mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``binary_fused_topk_raw`` + the exact sign-dot rescore of the k
    winners and a stable sort (``pallas_binary_topk``'s wrapper)."""
    _, idx = binary_fused_topk_raw(queries, packed, d=d, k=k,
                                   block_n=block_n, mask=mask)
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
    recall_target: float = 0.99, mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The binary store's stage 1 on the card (the part XLA's
    ``approx_max_k`` played on the TPU): the binary fold at the tile width
    and candidate count ``fold_plan`` sets, the candidates rescored to
    exact sign-dots, the best k kept. k above the fold's 128 candidates
    (the store asks for binary_oversample x k) takes the exact binary
    search, whose scores are already exact, and above ``EXACT_MAX_K`` the
    blocked route: ``binary_topk`` itself, counted as ``binary_blocked`` on
    the card. ``mask`` restricts every route; slots no allowed row fills
    are (NEG_INF, -1)."""
    from .binary import binary_topk

    n = packed.shape[0]
    k_eff = min(k, n)
    if k_eff > EXACT_MAX_K:
        _validate_mask(mask, n, packed.device)
        s, i = binary_topk(queries, packed, d, k_eff,
                           mask=as_bool_mask(mask, n))
        if queries.device.type == "cuda":
            launches["binary_blocked"] += 1
        return _sentinel(s, i.to(torch.int32))
    if k_eff > FOLD_MAX_K:
        return binary_exact_topk_raw(queries, packed, d=d, k=k_eff,
                                     mask=mask)
    block_n, cand = fold_plan(n, k_eff, recall_target)
    _, idx = binary_fused_topk_raw(queries, packed, d=d, k=cand,
                                   block_n=block_n, mask=mask)
    scores, idx = rescore_binary_candidates(queries, packed, idx, d)
    return scores[:, :k_eff], idx[:, :k_eff]


# ------------------------------------------------------------ int8 and int4


def _validate_quantized(q_codes, corpus, factor, d, k, op, block_n=_LANES,
                        max_k=FOLD_MAX_K):
    if block_n > (1 << _IDX_BITS) or block_n % _LANES:
        raise ValueError(
            f"block_n must be <= {1 << _IDX_BITS} and a multiple of {_LANES}"
        )
    if q_codes.ndim != 2 or corpus.ndim != 2:
        raise ValueError("query codes and corpus must be 2-D")
    if q_codes.dtype != torch.int8 or q_codes.shape[1] != d:
        raise ValueError(f"query codes must be int8 [Q, {d}] (got "
                         f"{q_codes.dtype} {tuple(q_codes.shape)})")
    want = ((torch.int8, d, "int8 codes") if op == _OP_I8
            else (torch.uint8, -(-d // 2), "uint8 packed nibbles"))
    if corpus.dtype != want[0] or corpus.shape[1] != want[1]:
        raise ValueError(f"corpus must be {want[2]} [N, {want[1]}] (got "
                         f"{corpus.dtype} {tuple(corpus.shape)})")
    if factor.dtype != torch.float32 or factor.numel() != 1:
        raise ValueError("factor must be one float32 value")
    if not (q_codes.device == corpus.device == factor.device):
        raise ValueError("query codes, corpus and factor must be on one "
                         "device")
    n = corpus.shape[0]
    if n == 0:
        raise ValueError("empty corpus")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    k_eff = min(k, n)
    if max_k is not None and k_eff > max_k:
        raise ValueError(f"the {_OP_STORE[op]} "
                         f"{'fold' if max_k == FOLD_MAX_K else 'exact'} "
                         f"kernel takes k <= {max_k} (got {k_eff})")
    return k_eff


def _code_rows(corpus, d: int, op: int):
    """``rows_of(lo, hi)``: rows [lo, hi) of the store as int8 codes (the
    int4 store's nibbles unpacked)."""
    if op == _OP_I8:
        return lambda lo, hi: corpus[lo:hi]
    return lambda lo, hi: sq4_unpack(corpus[lo:hi], d)


def quantized_fused_topk_raw_reference(
    q_codes: torch.Tensor, corpus: torch.Tensor, factor: torch.Tensor, *,
    d: int, k: int, op: int, mode: str = "fold", block_n: int = 4096,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the int8 (``op`` = ``_OP_I8``) and int4
    (``_OP_I4``) kernels, on any device. ``mode="fold"``: the fold tile by
    tile (``_plain_topk``) over ``quantized_scores`` of each tile's codes,
    19-bit-quantized scores; ``mode="exact"``: ``quantized_topk``, the
    exact scores best first, ties to the lower row, at any k. Slots no
    allowed row fills are (NEG_INF, -1)."""
    if mode not in ("fold", "exact"):
        raise ValueError(f"mode must be 'fold' or 'exact', got {mode!r}")
    fold = mode == "fold"
    k_eff = _validate_quantized(q_codes, corpus, factor, d, k, op,
                                block_n if fold else _LANES,
                                FOLD_MAX_K if fold else None)
    n = corpus.shape[0]
    _validate_mask(mask, n, corpus.device)
    rows_of = _code_rows(corpus, d, op)
    if not fold:
        s, i = quantized_topk(q_codes, n, rows_of, factor, k_eff,
                              block_size=1 << 20, mask=mask)
        return _sentinel(s, i.to(torch.int32))
    dev = q_codes.device

    def score_tile(base, end):
        tile = torch.zeros((block_n, d), dtype=torch.int8, device=dev)
        tile[: end - base] = rows_of(base, end)
        return quantized_scores(q_codes, tile, factor)

    return _plain_topk(score_tile, q_codes.shape[0], n, k_eff, "fold",
                       block_n, dev, as_bool_mask(mask, n))


def quantized_select_plan(nq: int, n: int,
                          k: int) -> tuple[str, int, int, int]:
    """The plan of the int8 / int4 exact search past ``EXACT_I8_MAX_K``
    (``exact_i8_select_kernel``; ``csrc/exact_i8_select.cuh`` states the
    arithmetic) at Q=nq over the corpus's n rows (a filter does not change
    it: its allowed rows are counted on the card): ``_buffer_plan`` with C
    = 8192 keys a query at every k to ``EXACT_MAX_K``, so that the sample
    is 1/15-1/19 of the rows (s = 15-19 for k = 257-2048); the radix route
    only past 16384 queries."""
    return _buffer_plan(nq, n, k, _EI_CAPACITY)


def quantized_select_reference(
    q_codes: torch.Tensor, corpus: torch.Tensor, factor: torch.Tensor, *,
    d: int, k: int, op: int, mask: torch.Tensor | None = None,
    route: str = "auto", block_size: int = 1 << 20,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None, tuple]:
    """The plain model of ``exact_i8_select_kernel``'s plan, step by step,
    on any device: (scores [Q, k] f32, ids [Q, k] i32, the queries that
    fall back (bool [Q]; None on the radix route), the plan).
    ``quantized_select_plan`` picks the route from the shapes; on
    ``"sampled"`` each query's threshold is the m-th best score of the
    allowed rows among every s-th row (NEG_INF where fewer than m are
    allowed), a key with no row bits (every row tying it is taken); the
    buffer counts the allowed keys at or above it (every allowed key on
    ``"all"``); a
    query whose count is not in [min(k, allowed rows), C] falls back to the
    exact top k (the radix select's), any other takes the best k of its
    buffer, padded with (NEG_INF, -1). Equal to the plain exact search
    (``quantized_fused_topk_raw_reference``) bit for bit, whichever route
    a query takes."""
    k_eff = _validate_quantized(q_codes, corpus, factor, d, k, op,
                                max_k=None)
    n = corpus.shape[0]
    nq = q_codes.shape[0]
    _validate_mask(mask, n, corpus.device)
    dev = q_codes.device
    allowed = as_bool_mask(mask, n)
    n_allowed = n if allowed is None else int(allowed.sum())
    plan = (quantized_select_plan(nq, n, k_eff) if route == "auto"
            else ("radix", 0, 0, 0))
    name, stride, rank, cap = plan
    rows_of = _code_rows(corpus, d, op)
    pre = torch.full((nq,), _EMPTY64, dtype=torch.int64, device=dev)
    if name == "sampled":
        sample = corpus[::stride]
        thr = quantized_topk(
            q_codes, sample.shape[0], _code_rows(sample, d, op), factor,
            rank, block_size=block_size,
            mask=None if allowed is None else allowed[::stride])[0]
        pre = _monotone_i32(thr[:, rank - 1]).long() << 32
    count = torch.zeros(nq, dtype=torch.int64, device=dev)
    best = {"buffer": None, "exact": None}
    for base in range(0, n, block_size):
        end = min(base + block_size, n)
        sc = quantized_scores(q_codes, rows_of(base, end), factor)
        keys = order_keys(sc, torch.arange(base, end, device=dev)[None, :])
        live = ~torch.isnan(sc)
        if allowed is not None:
            live = live & allowed[None, base:end]
        buffered = live & (keys >= pre[:, None])
        count += buffered.sum(dim=1)
        for name_, keep in (("buffer", buffered), ("exact", live)):
            top = torch.topk(torch.where(keep, keys, _EMPTY64),
                             min(k_eff, end - base), dim=1)[0]
            if best[name_] is not None:
                top = torch.cat([best[name_], top], dim=1)
                top = torch.topk(top, min(k_eff, top.shape[1]), dim=1)[0]
            best[name_] = top
    fell = None
    out = best["exact"]
    if name != "radix":
        fell = (count < min(k_eff, n_allowed)) | (count > cap)
        out = torch.where(fell[:, None], best["exact"], best["buffer"])
    out = torch.nn.functional.pad(out, (0, k_eff - out.shape[1]),
                                  value=_EMPTY64)
    empty = out == _EMPTY64
    s, i = decode_keys(torch.where(empty, 0, out))
    return (torch.where(empty, NEG_INF, s),
            torch.where(empty, -1, i).to(torch.int32), fell, plan)


def _exact_i8_select(q_codes, corpus, factor, *, d, k_eff, op, mask=None,
                     route="auto"):
    """The int8 and int4 stores' exact search past ``EXACT_I8_MAX_K`` on
    Hopper (``csrc/exact_i8_select.cuh``), with the row mask when ``mask``
    is given: ``quantized_select_plan`` picks the route from the shapes;
    on ``"sampled"`` ``_exact_i8`` takes the m best scores of a contiguous
    copy of every s-th row (with a filter, of its allowed rows among them:
    the threshold is NEG_INF where fewer than m are), and the m-th places
    each query's threshold; one buffer pass on the TMA + wgmma machinery
    (64 queries a block, the corpus in ``exact_i8_slab_plan``'s slabs)
    keeps the keys at or above it in a buffer of C keys and counts them; a
    query whose count is not in [min(k, allowed rows), C] falls back to the
    radix select of its k-th key on the card (the allowed rows are counted
    there too: the host never waits); a sort writes the best k. ``"all"``
    keeps every allowed row; ``"radix"`` runs the radix select
    for every query. The private ``route="radix"`` forces it, so that
    checks can hold the routes to each other bit for bit.
    ``last_kernel`` names the int4 route ``exact_i8_select_kernel<i4>``;
    ``last_select`` and ``select_fallbacks()`` read as the float select's."""
    _require_contiguous(q_codes, corpus)
    nq = q_codes.shape[0]
    n = corpus.shape[0]
    dev = q_codes.device
    masked = mask is not None
    lib = _library(masked)
    allowed = as_bool_mask(mask, n)
    kmin = (None if allowed is None else  # min(k, allowed rows), on the card
            allowed.sum(dtype=torch.int32).clamp_(max=k_eff))
    name, stride, rank, cap = (
        quantized_select_plan(nq, n, k_eff) if route == "auto"
        else ("radix", 0, 0, 0))
    tag = "" if op == _OP_I8 else _OP_TAG[op]
    thr = None
    if name == "sampled":  # the sample's m best scores, best first
        thr = _exact_i8(
            q_codes, corpus[::stride].contiguous(), factor, d=d, k_eff=rank,
            op=op, mask=None if allowed is None else pack_row_mask(
                allowed[::stride].contiguous()))[0]
    slab_rows = exact_i8_slab_plan(
        nq, n, _slots(dev.index, "exact_i8_select", d, k_eff, op, masked))[0]
    scratch = torch.empty(lib.lr_exact_i8_select_scratch(nq, k_eff, cap),
                          dtype=torch.uint8, device=dev)
    scores = torch.empty((nq, k_eff), dtype=torch.float32, device=dev)
    ids = torch.empty((nq, k_eff), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = lib.lr_exact_i8_select(
            q_codes.data_ptr(), corpus.data_ptr(), factor.data_ptr(),
            nq, n, d, k_eff, kmin.data_ptr() if masked else None,
            slab_rows, cap,
            thr.data_ptr() if thr is not None else None, rank,
            mask.data_ptr() if masked else None, op,
            scratch.data_ptr(), scores.data_ptr(), ids.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check(lib, code, "exact_i8_select_kernel" + tag)
    global last_kernel, last_select, _select_fell
    last_kernel = _launched("exact_i8_select_kernel" + tag, mask) + (
        "+exact_i8_wgmma_kernel" + tag + ("<mask>" if masked else "")
        if thr is not None else "")
    last_select = {"route": name, "stride": stride, "rank": rank,
                   "capacity": cap}
    _select_fell = scratch[:4].view(torch.int32) if cap else None
    return scores, ids


def quantized_exact_kernel(op: int, k: int) -> str:
    """The C kernel of an int8 (``op`` = ``_OP_I8``) or int4 exact search
    at k <= ``EXACT_MAX_K`` on the card: up to ``EXACT_I8_MAX_K``
    ``exact_i8_wgmma_kernel`` (the int4 store's through ``lr_exact_i4``,
    named ``exact_i8_wgmma_kernel<i4>``), past it
    ``exact_i8_select_kernel`` / ``<i4>``."""
    if op not in _OP_STORE:
        raise ValueError(f"not an int8 or int4 operand kind: {op}")
    tag = "" if op == _OP_I8 else _OP_TAG[op]
    if k <= EXACT_I8_MAX_K:
        return "exact_i8_wgmma_kernel" + tag
    return "exact_i8_select_kernel" + tag


def _quantized_raw(q_codes, corpus, factor, *, d, k, op, mode, block_n,
                   mask):
    """The int8 / int4 kernels' entry: on a CPU tensor the plain version,
    on a CUDA tensor the fold kernel (k <= 128: ``_fold_i8``, either store)
    or the exact kernel (k <= ``EXACT_MAX_K``:
    ``quantized_exact_kernel``'s, ``_exact_i8`` up to ``EXACT_I8_MAX_K``,
    else ``_exact_i8_select``, either store), counted as ``int8_fold`` ...
    ``int4_exact``."""
    if mode not in ("fold", "exact"):
        raise ValueError(f"mode must be 'fold' or 'exact', got {mode!r}")
    if q_codes.device.type == "cpu":
        return quantized_fused_topk_raw_reference(
            q_codes, corpus, factor, d=d, k=k, op=op, mode=mode,
            block_n=block_n, mask=mask)
    if q_codes.device.type != "cuda":
        raise ValueError(f"unsupported device {q_codes.device}")
    fold = mode == "fold"
    k_eff = _validate_quantized(q_codes, corpus, factor, d, k, op,
                                block_n if fold else _LANES,
                                FOLD_MAX_K if fold else EXACT_MAX_K)
    _validate_mask(mask, corpus.shape[0], corpus.device)
    factor = factor.reshape(1).contiguous()
    if fold:
        out = _fold_i8(q_codes, corpus, factor, d=d, k_eff=k_eff,
                       block_n=block_n, op=op, mask=mask)
    elif k_eff <= EXACT_I8_MAX_K:
        out = _exact_i8(q_codes, corpus, factor, d=d, k_eff=k_eff, op=op,
                        mask=mask)
    else:
        out = _exact_i8_select(q_codes, corpus, factor, d=d, k_eff=k_eff,
                               op=op, mask=mask)
    launches[f"{_OP_STORE[op]}_{mode}"] += 1
    return out


def sq8_fused_topk_raw(
    q_codes: torch.Tensor, codes: torch.Tensor, factor: torch.Tensor, *,
    k: int, mode: str = "fold", block_n: int = 4096,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused int8 top-k: int8 query codes [Q, d] against the int8 store's
    codes [N, d], scores ``float32(int32 dot) * factor`` (``factor``: one
    fp32 value, ``float32(q_scale * corpus_scale)``). Returns (scores [Q, k]
    f32, ids [Q, k] i32); ``mode="fold"`` (k <= 128) scores are
    19-bit-quantized, ``mode="exact"`` scores exact, ties to the lower row.
    On a CUDA tensor this launches ``fold_i8_wgmma_kernel<E, M, W>``,
    ``exact_i8_wgmma_kernel<KP, M, W>`` (k <= ``EXACT_I8_MAX_K``) or
    ``exact_i8_select_kernel<H, M, W>`` (k <= ``EXACT_MAX_K``) or raises; on a
    CPU tensor it runs ``quantized_fused_topk_raw_reference``. ``mask``
    restricts the search (see the module's docstring)."""
    return _quantized_raw(q_codes, codes, factor, d=codes.shape[1], k=k,
                          op=_OP_I8, mode=mode, block_n=block_n, mask=mask)


def sq4_fused_topk_raw(
    q_codes: torch.Tensor, packed: torch.Tensor, factor: torch.Tensor, *,
    d: int, k: int, mode: str = "fold", block_n: int = 4096,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``sq8_fused_topk_raw`` over the int4 store's packed nibbles, uint8
    [N, ceil(d/2)] (``ops.quantization.sq4_quantize``), sign-extended to
    int8 codes inside the kernels: on a CUDA tensor the fold launches
    ``fold_i8_wgmma_kernel<E, M, W>`` through ``lr_fold_i4`` (its producer
    warpgroup unpacks the nibbles; ``last_kernel``
    ``fold_i8_wgmma_kernel<i4>``), the exact search up to
    ``EXACT_I8_MAX_K`` ``exact_i8_wgmma_kernel<KP, M, W>`` through
    ``lr_exact_i4`` (the same producer; ``last_kernel``
    ``exact_i8_wgmma_kernel<i4>``), past it ``exact_i8_select_kernel<H, M,
    W>`` with ``op`` OP_I4 (the same producer; ``last_kernel``
    ``exact_i8_select_kernel<i4>``)."""
    return _quantized_raw(q_codes, packed, factor, d=d, k=k, op=_OP_I4,
                          mode=mode, block_n=block_n, mask=mask)


def rescore_quantized_candidates(
    q_codes: torch.Tensor, rows: torch.Tensor, idx: torch.Tensor,
    factor: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact scores of the candidate rows ``idx`` [Q, K] whose int8 codes
    are ``rows`` [Q, K, d]: int32 dots (exact integers) times ``factor``,
    as the kernels and the JAX package score them, best first with ties to
    the lower row; an empty slot (id -1) stays (NEG_INF, -1), after every
    real row."""
    dots = torch.sum(q_codes.to(torch.int32)[:, None, :]
                     * rows.to(torch.int32), dim=2)
    scores = torch.where(idx >= 0, dots.float() * factor, NEG_INF)
    order = torch.sort(order_keys(scores, idx), dim=1, descending=True,
                       stable=True)[1]
    return torch.gather(scores, 1, order), torch.gather(idx, 1, order)


def _approx_quantized(q_codes, corpus, factor, *, d, k, recall_target, mask,
                      op, block_size):
    n = corpus.shape[0]
    k_eff = min(k, n)
    rows_of = _code_rows(corpus, d, op)
    if k_eff > EXACT_MAX_K:  # the blocked plain search, as for float stores
        _validate_mask(mask, n, corpus.device)
        s, i = quantized_topk(q_codes, n, rows_of, factor, k_eff,
                              block_size=block_size, mask=mask)
        if q_codes.device.type == "cuda":
            launches[f"{_OP_STORE[op]}_blocked"] += 1
        return _sentinel(s, i.to(torch.int32))
    if k_eff > FOLD_MAX_K:  # exact scores, ties to the lower row
        return _quantized_raw(q_codes, corpus, factor, d=d, k=k_eff, op=op,
                              mode="exact", block_n=_LANES, mask=mask)
    block_n, cand = fold_plan(n, k_eff, recall_target)
    _, idx = _quantized_raw(q_codes, corpus, factor, d=d, k=cand, op=op,
                            mode="fold", block_n=block_n, mask=mask)
    flat = idx.reshape(-1).clamp_min(0).long()
    rows = rows_of(0, n)[flat] if op == _OP_I8 else sq4_unpack(
        corpus[flat], d)
    scores, idx = rescore_quantized_candidates(
        q_codes, rows.reshape(*idx.shape, d), idx, factor)
    return scores[:, :k_eff], idx[:, :k_eff]


def approx_sq8_fused_topk(
    queries: torch.Tensor, codes: torch.Tensor, corpus_scale, *, k: int,
    recall_target: float = 0.99, mask: torch.Tensor | None = None,
    block_size: int = 1 << 20,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 store's search on the card (the part XLA's ``approx_max_k``
    played in ``sq8_topk`` on the TPU): the prepared queries quantized with
    one SQ8 scale over the batch (``sq8_quantize``, as the JAX function
    does, so a query's scores depend on its batch; ``sq8_queries``: a
    (codes, scale) pair passes as it is), the int8 fold at
    ``fold_plan``'s width and candidates from ``recall_target``, the
    candidates rescored exactly in int32 and ranked with ties to the lower
    row, the best k kept; above the fold's 128 the exact int8 kernel, and
    past ``EXACT_MAX_K`` the blocked plain search in ``block_size``-row
    blocks (``int8_blocked``). Every returned score is the JAX package's
    score of that row bit for bit. ``mask`` restricts every route; slots no
    allowed row fills are (NEG_INF, -1). On a CPU tensor each route runs
    its plain version."""
    q_codes, q_scale = sq8_queries(queries)
    return _approx_quantized(
        q_codes, codes, score_factor(q_scale, corpus_scale),
        d=codes.shape[1], k=k, recall_target=recall_target, mask=mask,
        op=_OP_I8, block_size=block_size)


def approx_sq4_fused_topk(
    queries: torch.Tensor, packed: torch.Tensor, corpus_scale, *, d: int,
    k: int, recall_target: float = 0.99, mask: torch.Tensor | None = None,
    block_size: int = 1 << 20,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The int4 store's stage 1 on the card: ``approx_sq8_fused_topk``'s
    routes over the packed nibbles (``sq4_topk``'s scores: the SQ8 query
    codes against the int4 codes, times ``q_scale * corpus_scale``), the
    fold's candidates unpacked and rescored exactly in int32
    (``int4_fold``, ``int4_exact``, ``int4_blocked``)."""
    q_codes, q_scale = sq8_queries(queries)
    return _approx_quantized(
        q_codes, packed, score_factor(q_scale, corpus_scale), d=d, k=k,
        recall_target=recall_target, mask=mask, op=_OP_I4,
        block_size=block_size)
