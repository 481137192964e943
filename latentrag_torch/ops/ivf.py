"""The device IVF-Flat tier: cluster-pruned top-k over an inverted file.

The port of the JAX package's ``ops/ivf.py``. An exhaustive search reads
the whole store for every batch, so a single query pays the sweep that
1024 queries share. The inverted file groups the rows by their nearest
k-means centroid into fixed-``cap`` blocks (a large list spans several
blocks; the last block of each list pads with id -1), and a query scans
only the ``nprobe`` blocks whose list centroids score best: its device
bytes drop from N rows to ``nprobe * cap`` rows.

* build: ``ivf_build`` (fp32, bf16 and int8 stores), ``ivf_build_binary``
  (packed sign words) and ``ivf_build_sq4`` (packed int4 nibbles): k-means
  (``ops.kmeans``) over a subsample, every row assigned, then the layout
  (``_grouped_blocks``): a stable sort of the rows by list, so within a
  list rows keep their corpus order, and one gather into the blocks. For
  the same assignments the layout is the JAX package's bit for bit.
* persistence: ``ivf_assignments`` recovers every row's list from a
  layout, and ``ivf_build_from_assign`` rebuilds the layout from persisted
  centroids and assignments without k-means; ``ivf_append`` assigns new
  rows to the existing centroids and packs them into blocks appended at
  the tail.
* search: ``ivf_search`` ranks lists by centroid score (the coarse stage,
  plain PyTorch as the JAX package leaves it to XLA), scores the rows of
  the selected blocks with ``ivf_scan`` and keeps the best k, ties to the
  lower slot. Scores of the rows it visits are exact (the exhaustive
  searches' arithmetic); only the candidate set is approximate, set by
  ``nprobe``. With ``nprobe == nblocks`` and ``exact_select=True`` it is
  the exact search, the differential anchor.

``ivf_scan`` is the kernel of this module, a kernel of the port's own: the
JAX package scores the probed blocks in XLA (``score_group``: a gather of
the blocks, ``dot_general``, then ``lax.top_k`` / ``approx_max_k``), not in
Pallas. On a CUDA tensor it launches ``ivf_scan_kernel`` from
``csrc/ivf_scan.cu`` (its own library, ``LIBRARIES``) or raises; on a CPU
tensor it runs ``ivf_scan_reference``. Launches count in
``fused_topk.launches["ivf_scan"]`` (and ``["masked"]`` for a row mask).

Departures from the JAX function, none of which changes an answer:

* no ``group_bytes`` loop: it bounded the JAX gather's [Q, g*cap, d] copy
  of the probed rows; the kernel reads the blocks where they lie and
  writes 4 bytes of score a slot. One select over every probed slot in
  ``lax.top_k``'s order (score descending, then the lower slot) gives what
  the JAX package's select of each group and merge gives;
* the select is always exact, where the JAX function takes
  ``approx_max_k`` over a row wider than 8192 slots (exact on the CPU,
  where the tests compare the two), so it takes no ``recall_target``.
"""

from __future__ import annotations

import ctypes
import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from . import fused_topk as ft
from .binary import binary_unpack
from .kmeans import _full_fp32, assign_clusters, kmeans
from .quantization import score_factor, sq4_unpack, sq8_quantize
from .topk import NEG_INF, order_keys, unpack_row_mask

# the kernel's library: one source, no defines (csrc/ivf_scan.cu)
LIBRARIES = (("ivf_scan", ()),)
# store dtype -> operand kind of the kernel (the OP_* codes of
# csrc/fused_topk.cu); packed binary words are int32, int4 nibbles uint8
_KINDS = {torch.bfloat16: ft._OP_BF16, torch.int32: ft._OP_BIN,
          torch.float32: ft._OP_F32, torch.int8: ft._OP_I8,
          torch.uint8: ft._OP_I4}
_PACKED = (torch.int32, torch.uint8)
# the dtype of the queries each kind scores against
_QUERY_DTYPE = {ft._OP_BF16: torch.bfloat16, ft._OP_BIN: torch.bfloat16,
                ft._OP_F32: torch.float32, ft._OP_I8: torch.int8,
                ft._OP_I4: torch.int8}
# the plain version's gathered rows at most, in fp32 bytes
_REFERENCE_BYTES = 256 << 20


def _block_rows(nlist: int) -> int:
    """Rows a block of the k-means and assignment sweeps, so that its
    [rows, nlist] fp32 score tile stays near 512 MB (at 8192 lists the
    JAX package's 131072-row default would be a 4.3 GB tile)."""
    return int(max(1024, min(131072, (1 << 27) // max(nlist, 1))))


def _tick(timings, key: str, t0: float, device) -> float:
    """Record the seconds since ``t0`` under ``key`` (after the device's
    work) when ``timings`` is a dict; returns the new start."""
    if timings is None:
        return t0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    timings[key] = timings.get(key, 0.0) + t1 - t0
    return t1


def _assign_packed(packed: torch.Tensor, centroids: torch.Tensor, d: int,
                   kind: str = "binary", block_size: int = 262144):
    """[n] int32 nearest-centroid ids of a packed corpus (sign words or
    int4 nibbles): each block unpacks to bf16 and scores against bf16
    centroids with fp32 sums, as the JAX function does, so only a block is
    ever unpacked."""
    c = centroids.float().to(packed.device)
    c_half = 0.5 * torch.sum(c * c, dim=1)
    cb = c.to(torch.bfloat16).float()
    out = torch.empty((packed.shape[0],), dtype=torch.int32,
                      device=packed.device)
    unpack = sq4_unpack if kind == "sq4" else binary_unpack
    with _full_fp32():
        for base in range(0, packed.shape[0], block_size):
            xb = unpack(packed[base : base + block_size], d).to(
                torch.bfloat16).float()
            out[base : base + xb.shape[0]] = torch.argmax(
                xb @ cb.T - c_half[None, :], dim=1).to(torch.int32)
    return out


class IVFIndex(NamedTuple):
    """The inverted-file layout on the device."""

    centroids: torch.Tensor  # [nlist, d] fp32, prepared space
    blocks: torch.Tensor  # [nblocks, cap, w] store dtype
    block_ids: torch.Tensor  # [nblocks, cap] int32 corpus rows, -1 pad
    block2list: torch.Tensor  # [nblocks] int32 owning list of each block

    @property
    def nblocks(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def cap(self) -> int:
        return int(self.block_ids.shape[1])

    @property
    def row_width(self) -> int:
        """Stored row width: d for float and int8 blocks, ceil(d/32) words
        for sign bits, ceil(d/2) bytes for int4 nibbles."""
        return int(self.blocks.shape[2])


def _layout(assign: torch.Tensor, sizes: torch.Tensor,
            block_start: torch.Tensor, nblocks: int,
            cap: int) -> torch.Tensor:
    """[nblocks * cap] int32 slot -> row map (-1 pads). Row r of list c
    with rank j in its list (rows in corpus order, a stable sort) lands in
    slot ``block_start[c] * cap + j``: lists own consecutive blocks, ranks
    fill them front to back, the tail of a list's last block stays -1."""
    n = assign.shape[0]
    order = torch.sort(assign, stable=True)[1]
    sorted_assign = assign[order].long()
    cluster_start = torch.cumsum(sizes, 0) - sizes
    rank = torch.arange(n, device=assign.device) - cluster_start[sorted_assign]
    slot = block_start[sorted_assign] * cap + rank
    flat = torch.full((nblocks * cap,), -1, dtype=torch.int32,
                      device=assign.device)
    flat[slot] = order.to(torch.int32)
    return flat


def _grouped_blocks(rows: torch.Tensor, assign: torch.Tensor, nlist: int,
                    cap: int, *, id_base: int = 0):
    """Group ``rows`` by their ``assign`` list into padded cap-blocks:
    (blocks [nb, cap, w], block_ids [nb, cap] holding ``id_base + row`` or
    -1, block2list [nb] int32). Only the [nlist] sizes visit the host. Pad
    slots are zero rows: the gather reads row 0 for them and zeroes it, so
    a -1 never indexes a row."""
    dev = rows.device
    w = int(rows.shape[1])
    assign = assign.to(dev)
    sizes_dev = torch.bincount(assign.long(), minlength=nlist)
    sizes = sizes_dev.cpu().numpy()
    nblk = -(-sizes // cap)  # ceil; empty lists own zero blocks
    nblocks = int(nblk.sum())
    block_start = np.concatenate(([0], np.cumsum(nblk)[:-1])).astype(np.int64)
    block2list = np.repeat(np.arange(nlist, dtype=np.int32), nblk)
    flat = _layout(assign, sizes_dev, torch.from_numpy(block_start).to(dev),
                   nblocks, cap)
    pad = (flat < 0)[:, None]
    blocks = rows.index_select(0, flat.clamp_min(0).long())
    blocks = blocks.masked_fill_(pad, 0).reshape(nblocks, cap, w)
    ids = flat.reshape(nblocks, cap)
    if id_base:
        ids = torch.where(ids >= 0, ids + id_base, ids)
    return blocks, ids, torch.from_numpy(block2list).to(dev)


def _train_rows(corpus: torch.Tensor, nlist: int, train_rows, seed: int):
    """The k-means training rows: a random subsample of ``train_rows``
    rows, by default min(n, max(100k, 64 * nlist)), as the JAX build
    samples."""
    n = int(corpus.shape[0])
    if train_rows is None:
        train_rows = min(n, max(100_000, 64 * nlist))
    if train_rows >= n:
        return corpus
    g = torch.Generator().manual_seed(seed)
    sub = torch.randperm(n, generator=g)[:train_rows].to(corpus.device)
    return corpus.index_select(0, sub)


def _build(corpus, nlist, cap, seed, kmeans_iters, train_rows, timings,
           unpack=None, assign_fn=None) -> IVFIndex:
    n = int(corpus.shape[0])
    if n == 0:
        raise ValueError("cannot build an IVF over an empty corpus")
    nlist = max(1, min(nlist, n))
    cap = max(8, min(cap, n))
    block = _block_rows(nlist)
    t0 = time.perf_counter()
    train = _train_rows(corpus, nlist, train_rows, seed)
    if unpack is not None:  # packed stores train on unpacked codes
        train = unpack(train)
    centroids = kmeans(train, nlist, iters=kmeans_iters, seed=seed,
                       block_size=block)
    del train
    t0 = _tick(timings, "kmeans_s", t0, corpus.device)
    if assign_fn is None:
        assign = assign_clusters(corpus, centroids, block_size=block)
    else:
        assign = assign_fn(corpus, centroids)
    t0 = _tick(timings, "assign_s", t0, corpus.device)
    blocks, ids, block2list = _grouped_blocks(corpus, assign, nlist, cap)
    _tick(timings, "layout_s", t0, corpus.device)
    return IVFIndex(centroids, blocks, ids, block2list)


def ivf_build(corpus: torch.Tensor, nlist: int, cap: int = 1024, *,
              seed: int = 0, kmeans_iters: int = 15,
              train_rows: int | None = None,
              timings: dict | None = None) -> IVFIndex:
    """The inverted file over a prepared store on the device (fp32, bf16
    or int8 SQ8 codes: a global SQ8 scale commutes out of k-means, so the
    codes cluster as their values do). k-means trains on ``train_rows``
    rows (default min(n, max(100k, 64 * nlist))), every row is assigned.
    ``timings`` (a dict) receives ``kmeans_s``, ``assign_s``,
    ``layout_s``."""
    return _build(corpus, nlist, cap, seed, kmeans_iters, train_rows,
                  timings)


def ivf_build_binary(packed: torch.Tensor, d: int, nlist: int,
                     cap: int = 1024, *, seed: int = 0,
                     kmeans_iters: int = 15, train_rows: int | None = None,
                     timings: dict | None = None) -> IVFIndex:
    """The inverted file over packed sign words (the binary cascade's
    stage 1): blocks hold the words, centroids live in the unpacked +-1
    space, trained on a subsample's unpack; assignment unpacks a block at
    a time (``_assign_packed``)."""
    return _build(
        packed, nlist, cap, seed, kmeans_iters, train_rows, timings,
        unpack=lambda pk: binary_unpack(pk, d),
        assign_fn=lambda pk, c: _assign_packed(pk, c, d, "binary",
                                               _block_rows(c.shape[0])))


def ivf_build_sq4(packed: torch.Tensor, d: int, nlist: int,
                  cap: int = 1024, *, seed: int = 0, kmeans_iters: int = 15,
                  train_rows: int | None = None,
                  timings: dict | None = None) -> IVFIndex:
    """The inverted file over packed int4 nibbles (the int4 cascade's
    stage 1): blocks hold the nibbles, centroids live in the int4 code
    space (the scale commutes out of k-means)."""
    return _build(
        packed, nlist, cap, seed, kmeans_iters, train_rows, timings,
        unpack=lambda pk: sq4_unpack(pk, d),
        assign_fn=lambda pk, c: _assign_packed(pk, c, d, "sq4",
                                               _block_rows(c.shape[0])))


def ivf_assignments(index: IVFIndex, n: int) -> torch.Tensor:
    """[n] int32 list of every corpus row, recovered from the layout
    (appended blocks included): with the centroids, the state a warm boot
    needs to skip k-means and the assignment sweep."""
    ids = index.block_ids.reshape(-1)
    b2l = index.block2list.repeat_interleave(index.cap)
    live = ids >= 0
    out = torch.zeros((n,), dtype=torch.int32, device=ids.device)
    out[ids[live].long()] = b2l[live].to(torch.int32)
    return out


def ivf_build_from_assign(corpus: torch.Tensor, centroids, assign,
                          cap: int) -> IVFIndex:
    """The layout from persisted centroids and assignments: no k-means,
    no assignment sweep. The grouping is deterministic, so the index
    serves the candidates of the one that was saved (same corpus, same
    cap)."""
    dev = corpus.device
    if not isinstance(centroids, torch.Tensor):
        centroids = torch.from_numpy(np.array(centroids, dtype=np.float32))
    if not isinstance(assign, torch.Tensor):
        assign = torch.from_numpy(np.array(assign, dtype=np.int32))
    centroids = centroids.to(dev, torch.float32)
    assign = assign.to(dev, torch.int32)
    blocks, ids, block2list = _grouped_blocks(
        corpus, assign, int(centroids.shape[0]), cap)
    return IVFIndex(centroids.contiguous(), blocks, ids, block2list)


def ivf_append(index: IVFIndex, new_rows: torch.Tensor, id_base: int,
               dim: int = 0) -> IVFIndex:
    """Append rows without re-clustering: they are assigned to the
    existing centroids and packed into new blocks after the current ones
    (existing blocks and their padding stay). ``id_base`` is the corpus
    row of the first new row. ``dim`` is the vectors' width, needed for
    packed blocks."""
    if int(new_rows.shape[0]) == 0:
        return index
    nlist = int(index.centroids.shape[0])
    if index.blocks.dtype in _PACKED:
        if not dim:
            raise ValueError("packed IVF append requires dim=<vector dim>")
        kind = "sq4" if index.blocks.dtype == torch.uint8 else "binary"
        assign = _assign_packed(new_rows, index.centroids, dim, kind)
    else:
        new_rows = new_rows.to(index.blocks.dtype)
        assign = assign_clusters(new_rows, index.centroids)
    blocks, ids, block2list = _grouped_blocks(
        new_rows, assign, nlist, index.cap, id_base=id_base)
    return IVFIndex(
        index.centroids,
        torch.cat([index.blocks, blocks]),
        torch.cat([index.block_ids, ids]),
        torch.cat([index.block2list, block2list]),
    )


def auto_nprobe(nblocks: int, fraction: float = 0.02) -> int:
    """The default probe budget: about ``fraction`` of the blocks, at
    least 32."""
    return max(32, min(nblocks, int(np.ceil(nblocks * fraction))))


# ------------------------------------------------------------ the scan


def _kind(blocks: torch.Tensor) -> int:
    kind = _KINDS.get(blocks.dtype)
    if kind is None:
        raise ValueError(f"unsupported IVF block dtype {blocks.dtype}")
    return kind


def _validate_scan(queries, blocks, block_ids, sel, dim, factor, mask,
                   euclid) -> tuple[int, int]:
    """Checks of the scan's operands; returns (kind, d)."""
    kind = _kind(blocks)
    if blocks.ndim != 3:
        raise ValueError("blocks must be [nblocks, cap, w]")
    nblocks, cap, w = blocks.shape
    d = dim or w
    want_w = {ft._OP_BIN: -(-d // 32), ft._OP_I4: -(-d // 2)}.get(kind, d)
    if w != want_w:
        raise ValueError(f"blocks of width {w} do not hold d={d}")
    if queries.ndim != 2 or queries.dtype != _QUERY_DTYPE[kind] \
            or queries.shape[1] != d:
        raise ValueError(
            f"queries must be {_QUERY_DTYPE[kind]} [Q, {d}] for "
            f"{blocks.dtype} blocks (got {queries.dtype} "
            f"{tuple(queries.shape)})")
    if block_ids.dtype != torch.int32 or tuple(block_ids.shape) != (
            nblocks, cap):
        raise ValueError(f"block_ids must be int32 [{nblocks}, {cap}]")
    if sel.dtype != torch.int32 or sel.ndim != 2 \
            or sel.shape[0] != queries.shape[0]:
        raise ValueError("sel must be int32 [Q, S]")
    if kind in (ft._OP_I8, ft._OP_I4):
        if factor is None or factor.dtype != torch.float32 \
                or factor.numel() != 1:
            raise ValueError("int8 / int4 blocks need one float32 factor")
    if euclid and kind not in (ft._OP_BF16, ft._OP_F32):
        raise ValueError("quantized IVF blocks support cosine/dot only")
    if mask is not None and (mask.dtype != torch.int32 or mask.ndim != 1):
        raise ValueError("mask must be int32 words [ceil(N/32)]")
    tensors = [queries, blocks, block_ids, sel] + [
        t for t in (factor, mask) if t is not None]
    if any(t.device != queries.device for t in tensors):
        raise ValueError("the scan's operands must be on one device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("the scan's operands must be contiguous")
    return kind, d


def ivf_scan_reference(
    queries: torch.Tensor, blocks: torch.Tensor, block_ids: torch.Tensor,
    sel: torch.Tensor, *, dim: int = 0, factor: torch.Tensor | None = None,
    mask: torch.Tensor | None = None, euclid: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of ``ivf_scan``, on any device: the
    selected blocks gathered (a chunk of queries at a time), unpacked, and
    scored by one batched product in full fp32. int8 and int4 dots are
    exact integers in fp32 (every partial sum stays below 2^24), so their
    scores are ``float32(dot) * factor`` bit for bit."""
    kind, d = _validate_scan(queries, blocks, block_ids, sel, dim, factor,
                             mask, euclid)
    nq, s_n = sel.shape
    nblocks, cap, w = blocks.shape
    dev = queries.device
    live = (sel >= 0) & (sel < nblocks)
    safe = torch.where(live, sel, 0).long()
    allowed = None
    if mask is not None:
        allowed = unpack_row_mask(mask, mask.numel() * 32)
    scores = torch.empty((nq, s_n * cap), dtype=torch.float32, device=dev)
    ids = torch.empty((nq, s_n * cap), dtype=torch.int32, device=dev)
    step = max(1, _REFERENCE_BYTES // max(1, s_n * cap * d * 4))
    with _full_fp32():
        for q0 in range(0, nq, step):
            q1 = min(q0 + step, nq)
            rows = blocks[safe[q0:q1]].reshape(-1, w)
            if kind == ft._OP_BIN:
                rows = binary_unpack(rows, d)
            elif kind == ft._OP_I4:
                rows = sq4_unpack(rows, d)
            vals = rows.float().reshape(q1 - q0, s_n * cap, d)
            dots = torch.bmm(vals, queries[q0:q1].float()[:, :, None])[..., 0]
            if kind in (ft._OP_I8, ft._OP_I4):
                dots = dots * factor
            if euclid:
                dots = 2.0 * dots - torch.sum(vals * vals, dim=2)
            rid = torch.where(live[q0:q1, :, None], block_ids[safe[q0:q1]],
                              -1).reshape(q1 - q0, s_n * cap)
            ok = rid >= 0
            if allowed is not None:
                ok &= allowed[rid.clamp_min(0).long()]
            scores[q0:q1] = torch.where(ok, dots, NEG_INF)
            ids[q0:q1] = torch.where(ok, rid, -1)
    return scores, ids


@functools.cache
def _library() -> ctypes.CDLL:
    """The scan's library, built at its first launch."""
    from .cuda_build import load_libraries

    lib = load_libraries(LIBRARIES)[0]
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lr_ivf_scan.restype = i
    lib.lr_ivf_scan.argtypes = [p] * 8 + [i] * 10 + [p]
    lib.lr_ivf_error_string.restype = ctypes.c_char_p
    lib.lr_ivf_error_string.argtypes = [i]
    return lib


def ivf_scan(
    queries: torch.Tensor, blocks: torch.Tensor, block_ids: torch.Tensor,
    sel: torch.Tensor, *, dim: int = 0, factor: torch.Tensor | None = None,
    mask: torch.Tensor | None = None, euclid: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scores of every slot of the selected blocks: (scores [Q, S*cap] f32,
    ids [Q, S*cap] i32), slot ``s*cap + i`` row ``i`` of block
    ``sel[q, s]``.

    ``queries`` are the prepared operand of the blocks' kind: fp32 or
    bf16 rows (fp32 / bf16 blocks), bf16 (packed sign words, int32
    [nblocks, cap, ceil(dim/32)]), or int8 SQ8 codes (int8 blocks, and
    packed int4 nibbles uint8 [nblocks, cap, ceil(dim/2)]); ``factor`` is
    the int kinds' one fp32 ``q_scale * scale``. A selected id outside
    [0, nblocks) is a sentinel and is never read; sentinel slots, pad ids
    and rows ``mask`` (int32 words, bit ``r & 31`` of word ``r >> 5``)
    excludes are (NEG_INF, -1). int8 / int4 score
    ``float32(int32 dot) * factor``; float blocks sum in fp32, binary the
    sign-dot of the bf16 query; ``euclid`` (float blocks) scores
    ``2 q.r - |r|^2``.

    On a CUDA tensor it launches ``ivf_scan_kernel`` (``csrc/ivf_scan.cu``)
    or raises; on a CPU tensor it runs ``ivf_scan_reference``."""
    if queries.device.type == "cpu":
        return ivf_scan_reference(queries, blocks, block_ids, sel, dim=dim,
                                  factor=factor, mask=mask, euclid=euclid)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    kind, d = _validate_scan(queries, blocks, block_ids, sel, dim, factor,
                             mask, euclid)
    nq, s_n = sel.shape
    nblocks, cap, w = blocks.shape
    if nq > 65535:
        raise ValueError(f"the scan takes at most 65535 queries (got {nq})")
    scores = torch.empty((nq, s_n * cap), dtype=torch.float32,
                         device=queries.device)
    ids = torch.empty((nq, s_n * cap), dtype=torch.int32,
                      device=queries.device)
    if nq == 0 or s_n == 0:
        return scores, ids
    row_bytes = w * blocks.element_size()
    vec = int(row_bytes % 16 == 0 and blocks.data_ptr() % 16 == 0)
    lib = _library()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(queries.device):
        code = lib.lr_ivf_scan(
            ptr(queries), ptr(blocks), ptr(block_ids), ptr(sel), ptr(mask),
            ptr(factor), ptr(scores), ptr(ids), nq, s_n, nblocks, cap, w, d,
            0 if mask is None else mask.numel(), kind, int(euclid), vec,
            torch.cuda.current_stream().cuda_stream)
    if code != 0:
        msg = lib.lr_ivf_error_string(code).decode() if code > 0 else \
            "bad arguments"
        raise RuntimeError(f"ivf_scan launch failed: {msg} (code {code})")
    ft.launches["ivf_scan"] += 1
    ft.last_kernel = ft._launched(f"ivf_scan_kernel{ft._OP_TAG[kind]}", mask)
    return scores, ids


# ------------------------------------------------------------ the search


def _top_lower(scores: torch.Tensor, k: int) -> torch.Tensor:
    """[Q, k] positions of the k best scores of each row in
    ``lax.top_k``'s order: score descending, then the lower position
    (-0.0 below +0.0), from a unique int64 key."""
    pos = torch.arange(scores.shape[1], device=scores.device)[None, :]
    return torch.topk(order_keys(scores, pos), k, dim=1).indices


def _coarse(cscore: torch.Tensor, index: IVFIndex, nprobe: int,
            exact_select: bool, max_list_blocks) -> torch.Tensor:
    """[Q, S] int32 selected block ids (``nblocks`` marks a sentinel).

    Narrow indexes (or ``exact_select``): the top ``nprobe`` blocks of the
    block-replicated list scores, so the blocks of one list tie and the
    lower block wins, a partly selected list scanned front to back. Wide
    indexes (nblocks > 8192): the top lists by score, each expanded to all
    its blocks in storage order through a stable argsort of
    ``block2list`` (appended blocks sit at the tail), ``max_list_blocks``
    (default 4x the average, + 8) slots a list."""
    nq = cscore.shape[0]
    nblocks = index.nblocks
    b2l = index.block2list
    dev = cscore.device
    if nblocks > 8192 and not exact_select:
        nlist_real = int(index.centroids.shape[0])
        real = b2l >= 0
        nblk_l = torch.bincount(b2l[real].long(), minlength=nlist_real)
        order = torch.sort(b2l, stable=True)[1]
        n_pads = torch.sum(~real)
        start_sorted = n_pads + torch.cumsum(nblk_l, 0) - nblk_l
        avg_b = max(1.0, nblocks / nlist_real)
        n_lists = max(1, min(nlist_real, int(round(nprobe / avg_b))))
        if max_list_blocks is not None:
            b_cap = int(max_list_blocks)
        else:
            b_cap = min(nblocks, int(np.ceil(avg_b * 4)) + 8)
        lsel = _top_lower(cscore, n_lists)  # [Q, L]
        starts = start_sorted[lsel]
        counts = nblk_l[lsel]
        offs = torch.arange(b_cap, device=dev)
        pos = starts[:, :, None] + offs[None, None, :]
        ok = offs[None, None, :] < counts[:, :, None]
        bsel = order[torch.clamp(pos, max=nblocks - 1)]
        return torch.where(ok, bsel, nblocks).reshape(
            nq, n_lists * b_cap).to(torch.int32).contiguous()
    bscore = cscore[:, b2l.clamp_min(0).long()]
    bscore = torch.where(b2l[None, :] >= 0, bscore, NEG_INF)
    return _top_lower(bscore, nprobe).to(torch.int32).contiguous()


def ivf_search(
    queries: torch.Tensor,
    index: IVFIndex,
    k: int,
    nprobe: int,
    metric: str = "cosine",
    scale=None,
    mask: torch.Tensor | None = None,
    exact_select: bool = False,
    dim: int = 0,
    max_list_blocks: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the ``nprobe`` best blocks of each query: (scores [Q, k]
    f32, corpus row ids [Q, k] int32); slots past the probed candidates
    are (NEG_INF, -1).

    ``queries`` are prepared [Q, d] floats; ``scale`` is the store's scale
    for int8 blocks (SQ8) and int4 blocks (SQ4), so scores come back in
    the float space as the exhaustive searches give them; ``mask`` the
    packed int32 row words of a filter; ``dim`` the vectors' width for
    packed blocks. ``max_list_blocks`` is the build's largest list in
    blocks, the wide path's expansion per list. Every select here is
    exact."""
    q = queries.float().contiguous()
    nblocks = index.nblocks
    nprobe = max(1, min(int(nprobe), nblocks))
    kind = _kind(index.blocks)
    distance_like = metric in ("euclidean", "mahalanobis")
    packed = index.blocks.dtype in _PACKED
    if packed and not dim:
        raise ValueError("packed IVF blocks require dim=<vector dim>")
    if kind not in (ft._OP_BF16, ft._OP_F32) and distance_like:
        raise ValueError("quantized IVF blocks support cosine/dot only")
    cent = index.centroids
    with _full_fp32():
        cdots = q @ cent.T
        if distance_like:
            cscore = 2.0 * cdots - torch.sum(cent * cent, dim=1)[None, :]
        else:
            cscore = cdots
    sel = _coarse(cscore, index, nprobe, exact_select, max_list_blocks)
    factor = None
    if kind in (ft._OP_I8, ft._OP_I4):
        qv, q_scale = sq8_quantize(q)
        factor = score_factor(q_scale, scale)
    else:
        qv = q.to(_QUERY_DTYPE[kind])
    scores, ids = ivf_scan(qv.contiguous(), index.blocks, index.block_ids,
                           sel, dim=dim, factor=factor, mask=mask,
                           euclid=distance_like)
    kk = min(k, scores.shape[1])
    top = _top_lower(scores, kk)
    top_s = torch.gather(scores, 1, top)
    top_i = torch.gather(ids, 1, top)
    if kk < k:  # fewer probed slots than k: pad the tail
        w = k - kk
        top_s = torch.cat([top_s, torch.full((q.shape[0], w), NEG_INF,
                                             device=q.device)], dim=1)
        top_i = torch.cat([top_i, torch.full((q.shape[0], w), -1,
                                             dtype=torch.int32,
                                             device=q.device)], dim=1)
    live = top_s > NEG_INF * 0.5
    if distance_like:
        q_sq = torch.sum(q * q, dim=1, keepdim=True)
        top_s = torch.where(live, top_s - q_sq, top_s)
    top_i = torch.where(live, top_i, -1)
    return top_s, top_i
