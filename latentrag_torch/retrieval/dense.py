"""Dense latent-index retriever (the core of the JAX package's
``retrieval/dense.py``).

* ``build`` prepares the corpus for its metric (cosine: normalized;
  euclidean: raw; mahalanobis: whitened with a factor fitted at build) and
  holds it on the device as an fp32 or bf16 store, as the int8 store
  (cosine / dot only: SQ8 codes and their scale on the device), or as a
  cascade store (cosine / dot only): the binary store's packed sign bits
  or the int4 store's packed nibbles on the device, SQ8 rescore codes on
  the host;
* ``search(queries, k)`` scores all queries in one batch; ``retrieve``
  wraps it for one query;
* scoring backends keep the JAX package's names, so a config means the
  same on both sides: ``xla`` (``approx_topk``), ``xla_exact``
  (``exact_topk``, the oracle), ``pallas`` / ``pallas_exact`` (the fused
  kernel in fold / exact mode with the JAX package's tile width:
  hand-written CUDA on the card, its plain version on the CPU), and
  ``auto``: ``xla`` on CUDA, as the TPU's ``auto`` picked ``xla``, and
  ``xla_exact`` on the CPU. On CUDA ``xla`` runs the fused fold kernel at a
  tile width and candidate count set by ``recall_target`` and rescores
  its candidates exactly (the exact kernel above k=128);
* the int8 store searches as the JAX package's ``sq8_topk`` does: the
  queries quantized with one SQ8 scale over the batch, int32 dots, the
  JAX package's scores bit for bit (on CUDA ``approx_sq8_fused_topk``: the
  int8 fold kernel planned by ``fold_plan``, rescored exactly, the exact
  int8 kernel above 128; on the CPU the plain exact ``sq8_topk``);
* the binary and int4 stores search in two stages, as the JAX package's
  do: stage 1 takes ``binary_oversample`` x k candidates by sign-dot or
  int4 score (on CUDA the binary or int4 fold kernel, planned by
  ``fold_plan`` from the recall target of k; on the CPU the plain exact
  search), stage 2 rescores them exactly on the host against the SQ8
  codes, and the results come back as host numpy;
* ``search(..., filter=)`` restricts the search to the rows a filter spec
  allows (``retrieval.filtering``): the spec compiles once to the packed
  row mask the kernels read (cached per spec, dropped on any mutation);
  ``xla`` masks inside the fold and exact kernels on the card,
  ``xla_exact`` inside the oracle, the int8 store in its kernels, the
  cascades in stage 1;
  ``pallas`` / ``pallas_exact`` refuse a filter, as in the JAX package;
* ``add`` / ``remove`` mutate a built index live: new rows are prepared
  with the build-time whitener and SQ8 scale, removal gathers the
  survivors on the device in one ``index_select`` and leaves their scores
  unchanged bit for bit;
* persistence (``index_path``): the JAX package's store, file for file
  (``corpus.npy`` of prepared fp32 rows, the int8 store's dequantized;
  ``binary_packed.npy`` / ``sq8_scale.npy`` for the binary store,
  ``sq4_packed.npy`` / ``sq4_scale.npy`` / ``sq8_scale.npy`` for the int4
  store; ``whitener.npy``, the lazy text
  store, ``metadata.jsonl``, and ``meta.json`` last with the fingerprint
  and sampled digests of every sidecar), so a store written by either
  package loads in the other. A retriever built with an ``index_path``
  that holds a valid store loads it; ``build()`` with the same
  fingerprint and corpus digest then skips the rebuild and the
  self-check. A store of any tier loads at the tier asked for, as the
  JAX package's load does (an int8 store re-quantizes the stored rows; a
  cascade store without its sidecars re-derives them on the host, with
  the JAX package's warnings). A store that fails validation starts
  clean; an error of the device while the validated store is uploaded
  propagates;
* a post-build self-search: the first corpus row must retrieve itself
  top-1, searched through the store's configured backend (float stores),
  the int8 search (probe = the dequantized row), or the cascade (binary
  and int4 stores, probe = the dequantized SQ8 row), as the JAX package's
  check searches (its dense.py:657-665).

The JAX package's ``_self_check`` turned any exception into a silent
rebuild. Here a kernel that fails to build or launch raises; only a wrong
top-1 counts as a failed check.

* the device IVF (``ivf_nlist > 0``, ``ops.ivf``): small batches (at
  most ``ivf_query_limit`` queries, a corpus of at least ``IVF_MIN_ROWS``
  rows, the ``xla`` backend or a cascade's stage 1) scan only the blocks
  of the lists whose centroids score best, when the probe's estimated
  bytes stay under a quarter of the sweep's or the probe budget is pinned
  (``ivf_nprobe``, ``search(..., nprobe=)``: bucketed up to a power of
  two); ``_ivf_eligible`` decides, as the JAX package's does. The layout
  is built at the first eligible search (or at ``build``'s save), with a
  recall probe against the exhaustive route (``ivf_recall_estimate``);
  ``add`` appends to it within a budget, ``remove`` drops it. Its
  centroids and assignments persist as the JAX package's sidecars
  (``ivf_centroids.npy``, ``ivf_assign.npy``), so a warm boot rebuilds the
  layout without k-means, from a store either package wrote.

* a mesh (``mesh=``, ``parallel.make_mesh``): the store's rows sharded
  over it (``parallel.shard_rows``: zero pad rows at the end, at most P -
  1), each shard searched by the same route as one device's store
  (``ops.store_search.store_topk``, the kernels on the card) at k + P - 1
  and the candidates merged in ``lax.top_k``'s order
  (``parallel.sharded_topk``); a filter's mask is sharded like the rows;
  the cascades' stage 1 runs on the shards and stage 2 on the host as
  before; ``add`` / ``remove`` gather, mutate and re-shard. A 1-device
  mesh is dropped, as in the JAX package. The float and int8 stores then
  persist as ``sharded/`` (``parallel.checkpoint``: one ``.npy`` a shard,
  each written by the process that holds it) with a generation tag in
  both metas, a mixed generation refusing to load; the cascades persist
  their usual files. A ``sharded/`` store loads on a mesh of any size or
  on one device. The JAX package's ``sharded/`` is Orbax, which the port
  does not read (``scripts/orbax_sharded_to_npy.py`` rewrites it), and the
  JAX package does not read the port's. A mesh with the device IVF
  (``ivf_nlist > 0``) raises: the sharded IVF is ROADMAP queue 1 (a).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import secrets
import shutil
import time
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

from ..ops.binary import binary_quantize
from ..ops.distances import (
    estimate_covariance,
    prepare_for_metric,
    whitening_factor,
)
from ..ops import ivf as ivf_ops
from ..ops.quantization import (
    sq4_quantize,
    sq4_quantize_with_scale,
    sq4_unpack,
    sq8_quantize,
)
from ..ops.store_search import prepare_queries, store_topk
from ..ops.topk import NEG_INF, pack_row_mask
from ..parallel.checkpoint import (
    load_sharded_index,
    read_sharded_meta,
    save_sharded_index,
)
from ..parallel.distributed import barrier
from ..parallel.mesh import ShardedRows, gather_rows, shard_rows
from ..parallel.sharded_topk import sharded_search
from ..utils.device import resolve_device
from ..utils.timing import StatsTracker, force_completion
from .filtering import (
    FilterCache,
    canonical_filter_key,
    compile_filter_mask,
    extend_aligned_metadata,
    pack_mask,
)
from .rescore import exact_rescore_topk
from .textstore import (
    atomic_save,
    load_metadata_sidecar,
    load_texts,
    save_metadata_sidecar,
    save_texts,
)

log = logging.getLogger("latentrag_torch.retrieval")

FINGERPRINT_VERSION = 1
BACKENDS = ("auto", "xla", "xla_exact", "pallas", "pallas_exact")
# the device dtype of each store: binary the packed sign words, int8 the
# SQ8 codes, int4 the packed nibbles
STORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "binary": torch.int32, "int8": torch.int8,
                "int4": torch.uint8}
QUANTIZED = ("int8", "int4", "binary")
CASCADES = ("binary", "int4")  # stage 1 on the device, SQ8 codes on the host
EXACT_BACKENDS = ("xla_exact", "pallas_exact")


def _stored_digest(arr) -> str:
    """Sampled content digest of a persisted array: shape, dtype and <= 64
    evenly spaced rows (arrays of <= 4096 values in full). It binds each
    sidecar to its save generation, and verifies off a mmap in O(64 rows).
    The same hex string as the JAX package's for the same array."""
    a = arr if isinstance(arr, np.ndarray) else np.asarray(arr)
    h = hashlib.sha1()
    h.update(f"{tuple(a.shape)}:{a.dtype.str}:".encode())
    if a.ndim == 0 or a.size <= 4096:
        h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()
    n = int(a.shape[0])
    idxs = np.linspace(0, n - 1, num=min(n, 64), dtype=int)
    for row in a[idxs]:
        h.update(np.ascontiguousarray(row).tobytes())
    return h.hexdigest()


def verify_stored_digests(path: str, meta: dict) -> None:
    """Check every sidecar recorded in meta['stored_digests'] against the
    bytes on disk (sampled rows off the mmap). Raises ValueError on a
    missing file or a mixed-generation pairing; metas without digests
    (legacy stores) pass."""
    for fname, want in (meta.get("stored_digests") or {}).items():
        p = os.path.join(path, fname)
        if not os.path.exists(p):
            raise ValueError(
                f"{fname} recorded in meta.json but missing on disk; "
                "mixed-generation store"
            )
        if _stored_digest(np.load(p, mmap_mode="r")) != want:
            raise ValueError(
                f"{fname} contradicts meta.json's stored digest; "
                "mixed-generation store"
            )


def _corpus_digest(emb, texts) -> str:
    """Cheap stable identity of (embeddings, texts): the shape, 64 sampled
    rows in fp32 and their texts' prefixes. A device tensor gathers only
    the sampled rows; the byte stream is the host array's, so the digest
    is the JAX package's for the same data on any device."""
    if not hasattr(emb, "shape"):  # plain sequences
        emb = np.asarray(emb, dtype=np.float32)
    n = int(emb.shape[0])
    h = hashlib.sha1()
    h.update(f"{tuple(emb.shape)}:".encode())
    if n:
        idxs = np.linspace(0, n - 1, num=min(n, 64), dtype=int)
        if isinstance(emb, torch.Tensor):  # one gather of the sample rows
            sample = emb[torch.as_tensor(idxs, device=emb.device)]
            sample = sample.float().cpu().numpy()
        else:
            sample = np.asarray(emb)[idxs]
        for i, row in zip(idxs, sample):
            h.update(np.ascontiguousarray(row, dtype=np.float32).tobytes())
            if i < len(texts):
                h.update(str(texts[i])[:256].encode("utf-8", "ignore"))
    return h.hexdigest()[:16]


def make_fingerprint(
    *,
    d: int,
    embedding_model: str | None = None,
    ae_type: str | None = None,
    latent_dim: int | None = None,
    chunking: dict | None = None,
    metric: str = "cosine",
    normalize: bool = True,
) -> dict:
    """The store's provenance record, with the JAX package's keys."""
    return {
        "d": d,
        "embedding_model": embedding_model,
        "ae_type": ae_type,
        "latent_dim": latent_dim,
        "chunking": chunking
        or {
            "enabled": False,
            "mode": "sliding",
            "max_tokens": None,
            "stride": None,
            "min_tokens": None,
        },
        "metric": metric,
        "normalize": normalize,
        "version": FINGERPRINT_VERSION,
    }


def _drop_stale(path: str, *names: str) -> None:
    """Remove sidecars this save does not write: a stale one of another
    store type would pair with the new corpus on a later load."""
    for nm in names:
        p = os.path.join(path, nm)
        if os.path.isdir(p):
            shutil.rmtree(p)
        elif os.path.exists(p):
            os.remove(p)


@dataclass
class _Store:
    """A validated store, still on the host (``DenseRetriever._read``)."""

    texts: Any
    doc_ids: list
    metadata: list | None
    metric: str
    fingerprint: dict | None
    n: int
    dim: int
    # prepared fp32 rows, or the binary store's words, or the int4 store's
    # nibbles; None for a float or int8 store kept as ``sharded/``
    rows: np.ndarray | None
    whitener: np.ndarray | None
    rescore: np.ndarray | None = None  # cascades: SQ8 codes
    scale: float | None = None  # cascades: their scale
    sq4_scale: float | None = None  # int4: the nibbles' scale
    # the device IVF's persisted (centroids, assignments), when the store
    # holds them at this retriever's nlist and cap, and its recall estimate
    ivf_sidecar: tuple | None = None
    ivf_recall_estimate: float | None = None
    # a float or int8 store's ``sharded/`` directory and its checked meta:
    # its rows go from the shard files straight to the devices (_adopt)
    sharded: tuple | None = None


@dataclass
class DenseRetriever:
    """Exact / quasi-exact dense retriever over a latent corpus matrix."""

    metric: str = "cosine"
    backend: str = "auto"
    block_size: int = 1048576
    recall_target: float | str = "auto"
    store_dtype: str = "bfloat16"
    index_path: str | None = None
    fingerprint: dict | None = None
    device: Any = "cuda"
    # parallel.Mesh: the store's rows sharded over it (a 1-device mesh is
    # dropped)
    mesh: Any = None

    texts: Any = field(default_factory=list)
    doc_ids: list = field(default_factory=list)
    # optional per-document metadata (row-aligned dicts) backing
    # filter={"where": {...}}
    metadata: list | None = None
    stats: StatsTracker = field(default_factory=StatsTracker)

    _corpus: Any = None  # prepared [N, D] store on the device
    _corpus_n: int = 0
    _whitener: Any = None
    # cascade stores: _corpus holds only the packed sign words [N, D/32]
    # (binary) or nibbles [N, D/2] (int4) on the device; the SQ8 rescore
    # codes and their scale stay on the host. The int8 store's codes are
    # _corpus, their scale _corpus_scale.
    _rescore_host: Any = None  # np.int8 [N, D]
    _corpus_scale: Any = None  # float: the SQ8 scale (int8, cascades)
    _sq4_scale: Any = None  # float: the int4 store's stage-1 scale
    _dim: int = 0  # the vectors' dim (a packed row has D/32 words)
    binary_oversample: int = 8  # cascade stage-1 candidates per k
    _loaded_fingerprint: Any = None
    # compiled filter masks on the device (the packed int32 words), keyed
    # by canonical spec; dropped on any build or mutation
    _filter_cache: Any = None
    # the device IVF (ops.ivf): built at the first eligible search (or at
    # build()'s save) from the store on the device. 0 lists = disabled
    ivf_nlist: int = 0
    ivf_cap: int = 512
    ivf_nprobe: int = 0  # 0 = auto (~2 % of the blocks, at least 32)
    ivf_query_limit: int = 64
    # corpus rows the build's recall probe samples (0 skips it)
    ivf_selfcheck: int = 64
    _ivf_index: Any = None
    _ivf_recall_estimate: Any = None  # float | None, set by the probe
    _ivf_appended: int = 0  # rows appended since the last full IVF build
    # persisted (centroids, assignments) of a warm boot: the next
    # _ensure_ivf regroups them instead of running k-means
    _ivf_sidecar: Any = None
    # (block2list, its largest list in blocks) of the current layout
    _ivf_mlb: Any = None
    # the latest IVF build's seconds by stage (kmeans_s, assign_s,
    # layout_s, probe_s) and whether it came from the sidecar
    _ivf_build_info: dict = field(default_factory=dict)

    # k at/above this is treated as re-rank oversampling
    RERANK_K = 64
    # corpora below this never route through the IVF
    IVF_MIN_ROWS = 8192

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {BACKENDS}")
        if self.store_dtype not in STORE_DTYPES:
            raise ValueError(f"store_dtype {self.store_dtype!r} not in "
                             f"{tuple(STORE_DTYPES)}")
        # quantized stores cannot serve the exact oracle, and the cascades
        # take cosine / dot only, as in the JAX package
        if self.store_dtype in QUANTIZED and self.backend in EXACT_BACKENDS:
            raise ValueError(
                f"backend={self.backend!r} requests the exact oracle, but "
                f"store_dtype={self.store_dtype!r} is quantized; use a float "
                "store for oracle comparisons"
            )
        if self.store_dtype in CASCADES:
            self._validate_binary_combo()
        if self.mesh is not None and self.mesh.size == 1:
            # one shard is the single-device store with merge plumbing
            self.mesh = None
        if self.mesh is not None:
            if self.ivf_nlist > 0:
                raise NotImplementedError(
                    "the device IVF over a mesh (retrieval.ivf_nlist > 0 with "
                    "retrieval.shard_corpus) is ROADMAP queue 1 (a), the "
                    "sharded IVF; serve it unsharded or set ivf_nlist=0")
            self.device = self.mesh.devices[0]
        self.device = resolve_device(self.device)
        if self.index_path and os.path.exists(
            os.path.join(self.index_path, "meta.json")
        ):
            # the store is validated on the host before anything of it
            # reaches this retriever, so a refused store leaves it clean;
            # the upload after runs outside the except, so a device error
            # (CUDA, out of memory) propagates
            try:
                store = self._read(self.index_path)
            except Exception as e:  # corrupted or mixed store -> start clean
                log.warning("index at %s unreadable (%r); starting clean",
                            self.index_path, e)
            else:
                self._adopt(store)
                log.info("index loaded from %s (n=%d)", self.index_path,
                         self._corpus_n)

    def _validate_binary_combo(self):
        if self.metric not in ("cosine", "dot"):
            raise ValueError(
                f"{self.store_dtype} store supports cosine/dot only")

    @property
    def is_built(self) -> bool:
        return self._corpus is not None

    @property
    def dim(self) -> int:
        """The vectors' width (a binary store's too, not its packed word
        count); 0 before a build or a load."""
        return self._dim

    def _resolve_backend(self) -> str:
        if self.backend != "auto":
            return self.backend
        return "xla" if self.device.type == "cuda" else "xla_exact"

    def _effective_recall_target(self, k: int) -> float:
        """The recall_target knob for this k: "auto" is 0.95 when the
        caller oversamples for a re-rank (k >= RERANK_K), else 0.99."""
        rt = self.recall_target
        if isinstance(rt, str):
            if rt == "auto":
                return 0.95 if k >= self.RERANK_K else 0.99
            return float(rt)
        return float(rt)

    # ---------------------------------------------------------------- build

    def build(
        self,
        embeddings,
        texts: Sequence[str],
        doc_ids: Sequence | None = None,
        fingerprint: dict | None = None,
        sanity_check: bool = True,
        metadata: Sequence[dict] | None = None,
    ) -> None:
        """Prepare the corpus and hold it on the device; persist it when
        ``index_path`` is set. A loaded index with the same fingerprint,
        corpus digest and row count is kept as it is (only new
        ``metadata`` is taken); any other is rebuilt."""
        if metadata is not None and len(metadata) != len(texts):
            raise ValueError(
                f"{len(metadata)} metadata entries for {len(texts)} texts"
            )
        if fingerprint is not None:
            self.fingerprint = fingerprint
            # the caller's fingerprint decides the metric: a rebuild must
            # not inherit the metric of the store it loaded
            fp_metric = fingerprint.get("metric")
            if fp_metric and fp_metric != self.metric:
                log.warning(
                    "loaded index metric %r overridden by requested %r",
                    self.metric, fp_metric,
                )
                self.metric = fp_metric
        if self.fingerprint is None:
            self.fingerprint = make_fingerprint(
                d=int(embeddings.shape[1]), metric=self.metric
            )
        # corpus identity: a different corpus of the same size and config
        # must not be served from a stale store
        self.fingerprint = dict(self.fingerprint)
        self.fingerprint["corpus_digest"] = _corpus_digest(embeddings, texts)
        if (
            self.is_built
            and self._corpus_n == len(texts)
            and self._loaded_fingerprint == self.fingerprint
        ):
            if metadata is not None:  # new filters for the same corpus
                self.metadata = list(metadata)
                if self._filter_cache is not None:
                    self._filter_cache.clear()
                if self.index_path:
                    self._save_metadata_only(self.index_path)
            log.info("index compatible; skipping rebuild")
            return

        t0 = time.perf_counter()
        x = torch.as_tensor(embeddings).to(self.device, torch.float32)
        if len(texts) != x.shape[0]:
            raise ValueError("texts and embeddings row count mismatch")
        self.texts = list(texts)
        self.doc_ids = (
            list(doc_ids) if doc_ids is not None else list(range(len(texts)))
        )
        self.metadata = list(metadata) if metadata is not None else None
        if self._filter_cache is not None:
            self._filter_cache.clear()
        # the IVF and its sidecar describe the corpus being replaced
        self._ivf_index = self._ivf_recall_estimate = self._ivf_sidecar = None
        self._whitener = None
        if self.metric == "mahalanobis":
            self._whitener = whitening_factor(estimate_covariance(x))
        prepared = prepare_for_metric(x, self.metric, self._whitener)
        self._dim = int(x.shape[1])
        self._rescore_host = self._corpus_scale = self._sq4_scale = None
        if self.store_dtype in CASCADES:
            self._validate_binary_combo()
            codes, scale = sq8_quantize(prepared)
            self._rescore_host = codes.cpu().numpy()
            self._corpus_scale = float(scale)
            if self.store_dtype == "binary":
                self._corpus = binary_quantize(prepared)
            else:  # int4: the nibbles at their own scale
                self._corpus, scale4 = sq4_quantize(prepared)
                self._sq4_scale = float(scale4)
        elif self.store_dtype == "int8":
            self._validate_binary_combo()
            self._corpus, scale = sq8_quantize(prepared)
            self._corpus_scale = float(scale)
        else:
            self._corpus = prepared.to(
                STORE_DTYPES[self.store_dtype]).contiguous()
        self._corpus = self._place(self._corpus)
        self._corpus_n = int(x.shape[0])
        self._loaded_fingerprint = dict(self.fingerprint)
        self._sync()
        self.stats.add_build(time.perf_counter() - t0)

        if self.index_path:
            self._save(self.index_path, eager_ivf=True)

        if sanity_check and self._corpus_n > 0 and not self._self_check():
            log.warning("post-build self-check failed; rebuilding once")
            self._corpus = None
            self.build(x, texts, doc_ids, self.fingerprint,
                       sanity_check=False, metadata=metadata)

    def _self_check(self) -> bool:
        """The first corpus row must come back top-1, searched as a query
        would be: through the configured backend (float stores), the int8
        search or the cascade (binary and int4 stores), never through the
        IVF. Kernel build and launch errors propagate."""
        probe = self._corpus_row(0)[None, :]
        _, idx = self._search_prepared(probe, min(4, self._corpus_n),
                                       allow_ivf=False)
        return int(idx[0, 0]) == 0

    def _corpus_row(self, i: int) -> torch.Tensor:
        """Row ``i`` of the store as fp32 on the device (the int8 store:
        its dequantized row; the cascades: the dequantized SQ8 row)."""
        if self._rescore_host is not None:
            row = torch.from_numpy(self._rescore_host[i].astype(np.float32))
            return (row * self._corpus_scale).to(self.device)
        row = (self._corpus[i] if self.mesh is None
               else self._corpus.row(i)).float()
        if self.store_dtype == "int8":
            return row * self._corpus_scale
        return row

    # ----------------------------------------------------------------- mesh

    def _place(self, rows: torch.Tensor):
        """The store's rows as the retriever holds them: on its device, or
        row-sharded over the mesh."""
        return rows if self.mesh is None else shard_rows(rows, self.mesh)

    def _rows(self) -> torch.Tensor:
        """The store's ``_corpus_n`` rows as one tensor on the device (from
        a mesh, gathered, across processes too)."""
        if self.mesh is None:
            return self._corpus[: self._corpus_n]
        return gather_rows(self._corpus, self._corpus_n, self.device)

    def _sync(self) -> None:
        """Wait for the store's device work (every shard's device)."""
        if self.mesh is None:
            force_completion(self._corpus)
        else:
            for shard in self._corpus.shards:
                force_completion(shard)

    # ------------------------------------------------------------- mutation

    def add(
        self,
        embeddings,
        texts: Sequence[str],
        doc_ids: Sequence | None = None,
        metadata: Sequence[dict] | None = None,
    ) -> None:
        """Append documents to a built index. New rows are prepared with
        the build-time transform (the whitener of the build's covariance;
        the quantized stores' SQ8 and int4 scales) and concatenated on the
        device, so the scores of the rows already there do not change.
        Persists when ``index_path`` is set."""
        if not self.is_built:
            raise RuntimeError("build() the index before add()")
        x = torch.as_tensor(embeddings).to(self.device, torch.float32)
        if x.ndim != 2 or x.shape[1] != self._dim:
            raise ValueError(
                f"dim mismatch: index {self._dim}, new rows {tuple(x.shape)}"
            )
        start = self._corpus_n
        new_ids = (
            list(doc_ids)
            if doc_ids is not None
            else list(range(start, start + len(texts)))
        )
        if len(texts) != x.shape[0] or len(new_ids) != x.shape[0]:
            raise ValueError("texts/doc_ids/embeddings row count mismatch")
        if metadata is not None and len(metadata) != x.shape[0]:
            raise ValueError("metadata/embeddings row count mismatch")
        m = int(x.shape[0])
        if (self._ivf_index is None and self._ivf_sidecar is not None
                and self._ivf_append_budget(m, n_total=self._corpus_n + m)):
            # a warm boot's first add: lay the IVF out from the sidecar now
            # (no k-means), so the append below extends it and the next
            # save persists its assignments; no recall probe for an add
            self._ensure_ivf(probe=False)
        prepared = prepare_for_metric(x, self.metric, self._whitener)
        if self._rescore_host is not None:  # codes and words both grow
            self._rescore_host = np.concatenate(
                [self._rescore_host, self._requantize(prepared).cpu().numpy()]
            )
            if self.store_dtype == "int4":
                prepared = sq4_quantize_with_scale(prepared, self._sq4_scale)
            else:
                prepared = binary_quantize(prepared)
        elif self.store_dtype == "int8":
            prepared = self._requantize(prepared)
        else:
            prepared = prepared.to(self._corpus.dtype)
        self._corpus = self._place(
            torch.cat([self._rows(), prepared]).contiguous())
        self._corpus_n += int(x.shape[0])
        if not isinstance(self.texts, list):  # lazy store: materialise
            self.texts = list(self.texts)
        self.texts.extend(texts)
        self.doc_ids.extend(new_ids)
        self.metadata = extend_aligned_metadata(
            self.metadata, start, metadata, len(texts)
        )
        ivf = self._ivf_index
        self._mark_mutated()
        if ivf is not None and self._ivf_append_budget(m):
            # the new rows go to the existing centroids, in blocks appended
            # at the tail; earlier rows keep their ids, so the layout stays
            self._ivf_index = ivf_ops.ivf_append(
                ivf, prepared, start,
                dim=self._dim if self._rescore_host is not None else 0)
            self._ivf_appended += m
        if self.index_path:
            self._save(self.index_path)

    def remove(self, doc_ids: Sequence) -> int:
        """Remove every row whose doc_id is listed; returns the number of
        rows dropped (unknown ids are ignored). The survivors are gathered
        on the device with one ``index_select`` (the binary store's codes
        follow on the host), and the whitener and SQ8 scale stay, so a
        survivor's score does not change. Persists when ``index_path`` is
        set; refuses to empty the index."""
        if not self.is_built:
            raise RuntimeError("build() the index before remove()")
        drop = set(doc_ids)
        keep = [i for i, d in enumerate(self.doc_ids) if d not in drop]
        removed = self._corpus_n - len(keep)
        if removed == 0:
            return 0
        if not keep:
            raise ValueError(
                "remove() would drop every document; rebuild the index "
                "instead of emptying it live"
            )
        self._corpus = self._place(torch.index_select(
            self._rows(), 0,
            torch.as_tensor(keep, dtype=torch.long, device=self.device),
        ))
        if self._rescore_host is not None:
            self._rescore_host = np.ascontiguousarray(
                self._rescore_host[np.asarray(keep, dtype=np.int64)]
            )
        self._corpus_n = len(keep)
        if not isinstance(self.texts, list):
            self.texts = list(self.texts)
        self.texts = [self.texts[i] for i in keep]
        self.doc_ids = [self.doc_ids[i] for i in keep]
        if self.metadata is not None:
            self.metadata = [self.metadata[i] for i in keep]
        self._mark_mutated()
        if self.index_path:
            self._save(self.index_path)
        return removed

    def _mark_mutated(self) -> None:
        """After a live add/remove the build's corpus_digest no longer
        describes the store: drop it (nothing may take the mutated index
        for the original corpus) and count the mutation; every compiled
        filter mask is stale."""
        if self.fingerprint:
            fp = dict(self.fingerprint)
            fp.pop("corpus_digest", None)
            fp["live_mutations"] = int(fp.get("live_mutations", 0) or 0) + 1
            self.fingerprint = fp
            self._loaded_fingerprint = dict(fp)
        if self._filter_cache is not None:
            self._filter_cache.clear()
        # the IVF layout indexes rows by position: any mutation stales it
        self._ivf_index = self._ivf_recall_estimate = self._ivf_sidecar = None

    def _ivf_append_budget(self, m: int, n_total: int | None = None) -> bool:
        """Whether ``m`` more rows may be appended to the IVF: each append
        pads at least one block a touched list, so past a quarter of the
        corpus appended the next eligible search rebuilds instead.
        ``n_total`` is the corpus size to judge by (before an add lands)."""
        denom = self._corpus_n if n_total is None else n_total
        return (self._ivf_appended + m) * 4 <= denom

    def _requantize(self, prepared: torch.Tensor) -> torch.Tensor:
        """SQ8 codes at the existing scale, so old and new codes compare."""
        return torch.clamp(
            torch.round(prepared.float() / self._corpus_scale), -127, 127
        ).to(torch.int8)

    # --------------------------------------------------------------- search

    def _search_prepared(self, q: torch.Tensor, k: int, mask=None,
                         allow_ivf: bool = True, nprobe: int | None = None):
        """Top-k of queries already in the prepared space: (scores [Q, k]
        f32, indices [Q, k]), tensors on the device (host numpy from the
        cascade stores). ``mask`` (the packed int32 words of the allowed
        rows) restricts eligibility; slots no allowed row fills score
        NEG_INF. ``allow_ivf=False`` keeps the search exhaustive (the
        self-check and the recall probe's reference); ``nprobe`` pins the
        IVF's probe budget."""
        backend = self._resolve_backend()
        pinned = nprobe is not None
        if allow_ivf and self._ivf_eligible(q.shape[0], backend,
                                            pinned=pinned):
            return self._ivf_search(q, k, mask, nprobe)
        if self._rescore_host is not None:
            ivf = allow_ivf and self._ivf_eligible(
                q.shape[0], backend, binary=True, pinned=pinned)
            return self._search_cascade(q, k, mask, ivf, nprobe)
        return self._topk(q, k, self._effective_recall_target(k), mask)

    def _topk(self, q: torch.Tensor, k: int, rt: float, mask=None):
        """One exhaustive search of the store by its route
        (``ops.store_search.store_topk``: the float stores by the
        configured backend, the int8 store, the cascades' stage 1 with -1
        in the slots no allowed row fills): on the device, or on each shard
        of the mesh with the candidates merged (global int64 ids)."""
        store = ("float" if self.store_dtype in ("float32", "bfloat16")
                 else self.store_dtype)
        scale = (self._sq4_scale if store == "int4"
                 else self._corpus_scale if store == "int8" else None)
        backend = self._resolve_backend()

        def search(qd, corpus, kk, m):
            return store_topk(
                qd, corpus, kk, store=store, backend=backend,
                metric=self.metric, recall_target=rt,
                block_size=self.block_size, mask=m, scale=scale,
                d=self._dim)

        if self.mesh is None:
            return search(q, self._corpus, k, mask)
        return sharded_search(search, prepare_queries(q, store),
                              self._corpus, self._corpus_n, k, mask)

    def _stage1(self, q: torch.Tensor, ok: int, rt: float, mask=None):
        """The cascades' exhaustive stage 1: ``ok`` candidates by sign-dot
        or int4 score (the fold or exact kernels on the card, the plain
        exact search on the CPU, each shard of a mesh); slots no allowed
        row fills are -1."""
        return self._topk(q, ok, rt, mask)

    def _search_cascade(self, q: torch.Tensor, k: int, mask=None,
                        ivf: bool = False, nprobe: int | None = None):
        """The binary and int4 stores: stage 1 takes
        ``binary_oversample`` x k candidates by sign-dot or int4 score on
        the device (through the IVF with ``ivf``, at ``nprobe`` if
        pinned), stage 2 rescores them exactly on the host against the
        SQ8 codes. The recall target is k's, not the
        candidates'. Stage 1 takes the filter's mask and gives -1 in the
        slots no allowed row fills, which the rescore cannot revive.
        Returns host numpy (scores, ids), with (-inf, -1) in empty
        slots."""
        ok = min(self.binary_oversample * k, self._corpus_n)
        q = q.float().contiguous()
        if ivf:  # stage 1 through the IVF
            _, cand = self._ivf_search(q, ok, mask, nprobe)
        else:
            _, cand = self._stage1(q, ok, self._effective_recall_target(k),
                                   mask)
        return exact_rescore_topk(
            q.cpu().numpy(), lambda idx: self._rescore_host[idx],
            cand.cpu().numpy(), k, metric="dot", scale=self._corpus_scale,
        )

    # ----------------------------------------------------------- device IVF

    def _ivf_eligible(self, nq: int, backend: str, *, binary: bool = False,
                      pinned: bool = False) -> bool:
        """Route this search through the device IVF? Small batches only
        (at most ``ivf_query_limit`` queries) over corpora of at least
        ``IVF_MIN_ROWS`` rows, on the approximate backend (``xla``) for
        the float and int8 stores, or as a cascade's stage 1
        (``binary=True``). A pinned budget (``ivf_nprobe``, a search's
        ``nprobe``) goes; otherwise the batch's estimated probe rows
        (nq x auto nprobe x cap) must stay within a quarter of the sweep's
        n rows, as the JAX package's rule sets it."""
        if not (self.ivf_nlist > 0 and nq <= self.ivf_query_limit
                and self._corpus_n >= self.IVF_MIN_ROWS):
            return False
        if not binary and not (backend == "xla"
                               and self._rescore_host is None):
            return False
        if pinned or self.ivf_nprobe:
            return True
        rows = self._corpus_n
        nprobe_est = ivf_ops.auto_nprobe(max(1, rows // self.ivf_cap))
        return nq * nprobe_est * self.ivf_cap <= rows // 4

    def _ensure_ivf(self, probe: bool = True):
        """The IVF, built if there is none: from the warm boot's sidecar
        (a regrouping, no k-means) or by k-means over the store; then, with
        ``probe``, the recall probe (skipped for a restore whose estimate
        was persisted)."""
        if self._ivf_index is not None:
            return self._ivf_index
        t0 = time.perf_counter()
        info: dict = {}
        corpus = self._corpus[: self._corpus_n]
        restored = self._ivf_sidecar is not None
        if restored:
            cent, assign = self._ivf_sidecar
            self._ivf_index = ivf_ops.ivf_build_from_assign(
                corpus, cent, assign, self.ivf_cap)
        elif self.store_dtype == "int4":
            self._ivf_index = ivf_ops.ivf_build_sq4(
                corpus, self._dim, self.ivf_nlist, self.ivf_cap,
                timings=info)
        elif self._rescore_host is not None:
            self._ivf_index = ivf_ops.ivf_build_binary(
                corpus, self._dim, self.ivf_nlist, self.ivf_cap,
                timings=info)
        else:
            self._ivf_index = ivf_ops.ivf_build(
                corpus, self.ivf_nlist, self.ivf_cap, timings=info)
        self._ivf_appended = 0
        force_completion(self._ivf_index.blocks)
        info["build_s"] = time.perf_counter() - t0
        info["restored"] = restored
        log.info(
            "device IVF %s: nblocks=%d cap=%d in %.2fs",
            "restored from sidecar (no k-means)" if restored else "built",
            self._ivf_index.nblocks, self.ivf_cap, info["build_s"],
        )
        if probe and self.ivf_selfcheck and not (
                restored and self._ivf_recall_estimate is not None):
            t0 = time.perf_counter()
            self._ivf_recall_estimate = self._ivf_recall_probe(
                self._ivf_index)
            info["probe_s"] = time.perf_counter() - t0
            r_est = self._ivf_recall_estimate
            if r_est is not None:
                (log.warning if r_est < 0.8 else log.info)(
                    "device IVF candidate recall ~%.3f@10 at the configured "
                    "probe budget (%d corpus-row probes)%s",
                    r_est, min(self.ivf_selfcheck, self._corpus_n),
                    "" if r_est >= 0.8 else
                    " — weakly clustered corpus for this budget: raise "
                    "retrieval.ivf_nprobe or disable ivf_nlist",
                )
        self._ivf_build_info = info
        return self._ivf_index

    def _ivf_scale(self):
        """The scale of the IVF's blocks: the int4 nibbles', the int8
        codes' (None for float blocks and sign words)."""
        if self.store_dtype == "int4":
            return self._sq4_scale
        if self._rescore_host is not None:
            return None
        return self._corpus_scale

    def _ivf_probe_queries(self, rows: np.ndarray) -> torch.Tensor:
        """Prepared-space fp32 queries rebuilt from stored rows (the int4
        nibbles and the cascades' SQ8 codes dequantized)."""
        idx = torch.as_tensor(rows, dtype=torch.long, device=self.device)
        if self.store_dtype == "int4":
            return sq4_unpack(self._corpus[idx], self._dim).float() \
                * self._sq4_scale
        if self._rescore_host is not None:
            return torch.from_numpy(
                self._rescore_host[rows].astype(np.float32)).to(
                self.device) * self._corpus_scale
        q = self._corpus[idx].float()
        if self._corpus_scale is not None:  # int8 codes
            q = q * self._corpus_scale
        return q

    def _ivf_recall_probe(self, idx) -> float | None:
        """Candidate recall@10 of the configured probe budget on a sample
        of corpus rows as queries, against the exhaustive route of the same
        store (the cascades: stage 1 against stage 1). A corpus property,
        logged and served as ``ivf_recall_estimate``; corpus rows as probes
        flatter it a little (their own row sits in a probed list)."""
        if self.metric not in ("cosine", "dot"):
            return None
        n = self._corpus_n
        s = max(2, min(self.ivf_selfcheck, n))
        rows = np.linspace(0, n - 1, s).astype(np.int32)
        q = self._ivf_probe_queries(rows)
        kk = min(10, n)
        if self._rescore_host is not None:
            _, ref = self._stage1(q, kk, self._effective_recall_target(kk))
        else:
            _, ref = self._search_prepared(q, kk, allow_ivf=False)
        _, est = ivf_ops.ivf_search(
            q, idx, k=kk,
            nprobe=min(self.ivf_nprobe or ivf_ops.auto_nprobe(idx.nblocks),
                       idx.nblocks),
            metric=self.metric, scale=self._ivf_scale(),
            dim=self._dim if self._rescore_host is not None else 0)
        ref, est = ref.cpu().numpy(), est.cpu().numpy()
        hits = sum(len(set(a.tolist()) & set(b.tolist()))
                   for a, b in zip(est, ref))
        return hits / ref.size

    def _ivf_search(self, q: torch.Tensor, k: int, mask,
                    nprobe_override: int | None = None):
        """The IVF's top-k, (scores, ids) on the device, -1 in empty slots.
        A per-search ``nprobe`` is bucketed up to the next power of two and
        clamped to the blocks, as the JAX package buckets it; the wide
        path's list expansion takes the layout's largest list."""
        idx = self._ensure_ivf()
        if nprobe_override:
            nprobe = min(1 << (int(nprobe_override) - 1).bit_length(),
                         idx.nblocks)
        else:
            nprobe = self.ivf_nprobe or ivf_ops.auto_nprobe(idx.nblocks)
        if self._ivf_mlb is None or self._ivf_mlb[0] is not idx.block2list:
            b2l = idx.block2list.cpu().numpy()
            real = b2l[b2l >= 0]
            mlb = int(np.bincount(real).max()) if real.size else 1
            self._ivf_mlb = (idx.block2list, mlb)
        return ivf_ops.ivf_search(
            q, idx, k=min(k, self._corpus_n), nprobe=nprobe,
            metric=self.metric, scale=self._ivf_scale(), mask=mask,
            dim=self._dim if self._rescore_host is not None else 0,
            max_list_blocks=self._ivf_mlb[1])

    def _filter_device_mask(self, spec: dict) -> torch.Tensor:
        """The row mask of a filter spec on the device, compiled once per
        canonical spec and cached: ``pack_mask``'s little-endian bytes,
        padded to whole words and viewed as int32 [ceil(N/32)] (bit
        ``r & 31`` of word ``r >> 5`` is row r), the form the kernels
        read; with a mesh, each shard's words (a ``ShardedRows``)."""
        key = canonical_filter_key(spec)
        if self._filter_cache is None:
            self._filter_cache = FilterCache()
        m = self._filter_cache.get(key)
        if m is None:
            host = compile_filter_mask(
                spec, self.doc_ids, self.metadata, self._corpus_n
            )
            if self.mesh is None:
                packed = pack_mask(host)
                words = np.pad(packed, (0, (-packed.size) % 4)).view("<i4")
                m = torch.from_numpy(words.copy()).to(self.device)
            else:
                # sharded like the rows (pads False); each shard packs its
                # own rows' words, as a shard need not start a word
                m = shard_rows(torch.from_numpy(np.asarray(host, bool)),
                               self.mesh)
                m.shards = [pack_row_mask(x) for x in m.shards]
            self._filter_cache.put(key, m)
        return m

    def search(self, queries, k: int, filter: dict | None = None,
               nprobe: int | None = None):
        """Batched top-k. queries: [Q, D] in the raw embedding space (numpy
        or a tensor). Returns (scores [Q, k], indices [Q, k]) as numpy.
        ``filter`` (``retrieval.filtering``'s spec) restricts the search
        to the rows it allows. ``nprobe`` (device-IVF stores) pins this
        search's probe budget: it passes the traffic guard (not the query
        limit), is bucketed up to a power of two and clamped to the blocks,
        and is ignored without an IVF. Slots with no candidate (a filter
        that allows fewer than k rows, a small probe budget) come back as
        (NEG_INF, -1): skip ids < 0 before indexing texts or doc_ids."""
        if not self.is_built:
            raise RuntimeError("index not built")
        t0 = time.perf_counter()
        mask = self._filter_device_mask(filter) if filter is not None else None
        q = torch.as_tensor(queries).to(self.device, torch.float32)
        q = prepare_for_metric(q, self.metric, self._whitener)
        s, i = self._search_prepared(q, k, mask, nprobe=nprobe)
        if isinstance(s, torch.Tensor):  # the cascades return numpy
            s, i = s.float().cpu().numpy(), i.cpu().numpy()
        i = i.astype(np.int64)
        i = np.where(s > NEG_INF * 0.5, i, -1)
        self.stats.add_search_batch(time.perf_counter() - t0, q.shape[0])
        return s, i

    def retrieve(self, query_emb, top_k: int = 5, filter: dict | None = None):
        """Single query -> (texts, scores, doc_ids)."""
        q = np.asarray(query_emb, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        scores, idx = self.search(q, top_k, filter=filter)
        sel = [int(j) for j in idx[0] if j >= 0]
        return (
            [self.texts[j] for j in sel],
            scores[0][: len(sel)].tolist(),
            [self.doc_ids[j] for j in sel],
        )

    def get_stats(self, reset: bool = False) -> dict:
        return self.stats.get(reset)

    def compatible_with(self, fingerprint: dict) -> bool:
        return self.fingerprint == fingerprint

    # ---------------------------------------------------------- persistence

    def _save(self, path: str, eager_ivf: bool = False) -> None:
        """Write the store, each sidecar atomically, meta.json last with
        the sampled digest of every array it pairs with. With an IVF
        (``ivf_nlist`` over at least ``IVF_MIN_ROWS`` rows) its centroids
        and assignments persist too: a live IVF always, and at ``build``'s
        save (``eager_ivf``) one is built first where searches can route
        through it, so that warm boots skip k-means."""
        n = self._corpus_n
        mesh = self.mesh
        # across processes each writes its own shards and process 0 the
        # rest; the gathers and the sharded save are collectives, so every
        # process takes them first
        lead = mesh is None or mesh.rank == 0
        if lead:
            os.makedirs(path, exist_ok=True)
        stored_digests: dict[str, str] = {}
        sharded_generation = None
        if self._rescore_host is not None:
            # the cascades persist their usual files, a mesh's gathered
            packed = self._rows().cpu().numpy()
        elif mesh is not None:
            # each process writes its own shards; a random generation tag
            # in both metas catches a crash between the two writes
            sharded_generation = secrets.token_hex(8)
            save_sharded_index(
                os.path.join(path, "sharded"), self._corpus,
                {"n": n, "store_dtype": self.store_dtype,
                 "generation": sharded_generation})
        if not lead:
            barrier()  # returns once process 0 has written meta.json
            return
        if self._rescore_host is not None:  # cascade store
            # the words and nibbles persist verbatim (re-deriving them from
            # the dequantized rows would flip the signs of values that round
            # to code 0, and re-derive the nibbles' scale), the words as
            # uint32, the JAX package's dtype
            int4 = self.store_dtype == "int4"
            if not int4:
                packed = packed.view(np.uint32)
            pk_name = "sq4_packed.npy" if int4 else "binary_packed.npy"
            scale = np.asarray(self._corpus_scale, dtype=np.float32)
            corpus_arr = (
                self._rescore_host[:n].astype(np.float32)
                * float(self._corpus_scale)
            )
            atomic_save(os.path.join(path, pk_name), packed)
            atomic_save(os.path.join(path, "sq8_scale.npy"), scale)
            atomic_save(os.path.join(path, "corpus.npy"), corpus_arr)
            stored_digests.update({
                pk_name: _stored_digest(packed),
                "sq8_scale.npy": _stored_digest(scale),
                "corpus.npy": _stored_digest(corpus_arr),
            })
            if int4:
                s4 = np.asarray(self._sq4_scale, dtype=np.float32)
                atomic_save(os.path.join(path, "sq4_scale.npy"), s4)
                stored_digests["sq4_scale.npy"] = _stored_digest(s4)
                _drop_stale(path, "sharded", "binary_packed.npy")
            else:
                _drop_stale(path, "sharded", "sq4_packed.npy",
                            "sq4_scale.npy")
        elif mesh is not None:  # the rows went to sharded/ above
            if self._corpus_scale is not None:  # the int8 codes' scale
                scale = np.asarray(self._corpus_scale, dtype=np.float32)
                atomic_save(os.path.join(path, "sq8_scale.npy"), scale)
                stored_digests["sq8_scale.npy"] = _stored_digest(scale)
            else:
                _drop_stale(path, "sq8_scale.npy")
            _drop_stale(path, "binary_packed.npy", "corpus.npy",
                        "sq4_packed.npy", "sq4_scale.npy")
        else:
            if self.store_dtype == "int8":  # dequantized fp32
                corpus_arr = (self._corpus[:n].cpu().numpy()
                              .astype(np.float32) * float(self._corpus_scale))
            else:
                corpus_arr = self._corpus[:n].float().cpu().numpy()
            atomic_save(os.path.join(path, "corpus.npy"), corpus_arr)
            stored_digests["corpus.npy"] = _stored_digest(corpus_arr)
            _drop_stale(path, "binary_packed.npy", "sq8_scale.npy", "sharded",
                        "sq4_packed.npy", "sq4_scale.npy")
        if self._whitener is not None:
            wh = self._whitener.float().cpu().numpy()
            atomic_save(os.path.join(path, "whitener.npy"), wh)
            stored_digests["whitener.npy"] = _stored_digest(wh)
        else:
            _drop_stale(path, "whitener.npy")
        eager_ok = eager_ivf and (self._rescore_host is not None
                                  or self._resolve_backend() == "xla")
        ivf_saved = (self.ivf_nlist > 0 and n >= self.IVF_MIN_ROWS
                     and (self._ivf_index is not None or eager_ok))
        if ivf_saved:
            if self._ivf_index is None:
                log.info("building device IVF at save time so warm boots "
                         "skip k-means (retrieval.ivf_nlist=%d)",
                         self.ivf_nlist)
            idx = self._ensure_ivf()
            cent = idx.centroids.float().cpu().numpy()
            assign = ivf_ops.ivf_assignments(idx, n).cpu().numpy().astype(
                np.int32)
            atomic_save(os.path.join(path, "ivf_centroids.npy"), cent)
            atomic_save(os.path.join(path, "ivf_assign.npy"), assign)
            stored_digests["ivf_centroids.npy"] = _stored_digest(cent)
            stored_digests["ivf_assign.npy"] = _stored_digest(assign)
        else:
            _drop_stale(path, "ivf_centroids.npy", "ivf_assign.npy")
        ids_as_npy = save_texts(
            os.path.join(path, "texts"), self.texts, self.doc_ids
        )
        metadata_digest = save_metadata_sidecar(
            os.path.join(path, "metadata.jsonl"), self.metadata
        )
        meta = {
            "fingerprint": self.fingerprint,
            "metric": self.metric,
            "n": n,
            "stored_digests": stored_digests,
        }
        if metadata_digest is not None:
            meta["metadata_digest"] = metadata_digest
        if ivf_saved:
            # a restore regroups with the same cap; another nlist re-clusters
            meta["ivf_cap"] = self.ivf_cap
            meta["ivf_nlist"] = self.ivf_nlist
            if self._ivf_recall_estimate is not None:
                meta["ivf_recall_estimate"] = float(self._ivf_recall_estimate)
        if sharded_generation is not None:
            meta["sharded_generation"] = sharded_generation
        if not ids_as_npy:
            meta["doc_ids"] = list(self.doc_ids)
        tmp = os.path.join(path, "meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(path, "meta.json"))
        if mesh is not None:
            barrier()  # the other processes return after this
        log.info("index persisted to %s (n=%d)", path, n)

    def _save_metadata_only(self, path: str) -> None:
        """Rewrite only the metadata sidecar and its digest in meta.json
        (build() found the index itself compatible); meta.json still lands
        last."""
        meta_path = os.path.join(path, "meta.json")
        if not os.path.exists(meta_path):  # the store vanished: full save
            self._save(path)
            return
        if self.mesh is not None and self.mesh.rank != 0:
            barrier()  # process 0 writes; the others wait for it
            return
        with open(meta_path) as f:
            meta = json.load(f)
        digest = save_metadata_sidecar(
            os.path.join(path, "metadata.jsonl"), self.metadata
        )
        if digest is None:
            meta.pop("metadata_digest", None)
        else:
            meta["metadata_digest"] = digest
        tmp = meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, meta_path)
        if self.mesh is not None:
            barrier()

    def _read(self, path: str) -> _Store:
        """Validate the store at ``path`` on the host: meta.json, the text
        store's counts and generation tags, the sampled digests of every
        recorded sidecar, the metadata digest and the corpus's row count.
        Raises on any inconsistency; touches neither the device nor this
        retriever."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        lazy_texts, lazy_ids = load_texts(os.path.join(path, "texts"))
        if lazy_texts is not None:
            texts = lazy_texts
            doc_ids = lazy_ids if lazy_ids is not None else meta["doc_ids"]
        else:  # legacy store: texts inlined in meta.json
            texts = meta["texts"]
            doc_ids = meta["doc_ids"]
        n = int(meta["n"])
        if len(texts) != n or len(doc_ids) != len(texts):
            raise ValueError(
                f"text store holds {len(texts)} texts / {len(doc_ids)} "
                f"doc_ids but the index records n={n}; mixed-generation "
                "store"
            )
        verify_stored_digests(path, meta)
        mpath = os.path.join(path, "metadata.jsonl")
        want_md = meta.get("metadata_digest")
        metadata = load_metadata_sidecar(mpath, want_md, n)
        if want_md is None and os.path.exists(mpath):
            log.warning(
                "ignoring unrecorded metadata.jsonl at %s (no digest in "
                "meta.json); rebuild with metadata= to restore filtering",
                path,
            )
        wpath = os.path.join(path, "whitener.npy")
        whitener = np.load(wpath) if os.path.exists(wpath) else None
        # corpus.npy holds the prepared rows; a sharded store has
        # sharded/ in its place
        cpath = os.path.join(path, "corpus.npy")
        spath = os.path.join(path, "sharded")
        if not os.path.exists(cpath) and os.path.isdir(spath):
            # its meta and shard headers against meta.json; the JAX
            # package's Orbax layout raises
            smeta = read_sharded_meta(spath, n,
                                      meta.get("sharded_generation"))
            if len(smeta["row_shape"]) != 1:
                raise ValueError("sharded store rows are not vectors")
            corpus = None
            dim = int(smeta["row_shape"][0])
        else:
            corpus = np.load(cpath, mmap_mode="r")
            if corpus.ndim != 2 or corpus.shape[0] != n:
                raise ValueError("meta/corpus row mismatch")
            dim = int(corpus.shape[1])
        store = _Store(
            texts=texts, doc_ids=list(doc_ids), metadata=metadata,
            metric=meta.get("metric", self.metric),
            fingerprint=meta.get("fingerprint"), n=n, dim=dim, rows=corpus,
            whitener=whitener,
        )
        self._read_ivf_sidecar(path, meta, store)
        if corpus is None:
            sq8 = os.path.join(path, "sq8_scale.npy")
            if smeta["dtype"] == "int8":  # the codes' scale
                store.scale = float(np.load(sq8))
            if self.store_dtype not in CASCADES:  # read by _adopt
                store.sharded = (spath, smeta)
                return store
            corpus = self._sharded_host_rows(spath, smeta, store.scale)
        if self.store_dtype not in CASCADES:  # read off the mmap, once
            store.rows = np.array(corpus, dtype=np.float32)
            return store
        # a cascade store stays on the host until its packed rows go up
        if store.metric not in ("cosine", "dot"):
            raise ValueError(
                f"{self.store_dtype} store supports cosine/dot only")
        host = np.ascontiguousarray(corpus, dtype=np.float32)
        spath = os.path.join(path, "sq8_scale.npy")
        if os.path.exists(spath):
            scale = float(np.load(spath))
        else:
            scale = max(float(np.abs(host).max()) / 127.0, 1e-12)
            log.warning(
                "binary index at %s has no sq8_scale.npy — re-deriving "
                "the scale from the stored corpus; SQ8 rescoring may "
                "differ from the original build (save again to pin it)",
                path,
            )
        store.scale = float(np.float32(scale))  # the JAX store's fp32
        store.rescore = np.clip(np.round(host / scale), -127, 127).astype(
            np.int8)
        if self.store_dtype == "int4":
            store.rows, store.sq4_scale = self._read_nibbles(path, host)
            return store
        ppath = os.path.join(path, "binary_packed.npy")
        if os.path.exists(ppath):  # bit-stable packed store
            words = np.load(ppath)
            if words.shape != (n, -(-store.dim // 32)):
                raise ValueError("binary_packed.npy shape mismatch")
        else:  # legacy or cross-tier store: pack on the host
            log.warning(
                "binary index at %s predates binary_packed.npy — "
                "repacking sign bits from the fp store; exact-zero "
                "values may flip sign vs the original build (rankings "
                "not bit-stable; save again to pin them)",
                path,
            )
            d = host.shape[1]
            padded = np.concatenate(
                [host >= 0, np.zeros((host.shape[0], (-d) % 32), bool)],
                axis=1,
            )
            words = np.packbits(
                padded.reshape(host.shape[0], -1, 32), axis=-1,
                bitorder="little",
            ).view(np.uint32)[:, :, 0]
        # int32 with the same bits: torch's uint32 has no shifts
        store.rows = np.ascontiguousarray(words).view(np.int32)
        return store

    @staticmethod
    def _sharded_host_rows(spath: str, smeta: dict, scale) -> np.ndarray:
        """A ``sharded/`` store's rows on the host as fp32 (int8 codes
        dequantized with their ``scale``): the rows a cascade keeps
        there."""
        rows, _ = load_sharded_index(spath, device="cpu", meta=smeta)
        rows = rows[: int(smeta["n"])].float()
        if scale is not None:
            rows = rows * scale
        return rows.numpy()

    def _load_sharded(self, store: _Store):
        """A float or int8 ``sharded/`` store's rows as this retriever
        holds them, read from the shard files straight onto its devices
        (each shard of the mesh its own rows, or the first n rows on the
        one device), and their SQ8 scale (int8). Codes stay codes for an
        int8 store and are dequantized shard by shard for a float one; a
        float store read as int8 is quantized over all of its rows at
        once."""
        spath, smeta = store.sharded
        corpus, _ = load_sharded_index(spath, self.mesh, device=self.device,
                                       meta=smeta)
        if self.mesh is None:
            corpus = corpus[: store.n]
        stored_int8 = smeta["dtype"] == "int8"
        if self.store_dtype == "int8":
            if stored_int8:
                return corpus, store.scale
            rows = corpus if self.mesh is None else gather_rows(
                corpus, store.n, self.device)
            codes, scale = sq8_quantize(rows)
            return self._place(codes), float(scale)
        dtype = STORE_DTYPES[self.store_dtype]

        def cast(t):
            if stored_int8:
                t = t.float() * store.scale
            return t.to(dtype).contiguous()

        if self.mesh is None:
            return cast(corpus), None
        return ShardedRows([cast(t) for t in corpus.shards], self.mesh), None

    def _read_ivf_sidecar(self, path: str, meta: dict, store: _Store) -> None:
        """The IVF's persisted centroids and assignments (digests verified
        with the rest), taken only when this retriever asks for the same
        structure: the same nlist and cap, on one device (a mesh save's
        sidecar is per shard), one assignment a row."""
        if not (self.ivf_nlist > 0
                and "ivf_centroids.npy" in (meta.get("stored_digests") or {})
                and int(meta.get("ivf_cap", -1)) == self.ivf_cap
                and int(meta.get("ivf_nlist", -1)) == self.ivf_nlist
                and int(meta.get("ivf_mesh_p", -1)) == -1):
            return
        cent = np.load(os.path.join(path, "ivf_centroids.npy"))
        assign = np.load(os.path.join(path, "ivf_assign.npy"), mmap_mode="r")
        if assign.ndim != 1 or assign.shape[0] != store.n:
            return
        store.ivf_sidecar = (np.asarray(cent, dtype=np.float32),
                             np.ascontiguousarray(assign, dtype=np.int32))
        if meta.get("ivf_recall_estimate") is not None:
            store.ivf_recall_estimate = float(meta["ivf_recall_estimate"])

    @staticmethod
    def _read_nibbles(path: str, host: np.ndarray) -> tuple[np.ndarray,
                                                             float]:
        """The int4 store's nibbles and their scale: its sidecars, or,
        without them (a store of another tier), packed on the host from the
        stored rows with a re-derived scale, as the JAX package's load
        does."""
        ppath = os.path.join(path, "sq4_packed.npy")
        spath4 = os.path.join(path, "sq4_scale.npy")
        if os.path.exists(ppath) and os.path.exists(spath4):
            packed = np.load(ppath)
            if (packed.dtype != np.uint8
                    or packed.shape != (host.shape[0], -(-host.shape[1] // 2))):
                raise ValueError("sq4_packed.npy shape or dtype mismatch")
            return packed, float(np.load(spath4))
        log.warning(
            "int4 index at %s lacks sq4 sidecars — packing "
            "nibbles from the fp store with a re-derived "
            "scale; stage-1 candidates may differ from the "
            "original build (save again to pin them)",
            path,
        )
        # the JAX load's scale, a double divided in numpy as its fp32 value
        s4 = float(np.float32(max(float(np.abs(host).max()) / 7.0, 1e-12)))
        return sq4_quantize_with_scale(torch.tensor(host), s4).numpy(), s4

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _adopt(self, store: _Store) -> None:
        """Take a validated store: its arrays go to the device first, then
        every field is set."""
        whitener = (None if store.whitener is None
                    else self._upload(store.whitener.astype(np.float32)))
        if store.sharded is not None:
            corpus, scale = self._load_sharded(store)
        else:
            rows = self._upload(store.rows)
            scale = store.scale
            if self.store_dtype == "int8":
                # the stored rows, re-quantized
                rows, scale = sq8_quantize(rows)
                scale = float(scale)
            elif self.store_dtype not in QUANTIZED:
                rows = rows.to(STORE_DTYPES[self.store_dtype]).contiguous()
            corpus = self._place(rows)
        self._corpus = corpus
        self._whitener = whitener
        self.texts = store.texts
        self.doc_ids = store.doc_ids
        self.metadata = store.metadata
        self.metric = store.metric
        self.fingerprint = store.fingerprint
        self._loaded_fingerprint = store.fingerprint
        self._corpus_n = store.n
        self._dim = store.dim
        self._rescore_host = store.rescore
        self._corpus_scale = scale
        self._sq4_scale = store.sq4_scale
        self._ivf_index = None
        self._ivf_appended = 0
        self._ivf_sidecar = store.ivf_sidecar
        self._ivf_recall_estimate = store.ivf_recall_estimate
