"""Retriever over the C++ ANN tiers (HNSW / IVF-PQ).

The port of the JAX package's ``retrieval/ann_retriever.py``: the C++
indexes behind the batch-first ``search`` / ``retrieve`` / ``get_stats``
surface of ``DenseRetriever``, chosen by ``retrieval.backend``. Searches
run on the host in C++. The device builds the indexes where the config
asks for it, or where ``auto`` meets a CUDA device:

* ``hnsw_build=knn``: every row's k-NN list by ``ops.knn.knn_graph`` on
  the retriever's device (the fold kernel on the card; with more than one
  visible card ``parallel.sharded_knn_graph`` over all of them), then the
  graph's assembly in C++ (``HNSWIndex.from_knn``); ``beam``:
  per-insertion beam searches in C++;
* ``ivfpq_build=device``: coarse quantizer, PQ codebooks and every row's
  codes by ``ops.kmeans`` on the device, lists assembled in C++;
  ``host``: the C++ trainer on a subsample.

On a CUDA device the device builds run on the card or raise; none drops
to the host build. Index files and their sidecars (``.meta.json``,
``.texts``, ``.metadata.jsonl``, ``.refine.npy``) are the JAX package's,
so a store built by either package warm-boots in the other.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Sequence

import numpy as np
import torch

from ..utils.config import RetrievalConfig
from ..utils.device import resolve_device
from ..utils.timing import StatsTracker
from .ann import HNSWIndex, IVFPQIndex

log = logging.getLogger("latentrag_torch.retrieval")


def _normalize_rows(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(n, 1e-12)


def _host(x) -> np.ndarray:
    """Embeddings (numpy, or a tensor on any device) as host float32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.ascontiguousarray(x, dtype=np.float32)


class ANNRetriever:
    """HNSW or IVF-PQ over (optionally normalized) embeddings."""

    # the metrics each C++ scorer ranks correctly: HNSW scores inner
    # products (cosine via normalization, raw dot); IVF-PQ scores -L2
    # (euclidean; cosine via normalization, where argmin L2 is argmax
    # cosine on unit rows). Anything else would rank wrongly.
    _SUPPORTED = {
        "hnsw": ("cosine", "dot"),
        "ivfpq": ("cosine", "euclidean"),
    }

    def __init__(self, cfg: RetrievalConfig, kind: str, device="cuda"):
        if kind not in ("hnsw", "ivfpq"):
            raise ValueError(f"unknown ANN kind {kind!r}")
        if cfg.metric not in self._SUPPORTED[kind]:
            raise ValueError(
                f"{kind} backend cannot rank metric {cfg.metric!r} "
                f"(supports {self._SUPPORTED[kind]}); use backend='dense' "
                f"for euclidean/mahalanobis exact search"
            )
        self.cfg = cfg
        self.kind = kind
        self.device = resolve_device(device)
        self.texts: list = []
        self.doc_ids: list = []
        # per-document metadata backing filter={"where": ...}
        self.metadata: list | None = None
        self.stats = StatsTracker()
        self._filter_cache = None  # packed bitsets a filter spec
        self._index = None
        self._normalize = cfg.metric == "cosine"
        # the fp32 corpus kept on the host for IVF-PQ's exact refine stage
        self._refine = (
            max(0, int(cfg.ivfpq_refine)) if kind == "ivfpq" else 0
        )
        self._refine_emb: np.ndarray | None = None
        # the latest build's stages in seconds (empty after a load)
        self.build_split: dict = {}

    def build(
        self,
        embeddings,
        texts: Sequence[str],
        doc_ids: Sequence | None = None,
        embedding_model: str | None = None,
        ae_type: str | None = None,
        metadata: Sequence[dict] | None = None,
        **_: object,
    ) -> None:
        if metadata is not None and len(metadata) != len(texts):
            raise ValueError(
                f"{len(metadata)} metadata entries for {len(texts)} texts"
            )
        emb = _host(embeddings)
        if self._normalize:
            emb = _normalize_rows(emb)
        self.texts = list(texts)
        self.doc_ids = (
            list(doc_ids) if doc_ids is not None else list(range(len(texts)))
        )
        self.metadata = list(metadata) if metadata is not None else None
        if self._filter_cache is not None:
            self._filter_cache.clear()
        mode = self._resolved_build_mode()
        fp = self._fingerprint(emb, mode)
        # the encoder's and AE's provenance: a warm boot under another
        # encoder or autoencoder must refuse this index
        fp["embedding_model"] = embedding_model
        fp["ae_type"] = ae_type
        self.build_split = {}
        t0 = time.perf_counter()
        if self._try_load(fp):
            if self.kind == "ivfpq" and self._refine > 1:
                self._refine_emb = emb
            self.stats.add_build(time.perf_counter() - t0)
            return
        split = {"mode": mode}
        if self.kind == "hnsw":
            ix = self._build_hnsw(emb, mode, split)
        else:
            ix = self._build_ivfpq(emb, mode, split)
            if self._refine > 1:
                self._refine_emb = emb
        self._index = ix
        self.build_split = split
        self.stats.add_build(time.perf_counter() - t0)
        self._save(fp)

    def _build_hnsw(self, emb: np.ndarray, mode: str, split: dict):
        cfg = self.cfg
        if mode != "knn":
            t0 = time.perf_counter()
            ix = HNSWIndex(emb.shape[1], M=cfg.hnsw_m,
                           ef_construction=cfg.hnsw_ef_construction,
                           ef_search=cfg.hnsw_ef_search)
            ix.add(emb)
            split["beam_s"] = time.perf_counter() - t0
            return ix
        # every row's k-NN list on the device (with more than one visible
        # card, the corpus shards travel a ring over all of them), then
        # the assembly in C++
        from ..ops import knn

        t0 = time.perf_counter()
        knn_k = cfg.hnsw_knn_k or 2 * cfg.hnsw_m
        knn_metric = "cosine" if self._normalize else "dot"
        if self.device.type == "cuda" and torch.cuda.device_count() > 1:
            from ..parallel import make_mesh, sharded_knn_graph

            ids = sharded_knn_graph(emb, knn_k, make_mesh(),
                                    metric=knn_metric)
        else:
            ids = knn.knn_graph(torch.tensor(emb, device=self.device),
                                knn_k, metric=knn_metric)
        t1 = time.perf_counter()
        ix = HNSWIndex.from_knn(emb, ids, M=cfg.hnsw_m,
                                ef_construction=cfg.hnsw_ef_construction,
                                ef_search=cfg.hnsw_ef_search)
        split.update(knn_s=t1 - t0, knn=dict(knn.last_split),
                     assemble_s=time.perf_counter() - t1)
        return ix

    def _build_ivfpq(self, emb: np.ndarray, mode: str, split: dict):
        cfg = self.cfg
        nlist = min(cfg.ivfpq_nlist, max(1, emb.shape[0] // 8))
        m = cfg.ivfpq_m
        while emb.shape[1] % m != 0:
            m //= 2
        ix = IVFPQIndex(emb.shape[1], nlist=nlist, m=m,
                        nbits=cfg.ivfpq_nbits)
        iters = cfg.ivfpq_train_iters
        t0 = time.perf_counter()
        if mode == "device":
            # coarse and PQ codebooks trained and every row encoded on the
            # device; the C++ index only assembles its lists
            from ..ops.kmeans import ivfpq_encode_device, ivfpq_train_device

            x = torch.tensor(emb, device=self.device)
            coarse, books = ivfpq_train_device(
                x, nlist, m, ksub=1 << cfg.ivfpq_nbits, iters=iters)
            ix.set_trained(coarse, books)
            t1 = time.perf_counter()
            assigns, codes = ivfpq_encode_device(x, coarse, books)
            t2 = time.perf_counter()
            ix.add_encoded(assigns, codes)
            split.update(train_s=t1 - t0, encode_s=t2 - t1,
                         add_s=time.perf_counter() - t2)
            return ix
        # the host trainer holds large corpora only by subsampling (64
        # rows a centroid, FAISS's max_points_per_centroid compromise)
        max_train = max(nlist * 64, 16384)
        if emb.shape[0] > max_train:
            sel = np.random.default_rng(0).choice(
                emb.shape[0], max_train, replace=False)
            ix.train(np.ascontiguousarray(emb[sel]), iters=iters)
        else:
            ix.train(emb, iters=iters)
        t1 = time.perf_counter()
        ix.add(emb)
        split.update(train_s=t1 - t0, add_s=time.perf_counter() - t1)
        return ix

    def add(
        self,
        embeddings,
        texts: Sequence[str],
        doc_ids: Sequence | None = None,
        metadata: Sequence[dict] | None = None,
    ) -> None:
        """Append documents to a built index (``DenseRetriever.add``'s
        surface). HNSW beam-inserts into the graph (a kNN-assembled one
        too); IVF-PQ encodes against its trained centroids and codebooks;
        neither retrains. The grown index persists under an
        ``incremental`` fingerprint that no build matches, so the next
        build over the grown corpus rebuilds."""
        if self._index is None:
            raise RuntimeError("add() before build()")
        emb = _host(embeddings)
        if emb.ndim != 2 or emb.shape[1] != self._index.dim:
            raise ValueError(f"expected [n, {self._index.dim}] embeddings")
        if metadata is not None and len(metadata) != len(texts):
            raise ValueError("metadata/texts row count mismatch")
        if self._normalize:
            emb = _normalize_rows(emb)
        base = len(self.texts)
        if not isinstance(self.texts, list):  # lazy store: materialise
            self.texts = list(self.texts)
        self.texts.extend(texts)
        self.doc_ids.extend(
            doc_ids if doc_ids is not None
            else range(base, base + len(texts))
        )
        from .filtering import extend_aligned_metadata

        self.metadata = extend_aligned_metadata(
            self.metadata, base, metadata, len(texts)
        )
        if self._filter_cache is not None:
            self._filter_cache.clear()
        t0 = time.perf_counter()
        self._index.add(emb)
        if self.kind == "ivfpq" and self._refine_emb is not None:
            self._refine_emb = np.concatenate([self._refine_emb, emb])
        self.stats.add_build(time.perf_counter() - t0)
        if self.cfg.index_path:
            # a grown index is not a fresh build over the grown corpus
            # (IVF-PQ's quantizers were trained on the base corpus only):
            # persisted for a manual load, never matched by a build
            self._save({"incremental": True, "kind": self.kind,
                        "n": len(self.texts)})

    # -- persistence: the index file plus a .meta.json fingerprint (build
    #    parameters and a corpus digest); a build whose fingerprint matches
    #    loads the file, anything else rebuilds

    def _index_file(self) -> str:
        return f"{self.cfg.index_path}.{self.kind}"

    def _resolved_build_mode(self) -> str:
        """``auto`` resolved from the retriever's device: ``knn`` /
        ``device`` on CUDA, ``beam`` / ``host`` on the CPU. A configured
        ``auto`` is fingerprinted as ``auto`` (see ``_fingerprint``)."""
        mode = (self.cfg.hnsw_build if self.kind == "hnsw"
                else self.cfg.ivfpq_build)
        if mode == "auto":
            on_acc = self.device.type == "cuda"
            mode = (("knn" if on_acc else "beam") if self.kind == "hnsw"
                    else ("device" if on_acc else "host"))
        return mode

    def _fingerprint(self, emb: np.ndarray, mode: str) -> dict:
        from .dense import _corpus_digest

        cfg = self.cfg
        configured = (cfg.hnsw_build if self.kind == "hnsw"
                      else cfg.ivfpq_build)
        fp: dict = {
            "kind": self.kind,
            "metric": cfg.metric,
            "normalize": self._normalize,
            "dim": int(emb.shape[1]),
            "n": int(emb.shape[0]),
            # under 'auto' an index built on one device keeps serving on
            # another; an explicit mode pins it
            "build": "auto" if configured == "auto" else mode,
            "corpus_digest": _corpus_digest(emb, self.texts),
        }
        if self.kind == "hnsw":
            fp.update(m=cfg.hnsw_m, ef_construction=cfg.hnsw_ef_construction)
            if mode == "knn" and configured != "auto":
                # the effective value, and only where the knn build reads it
                fp["knn_k"] = cfg.hnsw_knn_k or 2 * cfg.hnsw_m
        else:
            fp.update(nlist=cfg.ivfpq_nlist, pq_m=cfg.ivfpq_m,
                      nbits=cfg.ivfpq_nbits, iters=cfg.ivfpq_train_iters)
        return fp

    def _load_index(self, path: str):
        if self.kind == "hnsw":
            return HNSWIndex.load(path, ef_search=self.cfg.hnsw_ef_search)
        return IVFPQIndex.load(path)

    def _try_load(self, fp: dict) -> bool:
        if not self.cfg.index_path:
            return False
        path = self._index_file()
        meta_path = path + ".meta.json"
        if not (os.path.exists(path) and os.path.exists(meta_path)):
            return False
        try:
            with open(meta_path) as f:
                meta = json.load(f)
            if meta.get("fingerprint") != fp:
                log.info("%s index at %s: fingerprint mismatch, rebuilding",
                         self.kind, path)
                return False
            self._index = self._load_index(path)
            log.info("%s index loaded from %s (n=%d)", self.kind, path,
                     fp["n"])
            return True
        except (OSError, ValueError, json.JSONDecodeError) as e:
            log.warning("%s index at %s unreadable (%s); rebuilding",
                        self.kind, path, e)
            return False

    def _save(self, fp: dict) -> None:
        if not self.cfg.index_path:
            return
        from .textstore import atomic_save, save_metadata_sidecar, save_texts

        path = self._index_file()
        try:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._index.save(path)
            # texts and doc_ids ride their own sidecar so load_persisted
            # serves without the corpus; the refine corpus is its own npy
            # (memory-mapped at a warm boot); each written to a temporary
            # name and renamed, so a crash never destroys the valid one
            if self._refine_emb is not None:
                atomic_save(path + ".refine.npy", self._refine_emb)
            elif os.path.exists(path + ".refine.npy"):
                # a stale refine sidecar must not pair with this index
                os.remove(path + ".refine.npy")
            ids_as_npy = save_texts(path + ".texts", self.texts,
                                    self.doc_ids)
            meta = {"fingerprint": fp}
            if not ids_as_npy:
                meta["doc_ids"] = list(self.doc_ids)
            digest = save_metadata_sidecar(
                path + ".metadata.jsonl", self.metadata
            )
            if digest is not None:
                meta["metadata_digest"] = digest
            tmp = path + ".meta.json.tmp"
            with open(tmp, "w") as f:
                json.dump(meta, f)
            os.replace(tmp, path + ".meta.json")
        except OSError as e:  # persistence is best-effort; search works
            log.warning("could not persist %s index to %s: %s", self.kind,
                        path, e)

    def load_persisted(self, expect: dict | None = None) -> bool:
        """Warm boot: the index and its texts and doc ids from disk, with
        no embeddings in hand (so no digest check: the caller trusts the
        store it named). ``expect`` maps fingerprint keys
        (``embedding_model``, ``ae_type``, ...) to the values the caller
        serves with; a stored None matches anything, a stored
        contradiction refuses. False when the store is absent, unreadable,
        contradicted, or has no texts."""
        if not self.cfg.index_path:
            return False
        from .textstore import load_metadata_sidecar, load_texts

        path = self._index_file()
        meta_path = path + ".meta.json"
        if not (os.path.exists(path) and os.path.exists(meta_path)):
            return False
        try:
            with open(meta_path) as f:
                meta = json.load(f)
            lazy_texts, lazy_ids = load_texts(path + ".texts")
            if lazy_texts is None and "texts" not in meta:
                log.info("%s store at %s predates texts persistence; cold "
                         "boot required", self.kind, path)
                return False
            fp = meta.get("fingerprint") or {}
            for key, want in (expect or {}).items():
                have = fp.get(key)
                if have is not None and have != want:
                    log.warning("%s store %s=%r contradicts requested %r; "
                                "warm boot refused", path, key, have, want)
                    return False
            # everything is read into locals; self changes only once every
            # check has passed
            index = self._load_index(path)
            if lazy_texts is not None:
                texts = lazy_texts
                doc_ids = (
                    lazy_ids if lazy_ids is not None else meta["doc_ids"]
                )
            else:  # an older store: texts inline in meta.json
                texts = list(meta["texts"])
                doc_ids = list(meta["doc_ids"])
            if len(texts) != len(index) or len(doc_ids) != len(texts):
                log.warning(
                    "%s store at %s holds %d texts / %d doc_ids for %d "
                    "indexed vectors; cold boot required", self.kind, path,
                    len(texts), len(doc_ids), len(index),
                )
                return False
            metadata = load_metadata_sidecar(
                path + ".metadata.jsonl", meta.get("metadata_digest"),
                len(index),
            )
            refine_emb = None
            if self._refine > 1:
                rpath = path + ".refine.npy"
                if os.path.exists(rpath):
                    refine_emb = np.load(rpath, mmap_mode="r")
                    if refine_emb.shape[0] != len(index):
                        log.warning(
                            "%s refine sidecar holds %d rows for %d "
                            "indexed vectors; cold boot required", path,
                            refine_emb.shape[0], len(index),
                        )
                        return False
                else:
                    log.warning(
                        "%s: ivfpq_refine=%d requested but %s is missing; "
                        "serving unrefined ADC scores (rebuild to restore "
                        "refinement)", path, self._refine, rpath,
                    )
            self._index, self.texts, self.doc_ids = index, texts, doc_ids
            self.metadata = metadata
            self._refine_emb = refine_emb
            self.build_split = {}
            if self._filter_cache is not None:
                self._filter_cache.clear()
            log.info("%s index warm-loaded from %s (n=%d)", self.kind, path,
                     len(self.texts))
            return True
        except (OSError, ValueError, KeyError, json.JSONDecodeError) as e:
            log.warning("%s index at %s unreadable (%r); warm boot failed",
                        self.kind, path, e)
            return False

    @property
    def dim(self) -> int:
        return int(self._index.dim) if self._index is not None else 0

    @property
    def is_built(self) -> bool:
        return self._index is not None

    @property
    def _nprobe(self) -> int:
        # the effective nlist (the build caps ivfpq_nlist at n / 8)
        nlist = getattr(self._index, "nlist", self.cfg.ivfpq_nlist)
        if self.cfg.ivfpq_nprobe > 0:
            return min(self.cfg.ivfpq_nprobe, nlist)
        return max(1, nlist // 16)

    def _filter_bits(self, spec: dict):
        """The packed bitset and selectivity of a filter spec, cached; the
        C++ tiers read the packed bytes."""
        from .filtering import (
            FilterCache,
            canonical_filter_key,
            compile_filter_mask,
            pack_mask,
        )

        key = canonical_filter_key(spec)
        if self._filter_cache is None:
            self._filter_cache = FilterCache()
        entry = self._filter_cache.get(key)
        if entry is None:
            n = len(self._index)
            mask = compile_filter_mask(spec, self.doc_ids, self.metadata, n)
            sel = float(mask.mean()) if n else 0.0
            entry = (pack_mask(mask), sel)
            self._filter_cache.put(key, entry)
        return entry

    def search(self, queries, k: int, filter: dict | None = None):
        """Batched top-k: (scores [Q, k] f32, ids [Q, k] i32) as numpy.
        ``filter`` restricts eligibility inside the C++ tiers: HNSW walks
        disallowed nodes but never returns them (the beam widens with
        1 / selectivity), IVF-PQ skips them in the list scan (probing more
        lists by the same rule)."""
        if self._index is None:
            raise RuntimeError("index not built")
        q = _host(queries)
        if self._normalize:
            q = _normalize_rows(q)
        t0 = time.perf_counter()
        bits, sel = (None, 1.0) if filter is None else self._filter_bits(
            filter
        )
        if bits is not None and sel == 0.0:
            # nothing eligible: all sentinels, no C++ call
            scores = np.full((q.shape[0], k), -np.inf, dtype=np.float32)
            ids = np.full((q.shape[0], k), -1, dtype=np.int32)
        elif self.kind == "hnsw":
            ef = self.cfg.hnsw_ef_search
            if bits is not None:
                # ~ef * sel of the ef visited nodes are eligible: keep at
                # least the unfiltered ef's worth of eligible results
                ef = min(len(self._index),
                         max(ef, int(np.ceil(max(ef, k) / sel))))
            scores, ids = self._index.search(
                q, k, ef_search=ef, allowed_bits=bits
            )
        elif self._refine_emb is not None and self._refine > 1:
            scores, ids = self._search_ivfpq_refined(q, k, bits=bits,
                                                     sel=sel)
        else:
            scores, ids = self._index.search(
                q, k, nprobe=self._filtered_nprobe(sel), allowed_bits=bits
            )
        self.stats.add_search_batch(time.perf_counter() - t0, q.shape[0])
        return scores, ids

    def _filtered_nprobe(self, sel: float) -> int:
        """~1 / selectivity more lists under a filter, so the eligible
        candidates stay at the unfiltered operating point."""
        np_base = self._nprobe
        if sel >= 1.0:
            return np_base
        nlist = getattr(self._index, "nlist", self.cfg.ivfpq_nlist)
        return min(nlist, max(np_base, int(np.ceil(np_base / sel))))

    def _search_ivfpq_refined(self, q: np.ndarray, k: int, bits=None,
                              sel: float = 1.0):
        """Two stages: ``ivfpq_refine`` x k ADC candidates, rescored
        exactly in fp32 against the host corpus (``rescore``). Empty
        slots (id -1) never displace a candidate and stay (-inf, -1); a
        filter applies at stage 1."""
        from .rescore import exact_rescore_topk

        n = self._refine_emb.shape[0]
        k1 = min(self._refine * k, n)
        _, cand = self._index.search(
            q, k1, nprobe=self._filtered_nprobe(sel), allowed_bits=bits
        )
        return exact_rescore_topk(
            q, lambda idx: self._refine_emb[idx], cand, k,
            metric=self.cfg.metric if self.cfg.metric == "euclidean"
            else "dot",
        )

    def retrieve(self, query_emb, top_k: int = 5,
                 filter: dict | None = None):
        q = _host(query_emb)
        if q.ndim == 1:
            q = q[None, :]
        scores, idx = self.search(q, top_k, filter=filter)
        sel = [j for j in idx[0] if j >= 0]
        return (
            [self.texts[j] for j in sel],
            scores[0][: len(sel)].tolist(),
            [self.doc_ids[j] for j in sel],
        )

    def get_stats(self, reset: bool = False) -> dict:
        return self.stats.get(reset)
