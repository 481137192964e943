"""Dense latent-index retriever (the core of the JAX package's
``retrieval/dense.py``).

* ``build`` prepares the corpus for its metric (cosine: normalized;
  euclidean: raw; mahalanobis: whitened with a factor fitted at build) and
  holds it on the device as an fp32 or bf16 store, or as the binary
  cascade store (cosine / dot only): packed sign bits on the device, SQ8
  rescore codes on the host;
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
* the binary store searches in two stages, as the JAX package's does:
  stage 1 takes ``binary_oversample`` x k candidates by sign-dot score
  (on CUDA the fused binary fold kernel, planned by ``fold_plan`` from
  the recall target of k; on the CPU the plain exact search), stage 2
  rescores them exactly on the host against the SQ8 codes, and the
  results come back as host numpy;
* a post-build self-search: the first corpus row must retrieve itself
  top-1, through the exact fused kernel (float stores) or through the
  cascade (binary store, probe = the dequantized SQ8 row).

The JAX package's ``_self_check`` turned any exception into a silent
rebuild. Here a kernel that fails to build or launch raises; only a wrong
top-1 counts as a failed check.

Persistence, filters, add/remove, the device IVF and the int8 / int4
stores are later slices (ROADMAP queue 1 items 11-17); config values that
need them raise ``NotImplementedError``.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

from ..ops.distances import (
    estimate_covariance,
    prepare_for_metric,
    whitening_factor,
)
from ..ops.binary import binary_quantize, binary_topk
from ..ops.fused_topk import approx_binary_fused_topk, fused_topk
from ..ops.quantization import sq8_quantize
from ..ops.topk import NEG_INF, approx_topk, exact_topk
from ..utils.device import resolve_device
from ..utils.timing import StatsTracker, force_completion
from .rescore import exact_rescore_topk

log = logging.getLogger("latentrag_torch.retrieval")

BACKENDS = ("auto", "xla", "xla_exact", "pallas", "pallas_exact")
STORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "binary": torch.int32}  # binary: packed sign words
EXACT_BACKENDS = ("xla_exact", "pallas_exact")


@dataclass
class DenseRetriever:
    """Exact / quasi-exact dense retriever over a latent corpus matrix."""

    metric: str = "cosine"
    backend: str = "auto"
    block_size: int = 1048576
    recall_target: float | str = "auto"
    store_dtype: str = "bfloat16"
    device: Any = "cuda"

    texts: list = field(default_factory=list)
    doc_ids: list = field(default_factory=list)
    stats: StatsTracker = field(default_factory=StatsTracker)

    _corpus: Any = None  # prepared [N, D] store on the device
    _corpus_n: int = 0
    _whitener: Any = None
    # binary store: _corpus holds only the packed sign words [N, D/32] on
    # the device; the SQ8 rescore codes and their scale stay on the host
    _rescore_host: Any = None  # np.int8 [N, D]
    _corpus_scale: Any = None  # float
    _dim: int = 0  # the vectors' dim (a packed row has D/32 words)
    binary_oversample: int = 8  # cascade stage-1 candidates per k

    # k at/above this is treated as re-rank oversampling
    RERANK_K = 64

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {BACKENDS}")
        if self.store_dtype not in STORE_DTYPES:
            raise NotImplementedError(
                f"store_dtype={self.store_dtype!r}: the int8 and int4 stores "
                "are ROADMAP queue 1 item 15; use float32, bfloat16 or binary"
            )
        if self.store_dtype == "binary":
            if self.metric not in ("cosine", "dot"):
                raise ValueError("binary store supports cosine/dot only")
            if self.backend in EXACT_BACKENDS:
                raise ValueError(
                    f"backend={self.backend!r} requests the exact oracle, "
                    "but store_dtype='binary' is quantized; use a float "
                    "store for oracle comparisons"
                )
        self.device = resolve_device(self.device)

    @property
    def is_built(self) -> bool:
        return self._corpus is not None

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
        sanity_check: bool = True,
    ) -> None:
        """Prepare the corpus and hold it on the device."""
        t0 = time.perf_counter()
        x = torch.as_tensor(embeddings).to(self.device, torch.float32)
        if len(texts) != x.shape[0]:
            raise ValueError("texts and embeddings row count mismatch")
        self.texts = list(texts)
        self.doc_ids = (
            list(doc_ids) if doc_ids is not None else list(range(len(texts)))
        )
        if self.metric == "mahalanobis":
            self._whitener = whitening_factor(estimate_covariance(x))
        prepared = prepare_for_metric(x, self.metric, self._whitener)
        self._dim = int(x.shape[1])
        if self.store_dtype == "binary":
            codes, scale = sq8_quantize(prepared)
            self._rescore_host = codes.cpu().numpy()
            self._corpus_scale = float(scale)
            self._corpus = binary_quantize(prepared)
        else:
            self._corpus = prepared.to(
                STORE_DTYPES[self.store_dtype]).contiguous()
        self._corpus_n = int(x.shape[0])
        force_completion(self._corpus)
        self.stats.add_build(time.perf_counter() - t0)

        if sanity_check and self._corpus_n > 0 and not self._self_check():
            log.warning("post-build self-check failed; rebuilding once")
            self._corpus = None
            self.build(x, texts, doc_ids, sanity_check=False)

    def _self_check(self) -> bool:
        """The first corpus row must come back top-1: searched through the
        exact fused kernel (float stores) or through the cascade (binary
        store). Kernel build and launch errors propagate."""
        probe = self._corpus_row(0)[None, :]
        _, idx = self._search_prepared(
            probe, min(4, self._corpus_n), backend="pallas_exact"
        )
        return int(idx[0, 0]) == 0

    def _corpus_row(self, i: int) -> torch.Tensor:
        """Row ``i`` of the store as fp32 on the device (the binary store:
        its dequantized SQ8 row)."""
        if self._rescore_host is not None:
            row = torch.from_numpy(self._rescore_host[i].astype(np.float32))
            return (row * self._corpus_scale).to(self.device)
        return self._corpus[i].float()

    # --------------------------------------------------------------- search

    def _search_prepared(self, q: torch.Tensor, k: int,
                         backend: str | None = None):
        """Top-k of queries already in the prepared space: (scores [Q, k]
        f32, indices [Q, k]), tensors on the device (host numpy from the
        binary store)."""
        if self._rescore_host is not None:
            return self._search_cascade(q, k)
        backend = backend or self._resolve_backend()
        q = q.to(self._corpus.dtype).contiguous()
        if backend == "xla":
            return approx_topk(
                q, self._corpus, k=k, metric=self.metric,
                block_size=self.block_size,
                recall_target=self._effective_recall_target(k),
            )
        if backend == "xla_exact":
            return exact_topk(q, self._corpus, k=k, metric=self.metric,
                              block_size=min(self.block_size, 8192))
        mode = "fold" if backend == "pallas" else "exact"
        return fused_topk(q, self._corpus, k=k, metric=self.metric, mode=mode)

    def _search_cascade(self, q: torch.Tensor, k: int):
        """The binary store: stage 1 takes ``binary_oversample`` x k
        candidates by sign-dot score on the device, stage 2 rescores them
        exactly on the host against the SQ8 codes. The recall target is
        k's, not the candidates'. Returns host numpy (scores, ids), with
        (-inf, -1) in slots past N."""
        ok = min(self.binary_oversample * k, self._corpus_n)
        q = q.float().contiguous()
        if self.device.type == "cuda":
            _, cand = approx_binary_fused_topk(
                q, self._corpus, d=self._dim, k=ok,
                recall_target=self._effective_recall_target(k),
            )
        else:
            _, cand = binary_topk(q, self._corpus, d=self._dim, k=ok)
        return exact_rescore_topk(
            q.cpu().numpy(), lambda idx: self._rescore_host[idx],
            cand.cpu().numpy(), k, metric="dot", scale=self._corpus_scale,
        )

    def search(self, queries, k: int, filter: dict | None = None):
        """Batched top-k. queries: [Q, D] in the raw embedding space (numpy
        or a tensor). Returns (scores [Q, k], indices [Q, k]) as numpy;
        slots with no candidate come back as (NEG_INF, -1)."""
        if not self.is_built:
            raise RuntimeError("index not built")
        if filter is not None:
            raise NotImplementedError(
                "filtered search is ROADMAP queue 1 item 12"
            )
        t0 = time.perf_counter()
        q = torch.as_tensor(queries).to(self.device, torch.float32)
        q = prepare_for_metric(q, self.metric, self._whitener)
        s, i = self._search_prepared(q, k)
        if isinstance(s, torch.Tensor):  # the binary store returns numpy
            s, i = s.float().cpu().numpy(), i.cpu().numpy()
        i = i.astype(np.int64)
        i = np.where(s > NEG_INF * 0.5, i, -1)
        self.stats.add_search_batch(time.perf_counter() - t0, q.shape[0])
        return s, i

    def retrieve(self, query_emb, top_k: int = 5):
        """Single query -> (texts, scores, doc_ids)."""
        q = np.asarray(query_emb, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        scores, idx = self.search(q, top_k)
        sel = [int(j) for j in idx[0] if j >= 0]
        return (
            [self.texts[j] for j in sel],
            scores[0][: len(sel)].tolist(),
            [self.doc_ids[j] for j in sel],
        )

    def get_stats(self, reset: bool = False) -> dict:
        return self.stats.get(reset)
