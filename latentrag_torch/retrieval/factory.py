"""Retriever factory: the dense / bruteforce branch of the JAX package's
``retrieval/factory.py``."""

from __future__ import annotations

import logging
from typing import Sequence

from ..utils.config import RetrievalConfig
from .dense import DenseRetriever

log = logging.getLogger("latentrag_torch.retrieval")

# backends whose index consumes device tensors straight from the encoder
DEVICE_BACKENDS = ("dense", "bruteforce")


def _make_dense(cfg: RetrievalConfig, device) -> DenseRetriever:
    """Construct (not build) a DenseRetriever from config."""
    if cfg.backend not in DEVICE_BACKENDS:
        raise NotImplementedError(
            f"retrieval.backend={cfg.backend!r} is not ported yet (ROADMAP "
            "queue 1: bm25 in item 24, hnsw/ivfpq in item 18)"
        )
    if cfg.shard_corpus:
        raise NotImplementedError(
            "retrieval.shard_corpus is ROADMAP queue 1 item 23 (multi-GPU)"
        )
    if cfg.ivf_nlist:
        raise NotImplementedError(
            "retrieval.ivf_nlist (device IVF) is ROADMAP queue 1 item 17"
        )
    backend = "xla_exact" if cfg.backend == "bruteforce" else cfg.kernel
    return DenseRetriever(
        metric=cfg.metric,
        backend=backend,
        block_size=cfg.block_size,
        recall_target=cfg.recall_target,
        store_dtype=cfg.store_dtype,
        binary_oversample=cfg.binary_oversample,
        device=device,
    )


def build_retriever(
    embeddings,
    texts: Sequence[str],
    doc_ids: Sequence | None,
    cfg: RetrievalConfig,
    *,
    device="cuda",
) -> DenseRetriever:
    """Config-driven dense retriever construction + build. The index lives
    in device memory; ``cfg.index_path`` is not read or written until
    persistence is ported (ROADMAP queue 1 item 11)."""
    retriever = _make_dense(cfg, device)
    retriever.build(embeddings, texts, doc_ids)
    return retriever
