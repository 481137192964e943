"""Retriever factory: the dense / bruteforce branch of the JAX package's
``retrieval/factory.py``."""

from __future__ import annotations

import logging
from typing import Sequence

import torch

from ..utils.config import RetrievalConfig
from .dense import DenseRetriever, make_fingerprint

log = logging.getLogger("latentrag_torch.retrieval")

# backends whose index consumes device tensors straight from the encoder
DEVICE_BACKENDS = ("dense", "bruteforce")


def _make_dense(cfg: RetrievalConfig, device) -> DenseRetriever:
    """Construct (not build) a DenseRetriever from config; with
    ``cfg.index_path`` set it loads the store there, if one is valid."""
    if cfg.backend not in DEVICE_BACKENDS:
        raise NotImplementedError(
            f"retrieval.backend={cfg.backend!r} is not ported yet (ROADMAP "
            "queue 1: bm25 in item 24, hnsw/ivfpq in item 18)"
        )
    if cfg.shard_corpus:
        # one device holds the whole corpus, as the JAX package serves the
        # flag on a single device (no mesh, or a 1-device mesh dropped)
        if torch.device(device).type == "cuda" and (
                torch.cuda.device_count() > 1):
            raise NotImplementedError(
                "retrieval.shard_corpus over more than one card is ROADMAP "
                "queue 1 item 23 (multi-GPU)"
            )
        log.info("retrieval.shard_corpus: one device; the corpus is served "
                 "unsharded")
    backend = "xla_exact" if cfg.backend == "bruteforce" else cfg.kernel
    return DenseRetriever(
        metric=cfg.metric,
        backend=backend,
        block_size=cfg.block_size,
        recall_target=cfg.recall_target,
        store_dtype=cfg.store_dtype,
        binary_oversample=cfg.binary_oversample,
        index_path=cfg.index_path or None,
        device=device,
        ivf_nlist=cfg.ivf_nlist,
        ivf_cap=cfg.ivf_cap,
        ivf_nprobe=cfg.ivf_nprobe,
        ivf_query_limit=cfg.ivf_query_limit,
        ivf_selfcheck=cfg.ivf_selfcheck,
    )


def build_retriever(
    embeddings,
    texts: Sequence[str],
    doc_ids: Sequence | None,
    cfg: RetrievalConfig,
    *,
    device="cuda",
    embedding_model: str | None = None,
    ae_type: str | None = None,
    latent_dim: int | None = None,
    chunking: dict | None = None,
    metadata: Sequence[dict] | None = None,
) -> DenseRetriever:
    """Config-driven dense retriever construction + build. The fingerprint
    carries the full provenance, so a store persisted at
    ``cfg.index_path`` is reused only by a run with the same encoder, AE,
    chunking, metric and corpus. ``metadata`` (row-aligned dicts) enables
    ``search(..., filter={"where": ...})``."""
    return _dense_retriever(
        cfg, embeddings, texts, doc_ids, device=device,
        embedding_model=embedding_model, ae_type=ae_type,
        latent_dim=latent_dim, chunking=chunking, metadata=metadata,
    )


def load_retriever(cfg: RetrievalConfig, *, device="cuda",
                   expect: dict | None = None) -> DenseRetriever | None:
    """Warm boot: a retriever from the store persisted at
    ``cfg.index_path`` alone, with no embeddings and no encode. Returns
    None when no valid store is there, or when its provenance contradicts
    ``expect`` (fingerprint keys such as ``embedding_model`` or
    ``ae_type`` mapped to the values the caller serves with; a stored None
    matches anything); callers then take ``build_retriever``."""
    if not cfg.index_path:
        return None
    retriever = _make_dense(cfg, device)
    if not retriever.is_built:
        return None
    fp = retriever.fingerprint or {}
    for key, want in (expect or {}).items():
        have = fp.get(key)
        if have is not None and have != want:
            log.warning(
                "persisted index %s=%r contradicts requested %r; "
                "falling back to cold build", key, have, want,
            )
            return None
    return retriever


def _dense_retriever(
    cfg, embeddings, texts, doc_ids, *, device, embedding_model, ae_type,
    latent_dim, chunking, metadata=None,
):
    retriever = _make_dense(cfg, device)
    fp = make_fingerprint(
        d=int(embeddings.shape[1]),
        embedding_model=embedding_model,
        ae_type=ae_type,
        latent_dim=latent_dim,
        chunking=chunking,
        metric=cfg.metric,
        normalize=cfg.normalize,
    )
    retriever.build(embeddings, texts, doc_ids, fingerprint=fp,
                    metadata=metadata)
    return retriever
