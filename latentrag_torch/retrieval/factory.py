"""Retriever factory: the JAX package's ``retrieval/factory.py`` for the
dense / bruteforce backends and the C++ ANN tiers (hnsw / ivfpq)."""

from __future__ import annotations

import logging
from typing import Sequence

from ..utils.config import RetrievalConfig
from .ann_retriever import ANNRetriever
from .dense import DenseRetriever, make_fingerprint

log = logging.getLogger("latentrag_torch.retrieval")

# backends whose index consumes device tensors straight from the encoder
DEVICE_BACKENDS = ("dense", "bruteforce")
# the C++ tiers: host numpy in, searched on the host
ANN_BACKENDS = ("hnsw", "ivfpq")


def _make_dense(cfg: RetrievalConfig, device, mesh=None) -> DenseRetriever:
    """Construct (not build) a DenseRetriever from config; with
    ``cfg.index_path`` set it loads the store there, if one is valid. As
    in the JAX package, a backend other than dense, bruteforce and the ANN
    tiers (``bm25``: BM25 runs only in the benchmark harness) gets a dense
    store on kernel ``auto``, and ``mesh`` shards it only under
    ``retrieval.shard_corpus``."""
    backend = {"dense": cfg.kernel, "bruteforce": "xla_exact"}.get(
        cfg.backend, "auto")
    return DenseRetriever(
        metric=cfg.metric,
        backend=backend,
        block_size=cfg.block_size,
        recall_target=cfg.recall_target,
        store_dtype=cfg.store_dtype,
        binary_oversample=cfg.binary_oversample,
        index_path=cfg.index_path or None,
        device=device,
        mesh=mesh if cfg.shard_corpus else None,
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
    mesh=None,
    embedding_model: str | None = None,
    ae_type: str | None = None,
    latent_dim: int | None = None,
    chunking: dict | None = None,
    metadata: Sequence[dict] | None = None,
) -> DenseRetriever | ANNRetriever:
    """Config-driven retriever construction + build. The fingerprint
    carries the full provenance, so a store persisted at
    ``cfg.index_path`` is reused only by a run with the same encoder, AE,
    chunking, metric and corpus. ``metadata`` (row-aligned dicts) enables
    ``search(..., filter={"where": ...})``. ``hnsw`` / ``ivfpq`` build the
    C++ ANN tiers (``ANNRetriever``; their device builds on ``device``)."""
    if cfg.backend in ANN_BACKENDS:
        ann = ANNRetriever(cfg, cfg.backend, device=device)
        ann.build(embeddings, texts, doc_ids,
                  embedding_model=embedding_model, ae_type=ae_type,
                  metadata=metadata)
        return ann
    return _dense_retriever(
        cfg, embeddings, texts, doc_ids, device=device, mesh=mesh,
        embedding_model=embedding_model, ae_type=ae_type,
        latent_dim=latent_dim, chunking=chunking, metadata=metadata,
    )


def load_retriever(cfg: RetrievalConfig, *, device="cuda",
                   expect: dict | None = None, mesh=None):
    """Warm boot: a retriever from the store persisted at
    ``cfg.index_path`` alone, with no embeddings and no encode. Returns
    None when no valid store is there, or when its provenance contradicts
    ``expect`` (fingerprint keys such as ``embedding_model`` or
    ``ae_type`` mapped to the values the caller serves with; a stored None
    matches anything); callers then take ``build_retriever``."""
    if not cfg.index_path:
        return None
    if cfg.backend in ANN_BACKENDS:
        ann = ANNRetriever(cfg, cfg.backend, device=device)
        return ann if ann.load_persisted(expect=expect) else None
    retriever = _make_dense(cfg, device, mesh)
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
    latent_dim, chunking, metadata=None, mesh=None,
):
    retriever = _make_dense(cfg, device, mesh)
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
