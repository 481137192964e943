"""DPR-style dual-encoder retrieval baseline.

The port of the JAX package's ``retrieval/dpr.py``: two independent
sentence encoders, one for questions and one for passages (BERT geometry,
[CLS] pooling, no normalization), over one ``DenseRetriever``. Scoring is
the raw [CLS] dot product (Karpukhin et al.), ``metric="dot"``; on the
card the store's search runs the fused top-k kernels. The embeddings stay
on the encoders' device from the encode into the build and the search.
"""

from __future__ import annotations

from typing import Sequence

from .dense import DenseRetriever, make_fingerprint


class DPRRetriever:
    """Dual-encoder dense retriever with the BaseRetriever text surface.
    The store lives on the context encoder's device."""

    def __init__(
        self,
        question_encoder,
        context_encoder,
        metric: str = "dot",  # DPR scores raw [CLS] dot products
        backend: str = "auto",
        store_dtype: str = "bfloat16",
    ):
        self.q_encoder = question_encoder
        self.c_encoder = context_encoder
        # store_dtype="float32" pins exact fp32 dot products (the
        # differential-parity mode); bf16 is the production store
        self.dense = DenseRetriever(
            metric=metric, backend=backend, store_dtype=store_dtype,
            device=context_encoder.device,
        )

    def build_index(self, corpus: Sequence[str],
                    metadata: Sequence[dict] | None = None) -> None:
        emb = self.c_encoder.encode_batch(list(corpus))
        fp = make_fingerprint(
            d=int(emb.shape[1]),
            embedding_model=f"dpr:{getattr(self.c_encoder, 'name', 'ctx')}",
            metric=self.dense.metric,
        )
        self.dense.build(emb, corpus, fingerprint=fp, metadata=metadata)

    def retrieve(self, query: str, top_k: int = 5,
                 filter: dict | None = None):
        scores, idx = self.search([query], top_k, filter=filter)
        return [(self.dense.texts[j], float(s))
                for j, s in zip(idx[0], scores[0]) if j >= 0]

    def search(self, queries: Sequence[str], k: int,
               filter: dict | None = None):
        q = self.q_encoder.encode_batch(list(queries))
        return self.dense.search(q, k, filter=filter)

    def get_stats(self, reset: bool = False) -> dict:
        return self.dense.get_stats(reset)
