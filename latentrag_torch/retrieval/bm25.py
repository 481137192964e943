"""Self-contained BM25 sparse baseline.

The port of the JAX package's ``retrieval/bm25.py``: an inverted index
with the Lucene-style BM25 the reference ran through pyserini (``k1=0.9,
b=0.4``, IDF ``ln(1 + (N - df + 0.5) / (df + 0.5))``), and the same
``build_index`` / ``retrieve`` / ``search`` surface. It runs on the host
in numpy, as in the JAX package: lexical scoring is a host workload.

The scorer takes a query's terms in the JAX package's order and, for each
term, scores its whole posting list at once in the same fp32 and fp64
steps that the JAX package takes for each posting, so the scores are the
same bits.
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Sequence

import numpy as np

_TOKEN_RE = re.compile(r"[a-z0-9]+")

# Minimal english stopword list (Lucene's default analyzer set).
_STOPWORDS = frozenset(
    "a an and are as at be but by for if in into is it no not of on or such "
    "that the their then there these they this to was will with".split()
)


def tokenize(text: str, remove_stopwords: bool = True) -> list[str]:
    toks = _TOKEN_RE.findall(text.lower())
    if remove_stopwords:
        toks = [t for t in toks if t not in _STOPWORDS]
    return toks


class BM25Retriever:
    """Inverted-index BM25 with Lucene-style parameters."""

    def __init__(self, k1: float = 0.9, b: float = 0.4):
        self.k1 = k1
        self.b = b
        # term -> (doc rows int64 [df], term frequencies int64 [df])
        self._postings: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        self._doc_len: np.ndarray | None = None
        self._avgdl: float = 0.0
        self._n_docs: int = 0
        self.corpus: list[str] = []
        # optional per-document metadata backing filter={"where": ...};
        # doc_ids in filter specs are the corpus row indices
        self.metadata: list | None = None

    def build_index(self, corpus: Sequence[str],
                    metadata: Sequence[dict] | None = None) -> None:
        if metadata is not None and len(metadata) != len(corpus):
            raise ValueError(
                f"{len(metadata)} metadata entries for {len(corpus)} docs"
            )
        self.metadata = list(metadata) if metadata is not None else None
        self.corpus = list(corpus)
        self._n_docs = len(self.corpus)
        postings: dict[str, list[tuple[int, int]]] = defaultdict(list)
        doc_len = np.zeros(self._n_docs, dtype=np.float32)
        for di, text in enumerate(self.corpus):
            counts = Counter(tokenize(text))
            doc_len[di] = sum(counts.values())
            for term, tf in counts.items():
                postings[term].append((di, tf))
        self._postings = {
            term: tuple(np.asarray(col, dtype=np.int64) for col in zip(*p))
            for term, p in postings.items()
        }
        self._doc_len = doc_len
        self._avgdl = float(doc_len.mean()) if self._n_docs else 0.0

    def _idf(self, term: str) -> float:
        rows = self._postings.get(term)
        df = 0 if rows is None else len(rows[0])
        if df == 0:
            return 0.0
        # Lucene BM25 idf: ln(1 + (N - df + 0.5)/(df + 0.5))
        return math.log(1.0 + (self._n_docs - df + 0.5) / (df + 0.5))

    def score_query(self, query: str) -> np.ndarray:
        """Dense fp32 score vector over all docs. Per posting, as the JAX
        package computes it: the length norm and the denominator in fp32,
        ``idf * tf * (k1 + 1)`` in fp64, rounded to fp32 and divided by
        the denominator in fp32, then added to the doc's fp32 score; the
        terms in the order of ``set(tokenize(query))``."""
        if self._doc_len is None:
            raise RuntimeError("index not built")
        scores = np.zeros(self._n_docs, dtype=np.float32)
        k1, b, avgdl = self.k1, self.b, max(self._avgdl, 1e-9)
        for term in set(tokenize(query)):
            idf = self._idf(term)
            if idf == 0.0:
                continue
            rows, tf = self._postings[term]
            dl = self._doc_len[rows]
            denom = tf.astype(np.float32) + k1 * (1.0 - b + b * dl / avgdl)
            num = (idf * (tf.astype(np.float64) * (k1 + 1.0))).astype(
                np.float32)
            scores[rows] += num / denom
        return scores

    def _filter_mask(self, spec: dict) -> np.ndarray:
        """Compile a filter spec (``retrieval.filtering``) to a bool [n]
        mask; doc_ids in specs are corpus row indices."""
        from .filtering import compile_filter_mask

        return compile_filter_mask(
            spec, list(range(self._n_docs)), self.metadata, self._n_docs
        )

    def retrieve(self, query: str, top_k: int = 5,
                 filter: dict | None = None):
        scores = self.score_query(query)
        if filter is not None:
            scores = np.where(self._filter_mask(filter), scores, -np.inf)
        k = min(top_k, self._n_docs)
        idx = np.argpartition(-scores, k - 1)[:k]
        idx = idx[np.argsort(-scores[idx])]
        return [(self.corpus[i], float(scores[i])) for i in idx
                if np.isfinite(scores[i])]

    def search(self, queries: Sequence[str], k: int,
               filter: dict | None = None):
        """Batch surface: (D, I) numpy arrays. With ``filter``, excluded
        docs score -inf and unreachable slots carry -1 ids (the dense
        tiers' sentinel convention)."""
        kk = min(k, self._n_docs)
        if not queries:
            return (np.zeros((0, kk), np.float32),
                    np.zeros((0, kk), np.int64))
        mask = self._filter_mask(filter) if filter is not None else None
        ds, inds = [], []
        for qtext in queries:
            scores = self.score_query(qtext)
            if mask is not None:
                scores = np.where(mask, scores, -np.inf)
            idx = np.argpartition(-scores, kk - 1)[:kk]
            idx = idx[np.argsort(-scores[idx])]
            d = scores[idx]
            ds.append(d)
            inds.append(np.where(np.isfinite(d), idx, -1))
        return np.stack(ds), np.stack(inds)
