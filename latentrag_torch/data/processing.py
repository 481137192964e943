"""Raw text processing: cleanup, noising, training pairs and triples.

The port's copy of the JAX package's ``data/processing.py``: whitespace
cleanup, word-drop and word-swap noising for denoising training, the DAE
(noisy, clean) pairs and the contrastive (query, positive, negative)
triples. Randomness flows through an explicit numpy
``Generator``, so the same seed gives the JAX package's strings.
"""

from __future__ import annotations

import re
from typing import Sequence

import numpy as np

_WS_RE = re.compile(r"\s+")


def clean_text(text: str) -> str:
    return _WS_RE.sub(" ", text).strip()


def add_noise(
    text: str,
    rng: np.random.Generator,
    drop_prob: float = 0.1,
    swap_prob: float = 0.1,
) -> str:
    """Word-level noising: random drops then adjacent swaps."""
    words = text.split()
    if len(words) > 1 and drop_prob > 0:
        keep = rng.random(len(words)) >= drop_prob
        if not keep.any():
            keep[rng.integers(len(words))] = True
        words = [w for w, k in zip(words, keep) if k]
    if len(words) > 1 and swap_prob > 0:
        for i in range(len(words) - 1):
            if rng.random() < swap_prob:
                words[i], words[i + 1] = words[i + 1], words[i]
    return " ".join(words)


def build_dae_dataset(
    texts: Sequence[str],
    rng: np.random.Generator,
    drop_prob: float = 0.1,
    swap_prob: float = 0.1,
) -> list[tuple[str, str]]:
    """(noisy, clean) text pairs."""
    return [
        (add_noise(clean_text(t), rng, drop_prob, swap_prob), clean_text(t))
        for t in texts
    ]


def jaccard_similarity(a: str, b: str) -> float:
    """Word-set Jaccard (the negative-mining filter)."""
    sa, sb = set(a.lower().split()), set(b.lower().split())
    if not sa and not sb:
        return 1.0
    return len(sa & sb) / max(len(sa | sb), 1)


def build_contrastive_triples(
    queries: Sequence[str],
    positives: Sequence[str],
    rng: np.random.Generator,
    max_jaccard: float = 0.1,
    max_attempts: int = 50,
) -> list[tuple[str, str, str]]:
    """(query, positive, negative) triples; negatives rejection-sampled from
    other positives with word-Jaccard < ``max_jaccard`` vs the positive,
    else the next example's positive."""
    n = len(queries)
    if n != len(positives):
        raise ValueError("queries/positives length mismatch")
    triples = []
    for i in range(n):
        neg = None
        for _ in range(max_attempts):
            j = int(rng.integers(n))
            if j == i:
                continue
            cand = positives[j]
            if jaccard_similarity(positives[i], cand) < max_jaccard:
                neg = cand
                break
        if neg is None:  # fall back to any other positive
            neg = positives[(i + 1) % n]
        triples.append((queries[i], positives[i], neg))
    return triples
