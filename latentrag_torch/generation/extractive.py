"""Offline extractive answerer (``generation.provider=extractive``).

The port of the JAX package's ``generation/extractive.py``, pure Python
and string for string the same: a deterministic, dependency-free
generation provider whose answer is the retrieved sentence(s) with the
highest rarity-weighted lexical overlap with the question. It lets the
RAG loop, generation metrics included, run with no network and no API
key; the LLM provider stays a config knob away.

Scoring: tokens are lowercased alphanumeric runs; each query token's
weight is a document-frequency-damped IDF over the retrieved docs (rare
terms dominate, "the" contributes ~nothing); a sentence scores the sum
of matched-token weights, normalized by sqrt(sentence length) so verbose
sentences don't win by surface area. Ties break to the earlier sentence
(stable, reproducible).
"""

from __future__ import annotations

import math
import re
from typing import Sequence

_TOKEN_RE = re.compile(r"[a-z0-9]+")
_SENT_RE = re.compile(r"(?<=[.!?])\s+")


def _tokens(text: str) -> list[str]:
    return _TOKEN_RE.findall(text.lower())


def split_sentences(text: str) -> list[str]:
    """Split on sentence-final punctuation followed by whitespace; a text
    without any becomes one sentence."""
    parts = [s.strip() for s in _SENT_RE.split(text)]
    return [s for s in parts if s]


def extractive_answer(
    query: str,
    docs: Sequence[str],
    max_sentences: int = 2,
) -> str:
    """Best-overlap sentence(s) from the retrieved docs, original order."""
    sentences: list[str] = []
    for d in docs:
        sentences.extend(split_sentences(str(d)))
    if not sentences:
        return ""
    q_tokens = set(_tokens(query))
    if not q_tokens:
        return sentences[0]
    # document-frequency damping over the candidate sentences: a query
    # term appearing in every sentence separates nothing
    n = len(sentences)
    sent_tokens = [set(_tokens(s)) for s in sentences]
    df = {
        t: sum(1 for st in sent_tokens if t in st) for t in q_tokens
    }
    weight = {
        t: math.log(1.0 + (n - df[t] + 0.5) / (df[t] + 0.5))
        for t in q_tokens
        if df[t] > 0
    }
    scored = []
    for i, st in enumerate(sent_tokens):
        matched = q_tokens & st
        if not matched:
            continue
        score = sum(weight.get(t, 0.0) for t in matched)
        score /= math.sqrt(max(len(st), 1))
        scored.append((score, i))
    if not scored:
        return sentences[0]
    scored.sort(key=lambda si: (-si[0], si[1]))
    keep = sorted(i for _, i in scored[:max_sentences])
    return " ".join(sentences[i] for i in keep)
