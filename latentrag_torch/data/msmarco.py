"""MS MARCO passage-ranking loader (the scale-out corpus of
``configs/msmarco_v5e8.yaml``).

The port of the JAX package's ``data/msmarco.py``. Records come from a
local jsonl file in the shape of the hub's ``ms_marco`` v1.1 records::

    {"query": "...", "passages": {"passage_text": [...], "is_selected": [...]}}

The hub source needs the ``datasets`` package and the network, which the
port never uses, so ``source=None`` raises. ``load_msmarco_eval`` yields
(queries, corpus, relevant) in the shape of ``squad.load_evaluation_data``.
"""

from __future__ import annotations

import json
from typing import Iterable, Iterator, Mapping


def _stream_records(split: str, source: str | None = None) -> Iterable[Mapping]:
    """MS-MARCO-shaped records from the local jsonl ``source``."""
    if source is None:
        raise ValueError(
            f"the MS MARCO {split!r} split needs the HF hub, and the port "
            "never uses the network; pass a local jsonl of its records "
            "(data.dataset=msmarco:<path>)"
        )

    def gen():
        with open(source) as f:
            for line in f:
                line = line.strip()
                if line:
                    yield json.loads(line)

    return gen()


def load_msmarco_corpus(
    max_passages: int | None = None,
    source: str | None = None,
) -> Iterator[str]:
    """Stream passage texts from the MS MARCO passage collection."""
    n = 0
    for ex in _stream_records("train", source):
        for passage in ex["passages"]["passage_text"]:
            yield passage
            n += 1
            if max_passages is not None and n >= max_passages:
                return


def load_msmarco_eval(
    max_queries: int | None = 1000,
    source: str | None = None,
) -> tuple[list[str], list[str], list[int]]:
    """(queries, deduped passage corpus, relevant passage index per query).

    Relevance = the is_selected passage of each query; a query without a
    selected passage is skipped before its passages enter the corpus.
    Passages are deduplicated first-seen across queries, distractors
    included."""
    queries: list[str] = []
    corpus: list[str] = []
    index: dict[str, int] = {}
    relevant: list[int] = []
    for ex in _stream_records("validation", source):
        if max_queries is not None and len(queries) >= max_queries:
            break
        texts = ex["passages"]["passage_text"]
        selected = ex["passages"]["is_selected"]
        pos = next((t for t, s in zip(texts, selected) if s), None)
        if pos is None:
            continue
        for t in texts:
            if t not in index:
                index[t] = len(corpus)
                corpus.append(t)
        queries.append(ex["query"])
        relevant.append(index[pos])
    return queries, corpus, relevant
