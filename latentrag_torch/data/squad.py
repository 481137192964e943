"""SQuAD-format evaluation data: loaders, the synthetic corpus, eval triples.

The slice of the JAX package's ``data/squad.py`` that the main path runs:
``synthetic``, ``squad:<local official json>`` and ``jsonl:<path>``
sources, and ``load_evaluation_data``. The hub ``squad`` source needs the
network, which the port never uses, so it raises; ``cloze:`` and
``msmarco`` sources and the AE training arrays are later slices.
"""

from __future__ import annotations

import json
from typing import Mapping, Sequence

import numpy as np

from ..utils.config import Config


def load_local_squad(path: str, max_samples: int | None = None) -> list[dict]:
    """Official SQuAD JSON format ({data: [{paragraphs: [{context, qas}]}]})."""
    with open(path) as f:
        raw = json.load(f)
    out = []
    i = 0
    for article in raw["data"]:
        for para in article["paragraphs"]:
            ctx = para["context"]
            for qa in para["qas"]:
                if max_samples is not None and len(out) >= max_samples:
                    return out
                if not qa.get("answers"):
                    continue
                ans = qa["answers"][0]
                out.append(
                    {
                        "question": qa["question"],
                        "context": ctx,
                        "answer_text": ans["text"],
                        "answer_start": int(ans["answer_start"]),
                        "doc_id": i,
                    }
                )
                i += 1
    return out



_TOPICS = [
    ("astronomy", "telescopes observe distant galaxies and nebulae",
     "telescopes"),
    ("biology", "mitochondria produce energy inside living cells",
     "mitochondria"),
    ("history", "the treaty ended a long war between the two empires",
     "the treaty"),
    ("music", "the orchestra rehearsed the symphony for many weeks",
     "the orchestra"),
    ("geography", "rivers carve deep canyons through ancient rock",
     "rivers"),
    ("computing", "processors execute billions of instructions per second",
     "processors"),
    ("medicine", "vaccines train the immune system against pathogens",
     "vaccines"),
    ("economics", "markets balance supply and demand through prices",
     "markets"),
]


def synthetic_examples(n: int = 200, seed: int = 0) -> list[dict]:
    """Deterministic synthetic QA corpus for offline tests/benchmarks.

    Contexts are distinct multi-sentence passages; the answer is a span
    inside the context; questions paraphrase the topic sentence.
    """
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        topic, fact, answer = _TOPICS[i % len(_TOPICS)]
        variant = int(rng.integers(1000, 9999))
        filler = (
            f"Study group {variant} documented many findings about {topic}. "
            f"Researchers repeated their measurements {1 + i % 7} times. "
        )
        sentence = f"In experiment {variant}, {fact}."
        context = filler + sentence + " Further work is planned."
        answer_start = context.index(answer)
        out.append(
            {
                "question": f"What {fact.split()[0]} are discussed in "
                f"experiment {variant} about {topic}?",
                "context": context,
                "answer_text": answer,
                "answer_start": answer_start,
                "doc_id": i,
            }
        )
    return out


def load_jsonl_examples(path: str, max_samples: int | None = None) -> list[dict]:
    """Custom-corpus loader: one JSON object per line with at least
    {question, context}; optional {answer_text, answer_start, doc_id}."""
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            if max_samples is not None and len(out) >= max_samples:
                break
            line = line.strip()
            if not line:
                continue
            ex = json.loads(line)
            out.append(
                {
                    "question": ex["question"],
                    "context": ex["context"],
                    "answer_text": ex.get("answer_text", ""),
                    "answer_start": int(ex.get("answer_start", 0)),
                    "doc_id": ex.get("doc_id", i),
                }
            )
    return out


def get_examples(cfg: Config, split: str = "train") -> list[dict]:
    """Dispatch: 'synthetic', 'squad:<path>' (local official json),
    'jsonl:<path>' (custom corpus). ``split`` is accepted for the JAX
    package's signature; the local sources have one split."""
    ds = cfg.data.dataset
    if ds.startswith("synthetic"):
        return synthetic_examples(cfg.data.max_samples or 200)
    if ds.startswith("jsonl:"):
        return load_jsonl_examples(ds.split(":", 1)[1], cfg.data.max_samples)
    if ds.startswith(("cloze:", "msmarco")):
        raise NotImplementedError(
            f"data.dataset={ds!r} is not ported yet (ROADMAP queue 1, "
            "slice E auxiliaries); use synthetic, squad:<path> or jsonl:<path>"
        )
    if ds.startswith("squad:"):
        return load_local_squad(ds.split(":", 1)[1], cfg.data.max_samples)
    raise ValueError(
        f"data.dataset={ds!r} needs the HF hub, and the port never uses the "
        "network; download the official SQuAD json and pass squad:<path>"
    )


# ------------------------------------------------------------- eval triples


def load_evaluation_data(
    examples: Sequence[Mapping],
    with_answers: bool = False,
):
    """(queries, deduped corpus, relevant corpus-doc index per query
    [, gold answers]).

    Contexts are deduplicated first-seen (the reference's ``set()`` dedup,
    ``utils/data_utils.py:542`` — 2000 queries → 315 unique contexts).
    ``with_answers`` additionally returns each query's gold answer text so
    generation output can be scored (ref ``main.py:331-335``).
    """
    corpus: list[str] = []
    index: dict[str, int] = {}
    queries: list[str] = []
    relevant: list[int] = []
    answers: list[str] = []
    for ex in examples:
        ctx = ex["context"]
        if ctx not in index:
            index[ctx] = len(corpus)
            corpus.append(ctx)
        queries.append(ex["question"])
        relevant.append(index[ctx])
        answers.append(str(ex.get("answer_text", "")))
    if with_answers:
        return queries, corpus, relevant, answers
    return queries, corpus, relevant
