"""SQuAD-format data: loaders, the synthetic corpus, eval triples, and the
autoencoders' training arrays.

The port of the JAX package's ``data/squad.py``: ``synthetic``,
``msmarco:<local jsonl>``, ``jsonl:<path>``, ``cloze:<text corpus>`` and
``<name>:<local official json>`` sources, ``load_evaluation_data``, and
``prepare_training_arrays`` / ``split_dataset`` with the arrays' save and
load. The hub forms (``squad``, ``msmarco`` without a path) need the
network, which the port never uses, so they raise and name the local form.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Sequence

import numpy as np

from ..utils.config import Config
from .cache import ensure_embedding_cache
from .chunking import build_chunked_corpus
from .processing import build_contrastive_triples, clean_text


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


def cloze_examples(
    texts: Sequence[str],
    max_samples: int | None = None,
    snippet_words: int = 12,
    seed: int = 0,
) -> list[dict]:
    """Self-supervised eval pairs from a raw text corpus: the query is a
    sampled snippet of a document, the document is the relevant answer
    (retrieval quality = can the snippet find its source doc)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, text in enumerate(texts):
        if max_samples is not None and len(out) >= max_samples:
            break
        words = text.split()
        if len(words) < snippet_words + 2:
            continue
        start = int(rng.integers(0, len(words) - snippet_words))
        snippet = " ".join(words[start : start + snippet_words])
        out.append(
            {
                "question": snippet,
                "context": text,
                "answer_text": snippet,
                "answer_start": text.find(snippet) if snippet in text else 0,
                "doc_id": i,
            }
        )
    return out


def load_text_corpus(path: str) -> list[str]:
    """One document per line (.txt) or a JSON list of strings (.json, also
    as ``{"texts": [...]}``)."""
    if path.endswith(".json"):
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict):
            data = data.get("texts")
        if not isinstance(data, list):
            raise ValueError(
                f"{path}: expected a JSON list of strings or "
                '{"texts": [...]}'
            )
        return [str(t) for t in data]
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def get_examples(cfg: Config, split: str = "train") -> list[dict]:
    """Dispatch: 'synthetic', 'msmarco:<path>' (local jsonl; the selected
    passage of each query), 'jsonl:<path>' (custom corpus),
    'cloze:<textfile>' (snippet->doc pairs from raw text), and
    '<name>:<path>' (a local official SQuAD json). ``split`` is accepted
    for the JAX package's signature; the local sources have one split."""
    ds = cfg.data.dataset
    if ds.startswith("synthetic"):
        return synthetic_examples(cfg.data.max_samples or 200)
    if ds.startswith("msmarco"):
        # (question, selected-passage) pairs; main loads load_msmarco_eval
        # itself to keep the distractor passages in its corpus
        from .msmarco import load_msmarco_eval

        _, _, src = ds.partition(":")
        queries, corpus, relevant = load_msmarco_eval(
            max_queries=cfg.data.max_samples, source=src or None
        )
        return [
            {"question": q, "context": corpus[r], "answer_text": "",
             "answer_start": 0, "doc_id": r}
            for q, r in zip(queries, relevant)
        ]
    if ds.startswith("jsonl:"):
        return load_jsonl_examples(ds.split(":", 1)[1], cfg.data.max_samples)
    if ds.startswith("cloze:"):
        return cloze_examples(
            load_text_corpus(ds.split(":", 1)[1]), cfg.data.max_samples
        )
    if ":" in ds:
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


# ---------------------------------------------------------- training arrays


def prepare_training_arrays(
    examples: Sequence[Mapping],
    encoder,
    tokenizer,
    variant: str,
    cache_dir: str,
    *,
    noise_std: float = 0.05,
    max_jaccard: float = 0.1,
    chunk_max_tokens: int = 128,
    chunk_stride: int = 64,
    seed: int = 42,
    model_name: str = "",
    mine_hard_negatives: bool = False,
) -> dict[str, np.ndarray]:
    """The host fp32 arrays a ``Trainer`` takes for one AE variant.

    vae: {x: clean_emb, y: clean_emb};
    dae: {x: clean_emb + N(0, noise_std^2), y: clean_emb}, the noise drawn
    on the host from ``default_rng(seed)``;
    cae: {q, p, n} embeddings of (question, positive chunk, mined
    negative). With ``mine_hard_negatives`` the trainer mines negatives in
    the batch, so only {q, p} are built.

    The positive is each example's first answer-aware chunk that holds the
    answer (``build_chunked_corpus``). ``encoder`` is an
    ``EmbeddingCompressor`` (its ``encode_text``); embeddings go through
    the content-addressed cache (``data/cache.py``)."""
    rng = np.random.default_rng(seed)
    chunks = build_chunked_corpus(
        list(examples), tokenizer, max_tokens=chunk_max_tokens,
        stride=chunk_stride,
    )
    by_doc: dict = {}
    for rec in chunks:
        by_doc.setdefault(rec.doc_id, []).append(rec)

    questions, positives = [], []
    for ex in examples:
        doc_chunks = by_doc.get(ex["doc_id"], [])
        pos = next(
            (r for r in doc_chunks if r.contains_answer),
            doc_chunks[0] if doc_chunks else None,
        )
        if pos is None:
            continue
        questions.append(clean_text(ex["question"]))
        positives.append(clean_text(pos.text))

    def encode(texts, tag):
        return ensure_embedding_cache(texts, encoder.encode_text, cache_dir,
                                      model_name, tag=tag)

    if variant in ("vae", "dae"):
        emb = encode(positives, f"squad_{variant}")
        if variant == "vae":
            return {"x": emb, "y": emb}
        noisy = emb + rng.normal(0.0, noise_std, emb.shape).astype(np.float32)
        return {"x": noisy, "y": emb}

    if variant == "cae":
        n = len(questions)
        if mine_hard_negatives:
            all_emb = encode(questions + positives, "squad_cae_qp")
            return {"q": all_emb[:n], "p": all_emb[n:]}
        triples = build_contrastive_triples(
            questions, positives, rng, max_jaccard=max_jaccard
        )
        all_emb = encode([t[0] for t in triples] + [t[1] for t in triples]
                         + [t[2] for t in triples], "squad_cae")
        return {"q": all_emb[:n], "p": all_emb[n:2 * n],
                "n": all_emb[2 * n:]}
    raise ValueError(f"unknown variant {variant!r}")


def split_dataset(
    data: Mapping[str, np.ndarray], val_split: float = 0.1, seed: int = 42
) -> tuple[dict, dict]:
    """Seeded shuffle split into (train, val): the first
    ``max(1, int(n * val_split))`` rows of ``default_rng(seed)``'s
    permutation are the validation set."""
    keys = list(data.keys())
    n = len(data[keys[0]])
    idx = np.random.default_rng(seed).permutation(n)
    n_val = max(1, int(n * val_split)) if n > 1 else 0
    val_idx, train_idx = idx[:n_val], idx[n_val:]
    train = {k: data[k][train_idx] for k in keys}
    val = {k: data[k][val_idx] for k in keys}
    return train, val


def save_training_arrays(data: Mapping[str, np.ndarray], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **data)


def load_training_arrays(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
