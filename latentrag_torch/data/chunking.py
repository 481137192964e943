"""Document chunking: the inference-time sliding-window and semantic
chunkers, and the training-time answer-aware chunker.

The port of the JAX package's ``data/chunking.py`` for what
``PipelineRunner.process`` needs (``chunking.enabled``): token windows cut
on the tokenizer's exact char offsets, so a chunk's text never splits a
word, each record carrying its doc id for doc-level MaxSim.

* ``sliding_window_chunker``: ``max_tokens`` windows every ``stride``
  tokens;
* ``semantic_window_chunker``: window ends snapped to the last
  sentence-final punctuation token within ``[min_tokens, max_tokens]``;
* ``build_inference_corpus``: either one over a corpus;
* ``chunk_context_with_alignment`` / ``build_chunked_corpus``: the
  training-time chunker, a window centred on the answer plus sliding
  windows, each record marking whether it holds the answer
  (``data.squad.prepare_training_arrays`` takes each example's first such
  chunk as its positive).

Records equal the JAX package's field by field, offsets included, through
either tokenizer path (the C++ WordPiece for ASCII text, Python for the
rest: both give the same offsets). ``save_chunk_index`` /
``load_chunk_index`` keep records in the JAX package's parquet file (one
row a record; through pandas and pyarrow, imported at the call).
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Sequence

from .tokenizer import WordPieceTokenizer

log = logging.getLogger("latentrag_torch.data")

_SENT_PUNCT = (".", "!", "?", ";", ":")


@dataclass(frozen=True)
class ChunkRecord:
    doc_id: int | str
    chunk_id: int
    text: str
    tok_start: int
    tok_end: int  # exclusive
    char_start: int
    char_end: int  # exclusive
    contains_answer: bool = False


def _body_tokens(tokenizer: WordPieceTokenizer, text: str):
    """Tokenize without special tokens; returns (tokens, offsets)."""
    enc = tokenizer.encode(text, add_special_tokens=False)
    return enc.tokens, enc.offsets


def _char_to_token_span(
    offsets: Sequence[tuple[int, int]], char_start: int, char_end: int
) -> tuple[int, int] | None:
    """Token [start, end) covering the char span; None if not alignable."""
    tok_start = tok_end = None
    for i, (s, e) in enumerate(offsets):
        if e <= s:
            continue
        if tok_start is None and e > char_start:
            tok_start = i
        if s < char_end:
            tok_end = i + 1
    if tok_start is None or tok_end is None or tok_start >= tok_end:
        return None
    return tok_start, tok_end


def _window_record(
    text: str,
    offsets: Sequence[tuple[int, int]],
    doc_id,
    chunk_id: int,
    tok_start: int,
    tok_end: int,
) -> ChunkRecord:
    char_start = offsets[tok_start][0]
    char_end = offsets[tok_end - 1][1]
    return ChunkRecord(
        doc_id=doc_id,
        chunk_id=chunk_id,
        text=text[char_start:char_end],
        tok_start=tok_start,
        tok_end=tok_end,
        char_start=char_start,
        char_end=char_end,
    )


def sliding_window_chunker(
    text: str,
    tokenizer: WordPieceTokenizer,
    max_tokens: int = 128,
    stride: int = 64,
    doc_id=0,
) -> list[ChunkRecord]:
    """Token windows of ``max_tokens`` every ``stride`` tokens."""
    if stride <= 0:
        raise ValueError("stride must be positive")
    _, offsets = _body_tokens(tokenizer, text)
    n = len(offsets)
    records = []
    start = 0
    while start < n:
        end = min(start + max_tokens, n)
        records.append(
            _window_record(text, offsets, doc_id, len(records), start, end))
        if end == n:
            break
        start += stride
    return records


def semantic_window_chunker(
    text: str,
    tokenizer: WordPieceTokenizer,
    max_tokens: int = 128,
    min_tokens: int = 48,
    doc_id=0,
) -> list[ChunkRecord]:
    """Windows whose ends snap to sentence punctuation in
    ``[min_tokens, max_tokens]`` when one exists; hard cut otherwise."""
    if min_tokens > max_tokens:
        raise ValueError("min_tokens must be <= max_tokens")
    tokens, offsets = _body_tokens(tokenizer, text)
    n = len(tokens)
    records = []
    start = 0
    while start < n:
        end = min(start + max_tokens, n)
        if end < n:  # snap to the last punctuation token in the window
            for i in range(end - 1, start + min_tokens - 1, -1):
                if tokens[i] in _SENT_PUNCT:
                    end = i + 1  # the punctuation stays in this chunk
                    break
        records.append(
            _window_record(text, offsets, doc_id, len(records), start, end))
        start = end
    return records


def build_inference_corpus(
    texts: Sequence[str],
    doc_ids: Sequence | None,
    tokenizer: WordPieceTokenizer,
    mode: str = "sliding",
    max_tokens: int = 128,
    stride: int = 64,
    min_tokens: int = 48,
) -> list[ChunkRecord]:
    """Chunk an inference corpus; ``mode`` in {'sliding', 'semantic'}."""
    if mode not in ("sliding", "semantic"):
        raise ValueError(f"unknown chunking mode {mode!r}")
    if doc_ids is None:
        doc_ids = range(len(texts))
    out: list[ChunkRecord] = []
    for text, did in zip(texts, doc_ids):
        if mode == "sliding":
            out.extend(sliding_window_chunker(
                text, tokenizer, max_tokens, stride, doc_id=did))
        else:
            out.extend(semantic_window_chunker(
                text, tokenizer, max_tokens, min_tokens, doc_id=did))
    return out


def chunk_context_with_alignment(
    context: str,
    answer_text: str,
    answer_char_start: int,
    tokenizer: WordPieceTokenizer,
    max_tokens: int = 128,
    stride: int = 64,
    doc_id=0,
) -> list[ChunkRecord]:
    """Answer-aware training chunker.

    A window centred on the answer's token span, then sliding windows,
    deduplicated by token span. A window holds the answer when it covers
    the answer's span or its text contains the answer text. If no window
    holds it, the full context is appended as a last chunk; if the answer
    span cannot be aligned, or the context fits one window, the full
    context is the single chunk."""
    tokens, offsets = _body_tokens(tokenizer, context)
    n = len(tokens)

    def full_context(chunk_id: int) -> ChunkRecord:
        return ChunkRecord(doc_id=doc_id, chunk_id=chunk_id, text=context,
                           tok_start=0, tok_end=n, char_start=0,
                           char_end=len(context), contains_answer=True)

    if n <= max_tokens:
        return [full_context(0)]
    span = _char_to_token_span(offsets, answer_char_start,
                               answer_char_start + len(answer_text))
    if span is None:
        log.debug("answer span alignment failed; full-context fallback")
        return [full_context(0)]
    a_start, a_end = span

    centre = (a_start + a_end) // 2
    w_start = max(0, min(centre - max_tokens // 2, n - max_tokens))
    windows = [(w_start, w_start + max_tokens)]
    s = 0
    while s < n:
        e = min(s + max_tokens, n)
        windows.append((s, e))
        if e == n:
            break
        s += stride

    seen: set[tuple[int, int]] = set()
    records: list[ChunkRecord] = []
    for ws, we in windows:
        if (ws, we) in seen:
            continue
        seen.add((ws, we))
        rec = _window_record(context, offsets, doc_id, len(records), ws, we)
        # the text check catches answers repeated elsewhere
        contains = (ws <= a_start and a_end <= we) or (
            answer_text.lower() in rec.text.lower())
        records.append(dataclasses.replace(rec, contains_answer=contains))

    if not any(r.contains_answer for r in records):
        log.debug("answer lost by chunking; re-appending full context")
        records.append(full_context(len(records)))
    return records


def build_chunked_corpus(
    examples: Sequence[dict],
    tokenizer: WordPieceTokenizer,
    max_tokens: int = 128,
    stride: int = 64,
) -> list[ChunkRecord]:
    """Answer-aware chunks for training examples
    ({context, answer_text, answer_start, doc_id})."""
    out: list[ChunkRecord] = []
    for ex in examples:
        out.extend(chunk_context_with_alignment(
            ex["context"], ex.get("answer_text", ""),
            ex.get("answer_start", 0), tokenizer, max_tokens=max_tokens,
            stride=stride, doc_id=ex.get("doc_id", 0)))
    return out


def save_chunk_index(records: Sequence[ChunkRecord], path: str) -> None:
    """Write ``records`` as a parquet table (pandas, at the call)."""
    import pandas as pd

    pd.DataFrame([dataclasses.asdict(r) for r in records]).to_parquet(path)


def load_chunk_index(path: str) -> list[ChunkRecord]:
    """The records of a parquet chunk index (either package's)."""
    import pandas as pd

    df = pd.read_parquet(path)
    return [ChunkRecord(**row) for row in df.to_dict("records")]
