"""The port's inference chunkers (``latentrag_torch/data/chunking.py``)
against the JAX package's on the same texts and vocabulary: records equal
field by field, offsets included, through the C++ WordPiece (ASCII rows)
and the Python path (the rest)."""

import random

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from latentrag_tpu.data import chunking as jc
from latentrag_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from latentrag_torch.data import chunking as tc
from latentrag_torch.data import tokenizer as ttok
from latentrag_torch.data.tokenizer import WordPieceTokenizer

WORDS = ("the telescope observes distant galaxies and stars . mitochondria "
         "produce energy inside living cells ! markets react to interest "
         "rates ? volcanic eruptions reshape coastlines ; quantum : error "
         "correction scales").split()
UNICODE = "abcdefgh ij klmno 012 .,!? éüñà 漢字 \t\n ​ ́ —"


def _ascii_corpus(seed, n=40):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(0, 260))))
            for _ in range(n)]


def _unicode_corpus(seed, n=30):
    rng = random.Random(seed)
    return ["".join(rng.choice(UNICODE) for _ in range(rng.randint(5, 300)))
            for _ in range(n)]


def _tokenizers(corpus, native=True):
    jax_tok = JaxTokenizer.train_from_corpus(corpus, vocab_size=500,
                                             min_freq=1)
    return jax_tok, WordPieceTokenizer(dict(jax_tok.vocab), native=native)


_TOKS = _tokenizers(_ascii_corpus(5) + _unicode_corpus(6))


def _records(mod, tok, text, mode, **kw):
    if mode == "sliding":
        return mod.sliding_window_chunker(
            text, tok, kw["max_tokens"], kw["stride"], doc_id=7)
    return mod.semantic_window_chunker(
        text, tok, kw["max_tokens"], kw["min_tokens"], doc_id=7)


@pytest.mark.parametrize("mode", ["sliding", "semantic"])
@pytest.mark.parametrize("corpus", ["ascii", "unicode"])
@pytest.mark.parametrize("window", [(16, 8, 4), (128, 64, 48), (12, 12, 12)])
def test_records_match_jax(mode, corpus, window):
    texts = (_ascii_corpus(0) if corpus == "ascii" else _unicode_corpus(11))
    jax_tok, tok = _tokenizers(texts)
    max_tokens, stride, min_tokens = window
    kw = dict(max_tokens=max_tokens, stride=stride, min_tokens=min_tokens)
    ttok.reset_rows_served()
    n = 0
    for text in texts:
        want = _records(jc, jax_tok, text, mode, **kw)
        got = _records(tc, tok, text, mode, **kw)
        assert [vars(r) for r in got] == [vars(r) for r in want], text
        for r in got:
            assert r.text == text[r.char_start:r.char_end]
            assert r.tok_end - r.tok_start <= max_tokens
        n += len(got)
    assert n > len(texts)
    # the ASCII corpus goes through the C++ WordPiece, the other through
    # Python (its rows all hold a non-ASCII character or more)
    path = "native" if corpus == "ascii" else "python"
    assert ttok.rows_served[path] > 0


@pytest.mark.parametrize("mode", ["sliding", "semantic"])
def test_both_tokenizer_paths_give_the_same_records(mode):
    texts = _ascii_corpus(3)
    _, native = _tokenizers(texts)
    _, python = _tokenizers(texts, native=False)
    for text in texts:
        got = _records(tc, native, text, mode, max_tokens=20, stride=7,
                       min_tokens=5)
        want = _records(tc, python, text, mode, max_tokens=20, stride=7,
                        min_tokens=5)
        assert got == want


@settings(max_examples=40, deadline=None)
@given(text=st.lists(st.sampled_from(list(UNICODE) + WORDS),
                    max_size=60).map(" ".join),
       max_tokens=st.integers(1, 24), stride=st.integers(1, 24),
       min_tokens=st.integers(0, 24))
def test_records_match_jax_on_drawn_text(text, max_tokens, stride,
                                         min_tokens):
    jax_tok, tok = _TOKS
    for mode in ("sliding", "semantic"):
        if mode == "semantic" and min_tokens > max_tokens:
            continue
        kw = dict(max_tokens=max_tokens, stride=stride,
                  min_tokens=min_tokens)
        assert _records(tc, tok, text, mode, **kw) == [
            tc.ChunkRecord(**vars(r))
            for r in _records(jc, jax_tok, text, mode, **kw)]


def test_empty_text_and_invalid_bounds():
    jax_tok, tok = _TOKS
    assert tc.sliding_window_chunker("", tok) == []
    assert tc.semantic_window_chunker("", tok) == []
    assert tc.semantic_window_chunker("  \t ", tok) == []
    with pytest.raises(ValueError, match="min_tokens"):
        tc.semantic_window_chunker("a b c", tok, max_tokens=4, min_tokens=5)
    with pytest.raises(ValueError, match="stride"):
        tc.sliding_window_chunker("a b c", tok, stride=0)
    with pytest.raises(ValueError, match="mode"):
        tc.build_inference_corpus(["a"], None, tok, mode="paragraph")


@pytest.mark.parametrize("mode", ["sliding", "semantic"])
def test_inference_corpus_carries_doc_ids(mode):
    jax_tok, tok = _TOKS
    texts = _ascii_corpus(9, n=12) + [""]
    ids = [f"d{i}" for i in range(len(texts))]
    kw = dict(mode=mode, max_tokens=24, stride=12, min_tokens=8)
    got = tc.build_inference_corpus(texts, ids, tok, **kw)
    want = jc.build_inference_corpus(texts, ids, jax_tok, **kw)
    assert [vars(r) for r in got] == [vars(r) for r in want]
    assert {r.doc_id for r in got} == {d for d, t in zip(ids, texts)
                                       if t.split()}
    # no doc ids: the positions
    plain = tc.build_inference_corpus(texts, None, tok, **kw)
    assert [r.doc_id for r in plain] == [int(r.doc_id[1:]) for r in got]


def test_char_to_token_span_matches_jax():
    jax_tok, tok = _TOKS
    text = _ascii_corpus(2, n=1)[0]
    offsets = tok.encode(text, add_special_tokens=False).offsets
    rng = np.random.default_rng(4)
    for _ in range(50):
        a, b = sorted(int(x) for x in rng.integers(0, len(text) + 2, 2))
        assert tc._char_to_token_span(offsets, a, b) == \
            jc._char_to_token_span(offsets, a, b)
