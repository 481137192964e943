"""The port's training data (``latentrag_torch/data/processing.py``,
``cache.py``, the training-time chunker and ``squad.py``'s training
arrays) against the JAX package's on the same seeds and texts: noised
strings and mined triples string for string, cache digests and file
names, answer-aware chunk records field for field, and the assembled
arrays bit for bit from one stub encoder."""

import hashlib
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from latentrag_tpu.data import cache as jcache
from latentrag_tpu.data import chunking as jc
from latentrag_tpu.data import processing as jp
from latentrag_tpu.data import squad as jsquad
from latentrag_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from latentrag_torch.data import cache as tcache
from latentrag_torch.data import chunking as tc
from latentrag_torch.data import processing as tp
from latentrag_torch.data import squad as tsquad
from latentrag_torch.data.tokenizer import WordPieceTokenizer

WORDS = ("the telescope observes distant galaxies and stars . mitochondria "
         "produce energy inside living cells ! markets react to interest "
         "rates ? volcanic eruptions reshape coastlines ; quantum : error "
         "correction scales").split()


def _texts(seed, n=30, longest=60):
    rng = np.random.default_rng(seed)
    return ["  ".join(rng.choice(WORDS, size=int(rng.integers(0, longest))))
            + ("\t\n" if i % 3 else "") for i in range(n)]


_EXAMPLES = jsquad.synthetic_examples(48, seed=3)
_JTOK = JaxTokenizer.train_from_corpus(
    [e["context"] for e in _EXAMPLES] + _texts(9), vocab_size=400)
_TOK = WordPieceTokenizer(dict(_JTOK.vocab))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("probs", [(0.1, 0.1), (0.5, 0.3), (1.0, 0.0)])
def test_processing_matches_jax(seed, probs):
    texts = _texts(seed)
    assert [tp.clean_text(t) for t in texts] == [jp.clean_text(t)
                                                  for t in texts]
    drop, swap = probs
    got = tp.build_dae_dataset(texts, np.random.default_rng(seed), drop, swap)
    want = jp.build_dae_dataset(texts, np.random.default_rng(seed), drop,
                                swap)
    assert got == want
    a, b = texts[0], texts[1]
    assert tp.jaccard_similarity(a, b) == jp.jaccard_similarity(a, b)
    assert tp.jaccard_similarity("", "") == jp.jaccard_similarity("", "")
    qs, ps = _texts(seed + 10, n=20), _texts(seed + 20, n=20)
    for max_jaccard in (0.1, 0.6):
        assert tp.build_contrastive_triples(
            qs, ps, np.random.default_rng(seed), max_jaccard=max_jaccard
        ) == jp.build_contrastive_triples(
            qs, ps, np.random.default_rng(seed), max_jaccard=max_jaccard)
    with pytest.raises(ValueError, match="mismatch"):
        tp.build_contrastive_triples(qs, ps[:3], np.random.default_rng(0))


def _stub_vectors(texts, dim=12):
    """Fixed vectors a text, from its sha1: the same in both packages."""
    return np.stack([
        np.random.default_rng(int(hashlib.sha1(t.encode()).hexdigest()[:8],
                                  16)).standard_normal(dim).astype(np.float32)
        for t in texts]) if texts else np.zeros((0, dim), np.float32)


class _Stub:
    """A compressor stand-in; the port's returns a tensor, as the port's
    ``EmbeddingCompressor`` does."""

    def __init__(self, as_tensor):
        self.as_tensor = as_tensor
        self.calls = 0

    def encode_text(self, texts):
        self.calls += 1
        v = _stub_vectors(list(texts))
        return torch.from_numpy(v) if self.as_tensor else v


def test_cache_digest_names_and_cross_hits(tmp_path):
    texts = _texts(4)
    assert (tcache.texts_fingerprint(texts, "m")
            == jcache.texts_fingerprint(texts, "m"))
    assert (tcache.texts_fingerprint(texts[:-1], "m")
            != tcache.texts_fingerprint(texts, "m"))
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    want = jcache.ensure_embedding_cache(texts, _Stub(False).encode_text,
                                         jdir, "m", tag="x")
    stub = _Stub(True)
    got = tcache.ensure_embedding_cache(texts, stub.encode_text, tdir, "m",
                                        tag="x")
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    # each package's file is a hit for the other: no encode
    hit = tcache.ensure_embedding_cache(texts, stub.encode_text, jdir, "m",
                                        tag="x")
    assert stub.calls == 1 and np.array_equal(hit, want)
    jstub = _Stub(False)
    jhit = jcache.ensure_embedding_cache(texts, jstub.encode_text, tdir, "m",
                                         tag="x")
    assert jstub.calls == 0 and np.array_equal(jhit, want)
    # an unreadable file is re-encoded and rewritten
    path = os.path.join(tdir, os.listdir(tdir)[0])
    with open(path, "wb") as f:
        f.write(b"not an npz")
    again = tcache.ensure_embedding_cache(texts, stub.encode_text, tdir, "m",
                                          tag="x")
    assert stub.calls == 2 and np.array_equal(again, want)


def _chunk_pair(ex, max_tokens, stride):
    args = (ex["context"], ex["answer_text"], ex["answer_start"])
    kw = dict(max_tokens=max_tokens, stride=stride, doc_id=ex["doc_id"])
    return (tc.chunk_context_with_alignment(*args, _TOK, **kw),
            jc.chunk_context_with_alignment(*args, _JTOK, **kw))


@pytest.mark.parametrize("window", [(8, 4), (12, 5), (16, 16), (128, 64)])
def test_training_chunks_match_jax(window):
    max_tokens, stride = window
    n = 0
    for ex in _EXAMPLES:
        got, want = _chunk_pair(ex, max_tokens, stride)
        assert [vars(r) for r in got] == [vars(r) for r in want]
        assert any(r.contains_answer for r in got)
        n += len(got)
    got = tc.build_chunked_corpus(_EXAMPLES, _TOK, max_tokens, stride)
    want = jc.build_chunked_corpus(_EXAMPLES, _JTOK, max_tokens, stride)
    assert [vars(r) for r in got] == [vars(r) for r in want]
    assert len(got) == n


@settings(max_examples=60, deadline=None)
@given(words=st.lists(st.sampled_from(WORDS), max_size=50),
       span=st.tuples(st.integers(0, 60), st.integers(1, 4)),
       shift=st.integers(-3, 3), max_tokens=st.integers(1, 20),
       stride=st.integers(1, 20))
def test_training_chunks_match_jax_on_drawn_text(words, span, shift,
                                                 max_tokens, stride):
    """Answers drawn from the text, with the start moved off it at times
    (an unaligned span, or one the text check must find)."""
    context = " ".join(words)
    start, length = span
    start = min(start, len(words))
    answer = " ".join(words[start:start + length])
    char = len(" ".join(words[:start])) + (1 if start else 0)
    ex = {"context": context, "answer_text": answer,
          "answer_start": max(0, char + shift), "doc_id": 5}
    got, want = _chunk_pair(ex, max_tokens, stride)
    assert got == [tc.ChunkRecord(**vars(r)) for r in want]


def _arrays(mod, tok, stub, variant, cache_dir, mined):
    return mod.prepare_training_arrays(
        _EXAMPLES, stub, tok, variant, cache_dir, chunk_max_tokens=16,
        chunk_stride=8, seed=7, model_name="stub", noise_std=0.05,
        mine_hard_negatives=mined)


@pytest.mark.parametrize("variant,mined", [("vae", False), ("dae", False),
                                           ("cae", False), ("cae", True)])
def test_prepare_training_arrays_bit_for_bit(tmp_path, variant, mined):
    want = _arrays(jsquad, _JTOK, _Stub(False), variant, str(tmp_path / "j"),
                   mined)
    got = _arrays(tsquad, _TOK, _Stub(True), variant, str(tmp_path / "t"),
                  mined)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k])
    assert sorted(got) == {"vae": ["x", "y"], "dae": ["x", "y"],
                           "cae": ["p", "q"] if mined else ["n", "p", "q"]
                           }[variant]
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))
    train, val = tsquad.split_dataset(got, 0.25, seed=3)
    jtrain, jval = jsquad.split_dataset(want, 0.25, seed=3)
    for k in want:
        assert np.array_equal(train[k], jtrain[k])
        assert np.array_equal(val[k], jval[k])
    path = str(tmp_path / "arrays" / "a.npz")
    tsquad.save_training_arrays(got, path)
    loaded = jsquad.load_training_arrays(path)
    assert all(np.array_equal(loaded[k], got[k]) for k in got)
    back = tsquad.load_training_arrays(path)
    assert all(np.array_equal(back[k], got[k]) for k in got)


@pytest.mark.parametrize("n,val_split", [(1, 0.1), (2, 0.1), (10, 0.0),
                                         (37, 0.3)])
def test_split_dataset_matches_jax(n, val_split):
    data = {"x": np.arange(n * 3, dtype=np.float32).reshape(n, 3),
            "y": np.arange(n, dtype=np.float32)}
    got = tsquad.split_dataset(data, val_split, seed=11)
    want = jsquad.split_dataset(data, val_split, seed=11)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert all(np.array_equal(g[k], w[k]) for k in w)


def test_prepare_training_arrays_rejects_unknown_variant(tmp_path):
    with pytest.raises(ValueError, match="unknown variant"):
        _arrays(tsquad, _TOK, _Stub(True), "pca", str(tmp_path), False)
