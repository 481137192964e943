"""The port's BM25 (``latentrag_torch.retrieval.bm25``) against the JAX
package's: tokens, fp32 scores bit for bit (the port scores a term's
posting list at once, the JAX package one posting at a time), and the
search and retrieve surfaces with and without filters."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from latentrag_torch.retrieval import BM25Retriever, tokenize
from latentrag_tpu.data import load_evaluation_data, synthetic_examples
from latentrag_tpu.retrieval.bm25 import BM25Retriever as JaxBM25
from latentrag_tpu.retrieval.bm25 import tokenize as jax_tokenize

WORDS = ["the", "Cells", "divide", "galaxies", "quasar", "jets", "a", "of",
         "energy", "x9", "2024", "rome", "aqueducts", "ünïcode", "it's"]
text = st.lists(st.sampled_from(WORDS), max_size=30).map(" ".join)


def _pair(corpus, metadata=None, **kw):
    t, j = BM25Retriever(**kw), JaxBM25(**kw)
    t.build_index(corpus, metadata=metadata)
    j.build_index(corpus, metadata=metadata)
    return t, j


def _synthetic(n=200):
    queries, corpus, _ = load_evaluation_data(synthetic_examples(n))
    return queries, corpus


@pytest.mark.parametrize("s", [
    "The cat's 3 hats, and THE dog!", "", "a an and the", "ünïcode Wörds 42x",
    "mixed-case_Tokens with.dots",
])
@pytest.mark.parametrize("stop", [True, False])
def test_tokenize_matches_jax(s, stop):
    assert tokenize(s, stop) == jax_tokenize(s, stop)


@pytest.mark.parametrize("k1,b", [(0.9, 0.4), (1.2, 0.75), (0.5, 0.0)])
def test_scores_bit_for_bit_on_synthetic_corpus(k1, b):
    queries, corpus = _synthetic()
    t, j = _pair(corpus, k1=k1, b=b)
    assert t._avgdl == j._avgdl and t._n_docs == j._n_docs
    for q in queries[:60] + ["unseen terms only", "", "the of and"]:
        got, want = t.score_query(q), j.score_query(q)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@settings(max_examples=120, deadline=None)
@given(corpus=st.lists(text, min_size=1, max_size=12),
       queries=st.lists(text, min_size=1, max_size=4))
def test_scores_bit_for_bit_on_random_texts(corpus, queries):
    t, j = _pair(corpus)
    for q in queries:
        np.testing.assert_array_equal(t.score_query(q).view(np.int32),
                                      j.score_query(q).view(np.int32))
    for k in (1, 3, 50):
        for got, want in zip(t.search(queries, k), j.search(queries, k)):
            np.testing.assert_array_equal(got, want)


FILTERS = [None, {"doc_ids": [3, 7, 11, 19]}, {"exclude_doc_ids": [0, 1, 2]},
           {"where": {"group": "even"}}, {"doc_ids": []},
           {"doc_ids": [5]}]


@pytest.mark.parametrize("flt", range(len(FILTERS)))
def test_search_and_retrieve_match_jax(flt):
    """Ids, scores and the -1 sentinels of slots a filter cannot fill."""
    queries, corpus = _synthetic(60)
    meta = [{"group": "even" if i % 2 == 0 else "odd"}
            for i in range(len(corpus))]
    t, j = _pair(corpus, metadata=meta)
    spec = FILTERS[flt]
    for k in (1, 10, 25):
        (ts, ti), (js, ji) = t.search(queries, k, spec), j.search(
            queries, k, spec)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ts, js)
        assert ti.dtype == ji.dtype and ts.dtype == js.dtype
        if spec is not None and spec.get("doc_ids") == []:
            assert (ti == -1).all()
    for q in queries[:10]:
        assert t.retrieve(q, 5, spec) == j.retrieve(q, 5, spec)
    empty = t.search([], 5, spec)
    want = j.search([], 5, spec)
    assert [a.shape for a in empty] == [a.shape for a in want]


def test_synthetic_recall_and_errors_match_jax():
    queries, corpus = _synthetic(120)
    t, j = _pair(corpus)
    _, idx = t.search(queries, 10)
    assert np.mean([i in row for i, row in enumerate(idx)]) > 0.9
    for r in (BM25Retriever(), JaxBM25()):
        with pytest.raises(RuntimeError, match="index not built"):
            r.score_query("q")
        with pytest.raises(ValueError, match="metadata entries"):
            r.build_index(["a", "b"], metadata=[{}])
