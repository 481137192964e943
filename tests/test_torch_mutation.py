"""Live ``add`` / ``remove`` in the port against the JAX package, on the
CPU: the same sequence of mutations, with metadata, gives the same ids,
scores, metadata and fingerprint (``live_mutations``, no corpus digest);
survivors' scores do not change at all; new rows take the build's
whitener and SQ8 scale; a mutated store the port saves loads in the JAX
package. Every store lives under ``tmp_path``."""

import numpy as np
import pytest
import torch

from latentrag_tpu.retrieval.dense import DenseRetriever as JaxDense
from latentrag_torch.retrieval import DenseRetriever

D = 16
STORES = [("float32", "cosine"), ("float32", "mahalanobis"),
          ("bfloat16", "euclidean"), ("binary", "cosine")]


def _rows(rng, n, d=D):
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[:, 0] *= 2.5
    return x


def _backend(store):
    return "xla" if store == "binary" else "xla_exact"


def _mutate(r, extra, extra2):
    """One sequence of mutations: add with metadata, remove (an unknown id
    too), add without metadata, remove again."""
    r.add(extra, [f"new {i}" for i in range(len(extra))],
          doc_ids=[f"n{i}" for i in range(len(extra))],
          metadata=[{"src": "live", "i": i} for i in range(len(extra))])
    assert r.remove([3, 7, "n1", 999]) == 3
    r.add(extra2, ["late a", "late b"])
    assert r.remove([0]) == 1


@pytest.mark.parametrize("store,metric", STORES)
def test_mutation_sequence_matches_jax(rng, tmp_path, store, metric):
    base = _rows(rng, 200)
    extra, extra2 = _rows(rng, 6), _rows(rng, 2)
    texts = [f"doc {i}" for i in range(200)]
    md = [{"src": "build", "i": i} for i in range(200)]
    j = JaxDense(metric=metric, backend=_backend(store), store_dtype=store)
    j.build(base, texts, metadata=md, fingerprint={"embedding_model": "m"})
    t = DenseRetriever(metric=metric, store_dtype=store, device="cpu",
                       index_path=str(tmp_path / "idx"))
    t.build(base, texts, metadata=md, fingerprint={"embedding_model": "m"})
    for r in (j, t):
        _mutate(r, extra, extra2)
    assert t.texts == list(j.texts) and t.doc_ids == j.doc_ids
    assert t.metadata == j.metadata
    assert t.fingerprint == j.fingerprint
    assert t.fingerprint["live_mutations"] == 4
    assert "corpus_digest" not in t.fingerprint
    q = np.concatenate([extra[[0, 4]], base[[5, 50]], extra2[:1]])
    s_j, i_j = j.search(q, 6)
    s_t, i_t = t.search(q, 6)
    np.testing.assert_array_equal(i_t, i_j)
    tol = 2e-2 if store == "bfloat16" else 1e-5
    np.testing.assert_allclose(s_t, s_j, rtol=tol, atol=tol)
    if store == "binary":
        np.testing.assert_array_equal(t._rescore_host, j._rescore_host)
        np.testing.assert_array_equal(t._corpus.numpy().view(np.uint32),
                                      np.asarray(j._corpus_dev))
    # an added row's own embedding retrieves it first; removed ids never
    # come back
    assert t.doc_ids[i_t[0, 0]] == "n0"
    assert not {3, 7, "n1", 0} & {t.doc_ids[i] for i in i_t.ravel() if i >= 0}
    # the save after the last mutation loads in the JAX package
    j2 = JaxDense(metric=metric, backend=_backend(store), store_dtype=store,
                  index_path=str(tmp_path / "idx"))
    assert j2.is_built and j2.fingerprint == t.fingerprint
    assert j2.metadata == t.metadata and j2.doc_ids == t.doc_ids
    s_2, i_2 = j2.search(q, 6)
    np.testing.assert_array_equal(i_2, i_t)
    np.testing.assert_allclose(s_2, s_t, rtol=tol, atol=tol)
    # a filter over the mutated metadata
    _, i_f = t.search(q, 6, filter={"where": {"src": "live"}})
    _, i_fj = j.search(q, 6, filter={"where": {"src": "live"}})
    np.testing.assert_array_equal(i_f, i_fj)


@pytest.mark.parametrize("store,metric", STORES)
def test_survivor_scores_unchanged_bit_for_bit(rng, store, metric):
    """remove() gathers the survivors as they are: each survivor's score
    for a query is the same float before and after, and the whitener and
    SQ8 scale stay."""
    base = _rows(rng, 300)
    t = DenseRetriever(metric=metric, store_dtype=store, device="cpu",
                       backend="xla" if store == "binary" else "xla_exact")
    t.build(base, [str(i) for i in range(300)])
    whitener, scale = t._whitener, t._corpus_scale
    q = base[[10, 200]]
    s0, i0 = t.search(q, 300)
    before = {(qi, int(i)): s for qi in range(2)
              for s, i in zip(s0[qi], i0[qi]) if i >= 0}
    dropped = list(range(0, 300, 3))
    t.remove(dropped)
    assert t._whitener is whitener and t._corpus_scale == scale
    s1, i1 = t.search(q, 300)
    for qi in range(2):
        for s, i in zip(s1[qi], i1[qi]):
            if i < 0:
                continue
            row = int(t.doc_ids[i])
            assert row not in dropped
            assert (qi, row) in before and before[(qi, row)] == s


def test_add_uses_the_build_transform(rng):
    """New rows are whitened with the build's factor and quantized at the
    build's SQ8 scale, so adding rows changes no earlier row's score."""
    base = _rows(rng, 100)
    new = _rows(rng, 4) * 10.0  # far outside the build's spread
    t = DenseRetriever(metric="mahalanobis", store_dtype="float32",
                       device="cpu")
    t.build(base, [str(i) for i in range(100)])
    w = t._whitener.clone()
    s0, _ = t.search(base[:3], 1)
    t.add(new, ["a", "b", "c", "d"])
    torch.testing.assert_close(t._whitener, w)
    s1, i1 = t.search(base[:3], 1)
    np.testing.assert_array_equal(s1, s0)
    tb = DenseRetriever(store_dtype="binary", device="cpu")
    tb.build(base, [str(i) for i in range(100)])
    scale = tb._corpus_scale
    tb.add(new, ["a", "b", "c", "d"])
    assert tb._corpus_scale == scale
    unit = new / np.linalg.norm(new, axis=1, keepdims=True)
    want = np.clip(np.round(unit / np.float32(scale)), -127, 127)
    np.testing.assert_array_equal(tb._rescore_host[100:], want)
    assert tb._corpus.shape == (104, 1) and tb._rescore_host.shape == (104, D)


def test_mutation_guards(rng):
    t = DenseRetriever(store_dtype="float32", device="cpu")
    with pytest.raises(RuntimeError, match="build"):
        t.add(_rows(rng, 1), ["x"])
    with pytest.raises(RuntimeError, match="build"):
        t.remove([0])
    t.build(_rows(rng, 5), list("abcde"), fingerprint={"embedding_model": "m"})
    with pytest.raises(ValueError, match="dim"):
        t.add(_rows(rng, 1, D + 1), ["x"])
    with pytest.raises(ValueError, match="mismatch"):
        t.add(_rows(rng, 2), ["x"])
    with pytest.raises(ValueError, match="metadata"):
        t.add(_rows(rng, 1), ["x"], metadata=[{}, {}])
    assert t.remove([42]) == 0 and t.fingerprint.get("live_mutations") is None
    with pytest.raises(ValueError, match="every document"):
        t.remove([0, 1, 2, 3, 4])
    assert len(t.texts) == 5
    assert t.remove([1]) == 1 and t.remove([1]) == 0


def test_add_after_a_lazy_load_materialises(rng, tmp_path):
    path = str(tmp_path / "idx")
    base = _rows(rng, 40)
    DenseRetriever(store_dtype="float32", device="cpu",
                   index_path=path).build(base, [f"t{i}" for i in range(40)])
    t = DenseRetriever(store_dtype="float32", device="cpu", index_path=path)
    assert not isinstance(t.texts, list)
    t.add(-base[:2], ["added a", "added b"], doc_ids=["xa", "xb"])
    assert isinstance(t.texts, list) and t.texts[-1] == "added b"
    t2 = DenseRetriever(store_dtype="float32", device="cpu", index_path=path)
    assert len(t2.texts) == 42 and t2.doc_ids[-1] == "xb"
    j = JaxDense(backend="xla_exact", store_dtype="float32", index_path=path)
    assert j.doc_ids[-1] == "xb" and j.fingerprint["live_mutations"] == 1
