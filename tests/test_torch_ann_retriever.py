"""The port's ``ANNRetriever`` (``latentrag_torch.retrieval.ann_retriever``)
against the JAX package's, on the CPU: the recall bands of the JAX
package's own tests (``tests/test_native_ann.py``), filters, ``add``,
persistence in the JAX package's files both ways, and the fingerprint and
provenance rules. Beam-built HNSW graphs link on several threads, so they
are held by recall; IVF-PQ's host build is single-threaded and is held
bit for bit."""

import logging

import numpy as np
import pytest
import torch

from latentrag_tpu.retrieval import build_retriever as jax_build
from latentrag_tpu.retrieval.ann_retriever import ANNRetriever as JaxANN
from latentrag_tpu.utils.config import RetrievalConfig as JaxCfg
from latentrag_torch.retrieval import (
    DenseRetriever,
    build_retriever,
    load_retriever,
)
from latentrag_torch.retrieval.ann_retriever import ANNRetriever
from latentrag_torch.utils.config import RetrievalConfig


def _normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def corpus():
    return _normed(np.random.default_rng(0), 2000, 32)


@pytest.fixture(scope="module")
def queries():
    return _normed(np.random.default_rng(1), 50, 32)


def _recall(got, ref, k=10):
    return np.mean([len(set(ref[i]) & set(got[i])) / k
                    for i in range(len(ref))])


def _exact(q, c, k):
    return np.argsort(-(q @ c.T), axis=1)[:, :k]


def _pair(kind, **kw):
    """The port's retriever on the CPU and the JAX package's, one config."""
    return (ANNRetriever(RetrievalConfig(backend=kind, **kw), kind,
                         device="cpu"),
            JaxANN(JaxCfg(backend=kind, **kw), kind))


@pytest.mark.parametrize("build", ["beam", "knn"])
def test_hnsw_recall_band(corpus, queries, build):
    t, j = _pair("hnsw", index_path="", hnsw_m=16,
                 hnsw_ef_construction=100, hnsw_build=build)
    texts = [f"t{i}" for i in range(2000)]
    t.build(corpus, texts)
    j.build(corpus, texts)
    ref = _exact(queries, corpus, 10)
    r_t = _recall(t.search(queries, 10)[1], ref)
    r_j = _recall(j.search(queries, 10)[1], ref)
    assert r_t >= 0.9 and r_t >= r_j - 0.05, (r_t, r_j)
    assert t.build_split["mode"] == build
    if build == "knn":  # the k-NN stage on the retriever's device
        assert t.build_split["knn"]["blocks"] == 1
        assert set(t.build_split) >= {"knn_s", "assemble_s"}


@pytest.mark.parametrize("refine", [0, 8])
def test_ivfpq_matches_jax(corpus, queries, refine):
    """Host build (one thread): the same answers as the JAX retriever;
    refinement lifts recall to the JAX test's 0.95 and scores exactly."""
    t, j = _pair("ivfpq", index_path="", ivfpq_nlist=16, ivfpq_m=8,
                 ivfpq_nprobe=16, ivfpq_refine=refine)
    texts = [f"t{i}" for i in range(2000)]
    t.build(corpus, texts)
    j.build(corpus, texts)
    s_t, i_t = t.search(queries, 10)
    s_j, i_j = j.search(queries, 10)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_array_equal(s_t, s_j)
    r = _recall(i_t, _exact(queries, corpus, 10))
    if refine:
        assert r >= 0.95
        sims = queries @ corpus.T
        assert np.allclose(s_t, np.take_along_axis(sims, i_t, axis=1),
                           atol=1e-5)
        assert (np.diff(s_t, axis=1) <= 1e-6).all()
    else:
        assert r >= 0.5


def test_ivfpq_device_build_matches_jax_band(corpus, queries):
    """``ivfpq_build=device`` on the CPU: the port's device trainer, held
    to the JAX package's device build by recall (its seeds differ)."""
    t, j = _pair("ivfpq", index_path="", ivfpq_nlist=16, ivfpq_m=8,
                 ivfpq_nprobe=8, ivfpq_refine=0, ivfpq_build="device",
                 ivfpq_train_iters=8)
    texts = [f"t{i}" for i in range(2000)]
    t.build(corpus, texts)
    j.build(corpus, texts)
    ref = _exact(queries, corpus, 10)
    r_t = _recall(t.search(queries, 10)[1], ref)
    r_j = _recall(j.search(queries, 10)[1], ref)
    assert r_t >= 0.5 and r_t >= r_j - 0.05, (r_t, r_j)
    assert set(t.build_split) >= {"train_s", "encode_s", "add_s"}


def test_refine_euclidean_exact_scores():
    rng = np.random.default_rng(3)
    c = rng.standard_normal((500, 16)).astype(np.float32)
    q = rng.standard_normal((20, 16)).astype(np.float32)
    t, j = _pair("ivfpq", index_path="", metric="euclidean", ivfpq_nlist=8,
                 ivfpq_m=8, ivfpq_nprobe=8, ivfpq_refine=8)
    t.build(c, [f"t{i}" for i in range(500)])
    j.build(c, [f"t{i}" for i in range(500)])
    s, i = t.search(q, 5)
    d2 = ((q[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    assert np.allclose(s, -np.take_along_axis(d2, i, axis=1), atol=1e-3)
    np.testing.assert_array_equal(i, j.search(q, 5)[1])


def test_nprobe_knob_and_sentinels(corpus):
    t, _ = _pair("ivfpq", index_path="", ivfpq_nlist=16, ivfpq_m=8,
                 ivfpq_nprobe=5)
    t.build(corpus, [f"t{i}" for i in range(2000)])
    assert t._nprobe == 5
    auto, _ = _pair("ivfpq", index_path="", ivfpq_nlist=4096, ivfpq_m=8,
                    ivfpq_nprobe=0)
    auto.build(corpus[:80], [f"t{i}" for i in range(80)])
    assert 1 <= auto._nprobe <= auto._index.nlist == 10
    rng = np.random.default_rng(4)
    c = _normed(rng, 24, 16)
    small, _ = _pair("ivfpq", index_path="", ivfpq_nlist=2, ivfpq_m=8,
                     ivfpq_nprobe=2, ivfpq_refine=4)
    small.build(c, [f"t{i}" for i in range(24)])
    s, i = small.search(_normed(rng, 3, 16), 30)
    assert i.shape == (3, 30) and (i < 24).all()
    assert np.isneginf(s[i < 0]).all() and (i >= 0).sum(axis=1).min() >= 1


@pytest.mark.parametrize("kind", ["hnsw", "ivfpq"])
def test_filters_and_add_match_jax(kind):
    """doc_ids, exclude and where filters, then an add with metadata:
    only allowed ids come back, the added row finds itself, and the IVF-PQ
    answers are the JAX retriever's."""
    rng = np.random.default_rng(7)
    c = _normed(rng, 600, 16)
    texts = [f"t{i}" for i in range(600)]
    ids = [i * 3 for i in range(600)]
    meta = [{"src": "a" if i % 4 else "b"} for i in range(600)]
    kw = dict(index_path="", hnsw_m=16, ivfpq_nlist=8, ivfpq_m=8,
              ivfpq_nprobe=8, ivfpq_refine=4)
    t, j = _pair(kind, **kw)
    t.build(c, texts, doc_ids=ids, metadata=meta)
    j.build(c, texts, doc_ids=ids, metadata=meta)
    q = c[:5] + 0.01
    specs = [{"doc_ids": [0, 3, 33, 1200]}, {"exclude_doc_ids": ids[:300]},
             {"where": {"src": "b"}}, {"doc_ids": [999999]}]
    for spec in specs:
        s_t, i_t = t.search(q, 4, filter=spec)
        s_j, i_j = j.search(q, 4, filter=spec)
        live = i_t[i_t >= 0]
        allowed = {0, 1, 11, 400} if "doc_ids" in spec else None
        if spec == {"doc_ids": [999999]}:
            assert (i_t == -1).all() and np.isneginf(s_t).all()
        elif allowed is not None:
            assert set(live.tolist()) <= allowed
        elif "where" in spec:
            assert all(meta[r]["src"] == "b" for r in live)
        else:
            assert (live >= 300).all()
        if kind == "ivfpq":
            np.testing.assert_array_equal(i_t, i_j)
    new = _normed(rng, 2, 16)
    for r in (t, j):
        r.add(new, ["new0", "new1"], doc_ids=[5000, 5001],
              metadata=[{"src": "live"}, {"src": "live"}])
    texts_t, _, ids_t = t.retrieve(torch.from_numpy(new[1]), top_k=2,
                                   filter={"where": {"src": "live"}})
    assert texts_t[0] == "new1" and ids_t == [5001, 5000]
    assert t.doc_ids == j.doc_ids and len(t.texts) == 602


def test_factory_dispatches_ann_and_bm25_still_refuses(corpus):
    for backend in ("hnsw", "ivfpq"):
        cfg = RetrievalConfig(backend=backend, index_path="")
        r = build_retriever(torch.from_numpy(corpus[:300]),
                            [f"t{i}" for i in range(300)], None, cfg,
                            device="cpu")
        assert isinstance(r, ANNRetriever)
        texts, _, doc_ids = r.retrieve(corpus[5], top_k=3)
        assert texts[0] == "t5" and doc_ids[0] == 5
        assert r.get_stats()["search_calls"] == 1
        j = jax_build(corpus[:300], [f"t{i}" for i in range(300)], None,
                      JaxCfg(backend=backend, index_path=""))
        assert j.retrieve(corpus[5], top_k=3)[0][0] == "t5"
    # bm25 no longer refuses: as in the JAX factory, it is a dense store on
    # kernel auto (BM25 itself runs only in the benchmark harness)
    r = build_retriever(corpus[:10], ["a"] * 10, None,
                        RetrievalConfig(backend="bm25", index_path=""),
                        device="cpu")
    j = jax_build(corpus[:10], ["a"] * 10, None,
                  JaxCfg(backend="bm25", index_path=""))
    assert isinstance(r, DenseRetriever) and r.backend == j.backend == "auto"
    np.testing.assert_array_equal(r.search(corpus[:3], 4)[1],
                                  np.asarray(j.search(corpus[:3], 4)[1]))
    with pytest.raises(ValueError, match="cannot rank"):
        ANNRetriever(RetrievalConfig(backend="hnsw", metric="euclidean"),
                     "hnsw", device="cpu")


@pytest.mark.parametrize("kind", ["hnsw", "ivfpq"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_stores_cross_load(tmp_path, kind, writer, caplog):
    """A store one package writes: the other's ``load_persisted`` serves
    it with equal answers, and the other's build over the same corpus
    loads it (the fingerprints agree) instead of rebuilding."""
    rng = np.random.default_rng(11)
    c = _normed(rng, 400, 16)
    q = _normed(rng, 10, 16)
    texts = [f"t{i}" for i in range(400)]
    kw = dict(index_path=str(tmp_path / "ix"), hnsw_m=8, ivfpq_nlist=8,
              ivfpq_m=8, ivfpq_nprobe=8, ivfpq_refine=4)
    t, j = _pair(kind, **kw)
    first, second = (t, j) if writer == "port" else (j, t)
    first.build(c, texts, doc_ids=[i * 7 for i in range(400)],
                embedding_model="mini", ae_type="vae",
                metadata=[{"i": i % 5} for i in range(400)])
    s0, i0 = first.search(q, 5)
    assert second.load_persisted(expect={"embedding_model": "mini"})
    assert list(second.texts) == texts
    assert list(second.doc_ids) == [i * 7 for i in range(400)]
    assert second.dim == 16 and second.metadata[3] == {"i": 3}
    s1, i1 = second.search(q, 5)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_allclose(s0, s1, atol=1e-6)
    if kind == "ivfpq":
        assert second._refine_emb is not None
    again, _ = _pair(kind, **kw) if writer == "jax" else (None, None)
    if again is None:
        again = JaxANN(JaxCfg(backend=kind, **kw), kind)
    with caplog.at_level(logging.INFO):
        again.build(c, texts, doc_ids=[i * 7 for i in range(400)],
                    embedding_model="mini", ae_type="vae",
                    metadata=[{"i": i % 5} for i in range(400)])
    assert f"{kind} index loaded from" in caplog.text
    np.testing.assert_array_equal(again.search(q, 5)[1], i0)


def test_contradicted_provenance_and_absent_store(tmp_path):
    rng = np.random.default_rng(13)
    c = _normed(rng, 200, 16)
    cfg = RetrievalConfig(index_path=str(tmp_path / "ix"), backend="hnsw",
                          hnsw_m=8)
    ANNRetriever(cfg, "hnsw", device="cpu").build(
        c, [f"t{i}" for i in range(200)], embedding_model="mini",
        ae_type="vae")
    assert ANNRetriever(cfg, "hnsw", device="cpu").load_persisted(
        expect={"embedding_model": "mini", "ae_type": "vae"})
    assert not ANNRetriever(cfg, "hnsw", device="cpu").load_persisted(
        expect={"ae_type": "dae"})
    assert ANNRetriever(cfg, "hnsw", device="cpu").load_persisted(
        expect={"latent_dim": 64})  # a stored None is a wildcard
    jax_refused = JaxANN(JaxCfg(index_path=str(tmp_path / "ix"),
                                backend="hnsw", hnsw_m=8), "hnsw")
    assert not jax_refused.load_persisted(expect={"ae_type": "dae"})
    assert load_retriever(cfg, device="cpu",
                          expect={"ae_type": "dae"}) is None
    assert isinstance(load_retriever(cfg, device="cpu"), ANNRetriever)
    absent = RetrievalConfig(index_path=str(tmp_path / "none"),
                             backend="hnsw")
    assert not ANNRetriever(absent, "hnsw", device="cpu").load_persisted()
    assert load_retriever(absent, device="cpu") is None


@pytest.mark.parametrize("kind", ["hnsw", "ivfpq"])
def test_grown_index_never_reloads_as_fresh(tmp_path, kind, caplog):
    rng = np.random.default_rng(17)
    c = _normed(rng, 300, 16)
    extra = _normed(rng, 20, 16)
    cfg = RetrievalConfig(index_path=str(tmp_path / "ix"), backend=kind,
                          hnsw_m=8, ivfpq_nlist=8, ivfpq_m=8)
    r = ANNRetriever(cfg, kind, device="cpu")
    r.build(c, [f"t{i}" for i in range(300)])
    r.add(extra, [f"x{i}" for i in range(20)])
    # the grown store serves a manual load with all its rows
    warm = ANNRetriever(cfg, kind, device="cpu")
    assert warm.load_persisted() and len(warm.texts) == 320
    for corpus, texts in ((c, [f"t{i}" for i in range(300)]),
                          (np.concatenate([c, extra]),
                           [f"t{i}" for i in range(300)]
                           + [f"x{i}" for i in range(20)])):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            again = ANNRetriever(cfg, kind, device="cpu")
            again.build(corpus, texts)
        assert "fingerprint mismatch, rebuilding" in caplog.text
        assert again.build_split["mode"] in ("beam", "host")


@pytest.mark.parametrize("kind", ["hnsw", "ivfpq"])
def test_build_mode_resolves_from_the_device(monkeypatch, kind):
    """``auto`` is ``knn`` / ``device`` on CUDA and ``beam`` / ``host`` on
    the CPU; the fingerprint keeps ``auto`` either way, as the JAX
    package's, so a store moves between devices."""
    cfg = RetrievalConfig(backend=kind)
    cpu = ANNRetriever(cfg, kind, device="cpu")
    assert cpu._resolved_build_mode() == ("beam" if kind == "hnsw"
                                          else "host")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    card = ANNRetriever(cfg, kind, device="cuda")
    assert card._resolved_build_mode() == ("knn" if kind == "hnsw"
                                           else "device")
    emb = _normed(np.random.default_rng(2), 50, 16)
    j = JaxANN(JaxCfg(backend=kind), kind)
    j.texts = cpu.texts = card.texts = [f"t{i}" for i in range(50)]
    want = j._fingerprint(emb, j._resolved_build_mode())
    assert cpu._fingerprint(emb, "beam") == want
    assert card._fingerprint(emb, card._resolved_build_mode()) == want
    pinned = RetrievalConfig(backend=kind, hnsw_build="knn",
                             ivfpq_build="device")
    jp = JaxANN(JaxCfg(backend=kind, hnsw_build="knn",
                       ivfpq_build="device"), kind)
    jp.texts = j.texts
    tp = ANNRetriever(pinned, kind, device="cpu")
    tp.texts = j.texts
    mode = "knn" if kind == "hnsw" else "device"
    assert tp._fingerprint(emb, mode) == jp._fingerprint(emb, mode)


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ANNRetriever(RetrievalConfig(backend="hnsw"), "hnsw")
