"""The port's persisted dense store against the JAX package's, on the CPU:
stores cross-load both ways (float32, bfloat16 and binary; cosine,
euclidean and mahalanobis; int and string doc ids; with and without
metadata) with equal digests, equal search results and a warm boot that
skips the rebuild; every start-clean case of the JAX package's tests
starts clean in the port; the text store and the digests are byte for
byte the JAX package's. Every store lives under ``tmp_path``."""

import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch

from latentrag_tpu.parallel import make_mesh
from latentrag_tpu.retrieval import dense as jd
from latentrag_tpu.retrieval import textstore as jts
from latentrag_tpu.retrieval.dense import DenseRetriever as JaxDense
from latentrag_torch.retrieval import dense as td
from latentrag_torch.retrieval import textstore as tts
from latentrag_torch.retrieval import DenseRetriever, load_retriever
from latentrag_torch.retrieval.textstore import LazyTexts
from latentrag_torch.utils import Config, apply_overrides

N, D = 240, 16
# (store, metric) pairs the port persists; the binary store is cosine/dot
STORES = [(s, m) for s in ("float32", "bfloat16")
          for m in ("cosine", "euclidean", "mahalanobis")] + [("binary",
                                                                "cosine")]
# score tolerance after a load: the same arithmetic on the same stored
# values, up to the two packages' sum orders (bf16 queries round apart)
SCORE_TOL = {"float32": 1e-6, "bfloat16": 1e-2, "binary": 1e-6}


def _corpus(rng, n=N, d=D):
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[:, 1] *= 3.0  # anisotropic, so the whitener is not the identity
    return x


def _texts(n=N):
    return [f"doc {i} ☃" for i in range(n)]


def _ids(kind, n=N):
    return list(range(0, 3 * n, 3)) if kind == "int" else [f"d{i}"
                                                           for i in range(n)]


def _metadata(with_md, n=N):
    return [{"lang": "en" if i % 3 else "de", "year": 2000 + i % 7}
            for i in range(n)] if with_md else None


def _backend(store):
    return "xla" if store == "binary" else "xla_exact"


def _fp(metric):
    return jd.make_fingerprint(d=D, embedding_model="m", ae_type="vae",
                               latent_dim=D, metric=metric)


def _meta(path):
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def _port(path, store="float32", metric="cosine", **kw):
    return DenseRetriever(metric=metric, backend="auto", store_dtype=store,
                          index_path=str(path), device="cpu", **kw)


def _jax(path, store="float32", metric="cosine"):
    return JaxDense(metric=metric, backend=_backend(store),
                    store_dtype=store, index_path=str(path))


def _same_search(rng, a, b, store, k=7, d=D):
    q = rng.standard_normal((6, d)).astype(np.float32)
    s_a, i_a = a.search(q, k)
    s_b, i_b = b.search(q, k)
    np.testing.assert_array_equal(np.asarray(i_a), np.asarray(i_b))
    np.testing.assert_allclose(np.asarray(s_a), np.asarray(s_b),
                               atol=SCORE_TOL[store], rtol=SCORE_TOL[store])


# --------------------------------------------------------- digests, text


@pytest.mark.parametrize("shape,dtype", [
    ((), np.float32), ((7,), np.float32), ((100, 41), np.float32),
    ((5000, 3), np.uint32), ((300, 16), np.int8), ((64, 64), np.float64),
])
def test_stored_digest_is_the_jax_packages(rng, shape, dtype):
    a = (rng.standard_normal(shape) * 1000).astype(dtype)
    assert td._stored_digest(a) == jd._stored_digest(a)


def test_corpus_digest_is_the_jax_packages(rng):
    """Host arrays, host tensors and plain sequences give the JAX
    package's digest (a CUDA tensor gathers the same 64 rows)."""
    for n in (0, 5, 64, 1000):
        emb = rng.standard_normal((n, 12)).astype(np.float32)
        texts = [f"t{i}" * 50 for i in range(n)]
        want = jd._corpus_digest(emb, texts)
        assert td._corpus_digest(emb, texts) == want
        assert td._corpus_digest(torch.from_numpy(emb), texts) == want
    assert td._corpus_digest([[1.0, 2.0]], ["a"]) == jd._corpus_digest(
        [[1.0, 2.0]], ["a"])
    assert td.make_fingerprint(d=3, ae_type="dae") == jd.make_fingerprint(
        d=3, ae_type="dae")
    assert td.FINGERPRINT_VERSION == jd.FINGERPRINT_VERSION


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_text_store_is_byte_compatible(tmp_path, writer):
    texts = ["alpha", "", "béta ☃", "x" * 300]
    for ids in ([4, 9, 1, 0], ["a", "b", "c", "d"]):
        prefix = str(tmp_path / f"texts_{type(ids[0]).__name__}")
        save, load = ((jts.save_texts, tts.load_texts) if writer == "jax"
                      else (tts.save_texts, jts.load_texts))
        as_npy = save(prefix, texts, ids)
        got_texts, got_ids = load(prefix)
        assert list(got_texts) == texts
        assert got_ids == (ids if as_npy else None)
    md = [{"k": 1, "b": [1, 2]}, {}, {"z": None}]
    p1, p2 = str(tmp_path / "m1.jsonl"), str(tmp_path / "m2.jsonl")
    dig = jts.save_metadata_sidecar(p1, md)
    assert tts.save_metadata_sidecar(p2, md) == dig
    assert open(p1, "rb").read() == open(p2, "rb").read()
    assert tts.load_metadata_sidecar(p1, dig, 3) == md
    assert jts.load_metadata_sidecar(p2, dig, 3) == md


# ----------------------------------------------------- cross-loading


@pytest.mark.parametrize("ids,with_md", [("int", False), ("str", True)])
@pytest.mark.parametrize("store,metric", STORES)
def test_jax_store_loads_in_the_port(rng, tmp_path, store, metric, ids,
                                     with_md):
    """A store the JAX package wrote loads in the port: texts, ids,
    metadata, metric and fingerprint as written, the same search results,
    and a save of it that records the same stored digests."""
    emb, texts = _corpus(rng), _texts()
    j = _jax(tmp_path / "idx", store, metric)
    j.build(emb, texts, _ids(ids), fingerprint=_fp(metric),
            metadata=_metadata(with_md))
    t = _port(tmp_path / "idx", store, metric)
    assert t.is_built and t._corpus_n == N and isinstance(t.texts, LazyTexts)
    assert list(t.texts) == texts and t.doc_ids == _ids(ids)
    assert t.metadata == _metadata(with_md)
    assert t.fingerprint == j.fingerprint and t.metric == metric
    assert t.fingerprint["corpus_digest"] == td._corpus_digest(emb, texts)
    _same_search(rng, t, j, store)
    if store == "binary":  # the words and codes, bit for bit
        np.testing.assert_array_equal(
            t._corpus.numpy().view(np.uint32), np.asarray(j._corpus_dev))
        np.testing.assert_array_equal(t._rescore_host, j._rescore_host)
    t._save(str(tmp_path / "again"))
    want = _meta(tmp_path / "idx")
    got = _meta(tmp_path / "again")
    assert got["stored_digests"] == want["stored_digests"]
    assert got.get("metadata_digest") == want.get("metadata_digest")
    assert got["fingerprint"] == want["fingerprint"]
    for name, digest in want["stored_digests"].items():
        assert td._stored_digest(
            np.load(tmp_path / "idx" / name)) == digest


@pytest.mark.parametrize("ids,with_md", [("int", False), ("str", True)])
@pytest.mark.parametrize("store,metric", STORES)
def test_port_store_loads_in_jax(rng, tmp_path, store, metric, ids,
                                 with_md):
    """A store the port wrote loads in the JAX package, which searches it
    as the port does and saves the same stored digests."""
    emb, texts = _corpus(rng), _texts()
    t = _port(tmp_path / "idx", store, metric)
    t.build(emb, texts, _ids(ids), fingerprint=_fp(metric),
            metadata=_metadata(with_md))
    assert t.fingerprint["corpus_digest"] == jd._corpus_digest(emb, texts)
    j = _jax(tmp_path / "idx", store, metric)
    assert j.is_built and j._corpus_n == N
    assert list(j.texts) == texts and j.doc_ids == _ids(ids)
    assert j.metadata == _metadata(with_md)
    assert j.fingerprint == t.fingerprint and j.metric == metric
    _same_search(rng, t, j, store)
    j._save(str(tmp_path / "again"))
    assert (_meta(tmp_path / "again")["stored_digests"]
            == _meta(tmp_path / "idx")["stored_digests"])


@pytest.mark.parametrize("store", ["float32", "bfloat16", "binary"])
def test_warm_boot_of_a_jax_store_skips_the_rebuild(rng, tmp_path, caplog,
                                                    store):
    """The port's build() over a store the JAX package wrote for the same
    embeddings, texts and provenance keeps it: no rebuild, no save, no
    self-check."""
    emb, texts = _corpus(rng), _texts()
    _jax(tmp_path / "idx", store).build(emb, texts, fingerprint=_fp("cosine"))
    stamp = os.path.getmtime(tmp_path / "idx" / "meta.json")
    t = _port(tmp_path / "idx", store)
    t._self_check = lambda: pytest.fail("the self-check ran on a warm boot")
    with caplog.at_level(logging.INFO, logger="latentrag_torch.retrieval"):
        t.build(emb, texts, fingerprint=_fp("cosine"))
    assert "index compatible; skipping rebuild" in caplog.text
    assert t.get_stats()["build_time_s"] == 0.0
    assert os.path.getmtime(tmp_path / "idx" / "meta.json") == stamp
    # another corpus of the same size rebuilds
    other = _corpus(rng)
    t2 = _port(tmp_path / "idx", store)
    t2.build(other, texts, fingerprint=_fp("cosine"))
    assert t2.get_stats()["build_time_s"] > 0
    _, idx = t2.search(other[:3], 1)
    assert (idx[:, 0] == np.arange(3)).all()


def test_load_retriever_warm_boots_and_checks_provenance(rng, tmp_path):
    cfg = apply_overrides(Config(), [
        f"retrieval.index_path={tmp_path}/idx", "retrieval.store_dtype=float32"])
    assert load_retriever(cfg.retrieval, device="cpu") is None  # no store
    emb, texts = _corpus(rng), _texts()
    _jax(tmp_path / "idx").build(emb, texts, fingerprint=_fp("cosine"))
    r = load_retriever(cfg.retrieval, device="cpu",
                       expect={"embedding_model": "m", "ae_type": "vae"})
    assert r is not None and r.is_built and r.texts[5] == texts[5]
    assert load_retriever(cfg.retrieval, device="cpu",
                          expect={"ae_type": "dae"}) is None
    no_path = apply_overrides(Config(), ["retrieval.index_path="])
    assert load_retriever(no_path.retrieval, device="cpu") is None


# ------------------------------------------------------ start clean


def _built(rng, tmp_path, store="float32", metric="cosine", name="idx"):
    path = str(tmp_path / name)
    r = _port(path, store, metric)
    r.build(_corpus(rng), _texts(), fingerprint=_fp(metric))
    return path


def _starts_clean(path, store="float32", metric="cosine"):
    r = _port(path, store, metric)
    assert not r.is_built
    assert r.fingerprint is None and r.texts == [] and r.doc_ids == []
    assert r.metadata is None and r._corpus_n == 0 and r._whitener is None
    return r


def test_corrupted_meta_starts_clean(tmp_path):
    path = tmp_path / "idx"
    path.mkdir()
    (path / "meta.json").write_text("{not json")
    _starts_clean(str(path))


def test_mixed_generation_corpus_starts_clean(rng, tmp_path):
    """A corpus.npy of another generation, same shape, so every length
    check passes: the stored digest refuses it."""
    path = _built(rng, tmp_path)
    tts.atomic_save(os.path.join(path, "corpus.npy"), _corpus(rng))
    _starts_clean(path)


@pytest.mark.parametrize("sidecar", ["whitener.npy", "binary_packed.npy",
                                     "sq8_scale.npy", "corpus.npy"])
def test_missing_recorded_sidecar_starts_clean(rng, tmp_path, sidecar):
    store, metric = (("float32", "mahalanobis") if sidecar == "whitener.npy"
                     else ("binary", "cosine"))
    path = _built(rng, tmp_path, store, metric)
    os.remove(os.path.join(path, sidecar))
    _starts_clean(path, store, metric)


def test_text_count_skew_starts_clean(rng, tmp_path):
    """The text store shorter than the recorded n (a crash between the
    texts' save and the meta rename)."""
    path = _built(rng, tmp_path)
    tts.save_texts(os.path.join(path, "texts"), _texts()[:11],
                   list(range(11)))
    _starts_clean(path)


def test_truncated_text_blob_starts_clean(rng, tmp_path):
    path = _built(rng, tmp_path)
    blob_p = os.path.join(path, "texts.bin.npy")
    blob = np.load(blob_p)
    with open(blob_p, "wb") as f:
        np.save(f, blob[: len(blob) // 2])
    _starts_clean(path)


def test_text_tag_mismatch_starts_clean(rng, tmp_path):
    """Two text generations of the same total size: the generation tag,
    not a length, refuses the mixed pair."""
    path = _built(rng, tmp_path)
    prefix = os.path.join(path, "texts")
    old = np.load(prefix + ".bin.npy")
    texts = _texts()
    texts[0], texts[1] = texts[1], texts[0]  # same bytes, other tag
    tts.save_texts(prefix, texts, list(range(N)))
    tts.atomic_save(prefix + ".bin.npy", old)
    _starts_clean(path)


def test_tampered_metadata_sidecar_starts_clean(rng, tmp_path):
    path = str(tmp_path / "idx")
    r = _port(path)
    r.build(_corpus(rng), _texts(), metadata=_metadata(True))
    with open(os.path.join(path, "metadata.jsonl"), "a") as f:
        f.write("\n{}")
    _starts_clean(path)


def test_sharded_jax_store_starts_clean(rng, tmp_path, eight_devices):
    """The JAX package's sharded store keeps no corpus.npy: without a
    mesh it fails validation, as in the JAX package."""
    path = str(tmp_path / "idx")
    j = JaxDense(backend="xla", store_dtype="float32", mesh=make_mesh(8),
                 index_path=path)
    j.build(_corpus(rng, 64), _texts(64))
    assert os.path.isdir(os.path.join(path, "sharded"))
    _starts_clean(path)


def test_device_error_during_upload_propagates(rng, tmp_path, monkeypatch):
    """Only validation failures start clean: an error of the device while
    the validated store is uploaded reaches the caller."""
    path = _built(rng, tmp_path)

    def oom(self, arr):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(DenseRetriever, "_upload", oom)
    with pytest.raises(RuntimeError, match="out of memory"):
        _port(path)


def test_refused_store_does_not_leak_its_provenance(rng, tmp_path):
    path = str(tmp_path / "idx")
    r1 = _port(path, fingerprint={"embedding_model": "m1"})
    r1.build(_corpus(rng), _texts())
    tts.save_texts(os.path.join(path, "texts"), _texts()[:7], list(range(7)))
    r2 = _starts_clean(path)
    r2.build(_corpus(rng, 30), _texts(30))
    assert r2.fingerprint.get("embedding_model") is None


# ----------------------------------------- legacy, cross-tier, stale


def test_legacy_binary_store_repacks_as_jax_does(rng, tmp_path):
    """A binary store without binary_packed.npy (and predating the digest
    record) repacks its sign bits on the host: the port's words and codes
    equal the JAX package's load of the same files."""
    corpus = _corpus(rng, 300, 48)  # 48 % 32 != 0: pad bits
    path = str(tmp_path / "idx")
    j = JaxDense(backend="xla", store_dtype="binary", index_path=path)
    j.build(corpus, _texts(300))
    os.remove(os.path.join(path, "binary_packed.npy"))
    meta = _meta(path)
    meta.pop("stored_digests")
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    t = _port(path, "binary")
    j2 = JaxDense(backend="xla", store_dtype="binary", index_path=path)
    assert t.is_built and j2.is_built
    np.testing.assert_array_equal(t._corpus.numpy().view(np.uint32),
                                  np.asarray(j2._corpus_dev))
    np.testing.assert_array_equal(t._rescore_host, j2._rescore_host)
    assert t._corpus_scale == float(j2._corpus_scale)
    _same_search(rng, t, j2, "binary", d=48)


@pytest.mark.parametrize("written,loaded", [
    ("float32", "binary"), ("bfloat16", "binary"), ("int8", "float32"),
    ("int8", "binary"), ("int4", "bfloat16"), ("binary", "float32"),
])
def test_cross_tier_store_loads_as_jax_loads_it(rng, tmp_path, written,
                                                 loaded):
    """A store of another tier loads at the tier asked for, as the JAX
    package's load of the same files does (int8 and int4 stores keep
    dequantized fp32 rows; a float store loaded as binary re-derives its
    scale and packs its words on the host)."""
    path = str(tmp_path / "idx")
    JaxDense(backend="xla", store_dtype=written, index_path=path).build(
        _corpus(rng), _texts())
    t = _port(path, loaded)
    j = JaxDense(backend="xla", store_dtype=loaded, index_path=path)
    assert t.is_built and j.is_built
    if loaded == "binary":
        np.testing.assert_array_equal(t._corpus.numpy().view(np.uint32),
                                      np.asarray(j._corpus_dev))
        np.testing.assert_array_equal(t._rescore_host, j._rescore_host)
    else:
        np.testing.assert_array_equal(
            t._corpus.float().numpy(),
            np.asarray(j._corpus_dev, dtype=np.float32))
    _same_search(rng, t, j, loaded)


def test_save_drops_stale_sidecars(rng, tmp_path):
    """A rebuild of another store type removes the old type's sidecars,
    and IVF sidecars that the new store does not hold (it has no IVF: no
    ``ivf_nlist``, and 30 rows)."""
    path = _built(rng, tmp_path, "binary")
    assert os.path.exists(os.path.join(path, "binary_packed.npy"))
    for name in ("ivf_centroids.npy", "ivf_assign.npy"):
        np.save(os.path.join(path, name), np.zeros(3, np.float32))
    r = _port(path, "float32", "mahalanobis")
    r.build(_corpus(rng, 30), _texts(30), fingerprint=_fp("mahalanobis"))
    for name in ("binary_packed.npy", "sq8_scale.npy", "ivf_centroids.npy",
                 "ivf_assign.npy"):
        assert not os.path.exists(os.path.join(path, name)), name
    assert os.path.exists(os.path.join(path, "whitener.npy"))
    r2 = _port(path, "float32", "mahalanobis")
    r2.build(_corpus(rng, 30), _texts(30), fingerprint=_fp("cosine"))
    assert not os.path.exists(os.path.join(path, "whitener.npy"))
    assert _port(path).is_built


def test_requested_metric_wins_over_loaded(rng, tmp_path):
    path = _built(rng, tmp_path, metric="cosine")
    corpus = _corpus(rng)
    r = _port(path, metric="euclidean")
    r.build(corpus, _texts(), fingerprint=_fp("euclidean"))
    assert r.metric == "euclidean"
    q = corpus[:4]
    _, idx = r.search(q, 3)
    ref = -(((q[:, None] - corpus[None]) ** 2).sum(-1))
    np.testing.assert_array_equal(idx[:, 0], np.argsort(-ref, axis=1)[:, 0])


def test_fingerprint_mismatch_rebuilds(rng, tmp_path):
    path = _built(rng, tmp_path)
    r = _port(path)
    fp_new = td.make_fingerprint(d=D, ae_type="dae", latent_dim=D)
    assert not r.compatible_with(fp_new)
    r.build(_corpus(rng, 40), _texts(40), fingerprint=fp_new)
    assert r._corpus_n == 40
    assert {k: v for k, v in r.fingerprint.items()
            if k != "corpus_digest"} == fp_new
    assert _port(path)._corpus_n == 40


def test_legacy_inline_texts_and_metadata_refresh(rng, tmp_path):
    """A store with its texts inlined in meta.json loads; build() with new
    metadata on a compatible store rewrites only the metadata sidecar."""
    corpus, texts = _corpus(rng), _texts()
    path = _built(rng, tmp_path)
    for f in ("texts.bin.npy", "texts_offsets.npy", "texts_doc_ids.npy"):
        os.remove(os.path.join(path, f))
    meta = _meta(path)
    meta["texts"], meta["doc_ids"] = texts, list(range(N))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    r = _port(path)
    assert r.is_built and r.texts[3] == texts[3]

    path2 = str(tmp_path / "idx2")
    _port(path2).build(corpus, texts)
    stamp = os.path.getmtime(os.path.join(path2, "corpus.npy"))
    r2 = _port(path2)
    r2.build(corpus, texts, metadata=_metadata(True))
    assert os.path.getmtime(os.path.join(path2, "corpus.npy")) == stamp
    r3 = _port(path2)
    assert r3.metadata == _metadata(True)
    _, idx = r3.search(corpus[:2], 5, filter={"where": {"lang": "de"}})
    assert all(r3.metadata[i]["lang"] == "de" for i in idx.ravel() if i >= 0)
    shutil.rmtree(path2)
