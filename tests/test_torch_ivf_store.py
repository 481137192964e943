"""The device IVF through ``DenseRetriever`` against the JAX package's
retriever, on the CPU: the routing rule (``_ivf_eligible``), searches over
stores that carry the IVF sidecars (``ivf_centroids.npy``,
``ivf_assign.npy``) written by either package and loaded in the other,
warm boots without k-means, ``add`` / ``remove``, the recall probe, and the
factory's fields.

Both packages regroup the same persisted assignments into the same layout,
so the JAX package's searches are the reference: int8 and int4 stores bit
for bit (``metric="dot"`` over rows the test normalizes, since the two
frameworks normalize cosine rows in other sum orders), float and binary
stores to fp32 sum-order tolerances."""

import logging
import os
import shutil

import numpy as np
import pytest

from latentrag_tpu.retrieval.dense import DenseRetriever as JaxDense
from latentrag_torch.ops import fused_topk as ft
from latentrag_torch.ops import ivf as tivf
from latentrag_torch.ops.topk import NEG_INF
from latentrag_torch.retrieval import DenseRetriever
from latentrag_torch.retrieval.factory import build_retriever
from latentrag_torch.utils import Config, apply_overrides

N, D, NLIST, CAP = 9000, 16, 32, 64
STORES = [("float32", "cosine"), ("bfloat16", "cosine"), ("int8", "dot"),
          ("int4", "dot"), ("binary", "dot")]
IVF = dict(ivf_nlist=NLIST, ivf_cap=CAP)


def _mixture(n, d, n_centers, seed, spread=0.15):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    which = rng.integers(0, n_centers, size=n)
    x = centers[which] + spread * rng.normal(size=(n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    return _mixture(N, D, 24, seed=0)


@pytest.fixture(scope="module")
def queries():
    return _mixture(8, D, 24, seed=4)


def _texts(n, base=0):
    return [f"doc {i}" for i in range(base, base + n)]


@pytest.fixture(scope="module")
def jax_stores(tmp_path_factory, corpus):
    """A store of each kind built and persisted by the JAX package, with
    its IVF built at save (backend xla): {store: path}."""
    base = tmp_path_factory.mktemp("jax_ivf")
    out = {}
    for store, metric in STORES:
        path = str(base / store)
        JaxDense(metric=metric, backend="xla", store_dtype=store,
                 index_path=path, **IVF).build(corpus, _texts(N))
        assert os.path.exists(os.path.join(path, "ivf_assign.npy"))
        out[store] = path
    return out


def _copy(src, dst):
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    return str(dst)


def _hold(store, want, got):
    (sj, ij), (st, it) = want, got
    if store in ("int8", "int4"):
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(np.asarray(st, np.float32).view(
            np.int32), np.asarray(sj, np.float32).view(np.int32))
        return
    np.testing.assert_allclose(st, sj, atol=1e-4, rtol=1e-5)
    assert np.mean(np.asarray(it) == np.asarray(ij)) >= 0.98


# ------------------------------------------------------------ the route

ELIGIBLE_CASES = [("float32", "xla"), ("float32", "xla_exact"),
                  ("bfloat16", "xla"), ("int8", "xla"), ("int4", "xla"),
                  ("binary", "xla")]


@pytest.mark.parametrize("store,backend", ELIGIBLE_CASES)
def test_routing_decisions_match_jax(store, backend):
    metric = "cosine"
    for n in (8191, 9000, 100_000, 8_800_000):
        for nprobe_cfg in (0, 16):
            kw = dict(metric=metric, backend=backend, store_dtype=store,
                      ivf_nlist=NLIST, ivf_cap=512, ivf_nprobe=nprobe_cfg)
            j = JaxDense(**kw)
            t = DenseRetriever(device="cpu", **kw)
            for r in (j, t):
                r._corpus_n = n
                if store in ("int4", "binary"):
                    r._rescore_host = np.zeros((1, 1), np.int8)
            for nq in (1, 4, 8, 64, 65):
                for binary in (False, True):
                    for pinned in (False, True):
                        got = t._ivf_eligible(nq, backend, binary=binary,
                                              pinned=pinned)
                        want = j._ivf_eligible(nq, backend, binary=binary,
                                               pinned=pinned)
                        assert got == want, (n, nprobe_cfg, nq, binary,
                                             pinned)
    off = DenseRetriever(device="cpu", store_dtype=store, backend=backend)
    off._corpus_n = 8_800_000
    assert not off._ivf_eligible(1, backend, pinned=True)


# ------------------------------------------- stores from the JAX package


@pytest.mark.parametrize("store,metric", STORES)
def test_jax_store_with_sidecars_searches_as_jax(jax_stores, tmp_path,
                                                 queries, store, metric,
                                                 caplog):
    jpath = _copy(jax_stores[store], tmp_path / "j")
    tpath = _copy(jax_stores[store], tmp_path / "t")
    j = JaxDense(metric=metric, backend="xla", store_dtype=store,
                 index_path=jpath, **IVF)
    t = DenseRetriever(metric=metric, backend="xla", store_dtype=store,
                       index_path=tpath, device="cpu", **IVF)
    assert t._ivf_sidecar is not None
    assert t._ivf_recall_estimate == j._ivf_recall_estimate is not None
    with caplog.at_level(logging.INFO, logger="latentrag_torch.retrieval"):
        got1 = t.search(queries[:1], 10)  # auto budget: the guard admits 1
    assert "restored from sidecar (no k-means)" in caplog.text
    assert t._ivf_build_info["restored"] is True
    _hold(store, j.search(queries[:1], 10), got1)
    # a pinned budget (bucketed 5 -> 8), and one past the guard's batch
    want8 = j.search(queries, 10, nprobe=8)
    _hold(store, want8, t.search(queries, 10, nprobe=5))
    _hold(store, want8, t.search(queries, 10, nprobe=8))
    _hold(store, j.search(queries, 10, nprobe=1),
          t.search(queries, 10, nprobe=1))
    # a filter: only allowed ids come back, in the masked scan
    spec = {"doc_ids": list(range(0, N, 7))}
    want_f = j.search(queries, 12, filter=spec, nprobe=4)
    got_f = t.search(queries, 12, filter=spec, nprobe=4)
    _hold(store, want_f, got_f)
    ids = got_f[1]
    assert all(int(i) % 7 == 0 for i in ids[ids >= 0])
    # the same layout: the recall probe over it gives the JAX estimate
    assert t._ivf_recall_probe(t._ensure_ivf()) == pytest.approx(
        j._ivf_recall_estimate, abs=0.02)


@pytest.mark.parametrize("store,metric", [STORES[0], STORES[2], STORES[4]])
def test_port_store_with_sidecars_loads_in_jax(tmp_path, corpus, queries,
                                               store, metric):
    path = str(tmp_path / "p")
    t = DenseRetriever(metric=metric, backend="xla", store_dtype=store,
                       index_path=path, device="cpu", **IVF)
    t.build(corpus, _texts(N))
    assert t._ivf_index is not None  # built at build()'s save
    assert os.path.exists(os.path.join(path, "ivf_assign.npy"))
    j = JaxDense(metric=metric, backend="xla", store_dtype=store,
                 index_path=_copy(path, tmp_path / "j"), **IVF)
    assert j._ivf_sidecar is not None
    assert j._ivf_recall_estimate == pytest.approx(t._ivf_recall_estimate)
    t2 = DenseRetriever(metric=metric, backend="xla", store_dtype=store,
                        index_path=_copy(path, tmp_path / "t2"),
                        device="cpu", **IVF)
    for nprobe in (8, 2):
        _hold(store, j.search(queries, 10, nprobe=nprobe),
              t2.search(queries, 10, nprobe=nprobe))
    _hold(store, j.search(queries[:1], 10), t2.search(queries[:1], 10))


# ------------------------------------------------------ warm boot, mutation


def test_warm_boot_runs_no_kmeans_and_answers_as_before(tmp_path, corpus,
                                                       queries, monkeypatch):
    path = str(tmp_path / "s")
    r = DenseRetriever(metric="dot", backend="xla", store_dtype="int8",
                       index_path=path, device="cpu", **IVF)
    r.build(corpus, _texts(N))
    before = r.search(queries, 10, nprobe=8)
    est = r._ivf_recall_estimate
    assert 0.0 < est <= 1.0

    def refuse(*a, **k):
        raise AssertionError("k-means ran on a warm boot")

    monkeypatch.setattr(tivf, "kmeans", refuse)
    r2 = DenseRetriever(metric="dot", backend="xla", store_dtype="int8",
                        index_path=path, device="cpu", **IVF)
    after = r2.search(queries, 10, nprobe=8)
    np.testing.assert_array_equal(after[1], before[1])
    np.testing.assert_array_equal(after[0], before[0])
    assert r2._ivf_recall_estimate == est  # persisted, no probe
    assert "probe_s" not in r2._ivf_build_info
    # another nlist or cap: the sidecar is refused, the IVF re-clusters
    r3 = DenseRetriever(metric="dot", backend="xla", store_dtype="int8",
                        index_path=path, device="cpu", ivf_nlist=16,
                        ivf_cap=CAP)
    assert r3.is_built and r3._ivf_sidecar is None


@pytest.mark.parametrize("store,metric", [STORES[2], STORES[3]])
def test_add_appends_as_jax_then_remove_drops_the_ivf(jax_stores, tmp_path,
                                                      queries, store,
                                                      metric):
    jpath = _copy(jax_stores[store], tmp_path / "j")
    tpath = _copy(jax_stores[store], tmp_path / "t")
    j = JaxDense(metric=metric, backend="xla", store_dtype=store,
                 index_path=jpath, **IVF)
    t = DenseRetriever(metric=metric, backend="xla", store_dtype=store,
                       index_path=tpath, device="cpu", **IVF)
    new = _mixture(40, D, 24, seed=8)
    j.add(new, _texts(40, N))
    t.add(new, _texts(40, N))  # warm boot: materialised from the sidecar
    assert t._ivf_index is not None and t._ivf_appended == 40
    assert t._ivf_index.nblocks == j._ivf_index.nblocks
    np.testing.assert_array_equal(t._ivf_index.block_ids.numpy(),
                                  np.asarray(j._ivf_index.block_ids))
    want = j.search(new, 4, nprobe=8)
    s, i = t.search(new, 4, nprobe=8)
    _hold(store, want, (s, i))
    # the appended blocks are probed: most new rows find themselves (the
    # int4 stage 1 and SQ8 dots may rank near neighbours above a row)
    assert np.mean([N + r in i[r] for r in range(40)]) >= 0.8
    assert np.load(os.path.join(tpath, "ivf_assign.npy")).shape == (N + 40,)
    t.remove([0, 1, 2])
    assert t._ivf_index is None and t._ivf_sidecar is None
    assert not os.path.exists(os.path.join(tpath, "ivf_assign.npy"))
    s, i = t.search(queries, 10, nprobe=8)  # rebuilt by k-means
    assert t._ivf_index is not None and (i >= 0).all()
    assert not {0, 1, 2} & set(i.ravel().tolist())


def test_large_add_drops_the_ivf_for_a_rebuild(corpus):
    r = DenseRetriever(metric="cosine", backend="xla", store_dtype="float32",
                       device="cpu", **IVF)
    r.build(corpus, _texts(N))
    assert r._ivf_index is None  # no save: the self-check stays exhaustive
    r.search(corpus[:1], 5)
    assert r._ivf_index is not None and r._ivf_recall_estimate is not None
    r.add(corpus[:3100], _texts(3100, N))  # over a quarter: no append
    assert r._ivf_index is None
    s, i = r.search(corpus[5:6], 2, nprobe=4)
    assert r._ivf_index is not None and r._ivf_appended == 0
    assert s[0, 0] > NEG_INF * 0.5


def test_route_counts_and_small_corpora(corpus, queries):
    r = DenseRetriever(metric="cosine", backend="xla", store_dtype="float32",
                       device="cpu", **IVF)
    r.build(corpus[:8000], _texts(8000))  # under IVF_MIN_ROWS
    r.search(queries, 5, nprobe=8)
    assert r._ivf_index is None
    ft.reset_launches()
    big = DenseRetriever(metric="cosine", backend="xla_exact",
                         store_dtype="float32", device="cpu", **IVF)
    big.build(corpus, _texts(N))
    big.search(queries[:1], 5, nprobe=8)  # the oracle backend never routes
    assert big._ivf_index is None
    assert ft.launches["ivf_scan"] == 0  # the CPU counts no launch


def test_factory_passes_the_ivf_fields(corpus):
    cfg = apply_overrides(Config(), [
        "retrieval.index_path=",
        "retrieval.ivf_nlist=32", "retrieval.ivf_cap=64",
        "retrieval.ivf_nprobe=6", "retrieval.ivf_query_limit=16",
        "retrieval.ivf_selfcheck=0", "retrieval.kernel=xla",
        "retrieval.store_dtype=float32"]).retrieval
    r = build_retriever(corpus, _texts(N), None, cfg, device="cpu")
    assert (r.ivf_nlist, r.ivf_cap, r.ivf_nprobe, r.ivf_query_limit,
            r.ivf_selfcheck) == (32, 64, 6, 16, 0)
    s, i = r.search(corpus[:16], 3)  # a pinned config budget routes
    assert r._ivf_index is not None and r._ivf_recall_estimate is None
    assert (i[:, 0] == np.arange(16)).all()
    assert not r._ivf_eligible(17, "xla")  # past the query limit
