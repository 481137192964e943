"""The port's sharded device IVF (``latentrag_torch.parallel.ivf`` and
``DenseRetriever(mesh=..., ivf_nlist>0)``) on an 8-entry ``cpu`` mesh
against the JAX package's on pytest's 8 virtual CPU devices, same seeded
numpy inputs.

* per-shard layouts from JAX's own centroids and assignments
  (``build_sharded_ivf_from_assign``): blocks, ids and lists bit for bit,
  the padding to the largest shard's block count included;
* searches over that shared layout: at full probe the ids of JAX's exact
  oracle bit for bit and scores within 1e-5 (fp32 sums in another order;
  int8 / int4 bit for bit), and at partial ``nprobe`` JAX's sharded IVF
  ids bit for bit, for float, int8, binary, int4 and filtered stores;
* pad rows, n < P and the mask contract's errors;
* the retriever on a mesh: small batches and the binary / int4 cascades'
  stage 1 through the sharded IVF at full probe (JAX's full-probe ids),
  the ``ivf_mesh_p`` sidecar round trip, refused on another mesh size
  and on one device, and add / remove dropping the IVF;
* a wide shard (more than 8192 blocks at cap 8) with one list over 4x the
  average: ``max_list_blocks`` keeps the whole list, so each shard answers
  as the port's single-device IVF over that shard does.
"""

import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentrag_tpu.ops.binary import binary_quantize as jax_binary_quantize
from latentrag_tpu.ops.quantization import sq4_quantize as jax_sq4_quantize
from latentrag_tpu.ops.quantization import sq8_quantize as jax_sq8_quantize
from latentrag_tpu.ops.topk import exact_topk as jax_exact_topk
from latentrag_tpu.parallel import make_mesh as jax_make_mesh
from latentrag_tpu.parallel import shard_rows as jax_shard_rows
from latentrag_tpu.parallel import ivf as jivf
from latentrag_torch.ops import ivf as tivf
from latentrag_torch.parallel import make_mesh, shard_rows
from latentrag_torch.parallel import ivf as pivf
from latentrag_torch.retrieval import DenseRetriever

N, D, K = 20_001, 32, 10  # not a mesh multiple: pad rows on the last shard
SCORE_TOL = 1e-5


def _clustered(n, d, seed=0, n_centers=64, spread=0.15):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, d)).astype(np.float32)
    which = rng.integers(0, n_centers, size=n)
    x = centers[which] + spread * rng.normal(size=(n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def meshes(eight_devices):
    return make_mesh(devices=["cpu"] * 8), jax_make_mesh(8)


@pytest.fixture(scope="module")
def corpus():
    return _clustered(N, D, seed=0)


@pytest.fixture(scope="module")
def queries():
    return _clustered(16, D, seed=5)


def _store(kind, x):
    """(port rows, JAX rows, scale, dim) of ``x`` as ``kind`` stores it."""
    if kind == "float32":
        return x, x, None, 0
    if kind == "int8":
        c, s = jax_sq8_quantize(jnp.asarray(x))
        return np.asarray(c), np.asarray(c), float(s), 0
    if kind == "int4":
        c, s = jax_sq4_quantize(jnp.asarray(x))
        return np.asarray(c), np.asarray(c), float(s), x.shape[1]
    w = np.asarray(jax_binary_quantize(jnp.asarray(x)))
    return w.view(np.int32), w, None, x.shape[1]


_LAYOUTS: dict = {}


def _shared_layout(meshes, x, kind, nlist=256, cap=32):
    """JAX's sharded IVF over ``x`` and the port's rebuilt from its
    centroids and assignments: (port sivf, JAX sivf, port shards, JAX
    shards, scale, dim), built once a kind."""
    key = (kind, nlist, cap)
    if key not in _LAYOUTS:
        _LAYOUTS[key] = _build_shared(meshes, x, kind, nlist, cap)
    return _LAYOUTS[key]


def _build_shared(meshes, x, kind, nlist, cap):
    tm, jm = meshes
    rows_t, rows_j, scale, dim = _store(kind, x)
    j_sh = jax_shard_rows(jnp.asarray(rows_j), jm)
    jsivf = jivf.build_sharded_ivf(j_sh, jm, nlist=nlist, cap=cap, dim=dim)
    cent = np.asarray(jsivf.centroids)
    assign = jivf.sharded_ivf_assignments(jsivf)
    t_sh = shard_rows(torch.tensor(rows_t), tm)
    tsivf = pivf.build_sharded_ivf_from_assign(t_sh, tm, cent, assign, cap)
    return tsivf, jsivf, t_sh, j_sh, scale, dim


def _search_both(meshes, tsivf, jsivf, q, n, k, nprobe, scale, dim,
                 mask=None):
    tm, jm = meshes
    filtered = mask is not None
    ft = pivf.make_sharded_ivf_topk(tm, k=k, nprobe=nprobe, dim=dim,
                                    filtered=filtered)
    fj = jivf.make_sharded_ivf_topk(jm, k=k, nprobe=nprobe, dim=dim,
                                    filtered=filtered)
    st, it = ft(torch.tensor(q), tsivf, n, scale=scale,
                mask_shard=None if mask is None
                else shard_rows(torch.tensor(mask), tm))
    sj, ij = fj(jnp.asarray(q), jsivf, n,
                scale=None if scale is None else jnp.float32(scale),
                mask_shard=None if mask is None
                else jax_shard_rows(jnp.asarray(mask), jm))
    return (st.numpy(), it.numpy()), (np.asarray(sj), np.asarray(ij))


@pytest.mark.parametrize("kind", ["float32", "int8", "binary", "int4"])
def test_layout_from_jax_assignments_bit_for_bit(meshes, corpus, kind):
    tsivf, jsivf, *_ = _shared_layout(meshes, corpus, kind)
    assert tsivf.nblocks == jsivf.nblocks
    assert tsivf.rows_per_shard == jsivf.rows_per_shard
    jb = np.asarray(jsivf.blocks)
    jids, jb2l = np.asarray(jsivf.block_ids), np.asarray(jsivf.block2list)
    for j, idx in enumerate(tsivf.shards):
        got = idx.blocks.numpy()
        if kind == "binary":
            got = got.view(np.uint32)
        np.testing.assert_array_equal(got, jb[j])
        np.testing.assert_array_equal(idx.block_ids.numpy(), jids[j])
        np.testing.assert_array_equal(idx.block2list.numpy(), jb2l[j])
    # the shards differ in size: the smaller ones carry pad blocks
    assert (jb2l == -1).any()
    np.testing.assert_array_equal(pivf.sharded_ivf_assignments(tsivf),
                                  jivf.sharded_ivf_assignments(jsivf))


@pytest.mark.parametrize("kind", ["float32", "int8", "binary", "int4"])
def test_full_probe_matches_jax(meshes, corpus, queries, kind):
    tsivf, jsivf, _, _, scale, dim = _shared_layout(meshes, corpus, kind)
    (st, it), (sj, ij) = _search_both(meshes, tsivf, jsivf, queries, N, K,
                                      10**6, scale, dim)
    np.testing.assert_array_equal(it, ij)
    if kind in ("int8", "int4"):
        np.testing.assert_array_equal(st, sj)
    else:
        np.testing.assert_allclose(st, sj, atol=SCORE_TOL, rtol=SCORE_TOL)
    assert (it < N).all() and (it >= 0).all()  # no pad row surfaces
    if kind == "float32":  # and JAX's exact oracle, bit for bit
        s_ref, i_ref = jax_exact_topk(jnp.asarray(queries),
                                      jnp.asarray(corpus), k=K)
        np.testing.assert_array_equal(it, np.asarray(i_ref))
        np.testing.assert_allclose(st, np.asarray(s_ref), atol=SCORE_TOL)


@pytest.mark.parametrize("kind,nprobe", [("float32", 8), ("float32", 40),
                                         ("int8", 16), ("binary", 16),
                                         ("int4", 16)])
def test_partial_probe_matches_jax(meshes, corpus, queries, kind, nprobe):
    tsivf, jsivf, _, _, scale, dim = _shared_layout(meshes, corpus, kind)
    (st, it), (sj, ij) = _search_both(meshes, tsivf, jsivf, queries, N, K,
                                      nprobe, scale, dim)
    np.testing.assert_array_equal(it, ij)
    live = it >= 0
    np.testing.assert_allclose(st[live], sj[live], atol=SCORE_TOL,
                               rtol=SCORE_TOL)


@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_filtered_matches_jax(meshes, corpus, queries, kind):
    tsivf, jsivf, _, _, scale, dim = _shared_layout(meshes, corpus, kind)
    allowed = np.zeros(N, dtype=bool)
    allowed[::5] = True
    for nprobe in (24, 10**6):
        (st, it), (sj, ij) = _search_both(meshes, tsivf, jsivf, queries, N,
                                          K, nprobe, scale, dim,
                                          mask=allowed)
        np.testing.assert_array_equal(it, ij)
        live = it >= 0
        assert live.any() and (it[live] % 5 == 0).all()


def test_pad_rows_match_jax(meshes):
    """13 rows on 8 shards: shards of one and two rows, three pad rows;
    euclidean, where a zero pad row would outscore these far rows."""
    n = 13
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((n, 8)) * 0.1 + 3.0).astype(np.float32)
    q = x[:3] + 0.01
    tm, jm = meshes
    j_sh = jax_shard_rows(jnp.asarray(x), jm)
    jsivf = jivf.build_sharded_ivf(j_sh, jm, nlist=16, cap=8)
    tsivf = pivf.build_sharded_ivf_from_assign(
        shard_rows(torch.tensor(x), tm), tm, np.asarray(jsivf.centroids),
        jivf.sharded_ivf_assignments(jsivf), 8)
    k = min(6, n)
    for metric in ("cosine", "euclidean"):
        st, it = pivf.make_sharded_ivf_topk(tm, k=k, nprobe=10**6,
                                            metric=metric)(
            torch.tensor(q), tsivf, n)
        sj, ij = jivf.make_sharded_ivf_topk(jm, k=k, nprobe=10**6,
                                            metric=metric)(
            jnp.asarray(q), jsivf, n)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        assert it.numpy().max() < n


def test_fewer_rows_than_shards(meshes):
    """n < P: three shards of padding only (the JAX build refuses them,
    its per-shard list counts then differ); the port's answer is the exact
    search, pads never surface."""
    tm, _ = meshes
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((5, 8)) * 0.1 + 3.0).astype(np.float32)
    sivf = pivf.build_sharded_ivf(shard_rows(torch.tensor(x), tm), tm,
                                  nlist=16, cap=8)
    for metric in ("cosine", "euclidean"):
        s, i = pivf.make_sharded_ivf_topk(tm, k=7, nprobe=10**6,
                                          metric=metric)(
            torch.tensor(x[:3]), sivf, 5)
        s_ref, i_ref = jax_exact_topk(jnp.asarray(x[:3]), jnp.asarray(x),
                                      k=5, metric=metric)
        np.testing.assert_array_equal(i.numpy()[:, :5], np.asarray(i_ref))
        assert (i.numpy()[:, 5:] == -1).all()


def test_port_build_full_probe_is_exact(meshes, corpus, queries):
    """The port's own k-means per shard (2048 / 8 lists a shard): at full
    probe the exact oracle; the pad rows never surface."""
    tm, _ = meshes
    sh = shard_rows(torch.tensor(corpus), tm)
    sivf = pivf.build_sharded_ivf(sh, tm, nlist=64, cap=64)
    assert len(sivf.shards) == 8
    assert all(int(idx.centroids.shape[0]) == 8 for idx in sivf.shards)
    s, i = pivf.make_sharded_ivf_topk(tm, k=K, nprobe=10**6)(
        torch.tensor(queries), sivf, N)
    s_ref, i_ref = jax_exact_topk(jnp.asarray(queries), jnp.asarray(corpus),
                                  k=K)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=SCORE_TOL)


def test_mask_contract_errors(meshes, corpus):
    tm, _ = meshes
    sh = shard_rows(torch.tensor(corpus[:4000]), tm)
    sivf = pivf.build_sharded_ivf(sh, tm, nlist=32, cap=32)
    q = torch.tensor(corpus[:2])
    plain = pivf.make_sharded_ivf_topk(tm, k=2, nprobe=4)
    with pytest.raises(ValueError, match="without"):
        plain(q, sivf, 4000,
              mask_shard=shard_rows(torch.ones(4000, dtype=torch.bool), tm))
    filt = pivf.make_sharded_ivf_topk(tm, k=2, nprobe=4, filtered=True)
    with pytest.raises(ValueError, match="filtered=True"):
        filt(q, sivf, 4000)
    with pytest.raises(ValueError, match="requires dim"):
        pivf.build_sharded_ivf(shard_rows(torch.zeros((64, 1),
                                                      dtype=torch.int32), tm),
                               tm, nlist=8)


# ------------------------------------------------------------ the retriever


def _retriever(mesh, store, **kw):
    return DenseRetriever(backend="xla", store_dtype=store, mesh=mesh,
                          device="cpu", ivf_nlist=256, ivf_cap=32, **kw)


def test_retriever_routes_small_batches_through_sharded_ivf(
        meshes, corpus, queries):
    tm, _ = meshes
    texts = [f"t{i}" for i in range(N)]
    r = _retriever(tm, "float32", ivf_nprobe=10**6)
    r.build(corpus, texts, sanity_check=False)
    s, i = r.search(queries, K)
    assert isinstance(r._ivf_index, pivf.ShardedIVF)
    assert list(r._sharded_ivf_fns) == [(K, 10**6, False)]
    s_ref, i_ref = jax_exact_topk(jnp.asarray(queries), jnp.asarray(corpus),
                                  k=K)
    np.testing.assert_array_equal(i, np.asarray(i_ref))
    np.testing.assert_allclose(s, np.asarray(s_ref), atol=SCORE_TOL)
    assert 0.0 <= r._ivf_recall_estimate <= 1.0
    # a batch above the query limit stays exhaustive (no new search)
    fns = dict(r._sharded_ivf_fns)
    r.ivf_query_limit = 8
    s2, i2 = r.search(queries, K)
    assert r._sharded_ivf_fns == fns
    np.testing.assert_array_equal(i2, i)


def test_guard_counts_one_shards_rows(meshes):
    """The auto traffic guard: the probe's rows against one shard's rows
    (JAX dense.py's n / P), so on the mesh fewer queries route."""
    tm, _ = meshes
    r = DenseRetriever(backend="xla", store_dtype="float32", device="cpu",
                       ivf_nlist=64, ivf_cap=512)
    r_mesh = DenseRetriever(backend="xla", store_dtype="float32",
                            device="cpu", mesh=tm, ivf_nlist=64,
                            ivf_cap=512)
    for x in (r, r_mesh):
        x._corpus_n = 1_600_000
    # one device: 3125 blocks, auto nprobe 63, 12 queries within 400k rows;
    # a shard of 200k rows: 390 blocks, nprobe 32 (the floor), 3 queries
    assert r._ivf_eligible(12, "xla") and not r._ivf_eligible(13, "xla")
    assert r_mesh._ivf_eligible(3, "xla")
    assert not r_mesh._ivf_eligible(4, "xla")


@pytest.mark.parametrize("store", ["binary", "int4"])
def test_retriever_cascade_stage1_through_sharded_ivf(
        meshes, corpus, queries, store):
    """Full probe: stage 1's candidates are the whole corpus's, so the
    rescored answer is the single-device cascade's."""
    tm, _ = meshes
    texts = [f"t{i}" for i in range(N)]
    r = _retriever(tm, store, ivf_nprobe=10**6, binary_oversample=8)
    r.build(corpus, texts, sanity_check=False)
    s, i = r.search(queries, 5)
    assert isinstance(r._ivf_index, pivf.ShardedIVF)
    assert r._ivf_index.shards[0].blocks.dtype == (
        torch.int32 if store == "binary" else torch.uint8)
    assert r._sharded_ivf_fns
    r1 = DenseRetriever(backend="xla", store_dtype=store, device="cpu",
                        binary_oversample=8)
    r1.build(corpus, texts, sanity_check=False)
    s1, i1 = r1.search(queries, 5)
    np.testing.assert_array_equal(i, i1)
    np.testing.assert_allclose(s, s1, atol=1e-5)


def test_retriever_filtered_through_sharded_ivf(meshes, corpus, queries):
    tm, _ = meshes
    texts = [f"t{i}" for i in range(N)]
    r = _retriever(tm, "float32", ivf_nprobe=10**6)
    r.build(corpus, texts, doc_ids=list(range(N)), sanity_check=False)
    allowed = list(range(0, N, 7))
    s, i = r.search(queries, K, filter={"doc_ids": allowed})
    assert list(r._sharded_ivf_fns) == [(K, 10**6, True)]
    sub = corpus[allowed]
    s_ref, i_ref = jax_exact_topk(jnp.asarray(queries), jnp.asarray(sub),
                                  k=K)
    np.testing.assert_array_equal(i, np.asarray(allowed)[np.asarray(i_ref)])
    np.testing.assert_allclose(s, np.asarray(s_ref), atol=SCORE_TOL)


def test_mesh_sidecar_round_trip(tmp_path, meshes, corpus, queries, caplog):
    tm, _ = meshes
    path = str(tmp_path / "idx")
    texts = [f"t{i}" for i in range(N)]
    kw = dict(ivf_nprobe=64, index_path=path)
    r = _retriever(tm, "float32", **kw)
    r.build(corpus, texts, sanity_check=False)
    assert r._ivf_index is not None  # built at the save
    s_cold, i_cold = r.search(queries, K)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert meta["ivf_mesh_p"] == 8
    assign = np.load(os.path.join(path, "ivf_assign.npy"))
    cent = np.load(os.path.join(path, "ivf_centroids.npy"))
    assert assign.shape == (8, r._ivf_index.rows_per_shard)
    assert cent.shape == (8, 32, D)
    np.testing.assert_array_equal(
        assign, pivf.sharded_ivf_assignments(r._ivf_index))

    real_kmeans = tivf.kmeans

    def refuse(*a, **k):
        raise AssertionError("k-means ran on a warm boot")

    tivf.kmeans = refuse
    try:
        r2 = _retriever(tm, "float32", **kw)
        assert r2._ivf_sidecar is not None
        assert r2._ivf_recall_estimate == pytest.approx(
            r._ivf_recall_estimate)
        with caplog.at_level(logging.INFO, logger="latentrag_torch"):
            s_warm, i_warm = r2.search(queries, K)
    finally:
        tivf.kmeans = real_kmeans
    assert r2._ivf_build_info["restored"] is True
    assert any("restored from sidecar" in m for m in caplog.messages)
    np.testing.assert_array_equal(i_warm, i_cold)
    np.testing.assert_array_equal(s_warm, s_cold)


def test_mesh_sidecar_refused_on_another_size(tmp_path, meshes, corpus):
    tm, _ = meshes
    path = str(tmp_path / "idx")
    texts = [f"t{i}" for i in range(N)]
    _retriever(tm, "float32", ivf_nprobe=64, index_path=path).build(
        corpus, texts, sanity_check=False)
    half = make_mesh(devices=["cpu"] * 4)
    r2 = _retriever(half, "float32", ivf_nprobe=64, index_path=path)
    assert r2.is_built and r2._ivf_sidecar is None  # a cold build next
    s, i = r2.search(corpus[:4], 3)
    assert (i[:, 0] == np.arange(4)).all()
    assert r2._ivf_build_info["restored"] is False
    assert len(r2._ivf_index.shards) == 4
    # and one device does not take the mesh's sidecar either
    r3 = DenseRetriever(backend="xla", store_dtype="float32", device="cpu",
                        ivf_nlist=256, ivf_cap=32, ivf_nprobe=64,
                        index_path=path)
    assert r3.is_built and r3._ivf_sidecar is None
    # the geometry check at build: a sidecar of the right mesh size but
    # other rows per shard rebuilds cold with a warning
    r4 = _retriever(tm, "float32", ivf_nprobe=64, index_path=path)
    cent, assign = r4._ivf_sidecar
    r4._ivf_sidecar = (cent, assign[:, :-1])
    r4._ensure_ivf(probe=False)
    assert r4._ivf_build_info["restored"] is False


def test_binary_mesh_sidecar_round_trip(tmp_path, meshes, corpus, queries):
    tm, _ = meshes
    path = str(tmp_path / "idx")
    texts = [f"t{i}" for i in range(N)]
    kw = dict(ivf_nprobe=10**6, binary_oversample=8, index_path=path)
    r = _retriever(tm, "binary", **kw)
    r.build(corpus, texts, sanity_check=False)
    s_cold, i_cold = r.search(queries, 5)
    r2 = _retriever(tm, "binary", **kw)
    assert r2._ivf_sidecar is not None
    s_warm, i_warm = r2.search(queries, 5)
    assert r2._ivf_build_info["restored"] is True
    np.testing.assert_array_equal(i_warm, i_cold)
    np.testing.assert_array_equal(s_warm, s_cold)


def test_mesh_add_remove_rebuild_ivf(tmp_path, meshes, corpus, queries):
    """A mesh does not append to its IVF: add and remove drop it, the next
    eligible search rebuilds it over the new rows, and the save after the
    mutation drops the stale sidecar."""
    tm, _ = meshes
    path = str(tmp_path / "idx")
    texts = [f"t{i}" for i in range(N)]
    r = _retriever(tm, "float32", ivf_nprobe=10**6, index_path=path)
    r.build(corpus[:-100], texts[:-100], sanity_check=False)
    assert r._ivf_index is not None
    r.add(corpus[-100:], texts[-100:])
    assert r._ivf_index is None and r._ivf_appended == 0
    assert not os.path.exists(os.path.join(path, "ivf_assign.npy"))
    s, i = r.search(queries, K)
    assert r._ivf_index is not None and r._ivf_index.rows_per_shard == \
        -(-N // 8)
    _, i_ref = jax_exact_topk(jnp.asarray(queries), jnp.asarray(corpus), k=K)
    np.testing.assert_array_equal(i, np.asarray(i_ref))
    drop = [int(v) for v in i[:, 0]]
    assert r.remove(drop) == len(set(drop))
    assert r._ivf_index is None
    _, i2 = r.search(queries, K)
    assert r._ivf_index is not None
    assert not set(drop) & {r.doc_ids[j] for j in i2.ravel() if j >= 0}


# ------------------------------------------------------- the wide shard


def test_wide_shard_keeps_whole_skewed_list(meshes):
    """Two shards of over 8192 blocks each (cap 8) where list 0 holds 10,000
    rows (1250 blocks, ~135x the ~9-block average: JAX's 4x + 8 bound
    would keep 46 of them). ``max_list_blocks`` expands the whole list, so
    each shard's answer is the port's single-device IVF over that shard
    with its own largest list; the default bound misses rows there."""
    rng = np.random.default_rng(3)
    rps, nls, d, cap = 70_000, 1024, 16, 8
    mesh2 = make_mesh(devices=["cpu"] * 2)
    x = rng.standard_normal((2 * rps, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    cent = rng.standard_normal((2, nls, d)).astype(np.float32)
    q = rng.standard_normal((4, d)).astype(np.float32)
    cent[:, 0] = 10.0 * q[0]  # list 0 ranks first for the queries
    assign = np.empty((2, rps), np.int32)
    for g in range(2):
        assign[g] = 1 + rng.integers(0, nls - 1, size=rps)
        assign[g, rng.choice(rps, 10_000, replace=False)] = 0
    sh = shard_rows(torch.tensor(x), mesh2)
    sivf = pivf.build_sharded_ivf_from_assign(sh, mesh2, cent, assign, cap)
    assert sivf.nblocks > 8192 and sivf.max_list_blocks == 1250
    nprobe = 2 * sivf.nblocks // nls  # about two lists' worth
    qt = torch.tensor(q[:1])
    s, i = pivf.make_sharded_ivf_topk(mesh2, k=K, nprobe=nprobe)(
        qt, sivf, 2 * rps)
    parts = []
    for g in range(2):
        idx = tivf.ivf_build_from_assign(sh.shards[g], cent[g], assign[g],
                                         cap)
        ps, pi = tivf.ivf_search(qt, idx, k=K + 1, nprobe=nprobe,
                                 max_list_blocks=1250)
        parts.append((ps, pi.long() + g * rps))
        # JAX's default bound clips list 0: other rows come back
        _, clipped = tivf.ivf_search(qt, idx, k=K + 1, nprobe=nprobe)
        assert not torch.equal(clipped, pi)
    cat_s = torch.cat([p[0] for p in parts], 1)
    cat_i = torch.cat([p[1] for p in parts], 1)
    top = torch.topk(cat_s, K, dim=1)
    np.testing.assert_array_equal(i.numpy(),
                                  torch.gather(cat_i, 1, top.indices).numpy())
    np.testing.assert_array_equal(s.numpy(), top.values.numpy())
