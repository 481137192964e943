"""Filtered search in the port against the JAX package, on the CPU: the
spec compiler, its cache key and the packed mask are the JAX module's
output on random specs; a filtered ``search`` returns the JAX package's
filtered ids and scores on every route it filters (``xla``, ``xla_exact``,
the binary cascade), with (NEG_INF, -1) in the slots of a filter that
allows fewer than k rows, or none; the masked plain versions of the
kernels hold the same contract, and a CPU tensor never launches a kernel.
The kernels themselves are held to these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

from latentrag_tpu.ops import binary as jb
from latentrag_tpu.ops.topk import exact_topk as jax_exact_topk
from latentrag_tpu.retrieval import filtering as jf
from latentrag_tpu.retrieval.dense import DenseRetriever as JaxDense
from latentrag_torch.ops import binary as tb
from latentrag_torch.ops import fused_topk as ft
from latentrag_torch.ops.topk import (
    NEG_INF,
    approx_topk,
    exact_topk,
    pack_row_mask,
    unpack_row_mask,
)
from latentrag_torch.retrieval import DenseRetriever
from latentrag_torch.retrieval import filtering as tf

N, D, K = 300, 16, 8
LANGS = ["en", "fr", "de", None]


def _metadata(rng, n=N):
    out = []
    for _ in range(n):
        md = {}
        if rng.random() < 0.9:
            md["lang"] = LANGS[rng.integers(len(LANGS))]
        if rng.random() < 0.7:
            md["year"] = int(rng.integers(2000, 2005))
        out.append(md)
    return out


def _random_spec(rng, doc_ids):
    spec = {}
    if rng.random() < 0.5:
        spec["doc_ids"] = [doc_ids[i] for i in rng.choice(
            len(doc_ids), int(rng.integers(0, len(doc_ids))), replace=False)]
    if rng.random() < 0.4:
        spec["exclude_doc_ids"] = [doc_ids[i] for i in rng.choice(
            len(doc_ids), int(rng.integers(0, 20)), replace=False)]
    if rng.random() < 0.6 or not spec:
        where = {}
        if rng.random() < 0.7:
            where["lang"] = (LANGS[rng.integers(len(LANGS))]
                             if rng.random() < 0.5
                             else list(rng.choice(["en", "fr", "de"], 2)))
        if rng.random() < 0.5 or not where:
            where["year"] = int(rng.integers(2000, 2006))
        spec["where"] = where
    return spec


# ------------------------------------------------------------- specs


@pytest.mark.parametrize("seed", range(8))
def test_spec_compiler_matches_jax(seed):
    rng = np.random.default_rng(seed)
    doc_ids = ([int(i) for i in rng.permutation(10 * N)[:N]] if seed % 2
               else [f"id{i}" for i in range(N)])
    md = _metadata(rng)
    for _ in range(6):
        spec = _random_spec(rng, doc_ids)
        assert tf.canonical_filter_key(spec) == jf.canonical_filter_key(spec)
        want = jf.compile_filter_mask(spec, doc_ids, md, N)
        got = tf.compile_filter_mask(spec, doc_ids, md, N)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tf.pack_mask(got), jf.pack_mask(want))
    ext = tf.extend_aligned_metadata(md[:5], 5, None, 3)
    assert ext == jf.extend_aligned_metadata(md[:5], 5, None, 3)
    assert tf.extend_aligned_metadata(None, 2, [{"a": 1}], 1) == [{}, {},
                                                                  {"a": 1}]


@pytest.mark.parametrize("bad", [{}, {"bogus": 1}, {"doc_ids": 3},
                                 {"where": [1, 2]}, {"doc_ids": [object()]},
                                 "spec"])
def test_malformed_specs_raise_as_in_jax(bad):
    with pytest.raises(ValueError):
        jf.canonical_filter_key(bad)
    with pytest.raises(ValueError):
        tf.canonical_filter_key(bad)


def test_filter_cache_lru():
    c = tf.FilterCache(capacity=2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1
    c.put("c", 3)  # evicts b
    assert c.get("b") is None and c.get("a") == 1 and c.get("c") == 3
    c.clear()
    assert c.get("a") is None


@pytest.mark.parametrize("n", [1, 7, 31, 32, 33, 300, 1000])
def test_packed_words_are_pack_mask_bytes(n):
    """The kernels' int32 words are pack_mask's little-endian bytes padded
    to whole words; both forms unpack to the mask."""
    m = np.random.default_rng(n).random(n) < 0.4
    words = pack_row_mask(torch.from_numpy(m))
    b = jf.pack_mask(m)
    np.testing.assert_array_equal(
        words.numpy(), np.pad(b, (0, (-b.size) % 4)).view("<i4"))
    assert words.shape == (-(-n // 32),)
    np.testing.assert_array_equal(unpack_row_mask(words, n).numpy(), m)
    np.testing.assert_array_equal(
        unpack_row_mask(torch.from_numpy(b), n).numpy(), m)


# ---------------------------------------------------- the retriever


def _data(rng, n=N, d=D):
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[:, 2] *= 3.0
    return x, [f"t{i}" for i in range(n)], [7 * i for i in range(n)]


FILTERS = {
    "ids": lambda ids: {"doc_ids": ids[::3]},
    "where": lambda ids: {"where": {"lang": ["en", "de"]}},
    "exclude": lambda ids: {"exclude_doc_ids": ids[: N // 2],
                            "where": {"year": 2001}},
    "fewer_than_k": lambda ids: {"doc_ids": ids[10:13]},
    "none": lambda ids: {"doc_ids": [-5]},
}


@pytest.mark.parametrize("kind", sorted(FILTERS))
@pytest.mark.parametrize("store,metric", [
    ("float32", "cosine"), ("float32", "euclidean"),
    ("float32", "mahalanobis"), ("bfloat16", "cosine"),
])
@pytest.mark.parametrize("backend", ["xla", "xla_exact"])
def test_filtered_search_matches_jax(rng, backend, store, metric, kind):
    """The port's filtered search returns the JAX package's xla_exact
    filtered search: ids equal, scores within the store's precision, and
    (NEG_INF, -1) where the filter allows fewer than k rows."""
    emb, texts, ids = _data(rng)
    md = _metadata(rng)
    spec = FILTERS[kind](ids)
    j = JaxDense(metric=metric, backend="xla_exact", store_dtype=store)
    j.build(emb, texts, ids, metadata=md)
    t = DenseRetriever(metric=metric, backend=backend, store_dtype=store,
                       device="cpu")
    t.build(emb, texts, ids, metadata=md)
    q = rng.standard_normal((5, D)).astype(np.float32)
    s_j, i_j = j.search(q, K, filter=spec)
    s_t, i_t = t.search(q, K, filter=spec)
    np.testing.assert_array_equal(i_t, i_j)
    tol = 1e-4 if store == "float32" else 2e-2
    live = i_t >= 0
    np.testing.assert_allclose(s_t[live], s_j[live], rtol=tol, atol=tol)
    assert (s_t[~live] == np.float32(NEG_INF)).all()
    allowed = set(np.flatnonzero(tf.compile_filter_mask(spec, ids, md, N)))
    assert set(i_t[live].tolist()) <= allowed
    if kind == "none":
        assert not live.any()
    if kind == "fewer_than_k":
        assert (live.sum(axis=1) == 3).all()
    texts_out, _, ids_out = t.retrieve(q[0], top_k=K, filter=spec)
    assert len(texts_out) == int(live[0].sum())
    assert ids_out == [ids[i] for i in i_t[0] if i >= 0]


@pytest.mark.parametrize("kind", sorted(FILTERS))
@pytest.mark.parametrize("top_k", [3, 40])
def test_filtered_binary_cascade_matches_jax(rng, kind, top_k):
    """The binary store passes the mask to stage 1 and sentinels its
    NEG_INF slots before the host rescore, as the JAX package does."""
    emb, texts, ids = _data(rng, n=600, d=32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    md = _metadata(rng, 600)
    spec = FILTERS[kind](ids)
    j = JaxDense(backend="xla", store_dtype="binary")
    j.build(emb, texts, ids, metadata=md)
    t = DenseRetriever(store_dtype="binary", device="cpu")
    t.build(emb, texts, ids, metadata=md)
    q = emb[[4, 90, 301]] + 0.05
    s_j, i_j = j.search(q, top_k, filter=spec)
    s_t, i_t = t.search(q, top_k, filter=spec)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(s_t, s_j, atol=1e-5)
    allowed = set(np.flatnonzero(tf.compile_filter_mask(spec, ids, md, 600)))
    assert set(i_t[i_t >= 0].tolist()) <= allowed
    assert np.isneginf(s_t[i_t < 0]).all()


def test_pallas_backends_refuse_a_filter(rng):
    emb, texts, ids = _data(rng)
    for backend in ("pallas", "pallas_exact"):
        t = DenseRetriever(backend=backend, store_dtype="float32",
                           device="cpu")
        t.build(emb, texts, ids)
        with pytest.raises(ValueError, match="filtered search"):
            t.search(emb[:2], 3, filter={"doc_ids": ids[:5]})
        t.search(emb[:2], 3)  # unfiltered still serves


def test_where_filter_needs_metadata_and_cache_follows_mutation(rng):
    emb, texts, ids = _data(rng)
    t = DenseRetriever(store_dtype="float32", device="cpu")
    t.build(emb, texts, ids)
    with pytest.raises(ValueError, match="metadata"):
        t.search(emb[:1], 3, filter={"where": {"lang": "en"}})
    spec = {"doc_ids": ids[:4]}
    m = t._filter_device_mask(spec)
    assert m.dtype == torch.int32 and m.shape == (-(-N // 32),)
    assert t._filter_device_mask(spec) is m  # cached
    t.add(emb[:2] * 2, ["x", "y"], doc_ids=[-1, -2],
          metadata=[{"lang": "en"}, {"lang": "fr"}])
    m2 = t._filter_device_mask(spec)
    assert m2 is not m and m2.shape == (-(-(N + 2) // 32),)
    _, idx = t.search(emb[:1] * 2, 3, filter={"where": {"lang": "en"}})
    assert idx[0].tolist() == [N, -1, -1]  # only the added "en" row
    t.remove(ids[:2])
    assert t._filter_device_mask(spec) is not m2


# ------------------------------------- the kernels' plain versions


def _mask(rng, n, frac):
    return torch.from_numpy(rng.random(n) < frac)


def _oracle(q, c, mask, k, metric="cosine"):
    s, i = exact_topk(q, c, k=k, metric=metric, mask=mask)
    return s, torch.where(s > NEG_INF * 0.5, i, -1)


@pytest.mark.parametrize("frac", [0.0, 0.01, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("mode", ["fold", "exact"])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_masked_fused_topk_plain(rng, frac, mode, metric):
    """The masked plain versions: exact mode is the masked oracle; the
    fold offers only allowed rows and, with 128-row tiles at this size,
    finds the masked top k; empty slots are (NEG_INF, -1)."""
    q = torch.from_numpy(rng.standard_normal((6, D)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((1000, D)).astype(np.float32))
    m = _mask(rng, 1000, frac)
    words = pack_row_mask(m)
    s, i = ft.fused_topk_raw(q, c, k=K, metric=metric, mode=mode,
                             block_n=128, mask=words)
    s_o, i_o = _oracle(q, c, m, K, metric)
    empty = i < 0
    assert (s[empty] == NEG_INF).all()
    assert (empty == (i_o < 0)).all()
    assert m[i[~empty].long()].all()
    if mode == "exact":
        torch.testing.assert_close(i.long(), i_o)
        torch.testing.assert_close(s, s_o, rtol=1e-5, atol=1e-5)
    s2, i2 = ft.fused_topk(q, c, k=K, metric=metric, mode=mode, block_n=128,
                           mask=words)
    assert (i2[:, :] < 0).sum() == empty.sum()
    assert (s2[i2 < 0] == NEG_INF).all()
    assert ft.launches == dict.fromkeys(ft.launches, 0)


@pytest.mark.parametrize("frac", [0.0, 0.01, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("k", [10, 200, 2100])
def test_masked_approx_routes_plain(rng, frac, k):
    """approx_fused_topk (fold, exact past 128, blocked past 2048) and the
    binary stage 1 on every route, masked: allowed rows only, the masked
    oracle's rows where they are exact, sentinels in empty slots."""
    n = 2500
    q = torch.from_numpy(rng.standard_normal((3, D)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
    m = _mask(rng, n, frac)
    words = pack_row_mask(m)
    s, i = ft.approx_fused_topk(q, c, k=k, mask=words)
    s_o, i_o = _oracle(q, c, m, k)
    assert ((i < 0) == (i_o < 0)).all() and (s[i < 0] == NEG_INF).all()
    assert m[i[i >= 0].long()].all()
    s_a, i_a = approx_topk(q, c, k=k, mask=words)  # CPU: the oracle
    torch.testing.assert_close(torch.where(s_a > NEG_INF / 2, i_a, -1), i_o)
    packed = tb.binary_quantize(c)
    s_b, i_b = ft.approx_binary_fused_topk(q, packed, d=D, k=k, mask=words)
    s_bo, _ = tb.binary_topk(q, packed, D, k, mask=m)
    assert ((i_b < 0) == (s_bo <= NEG_INF / 2)).all()
    assert m[i_b[i_b >= 0].long()].all()
    live = i_b >= 0
    torch.testing.assert_close(s_b[live], s_bo[live])


@pytest.mark.parametrize("frac", [0.0, 0.05, 0.5])
def test_masked_binary_plain_matches_jax_binary_topk(rng, frac):
    """The masked exact sign-dot search (binary_exact_topk_raw's plain
    version) and the masked binary fold give the JAX package's masked
    binary_topk scores."""
    x = rng.standard_normal((700, 48)).astype(np.float32)
    q = rng.standard_normal((4, 48)).astype(np.float32)
    m = rng.random(700) < frac
    packed = tb.binary_quantize(torch.from_numpy(x))
    words = pack_row_mask(torch.from_numpy(m))
    s_j, i_j = jb.binary_topk(q, np.asarray(jb.binary_quantize(x)), d=48,
                              k=150, recall_target=1.0, mask=m)
    s_j = np.asarray(s_j)
    s_t, i_t = ft.binary_exact_topk_raw(torch.from_numpy(q), packed, d=48,
                                        k=150, mask=words)
    live = s_j > NEG_INF / 2
    assert ((i_t.numpy() >= 0) == live).all()
    np.testing.assert_allclose(s_t.numpy()[live], s_j[live], atol=1e-5)
    s_f, i_f = ft.binary_fused_topk_raw(torch.from_numpy(q), packed, d=48,
                                        k=10, block_n=128, mask=words)
    assert m[i_f[i_f >= 0].numpy()].all()
    assert ((i_f < 0).numpy() == ~live[:, :10]).all()


def test_rescore_never_gathers_row_minus_one():
    """An empty slot (-1) rescored stays (NEG_INF, -1) after every real
    row; it is not the last row's score."""
    c = torch.eye(4, 8)
    q = c[[3]]
    idx = torch.tensor([[-1, 0, 3, -1]], dtype=torch.int32)
    s, i = ft.rescore_candidates(q, c, idx, "cosine")
    assert i.tolist() == [[3, 0, -1, -1]]
    assert s[0, :2].tolist() == [1.0, 0.0] and (s[0, 2:] == NEG_INF).all()
    packed = tb.binary_quantize(c)
    s_b, i_b = ft.rescore_binary_candidates(q, packed, idx, 8)
    assert i_b[0, 2:].tolist() == [-1, -1] and (s_b[0, 2:] == NEG_INF).all()


def test_masked_exact_past_the_kernel_lists_plain(rng):
    """exact mode past 2048 takes the mask on the CPU (the plain version);
    only the card's exact select refuses it."""
    q = torch.from_numpy(rng.standard_normal((2, D)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((3000, D)).astype(np.float32))
    m = _mask(rng, 3000, 0.5)
    s, i = ft.fused_topk_raw(q, c, k=2500, mode="exact", mask=pack_row_mask(m))
    s_o, i_o = _oracle(q, c, m, 2500)
    torch.testing.assert_close(i.long(), i_o)


def test_mask_validation(rng):
    q = torch.zeros((1, D))
    c = torch.zeros((100, D))
    for bad in (torch.zeros(3, dtype=torch.int32),
                torch.zeros(4, dtype=torch.int64),
                torch.zeros((4, 1), dtype=torch.int32)):
        with pytest.raises(ValueError, match="mask"):
            ft.fused_topk_raw(q, c, k=2, mask=bad)
    with pytest.raises(ValueError, match="mask"):
        ft.binary_fused_topk_raw(q, tb.binary_quantize(c), d=D, k=2,
                                 mask=torch.zeros(3, dtype=torch.int32))


def test_jax_exact_topk_takes_the_same_mask(rng):
    """The port's oracle with the packed words equals the JAX oracle with
    the bool mask."""
    q = rng.standard_normal((3, D)).astype(np.float32)
    c = rng.standard_normal((500, D)).astype(np.float32)
    m = rng.random(500) < 0.2
    s_j, i_j = jax_exact_topk(q, c, k=20, block_size=128, mask=m)
    s_t, i_t = exact_topk(torch.from_numpy(q), torch.from_numpy(c), k=20,
                          block_size=128,
                          mask=pack_row_mask(torch.from_numpy(m)))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5)
