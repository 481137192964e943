"""The port's device assists of the IVF-PQ tier (``latentrag_torch.ops.
kmeans``: ``pq_encode``, ``ivfpq_train_device``, ``ivfpq_encode_device``)
against the JAX package's, on the CPU with seeded numpy inputs.

Given the JAX package's parameters, the port's lists and codes are the
JAX package's: an argmax can part only at an exact fp32 tie of two
scores, and each test counts those ties on its data (0). The port's own
training draws its seeds from a ``torch.Generator`` (a recorded
departure), so its parameters are held by what they serve: ADC recall in
the JAX package's band."""

import numpy as np
import pytest
import torch

from latentrag_tpu.ops import kmeans as jkm
from latentrag_tpu.retrieval import ann as jann
from latentrag_torch.ops import kmeans as tkm
from latentrag_torch.retrieval import ann as tann


def _lowrank(seed, n, d):
    rng = np.random.default_rng(seed)
    rank = max(d // 4, 8)
    g = rng.standard_normal((n, rank)).astype(np.float32)
    proj = rng.standard_normal((rank, d)).astype(np.float32)
    x = g @ proj + 0.05 * rng.standard_normal((n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    x = _lowrank(0, 4000, 64)
    coarse, books = jkm.ivfpq_train_device(x, 64, 16, iters=5)
    return x, np.array(coarse), np.array(books)


def _exact_ties(scores: np.ndarray) -> int:
    """Argmaxes whose best score is met exactly by another entry."""
    best = scores.max(axis=-1, keepdims=True)
    return int(((scores == best).sum(axis=-1) > 1).sum())


@pytest.mark.parametrize("block_size", [32768, 1000])
def test_pq_encode_matches_jax(data, block_size):
    x, coarse, books = data
    assign = np.asarray(jkm.assign_clusters(x, coarse))
    resid = x - coarse[assign]
    got = tkm.pq_encode(torch.from_numpy(resid), torch.from_numpy(books),
                        m=16, block_size=block_size)
    want = np.asarray(jkm.pq_encode(resid, books, m=16))
    r = resid.reshape(-1, 16, 4)
    scores = (np.einsum("nmd,mkd->nmk", r, books)
              - 0.5 * np.sum(books * books, axis=2)[None])
    assert _exact_ties(scores) == 0
    assert got.dtype == torch.uint8 and got.shape == (4000, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ivfpq_encode_device_matches_jax(data):
    x, coarse, books = data
    ja, jc = jkm.ivfpq_encode_device(x, coarse, books)
    ta, tc = tkm.ivfpq_encode_device(torch.from_numpy(x), coarse, books)
    coarse_scores = x @ coarse.T - 0.5 * np.sum(coarse * coarse, axis=1)
    assert _exact_ties(coarse_scores) == 0
    assert ta.dtype == np.int32 and tc.dtype == np.uint8
    np.testing.assert_array_equal(ta, np.asarray(ja))
    np.testing.assert_array_equal(tc, np.asarray(jc))
    # blocked assignment gives the same answer
    ta2, tc2 = tkm.ivfpq_encode_device(torch.from_numpy(x), coarse, books,
                                       block_size=700)
    np.testing.assert_array_equal(ta2, ta)
    np.testing.assert_array_equal(tc2, tc)


def test_port_encoded_index_answers_as_jax(data):
    """The C++ index fed the port's lists and codes searches as the one
    fed the JAX package's, bit for bit."""
    x, coarse, books = data
    q = _lowrank(1, 40, 64)
    out = []
    for assign, codes in (
        tkm.ivfpq_encode_device(torch.from_numpy(x), coarse, books),
        jkm.ivfpq_encode_device(x, coarse, books),
    ):
        ix = tann.IVFPQIndex(64, nlist=64, m=16, nbits=8)
        ix.set_trained(coarse, books)
        ix.add_encoded(np.asarray(assign), np.asarray(codes))
        out.append(ix.search(q, 10, nprobe=8))
    np.testing.assert_array_equal(out[0][1], out[1][1])
    np.testing.assert_array_equal(out[0][0], out[1][0])


def test_ivfpq_train_device_serves_in_the_jax_band():
    """The port's own training (shapes, dtypes, seeded and so repeatable)
    serves ADC recall within 0.05 of the JAX package's trained on the
    same rows, and the same C++ tier takes it."""
    x = _lowrank(2, 3000, 64)
    q = _lowrank(3, 60, 64)
    true = np.argsort(-(q @ x.T), axis=1)[:, :10]
    t1 = tkm.ivfpq_train_device(torch.from_numpy(x), 32, 16, iters=8)
    t2 = tkm.ivfpq_train_device(torch.from_numpy(x), 32, 16, iters=8)
    coarse, books = t1
    assert coarse.shape == (32, 64) and books.shape == (16, 256, 4)
    assert coarse.dtype == books.dtype == np.float32
    np.testing.assert_array_equal(t2[0], coarse)
    np.testing.assert_array_equal(t2[1], books)
    recall = {}
    for name, (c, b), (enc, pkg) in (
        ("port", t1, (lambda c, b: tkm.ivfpq_encode_device(
            torch.from_numpy(x), c, b), tann)),
        ("jax", jkm.ivfpq_train_device(x, 32, 16, iters=8),
         (lambda c, b: jkm.ivfpq_encode_device(x, c, b), jann)),
    ):
        ix = pkg.IVFPQIndex(64, nlist=32, m=16, nbits=8)
        ix.set_trained(np.asarray(c), np.asarray(b))
        ix.add_encoded(*[np.asarray(a) for a in enc(c, b)])
        _, got = ix.search(q, 10, nprobe=32)
        recall[name] = np.mean([len(set(got[i]) & set(true[i])) / 10
                                for i in range(len(q))])
    assert recall["port"] >= 0.5 and recall["port"] >= recall["jax"] - 0.05, (
        recall)


def test_train_on_tiny_corpus_keeps_shapes():
    """Fewer rows than codebook entries: duplicated starting rows, as the
    JAX package's init."""
    x = _lowrank(4, 40, 16)
    coarse, books = tkm.ivfpq_train_device(torch.from_numpy(x), 5, 4,
                                           ksub=256, iters=3)
    assert coarse.shape == (5, 16) and books.shape == (4, 256, 4)
    assert np.isfinite(books).all()
