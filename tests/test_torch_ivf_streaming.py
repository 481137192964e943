"""The port's streaming binary IVF build (``ops.ivf.
ivf_build_binary_streaming``) against the JAX package's, same seeded
packed sign words, chunked at a size that does not divide the corpus.

* given JAX's centroids: ``blocks``, ``block_ids`` and ``block2list`` bit
  for bit JAX's streaming layout (the JAX store's uint32 words, the
  port's int32 with the same bits), and the port's
  ``ivf_build_from_assign`` over the same assignments;
* built from scratch (the port's k-means): every row placed once, and the
  full probe the exhaustive binary search (scores within 1e-5, fp32 sums
  of +-bf16 values in another order);
* an empty corpus raises ValueError, a ``chunk_fn`` that returns other
  rows in the place sweep than in the count sweep RuntimeError;
* a wide index (over 8192 blocks) probes whole lists: with the build's
  largest list the probe of ~30 lists keeps the exhaustive sweep's top
  10 as JAX's does (tests/test_ivf_streaming.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentrag_tpu.ops.binary import binary_quantize as jax_binary_quantize
from latentrag_tpu.ops.ivf import ivf_build_binary as jax_build_binary
from latentrag_tpu.ops.ivf import (
    ivf_build_binary_streaming as jax_streaming,
)
from latentrag_torch.ops import ivf as tivf
from latentrag_torch.ops.binary import binary_topk

N, D, K = 50_003, 64, 10  # not a chunk multiple
CHUNK = 8_192
SCORE_TOL = 1e-5


def _clustered(n, d, seed=0, n_centers=64, spread=0.12):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, d)).astype(np.float32)
    which = rng.integers(0, n_centers, size=n)
    x = centers[which] + spread * rng.normal(size=(n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def words():
    """(JAX uint32 words, the port's int32 view of them)."""
    w = np.asarray(jax_binary_quantize(jnp.asarray(_clustered(N, D))))
    return w, torch.from_numpy(w.view(np.int32).copy())


def _chunks(rows):
    return lambda i: rows[i * CHUNK:(i + 1) * CHUNK]


def test_layout_bit_for_bit_jax_and_from_assign(words):
    w_j, w_t = words
    cent = np.asarray(jax_build_binary(jnp.asarray(w_j), D, nlist=64,
                                       cap=128, seed=3).centroids)
    want = jax_streaming(_chunks(jnp.asarray(w_j)), N, D, nlist=64, cap=128,
                         chunk_rows=CHUNK, centroids=jnp.asarray(cent))
    timings = {}
    got = tivf.ivf_build_binary_streaming(
        _chunks(w_t), N, D, nlist=64, cap=128, chunk_rows=CHUNK,
        centroids=cent, timings=timings)
    np.testing.assert_array_equal(got.blocks.numpy().view(np.uint32),
                                  np.asarray(want.blocks))
    np.testing.assert_array_equal(got.block_ids.numpy(),
                                  np.asarray(want.block_ids))
    np.testing.assert_array_equal(got.block2list.numpy(),
                                  np.asarray(want.block2list))
    assign = tivf._assign_packed(w_t, torch.tensor(cent), D)
    ref = tivf.ivf_build_from_assign(w_t, cent, assign, 128)
    for a, b in zip(got[1:], ref[1:]):
        assert torch.equal(a, b)
    assert set(timings) == {"train_s", "count_s", "place_s"}
    assert timings["train_s"] < 1.0  # centroids given: no k-means


def test_scratch_build_full_probe_is_exhaustive(words):
    _, w_t = words
    idx = tivf.ivf_build_binary_streaming(
        _chunks(w_t), N, D, nlist=64, cap=128, chunk_rows=CHUNK,
        kmeans_iters=5, train_rows=20_000)
    ids = idx.block_ids.reshape(-1)
    real = ids[ids >= 0]
    assert real.numel() == N and torch.unique(real).numel() == N
    q = torch.from_numpy(_clustered(8, D, seed=9))
    s, i = tivf.ivf_search(q, idx, k=K, nprobe=idx.nblocks, dim=D,
                           exact_select=True)
    s_ref, i_ref = binary_topk(q, w_t, d=D, k=K)
    np.testing.assert_allclose(s.numpy(), s_ref.numpy(), atol=SCORE_TOL)


def test_empty_corpus_raises():
    with pytest.raises(ValueError, match="empty"):
        tivf.ivf_build_binary_streaming(lambda i: None, 0, D, nlist=4)


def test_diverging_sweeps_raise(words):
    _, w_t = words
    cent = tivf.kmeans(tivf.binary_unpack(w_t[:5000], D), 16, iters=3)
    calls = {"n": 0}
    nchunks = -(-N // CHUNK)

    def fickle(i):
        calls["n"] += 1
        rows = w_t[i * CHUNK:(i + 1) * CHUNK]
        if calls["n"] > nchunks + 1 and i == 0:  # the place sweep differs
            return torch.zeros_like(rows)  # every sign -1: one list
        return rows

    with pytest.raises(RuntimeError, match="diverged"):
        tivf.ivf_build_binary_streaming(fickle, N, D, nlist=16, cap=64,
                                        chunk_rows=CHUNK, centroids=cent)


def test_wide_index_probe_expands_whole_lists():
    n = 80_000  # cap 8 needs 80k rows for > 8192 blocks
    pk = torch.from_numpy(np.asarray(jax_binary_quantize(
        jnp.asarray(_clustered(n, D, seed=5)))).view(np.int32).copy())
    idx = tivf.ivf_build_binary_streaming(
        _chunks(pk), n, D, nlist=256, cap=8, chunk_rows=CHUNK,
        kmeans_iters=5, train_rows=20_000)
    assert idx.nblocks > 8192
    b2l = idx.block2list.numpy()
    mlb = int(np.bincount(b2l[b2l >= 0]).max())
    q = torch.from_numpy(_clustered(16, D, seed=11))
    s_ref, i_ref = binary_topk(q, pk, d=D, k=K)
    nprobe = 30 * idx.nblocks // 256  # ~30 lists' worth of blocks
    s, i = tivf.ivf_search(q, idx, k=K, nprobe=nprobe, dim=D,
                           max_list_blocks=mlb)
    hits = sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(i.numpy(), i_ref.numpy()))
    assert hits / i_ref.numel() >= 0.9
