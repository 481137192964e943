"""The port's k-NN lists (``latentrag_torch.ops.knn``) against the JAX
package's ``ops/knn.py`` on the CPU: the same seeded numpy inputs through
both. On the CPU both searches are exact (the port's ``approx_topk`` is
the blocked plain search there, the JAX ``approx_max_k`` is exact on its
CPU backend), so the lists agree up to the order of fp32 near-ties."""

import numpy as np
import pytest
import torch

from latentrag_tpu.ops import knn as jknn
from latentrag_torch.ops import knn as tknn


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _lowrank(seed, n, d):
    """Unit rows near a d/4-rank subspace (noise 0.05), as the JAX
    package's ANN sweeps draw them."""
    rng = np.random.default_rng(seed)
    rank = max(d // 4, 8)
    g = rng.standard_normal((n, rank)).astype(np.float32)
    proj = rng.standard_normal((rank, d)).astype(np.float32)
    x = g @ proj + 0.05 * rng.standard_normal((n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("case", ["self_first", "self_absent", "invalid",
                                  "short", "offset"])
def test_strip_self_matches_jax(case):
    rng = np.random.default_rng(len(case))
    rows, kk, k, start = 64, 9, 8, 0
    idx = rng.integers(0, 500, size=(rows, kk)).astype(np.int32)
    if case == "self_first":
        idx[:, 0] = np.arange(rows)
    elif case == "invalid":  # -1 ids and a self mid-list
        idx[rng.random(idx.shape) < 0.3] = -1
        idx[::3, 4] = np.arange(0, rows, 3)
    elif case == "short":  # fewer candidates than k after the strip
        kk = 4
        idx = idx[:, :kk]
        idx[:, 1] = np.arange(rows)
    elif case == "offset":
        start = 200
        idx[:, 2] = np.arange(start, start + rows)
    got = tknn.strip_self(idx, start, k)
    want = jknn.strip_self(idx, start, k)
    assert got.dtype == np.int32 and got.shape == (rows, k)
    np.testing.assert_array_equal(got, want)
    own = np.arange(start, start + rows)[:, None]
    assert not (got == own).any()


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("k,query_block", [(16, 512), (64, 4096)])
def test_knn_graph_matches_jax(exact, k, query_block):
    """Ids equal on >= 99.9 % of slots; where they differ the two rows'
    scores for that query are within 1e-6 (an fp32 near-tie)."""
    c = _lowrank(0, 3000, 32)
    got = tknn.knn_graph(torch.from_numpy(c), k, metric="cosine",
                         query_block=query_block, exact=exact)
    want = jknn.knn_graph(c, k, metric="cosine", query_block=query_block,
                          exact=exact)
    assert got.shape == want.shape == (3000, k) and got.dtype == np.int32
    same = got == want
    assert same.mean() >= 0.999, same.mean()
    r, s = np.nonzero(~same)
    sims_got = np.einsum("id,id->i", c[r], c[got[r, s]])
    sims_want = np.einsum("id,id->i", c[r], c[want[r, s]])
    np.testing.assert_allclose(sims_got, sims_want, atol=1e-6)
    assert (got != np.arange(3000)[:, None]).all()
    assert tknn.last_split["blocks"] == -(-3000 // query_block)


def test_knn_graph_pads_sentinels_like_jax():
    c = _unit(np.random.default_rng(1), 4, 8)
    got = tknn.knn_graph(torch.from_numpy(c), 6, metric="cosine", exact=True)
    want = jknn.knn_graph(c, 6, metric="cosine", exact=True)
    np.testing.assert_array_equal(got, want)
    assert (got[:, :3] >= 0).all() and (got[:, 3:] == -1).all()
    # the approximate route pads the same way
    np.testing.assert_array_equal(
        tknn.knn_graph(torch.from_numpy(c), 6, metric="cosine"), want)


def test_knn_graph_dot_metric_and_tensor_input():
    """A tensor corpus stays on its device; ``dot`` scores raw rows."""
    rng = np.random.default_rng(2)
    c = rng.standard_normal((700, 16)).astype(np.float32)
    got = tknn.knn_graph(torch.from_numpy(c), 5, metric="dot",
                         query_block=256)
    want = jknn.knn_graph(c, 5, metric="dot", query_block=256, exact=True)
    assert (got == want).mean() >= 0.999


def test_knn_graph_needs_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tknn.knn_graph(np.zeros((4, 8), np.float32), 2)
