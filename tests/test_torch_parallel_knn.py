"""The port's ring k-NN graph (``parallel.sharded_knn_graph``) on ``cpu``
meshes against the JAX package's on pytest's 8 virtual CPU devices and
against the single-device ``knn_graph`` oracle: the same lists, ids bit
for bit (both packages' CPU steps are exact; ties are measure-zero on
random floats)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentrag_tpu.parallel import make_mesh as jax_make_mesh
from latentrag_tpu.parallel import sharded_knn_graph as jax_knn
from latentrag_torch.ops.knn import knn_graph
from latentrag_torch.parallel import make_mesh, sharded_knn_graph


def _normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("n", [9, 63, 64, 100, 257])
@pytest.mark.parametrize("exact", [True, False])
def test_matches_jax_and_single_device(rng, eight_devices, n, exact):
    k = min(8, n - 1)
    c = _normed(rng, n, 16)
    got = sharded_knn_graph(torch.tensor(c), k,
                            make_mesh(devices=["cpu"] * 8), exact=exact)
    want = jax_knn(jnp.asarray(c), k, jax_make_mesh(8), exact=exact)
    oracle = knn_graph(torch.tensor(c), k, exact=True)
    assert got.shape == (n, k) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, oracle)


@pytest.mark.parametrize("p", [2, 3, 5])
def test_other_mesh_sizes(rng, p):
    """The ring of P steps over P shards, P not dividing n."""
    c = _normed(rng, 101, 12)
    got = sharded_knn_graph(c, 6, make_mesh(devices=["cpu"] * p),
                            exact=True)
    np.testing.assert_array_equal(got, knn_graph(torch.tensor(c), 6,
                                                 exact=True))


def test_k_exceeds_corpus(rng, eight_devices):
    n, k = 5, 9
    c = _normed(rng, n, 16)
    got = sharded_knn_graph(torch.tensor(c), k,
                            make_mesh(devices=["cpu"] * 8), exact=True)
    want = jax_knn(jnp.asarray(c), k, jax_make_mesh(8), exact=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    for r in range(n):
        row = got[r]
        valid = row[row >= 0]
        assert sorted(valid) == sorted(set(range(n)) - {r})
        assert (row[len(valid):] == -1).all()


def test_euclidean_metric(rng, eight_devices):
    n, k = 70, 6
    c = rng.standard_normal((n, 12)).astype(np.float32)
    got = sharded_knn_graph(torch.tensor(c), k,
                            make_mesh(devices=["cpu"] * 8),
                            metric="euclidean", exact=True)
    want = jax_knn(jnp.asarray(c), k, jax_make_mesh(8), metric="euclidean",
                   exact=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    d2 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    np.testing.assert_array_equal(got, np.argsort(d2, axis=1)[:, :k])


def test_empty_corpus():
    got = sharded_knn_graph(np.zeros((0, 4), np.float32), 3,
                            make_mesh(devices=["cpu"] * 2))
    assert got.shape == (0, 3)
