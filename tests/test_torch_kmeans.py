"""The port's k-means (``latentrag_torch.ops.kmeans``) and the IVF's packed
assignment (``ops.ivf._assign_packed``) against the JAX package's, on the
CPU: the same numpy inputs through both.

The port draws its random numbers from a ``torch.Generator``, so its
``kmeans`` starts elsewhere than the JAX one; ``lloyd`` from the JAX
package's own initial centroids (JAX ``kmeans(..., iters=0)``) is held to
JAX ``kmeans`` after the same iterations. The port sums each cluster with
``index_add_`` in another order than the JAX one-hot product, so centroids
agree within 1e-5, not bit for bit; assignments on separated mixtures are
equal. The mixture is tight (spread 0.02 around unit centres): no row lies
within fp32 rounding of a boundary, where two sum orders could assign it
differently, and no cluster empties, where the two packages re-seed from
rows their own generators draw."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentrag_tpu.ops import ivf as jivf
from latentrag_tpu.ops import kmeans as jkm
from latentrag_tpu.ops.binary import binary_quantize as jax_binary_quantize
from latentrag_tpu.ops.quantization import sq4_quantize as jax_sq4_quantize
from latentrag_torch.ops import ivf as tivf
from latentrag_torch.ops import kmeans as tkm
from latentrag_torch.ops.binary import binary_quantize
from latentrag_torch.ops.quantization import sq4_quantize


def _mixture(n, d, n_centers, seed, spread=0.02):
    """Separated Gaussian clusters, unit rows."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    which = rng.integers(0, n_centers, size=n)
    x = centers[which] + spread * rng.normal(size=(n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def mixture():
    return _mixture(4000, 16, 24, seed=3)


@pytest.mark.parametrize("iters", [3, 5])
def test_lloyd_from_the_jax_init_matches_jax_kmeans(mixture, iters):
    key = jax.random.PRNGKey(7)
    x = jnp.asarray(mixture)
    init = np.asarray(jkm.kmeans(x, 24, iters=0, key=key))
    want = np.asarray(jkm.kmeans(x, 24, iters=iters, key=key))
    got = tkm.lloyd(torch.tensor(mixture), torch.tensor(init), iters,
                    block_size=1000).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    a_want = np.asarray(jkm.assign_clusters(x, jnp.asarray(want)))
    a_got = tkm.assign_clusters(torch.tensor(mixture),
                                torch.tensor(got)).numpy()
    np.testing.assert_array_equal(a_got, a_want)
    assert np.bincount(a_want, minlength=24).min() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_assign_clusters_matches_jax(mixture, dtype):
    cent = _mixture(24, 16, 24, seed=4, spread=0.0)
    if dtype == "int8":  # SQ8-like codes, as the int8 store clusters them
        rows = np.clip(np.round(mixture * 127), -127, 127).astype(np.int8)
        cent = cent * 127
        xj, xt = jnp.asarray(rows), torch.tensor(rows)
    elif dtype == "bfloat16":
        xj = jnp.asarray(mixture).astype(jnp.bfloat16)
        xt = torch.tensor(mixture).to(torch.bfloat16)
    else:
        xj, xt = jnp.asarray(mixture), torch.tensor(mixture)
    want = np.asarray(jkm.assign_clusters(xj, jnp.asarray(cent),
                                          block_size=1024))
    for block in (1024, 4000, 1 << 17):  # the blocking does not matter
        got = tkm.assign_clusters(xt, torch.tensor(cent), block_size=block)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["binary", "sq4"])
def test_assign_packed_matches_jax(mixture, kind):
    d = 16
    if kind == "binary":
        pk_j = jax_binary_quantize(jnp.asarray(mixture))
        pk_t = binary_quantize(torch.tensor(mixture))
        np.testing.assert_array_equal(pk_t.numpy().view(np.uint32),
                                      np.asarray(pk_j))
        cent = np.sign(_mixture(24, d, 24, seed=5, spread=0.0))
    else:
        pk_j, _ = jax_sq4_quantize(jnp.asarray(mixture))
        pk_t, _ = sq4_quantize(torch.tensor(mixture))
        np.testing.assert_array_equal(pk_t.numpy(), np.asarray(pk_j))
        cent = np.round(_mixture(24, d, 24, seed=5, spread=0.0) * 7)
    cent = cent.astype(np.float32)
    want = np.asarray(jivf._assign_packed(pk_j, jnp.asarray(cent), d,
                                          kind=kind))
    got = tivf._assign_packed(pk_t, torch.tensor(cent), d, kind,
                              block_size=1500)
    np.testing.assert_array_equal(got.numpy(), want)


def test_kmeans_init_draws_distinct_rows_and_tiles_small_inputs():
    x = torch.arange(40, dtype=torch.float32).reshape(20, 2)
    c = tkm.kmeans_init(x, 8, seed=1)
    assert len({tuple(r) for r in c.tolist()}) == 8
    assert all(any(torch.equal(r, row) for row in x) for r in c)
    small = tkm.kmeans_init(x[:3], 8, seed=1)  # fewer rows than k
    assert small.shape == (8, 2)
    assert len({tuple(r) for r in small.tolist()}) == 3
    np.testing.assert_array_equal(tkm.kmeans_init(x, 8, seed=1).numpy(),
                                  c.numpy())  # seeded


def test_empty_clusters_reseed_from_rows_and_tf32_is_restored():
    x = torch.tensor(_mixture(300, 8, 3, seed=6, spread=0.01))
    # two of the five starts far from every row: they collect nothing
    init = torch.cat([x[:3], torch.full((2, 8), 50.0)])
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        cent = tkm.lloyd(x, init, 1)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    rows = {tuple(r) for r in x.tolist()}
    assert tuple(cent[3].tolist()) in rows and tuple(cent[4].tolist()) in rows
    full = tkm.kmeans(x, 3, iters=10, seed=0)
    a = tkm.assign_clusters(x, full)
    assert torch.bincount(a.long(), minlength=3).min() > 0
