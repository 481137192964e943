"""The port's sharded top-k (``latentrag_torch.parallel``) on an 8-entry
``cpu`` mesh against the JAX package's ``make_sharded_topk`` on
pytest's 8 virtual CPU devices, same seeded numpy inputs: the exact backend's
ids bit for bit and scores within 1e-5 (fp32 sum order); the approximate,
SQ8, SQ4 and binary backends (exact on the CPU in both packages) the same;
pad rows, n < P, k > a shard, filters and the contract's errors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentrag_tpu.ops.binary import binary_quantize as jax_binary_quantize
from latentrag_tpu.ops.quantization import sq4_quantize as jax_sq4_quantize
from latentrag_tpu.ops.quantization import sq8_quantize as jax_sq8_quantize
from latentrag_tpu.parallel import make_mesh as jax_make_mesh
from latentrag_tpu.parallel import make_sharded_topk as jax_sharded_topk
from latentrag_tpu.parallel import shard_rows as jax_shard_rows
from latentrag_torch.ops.topk import exact_topk
from latentrag_torch.parallel import (
    Mesh,
    gather_rows,
    make_mesh,
    make_sharded_topk,
    shard_rows,
)
from latentrag_torch.parallel.sharded_topk import lax_top_k

SCORE_TOL = 1e-5  # fp32 sums in another order


@pytest.fixture(scope="module")
def meshes(eight_devices):
    return make_mesh(devices=["cpu"] * 8), jax_make_mesh(8)


def _rows(rng, n, d, metric="cosine"):
    x = rng.standard_normal((n, d)).astype(np.float32)
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def _both(meshes, q, c, n, k, backend="exact", metric="cosine", scale=None,
          d=None, mask=None, jax_c=None):
    """The port's and the JAX package's sharded search of the same rows
    (``jax_c``: the JAX operand when it differs in dtype)."""
    tm, jm = meshes
    filtered = mask is not None
    fn_t = make_sharded_topk(tm, k=k, metric=metric, backend=backend, d=d,
                             filtered=filtered)
    fn_j = jax_sharded_topk(jm, k=k, metric=metric, backend=backend, d=d,
                            filtered=filtered)
    st, it = fn_t(torch.tensor(q), shard_rows(torch.tensor(c), tm), n,
                  None if scale is None else float(scale),
                  mask_shard=None if mask is None
                  else shard_rows(torch.tensor(mask), tm))
    sj, ij = fn_j(jnp.asarray(q),
                  jax_shard_rows(jnp.asarray(c if jax_c is None else jax_c),
                                 jm),
                  jnp.int32(n),
                  None if scale is None else jnp.float32(scale),
                  mask_shard=None if mask is None
                  else jax_shard_rows(jnp.asarray(mask), jm))
    return (st.numpy(), it.numpy()), (np.asarray(sj), np.asarray(ij))


@pytest.mark.parametrize("metric", ["cosine", "dot", "euclidean"])
@pytest.mark.parametrize("n,k", [(999, 5), (4096, 5), (41, 6), (333, 37)])
def test_exact_matches_jax(rng, meshes, metric, n, k):
    c = _rows(rng, n, 32, metric)
    q = _rows(rng, 6, 32, metric)
    (st, it), (sj, ij) = _both(meshes, q, c, n, k, metric=metric)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(st, sj, atol=SCORE_TOL, rtol=SCORE_TOL)
    # and the single-device oracle's set
    s0, i0 = exact_topk(torch.tensor(q), torch.tensor(c), k=k, metric=metric)
    for a, b in zip(it, i0.numpy()):
        assert set(a.tolist()) == set(b.tolist())


def test_euclidean_pad_rows_never_displace(rng, meshes):
    """n=41 pads to 48: 7 zero rows on the last shards, which score
    -|q|^2 under euclidean and beat every real row of these far rows."""
    c = (rng.standard_normal((41, 8)) * 0.1 + 5.0).astype(np.float32)
    q = c[:4] + 0.01
    (st, it), (sj, ij) = _both(meshes, q, c, 41, 6, metric="euclidean")
    np.testing.assert_array_equal(it, ij)
    assert it.max() < 41 and it.min() >= 0


@pytest.mark.parametrize("n,k", [(5, 3), (7, 7), (9, 12), (63, 10), (64, 64),
                                 (5, 5)])
def test_edge_shapes_match_jax(rng, meshes, n, k):
    """n < P (shards of padding only), n not a multiple of P, k past a
    shard and past n: the -1 sentinels sit at the tail, as in JAX."""
    c = _rows(rng, n, 16)
    q = _rows(rng, 4, 16)
    (st, it), (sj, ij) = _both(meshes, q, c, n, k)
    np.testing.assert_array_equal(it, ij)
    live = it >= 0
    np.testing.assert_allclose(st[live], sj[live], atol=SCORE_TOL)
    ref = np.argsort(-(q @ c.T), axis=1)[:, :min(k, n)]
    for row in range(4):
        got = [j for j in it[row] if j >= 0]
        assert sorted(got) == sorted(ref[row].tolist())
        assert all(j == -1 for j in it[row][len(got):])


def test_approx_backend_matches_jax(rng, meshes):
    """On the CPU both packages' approximate routes are exact."""
    c = _rows(rng, 5000, 16)
    q = _rows(rng, 8, 16)
    (st, it), (sj, ij) = _both(meshes, q, c, 5000, 10, backend="approx")
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(st, sj, atol=SCORE_TOL)


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_sq8_backend_matches_jax(rng, meshes, metric):
    """int8 codes: the scores are integer dots times one factor, so they
    match the JAX function's bit for bit."""
    c = _rows(rng, 4093, 16)
    q = _rows(rng, 6, 16)
    codes, scale = jax_sq8_quantize(jnp.asarray(c))
    codes = np.asarray(codes)
    (st, it), (sj, ij) = _both(meshes, q, codes, 4093, 5, backend="sq8",
                               metric=metric, scale=float(scale))
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(st, sj)


def test_sq4_backend_matches_jax(rng, meshes):
    c = _rows(rng, 2001, 32)
    q = _rows(rng, 5, 32)
    packed, scale = jax_sq4_quantize(jnp.asarray(c))
    (st, it), (sj, ij) = _both(meshes, q, np.asarray(packed), 2001, 7,
                               backend="sq4", scale=float(scale), d=32)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(st, sj)


def test_binary_backend_matches_jax(rng, meshes):
    """Packed sign words: the JAX store's uint32, the port's int32 with the
    same bits."""
    c = _rows(rng, 1003, 48)
    q = _rows(rng, 5, 48)
    words = np.asarray(jax_binary_quantize(jnp.asarray(c)))
    (st, it), (sj, ij) = _both(meshes, q, words.view(np.int32), 1003, 40,
                               backend="binary", d=48, jax_c=words)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(st, sj)


@pytest.mark.parametrize("backend", ["exact", "approx", "sq8", "binary"])
def test_filtered_matches_jax(rng, meshes, backend):
    """A row mask sharded like the corpus (a shard's first row is not on a
    32-row word: 333 rows make 42-row shards)."""
    n = 333
    c = _rows(rng, n, 32)
    q = _rows(rng, 5, 32)
    mask = rng.random(n) < 0.3
    kw = {}
    jax_c = None
    if backend == "sq8":
        codes, scale = jax_sq8_quantize(jnp.asarray(c))
        c, kw = np.asarray(codes), {"scale": float(scale)}
    elif backend == "binary":
        jax_c = np.asarray(jax_binary_quantize(jnp.asarray(c)))
        c, kw = jax_c.view(np.int32), {"d": 32}
    (st, it), (sj, ij) = _both(meshes, q, c, n, 8, backend=backend,
                               mask=mask, jax_c=jax_c, **kw)
    np.testing.assert_array_equal(it, ij)
    live = it >= 0
    np.testing.assert_allclose(st[live], sj[live], atol=SCORE_TOL)
    assert mask[it[live]].all()


def test_filter_fewer_than_k(rng, meshes):
    c = _rows(rng, 100, 16)
    q = _rows(rng, 3, 16)
    mask = np.zeros(100, bool)
    mask[[3, 50, 97]] = True
    (st, it), (sj, ij) = _both(meshes, q, c, 100, 5, mask=mask)
    np.testing.assert_array_equal(it, ij)
    assert (it[:, 3:] == -1).all() and (st[:, 3:] < -1e37).all()


def test_contract_errors(rng, meshes):
    tm, _ = meshes
    c = shard_rows(torch.tensor(_rows(rng, 64, 8)), tm)
    q = torch.tensor(_rows(rng, 2, 8))
    mask = shard_rows(torch.ones(64, dtype=torch.bool), tm)
    with pytest.raises(ValueError, match="filtered=True"):
        make_sharded_topk(tm, k=3)(q, c, 64, mask_shard=mask)
    with pytest.raises(ValueError, match="pass the row-sharded mask"):
        make_sharded_topk(tm, k=3, filtered=True)(q, c, 64)
    for backend in ("binary", "sq4"):
        with pytest.raises(ValueError, match="requires d"):
            make_sharded_topk(tm, k=3, backend=backend)
    with pytest.raises(ValueError, match="backend"):
        make_sharded_topk(tm, k=3, backend="nope")


def test_shard_layout_matches_jax(rng, meshes):
    """The same rows on the same shards as the JAX layout: zero pad rows
    at the end, shard g holding rows [g r, (g + 1) r)."""
    tm, jm = meshes
    for n in (5, 41, 64, 333):
        x = rng.standard_normal((n, 3)).astype(np.float32)
        ours = shard_rows(x, tm)
        theirs = jax_shard_rows(jnp.asarray(x), jm)
        assert ours.shape == tuple(theirs.shape)
        for j, shard in enumerate(ours.shards):
            want = [s.data for s in theirs.addressable_shards
                    if s.device == jm.devices[j]][0]
            np.testing.assert_array_equal(shard.numpy(), np.asarray(want))
        np.testing.assert_array_equal(gather_rows(ours, n).numpy(), x)


def test_mesh_construction():
    m = make_mesh(devices=["cpu", "cpu", "cpu"])
    assert (m.size, m.world, m.rank, m.axis) == (3, 1, 0, "data")
    assert m.distinct_devices() == [torch.device("cpu")]
    assert isinstance(m, Mesh)
    with pytest.raises(ValueError, match="at least one"):
        make_mesh(devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh()


def test_make_mesh_refuses_more_cards_than_visible(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh().devices == (torch.device("cuda:0"),
                                   torch.device("cuda:1"))
    assert make_mesh(1).size == 1
    with pytest.raises(ValueError, match="requested 3 devices, have 2"):
        make_mesh(3)


def test_lax_top_k_orders_ties_to_the_lower_position():
    s = torch.tensor([[1.0, 3.0, 3.0, -3.4e38, 3.0, 2.0]])
    vals, pos = lax_top_k(s, 4)
    assert pos.tolist() == [[1, 2, 4, 5]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 2.0]]
