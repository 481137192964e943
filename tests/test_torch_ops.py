"""The port's distance and top-k ops against the JAX package's, on the CPU.

Inputs come from a seeded numpy generator and go through both functions;
fp32 results agree to 1e-5 (both sides score in full fp32; sums run in
another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from latentrag_tpu.ops import distances as jd
from latentrag_tpu.ops import topk as jt
from latentrag_torch.ops import distances as td
from latentrag_torch.ops import topk as tt

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def test_l2_normalize_matches(rng):
    x = rng.standard_normal((17, 24)).astype(np.float32)
    x[3] = 0.0  # the eps guard
    np.testing.assert_allclose(
        td.l2_normalize(_t(x)).numpy(), np.asarray(jd.l2_normalize(x)),
        atol=TOL,
    )


def test_covariance_and_whitening_match(rng):
    x = rng.standard_normal((200, 12)).astype(np.float32)
    x[:, 0] *= 5.0
    cov_j = np.asarray(jd.estimate_covariance(jnp.asarray(x)))
    cov_t = td.estimate_covariance(_t(x)).numpy()
    np.testing.assert_allclose(cov_t, cov_j, rtol=TOL, atol=TOL)
    w_j = np.asarray(jd.whitening_factor(jnp.asarray(cov_j)))
    w_t = td.whitening_factor(_t(cov_j)).numpy()
    np.testing.assert_allclose(w_t, w_j, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        td.whiten(_t(x), _t(w_j)).numpy(),
        np.asarray(jd.whiten(jnp.asarray(x), jnp.asarray(w_j))),
        rtol=TOL, atol=TOL,
    )


@pytest.mark.parametrize("metric", ["cosine", "dot", "euclidean", "mahalanobis"])
def test_pairwise_scores_and_prepare_match(rng, metric):
    q = rng.standard_normal((9, 16)).astype(np.float32)
    c = rng.standard_normal((50, 16)).astype(np.float32)
    w = None
    if metric == "mahalanobis":
        w = np.asarray(jd.whitening_factor(jd.estimate_covariance(c)))
    qj = np.asarray(jd.prepare_for_metric(jnp.asarray(q), metric,
                                          None if w is None else jnp.asarray(w)))
    qt = td.prepare_for_metric(_t(q), metric, None if w is None else _t(w))
    np.testing.assert_allclose(qt.numpy(), qj, atol=TOL, rtol=TOL)
    cj = np.asarray(jd.prepare_for_metric(jnp.asarray(c), metric,
                                          None if w is None else jnp.asarray(w)))
    s_j = np.asarray(jd.pairwise_scores(jnp.asarray(qj), jnp.asarray(cj), metric))
    s_t = td.pairwise_scores(_t(qj), _t(cj), metric).numpy()
    np.testing.assert_allclose(s_t, s_j, rtol=TOL, atol=TOL)
    if metric in ("euclidean", "mahalanobis"):
        assert s_t.max() <= 1e-4  # -||q - c||² convention


def test_pairwise_scores_rejects_unknown_metric():
    with pytest.raises(ValueError):
        td.pairwise_scores(torch.zeros(1, 2), torch.zeros(1, 2), "hamming")


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("n,block", [(300, 8192), (2500, 512), (40, 16)])
def test_exact_topk_matches_blocked(rng, metric, n, block):
    """n > block exercises the running merge; k=7 against n=40/block=16
    clips per block."""
    q = rng.standard_normal((11, 8)).astype(np.float32)
    c = rng.standard_normal((n, 8)).astype(np.float32)
    s_j, i_j = jt.exact_topk(jnp.asarray(q), jnp.asarray(c), k=7,
                             metric=metric, block_size=block)
    s_t, i_t = tt.exact_topk(_t(q), _t(c), k=7, metric=metric,
                             block_size=block)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=TOL,
                               rtol=TOL)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))


@pytest.mark.parametrize("lax_order", [True, False])
@pytest.mark.parametrize("n,block", [(300, 8192), (2500, 512)])
def test_exact_topk_tie_order(rng, n, block, lax_order):
    """Small integer vectors tie exactly, in any sum order. ``lax_order``
    (the default) gives ``lax.top_k``'s ids, ties to the lower row; the
    float select gives its scores and, within each tie group but the
    last, its ids by set."""
    from latentrag_torch.ops.quantization import same_ids_at_ties

    q = rng.integers(-2, 3, (11, 8)).astype(np.float32)
    c = rng.integers(-2, 3, (n, 8)).astype(np.float32)
    s_j, i_j = jt.exact_topk(jnp.asarray(q), jnp.asarray(c), k=40,
                             metric="cosine", block_size=block)
    s_t, i_t = tt.exact_topk(_t(q), _t(c), k=40, metric="cosine",
                             block_size=block, lax_order=lax_order)
    if lax_order:
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    else:
        assert same_ids_at_ties(np.asarray(s_j), np.asarray(i_j),
                                s_t, i_t).all()


def test_exact_topk_clips_k_and_masks(rng):
    q = rng.standard_normal((3, 4)).astype(np.float32)
    c = rng.standard_normal((5, 4)).astype(np.float32)
    s, i = tt.exact_topk(_t(q), _t(c), k=9)
    assert s.shape == (3, 5)
    mask = torch.tensor([True, False, True, False, True])
    s, i = tt.exact_topk(_t(q), _t(c), k=3, mask=mask)
    assert set(i.flatten().tolist()) <= {0, 2, 4}


def test_approx_topk_on_cpu_is_exact(rng):
    q = rng.standard_normal((5, 8)).astype(np.float32)
    c = rng.standard_normal((900, 8)).astype(np.float32)
    s0, i0 = tt.exact_topk(_t(q), _t(c), k=6)
    s1, i1 = tt.approx_topk(_t(q), _t(c), k=6, recall_target=0.9)
    np.testing.assert_array_equal(i0.numpy(), i1.numpy())


@pytest.mark.parametrize("c,k", [(10, 5), (12, 20), (6, 6)])
def test_maxsim_aggregate_matches(rng, c, k):
    scores = rng.standard_normal((8, c)).astype(np.float32)
    docs = rng.integers(0, 4, (8, c)).astype(np.int32)
    scores[0, -1] = -3.4e38  # an empty slot
    docs[0, -1] = -1
    s_j, d_j = jt.maxsim_aggregate(jnp.asarray(scores), jnp.asarray(docs), k=k)
    s_t, d_t = tt.maxsim_aggregate(_t(scores), _t(docs), k=k)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=TOL)
    live = np.asarray(s_j) > -1e37  # duplicate-doc slots are all NEG_INF
    np.testing.assert_array_equal(d_t.numpy()[live], np.asarray(d_j)[live])


def test_unpack_row_mask_matches(rng):
    bits = rng.integers(0, 2, 21).astype(bool)
    packed = np.packbits(bits, bitorder="little")
    want = np.asarray(jt.unpack_row_mask(jnp.asarray(packed), 21))
    got = tt.unpack_row_mask(_t(packed), 21).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, bits)
