"""The port's AE losses (``latentrag_torch/training/losses.py``) against
the JAX package's on the same seeded inputs: each value within 1e-6
relative, and its gradient (autograd against ``jax.grad``) within 1e-5
relative + 1e-7 absolute, the mining case with duplicate positives and
ties included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentrag_tpu.training import losses as jl
from latentrag_torch.training import losses as tl

VALUE_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7


def _inputs(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _check(jax_fn, torch_fn, arrays):
    """Value and gradient w.r.t. every input of both scalar losses."""
    want, jgrads = jax.value_and_grad(
        jax_fn, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    got = torch_fn(*ts)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=VALUE_RTOL)
    for t, g in zip(ts, jgrads):
        # an input the loss does not read: no grad here, zeros in JAX
        grad = t.grad if t.grad is not None else torch.zeros_like(t)
        np.testing.assert_allclose(grad.numpy(), np.asarray(g),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
    return got.item()


@pytest.mark.parametrize("seed", [0, 1])
def test_vae_terms_match_jax(seed):
    recon, x, mu, logvar = _inputs(seed, [(16, 24), (16, 24), (16, 8),
                                          (16, 8)])
    _check(jl.cosine_reconstruction, tl.cosine_reconstruction, [recon, x])
    _check(jl.kl_divergence, tl.kl_divergence, [mu, logvar])
    for beta in (1e-3, 0.5):
        _check(lambda *a: jl.vae_loss(*a, beta=beta)[0],
               lambda *a: tl.vae_loss(*a, beta=beta)[0],
               [recon, x, mu, logvar])
    total, aux = tl.vae_loss(*(torch.from_numpy(a) for a in
                               (recon, x, mu, logvar)))
    assert set(aux) == {"recon", "kl"}
    # a zero row: the clamped denominator gives the same value in both;
    # the norm's gradient there is NaN in JAX and 0 in PyTorch, so only
    # the value is held, and the port's gradient must be finite
    recon[3] = 0.0
    want = jl.cosine_reconstruction(jnp.asarray(recon), jnp.asarray(x))
    r = torch.tensor(recon, requires_grad=True)
    got = tl.cosine_reconstruction(r, torch.from_numpy(x))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=VALUE_RTOL)
    assert torch.isfinite(r.grad).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_dae_and_triplet_match_jax(seed):
    a, p, n = _inputs(seed, [(16, 8), (16, 8), (16, 8)])
    _check(jl.dae_loss, tl.dae_loss, [a, p])
    for margin in (0.2, 5.0):
        _check(lambda *v: jl.triplet_loss(*v, margin=margin),
               lambda *v: tl.triplet_loss(*v, margin=margin), [a, p, n])


def test_pairwise_dists_match_jax():
    a, b = _inputs(3, [(12, 8), (9, 8)])
    np.testing.assert_allclose(
        tl._pairwise_dists(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jl._pairwise_dists(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6, atol=1e-6)
    # the diagonal of a with itself: clamped at 0, not NaN
    d = tl._pairwise_dists(torch.from_numpy(a), torch.from_numpy(a))
    assert torch.isfinite(d).all()


@pytest.mark.parametrize("mode", ["mined", "given", "rolled"])
def test_contrastive_loss_matches_jax(mode):
    q, p, n = _inputs(4, [(24, 8), (24, 8), (24, 8)])
    mine = mode == "mined"

    def jfn(q, p, n):
        return jl.contrastive_loss(q, p, n if mode == "given" else None,
                                   margin=0.3, mine_hard_negatives=mine)

    def tfn(q, p, n):
        return tl.contrastive_loss(q, p, n if mode == "given" else None,
                                   margin=0.3, mine_hard_negatives=mine)

    assert _check(jfn, tfn, [q, p, n]) > 0


def test_mining_skips_duplicates_and_takes_the_first_tie():
    """Rows 0-2 share one positive (the mined negative must not be one of
    them); rows 5 and 6 are an exact copy of row 4's distance pattern, so
    anchor 7's nearest other positive ties between them, and both
    packages take the first index."""
    q, p = _inputs(5, [(10, 6), (10, 6)])
    p[1] = p[0]
    p[2] = p[0]
    p[5] = p[4] + 0.25
    p[6] = p[5]
    q[7] = p[5] + 0.01
    ts = [torch.tensor(a, requires_grad=True) for a in (q, p)]
    d = tl._pairwise_dists(ts[0], ts[1]).detach()
    eye = torch.eye(10, dtype=torch.bool)
    dup = torch.all(ts[1][:, None] == ts[1][None], dim=-1)
    hard = torch.where(eye | dup, torch.inf, d).argmin(1)
    assert hard[0] not in (0, 1, 2) and hard[1] not in (0, 1, 2)
    _check(lambda q, p: jl.contrastive_loss(q, p, margin=1.0),
           lambda q, p: tl.contrastive_loss(q, p, margin=1.0), [q, p])
