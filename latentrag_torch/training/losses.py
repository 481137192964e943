"""Training objectives of the three autoencoder variants.

The port of the JAX package's ``training/losses.py``:

* VAE: cosine reconstruction ``(1 - cos(x_hat, x)).mean()`` + beta * KL,
  with KL = ``-0.5 * mean(1 + logvar - mu^2 - e^logvar)``;
* DAE: MSE (noisy input -> clean target);
* contrastive: the triplet margin loss, with in-batch hard-negative
  mining (the masked pairwise-distance row-min) or given negatives.

Reductions run in fp32.
"""

from __future__ import annotations

import torch


def cosine_reconstruction(x_recon: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    x_recon, x = x_recon.float(), x.float()
    dot = torch.sum(x_recon * x, dim=-1)
    nr = torch.linalg.norm(x_recon, dim=-1)
    nx = torch.linalg.norm(x, dim=-1)
    cos = dot / torch.clamp(nr * nx, min=1e-12)
    return torch.mean(1.0 - cos)


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    mu, logvar = mu.float(), logvar.float()
    return -0.5 * torch.mean(1.0 + logvar - mu.square() - torch.exp(logvar))


def vae_loss(
    x_recon: torch.Tensor,
    x: torch.Tensor,
    mu: torch.Tensor,
    logvar: torch.Tensor,
    beta: float = 1e-3,
) -> tuple[torch.Tensor, dict]:
    recon = cosine_reconstruction(x_recon, x)
    kl = kl_divergence(mu, logvar)
    return recon + beta * kl, {"recon": recon, "kl": kl}


def dae_loss(x_recon: torch.Tensor, x_clean: torch.Tensor) -> torch.Tensor:
    return torch.mean((x_recon.float() - x_clean.float()).square())


def _pairwise_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distance matrix [N, M] with fp32 accumulation."""
    a, b = a.float(), b.float()
    a_sq = torch.sum(a.square(), dim=1, keepdim=True)
    b_sq = torch.sum(b.square(), dim=1)[None, :]
    d2 = a_sq + b_sq - 2.0 * (a @ b.T)
    return torch.sqrt(torch.clamp(d2, min=0.0))


def triplet_loss(
    anchor: torch.Tensor,
    positive: torch.Tensor,
    negative: torch.Tensor,
    margin: float = 0.2,
) -> torch.Tensor:
    d_pos = torch.linalg.norm(anchor.float() - positive.float(), dim=-1)
    d_neg = torch.linalg.norm(anchor.float() - negative.float(), dim=-1)
    return torch.mean(torch.clamp(d_pos - d_neg + margin, min=0.0))


def contrastive_loss(
    z_query: torch.Tensor,
    z_positive: torch.Tensor,
    z_negative: torch.Tensor | None = None,
    margin: float = 0.2,
    mine_hard_negatives: bool = True,
) -> torch.Tensor:
    """Triplet margin loss over latent codes.

    With ``mine_hard_negatives`` the negative of anchor i is the hardest
    in-batch positive j != i (the row-min of the distance matrix, the first
    index on ties) and ``z_negative`` is ignored. Duplicate positives are
    excluded like the diagonal: mining one would make the negative the
    positive itself, an anchor without gradient. Otherwise the given
    negatives, or the positives rolled by one."""
    if mine_hard_negatives:
        with torch.no_grad():
            d = _pairwise_dists(z_query, z_positive)
            n = d.shape[0]
            eye = torch.eye(n, dtype=torch.bool, device=d.device)
            dup = torch.all(z_positive[:, None, :] == z_positive[None, :, :],
                            dim=-1)
            d = torch.where(eye | dup, torch.inf, d)
            hard_idx = torch.argmin(d, dim=1)
        negative = z_positive[hard_idx]
    elif z_negative is not None:
        negative = z_negative
    else:
        negative = torch.roll(z_positive, 1, dims=0)
    return triplet_loss(z_query, z_positive, negative, margin)
