"""Similarity-space transforms: normalization, whitening, score blocks.

The port of the JAX package's ``ops/distances.py``. Scores are
higher-is-better everywhere: euclidean and mahalanobis give -||q - c||²,
and mahalanobis is euclidean in a whitened space (W = L^-T from the
Cholesky factor of the shrunk covariance), so every metric shares one
top-k path.

The JAX reference scores fp32 at ``Precision.HIGHEST``. PyTorch's fp32
matrix products on the card may run in TF32 when asked; this module turns
that off for matmuls and cuDNN alike, so fp32 here is fp32.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

METRICS = ("cosine", "dot", "euclidean", "mahalanobis")


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization (fp32 accumulation for the norm)."""
    norm = torch.sqrt(torch.sum(torch.square(x.float()), dim=-1, keepdim=True))
    return (x / torch.clamp(norm, min=eps).to(x.dtype)).to(x.dtype)


def estimate_covariance(x: torch.Tensor, shrinkage: float = 1e-3) -> torch.Tensor:
    """Empirical covariance with diagonal shrinkage toward mean variance."""
    x = x.float()
    mu = x.mean(dim=0, keepdim=True)
    xc = x - mu
    cov = (xc.T @ xc) / max(x.shape[0] - 1, 1)
    avg_var = torch.trace(cov) / cov.shape[0]
    eye = torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)
    return (1.0 - shrinkage) * cov + shrinkage * avg_var * eye


def whitening_factor(cov: torch.Tensor) -> torch.Tensor:
    """W with ``(x-y) Σ⁻¹ (x-y)ᵀ == ||xW - yW||²``: Σ = L Lᵀ, W = L⁻ᵀ."""
    L = torch.linalg.cholesky(cov.float())
    eye = torch.eye(cov.shape[0], dtype=torch.float32, device=cov.device)
    L_inv = torch.linalg.solve_triangular(L, eye, upper=False)
    return L_inv.T


def whiten(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (x.float() @ w).to(x.dtype)


def pairwise_scores(
    queries: torch.Tensor, corpus: torch.Tensor, metric: str = "cosine"
) -> torch.Tensor:
    """Dense [Q, N] fp32 score block over PREPARED inputs (cosine:
    normalized; euclidean: raw; mahalanobis: whitened). bf16 inputs are
    widened first: the products of bf16 values are exact in fp32, as the
    reference's fp32-accumulating dot gives them."""
    if metric not in METRICS:
        raise ValueError(f"metric {metric!r} not in {METRICS}")
    qf, cf = queries.float(), corpus.float()
    dots = qf @ cf.T
    if metric in ("cosine", "dot"):
        return dots
    q_sq = torch.sum(torch.square(qf), dim=-1, keepdim=True)
    c_sq = torch.sum(torch.square(cf), dim=-1)[None, :]
    return 2.0 * dots - q_sq - c_sq


def prepare_for_metric(
    x: torch.Tensor, metric: str, whitener: torch.Tensor | None = None
) -> torch.Tensor:
    """Apply the one-time per-side transform for a metric."""
    if metric == "cosine":
        return l2_normalize(x)
    if metric == "mahalanobis":
        if whitener is None:
            raise ValueError("mahalanobis requires a whitening factor")
        return whiten(x, whitener)
    return x
