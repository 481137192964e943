"""Embedding-space diagnostics: original vs compressed latents.

The port of the JAX package's ``evaluation/visualization.py``: each
query's positive-pair rank against all documents under cosine similarity,
Recall@k before and after compression, a PCA or t-SNE projection (cosine
metric, PCA init), the paired scatter with the least similar pairs linked,
the pair-distance histogram with its CDF, and positives against sampled
negatives. Ranks and recall are tensor ops on the device of their inputs
(a card tensor stays on the card; numpy goes to the CPU); the plots run on
the host through matplotlib and scikit-learn, imported at the call, which
the card machine lacks: ``make_plots=False`` needs neither.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..ops.distances import l2_normalize

log = logging.getLogger("latentrag_torch.eval")


def _rows(x) -> torch.Tensor:
    """``x`` as an fp32 tensor: a tensor stays on its device, numpy (or a
    list) becomes a CPU tensor."""
    return torch.as_tensor(x).float()


def _host_normalized(x) -> np.ndarray:
    return l2_normalize(_rows(x)).cpu().numpy()


def positive_ranks(query_emb, doc_emb) -> torch.Tensor:
    """1-based rank of the aligned (positive) doc of each query under
    cosine similarity against all docs; a tie with the positive does not
    push it down."""
    q = l2_normalize(_rows(query_emb))
    d = l2_normalize(_rows(doc_emb))
    sims = q @ d.T  # [N, N]
    pos = torch.diagonal(sims)
    return 1 + (sims > pos[:, None]).sum(dim=1)


def recall_at_k(ranks, k: int) -> float:
    return float((torch.as_tensor(ranks) <= k).double().mean())


def _plotting():
    """matplotlib's pyplot on the Agg backend, or an ImportError naming
    what the plots need."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "the latent-space plots need matplotlib and scikit-learn, which "
            "are not installed; pass make_plots=False for the recall and "
            "rank numbers alone"
        ) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _project(emb: np.ndarray, method: str, perplexity: float = 30.0):
    try:
        from sklearn.decomposition import PCA
        from sklearn.manifold import TSNE
    except ImportError as e:
        raise ImportError(
            "the latent-space projection needs scikit-learn (and the plots "
            "matplotlib), which is not installed; pass make_plots=False for "
            "the recall and rank numbers alone"
        ) from e
    if method == "pca":
        return PCA(n_components=2).fit_transform(emb)
    if method == "tsne":
        return TSNE(
            n_components=2,
            metric="cosine",
            init="pca",
            perplexity=min(perplexity, max(2.0, (len(emb) - 1) / 3.0)),
            random_state=0,
        ).fit_transform(emb)
    raise ValueError(f"unknown projection {method!r}")


def visualize_compressed_vs_original(
    query_emb,
    doc_emb,
    query_latent,
    doc_latent,
    out_dir: str = "fig",
    prefix: str = "latent",
    k: int = 10,
    projection: str = "pca",
    top_dissimilar: int = 10,
    make_plots: bool = True,
) -> dict:
    """Side-by-side diagnostics of the raw vs compressed embedding space."""
    ranks_orig = positive_ranks(query_emb, doc_emb)
    ranks_comp = positive_ranks(query_latent, doc_latent)
    result = {
        "recall_original": recall_at_k(ranks_orig, k),
        "recall_compressed": recall_at_k(ranks_comp, k),
        "mean_rank_original": float(ranks_orig.double().mean()),
        "mean_rank_compressed": float(ranks_comp.double().mean()),
    }
    if not make_plots:
        return result

    plt = _plotting()
    os.makedirs(out_dir, exist_ok=True)
    q_lat = _rows(query_latent).cpu().numpy()
    d_lat = _rows(doc_latent).cpu().numpy()
    n = len(q_lat)

    # --- paired scatter with dissimilar-pair links ------------------------
    proj = _project(np.concatenate([q_lat, d_lat], axis=0), projection)
    qp, dp = proj[:n], proj[n:]
    pair_sims = (_host_normalized(q_lat) * _host_normalized(d_lat)).sum(axis=1)
    worst = np.argsort(pair_sims)[:top_dissimilar]

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.scatter(qp[:, 0], qp[:, 1], s=12, c="tab:blue", label="queries")
    ax.scatter(dp[:, 0], dp[:, 1], s=12, c="tab:orange", label="documents")
    for i in worst:
        ax.plot(
            [qp[i, 0], dp[i, 0]], [qp[i, 1], dp[i, 1]],
            c="tab:red", lw=0.8, alpha=0.7,
        )
    ax.set_title(f"{prefix}: latent space ({projection})")
    ax.legend()
    scatter_path = os.path.join(out_dir, f"{prefix}_{projection}_pairs.png")
    fig.savefig(scatter_path, dpi=120)
    plt.close(fig)

    # --- pair-distance histogram + CDF ------------------------------------
    fig, ax = plt.subplots(figsize=(8, 5))
    dists = 1.0 - pair_sims
    ax.hist(dists, bins=40, alpha=0.7, label="pair cosine distance")
    ax2 = ax.twinx()
    xs = np.sort(dists)
    ax2.plot(xs, np.linspace(0, 1, len(xs)), c="tab:red", label="CDF")
    ax.set_title(f"{prefix}: positive-pair distances")
    hist_path = os.path.join(out_dir, f"{prefix}_pair_dist.png")
    fig.savefig(hist_path, dpi=120)
    plt.close(fig)

    result["figures"] = [scatter_path, hist_path]
    log.info("wrote %s, %s", scatter_path, hist_path)
    return result


def plot_positive_vs_negative_distances(
    query_latent,
    doc_latent,
    out_dir: str = "fig",
    prefix: str = "latent",
    n_negatives: int = 1000,
    seed: int = 0,
) -> str:
    """Histogram of positive-pair vs sampled negative-pair cosine distances
    (``default_rng(seed)`` draws the negatives, as the JAX package does)."""
    plt = _plotting()
    qn = _host_normalized(query_latent)
    dn = _host_normalized(doc_latent)
    pos = 1.0 - (qn * dn).sum(axis=1)
    rng = np.random.default_rng(seed)
    n = len(qn)
    qi = rng.integers(0, n, n_negatives)
    di = rng.integers(0, n, n_negatives)
    keep = qi != di
    neg = 1.0 - (qn[qi[keep]] * dn[di[keep]]).sum(axis=1)

    os.makedirs(out_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.hist(pos, bins=40, alpha=0.6, label="positives", density=True)
    ax.hist(neg, bins=40, alpha=0.6, label="negatives", density=True)
    ax.set_xlabel("cosine distance")
    ax.legend()
    ax.set_title(f"{prefix}: positives vs negatives")
    path = os.path.join(out_dir, f"{prefix}_pos_neg.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
