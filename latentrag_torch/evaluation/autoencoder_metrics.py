"""Autoencoder quality and compression accounting: the JAX package's
``evaluation/autoencoder_metrics.py`` (reconstruction MSE, compression
ratio, the index's size on disk against the raw embeddings')."""

from __future__ import annotations

import os

import numpy as np
import torch


def reconstruction_mse(model: torch.nn.Module, x) -> float:
    """Mean squared reconstruction error over a batch, on the deterministic
    path (the VAE decodes its mean), on the device of ``model``; the mean
    is taken in fp64 on the host."""
    dev = next(model.parameters()).device
    xt = torch.as_tensor(x, dtype=torch.float32).to(dev)
    with torch.no_grad():
        out = model(xt)
    recon = out[0] if isinstance(out, tuple) else out
    d = (recon.cpu().numpy().astype(np.float64)
         - xt.cpu().numpy().astype(np.float64))
    return float(np.mean(np.square(d)))


def compression_ratio(dim_in: int, dim_out: int) -> float:
    if dim_out <= 0:
        raise ValueError("dim_out must be positive")
    return dim_in / dim_out


def summarise_sizes(
    index_path: str | None, n_vectors: int, dim_in: int, dim_out: int
) -> dict:
    """Disk footprint of the index vs estimated fp32 embedding storage."""
    index_bytes = 0
    if index_path and os.path.exists(index_path):
        if os.path.isdir(index_path):
            for root, _, files in os.walk(index_path):
                index_bytes += sum(
                    os.path.getsize(os.path.join(root, f)) for f in files
                )
        else:
            index_bytes = os.path.getsize(index_path)
    return {
        "index_bytes": index_bytes,
        "raw_fp32_bytes": n_vectors * dim_in * 4,
        "latent_fp32_bytes": n_vectors * dim_out * 4,
        "compression_ratio": compression_ratio(dim_in, dim_out),
    }
