"""EmbeddingCompressor: sentence encoder + optional latent autoencoder.

The port of the JAX package's ``retrieval/embedder.py``. Texts are encoded
on the encoder's device and, with an AE attached, compressed chunk by
chunk through the AE's retrieval latent (VAE -> posterior mean), so peak
device memory is one encoder chunk plus the [N, latent] result, never the
full [N, hidden] encoder output. Results stay on the device as fp32
tensors.
"""

from __future__ import annotations

from typing import Sequence

import torch


class EmbeddingCompressor:
    """Text -> (optionally compressed) embedding tensor.

    ``encoder`` exposes ``encode_batch(list[str]) -> Tensor [B, D]`` and
    ``dim``; ``autoencoder`` is an AE ``nn.Module`` on the same device, or
    ``None``."""

    def __init__(self, encoder, autoencoder=None, batch_size: int = 64):
        self.encoder = encoder
        self.autoencoder = autoencoder
        self.batch_size = batch_size

    @property
    def input_dim(self) -> int:
        return int(self.encoder.dim)

    @property
    def output_dim(self) -> int:
        if self.autoencoder is None:
            return self.input_dim
        return int(self.autoencoder.latent_dim)

    @torch.no_grad()
    def encode_text(self, texts: Sequence[str]) -> torch.Tensor:
        """Batched encode (+compress): fp32 [N, output_dim] on the device."""
        texts = list(texts)
        if self.autoencoder is None or not texts:
            emb = self.encoder.encode_batch(texts)
            if self.autoencoder is not None:  # empty input keeps its width
                emb = emb.new_zeros((0, self.output_dim))
            return emb.float()
        bs = max(self.batch_size, 1)
        zs = [
            self.autoencoder.latent(self.encoder.encode_batch(texts[i : i + bs]))
            for i in range(0, len(texts), bs)
        ]
        return (zs[0] if len(zs) == 1 else torch.cat(zs)).float()
