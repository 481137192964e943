"""Latent-compression autoencoders (VAE / DAE / CAE) as ``nn.Module``s.

The port of the JAX package's ``models/autoencoders.py``: 384→512→64 MLPs
that compress sentence embeddings into the retrieval latent space. The
modules use the reference torch checkpoints' own key names (``encoder.0``,
``encoder.2``, ``mu_layer``, ``logvar_layer``, ``decoder.0``,
``decoder.2``), so a reference ``.pth`` loads with ``load_state_dict``.

``latent(x)`` is the retrieval-time latent: the posterior mean for the VAE,
the encoder output for the DAE, the L2-normalised encoder output for the
CAE.
"""

from __future__ import annotations

import torch
from torch import nn


def _decoder(latent_dim: int, hidden_dim: int, input_dim: int) -> nn.Sequential:
    return nn.Sequential(
        nn.Linear(latent_dim, hidden_dim), nn.ReLU(),
        nn.Linear(hidden_dim, input_dim),
    )


class VariationalAutoencoder(nn.Module):
    """Gaussian-posterior VAE; ``encode`` returns (mu, logvar)."""

    def __init__(self, input_dim: int = 384, latent_dim: int = 64,
                 hidden_dim: int = 512):
        super().__init__()
        self.latent_dim = latent_dim
        self.encoder = nn.Sequential(nn.Linear(input_dim, hidden_dim), nn.ReLU())
        self.mu_layer = nn.Linear(hidden_dim, latent_dim)
        self.logvar_layer = nn.Linear(hidden_dim, latent_dim)
        self.decoder = _decoder(latent_dim, hidden_dim, input_dim)

    def encode(self, x):
        h = self.encoder(x)
        return self.mu_layer(h), self.logvar_layer(h)

    def decode(self, z):
        return self.decoder(z)

    def forward(self, x):
        """(recon, mu, logvar) with z = mu, the JAX package's deterministic
        path; reparameterised sampling comes with training (slice D)."""
        mu, logvar = self.encode(x)
        return self.decode(mu), mu, logvar

    def latent(self, x):
        return self.encode(x)[0]


class DenoisingAutoencoder(nn.Module):
    """Plain MLP AE trained noisy→clean."""

    def __init__(self, input_dim: int = 384, latent_dim: int = 64,
                 hidden_dim: int = 512):
        super().__init__()
        self.latent_dim = latent_dim
        self.encoder = nn.Sequential(
            nn.Linear(input_dim, hidden_dim), nn.ReLU(),
            nn.Linear(hidden_dim, latent_dim),
        )
        self.decoder = _decoder(latent_dim, hidden_dim, input_dim)

    def encode(self, x):
        return self.encoder(x)

    def decode(self, z):
        return self.decoder(z)

    def forward(self, x):
        return self.decode(self.encode(x))

    def latent(self, x):
        return self.encode(x)


class ContrastiveAutoencoder(DenoisingAutoencoder):
    """AE whose latent is L2-normalised; ``forward`` returns (recon, z)."""

    def encode(self, x):
        z = self.encoder(x)
        norm = torch.linalg.norm(z, dim=-1, keepdim=True)
        return z / torch.clamp(norm, min=1e-12)

    def forward(self, x):
        z = self.encode(x)
        return self.decode(z), z


AE_CLASSES = {
    "vae": VariationalAutoencoder,
    "dae": DenoisingAutoencoder,
    "cae": ContrastiveAutoencoder,
}


def build_autoencoder(ae_type: str, cfg) -> nn.Module:
    """Instantiate from an ``AutoencoderConfig`` (weights from PyTorch's
    default init; load a checkpoint over them)."""
    cls = AE_CLASSES[ae_type]
    return cls(
        input_dim=cfg.input_dim,
        latent_dim=cfg.latent_dim,
        hidden_dim=cfg.hidden_dim,
    )
