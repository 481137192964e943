"""Latent-compression autoencoders (VAE / DAE / CAE) as ``nn.Module``s.

The port of the JAX package's ``models/autoencoders.py``: 384→512→64 MLPs
that compress sentence embeddings into the retrieval latent space. The
modules use the reference torch checkpoints' own key names (``encoder.0``,
``encoder.2``, ``mu_layer``, ``logvar_layer``, ``decoder.0``,
``decoder.2``), so a reference ``.pth`` loads with ``load_state_dict``.

``latent(x)`` is the retrieval-time latent: the posterior mean for the VAE,
the encoder output for the DAE, the L2-normalised encoder output for the
CAE (``encode_latents`` takes it without autograd). ``init_autoencoder``
draws the weights at Flax's ``Dense`` init scales from a
``torch.Generator``, as the trainer starts them.
"""

from __future__ import annotations

import math

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

    def forward(self, x, train: bool = False,
                generator: torch.Generator | None = None,
                eps: torch.Tensor | None = None):
        """(recon, mu, logvar). By default z = mu, the deterministic path
        of retrieval. With ``train=True`` z = mu + eps * exp(0.5 * logvar),
        where ``eps`` is given or drawn N(0, 1) from ``generator`` (on
        ``x``'s device); one of them is required."""
        mu, logvar = self.encode(x)
        if not train:
            return self.decode(mu), mu, logvar
        if eps is None:
            if generator is None:
                raise ValueError("train=True needs a generator or eps")
            eps = torch.randn(mu.shape, generator=generator,
                              device=mu.device, dtype=mu.dtype)
        return self.decode(mu + eps * torch.exp(0.5 * logvar)), mu, logvar

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


def encode_latents(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Deterministic retrieval-time latent for any AE type (VAE -> mu)."""
    with torch.no_grad():
        return model.latent(x)


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


# jax.nn.initializers.lecun_normal: variance 1 / fan_in through a normal
# truncated to two standard deviations, whose own deviation this restores
_TRUNC_STD = 0.87962566103423978


def init_autoencoder(model: nn.Module, generator: torch.Generator) -> None:
    """Draw ``model``'s weights in place at the JAX package's init scales
    (Flax ``nn.Dense``: lecun-normal kernels, a normal truncated at two
    standard deviations with variance 1 / fan_in, and zero biases) from
    ``generator``, a CPU generator. The draws differ from JAX's PRNG."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
                continue
            std = math.sqrt(1.0 / p.shape[1]) / _TRUNC_STD
            u = torch.rand(p.shape, generator=generator, dtype=torch.float64)
            z = torch.erfinv((2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1.0))
            p.copy_((z * math.sqrt(2.0) * std).to(p.dtype))
