"""Training: the autoencoder trainer and its CLI (``train``), the sentence
encoder's, DPR's and the reranker's trainers, their losses and the
checkpoint functions (``.pth`` weights, ``.train.pt`` resume state)."""

from .losses import (
    contrastive_loss,
    cosine_reconstruction,
    dae_loss,
    kl_divergence,
    triplet_loss,
    vae_loss,
)
from .train_dpr import build_dpr_encoders
from .trainer import (
    TrainResult,
    Trainer,
    restore_training_state,
    save_training_state,
    save_weights,
)

__all__ = [
    "contrastive_loss",
    "cosine_reconstruction",
    "dae_loss",
    "kl_divergence",
    "triplet_loss",
    "vae_loss",
    "build_dpr_encoders",
    "TrainResult",
    "Trainer",
    "restore_training_state",
    "save_training_state",
    "save_weights",
]
