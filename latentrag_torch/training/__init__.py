"""Training entry points. So far only the DPR towers' builder: the
trainers (ROADMAP queue 1, items 21-22) are not ported yet."""

from .train_dpr import build_dpr_encoders

__all__ = ["build_dpr_encoders"]
