"""Global seeding for the host RNGs and PyTorch.

The JAX package threads ``jax.random`` keys (its ``KeySeq`` hands out
fresh ones); the port seeds Python's, numpy's and PyTorch's default
generators here, and modules that draw weights take an explicit
``torch.Generator`` in ``KeySeq``'s place, so ``KeySeq`` has no port.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int, deterministic: bool = False) -> None:
    """Seed Python's, numpy's and PyTorch's default generators.

    ``deterministic`` asks PyTorch for deterministic algorithms where it
    has them (slower, bitwise-reproducible reductions)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
