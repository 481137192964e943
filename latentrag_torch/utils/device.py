"""Device selection for the port's entry points.

Every entry point takes ``device`` (default ``"cuda"``). Asking for CUDA
where there is none raises: the port never moves to the CPU on its own,
so a run that reports device numbers has run on the device.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev


def as_tensor(x) -> torch.Tensor:
    """``x`` as a tensor: a tensor stays on its device, numpy goes to the
    card (``resolve_device``'s default, which raises without CUDA)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(np.asarray(x), device=resolve_device())
