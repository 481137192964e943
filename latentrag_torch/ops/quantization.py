"""Int8 scalar quantization (SQ8) of the latent corpus.

The port of the JAX package's ``ops/quantization.py``, so far only
``sq8_quantize``: the binary store keeps SQ8 codes on the host for its
exact stage-2 rescore. The int8 store's search (``sq8_topk``) and the
packed SQ4 functions are ROADMAP queue 1 item 15.
"""

from __future__ import annotations

import torch


def sq8_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (codes [N, D] int8, scale f32).

    ``x ~ codes * scale``; scale = max|x| / 127. ``torch.round`` rounds
    half to even as ``jnp.round`` does, so the codes match the JAX
    package's bit for bit."""
    x = x.float()
    scale = torch.clamp(x.abs().max() / 127.0, min=1e-12)
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes, scale
