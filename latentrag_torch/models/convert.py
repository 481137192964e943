"""Weights carried across: JAX-package parameter trees -> the port's state dicts.

The JAX package keeps Flax parameter trees: ``Dense`` layers as
``kernel [in, out]`` + ``bias``, ``LayerNorm`` as ``scale`` + ``bias``,
``Embed`` as ``embedding``. The port's modules hold ``nn.Linear``
(``weight [out, in]``), ``nn.LayerNorm`` (``weight``) and ``nn.Embedding``
(``weight``). These functions take the Flax tree as nested dicts of arrays
(numpy, or anything ``np.asarray`` reads) and return the port's
``state_dict``; they import nothing of JAX.

``load_autoencoder_pth`` reads a reference-keyed ``.pth``, which needs no
conversion. The JAX package's encoder msgpack reads into such a tree with
``models.encoder.msgpack_io.load_msgpack`` (a bf16 leaf arrives as a
``torch.bfloat16`` tensor); its Orbax AE checkpoints have no reader yet.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..utils.config import canonical_ae_type


def _t(a: Any) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).clone()
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(node: Mapping, prefix: str) -> dict:
    return {
        f"{prefix}.weight": _t(node["kernel"]).T.contiguous(),
        f"{prefix}.bias": _t(node["bias"]),
    }


def _ln(node: Mapping, prefix: str) -> dict:
    return {f"{prefix}.weight": _t(node["scale"]),
            f"{prefix}.bias": _t(node["bias"])}


def minilm_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``MiniLMEncoder`` params -> ``MiniLMEncoder`` state dict."""
    sd = {
        "word_embeddings.weight": _t(params["word_embeddings"]["embedding"]),
        "position_embeddings.weight":
            _t(params["position_embeddings"]["embedding"]),
        "token_type_embedding": _t(params["token_type_embedding"]),
        **_ln(params["embed_ln"], "embed_ln"),
    }
    n_layers = sum(1 for key in params if key.startswith("layer_"))
    for i in range(n_layers):
        p = params[f"layer_{i}"]
        pre = f"layers.{i}"
        for name in ("q", "k", "v", "attn_out", "mlp_in", "mlp_out"):
            sd.update(_linear(p[name], f"{pre}.{name}"))
        sd.update(_ln(p["attn_ln"], f"{pre}.attn_ln"))
        sd.update(_ln(p["mlp_ln"], f"{pre}.mlp_ln"))
    return sd


# Flax AE module path -> the reference torch key (models/convert_torch.py
# of the JAX package maps the other way)
_AE_KEYS = {
    "vae": {
        ("enc_hidden",): "encoder.0",
        ("mu_head",): "mu_layer",
        ("logvar_head",): "logvar_layer",
        ("decoder", "hidden"): "decoder.0",
        ("decoder", "out"): "decoder.2",
    },
    "dae": {
        ("encoder", "hidden"): "encoder.0",
        ("encoder", "out"): "encoder.2",
        ("decoder", "hidden"): "decoder.0",
        ("decoder", "out"): "decoder.2",
    },
}
_AE_KEYS["cae"] = _AE_KEYS["dae"]


def autoencoder_state_dict_from_jax(
    params: Mapping, ae_type: str
) -> dict[str, torch.Tensor]:
    """Flax AE params -> the port's (reference-keyed) AE state dict."""
    ae_type = canonical_ae_type(ae_type)
    sd: dict[str, torch.Tensor] = {}
    for path, key in _AE_KEYS[ae_type].items():
        node = params
        for part in path:
            node = node[part]
        sd.update(_linear(node, key))
    return sd


def load_autoencoder_pth(path: str, ae_type: str) -> dict[str, torch.Tensor]:
    """A reference-keyed ``.pth`` state dict, checked against the keys the
    port's module for ``ae_type`` expects."""
    ae_type = canonical_ae_type(ae_type)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    want = {f"{k}.{p}" for k in _AE_KEYS[ae_type].values()
            for p in ("weight", "bias")}
    if set(sd) != want:
        raise KeyError(
            f"{path}: keys {sorted(sd)} do not match ae_type={ae_type!r} "
            f"({sorted(want)})"
        )
    return sd
