"""Weights carried across: JAX-package parameter trees -> the port's state dicts.

The JAX package keeps Flax parameter trees: ``Dense`` layers as
``kernel [in, out]`` + ``bias``, ``LayerNorm`` as ``scale`` + ``bias``,
``Embed`` as ``embedding``. The port's modules hold ``nn.Linear``
(``weight [out, in]``), ``nn.LayerNorm`` (``weight``) and ``nn.Embedding``
(``weight``). These functions take the Flax tree as nested dicts of arrays
(numpy, or anything ``np.asarray`` reads) and return the port's
``state_dict``; they import nothing of JAX.

``minilm_params_from_state_dict`` and ``cross_encoder_params_from_state_dict``
go the other way for the sentence encoder (and the DPR towers) and the
cross-encoder reranker: the port's state dict -> the Flax tree, keys in
the order the Flax module creates them, for ``msgpack_io.save_msgpack``.

``load_autoencoder_pth`` reads a reference-keyed ``.pth``, which needs no
conversion. The JAX package's encoder msgpack reads into such a tree with
``models.encoder.msgpack_io.load_msgpack`` (a bf16 leaf arrives as a
``torch.bfloat16`` tensor), and a local Hugging Face checkpoint with
``models.encoder.convert``. Its Orbax AE checkpoints are read where the
JAX package runs: ``scripts/orbax_ae_to_pth.py`` maps their params through
``autoencoder_state_dict_from_jax`` into the ``.pth`` that
``load_autoencoder_pth`` reads (the port's own trainer writes one too).
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


_LAYER_DENSE = ("q", "k", "v", "attn_out", "mlp_in", "mlp_out")
# a TransformerLayer's submodules in the order the Flax module makes them
_LAYER_ORDER = ("q", "k", "v", "attn_out", "attn_ln", "mlp_in", "mlp_out",
                "mlp_ln")


def _trunk(params: Mapping) -> dict[str, torch.Tensor]:
    """The word and position embeddings, the embedding LayerNorm and the
    ``layer_<i>`` blocks, shared by the sentence and cross encoders."""
    sd = {
        "word_embeddings.weight": _t(params["word_embeddings"]["embedding"]),
        "position_embeddings.weight":
            _t(params["position_embeddings"]["embedding"]),
        **_ln(params["embed_ln"], "embed_ln"),
    }
    n_layers = sum(1 for key in params if key.startswith("layer_"))
    for i in range(n_layers):
        p = params[f"layer_{i}"]
        pre = f"layers.{i}"
        for name in _LAYER_DENSE:
            sd.update(_linear(p[name], f"{pre}.{name}"))
        sd.update(_ln(p["attn_ln"], f"{pre}.attn_ln"))
        sd.update(_ln(p["mlp_ln"], f"{pre}.mlp_ln"))
    return sd


def minilm_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``MiniLMEncoder`` params -> ``MiniLMEncoder`` state dict."""
    return {**_trunk(params),
            "token_type_embedding": _t(params["token_type_embedding"])}


def cross_encoder_state_dict_from_jax(
    params: Mapping,
) -> dict[str, torch.Tensor]:
    """Flax ``CrossEncoderModel`` params -> ``CrossEncoderModel`` state
    dict."""
    return {
        **_trunk(params),
        "token_type_embeddings.weight":
            _t(params["token_type_embeddings"]["embedding"]),
        **_linear(params["pooler"], "pooler"),
        **_linear(params["classifier"], "classifier"),
    }


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _dense_params(sd: Mapping[str, torch.Tensor], pre: str) -> dict:
    return {"kernel": _np(sd[f"{pre}.weight"]).T.copy(),
            "bias": _np(sd[f"{pre}.bias"])}


def _ln_params(sd: Mapping[str, torch.Tensor], pre: str) -> dict:
    return {"scale": _np(sd[f"{pre}.weight"]), "bias": _np(sd[f"{pre}.bias"])}


def _trunk_params(sd: Mapping[str, torch.Tensor], segment: dict) -> dict:
    """The trunk's half of a Flax tree (fp32 numpy leaves, in the order the
    Flax module creates them): word and position embeddings, ``segment``
    (the segment embedding's entry), the embedding LayerNorm and the
    ``layer_<i>`` blocks; shared by the sentence and cross encoders."""
    tree = {
        "word_embeddings": {"embedding": _np(sd["word_embeddings.weight"])},
        "position_embeddings": {
            "embedding": _np(sd["position_embeddings.weight"])},
        **segment,
        "embed_ln": _ln_params(sd, "embed_ln"),
    }
    n_layers = len({key.split(".")[1] for key in sd
                    if key.startswith("layers.")})
    for i in range(n_layers):
        tree[f"layer_{i}"] = {
            name: (_ln_params if name.endswith("_ln") else _dense_params)(
                sd, f"layers.{i}.{name}")
            for name in _LAYER_ORDER
        }
    return tree


def minilm_params_from_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    """``MiniLMEncoder`` state dict -> the Flax ``MiniLMEncoder`` tree, the
    inverse of ``minilm_state_dict_from_jax``: what the JAX package's
    ``load_params`` restores from a ``save_msgpack`` of it (the encoder's
    and the DPR towers' checkpoints)."""
    return _trunk_params(sd, {
        "token_type_embedding": _np(sd["token_type_embedding"])})


def cross_encoder_params_from_state_dict(
    sd: Mapping[str, torch.Tensor],
) -> dict:
    """``CrossEncoderModel`` state dict -> the Flax ``CrossEncoderModel``
    tree (fp32 numpy leaves, Flax's key order): what the JAX package's
    ``load_params`` restores from a ``save_msgpack`` of it."""
    return {
        **_trunk_params(sd, {"token_type_embeddings": {
            "embedding": _np(sd["token_type_embeddings.weight"])}}),
        "pooler": _dense_params(sd, "pooler"),
        "classifier": _dense_params(sd, "classifier"),
    }


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
