"""Hugging Face BERT checkpoints -> the JAX package's parameter trees.

The port of the JAX package's ``models/encoder/convert.py``: a standard HF
BERT checkpoint (sentence-transformers/all-MiniLM-L6-v2, or a 1-label
``BertForSequenceClassification`` cross-encoder of the ms-marco family)
becomes the Flax ``MiniLMEncoder`` / ``CrossEncoderModel`` tree, leaf for
leaf the JAX converter's, which ``models.convert`` maps to the port's
state dicts and ``save_params`` writes as ``flax.serialization`` would.

The JAX converter loads through ``transformers.AutoModel``; the machine
that serves the port has no ``transformers``, so this module reads the
checkpoint directory itself, and only a local one (the port never uses
the network):

* ``config.json`` must be there (``from_pretrained`` needs it too);
* ``model.safetensors``: an 8-byte little-endian header length, a JSON
  header (``__metadata__`` skipped), then the raw little-endian buffers at
  each tensor's ``data_offsets``; F32, F16, BF16 (widened through uint16)
  and F64;
* else ``pytorch_model.bin``, through ``torch.load(weights_only=True)``;
* either one sharded: the ``*.index.json`` weight map names the files.

Then it does to the keys what ``from_pretrained`` does for these models:
the ``bert.`` prefix is stripped, legacy ``LayerNorm.gamma`` / ``beta``
become ``weight`` / ``bias``, ``position_ids`` buffers are ignored, and
every tensor is widened to fp32 (``from_pretrained`` without a
``torch_dtype`` loads fp32). The vocab file is the directory's
``vocab.txt``, or None without one (the JAX converter then asks
``AutoTokenizer``, which is not here either).
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

from .msgpack_io import load_msgpack, save_msgpack

_SAFETENSORS = "model.safetensors"
_TORCH_BIN = "pytorch_model.bin"
# safetensors dtypes a float checkpoint holds, as little-endian numpy types
_ST_DTYPES = {"F32": "<f4", "F16": "<f2", "F64": "<f8", "BF16": "<u2"}


def _decode(raw: bytes, dtype: str, shape, name: str) -> np.ndarray:
    if dtype not in _ST_DTYPES:
        raise ValueError(f"{name}: safetensors dtype {dtype} is not a float "
                         "type this reader takes (F32, F16, BF16, F64)")
    np_dtype = np.dtype(_ST_DTYPES[dtype])
    if len(raw) != int(np.prod(shape, dtype=np.int64)) * np_dtype.itemsize:
        raise ValueError(f"{name}: {len(raw)} bytes for shape {shape} of "
                         f"{dtype}")
    arr = np.frombuffer(raw, dtype=np_dtype).reshape(shape)
    if dtype == "BF16":
        return (arr.astype(np.uint32) << 16).view(np.float32)
    return arr.astype(np.float32)


def _read_safetensors(path: str) -> dict[str, np.ndarray]:
    """Every tensor of a safetensors file but ``position_ids``, fp32."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        for name, info in header.items():
            if name == "__metadata__" or name.endswith("position_ids"):
                continue
            begin, end = info["data_offsets"]
            f.seek(base + begin)
            out[name] = _decode(f.read(end - begin), info["dtype"],
                                tuple(info["shape"]), name)
    return out


def _read_torch_bin(path: str) -> dict[str, np.ndarray]:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {name: t.detach().to(torch.float32).numpy()
            for name, t in sd.items() if not name.endswith("position_ids")}


def read_hf_state_dict(path: str) -> dict[str, np.ndarray]:
    """The fp32 tensors of the local HF checkpoint directory ``path``,
    under the keys ``from_pretrained`` gives them (no ``bert.`` prefix,
    ``weight`` / ``bias`` LayerNorms)."""
    path = str(path)
    if not os.path.isfile(os.path.join(path, "config.json")):
        raise FileNotFoundError(
            f"{path!r} is not a local HF checkpoint directory (no "
            "config.json); the port reads no hub model names, so download "
            "the checkpoint and pass its directory"
        )
    for fname, read in ((_SAFETENSORS, _read_safetensors),
                        (_TORCH_BIN, _read_torch_bin)):
        single = os.path.join(path, fname)
        index = single + ".index.json"
        if os.path.isfile(single):
            raw = read(single)
            break
        if os.path.isfile(index):
            with open(index) as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
            raw = {}
            for shard in shards:
                raw.update(read(os.path.join(path, shard)))
            break
    else:
        raise FileNotFoundError(
            f"{path}: no {_SAFETENSORS} or {_TORCH_BIN} (nor a sharded "
            "index of either)"
        )
    sd = {}
    for key, value in raw.items():
        if key.startswith("bert."):
            key = key[len("bert."):]
        if key.endswith("LayerNorm.gamma"):
            key = key[: -len("gamma")] + "weight"
        elif key.endswith("LayerNorm.beta"):
            key = key[: -len("beta")] + "bias"
        sd[key] = value
    return sd


def _vocab_file(path: str) -> str | None:
    cand = os.path.join(str(path), "vocab.txt")
    return cand if os.path.exists(cand) else None


def _dense(sd, prefix: str) -> dict:
    return {"kernel": sd[f"{prefix}.weight"].T.copy(),
            "bias": sd[f"{prefix}.bias"].copy()}


def _ln(sd, prefix: str) -> dict:
    return {"scale": sd[f"{prefix}.weight"].copy(),
            "bias": sd[f"{prefix}.bias"].copy()}


def _layers(sd, params: dict) -> dict:
    """The ``layer_<i>`` blocks, as many as the checkpoint has."""
    n_layers = len(
        {k.split(".")[2] for k in sd if k.startswith("encoder.layer.")}
    )
    for i in range(n_layers):
        p = f"encoder.layer.{i}"
        params[f"layer_{i}"] = {
            "q": _dense(sd, f"{p}.attention.self.query"),
            "k": _dense(sd, f"{p}.attention.self.key"),
            "v": _dense(sd, f"{p}.attention.self.value"),
            "attn_out": _dense(sd, f"{p}.attention.output.dense"),
            "attn_ln": _ln(sd, f"{p}.attention.output.LayerNorm"),
            "mlp_in": _dense(sd, f"{p}.intermediate.dense"),
            "mlp_out": _dense(sd, f"{p}.output.dense"),
            "mlp_ln": _ln(sd, f"{p}.output.LayerNorm"),
        }
    return params


def convert_hf_bert_to_params(model_name_or_path: str):
    """(params, vocab_file) of a local HF BERT checkpoint: the Flax
    ``MiniLMEncoder`` tree (fp32 numpy leaves; single segment: the
    token-type row 0), and the directory's ``vocab.txt`` or None."""
    sd = read_hf_state_dict(model_name_or_path)
    params = {
        "word_embeddings": {
            "embedding": sd["embeddings.word_embeddings.weight"].copy()
        },
        "position_embeddings": {
            "embedding": sd["embeddings.position_embeddings.weight"].copy()
        },
        "token_type_embedding": sd[
            "embeddings.token_type_embeddings.weight"
        ][0].copy(),
        "embed_ln": _ln(sd, "embeddings.LayerNorm"),
    }
    return _layers(sd, params), _vocab_file(model_name_or_path)


def convert_hf_cross_encoder_to_params(model_name_or_path: str):
    """(params, vocab_file) of a local HF ``BertForSequenceClassification``
    with one label: the Flax ``CrossEncoderModel`` tree (the 2-row
    token-type table, the tanh pooler, the scalar head). Raises
    ``ValueError`` on a head of another width."""
    sd = read_hf_state_dict(model_name_or_path)
    params = {
        "word_embeddings": {
            "embedding": sd["embeddings.word_embeddings.weight"].copy()
        },
        "position_embeddings": {
            "embedding": sd["embeddings.position_embeddings.weight"].copy()
        },
        "token_type_embeddings": {
            "embedding": sd["embeddings.token_type_embeddings.weight"].copy()
        },
        "embed_ln": _ln(sd, "embeddings.LayerNorm"),
        "pooler": _dense(sd, "pooler.dense"),
        "classifier": _dense(sd, "classifier"),
    }
    if params["classifier"]["bias"].shape != (1,):
        raise ValueError(
            "expected a 1-label cross-encoder head, got "
            f"{params['classifier']['bias'].shape[0]} labels"
        )
    return _layers(sd, params), _vocab_file(model_name_or_path)


def save_params(params, path: str) -> None:
    """Write a params tree as ``flax.serialization.to_bytes`` does (the
    JAX package's ``load_params`` reads it)."""
    save_msgpack(params, path)


def load_params(path: str):
    """The params tree of a msgpack file either package wrote."""
    return load_msgpack(path)
