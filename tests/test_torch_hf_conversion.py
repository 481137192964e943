"""Local Hugging Face checkpoints in the port, on the CPU: the port reads
the checkpoint directory itself (no ``transformers``) and must give the
JAX converter's parameter tree leaf for leaf, bit for bit, for the same
directory, saved as safetensors, as ``pytorch_model.bin``, as bf16
safetensors, sharded, and with legacy key names.

Small random BERTs are built here with ``transformers`` (vocab 120,
hidden 32, 2 layers), as ``tests/test_hf_conversion.py`` builds them.
Tolerances: the trees bit for bit (both widen to fp32 the same values);
the port's fp32 encoder against HF's forward within 1e-5 (mean-pooled,
normalized embeddings; the cross-encoder's logits), two fp32 sum orders
of one network; ``default_encoder``'s ``encoder.msgpack`` byte for byte
the JAX ``save_params`` of the JAX conversion."""

import copy
import json
import logging
import os

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from latentrag_tpu.models.encoder.convert import (
    convert_hf_bert_to_params as jax_convert_bert,
)
from latentrag_tpu.models.encoder.convert import (
    convert_hf_cross_encoder_to_params as jax_convert_cross,
)
from latentrag_tpu.models.encoder.convert import load_params as jax_load
from latentrag_tpu.models.encoder.convert import save_params as jax_save
from latentrag_torch.models.convert import (
    cross_encoder_state_dict_from_jax,
    minilm_state_dict_from_jax,
)
from latentrag_torch.models.encoder import (
    convert_hf_bert_to_params,
    convert_hf_cross_encoder_to_params,
    load_params,
    save_params,
)
from latentrag_torch.models.encoder.cross import CrossEncoderModel
from latentrag_torch.models.encoder.minilm import MiniLMEncoder
from latentrag_torch.pipeline import default_encoder
from latentrag_torch.utils import Config, apply_overrides

GEOM = dict(vocab_size=120, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
FORMS = ("safetensors", "bin", "bf16", "sharded", "legacy")


def _vocab(path):
    toks = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    toks += [f"w{i}" for i in range(GEOM["vocab_size"] - len(toks))]
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(toks) + "\n")


def _save(model, path, form):
    """``model`` saved to ``path`` in one of FORMS, with a vocab.txt."""
    if form == "safetensors":
        model.save_pretrained(path)
    elif form == "bin":
        model.save_pretrained(path, safe_serialization=False)
    elif form == "bf16":
        copy.deepcopy(model).to(torch.bfloat16).save_pretrained(path)
    elif form == "sharded":
        model.save_pretrained(path, max_shard_size="20KB")
        assert os.path.exists(os.path.join(path,
                                           "model.safetensors.index.json"))
    else:  # legacy: the "bert." prefix, gamma/beta, a position_ids buffer
        model.save_pretrained(path, safe_serialization=False)
        bin_path = os.path.join(path, "pytorch_model.bin")
        sd = torch.load(bin_path, weights_only=True)
        legacy = {}
        for k, v in sd.items():
            k = "bert." + k if not k.startswith(("bert.", "classifier")) \
                else k
            k = k.replace("LayerNorm.weight", "LayerNorm.gamma").replace(
                "LayerNorm.bias", "LayerNorm.beta")
            legacy[k] = v
        legacy["bert.embeddings.position_ids"] = torch.arange(
            GEOM["max_position_embeddings"])[None]
        torch.save(legacy, bin_path)
    _vocab(path)
    return path


@pytest.fixture(scope="module")
def bert_dirs(tmp_path_factory):
    torch.manual_seed(0)
    model = transformers.BertModel(transformers.BertConfig(**GEOM)).eval()
    root = tmp_path_factory.mktemp("hf_bert")
    return model, {form: _save(model, str(root / form), form)
                   for form in FORMS}


@pytest.fixture(scope="module")
def cross_dirs(tmp_path_factory):
    torch.manual_seed(1)
    model = transformers.BertForSequenceClassification(
        transformers.BertConfig(**GEOM, num_labels=1,
                                classifier_dropout=0.0)).eval()
    root = tmp_path_factory.mktemp("hf_cross")
    return model, {form: _save(model, str(root / form), form)
                   for form in FORMS}


def _assert_same_tree(got, want, where="params"):
    if isinstance(want, dict):
        assert isinstance(got, dict), where
        assert list(got) == list(want), where  # flax writes in this order
        for key in want:
            _assert_same_tree(got[key], want[key], f"{where}.{key}")
        return
    want = np.asarray(want)
    assert isinstance(got, np.ndarray), where
    assert got.dtype == want.dtype == np.float32, where
    np.testing.assert_array_equal(got, want, err_msg=where)


@pytest.mark.parametrize("form", FORMS)
def test_bert_tree_equals_jax_converter(bert_dirs, form):
    path = bert_dirs[1][form]
    got, vocab = convert_hf_bert_to_params(path)
    want, want_vocab = jax_convert_bert(path)
    _assert_same_tree(got, want)
    assert vocab == want_vocab == os.path.join(path, "vocab.txt")


@pytest.mark.parametrize("form", FORMS)
def test_cross_encoder_tree_equals_jax_converter(cross_dirs, form):
    path = cross_dirs[1][form]
    got, vocab = convert_hf_cross_encoder_to_params(path)
    want, want_vocab = jax_convert_cross(path)
    _assert_same_tree(got, want)
    assert vocab == want_vocab


def test_bf16_checkpoint_widens_as_from_pretrained(bert_dirs):
    """from_pretrained without a torch_dtype loads fp32: the bf16 file's
    values widened, which are the fp32 model's rounded to bf16."""
    model, dirs = bert_dirs
    got, _ = convert_hf_bert_to_params(dirs["bf16"])
    w = model.state_dict()["embeddings.word_embeddings.weight"]
    np.testing.assert_array_equal(
        got["word_embeddings"]["embedding"],
        w.to(torch.bfloat16).float().numpy())


def test_encoder_matches_hf_forward(bert_dirs, rng):
    model, dirs = bert_dirs
    params, _ = convert_hf_bert_to_params(dirs["safetensors"])
    enc = MiniLMEncoder(
        vocab_size=GEOM["vocab_size"], hidden_dim=GEOM["hidden_size"],
        num_layers=GEOM["num_hidden_layers"],
        num_heads=GEOM["num_attention_heads"],
        mlp_dim=GEOM["intermediate_size"],
        max_position_embeddings=GEOM["max_position_embeddings"],
        dtype=torch.float32)
    enc.load_state_dict(minilm_state_dict_from_jax(params))
    ids = torch.from_numpy(rng.integers(0, GEOM["vocab_size"], (3, 10)))
    mask = torch.ones((3, 10), dtype=torch.int64)
    mask[1, 6:] = 0
    mask[2, 4:] = 0
    with torch.no_grad():
        ours = enc.eval()(ids, mask)
        out = model(input_ids=ids, attention_mask=mask).last_hidden_state
        m = mask[..., None].float()
        pooled = torch.nn.functional.normalize((out * m).sum(1) / m.sum(1),
                                               dim=-1)
    np.testing.assert_allclose(ours.numpy(), pooled.numpy(), atol=1e-5)


def test_cross_encoder_matches_hf_logits(cross_dirs, rng):
    model, dirs = cross_dirs
    params, _ = convert_hf_cross_encoder_to_params(dirs["bin"])
    ours_mod = CrossEncoderModel(
        vocab_size=GEOM["vocab_size"], hidden_dim=GEOM["hidden_size"],
        num_layers=GEOM["num_hidden_layers"],
        num_heads=GEOM["num_attention_heads"],
        mlp_dim=GEOM["intermediate_size"],
        max_position_embeddings=GEOM["max_position_embeddings"],
        dtype=torch.float32)
    ours_mod.load_state_dict(cross_encoder_state_dict_from_jax(params))
    ids = torch.from_numpy(rng.integers(0, GEOM["vocab_size"], (3, 12)))
    mask = torch.ones((3, 12), dtype=torch.int64)
    mask[1, 8:] = 0
    tt = torch.zeros((3, 12), dtype=torch.int64)
    tt[:, 5:] = 1
    tt[1, 8:] = 0
    with torch.no_grad():
        ours = ours_mod.eval()(ids, mask, tt)
        theirs = model(input_ids=ids, attention_mask=mask,
                       token_type_ids=tt).logits[:, 0]
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), atol=1e-5)


def test_multilabel_head_raises(tmp_path):
    model = transformers.BertForSequenceClassification(
        transformers.BertConfig(**{**GEOM, "num_hidden_layers": 1},
                                num_labels=3))
    model.save_pretrained(str(tmp_path))
    for convert in (convert_hf_cross_encoder_to_params, jax_convert_cross):
        with pytest.raises(ValueError, match="1-label"):
            convert(str(tmp_path))


def test_refuses_what_is_not_a_local_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="config.json"):
        convert_hf_bert_to_params("sentence-transformers/all-MiniLM-L6-v2")
    (tmp_path / "config.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        convert_hf_bert_to_params(str(tmp_path))


def _encoder_cfg(tmp_path, name, *extra):
    return apply_overrides(Config(), [
        f"encoder.name={name}", "encoder.dtype=float32",
        f"encoder.vocab_size={GEOM['vocab_size']}",
        f"encoder.hidden_dim={GEOM['hidden_size']}",
        f"encoder.num_layers={GEOM['num_hidden_layers']}",
        f"encoder.num_heads={GEOM['num_attention_heads']}",
        f"encoder.mlp_dim={GEOM['intermediate_size']}",
        f"encoder.max_position_embeddings={GEOM['max_position_embeddings']}",
        f"paths.data_dir={tmp_path}/data",
        f"paths.checkpoints_dir={tmp_path}/ckpt", *extra])


def test_default_encoder_converts_then_loads(bert_dirs, tmp_path, caplog):
    """The first ``default_encoder`` converts ``encoder.name`` into
    ``encoder.msgpack`` (the file the JAX ``save_params`` writes, which the
    JAX ``load_params`` reads) and copies vocab.txt; the next one loads
    the msgpack and converts nothing."""
    model, dirs = bert_dirs
    path = dirs["safetensors"]
    cfg = _encoder_cfg(tmp_path, path)
    with caplog.at_level(logging.INFO, logger="latentrag_torch.main"):
        enc = default_encoder(cfg, ["w5 w6"], device="cpu")
    assert "converted HF checkpoint" in caplog.text
    out = f"{tmp_path}/ckpt/encoder.msgpack"
    want, _ = jax_convert_bert(path)
    jax_save(want, f"{tmp_path}/jax.msgpack")
    with open(out, "rb") as a, open(f"{tmp_path}/jax.msgpack", "rb") as b:
        assert a.read() == b.read()
    _assert_same_tree(load_params(out), want)
    _assert_same_tree({k: v for k, v in jax_load(out, want).items()}, want)
    with open(f"{tmp_path}/data/vocab.txt") as f, \
            open(os.path.join(path, "vocab.txt")) as g:
        assert f.read() == g.read()
    assert enc.tokenizer.vocab_size == GEOM["vocab_size"]
    sd = enc.module.state_dict()
    for key, value in minilm_state_dict_from_jax(want).items():
        assert torch.equal(sd[key], value), key
    # the texts' embeddings are HF's forward of the converted weights
    ids, mask = enc.tokenizer.encode_batch(["w5 w6 w7"], max_length=16)
    with torch.no_grad():
        h = model(input_ids=torch.from_numpy(ids).long(),
                  attention_mask=torch.from_numpy(mask).long())
        m = torch.from_numpy(mask)[..., None].float()
        pooled = torch.nn.functional.normalize(
            (h.last_hidden_state * m).sum(1) / m.sum(1), dim=-1)
    np.testing.assert_allclose(enc.encode_batch(["w5 w6 w7"]).numpy(),
                               pooled.numpy(), atol=1e-5)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="latentrag_torch.main"):
        again = default_encoder(cfg, ["w5 w6"], device="cpu")
    assert "converted" not in caplog.text
    assert "loaded encoder weights" in caplog.text
    assert all(torch.equal(a, b) for a, b in zip(
        again.module.state_dict().values(), sd.values()))


def test_default_encoder_keeps_an_existing_vocab(bert_dirs, tmp_path):
    os.makedirs(f"{tmp_path}/data")
    with open(f"{tmp_path}/data/vocab.txt", "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "w0"]) + "\n")
    default_encoder(_encoder_cfg(tmp_path, bert_dirs[1]["bin"]), ["w0"],
                    device="cpu")
    with open(f"{tmp_path}/data/vocab.txt") as f:
        assert f.read().split() == ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "w0"]
    assert os.path.exists(f"{tmp_path}/ckpt/encoder.msgpack")


def test_default_encoder_hub_forms(tmp_path, caplog):
    """A hub name converts nothing (seeded init) and, with
    ``hub_fallback=true``, raises: the port never uses the network. A
    local directory whose conversion fails logs the JAX package's warning
    and keeps the seeded init."""
    hub = "sentence-transformers/all-MiniLM-L6-v2"
    enc = default_encoder(_encoder_cfg(tmp_path, hub), ["w0 w1"],
                          device="cpu")
    assert not os.path.exists(f"{tmp_path}/ckpt/encoder.msgpack")
    assert enc.module.word_embeddings.weight.shape[1] == GEOM["hidden_size"]
    with pytest.raises(ValueError, match="never uses the network"):
        default_encoder(_encoder_cfg(tmp_path, hub,
                                     "encoder.hub_fallback=true"),
                        ["w0"], device="cpu")
    broken = tmp_path / "broken"
    broken.mkdir()
    (broken / "config.json").write_text(json.dumps({"model_type": "bert"}))
    with caplog.at_level(logging.WARNING, logger="latentrag_torch.main"):
        default_encoder(_encoder_cfg(tmp_path, str(broken)), ["w0"],
                        device="cpu")
    assert "unusable" in caplog.text and "self-init" in caplog.text
    assert not os.path.exists(f"{tmp_path}/ckpt/encoder.msgpack")


def test_save_and_load_params_round_trip(bert_dirs, tmp_path):
    params, _ = convert_hf_bert_to_params(bert_dirs[1]["safetensors"])
    save_params(params, f"{tmp_path}/p.msgpack")
    _assert_same_tree(load_params(f"{tmp_path}/p.msgpack"), params)
    _assert_same_tree(jax_load(f"{tmp_path}/p.msgpack", params), params)
