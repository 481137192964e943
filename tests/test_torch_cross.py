"""The port's cross-encoder (``latentrag_torch/models/encoder/cross.py``)
against the JAX package's ``CrossEncoderModel`` on the CPU, at 2 layers,
hidden 64, 4 heads, MLP 128 and a corpus-trained vocabulary: pair inputs,
logits on carried-across params in fp32 and bf16, batching, and the
``reranker.msgpack`` files each package writes, read by the other."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from latentrag_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from latentrag_tpu.models.encoder.convert import load_params, save_params
from latentrag_tpu.models.encoder.cross import (
    CrossEncoderScorer as JaxScorer,
)
from latentrag_tpu.models.encoder.cross import encode_pairs as jax_pairs
from latentrag_tpu.utils.config import EncoderConfig as JaxEncoderConfig
from latentrag_torch.data.tokenizer import WordPieceTokenizer
from latentrag_torch.models.convert import (
    cross_encoder_params_from_state_dict,
    cross_encoder_state_dict_from_jax,
)
from latentrag_torch.models.encoder.cross import (
    CrossEncoderScorer,
    encode_pairs,
)
from latentrag_torch.models.encoder.msgpack_io import load_msgpack, save_msgpack
from latentrag_torch.utils.config import EncoderConfig

WORDS = ("the telescope observes distant galaxies and stars mitochondria "
         "produce energy inside living cells markets react to interest rate "
         "announcements volcanic eruptions reshape the island coastline "
         "quantum processors need error correction").split()
GEOMETRY = dict(vocab_size=400, hidden_dim=64, num_layers=2, num_heads=4,
                mlp_dim=128, max_length=64, batch_size=16)
# bf16: the two packages round their bf16 products and sums in other
# orders; on these pairs the largest |port - JAX| measured is 0.0146 at
# seed 0 (logits spread over 0.57) and 0.0117 at seed 3 (over 3.1)
BF16_ATOL = 0.03


def _texts(rng, n, lo, hi):
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(lo, hi))))
            for _ in range(n)]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    queries = _texts(rng, 40, 1, 12)
    docs = _texts(rng, 40, 0, 80)
    jax_tok = JaxTokenizer.train_from_corpus(queries + docs, vocab_size=400)
    return queries, docs, jax_tok, WordPieceTokenizer(dict(jax_tok.vocab))


def _pair(data, dtype="float32", seed=3, **over):
    """A JAX scorer at a seeded init and the port's on its params."""
    _, _, jax_tok, tok = data
    geo = {**GEOMETRY, "dtype": dtype, **over}
    want = JaxScorer(jax_tok, JaxEncoderConfig(**geo), seed=seed)
    params = jax.tree_util.tree_map(np.asarray, want.params)
    got = CrossEncoderScorer(
        tok, EncoderConfig(**geo),
        state_dict=cross_encoder_state_dict_from_jax(params), device="cpu")
    return want, got, params


@pytest.mark.parametrize("max_length,query_max", [
    (64, 16),  # documents cut to their budget
    (128, 64),  # most pairs fit
    (16, 16),  # long queries take the whole pair: no document tokens
    (24, 8),  # queries overflow query_max
    (8, 4),
])
def test_encode_pairs_match_jax(data, max_length, query_max):
    queries, docs, jax_tok, tok = data
    want = jax_pairs(jax_tok, queries, docs, max_length=max_length,
                     query_max=query_max)
    got = encode_pairs(tok, queries, docs, max_length=max_length,
                       query_max=query_max)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="1:1"):
        encode_pairs(tok, queries[:2], docs[:1])


@pytest.mark.parametrize("seed", [0, 3])
def test_fp32_logits_match_jax(data, seed):
    queries, docs, _, _ = data
    want, got, _ = _pair(data, seed=seed)
    w = want.score_pairs(queries, docs)
    g = got.score_pairs(queries, docs)
    assert g.dtype == np.float32 and g.shape == (len(queries),)
    assert np.all(np.abs(g - w) <= 1e-5 + 1e-5 * np.abs(w)), \
        np.abs(g - w).max()


@pytest.mark.parametrize("seed", [0, 3])
def test_bf16_logits_match_jax(data, seed):
    queries, docs, _, _ = data
    want, got, _ = _pair(data, "bfloat16", seed=seed)
    w = want.score_pairs(queries, docs)
    g = got.score_pairs(queries, docs)
    assert np.abs(g - w).max() <= BF16_ATOL
    assert np.ptp(w) > 10 * BF16_ATOL  # the band is not the logits' spread


@pytest.mark.parametrize("batch_size", [1, 6, 64])
def test_scores_equal_across_batch_sizes(data, batch_size):
    """fp32: a pair's logit does not depend on the chunk, the length
    bucket or the batch bucket it is scored in."""
    queries, docs, _, tok = data
    _, full, _ = _pair(data)
    other = CrossEncoderScorer(
        tok, dataclasses.replace(full.cfg, batch_size=batch_size),
        state_dict=full.module.state_dict(), device="cpu")
    np.testing.assert_allclose(other.score_pairs(queries, docs),
                               full.score_pairs(queries, docs),
                               rtol=1e-5, atol=1e-5)
    assert full.score_pairs([], []).shape == (0,)


def test_port_file_loads_in_jax(data, tmp_path):
    """The port's seeded scorer written with ``save_msgpack``: the JAX
    package's ``load_params`` restores its params bit for bit, the file is
    the bytes ``flax.serialization.to_bytes`` writes, and the JAX model
    on those params gives the port's fp32 logits."""
    from flax import serialization

    queries, docs, jax_tok, tok = data
    port = CrossEncoderScorer(tok, EncoderConfig(**GEOMETRY, dtype="float32"),
                              seed=7, device="cpu")
    path = str(tmp_path / "reranker.msgpack")
    tree = cross_encoder_params_from_state_dict(port.module.state_dict())
    save_msgpack(tree, path)
    template = JaxScorer(jax_tok, JaxEncoderConfig(**GEOMETRY,
                                                   dtype="float32"), seed=0)
    restored = load_params(path, template.params)
    flat_r = jax.tree_util.tree_leaves_with_path(restored)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(flat_r) == len(flat_t)
    for key, leaf in flat_r:
        assert leaf.dtype == np.float32
        np.testing.assert_array_equal(np.asarray(leaf), flat_t[key])
    with open(path, "rb") as f:
        assert f.read() == serialization.to_bytes(tree)
    template.params = restored
    w = template.score_pairs(queries, docs)
    g = port.score_pairs(queries, docs)
    assert np.all(np.abs(g - w) <= 1e-5 + 1e-5 * np.abs(w))


def test_jax_file_loads_in_port(data, tmp_path):
    """A JAX-saved reranker: the port reads it into a state dict equal to
    the JAX params bit for bit, and writes the same tree back."""
    _, _, params = _pair(data, seed=9)
    path = str(tmp_path / "reranker.msgpack")
    save_params(params, path)
    sd = cross_encoder_state_dict_from_jax(load_msgpack(path))
    want = cross_encoder_state_dict_from_jax(params)
    assert sd.keys() == want.keys()
    for key in sd:
        assert torch.equal(sd[key], want[key]), key
    back = cross_encoder_params_from_state_dict(sd)
    for (kb, b), (kp, p) in zip(jax.tree_util.tree_leaves_with_path(back),
                                jax.tree_util.tree_leaves_with_path(params)):
        assert kb == kp
        np.testing.assert_array_equal(b, p)


def test_seeded_init_and_device(data, monkeypatch):
    """The seed decides the weights; the default device is the card,
    which raises without CUDA."""
    _, _, _, tok = data
    cfg = EncoderConfig(**GEOMETRY, dtype="float32")
    a = CrossEncoderScorer(tok, cfg, seed=1, device="cpu").module
    b = CrossEncoderScorer(tok, cfg, seed=1, device="cpu").module
    c = CrossEncoderScorer(tok, cfg, seed=2, device="cpu").module
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb)
        if not name.endswith("bias") and "_ln" not in name:
            assert not torch.equal(pa, pc)
            std = pa.std().item() * pa.shape[1] ** 0.5
            assert 0.8 < std < 1.2, name
    assert a.word_embeddings.weight.shape[0] == max(400, tok.vocab_size)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CrossEncoderScorer(tok, cfg)
