"""The port's second stage (``latentrag_torch/retrieval/reranker.py``)
against the JAX package's on the CPU: candidate rescoring with empty
slots, every branch of ``build_reranker``, the vocabulary digest, and
checkpoints with their sidecars crossing between the packages."""

import logging
import os

import jax
import numpy as np
import pytest
import torch

from latentrag_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from latentrag_tpu.data.tokenizer import tokenizer_digest as jax_digest
from latentrag_tpu.models.encoder.convert import save_params
from latentrag_tpu.models.encoder.cross import (
    CrossEncoderScorer as JaxScorer,
)
from latentrag_tpu.retrieval import reranker as jr
from latentrag_tpu.utils import Config as JaxConfig
from latentrag_tpu.utils import apply_overrides as jax_overrides
from latentrag_torch.data.tokenizer import WordPieceTokenizer
from latentrag_torch.data.tokenizer import tokenizer_digest
from latentrag_torch.models.convert import cross_encoder_state_dict_from_jax
from latentrag_torch.models.encoder.cross import CrossEncoderScorer
from latentrag_torch.retrieval import reranker as tr
from latentrag_torch.utils import Config, apply_overrides

CORPUS = [
    "the telescope observes distant galaxies and stars",
    "mitochondria produce energy inside living cells",
    "markets react to interest rate announcements",
    "the orchestra rehearsed the symphony for weeks",
    "volcanic eruptions reshape the island coastline",
    "quantum processors need error correction to scale",
    "ancient rome built aqueducts across the empire",
    "deep ocean trenches host unique ecosystems",
]
QUERIES = ["what do telescopes observe", "how do cells make energy",
           "rome aqueducts", "ocean trench life"]


def _overrides(base, max_length=256):
    return [f"paths.checkpoints_dir={base}/ckpt", f"paths.data_dir={base}/data",
            "encoder.vocab_size=400", "encoder.dtype=float32",
            "encoder.hidden_dim=64", "encoder.num_layers=2",
            "encoder.num_heads=4", "encoder.mlp_dim=128",
            f"encoder.max_length={max_length}", "encoder.batch_size=8"]


@pytest.fixture(scope="module")
def toks():
    jax_tok = JaxTokenizer.train_from_corpus(CORPUS + QUERIES, vocab_size=400)
    return jax_tok, WordPieceTokenizer(dict(jax_tok.vocab))


def _candidates():
    rng = np.random.default_rng(2)
    idx = rng.integers(0, len(CORPUS), size=(len(QUERIES), 6))
    idx[0, 4:] = -1
    idx[2, 1] = -1
    idx[3, :] = -1  # a query without a candidate
    return idx


def test_tokenizer_digest_matches_jax(toks):
    jax_tok, tok = toks
    assert tokenizer_digest(tok) == jax_digest(jax_tok)
    other = WordPieceTokenizer.train_from_corpus(["other words"],
                                                 vocab_size=400)
    assert tokenizer_digest(other) != tokenizer_digest(tok)


def test_rescore_candidates_matches_jax(toks):
    """The same fp32 cross-encoder on both sides, the same candidates with
    empty slots: the same [Q, C] matrix, NEG_INF where a slot is empty."""
    jax_tok, tok = toks
    cfg_j = jax_overrides(JaxConfig(), _overrides("/unused"))
    jax_scorer = JaxScorer(jax_tok, cfg_j.encoder, seed=4)
    params = jax.tree_util.tree_map(np.asarray, jax_scorer.params)
    port = tr.CrossEncoderReranker(CrossEncoderScorer(
        tok, apply_overrides(Config(), _overrides("/unused")).encoder,
        state_dict=cross_encoder_state_dict_from_jax(params), device="cpu"))
    idx = _candidates()
    want = jr.CrossEncoderReranker(jax_scorer).rescore_candidates(
        QUERIES, idx, CORPUS)
    got = port.rescore_candidates(QUERIES, idx, CORPUS)
    assert got.dtype == np.float32 and got.shape == idx.shape
    assert (got[idx < 0] == tr.NEG_INF).all() and tr.NEG_INF == jr.NEG_INF
    live = idx >= 0
    assert np.all(np.abs(got[live] - want[live])
                  <= 1e-5 + 1e-5 * np.abs(want[live]))
    # no live slot at all: no scorer call
    empty = port.rescore_candidates(QUERIES, np.full((4, 3), -1), CORPUS)
    assert (empty == tr.NEG_INF).all()


def _write_port(base, tok, max_length, query_max, seed=6):
    cfg = apply_overrides(Config(), _overrides(base))
    scorer = CrossEncoderScorer(tok, cfg.encoder, seed=seed, device="cpu")
    os.makedirs(f"{base}/ckpt", exist_ok=True)
    return tr.save_reranker(cfg, scorer, max_length=max_length,
                            query_max=query_max), scorer


def test_missing_checkpoint_raises(toks, tmp_path):
    cfg = apply_overrides(Config(), _overrides(tmp_path))
    with pytest.raises(FileNotFoundError,
                       match=r"python -m latentrag_torch\.training\."
                             r"train_reranker"):
        tr.build_reranker(cfg, toks[1], device="cpu")


@pytest.mark.parametrize("trained", [48, 512])
def test_sidecar_pins_length_and_query_max(toks, tmp_path, trained):
    """The trained pair length replaces encoder.max_length whether it is
    shorter or longer, and query_max comes from the sidecar."""
    _, tok = toks
    _write_port(tmp_path, tok, max_length=trained, query_max=24)
    for served in (64, 256):
        cfg = apply_overrides(Config(), _overrides(tmp_path, served))
        rr = tr.build_reranker(cfg, tok, device="cpu")
        assert rr.scorer.cfg.max_length == trained
        assert rr.scorer.query_max == 24
        assert cfg.encoder.max_length == served  # the config is untouched


def test_sidecar_refuses_another_vocabulary(toks, tmp_path):
    _, tok = toks
    _write_port(tmp_path, tok, max_length=48, query_max=24)
    cfg = apply_overrides(Config(), _overrides(tmp_path))
    other = WordPieceTokenizer.train_from_corpus(
        ["completely different corpus tokens here"], vocab_size=400)
    with pytest.raises(ValueError, match="different.*vocabulary"):
        tr.build_reranker(cfg, other, device="cpu")


def test_no_sidecar_warns_and_serves_at_encoder_length(toks, tmp_path,
                                                        caplog):
    _, tok = toks
    path, _ = _write_port(tmp_path, tok, max_length=48, query_max=24)
    os.remove(path + ".meta.json")
    cfg = apply_overrides(Config(), _overrides(tmp_path, 96))
    with caplog.at_level(logging.WARNING, "latentrag_torch.retrieval"):
        rr = tr.build_reranker(cfg, tok, device="cpu")
    assert "no meta sidecar" in caplog.text
    assert rr.scorer.cfg.max_length == 96
    assert rr.scorer.query_max == tr.DEFAULT_QUERY_MAX == 64


def test_port_checkpoint_loads_in_jax(toks, tmp_path):
    """A reranker the port wrote, with its sidecar: the JAX package's
    ``build_reranker`` loads it and scores the candidates as the port
    does, in fp32."""
    jax_tok, tok = toks
    _, scorer = _write_port(tmp_path, tok, max_length=48, query_max=16)
    ov = _overrides(tmp_path)
    want = jr.build_reranker(jax_overrides(JaxConfig(), ov), jax_tok)
    got = tr.build_reranker(apply_overrides(Config(), ov), tok, device="cpu")
    assert want.scorer.cfg.max_length == got.scorer.cfg.max_length == 48
    assert want.scorer.query_max == got.scorer.query_max == 16
    idx = _candidates()
    w = want.rescore_candidates(QUERIES, idx, CORPUS)
    g = got.rescore_candidates(QUERIES, idx, CORPUS)
    saved = scorer.module.state_dict()
    for key, value in got.scorer.module.state_dict().items():
        assert torch.equal(value, saved[key]), key
    assert np.all(np.abs(g - w) <= 1e-5 + 1e-5 * np.abs(w))


def test_jax_checkpoint_loads_in_port(toks, tmp_path):
    """A reranker the JAX package saved (``save_params`` and its
    ``save_reranker_meta``): the port's ``build_reranker`` loads it, with
    the sidecar's lengths, and scores as the JAX reranker does."""
    jax_tok, tok = toks
    ov = _overrides(tmp_path)
    cfg_j = jax_overrides(JaxConfig(), ov)
    os.makedirs(f"{tmp_path}/ckpt")
    save_params(JaxScorer(jax_tok, cfg_j.encoder, seed=8).params,
                jr.reranker_checkpoint_path(cfg_j))
    jr.save_reranker_meta(cfg_j, jax_tok, max_length=40, query_max=12)
    want = jr.build_reranker(cfg_j, jax_tok)
    got = tr.build_reranker(apply_overrides(Config(), ov), tok, device="cpu")
    assert got.scorer.cfg.max_length == 40 and got.scorer.query_max == 12
    idx = _candidates()
    w = want.rescore_candidates(QUERIES, idx, CORPUS)
    g = got.rescore_candidates(QUERIES, idx, CORPUS)
    assert np.all(np.abs(g - w) <= 1e-5 + 1e-5 * np.abs(w))
