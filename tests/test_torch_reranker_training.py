"""The port's reranker trainer (``latentrag_torch/training/
train_reranker.py``) against the JAX package's on the CPU: ``listwise_loss``
value and gradient; ``fit`` in the in-batch and the mined-negatives modes
at 2 layers and width 32 in fp32 mode from the JAX params carried across,
every epoch's losses within 1e-4 relative; the logged cut of unequal
negatives lists (which the JAX package makes silently, with the same
losses); and the CLI's checkpoint and sidecar, which the port's
``build_reranker`` accepts and the JAX package's loads."""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentrag_tpu.data import synthetic_examples
from latentrag_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from latentrag_tpu.models.encoder.cross import CrossEncoderScorer as JaxScorer
from latentrag_tpu.retrieval import reranker as jr
from latentrag_tpu.training import train_reranker as jrt
from latentrag_tpu.utils import Config as JaxConfig
from latentrag_tpu.utils import apply_overrides as jax_overrides
from latentrag_torch.data.tokenizer import WordPieceTokenizer
from latentrag_torch.models.convert import cross_encoder_state_dict_from_jax
from latentrag_torch.models.encoder.cross import CrossEncoderScorer
from latentrag_torch.retrieval import reranker as tr
from latentrag_torch.training import train_reranker as trt
from latentrag_torch.utils import Config, apply_overrides
from latentrag_torch.utils.config import TrainingConfig

LOSS_RTOL = 1e-4
MAX_LENGTH = 32

EXAMPLES = synthetic_examples(24)
QUERIES = [e["question"] for e in EXAMPLES]
POSITIVES = [e["context"] for e in EXAMPLES]
POSITIVES[3] = POSITIVES[2]  # a duplicate positive for the mask


def _overrides(base):
    return [f"paths.data_dir={base}/data", f"paths.checkpoints_dir={base}/ckpt",
            "encoder.vocab_size=300", "encoder.dtype=float32",
            "encoder.hidden_dim=32", "encoder.num_layers=2",
            "encoder.num_heads=4", "encoder.mlp_dim=64"]


_JTOK = JaxTokenizer.train_from_corpus(POSITIVES + QUERIES, vocab_size=300)
_TOK = WordPieceTokenizer(dict(_JTOK.vocab))


def _scorers(seed=3):
    j = JaxScorer(_JTOK, jax_overrides(JaxConfig(), _overrides("/u")).encoder,
                  seed=seed)
    t = CrossEncoderScorer(
        _TOK, apply_overrides(Config(), _overrides("/u")).encoder,
        state_dict=cross_encoder_state_dict_from_jax(
            jax.tree.map(np.asarray, j.params)), device="cpu")
    return j, t


def _negatives(lengths):
    """Mined-negative lists: other examples' positives, some lists holding
    the example's own positive text (a duplicate of the positive)."""
    n = len(QUERIES)
    return [[POSITIVES[(i + d) % n] for d in range(1, lengths[i % len(
        lengths)] + 1)] for i in range(n)]


def test_listwise_loss_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((6, 6)).astype(np.float32) * 3
    dup = np.zeros((6, 6), bool)
    dup[1, 4] = dup[2, 2] = True
    for mask in (None, dup):
        want, g = jax.value_and_grad(lambda x: jrt.listwise_loss(
            x, None if mask is None else jnp.asarray(mask)))(
            jnp.asarray(logits))
        x = torch.tensor(logits, requires_grad=True)
        got = trt.listwise_loss(x, None if mask is None
                                else torch.from_numpy(mask))
        got.backward()
        assert got.item() == pytest.approx(float(want), rel=1e-6)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-7)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, rec):
        self.lines.append((rec.levelname, rec.getMessage()))


@pytest.mark.parametrize("mode", ["in_batch", "mined"])
def test_fit_matches_jax(mode):
    cfg = TrainingConfig(batch_size=8, epochs=2, learning_rate=1e-3, seed=4)
    # unequal lists in the mined mode: every list is cut to 2
    negs = _negatives([2, 3, 4]) if mode == "mined" else None
    j, t = _scorers()
    want = jrt.RerankerTrainer(j, cfg, max_length=MAX_LENGTH).fit(
        QUERIES, POSITIVES, negatives=negs)
    lines = _Lines()
    lg = logging.getLogger("latentrag_torch.train")
    lg.addHandler(lines)
    level, lg.level = lg.level, logging.INFO
    try:
        got = trt.RerankerTrainer(t, cfg, max_length=MAX_LENGTH).fit(
            QUERIES, POSITIVES, negatives=negs)
    finally:
        lg.removeHandler(lines)
        lg.level = level
    np.testing.assert_allclose(np.array(got.history),
                               np.array(want.history), rtol=LOSS_RTOL)
    assert len(got.history) == 2
    msgs = [m for _, m in lines.lines]
    if mode == "mined":
        # 24 lists of 2, 3, 4 negatives cut to 2: 8 + 16 = 24 dropped
        cut = [(lvl, m) for lvl, m in lines.lines if "cut to" in m]
        assert cut == [("WARNING", "[reranker] mined negatives cut to the "
                        "shortest list's 2: 24 of 72 negatives dropped (16 "
                        "of 24 examples had more)")]
    else:
        assert any("listwise batch capped at 6 queries" in m for m in msgs)
        assert not any("cut to" in m for m in msgs)


def test_equal_negatives_are_not_logged_and_empty_lists_raise():
    _, t = _scorers()
    lines = _Lines()
    lg = logging.getLogger("latentrag_torch.train")
    lg.addHandler(lines)
    try:
        trt.RerankerTrainer(t, TrainingConfig(batch_size=8, epochs=0)).fit(
            QUERIES, POSITIVES, negatives=_negatives([2]))
    finally:
        lg.removeHandler(lines)
    assert not any("cut to" in m for _, m in lines.lines)
    with pytest.raises(ValueError, match=">=1 mined negative"):
        trt.RerankerTrainer(t).fit(QUERIES, POSITIVES,
                                   negatives=_negatives([0]))
    with pytest.raises(ValueError, match="at least 8"):
        trt.RerankerTrainer(t).fit(QUERIES[:7], POSITIVES[:7])


def test_cli_checkpoint_and_sidecar_serve_in_both_packages(tmp_path):
    ov = ["data.dataset=synthetic", "data.max_samples=24",
          "logging.log_to_file=false", *_overrides(tmp_path)]
    assert trt.main(["--epochs", "1", "--batch_size", "4", "--max_length",
                     str(MAX_LENGTH), "--device", "cpu", "--set", *ov]) == 0
    cfg = apply_overrides(Config(), ov)
    path = tr.reranker_checkpoint_path(cfg)
    assert os.path.exists(path) and os.path.exists(path + ".meta.json")
    assert os.path.exists(f"{tmp_path}/ckpt/reranker_train.pt")
    tok = WordPieceTokenizer.load(f"{tmp_path}/data/tokenizer.json")
    got = tr.build_reranker(cfg, tok, device="cpu")
    assert got.scorer.cfg.max_length == MAX_LENGTH
    jtok = JaxTokenizer.load(f"{tmp_path}/data/tokenizer.json")
    want = jr.build_reranker(jax_overrides(JaxConfig(), ov), jtok)
    idx = np.arange(12).reshape(4, 3)
    idx[1, 2] = -1
    g = got.rescore_candidates(QUERIES[:4], idx, POSITIVES)
    w = want.rescore_candidates(QUERIES[:4], idx, POSITIVES)
    assert np.all(np.abs(g - w) <= 1e-5 + 1e-5 * np.abs(w))
