"""The port's encoder trainers (``latentrag_torch/training/
train_encoder.py``, ``train_dpr.py``) against the JAX package's on the CPU:
``info_nce_loss`` value and gradient; ``EncoderTrainer.fit`` and
``DualEncoderTrainer.fit`` at 2 layers and width 32 in fp32 mode from the
JAX params carried across, every epoch's losses within 1e-4 relative and
the params after the fit held in two parts (Adam's first steps turn any
gradient into +-lr): >= 99.9 % of elements within 1e-5, every element
within 2 * lr * steps; the bf16 mode's loss within the encoder's bf16
band; and the CLIs' msgpacks, which the JAX package's ``load_params`` and
the port's loaders read, encoding the same texts within 1e-6.

The 99.9 % share leaves out the attention key biases (``layers.*.k.bias``):
a bias added to every key shifts a query's logits by one constant, which
the softmax removes, so their true gradient is 0 and each package's is
rounding noise (~1e-10), which Adam's first step turns into +-lr of
either sign. Measured: from step 1, 64 of the 43,168 elements (0.148 %),
all of them key biases, differ by up to 0.0030 after 12 steps (lr 1e-3);
with them the share is 0.9985. They stay under the every-element bound.
``info_nce_loss``'s gradient is held within 1e-5 relative + 1e-5 x its
largest entry: the 1 / temperature = 20 scale carries the fp32 products'
sum-order rounding into it (measured 4.0e-6 on entries up to 6.1, 3 of
192 elements past 1e-5 relative)."""

import dataclasses
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentrag_tpu.data import synthetic_examples
from latentrag_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from latentrag_tpu.models.encoder import SentenceEncoder as JaxEncoder
from latentrag_tpu.models.encoder.convert import load_params
from latentrag_tpu.training import train_dpr as jdpr
from latentrag_tpu.training import train_encoder as jenc
from latentrag_tpu.utils import Config as JaxConfig
from latentrag_tpu.utils import apply_overrides as jax_overrides
from latentrag_torch.data.tokenizer import WordPieceTokenizer
from latentrag_torch.models.convert import (
    minilm_params_from_state_dict,
    minilm_state_dict_from_jax,
)
from latentrag_torch.models.encoder import SentenceEncoder
from latentrag_torch.pipeline import default_encoder
from latentrag_torch.training import train_dpr as tdpr
from latentrag_torch.training import train_encoder as tenc
from latentrag_torch.utils import Config, apply_overrides
from latentrag_torch.utils.config import TrainingConfig

LOSS_RTOL = 1e-4
PARAM_CLOSE, PARAM_SHARE = 1e-5, 0.999
ENCODE_TOL = 1e-6
BF16_BAND = 5e-3  # the encoder's bf16 band (tests/test_torch_models.py)
MAX_LENGTH = 24

EXAMPLES = synthetic_examples(40)
QUERIES = [e["question"] for e in EXAMPLES]
POSITIVES = [e["context"] for e in EXAMPLES]
# a duplicated context: the dup mask must take it out of the negatives
POSITIVES[5] = POSITIVES[4]


def _overrides(base, dtype="float32"):
    hidden, heads, mlp = (32, 4, 64) if dtype == "float32" else (96, 4, 192)
    return [f"paths.data_dir={base}/data",
            f"paths.checkpoints_dir={base}/ckpt",
            "encoder.vocab_size=300", f"encoder.dtype={dtype}",
            f"encoder.hidden_dim={hidden}", "encoder.num_layers=2",
            f"encoder.num_heads={heads}", f"encoder.mlp_dim={mlp}"]


_JTOK = JaxTokenizer.train_from_corpus(POSITIVES + QUERIES, vocab_size=300)
_TOK = WordPieceTokenizer(dict(_JTOK.vocab))


def _pair(dtype="float32", seed=0, **ecfg):
    """A JAX encoder and the port's with its params carried across."""
    jcfg = jax_overrides(JaxConfig(), _overrides("/unused", dtype)).encoder
    tcfg = apply_overrides(Config(), _overrides("/unused", dtype)).encoder
    jcfg, tcfg = (dataclasses.replace(c, **ecfg) for c in (jcfg, tcfg))
    j = JaxEncoder(_JTOK, jcfg, seed=seed)
    t = SentenceEncoder(_TOK, tcfg, device="cpu", state_dict=(
        minilm_state_dict_from_jax(jax.tree.map(np.asarray, j.params))))
    return j, t


def _assert_params(module, jax_params, lr, steps):
    want = minilm_state_dict_from_jax(jax.tree.map(np.asarray, jax_params))
    got = module.state_dict()
    diffs = {k: (got[k] - want[k]).abs().flatten().numpy() for k in want}
    held = np.concatenate([d for k, d in diffs.items()
                           if not k.endswith(".k.bias")])
    assert (held <= PARAM_CLOSE).mean() >= PARAM_SHARE, held.max()
    assert max(d.max() for d in diffs.values()) <= 2 * lr * steps


def test_info_nce_loss_matches_jax():
    rng = np.random.default_rng(0)
    zq, zp = (rng.standard_normal((12, 16)).astype(np.float32)
              for _ in range(2))
    dup = np.zeros((12, 12), bool)
    dup[2, 3] = dup[3, 2] = dup[5, 5] = True
    for mask in (None, dup):
        def jf(a, b, mask=mask):
            return jenc.info_nce_loss(a, b, 0.05, None if mask is None
                                      else jnp.asarray(mask))
        want, (ga, gb) = jax.value_and_grad(jf, argnums=(0, 1))(
            jnp.asarray(zq), jnp.asarray(zp))
        a, b = (torch.tensor(v, requires_grad=True) for v in (zq, zp))
        got = tenc.info_nce_loss(a, b, 0.05, None if mask is None
                                 else torch.from_numpy(mask))
        got.backward()
        assert got.item() == pytest.approx(float(want), rel=1e-6)
        for t, g in ((a, ga), (b, gb)):
            g = np.asarray(g)
            np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-5,
                                       atol=1e-5 * np.abs(g).max())


def _cfg(**kw):
    return TrainingConfig(**{"batch_size": 8, "epochs": 3,
                             "learning_rate": 1e-3, "seed": 5, **kw})


def test_encoder_fit_matches_jax(tmp_path):
    cfg = _cfg()
    j, t = _pair()
    want = jenc.EncoderTrainer(j, cfg, max_length=MAX_LENGTH).fit(
        QUERIES, POSITIVES)
    trainer = tenc.EncoderTrainer(t, cfg, max_length=MAX_LENGTH)
    path = str(tmp_path / "encoder_train.pt")
    got = trainer.fit(QUERIES, POSITIVES, checkpoint_path=path)
    np.testing.assert_allclose(np.array(got.history),
                               np.array(want.history), rtol=LOSS_RTOL)
    steps = 3 * ((40 - 4) // 8)
    _assert_params(t.module, want.params, cfg.learning_rate, steps)
    # the best state went back into the tower, which encodes as the JAX
    # encoder over the trained params
    out = str(tmp_path / "encoder.msgpack")
    tenc.save_encoder_msgpack(t.module, out)
    j.params = load_params(out, j.params)
    np.testing.assert_allclose(t.encode_batch(QUERIES).numpy(),
                               np.asarray(j.encode_batch(QUERIES)),
                               atol=ENCODE_TOL, rtol=ENCODE_TOL)
    # resume past the last epoch: nothing trains, the tower is the saved
    # state's
    state = torch.load(path, weights_only=True)
    again = tenc.EncoderTrainer(t, cfg, max_length=MAX_LENGTH).fit(
        QUERIES, POSITIVES, checkpoint_path=path, resume=True)
    assert again.history == [] and again.best_val_loss == state["best_val"]


def test_encoder_bf16_loss_within_the_band():
    """bf16 mode: the loss of each batch of an epoch from the same params,
    and the first step's, within the band; later steps diverge as the
    bf16 roundings of each package's sums do."""
    j, t = _pair("bfloat16")
    cfg = _cfg(epochs=1)
    jtr = jenc.EncoderTrainer(j, cfg, max_length=MAX_LENGTH)
    ttr = tenc.EncoderTrainer(t, cfg, max_length=MAX_LENGTH)
    data = jtr._tokenize_pairs(QUERIES, POSITIVES)
    for s in range(0, 40, 8):
        batch = {k: v[s:s + 8] for k, v in data.items()}
        want = float(jtr._eval_step(j.params, batch))
        got = ttr.loss(ttr.to_device(batch)).item()
        assert got == pytest.approx(want, rel=BF16_BAND)
    _, _, first = jtr._train_step(j.params, jtr.tx.init(j.params), batch)
    assert ttr.train_step(ttr.to_device(batch)).item() == pytest.approx(
        float(first), rel=BF16_BAND)


def _towers(dtype="float32"):
    out = []
    for seed in (1, 2):
        out.append(_pair(dtype, seed=seed, pooling="cls", normalize=False))
    return out


def test_dual_encoder_fit_matches_jax():
    cfg = _cfg()
    (jq, tq), (jc, tc) = _towers()
    want = jdpr.DualEncoderTrainer(jq, jc, cfg, max_length=MAX_LENGTH).fit(
        QUERIES, POSITIVES)
    got = tdpr.DualEncoderTrainer(tq, tc, cfg, max_length=MAX_LENGTH).fit(
        QUERIES, POSITIVES)
    np.testing.assert_allclose(np.array(got.history),
                               np.array(want.history), rtol=LOSS_RTOL)
    steps = 3 * ((40 - 4) // 8)
    _assert_params(tq.module, want.q_params, cfg.learning_rate, steps)
    _assert_params(tc.module, want.c_params, cfg.learning_rate, steps)
    assert sorted(got.q_params) == sorted(tq.module.state_dict())
    assert all(torch.equal(v, tc.module.state_dict()[k])
               for k, v in got.c_params.items())


def test_minilm_params_round_trip():
    j, t = _pair()
    tree = minilm_params_from_state_dict(t.module.state_dict())
    assert list(tree) == list(j.params)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    want = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, j.params))[0])
    assert len(flat) == len(want)
    for path, leaf in flat:
        assert np.array_equal(leaf, want[path])


class _Lines(logging.Handler):
    """The messages of one logger (the CLIs reset the root's handlers)."""

    def __init__(self, name):
        super().__init__(logging.INFO)
        self.lines = []
        self.logger = logging.getLogger(name)

    def emit(self, rec):
        self.lines.append(rec.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        self.level, self.logger.level = self.logger.level, logging.INFO
        return self.lines

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.level = self.level


def _cli_overrides(base):
    return ["data.dataset=synthetic", "data.max_samples=40",
            "logging.log_to_file=false", "training.seed=3",
            *_overrides(base)]


def test_train_encoder_cli_writes_what_both_packages_load(tmp_path):
    ov = _cli_overrides(tmp_path)
    assert tenc.main(["--epochs", "1", "--batch_size", "8", "--max_length",
                      "24", "--device", "cpu", "--set", *ov]) == 0
    path = f"{tmp_path}/ckpt/encoder.msgpack"
    assert os.path.exists(path)
    assert os.path.exists(f"{tmp_path}/ckpt/encoder_train.pt")
    cfg = apply_overrides(Config(), ov)
    with _Lines("latentrag_torch.main") as lines:
        enc = default_encoder(cfg, POSITIVES, device="cpu")
    assert f"loaded encoder weights: {path}" in lines
    jcfg = jax_overrides(JaxConfig(), ov)
    tok = JaxTokenizer.load(f"{tmp_path}/data/tokenizer.json")
    j = JaxEncoder(tok, jcfg.encoder)
    j.params = load_params(path, j.params)
    np.testing.assert_allclose(enc.encode_batch(QUERIES).numpy(),
                               np.asarray(j.encode_batch(QUERIES)),
                               atol=ENCODE_TOL, rtol=ENCODE_TOL)


def test_train_dpr_cli_writes_what_both_packages_load(tmp_path):
    ov = _cli_overrides(tmp_path)
    assert tdpr.main(["--epochs", "1", "--batch_size", "8", "--max_length",
                      "24", "--device", "cpu", "--set", *ov]) == 0
    for name in ("dpr_question", "dpr_context"):
        assert os.path.exists(f"{tmp_path}/ckpt/{name}.msgpack")
    with _Lines("latentrag_torch.train") as lines:
        tq, tc = tdpr.build_dpr_encoders(apply_overrides(Config(), ov),
                                         device="cpu")
    assert sum(m.startswith("loaded dpr_") for m in lines) == 2
    jq, jc = jdpr.build_dpr_encoders(jax_overrides(JaxConfig(), ov))
    for t, j in ((tq, jq), (tc, jc)):
        np.testing.assert_allclose(t.encode_batch(QUERIES).numpy(),
                                   np.asarray(j.encode_batch(QUERIES)),
                                   atol=ENCODE_TOL, rtol=ENCODE_TOL)


def test_encoder_trainer_needs_eight_pairs():
    _, t = _pair()
    with pytest.raises(ValueError, match="at least 8"):
        tenc.EncoderTrainer(t).fit(QUERIES[:7], POSITIVES[:7])
    with pytest.raises(ValueError, match="at least 8"):
        tdpr.DualEncoderTrainer(t, t).fit(QUERIES[:7], POSITIVES[:7])
