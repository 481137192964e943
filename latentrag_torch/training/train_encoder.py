"""Contrastive sentence-encoder training (in-batch InfoNCE).

The port of the JAX package's ``training/train_encoder.py``: the MiniLM
tower trains from its seeded init (or from loaded weights) on (query,
positive passage) pairs with symmetric in-batch-negative InfoNCE. One
shared tower encodes queries and passages as one batch of 2B rows; the
similarity matrix is [B, B] fp32; sequences pad to ``max_length``.

The trainer calls ``SentenceEncoder.module`` itself, with autograd on and
in ``train()`` mode (``encode_batch`` is ``no_grad`` and buckets the
shapes). Parameters stay fp32 and activations take ``encoder.dtype``, as
Flax's ``nn.Dense(dtype=...)`` trains them. The optimizer is optax's
``adamw`` (weight decay 1e-4 on every tensor). At each validation
improvement the state is copied and, with a checkpoint path, written with
the optimizer's state (``trainer.save_training_state``); the best state
is loaded back into the tower at the end, as the JAX trainer sets
``encoder.params``. One device: data parallelism waits for the port's
``torch.distributed`` work (ROADMAP queue 1, item 4).

  python -m latentrag_torch.training.train_encoder --epochs 5 \\
      --set data.dataset=synthetic data.max_samples=200

writes ``<checkpoints_dir>/encoder.msgpack`` (the JAX package's Flax
layout), which ``pipeline.default_encoder`` loads, and keeps the resume
state ``<checkpoints_dir>/encoder_train.pt``.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import sys
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from ..utils.config import TrainingConfig
from .trainer import (
    apply_gradients,
    grads_of,
    make_optimizer,
    restore_training_state,
    save_training_state,
    snapshot,
)

log = logging.getLogger("latentrag_torch.train")

WEIGHT_DECAY = 1e-4  # the JAX trainers' optax.adamw weight decay


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Per-row CE with integer labels, ``logsumexp - logit[label]``
    (optax's ``softmax_cross_entropy_with_integer_labels``)."""
    return (torch.logsumexp(logits, dim=-1)
            - logits.gather(-1, labels[:, None])[:, 0])


def info_nce_loss(
    z_q: torch.Tensor,
    z_p: torch.Tensor,
    temperature: float = 0.05,
    dup_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Symmetric in-batch InfoNCE over the embeddings' fp32 similarities.

    ``dup_mask[i, j]`` true marks off-diagonal pairs whose positives are
    identical (frequent in SQuAD: several questions share one context);
    they are set to -1e9, out of the negatives, since the objective
    would otherwise push sim(q_i, p_j) down while p_j == p_i."""
    sims = (z_q @ z_p.T).float() / temperature
    labels = torch.arange(sims.shape[0], device=sims.device)
    if dup_mask is not None:
        eye = torch.eye(sims.shape[0], dtype=torch.bool, device=sims.device)
        sims = torch.where(dup_mask & ~eye, -1e9, sims)
    return 0.5 * (softmax_cross_entropy(sims, labels).mean()
                  + softmax_cross_entropy(sims.T, labels).mean())


def duplicate_rows(ids: torch.Tensor) -> torch.Tensor:
    """[B, B] true where two rows of token ids are equal."""
    return torch.all(ids[:, None, :] == ids[None, :, :], dim=-1)


def pad_to(a: np.ndarray, length: int, fill: int) -> np.ndarray:
    if a.shape[1] < length:
        a = np.pad(a, ((0, 0), (0, length - a.shape[1])),
                   constant_values=fill)
    return a


@dataclasses.dataclass
class EncoderTrainResult:
    params: dict  # the best state dict
    history: list  # (epoch, train_loss, val_loss)
    best_val_loss: float


class PairTrainer:
    """The loop the encoder, DPR and reranker trainers share: AdamW (wd
    1e-4) over ``module``'s parameters, ``loss(batch)`` in the subclass,
    an epoch of steps over the shuffled training indices, one validation
    batch, the best state copied (and written) at each improvement and
    loaded back at the end."""

    tag = "encoder"

    def __init__(self, module: nn.Module, cfg: TrainingConfig,
                 device: torch.device):
        self.module = module
        self.cfg = cfg
        self.device = device
        self.params = list(module.parameters())
        self.optimizer = make_optimizer(self.params, cfg.learning_rate,
                                        WEIGHT_DECAY)

    def loss(self, batch: dict) -> torch.Tensor:
        raise NotImplementedError

    def train_step(self, batch: dict) -> torch.Tensor:
        """One AdamW step; returns the batch's loss (on the device)."""
        loss = self.loss(batch)
        grads = grads_of(loss, self.params)
        apply_gradients(self.optimizer, grads)
        return loss.detach()

    def to_device(self, arrays: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in arrays.items()}

    def _run(self, make_batch: Callable[[np.ndarray], dict],
             train_idx: np.ndarray, val_batch: dict, bs: int,
             rng: np.random.Generator, checkpoint_path: str | None,
             resume: bool) -> tuple[dict, list, float]:
        """The epochs; returns (best state, history, best val loss)."""
        self.optimizer = make_optimizer(self.params, self.cfg.learning_rate,
                                        WEIGHT_DECAY)
        best_val = math.inf
        start_epoch = 0
        if resume and checkpoint_path and os.path.isfile(checkpoint_path):
            best_val, start_epoch = restore_training_state(
                checkpoint_path, self.module, self.optimizer)
            log.info("[%s] resumed from %s at epoch %d (best val %.4f)",
                     self.tag, checkpoint_path, start_epoch, best_val)
        best = snapshot(self.module)
        history = []
        for epoch in range(start_epoch, self.cfg.epochs):
            rng.shuffle(train_idx)
            self.module.train()
            losses = [self.train_step(make_batch(train_idx[s:s + bs]))
                      for s in range(0, len(train_idx) - bs + 1, bs)]
            self.module.eval()
            with torch.no_grad():
                val_loss = self.loss(val_batch).item()
            train_loss = (torch.stack(losses).double().mean().item()
                          if losses else float("nan"))
            history.append((epoch, train_loss, val_loss))
            log.info("[%s] epoch %d train %.4f val %.4f", self.tag, epoch,
                     train_loss, val_loss)
            if val_loss < best_val:
                best_val = val_loss
                best = snapshot(self.module)
                if checkpoint_path:
                    save_training_state(checkpoint_path, self.module,
                                        self.optimizer, epoch, best_val)
        self.module.load_state_dict(best)
        return best, history, best_val

    def _run_split(self, data: dict, val_fraction: float,
                   checkpoint_path: str | None,
                   resume: bool) -> tuple[dict, list, float]:
        """``_run`` over tokenized rows: the JAX trainers' seeded split (at
        least 2 validation rows, one validation batch) and batches of
        ``cfg.batch_size`` rows (at most the training rows)."""
        n = len(next(iter(data.values())))
        rng = np.random.default_rng(self.cfg.seed)
        order = rng.permutation(n)
        n_val = max(2, int(n * val_fraction))
        val_idx, train_idx = order[:n_val], order[n_val:]
        return self._run(
            lambda sel: self.to_device({k: v[sel] for k, v in data.items()}),
            train_idx, self.to_device({k: v[val_idx] for k, v in data.items()}),
            min(self.cfg.batch_size, len(train_idx)), rng, checkpoint_path,
            resume)


class EncoderTrainer(PairTrainer):
    """Train a ``SentenceEncoder`` on (query, positive) text pairs."""

    def __init__(self, encoder, cfg: TrainingConfig | None = None,
                 max_length: int = 64, temperature: float = 0.05):
        self.encoder = encoder
        self.max_length = max_length
        self.temperature = temperature
        super().__init__(encoder.module,
                         cfg or TrainingConfig(batch_size=32, epochs=5),
                         encoder.device)

    def loss(self, batch: dict) -> torch.Tensor:
        ids = torch.cat([batch["q_ids"], batch["p_ids"]]).long()
        mask = torch.cat([batch["q_mask"], batch["p_mask"]])
        z = self.module(ids, mask)
        b = batch["q_ids"].shape[0]
        # duplicated contexts are found by their token ids
        return info_nce_loss(z[:b], z[b:], self.temperature,
                             dup_mask=duplicate_rows(batch["p_ids"]))

    def _tokenize_pairs(self, queries: Sequence[str],
                        positives: Sequence[str]) -> dict:
        tok = self.encoder.tokenizer
        q_ids, q_mask = tok.encode_batch(list(queries), self.max_length)
        p_ids, p_mask = tok.encode_batch(list(positives), self.max_length)
        return {"q_ids": pad_to(q_ids, self.max_length, tok.pad_id),
                "q_mask": pad_to(q_mask, self.max_length, 0),
                "p_ids": pad_to(p_ids, self.max_length, tok.pad_id),
                "p_mask": pad_to(p_mask, self.max_length, 0)}

    def fit(self, queries: Sequence[str], positives: Sequence[str],
            val_fraction: float = 0.1, checkpoint_path: str | None = None,
            resume: bool = False) -> EncoderTrainResult:
        """Train; with ``checkpoint_path`` every improvement writes the
        resume state there, and ``resume`` continues from it (the epoch
        counter and Adam's state; the shuffle stream restarts)."""
        if len(queries) < 8:
            raise ValueError(
                f"need at least 8 (query, positive) pairs, got {len(queries)}"
            )
        best, history, best_val = self._run_split(
            self._tokenize_pairs(queries, positives), val_fraction,
            checkpoint_path, resume)
        return EncoderTrainResult(params=best, history=history,
                                  best_val_loss=best_val)


def save_encoder_msgpack(module: nn.Module, path: str) -> None:
    """A ``MiniLMEncoder``'s weights as the JAX package's Flax msgpack."""
    from ..models.convert import minilm_params_from_state_dict
    from ..models.encoder.msgpack_io import save_msgpack

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    save_msgpack(minilm_params_from_state_dict(module.state_dict()), path)


def main(argv=None) -> int:
    """CLI: train the sentence encoder on the configured dataset's
    (question, context) pairs and save its weights and tokenizer."""
    import argparse

    from ..data import WordPieceTokenizer, get_examples
    from ..models.encoder import SentenceEncoder
    from ..utils import apply_overrides, init_logger, load_config

    p = argparse.ArgumentParser(description="train the sentence encoder")
    p.add_argument("--config", default=None)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--learning_rate", type=float, default=3e-4)
    p.add_argument("--max_length", type=int, default=64)
    p.add_argument("--out", default=None, help="weights output (.msgpack)")
    p.add_argument("--resume", action="store_true",
                   help="continue from <checkpoints_dir>/encoder_train.pt")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--set", nargs="*", default=[], metavar="a.b=v")
    args = p.parse_args(argv)

    cfg = apply_overrides(load_config(args.config), args.set)
    loggers = init_logger(cfg.logging)
    examples = get_examples(cfg, split="train")
    queries = [e["question"] for e in examples]
    positives = [e["context"] for e in examples]

    tok_path = os.path.join(cfg.paths.data_dir, "tokenizer.json")
    if os.path.exists(tok_path):
        tokenizer = WordPieceTokenizer.load(tok_path)
    else:
        tokenizer = WordPieceTokenizer.train_from_corpus(
            positives, vocab_size=cfg.encoder.vocab_size)
        os.makedirs(cfg.paths.data_dir, exist_ok=True)
        tokenizer.save(tok_path)

    encoder = SentenceEncoder(tokenizer, cfg.encoder, device=args.device)
    tcfg = TrainingConfig(batch_size=args.batch_size, epochs=args.epochs,
                          learning_rate=args.learning_rate,
                          seed=cfg.training.seed)
    trainer = EncoderTrainer(encoder, tcfg, max_length=args.max_length)
    result = trainer.fit(
        queries, positives, resume=args.resume,
        checkpoint_path=os.path.join(cfg.paths.checkpoints_dir,
                                     "encoder_train.pt"))
    out = args.out or os.path.join(cfg.paths.checkpoints_dir,
                                   "encoder.msgpack")
    save_encoder_msgpack(encoder.module, out)
    loggers.train.info("encoder trained: best val %.4f -> %s",
                       result.best_val_loss, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
