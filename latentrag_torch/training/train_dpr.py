"""DPR dual-encoder training: separate question and context towers,
in-batch InfoNCE (Karpukhin et al. 2020).

The port of the JAX package's ``training/train_dpr.py``: the towers train
jointly under one AdamW (weight decay 1e-4 on every tensor) on (question,
positive passage) pairs; each tower runs its batch as one forward, the
similarity matrix is [B, B] fp32, sequences pad to ``max_length``.
``build_dpr_encoders`` loads the towers the trainer writes
(``dpr_question.msgpack`` / ``dpr_context.msgpack``, the JAX package's
Flax layout), so the harness's ``dpr`` system serves trained towers.

  python -m latentrag_torch.training.train_dpr --epochs 5 --set \\
      data.dataset=synthetic data.max_samples=200
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys
from typing import Sequence

import torch
from torch import nn

from ..utils.config import TrainingConfig
from .train_encoder import (
    PairTrainer,
    duplicate_rows,
    info_nce_loss,
    pad_to,
    save_encoder_msgpack,
)

log = logging.getLogger("latentrag_torch.train")


@dataclasses.dataclass
class DPRTrainResult:
    q_params: dict
    c_params: dict
    history: list
    best_val_loss: float


class DualEncoderTrainer(PairTrainer):
    """Train a question tower and a context tower jointly with InfoNCE."""

    tag = "dpr"

    def __init__(self, q_encoder, c_encoder, cfg: TrainingConfig | None = None,
                 max_length: int = 64, temperature: float = 0.05):
        self.q_encoder = q_encoder
        self.c_encoder = c_encoder
        self.max_length = max_length
        self.temperature = temperature
        super().__init__(
            nn.ModuleDict({"q": q_encoder.module, "c": c_encoder.module}),
            cfg or TrainingConfig(batch_size=32, epochs=5),
            q_encoder.device)

    def loss(self, batch: dict) -> torch.Tensor:
        zq = self.module["q"](batch["q_ids"].long(), batch["q_mask"])
        zp = self.module["c"](batch["p_ids"].long(), batch["p_mask"])
        return info_nce_loss(zq, zp, self.temperature,
                             dup_mask=duplicate_rows(batch["p_ids"]))

    def _tokenize(self, queries: Sequence[str],
                  positives: Sequence[str]) -> dict:
        out = {}
        for side, tok, texts in (("q", self.q_encoder.tokenizer, queries),
                                 ("p", self.c_encoder.tokenizer, positives)):
            ids, mask = tok.encode_batch(list(texts), self.max_length)
            out[f"{side}_ids"] = pad_to(ids, self.max_length, tok.pad_id)
            out[f"{side}_mask"] = pad_to(mask, self.max_length, 0)
        return out

    def fit(self, queries: Sequence[str], positives: Sequence[str],
            val_fraction: float = 0.1, checkpoint_path: str | None = None,
            resume: bool = False) -> DPRTrainResult:
        """Train both towers; ``checkpoint_path`` and ``resume`` as
        ``EncoderTrainer.fit``'s."""
        if len(queries) < 8:
            raise ValueError(
                f"need at least 8 (question, passage) pairs, got "
                f"{len(queries)}"
            )
        best, history, best_val = self._run_split(
            self._tokenize(queries, positives), val_fraction,
            checkpoint_path, resume)
        split = {side: {k[2:]: v for k, v in best.items()
                        if k.startswith(side + ".")} for side in ("q", "c")}
        return DPRTrainResult(q_params=split["q"], c_params=split["c"],
                              history=history, best_val_loss=best_val)


def build_dpr_encoders(cfg, corpus_texts=None, device="cuda"):
    """(question encoder, context encoder) on ``device``: the port's
    ``SentenceEncoder`` at ``cfg.encoder``'s geometry with [CLS] pooling
    and no normalization. Each tower loads
    ``<checkpoints_dir>/dpr_question.msgpack`` / ``dpr_context.msgpack``
    (written by ``main`` below or by the JAX package's trainer) when the
    file is there, else it takes a seeded init (``torch.Generator`` seeds
    1 and 2; the JAX package seeds its towers with 1 and 2 through its own
    PRNG, so seeded towers differ between the packages). The tokenizer
    resolves as the pipeline's encoder's does (vocab.txt > tokenizer.json
    > trained on the corpus)."""
    from ..data.tokenizer import resolve_tokenizer
    from ..models.convert import minilm_state_dict_from_jax
    from ..models.encoder import SentenceEncoder
    from ..models.encoder.msgpack_io import load_msgpack

    tokenizer = resolve_tokenizer(
        cfg.paths.data_dir, cfg.encoder.vocab_size, corpus_texts or []
    )
    ecfg = dataclasses.replace(cfg.encoder, pooling="cls", normalize=False)
    towers = []
    for name, seed in (("dpr_question", 1), ("dpr_context", 2)):
        path = os.path.join(cfg.paths.checkpoints_dir, f"{name}.msgpack")
        state_dict = None
        if os.path.exists(path):
            state_dict = minilm_state_dict_from_jax(load_msgpack(path))
            log.info("loaded %s weights: %s", name, path)
        towers.append(SentenceEncoder(tokenizer, ecfg, state_dict=state_dict,
                                      seed=seed, device=device))
    return tuple(towers)


def main(argv=None) -> int:
    import argparse

    from ..data import get_examples
    from ..utils import apply_overrides, init_logger, load_config, set_seed

    p = argparse.ArgumentParser(description="train DPR dual towers")
    p.add_argument("--config", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--max_length", type=int, default=64)
    p.add_argument("--resume", action="store_true",
                   help="continue from <checkpoints_dir>/dpr_train.pt")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--set", nargs="*", default=[], metavar="a.b=v")
    args = p.parse_args(argv)

    cfg = apply_overrides(load_config(args.config), args.set)
    loggers = init_logger(cfg.logging)
    set_seed(cfg.training.seed, cfg.training.deterministic)

    examples = get_examples(cfg)
    queries = [ex["question"] for ex in examples]
    positives = [ex["context"] for ex in examples]
    loggers.train.info("DPR training on %d pairs", len(queries))

    q_enc, c_enc = build_dpr_encoders(cfg, corpus_texts=positives,
                                      device=args.device)
    tcfg = cfg.training
    if args.epochs is not None:
        tcfg = dataclasses.replace(tcfg, epochs=args.epochs)
    if args.batch_size is not None:
        tcfg = dataclasses.replace(tcfg, batch_size=args.batch_size)
    trainer = DualEncoderTrainer(q_enc, c_enc, tcfg,
                                 max_length=args.max_length)
    res = trainer.fit(
        queries, positives, resume=args.resume,
        checkpoint_path=os.path.join(cfg.paths.checkpoints_dir,
                                     "dpr_train.pt"))
    qp = os.path.join(cfg.paths.checkpoints_dir, "dpr_question.msgpack")
    cp = os.path.join(cfg.paths.checkpoints_dir, "dpr_context.msgpack")
    save_encoder_msgpack(q_enc.module, qp)
    save_encoder_msgpack(c_enc.module, cp)
    loggers.train.info("DPR towers trained: best val %.4f -> %s, %s",
                       res.best_val_loss, qp, cp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
