"""Cross-encoder reranker training: a listwise softmax over candidates.

The port of the JAX package's ``training/train_reranker.py``. Two modes:

* in-batch: each step scores the B x B pair matrix (every query against
  every in-batch passage, B^2 pair forwards as one batched call) and
  minimizes softmax cross-entropy with diagonal labels, duplicate-positive
  columns masked (as ``train_encoder.info_nce_loss`` masks them); the
  batch is capped at 16 queries (256 pairs a step);
* mined hard negatives: each step scores [B, 1 + H] candidate lists, the
  positive in column 0 and H mined negatives after it. Every list is cut
  to the shortest list's length, as in the JAX package, and the cut is
  logged when it drops negatives.

The seeded init (``seed=3``) is the port's ``torch.Generator`` draw, not
JAX's. One device.

  python -m latentrag_torch.training.train_reranker --epochs 5 --set \\
      data.dataset=synthetic data.max_samples=200

writes ``<checkpoints_dir>/reranker.msgpack`` (the JAX package's Flax
layout, which ``retrieval.rerank=cross`` loads) with its ``.meta.json``
sidecar, and keeps the resume state ``<checkpoints_dir>/reranker_train.pt``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys
from typing import Sequence

import numpy as np
import torch

from ..models.encoder.cross import encode_pairs
from ..utils.config import TrainingConfig
from .train_encoder import PairTrainer, softmax_cross_entropy

log = logging.getLogger("latentrag_torch.train")


@dataclasses.dataclass
class RerankerTrainResult:
    params: dict
    history: list
    best_val_loss: float


def listwise_loss(logits: torch.Tensor,
                  dup_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Softmax CE over each query's B candidate scores, diagonal labels.

    ``logits``: [B, B], row i query i against every in-batch passage.
    ``dup_mask[i, j]`` true marks off-diagonal columns whose passage equals
    query i's positive; they leave the candidate set (-1e9)."""
    logits = logits.float()
    labels = torch.arange(logits.shape[0], device=logits.device)
    if dup_mask is not None:
        eye = torch.eye(logits.shape[0], dtype=torch.bool,
                        device=logits.device)
        logits = torch.where(dup_mask & ~eye, -1e9, logits)
    return softmax_cross_entropy(logits, labels).mean()


class RerankerTrainer(PairTrainer):
    """Listwise training over a ``CrossEncoderScorer``."""

    tag = "reranker"

    def __init__(self, scorer, cfg: TrainingConfig | None = None,
                 max_length: int = 128):
        self.scorer = scorer
        self.max_length = max_length
        super().__init__(scorer.module,
                         cfg or TrainingConfig(batch_size=8, epochs=5),
                         scorer.device)

    def loss(self, batch: dict) -> torch.Tensor:
        logits = self.module(batch["ids"], batch["mask"],
                             batch["tt"]).reshape(batch["dup"].shape)
        if "labels" in batch:
            # mined mode: [B, 1+H] lists, the positive in column 0;
            # duplicate-of-positive columns leave the softmax
            logits = torch.where(batch["dup"], -1e9, logits.float())
            return softmax_cross_entropy(logits, batch["labels"]).mean()
        return listwise_loss(logits, dup_mask=batch["dup"])

    def _pairs(self, pq: list, pd: list) -> dict:
        ids, mask, tt = encode_pairs(
            self.scorer.tokenizer, pq, pd, max_length=self.max_length,
            query_max=self.scorer.query_max)
        return self.to_device({"ids": ids.astype(np.int64),
                               "mask": mask, "tt": tt.astype(np.int64)})

    def _hard_batch(self, queries, positives, negs) -> dict:
        """[B, 1+H] lists: column 0 the positive, columns 1..H the mined
        hard negatives."""
        b, h = len(queries), len(negs[0])
        pq, pd = [], []
        dup = np.zeros((b, 1 + h), bool)
        for i in range(b):
            for j, dtext in enumerate([positives[i]] + list(negs[i])):
                pq.append(queries[i])
                pd.append(dtext)
                if j > 0 and dtext == positives[i]:
                    dup[i, j] = True
        return {**self._pairs(pq, pd), **self.to_device({
            "dup": dup, "labels": np.zeros((b,), np.int64)})}

    def _pair_batch(self, queries: Sequence[str], docs: Sequence[str]):
        """All B x B (query, doc) pairs and the duplicate mask."""
        b = len(queries)
        pq = [queries[i] for i in range(b) for _ in range(b)]
        pd = [docs[j] for _ in range(b) for j in range(b)]
        docs_arr = np.asarray(docs, dtype=object)
        return {**self._pairs(pq, pd), **self.to_device({
            "dup": docs_arr[None, :] == docs_arr[:, None]})}

    def fit(
        self,
        queries: Sequence[str],
        positives: Sequence[str],
        val_fraction: float = 0.1,
        checkpoint_path: str | None = None,
        resume: bool = False,
        negatives: Sequence[Sequence[str]] | None = None,
    ) -> RerankerTrainResult:
        """``negatives`` (optional): per-example mined hard negatives;
        given them, each step is a [B, 1+H] list softmax with the positive
        in column 0 instead of the in-batch B x B matrix."""
        cfg = self.cfg
        if len(queries) < 8:
            raise ValueError(
                f"need at least 8 (question, passage) pairs, got "
                f"{len(queries)}"
            )
        n = len(queries)
        rng = np.random.default_rng(cfg.seed)
        order = rng.permutation(n)
        if negatives is not None:
            lengths = [len(g) for g in negatives]
            h = min(lengths)
            if h < 1:
                raise ValueError("every example needs >=1 mined negative")
            if max(lengths) > h:
                log.warning(
                    "[reranker] mined negatives cut to the shortest list's "
                    "%d: %d of %d negatives dropped (%d of %d examples had "
                    "more)", h, sum(lengths) - h * n, sum(lengths),
                    sum(x > h for x in lengths), n)
            negatives = [list(g)[:h] for g in negatives]
            # pairs a step = bs * (1+h): the capped B^2 mode's budget
            bs = min(cfg.batch_size, max(2, 256 // (1 + h)), max(2, n // 4))

            def make_batch(sel):
                return self._hard_batch([queries[i] for i in sel],
                                        [positives[i] for i in sel],
                                        [negatives[i] for i in sel])
        else:
            # B^2 pairs a step, quadratic where the other trainers are
            # linear: 16 queries -> 256 pair forwards a step
            bs = min(cfg.batch_size, 16, max(2, n // 4))
            if bs < cfg.batch_size:
                log.info(
                    "[reranker] listwise batch capped at %d queries "
                    "(%d^2 = %d pairs/step; config asked %d)",
                    bs, bs, bs * bs, cfg.batch_size,
                )

            def make_batch(sel):
                return self._pair_batch([queries[i] for i in sel],
                                        [positives[i] for i in sel])

        n_val = max(bs, int(n * val_fraction))
        val_idx, train_idx = order[:n_val], order[n_val:]
        best, history, best_val = self._run(
            make_batch, train_idx, make_batch(val_idx[:bs]), bs, rng,
            checkpoint_path, resume)
        return RerankerTrainResult(params=best, history=history,
                                   best_val_loss=best_val)


def main(argv=None) -> int:
    import argparse

    from ..data import get_examples
    from ..data.tokenizer import resolve_tokenizer
    from ..models.encoder.cross import CrossEncoderScorer
    from ..retrieval.reranker import save_reranker
    from ..utils import apply_overrides, init_logger, load_config, set_seed

    p = argparse.ArgumentParser(
        description="train the cross-encoder reranker"
    )
    p.add_argument("--config", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--max_length", type=int, default=128)
    p.add_argument("--resume", action="store_true",
                   help="continue from <checkpoints_dir>/reranker_train.pt")
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
    loggers.train.info("reranker training on %d pairs", len(queries))

    # the pipeline's resolution order (vocab.txt > tokenizer.json >
    # train): another vocabulary than serving's would scramble every
    # embedding lookup
    tokenizer = resolve_tokenizer(
        cfg.paths.data_dir, cfg.encoder.vocab_size, positives
    )
    scorer = CrossEncoderScorer(tokenizer, cfg.encoder, seed=3,
                                device=args.device)
    tcfg = cfg.training
    if args.epochs is not None:
        tcfg = dataclasses.replace(tcfg, epochs=args.epochs)
    if args.batch_size is not None:
        tcfg = dataclasses.replace(tcfg, batch_size=args.batch_size)
    trainer = RerankerTrainer(scorer, tcfg, max_length=args.max_length)
    res = trainer.fit(
        queries, positives, resume=args.resume,
        checkpoint_path=os.path.join(cfg.paths.checkpoints_dir,
                                     "reranker_train.pt"))
    # the weights with the sidecar pinning the trained pair length and
    # the vocabulary's identity for the serving side
    out = save_reranker(cfg, scorer, args.max_length, scorer.query_max)
    loggers.train.info("reranker trained: best val %.4f -> %s",
                       res.best_val_loss, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
