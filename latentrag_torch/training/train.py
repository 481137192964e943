"""Training CLI of the autoencoder variants.

The port of the JAX package's ``training/train.py``: one entry point for
the three variants; flags override the YAML, which ``--set`` overrides.

Usage:
  python -m latentrag_torch.training.train --ae_type vae
  python -m latentrag_torch.training.train --ae_type cae --epochs 10 \\
      --batch_size 64 --device cpu --set data.dataset=synthetic

It writes ``<checkpoints_dir>/<models.<ae>.checkpoint or ae_type>`` with
``.pth`` added when the name lacks it (the reference-keyed weights that
``python -m latentrag_torch.main --ae_type <ae>`` loads) and, beside it,
the resume state ``<name>.train.pt`` (``--resume`` continues from it).
``--device`` defaults to ``cuda`` and never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from ..data import (
    WordPieceTokenizer,
    get_examples,
    prepare_training_arrays,
    split_dataset,
)
from ..models import build_autoencoder
from ..models.encoder import SentenceEncoder
from ..pipeline import autoencoder_checkpoint_path
from ..retrieval import EmbeddingCompressor
from ..utils import (
    apply_overrides,
    canonical_ae_type,
    init_logger,
    load_config,
    set_seed,
)
from .trainer import Trainer


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="train a latent autoencoder")
    p.add_argument("--config", default=None)
    p.add_argument("--ae_type", required=True)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--resume", action="store_true",
                   help="continue from the checkpoint's resume state "
                        "(params + optimizer state + epoch)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--set", nargs="*", default=[], metavar="a.b=v")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.set)
    updates = {k: v for k, v in (
        ("epochs", args.epochs), ("batch_size", args.batch_size),
        ("learning_rate", args.learning_rate), ("seed", args.seed))
        if v is not None}
    if updates:
        cfg = dataclasses.replace(
            cfg, training=dataclasses.replace(cfg.training, **updates))

    loggers = init_logger(cfg.logging)
    set_seed(cfg.training.seed, cfg.training.deterministic)
    ae_type = canonical_ae_type(args.ae_type)
    if ae_type == "none":
        raise SystemExit("--ae_type none has nothing to train")

    # the CAE gets the reference's extra regularisation when none is set
    if ae_type == "cae" and cfg.training.weight_decay == 0.0:
        cfg = dataclasses.replace(cfg, training=dataclasses.replace(
            cfg.training, weight_decay=1e-4, grad_clip_norm=1.0,
            lr_plateau_factor=0.5, early_stop_relative=True,
            early_stop_min_delta=0.003))

    examples = get_examples(cfg, split="train")
    tok_path = os.path.join(cfg.paths.data_dir, "tokenizer.json")
    if os.path.exists(tok_path):
        tokenizer = WordPieceTokenizer.load(tok_path)
    else:
        tokenizer = WordPieceTokenizer.train_from_corpus(
            [e["context"] for e in examples],
            vocab_size=cfg.encoder.vocab_size)
        os.makedirs(cfg.paths.data_dir, exist_ok=True)
        tokenizer.save(tok_path)
    encoder = SentenceEncoder(tokenizer, cfg.encoder, device=args.device)
    compressor = EmbeddingCompressor(encoder,
                                     batch_size=cfg.encoder.batch_size)

    loggers.train.info("preparing %s training arrays (%d examples)",
                       ae_type, len(examples))
    data = prepare_training_arrays(
        examples, compressor, tokenizer, ae_type,
        cache_dir=os.path.join(cfg.paths.data_dir, "emb_cache"),
        noise_std=cfg.data.dae_noise_std,
        max_jaccard=cfg.data.negative_jaccard_max,
        seed=cfg.training.seed, model_name=cfg.encoder.name,
        mine_hard_negatives=(ae_type == "cae"
                             and cfg.training.mine_hard_negatives),
    )
    train_data, val_data = split_dataset(data, cfg.data.val_split,
                                         cfg.training.seed)

    model = build_autoencoder(ae_type, cfg.models.for_type(ae_type))
    trainer = Trainer(model, ae_type, cfg.training, device=args.device)
    path = autoencoder_checkpoint_path(cfg, ae_type)
    result = trainer.fit(train_data, val_data, checkpoint_path=path,
                         resume=args.resume)
    loggers.train.info(
        "done: best val %.5f after %d epochs (early stop: %s) -> %s",
        result.best_val_loss, result.epochs_ran, result.stopped_early, path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
