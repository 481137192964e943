"""The DPR towers: ``build_dpr_encoders``, the JAX package's
``training/train_dpr.py`` builder. Its trainer is not ported yet (ROADMAP
queue 1, items 21-22); this module holds only the builder the benchmark
harness's ``dpr`` system calls."""

from __future__ import annotations

import dataclasses
import logging
import os

log = logging.getLogger("latentrag_torch.train")


def build_dpr_encoders(cfg, corpus_texts=None, device="cuda"):
    """(question encoder, context encoder) on ``device``: the port's
    ``SentenceEncoder`` at ``cfg.encoder``'s geometry with [CLS] pooling
    and no normalization. Each tower loads
    ``<checkpoints_dir>/dpr_question.msgpack`` / ``dpr_context.msgpack``
    (the JAX package's tower checkpoints) when the file is there, else it
    takes a seeded init (``torch.Generator`` seeds 1 and 2; the JAX
    package seeds its towers with 1 and 2 through its own PRNG, so seeded
    towers differ between the packages). The tokenizer resolves as the
    pipeline's encoder's does (vocab.txt > tokenizer.json > trained on
    the corpus)."""
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
