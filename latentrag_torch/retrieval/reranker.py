"""Cross-encoder reranking, two-stage retrieval's second stage.

The port of the JAX package's ``retrieval/reranker.py``. Stage 1 (a dense
or ANN tier) fetches an oversampled candidate set; this stage rescores each
(query, candidate text) pair with the cross-encoder
(``models/encoder/cross.py``) on the scorer's device.

``retrieval.rerank=cross`` makes the pipeline and the server rescore the
chunk-level candidates before MaxSim; ``retrieval.rerank_candidates``
widens the stage-1 fetch (0 = 4 x top_k). The reranker needs a trained
checkpoint, ``<checkpoints_dir>/reranker.msgpack`` (written by
``python -m latentrag_torch.training.train_reranker``, or by the JAX
package's ``train_reranker``), and its ``.meta.json`` sidecar: an
untrained cross-encoder would scramble stage 1's ranking, so a missing
checkpoint raises, as a missing AE checkpoint does.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Sequence

import numpy as np

log = logging.getLogger("latentrag_torch.retrieval")

NEG_INF = float(-3.4e38)
DEFAULT_QUERY_MAX = 64


class CrossEncoderReranker:
    """Batched candidate rescoring over a ``CrossEncoderScorer``."""

    def __init__(self, scorer):
        self.scorer = scorer

    def rescore_candidates(self, queries: Sequence[str], idx: np.ndarray,
                           texts: Sequence[str]) -> np.ndarray:
        """Cross-encoder scores for stage-1 candidates.

        ``idx`` is the [Q, C] candidate matrix of row indices into
        ``texts`` (-1 = empty slot). Returns fp32 [Q, C] logits with
        NEG_INF in empty slots, a drop-in for stage 1's score matrix. All
        live pairs go to the scorer in one call, row-major."""
        idx = np.asarray(idx)
        valid = idx >= 0
        rows, cols = np.nonzero(valid)
        out = np.full(idx.shape, NEG_INF, dtype=np.float32)
        if rows.size:
            out[valid] = self.scorer.score_pairs(
                [queries[i] for i in rows],
                [texts[int(j)] for j in idx[rows, cols]])
        return out


def reranker_checkpoint_path(cfg) -> str:
    return os.path.join(cfg.paths.checkpoints_dir, "reranker.msgpack")


def save_reranker_meta(cfg, tokenizer, max_length: int,
                       query_max: int) -> None:
    """The sidecar recording what the checkpoint was trained with: the
    pair truncation lengths and the vocabulary's identity. Serving replays
    them: a longer pair would attend over position rows training never
    touched, and another vocabulary of the same size would index the wrong
    embedding rows."""
    from ..data.tokenizer import tokenizer_digest

    meta = {
        "max_length": int(max_length),
        "query_max": int(query_max),
        "vocab_size": int(tokenizer.vocab_size),
        "vocab_sha1": tokenizer_digest(tokenizer),
    }
    path = reranker_checkpoint_path(cfg) + ".meta.json"
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, path)


def save_reranker(cfg, scorer, max_length: int, query_max: int) -> str:
    """Write ``scorer``'s weights as the JAX package's
    ``reranker.msgpack`` (the Flax tree, flax's byte layout) and its
    sidecar; returns the checkpoint's path."""
    from ..models.convert import cross_encoder_params_from_state_dict
    from ..models.encoder.msgpack_io import save_msgpack

    path = reranker_checkpoint_path(cfg)
    save_msgpack(cross_encoder_params_from_state_dict(
        scorer.module.state_dict()), path)
    save_reranker_meta(cfg, scorer.tokenizer, max_length, query_max)
    return path


def build_reranker(cfg, tokenizer, device="cuda") -> CrossEncoderReranker:
    """The configured reranker from its trained checkpoint, on ``device``.

    Raises FileNotFoundError when the checkpoint is absent. The sidecar
    pins the trained pair length (served pairs truncate to exactly it,
    whatever ``encoder.max_length`` says) and ``query_max``, and refuses a
    tokenizer of another vocabulary (ValueError). Without a sidecar the
    scorer serves at ``encoder.max_length`` and logs a warning."""
    from ..data.tokenizer import tokenizer_digest
    from ..models.convert import cross_encoder_state_dict_from_jax
    from ..models.encoder.cross import CrossEncoderScorer
    from ..models.encoder.msgpack_io import load_msgpack

    path = reranker_checkpoint_path(cfg)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"retrieval.rerank=cross needs a trained reranker at {path}; "
            "train one with python -m latentrag_torch.training."
            "train_reranker --epochs 5"
        )
    ecfg = cfg.encoder
    query_max = DEFAULT_QUERY_MAX
    meta_path = path + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        want_sha = meta.get("vocab_sha1")
        if want_sha is not None and want_sha != tokenizer_digest(tokenizer):
            raise ValueError(
                f"reranker at {path} was trained under a different "
                "vocabulary than the serving tokenizer; retrain it in this "
                "workspace (its trainer resolves the tokenizer as the "
                "pipeline does)"
            )
        # the trained pair length is the model's input contract: serve at
        # exactly it, shorter or longer than encoder.max_length
        trained_len = int(meta.get("max_length", ecfg.max_length))
        if trained_len != ecfg.max_length:
            ecfg = dataclasses.replace(ecfg, max_length=trained_len)
        query_max = int(meta.get("query_max", query_max))
    else:
        log.warning(
            "reranker at %s has no meta sidecar; serving with "
            "encoder.max_length=%d untruncated (retrain to pin the trained "
            "pair length)", path, ecfg.max_length,
        )
    scorer = CrossEncoderScorer(
        tokenizer, ecfg,
        state_dict=cross_encoder_state_dict_from_jax(load_msgpack(path)),
        query_max=query_max, device=device)
    log.info("cross-encoder reranker loaded: %s (pair length %d)",
             path, ecfg.max_length)
    return CrossEncoderReranker(scorer)
