"""End-to-end retrieval pipeline: encode -> (compress) -> index -> search ->
MaxSim -> evaluate.

The port of the JAX package's ``pipeline.py`` (``PipelineRunner.process``),
on a device chosen by the caller (default CUDA; the CPU only when asked):

* corpus and queries encode on the device and stay there into the index
  build and the one batched search;
* ``candidate_k = top_k`` clipped to the corpus (the JAX package's x3
  widening for chunks and x4 for the reranker come with those slices);
* empty candidate slots (id -1) map to a sentinel doc whose score is
  forced to NEG_INF before MaxSim, and sentinel docs are dropped after;
* MaxSim runs on the device, as the JAX package runs it there.

Chunking, reranking and generation are later slices (ROADMAP queue 1
items 19 and 24); asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Sequence

import numpy as np
import torch

from .data.tokenizer import resolve_tokenizer
from .evaluation import evaluate_retrieval
from .models import build_autoencoder, load_autoencoder_pth
from .models.encoder import SentenceEncoder
from .ops import maxsim_aggregate
from .retrieval import EmbeddingCompressor, build_retriever
from .utils import Config, canonical_ae_type, force_completion, resolve_device

log = logging.getLogger("latentrag_torch.main")


def load_autoencoder(cfg: Config, ae_type: str, device="cuda"):
    """The AE module for ``ae_type`` with its trained weights, on
    ``device``. ``models.<ae>.checkpoint`` must name a reference-keyed
    ``.pth`` (absolute, or under ``paths.checkpoints_dir``)."""
    ae_type = canonical_ae_type(ae_type)
    if ae_type == "none":
        return None
    acfg = cfg.models.for_type(ae_type)
    ckpt = acfg.checkpoint or ae_type
    if not ckpt.endswith(".pth"):
        raise NotImplementedError(
            f"models.{ae_type}.checkpoint={ckpt!r}: reading the JAX "
            "package's Orbax checkpoints is ROADMAP queue 1 item 11; point "
            "it at a reference-keyed .pth"
        )
    path = ckpt if os.path.isabs(ckpt) else os.path.join(
        cfg.paths.checkpoints_dir, ckpt
    )
    if not os.path.isfile(path):
        raise FileNotFoundError(f"autoencoder checkpoint not found: {path}")
    model = build_autoencoder(ae_type, acfg)
    model.load_state_dict(load_autoencoder_pth(path, ae_type))
    return model.to(resolve_device(device)).eval()


def default_encoder(cfg: Config, corpus: Sequence[str],
                    device="cuda") -> SentenceEncoder:
    """The sentence encoder: the tokenizer resolved as the JAX package
    resolves it (vocab.txt > tokenizer.json > trained on the corpus), and
    weights from ``encoder.weights_path`` (a ``MiniLMEncoder`` state dict
    in a .pt/.pth file) or, when no file is there, a seeded init."""
    tokenizer = resolve_tokenizer(
        cfg.paths.data_dir, cfg.encoder.vocab_size, corpus
    )
    weights = cfg.encoder.weights_path or os.path.join(
        cfg.paths.checkpoints_dir, "encoder.msgpack"
    )
    state_dict = None
    if os.path.exists(weights):
        if not weights.endswith((".pt", ".pth")):
            raise NotImplementedError(
                f"encoder weights {weights}: reading the JAX package's "
                "msgpack is ROADMAP queue 1 item 11; convert the params with "
                "models.convert.minilm_state_dict_from_jax, torch.save the "
                "result and set encoder.weights_path=<file>.pt"
            )
        state_dict = torch.load(weights, map_location="cpu", weights_only=True)
        log.info("loaded encoder weights: %s", weights)
    return SentenceEncoder(tokenizer, cfg.encoder, state_dict=state_dict,
                           device=device)


def aggregate_docs(scores, idx, doc_ids, k: int, device):
    """The search's chunk candidates (host ``scores`` and ``idx`` [Q, C])
    folded to docs by MaxSim on ``device``, as the JAX package runs it on
    its device: empty slots (id -1) map to the sentinel doc -1 with score
    NEG_INF, and sentinel and duplicate-doc slots are dropped after.
    Returns (doc scores [Q, k] numpy, retrieved doc ids per query)."""
    chunk_doc = np.where(
        idx >= 0, np.asarray(doc_ids, dtype=np.int64)[np.maximum(idx, 0)], -1)
    scores = np.where(idx >= 0, scores, -3.4e38).astype(np.float32)
    doc_scores, doc_top = maxsim_aggregate(
        torch.from_numpy(scores).to(device),
        torch.from_numpy(chunk_doc).to(device), k=k)
    doc_scores = doc_scores.cpu().numpy()
    doc_top = doc_top.cpu().numpy()
    keep = (doc_scores > -1e37) & (doc_top >= 0)
    return doc_scores, [row[m].tolist() for row, m in zip(doc_top, keep)]


class PipelineRunner:
    def __init__(
        self,
        cfg: Config,
        ae_type: str = "none",
        generate: bool = False,
        compressor: EmbeddingCompressor | None = None,
        device: str | torch.device = "cuda",
    ):
        if generate:
            raise NotImplementedError(
                "generation is ROADMAP queue 1 item 24 (auxiliaries)"
            )
        if cfg.chunking.enabled:
            raise NotImplementedError(
                "chunking is not ported yet (ROADMAP queue 1, slice E)"
            )
        if cfg.retrieval.rerank != "none":
            raise NotImplementedError(
                "retrieval.rerank is ROADMAP queue 1 item 19"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ae_type = canonical_ae_type(ae_type)
        self._compressor = compressor
        self._autoencoder = load_autoencoder(cfg, self.ae_type, self.device)

    def _ensure_compressor(self, corpus: Sequence[str]) -> EmbeddingCompressor:
        if self._compressor is None:
            encoder = default_encoder(self.cfg, corpus, device=self.device)
            self._compressor = EmbeddingCompressor(
                encoder,
                autoencoder=self._autoencoder,
                batch_size=self.cfg.encoder.batch_size,
            )
        elif self._compressor.autoencoder is None and self._autoencoder:
            self._compressor.autoencoder = self._autoencoder
        return self._compressor

    def process(
        self,
        queries: Sequence[str],
        corpus: Sequence[str],
        relevant_ids: Sequence[int],
    ) -> dict[str, Any]:
        cfg = self.cfg
        compressor = self._ensure_compressor(corpus)
        timings: dict[str, float] = {}
        texts = list(corpus)
        doc_ids = list(range(len(corpus)))

        t0 = time.perf_counter()
        corpus_emb = compressor.encode_text(texts)
        force_completion(corpus_emb)
        timings["encode_corpus_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        query_emb = compressor.encode_text(queries)
        force_completion(query_emb)
        timings["encode_queries_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        retriever = build_retriever(
            corpus_emb,
            texts,
            doc_ids,
            cfg.retrieval,
            device=self.device,
        )
        timings["build_index_s"] = time.perf_counter() - t0

        top_k = cfg.retrieval.top_k
        candidate_k = min(top_k, len(texts))
        t0 = time.perf_counter()
        scores, idx = retriever.search(query_emb, candidate_k)
        timings["search_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        doc_scores, retrieved_doc_ids = aggregate_docs(
            scores, idx, doc_ids, min(top_k, candidate_k), self.device)
        timings["aggregate_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        metrics = evaluate_retrieval(
            retrieved_doc_ids,
            list(relevant_ids),
            metrics=cfg.evaluation.retrieval_metrics,
        )
        timings["evaluate_s"] = time.perf_counter() - t0

        return {
            "ae_type": self.ae_type,
            "device": str(self.device),
            "dim_in": compressor.input_dim,
            "dim_out": compressor.output_dim,
            "n_corpus": len(corpus),
            "n_chunks": len(texts),
            "n_queries": len(queries),
            "top_k": top_k,
            "candidate_k": candidate_k,
            "retrieval_metrics": metrics,
            "retriever_stats": retriever.get_stats(),
            "timings": timings,
            "retrieved_doc_ids": retrieved_doc_ids,
            "doc_scores": doc_scores,
        }

    def print_run_card(self, result: dict[str, Any]) -> None:
        """The run's metrics and timings as log lines."""
        log.info(
            "ae_type=%s device=%s corpus=%d queries=%d compression %d->%d",
            result["ae_type"], result["device"], result["n_corpus"],
            result["n_queries"], result["dim_in"], result["dim_out"],
        )
        for name, stats in result["retrieval_metrics"].items():
            log.info("%s: %.4f ± %.4f", name, stats["mean"], stats["std"])
        for name, sec in result["timings"].items():
            log.info("%s: %.2f ms", name, sec * 1e3)
