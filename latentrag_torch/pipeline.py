"""End-to-end retrieval pipeline: (chunk) -> encode -> (compress) -> index
-> search -> (rerank) -> MaxSim -> evaluate.

The port of the JAX package's ``pipeline.py`` (``PipelineRunner.process``),
on a device chosen by the caller (default CUDA; the CPU only when asked):

* ``chunking.enabled`` splits each document into token windows on the
  host (``data/chunking.py``, sliding or semantic); chunk texts are
  indexed and each carries its doc id;
* corpus and queries encode on the device and stay there into the index
  build and the one batched search (the C++ ANN tiers, ``hnsw`` and
  ``ivfpq``, copy them to the host there);
* ``candidate_k = top_k``, x3 with chunking, widened to
  ``retrieval.rerank_candidates`` (0 = 4 x top_k) with a reranker, and
  clipped to the rows;
* ``retrieval.rerank=cross`` rescores the candidates with the
  cross-encoder on the device (``retrieval/reranker.py``) before MaxSim;
* empty candidate slots (id -1) map to a sentinel doc whose score is
  forced to NEG_INF before MaxSim, and sentinel docs are dropped after;
* MaxSim folds chunks to docs on the device, as the JAX package runs it
  there;
* with ``generate=True`` each query's answer comes from its retrieved
  chunks (at most ``retrieval.max_chunks_per_doc`` of each top doc) through
  ``RAGGenerator`` (``generation.provider=extractive`` answers offline),
  and with gold answers and at least
  ``evaluation.min_pairs_for_bootstrap`` pairs the generation metrics get
  bootstrap CIs; both on the host, as in the JAX package.
"""

from __future__ import annotations

import asyncio
import logging
import os
import shutil
import time
from typing import Any, Sequence

import numpy as np
import torch

from .data.chunking import build_inference_corpus
from .data.tokenizer import resolve_tokenizer
from .evaluation import evaluate_retrieval
from .generation import GeneratorSettings, LLMSettings, RAGGenerator
from .models import build_autoencoder, load_autoencoder_pth
from .models.convert import minilm_state_dict_from_jax
from .models.encoder import SentenceEncoder
from .models.encoder.convert import convert_hf_bert_to_params, save_params
from .models.encoder.msgpack_io import load_msgpack
from .ops import maxsim_aggregate
from .retrieval import EmbeddingCompressor, build_retriever
from .utils import Config, canonical_ae_type, force_completion, resolve_device

log = logging.getLogger("latentrag_torch.main")


def autoencoder_checkpoint_path(cfg: Config, ae_type: str) -> str:
    """The ``.pth`` of ``ae_type``: ``models.<ae>.checkpoint`` (default the
    AE's name; absolute, or under ``paths.checkpoints_dir``), with
    ``.pth`` added when the name lacks it. The port's trainer writes it
    there and ``load_autoencoder`` reads it."""
    ckpt = cfg.models.for_type(ae_type).checkpoint or ae_type
    if not ckpt.endswith(".pth"):
        ckpt += ".pth"
    return os.path.join(cfg.paths.checkpoints_dir, ckpt)


ORBAX_SCRIPT = "scripts/orbax_ae_to_pth.py"


def load_autoencoder(cfg: Config, ae_type: str, device="cuda"):
    """The AE module for ``ae_type`` with its trained weights, on
    ``device``, from ``autoencoder_checkpoint_path``: a reference-keyed
    ``.pth``, as the port's trainer (``python -m
    latentrag_torch.training.train``) writes it, or as
    ``scripts/orbax_ae_to_pth.py`` converts an AE that the JAX package
    trained. An Orbax checkpoint directory (the JAX trainer's) with no
    ``.pth`` beside it raises NotImplementedError with the command that
    converts it; no checkpoint at all raises FileNotFoundError."""
    ae_type = canonical_ae_type(ae_type)
    if ae_type == "none":
        return None
    acfg = cfg.models.for_type(ae_type)
    path = autoencoder_checkpoint_path(cfg, ae_type)
    if not os.path.isfile(path):
        orbax_dir = path[: -len(".pth")]
        if os.path.isfile(os.path.join(orbax_dir, "_CHECKPOINT_METADATA")):
            raise NotImplementedError(
                f"{orbax_dir} is an Orbax checkpoint of the JAX package's "
                "trainer (OCDBT, read through tensorstore), which the port "
                "does not read; where the JAX package is installed, run "
                f"`python {ORBAX_SCRIPT} --checkpoint {orbax_dir} "
                f"--ae_type {ae_type}` to write {path}"
            )
        raise FileNotFoundError(
            f"no checkpoint for ae_type={ae_type!r} at {path}; train it "
            "with `python -m latentrag_torch.training.train --ae_type "
            f"{ae_type}`, or convert the JAX package's Orbax checkpoint "
            f"with {ORBAX_SCRIPT}"
        )
    model = build_autoencoder(ae_type, acfg)
    model.load_state_dict(load_autoencoder_pth(path, ae_type))
    return model.to(resolve_device(device)).eval()


def _hf_checkpoint_usable(ecfg) -> bool:
    """Whether ``encoder.name`` is a local HF checkpoint directory (with a
    ``config.json``). The hub forms need the network, which the port never
    uses: ``encoder.hub_fallback=true`` with another name raises."""
    name = ecfg.name
    if os.path.isdir(name) and os.path.exists(
        os.path.join(name, "config.json")
    ):
        return True
    if ecfg.hub_fallback:
        raise ValueError(
            f"encoder.hub_fallback=true asks for {name!r} from the HF hub, "
            "and the port never uses the network; download the checkpoint "
            "and set encoder.name to its local directory"
        )
    return False


def _convert_hf_encoder(cfg: Config, weights: str, vocab_path: str) -> None:
    """Convert the local HF checkpoint ``encoder.name`` into ``weights``
    (msgpack, or a state dict where the name ends in .pt/.pth) and copy
    its vocab.txt to ``vocab_path`` unless one is there. A failed
    conversion logs the JAX package's warning; the seeded init serves."""
    try:
        hf_params, vocab_file = convert_hf_bert_to_params(cfg.encoder.name)
        if weights.endswith((".pt", ".pth")):
            os.makedirs(os.path.dirname(weights) or ".", exist_ok=True)
            torch.save(minilm_state_dict_from_jax(hf_params), weights)
        else:
            save_params(hf_params, weights)
        if vocab_file and not os.path.exists(vocab_path):
            os.makedirs(cfg.paths.data_dir, exist_ok=True)
            shutil.copyfile(vocab_file, vocab_path)
        log.info("converted HF checkpoint %s -> %s", cfg.encoder.name,
                 weights)
    except Exception as e:
        log.warning(
            "HF checkpoint %r unusable (%s); falling back to the "
            "self-init encoder", cfg.encoder.name, e,
        )


def default_encoder(cfg: Config, corpus: Sequence[str],
                    device="cuda", mesh=None) -> SentenceEncoder:
    """The sentence encoder: the tokenizer resolved as the JAX package
    resolves it (vocab.txt > tokenizer.json > trained on the corpus), and
    weights from ``encoder.weights_path`` or, unset,
    ``<checkpoints_dir>/encoder.msgpack``: a ``MiniLMEncoder`` state dict
    in a .pt/.pth file, or the JAX package's Flax params in msgpack
    (``models.encoder.msgpack_io``). When no file is there and
    ``encoder.name`` is a local HF checkpoint directory, it is converted
    now and persisted (the weights file, and its vocab.txt into
    ``paths.data_dir``), as the JAX package does; else a seeded init.
    ``mesh`` makes the encode data-parallel over its shards."""
    vocab_path = os.path.join(cfg.paths.data_dir, "vocab.txt")
    weights = cfg.encoder.weights_path or os.path.join(
        cfg.paths.checkpoints_dir, "encoder.msgpack"
    )
    if not os.path.exists(weights) and _hf_checkpoint_usable(cfg.encoder):
        _convert_hf_encoder(cfg, weights, vocab_path)
    tokenizer = resolve_tokenizer(
        cfg.paths.data_dir, cfg.encoder.vocab_size, corpus
    )
    state_dict = None
    if os.path.exists(weights):
        if weights.endswith((".pt", ".pth")):
            state_dict = torch.load(weights, map_location="cpu",
                                    weights_only=True)
        else:
            state_dict = minilm_state_dict_from_jax(load_msgpack(weights))
        log.info("loaded encoder weights: %s", weights)
    return SentenceEncoder(tokenizer, cfg.encoder, state_dict=state_dict,
                           device=device, mesh=mesh)


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
        reranker=None,
        generator: RAGGenerator | None = None,
        mesh=None,
    ):
        """``mesh`` (a ``parallel.Mesh``) encodes data-parallel over it and,
        under ``retrieval.shard_corpus``, shards the dense store over it,
        as the JAX package's runner does."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.ae_type = canonical_ae_type(ae_type)
        self.generate = generate
        self._compressor = compressor
        self._reranker = reranker
        self._generator = generator
        self._autoencoder = load_autoencoder(cfg, self.ae_type, self.device)

    def _ensure_compressor(self, corpus: Sequence[str]) -> EmbeddingCompressor:
        if self._compressor is None:
            encoder = default_encoder(self.cfg, corpus, device=self.device,
                                      mesh=self.mesh)
            self._compressor = EmbeddingCompressor(
                encoder,
                autoencoder=self._autoencoder,
                batch_size=self.cfg.encoder.batch_size,
            )
        elif self._compressor.autoencoder is None and self._autoencoder:
            self._compressor.autoencoder = self._autoencoder
        return self._compressor

    def _ensure_reranker(self):
        """The configured second stage, or None: built from the trained
        checkpoint with the compressor's tokenizer, on the runner's
        device; an injected one (tests, a booted server) wins. Call after
        ``_ensure_compressor``."""
        rerank = self.cfg.retrieval.rerank
        if rerank == "none":
            return None
        if self._reranker is None:
            if rerank != "cross":
                raise ValueError(f"unknown retrieval.rerank={rerank!r}; use "
                                 "'none' or 'cross'")
            from .retrieval.reranker import build_reranker

            self._reranker = build_reranker(
                self.cfg, self._compressor.encoder.tokenizer,
                device=self.device)
        return self._reranker

    def _ensure_generator(self) -> RAGGenerator:
        """The configured generator; an injected one wins."""
        if self._generator is None:
            g = self.cfg.generation
            self._generator = RAGGenerator(
                GeneratorSettings(
                    llm=LLMSettings(
                        provider=g.provider,
                        model=g.model,
                        temperature=g.temperature,
                        max_tokens=g.max_tokens,
                    ),
                    system_prompt_path=g.system_prompt_path,
                    max_context_tokens=g.max_context_tokens,
                )
            )
        return self._generator

    def process(
        self,
        queries: Sequence[str],
        corpus: Sequence[str],
        relevant_ids: Sequence[int],
        gold_answers: Sequence[str] | None = None,
    ) -> dict[str, Any]:
        cfg = self.cfg
        compressor = self._ensure_compressor(corpus)
        timings: dict[str, float] = {}
        chunking = cfg.chunking
        if chunking.enabled:
            t0 = time.perf_counter()
            records = build_inference_corpus(
                corpus, None, compressor.encoder.tokenizer,
                mode=chunking.mode, max_tokens=chunking.max_tokens,
                stride=chunking.stride, min_tokens=chunking.min_tokens,
            )
            texts = [r.text for r in records]
            doc_ids = [r.doc_id for r in records]
            timings["chunking_s"] = time.perf_counter() - t0
        else:
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
        # the run's provenance, as the JAX package records it: a store at
        # retrieval.index_path from a run with the same provenance and
        # corpus is loaded, and the build and its self-check are skipped
        retriever = build_retriever(
            corpus_emb,
            texts,
            doc_ids,
            cfg.retrieval,
            device=self.device,
            mesh=self.mesh,
            embedding_model=cfg.encoder.name,
            ae_type=self.ae_type if self.ae_type != "none" else None,
            latent_dim=compressor.output_dim,
            chunking={
                "enabled": chunking.enabled,
                "mode": chunking.mode,
                "max_tokens": chunking.max_tokens if chunking.enabled
                else None,
                "stride": chunking.stride if chunking.enabled else None,
                "min_tokens": chunking.min_tokens if chunking.enabled
                else None,
            },
        )
        timings["build_index_s"] = time.perf_counter() - t0

        top_k = cfg.retrieval.top_k
        candidate_k = top_k * 3 if chunking.enabled else top_k
        reranker = self._ensure_reranker()
        if reranker is not None:
            # rescoring only top_k candidates could merely reorder them
            candidate_k = max(candidate_k,
                              cfg.retrieval.rerank_candidates or 4 * top_k)
        candidate_k = min(candidate_k, len(texts))
        t0 = time.perf_counter()
        scores, idx = retriever.search(query_emb, candidate_k)
        timings["search_s"] = time.perf_counter() - t0
        if reranker is not None:
            # the logits replace stage 1's scores; empty slots stay NEG_INF
            t0 = time.perf_counter()
            scores = reranker.rescore_candidates(queries, idx, texts)
            timings["rerank_s"] = time.perf_counter() - t0

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

        result: dict[str, Any] = {
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
        if self.generate:
            # generation, then its metrics when gold answers exist and the
            # sample is large enough for stable CIs
            t0 = time.perf_counter()
            result["answers"] = self._run_generation(
                queries, texts, doc_ids, idx, retrieved_doc_ids)
            timings["generate_s"] = time.perf_counter() - t0
            ecfg = cfg.evaluation
            n = len(result["answers"])
            if gold_answers is None:
                log.info("no gold answers supplied; skipping generation eval")
            elif n < ecfg.min_pairs_for_bootstrap:
                log.info("generation eval skipped: %d pairs < min %d for a "
                         "stable bootstrap", n, ecfg.min_pairs_for_bootstrap)
            else:
                from .evaluation import evaluate_generation_bootstrap

                t0 = time.perf_counter()
                result["generation_metrics"] = evaluate_generation_bootstrap(
                    result["answers"],
                    [str(a) for a in gold_answers],
                    metrics=ecfg.generation_metrics,
                    n_resamples=ecfg.bootstrap_samples,
                    alpha=ecfg.bootstrap_alpha,
                    min_pairs=ecfg.min_pairs_for_bootstrap,
                )
                timings["generation_eval_s"] = time.perf_counter() - t0
        return result

    def _run_generation(self, queries, texts, doc_ids, chunk_idx,
                        retrieved_doc_ids) -> list[str]:
        """Each query's context: its candidate chunks in search order that
        belong to one of its retrieved docs, at most
        ``retrieval.max_chunks_per_doc`` a doc (empty slots, id -1,
        skipped). The completions run through ``generate_batch_async`` at
        ``generation.concurrency`` (answers in query order); a generator
        without it (a duck-typed stand-in) answers one query at a time."""
        gen = self._ensure_generator()
        max_chunks = self.cfg.retrieval.max_chunks_per_doc
        docs_per_query: list[list[str]] = []
        for row, top in zip(chunk_idx, retrieved_doc_ids):
            top_docs = set(top)
            per_doc: dict[int, int] = {}
            chosen: list[str] = []
            for j in row:
                if j < 0:
                    continue
                did = doc_ids[j]
                if did not in top_docs or per_doc.get(did, 0) >= max_chunks:
                    continue
                per_doc[did] = per_doc.get(did, 0) + 1
                chosen.append(texts[j])
            docs_per_query.append(chosen)
        concurrency = max(1, self.cfg.generation.concurrency)
        if not hasattr(gen, "generate_batch_async"):
            concurrency = 1
        if concurrency == 1:
            return [gen.generate(q, d)
                    for q, d in zip(queries, docs_per_query)]
        return asyncio.run(gen.generate_batch_async(
            list(queries), docs_per_query, concurrency=concurrency))

    def print_run_card(self, result: dict[str, Any]) -> None:
        """The run's metrics and timings as log lines."""
        log.info(
            "ae_type=%s device=%s corpus=%d chunks=%d queries=%d "
            "candidate_k=%d compression %d->%d",
            result["ae_type"], result["device"], result["n_corpus"],
            result["n_chunks"], result["n_queries"], result["candidate_k"],
            result["dim_in"], result["dim_out"],
        )
        for name, stats in result["retrieval_metrics"].items():
            log.info("%s: %.4f ± %.4f", name, stats["mean"], stats["std"])
        for name, stats in result.get("generation_metrics", {}).items():
            log.info("%s: %.2f [%.2f, %.2f]", name, stats["mean"],
                     stats["ci_low"], stats["ci_high"])
        for name, sec in result["timings"].items():
            log.info("%s: %.2f ms", name, sec * 1e3)
