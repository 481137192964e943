"""Multi-system retrieval benchmark harness.

The port of the JAX package's ``evaluation/benchmark.py``: each requested
system is built over the same (queries, corpus, relevant) triple,
evaluated with the shared metric stack, and compared pair by pair with
paired-bootstrap p-values.

Systems: ``bm25`` (sparse baseline, host numpy), ``sbert`` (dense, no
compression), ``vae`` / ``dae`` / ``cae`` (compressed latents), ``dpr``
(dual encoder, raw [CLS] dot products) and ``rerank`` (sbert stage 1 +
the trained cross-encoder stage 2). The dense systems and DPR run on
``device`` (the card unless the caller asks for the CPU). A system that
fails is reported as ``{"error": ...}`` and the others still run.
"""

from __future__ import annotations

import logging
from typing import Any, Sequence

from ..utils import Config
from .generation_metrics import paired_bootstrap_test
from .retrieval_metrics import evaluate_retrieval

log = logging.getLogger("latentrag_torch.eval")


class _MemoEncoder:
    """Delegating encoder wrapper that memoises ``encode_batch`` results,
    so identical text lists (the shared corpus and queries) encode once
    across the benchmarked systems."""

    def __init__(self, encoder):
        self._enc = encoder
        self._memo: dict = {}

    def __getattr__(self, name):
        return getattr(self._enc, name)

    def encode_batch(self, texts):
        # the tuple itself is the key: the dict resolves hash collisions by
        # equality, so two different text lists never alias
        key = tuple(texts)
        if key not in self._memo:
            self._memo[key] = self._enc.encode_batch(texts)
        return self._memo[key]


DENSE_SYSTEMS = {"sbert": "none", "vae": "vae", "dae": "dae", "cae": "cae"}


def run_benchmark(
    cfg: Config,
    queries: Sequence[str],
    corpus: Sequence[str],
    relevant: Sequence[int],
    systems: Sequence[str] = ("bm25", "sbert", "vae", "dae", "cae"),
    dpr_encoders: tuple | None = None,
    csv_path: str | None = None,
    tag: str = "benchmark",
    generate: bool = False,
    gold_answers: Sequence[str] | None = None,
    generator=None,
    device="cuda",
) -> dict[str, Any]:
    """Evaluate each system; returns {system: {metrics, stats}} plus
    ``_deltas``: for every metric and pair of systems ``{delta, p_value,
    significant_05}``. With ``generate=True`` and ``gold_answers`` the
    dense systems also answer, and ``_generation_deltas`` reports paired
    ROUGE-L significance between them (skipped, with a warning, where
    rouge-score is missing)."""
    # deferred imports: the pipeline imports this package's metrics
    from ..pipeline import PipelineRunner
    from ..retrieval import BM25Retriever

    results: dict[str, Any] = {}
    per_query: dict[str, dict] = {}  # system -> {metric: np.ndarray[Q]}
    answers: dict[str, list] = {}  # system -> generated answers
    shared_encoder = None
    for system in systems:
        try:
            if system == "bm25":
                r = BM25Retriever()
                r.build_index(corpus)
                _, idx = r.search(queries, cfg.retrieval.top_k)
                metrics, per_query[system] = evaluate_retrieval(
                    [row.tolist() for row in idx], list(relevant),
                    metrics=cfg.evaluation.retrieval_metrics,
                    return_per_query=True,
                )
                results[system] = {"metrics": metrics, "stats": {}}
            elif system == "dpr":
                from ..retrieval.dpr import DPRRetriever

                if dpr_encoders is None:
                    # trained tower checkpoints when present, else seeded
                    # towers (training/train_dpr.py)
                    from ..training.train_dpr import build_dpr_encoders

                    dpr_encoders = build_dpr_encoders(
                        cfg, corpus_texts=list(corpus), device=device
                    )
                r = DPRRetriever(*dpr_encoders)
                r.build_index(corpus)
                _, idx = r.search(queries, cfg.retrieval.top_k)
                metrics, per_query[system] = evaluate_retrieval(
                    [row.tolist() for row in idx], list(relevant),
                    metrics=cfg.evaluation.retrieval_metrics,
                    return_per_query=True,
                )
                results[system] = {"metrics": metrics, "stats": r.get_stats()}
            elif system in DENSE_SYSTEMS or system == "rerank":
                # one sentence encoder shared (and its encodings memoised)
                # across sbert / vae / dae / cae / rerank: their MiniLM
                # embeddings are identical, and the corpus encode is the
                # dominant cost
                if shared_encoder is None:
                    from ..pipeline import default_encoder

                    shared_encoder = _MemoEncoder(
                        default_encoder(cfg, corpus, device=device)
                    )
                from ..retrieval.embedder import EmbeddingCompressor

                sys_cfg = cfg
                if system == "rerank":
                    # sbert stage 1 + the trained cross-encoder stage 2; a
                    # missing reranker checkpoint surfaces through the
                    # per-system error handling below
                    import dataclasses as _dc

                    sys_cfg = _dc.replace(
                        cfg,
                        retrieval=_dc.replace(cfg.retrieval, rerank="cross"),
                    )
                runner = PipelineRunner(
                    sys_cfg,
                    ae_type=DENSE_SYSTEMS.get(system, "none"),
                    compressor=EmbeddingCompressor(
                        shared_encoder, batch_size=cfg.encoder.batch_size,
                    ),
                    generate=generate,
                    generator=generator,
                    device=device,
                )
                out = runner.process(
                    queries, corpus, relevant, gold_answers=gold_answers
                )
                results[system] = {
                    "metrics": out["retrieval_metrics"],
                    "stats": out["retriever_stats"],
                }
                if "generation_metrics" in out:
                    results[system]["generation_metrics"] = out[
                        "generation_metrics"
                    ]
                if "answers" in out:
                    answers[system] = out["answers"]
                # per-query vectors recomputed from the retrieved ids (the
                # pipeline reports aggregates only)
                _, per_query[system] = evaluate_retrieval(
                    out["retrieved_doc_ids"], list(relevant),
                    metrics=cfg.evaluation.retrieval_metrics,
                    return_per_query=True,
                )
            else:
                raise ValueError(f"unknown system {system!r}")
        except Exception as e:  # noqa: BLE001 - one system's failure
            log.warning("system %s failed: %s", system, e)
            results[system] = {"error": str(e)}

    if csv_path:
        from ..utils.experiment_log import append_csv_row, build_metrics_row

        for system, res in results.items():
            if "metrics" not in res:
                continue
            row = build_metrics_row(
                tag=f"{tag}:{system}",
                dataset=cfg.data.dataset,
                embedder=cfg.encoder.name,
                ae_type=DENSE_SYSTEMS.get(system, system),
                dim_in=cfg.encoder.hidden_dim,
                dim_out=cfg.models.for_type(system).latent_dim
                if system in ("vae", "dae", "cae")
                else cfg.encoder.hidden_dim,
                retriever=system,
                index_type=cfg.retrieval.kernel,
                metric_space=cfg.retrieval.metric,
                top_k=cfg.retrieval.top_k,
                candidate_k=cfg.retrieval.top_k,
                n_corpus=len(corpus),
                retrieval_metrics=res["metrics"],
                retriever_stats=res.get("stats", {}),
                logs_dir=cfg.paths.logs_dir,
            )
            append_csv_row(row, csv_path)

    # pairwise deltas + paired-bootstrap significance for every metric
    ok = {s: r for s, r in results.items() if "metrics" in r}
    if ok:
        n_resamples = cfg.evaluation.bootstrap_samples
        names = list(ok)
        all_deltas: dict[str, dict] = {}
        for metric in next(iter(ok.values()))["metrics"]:
            deltas = {}
            for i, a in enumerate(names):
                for b in names[i + 1 :]:
                    entry: dict[str, Any] = {
                        "delta": ok[a]["metrics"][metric]["mean"]
                        - ok[b]["metrics"][metric]["mean"]
                    }
                    va = per_query.get(a, {}).get(metric)
                    vb = per_query.get(b, {}).get(metric)
                    if (n_resamples > 0 and va is not None
                            and vb is not None and len(va) == len(vb)):
                        t = paired_bootstrap_test(
                            va, vb, n_resamples=n_resamples
                        )
                        entry["p_value"] = t["p_value"]
                        entry["significant_05"] = t["significant_05"]
                    deltas[f"{a}-{b}"] = entry
            all_deltas[metric] = deltas
        results["_deltas"] = all_deltas

    # generation significance: paired ROUGE-L between systems that answered
    if gold_answers is not None and len(answers) >= 2:
        from .generation_metrics import rouge_l_scores

        refs = [str(a) for a in gold_answers]
        try:
            vecs = {
                s: rouge_l_scores(hyp, refs)
                for s, hyp in answers.items()
                if len(hyp) == len(refs)
            }
        except RuntimeError as e:  # rouge-score missing: the retrieval
            # results must survive
            log.warning("generation significance skipped: %s", e)
            vecs = {}
        gnames = list(vecs)
        gen_deltas = {}
        for i, a in enumerate(gnames):
            for b in gnames[i + 1 :]:
                t = paired_bootstrap_test(vecs[a], vecs[b])
                gen_deltas[f"{a}-{b}"] = {
                    "delta": t["mean_diff"],
                    "p_value": t["p_value"],
                    "significant_05": t["significant_05"],
                }
        if gen_deltas:
            results["_generation_deltas"] = {"ROUGE-L": gen_deltas}
    return results
