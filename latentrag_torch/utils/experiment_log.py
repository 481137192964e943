"""Experiment tracking: append-only CSV rows + per-config baseline speedups.

A stdlib copy of the JAX package's ``utils/experiment_log.py``: the same
columns and baseline files, so rows from both packages share one CSV.

Parity with the reference's ``utils/benchmark_utils.py:15-118``: one row per
pipeline run with quality metrics, latency percentiles, QPS and compression
ratio; a per-configuration baseline JSON written on uncompressed
(``ae_type=none``) runs and consumed by compressed runs to add speedup/delta
columns. Fixes the reference defect where ``dim_in`` fell back to the latent
dim, making ``compression_ratio`` read 1.0 (SURVEY §2.2).
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Any, Mapping

CSV_COLUMNS = [
    "timestamp",
    "tag",
    "dataset",
    "embedder",
    "ae_type",
    "latent_dim",
    "compression_ratio",
    "retriever",
    "index_type",
    "metric_space",
    "top_k",
    "candidate_k",
    "n_corpus",
    "recall",
    "mrr",
    "ndcg",
    "bleu",
    "bleu_ci_low",
    "bleu_ci_high",
    "rouge_l",
    "rouge_l_ci_low",
    "rouge_l_ci_high",
    "meteor",
    "meteor_ci_low",
    "meteor_ci_high",
    "build_time_s",
    "search_time_s",
    "p50_ms",
    "p95_ms",
    "qps",
    "speedup_p50",
    "speedup_p95",
    "delta_ms_p50",
    "delta_ms_p95",
]


def _baseline_key(row: Mapping[str, Any]) -> str:
    parts = [
        str(row.get("dataset", "")),
        str(row.get("retriever", "")),
        str(row.get("index_type", "")),
        str(row.get("top_k", "")),
        str(row.get("n_corpus", "")),
    ]
    return "_".join(p.replace("/", "-") for p in parts)


def _baseline_path(logs_dir: str, key: str) -> str:
    return os.path.join(logs_dir, "benchmarks", f"baseline_{key}.json")


def build_metrics_row(
    *,
    tag: str,
    dataset: str,
    embedder: str,
    ae_type: str,
    dim_in: int,
    dim_out: int,
    retriever: str,
    index_type: str,
    metric_space: str,
    top_k: int,
    candidate_k: int,
    n_corpus: int,
    retrieval_metrics: Mapping[str, Mapping[str, float]],
    retriever_stats: Mapping[str, Any],
    logs_dir: str = "./logs",
    generation_metrics: Mapping[str, Mapping[str, float]] | None = None,
) -> dict[str, Any]:
    """Assemble one experiment CSV row; read/write baseline speedup JSONs.

    ``retrieval_metrics`` is ``{metric_name: {"mean": .., "std": ..}}`` as
    produced by ``evaluation.retrieval_metrics.evaluate_retrieval``;
    ``generation_metrics`` is ``{metric: {"mean", "ci_low", "ci_high"}}``
    from ``evaluate_generation_bootstrap`` (columns stay empty when a run
    skips generation).
    """

    def metric_mean(prefix: str) -> float | None:
        for name, stats in retrieval_metrics.items():
            if name.lower().startswith(prefix):
                return float(stats["mean"])
        return None

    p50 = retriever_stats.get("p50")
    p95 = retriever_stats.get("p95")
    qps = (1000.0 / p50) if p50 else None
    row: dict[str, Any] = {
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
        "tag": tag,
        "dataset": dataset,
        "embedder": embedder,
        "ae_type": ae_type,
        "latent_dim": dim_out,
        "compression_ratio": (dim_in / dim_out) if dim_out else None,
        "retriever": retriever,
        "index_type": index_type,
        "metric_space": metric_space,
        "top_k": top_k,
        "candidate_k": candidate_k,
        "n_corpus": n_corpus,
        "recall": metric_mean("recall"),
        "mrr": metric_mean("mrr"),
        "ndcg": metric_mean("ndcg"),
        "build_time_s": retriever_stats.get("build_time_s"),
        "search_time_s": retriever_stats.get("search_time_s"),
        "p50_ms": p50,
        "p95_ms": p95,
        "qps": qps,
        "speedup_p50": None,
        "speedup_p95": None,
        "delta_ms_p50": None,
        "delta_ms_p95": None,
    }
    for name, stats in (generation_metrics or {}).items():
        col = name.strip().lower().replace("-", "_")
        if col in ("bleu", "rouge_l", "rougel", "meteor"):
            col = "rouge_l" if col == "rougel" else col
            row[col] = float(stats["mean"])
            row[f"{col}_ci_low"] = float(stats["ci_low"])
            row[f"{col}_ci_high"] = float(stats["ci_high"])

    key = _baseline_key(row)
    path = _baseline_path(logs_dir, key)
    if ae_type in ("none", "", None):
        if p50 is not None:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                json.dump({"p50_ms": p50, "p95_ms": p95}, f)
    elif os.path.exists(path):
        with open(path) as f:
            base = json.load(f)
        if p50 and base.get("p50_ms"):
            row["speedup_p50"] = base["p50_ms"] / p50
            row["delta_ms_p50"] = p50 - base["p50_ms"]
        if p95 and base.get("p95_ms"):
            row["speedup_p95"] = base["p95_ms"] / p95
            row["delta_ms_p95"] = p95 - base["p95_ms"]
    return row


def append_csv_row(row: Mapping[str, Any], csv_path: str) -> None:
    """Append one row, writing the header on first use (append-only log).

    A pre-existing log whose header predates the current schema is migrated
    in place first (rows re-keyed by the OLD header, new columns empty) —
    appending new-order values under an old header would silently misalign
    every column from the first changed position on.
    """
    os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
    exists = os.path.exists(csv_path)
    if exists:
        with open(csv_path, newline="") as f:
            reader = csv.reader(f)
            old_header = next(reader, None)
            if old_header is not None and old_header != CSV_COLUMNS:
                old_rows = [
                    dict(zip(old_header, r)) for r in reader if r
                ]
                with open(csv_path, "w", newline="") as g:
                    w = csv.DictWriter(
                        g, fieldnames=CSV_COLUMNS, extrasaction="ignore"
                    )
                    w.writeheader()
                    for r in old_rows:
                        w.writerow({k: r.get(k) for k in CSV_COLUMNS})
    with open(csv_path, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=CSV_COLUMNS, extrasaction="ignore")
        if not exists:
            writer.writeheader()
        writer.writerow({k: row.get(k) for k in CSV_COLUMNS})
