"""latentrag_torch pipeline CLI: the port of the JAX package's ``main.py``.

Usage:
  python -m latentrag_torch.main --ae_type vae --device cuda \
      --set data.dataset=synthetic models.vae.checkpoint=/path/vae.pth

Each AE variant runs the pipeline once, logs its run card and appends one
row to ``<logs_dir>/benchmarks/experiments.csv`` (the JAX package's CSV
schema). ``--device`` defaults to ``cuda`` and never falls back to the
CPU on its own; ``--device cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import sys

from .data import get_examples, load_evaluation_data
from .pipeline import PipelineRunner
from .utils import (
    apply_overrides,
    canonical_ae_type,
    init_logger,
    load_config,
    set_seed,
)
from .utils.experiment_log import append_csv_row, build_metrics_row

AE_CHOICES = ("none", "vae", "dae", "cae", "contrastive", "all")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="latentrag_torch RAG pipeline")
    p.add_argument("--config", default=None, help="YAML config path")
    p.add_argument("--ae_type", default="none", choices=AE_CHOICES)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--tag", default="run", help="experiment CSV tag")
    p.add_argument("--set", nargs="*", default=[], metavar="a.b=v",
                   help="config overrides")
    return p.parse_args(argv)


def main(argv=None, results: list | None = None) -> int:
    """Run the pipeline; each variant's result dict is appended to
    ``results`` when the caller passes a list."""
    args = parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.set)
    loggers = init_logger(cfg.logging)
    set_seed(cfg.training.seed, cfg.training.deterministic)

    loggers.main.info("loading dataset %r", cfg.data.dataset)
    examples = get_examples(cfg)
    queries, corpus, relevant = load_evaluation_data(examples)
    loggers.main.info("|queries|=%d |corpus|=%d", len(queries), len(corpus))

    variants = (
        ["vae", "dae", "cae"]
        if args.ae_type == "all"
        else [canonical_ae_type(args.ae_type)]
    )
    for ae in variants:
        try:
            runner = PipelineRunner(cfg, ae_type=ae, device=args.device)
        except FileNotFoundError as e:
            loggers.main.error("%s", e)
            return 2
        result = runner.process(queries, corpus, relevant)
        runner.print_run_card(result)
        if results is not None:
            results.append(result)
        row = build_metrics_row(
            tag=args.tag,
            dataset=cfg.data.dataset,
            embedder=cfg.encoder.name,
            ae_type=ae,
            dim_in=result["dim_in"],
            dim_out=result["dim_out"],
            retriever=cfg.retrieval.backend,
            index_type=cfg.retrieval.kernel,
            metric_space=cfg.retrieval.metric,
            top_k=result["top_k"],
            candidate_k=result["candidate_k"],
            n_corpus=result["n_corpus"],
            retrieval_metrics=result["retrieval_metrics"],
            retriever_stats=result["retriever_stats"],
            logs_dir=cfg.paths.logs_dir,
        )
        append_csv_row(
            row, f"{cfg.paths.logs_dir}/benchmarks/experiments.csv"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
