"""latentrag_torch pipeline CLI: the port of the JAX package's ``main.py``.

Usage:
  python -m latentrag_torch.main --ae_type vae --device cuda \
      --set data.dataset=synthetic models.vae.checkpoint=/path/vae.pth
  python -m latentrag_torch.main --generate \
      --set generation.provider=extractive
  python -m latentrag_torch.main --benchmark bm25 sbert dpr
  python -m latentrag_torch.main --ae_type vae --profile /tmp/trace
  python -m latentrag_torch.main --config configs/msmarco_v5e8.yaml \
      --ae_type dae --set data.dataset=msmarco:/path/dev.jsonl

Each AE variant runs the pipeline once, logs its run card and appends one
row to ``<logs_dir>/benchmarks/experiments.csv`` (the JAX package's CSV
schema; with ``--generate`` its generation columns too). ``--benchmark
[SYSTEM ...]`` runs the multi-system harness instead (default systems
``bm25 sbert``). ``data.dataset=msmarco:<jsonl>`` evaluates each query
against every passage of the file, distractors included (no gold
answers). ``--profile DIR`` writes a ``torch.profiler`` trace of
each pipeline run into DIR. ``--device`` defaults to ``cuda`` and never
falls back to the CPU on its own; ``--device cpu`` runs the plain PyTorch
path.
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
from .utils.device import resolve_device
from .utils.experiment_log import append_csv_row, build_metrics_row

AE_CHOICES = ("none", "vae", "dae", "cae", "contrastive", "all")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="latentrag_torch RAG pipeline")
    p.add_argument("--config", default=None, help="YAML config path")
    p.add_argument("--ae_type", default="none", choices=AE_CHOICES)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--generate", action="store_true",
                   help="generate an answer for each query (and score the "
                        "answers against the gold ones)")
    p.add_argument("--benchmark", nargs="*", metavar="SYSTEM",
                   help="run the multi-system benchmark instead of the "
                        "pipeline (default systems: bm25 sbert)")
    p.add_argument("--tag", default="run", help="experiment CSV tag")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the pipeline run "
                        "into DIR (TensorBoard / chrome://tracing)")
    p.add_argument("--set", nargs="*", default=[], metavar="a.b=v",
                   help="config overrides")
    return p.parse_args(argv)


def main(argv=None, results: list | None = None) -> int:
    """Run the pipeline (or, with ``--benchmark``, the harness); each
    variant's result dict (the harness's result) is appended to
    ``results`` when the caller passes a list."""
    args = parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.set)
    loggers = init_logger(cfg.logging)
    set_seed(cfg.training.seed, cfg.training.deterministic)

    loggers.main.info("loading dataset %r", cfg.data.dataset)
    if cfg.data.dataset.startswith("msmarco"):
        # 'msmarco:<local.jsonl>': the corpus keeps every passage
        # (positives and distractors), which the example -> dedup shape of
        # load_evaluation_data cannot hold
        from .data.msmarco import load_msmarco_eval

        _, _, src = cfg.data.dataset.partition(":")
        queries, corpus, relevant = load_msmarco_eval(
            max_queries=cfg.data.max_samples, source=src or None
        )
        gold = None
    else:
        queries, corpus, relevant, gold = load_evaluation_data(
            get_examples(cfg), with_answers=True)
    loggers.main.info("|queries|=%d |corpus|=%d", len(queries), len(corpus))

    if args.benchmark is not None:
        from .evaluation import run_benchmark

        systems = tuple(args.benchmark) or ("bm25", "sbert")
        out = run_benchmark(cfg, queries, corpus, relevant, systems=systems,
                            generate=args.generate, gold_answers=gold,
                            device=args.device)
        if results is not None:
            results.append(out)
        for system, res in out.items():
            if system.startswith("_"):
                loggers.main.info("%s: %s", system, res)
            elif "metrics" in res:
                loggers.main.info("%s: %s", system, {
                    m: round(v["mean"], 4) for m, v in res["metrics"].items()
                })
            else:
                loggers.main.info("%s: ERROR %s", system, res.get("error"))
        return 0

    mesh = None
    if cfg.retrieval.shard_corpus:
        from .parallel import make_mesh

        dev = resolve_device(args.device)
        # every visible card (a 1-device mesh is dropped downstream)
        mesh = make_mesh(devices=None if dev.type == "cuda" else [dev])
        loggers.main.info("sharding corpus over %d devices", mesh.size)

    variants = (
        ["vae", "dae", "cae"]
        if args.ae_type == "all"
        else [canonical_ae_type(args.ae_type)]
    )
    for ae in variants:
        try:
            runner = PipelineRunner(cfg, ae_type=ae, generate=args.generate,
                                    device=args.device, mesh=mesh)
        except FileNotFoundError as e:
            loggers.main.error("%s", e)
            return 2
        answers = gold if args.generate else None
        if args.profile:
            from .utils.profiling import trace

            with trace(args.profile):
                result = runner.process(queries, corpus, relevant,
                                        gold_answers=answers)
        else:
            result = runner.process(queries, corpus, relevant,
                                    gold_answers=answers)
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
            generation_metrics=result.get("generation_metrics"),
        )
        append_csv_row(
            row, f"{cfg.paths.logs_dir}/benchmarks/experiments.csv"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
