from .benchmark import run_benchmark
from .generation_metrics import (
    bootstrap_ci,
    corpus_bleu,
    evaluate_generation_bootstrap,
    mean_rouge_l,
    meteor_score,
    meteor_scores,
    paired_bootstrap_test,
    rouge_l_scores,
)
from .retrieval_metrics import evaluate_retrieval, hit_matrix, parse_metric

__all__ = [
    "run_benchmark",
    "bootstrap_ci",
    "corpus_bleu",
    "evaluate_generation_bootstrap",
    "mean_rouge_l",
    "meteor_score",
    "meteor_scores",
    "paired_bootstrap_test",
    "rouge_l_scores",
    "evaluate_retrieval",
    "hit_matrix",
    "parse_metric",
]
