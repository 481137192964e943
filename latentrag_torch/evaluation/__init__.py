from .autoencoder_metrics import (
    compression_ratio,
    reconstruction_mse,
    summarise_sizes,
)
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
from .visualization import (
    plot_positive_vs_negative_distances,
    positive_ranks,
    recall_at_k,
    visualize_compressed_vs_original,
)

__all__ = [
    "compression_ratio",
    "reconstruction_mse",
    "summarise_sizes",
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
    "plot_positive_vs_negative_distances",
    "positive_ranks",
    "recall_at_k",
    "visualize_compressed_vs_original",
]
