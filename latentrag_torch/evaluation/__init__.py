from .retrieval_metrics import evaluate_retrieval, hit_matrix, parse_metric

__all__ = ["evaluate_retrieval", "hit_matrix", "parse_metric"]
