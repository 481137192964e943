"""Device ops. The fused kernels' wrappers live in ``ops.fused_topk`` (the
module is not re-exported here, so ``ops.fused_topk`` names the module)."""

from .distances import (
    METRICS,
    estimate_covariance,
    l2_normalize,
    pairwise_scores,
    prepare_for_metric,
    whiten,
    whitening_factor,
)
from .topk import (
    NEG_INF,
    approx_topk,
    exact_topk,
    maxsim_aggregate,
    pack_row_mask,
    unpack_row_mask,
)

__all__ = [
    "METRICS",
    "estimate_covariance",
    "l2_normalize",
    "pairwise_scores",
    "prepare_for_metric",
    "whiten",
    "whitening_factor",
    "NEG_INF",
    "approx_topk",
    "exact_topk",
    "maxsim_aggregate",
    "pack_row_mask",
    "unpack_row_mask",
]
