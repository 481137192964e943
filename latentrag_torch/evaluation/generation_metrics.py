"""Generation quality: BLEU, ROUGE-L, METEOR, bootstrap CIs, paired
significance.

The port of the JAX package's ``evaluation/generation_metrics.py``, host
numpy with the same arithmetic: corpus BLEU (sacrebleu), mean ROUGE-L F1
x 100 (rouge-score), a self-contained METEOR, percentile-bootstrap
confidence intervals and a paired bootstrap test, resampled with
``np.random.default_rng(seed)`` so the same seed gives the same CIs and
p-values. sacrebleu and rouge-score are optional: a metric that needs a
missing one raises ``RuntimeError``; METEOR needs neither.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

try:
    import sacrebleu

    _HAVE_SACREBLEU = True
except ImportError:  # pragma: no cover
    _HAVE_SACREBLEU = False

try:
    from rouge_score import rouge_scorer

    _HAVE_ROUGE = True
except ImportError:  # pragma: no cover
    _HAVE_ROUGE = False


def corpus_bleu(hypotheses: Sequence[str], references: Sequence[str]) -> float:
    if not _HAVE_SACREBLEU:
        raise RuntimeError("sacrebleu not available")
    return float(
        sacrebleu.corpus_bleu(list(hypotheses), [list(references)]).score
    )


def rouge_l_scores(
    hypotheses: Sequence[str], references: Sequence[str]
) -> np.ndarray:
    """Per-pair ROUGE-L F1 × 100."""
    if not _HAVE_ROUGE:
        raise RuntimeError("rouge-score not available")
    scorer = rouge_scorer.RougeScorer(["rougeL"], use_stemmer=True)
    return np.array(
        [
            scorer.score(ref, hyp)["rougeL"].fmeasure * 100.0
            for hyp, ref in zip(hypotheses, references)
        ],
        dtype=np.float64,
    )


def mean_rouge_l(hypotheses: Sequence[str], references: Sequence[str]) -> float:
    return float(rouge_l_scores(hypotheses, references).mean())


def meteor_score(hypothesis: str, reference: str) -> float:
    """Self-contained METEOR (exact unigram matching variant) × 100.

    Standard formulation: harmonic F-mean weighted toward recall
    (alpha=0.9) with a fragmentation penalty gamma=0.5, beta=3 over
    contiguous match chunks.
    """
    hyp = hypothesis.lower().split()
    ref = reference.lower().split()
    if not hyp or not ref:
        return 0.0
    # greedy exact alignment preserving order information
    ref_used = [False] * len(ref)
    align: list[tuple[int, int]] = []  # (hyp_i, ref_j)
    for i, tok in enumerate(hyp):
        for j, rtok in enumerate(ref):
            if not ref_used[j] and rtok == tok:
                ref_used[j] = True
                align.append((i, j))
                break
    m = len(align)
    if m == 0:
        return 0.0
    precision = m / len(hyp)
    recall = m / len(ref)
    fmean = precision * recall / (0.9 * precision + 0.1 * recall)
    # chunks: maximal runs contiguous in BOTH hypothesis and reference
    chunks = 1
    for (i1, j1), (i2, j2) in zip(align, align[1:]):
        if not (i2 == i1 + 1 and j2 == j1 + 1):
            chunks += 1
    penalty = 0.5 * (chunks / m) ** 3
    return 100.0 * fmean * (1.0 - penalty)


def meteor_scores(
    hypotheses: Sequence[str], references: Sequence[str]
) -> np.ndarray:
    return np.array(
        [meteor_score(h, r) for h, r in zip(hypotheses, references)],
        dtype=np.float64,
    )


def bootstrap_ci(
    values: np.ndarray,
    n_resamples: int = 2000,
    alpha: float = 0.05,
    seed: int = 0,
) -> tuple[float, float, float]:
    """(mean, lo, hi) percentile-bootstrap CI; vectorised resampling."""
    values = np.asarray(values, dtype=np.float64)
    rng = np.random.default_rng(seed)
    n = len(values)
    idx = rng.integers(0, n, size=(n_resamples, n))
    means = values[idx].mean(axis=1)
    lo, hi = np.percentile(means, [100 * alpha / 2, 100 * (1 - alpha / 2)])
    return float(values.mean()), float(lo), float(hi)


def evaluate_generation_bootstrap(
    hypotheses: Sequence[str],
    references: Sequence[str],
    metrics: Sequence[str] = ("ROUGE-L", "BLEU"),
    n_resamples: int = 2000,
    alpha: float = 0.05,
    min_pairs: int = 100,
    seed: int = 0,
) -> dict:
    """Metric means with bootstrap CIs over ≥``min_pairs`` pairs."""
    if len(hypotheses) != len(references):
        raise ValueError("hypothesis/reference count mismatch")
    if len(hypotheses) < min_pairs:
        raise ValueError(
            f"need >= {min_pairs} pairs for stable bootstrap, got "
            f"{len(hypotheses)}"
        )
    out: dict[str, dict] = {}
    for metric in metrics:
        m = metric.strip().lower()
        if m in ("rouge-l", "rougel"):
            vals = rouge_l_scores(hypotheses, references)
            mean, lo, hi = bootstrap_ci(vals, n_resamples, alpha, seed)
        elif m == "meteor":
            vals = meteor_scores(hypotheses, references)
            mean, lo, hi = bootstrap_ci(vals, n_resamples, alpha, seed)
        elif m == "bleu":
            # BLEU is corpus-level: bootstrap over sentence resamples
            rng = np.random.default_rng(seed)
            hyp = np.array(hypotheses, dtype=object)
            ref = np.array(references, dtype=object)
            n = len(hyp)
            samples = []
            for _ in range(max(n_resamples // 10, 50)):  # corpus BLEU is slow
                sel = rng.integers(0, n, size=n)
                samples.append(corpus_bleu(hyp[sel].tolist(), ref[sel].tolist()))
            mean = corpus_bleu(hypotheses, references)
            lo, hi = np.percentile(
                samples, [100 * alpha / 2, 100 * (1 - alpha / 2)]
            )
        else:
            raise ValueError(f"unknown generation metric {metric!r}")
        out[metric] = {"mean": float(mean), "ci_low": float(lo), "ci_high": float(hi)}
    return out


def paired_bootstrap_test(
    scores_a: np.ndarray,
    scores_b: np.ndarray,
    n_resamples: int = 10000,
    seed: int = 0,
) -> dict:
    """Paired bootstrap: p-value for mean(A) > mean(B) by resampled
    sign; vectorised."""
    a = np.asarray(scores_a, dtype=np.float64)
    b = np.asarray(scores_b, dtype=np.float64)
    if a.shape != b.shape:
        raise ValueError("paired scores must align")
    diff = a - b
    rng = np.random.default_rng(seed)
    n = len(diff)
    idx = rng.integers(0, n, size=(n_resamples, n))
    means = diff[idx].mean(axis=1)
    observed = float(diff.mean())
    if observed >= 0:
        p = float(np.mean(means <= 0))
    else:
        p = float(np.mean(means >= 0))
    return {
        "mean_diff": observed,
        "p_value": p,
        "significant_05": p < 0.05,
    }
