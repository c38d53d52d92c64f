"""Ranking metric helpers: NDCG@k and MAP@k per query.

Copy of lightgbm_tpu/metrics/rank_utils.py (reference:
src/metric/dcg_calculator.cpp DCGCalculator, rank_metric.hpp:20
NDCGMetric, map_metric.hpp:21 MapMetric). Default label gains are 2^i - 1
(dcg_calculator.cpp kDefaultLabelGain).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

_DEFAULT_MAX_LABEL = 31


def default_label_gain(max_label: int = _DEFAULT_MAX_LABEL) -> np.ndarray:
    return (2.0 ** np.arange(max_label + 1)) - 1.0


def dcg_at_k(scores: np.ndarray, labels: np.ndarray, k: int,
             label_gain: np.ndarray) -> float:
    top = np.argsort(-scores, kind="stable")[:k]
    gains = label_gain[labels[top].astype(np.int64)]
    discounts = 1.0 / np.log2(np.arange(2, len(top) + 2))
    return float(np.sum(gains * discounts))


def max_dcg_at_k(labels: np.ndarray, k: int,
                 label_gain: np.ndarray) -> float:
    sorted_labels = np.sort(labels)[::-1][:k]
    gains = label_gain[sorted_labels.astype(np.int64)]
    discounts = 1.0 / np.log2(np.arange(2, len(sorted_labels) + 2))
    return float(np.sum(gains * discounts))


def _query_weights(query_boundaries, weight):
    """Per-query weights: the reference weights queries, not rows, for
    ranking (a query's weight is its first row's)."""
    nq = len(query_boundaries) - 1
    qw = np.ones(nq) if weight is None else np.array(
        [weight[query_boundaries[q]] for q in range(nq)])
    return nq, qw, float(np.sum(qw))


def eval_ndcg(score: np.ndarray, label: np.ndarray,
              query_boundaries: Optional[np.ndarray],
              weight: Optional[np.ndarray],
              eval_at: Sequence[int],
              label_gain: Sequence[float]) -> List[Tuple[str, float, bool]]:
    if query_boundaries is None:
        raise ValueError("NDCG metric requires query information")
    lg = np.asarray(label_gain, np.float64) if len(label_gain) else \
        default_label_gain(int(np.max(label)) if len(label) else 1)
    nq, qw, sumw = _query_weights(query_boundaries, weight)
    results = []
    for k in eval_at:
        acc = 0.0
        for q in range(nq):
            s, e = query_boundaries[q], query_boundaries[q + 1]
            max_dcg = max_dcg_at_k(label[s:e], k, lg)
            if max_dcg <= 0.0:
                acc += 1.0 * qw[q]   # the reference counts such queries as 1
            else:
                acc += dcg_at_k(score[s:e], label[s:e], k, lg) / max_dcg * qw[q]
        results.append((f"ndcg@{k}", acc / sumw, True))
    return results


def eval_map(score: np.ndarray, label: np.ndarray,
             query_boundaries: Optional[np.ndarray],
             weight: Optional[np.ndarray],
             eval_at: Sequence[int]) -> List[Tuple[str, float, bool]]:
    if query_boundaries is None:
        raise ValueError("MAP metric requires query information")
    nq, qw, sumw = _query_weights(query_boundaries, weight)
    results = []
    for k in eval_at:
        acc = 0.0
        for q in range(nq):
            s, e = query_boundaries[q], query_boundaries[q + 1]
            rel = (label[s:e] > 0).astype(np.float64)
            rel_sorted = rel[np.argsort(-score[s:e], kind="stable")[:k]]
            hits = np.cumsum(rel_sorted)
            npos = float(np.sum(rel))
            if npos <= 0:
                acc += 1.0 * qw[q]
                continue
            prec = hits / np.arange(1, len(rel_sorted) + 1)
            acc += float(np.sum(prec * rel_sorted) / min(npos, k)) * qw[q]
        results.append((f"map@{k}", acc / sumw, True))
    return results
