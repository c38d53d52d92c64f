"""Seeded synthetic tables in the shapes of public datasets, made with
numpy (nothing is downloaded): the data `chip_smoke.py` and
`scripts/profile_torch_port.py` train the wave-apply route on.

* `criteo_like`: the schema of the Criteo display-advertising click logs
  (Kaggle 2014 challenge / Criteo-1TB): 13 integer count columns and 26
  categorical columns, a binary click label near 25% positive.
* `efb_like`: sparse one-hot columns beside dense ones, the shape EFB
  bundles (tests/test_tpu_parity.py:107-120 of the JAX package).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# Criteo's 26 categorical columns, capped at 250 categories: every column
# fits the uint8 storage of at most 256 bins
CRITEO_CARDINALITIES = (3, 4, 5, 8, 10, 12, 15, 20, 24, 27, 31, 40, 50, 60,
                        80, 100, 120, 150, 180, 200, 220, 240, 250, 250, 250,
                        250)
# the same schema with its last six columns past 256 categories, for the
# uint16 storage of max_bin > 255
CRITEO_WIDE_CARDINALITIES = CRITEO_CARDINALITIES[:20] + (300, 400, 500, 600,
                                                         800, 1000)
CRITEO_NUM_COUNTS = 13
CRITEO_CAT_COLUMNS = tuple(range(CRITEO_NUM_COUNTS,
                                 CRITEO_NUM_COUNTS
                                 + len(CRITEO_CARDINALITIES)))


def _sigmoid(z):
    return 1.0 / (1.0 + np.exp(-z))


def criteo_like(n: int, seed: int = 7,
                cardinalities: Tuple[int, ...] = CRITEO_CARDINALITIES
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(X [n, 39] f32, y [n] f32) of the Criteo schema, from
    `np.random.RandomState(seed)`.

    Columns 0-12 are counts floor(exp(N(mu_j, sigma_j))) with per-column
    NaN rates in [0, 0.4); columns 13-38 are category codes 0..c-1 drawn
    Zipf(1.2) over `cardinalities` (26 of them; CRITEO_CARDINALITIES by
    default), 2% NaN. The label is
    Bernoulli(sigmoid(sum of per-category effects ~ N(0, 0.5) + sum_j w_j *
    log1p(count_j) - shift)), the shift set for a positive rate near 25%."""
    rng = np.random.RandomState(seed)
    k = CRITEO_NUM_COUNTS
    X = np.empty((n, k + len(cardinalities)), np.float32)
    mu = rng.uniform(0.0, 4.0, k)
    sigma = rng.uniform(0.5, 1.5, k)
    nan_rate = rng.uniform(0.0, 0.4, k)
    w = rng.normal(0.0, 0.3, k)
    z = np.zeros(n, np.float64)
    for j in range(k):
        c = np.floor(np.exp(rng.normal(mu[j], sigma[j], n)))
        z += w[j] * np.log1p(c)
        c[rng.rand(n) < nan_rate[j]] = np.nan
        X[:, j] = c
    for i, card in enumerate(cardinalities):
        p = np.arange(1, card + 1, dtype=np.float64) ** -1.2
        cdf = np.cumsum(p / p.sum())
        code = np.minimum(np.searchsorted(cdf, rng.rand(n)), card - 1)
        z += rng.normal(0.0, 0.5, card)[code]
        col = code.astype(np.float32)
        col[rng.rand(n) < 0.02] = np.nan
        X[:, k + i] = col
    lo, hi = z.min(), z.max()
    for _ in range(60):                   # shift for a 25% positive rate
        mid = 0.5 * (lo + hi)
        if _sigmoid(z - mid).mean() > 0.25:
            lo = mid
        else:
            hi = mid
    y = (rng.rand(n) < _sigmoid(z - 0.5 * (lo + hi))).astype(np.float32)
    return X, y


def efb_like(n: int, n_sparse: int = 30, n_dense: int = 30,
             seed: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """(X [n, n_sparse + n_dense] f32, y) with one hot sparse column per
    row (values in [1, 3), 0 elsewhere) beside dense normal columns; the
    label depends on both with distinct weights."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, n_sparse + n_dense), np.float32)
    hot = rng.randint(0, n_sparse, size=n)
    X[np.arange(n), hot] = rng.uniform(1, 3, size=n).astype(np.float32)
    X[:, n_sparse:] = rng.normal(size=(n, n_dense))
    ws = np.linspace(-2.0, 2.0, n_sparse) + 0.01 * np.arange(n_sparse)
    wd = rng.normal(size=n_dense) * np.linspace(1.5, 0.1, n_dense)
    z = ws[hot] + X[:, n_sparse:] @ wd
    y = (z + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    return X, y
