"""One tree of the port's wave grower against lightgbm_tpu's
ops/grow_wave.py:grow_tree_wave on the JAX CPU route, from the same fixed
gradients.

Gradients and hessians lie on a 1/64 grid, so every histogram bin is an
exact f32 sum in any order of addition: both growers then see the same
histograms, and the tree must be the same — structure and default_left
exactly, leaf_of_row bitwise, leaf values and gains within rtol=1e-5
(rtol=1e-4 from unrounded gradients: a leaf's gradient sum cancels
positive against negative rows, and a gain is the difference of three leaf
gains, so last-bit differences of the sums grow in relative terms). Leaf
counts are synthesized from hessians (hess * count / sum_hess, rounded),
whose cumulative sums are inexact; a count straddling x.5 may round the
other way, so counts are held to +-1.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lightgbm_tpu.ops import grow as jg
from lightgbm_tpu.ops import grow_wave as jw
from lightgbm_tpu.ops import split as js
from lightgbm_tpu_torch.ops import grow as tg
from lightgbm_tpu_torch.ops import grow_wave as tw
from lightgbm_tpu_torch.ops import split as ts


def _inputs(N, F, B, seed, grid=True):
    rng = np.random.RandomState(seed)
    nb = rng.randint(B // 2, B + 1, size=F).astype(np.int32)
    X = (rng.rand(F, N) * nb[:, None]).astype(np.uint8)
    w = rng.normal(size=F)
    s = ((X.astype(np.float64) / nb[:, None] - 0.5) * w[:, None]).sum(0)
    g = np.tanh(s) + 0.3 * rng.normal(size=N)
    h = rng.uniform(0.05, 0.25, size=N)
    if grid:
        g, h = np.round(g * 64) / 64, np.round(h * 64) / 64
    mt = rng.randint(0, 3, size=F).astype(np.int32)
    db = np.minimum(rng.randint(0, B, size=F), nb - 1).astype(np.int32)
    return X, g.astype(np.float32), h.astype(np.float32), (nb, mt, db)


def _grow_both(N, F, L, B, seed, grid=True, **over):
    X, g, h, (nb, mt, db) = _inputs(N, F, B, seed, grid)
    kw = dict(num_leaves=L, max_depth=-1, min_data_in_leaf=20.0,
              min_sum_hessian_in_leaf=1e-3, lambda_l1=0.0, lambda_l2=0.0,
              max_delta_step=0.0, min_gain_to_split=0.0, path_smooth=0.0,
              num_bins_padded=B, wave_gain_slack=0.3)
    kw.update(over)
    jm = js.FeatureMeta(num_bins=jnp.asarray(nb),
                        missing_type=jnp.asarray(mt),
                        default_bin=jnp.asarray(db),
                        is_categorical=jnp.zeros(F, bool))
    tj, lj = jw.grow_tree_wave(jnp.asarray(X), jnp.asarray(g),
                               jnp.asarray(h), jnp.ones(N, jnp.float32), jm,
                               jg.GrowConfig(**kw))
    tm = ts.FeatureMeta(num_bins=torch.tensor(nb),
                        missing_type=torch.tensor(mt),
                        default_bin=torch.tensor(db),
                        is_categorical=torch.zeros(F, dtype=torch.bool))
    tt, lt = tw.grow_tree_wave(torch.tensor(X), torch.tensor(g),
                               torch.tensor(h), torch.ones(N), tm,
                               tg.GrowConfig(**kw))
    return tj, np.asarray(lj), tt, lt.numpy()


def _assert_same_tree(tj, tt, exact_dl=True, rtol=1e-5):
    n = int(tj.num_leaves)
    assert tt.num_leaves == n and tt.num_waves == int(tj.num_waves)
    m = n - 1
    for name in ("split_feature", "threshold_bin", "left_child",
                 "right_child"):
        np.testing.assert_array_equal(getattr(tt, name)[:m].numpy(),
                                      np.asarray(getattr(tj, name))[:m],
                                      err_msg=name)
    if exact_dl:
        np.testing.assert_array_equal(tt.default_left[:m].numpy(),
                                      np.asarray(tj.default_left)[:m])
    for name, k in (("leaf_value", n), ("leaf_weight", n),
                    ("split_gain", m), ("internal_value", m),
                    ("internal_weight", m)):
        np.testing.assert_allclose(getattr(tt, name)[:k].numpy(),
                                   np.asarray(getattr(tj, name))[:k],
                                   rtol=rtol, atol=1e-7, err_msg=name)
    for name, k in (("leaf_count", n), ("internal_count", m)):
        d = np.abs(getattr(tt, name)[:k].numpy().astype(np.int64)
                   - np.asarray(getattr(tj, name))[:k])
        assert d.max(initial=0) <= 1, name


@pytest.mark.parametrize("N,F,L,B,seed,over", [
    (3000, 8, 31, 64, 2, {}),
    (8000, 12, 63, 64, 6, {}),
    (20000, 28, 255, 64, 1, {}),          # the bench shape, cut in rows
    (3000, 12, 63, 32, 5, {"wave_gain_slack": 0.0}),
    (4000, 10, 31, 64, 3, {"max_depth": 4}),
    (4000, 10, 31, 64, 7, {"lambda_l1": 0.5, "lambda_l2": 1.0,
                           "min_data_in_leaf": 50.0}),
])
def test_tree_matches_grow_tree_wave(N, F, L, B, seed, over):
    tj, lj, tt, lt = _grow_both(N, F, L, B, seed, **over)
    assert int(tj.num_leaves) > 1
    _assert_same_tree(tj, tt)
    np.testing.assert_array_equal(lt, lj)
    assert lt.dtype == np.int32


def test_tree_from_f32_gradients_matches_grow_tree_wave():
    """Unrounded gradients: histograms differ in the last bits. Where a
    node's missing bin is empty both directions give the same split and
    those bits pick default_left, so the flag is not compared; where rows
    take it, leaf_of_row (compared bitwise) shows it."""
    tj, lj, tt, lt = _grow_both(3000, 8, 31, 64, 2, grid=False)
    _assert_same_tree(tj, tt, exact_dl=False, rtol=1e-4)
    np.testing.assert_array_equal(lt, lj)


def test_single_leaf_tree():
    """No split clears min_data_in_leaf: a constant-zero stump."""
    tj, lj, tt, lt = _grow_both(500, 4, 31, 32, 0,
                                    min_data_in_leaf=400.0)
    assert tt.num_leaves == int(tj.num_leaves) == 1
    assert float(tt.leaf_value[0]) == 0.0
    assert not lt.any() and not lj.any()
