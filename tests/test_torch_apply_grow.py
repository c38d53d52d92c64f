"""One tree of the port's wave grower on the wave-apply route against
lightgbm_tpu/ops/grow_wave.py:grow_tree_wave on the JAX CPU route, from
the same fixed gradients: categorical data (one-hot and sorted
many-vs-many splits) and EFB-bundled storage, each under the col-wise slot
histogram and a row-wise layout.

The grower inputs (storage, feature metadata, bundle maps, grower
configuration) come from each package's own `Booster` over the same raw
data. Gradients and hessians lie on a 1/64 grid, so every histogram bin,
every bundle re-slice and every default-bin fix-up is an exact f32 sum in
any order: the two growers see the same histograms, and the tree must be
the same — structure, default_left, categorical flags and bin bitsets
exactly, leaf_of_row bitwise, values within rtol 1e-6. The JAX CPU route
runs every histogram_impl as one XLA lowering, so a row-wise run of the
port is held to the JAX package's default run.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.ops.grow_wave import grow_tree_wave as j_grow
from lightgbm_tpu_torch.ops import grow_wave as tw
from lightgbm_tpu_torch.ops.grow_wave import grow_tree_wave as t_grow
from lightgbm_tpu_torch.utils.synthetic import (CRITEO_CAT_COLUMNS,
                                                criteo_like, efb_like)

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

PARAMS = dict(objective="binary", num_leaves=15, max_bin=63, verbose=-1,
              min_data_in_leaf=20)


def _grid_grads(y, seed):
    rng = np.random.RandomState(seed)
    N = len(y)
    g = np.round((np.tanh(rng.normal(size=N)) + (y - 0.5)) * 64) / 64
    h = np.round(rng.uniform(0.05, 0.25, size=N) * 64) / 64
    return g.astype(np.float32), h.astype(np.float32)


def _jax_tree(X, y, dskw, g, h, over=None):
    gj = lj.Booster({**PARAMS, **(over or {})},
                    lj.Dataset(X, label=y, **dskw))._gbdt
    tree, lor = j_grow(gj.X_t, jnp.asarray(g), jnp.asarray(h),
                       jnp.ones(len(y), jnp.float32), gj.meta, gj.grow_cfg)
    return tree, np.asarray(lor)


def _port_tree(X, y, dskw, g, h, over):
    gt = lt.Booster({**PARAMS, "device_type": "cpu", "binning_impl": "host",
                     **over}, lt.Dataset(X, label=y, **dskw))._gbdt
    tree, lor = t_grow(gt.X_t, torch.from_numpy(g), torch.from_numpy(h),
                       torch.ones(len(y)), gt.meta, gt.grow_cfg,
                       hist_plan=gt.hist_plan)
    return gt, tree, lor.numpy()


def _assert_same_tree(tj, lj_, tt, lt_, gain_atol=1e-7):
    n = int(tj.num_leaves)
    m = n - 1
    assert n > 2 and tt.num_leaves == n
    assert tt.num_waves == int(tj.num_waves)
    for name in ("split_feature", "threshold_bin", "default_left",
                 "left_child", "right_child", "split_is_cat"):
        np.testing.assert_array_equal(getattr(tt, name)[:m].numpy(),
                                      np.asarray(getattr(tj, name))[:m],
                                      err_msg=name)
    np.testing.assert_array_equal(
        tt.split_cat_bitset[:m].numpy(),
        np.asarray(tj.split_cat_bitset)[:m].astype(np.int64))
    for name, k in (("leaf_value", n), ("leaf_weight", n), ("split_gain", m),
                    ("internal_value", m), ("internal_weight", m)):
        np.testing.assert_allclose(getattr(tt, name)[:k].numpy(),
                                   np.asarray(getattr(tj, name))[:k],
                                   rtol=1e-6,
                                   atol=gain_atol if name == "split_gain"
                                   else 1e-7, err_msg=name)
    np.testing.assert_array_equal(lt_, lj_)


@pytest.fixture(scope="module")
def cat_case():
    rng = np.random.RandomState(3)
    N = 4000
    c0 = rng.randint(0, 12, N)
    c1 = rng.randint(0, 40, N)
    c2 = rng.randint(0, 3, N)
    Xn = rng.normal(size=(N, 3))
    z = (np.linspace(-2.0, 2.2, 12)[c0] + np.cos(np.arange(40) * 2.3)[c1]
         + np.array([-0.8, 0.2, 0.7])[c2] + Xn[:, 0])
    y = (z > 0).astype(np.float32)
    X = np.column_stack([c0, c1, c2, Xn]).astype(np.float32)
    X[rng.rand(N) < 0.03, 1] = np.nan
    dskw = dict(categorical_feature=[0, 1, 2])
    g, h = _grid_grads(y, 0)
    return X, y, dskw, g, h, _jax_tree(X, y, dskw, g, h)


@pytest.fixture(scope="module")
def efb_case():
    X, y = efb_like(3000, n_sparse=24, n_dense=6, seed=4)
    g, h = _grid_grads(y, 1)
    return X, y, {}, g, h, _jax_tree(X, y, {}, g, h)


@pytest.mark.parametrize("over,route", [
    ({}, "slots"), ({"histogram_impl": "rowwise_packed"}, "rowwise_packed")])
def test_categorical_tree_matches_grow_tree_wave(cat_case, over, route):
    X, y, dskw, g, h, (tj, lj_) = cat_case
    gt, tt, lt_ = _port_tree(X, y, dskw, g, h, over)
    assert gt.grow_route == "apply" and gt.hist_route == route
    _assert_same_tree(tj, lj_, tt, lt_)
    assert bool(tt.split_is_cat[:tt.num_leaves - 1].any())


@pytest.mark.parametrize("over,route", [
    ({}, "slots"), ({"force_row_wise": True}, "rowwise")])
def test_bundled_tree_matches_grow_tree_wave(efb_case, over, route):
    X, y, dskw, g, h, (tj, lj_) = efb_case
    gt, tt, lt_ = _port_tree(X, y, dskw, g, h, over)
    assert gt.grow_cfg.bundled and gt.X_t.shape[0] < X.shape[1]
    assert gt.grow_route == "apply" and gt.hist_route == route
    _assert_same_tree(tj, lj_, tt, lt_)


@pytest.fixture(scope="module")
def criteo_case():
    X, y = criteo_like(3000, seed=11)
    dskw = dict(categorical_feature=list(CRITEO_CAT_COLUMNS))
    g, h = _grid_grads(y, 2)
    return X, y, dskw, g, h, _jax_tree(X, y, dskw, g, h, {"max_bin": 255})


def test_criteo_like_tree_decides_rows_in_the_pass(criteo_case,
                                                   monkeypatch):
    """The Criteo schema at max_bin 255 (B = 256, 8-word bitsets): the
    port's apply route decides each row inside its wave_apply pass (no
    dec_go_left decision matrix) and grows the JAX package's tree."""
    X, y, dskw, g, h, (tj, lj_) = criteo_case
    calls = {"wave_apply": 0, "dec_go_left": 0}
    for name in calls:
        fn = getattr(tw, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(tw, name, counted)
    gt, tt, lt_ = _port_tree(X, y, dskw, g, h, {"max_bin": 255})
    assert gt.grow_route == "apply" and gt.num_bins_padded == 256
    # the sorted many-vs-many gains are differences of f32 sums that the
    # two packages evaluate in different orders: on this data one gain of
    # about 27 differs by 6.1e-5 (so it does before the pass decided rows
    # itself), 1e-6 of the root split's gain
    _assert_same_tree(tj, lj_, tt, lt_,
                      gain_atol=1e-6 * float(np.asarray(tj.split_gain)[0]))
    assert bool(tt.split_is_cat[:tt.num_leaves - 1].any())
    assert calls["wave_apply"] > 0 and calls["dec_go_left"] == 0
