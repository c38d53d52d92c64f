"""Quantized gradients (use_quantized_grad) in the port against the JAX
package on the CPU.

* The discretizer (`grow_wave.discretize_gradients`) bitwise against the
  JAX package's expressions (lightgbm_tpu/ops/grow_wave.py:381-404): the
  int8 gradients and hessians and both scales, stochastic rounding on and
  off, 4, 6 and 16 bins.
* One tree of `grow_tree_wave` against the JAX package's on every wave
  route the port takes: "mega", "apply" (B = 256, categorical features;
  EFB-bundled storage, whose re-sliced int32 sums are descaled before the
  default-bin fix-up), the row-wise layout and "fused_tiled" (num_leaves
  <= 17, so the fused
  route's wave cap of 16 at B = 256 cuts no wave the JAX CPU route runs).
  The gradients have max |g| = max h = 1, so at 4 bins the scales are 1/2
  and 1/4 and every descaled histogram sum is exact in any order: the
  trees are equal, leaf_of_row bitwise, and the leaf values bitwise.
* 5 rounds of `train` against `lightgbm_tpu.train`, with and without
  quant_train_renew_leaf: equal trees (structure exact, values within
  rtol 1e-4 as tests/test_torch_train.py holds them), predictions within
  1e-5.
* The JAX package's own rule (tests/test_quantized.py:50-56) on the port:
  the quantized AUC is above the float AUC - 0.01.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.datasets import make_classification
from sklearn.metrics import roc_auc_score

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.ops.grow_wave import grow_tree_wave as j_grow
from lightgbm_tpu_torch.ops import grow_wave as tw
from lightgbm_tpu_torch.utils.synthetic import efb_like
from test_torch_apply_grow import _assert_same_tree
from test_torch_train import PARAMS, TORCH, _assert_same_trees

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

SEED = 12345


def _jax_discretize(g, h, qb, stochastic, seed):
    """grow_wave.py:386-401 of the JAX package, verbatim."""
    max_g = jnp.max(jnp.abs(g))
    max_h = jnp.max(h)
    g_scale = jnp.maximum(max_g / (qb // 2), 1e-30)
    h_scale = jnp.maximum(max_h / qb, 1e-30)
    if stochastic:
        key = jax.random.PRNGKey(jnp.int32(seed))
        kg, kh = jax.random.split(key)
        ug = jax.random.uniform(kg, (g.shape[0],), jnp.float32)
        uh = jax.random.uniform(kh, (g.shape[0],), jnp.float32)
    else:
        ug = uh = jnp.float32(0.5)
    g8 = jnp.clip(jnp.trunc(g / g_scale + jnp.sign(g) * ug),
                  -127, 127).astype(jnp.int8)
    h8 = jnp.clip(jnp.trunc(h / h_scale + uh), 0, 127).astype(jnp.int8)
    return g8, h8, g_scale, h_scale


@pytest.mark.parametrize("qb", [4, 6, 16])
@pytest.mark.parametrize("stochastic", [True, False])
def test_discretizer_equals_jax_bitwise(qb, stochastic):
    rng = np.random.RandomState(qb)
    N = 5000
    g = (rng.normal(size=N) * 0.3).astype(np.float32)
    g[::97] = 0.0
    h = rng.uniform(0.0, 0.25, size=N).astype(np.float32)
    seed = -7 if stochastic else 0
    g8j, h8j, gsj, hsj = _jax_discretize(jnp.asarray(g), jnp.asarray(h), qb,
                                         stochastic, seed)
    v8, scale = tw.discretize_gradients(torch.from_numpy(g),
                                        torch.from_numpy(h), qb, stochastic,
                                        seed)
    assert v8.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(v8[0].numpy(), np.asarray(g8j))
    np.testing.assert_array_equal(v8[1].numpy(), np.asarray(h8j))
    np.testing.assert_array_equal(
        scale.numpy().view(np.int32),
        np.asarray([gsj, hsj], np.float32).view(np.int32))
    assert int(v8[0].abs().max()) <= qb // 2 + 1


def _pow2_grads(y, seed):
    """1/64-grid gradients with max |g| = max h = 1."""
    rng = np.random.RandomState(seed)
    N = len(y)
    g = np.clip(np.round((np.tanh(rng.normal(size=N)) + (y - 0.5)) * 32)
                / 64, -1.0, 1.0)
    h = np.round(rng.uniform(0.05, 1.0, size=N) * 64) / 64
    g[0], h[0] = 1.0, 1.0
    return g.astype(np.float32), h.astype(np.float32)


QPARAMS = dict(use_quantized_grad=True, num_grad_quant_bins=4)


def _jax_tree(X, y, dskw, g, h, over):
    """(tree, leaf_of_row) of one quantized tree of the JAX package."""
    p = {**PARAMS, "num_leaves": 15, **QPARAMS, **over}
    gj = lj.Booster(p, lj.Dataset(X, label=y, **dskw))._gbdt
    tj, lor_j = j_grow(gj.X_t, jnp.asarray(g), jnp.asarray(h),
                       jnp.ones(len(y), jnp.float32), gj.meta, gj.grow_cfg,
                       rng_seed=jnp.int32(SEED))
    return tj, np.asarray(lor_j)


def _port_tree(X, y, dskw, g, h, over):
    """(Booster's gbdt, tree, leaf_of_row) of the port's tree from the
    same inputs."""
    p = {**PARAMS, "num_leaves": 15, **QPARAMS, **over, **TORCH}
    gt = lt.Booster(p, lt.Dataset(X, label=y, **dskw))._gbdt
    tt, lor_t = tw.grow_tree_wave(gt.X_t, torch.from_numpy(g),
                                  torch.from_numpy(h), torch.ones(len(y)),
                                  gt.meta, gt.grow_cfg,
                                  hist_plan=gt.hist_plan, rng_seed=SEED)
    return gt, tt, lor_t.numpy()


@pytest.fixture(scope="module")
def dense_case():
    rng = np.random.RandomState(5)
    N, F = 4000, 10
    X = rng.normal(size=(N, F)).astype(np.float32)
    y = (X @ rng.normal(size=F) > 0).astype(np.float32)
    X[rng.rand(N) < 0.05, 2] = np.nan
    g, h = _pow2_grads(y, 0)
    return X, y, {}, g, h, _jax_tree(X, y, {}, g, h, {"max_bin": 63})


@pytest.fixture(scope="module")
def cat_case():
    rng = np.random.RandomState(3)
    N = 4000
    c0, c1 = rng.randint(0, 12, N), rng.randint(0, 40, N)
    Xn = rng.normal(size=(N, 3))
    z = (np.linspace(-2.0, 2.2, 12)[c0] + np.cos(np.arange(40) * 2.3)[c1]
         + Xn[:, 0])
    y = (z > 0).astype(np.float32)
    X = np.column_stack([c0, c1, Xn]).astype(np.float32)
    dskw = dict(categorical_feature=[0, 1])
    g, h = _pow2_grads(y, 1)
    return X, y, dskw, g, h, _jax_tree(X, y, dskw, g, h, {"max_bin": 255})


def test_mega_tree_equals_jax(dense_case):
    X, y, dskw, g, h, (tj, lj_) = dense_case
    gt, tt, lt_ = _port_tree(X, y, dskw, g, h, {"max_bin": 63})
    assert gt.grow_route == "mega" and gt.num_bins_padded <= 64
    _assert_same_tree(tj, lj_, tt, lt_)
    n = tt.num_leaves
    np.testing.assert_array_equal(tt.leaf_value[:n].numpy(),
                                  np.asarray(tj.leaf_value)[:n])


@pytest.mark.parametrize("over,route", [
    ({}, ("apply", "slots")),
    ({"force_row_wise": True}, ("apply", "rowwise")),
    ({"histogram_impl": "fused"}, ("fused_tiled", "slots")),
])
def test_wide_routes_tree_equals_jax(cat_case, over, route):
    """B = 256 with categorical features; the JAX CPU route runs every
    histogram_impl as its one XLA lowering, so each port route is held to
    the JAX package's default tree."""
    X, y, dskw, g, h, (tj, lj_) = cat_case
    gt, tt, lt_ = _port_tree(X, y, dskw, g, h, {"max_bin": 255, **over})
    assert (gt.grow_route, gt.hist_route) == route
    assert gt.num_bins_padded == 256
    _assert_same_tree(tj, lj_, tt, lt_)
    n = tt.num_leaves
    np.testing.assert_array_equal(tt.leaf_value[:n].numpy(),
                                  np.asarray(tj.leaf_value)[:n])
    assert bool(tt.split_is_cat[:n - 1].any())


@pytest.fixture(scope="module")
def efb_case():
    X, y = efb_like(3000, n_sparse=24, n_dense=6, seed=4)
    g, h = _pow2_grads(y, 1)
    return X, y, {}, g, h, _jax_tree(X, y, {}, g, h, {})


@pytest.mark.parametrize("over,route", [
    ({}, "slots"), ({"force_row_wise": True}, "rowwise")])
def test_bundled_tree_equals_jax(efb_case, over, route):
    X, y, dskw, g, h, (tj, lj_) = efb_case
    gt, tt, lt_ = _port_tree(X, y, dskw, g, h, over)
    assert gt.grow_cfg.bundled and (gt.grow_route, gt.hist_route) == (
        "apply", route)
    _assert_same_tree(tj, lj_, tt, lt_)
    n = tt.num_leaves
    np.testing.assert_array_equal(tt.leaf_value[:n].numpy(),
                                  np.asarray(tj.leaf_value)[:n])


def test_routes_never_take_the_narrow_fused_kernel():
    """grow_wave.py:300-309: quantized gradients take the general fused
    kernel, also on narrow numeric storage."""
    base = dict(num_leaves=15, max_depth=-1, min_data_in_leaf=20.0,
                min_sum_hessian_in_leaf=1e-3, lambda_l1=0.0, lambda_l2=0.0,
                max_delta_step=0.0, min_gain_to_split=0.0, path_smooth=0.0,
                num_bins_padded=64, hist_impl="fused")
    cfg = tw.GrowConfig(**base)
    assert tw.wave_routes(cfg, 10) == ("fused", "slots")
    q = cfg._replace(use_quantized_grad=True)
    assert tw.wave_routes(q, 10) == ("fused_tiled", "slots")
    assert tw.fused_veto_reasons(q) == []
    assert tw.wave_routes(q._replace(hist_impl="auto"), 10) == ("mega",
                                                                 "slots")


@pytest.fixture(scope="module")
def train_data():
    rng = np.random.RandomState(11)
    N, F = 3000, 8
    X = rng.normal(size=(N, F)).astype(np.float32)
    y = (X @ (rng.normal(size=F) * 2) + rng.normal(scale=0.5, size=N)
         > 0).astype(np.float32)
    X[rng.rand(N) < 0.1, 0] = np.nan
    X[rng.rand(N) < 0.3, 1] = 0.0
    return X, y


@pytest.mark.parametrize("renew", [False, True])
def test_train_matches_jax(train_data, renew):
    X, y = train_data
    over = {**QPARAMS, "quant_train_renew_leaf": renew}
    bj = lj.train({**PARAMS, **over}, lj.Dataset(X, label=y),
                  num_boost_round=5)
    bt = lt.train({**PARAMS, **TORCH, **over}, lt.Dataset(X, label=y),
                  num_boost_round=5)
    assert bt._gbdt.grow_route == "mega"
    _assert_same_trees(bt.model_to_string(), bj.model_to_string())
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-5)


def test_quantized_auc_within_001_of_float():
    X, y = make_classification(n_samples=4000, n_features=12,
                               n_informative=8, random_state=7)
    X, y = X.astype(np.float32), y.astype(np.float32)

    def auc(**over):
        p = dict(objective="binary", num_leaves=31, learning_rate=0.2,
                 min_data_in_leaf=5, verbose=-1, **TORCH, **over)
        return roc_auc_score(y, lt.train(p, lt.Dataset(X, label=y),
                                         20).predict(X))
    auc_fp = auc()
    assert auc(use_quantized_grad=True) > auc_fp - 0.01
    assert auc(use_quantized_grad=True,
               quant_train_renew_leaf=True) > auc_fp - 0.01
