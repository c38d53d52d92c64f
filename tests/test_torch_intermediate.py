"""Monotone constraints with monotone_constraints_method="intermediate" in
the port against the JAX package on the CPU.

The method (grow_wave.py:717-757, :1201-1272, :1403-1438, :1767-1800 of
the JAX package): each child is bounded by its sibling's output, at most
one split a wave lands among the leaves under a monotone node, every
apply refreshes all bounds against the outputs under each monotone node,
and the leaves whose bounds moved re-search their own best in a third
block of the wave's search before they may speculate children again.

  * one tree of each package's grower from the same 1/64-grid gradients
    (every histogram sum exact in f32, so both see the same histograms)
    on the megakernel route ("mega", 8 numeric columns, B = 64) and the
    apply route (a categorical column), with monotone_penalty, and with
    use_quantized_grad (grid gradients with max |g| = max h = 1, C note
    10): structure, default_left and leaf_of_row exactly, the wave count
    exactly (the serialized waves and the own re-search blocks follow the
    JAX package's), leaf values and gains within rtol 1e-5;
  * whole runs of lightgbm_tpu.train and lightgbm_tpu_torch.train
    (device_type="cpu") on both routes: split features, bin thresholds,
    children and categorical bitsets exactly, leaf values within 1e-6,
    internal values within rtol 1e-4 / atol 1e-5 (the whole-run tolerance
    of tests/test_torch_constraints.py), split gains within rtol 1e-4 /
    atol 1e-6 times the tree's largest gain: a gain is a difference of
    leaf gains as large as the root's, which the JAX search sums in f32
    and the port in f64 (ROADMAP C note 9);
  * the bounds hold: raw scores never move against a constraint along a
    sweep of the feature;
  * histogram_impl="fused" is vetoed naming `monotone_intermediate`, as in
    the JAX package, and trains the same trees on "mega".
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.ops.grow_wave import grow_tree_wave as j_grow
from lightgbm_tpu_torch.ops import grow_wave as tw

PARAMS = dict(objective="binary", num_leaves=15, max_bin=63,
              learning_rate=0.1, min_data_in_leaf=20, verbose=-1,
              bagging_freq=0, monotone_constraints_method="intermediate")
TORCH = {"device_type": "cpu", "binning_impl": "host"}
MONO = [1, -1, 0, 1, 0, 0, 0, 0]
ROUNDS = 2
SEED = 11


def _data(route):
    """3000 x 8 rows, NaN in feature 3; on "apply" feature 5 holds 12
    categories. Feature 0 enters through a sine, so its +1 constraint
    binds (the data of tests/test_torch_constraints.py)."""
    rng = np.random.RandomState(0)
    N = 3000
    X = rng.normal(size=(N, 8)).astype(np.float32)
    X[rng.rand(N) < 0.1, 3] = np.nan
    z = X[:, 0] - X[:, 1] + 0.5 * X[:, 2] + np.sin(3 * X[:, 0])
    dskw = {}
    if route == "apply":
        X[:, 5] = rng.randint(0, 12, N)
        z = z + 1.5 * (X[:, 5] % 3 == 0)
        dskw = {"categorical_feature": [5]}
    y = (z + rng.normal(scale=0.5, size=N) > 0).astype(np.float32)
    return X, y, dskw


def _grid_grads(y, seed, unit=False):
    """1/64-grid gradients; with `unit`, max |g| = max h = 1."""
    rng = np.random.RandomState(seed)
    N = len(y)
    if unit:
        g = np.clip(np.round((0.5 - y + 0.2 * rng.normal(size=N)) * 64)
                    / 64, -1.0, 1.0)
        h = np.round(rng.uniform(0.05, 1.0, size=N) * 64) / 64
        g[0], h[0] = 1.0, 1.0
    else:
        g = np.round((0.5 - y + 0.1 * rng.normal(size=N)) * 64) / 64
        h = np.round(rng.uniform(0.1, 0.3, size=N) * 64) / 64
    return g.astype(np.float32), h.astype(np.float32)


def _one_tree(route, over, unit=False):
    """(JAX tree, JAX leaf_of_row, port gbdt, port tree, port
    leaf_of_row) of one tree of both growers from the same grid
    gradients, on each package's own binned data, meta and config."""
    X, y, dskw = _data(route)
    g, h = _grid_grads(y, 3, unit)
    p = {**PARAMS, "monotone_constraints": MONO, **over}
    gj = lj.Booster(p, lj.Dataset(X, label=y, **dskw))._gbdt
    tj, lor_j = j_grow(gj.X_t, jnp.asarray(g), jnp.asarray(h),
                       jnp.ones(len(y), jnp.float32), gj.meta, gj.grow_cfg,
                       rng_seed=jnp.int32(SEED))
    gt = lt.Booster({**p, **TORCH}, lt.Dataset(X, label=y, **dskw))._gbdt
    tt, lor_t = tw.grow_tree_wave(gt.X_t, torch.from_numpy(g),
                                  torch.from_numpy(h), torch.ones(len(y)),
                                  gt.meta, gt.grow_cfg,
                                  hist_plan=gt.hist_plan, rng_seed=SEED)
    return tj, np.asarray(lor_j), gt, tt, lor_t.numpy()


def _assert_same_tree(tj, tt):
    n = int(tj.num_leaves)
    assert tt.num_leaves == n > 1
    assert tt.num_waves == int(tj.num_waves)
    m = n - 1
    for name in ("split_feature", "threshold_bin", "default_left",
                 "left_child", "right_child", "split_is_cat"):
        np.testing.assert_array_equal(getattr(tt, name)[:m].numpy(),
                                      np.asarray(getattr(tj, name))[:m],
                                      err_msg=name)
    np.testing.assert_array_equal(
        tt.split_cat_bitset[:m].numpy().astype(np.uint32),
        np.asarray(tj.split_cat_bitset)[:m])
    for name, k in (("leaf_value", n), ("split_gain", m),
                    ("internal_value", m)):
        np.testing.assert_allclose(getattr(tt, name)[:k].numpy(),
                                   np.asarray(getattr(tj, name))[:k],
                                   rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("route,over,unit", [
    ("mega", {}, False),
    ("mega", {"monotone_penalty": 0.5}, False),
    ("apply", {}, False),
    ("mega", {"use_quantized_grad": True, "num_grad_quant_bins": 4}, True),
])
def test_one_tree_matches_jax_grower(route, over, unit):
    tj, lor_j, gt, tt, lor_t = _one_tree(route, over, unit)
    assert gt.grow_route == route
    _assert_same_tree(tj, tt)
    np.testing.assert_array_equal(lor_t, lor_j)
    # the constraints bind: monotone features split
    m = tt.num_leaves - 1
    assert np.isin(tt.split_feature[:m].numpy(), [0, 1, 3]).any()


@pytest.fixture(scope="module")
def runs():
    """(JAX booster, port booster) by (route, over), trained once."""
    cache = {}

    def get(route, over=()):
        key = (route, over)
        if key not in cache:
            X, y, dskw = _data(route)
            p = {**PARAMS, "monotone_constraints": MONO, **dict(over)}
            cache[key] = (
                lj.train(p, lj.Dataset(X, label=y, **dskw), ROUNDS),
                lt.train({**p, **TORCH}, lt.Dataset(X, label=y, **dskw),
                         ROUNDS))
        return cache[key]
    return get


def _blocks(text):
    body = text.split("end of trees")[0]
    return [dict(ln.split("=", 1) for ln in blk.splitlines()[1:] if "=" in ln)
            for blk in body.split("Tree=")[1:]]


def _nums(s, dtype=float):
    return np.array(s.split(), dtype=dtype)


def _assert_same_model(X, bj, bt):
    tt, tj = _blocks(bt.model_to_string()), _blocks(bj.model_to_string())
    assert len(tt) == len(tj) == ROUNDS
    for a, b in zip(tt, tj):
        for k in ("num_leaves", "num_cat", "split_feature", "threshold",
                  "left_child", "right_child", "cat_boundaries",
                  "cat_threshold"):
            assert a.get(k) == b.get(k), k
        np.testing.assert_array_equal(_nums(a["decision_type"], int) & ~2,
                                      _nums(b["decision_type"], int) & ~2)
        np.testing.assert_allclose(_nums(a["leaf_value"]),
                                   _nums(b["leaf_value"]), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(_nums(a["internal_value"]),
                                   _nums(b["internal_value"]), rtol=1e-4,
                                   atol=1e-5)
        # a gain is a difference of leaf gains up to the root's: its
        # rounding is relative to the tree's largest gain
        ga, gb = _nums(a["split_gain"]), _nums(b["split_gain"])
        np.testing.assert_allclose(ga, gb, rtol=1e-4,
                                   atol=1e-6 * np.abs(gb).max())
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("route", ["mega", "apply"])
def test_whole_runs_match_jax(runs, route):
    bj, bt = runs(route)
    g = bt._gbdt
    assert g.grow_route == route and g.grow_cfg.monotone_method == \
        "intermediate"
    _assert_same_model(_data(route)[0], bj, bt)
    if route == "apply":
        assert sum(t.num_cat for t in g.models) > 0
    # the method binds: `basic` grows other trees
    X, y, dskw = _data(route)
    basic = lt.train({**PARAMS, **TORCH, "monotone_constraints": MONO,
                      "monotone_constraints_method": "basic"},
                     lt.Dataset(X, label=y, **dskw), 1)
    assert basic.model_to_string().split("Tree=1")[0] \
        != bt.model_to_string().split("Tree=1")[0]


@pytest.mark.parametrize("route", ["mega", "apply"])
def test_scores_follow_the_constraints(runs, route):
    """The raw score of 128 fixed rows never moves against a constraint
    along a 48-point sweep of its feature, and moves along some."""
    _, bt = runs(route)
    rows = np.random.RandomState(7).normal(size=(128, 8)).astype(np.float32)
    if route == "apply":
        rows[:, 5] = np.arange(128) % 12
    grid = np.linspace(-3.0, 3.0, 48, dtype=np.float32)
    moved = 0
    for j, sign in ((0, 1), (1, -1), (3, 1)):
        Xs = np.repeat(rows, len(grid), axis=0)
        Xs[:, j] = np.tile(grid, len(rows))
        p = bt.predict(Xs, raw_score=True).reshape(len(rows), len(grid))
        step = np.diff(p, axis=1) * sign
        assert step.min() >= 0.0, (j, step.min())
        moved += int((step > 0).sum())
    assert moved > 0


def test_fused_is_vetoed(runs):
    """histogram_impl="fused" takes "mega" with the JAX package's veto
    reason (grow_wave.py:134-136), and grows the same trees."""
    bj, _ = runs("mega")
    X, y, _ = _data("mega")
    bf = lt.train({**PARAMS, **TORCH, "monotone_constraints": MONO,
                   "histogram_impl": "fused"}, lt.Dataset(X, label=y),
                  ROUNDS)
    assert bf._gbdt.grow_route == "mega"
    assert bf._gbdt.fused_veto_reasons == ["monotone_intermediate"]
    _assert_same_model(X, bj, bf)
