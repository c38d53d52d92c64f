"""The wave grower in strict leaf-wise order (tpu_grower="wave_exact") in
the port against the JAX package on the CPU, on every route the port has.

  * One tree of both packages' `grow_tree_wave` from the same 1/64-grid
    gradients, on each package's own binned data, meta and config: the
    structure, counts and categorical bitsets exactly, the number of waves
    exactly (the order step applies what JAX's `make_sim` applies, wave
    by wave), values within rtol 1e-5, and leaf_of_row. Routes: "mega"
    (8 dense columns), "apply" (categorical, and 40 columns), "fused" and
    "fused_tiled" (num_leaves 15: the fused routes' wave caps, C note 8),
    with forced splits and with monotone `intermediate` on "mega".
  * The port's wave_exact grows the port's compact trees, as JAX
    tests/test_grow_wave.py:41 holds: both search synthesized counts and
    take sibling histograms by subtraction.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.ops.grow_wave import grow_tree_wave
from lightgbm_tpu_torch.ops import grow_wave as tw

from test_torch_serial_growers import assert_models_close

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

TORCH = {"device_type": "cpu", "binning_impl": "host"}
PARAMS = dict(objective="binary", num_leaves=15, max_bin=63,
              learning_rate=0.1, min_data_in_leaf=10, verbose=-1,
              tpu_grower="wave_exact")
SEED = 5
# one XLA program a configuration: compiling it whole beats dispatching
# the grower's loops op by op
j_grow = jax.jit(grow_tree_wave, static_argnames=("cfg",))
FS = {"feature": 0, "threshold": 0.1,
      "right": {"feature": 1, "threshold": -0.4}}


def _data(F=8, cat=False, N=2000):
    """N x F rows, NaN in feature 3; with `cat`, features 5 and 6 hold 12
    and 30 categories."""
    rng = np.random.RandomState(2)
    X = rng.normal(size=(N, F)).astype(np.float32)
    X[rng.rand(N) < 0.1, 3] = np.nan
    z = X[:, 0] - X[:, 1] + 0.5 * X[:, 2] + np.sin(3 * X[:, 4])
    dskw = {}
    if cat:
        for c, n in ((5, 12), (6, 30)):
            X[:, c] = rng.randint(0, n, N)
            z = z + np.sin(np.arange(n) * (1.1 + c))[X[:, c].astype(int)]
        dskw = {"categorical_feature": [5, 6]}
    y = (z + rng.normal(scale=0.5, size=N) > 0).astype(np.float32)
    return X, y, dskw


def _grid(y):
    rng = np.random.RandomState(7)
    g = np.round((0.5 - y + 0.1 * rng.normal(size=len(y))) * 64) / 64
    h = np.round(rng.uniform(0.1, 0.3, size=len(y)) * 64) / 64
    return g.astype(np.float32), h.astype(np.float32)


# name: (data kwargs, params, the port's route)
CASES = {
    "mega": ({}, {}, "mega"),
    "apply_cat": ({"cat": True}, {"max_cat_to_onehot": 4}, "apply"),
    "apply_wide": ({"F": 40}, {}, "apply"),
    "fused": ({}, {"histogram_impl": "fused"}, "fused"),
    "fused_tiled": ({"F": 40}, {"histogram_impl": "fused"}, "fused_tiled"),
    "forced": ({}, {"forced": True}, "mega"),
    "intermediate": ({}, {"monotone_constraints": [1, -1, 0, 0, 1, 0, 0, 0],
                          "monotone_constraints_method": "intermediate"},
                     "mega"),
}


def _params(over, tmp_path):
    p = {**PARAMS, **over}
    if p.pop("forced", False):
        path = tmp_path / "fs.json"
        path.write_text(json.dumps(FS))
        p["forcedsplits_filename"] = str(path)
    return p


@pytest.mark.parametrize("case", list(CASES))
def test_one_tree_equals_jax(case, tmp_path):
    dkw, over, route = CASES[case]
    X, y, dskw = _data(**dkw)
    g, h = _grid(y)
    p = _params(over, tmp_path)
    gj = lj.Booster(p, lj.Dataset(X, label=y, **dskw))._gbdt
    gt = lt.Booster({**p, **TORCH}, lt.Dataset(X, label=y, **dskw))._gbdt
    assert gt.grower == gj.grower == "wave_exact"
    assert gt.grow_cfg.wave_exact and gt.grow_route == route
    tj, lor_j = j_grow(gj.X_t, jnp.asarray(g), jnp.asarray(h),
                       jnp.ones(len(y), jnp.float32), gj.meta,
                       cfg=gj.grow_cfg, rng_seed=jnp.int32(SEED))
    tt, lor_t = tw.grow_tree_wave(gt.X_t, torch.from_numpy(g),
                                  torch.from_numpy(h), torch.ones(len(y)),
                                  gt.meta, gt.grow_cfg,
                                  hist_plan=gt.hist_plan, rng_seed=SEED)
    n = int(tj.num_leaves)
    assert tt.num_leaves == n > 8
    assert tt.num_waves == int(tj.num_waves)
    m = n - 1
    for name in ("split_feature", "threshold_bin", "default_left",
                 "left_child", "right_child", "split_parent_leaf",
                 "split_is_cat", "internal_count"):
        np.testing.assert_array_equal(getattr(tt, name)[:m].numpy(),
                                      np.asarray(getattr(tj, name))[:m],
                                      err_msg=name)
    np.testing.assert_array_equal(
        tt.split_cat_bitset[:m].numpy().astype(np.uint32),
        np.asarray(tj.split_cat_bitset)[:m])
    np.testing.assert_array_equal(tt.leaf_count.numpy(),
                                  np.asarray(tj.leaf_count))
    for name, k in (("leaf_value", n), ("split_gain", m),
                    ("internal_value", m)):
        np.testing.assert_allclose(getattr(tt, name)[:k].numpy(),
                                   np.asarray(getattr(tj, name))[:k],
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(lor_t.numpy(), np.asarray(lor_j))
    if case == "apply_cat":
        assert tt.split_is_cat[:m].any()
    if case == "forced":
        # the forced root and its right child lead the tree
        assert tt.split_feature[:2].tolist() == [0, 1]


def test_wave_exact_grows_compact_trees():
    """JAX tests/test_grow_wave.py:41 in the port: wave_exact reorders
    the device work of the serial growers, not their algorithm; here the
    structures and values are equal outright (both sum exactly in f64)."""
    X, y, _ = _data()
    p = {**PARAMS, **TORCH, "min_data_in_leaf": 2}
    texts = [lt.train({**p, "tpu_grower": gr}, lt.Dataset(X, label=y),
                      4).model_to_string() for gr in ("wave_exact",
                                                      "compact")]
    assert_models_close(*texts, counts=False)


def _applied(*args):
    """The leaves exact_order applies, in order."""
    leaves, sel = tw.exact_order(*args)
    return leaves[sel].tolist()


def test_exact_order_replays_the_serial_rule():
    """The order step alone: leaf 2 (gain 5) applies; its left child (4,
    now leaf 2) and right child (3, leaf 3) are ahead of leaf 0 (2.5) and
    not speculated yet, so the wave stops there."""
    L = 8
    f = torch.full((L,), float("-inf"))
    keyed, kl, kr = f.clone(), f.clone(), f.clone()
    keyed[:3] = torch.tensor([2.5, 1.0, 5.0])
    kl[2], kr[2] = 4.0, 3.0
    ready = torch.tensor([True, True, True] + [False] * 5)
    app = _applied(keyed, kl, kr, ready, None, 3, L, 8)
    assert bool(keyed.max() > 0.0) and app == [2]
    # children worth nothing: the queue runs on through leaves 1 and 0,
    # unless (monotone intermediate) leaf 1 lies under a monotone node as
    # leaf 2 does: one such leaf a wave
    keyed[1] = 4.5
    im = torch.tensor([False, True, True] + [False] * 5)
    kl[2] = kr[2] = 0.0
    assert _applied(keyed, kl, kr, ready, im, 3, L, 8) == [2]
    assert _applied(keyed, kl, kr, ready, None, 3, L, 8) == [2, 1, 0]
