"""The serial growers of the port (tpu_grower="masked", "compact") and the
grower ladder against the JAX package on the CPU.

  * One tree of `ops/grow.py:grow_tree` and `ops/grow_fast.py:
    grow_tree_fast` against the JAX package's from the same gradients,
    in-bag weights and feature mask, on each package's own binned data,
    meta and config: every DeviceTree field and leaf_of_row. Gradients and
    hessians lie on a 1/64 grid, so every histogram sum is exact in both
    packages (ROADMAP C notes 5, 9): integer fields and leaf_of_row are
    compared exactly, float fields within rtol 1e-5 (the same f32
    formulas in another operation order).
  * Whole runs (4 rounds): binary on both growers, then 3-class and dart
    on masked, l1 with its leaf renewal and linear_tree on compact (both
    growers are held to JAX tree by tree above): the model text up to the
    parameter echo, field by field as tests/test_torch_boosting_modes.py
    compares it, and raw predictions within 1e-6 times their scale.
  * compact grows masked's trees on the data of JAX tests/test_grow_fast.py
    (hessians from the binary objective: the two differ only where a
    synthesized count straddles min_data_in_leaf).
  * tpu_grower=auto walks JAX's histogram_pool_size ladder, and the
    switches back to the wave grower warn in JAX's words.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
import lightgbm_tpu.utils.log as jlog
import lightgbm_tpu_torch.utils.log as tlog
from lightgbm_tpu.ops.grow import grow_tree as j_masked
from lightgbm_tpu.ops.grow_fast import grow_tree_fast as j_compact
from lightgbm_tpu_torch.ops.grow import grow_tree as t_masked
from lightgbm_tpu_torch.ops.grow_fast import grow_tree_fast as t_compact

from test_torch_boosting_modes import _CLOSE, _EXACT, _nums, _split_text

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

TORCH = {"device_type": "cpu", "binning_impl": "host"}
PARAMS = dict(objective="binary", num_leaves=15, max_bin=63,
              learning_rate=0.1, min_data_in_leaf=10, verbose=-1)
# the JAX growers jitted whole: one XLA program a configuration
GROWERS = {"masked": (jax.jit(j_masked, static_argnames=("cfg",)),
                      t_masked),
           "compact": (jax.jit(j_compact, static_argnames=("cfg",)),
                       t_compact)}


def _data(cat=False, n=2000):
    """n x 7 rows, NaN in feature 2, zeros in a third of feature 4; with
    `cat`, feature 5 holds 11 categories."""
    rng = np.random.RandomState(5)
    X = rng.normal(size=(n, 7)).astype(np.float32)
    X[rng.rand(n) < 0.1, 2] = np.nan
    X[rng.rand(n) < 0.3, 4] = 0.0
    z = 1.5 * X[:, 0] - X[:, 1] + np.nan_to_num(X[:, 2]) + 0.7 * X[:, 4]
    dskw = {}
    if cat:
        X[:, 5] = rng.randint(0, 11, n)
        z = z + np.sin(1.7 * X[:, 5])
        dskw = {"categorical_feature": [5]}
    y = (z + rng.normal(scale=0.4, size=n) > 0).astype(np.float32)
    return X, y, dskw


def _grid(y, seed):
    rng = np.random.RandomState(seed)
    g = np.round((0.5 - y + 0.1 * rng.normal(size=len(y))) * 64) / 64
    h = np.round(rng.uniform(0.1, 0.3, size=len(y)) * 64) / 64
    return g.astype(np.float32), h.astype(np.float32)


def _bag(kind, n):
    rng = np.random.RandomState(8)
    if kind == "bagging":
        return (rng.rand(n) < 0.7).astype(np.float32)
    if kind == "goss":
        # GOSS: the top rows at 1, a sample of the rest amplified
        u = rng.rand(n)
        return np.where(u < 0.2, 1.0, np.where(u < 0.5, 2.5, 0.0)) \
            .astype(np.float32)
    return np.ones(n, np.float32)


FN_CASES = {
    "numerical": ({}, False, "all", None),
    "categorical": ({"max_cat_to_onehot": 4}, True, "all", None),
    "bagging": ({}, False, "bagging", None),
    "goss": ({}, False, "goss", None),
    "feature_mask": ({}, False, "all", [1, 1, 0, 1, 1, 0, 1]),
    "max_depth": ({"max_depth": 3}, False, "all", None),
}


@pytest.mark.parametrize("grower", list(GROWERS))
@pytest.mark.parametrize("case", list(FN_CASES))
def test_one_tree_equals_jax(grower, case):
    over, cat, bag, fmask = FN_CASES[case]
    X, y, dskw = _data(cat)
    g, h = _grid(y, 2)
    b = _bag(bag, len(y))
    p = {**PARAMS, **over, "tpu_grower": grower}
    gj = lj.Booster(p, lj.Dataset(X, label=y, **dskw))._gbdt
    gt = lt.Booster({**p, **TORCH}, lt.Dataset(X, label=y, **dskw))._gbdt
    assert gt.grower == gj.grower == grower
    jfn, tfn = GROWERS[grower]
    fm_j = None if fmask is None else jnp.asarray(np.asarray(fmask, bool))
    fm_t = None if fmask is None else torch.tensor(fmask, dtype=torch.bool)
    tj, lor_j = jfn(gj.X_t, jnp.asarray(g), jnp.asarray(h), jnp.asarray(b),
                    gj.meta, cfg=gj.grow_cfg, feature_mask=fm_j)
    tt, lor_t = tfn(gt.X_t, torch.from_numpy(g), torch.from_numpy(h),
                    torch.from_numpy(b), gt.meta, gt.grow_cfg, fm_t,
                    hist_plan=gt.hist_plan)
    n = int(tj.num_leaves)
    assert tt.num_leaves == n > 3
    m = n - 1
    # one host read a split tried, none after the split that makes the
    # last leaf
    L = gt.grow_cfg.num_leaves
    assert tt.host_reads == (n if n < L else L - 1)
    for name in ("split_feature", "threshold_bin", "default_left",
                 "left_child", "right_child", "internal_count",
                 "split_parent_leaf", "split_is_cat"):
        np.testing.assert_array_equal(getattr(tt, name)[:m].numpy(),
                                      np.asarray(getattr(tj, name))[:m],
                                      err_msg=name)
    np.testing.assert_array_equal(
        tt.split_cat_bitset[:m].numpy().astype(np.uint32),
        np.asarray(tj.split_cat_bitset)[:m])
    np.testing.assert_array_equal(tt.leaf_count.numpy(),
                                  np.asarray(tj.leaf_count))
    for name, k in (("leaf_value", None), ("leaf_weight", None),
                    ("split_gain", m), ("internal_value", m),
                    ("internal_weight", m)):
        np.testing.assert_allclose(getattr(tt, name)[:k].numpy(),
                                   np.asarray(getattr(tj, name))[:k],
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(lor_t.numpy(), np.asarray(lor_j))
    if grower == "masked":
        # the masked grower's counts are exact in-bag counts
        np.testing.assert_array_equal(
            tt.leaf_count[:n].numpy(),
            np.bincount(lor_t.numpy(), weights=b > 0, minlength=n)[:n])
    if cat:
        assert tt.split_is_cat[:m].any()


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------
def assert_models_close(ta, tb, rtol=1e-5, counts=True):
    """Two model texts (parameters left out) field by field: the header,
    feature importances and structure exactly, decision_type without its
    default-left bit (C note 5), the counts within 1 (`counts`), the float
    fields within `rtol` (atol 1e-5)."""
    ha, ba, taila = _split_text(ta)
    hb, bb, tailb = _split_text(tb)
    assert [ln for ln in ha.splitlines() if not ln.startswith("tree_sizes")] \
        == [ln for ln in hb.splitlines() if not ln.startswith("tree_sizes")]
    assert taila == tailb and len(ba) == len(bb)
    for a, b in zip(ba, bb):
        assert set(a) == set(b)
        for k in _EXACT:
            assert a.get(k) == b.get(k), k
        da, db = (_nums(x.get("decision_type", "")).astype(int)
                  for x in (a, b))
        np.testing.assert_array_equal(da & ~2, db & ~2)
        for k in ("leaf_count", "internal_count") if counts else ():
            if k in a:
                assert np.max(np.abs(_nums(a[k]) - _nums(b[k]))) <= 1, k
        for k in _CLOSE:
            if k in a:
                np.testing.assert_allclose(_nums(b[k]), _nums(a[k]),
                                           rtol=rtol, atol=1e-5, err_msg=k)


RUN_CASES = {
    "binary": dict(objective="binary"),
    "multiclass": dict(objective="multiclass", num_class=3),
    "l1": dict(objective="regression_l1"),
    "dart": dict(objective="binary", boosting="dart", drop_rate=0.5,
                 skip_drop=0.0),
    "linear": dict(objective="binary", linear_tree=True),
}


def _label(name, X, y):
    if name == "multiclass":
        return np.digitize(X[:, 0] - X[:, 1], [-1.0, 1.0]).astype(np.float32)
    if name == "l1":
        return (X[:, 0] - 0.5 * X[:, 1]
                + np.where(y > 0, 0.5, -0.5)).astype(np.float32)
    return y


@pytest.mark.parametrize("name,grower", [
    ("binary", "masked"), ("binary", "compact"), ("multiclass", "masked"),
    ("dart", "masked"), ("l1", "compact"), ("linear", "compact")])
def test_training_matches_jax(grower, name):
    X, y, _ = _data()
    y = _label(name, X, y)
    p = {**PARAMS, **RUN_CASES[name], "tpu_grower": grower}
    bj = lj.train(p, lj.Dataset(X, label=y), 4)
    bt = lt.train({**p, **TORCH}, lt.Dataset(X, label=y), 4)
    assert bt._gbdt.grower == bj._gbdt.grower == grower
    assert bt._gbdt.grow_route == grower
    # softmax hessians are off the grid: JAX's f32 histogram sums of 2000
    # rows round its leaf weights by up to 3e-5 relative (C note 9)
    assert_models_close(bj.model_to_string(), bt.model_to_string(),
                        rtol=1e-4 if name == "multiclass" else 1e-5)
    pj = bj.predict(X, raw_score=True)
    np.testing.assert_allclose(bt.predict(X, raw_score=True), pj, rtol=0,
                               atol=1e-6 * (1 + np.abs(pj).max()))


def _first_divergence(t1, t2):
    """The first node whose split differs in structure (feature,
    threshold, bitset, children), or None."""
    for i in range(min(t1.num_leaves, t2.num_leaves) - 1):
        if (t1.split_feature[i] != t2.split_feature[i]
                or t1.threshold_in_bin[i] != t2.threshold_in_bin[i]
                or t1.left_child[i] != t2.left_child[i]
                or t1.right_child[i] != t2.right_child[i]):
            return i
        if t1.decision_type[i] & 1:
            c = int(t1.threshold_in_bin[i])
            s1 = t1.cat_threshold[t1.cat_boundaries[c]:
                                  t1.cat_boundaries[c + 1]]
            s2 = t2.cat_threshold[t2.cat_boundaries[c]:
                                  t2.cat_boundaries[c + 1]]
            if not np.array_equal(s1, s2):
                return i
    return None if t1.num_leaves == t2.num_leaves \
        else min(t1.num_leaves, t2.num_leaves) - 1


def test_compact_equals_masked():
    """JAX tests/test_grow_fast.py:106-132 in the port: the binary
    objective's hessians, numerical and categorical features. compact
    takes the larger child's histogram as parent minus smaller in f32,
    masked sums it directly, so the two can round apart at the last bit;
    as in the JAX test, trees must be the same split for split up to a
    first divergence whose two gains agree within 1e-4 relative (a float
    tie), and leaf values of equal trees within rtol 1e-4. The counts
    differ, as in the JAX package: masked's are exact, compact's the
    searches' synthesized ones."""
    X, y, dskw = _data(cat=True, n=3000)
    p = {**PARAMS, **TORCH, "min_data_per_group": 10}
    fast, slow = (lt.train({**p, "tpu_grower": gr},
                           lt.Dataset(X, label=y, **dskw), 5)._gbdt.models
                  for gr in ("compact", "masked"))
    equal = 0
    for t1, t2 in zip(fast, slow):
        div = _first_divergence(t1, t2)
        if div is None:
            np.testing.assert_allclose(t1.leaf_value, t2.leaf_value,
                                       rtol=1e-4, atol=1e-5)
            equal += 1
            continue
        np.testing.assert_allclose(t1.split_gain[div], t2.split_gain[div],
                                   rtol=1e-4)
        break
    assert equal >= 1


# ---------------------------------------------------------------------------
# the grower ladder and the switches to the wave grower
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pool,want", [(1.0, "wave"), (0.2, "compact"),
                                       (0.05, "masked"), (-1, "wave")])
def test_auto_ladder_picks_jax_grower(pool, want):
    """F = 7 features, B = 64, 15 leaves: one [L, 3, F, B] cache is 0.080
    MB, the wave grower's caches and temporaries 0.30 MB."""
    X, y, _ = _data(n=600)
    p = {**PARAMS, "histogram_pool_size": pool}
    gj = lj.Booster(p, lj.Dataset(X, label=y))._gbdt
    gt = lt.Booster({**p, **TORCH}, lt.Dataset(X, label=y))._gbdt
    assert gt.grower == gj.grower == want
    assert gt._grower_feasible == gj._grower_feasible


class _Sink:
    def __init__(self):
        self.lines = []

    def info(self, msg):
        pass

    def warning(self, msg):
        self.lines.append(msg)


def _warnings(mod, log, p, X, y):
    sink, prev = _Sink(), log._logger
    mod.register_logger(sink)
    try:
        g = mod.Booster(p, mod.Dataset(X, label=y))._gbdt
    finally:
        mod.register_logger(prev)
    return g.grower, [ln for ln in sink.lines if "grower" in ln]


def _efb_data(n=800):
    rng = np.random.RandomState(4)
    X = np.zeros((n, 6), np.float32)
    hot = rng.randint(0, 4, n)
    X[np.arange(n), hot] = 1.0
    X[:, 4:] = rng.normal(size=(n, 2))
    y = (hot % 2 + 0.3 * X[:, 4] > 0.5).astype(np.float32)
    return X, y


@pytest.mark.parametrize("case", ["quantized", "monotone", "forced", "cegb",
                                  "efb"])
def test_switch_to_wave_warns_as_jax(case, tmp_path):
    X, y, _ = _data(n=600)
    p = {**PARAMS, "verbose": 0, "tpu_grower": "masked"}
    if case == "quantized":
        p["use_quantized_grad"] = True
    elif case == "monotone":
        p["monotone_constraints"] = [1, 0, 0, 0, 0, 0, 0]
    elif case == "forced":
        fs = tmp_path / "fs.json"
        fs.write_text('{"feature": 0, "threshold": 0.0}')
        p["forcedsplits_filename"] = str(fs)
    elif case == "cegb":
        p["cegb_penalty_split"] = 0.5
    else:
        # a bundled dataset and a pool the serial growers would fit in
        X, y = _efb_data()
        p = {**PARAMS, "verbose": 0, "histogram_pool_size": 0.001}
    gr_j, wj = _warnings(lj, jlog, p, X, y)
    gr_t, wt = _warnings(lt, tlog, {**p, **TORCH}, X, y)
    assert gr_t == gr_j == "wave"
    assert wt == wj and wj
