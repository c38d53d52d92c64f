"""End to end on the wave-apply route: `lt.train` against
`lightgbm_tpu.train` on the CPU for wide numeric data (F = 48), a
categorical mix, EFB-bundled sparse data and the row-wise histogram
layouts; model files across packages; a JAX categorical model carried
across with `booster_from_state`.

The data has well separated best gains, so both packages grow the same
trees; what may differ is float rounding (the port accumulates histograms
in f64, the JAX CPU reference in f32: ROADMAP C note 1). Compared:
  * tree structure, thresholds and categorical bitsets (cat_boundaries /
    cat_threshold) exactly, and decision types except their default-left
    bit: where a node's missing bin holds no rows both scan directions
    give the same split and the last bit of the sums picks one (ROADMAP C
    note 5); where it holds rows (column 3 of the wide data has NaNs) the
    predictions check it;
  * leaf and internal values, weights and gains within rtol 1e-4 (as
    tests/test_torch_train.py: f32 sums added in another order, then
    subtracted parent minus child down the tree), or 1e-5 absolute where a
    leaf's gradient sum cancels to near 0;
  * counts (synthesized from hessians, then rounded) within +-1;
  * predictions within rtol 1e-5 (raw scores also 1e-6 absolute): the
    leaf values above summed over the rounds.
The JAX package's CPU route runs every histogram_impl as the same XLA
lowering, so the row-wise layouts are held to its default run.
"""

import numpy as np
import torch
import pytest

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.convert import booster_from_state
from lightgbm_tpu_torch.utils.synthetic import efb_like

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

PARAMS = dict(objective="binary", num_leaves=15, max_bin=63,
              learning_rate=0.1, min_data_in_leaf=20, verbose=-1,
              bagging_freq=0)
TORCH = {"device_type": "cpu", "binning_impl": "host"}
ROUNDS = 2


def _tree_blocks(text):
    body = text.split("end of trees")[0]
    return [dict(ln.split("=", 1) for ln in blk.splitlines()[1:] if "=" in ln)
            for blk in body.split("Tree=")[1:]]


def _nums(s, dtype=float):
    return np.array(s.split(), dtype=dtype)


def _assert_same_trees(text_t, text_j, n=ROUNDS):
    tt, tj = _tree_blocks(text_t), _tree_blocks(text_j)
    assert len(tt) == len(tj) == n
    for a, b in zip(tt, tj):
        assert a.keys() == b.keys()
        for k in ("num_leaves", "num_cat", "split_feature", "threshold",
                  "left_child", "right_child", "cat_boundaries",
                  "cat_threshold", "shrinkage"):
            assert a.get(k) == b.get(k), k
        np.testing.assert_array_equal(_nums(a["decision_type"], int) & ~2,
                                      _nums(b["decision_type"], int) & ~2)
        for k in ("split_gain", "leaf_value", "leaf_weight",
                  "internal_value", "internal_weight"):
            np.testing.assert_allclose(_nums(a[k]), _nums(b[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        for k in ("leaf_count", "internal_count"):
            assert np.abs(_nums(a[k], int) - _nums(b[k], int)).max() <= 1


def _train_both(X, y, dskw=None, over=None, jax_booster=None):
    dskw = dskw or {}
    bj = jax_booster or lj.train(PARAMS, lj.Dataset(X, label=y, **dskw),
                                 num_boost_round=ROUNDS)
    bt = lt.train({**PARAMS, **TORCH, **(over or {})},
                  lt.Dataset(X, label=y, **dskw), num_boost_round=ROUNDS)
    return bj, bt


def _assert_same_model(X, bj, bt):
    _assert_same_trees(bt.model_to_string(), bj.model_to_string())
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-5)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module")
def wide():
    rng = np.random.RandomState(0)
    N, F = 3000, 48
    X = rng.normal(size=(N, F)).astype(np.float32)
    X[rng.rand(N) < 0.1, 3] = np.nan
    w = np.zeros(F)
    w[:8] = [3.0, -2.5, 2.0, 1.6, -1.3, 1.0, 0.8, -0.6]
    y = (np.nan_to_num(X) @ w + rng.normal(scale=0.3, size=N) > 0) \
        .astype(np.float32)
    bj = lj.train(PARAMS, lj.Dataset(X, label=y), num_boost_round=ROUNDS)
    return X, y, bj


@pytest.fixture(scope="module")
def cat():
    """Two categoricals (12 and 30 categories, one-hot and sorted
    many-vs-many modes) with distinct per-category effects, a 3-category
    one, and numeric columns."""
    rng = np.random.RandomState(1)
    N = 4000
    c0 = rng.randint(0, 12, N)
    c1 = rng.randint(0, 30, N)
    c2 = rng.randint(0, 3, N)
    Xn = rng.normal(size=(N, 4))
    z = (np.linspace(-2.0, 2.2, 12)[c0] + np.sin(np.arange(30) * 1.7)[c1]
         + np.array([-0.7, 0.1, 0.9])[c2] + 0.8 * Xn[:, 0])
    y = (z + rng.normal(scale=0.3, size=N) > 0).astype(np.float32)
    X = np.column_stack([c0, c1, c2, Xn]).astype(np.float32)
    X[rng.rand(N) < 0.02, 1] = np.nan
    kw = dict(categorical_feature=[0, 1, 2])
    bj = lj.train(PARAMS, lj.Dataset(X, label=y, **kw),
                  num_boost_round=ROUNDS)
    return X, y, kw, bj


def test_wide_numeric_matches_jax(wide):
    X, y, bj = wide
    _, bt = _train_both(X, y, jax_booster=bj)
    assert bt._gbdt.grow_route == "apply" and bt._gbdt.X_t.shape[0] == 48
    _assert_same_model(X, bj, bt)


@pytest.mark.parametrize("over,route", [
    ({"force_row_wise": True}, "rowwise"),
    ({"histogram_impl": "rowwise_packed", "max_bin": 63}, "rowwise")])
def test_row_wise_layouts_match_jax(wide, over, route):
    """force_row_wise and rowwise_packed on the wide data (no column fits
    a nibble, so rowwise_packed runs the plain row-wise layout)."""
    X, y, bj = wide
    _, bt = _train_both(X, y, over=over, jax_booster=bj)
    assert bt._gbdt.hist_route == route
    _assert_same_model(X, bj, bt)


def test_categorical_matches_jax(cat):
    X, y, kw, bj = cat
    _, bt = _train_both(X, y, kw, jax_booster=bj)
    g = bt._gbdt
    assert g.grow_route == "apply" and g.grow_cfg.has_categorical
    assert all(t.num_cat > 0 for t in g.models)
    _assert_same_model(X, bj, bt)


def test_categorical_model_files_cross_load(tmp_path, cat):
    X, y, kw, bj = cat
    _, bt = _train_both(X, y, kw, jax_booster=bj)
    ft, fj = tmp_path / "port.txt", tmp_path / "jax.txt"
    bt.save_model(str(ft))
    bj.save_model(str(fj))
    np.testing.assert_allclose(lj.Booster(model_file=str(ft)).predict(X),
                               bt.predict(X), rtol=0, atol=1e-12)
    np.testing.assert_allclose(lt.Booster(model_file=str(fj)).predict(X),
                               bj.predict(X), rtol=0, atol=1e-12)
    rt = lt.Booster(model_str=bt.model_to_string())
    np.testing.assert_array_equal(rt.predict(X), bt.predict(X))


def test_categorical_state_carried_across(cat):
    """A JAX categorical model rebuilt in the port predicts the same,
    unseen and negative categories included."""
    X, _, _, bj = cat
    g = bj._gbdt
    bst = booster_from_state(
        params=bj.params, trees=[vars(t) for t in g.models],
        mappers=[m.to_dict() for m in g.mappers],
        real_feature_index=g.real_feature_index,
        feature_names=g.feature_names_,
        num_total_features=g.max_feature_idx_ + 1)
    Xo = X.copy()
    Xo[:50, 0] = 77.0
    Xo[50:100, 1] = -3.0
    for Z in (X, Xo):
        np.testing.assert_allclose(bst.predict(Z), bj.predict(Z), rtol=0,
                                   atol=1e-12)
    assert _tree_blocks(bst.model_to_string()) \
        == _tree_blocks(bj.model_to_string())


def test_efb_bundled_matches_jax():
    X, y = efb_like(3000, n_sparse=24, n_dense=6)
    bj, bt = _train_both(X, y)
    h = bt.train_set._handle
    assert h.bundles is not None and bt._gbdt.X_t.shape[0] < X.shape[1]
    assert bt._gbdt.grow_route == "apply"
    _assert_same_model(X, bj, bt)


def test_categorical_valid_set_scores(cat):
    """The valid-set walk over raw bins (categorical bitsets included)
    keeps the scores a fresh predict gives."""
    X, y, kw, _ = cat
    p = {**PARAMS, **TORCH, "metric": "auc"}
    dtr = lt.Dataset(X[:3000], label=y[:3000], params=p, **kw)
    dva = lt.Dataset(X[3000:], label=y[3000:], reference=dtr, params=p)
    bst = lt.train(p, dtr, num_boost_round=3, valid_sets=[dva],
                   valid_names=["va"])
    assert any(t.num_cat > 0 for t in bst._gbdt.models)
    raw = bst.predict(X[3000:], raw_score=True)
    kept = bst._gbdt._valid_scores[0][0].numpy()
    np.testing.assert_allclose(raw, kept, rtol=0, atol=1e-5)
    assert bst.eval_valid()[0][2] > 0.9
