"""The API surface of the port against the JAX package on the CPU: the
Booster's num_model_per_iteration, model_from_string, dump_model,
free_dataset and free_network (rollback_one_iter is held to the JAX
package in test_torch_boosting_modes.py and test_torch_linear.py); the Dataset's getters,
setters, subset and add_features_from; cv with CVBooster; resolve_params at
the module level.

Exact: the JSON dump of one model text, subset bins and metadata, the
merged bins of add_features_from, fold membership. Within tolerance: the
cv folds' trees grown by both packages (structure exactly, leaf values
within 1e-5: f32 against f64 histogram sums, ROADMAP C note 9), cv's
per-round means and standard deviations within 1e-6. Each JAX training
costs seconds of compilation, so the subset and the merged Dataset train
in the port only, against a Dataset binned from the same rows.
"""

import numpy as np
import torch
import pytest

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

TORCH = {"device_type": "cpu", "binning_impl": "host"}
PARAMS = dict(objective="binary", num_leaves=7, max_bin=63,
              min_data_in_leaf=20, learning_rate=0.2, verbose=-1)


def _data():
    """1500 rows of 6 features, NaN in feature 2, feature 5 categorical
    (8 categories, three of which move the label)."""
    rng = np.random.RandomState(5)
    n = 1500
    X = rng.normal(size=(n, 6)).astype(np.float32)
    X[rng.rand(n) < 0.1, 2] = np.nan
    X[:, 5] = rng.randint(0, 8, n)
    z = 2 * X[:, 0] - X[:, 1] + 0.5 * np.nan_to_num(X[:, 2]) \
        + 1.5 * np.isin(X[:, 5], [1, 4, 6])
    y = (z + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    w = (rng.randint(1, 5, n) / 2).astype(np.float32)
    return X, y, w


X, Y, W = _data()
CAT = {"categorical_feature": [5]}


def _same_trees(mj, mt):
    assert len(mj) == len(mt)
    for a, b in zip(mj, mt):
        for k in ("num_leaves", "split_feature", "threshold", "left_child",
                  "right_child", "cat_boundaries", "cat_threshold"):
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k),
                                          err_msg=k)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=0,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def trained():
    """3 rounds of the port with a valid set; the JAX package reads its
    model text."""
    ds = lt.Dataset(X[:1200], label=Y[:1200], **CAT)
    va = lt.Dataset(X[1200:], label=Y[1200:], reference=ds, **CAT)
    bt = lt.train({**PARAMS, **TORCH}, ds, 3, valid_sets=[va])
    return lj.Booster(model_str=bt.model_to_string()), bt


def test_booster_methods(trained):
    bj, bt = trained
    assert bt.num_model_per_iteration() == bj.num_model_per_iteration() == 1
    assert bt.free_dataset() is bt and bt.free_network() is bt
    text = bt.model_to_string()
    other = lt.Booster({**PARAMS, **TORCH}, lt.Dataset(X, label=Y))
    assert other.model_from_string(text) is other
    assert other.num_trees() == 3
    np.testing.assert_array_equal(other.predict(X), bt.predict(X))
    m3 = lt.Booster(model_str=lt.train(
        {**PARAMS, **TORCH, "objective": "multiclass", "num_class": 3},
        lt.Dataset(X, label=np.digitize(X[:, 0], [-0.5, 0.5])),
        1).model_to_string())
    assert m3.num_model_per_iteration() == 3
    assert lt.resolve_params({"eta": 0.3}).learning_rate == 0.3


@pytest.mark.parametrize("kw", [{}, {"num_iteration": 2},
                                {"start_iteration": 1,
                                 "importance_type": "gain"}])
def test_dump_model_equals_jax(trained, kw):
    _, bt = trained
    text = bt.model_to_string()
    dj = lj.Booster(model_str=text).dump_model(**kw)
    dt = lt.Booster(model_str=text, params=TORCH).dump_model(**kw)
    assert dt == dj
    assert bt.dump_model(**kw) == dt
    # categorical nodes dump their category lists
    assert any(n.get("decision_type") == "=="
               for n in _nodes(lt.Booster(model_str=text).dump_model()))


def _nodes(d):
    out = []
    for t in d["tree_info"]:
        stack = [t["tree_structure"]]
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(n[c] for c in ("left_child", "right_child")
                         if c in n)
    return out


def test_dataset_getters_and_setters():
    kw = dict(label=Y, weight=W, init_score=np.full(len(Y), 0.25),
              group=[500, 700, 300])
    dj, dt = lj.Dataset(X, **kw), lt.Dataset(X, params=TORCH, **kw)
    for name in ("get_label", "get_weight", "get_group", "get_init_score"):
        np.testing.assert_array_equal(getattr(dt, name)(),
                                      getattr(dj, name)())
    dj.construct()
    dt.construct()
    y2, w2 = 1 - Y, np.ones_like(W)
    for d in (dj, dt):
        assert d.set_label(y2) is d
        d.set_weight(w2).set_group([1000, 500]).set_init_score(
            np.zeros(len(Y)))
    for name in ("get_label", "get_weight", "get_group", "get_init_score"):
        np.testing.assert_array_equal(getattr(dt, name)(),
                                      getattr(dj, name)())
    np.testing.assert_array_equal(dt.get_label(), y2)
    np.testing.assert_array_equal(dt.get_group(), [1000, 500])
    md = dt._handle.metadata
    np.testing.assert_array_equal(md.query_boundaries, [0, 1000, 1500])
    np.testing.assert_array_equal(md.weight, w2)


def test_subset_bins_equal_jax():
    kw = dict(label=Y, weight=W, init_score=np.linspace(-1, 1, len(Y)),
              **CAT)
    dj = lj.Dataset(X, **kw).construct()
    dt = lt.Dataset(X, params=TORCH, **kw).construct()
    idx = np.random.RandomState(1).choice(len(Y), 900, replace=False)
    idx.sort()
    sj, st = dj.subset(idx), dt.subset(idx)
    hj, ht = sj._handle, st._handle
    np.testing.assert_array_equal(ht.X_binned, hj.X_binned)
    np.testing.assert_array_equal(ht.X_t.numpy(), ht.X_binned.T)
    for k in ("label", "weight", "init_score"):
        np.testing.assert_array_equal(getattr(ht.metadata, k),
                                      getattr(hj.metadata, k))
    assert st.num_data() == 900 and ht.mappers is dt._handle.mappers
    # a subset trains as a Dataset binned from its rows on the parent's
    # mappers does
    bs = lt.train({**PARAMS, **TORCH}, st, 2)
    br = lt.train({**PARAMS, **TORCH}, lt.Dataset(
        X[idx], label=Y[idx], weight=W[idx], init_score=kw["init_score"][idx],
        reference=dt, params=TORCH, **CAT), 2)
    assert bs.model_to_string() == br.model_to_string()
    # whole queries survive a subset; a split query is dropped
    g = [300, 600, 600]
    qt = lt.Dataset(X, label=Y, group=g, params=TORCH).construct()
    np.testing.assert_array_equal(
        qt.subset(np.arange(300, 1500)).get_group(), [600, 600])
    assert qt.subset(np.arange(0, 400)).get_group() is None


def test_add_features_from_equals_jax():
    out = []
    for mod, extra in ((lj, {}), (lt, TORCH)):
        a = mod.Dataset(X[:, :3], label=Y, params=dict(extra))
        b = mod.Dataset(X[:, 3:], label=Y, params=dict(extra), **{
            "categorical_feature": [2]})
        assert a.add_features_from(b) is a
        out.append(a)
    hj, ht = out[0]._handle, out[1]._handle
    np.testing.assert_array_equal(ht.X_binned, hj.X_binned)
    np.testing.assert_array_equal(ht.X_t.numpy(), ht.X_binned.T)
    assert ht.feature_names == hj.feature_names
    assert ht.real_feature_index == hj.real_feature_index
    assert out[1].num_feature() == out[0].num_feature() == 6
    # the merged Dataset trains on the wave-apply route (its categorical
    # column) as one built from all six columns does
    bm = lt.train({**PARAMS, **TORCH}, out[1], 2)
    whole = lt.Dataset(X, label=Y, params=TORCH, **CAT).construct()
    bw = lt.train({**PARAMS, **TORCH}, whole, 2)
    assert bm._gbdt.grow_route == "apply"
    _same_trees(bw._gbdt.models, bm._gbdt.models)


def test_cv_matches_jax():
    res = []
    for mod, extra in ((lj, {}), (lt, TORCH)):
        ds = mod.Dataset(X, label=Y, weight=W, free_raw_data=False,
                         params=dict(extra), **CAT)
        res.append(mod.cv({**PARAMS, **extra,
                           "metric": ["binary_logloss", "auc"]}, ds,
                          num_boost_round=3, nfold=3, stratified=True,
                          seed=4, return_cvbooster=True,
                          eval_train_metric=True))
    rj, rt = res
    keys = sorted(k for k in rj if k != "cvbooster")
    assert sorted(k for k in rt if k != "cvbooster") == keys
    assert "valid auc-mean" in keys and "train binary_logloss-stdv" in keys
    for k in keys:
        assert len(rt[k]) == 3
        np.testing.assert_allclose(rt[k], rj[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    cbt = rt["cvbooster"]
    assert isinstance(cbt, lt.CVBooster) and len(cbt.boosters) == 3
    assert cbt.num_trees() == [3, 3, 3]
    for bj, bt in zip(rj["cvbooster"].boosters, cbt.boosters):
        _same_trees(bj._gbdt.models, bt._gbdt.models)


@pytest.mark.parametrize("kind", ["stratified", "shuffled", "groups"])
def test_folds_equal_jax(kind):
    from lightgbm_tpu.engine import _make_n_folds as folds_j
    from lightgbm_tpu_torch.engine import _make_n_folds as folds_t
    kw = {"group": [300, 200, 400, 100, 500]} if kind == "groups" else {}
    out = []
    for mod, fn, extra in ((lj, folds_j, {}), (lt, folds_t, TORCH)):
        ds = mod.Dataset(X, label=Y, params=dict(extra), **kw)
        out.append(list(fn(ds, 3, {}, kind == "stratified", True, 7)))
    for (aj, bj_, gj), (at, bt_, gt) in zip(*out):
        np.testing.assert_array_equal(at, aj)
        np.testing.assert_array_equal(bt_, bj_)
        assert (gj is None) == (gt is None)
        if gj is not None:
            np.testing.assert_array_equal(gt, gj)


def test_cv_early_stopping_and_raw_data():
    ds = lt.Dataset(X, label=Y, free_raw_data=False, params=TORCH)
    r = lt.cv({**PARAMS, **TORCH, "metric": "binary_logloss",
               "learning_rate": 2.0, "early_stopping_round": 1}, ds,
              num_boost_round=20, nfold=3, return_cvbooster=True)
    n = len(r["valid binary_logloss-mean"])
    assert n < 20 and r["cvbooster"].best_iteration == n
    with pytest.raises(ValueError, match="free_raw_data=False"):
        lt.cv({**PARAMS, **TORCH}, lt.Dataset(X, label=Y, params=TORCH), 2)


@pytest.mark.parametrize("call,item", [
    (lambda p: lt.Dataset(None, params=TORCH).init_streaming(), "A13"),
    (lambda p: lt.Dataset(None, params=TORCH).push_rows(X), "A13"),
    (lambda p: lt.Dataset(None, params=TORCH).mark_finished(), "A13"),
])
def test_surface_left_out_raises(tmp_path, call, item):
    # streaming Datasets are ROADMAP item A13; text files are ported
    # (tests/test_torch_loader.py)
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        call(tmp_path)
