"""Random forests and DART in the port against the JAX package on the CPU.

Each case trains both packages on the same seeded data and compares:
  * the model text up to the parameter echo. Where every gradient of every
    tree lies on a 1/64 grid (RF from a grid-valued start) the texts are
    equal byte for byte. Elsewhere the JAX package's f32
    histogram sums and the port's f64 ones round differently (ROADMAP C
    note 9), so the text is compared field by field: the header, the
    structure (split features, thresholds, children, categorical bitsets,
    shrinkage) exactly, decision_type without its default-left bit
    (where a node's missing bin holds no rows both scan directions give
    the same split and the last bit of the sums picks one, C note 5; where
    it holds rows the predictions below check it), counts within 1, and
    gains, leaf and internal values and weights within rtol 1e-5 and
    atol 1e-5;
  * raw predictions of the rows, which have NaNs, within 1e-6 times their
    scale, 1 + max |raw| (rf's trees are unshrunk, with values near 2);
  * for DART, the drop set of every iteration exactly (both draw from
    NumPy's RandomState(drop_seed)), and the valid set's kept scores
    against the JAX package's within 1e-6.
The fatals of rf and of dart with linear_tree carry the JAX package's
messages.
"""

import numpy as np
import torch
import pytest

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.utils.log import FatalError as JaxFatal
from lightgbm_tpu_torch.utils.log import FatalError

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

TORCH = {"device_type": "cpu", "binning_impl": "host"}
BASE = dict(num_leaves=15, max_bin=63, min_data_in_leaf=20, verbose=-1)
BAG = dict(bagging_fraction=0.8, bagging_freq=1)


def _data():
    """2000 rows of 6 features, NaN in feature 2; a binary label, a
    3-class label, a label on a 1/64 grid with mean 0.5, and weights on a
    1/2 grid; rows 1500 on are a valid set."""
    rng = np.random.RandomState(3)
    n = 2000
    X = rng.normal(size=(n, 6)).astype(np.float32)
    X[rng.rand(n) < 0.1, 2] = np.nan
    z = 2 * X[:, 0] - X[:, 1] + np.nan_to_num(X[:, 2]) + 0.5 * X[:, 3]
    yb = (z + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    y3 = np.digitize(z, [-1.0, 1.0]).astype(np.float32)
    units = np.round(np.clip(z, -3, 3) * 8).astype(np.int64) + 32
    short = 32 * n - int(units.sum())     # in 1/64 units: the mean 0.5
    units[:abs(short)] += np.sign(short)
    yg = (units / 64).astype(np.float32)
    w = (rng.randint(1, 5, n) / 2).astype(np.float32)
    return X, {"binary": yb, "multiclassova": y3, "regression": yg}, w


X, LABELS, W = _data()

# name: (params, rounds, weighted, with a valid set, texts equal bitwise)
CASES = {
    "rf_binary": (dict(objective="binary", boosting="rf", **BAG), 5, True,
                  False, False),
    "rf_multiclassova": (dict(objective="multiclassova", num_class=3,
                              boosting="rf", **BAG), 4, True, False, False),
    "rf_regression_grid": (dict(objective="regression", boosting="rf",
                                **BAG), 5, False, False, True),
    "dart_weighted": (dict(objective="binary", boosting="dart",
                           drop_rate=0.5, skip_drop=0.0), 5, True, True,
                      False),
    "dart_uniform_max_drop": (dict(objective="binary", boosting="dart",
                                   drop_rate=0.6, skip_drop=0.0,
                                   uniform_drop=True, max_drop=1), 5, False,
                              True, False),
    "dart_xgboost_mode": (dict(objective="binary", boosting="dart",
                               drop_rate=0.5, skip_drop=0.2,
                               xgboost_dart_mode=True, drop_seed=7), 5,
                          True, False, False),
}


def _train(mod, name):
    p, rounds, weighted, valid, _ = CASES[name]
    p = {**BASE, **p, **(TORCH if mod is lt else {})}
    y = LABELS[p["objective"]]
    w = W if weighted else None
    n = 1500 if valid else len(y)
    ds = mod.Dataset(X[:n], label=y[:n], weight=None if w is None else w[:n])
    sets = [mod.Dataset(X[n:], label=y[n:], reference=ds)] if valid else []
    drops = []

    def keep(env):
        drops.append(list(getattr(env.model._gbdt, "_drop_index", [])))
    bst = mod.train(p, ds, rounds, valid_sets=sets, callbacks=[keep])
    return bst, drops


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = (_train(lj, name), _train(lt, name))
        return cache[name]
    return get


def _split_text(text):
    body = text.split("\nparameters:")[0]
    head, _, rest = body.partition("\nTree=")
    trees, _, tail = ("Tree=" + rest).partition("end of trees")
    blocks = [dict(ln.split("=", 1) for ln in blk.splitlines()[1:]
                   if "=" in ln) for blk in trees.split("Tree=")[1:]]
    return head, blocks, tail


def _nums(s):
    return np.array(s.split(), dtype=np.float64)


_EXACT = ("num_leaves", "num_cat", "split_feature", "threshold",
          "left_child", "right_child", "cat_boundaries", "cat_threshold",
          "shrinkage", "is_linear", "leaf_features")
_CLOSE = ("split_gain", "leaf_value", "leaf_weight", "internal_value",
          "internal_weight", "leaf_const", "leaf_coeff")


def assert_text_close(tj, tt):
    """The model texts (parameters left out) field by field."""
    hj, bj, tailj = _split_text(tj)
    ht, bt, tailt = _split_text(tt)
    strip = [ln for ln in hj.splitlines() if not ln.startswith("tree_sizes")]
    assert strip == [ln for ln in ht.splitlines()
                     if not ln.startswith("tree_sizes")]
    assert tailj == tailt                         # feature importances
    assert len(bj) == len(bt)
    for a, b in zip(bj, bt):
        assert set(a) == set(b)
        for k in _EXACT:
            assert a.get(k) == b.get(k), k
        da, db = (_nums(x.get("decision_type", "")).astype(int)
                  for x in (a, b))
        np.testing.assert_array_equal(da & ~2, db & ~2)
        for k in ("leaf_count", "internal_count"):
            if k in a:
                assert np.max(np.abs(_nums(a[k]) - _nums(b[k]))) <= 1, k
        for k in _CLOSE:
            if k in a:
                np.testing.assert_allclose(_nums(b[k]), _nums(a[k]),
                                           rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_trees_and_predictions_match_jax(runs, name):
    (bj, dj), (bt, dt) = runs(name)
    exact = CASES[name][4]
    tj, tt = bj.model_to_string(), bt.model_to_string()
    if exact:
        assert tt.split("\nparameters:")[0] == tj.split("\nparameters:")[0]
    else:
        assert_text_close(tj, tt)
    if name.startswith("rf"):
        assert "\naverage_output\n" in tt
    assert bt.num_model_per_iteration() == bj.num_model_per_iteration()
    pj = bj.predict(X, raw_score=True)
    np.testing.assert_allclose(bt.predict(X, raw_score=True), pj, rtol=0,
                               atol=1e-6 * (1 + np.abs(pj).max()))
    # the kept training scores are the model's raw predictions (averaged
    # for rf, where scores hold the sum of the trees)
    g = bt._gbdt
    n = g.num_data
    s = g.scores.numpy() / (g.iter if g.average_output else 1)
    np.testing.assert_allclose(
        s.T.squeeze(), bt.predict(X[:n], raw_score=True), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("dart")])
def test_dart_drop_sets_and_valid_scores(runs, name):
    (bj, dj), (bt, dt) = runs(name)
    assert dt == dj and any(dj)
    gj, gt = bj._gbdt, bt._gbdt
    assert gt.tree_weight_ == gj.tree_weight_
    assert gt.sum_weight_ == gj.sum_weight_
    for vj, vt in zip(gj._valid_scores, gt._valid_scores):
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0,
                                   atol=1e-6)
        # and the valid rows' raw predictions of the final model
        np.testing.assert_allclose(vt.numpy()[0],
                                   bt.predict(X[1500:], raw_score=True),
                                   rtol=0, atol=1e-5)


def test_dart_rollback_then_continue():
    """Roll DART's last iteration back (its tree's outputs leave the
    training and valid scores, through #2 on the CPU), then train on: the
    drop sets and trees the JAX package's same calls give."""
    out = []
    for mod in (lj, lt):
        bst, drops = _train(mod, "dart_weighted")
        bst.rollback_one_iter()
        g = bst._gbdt
        mid = (np.asarray(g.scores)[0].copy(),
               np.asarray(g._valid_scores[0])[0].copy(),
               bst.predict(X, raw_score=True))
        bst.update()
        out.append((bst, mid, drops + [list(g._drop_index)]))
    (bj, (sj, vj, _), dj), (bt, (st, vt, p4), dt) = out
    assert dt == dj
    np.testing.assert_allclose(st, p4[:1500], rtol=0, atol=1e-5)
    np.testing.assert_allclose(vt, p4[1500:], rtol=0, atol=1e-5)
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-6)
    assert_text_close(bj.model_to_string(), bt.model_to_string())


def test_rf_eval_sees_averaged_scores(runs):
    (bj, _), (bt, _) = runs("rf_binary")
    ej = bj.eval_train()
    et = bt.eval_train()
    assert [e[:2] for e in et] == [e[:2] for e in ej]
    np.testing.assert_allclose([e[2] for e in et], [e[2] for e in ej],
                               rtol=1e-6)


@pytest.mark.parametrize("over,msg", [
    (dict(boosting="rf"), "requires 0 < bagging_fraction < 1"),
    (dict(boosting="rf", objective="none", **BAG),
     "does not support custom objective"),
    (dict(boosting="dart", linear_tree=True),
     "boosting=dart with linear_tree is not supported"),
])
def test_fatals_match_jax(over, msg):
    p = {**BASE, "objective": "binary", **over}
    y = LABELS["binary"]
    with pytest.raises(JaxFatal, match=msg) as ej:
        lj.train(p, lj.Dataset(X, label=y), 1)
    with pytest.raises(FatalError, match=msg) as et:
        lt.train({**p, **TORCH}, lt.Dataset(X, label=y), 1)
    assert str(et.value) == str(ej.value)
