"""The port's scikit-learn estimators (lightgbm_tpu_torch/sklearn.py) and
SHAP values (models/shap.py) held to the JAX package's: the six cases of
tests/test_sklearn.py run on both packages (the same classes, best
iteration and recorded metrics; predictions within 1e-5, and each port
estimator's model that of `lt.train` with its parameters, bit for bit);
the fallback label encoder and class weights, used where scikit-learn is
missing (the card's machine), equal scikit-learn's; pred_contrib of one
model text loaded into both packages gives the JAX package's feature
columns bit for bit, and each row sums to its raw score within 1e-10; and
a linear-tree model raises the JAX package's ValueError.

Two documented differences. The binary and multiclass cases label rows by
an exact function of two features, so tree 0 meets splits whose gains tie
in exact arithmetic, which each package decides by its own rounding
(ROADMAP C note 9; binary: node 8 splits feature 0 in JAX and feature 1
in the port, both at gain 1.9619598): there the test holds the
predictions' classes to JAX's, and their values on one model, the JAX
estimator's trees loaded into the port's estimator. And the expected-value
column of pred_contrib weighs each tree's leaves by count, as the
reference's Tree::ExpectedValue does and as the path fractions do; the
JAX package weighs them by hessian sums, so its rows miss the raw score
by up to 1.6e-4 here (ROADMAP C note 18)."""

import copy

import numpy as np
import pytest
import torch
from sklearn.base import clone
from sklearn.preprocessing import LabelEncoder
from sklearn.utils.class_weight import compute_sample_weight

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
import lightgbm_tpu_torch.sklearn as tsk
from lightgbm_tpu.runtime import autotune as jat
from lightgbm_tpu_torch.runtime import autotune as tat

torch.set_num_threads(1)

CPU = {"device_type": "cpu"}


@pytest.fixture(autouse=True)
def _isolate_autotune_cache(tmp_path, monkeypatch):
    """No decision of these runs reaches the user-level disk cache or
    another test's in-process cache, in either package."""
    monkeypatch.setenv("LIGHTGBM_TPU_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    saved = [(c, dict(c)) for c in (jat._MEM_CACHE, tat._MEM_CACHE)]
    for c, _ in saved:
        c.clear()
    yield
    for c, old in saved:
        c.clear()
        c.update(old)


def _regressor(pkg):
    rng = np.random.RandomState(0)
    X = rng.normal(size=(800, 10))
    y = X[:, 0] * 3 - X[:, 1] + 0.1 * rng.normal(size=800)
    reg = pkg.LGBMRegressor(n_estimators=30, num_leaves=15,
                            min_child_samples=5, **_kw(pkg))
    reg.fit(X, y)
    pred = reg.predict(X)
    assert np.corrcoef(pred, y)[0, 1] > 0.95
    assert reg.n_features_in_ == 10
    assert reg.feature_importances_.shape == (10,)
    assert reg.feature_importances_[0] > 0
    return reg, pred, X


def _binary(pkg):
    rng = np.random.RandomState(1)
    X = rng.normal(size=(600, 8))
    y_raw = np.where(X[:, 0] + X[:, 1] > 0, "pos", "neg")
    clf = pkg.LGBMClassifier(n_estimators=20, num_leaves=15, **_kw(pkg))
    clf.fit(X, y_raw)
    assert set(clf.classes_) == {"neg", "pos"} and clf.n_classes_ == 2
    proba = clf.predict_proba(X)
    assert proba.shape == (600, 2)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, rtol=1e-5)
    assert np.mean(clf.predict(X) == y_raw) > 0.9
    return clf, proba, X


def _multiclass(pkg):
    rng = np.random.RandomState(2)
    X = rng.normal(size=(900, 6))
    y = (X[:, 0] > 0.5).astype(int) + (X[:, 1] > 0).astype(int)
    clf = pkg.LGBMClassifier(n_estimators=15, num_leaves=7, **_kw(pkg))
    clf.fit(X, y)
    assert clf.n_classes_ == 3
    proba = clf.predict_proba(X)
    assert proba.shape == (900, 3)
    assert np.mean(clf.predict(X) == y) > 0.8
    return clf, proba, X


def _early_stopping(pkg):
    rng = np.random.RandomState(3)
    X = rng.normal(size=(1000, 10))
    y = X[:, 0] + 0.3 * rng.normal(size=1000)
    reg = pkg.LGBMRegressor(n_estimators=200, num_leaves=7,
                            learning_rate=0.2, **_kw(pkg))
    reg.fit(X[:700], y[:700], eval_set=[(X[700:], y[700:])],
            callbacks=[pkg.early_stopping(5, verbose=False)])
    assert 0 < reg.best_iteration_ <= 200
    assert "valid_0" in reg.evals_result_
    return reg, reg.predict(X[700:]), X[700:]


def _ranker(pkg):
    rng = np.random.RandomState(4)
    X = rng.normal(size=(100, 5))
    y = rng.randint(0, 3, size=100)
    with pytest.raises(ValueError):
        pkg.LGBMRanker(**_kw(pkg)).fit(X, y)
    rk = pkg.LGBMRanker(n_estimators=5, num_leaves=7, min_child_samples=3,
                        **_kw(pkg))
    rk.fit(X, y, group=[25, 25, 25, 25])
    pred = rk.predict(X)
    assert pred.shape == (100,)
    return rk, pred, X


def _params_clone(pkg):
    reg = pkg.LGBMRegressor(n_estimators=10, num_leaves=5, extra_param=1,
                            **_kw(pkg))
    params = reg.get_params()
    assert params["n_estimators"] == 10 and params["extra_param"] == 1
    reg.set_params(n_estimators=20)
    assert reg.n_estimators == 20
    assert clone(pkg.LGBMRegressor(n_estimators=7)).n_estimators == 7
    reg3 = clone(pkg.LGBMRegressor(reg_alpha=1.5, min_child_samples=5))
    assert reg3.reg_alpha == 1.5 and reg3.min_child_samples == 5
    return reg3, np.asarray([reg3.get_params()[k]
                             for k in ("reg_alpha", "min_child_samples")]), None


def _kw(pkg):
    return CPU if pkg is lt else {}


CASES = {"regressor": _regressor, "binary": _binary,
         "multiclass": _multiclass, "early_stopping": _early_stopping,
         "ranker": _ranker, "get_set_params_clone": _params_clone}
# tree 0 meets exactly tied split gains (ROADMAP C note 9)
TIED = ("binary", "multiclass")


@pytest.mark.parametrize("name", list(CASES))
def test_case_matches_jax(name):
    tm, tp, X = CASES[name](lt)
    jm, jp, _ = CASES[name](lj)
    if name in TIED:
        agree = np.mean(np.argmax(tp, axis=1) == np.argmax(jp, axis=1))
        assert agree >= 0.97, agree
        # label decoding and the link on one model: the JAX estimator's
        # trees in the port's estimator give its probabilities and classes
        shared = copy.copy(tm)
        shared._Booster = lt.Booster(
            params=CPU, model_str=jm.booster_.model_to_string())
        np.testing.assert_allclose(shared.predict_proba(X), jp, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(shared.predict(X), jm.predict(X))
    else:
        np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-5)
    if getattr(jm, "_Booster", None) is None:
        return
    if hasattr(jm, "classes_"):
        np.testing.assert_array_equal(tm.classes_, jm.classes_)
    assert tm.best_iteration_ == jm.best_iteration_
    assert tm.evals_result_.keys() == jm.evals_result_.keys()
    for vs in jm.evals_result_:
        assert tm.evals_result_[vs].keys() == jm.evals_result_[vs].keys()
    # the estimator is lt.train with its parameters
    if not tm.evals_result_:
        ref = lt.train(dict(tm.booster_.params), tm.booster_.train_set,
                       tm.n_estimators)
        assert ref.model_to_string() == tm.booster_.model_to_string()


@pytest.mark.parametrize("labels,unseen", [
    (np.array(["pos", "neg", "neg", "mid", "pos"]), "zz"),
    (np.array([3, -1, 7, 3, 0, 7]), 5),
    (np.array([0.5, 2.25, -1.0, 0.5, 1e-9]), 99.5),
], ids=["str", "int", "float"])
def test_fallback_label_encoder_equals_sklearn(labels, unseen):
    ours = tsk._LabelEncoder().fit(labels)
    ref = LabelEncoder().fit(labels)
    np.testing.assert_array_equal(ours.classes_, ref.classes_)
    np.testing.assert_array_equal(ours.transform(labels),
                                  ref.transform(labels))
    with pytest.raises(ValueError, match="unseen"):
        ours.transform(np.asarray([labels[0], unseen], labels.dtype))


def test_estimators_without_sklearn(monkeypatch):
    """With scikit-learn gone the classifier encodes its labels, weighs its
    classes and lists its parameters on the fallbacks: the same model as
    with scikit-learn."""
    rng = np.random.RandomState(6)
    X = rng.normal(size=(400, 4))
    y = np.where(X[:, 0] > 0.3, "b", np.where(X[:, 1] > 0, "a", "c"))
    kw = dict(n_estimators=5, num_leaves=7, class_weight="balanced", **CPU)
    with_sk = tsk.LGBMClassifier(**kw).fit(X, y)
    cw = {"a": 2.0, "c": 0.5}
    ref_w = compute_sample_weight(cw, y)
    monkeypatch.setattr(tsk, "_SKLEARN", False)
    np.testing.assert_allclose(tsk._class_sample_weight(cw, y), ref_w)
    np.testing.assert_allclose(tsk._class_sample_weight("balanced", y),
                               compute_sample_weight("balanced", y))
    without = tsk.LGBMClassifier(**kw).fit(X, y)
    assert isinstance(without._le, tsk._LabelEncoder)
    np.testing.assert_array_equal(without.classes_, with_sk.classes_)
    assert without.booster_.model_to_string() == \
        with_sk.booster_.model_to_string()
    assert without.get_params()["class_weight"] == "balanced"
    assert without.get_params()["device_type"] == "cpu"


def _contrib_models():
    rng = np.random.RandomState(8)
    X = rng.normal(size=(1500, 5))
    X[:, 2] = rng.randint(0, 9, size=1500)
    X[rng.rand(*X.shape) < 0.05] = np.nan
    yb = (X[:, 0] + (np.nan_to_num(X[:, 2]) % 3 == 1) > 0.3).astype(int)
    ym = np.digitize(X[:, 1], [-0.5, 0.5])
    p = {"num_leaves": 15, "verbosity": -1, "min_data_in_leaf": 10}
    binary = lj.train(dict(p, objective="binary"),
                      lj.Dataset(X, label=yb, categorical_feature=[2]), 6)
    multi = lj.train(dict(p, objective="multiclass", num_class=3),
                     lj.Dataset(X, label=ym), 4)
    q = rng.normal(size=(60, 5))
    q[:, 2] = rng.randint(-1, 12, size=60)
    q[rng.rand(*q.shape) < 0.1] = np.nan
    return {"binary": binary.model_to_string(),
            "multiclass": multi.model_to_string()}, q


def test_pred_contrib_equals_jax():
    texts, q = _contrib_models()
    F = q.shape[1]
    for name, text in texts.items():
        tb = lt.Booster(model_str=text)
        jb = lj.Booster(model_str=text)
        K = tb.num_model_per_iteration()
        for it0, n in ((0, None), (1, 2)):
            got = tb.predict(q, pred_contrib=True, start_iteration=it0,
                             num_iteration=n).reshape(len(q), K, F + 1)
            ref = jb.predict(q, pred_contrib=True, start_iteration=it0,
                             num_iteration=n).reshape(len(q), K, F + 1)
            np.testing.assert_array_equal(got[:, :, :F], ref[:, :, :F])
            # the expected value: leaves weighed by count in the port (the
            # reference's), by hessian sum in JAX
            trees = jb._gbdt.models
            end = len(trees) // K if n is None else it0 + n
            for k in range(K):
                ts = [trees[i * K + k] for i in range(it0, end)]
                by_count = sum(
                    float(np.sum(t.leaf_count / t.internal_count[0]
                                 * t.leaf_value)) for t in ts)
                by_weight = sum(t.expected_value() for t in ts)
                np.testing.assert_allclose(got[:, k, F], by_count,
                                           rtol=0, atol=1e-12)
                np.testing.assert_allclose(ref[:, k, F], by_weight,
                                           rtol=0, atol=1e-12)
            raw = tb.predict(q, raw_score=True, start_iteration=it0,
                             num_iteration=n).reshape(len(q), K)
            np.testing.assert_allclose(got.sum(axis=2), raw, rtol=0,
                                       atol=1e-10)


def test_pred_contrib_refuses_linear_trees():
    rng = np.random.RandomState(9)
    X = rng.normal(size=(600, 3))
    y = X[:, 0] * 2 + X[:, 1]
    bst = lt.train({"objective": "regression", "linear_tree": True,
                    "num_leaves": 4, "verbosity": -1, **CPU},
                   lt.Dataset(X, label=y), 3)
    with pytest.raises(ValueError) as te:
        bst.predict(X[:5], pred_contrib=True)
    with pytest.raises(ValueError) as je:
        lj.Booster(model_str=bst.model_to_string()).predict(
            X[:5], pred_contrib=True)
    assert str(te.value) == str(je.value)
