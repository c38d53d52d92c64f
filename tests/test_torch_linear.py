"""Linear trees (linear_tree=True) in the port against the JAX package on
the CPU: training on the megakernel and wave-apply routes, with NaN rows,
bagging and a valid set, the model text, refit, continued training from a
linear model, and rollback_one_iter.

The labels lie on a 1/64 grid and the scores start at zero, so the first
tree's gradients are exact in both packages and its leaf values equal; from
then on every row's score is the linear model's output, which the same host
fit (models/linear.py, f64 NumPy in both packages) computes from the same
f32 gradients. So the coefficients and constants compare within rtol 1e-9
(they come out equal), while the leaf values of later trees, which are
f32 histogram sums in the JAX package and f64 in the port (ROADMAP C note
9), compare within 1e-5. A row with NaN in a leaf's feature takes that
constant leaf value instead of the linear output, so with NaN rows the
later trees' gradients carry those last bits too, and their coefficients
compare within rtol 1e-6. The trees' structures compare exactly (the
decision types without the default-left bit, C note 5), the predictions
within 1e-6.
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
BASE = dict(objective="regression", num_leaves=7, max_bin=63,
            min_data_in_leaf=50, learning_rate=0.5, boost_from_average=False,
            linear_tree=True, verbose=-1)
CAT = 4


def _data(seed, nan):
    """2000 rows of 6 features, feature 4 holding 6 categories (two of
    them, not three, move the label: an even split of the categories
    would tie with its complement, C note 9), NaN in 5% of feature 1 where
    `nan`; the label on a 1/64 grid. Rows 1600 on are held out."""
    rng = np.random.RandomState(seed)
    n = 2000
    X = rng.normal(size=(n, 6)).astype(np.float32)
    if nan:
        X[rng.rand(n) < 0.05, 1] = np.nan
    X[:, CAT] = rng.randint(0, 6, n)
    z = 2 * X[:, 0] - np.nan_to_num(X[:, 1]) + X[:, 2] * X[:, 3] \
        + 2 * (X[:, CAT] % 3 == 0)
    y = np.round((z + rng.normal(scale=0.3, size=n)) * 64) / 64
    return X, y.astype(np.float32)


# name: (params, seed, NaN rows, categorical column, valid set, route)
CASES = {
    "mega": (dict(), 0, False, False, False, "mega"),
    "apply_categorical": (dict(), 0, False, True, False, "apply"),
    "nan_bagging_valid": (dict(bagging_fraction=0.8, bagging_freq=1), 0,
                          True, True, True, "apply"),
}
ROUNDS = 4


def _ds(mod, name, rows=slice(0, 1600), **kw):
    _, seed, nan, cat, _, _ = CASES[name]
    X, y = _data(seed, nan)
    cats = {"categorical_feature": [CAT]} if cat else {}
    return mod.Dataset(X[rows], label=y[rows], **cats, **kw)


def _params(mod, name):
    return {**BASE, **CASES[name][0], **(TORCH if mod is lt else {})}


def _train(mod, name, rounds=ROUNDS, **kw):
    ds = _ds(mod, name, free_raw_data=False)
    # a valid set keeps its raw values under linear_tree in its own params
    sets = [_ds(mod, name, slice(1600, None), reference=ds,
                params=_params(mod, name))] if CASES[name][4] else []
    return mod.train(_params(mod, name), ds, rounds, valid_sets=sets, **kw)


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = (_train(lj, name), _train(lt, name))
        return cache[name]
    return get


def _coef_rtol(name):
    return 1e-6 if CASES[name][2] else 1e-9


def _body(text):
    return text.split("\nparameters:")[0]


def assert_same_linear_trees(tj, tt, coef_rtol):
    assert len(tj) == len(tt)
    for a, b in zip(tj, tt):
        for k in ("num_leaves", "split_feature", "threshold", "left_child",
                  "right_child", "cat_boundaries", "cat_threshold"):
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k),
                                          err_msg=k)
        # the default-left bit aside (C note 5; the predictions over rows
        # with NaNs check it where it matters)
        np.testing.assert_array_equal(b.decision_type & ~2,
                                      a.decision_type & ~2)
        assert b.is_linear and a.is_linear
        assert b.leaf_features == a.leaf_features
        np.testing.assert_allclose(b.leaf_const, a.leaf_const,
                                   rtol=coef_rtol, atol=0)
        for ca, cb in zip(a.leaf_coeff, b.leaf_coeff):
            np.testing.assert_allclose(cb, ca, rtol=coef_rtol, atol=0)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_linear_trees_match_jax(runs, name):
    bj, bt = runs(name)
    assert bt._gbdt.grow_route == CASES[name][5]
    tj, tt = bj._gbdt.models, bt._gbdt.models
    assert_same_linear_trees(tj, tt, _coef_rtol(name))
    # the first tree stays constant; later ones are linear, and never in
    # the categorical column
    assert not any(tt[0].leaf_features)
    assert all(any(t.leaf_features) for t in tt[1:])
    if CASES[name][3]:
        assert all(CAT not in fs for t in tt for fs in t.leaf_features)
    X, _ = _data(CASES[name][1], CASES[name][2])
    pt = bt.predict(X, raw_score=True)
    np.testing.assert_allclose(pt, bj.predict(X, raw_score=True), rtol=0,
                               atol=1e-6)
    # the kept training (and valid) scores are the model's outputs
    np.testing.assert_allclose(bt._gbdt.scores[0].numpy(), pt[:1600],
                               rtol=0, atol=1e-5)
    for vj, vt in zip(bj._gbdt._valid_scores, bt._gbdt._valid_scores):
        np.testing.assert_allclose(vt[0].numpy(), np.asarray(vj)[0],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(vt[0].numpy(), pt[1600:], rtol=0,
                                   atol=1e-5)
    assert len(bt._gbdt.linear_fit_ms) == ROUNDS


def test_model_text_round_trip(runs):
    bj, bt = runs("nan_bagging_valid")
    text = bt.model_to_string()
    assert "is_linear=1" in text and "leaf_coeff=" in text
    X, _ = _data(0, True)
    back = lt.Booster(model_str=text, params=TORCH)
    assert _body(back.model_to_string()) == _body(text)
    np.testing.assert_array_equal(back.predict(X), bt.predict(X))
    # the JAX package reads the port's text to the same predictions
    np.testing.assert_array_equal(lj.Booster(model_str=text).predict(X),
                                  bt.predict(X))
    # and the state conversion keeps the linear leaves
    from lightgbm_tpu_torch.convert import booster_from_state
    g = bj._gbdt
    conv = booster_from_state(
        params=bj.params, trees=[vars(t) for t in g.models],
        mappers=[m.to_dict() for m in g.mappers],
        real_feature_index=g.real_feature_index,
        feature_names=g.feature_names_,
        num_total_features=g.max_feature_idx_ + 1)
    np.testing.assert_array_equal(conv.predict(X, raw_score=True),
                                  bj.predict(X, raw_score=True))


@pytest.mark.parametrize("decay", [0.9, 1.0])
def test_refit_matches_jax(runs, decay):
    bj, _ = runs("nan_bagging_valid")
    text = bj.model_to_string()
    X, y = _data(0, True)
    Xh, yh = X[1600:], y[1600:]
    rj = lj.Booster(model_str=text, params=_params(lj, "mega")).refit(
        Xh, yh, decay_rate=decay)
    rt = lt.Booster(model_str=text, params=_params(lt, "mega")).refit(
        Xh, yh, decay_rate=decay)
    assert_same_linear_trees(rj._gbdt.models, rt._gbdt.models, 1e-9)
    if decay == 1.0:
        assert _body(rt.model_to_string()) == _body(text)
    else:
        moved = [np.max(np.abs(np.asarray(a.leaf_const) - b.leaf_const))
                 for a, b in zip(rt._gbdt.models, bj._gbdt.models)]
        assert max(moved) > 0


def test_init_model_from_linear_model(runs):
    bj, bt = runs("apply_categorical")
    ds_t = _ds(lt, "apply_categorical")
    cj = lj.train(_params(lj, "apply_categorical"),
                  _ds(lj, "apply_categorical"), 2, init_model=bj)
    grab = {}

    def at_start(env):
        if env.iteration == 0:
            grab["scores"] = env.model._gbdt.scores.clone()
    at_start.before_iteration = True
    ct = lt.train(_params(lt, "apply_categorical"), ds_t, 2,
                  init_model=bt.model_to_string(), callbacks=[at_start])
    # the replayed linear trees give the model's raw predictions
    X, _ = _data(0, False)
    np.testing.assert_allclose(grab["scores"][0].numpy(),
                               bt.predict(X[:1600], raw_score=True), rtol=0,
                               atol=1e-6)
    assert ct.num_trees() == ROUNDS + 2
    assert_same_linear_trees(cj._gbdt.models, ct._gbdt.models, 1e-9)


def test_rollback_then_continue(runs):
    """Train 4 rounds, roll one back (the scores lose the linear tree's
    outputs), train 2 more: the same trees as the JAX package's."""
    name = "nan_bagging_valid"
    out = []
    for mod in (lj, lt):
        bst = _train(mod, name)
        bst.rollback_one_iter()
        assert bst.current_iteration == ROUNDS - 1
        assert bst.num_trees() == ROUNDS - 1
        mid = (np.asarray(bst._gbdt.scores)[0].copy(),
               np.asarray(bst._gbdt._valid_scores[0])[0].copy())
        for _ in range(2):
            bst.update()
        out.append((bst, mid))
    (bj, (sj, vj)), (bt, (st, vt)) = out
    X, _ = _data(0, True)
    p3 = bt.predict(X, raw_score=True, num_iteration=ROUNDS - 1)
    np.testing.assert_allclose(st, p3[:1600], rtol=0, atol=1e-5)
    np.testing.assert_allclose(vt, p3[1600:], rtol=0, atol=1e-5)
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-6)
    assert_same_linear_trees(bj._gbdt.models, bt._gbdt.models,
                             _coef_rtol(name))
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=0,
                               atol=1e-6)
