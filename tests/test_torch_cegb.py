"""Cost-effective gradient boosting (CEGB: cegb_penalty_split,
cegb_penalty_feature_coupled, cegb_tradeoff) in the port against the JAX
package on the CPU.

The penalty of a split is tradeoff * (penalty_split * leaf count +
coupled[f] while feature f is unused by the model), subtracted from the
gain before the argmax (DeltaGain, cost_effective_gradient_boosting.hpp:81;
lightgbm_tpu/ops/grow_wave.py:577-598). A feature's coupled penalty is
charged until a split on it is applied, in this tree or an earlier one,
a multiclass round's earlier classes included.

  * the searches: find_best_split and find_best_split_categorical with a
    per-(histogram, feature) penalty against JAX's on seeded 1/64-grid
    histograms (feature, threshold, direction, bitset exactly, floats
    within rtol 1e-5);
  * whole runs: split penalty, coupled penalty, both, on `mega` and on
    `apply` with a categorical column, and multiclass: the trees equal the
    JAX package's (structure exactly, leaf values within 1e-5, gains within
    rtol 1e-4 / atol 1e-6 times the tree's largest gain, ROADMAP C note
    9); the model's used features are the port's coupled state;
  * a feature's coupled penalty is paid once: only the first tree that
    splits on a feature pays it, later trees use the feature freely;
  * the lazy penalty, a coupled vector of the wrong length and EFB
    bundles are fatal with the JAX package's messages; histogram_impl=
    "fused" is vetoed naming `cegb`, as in the JAX package.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.ops import categorical as jc
from lightgbm_tpu.ops import grow as jgrow
from lightgbm_tpu.ops import grow_wave as jgw
from lightgbm_tpu.ops import split as js
from lightgbm_tpu.utils.log import FatalError as JFatal
from lightgbm_tpu_torch.ops import categorical as tc
from lightgbm_tpu_torch.ops import grow as tgrow
from lightgbm_tpu_torch.ops import grow_wave as tgw
from lightgbm_tpu_torch.ops import split as ts
from lightgbm_tpu_torch.utils.log import FatalError as TFatal

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

PARAMS = dict(objective="binary", num_leaves=15, max_bin=63,
              learning_rate=0.2, min_data_in_leaf=5, verbose=-1)
TORCH = {"device_type": "cpu", "binning_impl": "host"}
ROUNDS = 3
W6 = np.array([2.0, 1.5, 1.0, 0.5, 0.25, 0.1])


def _data(cat=False, n=4000):
    rng = np.random.RandomState(21)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    z = X @ W6
    if cat:
        X[:, 5] = rng.randint(0, 10, n)
        z = z + 0.8 * (X[:, 5] % 3 == 0)
    y = (z + rng.normal(scale=0.3, size=n) > 0).astype(np.float32)
    return X, y, ({"categorical_feature": [5]} if cat else {})


HP = dict(min_data_in_leaf=5.0, min_sum_hessian_in_leaf=1e-3,
          lambda_l1=0.0, lambda_l2=0.0, max_delta_step=0.0,
          min_gain_to_split=0.0, path_smooth=0.0)


def _search_case(seed, n=6, F=7, B=32):
    rng = np.random.RandomState(seed)
    g = (np.round(rng.normal(size=(n, F, B)) * 64) / 64).astype(np.float32)
    h = (np.round(rng.uniform(0.5, 2.0, size=(n, F, B)) * 64) / 64) \
        .astype(np.float32)
    c = rng.randint(5, 20, size=(n, F, B)).astype(np.float32)
    nb = rng.randint(B // 2, B + 1, size=F).astype(np.int32)
    nb[4] = 4                      # a one-hot categorical feature
    past = np.arange(B)[None, :] >= nb[:, None]
    g, h, c = (np.where(past, np.float32(0), x) for x in (g, h, c))
    hist = np.stack([g, h, c], axis=1)
    sg, sh, cnt = g[:, 0].sum(-1), h[:, 0].sum(-1), c[:, 0].sum(-1)
    out = (-sg / sh).astype(np.float32)
    mt = rng.randint(0, 3, size=F).astype(np.int32)
    db = rng.randint(0, 2, size=F).astype(np.int32)
    iscat = np.zeros(F, bool)
    iscat[[1, 4]] = True
    pen = (np.round(rng.uniform(0, 8, size=(n, F)) * 64) / 64) \
        .astype(np.float32)
    return hist, sg, sh, cnt, out, (nb, mt, db, iscat), pen


@pytest.mark.parametrize("seed", [0, 1])
def test_searches_with_penalty_match_jax(seed):
    hist, sg, sh, cnt, out, (nb, mt, db, iscat), pen = _search_case(seed)
    jm = js.FeatureMeta(num_bins=jnp.asarray(nb),
                        missing_type=jnp.asarray(mt),
                        default_bin=jnp.asarray(db),
                        is_categorical=jnp.asarray(iscat))
    jhp = js.SplitHyperParams(**HP)
    cat = dict(max_cat_to_onehot=4, max_cat_threshold=32, cat_l2=10.0,
               cat_smooth=1.0, min_data_per_group=5.0)
    jcat = jc.CatConfig(num_bitset_words=1, **cat)

    def one(h_, a, b, c, o, p_):
        num = js.find_best_split(h_, a, b, c, o, jm, jhp, cegb_pen=p_)
        res, words = jc.find_best_split_categorical(h_, a, b, c, o, jm, jhp,
                                                    jcat, cegb_pen=p_)
        return num, res, words
    wn, wc, ww = jax.vmap(one)(*(jnp.asarray(x) for x in (
        hist, sg, sh, cnt, out, pen)))
    t = torch.from_numpy
    tm = ts.FeatureMeta(num_bins=t(nb), missing_type=t(mt),
                        default_bin=t(db), is_categorical=t(iscat))
    thp = ts.SplitHyperParams(**HP)
    args = (t(hist), t(sg), t(sh), t(cnt), t(out), tm, thp)
    gn = ts.find_best_split(*args, cegb_pen=t(pen))
    gc, gw = tc.find_best_split_categorical(
        *args, tc.CatConfig(num_bitset_words=1, **cat), cegb_pen=t(pen))
    for got, want in ((gn, wn), (gc, wc)):
        for name in ("feature", "threshold", "default_left"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)),
                                          err_msg=name)
        for name in ts.SplitResult._fields[4:] + ("gain",):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(gw.numpy().astype(np.uint32),
                                  np.asarray(ww))
    assert np.isfinite(gn.gain.numpy()).sum() >= 3
    assert np.isfinite(gc.gain.numpy()).sum() >= 3
    # the penalty changes the choice somewhere
    free = ts.find_best_split(*args)
    assert not torch.equal(free.feature, gn.feature) \
        or not torch.equal(free.gain, gn.gain)


def _blocks(text):
    body = text.split("end of trees")[0]
    return [dict(ln.split("=", 1) for ln in blk.splitlines()[1:] if "=" in ln)
            for blk in body.split("Tree=")[1:]]


def _nums(s, dtype=float):
    return np.array(s.split(), dtype=dtype)


def _assert_same_model(X, bj, bt, n_trees):
    tt, tj = _blocks(bt.model_to_string()), _blocks(bj.model_to_string())
    assert len(tt) == len(tj) == n_trees
    for a, b in zip(tt, tj):
        for k in ("num_leaves", "num_cat", "split_feature", "threshold",
                  "left_child", "right_child", "cat_boundaries",
                  "cat_threshold"):
            assert a.get(k) == b.get(k), k
        np.testing.assert_allclose(_nums(a["leaf_value"]),
                                   _nums(b["leaf_value"]), rtol=0,
                                   atol=1e-5)
        if int(a["num_leaves"]) > 1:
            ga, gb = _nums(a["split_gain"]), _nums(b["split_gain"])
            np.testing.assert_allclose(ga, gb, rtol=1e-4,
                                       atol=1e-6 * np.abs(gb).max())
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-5)


def _used(models):
    return sorted({int(f) for t in models
                   for f in t.split_feature_inner[:t.num_leaves - 1]})


COUPLED = [0.0, 0.0, 3.0, 40.0, 40.0, 40.0]


@pytest.mark.parametrize("cat,over", [
    (False, {"cegb_penalty_split": 0.1}),
    (False, {"cegb_penalty_feature_coupled": COUPLED}),
    (True, {"cegb_penalty_feature_coupled": COUPLED,
            "cegb_penalty_split": 0.005, "cegb_tradeoff": 0.5}),
])
def test_whole_runs_match_jax(cat, over):
    X, y, dskw = _data(cat)
    p = {**PARAMS, **over}
    bj = lj.train(p, lj.Dataset(X, label=y, **dskw), ROUNDS)
    bt = lt.train({**p, **TORCH}, lt.Dataset(X, label=y, **dskw), ROUNDS)
    g = bt._gbdt
    assert g.grow_route == ("apply" if cat else "mega")
    _assert_same_model(X, bj, bt, ROUNDS)
    free = lt.train({**PARAMS, **TORCH}, lt.Dataset(X, label=y, **dskw),
                    ROUNDS)
    assert _used(g.models) == sorted(np.flatnonzero(
        g._cegb_used.numpy()).tolist())
    if "cegb_penalty_feature_coupled" in over:
        # the priced features are used no more than without the price
        assert len(_used(g.models)) <= len(_used(free._gbdt.models))
    else:
        n = sum(t.num_leaves for t in g.models)
        assert n < sum(t.num_leaves for t in free._gbdt.models)


def test_multiclass_round_charges_in_class_order():
    """Three classes a round: a feature the round's class-0 tree splits on
    is free for its class-1 and class-2 trees, as in the JAX package, which
    updates the state after each tree."""
    X, y, _ = _data()
    y3 = np.digitize(X @ W6, [-1.0, 1.0]).astype(np.float32)
    p = {**PARAMS, "objective": "multiclass", "num_class": 3,
         "num_leaves": 7, "cegb_penalty_feature_coupled": [20.0] * 6}
    bj = lj.train(p, lj.Dataset(X, label=y3), 2)
    bt = lt.train({**p, **TORCH}, lt.Dataset(X, label=y3), 2)
    _assert_same_model(X, bj, bt, 6)


def test_coupled_penalty_is_paid_once():
    """Splits are charged the coupled penalty only while their feature is
    unused: the tree that first uses a feature pays, later trees do not.
    So, with a penalty below the first trees' gains, every tree past the
    first reuses the features the model already holds, and the run's
    first tree equals one grown with the penalty alone."""
    X, y, _ = _data()
    p = {**PARAMS, **TORCH, "cegb_penalty_feature_coupled": [5.0] * 6}
    bt = lt.train(p, lt.Dataset(X, label=y), 4)
    g = bt._gbdt
    seen = set()
    new_per_tree = []
    for t in g.models:
        used = {int(f) for f in t.split_feature_inner[:t.num_leaves - 1]}
        new_per_tree.append(len(used - seen))
        seen |= used
    assert new_per_tree[0] > 0 and sum(new_per_tree[1:]) <= 1
    # one tree from the first tree's gradients with the state of a model
    # that uses every feature: no penalty, so the plain tree
    g2 = lt.Booster({**PARAMS, **TORCH}, lt.Dataset(X, label=y))._gbdt
    gr, he = g2._gradients()
    for used, same in ((torch.ones(6, dtype=torch.bool), True),
                       (torch.zeros(6, dtype=torch.bool), False)):
        tp, _ = tgw.grow_tree_wave(g.X_t, gr[0], he[0], torch.ones(len(y)),
                                   g.meta, g.grow_cfg, cegb_used=used)
        tf, _ = tgw.grow_tree_wave(g2.X_t, gr[0], he[0], torch.ones(len(y)),
                                   g2.meta, g2.grow_cfg)
        m = tf.num_leaves - 1
        eq = (tp.num_leaves == tf.num_leaves and torch.equal(
            tp.split_feature[:m], tf.split_feature[:m]) and torch.equal(
            tp.split_gain[:m], tf.split_gain[:m]))
        assert eq == same


def test_lazy_and_bundles_are_fatal_as_in_jax():
    X, y, _ = _data()
    cases = [({"cegb_penalty_feature_lazy": [1.0] * 6}, X),
             ({"cegb_penalty_feature_coupled": [1.0] * 5}, X)]
    # one-hot columns bundle under EFB
    rng = np.random.RandomState(3)
    Xs = np.zeros((2000, 12), np.float32)
    Xs[np.arange(2000), rng.randint(0, 12, 2000)] = 1.0
    cases.append(({"cegb_penalty_split": 0.1}, Xs))
    for over, data in cases:
        yy = y[:len(data)]
        with pytest.raises(JFatal) as ej:
            lj.train({**PARAMS, **over}, lj.Dataset(data, label=yy), 1)
        with pytest.raises(TFatal) as et:
            lt.train({**PARAMS, **TORCH, **over},
                     lt.Dataset(data, label=yy), 1)
        assert str(et.value) == str(ej.value), over


@pytest.mark.parametrize("split,coupled,forced", [
    (0.5, False, False), (0.0, True, False), (0.0, False, True),
    (0.5, True, True)])
def test_fused_veto_reasons_match_jax(monkeypatch, split, coupled, forced):
    monkeypatch.delenv("LIGHTGBM_TPU_DISABLE_FUSED", raising=False)
    F = 8
    common = dict(num_leaves=15, max_depth=-1, min_data_in_leaf=20.0,
                  min_sum_hessian_in_leaf=1e-3, lambda_l1=0.0,
                  lambda_l2=0.0, max_delta_step=0.0, min_gain_to_split=0.0,
                  path_smooth=0.0, num_bins_padded=64, hist_impl="fused",
                  cegb_penalty_split=split)
    tcfg = tgrow.GrowConfig(has_cegb_coupled=coupled, has_forced=forced,
                            **common)
    jm = js.FeatureMeta(
        num_bins=jnp.full(F, 9), missing_type=jnp.zeros(F),
        default_bin=jnp.zeros(F), is_categorical=jnp.zeros(F, bool),
        forced=jnp.zeros((4, 1), jnp.int32) if forced else None,
        cegb_coupled=jnp.ones(F) if coupled else None)
    want = jgw.fused_veto_reasons(jgrow.GrowConfig(**common), jm, False,
                                  True)
    assert tgw.fused_veto_reasons(tcfg) == want
    assert tgw.wave_routes(tcfg, F)[0] == "mega"
    # and a run under histogram_impl=fused takes "mega" naming them
    X, y, _ = _data(n=1000)
    bf = lt.train({**PARAMS, **TORCH, "histogram_impl": "fused",
                   "cegb_penalty_split": 0.01}, lt.Dataset(X, label=y), 1)
    assert bf._gbdt.grow_route == "mega"
    assert bf._gbdt.fused_veto_reasons == ["cegb"]
