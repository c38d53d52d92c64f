"""Forced splits (forcedsplits_filename) in the port against the JAX
package on the CPU.

  * the [4, S] BFS table of a JSON with nested children, a node on an
    unused feature (dropped with a warning) and thresholds between bin
    bounds: bitwise equal to lightgbm_tpu's parse_forced_splits;
  * the search's forced mode: find_best_split_and_forced against JAX's on
    seeded 1/64-grid histograms, the normal best and the forced cell's
    split (feature, threshold, direction exactly, floats within rtol
    1e-5), with a column mask and a CEGB penalty that only the normal
    selection reads;
  * whole runs (`mega`, and `apply` with a categorical column; with
    bagging): the forced nodes lead every tree in BFS order, and the trees
    equal the JAX package's (split features, bin thresholds, children
    exactly; leaf values within 1e-5 and gains within rtol 1e-4 / atol
    1e-6 times the tree's largest gain: the JAX search sums a leaf's
    gradients in f32, the port in f64, ROADMAP C note 9, and a small leaf
    reached by subtraction from a large one keeps the large one's last
    bits, 2.2e-6 on the categorical run);
  * a forced split that cannot be made leaves its branch to normal growth,
    as in the JAX package;
  * a forced split on a categorical feature is fatal with the JAX
    package's message; histogram_impl="fused" is vetoed naming
    `forced_splits`.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.models.gbdt import parse_forced_splits as j_parse
from lightgbm_tpu.ops import split as js
from lightgbm_tpu.utils.log import FatalError as JFatal
from lightgbm_tpu_torch.models.gbdt import parse_forced_splits as t_parse
from lightgbm_tpu_torch.ops import split as ts
from lightgbm_tpu_torch.utils.log import FatalError as TFatal

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

PARAMS = dict(objective="binary", num_leaves=15, max_bin=63,
              learning_rate=0.1, min_data_in_leaf=5, verbose=-1)
TORCH = {"device_type": "cpu", "binning_impl": "host"}
ROUNDS = 3
FS = {"feature": 3, "threshold": 0.25,
      "left": {"feature": 0, "threshold": -0.3},
      "right": {"feature": 1, "threshold": -0.5,
                "left": {"feature": 6, "threshold": 0.0},
                "right": {"feature": 2, "threshold": 0.7}}}


def _data(cat=False):
    """4000 x 7 rows: six normal columns and a constant one (feature 6,
    unused after binning); with `cat`, feature 5 holds 10 categories."""
    rng = np.random.RandomState(9)
    X = rng.normal(size=(4000, 7)).astype(np.float32)
    X[:, 6] = 1.0
    z = X[:, :6] @ rng.normal(size=6)
    if cat:
        X[:, 5] = rng.randint(0, 10, 4000)
        z = z + (X[:, 5] % 3 == 0)
    y = (z + rng.normal(scale=0.3, size=4000) > 0).astype(np.float32)
    return X, y, ({"categorical_feature": [5]} if cat else {})


def _write(tmp_path, spec, name="fs.json"):
    p = str(tmp_path / name)
    with open(p, "w") as f:
        json.dump(spec, f)
    return p


def test_table_equals_jax(tmp_path):
    X, y, _ = _data()
    p = _write(tmp_path, FS)
    dj = lj.Dataset(X, label=y, params={"max_bin": 63}).construct()._handle
    dt = lt.Dataset(X, label=y, params={"max_bin": 63, **TORCH}) \
        .construct()._handle
    want, got = j_parse(p, dj), t_parse(p, dt)
    assert got.dtype == np.int32 and got.shape == want.shape == (4, 4)
    np.testing.assert_array_equal(got, want)
    # BFS order; the node on the constant feature 6 is gone, its parent's
    # left child with it
    np.testing.assert_array_equal(got[0], [3, 0, 1, 2])
    np.testing.assert_array_equal(got[2], [1, -1, -1, -1])
    np.testing.assert_array_equal(got[3], [2, -1, 3, -1])
    assert t_parse(_write(tmp_path, {}, "empty.json"), dt) is None


HP = dict(min_data_in_leaf=5.0, min_sum_hessian_in_leaf=1e-3,
          lambda_l1=0.0, lambda_l2=0.0, max_delta_step=0.0,
          min_gain_to_split=0.0, path_smooth=0.0)


def _search_case(seed, n=6, F=7, B=32):
    """n 1/64-grid histograms [n, 3, F, B], their parents' scalars, mixed
    missing types, each histogram's forced (feature, bin), a column mask
    and a CEGB penalty per (histogram, feature)."""
    rng = np.random.RandomState(seed)
    g = (np.round(rng.normal(size=(n, F, B)) * 64) / 64).astype(np.float32)
    h = (np.round(rng.uniform(0.5, 2.0, size=(n, F, B)) * 64) / 64) \
        .astype(np.float32)
    c = rng.randint(1, 6, size=(n, F, B)).astype(np.float32)
    nb = rng.randint(B // 2, B + 1, size=F).astype(np.int32)
    past = np.arange(B)[None, :] >= nb[:, None]
    g, h, c = (np.where(past, np.float32(0), x) for x in (g, h, c))
    hist = np.stack([g, h, c], axis=1)
    sg, sh, cnt = g[:, 0].sum(-1), h[:, 0].sum(-1), c[:, 0].sum(-1)
    out = (-sg / sh).astype(np.float32)
    mt = rng.randint(0, 3, size=F).astype(np.int32)
    db = rng.randint(0, B // 2, size=F).astype(np.int32)
    ff = rng.randint(0, F, size=n).astype(np.int32)
    fb = rng.randint(0, B // 2, size=n).astype(np.int32)
    fb[0] = B - 1                  # past every feature's thresholds: -inf
    fmask = rng.rand(F) < 0.7
    fmask[ff[1]] = False           # the forced feature bypasses the mask
    pen = np.round(rng.uniform(0, 4, size=(n, F)) * 64) / 64
    return (hist, sg, sh, cnt, out, (nb, mt, db), ff, fb, fmask,
            pen.astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_search_forced_mode_matches_jax(seed):
    hist, sg, sh, cnt, out, (nb, mt, db), ff, fb, fmask, pen = \
        _search_case(seed)
    jm = js.FeatureMeta(num_bins=jnp.asarray(nb),
                        missing_type=jnp.asarray(mt),
                        default_bin=jnp.asarray(db),
                        is_categorical=jnp.zeros(len(nb), bool))
    jhp = js.SplitHyperParams(**HP)

    def one(h_, a, b, c, o, f_, t_, p_):
        return js.find_best_split_and_forced(
            h_, a, b, c, o, jm, jhp, jnp.asarray(fmask), None, None, f_,
            t_, cegb_pen=p_)
    want_n, want_f = jax.vmap(one)(*(jnp.asarray(x) for x in (
        hist, sg, sh, cnt, out, ff, fb, pen)))
    t = torch.from_numpy
    tm = ts.FeatureMeta(num_bins=t(nb), missing_type=t(mt),
                        default_bin=t(db),
                        is_categorical=torch.zeros(len(nb), dtype=torch.bool))
    got_n, got_f = ts.find_best_split_and_forced(
        t(hist), t(sg), t(sh), t(cnt), t(out), tm, ts.SplitHyperParams(**HP),
        t(fmask), None, None, t(ff).long(), t(fb).long(), cegb_pen=t(pen))
    for got, want in ((got_n, want_n), (got_f, want_f)):
        for name in ("feature", "threshold", "default_left"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)),
                                          err_msg=name)
        for name in ts.SplitResult._fields[4:] + ("gain",):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
    fg = got_f.gain.numpy()
    assert not np.isfinite(fg[0]) and np.isfinite(fg[1:]).sum() >= 3
    ok = np.isfinite(fg)
    np.testing.assert_array_equal(got_f.feature.numpy()[ok], ff[ok])
    np.testing.assert_array_equal(got_f.threshold.numpy()[ok], fb[ok])
    # find_best_split's forced mode is the forced cell's split
    alone = ts.find_best_split(t(hist), t(sg), t(sh), t(cnt), t(out), tm,
                               ts.SplitHyperParams(**HP), forced_f=t(ff),
                               forced_b=t(fb))
    for a, b in zip(alone, got_f):
        assert torch.equal(a, b)


def _blocks(text):
    body = text.split("end of trees")[0]
    return [dict(ln.split("=", 1) for ln in blk.splitlines()[1:] if "=" in ln)
            for blk in body.split("Tree=")[1:]]


def _nums(s, dtype=float):
    return np.array(s.split(), dtype=dtype)


def _assert_same_model(X, bj, bt, rounds=ROUNDS):
    tt, tj = _blocks(bt.model_to_string()), _blocks(bj.model_to_string())
    assert len(tt) == len(tj) == rounds
    for a, b in zip(tt, tj):
        for k in ("num_leaves", "num_cat", "split_feature", "threshold",
                  "left_child", "right_child", "cat_boundaries",
                  "cat_threshold"):
            assert a.get(k) == b.get(k), k
        np.testing.assert_allclose(_nums(a["leaf_value"]),
                                   _nums(b["leaf_value"]), rtol=0,
                                   atol=1e-5)
        ga, gb = _nums(a["split_gain"]), _nums(b["split_gain"])
        np.testing.assert_allclose(ga, gb, rtol=1e-4,
                                   atol=1e-6 * np.abs(gb).max())
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-5)


def _both(tmp_path, spec, cat=False, **over):
    X, y, dskw = _data(cat)
    p = {**PARAMS, "forcedsplits_filename": _write(tmp_path, spec), **over}
    return (X, lj.train(p, lj.Dataset(X, label=y, **dskw), ROUNDS),
            lt.train({**p, **TORCH}, lt.Dataset(X, label=y, **dskw),
                     ROUNDS))


@pytest.mark.parametrize("cat,over", [
    (False, {}), (True, {}),
    (False, {"bagging_fraction": 0.7, "bagging_freq": 1})])
def test_forced_nodes_lead_every_tree(tmp_path, cat, over):
    X, bj, bt = _both(tmp_path, FS, cat, **over)
    g = bt._gbdt
    assert g.grow_route == ("apply" if cat else "mega")
    table = g.meta.forced.numpy()
    for t in g.models:
        # BFS: nodes 0-3 are the forced ones, in the table's order
        np.testing.assert_array_equal(t.split_feature_inner[:4], table[0])
        np.testing.assert_array_equal(t.threshold_in_bin[:4], table[1])
        assert t.left_child[0] == 1 and t.right_child[0] == 2
        assert t.right_child[2] == 3
    _assert_same_model(X, bj, bt)


def test_invalid_forced_split_falls_back(tmp_path):
    """A threshold past the data leaves one side empty: the root grows
    normally (the JAX package's test_invalid_forced_falls_back), and so
    does the branch below it."""
    X, bj, bt = _both(tmp_path, {"feature": 2, "threshold": 1e9,
                                 "left": {"feature": 4, "threshold": 0.0}})
    for t in bt._gbdt.models:
        assert t.num_leaves > 1
        assert not (t.split_feature[0] == 2 and t.threshold[0] > 1e8)
    _assert_same_model(X, bj, bt)


def test_categorical_forced_split_is_fatal(tmp_path):
    X, y, dskw = _data(cat=True)
    p = {**PARAMS, "forcedsplits_filename": _write(
        tmp_path, {"feature": 5, "threshold": 2})}
    with pytest.raises(JFatal) as ej:
        lj.train(p, lj.Dataset(X, label=y, **dskw), 1)
    with pytest.raises(TFatal) as et:
        lt.train({**p, **TORCH}, lt.Dataset(X, label=y, **dskw), 1)
    assert str(et.value) == str(ej.value)
    assert "categorical" in str(et.value)


def test_fused_is_vetoed(tmp_path):
    X, y, _ = _data()
    p = {**PARAMS, **TORCH, "histogram_impl": "fused",
         "forcedsplits_filename": _write(tmp_path, FS)}
    bf = lt.train(p, lt.Dataset(X, label=y), 1)
    assert bf._gbdt.grow_route == "mega"
    assert bf._gbdt.fused_veto_reasons == ["forced_splits"]
    assert bf._gbdt.models[0].split_feature[0] == 3
