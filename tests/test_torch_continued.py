"""The training loop around the grower in the port against the JAX package
on the CPU: continued training (init_model), valid sets added after
training started, custom objectives and metrics (fobj / feval),
reset_parameter (the callback and the Booster method), Booster.refit and
keep_training_booster.

Tolerances: trees compare structure (split features, thresholds, children,
categorical bitsets) exactly, leaf values within 1e-5 (the JAX search sums
in f32, the port in f64: ROADMAP C note 9); scores and predictions within
1e-5. Two comparisons are exact: the scores a model text replays onto
the training rows (the same f32 leaf values added tree by tree in model
order, as the JAX package's NumPy loop adds them) are bitwise equal, and a
refit at decay_rate 1.0 leaves the model text unchanged.

One deliberate difference (ROADMAP C note 12): the JAX package shrinks
every tree that is still on the device when the model is read by the
learning rate in force at that time, so after reset_parameter changes the
rate its trees carry the last rate and its predictions leave its own
training scores. The port shrinks each tree by the rate it was grown
under; the trees' structures equal the JAX package's.
"""

import numpy as np
import torch
import jax
import pytest

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

PARAMS = dict(objective="binary", num_leaves=15, max_bin=63,
              learning_rate=0.1, min_data_in_leaf=20, verbose=-1)
TORCH = {"device_type": "cpu", "binning_impl": "host"}


def _data():
    """3000 rows of 8 features, NaN in feature 3, feature 5 categorical
    (12 categories); rows 2000 on are held out."""
    rng = np.random.RandomState(0)
    N = 3000
    X = rng.normal(size=(N, 8)).astype(np.float32)
    X[rng.rand(N) < 0.1, 3] = np.nan
    X[:, 5] = rng.randint(0, 12, N)
    z = X[:, 0] - X[:, 1] + 0.5 * X[:, 2] + np.sin(3 * X[:, 0]) \
        + 1.5 * (X[:, 5] % 3 == 0)
    y = (z + rng.normal(scale=0.5, size=N) > 0).astype(np.float32)
    return X, y


X, Y = _data()
XT, YT, XV, YV = X[:2000], Y[:2000], X[2000:], Y[2000:]
CAT = {"categorical_feature": [5]}


def _ds(mod, Xa=XT, ya=YT):
    return mod.Dataset(Xa, label=ya, **CAT)


def _blocks(text):
    body = text.split("end of trees")[0]
    return [dict(ln.split("=", 1) for ln in blk.splitlines()[1:] if "=" in ln)
            for blk in body.split("Tree=")[1:]]


def _nums(s, dtype=float):
    return np.array(s.split(), dtype=dtype)


def _assert_same_trees(bt, bj, n_trees, leaves=True):
    tt, tj = _blocks(bt.model_to_string()), _blocks(bj.model_to_string())
    assert len(tt) == len(tj) == n_trees
    for a, b in zip(tt, tj):
        for k in ("num_leaves", "num_cat", "split_feature", "threshold",
                  "left_child", "right_child", "cat_boundaries",
                  "cat_threshold"):
            assert a.get(k) == b.get(k), k
        if leaves:
            np.testing.assert_allclose(_nums(a["leaf_value"]),
                                       _nums(b["leaf_value"]), rtol=0,
                                       atol=1e-5)


def _scores(b):
    return np.asarray(jax.device_get(b._gbdt.scores)) \
        if not hasattr(b._gbdt.scores, "numpy") else b._gbdt.scores.numpy()


@pytest.fixture(scope="module")
def base():
    """Three rounds in each package, and the JAX model's text."""
    bj = lj.train(PARAMS, _ds(lj), 3)
    bt = lt.train({**PARAMS, **TORCH}, _ds(lt), 3)
    return bj, bt, bj.model_to_string()


def test_replayed_scores_are_bitwise_the_jax_packages(base):
    """One model text replayed onto the training rows of each package (the
    categorical nodes through bin bitsets on this Dataset's mappers)."""
    _, _, text = base
    gj = lj.Booster(PARAMS, _ds(lj))._gbdt
    gt = lt.Booster({**PARAMS, **TORCH}, _ds(lt))._gbdt
    gj.load_init_model(text)
    gt.load_init_model(text)
    assert gt.iter == gj.iter == 3
    assert any(t.num_cat for t in gt.models)
    np.testing.assert_array_equal(gt.scores.numpy(),
                                  np.asarray(gj.scores))
    # the replay is the model's prediction of the training rows
    want = lt.Booster(model_str=text, params=TORCH).predict(
        XT, raw_score=True)
    np.testing.assert_allclose(gt.scores.numpy()[0], want, rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("source", ["booster", "string", "file"])
def test_init_model_matches_jax(base, tmp_path, source):
    bj0, bt0, text = base
    if source == "booster":
        ij, it = bj0, bt0
    elif source == "string":
        ij = it = text
    else:
        ij = it = str(tmp_path / "model.txt")
        bj0.save_model(ij)
    bj = lj.train(PARAMS, _ds(lj), 2, init_model=ij)
    bt = lt.train({**PARAMS, **TORCH}, _ds(lt), 2, init_model=it)
    assert bt.current_iteration == bj.current_iteration == 5
    assert bt.num_trees() == 5
    _assert_same_trees(bt, bj, 5)
    np.testing.assert_allclose(_scores(bt), _scores(bj), rtol=0, atol=1e-5)
    # no second boost from the average: the first tree keeps the bias
    assert _blocks(bt.model_to_string())[3]["shrinkage"] == "0.1"
    np.testing.assert_allclose(bt.predict(XT, raw_score=True),
                               _scores(bt)[0], rtol=0, atol=1e-5)


def test_late_valid_set_matches_jax(base):
    """A valid set added after three rounds starts from the model's scores,
    then advances with each round."""
    bj0, bt0, _ = base
    bj = lj.train(PARAMS, _ds(lj), 3)
    bt = lt.train({**PARAMS, **TORCH}, _ds(lt), 3)
    bj.add_valid(_ds(lj, XV, YV), "late")
    bt.add_valid(_ds(lt, XV, YV), "late")
    vs = bt._gbdt._valid_scores[0].numpy()[0]
    np.testing.assert_allclose(vs, bt.predict(XV, raw_score=True), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(vs, np.asarray(bj._gbdt._valid_scores[0])[0],
                               rtol=0, atol=1e-5)
    bj.update()
    bt.update()
    (_, m, vt, _), = bt.eval_valid()
    (_, _, vj, _), = bj.eval_valid()
    assert m == "binary_logloss" and abs(vt - vj) < 1e-6
    np.testing.assert_allclose(bt._gbdt._valid_scores[0].numpy()[0],
                               bt.predict(XV, raw_score=True,
                                          num_iteration=4), rtol=0,
                               atol=1e-6)


def _fobj(score, ds):
    """Binary logloss gradients of the training labels."""
    p = 1.0 / (1.0 + np.exp(-score))
    return p - YT, p * (1.0 - p)


def _feval(score, ds):
    return [("mean_score", float(np.mean(score)), False),
            ("rows", float(len(score)), True)]


def test_fobj_and_feval_match_jax():
    """A custom objective grows the JAX package's trees from the same
    gradients; feval is reported each round for the training and valid
    sets, after the built-in metrics."""
    p = {**PARAMS, "objective": "none", "metric": "none"}
    rj, rt = {}, {}
    bj = lj.train(p, _ds(lj), 3, valid_sets=[_ds(lj), _ds(lj, XV, YV)],
                  fobj=_fobj, feval=_feval,
                  callbacks=[lj.record_evaluation(rj)])
    dt = _ds(lt)
    bt = lt.train({**p, **TORCH}, dt, 3, valid_sets=[dt, _ds(lt, XV, YV)],
                  fobj=_fobj, feval=_feval,
                  callbacks=[lt.record_evaluation(rt)])
    _assert_same_trees(bt, bj, 3)
    # the training set, passed as valid set 0, is evaluated as "valid_0"
    assert rt.keys() == rj.keys() == {"valid_0", "valid_1"}
    for name in rt:
        assert rt[name].keys() == {"mean_score", "rows"}
        assert len(rt[name]["mean_score"]) == 3
        np.testing.assert_allclose(rt[name]["mean_score"],
                                   rj[name]["mean_score"], rtol=0,
                                   atol=1e-6)
    assert rt["valid_1"]["rows"] == [1000.0] * 3
    # the same custom gradients grow the built-in objective's trees, bar
    # its boost from the average (custom gradients start from zero)
    b0 = lt.train({**PARAMS, **TORCH, "boost_from_average": False},
                  _ds(lt), 1)
    _assert_same_trees(lt.train({**p, **TORCH}, _ds(lt), 1, fobj=_fobj),
                       b0, 1)
    # eval(data, name, feval)
    res = bt.eval(dt, "training", _feval)
    assert [r[1] for r in res] == ["mean_score", "rows"]


def test_fobj_may_return_tensors():
    import torch
    calls = []

    def fobj(score, ds):
        calls.append(score.shape)
        g, h = _fobj(score, ds)
        return torch.from_numpy(g.astype(np.float32)), torch.from_numpy(
            h.astype(np.float32))
    bt = lt.train({**PARAMS, **TORCH, "objective": "none"}, _ds(lt), 2,
                  fobj=fobj)
    bn = lt.train({**PARAMS, **TORCH, "objective": "none"}, _ds(lt), 2,
                  fobj=_fobj)
    assert calls == [(2000,), (2000,)]
    assert bt.model_to_string() == bn.model_to_string()


LRS = [0.3, 0.2, 0.1]


def test_reset_parameter_callback_against_jax():
    bj = lj.train(PARAMS, _ds(lj), 3,
                  callbacks=[lj.reset_parameter(learning_rate=LRS)])
    bt = lt.train({**PARAMS, **TORCH}, _ds(lt), 3,
                  callbacks=[lt.reset_parameter(learning_rate=LRS)])
    _assert_same_trees(bt, bj, 3, leaves=False)
    tt, tj = _blocks(bt.model_to_string()), _blocks(bj.model_to_string())
    # tree 0 carries the average's bias, and with it shrinkage 1
    assert [b["shrinkage"] for b in tt] == ["1", "0.2", "0.1"]
    assert [b["shrinkage"] for b in tj] == ["1", "0.1", "0.1"]
    # each port tree holds its own rate's values: the JAX tree's, scaled
    for a, b, lr in zip(tt[1:], tj[1:], LRS[1:]):
        np.testing.assert_allclose(_nums(a["leaf_value"]),
                                   _nums(b["leaf_value"]) * lr / LRS[-1],
                                   rtol=1e-5, atol=1e-6)
    # so the port's predictions are its training scores, which are the JAX
    # package's training scores; the JAX model's predictions are not
    pt = bt.predict(XT, raw_score=True)
    np.testing.assert_allclose(pt, _scores(bt)[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(_scores(bt), _scores(bj), rtol=0, atol=1e-5)
    assert np.abs(bj.predict(XT, raw_score=True) - pt).max() > 1e-2


def test_reset_parameter_method_against_jax():
    """Booster.reset_parameter between updates: the next trees grow under
    the new rate (and the new config, which the grower does not read)."""
    out = []
    for mod, extra in ((lj, {}), (lt, TORCH)):
        b = mod.Booster({**PARAMS, **extra}, _ds(mod))
        b.update()
        b.reset_parameter({"learning_rate": 0.4, "lambda_l2": 5.0})
        b.update()
        b.update()
        assert b._gbdt.shrinkage_rate == 0.4
        assert b._gbdt.config.lambda_l2 == 5.0
        out.append(b)
    bj, bt = out
    _assert_same_trees(bt, bj, 3, leaves=False)
    assert [b["shrinkage"] for b in _blocks(bt.model_to_string())] \
        == ["1", "0.4", "0.4"]
    np.testing.assert_allclose(_scores(bt), _scores(bj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(bt.predict(XT, raw_score=True),
                               _scores(bt)[0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("decay", [0.9, 1.0])
def test_refit_matches_jax(base, decay):
    """Both packages refit the same model text to the held-out rows."""
    _, _, text = base
    src_j = lj.Booster(model_str=text, params=PARAMS)
    src_t = lt.Booster(model_str=text, params={**PARAMS, **TORCH})
    rj = src_j.refit(XV, YV, decay_rate=decay)
    rt = src_t.refit(XV, YV, decay_rate=decay)
    assert isinstance(rt, lt.Booster) and rt is not src_t
    _assert_same_trees(rt, rj, 3, leaves=False)
    for a, b in zip(rt._gbdt.models, rj._gbdt.models):
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=0,
                                   atol=1e-6)
    # the source booster is unchanged; at decay 1 so is the text
    assert src_t.model_to_string() == lt.Booster(
        model_str=text, params={**PARAMS, **TORCH}).model_to_string()
    if decay == 1.0:
        assert rt.model_to_string() == src_t.model_to_string()
    else:
        assert rt.model_to_string() != src_t.model_to_string()


def test_keep_training_booster_is_accepted():
    bt = lt.train({**PARAMS, **TORCH}, _ds(lt), 2,
                  keep_training_booster=True)
    bt.update()
    assert bt.current_iteration == 3 and bt.num_trees() == 3
