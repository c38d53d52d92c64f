"""End to end: `train` of the port against `lightgbm_tpu.train`, model
files across packages, state conversion, and the configurations the port
refuses.

The data has well separated best gains, so both packages grow the same
trees; what may differ is float rounding. Compared:
  * tree structure (split features, thresholds, children) exactly;
  * decision_type exactly except its default-left bit: where a node's
    missing bin holds no rows, both scan directions give the same split
    and the last bit of the histogram sums picks one. Where it holds rows
    it matters, and the predictions over the training rows (which have
    NaNs and zeros) check it;
  * leaf and internal values, weights and gains within rtol=1e-4 (f32 sums
    of gradients added in another order, over 5 rounds);
  * counts (synthesized from hessians, then rounded) within +-1;
  * predictions within 1e-5.
"""

import numpy as np
import torch
import pytest

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.utils.log import FatalError as JFatalError
from lightgbm_tpu_torch.convert import booster_from_state
from lightgbm_tpu_torch.utils import log as tlog

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

PARAMS = dict(objective="binary", num_leaves=15, max_bin=63,
              learning_rate=0.1, min_data_in_leaf=20, verbose=-1,
              bagging_freq=0)
TORCH = {"device_type": "cpu", "binning_impl": "host"}


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(11)
    N, F = 3000, 8
    X = rng.normal(size=(N, F)).astype(np.float32)
    w = rng.normal(size=F) * 2
    y = (X @ w + rng.normal(scale=0.5, size=N) > 0).astype(np.float32)
    X[rng.rand(N) < 0.1, 0] = np.nan
    X[rng.rand(N) < 0.3, 1] = 0.0
    return X, y


@pytest.fixture(scope="module")
def boosters(data):
    X, y = data
    bj = lj.train(PARAMS, lj.Dataset(X, label=y), num_boost_round=5)
    bt = lt.train({**PARAMS, **TORCH}, lt.Dataset(X, label=y),
                  num_boost_round=5)
    return bj, bt


def _tree_blocks(text):
    body = text.split("end of trees")[0]
    return [dict(ln.split("=", 1) for ln in blk.splitlines()[1:] if "=" in ln)
            for blk in body.split("Tree=")[1:]]


def _nums(s, dtype=float):
    return np.array(s.split(), dtype=dtype)


def _assert_same_trees(text_t, text_j):
    tt, tj = _tree_blocks(text_t), _tree_blocks(text_j)
    assert len(tt) == len(tj) == 5
    for a, b in zip(tt, tj):
        assert a.keys() == b.keys()
        for k in ("num_leaves", "num_cat", "split_feature", "threshold",
                  "left_child", "right_child", "is_linear", "shrinkage"):
            assert a[k] == b[k], k
        da, db = _nums(a["decision_type"], int), _nums(b["decision_type"], int)
        # bit 1 is default_left, see the module docstring
        np.testing.assert_array_equal(da & ~2, db & ~2)
        for k in ("split_gain", "leaf_value", "leaf_weight",
                  "internal_value", "internal_weight"):
            np.testing.assert_allclose(_nums(a[k]), _nums(b[k]), rtol=1e-4,
                                       atol=1e-7, err_msg=k)
        for k in ("leaf_count", "internal_count"):
            assert np.abs(_nums(a[k], int) - _nums(b[k], int)).max() <= 1


def test_five_rounds_match_jax(data, boosters):
    X, _ = data
    bj, bt = boosters
    _assert_same_trees(bt.model_to_string(), bj.model_to_string())
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)


def test_feature_fraction_matches_jax(data):
    """By-tree column sampling draws the same feature subsets."""
    X, y = data
    p = {**PARAMS, "feature_fraction": 0.5, "feature_fraction_seed": 3}
    bj = lj.train(p, lj.Dataset(X, label=y), num_boost_round=5)
    bt = lt.train({**p, **TORCH}, lt.Dataset(X, label=y), num_boost_round=5)
    _assert_same_trees(bt.model_to_string(), bj.model_to_string())
    used = {int(f) for blk in _tree_blocks(bt.model_to_string())[:1]
            for f in blk["split_feature"].split()}
    assert len(used) <= 4


def test_header_matches_jax(boosters):
    bj, bt = boosters
    hj = bj.model_to_string().split("Tree=0")[0].splitlines()
    ht = bt.model_to_string().split("Tree=0")[0].splitlines()
    keep = ("version", "num_class", "num_tree_per_iteration", "label_index",
            "max_feature_idx", "objective", "feature_names", "feature_infos")
    assert [ln for ln in ht if ln.startswith(keep)] \
        == [ln for ln in hj if ln.startswith(keep)]


def test_model_files_cross_load(tmp_path, data, boosters):
    X, _ = data
    bj, bt = boosters
    ft, fj = tmp_path / "port.txt", tmp_path / "jax.txt"
    bt.save_model(str(ft))
    bj.save_model(str(fj))
    # the JAX package serves the port's model and vice versa, with the
    # predictions of the package that trained it
    np.testing.assert_allclose(lj.Booster(model_file=str(ft)).predict(X),
                               bt.predict(X), rtol=0, atol=1e-12)
    np.testing.assert_allclose(lt.Booster(model_file=str(fj)).predict(X),
                               bj.predict(X), rtol=0, atol=1e-12)
    # a text round trip in the port is bitwise
    rt = lt.Booster(model_str=bt.model_to_string())
    np.testing.assert_array_equal(rt.predict(X), bt.predict(X))
    _assert_same_trees(rt.model_to_string(), bt.model_to_string())


def test_convert_reproduces_jax_predictions(data, boosters):
    X, _ = data
    bj, _ = boosters
    g = bj._gbdt
    bst = booster_from_state(
        params=bj.params,
        trees=[vars(t) for t in g.models],
        mappers=[m.to_dict() for m in g.mappers],
        real_feature_index=g.real_feature_index,
        feature_names=g.feature_names_,
        num_total_features=g.max_feature_idx_ + 1)
    np.testing.assert_allclose(bst.predict(X), bj.predict(X), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(bst.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=0,
                               atol=1e-12)
    assert _tree_blocks(bst.model_to_string()) \
        == _tree_blocks(bj.model_to_string())


def test_update_batch_equals_update_loop(data):
    X, y = data
    p = {**PARAMS, **TORCH}
    b1 = lt.Booster(p, lt.Dataset(X, label=y))
    b1.update_batch(4)
    b2 = lt.Booster(p, lt.Dataset(X, label=y))
    for _ in range(4):
        b2.update()
    assert b1.model_to_string() == b2.model_to_string()


def test_valid_sets_early_stopping_and_logging(data):
    X, y = data
    p = {**PARAMS, **TORCH, "metric": ["auc", "binary_logloss"]}
    dtr = lt.Dataset(X[:2000], label=y[:2000], params=p)
    dva = lt.Dataset(X[2000:], label=y[2000:], reference=dtr, params=p)
    rec, logs = {}, []
    prev = tlog._logger
    lt.register_logger(type("L", (), {"info": logs.append,
                                      "warning": logs.append})())
    try:
        bst = lt.train(p, dtr, num_boost_round=60, valid_sets=[dva],
                       valid_names=["va"],
                       callbacks=[lt.record_evaluation(rec),
                                  lt.log_evaluation(10),
                                  lt.early_stopping(3, verbose=False)])
    finally:
        lt.register_logger(prev)
    auc = rec["va"]["auc"]
    assert 0 < bst.best_iteration <= len(auc) <= 60
    assert auc[bst.best_iteration - 1] == max(auc) > 0.9
    assert any("va's auc" in s for s in logs)
    # the valid-set scores the trainer kept equal a fresh predict
    raw = bst.predict(X[2000:], raw_score=True,
                      num_iteration=bst.current_iteration)
    kept = bst._gbdt._valid_scores[0][0].numpy()
    np.testing.assert_allclose(raw, kept, rtol=0, atol=1e-5)


def _trees_only(text):
    """Model text minus the bracketed parameter dump."""
    return "\n".join(l for l in text.splitlines() if not l.startswith("["))


@pytest.mark.parametrize("over,want", [
    pytest.param({"num_machines": 4}, "no machine rank given",
                 id="over0-A16"),
    pytest.param({"tree_learner": "data"}, "serial", id="over1-A16"),
    pytest.param({"num_machines": 8, "tpu_grower": "compact"},
                 "no machine rank given", id="over2-A16"),
    pytest.param({"tree_learner": "feature"}, "serial", id="over3-A16"),
    pytest.param({"num_machines": 2}, "no machine rank given",
                 id="over4-A16"),
    pytest.param({"pre_partition": True}, "serial", id="over5-A16"),
    pytest.param({"tree_learner": "voting", "tpu_grower": "masked"},
                 "serial", id="over6-A16"),
    pytest.param({"tree_learner": "voting"}, "serial", id="over7-A16"),
])
def test_configurations_outside_the_slice_raise(data, over, want):
    """The distributed configurations in one process (no group): a
    distributed tree_learner or pre_partition trains serially and grows
    the serial model, as the JAX package does on one device; num_machines
    > 1 with no rank given is fatal with the JAX package's message
    (tests/test_torch_parallel.py trains them over process groups)."""
    X, y = data
    p = {**PARAMS, **TORCH, **over}
    if want != "serial":
        with pytest.raises(lt.FatalError, match=want):
            lt.train(p, lt.Dataset(X, label=y), num_boost_round=1)
        with pytest.raises(JFatalError, match=want):
            lj.train({**PARAMS, **over}, lj.Dataset(X, label=y),
                     num_boost_round=1)
        return
    serial = {**PARAMS, **TORCH,
              **{k: v for k, v in over.items() if k == "tpu_grower"}}
    got = lt.train(p, lt.Dataset(X, label=y), num_boost_round=2)
    ref = lt.train(serial, lt.Dataset(X, label=y), num_boost_round=2)
    assert got._gbdt.use_dist is False
    assert _trees_only(got.model_to_string()) == \
        _trees_only(ref.model_to_string())


@pytest.mark.parametrize("num_leaves", [8192, 4097, 131072])
def test_num_leaves_past_the_leaf_cap_trains(data, num_leaves):
    """num_leaves past the kernels' 4096-entry shared-memory leaf tables
    (once refused naming "A11, the leaf cap") trains: the wave kernels
    take the global leaf maps (ops/histogram_cuda.py:new_leaf_map), on the
    CPU their plain versions; the tree grows until min_data_in_leaf
    stops it, as it does under num_leaves = 1024. At 131072 leaves the
    histogram_pool_size ladder picks masked (the wave grower's caches
    need GBs), so the wave grower is named."""
    X, y = data
    p = {**PARAMS, **TORCH, "min_data_in_leaf": 2}
    wave = {"tpu_grower": "wave"} if num_leaves == 131072 else {}
    got = lt.train({**p, **wave, "num_leaves": num_leaves},
                   lt.Dataset(X, label=y), num_boost_round=2)
    ref = lt.train({**p, "num_leaves": 1024}, lt.Dataset(X, label=y),
                   num_boost_round=2)
    assert got._gbdt.grower == "wave"
    leaves = [t.num_leaves for t in got._gbdt.models]
    assert leaves == [t.num_leaves for t in ref._gbdt.models]
    assert 100 < max(leaves) < 1024
    assert got.model_to_string().split("parameters:")[0].replace(
        f"num_leaves: {num_leaves}", "") == ref.model_to_string().split(
        "parameters:")[0].replace("num_leaves: 1024", "")


def test_categorical_and_wide_data_raise(data):
    """Categorical and wide data train on the wave-apply route, and so does
    more than 256 bins per feature (uint16 storage, A14's first item),
    which raised before it was ported; tests/test_torch_wide_bins.py holds
    it to the JAX package."""
    X, y = data
    cat = lt.train({**PARAMS, **TORCH},
                   lt.Dataset(X, label=y, categorical_feature=[2]), 1)
    wide = np.random.RandomState(0).normal(size=(500, 40))
    w = lt.train({**PARAMS, **TORCH},
                 lt.Dataset(wide, label=wide[:, 0] > 0), 1)
    assert cat._gbdt.grow_route == w._gbdt.grow_route == "apply"
    assert cat._gbdt.grow_cfg.has_categorical and w._gbdt.X_t.shape[0] == 40
    b300 = lt.train({**PARAMS, **TORCH, "max_bin": 300},
                    lt.Dataset(X, label=y, categorical_feature=[2]), 1)
    assert b300._gbdt.grow_route == "apply"
    assert b300._gbdt.X_t.dtype == torch.uint16


def test_pred_early_stop_matches_jax(data, boosters):
    """pred_early_stop / _freq / _margin from the predict call or from the
    booster's params stop a row's walk as the JAX package's does."""
    X, _ = data
    bj, bt = boosters
    es = dict(pred_early_stop=True, pred_early_stop_freq=1,
              pred_early_stop_margin=0.2)
    got = bt.predict(X, raw_score=True, **es)
    ref = bj.predict(X, raw_score=True, **es)
    full = bt.predict(X, raw_score=True)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # the margin stops some rows early, so the prediction is not the full
    # walk's
    assert np.abs(got - full).max() > 1e-3
    bt.params.update(es)
    try:
        np.testing.assert_array_equal(bt.predict(X, raw_score=True), got)
    finally:
        for k in es:
            del bt.params[k]
    np.testing.assert_array_equal(bt.predict(X, raw_score=True), full)


def test_valid_set_without_params_follows_the_booster(data):
    """A valid set made with reference= and no params is binned and scored
    under the booster's params, so a CPU run stays on the CPU; its metric
    equals the JAX package's."""
    X, y = data
    p = {**PARAMS, **TORCH, "metric": "auc"}
    ev_t, ev_j = {}, {}
    dtr = lt.Dataset(X[:2000], label=y[:2000])
    lt.train(p, dtr, num_boost_round=3,
             valid_sets=[lt.Dataset(X[2000:], label=y[2000:],
                                    reference=dtr)],
             callbacks=[lt.record_evaluation(ev_t)])
    jtr = lj.Dataset(X[:2000], label=y[:2000])
    lj.train({**PARAMS, "metric": "auc"}, jtr, num_boost_round=3,
             valid_sets=[lj.Dataset(X[2000:], label=y[2000:],
                                    reference=jtr)],
             callbacks=[lj.record_evaluation(ev_j)])
    np.testing.assert_allclose(ev_t["valid_0"]["auc"],
                               ev_j["valid_0"]["auc"], rtol=0, atol=1e-6)
