"""Multiclass training in the port against the JAX package, on the CPU:
[K, N] scores, K trees an iteration, per-class boost-from-average, the
tree seeds (seed + iter) * K + k, GOSS over the classes, the evaluation,
pred_leaf, model text, state conversion and serving.

softmax starts with boost_from_average=False, so its first gradients are
exact (p = 1/3) and both packages grow the same trees; values within 1e-5.
"""


import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu import config as jcfg
from lightgbm_tpu.data.dataset import Metadata as JMetadata
from lightgbm_tpu.models import sample_strategy as jss
from lightgbm_tpu_torch import config as tcfg
from lightgbm_tpu_torch.convert import booster_from_state
from lightgbm_tpu_torch.data.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.models import sample_strategy as tss

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

K = 3
CASES = {
    "softmax": dict(objective="multiclass", num_class=K,
                    boost_from_average=False, metric="multi_logloss"),
    "ova": dict(objective="multiclassova", num_class=K,
                metric=["multi_logloss", "multi_error"]),
}


def _data():
    rng = np.random.RandomState(17)
    X = rng.normal(size=(1500, 8)).astype(np.float32)
    m = X @ rng.normal(size=8)
    y = np.digitize(m, np.quantile(m, [0.3, 0.65])).astype(np.float32)
    return X, y


@pytest.fixture(scope="module", params=sorted(CASES))
def trained(request):
    X, y = _data()
    p = dict(num_leaves=7, max_bin=63, verbose=-1, seed=2,
             **CASES[request.param])
    bj = lj.train(p, lj.Dataset(X, label=y), 3)
    bt = lt.train({**p, "device_type": "cpu"}, lt.Dataset(X, label=y), 3)
    return request.param, p, X, y, bj, bt


def test_trees_and_predictions_match_jax(trained):
    name, _, X, _, bj, bt = trained
    tm, jm = bt._gbdt.models, bj._gbdt.models
    assert len(tm) == len(jm) == 3 * K
    assert bt._gbdt.scores.shape == (K, len(X))
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.threshold_in_bin, b.threshold_in_bin)
        np.testing.assert_array_equal(a.left_child, b.left_child)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=0,
                                   atol=1e-5)
    pt, pj = bt.predict(X), bj.predict(X)
    assert pt.shape == (len(X), K)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)
    if name == "softmax":
        np.testing.assert_allclose(pt.sum(axis=1), 1.0, rtol=0, atol=1e-12)
    # the trainer's scores are the raw predictions of the training rows
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bt._gbdt.scores.numpy().T, atol=1e-5)


def test_evaluation_matches_jax(trained):
    _, _, _, _, bj, bt = trained
    got, want = bt.eval_train(), bj.eval_train()
    assert [r[:2] for r in got] == [r[:2] for r in want]
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want],
                               rtol=1e-5)


def test_pred_leaf_and_model_text(trained):
    """pred_leaf is [N, 3 K] (iteration, then class), equal to the JAX
    package's; the model text names the classes as JAX's does and a text
    round trip predicts bitwise."""
    _, _, X, _, bj, bt = trained
    leaves = bt.predict(X, pred_leaf=True)
    assert leaves.shape == (len(X), 3 * K)
    np.testing.assert_array_equal(leaves, bj.predict(X, pred_leaf=True))
    np.testing.assert_array_equal(
        bt.predict(X, pred_leaf=True, start_iteration=1, num_iteration=1),
        leaves[:, K:2 * K])
    text = bt.model_to_string()
    head = [ln for ln in text.splitlines()[:8]
            if ln.startswith(("num_class", "num_tree_per", "objective"))]
    jhead = [ln for ln in bj.model_to_string().splitlines()[:8]
             if ln.startswith(("num_class", "num_tree_per", "objective"))]
    assert head == jhead and len(head) == 3
    back = lt.Booster(model_str=text)
    np.testing.assert_array_equal(back.predict(X), bt.predict(X))
    # the trees' text too (a loaded model writes its own parameters)
    assert back.model_to_string().split("parameters:")[0] == \
        text.split("parameters:")[0]


def test_state_conversion_and_serving(trained):
    """A JAX multiclass model carried over by booster_from_state predicts
    what JAX predicts; a serving session's [K, n] margins equal
    Booster.predict(raw_score=True) (bitwise on the host engine)."""
    _, p, X, _, bj, bt = trained
    g = bj._gbdt
    conv = booster_from_state(
        params={**p, "device_type": "cpu"},
        trees=[vars(t) for t in g.models],
        mappers=[m.to_dict() for m in g.mappers],
        real_feature_index=g.real_feature_index,
        feature_names=g.feature_names_,
        num_total_features=g.max_feature_idx_ + 1)
    assert conv._gbdt.num_tree_per_iteration == K
    np.testing.assert_allclose(conv.predict(X), bj.predict(X), rtol=0,
                               atol=1e-12)
    raw = bt.predict(X[:300], raw_score=True)
    host = bt.serve(engine="host")
    np.testing.assert_array_equal(host.score_margin(X[:300]), raw.T)
    np.testing.assert_array_equal(host.predict(X[:300]), bt.predict(X[:300]))
    dev = bt.serve(engine="device")
    np.testing.assert_allclose(dev.score_margin(X[:300]), raw.T, rtol=0,
                               atol=1e-5)


def test_valid_set_and_early_stopping():
    """[K, N] valid scores follow the trees; early stopping on
    multi_logloss picks a best iteration (the valid labels are shuffled,
    so the valid loss turns up within a few rounds)."""
    X, y = _data()
    p = dict(CASES["softmax"], num_leaves=7, verbose=-1, device_type="cpu",
             learning_rate=0.5)
    train = lt.Dataset(X[:1000], label=y[:1000])
    yv = np.random.RandomState(0).permutation(y[1000:])
    valid = train.create_valid(X[1000:], label=yv)
    rec = {}
    bst = lt.train(p, train, 12, valid_sets=[valid], valid_names=["va"],
                   callbacks=[lt.record_evaluation(rec),
                              lt.early_stopping(2, verbose=False)])
    ll = rec["va"]["multi_logloss"]
    assert 0 < bst.best_iteration <= len(ll) < 12
    assert ll[bst.best_iteration - 1] == min(ll)
    kept = bst._gbdt._valid_scores[0].numpy()
    raw = bst.predict(X[1000:], raw_score=True,
                      num_iteration=bst.current_iteration)
    np.testing.assert_allclose(raw, kept.T, rtol=0, atol=1e-5)


def test_tree_seeds_follow_the_class():
    """(seed + iter) * K + k as an int32, the JAX package's tree seed;
    K = 1 keeps seed + iter."""
    X, y = _data()
    for seed in (0, 9, 2 ** 31 - 2):
        bst = lt.Booster({**CASES["softmax"], "seed": seed,
                          "device_type": "cpu", "verbose": -1},
                         lt.Dataset(X, label=y))
        for it, k in ((0, 0), (0, 2), (5, 1)):
            want = np.array((seed + it) * K + k).astype(np.int64)
            want = int(((want + 2 ** 31) % 2 ** 32) - 2 ** 31)
            assert bst._gbdt.tree_seed(it, k) == want


def test_goss_sums_over_the_classes_bitwise():
    """GOSS ranks rows by |g h| summed over the K classes; the mask equals
    the JAX package's bit for bit."""
    rng = np.random.RandomState(4)
    N = 3000
    g = rng.normal(size=(K, N)).astype(np.float32)
    h = rng.uniform(0.1, 1.0, size=(K, N)).astype(np.float32)
    params = dict(objective="multiclass", num_class=K,
                  data_sample_strategy="goss", learning_rate=0.5)
    jm, tm = JMetadata(N), TMetadata(N)
    jm.set_label(np.zeros(N, np.float32))
    tm.set_label(np.zeros(N, np.float32))
    js = jss.create_sample_strategy(jcfg.resolve_params(dict(params)), N, jm)
    ts = tss.create_sample_strategy(tcfg.resolve_params(dict(params)), N, tm,
                                    torch.device("cpu"))
    for it in (2, 3, 7):
        want = np.asarray(js.sample(it, g, h))
        got = ts.sample(it, torch.from_numpy(g), torch.from_numpy(h))
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got > 1).any() and (got == 0).any()
