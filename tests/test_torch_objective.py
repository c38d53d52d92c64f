"""Objectives of the port against the JAX package: binary logloss and L2
regression gradients / hessians, boost-from-average and output conversion.

Gradients are the same f32 elementwise formulas; exp is computed by
PyTorch's and by XLA's CPU kernels, which may differ in the last bit, so
gradients are compared with rtol=2e-6 (a few f32 ulps). The binary hessian
|r| * (sigmoid - |r|) cancels when |r| nears sigmoid, which turns that
last bit of r into an absolute error of a few ulps of sigmoid^2: hessians
also get atol=8 * 2^-23 * sigmoid^2. boost_from_score is computed on the
host in float64 by both and compared exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lightgbm_tpu import config as jcfg
from lightgbm_tpu import objectives as jobj
from lightgbm_tpu.data.dataset import Metadata as JMetadata
from lightgbm_tpu_torch import config as tcfg
from lightgbm_tpu_torch import objectives as tobj
from lightgbm_tpu_torch.data.dataset import Metadata as TMetadata

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)


def _objectives(params, label, weight):
    out = []
    for cfg_mod, obj_mod, md_cls in ((jcfg, jobj, JMetadata),
                                     (tcfg, tobj, TMetadata)):
        cfg = cfg_mod.resolve_params(dict(params))
        md = md_cls(len(label))
        md.set_label(label)
        md.set_weight(weight)
        obj = obj_mod.create_objective(cfg)
        obj.init(md, len(label))
        out.append(obj)
    return out


def _data(seed, binary, weighted):
    rng = np.random.RandomState(seed)
    n = 2000
    label = ((rng.rand(n) < 0.3) if binary else rng.normal(size=n) * 3)
    label = label.astype(np.float32)
    weight = (rng.uniform(0.5, 2.0, size=n).astype(np.float32)
              if weighted else None)
    score = (rng.normal(size=n) * 4).astype(np.float32)
    return label, weight, score


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("params", [
    {"objective": "binary"},
    {"objective": "binary", "sigmoid": 2.5},
    {"objective": "binary", "is_unbalance": True},
    {"objective": "binary", "scale_pos_weight": 3.0},
    {"objective": "regression"},
])
def test_gradients_match_jax(params, weighted):
    binary = params["objective"] == "binary"
    label, weight, score = _data(len(params) + weighted, binary, weighted)
    oj, ot = _objectives(params, label, weight)
    gj, hj = oj.get_gradients(jnp.asarray(score), jnp.asarray(label),
                              None if weight is None else jnp.asarray(weight))
    gt, ht = ot.get_gradients(torch.tensor(score), torch.tensor(label),
                              None if weight is None else torch.tensor(weight))
    assert gt.dtype == ht.dtype == torch.float32
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=2e-6,
                               atol=1e-7)
    sig = params.get("sigmoid", 1.0)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=2e-6,
                               atol=8 * 2.0 ** -23 * sig ** 2)
    assert ot.boost_from_score(0) == oj.boost_from_score(0)
    assert ot.to_string() == oj.to_string()


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_boost_from_average(objective):
    label, weight, _ = _data(3, objective == "binary", True)
    for params in ({"objective": objective},
                   {"objective": objective, "boost_from_average": False}):
        oj, ot = _objectives(params, label, weight)
        assert ot.boost_from_score(0) == oj.boost_from_score(0)
    oj, ot = _objectives({"objective": objective}, label, None)
    if objective == "binary":
        p = float(np.mean(label > 0))
        assert ot.boost_from_score(0) == pytest.approx(np.log(p / (1 - p)))
    else:
        assert ot.boost_from_score(0) == pytest.approx(float(label.mean()))


def test_binary_convert_output_matches_jax():
    label, _, score = _data(4, True, False)
    oj, ot = _objectives({"objective": "binary", "sigmoid": 1.5}, label,
                         None)
    s = score.astype(np.float64)[None, :]
    np.testing.assert_array_equal(ot.convert_output(s),
                                  np.asarray(oj.convert_output(s)))


@pytest.mark.parametrize("objective", ["multiclass", "lambdarank",
                                       "regression_l1", "xentropy"])
def test_other_objectives_are_not_ported(objective):
    """These four were refused before the port had them; now each is
    created and writes the JAX package's objective string."""
    params = {"objective": objective, "num_class": 3}
    cj = jobj.create_objective(jcfg.resolve_params(dict(params)))
    ct = tobj.create_objective(tcfg.resolve_params(dict(params)))
    assert type(ct).__name__ == type(cj).__name__
    assert ct.to_string() == cj.to_string()
    assert ct.num_model_per_iteration == cj.num_model_per_iteration


# every other objective of the JAX package: labels each accepts, scores of
# moderate size (exp stays far from overflow)
_LABELS = {
    "regression_l1": "normal", "huber": "normal", "fair": "normal",
    "quantile": "normal", "mape": "normal", "poisson": "positive",
    "gamma": "positive", "tweedie": "positive", "xentropy": "unit",
    "xentlambda": "unit", "multiclass": "class", "multiclassova": "class"}


def _labels(kind, rng, n):
    if kind == "normal":
        return (rng.normal(size=n) * 3).astype(np.float32)
    if kind == "positive":
        return rng.gamma(2.0, 1.5, size=n).astype(np.float32)
    if kind == "unit":
        return rng.uniform(size=n).astype(np.float32)
    return rng.randint(0, 3, size=n).astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("objective", sorted(_LABELS))
def test_every_objective_matches_jax(objective, weighted):
    """Gradients and hessians at rtol 1e-6 (atol 1e-6 of the largest
    value, for the cancellations of 1 - label * exp(-s) and the like),
    boost_from_score, convert_output and the objective string."""
    rng = np.random.RandomState(len(objective) + weighted)
    n = 2000
    label = _labels(_LABELS[objective], rng, n)
    weight = (rng.uniform(0.5, 2.0, size=n).astype(np.float32)
              if weighted else None)
    params = {"objective": objective, "num_class": 3, "alpha": 0.7,
              "tweedie_variance_power": 1.3}
    oj, ot = _objectives(params, label, weight)
    K = ot.num_model_per_iteration
    score = (rng.normal(size=(K, n)) * 1.5).astype(np.float32)
    if K == 1:
        score = score[0]
    gj, hj = oj.get_gradients(jnp.asarray(score), jnp.asarray(label),
                              None if weight is None else jnp.asarray(weight))
    gt, ht = ot.get_gradients(torch.tensor(score), torch.tensor(label),
                              None if weight is None else torch.tensor(weight))
    for got, want in ((gt, gj), (ht, hj)):
        want = np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    for k in range(K):
        assert ot.boost_from_score(k) == oj.boost_from_score(k)
    s = score.astype(np.float64)
    np.testing.assert_array_equal(ot.convert_output(s),
                                  np.asarray(oj.convert_output(s)))
    assert ot.to_string() == oj.to_string()
    for attr in ("is_constant_hessian", "need_convert_output",
                 "need_renew_tree_output", "runs_on_host",
                 "num_model_per_iteration"):
        assert getattr(ot, attr) == getattr(oj, attr), attr
    if ot.need_renew_tree_output:
        assert ot.renew_tree_output_quantile() == \
            oj.renew_tree_output_quantile()
        wt, wj = ot.renew_sample_weights(), oj.renew_sample_weights()
        assert (wt is None) == (wj is None)
        if wt is not None:
            np.testing.assert_array_equal(wt, wj)


def test_registry_and_percentiles_match_jax():
    """The same objective names, each to the same class, and the two
    reference percentiles bitwise on values with ties."""
    assert set(tobj._OBJECTIVE_REGISTRY) == set(jobj._OBJECTIVE_REGISTRY)
    for name, cls in tobj._OBJECTIVE_REGISTRY.items():
        assert cls.__name__ == jobj._OBJECTIVE_REGISTRY[name].__name__
    rng = np.random.RandomState(8)
    v = np.round(rng.normal(size=301), 1)
    w = rng.uniform(0.1, 3.0, size=301)
    for alpha in (0.0, 0.1, 0.5, 0.9, 1.0):
        for n in (0, 1, 2, 7, 301):
            assert tobj.percentile_ref(v[:n], alpha) == \
                jobj.percentile_ref(v[:n], alpha)
            assert tobj.weighted_percentile_ref(v[:n], w[:n], alpha) == \
                jobj.weighted_percentile_ref(v[:n], w[:n], alpha)


def test_l1_renewal_training_matches_jax():
    """3 rounds of regression_l1 with bagging: each leaf renewed to the
    median residual of its in-bag rows (a host percentile), the same trees
    and leaf values as the JAX package's."""
    import lightgbm_tpu as lj
    import lightgbm_tpu_torch as lt
    rng = np.random.RandomState(21)
    X = rng.normal(size=(2000, 6)).astype(np.float32)
    y = (X @ np.array([3.0, -2.0, 1.0, 0.0, 0.5, 0.0])
         + rng.laplace(size=2000)).astype(np.float32)
    p = dict(objective="regression_l1", num_leaves=15, max_bin=63,
             verbose=-1, bagging_fraction=0.7, bagging_freq=1)
    bj = lj.train(p, lj.Dataset(X, label=y), 3)
    bt = lt.train({**p, "device_type": "cpu"}, lt.Dataset(X, label=y), 3)
    for a, b in zip(bt._gbdt.models, bj._gbdt.models):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.threshold_in_bin, b.threshold_in_bin)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=0,
                                   atol=1e-5)
    assert len(bt._gbdt.models) == len(bj._gbdt.models) == 3
    # a Newton step of sign gradients (hess 1) is at most 1 before the
    # shrinkage of 0.1; the renewed medians of residuals on this label's
    # scale are larger, so the renewal ran
    assert np.abs(bt._gbdt.models[1].leaf_value).max() > 0.1
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=0,
                               atol=1e-5)
    assert bt.eval_train()[0][:2] == ("training", "l1")
