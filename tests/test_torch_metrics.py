"""Every metric of the port against the JAX package's, on the CPU.

Both are float64 NumPy over the same seeded scores, so each value is held
to rtol 1e-9: [N] scores for the pointwise, binary, cross-entropy and
ranking metrics (ndcg / map at several eval_at), [K, N] for the
multiclass ones (multi_logloss, multi_error with and without
multi_error_top_k, auc_mu with and without class weights); each through
its objective's output transform, with and without row weights; scores
rounded so that some tie.
"""

import numpy as np
import torch
import pytest

from lightgbm_tpu import config as jcfg
from lightgbm_tpu import metrics as jmet
from lightgbm_tpu import objectives as jobj
from lightgbm_tpu.data.dataset import Metadata as JMetadata
from lightgbm_tpu_torch import config as tcfg
from lightgbm_tpu_torch import metrics as tmet
from lightgbm_tpu_torch import objectives as tobj
from lightgbm_tpu_torch.data.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.metrics import rank_utils as trank

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

N = 1500
# metric name -> (objective whose output transform it reads, label kind)
_FAMILY = {
    **{m: ("regression", "positive") for m in (
        "l2", "mean_squared_error", "mse", "regression", "regression_l2",
        "rmse", "root_mean_squared_error", "l2_root", "l1",
        "mean_absolute_error", "mae", "regression_l1", "quantile", "huber",
        "fair", "mape", "mean_absolute_percentage_error", "r2")},
    **{m: ("poisson", "positive") for m in (
        "poisson", "gamma", "gamma_deviance", "tweedie")},
    **{m: ("binary", "binary") for m in (
        "binary_logloss", "binary", "binary_error", "auc",
        "average_precision")},
    **{m: ("multiclass", "class") for m in (
        "multi_logloss", "multiclass", "softmax", "multiclassova",
        "multi_error", "auc_mu")},
    **{m: ("lambdarank", "relevance") for m in (
        "ndcg", "lambdarank", "rank_xendcg", "xendcg", "map",
        "mean_average_precision")},
    **{m: ("xentropy", "unit") for m in (
        "cross_entropy", "xentropy", "cross_entropy_lambda", "xentlambda",
        "kullback_leibler", "kldiv")},
}
PARAMS = {"num_class": 3, "alpha": 0.7, "fair_c": 0.8,
          "tweedie_variance_power": 1.4, "eval_at": [1, 3, 10]}


def _case(kind, seed, weighted):
    rng = np.random.RandomState(seed)
    label = {"positive": lambda: rng.gamma(2.0, 1.5, size=N),
             "binary": lambda: rng.rand(N) < 0.3,
             "class": lambda: rng.randint(0, 3, size=N),
             "relevance": lambda: rng.randint(0, 5, size=N),
             "unit": lambda: rng.uniform(size=N)}[kind]().astype(np.float32)
    weight = (rng.uniform(0.5, 2.0, size=N).astype(np.float32)
              if weighted else None)
    group = None
    if kind == "relevance":
        sizes = rng.randint(1, 40, size=N)
        sizes = sizes[:np.searchsorted(np.cumsum(sizes), N)]
        group = np.append(sizes, N - sizes.sum())
        if weighted:   # one weight a query, as ranking data has
            weight = np.repeat(rng.uniform(0.5, 2.0, size=len(group)),
                               group).astype(np.float32)
    K = 3 if kind == "class" else 1
    score = np.round(rng.normal(size=(K, N)) * 1.5, 1)
    return label, weight, group, score if K > 1 else score[0]


def _metric_pair(name, params, label, weight, group):
    out = []
    for cfg_mod, met_mod, obj_mod, md_cls in (
            (jcfg, jmet, jobj, JMetadata), (tcfg, tmet, tobj, TMetadata)):
        cfg = cfg_mod.resolve_params(dict(params))
        md = md_cls(N)
        md.set_label(label)
        md.set_weight(weight)
        if group is not None:
            md.set_group(group)
        obj = obj_mod.create_objective(cfg)
        obj.init(md, N)
        m = met_mod.create_metric(name, cfg)
        m.init(md, N)
        out.append((m, obj))
    return out


def _assert_same(got, want):
    assert [(n, h) for n, _, h in got] == [(n, h) for n, _, h in want]
    np.testing.assert_allclose([v for _, v, _ in got],
                               [v for _, v, _ in want], rtol=1e-9, atol=0)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", sorted(_FAMILY))
def test_every_metric_matches_jax(name, weighted):
    objective, kind = _FAMILY[name]
    label, weight, group, score = _case(kind, len(name), weighted)
    params = {**PARAMS, "objective": objective}
    (mj, oj), (mt, ot) = _metric_pair(name, params, label, weight, group)
    assert type(mt).__name__ == type(mj).__name__
    assert mt.result_name() == mj.result_name()
    _assert_same(mt.eval(score, ot), mj.eval(score, oj))
    # and without an objective (raw scores; the binary and cross-entropy
    # metrics then take a sigmoid of their own)
    _assert_same(mt.eval(score, None), mj.eval(score, None))


@pytest.mark.parametrize("over", [{"multi_error_top_k": 2},
                                  {"auc_mu_weights": [0, 1, 2, 1, 0, 1,
                                                      3, 1, 0]}])
@pytest.mark.parametrize("weighted", [False, True])
def test_multiclass_options_match_jax(over, weighted):
    label, weight, _, score = _case("class", 5, weighted)
    name = "multi_error" if "multi_error_top_k" in over else "auc_mu"
    params = {**PARAMS, **over, "objective": "multiclass"}
    (mj, oj), (mt, ot) = _metric_pair(name, params, label, weight, None)
    assert mt.result_name() == mj.result_name()
    _assert_same(mt.eval(score, ot), mj.eval(score, oj))


def test_registry_and_defaults_match_jax():
    assert set(tmet._METRIC_REGISTRY) == set(jmet._METRIC_REGISTRY)
    for name, cls in tmet._METRIC_REGISTRY.items():
        assert cls.__name__ == jmet._METRIC_REGISTRY[name].__name__
    for obj in list(tobj._OBJECTIVE_REGISTRY) + ["lambdarank",
                                                 "rank_xendcg xx"]:
        assert tmet.default_metric_for_objective(obj) == \
            jmet.default_metric_for_objective(obj)
    assert tmet.create_metric("no_such_metric", tcfg.Config()) is None


def test_rank_utils_match_jax():
    """The DCG helpers and the default label gains, on queries with tied
    scores and an all-zero query."""
    from lightgbm_tpu.metrics import rank_utils as jrank
    np.testing.assert_array_equal(trank.default_label_gain(),
                                  jrank.default_label_gain())
    rng = np.random.RandomState(3)
    s = np.round(rng.normal(size=40), 1)
    lab = rng.randint(0, 4, size=40)
    lg = trank.default_label_gain()
    for k in (1, 5, 40):
        assert trank.dcg_at_k(s, lab, k, lg) == jrank.dcg_at_k(s, lab, k, lg)
        assert trank.max_dcg_at_k(lab, k, lg) == \
            jrank.max_dcg_at_k(lab, k, lg)
    qb = np.array([0, 10, 25, 40])
    lab[10:25] = 0
    for f in ("eval_ndcg", "eval_map"):
        args = (s, lab, qb, None, [1, 3, 20]) + (
            ([],) if f == "eval_ndcg" else ())
        assert getattr(trank, f)(*args) == getattr(jrank, f)(*args)
