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
    cfg = tcfg.resolve_params({"objective": objective, "num_class": 3})
    with pytest.raises(NotImplementedError, match="ROADMAP item A10"):
        tobj.create_objective(cfg)
