"""The port's device predictors against the JAX package's, on the CPU.

Models are trained by the JAX package and their trees and mappers carried
over with `convert.tree_from_arrays` / `BinMapper.from_dict`, so both
packages walk the same trees.
Tolerances:
  * leaf routing is bitwise: the port's raw f32 walk and bin-domain walk
    reach the leaves the JAX bin-domain walk reaches (the JAX package holds
    its raw and binned walks bitwise equal to each other);
  * margins within rtol 1e-6 (atol 1e-6): the same f32 leaf values summed
    in another order;
  * inside the port, the raw walk and the binned walk give bitwise equal
    margins (one accumulation function), and the host walk of
    Booster.predict is the f64 PackedModel walk, bitwise.
"""

import types

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
from lightgbm_tpu.models.predictor import PackedModel as JPackedModel
from lightgbm_tpu.models.predictor import \
    predict_margin_device as j_predict_margin_device
from lightgbm_tpu.ops.predict import \
    predict_margin_packed as j_predict_margin_packed
from lightgbm_tpu.ops.predict_binned import build_binned_model as j_build
from lightgbm_tpu.ops.predict_binned import mappers_for as j_mappers_for
from lightgbm_tpu.ops.predict_binned import \
    predict_leaves_binned as j_predict_leaves_binned
from lightgbm_tpu_torch.convert import tree_from_arrays
from lightgbm_tpu_torch.data.binning import BinMapper
from lightgbm_tpu_torch.models import gbdt as tgbdt
from lightgbm_tpu_torch.models.predictor import (PackedModel,
                                                 build_device_tables,
                                                 predict_margin_device)
from lightgbm_tpu_torch.ops.predict import (predict_leaves_packed,
                                            predict_margin_packed)
from lightgbm_tpu_torch.ops.predict_binned import (build_binned_model,
                                                   mappers_for,
                                                   predict_leaves_binned,
                                                   predict_margin_binned)

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

COLS = 8
CPU = torch.device("cpu")


def _train_jax(kind, seed):
    rng = np.random.RandomState(seed)
    n = 1500
    X = rng.normal(size=(n, COLS))
    params = dict(num_leaves=15, verbose=-1, min_data_in_leaf=5,
                  max_bin=63)
    cat = []
    if kind == "categorical":
        X[:, 2] = rng.randint(0, 12, size=n)
        X[:, 5] = rng.randint(0, 8, size=n)
        y = np.where(np.isin(X[:, 2], (1, 4, 7, 9)), 3.0, -3.0) \
            + np.where(np.isin(X[:, 5], (0, 2, 5)), 1.5, -1.5) \
            + X[:, 0]
        params["objective"] = "regression"
        cat = [2, 5]
    elif kind == "multiclass":
        y = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0.5).astype(int)
        params.update(objective="multiclass", num_class=3)
    else:
        y = (X[:, 0] + X[:, 1] > 0).astype(float)
        params.update(objective="binary", zero_as_missing=kind == "zero")
    X[rng.rand(n, COLS) < 0.05] = np.nan
    X[rng.rand(n, COLS) < 0.05] = 0.0
    X = X.astype(np.float32).astype(np.float64)
    ds = lj.Dataset(X, label=y, categorical_feature=cat or "auto")
    return lj.train(params, ds, num_boost_round=10), X


def _port(jbst):
    """The JAX model's trees and mappers as the port's objects, in a
    GBDT-shaped namespace (the fields the predictors read)."""
    g = jbst._gbdt
    return types.SimpleNamespace(
        models=[tree_from_arrays(vars(t)) for t in g.models],
        mappers=[BinMapper.from_dict(m.to_dict()) for m in g.mappers],
        real_feature_index=list(g.real_feature_index),
        max_feature_idx_=g.max_feature_idx_,
        num_tree_per_iteration=g.num_tree_per_iteration)


def _queries(X, seed, n=600):
    rng = np.random.RandomState(seed)
    q = rng.normal(scale=2.0, size=(n, X.shape[1]))
    q[rng.rand(*q.shape) < 0.08] = np.nan
    q[rng.rand(*q.shape) < 0.08] = 0.0
    q[:100] = X[:100]
    return q.astype(np.float32)


@pytest.fixture(scope="module", params=["binary", "zero", "categorical",
                                        "multiclass"])
def models(request):
    jbst, X = _train_jax(request.param, 7)
    q = _queries(X, 3)
    if request.param == "categorical":
        q[:, 2] = np.random.RandomState(4).randint(-2, 14, size=len(q))
        q[5:12, 2] = [99, -3, 7.7, np.nan, 1000, -0.5, 11]
    return jbst, _port(jbst), q


def _jax_leaves(jbst, q):
    g = jbst._gbdt
    pm = JPackedModel(g.models, g.num_tree_per_iteration)
    bm = j_build(pm, j_mappers_for(g))
    return np.asarray(j_predict_leaves_binned(
        bm.device_arrays(), bm.bin_rows(q.astype(np.float64))))


def test_packed_walk_routes_like_jax(models):
    jbst, g, q = models
    K = g.num_tree_per_iteration
    pm = PackedModel(g.models, K)
    pa = pm.device_arrays(CPU)
    leaves = predict_leaves_packed(pa, torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(leaves, _jax_leaves(jbst, q))
    got = predict_margin_packed(pa, torch.from_numpy(q), K).numpy()
    jg = jbst._gbdt
    ref = np.asarray(j_predict_margin_packed(
        JPackedModel(jg.models, K).device_arrays(), q, K))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_binned_walk_bitwise_equals_packed_walk(models):
    jbst, g, q = models
    K = g.num_tree_per_iteration
    pm = PackedModel(g.models, K)
    bm = build_binned_model(pm, mappers_for(g))
    Xb = torch.from_numpy(bm.bin_rows(q.astype(np.float64)))
    pa = bm.device_arrays(CPU)
    np.testing.assert_array_equal(predict_leaves_binned(pa, Xb).numpy(),
                                  _jax_leaves(jbst, q))
    raw = predict_margin_packed(pm.device_arrays(CPU),
                                torch.from_numpy(q), K)
    assert torch.equal(predict_margin_binned(pa, Xb, K), raw)
    # the host binned walk is the host raw walk, bit for bit
    q64 = q.astype(np.float64)
    np.testing.assert_array_equal(bm.predict_margin(bm.bin_rows(q64)),
                                  pm.predict_margin(q64))


def test_predict_margin_device_equals_jax(models):
    jbst, g, q = models
    K = g.num_tree_per_iteration
    got = predict_margin_device(g.models, K, q, chunk=256, device=CPU)
    jg = jbst._gbdt
    ref = j_predict_margin_device(jg.models, K, q, chunk=256)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # the device tables are reusable across calls
    tables = build_device_tables(g.models, K, CPU)
    again = predict_margin_device(g.models, K, q, tables=tables)
    np.testing.assert_array_equal(again, got)


def test_single_row_path_matches_batch(models):
    _, g, q = models
    K = g.num_tree_per_iteration
    pm = PackedModel(g.models, K)
    q64 = q.astype(np.float64)
    batch = pm.predict_margin(q64[:5])
    for i in range(5):
        np.testing.assert_allclose(pm.predict_single(q64[i]), batch[:, i],
                                   rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def big_binary():
    """A port-trained binary model and a 100k-row f32 batch: the size at
    which Booster.predict routes f32 input to the device predictor."""
    import lightgbm_tpu_torch as lt
    rng = np.random.RandomState(5)
    X = rng.normal(size=(3000, 6)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    bst = lt.train(dict(objective="binary", num_leaves=15, verbose=-1,
                        device_type="cpu"), lt.Dataset(X, label=y), 4)
    Q = rng.normal(size=(100_000, 6)).astype(np.float32)
    Q[rng.rand(*Q.shape) < 0.02] = np.nan
    return bst, Q


def test_booster_predict_large_f32_batch(big_binary, monkeypatch):
    bst, Q = big_binary
    # device_type="cpu": the host walk, bitwise the f64 walk
    host = bst.predict(Q)
    np.testing.assert_array_equal(host, bst.predict(Q.astype(np.float64)))
    assert getattr(bst._gbdt, "_device_tables_cache", None) is None
    # a CUDA Booster takes the device route for this batch; here the CUDA
    # device is stood in for by the CPU, where the route's tensors then run
    g = bst._gbdt
    monkeypatch.setattr(g.config, "device_type", "cuda")
    monkeypatch.setattr(tgbdt, "resolve_device", lambda _: CPU)
    dev = bst.predict(Q)
    assert g._device_tables_cache is not None
    # f32 leaf sums against the f64 host walk
    np.testing.assert_allclose(dev, host, rtol=0, atol=1e-5)
    # below 100k rows, or in f64, the host walk stays
    g._device_tables_cache = None
    np.testing.assert_array_equal(bst.predict(Q[:99_999]), host[:99_999])
    bst.predict(Q.astype(np.float64))
    assert g._device_tables_cache is None


def _port_booster(jbst):
    """The JAX model as a port Booster (convert.booster_from_state)."""
    from lightgbm_tpu_torch.convert import booster_from_state
    g = jbst._gbdt
    return booster_from_state(
        params={**jbst.params, "device_type": "cpu"},
        trees=[vars(t) for t in g.models],
        mappers=[m.to_dict() for m in g.mappers],
        real_feature_index=g.real_feature_index,
        feature_names=g.feature_names_,
        num_total_features=g.max_feature_idx_ + 1)


def test_pred_leaf_matches_jax(models):
    """Booster.predict(pred_leaf=True) of the first 3 iterations is the
    JAX package's [N, 3 K] leaf indices (iteration, then class), and the
    whole model's too; pred_contrib gives the JAX package's SHAP feature
    values (tests/test_torch_sklearn.py holds them further); unknown
    keywords raise."""
    jbst, g, q = models
    K = g.num_tree_per_iteration
    bst = _port_booster(jbst)
    q64 = q.astype(np.float64)
    got = bst.predict(q64, pred_leaf=True, num_iteration=3)
    assert got.shape == (len(q), 3 * K)
    np.testing.assert_array_equal(
        got, jbst.predict(q64, pred_leaf=True, num_iteration=3))
    np.testing.assert_array_equal(bst.predict(q64, pred_leaf=True),
                                  jbst.predict(q64, pred_leaf=True))
    # the feature columns; the expected values weigh leaves by count in
    # the port, by hessian sum in JAX (ROADMAP C note 18)
    F = q.shape[1]
    np.testing.assert_array_equal(
        bst.predict(q64[:8], pred_contrib=True).reshape(8, K, F + 1)[..., :F],
        jbst.predict(q64[:8], pred_contrib=True).reshape(8, K, F + 1)[..., :F])
    with pytest.raises(NotImplementedError, match="ROADMAP item A18"):
        bst.predict(q64, validate_features=True)
