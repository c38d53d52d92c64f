"""Every input the JAX package's Dataset takes, in the port, and the C++
export of a model, against the JAX package on the CPU.

  * scipy CSR and CSC matrices (binned one column at a time, never
    densified), a pyarrow Table with an Arrow label and weight, Sequence
    sources (one, a list, with a `reference`): bins and bin mappers equal
    to the JAX package's bit for bit, and the same trees (3 rounds,
    compared as tests/test_torch_boosting_modes.py compares models) with
    raw predictions of the same input within 1e-6 of JAX's;
  * the binary cache: a round trip in the port, and caches written by
    either package loaded by the other; a reference with other mappers is
    fatal with JAX's message; a path that is not a cache raises naming
    ROADMAP item A18 (text files);
  * Booster.dump_model_to_cpp byte for byte the JAX package's for the same
    model text (None, Zero and NaN missing types, categorical bitsets),
    and its fatal for linear trees.
"""

import json

import numpy as np
import pyarrow as pa
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.utils.log import FatalError as JFatal
from lightgbm_tpu_torch.utils.log import FatalError as TFatal

from test_torch_boosting_modes import assert_text_close
from test_torch_serial_growers import assert_models_close

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

TORCH = {"device_type": "cpu", "binning_impl": "host"}
PARAMS = dict(objective="binary", num_leaves=15, max_bin=63,
              min_data_in_leaf=10, verbose=-1)
# a smaller sample than the rows, so the constructors' sampling runs
DS_PARAMS = {"bin_construct_sample_cnt": 900, "max_bin": 63}


def _data(n=1500):
    """n x 6 rows, two thirds of them zero (a sparse matrix), NaN in
    feature 3; label, weights on a 1/2 grid."""
    rng = np.random.RandomState(12)
    X = rng.normal(size=(n, 6))
    X[rng.rand(n, 6) < 0.66] = 0.0
    X[rng.rand(n) < 0.05, 3] = np.nan
    z = X[:, 0] - 2 * X[:, 1] + np.nan_to_num(X[:, 3]) + 0.5 * X[:, 5]
    y = (z + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    w = (rng.randint(1, 4, n) / 2).astype(np.float32)
    return X, y, w


X, Y, W = _data()


def _seq_class(mod, batch):
    class Rows(mod.Sequence):
        batch_size = batch

        def __init__(self, a):
            self.a = a

        def __len__(self):
            return len(self.a)

        def __getitem__(self, idx):
            return self.a[idx]
    return Rows


def _inputs(mod):
    Rows = _seq_class(mod, 128)
    return {
        "csr": (sp.csr_matrix(X), Y, W),
        "csc": (sp.csc_matrix(X), Y, W),
        "arrow": (pa.table({f"c{j}": X[:, j] for j in range(6)}),
                  pa.array(Y), pa.array(W)),
        "sequence": (Rows(X), Y, W),
        "sequences": ([Rows(X[:700]), Rows(X[700:1100]), Rows(X[1100:])],
                      Y, W),
    }


def _handles(mod, kind, ref=False):
    data, y, w = _inputs(mod)[kind]
    p = {**DS_PARAMS, **(TORCH if mod is lt else {})}
    if not ref:
        return mod.Dataset(data, label=y, weight=w, params=p).construct()
    base = mod.Dataset(X[:1000], label=Y[:1000], params=p).construct()
    return mod.Dataset(data, label=y, weight=w, reference=base,
                       params=p).construct()


@pytest.fixture(scope="module")
def jax_models():
    """The JAX package's 3-round models, made once: of the CSR input, and
    of the Arrow table, whose column names the model carries. Every input
    kind bins to the same JAX Dataset (each test asserts it), so one of
    them is each kind's JAX model."""
    cache = {}

    def get(kind):
        key = "arrow" if kind == "arrow" else "csr"
        if key not in cache:
            ds = _handles(lj, key)
            cache[key] = (ds, lj.train(PARAMS, ds, 3))
        return cache[key]
    return get


def _mappers(h):
    # as JSON: a NaN-missing feature's last upper bound is NaN
    return [json.dumps(m.to_dict()) for m in h.mappers]


def _assert_same_bins(hj, ht):
    assert _mappers(ht) == _mappers(hj)
    assert ht.real_feature_index == list(hj.real_feature_index)
    assert ht.used_feature_map == list(hj.used_feature_map)
    assert ht.X_binned.dtype == hj.X_binned.dtype
    np.testing.assert_array_equal(ht.X_binned, hj.X_binned)
    for k in ("label", "weight"):
        np.testing.assert_array_equal(getattr(ht.metadata, k),
                                      getattr(hj.metadata, k))


@pytest.mark.parametrize("kind", ["csr", "csc", "arrow", "sequence",
                                  "sequences"])
def test_input_bins_and_trees_equal_jax(jax_models, kind):
    dj = _handles(lj, kind)
    d_csr, bj = jax_models(kind)
    _assert_same_bins(d_csr._handle, dj._handle)
    dt = _handles(lt, kind)
    _assert_same_bins(dj._handle, dt._handle)
    # the binned matrix went to the dataset's device as the matrix path's
    ht = dt._handle
    assert torch.equal(ht.X_t, torch.from_numpy(ht.X_binned.T.copy()))
    if kind == "arrow":
        assert ht.feature_names == [f"c{j}" for j in range(6)]
    bt = lt.train({**PARAMS, **TORCH}, dt, 3)
    assert_text_close(bj.model_to_string(), bt.model_to_string())
    rows = {"csr": sp.csr_matrix(X), "csc": sp.csc_matrix(X),
            "arrow": pa.table({f"c{j}": X[:, j] for j in range(6)})}.get(
                kind, X)
    pj = bj.predict(rows, raw_score=True)
    np.testing.assert_allclose(bt.predict(rows, raw_score=True), pj,
                               rtol=0, atol=1e-6 * (1 + np.abs(pj).max()))


@pytest.mark.parametrize("kind", ["csr", "sequence"])
def test_input_with_reference_equals_jax(kind):
    _assert_same_bins(_handles(lj, kind, ref=True)._handle,
                      _handles(lt, kind, ref=True)._handle)


def test_sparse_input_keeps_no_raw_rows_for_linear_trees():
    p = {**PARAMS, **TORCH, "linear_tree": True}
    msg = "linear_tree requires raw feature values"
    with pytest.raises(TFatal, match=msg):
        lt.train(p, lt.Dataset(sp.csr_matrix(X), label=Y, params=p), 1)
    with pytest.raises(JFatal, match=msg):
        pj = {k: v for k, v in p.items() if k not in TORCH}
        lj.train(pj, lj.Dataset(sp.csr_matrix(X), label=Y, params=pj), 1)


# ---------------------------------------------------------------------------
# the binary cache
# ---------------------------------------------------------------------------
def _cache_source(mod):
    g = np.array([300, 700, 500])
    p = {**DS_PARAMS, **(TORCH if mod is lt else {})}
    # init scores on a 1/64 grid: the first tree's gradients sum exactly
    init = np.round(np.linspace(-1, 1, len(Y)) * 64) / 64
    return mod.Dataset(X, label=Y, weight=W, group=g, init_score=init,
                       params=p)


@pytest.mark.parametrize("writer,reader", [(lt, lt), (lj, lt), (lt, lj)])
def test_binary_cache_loads_in_either_package(tmp_path, writer, reader):
    path = str(tmp_path / "train.bin")
    src = _cache_source(writer).save_binary(path)
    p = {**DS_PARAMS, **(TORCH if reader is lt else {})}
    got = reader.Dataset(path, params=p).construct()._handle
    want = src._handle
    _assert_same_bins(want, got)
    np.testing.assert_array_equal(got.metadata.query_boundaries,
                                  want.metadata.query_boundaries)
    np.testing.assert_array_equal(got.metadata.init_score,
                                  want.metadata.init_score)
    assert got.feature_names == want.feature_names
    if reader is lt:
        assert torch.equal(got.X_t, torch.from_numpy(got.X_binned.T.copy()))
        # the metadata given at load time replaces the cached
        y2 = 1.0 - Y
        ov = lt.Dataset(path, label=y2, params=p).construct()._handle
        np.testing.assert_array_equal(ov.metadata.label, y2)


def test_binary_cache_trains_jax_trees(tmp_path):
    path = str(tmp_path / "train.bin")
    _cache_source(lj).save_binary(path)
    p = dict(PARAMS, objective="regression")
    bj = lj.train(p, lj.Dataset(path), 3)
    bt = lt.train({**p, **TORCH}, lt.Dataset(path, params=TORCH), 3)
    # trees 1 and 2 read gradients off the grid: JAX's f32 sums round the
    # gains by up to 2e-5 relative (C note 9)
    assert_models_close(bj.model_to_string(), bt.model_to_string(),
                        rtol=1e-4)


@pytest.mark.parametrize("ref_kind", ["max_bin", "nan"])
def test_binary_cache_with_other_reference_is_fatal(tmp_path, ref_kind):
    """A reference binned otherwise (max_bin 15) is fatal in both packages;
    so is the cache's own source when a feature has NaN missing values:
    both compare the mappers' dicts, whose NaN upper bound never equals
    itself (ROADMAP C note 16)."""
    path = str(tmp_path / "train.bin")
    msgs = []
    for mod, Fatal in ((lj, JFatal), (lt, TFatal)):
        p = {**DS_PARAMS, **(TORCH if mod is lt else {})}
        src = _cache_source(mod).save_binary(path)
        ref = (src if ref_kind == "nan"
               else mod.Dataset(X, label=Y, params={**p, "max_bin": 15}))
        with pytest.raises(Fatal, match="differ from the reference") as e:
            mod.Dataset(path, reference=ref, params=p).construct()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_binary_cache_with_its_reference_loads(tmp_path):
    path = str(tmp_path / "train.bin")
    src = lt.Dataset(np.nan_to_num(X), label=Y,
                     params={**DS_PARAMS, **TORCH}).save_binary(path)
    got = lt.Dataset(path, reference=src, label=Y,
                     params=TORCH).construct()._handle
    assert got.reference is src._handle
    _assert_same_bins(src._handle, got)


def test_text_path_raises_naming_a18(tmp_path):
    path = tmp_path / "train.csv"
    np.savetxt(path, np.column_stack([Y, np.nan_to_num(X)]), delimiter=",")
    with pytest.raises(NotImplementedError, match="ROADMAP item A18"):
        lt.Dataset(str(path), params=TORCH).construct()


# ---------------------------------------------------------------------------
# dump_model_to_cpp
# ---------------------------------------------------------------------------
def _cpp_model(zero_as_missing):
    """A port model with numerical splits on features of missing type
    None and NaN (or Zero under zero_as_missing) and categorical splits."""
    rng = np.random.RandomState(3)
    Xc = X.copy()
    Xc[:, 4] = rng.randint(0, 40, len(Xc))
    y = (Y + (Xc[:, 4] % 3 == 0) > 0.5).astype(np.float32)
    p = {**PARAMS, **TORCH, "zero_as_missing": zero_as_missing,
         "max_cat_to_onehot": 4}
    bst = lt.train(p, lt.Dataset(Xc, label=y, categorical_feature=[4]), 3)
    return bst.model_to_string()


@pytest.mark.parametrize("zero_as_missing", [False, True])
def test_dump_model_to_cpp_equals_jax(zero_as_missing):
    text = _cpp_model(zero_as_missing)
    bt = lt.Booster(model_str=text, params=TORCH)
    types = {(int(d) >> 2) & 3 for t in bt._gbdt.models
             for d in t.decision_type}
    assert ({1} if zero_as_missing else {0, 2}) <= types
    assert any(t.num_cat for t in bt._gbdt.models)
    cpp = bt.dump_model_to_cpp()
    assert cpp == lj.Booster(model_str=text).dump_model_to_cpp()
    assert "kCatBits" in cpp and "double Predict(const double* arr)" in cpp


def test_dump_model_to_cpp_refuses_linear_trees():
    p = {**PARAMS, **TORCH, "linear_tree": True}
    text = lt.train(p, lt.Dataset(np.nan_to_num(X), label=Y, params=p),
                    2).model_to_string()
    msgs = []
    for mod, Fatal, kw in ((lt, TFatal, {"params": TORCH}),
                           (lj, JFatal, {})):
        with pytest.raises(Fatal, match=r"tree\(s\) \[0, 1\]") as e:
            mod.Booster(model_str=text, **kw).dump_model_to_cpp()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
