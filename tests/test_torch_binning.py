"""Host binning of the port against the JAX package: for the same X the
bin mappers, the inner feature order and the binned matrix are bitwise
equal (binning is integer work, so there is no tolerance)."""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt


def _matrix(seed, n=3000):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 8)).astype(np.float32)
    X[rng.rand(n) < 0.15, 0] = np.nan                 # NaN-missing column
    X[rng.rand(n) < 0.6, 1] = 0.0                     # zero-heavy column
    X[:, 2] = rng.randint(0, 5, size=n)               # few distinct values
    X[:, 3] = 1.0                                     # trivial column
    X[rng.rand(n) < 0.5, 4] = np.nan                  # half missing
    X[:, 5] = np.round(X[:, 5] * 3) / 3               # coarse grid
    X[:, 7] = np.exp(X[:, 7] * 3)                     # wide dynamic range
    return X


def _both(X, params, ref=None):
    y = (np.nan_to_num(X[:, 0]) > 0).astype(np.float32)
    pj = {"binning_impl": "host", "verbose": -1, **params}
    pt = {"device_type": "cpu", **pj}
    if ref is None:
        dj = lj.Dataset(X, label=y, params=pj).construct()
        dt = lt.Dataset(X, label=y, params=pt).construct()
    else:
        dj = lj.Dataset(X, label=y, params=pj, reference=ref[0]).construct()
        dt = lt.Dataset(X, label=y, params=pt, reference=ref[1]).construct()
    return dj, dt


def _assert_same(hj, ht):
    assert len(hj.mappers) == len(ht.mappers)
    for mj, mt in zip(hj.mappers, ht.mappers):
        dj, dt = mj.to_dict(), mt.to_dict()
        assert dj.keys() == dt.keys()
        for k in dj:
            np.testing.assert_array_equal(np.asarray(dj[k]),
                                          np.asarray(dt[k]), err_msg=k)
    assert list(hj.real_feature_index) == list(ht.real_feature_index)
    assert list(hj.used_feature_map) == list(ht.used_feature_map)
    assert hj.X_binned.dtype == ht.X_binned.dtype
    np.testing.assert_array_equal(hj.X_binned, ht.X_binned)
    assert ht.feature_infos() == hj.feature_infos()


@pytest.mark.parametrize("max_bin", [63, 255, 15])
def test_mappers_and_bins_equal(max_bin):
    X = _matrix(max_bin)
    dj, dt = _both(X, {"max_bin": max_bin})
    _assert_same(dj._handle, dt._handle)
    # the device copy is the feature-major binned matrix
    assert dt._handle.X_t.dtype == torch.uint8
    np.testing.assert_array_equal(dt._handle.X_t.numpy(),
                                  dt._handle.X_binned.T)


@pytest.mark.parametrize("params", [{"zero_as_missing": True},
                                    {"use_missing": False},
                                    {"min_data_in_bin": 50}])
def test_missing_options_equal(params):
    X = _matrix(1)
    dj, dt = _both(X, {"max_bin": 63, **params})
    _assert_same(dj._handle, dt._handle)


def test_tier_order_moves_narrow_features_first():
    X = _matrix(2)
    _, dt = _both(X, {"max_bin": 255})
    widths = [m.num_bin for m in dt._handle.mappers]
    lane = [next(w for w in (32, 64, 128, 256, 512) if n <= w)
            for n in widths]
    assert lane == sorted(lane)
    assert list(dt._handle.real_feature_index) != sorted(
        dt._handle.real_feature_index)


def test_valid_set_reuses_reference_bins():
    X = _matrix(3)
    dj, dt = _both(X, {"max_bin": 63})
    Xv = _matrix(4, n=700)
    vj, vt = _both(Xv, {"max_bin": 63}, ref=(dj, dt))
    assert vt._handle.mappers is dt._handle.mappers
    np.testing.assert_array_equal(vj._handle.X_binned, vt._handle.X_binned)


def test_value_to_bin_matches_on_raw_values():
    """BinMapper.value_to_bin of the port (NumPy only) equals the JAX
    package's (which may take a native fast path) on values straddling
    every bin bound."""
    X = _matrix(5)
    dj, dt = _both(X, {"max_bin": 63})
    for mj, mt in zip(dj._handle.mappers, dt._handle.mappers):
        ub = np.asarray(mt.bin_upper_bound, np.float64)
        fin = ub[np.isfinite(ub)]
        probe = np.concatenate([fin, np.nextafter(fin, -np.inf),
                                np.nextafter(fin, np.inf),
                                [np.nan, 0.0, -0.0, 1e30, -1e30]])
        np.testing.assert_array_equal(mj.value_to_bin(probe),
                                      mt.value_to_bin(probe))
