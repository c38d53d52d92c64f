"""Host binning of the port against the JAX package: for the same X the
bin mappers, the inner feature order and the binned matrix are bitwise
equal (binning is integer work, so there is no tolerance)."""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)


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


# ---------------------------------------------------------------------------
# device binning at ingest (ops/bucketize.py): on device_type="cpu" the
# device route runs the kernel's plain version
# ---------------------------------------------------------------------------
def _construct(X, params):
    y = (np.nan_to_num(X[:, 0]) > 0).astype(np.float32)
    return lt.Dataset(X, label=y, params={"device_type": "cpu",
                                          "verbose": -1, **params}
                      ).construct()._handle


@pytest.mark.parametrize("max_bin", [63, 255, 15])
def test_device_route_equals_host_route_and_jax(max_bin):
    X = _matrix(max_bin + 100)
    dev = _construct(X, {"max_bin": max_bin, "binning_impl": "device"})
    host = _construct(X, {"max_bin": max_bin, "binning_impl": "host"})
    assert (dev.binning_route, host.binning_route) == ("device", "host")
    np.testing.assert_array_equal(dev.X_binned, host.X_binned)
    np.testing.assert_array_equal(dev.X_t.numpy(), host.X_t.numpy())
    y = (np.nan_to_num(X[:, 0]) > 0).astype(np.float32)
    dj = lj.Dataset(X, label=y, params={"max_bin": max_bin, "verbose": -1,
                                        "binning_impl": "device"}).construct()
    np.testing.assert_array_equal(dev.X_binned, dj._handle.X_binned)


def test_device_route_valid_set_and_auto_on_cpu():
    X = _matrix(6)
    dtr = lt.Dataset(X, label=X[:, 2] > 1, params={
        "device_type": "cpu", "max_bin": 63, "binning_impl": "device",
        "verbose": -1})
    Xv = _matrix(7, n=900)
    dva = lt.Dataset(Xv, reference=dtr, params=dtr.params).construct()
    assert dva._handle.binning_route == "device"
    host = _construct(Xv, {"max_bin": 63, "binning_impl": "host"})
    # the valid set reuses the training mappers: compare against a host
    # construct of the same rows through the same mappers
    ref = np.stack([m.value_to_bin(np.asarray(Xv[:, o], np.float64))
                    for m, o in zip(dtr._handle.mappers,
                                    dtr._handle.real_feature_index)], 1)
    np.testing.assert_array_equal(dva._handle.X_binned, ref)
    assert host.binning_route == "host"
    # auto resolves to the host route on the CPU
    assert _construct(X, {"max_bin": 63}).binning_route == "host"


def test_device_route_refusals(tmp_path, monkeypatch):
    X = _matrix(8)
    with pytest.raises(ValueError, match="float32"):
        _construct(X.astype(np.float64), {"binning_impl": "device"})
    # 300 bins do not fit the uint8 table: explicit device raises
    rng = np.random.RandomState(0)
    W = rng.normal(size=(3000, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="overflow uint8"):
        _construct(W, {"binning_impl": "device", "max_bin": 300,
                       "min_data_in_bin": 1})
    # autotune of binning_impl=auto (ported) probes, caches its decision
    # and bins bitwise as the untuned host route
    monkeypatch.setenv("LIGHTGBM_TPU_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    tuned = _construct(X, {"autotune": True})
    assert tuned.binning_decision["binning_impl"] in ("host", "device")
    np.testing.assert_array_equal(tuned.X_binned, _construct(X, {}).X_binned)
