"""More than 256 bins a feature (uint16 storage) in the port, on the CPU.

  * The bins: `max_bin` 511 and 1023 and a `max_bin_by_feature` entry over
    256 give the JAX package's uint16 matrix bit for bit, and the port keeps
    a uint16 `X_t` for the device.
  * Whole runs against `lightgbm_tpu.train` (5 rounds of binary logloss
    gradients on a 1/64 grid, the wave grower on the apply route in the
    port, the JAX package's XLA path): `max_bin` 1023 with a categorical
    feature of 400 categories, and `max_bin_by_feature` with entries of
    300 and 1000; the trees at tests/test_torch_train.py's tolerance and
    the raw predictions within 1e-5.
  * The routes past 256 bins: "apply" with the "slots" histogram whatever
    histogram_impl asks, the fused kernels vetoed with a reason that names
    the bin count; device binning and the binned serving engine refuse.
  * The plain versions of #1 (slot and window histograms), #4 and the
    window partition on uint16 bins against their results on the same
    bins stored as uint8.
  * The tile planner cuts a column's bin range where one column does not
    fit a tile (past 3072 bins at C = 2 in f64).

The serial growers and wave_exact on uint16 against the JAX package's:
tests/test_torch_wide_growers.py.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ops import histogram_cuda as hc
from lightgbm_tpu_torch.ops.predict_binned import BinnedUnavailable

from test_torch_train import _assert_same_trees

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

TORCH = {"device_type": "cpu", "binning_impl": "host"}
PARAMS = dict(objective="binary", num_leaves=15, learning_rate=0.1,
              min_data_in_leaf=10, verbose=-1)
CASES = {
    "max_bin_511": ({"max_bin": 511}, False),
    "max_bin_1023_cat": ({"max_bin": 1023}, True),
    "by_feature": ({"max_bin": 63,
                    "max_bin_by_feature": [300, 63, 1000, 63, 63, 20]},
                   False),
}


def wide_data(n=3000, seed=7):
    """n x 6 rows: NaN in feature 0, zeros in a third of feature 1, an
    integer feature of 800 values (3) and one of 400 values (4, the
    categorical one where a case says so)."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    X[rng.rand(n) < 0.1, 0] = np.nan
    X[rng.rand(n) < 0.3, 1] = 0.0
    X[:, 3] = rng.randint(0, 800, n)
    X[:, 4] = rng.randint(0, 400, n)
    z = (np.nan_to_num(X[:, 0]) - X[:, 1] + np.sin(3 * X[:, 2])
         + np.cos(X[:, 3] * 0.02) + 2 * np.sin(X[:, 4] * 1.7)
         + 0.3 * X[:, 5])
    y = (z + rng.normal(scale=0.4, size=n) > 0).astype(np.float32)
    return X, y


def _dskw(cat):
    return {"categorical_feature": [4]} if cat else {}


@pytest.fixture(scope="module")
def data():
    return wide_data()


@pytest.mark.parametrize("case", list(CASES))
def test_bins_equal_jax_in_uint16(case, data):
    X, y = data
    over, cat = CASES[case]
    p = {**PARAMS, **over}
    hj = lj.Dataset(X, label=y, params=p, **_dskw(cat)).construct()._handle
    ht = lt.Dataset(X, label=y, params={**p, **TORCH},
                    **_dskw(cat)).construct()._handle
    assert hj.X_binned.dtype == ht.X_binned.dtype == np.uint16
    np.testing.assert_array_equal(ht.X_binned, hj.X_binned)
    assert [m.num_bin for m in ht.mappers] == [m.num_bin for m in
                                               hj.mappers]
    assert max(m.num_bin for m in ht.mappers) > 256
    assert ht.X_t.dtype == torch.uint16
    np.testing.assert_array_equal(ht.X_t.numpy().T, ht.X_binned)


def _grid_fobj(y):
    """Binary logloss gradients rounded to a 1/64 grid, so every
    histogram sum is exact in both packages and exact ties are decided
    alike (ROADMAP C note 9: at 1000 bins over 3000 rows, thresholds
    across empty bins tie)."""
    def fobj(score, ds):
        p = 1.0 / (1.0 + np.exp(-np.asarray(score, np.float64)))
        g = np.round((p - y) * 64) / 64
        h = np.maximum(np.round(p * (1.0 - p) * 64), 1) / 64
        return g.astype(np.float32), h.astype(np.float32)
    return fobj


@pytest.mark.parametrize("case", ["max_bin_1023_cat", "by_feature"])
def test_training_equals_jax(case, data):
    X, y = data
    over, cat = CASES[case]
    p = {**PARAMS, **over, "objective": "none", "metric": "none"}
    bj = lj.train(p, lj.Dataset(X, label=y, **_dskw(cat)), 5,
                  fobj=_grid_fobj(y))
    bt = lt.train({**p, **TORCH}, lt.Dataset(X, label=y, **_dskw(cat)), 5,
                  fobj=_grid_fobj(y))
    g = bt._gbdt
    assert (g.grow_route, g.hist_route) == ("apply", "slots")
    assert g.X_t.dtype == torch.uint16 and g.num_bins_padded > 256
    if cat:
        assert g.grow_cfg.has_categorical
        # a categorical split whose left set reaches past category 255
        words = [np.diff(t.cat_boundaries).max() for t in g.models
                 if t.num_cat > 0]
        assert words and max(words) > 8
    _assert_same_trees(bt.model_to_string(), bj.model_to_string())
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("over", [
    {}, {"force_row_wise": True}, {"histogram_impl": "rowwise_packed"},
    {"histogram_impl": "fused"}, {"tpu_grower": "wave_exact"}])
def test_routes_past_256_bins(over, data):
    """The JAX package's Pallas-free route (`_use_pallas` false past 256
    bins): never "mega", no row-wise layout, the fused kernels vetoed with
    the bin count named."""
    X, y = data
    bt = lt.train({**PARAMS, **TORCH, "max_bin": 1023, **over},
                  lt.Dataset(X[:1000], label=y[:1000]), 1)
    g = bt._gbdt
    assert (g.grow_route, g.hist_route) == ("apply", "slots")
    if over.get("histogram_impl") == "fused":
        assert g.fused_veto_reasons == [
            f"wide_bins (B={g.num_bins_padded} > 256)"]
    else:
        assert g.fused_veto_reasons == []


def test_device_binning_and_binned_serving_refuse(data):
    X, y = data
    p = {**PARAMS, "max_bin": 1023, "device_type": "cpu"}
    with pytest.raises(ValueError, match="overflow uint8"):
        lt.Dataset(X, label=y, params={**p, "binning_impl": "device"}
                   ).construct()
    ds = lt.Dataset(X, label=y, params={**p, "binning_impl": "auto"})
    assert ds.construct()._handle.binning_route == "host"
    bst = lt.train(p, ds, 1)
    with pytest.raises(BinnedUnavailable, match="binned engine"):
        bst.serve(engine="binned")
    # raw-float serving needs nothing of the bins
    np.testing.assert_array_equal(bst.serve(engine="host").predict(X[:50]),
                                  bst.predict(X[:50]))


# ---------------------------------------------------------------------------
# the plain versions on uint16 bins
# ---------------------------------------------------------------------------
def _bins(seed, F, N, B):
    rng = np.random.RandomState(seed)
    b = rng.randint(0, B, (F, N))
    return (torch.from_numpy(b.astype(np.uint8)),
            torch.from_numpy(b.astype(np.uint16)))


def test_plain_histograms_on_uint16_equal_uint8():
    X8, X16 = _bins(0, 5, 3000, 200)
    rng = np.random.RandomState(1)
    vals = torch.from_numpy(np.round(rng.normal(size=(2, 3000)) * 64)
                            .astype(np.float32) / 64)
    q = torch.from_numpy(rng.randint(-127, 128, (2, 3000)).astype(np.int8))
    slot = torch.from_numpy(rng.randint(-1, 3, 3000).astype(np.int32))
    rows = torch.from_numpy(rng.permutation(3000).astype(np.int32))
    for v in (vals, q):
        for s, K in ((None, 1), (slot, 3)):
            assert torch.equal(
                hc.build_histogram_slots_plain(X16, v, s, K, 256),
                hc.build_histogram_slots_plain(X8, v, s, K, 256))
        for lo, hi in ((0, 3000), (700, 1900), (5, 5)):
            win = torch.tensor([lo, hi], dtype=torch.int32)
            a = hc.build_histogram_window_plain(X16, v, rows, win, 256)
            assert torch.equal(
                a, hc.build_histogram_window_plain(X8, v, rows, win, 256))
            assert torch.equal(a, hc.build_histogram_slots_plain(
                X8[:, rows[lo:hi].long()], v[:, rows[lo:hi].long()], None, 1,
                256)[0])


def test_plain_wave_apply_and_partition_on_uint16_equal_uint8():
    X8, X16 = _bins(2, 6, 2500, 256)
    rng = np.random.RandomState(3)
    lor = torch.from_numpy(rng.randint(0, 40, 2500).astype(np.int32))
    tbl = torch.full((16, 128), -1, dtype=torch.int32)
    tbl[0, :20] = torch.from_numpy(rng.permutation(40)[:20].astype(np.int32))
    tbl[7, :20] = torch.from_numpy(rng.permutation(60)[:20].astype(np.int32))
    for r0 in (1, 8):
        for i, hi in enumerate((6, 258, 2, 3, 256, 1)):
            tbl[r0 + i] = torch.from_numpy(
                rng.randint(0 if i != 1 else -1, hi, 128).astype(np.int32))
        tbl[r0 + 5] = 256
    tbl[14] = torch.from_numpy(rng.randint(0, 2, 128).astype(np.int32))
    tbl[15] = 40
    cats = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, (2, 128, 9))
                            .astype(np.int32))
    cats[:, :, 0] = torch.from_numpy(rng.randint(0, 2, (2, 128))
                                     .astype(np.int32))
    for c in (None, cats):
        a = hc.wave_apply_rows_plain(X16, lor, tbl, c, None, 20, 64)
        b = hc.wave_apply_rows_plain(X8, lor, tbl, c, None, 20, 64)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert (a[1] >= 0).any() and (a[0] != lor).any()
    order = torch.from_numpy(rng.permutation(2500).astype(np.int32))
    for start, count, is_cat in ((0, 2500, 0), (300, 1500, 1), (9, 0, 0)):
        words = rng.randint(-2 ** 31, 2 ** 31, 8)
        rec = torch.from_numpy(np.concatenate([
            [start, count, 4, 100, 1, 255, is_cat, 77, 8], words])
            .astype(np.int32))
        out = []
        for X in (X8, X16):
            o, lo = order.clone(), lor.clone()
            n = hc.window_partition_plain(X, o, lo, rec)
            out.append((o, lo, n))
        (o8, l8, n8), (o16, l16, n16) = out
        assert torch.equal(o8, o16) and torch.equal(l8, l16)
        assert torch.equal(n8, n16)
        # the window's left rows first, each side in its order; the rest
        # of the order untouched
        win = order[start:start + count].long()
        col = X8[4].long()[win]
        gl = (((torch.from_numpy(words.astype(np.int64)) & 0xFFFFFFFF)[
            col >> 5] >> (col & 31)) & 1 == 1) if is_cat else torch.where(
            col == 255, True, col <= 100)
        want = torch.cat([win[gl], win[~gl]]).to(torch.int32)
        assert torch.equal(o8[start:start + count], want)
        assert int(n8) == int(gl.sum())
        assert torch.equal(o8[:start], order[:start])
        assert (l8[win[~gl]] == 77).all()


# ---------------------------------------------------------------------------
# the tile planner past 3072 bins
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B", [3072, 3080, 4096, 1 << 16])
def test_planner_cuts_a_column_bin_range(B):
    for C, quant in ((2, False), (1, False), (4, False), (2, True)):
        acc = 4 if quant else 8
        for K in (1, 4):
            F = 3
            plan = hc.plan_hist_tiles(K, C, F, B, quantized=quant)
            assert plan.smem_bytes <= hc.HIST_SMEM_BUDGET
            if C * B * acc <= hc.HIST_SMEM_BUDGET:
                assert plan.bins_per_tile == 0
                continue
            bpt = plan.bins_per_tile
            nbt = plan.feat_tiles // F
            assert plan.feat_tiles == F * nbt and plan.feats_per_tile == 1
            assert plan.slots_per_tile == 1 and plan.slot_tiles == K
            assert bpt * C * acc == plan.smem_bytes
            # the bin tiles of a column cover its B bins once
            spans = [min(bpt, B - t * bpt) for t in range(nbt)]
            assert min(spans) >= 1 and sum(spans) == B
            assert not plan.direct
