"""The port's autotuner (lightgbm_tpu_torch/runtime/autotune.py) held to
the JAX package's: the helpers agree, a decision under one fake clock is
the same decision (the JAX package drops its fused-wave probe on the CPU,
where its Pallas kernels do not run: `fused_wave_timings` is the stated
difference), autotune=false and a cache pre-seeded with the ladder's
choice reproduce the untuned model, a pinned decision grows the JAX
package's trees, a forced tpu_grower skips the probes, and
binning_impl=auto under autotune bins bitwise as the untuned run and
caches its decision."""

import json
import os
import types

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.runtime import autotune as jat
from lightgbm_tpu_torch.ops.grow import GrowConfig
from lightgbm_tpu_torch.runtime import autotune as tat
from test_torch_boosting_modes import _nums, _split_text

torch.set_num_threads(1)

PARAMS = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
          "min_data_in_leaf": 5, "seed": 7}
CPU = {"device_type": "cpu"}
CANDIDATES = ["wave", "compact", "masked"]


@pytest.fixture(autouse=True)
def _isolate_autotune_cache(tmp_path, monkeypatch):
    """Every test's decisions stay out of the user-level disk cache and
    out of other tests' in-process caches, in both packages."""
    monkeypatch.setenv("LIGHTGBM_TPU_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    saved = [(c, dict(c)) for c in (jat._MEM_CACHE, tat._MEM_CACHE)]
    for c, _ in saved:
        c.clear()
    yield
    for c, old in saved:
        c.clear()
        c.update(old)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(42)
    X = rng.normal(size=(1200, 6))
    y = (X[:, 0] + X[:, 1] > 0).astype(int)
    return X, y


def _fake_clock():
    """Each call advances 1 s: every probe measures exactly 1 s, so the
    candidates tie and the tie resolves by preference order."""
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]
    return clock


def _exploding_timer():
    raise AssertionError("a cache hit must not probe")


def test_helpers_match_jax(tmp_path):
    for timings in ({"masked": 1.0, "compact": 1.0, "wave": 1.0},
                    {"masked": 1.0, "compact": 2.0, "wave": 2.0},
                    {"masked": 1.0, "wave": 1.01}, {"masked": 1.0,
                                                    "other": 0.5}, {}):
        assert tat._pick_winner(timings, tat.AUTOTUNE_PREFERENCE) == \
            jat._pick_winner(timings, jat.AUTOTUNE_PREFERENCE)
    assert tat.AUTOTUNE_PREFERENCE == jat.AUTOTUNE_PREFERENCE
    assert tat.TIE_TOL == jat.TIE_TOL
    assert tat.HIST_IMPL_CANDIDATES == jat.HIST_IMPL_CANDIDATES
    assert tat.DEFAULT_PROBE_ROWS == jat.DEFAULT_PROBE_ROWS
    # the CPU key is the JAX package's
    assert tat.make_key(1200, 6, 255, 7) == jat.make_key(1200, 6, 255, 7) \
        == "r1200_f6_b255_l7_cpu"
    assert tat.make_key(5, 2, 63, 31, "NVIDIA H100 80GB HBM3", "t16rf0") \
        == jat.make_key(5, 2, 63, 31, "NVIDIA H100 80GB HBM3", "t16rf0") \
        == "r5_f2_b63_l31_NVIDIA_H100_80GB_HBM3_t16rf0"
    for tile, rf in ((32, True), (16, True), (32, False), (8, False)):
        cfg = types.SimpleNamespace(fused_feature_tile=tile,
                                    fused_relabel_fusion=rf)
        assert tat.fused_variant_sig(cfg) == jat.fused_variant_sig(cfg)
    assert tat.default_cache_path() == os.environ[
        "LIGHTGBM_TPU_AUTOTUNE_CACHE"]
    # the disk cache round-trips between the packages
    cache = {"k": {"grower": "wave", "timings": {"wave": 0.5}}}
    path = str(tmp_path / "sub" / "c.json")
    tat.save_disk_cache(path, cache)
    assert jat.load_disk_cache(path) == tat.load_disk_cache(path) == cache
    jat.save_disk_cache(path, {"j": {"grower": None}})
    assert tat.load_disk_cache(path) == {"j": {"grower": None}}
    with open(path, "w") as f:
        f.write("[1, 2]")
    assert tat.load_disk_cache(path) == {}
    assert tat.load_disk_cache(str(tmp_path / "missing.json")) == {}


def _probe_inputs(X, y):
    jg = lj.train(dict(PARAMS), lj.Dataset(X, label=y), 1)._gbdt
    tg = lt.train(dict(PARAMS, **CPU), lt.Dataset(X, label=y), 1)._gbdt
    np.testing.assert_array_equal(tg.X_t.numpy(), np.asarray(jg.X_t))
    return jg, tg


def test_decision_matches_jax_under_fake_clock(data, tmp_path):
    X, y = data
    jg, tg = _probe_inputs(X, y)
    kw = dict(n_rows=1200, n_features=6, max_bin=255, num_leaves=7,
              probe_rows=512, seed=7)
    dj = jat.autotune_decision(jg.X_t, jg.meta, jg.grow_cfg, CANDIDATES,
                               cache_path=str(tmp_path / "j.json"),
                               timer=_fake_clock(), **kw)
    path = str(tmp_path / "t.json")
    dt = tat.autotune_decision(tg.X_t, tg.meta, tg.grow_cfg, CANDIDATES,
                               rows_per_chunk=jg.grow_cfg.rows_per_chunk,
                               cache_path=path, timer=_fake_clock(), **kw)
    for k in ("grower", "hist_impl", "rows_per_chunk", "key", "timings",
              "hist_impl_timings", "fused_variant", "probe_rows",
              "cached"):
        assert dt[k] == dj[k], k
    assert dt["grower"] == "wave" and dt["hist_impl"] == "tiered_hilo"
    assert dt["timings"] == {"wave": 1.0, "compact": 1.0, "masked": 1.0}
    assert dt["chunk_timings"] == {}
    # the stated difference: both arms run here; the JAX package's two
    # arms are Pallas kernels, dropped on the CPU
    assert dt["fused_wave_timings"] == {"two_pass": 1.0, "fused": 1.0}
    assert dj["fused_wave_timings"] == {}
    # cached: on disk, then in memory, neither probing again
    assert json.load(open(path))[dt["key"]]["grower"] == "wave"
    tat._MEM_CACHE.clear()
    again = dict(kw, cache_path=path, timer=_exploding_timer)
    d2 = tat.autotune_decision(tg.X_t, tg.meta, tg.grow_cfg, CANDIDATES,
                               **again)
    assert d2["cached"] == "disk" and d2["grower"] == dt["grower"]
    d3 = tat.autotune_decision(tg.X_t, tg.meta, tg.grow_cfg, CANDIDATES,
                               **again)
    assert d3["cached"] == "memory"


def test_tiled_fused_probe_runs_both_arms():
    """Past 32 storage columns the fused probe times #4 + #1 + the search
    against #10 (plain versions on the CPU); past 256 bins it is empty."""
    rng = np.random.RandomState(0)
    X = torch.from_numpy(rng.randint(0, 60, (40, 3000)).astype(np.uint8))
    cfg = GrowConfig(num_leaves=15, max_depth=-1, min_data_in_leaf=20.0,
                     min_sum_hessian_in_leaf=1e-3, lambda_l1=0.0,
                     lambda_l2=0.0, max_delta_step=0.0,
                     min_gain_to_split=0.0, path_smooth=0.0,
                     num_bins_padded=64, hist_tiers=(60,) * 40)
    assert tat.probe_fused_wave(X, cfg, timer=_fake_clock()) == {
        "two_pass": 1.0, "fused": 1.0}
    assert tat.probe_fused_wave(X, cfg._replace(num_bins_padded=512)) == {}


def _strip(text):
    return text.replace("[autotune: 1]", "[autotune: 0]")


def test_off_and_preseeded_reproduce_untuned(data):
    X, y = data
    base = lt.train(dict(PARAMS, **CPU), lt.Dataset(X, label=y), 5)
    off = lt.train(dict(PARAMS, **CPU, autotune=False),
                   lt.Dataset(X, label=y), 5)
    s_base = base.model_to_string()
    assert off.model_to_string() == s_base
    g = base._gbdt
    assert g.autotune_decision is None
    key = tat.make_key(g.num_data, len(g.mappers),
                       max(m.num_bin for m in g.mappers), 7)
    tat._MEM_CACHE[key] = {"grower": g.grower, "rows_per_chunk": 8192,
                           "timings": {}, "chunk_timings": {}, "key": key,
                           "probe_rows": 0}
    on = lt.train(dict(PARAMS, **CPU, autotune=True),
                  lt.Dataset(X, label=y), 5)
    assert on._gbdt.autotune_decision["cached"] == "memory"
    assert on._gbdt.grower == g.grower
    assert _strip(on.model_to_string()) == s_base


def test_pinned_decision_grows_jax_trees(data):
    """A pre-seeded decision of compact with rowwise routes both packages
    the same way: the same tree structures, leaf values within 1e-4."""
    X, y = data
    pinned = {"grower": "compact", "hist_impl": "rowwise",
              "rows_per_chunk": 8192, "timings": {}, "chunk_timings": {},
              "probe_rows": 0}
    for mod in (tat, jat):
        key = mod.make_key(1200, 6, 255, 7)
        mod._MEM_CACHE[key] = dict(pinned, key=key)
    params = dict(PARAMS, autotune=True)
    jb = lj.train(params, lj.Dataset(X, label=y), 4)
    tb = lt.train(dict(params, **CPU), lt.Dataset(X, label=y), 4)
    for g in (jb._gbdt, tb._gbdt):
        assert g.autotune_decision["cached"] == "memory"
        assert g.grower == "compact" and g.grow_cfg.hist_impl == "rowwise"
    assert tb._gbdt.hist_route == "rowwise"
    _, bj, _ = _split_text(jb.model_to_string())
    _, bt, _ = _split_text(tb.model_to_string())
    assert len(bj) == len(bt) == 4
    for a, b in zip(bt, bj):
        for k in ("num_leaves", "split_feature", "threshold", "left_child",
                  "right_child"):
            assert a[k] == b[k], k
        np.testing.assert_allclose(_nums(a["leaf_value"]),
                                   _nums(b["leaf_value"]), rtol=1e-4,
                                   atol=1e-7)


def test_constrained_choice_skips_the_probes(data):
    X, y = data
    bst = lt.train(dict(PARAMS, **CPU, autotune=True, tpu_grower="masked"),
                   lt.Dataset(X, label=y), 2)
    assert bst._gbdt.autotune_decision is None
    assert bst._gbdt.grower == "masked"


def test_live_probes_pick_a_feasible_grower(data):
    """The real clock: some feasible grower wins, the decision lands in
    the profile, and the run trains."""
    X, y = data
    bst = lt.train(dict(PARAMS, **CPU, autotune=True, device_profile=True),
                   lt.Dataset(X, label=y), 3)
    g = bst._gbdt
    d = g.autotune_decision
    assert d["grower"] == g.grower in CANDIDATES
    assert set(d["timings"]) == set(CANDIDATES)
    assert set(d["fused_wave_timings"]) in (set(), {"two_pass", "fused"})
    assert bst.get_profile()["autotune"]["key"] == d["key"]
    assert bst.get_profile()["stage_counts"]["autotune"] == 1
    assert np.mean((bst.predict(X) > 0.5) == (y > 0.5)) > 0.9


def test_binning_auto_under_autotune(tmp_path):
    rng = np.random.RandomState(5)
    X = rng.normal(size=(2000, 4)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)

    def construct(params):
        return lt.Dataset(X, label=y, params=dict(
            CPU, verbose=-1, max_bin=63, **params)).construct()._handle

    base = construct({})
    path = str(tmp_path / "bin.json")
    tuned = construct({"autotune": True, "autotune_cache": path})
    d = tuned.binning_decision
    assert d["cached"] is False and d["key"].endswith("_binning")
    assert d["key"] == jat.make_key(2000, 4, 63, 31) + "_binning"
    assert set(d["binning_timings"]) == {"host", "device"}
    assert tuned.binning_route == ("device" if d["binning_impl"] == "device"
                                   else "host")
    np.testing.assert_array_equal(tuned.X_binned, base.X_binned)
    assert json.load(open(path))[d["key"]]["binning_impl"] == \
        d["binning_impl"]
    again = construct({"autotune": True, "autotune_cache": path})
    assert again.binning_decision["cached"] == "memory"
    tat._MEM_CACHE.clear()
    again = construct({"autotune": True, "autotune_cache": path})
    assert again.binning_decision["cached"] == "disk"
    np.testing.assert_array_equal(again.X_binned, base.X_binned)
