"""Batched training of the regimes that grow through the extended
fixed-shape step (lightgbm_tpu_torch/ops/grow_batched.py), on the CPU:
the fused routes ("fused" with #9, "fused_tiled" with #10, float and
quantized, monotone, interaction sets), monotone `intermediate`,
`wave_exact`, forced splits, and the serial growers `masked` and
`compact` (SerialStepper: with bagging on uint16 storage past 256 bins,
compact on the row-wise routes); then the faults C5 (a NaN label
under huber, l1 and mape) and C6 (`cv` binning under its own params).

  * Each regime's batched model is md5-equal to its per-iteration model,
    the scores bitwise, at most ceil(steps / 4) + 1 blocking reads a
    tree (a step is a wave, or a split on the serial growers), and no
    step after its first call reads the device from the host
    (test_torch_batched.py's dispatch guard).
  * The device `exact_order` applies what the serial rule applies, on
    random keys with ties.
  * The port's batched trees of intermediate, wave_exact, forced splits,
    masked and compact against the JAX package's per-iteration trees, at
    tests/test_torch_train.py's tolerance. The fused routes are held to
    the port's own per-iteration run only: the JAX package's fused tiled
    route fails its own parity tests on the CPU (ROADMAP C note 2).

`tests/conftest.py` turns batched training off suite-wide; each test here
turns it on again.
"""

import json
import math

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.models import batched as tb
from lightgbm_tpu_torch.ops import grow_wave as tw
from lightgbm_tpu_torch.utils.synthetic import (CRITEO_CAT_COLUMNS,
                                                criteo_like)
from test_torch_batched import BASE, _HostReads, _dense, _md5
from test_torch_train import _assert_same_trees

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

FORCED = {"feature": 2, "threshold": 0.0,
          "left": {"feature": 3, "threshold": 0.5},
          "right": {"feature": 4, "threshold": -0.5}}
MONO = [1, -1, 0, 0, 1, 0, 0, 0]
INTER = dict(monotone_constraints=MONO,
             monotone_constraints_method="intermediate")


@pytest.fixture(autouse=True)
def batched_on(monkeypatch):
    monkeypatch.setenv("LIGHTGBM_TPU_DISABLE_BATCHED", "")


def _forced_file(tmp_path):
    path = tmp_path / "forced.json"
    path.write_text(json.dumps(FORCED))
    return str(path)


# case: (params, data, route, rounds)
CASES = {
    "fused": (dict(histogram_impl="fused"), "dense", "fused", 3),
    "fused_tiled": (dict(histogram_impl="fused", max_bin=255), "criteo",
                    "fused_tiled", 2),
    "fused_tiled_quantized": (dict(histogram_impl="fused", max_bin=255,
                                   use_quantized_grad=True,
                                   num_grad_quant_bins=4,
                                   quant_train_renew_leaf=True),
                              "criteo", "fused_tiled", 2),
    "fused_tiled_monotone": (dict(histogram_impl="fused",
                                  monotone_constraints=MONO),
                             "dense", "fused_tiled", 3),
    "fused_tiled_sets": (dict(histogram_impl="fused",
                              interaction_constraints=[[0, 1, 2],
                                                       [3, 4, 5]]),
                         "dense", "fused_tiled", 3),
    "intermediate_mega": (dict(INTER), "dense", "mega", 3),
    "intermediate_apply": (dict(INTER, force_row_wise=True), "dense",
                           "apply", 3),
    "wave_exact_mega": (dict(tpu_grower="wave_exact"), "dense", "mega", 3),
    "wave_exact_apply": (dict(tpu_grower="wave_exact", force_row_wise=True),
                         "dense", "apply", 3),
    "wave_exact_fused": (dict(tpu_grower="wave_exact",
                              histogram_impl="fused"), "dense", "fused", 3),
    "forced": (dict(forcedsplits_filename=FORCED), "dense", "mega", 3),
    "masked": (dict(tpu_grower="masked"), "dense", "masked", 3),
    "masked_bagging": (dict(tpu_grower="masked", bagging_fraction=0.7,
                            bagging_freq=1, max_bin=1023), "dense", "masked",
                       3),
    "compact": (dict(tpu_grower="compact"), "dense", "compact", 3),
    "compact_bagging": (dict(tpu_grower="compact", bagging_fraction=0.7,
                             bagging_freq=1, max_bin=1023), "dense",
                        "compact", 3),
    "compact_criteo": (dict(tpu_grower="compact", max_bin=255), "criteo",
                       "compact", 2),
    "compact_rowwise": (dict(tpu_grower="compact", max_bin=255,
                             force_row_wise=True), "criteo", "compact", 2),
    "compact_rowwise_packed": (dict(tpu_grower="compact", max_bin=255,
                                    histogram_impl="rowwise_packed"),
                               "criteo", "compact", 2),
}


def _data(kind):
    if kind == "criteo":
        X, y = criteo_like(1 << 11)
        return X, y, list(CRITEO_CAT_COLUMNS)
    X, y, _ = _dense()
    return X, y, "auto"


def _params(params, tmp_path):
    if params.get("forcedsplits_filename") is FORCED:
        params = {**params, "forcedsplits_filename": _forced_file(tmp_path)}
    return params


@pytest.mark.parametrize("case", list(CASES))
def test_regime_batched_md5_equals_per_iteration(case, tmp_path,
                                                 monkeypatch):
    params, kind, route, rounds = CASES[case]
    params = _params(params, tmp_path)
    X, y, cat = _data(kind)
    Xv, yv = X[:400], y[:400]

    def train(batched):
        ds = lt.Dataset(X, label=y, categorical_feature=cat)
        return lt.train({**BASE, **params, "batched_train": batched,
                         "metric": "binary_logloss"}, ds, rounds,
                        valid_sets=[lt.Dataset(Xv, label=yv, reference=ds)],
                        callbacks=[lt.record_evaluation({})])
    bi = train(False)
    # the dispatch guard over every step call after the first
    hits, seen = [], set()

    def guarded(self, name, fn):
        if name not in seen:
            seen.add(name)
            return fn()
        guard = _HostReads()
        with guard, monkeypatch.context() as m:
            for attr in ("tolist", "numpy", "item"):
                m.setattr(torch.Tensor, attr, lambda *a, _n=attr, **k: (
                    hits.append(_n), pytest.fail(f"{_n} in a step"))[1])
            fn()
        hits.extend(guard.hits)
    monkeypatch.setattr(tb.ChunkRunner, "_call", guarded)
    bb = train(True)
    g = bb._gbdt
    assert g.batched_veto == "" and len(g._runners) == 1
    assert g.grow_route == route
    assert bb.num_trees() == bi.num_trees() == rounds
    assert _md5(bb) == _md5(bi)
    np.testing.assert_array_equal(g.scores.numpy(),
                                  bi._gbdt.scores.numpy())
    np.testing.assert_array_equal(g._valid_scores[0].numpy(),
                                  bi._gbdt._valid_scores[0].numpy())
    runner = next(iter(g._runners.values()))
    serial = g.grower in ("masked", "compact")
    steps = [t.num_leaves - 1 if serial else t.num_waves for t in g.models]
    assert max(steps) > 1
    assert all(r <= math.ceil(w / tb.LAG) + 1
               for r, w in zip(runner.tree_reads, steps))
    if serial:
        assert runner.stepper.step_name == "split"
    assert hits == []


def _exact_order_host(keyed, kl, kr, ready, im, n, L, kmax):
    """The serial priority rule on the host (make_sim, JAX grow_wave.py:
    1151-1180): the leaves it applies, in order."""
    gain = keyed.astype(np.float64).copy()
    rdy = ready.copy()
    app, mono_done = [], False
    while True:
        p = int(np.argmax(gain))          # ties to the lower leaf id
        if not (gain[p] > 0.0 and rdy[p] and n < L and len(app) < kmax
                and not (im[p] and mono_done)):
            return app
        gain[p], gain[n] = kl[p], kr[p]
        rdy[p] = False
        n += 1
        app.append(p)
        mono_done |= bool(im[p])


@pytest.mark.parametrize("seed", range(4))
def test_device_exact_order_equals_the_host_rule(seed):
    rng = np.random.RandomState(seed)
    applied = 0
    for _ in range(60):
        L = int(rng.choice([8, 31, 64]))
        nl = int(rng.randint(1, L))
        kmax = min(int(rng.choice([4, 16, L - 1])), L - 1)
        # a few distinct values, so that keys tie, children with parents
        vals = np.array([-np.inf, -1.0, 0.0, 0.5, 1.0, 2.0, 3.0],
                        np.float32)
        keyed = np.full(L, -np.inf, np.float32)
        keyed[:nl] = rng.choice(vals, nl)
        kl = rng.choice(vals, L).astype(np.float32)
        kr = rng.choice(vals, L).astype(np.float32)
        ready = np.zeros(L, bool)
        ready[:nl] = rng.rand(nl) < 0.8
        im = (rng.rand(L) < 0.3) if rng.rand() < 0.5 else None
        want = _exact_order_host(keyed, kl, kr, ready,
                                 np.zeros(L, bool) if im is None else im,
                                 nl, L, kmax)
        leaves, sel = tw.exact_order(
            torch.from_numpy(keyed), torch.from_numpy(kl),
            torch.from_numpy(kr), torch.from_numpy(ready),
            None if im is None else torch.from_numpy(im),
            torch.tensor(nl), L, kmax)
        assert leaves[sel].tolist() == want
        applied += len(want)
    assert applied > 60


JAX_CASES = {
    "intermediate": dict(INTER),
    "wave_exact": dict(tpu_grower="wave_exact"),
    "forced": dict(forcedsplits_filename=FORCED),
    "masked": dict(tpu_grower="masked"),
    "compact": dict(tpu_grower="compact"),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_regime_batched_trees_match_jax_per_iteration(case, tmp_path):
    X, y, _ = _dense(3000)
    params = {k: v for k, v in BASE.items()
              if k not in ("device_type", "binning_impl")}
    params.update(_params(JAX_CASES[case], tmp_path))
    bj = lj.train({**params, "batched_train": False},
                  lj.Dataset(X, label=y), num_boost_round=5)
    bt = lt.train({**BASE, **params, "batched_train": True},
                  lt.Dataset(X, label=y), 5)
    assert bt._gbdt.batched_veto == "" and bt._gbdt._runners
    _assert_same_trees(bt.model_to_string(), bj.model_to_string())
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=0,
                               atol=1e-5)


_JAX_NAN = {}


def _num_leaves(text):
    return [int(ln.split("=")[1]) for ln in text.splitlines()
            if ln.startswith("num_leaves=")]


@pytest.mark.parametrize("objective,batched", [
    ("huber", True), ("huber", False), ("regression_l1", False),
    ("mape", False)])
def test_nan_labels_train_as_in_jax(objective, batched):
    """C5: the labels X @ w are NaN where column 0 is; the gradients are
    NaN there as jnp.sign keeps them, so both packages grow the same
    (1-leaf) trees and predict the same. The per-iteration loop stops at
    the first stump; a batched chunk runs to its end (its stop check is
    amortized, as the JAX package's), adding stumps that predict 0."""
    X, _, w = _dense(3000)
    y = (X @ w).astype(np.float32)
    assert int(np.isnan(y).sum()) == 295
    params = {k: v for k, v in BASE.items()
              if k not in ("device_type", "binning_impl")}
    params.update(objective=objective)
    if objective not in _JAX_NAN:
        bj = lj.train({**params, "batched_train": False},
                      lj.Dataset(X, label=y), num_boost_round=3)
        _JAX_NAN[objective] = (bj.model_to_string(), bj.predict(X))
    text_j, pred_j = _JAX_NAN[objective]
    bt = lt.train({**BASE, **params, "batched_train": batched},
                  lt.Dataset(X, label=y), 3)
    assert (bt._gbdt.batched_veto == "") == batched
    nt, nj = _num_leaves(bt.model_to_string()), _num_leaves(text_j)
    assert nt[:len(nj)] == nj and set(nt[len(nj):]) <= {1}
    assert len(nt) == (3 if batched else len(nj))
    np.testing.assert_allclose(bt.predict(X), pred_j, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stratified", [True, False])
def test_cv_bins_under_its_params(stratified):
    """C6: a Dataset built with no params takes cv's device_type (the CPU
    here, where the default CUDA device is missing) and trains the JAX
    package's folds."""
    X, y, _ = _dense(1200)
    params = dict(objective="binary", num_leaves=4, max_bin=63,
                  learning_rate=0.1, min_data_in_leaf=20, verbose=-1,
                  metric="binary_logloss")
    rt = lt.cv({**params, "device_type": "cpu", "binning_impl": "host"},
               lt.Dataset(X, label=y, free_raw_data=False), 2, nfold=2,
               stratified=stratified, seed=2)
    rj = lj.cv(params, lj.Dataset(X, label=y, free_raw_data=False), 2,
               nfold=2, stratified=stratified, seed=2)
    assert sorted(rt) == sorted(rj) and len(rt) == 2
    for k in rj:
        assert len(rt[k]) == 2
        np.testing.assert_allclose(rt[k], rj[k], rtol=0, atol=1e-6,
                                   err_msg=k)
