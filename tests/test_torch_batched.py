"""Batched training in the port (lightgbm_tpu_torch/models/batched.py,
ops/grow_batched.py) on the CPU, where the runner calls the steps its CUDA
graphs would replay.

The JAX package's contract holds: a batched model is md5-equal to the
per-iteration model of the same configuration (tests/test_batched.py),
here on the `mega` and `apply` routes with a tail chunk, categorical and
EFB storages, bagging, GOSS through its warm-up, quantized gradients
with and without leaf renewal, monotone `basic` with interaction sets,
bynode / extra_trees, L2 regression, and under early stopping, whose
surplus trees are cut. The fixed-shape tree equals the bucketed grower's
array by array, and its steps read nothing from the host (a dispatch
guard). The device metrics agree with the host metrics and the JAX
package's device metrics, `mask_for_iter` with the eager masks and JAX's,
and the threefry's device keys with its host keys. The per-iteration
path runs for every JAX veto, named in `batched_veto`; the serial growers
masked and compact, which trained per iteration until A12(b)'s last item,
batch; the drain stops on every exit. The fused routes, monotone
intermediate, wave_exact, forced splits and the serial growers batch:
tests/test_torch_batched_regimes.py. `tests/conftest.py` turns
batched training off suite-wide; each test here turns it on again.
"""

import hashlib
import math
import threading
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.metrics import create_metric as j_metric
from lightgbm_tpu.models.sample_strategy import \
    create_sample_strategy as j_strategy
from lightgbm_tpu.objectives import create_objective as j_objective
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.metrics import create_metric as t_metric
from lightgbm_tpu_torch.models import batched as tb
from lightgbm_tpu_torch.models.sample_strategy import \
    create_sample_strategy as t_strategy
from lightgbm_tpu_torch.objectives import create_objective as t_objective
from lightgbm_tpu_torch.ops.grow_batched import grow_tree_wave_batched
from lightgbm_tpu_torch.ops.grow_wave import grow_tree_wave
from lightgbm_tpu_torch.utils import random as tr
from lightgbm_tpu_torch.utils.synthetic import (CRITEO_CAT_COLUMNS,
                                                criteo_like)
from test_torch_train import _assert_same_trees

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

BASE = dict(objective="binary", num_leaves=15, max_bin=63,
            learning_rate=0.1, min_data_in_leaf=20, verbose=-1,
            device_type="cpu", binning_impl="host")
N = 2000


@pytest.fixture(autouse=True)
def batched_on(monkeypatch):
    monkeypatch.setenv("LIGHTGBM_TPU_DISABLE_BATCHED", "")


def _dense(n=N, F=8, seed=11):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    w = rng.normal(size=F) * 2
    y = (X @ w + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    X[rng.rand(n) < 0.1, 0] = np.nan
    X[rng.rand(n) < 0.3, 1] = 0.0
    return X, y, w


def _efb(n=N):
    rng = np.random.RandomState(3)
    X = np.zeros((n, 14), np.float32)
    X[np.arange(n), rng.randint(0, 10, n)] = 1.0
    X[:, 10:] = rng.normal(size=(n, 4))
    y = ((X[:, 2] + X[:, 5] + X[:, 10]) > 0.5).astype(np.float32)
    return X, y


def _md5(b):
    return hashlib.md5(b.model_to_string().encode()).hexdigest()


def _train(params, X, y, rounds, batched, cat="auto", **kw):
    ds = lt.Dataset(X, label=y, categorical_feature=cat)
    return lt.train({**BASE, **params, "batched_train": batched}, ds,
                    rounds, **kw)


CASES = {
    "mega_tail": (dict(batched_chunk_size=8), "dense", 11),
    "apply_criteo": (dict(max_bin=255), "criteo", 3),
    "efb": ({}, "efb", 4),
    "bagging": (dict(bagging_fraction=0.7, bagging_freq=2), "dense", 5),
    "goss": (dict(data_sample_strategy="goss", learning_rate=0.15),
             "dense", 8),
    "quantized": (dict(use_quantized_grad=True, num_grad_quant_bins=4),
                  "dense", 4),
    "quantized_renew": (dict(use_quantized_grad=True, num_grad_quant_bins=4,
                             quant_train_renew_leaf=True), "dense", 4),
    "monotone_sets": (dict(monotone_constraints=[1, -1, 0, 0, 1, 0, 0, 0],
                           monotone_penalty=0.5,
                           interaction_constraints=[[0, 1, 2], [3, 4, 5]]),
                      "dense", 4),
    "bynode_xt": (dict(feature_fraction_bynode=0.5, extra_trees=True,
                       feature_fraction=0.8), "dense", 4),
    "regression_l2": (dict(objective="regression", metric="l2"), "reg", 4),
}


def _case_data(kind):
    if kind == "criteo":
        X, y = criteo_like(1 << 11)
        return X, y, list(CRITEO_CAT_COLUMNS)
    if kind == "efb":
        X, y = _efb()
        return X, y, "auto"
    X, y, w = _dense()
    if kind == "reg":
        y = (np.nan_to_num(X) @ w).astype(np.float32)
    return X, y, "auto"


@pytest.mark.parametrize("case", list(CASES))
def test_batched_model_md5_equals_per_iteration(case):
    params, kind, rounds = CASES[case]
    X, y, cat = _case_data(kind)
    bi = _train(params, X, y, rounds, False, cat)
    bb = _train(params, X, y, rounds, True, cat)
    g = bb._gbdt
    assert g.batched_veto == "" and len(g._runners) == 1
    assert g.grow_route == ("apply" if kind in ("criteo", "efb")
                            else "mega")
    if kind == "efb":
        assert g.grow_cfg.bundled
    assert bb.num_trees() == bi.num_trees() == rounds
    assert _md5(bb) == _md5(bi)
    np.testing.assert_array_equal(g.scores.numpy(),
                                  bi._gbdt.scores.numpy())
    # one blocking read a group of LAG waves: ceil(waves / 4) a tree (one
    # for a stump), within the bound of ceil(waves / 4) + 1
    runner = next(iter(g._runners.values()))
    waves = [t.num_waves for t in g.models]
    assert runner.tree_reads == [max(1, math.ceil(w / tb.LAG))
                                 for w in waves]
    assert all(r <= math.ceil(w / tb.LAG) + 1
               for r, w in zip(runner.tree_reads, waves))
    assert runner.tree_waves == [tb.LAG * r for r in runner.tree_reads]


def test_early_stopping_truncates_to_the_live_stop():
    X, y, w = _dense()
    rng = np.random.RandomState(5)
    Xv = rng.normal(size=(600, 8)).astype(np.float32)
    yv = (Xv @ w + rng.normal(scale=2.0, size=600) > 0).astype(np.float32)
    out = []
    for batched in (False, True):
        ds = lt.Dataset(X, label=y)
        rec = {}
        b = lt.train({**BASE, "learning_rate": 0.6, "num_leaves": 31,
                      "metric": ["binary_logloss", "auc"],
                      "batched_train": batched}, ds, 40,
                     valid_sets=[lt.Dataset(Xv, label=yv, reference=ds)],
                     callbacks=[lt.early_stopping(5, verbose=False),
                                lt.record_evaluation(rec)])
        out.append((b, rec))
    (bi, ri), (bb, rb) = out
    assert 0 < bi.best_iteration < 35
    assert bb.best_iteration == bi.best_iteration
    assert bb.num_trees() == bi.num_trees()
    assert _md5(bb) == _md5(bi)
    assert bb._gbdt.batched_veto == ""
    for m in ri["valid_0"]:
        np.testing.assert_allclose(rb["valid_0"][m], ri["valid_0"][m],
                                   rtol=1e-5)


def test_continued_training_batched_equals_per_iteration():
    """init_model's trees first, then batched chunks: the model of the
    per-iteration continuation."""
    X, y, _ = _dense()
    base = _train({}, X, y, 3, False)
    out = []
    for batched in (False, True):
        b = lt.train({**BASE, "batched_train": batched},
                     lt.Dataset(X, label=y), 5, init_model=base)
        out.append(b)
    assert out[1]._gbdt.batched_veto == "" and out[1]._gbdt._runners
    assert out[1].num_trees() == out[0].num_trees() == 8
    assert _md5(out[1]) == _md5(out[0])


def test_update_batch_equals_update_calls():
    X, y, _ = _dense()
    bi = lt.Booster({**BASE, "batched_train": False}, lt.Dataset(X, label=y))
    for _ in range(7):
        bi.update()
    bb = lt.Booster(BASE, lt.Dataset(X, label=y))
    bb.update_batch(7, chunk=3)
    assert bb._gbdt.batched_veto == ""
    assert bb.current_iteration == 7
    assert _md5(bb) == _md5(bi)


def test_fixed_shape_tree_equals_bucketed_tree():
    """The fixed-shape step grows the per-iteration grower's tree from the
    same gradients, every array bitwise (float and quantized gradients,
    categorical storage, the row-wise layout)."""
    X, y, _ = _dense()
    Xc, yc = criteo_like(1 << 11)
    for params, data, cat in (
            ({"num_leaves": 31}, (X, y), "auto"),
            ({"use_quantized_grad": True, "quant_train_renew_leaf": True},
             (X, y), "auto"),
            ({"max_bin": 255}, (Xc, yc), list(CRITEO_CAT_COLUMNS)),
            ({"max_bin": 255, "force_row_wise": True}, (Xc, yc),
             list(CRITEO_CAT_COLUMNS))):
        g = lt.Booster({**BASE, **params},
                       lt.Dataset(*data, categorical_feature=cat))._gbdt
        gg, hh = g._gradients()
        bag = torch.ones(g.num_data)
        t1, l1 = grow_tree_wave(g.X_t, gg[0], hh[0], bag, g.meta, g.grow_cfg,
                                hist_plan=g.hist_plan, rng_seed=3)
        t2, l2, reads, ran = grow_tree_wave_batched(
            g.X_t, gg[0], hh[0], bag, g.meta, g.grow_cfg,
            hist_plan=g.hist_plan, rng_seed=3)
        assert torch.equal(l1, l2)
        assert int(t2.num_leaves) == t1.num_leaves > 1
        assert int(t2.num_waves) == t1.num_waves
        assert reads == -(-t1.num_waves // 4) and ran == 4 * reads
        for f in t1._fields:
            a = getattr(t1, f)
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, getattr(t2, f)), f


class _HostReads(TorchDispatchMode):
    """Records the operations that read a tensor to the host or copy host
    data in (on a CUDA tensor: a synchronizing read, or a copy that a
    captured graph cannot hold)."""
    BAD = ("aten._local_scalar_dense", "aten.nonzero", "aten.lift_fresh",
           "aten.masked_select", "aten.unique", "aten._unique2")

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith(self.BAD):
            self.hits.append(name)
        if name.startswith("aten.index") and any(
                isinstance(a, (list, tuple)) and any(
                    isinstance(t, torch.Tensor) and t.dtype == torch.bool
                    for t in a) for a in args):
            self.hits.append(name + " (a boolean mask)")
        return func(*args, **(kwargs or {}))


def test_steps_read_nothing_from_the_host(monkeypatch):
    """After each step's first call (which, on the card, runs eagerly
    before its capture) the start, wave (or split) and finish steps
    perform no host read and copy no host data in, on every covered
    regime, the serial growers masked and compact included."""
    hits = []
    seen = set()

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
    X, y, _ = _dense()
    Xv, yv, _ = _dense(400, seed=12)
    for params in (dict(bagging_fraction=0.7, bagging_freq=1,
                        metric=["auc", "binary_logloss"]),
                   dict(data_sample_strategy="goss", learning_rate=0.5),
                   dict(use_quantized_grad=True, quant_train_renew_leaf=True,
                        monotone_constraints=[1, -1, 0, 0, 0, 0, 0, 0],
                        monotone_penalty=0.5, feature_fraction=0.7,
                        interaction_constraints=[[0, 1], [2, 3, 4]]),
                   dict(feature_fraction_bynode=0.5, extra_trees=True),
                   dict(tpu_grower="masked", bagging_fraction=0.7,
                        bagging_freq=1, feature_fraction=0.7),
                   dict(tpu_grower="compact", data_sample_strategy="goss",
                        max_bin=1023)):
        seen.clear()
        ds = lt.Dataset(X, label=y)
        b = lt.train({**BASE, **params}, ds, 3,
                     valid_sets=[lt.Dataset(Xv, label=yv, reference=ds)],
                     callbacks=[lt.record_evaluation({})])
        assert b._gbdt.batched_veto == ""
    Xc, yc = criteo_like(1 << 10)
    for params in ({}, {"force_row_wise": True},
                   {"histogram_impl": "rowwise_packed"},
                   {"tpu_grower": "compact", "force_row_wise": True}):
        seen.clear()
        b = lt.train({**BASE, "max_bin": 255, **params},
                     lt.Dataset(Xc, label=yc,
                                categorical_feature=list(CRITEO_CAT_COLUMNS)),
                     2)
        assert b._gbdt.batched_veto == "" and b._gbdt.grow_route == \
            params.get("tpu_grower", "apply")
    assert hits == []


METRICS = ["l2", "rmse", "l1", "quantile", "binary_logloss",
           "binary_error", "auc", "multi_logloss", "multi_error",
           "multi_error@2"]


def _metric_inputs(name, rng, n=3000):
    if name.startswith("multi"):
        K = 4
        cfg = dict(objective="multiclass", num_class=K)
        if name == "multi_error@2":
            cfg["multi_error_top_k"] = 2
        score = rng.normal(size=(K, n)).astype(np.float32)
        label = rng.randint(0, K, n).astype(np.float32)
    elif name in ("binary_logloss", "binary_error", "auc"):
        cfg = dict(objective="binary", sigmoid=1.3)
        score = rng.normal(size=n).astype(np.float32)
        score[:40] = score[40:80]          # ties for the AUC's groups
        label = (rng.rand(n) < 0.4).astype(np.float32)
    else:
        cfg = dict(objective="regression", alpha=0.7)
        score = rng.normal(size=n).astype(np.float32)
        label = rng.normal(size=n).astype(np.float32)
    return cfg, score, label


@pytest.mark.parametrize("name", METRICS)
@pytest.mark.parametrize("weighted", [False, True])
def test_device_metrics_equal_host_and_jax(name, weighted):
    rng = np.random.RandomState(METRICS.index(name) + 7 * weighted)
    cfg, score, label = _metric_inputs(name, rng)
    n = label.shape[0]
    weight = (rng.rand(n) + 0.5).astype(np.float32) if weighted else None
    mname = name.split("@")[0]
    md = SimpleNamespace(label=label, weight=weight, query_boundaries=None)
    tcfg, jcfg = TConfig(**cfg), JConfig(**cfg)
    mt, mj = t_metric(mname, tcfg), j_metric(mname, jcfg)
    ot, oj = t_objective(tcfg), j_objective(jcfg)
    for m in (mt, mj):
        m.init(md, n)
    host = mt.eval(score if score.ndim == 2 else score, ot)[0][1]
    ft, fj = mt.device_eval_fn(ot), mj.device_eval_fn(oj)
    assert ft is not None and fj is not None
    w = np.ones(n, np.float32) if weight is None else weight
    sw = float(np.sum(w, dtype=np.float64)) if weighted else float(n)
    s2 = score if score.ndim == 2 else score[None]
    vt = float(ft(torch.from_numpy(s2), torch.from_numpy(label),
                  torch.from_numpy(w), torch.tensor(sw)))
    vj = float(fj(jnp.asarray(s2), jnp.asarray(label), jnp.asarray(w),
                  jnp.float32(sw)))
    assert vt == pytest.approx(host, rel=1e-5, abs=1e-6)
    assert vt == pytest.approx(vj, rel=1e-6, abs=1e-7)


def test_metrics_without_device_form_keep_the_per_iteration_path():
    cfg = TConfig(objective="binary")
    for name in ("ndcg", "map", "average_precision", "cross_entropy",
                 "kldiv", "auc_mu", "r2", "huber"):
        assert t_metric(name, cfg).device_eval_fn(t_objective(cfg)) is None
    X, y, _ = _dense()
    ds = lt.Dataset(X, label=y)
    b = lt.train({**BASE, "metric": ["auc", "average_precision"]}, ds, 2,
                 valid_sets=[lt.Dataset(X[:300], label=y[:300],
                                        reference=ds)])
    assert b._gbdt.batched_veto == "a valid metric without a device form"
    assert not b._gbdt._runners


@pytest.mark.parametrize("kw", [
    dict(bagging_freq=1, bagging_fraction=0.7),
    dict(bagging_freq=3, bagging_fraction=0.5, bagging_seed=-3),
    dict(data_sample_strategy="goss", learning_rate=0.5),
    dict(data_sample_strategy="goss", learning_rate=0.25, top_rate=0.3,
         other_rate=0.2)], ids=["bag_f1", "bag_f3", "goss", "goss_rates"])
def test_mask_for_iter_bitwise_sample_and_jax(kw):
    n = 3000
    rng = np.random.RandomState(4)
    md = SimpleNamespace(label=(rng.rand(n) < 0.3).astype(np.float32),
                         query_boundaries=None)
    st = t_strategy(TConfig(**kw), n, md, torch.device("cpu"))
    sj = j_strategy(JConfig(**kw), n, md)
    assert st.supports_scan and sj.supports_scan
    assert st.needs_grad == sj.needs_grad
    for it in (0, 1, 2, 3, 5, 7):
        g = rng.normal(size=n).astype(np.float32)
        h = rng.rand(n).astype(np.float32)
        gt, ht = torch.from_numpy(g), torch.from_numpy(h)
        eager = st.sample(it, gt, ht)
        dev = st.mask_for_iter(torch.tensor(it, dtype=torch.int64), gt, ht)
        jm = np.asarray(sj.mask_for_iter(it, jnp.asarray(g),
                                         jnp.asarray(h)))
        np.testing.assert_array_equal(dev.numpy(), eager.numpy())
        np.testing.assert_array_equal(dev.numpy(), jm)


def test_balanced_and_by_query_bagging_stay_off_the_scan():
    md = SimpleNamespace(label=np.r_[np.ones(50), np.zeros(50)],
                         query_boundaries=np.arange(0, 101, 10))
    for kw in (dict(bagging_freq=1, pos_bagging_fraction=0.5),
               dict(bagging_freq=1, bagging_fraction=0.5,
                    bagging_by_query=True)):
        st = t_strategy(TConfig(**kw), 100, md, torch.device("cpu"))
        assert not st.supports_scan


def test_device_keys_equal_host_keys():
    for seed in (0, 7, 2 ** 31 - 1, -5):
        k = tr.PRNGKey(seed)
        dk = tr.PRNGKey(torch.tensor(seed))
        for data in (0, 3, 2 ** 20):
            hk = tr.fold_in(k, data)
            for d in (tr.fold_in(dk, data),
                      tr.fold_in(dk, torch.tensor(data)),
                      tr.fold_in(k, torch.tensor(data))):
                assert [int(d.k1), int(d.k2)] == hk.tolist()
            np.testing.assert_array_equal(
                tr.uniform(tr.fold_in(dk, data), (1000,)).numpy(),
                tr.uniform(hk, (1000,)).numpy())
        for a, b in zip(tr.split(dk), tr.split(k)):
            assert [int(a.k1), int(a.k2)] == b.tolist()


def _veto(params, data="dense", rounds=2, **kw):
    if data == "criteo":
        X, y = criteo_like(1 << 10)
        cat = list(CRITEO_CAT_COLUMNS)
    else:
        X, y, _ = _dense(800)
        cat = "auto"
    b = _train(params, X, y, rounds, True, cat, **kw)
    return b._gbdt


JAX_VETOES = {
    "multiclass": (dict(objective="multiclass", num_class=3), "multiclass"),
    "linear": (dict(linear_tree=True), "linear_tree"),
    "l1": (dict(objective="regression_l1"), "leaf renewal"),
    "cegb": (dict(cegb_penalty_split=0.1), "CEGB"),
    "dart": (dict(boosting="dart"), "boosting=dart"),
    "rf": (dict(boosting="rf", bagging_fraction=0.8, bagging_freq=1),
           "boosting=rf"),
    "disabled": (dict(batched_train=False), "batched_train=false"),
}


@pytest.mark.parametrize("case", list(JAX_VETOES))
def test_jax_vetoes_train_per_iteration(case):
    params, why = JAX_VETOES[case]
    if case == "multiclass":
        X, y, _ = _dense(800)
        y = (np.nan_to_num(X[:, 2]) > 0).astype(np.float32) \
            + (np.nan_to_num(X[:, 3]) > 0.5)
        g = lt.train({**BASE, **params}, lt.Dataset(X, label=y), 2)._gbdt
    elif case == "disabled":
        X, y, _ = _dense(800)
        g = lt.train({**BASE, **params}, lt.Dataset(X, label=y), 2)._gbdt
    else:
        g = _veto(params)
    assert g.batched_veto.startswith(why) and "A12(b)" not in \
        g.batched_veto
    assert not g._runners


def test_rank_xendcg_and_the_env_escape_train_per_iteration(monkeypatch):
    X, y, _ = _dense(800)
    ds = lt.Dataset(X, label=(y * 2).astype(np.float32),
                    group=[100] * 8)
    g = lt.train({**BASE, "objective": "rank_xendcg", "metric": "ndcg"},
                 ds, 2)._gbdt
    assert g.batched_veto == "an objective on the host"
    monkeypatch.setenv("LIGHTGBM_TPU_DISABLE_BATCHED", "1")
    assert _veto({}).batched_veto == "LIGHTGBM_TPU_DISABLE_BATCHED"


A12B_VETOES = {
    "masked": (dict(tpu_grower="masked"), "dense", "split"),
    "compact": (dict(tpu_grower="compact"), "dense", "split"),
}


@pytest.mark.parametrize("case", list(A12B_VETOES))
def test_a12b_regimes_name_a12b(case):
    """The serial growers waited for A12(b) and named it in batched_veto;
    they batch now, through the split step of ops/grow_batched.py's
    SerialStepper (md5 parity: tests/test_torch_batched_regimes.py)."""
    params, data, step = A12B_VETOES[case]
    g = _veto(params, data)
    assert g.batched_veto == "" and g.grower == case
    runner = next(iter(g._runners.values()))
    assert runner.stepper.step_name == step
    assert runner.stepper.compact == (case == "compact")


def test_engine_refusals_train_per_iteration():
    X, y, _ = _dense(800)

    def fobj(score, ds):
        p = 1.0 / (1.0 + np.exp(-score))
        return p - y, p * (1.0 - p)

    def feval(score, ds):
        return "zero", 0.0, False

    def plain_cb(env):
        pass
    ds = lt.Dataset(X, label=y)
    for kw in (dict(fobj=fobj), dict(feval=feval,
                                     valid_sets=[lt.Dataset(
                                         X[:100], label=y[:100],
                                         reference=ds)]),
               dict(callbacks=[lt.reset_parameter(
                   learning_rate=[0.1, 0.05])]),
               dict(callbacks=[plain_cb]), dict(valid_sets=[ds])):
        b = lt.train({**BASE, "objective": "binary"}, ds, 2, **kw)
        assert not b._gbdt._runners, kw


def test_a_resample_inside_a_chunk_is_refused_and_cut():
    """Class-stratified bagging draws on the host: a chunk may not cross
    its resample, and the engine cuts chunks at its period."""
    X, y, _ = _dense()
    params = dict(bagging_freq=3, pos_bagging_fraction=0.6,
                  neg_bagging_fraction=0.9)
    bi = _train(params, X, y, 7, False)
    bb = _train(params, X, y, 7, True)
    g = bb._gbdt
    assert g._batched_sampling_mode() == "host" and g.batched_veto == ""
    assert _md5(bb) == _md5(bi)
    g.iter = 1
    assert not g.can_batch_iters(3)
    assert g.batched_veto == "a resample inside the chunk"
    assert g.can_batch_iters(2)


def test_drain_stops_on_every_exit():
    X, y, _ = _dense()

    def boom(env):
        if env.iteration == 5:
            raise RuntimeError("callback failed")
    boom.batched_replay = True
    with pytest.raises(RuntimeError, match="callback failed"):
        _train({"batched_chunk_size": 4}, X, y, 12, True,
               callbacks=[boom])
    assert not [t for t in threading.enumerate()
                if t.name == "gbdt-tree-drain" and t.is_alive()]
    b = _train({"batched_chunk_size": 4}, X, y, 9, True)
    assert b._gbdt._drain is None and b.num_trees() == 9
    assert len(b._gbdt.drain_lags_ms) == 3


def test_batched_trees_match_jax_per_iteration():
    """The JAX package's batched path is md5-equal to its per-iteration
    path by its contract (tests/test_batched.py, slow there); the port's
    batched trees are held to JAX's per-iteration trees at the parity
    tolerance of tests/test_torch_train.py."""
    X, y, _ = _dense(3000)
    params = {k: v for k, v in BASE.items()
              if k not in ("device_type", "binning_impl")}
    bj = lj.train({**params, "batched_train": False},
                  lj.Dataset(X, label=y), num_boost_round=5)
    bt = _train({}, X, y, 5, True)
    assert bt._gbdt.batched_veto == "" and bt._gbdt._runners
    _assert_same_trees(bt.model_to_string(), bj.model_to_string())
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=0,
                               atol=1e-5)
