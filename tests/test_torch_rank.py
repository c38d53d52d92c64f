"""Ranking in the port against the JAX package, on the CPU: LambdaRank's
device gradients (rtol 1e-5: f32 sums over pair blocks in another
order), RankXENDCG's host gradients and their uniforms (bitwise: the same
float64 NumPy on the same RandomState stream), by-query bagging (bitwise
masks), and 3 rounds of lambdarank (the same trees, values within 1e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu import config as jcfg
from lightgbm_tpu import objectives as jobj
from lightgbm_tpu.data.dataset import Metadata as JMetadata
from lightgbm_tpu.models import sample_strategy as jss
from lightgbm_tpu_torch import config as tcfg
from lightgbm_tpu_torch import objectives as tobj
from lightgbm_tpu_torch.data.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.models import sample_strategy as tss

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

# query sizes that fill every padded-length bucket, with 1- and 2-row
# queries and an all-zero-relevance query
SIZES = np.array([1, 2, 8, 9, 16, 17, 40, 3, 64, 100, 5, 33])


def _queries(seed):
    rng = np.random.RandomState(seed)
    N = int(SIZES.sum())
    label = rng.randint(0, 5, size=N).astype(np.float32)
    label[18:27] = 0.0                       # the 9-row query
    return N, label


def _pair(params, label, weight=None, group=SIZES):
    out = []
    for cfg_mod, obj_mod, md_cls in ((jcfg, jobj, JMetadata),
                                     (tcfg, tobj, TMetadata)):
        cfg = cfg_mod.resolve_params(dict(params))
        md = md_cls(len(label))
        md.set_label(label)
        md.set_weight(weight)
        md.set_group(group)
        obj = obj_mod.create_objective(cfg)
        obj.init(md, len(label))
        out.append(obj)
    return out


@pytest.mark.parametrize("over,weighted,tied", [
    ({}, False, True), ({}, True, True), ({}, False, False),
    ({}, True, False), ({"lambdarank_norm": False}, False, False),
    ({"lambdarank_norm": False}, True, True),
    ({"lambdarank_truncation_level": 3}, False, False),
    ({"sigmoid": 1.7}, True, False)])
def test_lambdarank_gradients_match_jax(over, weighted, tied):
    """At tied scores (iteration 0: the stable sort keeps index order)
    and at scores with some ties; the default truncation level (30) cuts
    the pair block of the 64- and 128-row buckets and not of the
    others, level 3 cuts every bucket's."""
    N, label = _queries(3)
    rng = np.random.RandomState(5)
    weight = (np.repeat(rng.uniform(0.5, 2.0, size=len(SIZES)), SIZES)
              .astype(np.float32) if weighted else None)
    oj, ot = _pair({"objective": "lambdarank", **over}, label, weight)
    assert not ot.runs_on_host and not oj.runs_on_host
    score = (np.zeros(N, np.float32) if tied
             else np.round(rng.normal(size=N), 1).astype(np.float32))
    # jitted: one compile instead of an eager compile of every operation
    gj, hj = jax.jit(oj.get_gradients)(
        jnp.asarray(score), jnp.asarray(label),
        None if weight is None else jnp.asarray(weight))
    gt, ht = ot.get_gradients(torch.from_numpy(score),
                              torch.from_numpy(label),
                              None if weight is None
                              else torch.from_numpy(weight))
    for got, want in ((gt, gj), (ht, hj)):
        want = np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == (N,)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
    assert np.abs(np.asarray(gj)).max() > 0
    assert ot.to_string() == oj.to_string()


def test_xendcg_gradients_and_draws_bitwise():
    """Two successive iterations: each draws its uniforms query by query
    from RandomState(objective_seed), so both calls equal JAX's bit for
    bit."""
    N, label = _queries(4)
    oj, ot = _pair({"objective": "rank_xendcg", "objective_seed": 11},
                   label)
    assert ot.runs_on_host and oj.runs_on_host
    rng = np.random.RandomState(6)
    for _ in range(2):
        s = rng.normal(size=N)
        gj, hj = oj.get_gradients_numpy(s)
        gt, ht = ot.get_gradients_numpy(s)
        np.testing.assert_array_equal(gt, gj)
        np.testing.assert_array_equal(ht, hj)
    assert ot._rng.uniform() == oj._rng.uniform()


def test_bagging_by_query_masks_bitwise():
    N, label = _queries(5)
    params = dict(objective="lambdarank", bagging_by_query=True,
                  bagging_fraction=0.6, bagging_freq=2, bagging_seed=9)
    jm, tm = JMetadata(N), TMetadata(N)
    for md in (jm, tm):
        md.set_label(label)
        md.set_group(SIZES)
    js = jss.create_sample_strategy(jcfg.resolve_params(dict(params)), N, jm)
    ts = tss.create_sample_strategy(tcfg.resolve_params(dict(params)), N, tm,
                                    torch.device("cpu"))
    for it in (0, 1, 2, 5):
        assert ts.resamples_at(it) == js.resamples_at(it)
        want = np.asarray(js.sample(it, None, None))
        got = ts.sample(it).numpy()
        np.testing.assert_array_equal(got, want)
        # whole queries: each query's rows share one flag
        flags = np.split(got, np.cumsum(SIZES)[:-1])
        assert all(len(set(f)) == 1 for f in flags)
        assert sum(f[0] for f in flags) == int(len(SIZES) * 0.6)


@pytest.fixture(scope="module")
def ranked():
    rng = np.random.RandomState(8)
    sizes = rng.randint(5, 60, size=60)
    N = int(sizes.sum())
    X = rng.normal(size=(N, 8)).astype(np.float32)
    rel = X @ rng.normal(size=8)
    y = np.clip(np.round(rel + rng.normal(scale=0.5, size=N) + 1), 0,
                4).astype(np.float32)
    p = dict(objective="lambdarank", num_leaves=7, max_bin=63, verbose=-1,
             min_data_in_leaf=5, eval_at=[1, 3, 10])
    bj = lj.train(p, lj.Dataset(X, label=y, group=sizes), 3)
    bt = lt.train({**p, "device_type": "cpu"},
                  lt.Dataset(X, label=y, group=sizes), 3)
    return X, y, sizes, p, bj, bt


def test_lambdarank_training_matches_jax(ranked):
    X, _, _, _, bj, bt = ranked
    assert len(bt._gbdt.models) == len(bj._gbdt.models) == 3
    for a, b in zip(bt._gbdt.models, bj._gbdt.models):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.threshold_in_bin, b.threshold_in_bin)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=0,
                                   atol=1e-5)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-5)
    got, want = bt.eval_train(), bj.eval_train()
    assert [r[1] for r in got] == ["ndcg@1", "ndcg@3", "ndcg@10"] \
        == [r[1] for r in want]
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want],
                               rtol=1e-9)


def test_xendcg_training_takes_the_host_route(ranked):
    """rank_xendcg: scores pulled once a round, NumPy gradients, uploaded;
    a valid set with its own groups reports ndcg@k, and ndcg@10 rises."""
    X, y, sizes, p, _, _ = ranked
    n_tr = int(sizes[:40].sum())
    train = lt.Dataset(X[:n_tr], label=y[:n_tr], group=sizes[:40])
    valid = train.create_valid(X[n_tr:], label=y[n_tr:], group=sizes[40:])
    rec = {}
    lt.train({**p, "objective": "rank_xendcg", "device_type": "cpu",
              "learning_rate": 0.3}, train, 4, valid_sets=[train, valid],
             valid_names=["tr", "va"],
             callbacks=[lt.record_evaluation(rec)])
    assert sorted(rec["va"]) == ["ndcg@1", "ndcg@10", "ndcg@3"]
    assert rec["tr"]["ndcg@10"][-1] > rec["tr"]["ndcg@10"][0]
