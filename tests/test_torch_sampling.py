"""Bagging and GOSS in the port (lightgbm_tpu_torch/models/
sample_strategy.py) against the JAX package's strategies on the CPU.

The masks are bitwise equal: uniform bagging and GOSS draw from the
port's threefry, pos / neg bagging from the same NumPy draws. Five rounds
of `train` with bagging, and with GOSS at learning_rate 0.5 (a warm-up of
2 iterations, so 3 sampled trees), grow the JAX package's trees: structure
exact (default_left where it matters, as tests/test_torch_train.py),
values within rtol 1e-4 / atol 1e-6 (a few leaf and internal values near
1e-3 differ in the last bits of their f32 sums, 2.4e-7 absolute),
predictions within 1e-5.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.models.sample_strategy import \
    create_sample_strategy as j_create
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.models.sample_strategy import \
    create_sample_strategy as t_create
from test_torch_train import PARAMS, TORCH, _nums, _tree_blocks

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

N = 5000


def _label():
    return (np.random.RandomState(2).rand(N) < 0.3).astype(np.float32)


def _both(**kw):
    md = SimpleNamespace(label=_label(), query_boundaries=None)
    return (j_create(JConfig(**kw), N, md),
            t_create(TConfig(**kw), N, md, torch.device("cpu")))


@pytest.mark.parametrize("kw", [
    dict(bagging_freq=1, bagging_fraction=0.7),
    dict(bagging_freq=2, bagging_fraction=0.5, bagging_seed=-3),
    dict(bagging_freq=1, pos_bagging_fraction=0.5, neg_bagging_fraction=0.8),
    dict(bagging_freq=2, pos_bagging_fraction=0.9, neg_bagging_fraction=0.3,
         bagging_seed=11),
], ids=["uniform_f1", "uniform_f2", "posneg_f1", "posneg_f2"])
def test_bagging_masks_equal_jax(kw):
    sj, st = _both(**kw)
    assert type(st).__name__ == type(sj).__name__ == "BaggingSampleStrategy"
    y = _label()
    for it in range(6):
        assert st.resamples_at(it) == sj.resamples_at(it)
        mj = np.asarray(sj.sample(it, None, None))
        mt = st.sample(it)
        assert mt.dtype == torch.float32
        np.testing.assert_array_equal(mt.numpy(), mj)
        if "bagging_fraction" in kw:
            assert int(mt.sum()) == int(N * kw["bagging_fraction"])
        else:
            pos = y > 0
            assert int(mt.numpy()[pos].sum()) == int(
                pos.sum() * kw["pos_bagging_fraction"])
            assert int(mt.numpy()[~pos].sum()) == int(
                (~pos).sum() * kw["neg_bagging_fraction"])
    # a new mask at each window, the same inside one
    f = kw["bagging_freq"]
    assert not torch.equal(st.sample(0), st.sample(2))
    assert torch.equal(st.sample(2), st.sample(2 + f - 1))


@pytest.mark.parametrize("kw", [
    dict(learning_rate=0.5),
    dict(learning_rate=0.25, top_rate=0.1, other_rate=0.3,
         data_random_seed=9),
])
def test_goss_masks_equal_jax(kw):
    sj, st = _both(data_sample_strategy="goss", **kw)
    assert type(st).__name__ == "GOSSStrategy"
    rng = np.random.RandomState(4)
    warm = int(1.0 / kw["learning_rate"])
    for it in range(warm + 3):
        g = rng.normal(size=N).astype(np.float32)
        h = rng.uniform(0.01, 0.25, size=N).astype(np.float32)
        mj = np.asarray(sj.sample(it, jnp.asarray(g)[None],
                                  jnp.asarray(h)[None]))
        mt = st.sample(it, torch.from_numpy(g), torch.from_numpy(h))
        np.testing.assert_array_equal(mt.numpy(), mj)
        if it < warm:
            assert bool((mt == 1.0).all())
        else:
            top = int(N * st.config.top_rate)
            assert int((mt == 1.0).sum()) == top
            assert 0 < int((mt > 1.0).sum()) < N - top


def _same_trees(text_t, text_j):
    tt, tj = _tree_blocks(text_t), _tree_blocks(text_j)
    assert len(tt) == len(tj) == 5
    for a, b in zip(tt, tj):
        for k in ("num_leaves", "split_feature", "threshold", "left_child",
                  "right_child"):
            assert a[k] == b[k], k
        # bit 1, default_left, is free where a node's missing bin holds no
        # rows (tests/test_torch_train.py); the predictions check the rest
        np.testing.assert_array_equal(_nums(a["decision_type"], int) & ~2,
                                      _nums(b["decision_type"], int) & ~2)
        for k in ("split_gain", "leaf_value", "leaf_weight",
                  "internal_value", "internal_weight"):
            np.testing.assert_allclose(_nums(a[k]), _nums(b[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        for k in ("leaf_count", "internal_count"):
            assert np.abs(_nums(a[k], int) - _nums(b[k], int)).max() <= 1


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(11)
    n, F = 3000, 8
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = (X @ (rng.normal(size=F) * 2) + rng.normal(scale=0.5, size=n)
         > 0).astype(np.float32)
    X[rng.rand(n) < 0.1, 0] = np.nan
    return X, y


@pytest.mark.parametrize("over", [
    dict(bagging_freq=1, bagging_fraction=0.7),
    dict(data_sample_strategy="goss", learning_rate=0.5),
], ids=["bagging", "goss"])
def test_train_matches_jax(data, over):
    X, y = data
    bj = lj.train({**PARAMS, **over}, lj.Dataset(X, label=y),
                  num_boost_round=5)
    bt = lt.train({**PARAMS, **TORCH, **over}, lt.Dataset(X, label=y),
                  num_boost_round=5)
    _same_trees(bt.model_to_string(), bj.model_to_string())
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-5)
    # the last tree grew on the sampled rows only
    root = int(_nums(_tree_blocks(bt.model_to_string())[-1]
                     ["internal_count"], int)[0])
    assert root < len(y)
