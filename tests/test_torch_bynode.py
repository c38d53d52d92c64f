"""feature_fraction_bynode and extra_trees in the port against the JAX
package, on the CPU.

The per-node draws are bitwise jax.random's: `node_masks` and `xt_bins`
(lightgbm_tpu/ops/grow_wave.py:657-682) under the keys the JAX grower
uses, PRNGKey(seed + 0x5EED) and PRNGKey(seed * 31 + extra_seed) in int32
arithmetic, folded with 0 at the root and with the wave count + 1 in the
waves; a row's draw does not depend on how many rows the draw has. The
search keeps only the drawn threshold of each feature (split.py
rand_bins). Trainings of 3 rounds on the megakernel and the apply route
grow the JAX package's trees, with leaf values within 1e-5; under
histogram_impl=fused both regimes veto the fused kernels, as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops.grow_wave import node_masks, xt_bins
from lightgbm_tpu_torch.utils.random import PRNGKey, fold_in

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

SEEDS = [0, 7, -5, 2 ** 31 - 100]


def _jax_uniform(seed_expr, step, n, F):
    key = jax.random.fold_in(jax.random.PRNGKey(seed_expr), step)
    return jax.random.uniform(key, (n, F))


@pytest.mark.parametrize("step", [0, 1, 6])
@pytest.mark.parametrize("seed", SEEDS)
def test_node_masks_bitwise_jax(seed, step):
    for F, frac, n in ((8, 0.5, 1), (28, 0.3, 256), (136, 0.9, 64)):
        u = _jax_uniform(jnp.int32(seed) + 0x5EED, step, n, F)
        k = max(1, int(F * frac))
        want = np.asarray(u <= -jax.lax.top_k(-u, k)[0][:, -1:])
        got = node_masks(fold_in(PRNGKey(seed + 0x5EED), step), n, F,
                         frac, torch.device("cpu"))
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got.sum(dim=1) == k).all()


@pytest.mark.parametrize("step", [0, 1, 6])
@pytest.mark.parametrize("seed", SEEDS)
def test_xt_bins_bitwise_jax(seed, step):
    extra_seed = 6
    nb = np.array([2, 3, 4, 17, 64, 255, 256, 9] * 5, np.int32)
    F, n = len(nb), 128
    u = _jax_uniform(jnp.int32(seed) * 31 + extra_seed, step, n, F)
    hi = jnp.maximum(jnp.asarray(nb) - 2, 1)
    want = np.asarray(jnp.minimum((u * hi[None, :]).astype(jnp.int32),
                                  hi - 1))
    got = xt_bins(fold_in(PRNGKey(seed * 31 + extra_seed), step), n,
                  torch.from_numpy(nb))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_a_rows_draw_does_not_depend_on_the_draws_size():
    """Element [i, j] hashes counter i * F + j: the first rows of a wave's
    [2 KMAX, F] draw are the draw of fewer rows (so the padded batch
    width cannot change a row)."""
    key = fold_in(PRNGKey(3 + 0x5EED), 4)
    cpu = torch.device("cpu")
    big = node_masks(key, 256, 28, 0.5, cpu)
    for n in (1, 2, 33, 128):
        assert torch.equal(node_masks(key, n, 28, 0.5, cpu), big[:n])
    bins = torch.full((28,), 64, dtype=torch.int32)
    assert torch.equal(xt_bins(key, 7, bins), xt_bins(key, 256, bins)[:7])


def test_rand_bins_search_matches_jax():
    """find_best_split with one drawn threshold per feature, batched in the
    port and one histogram at a time in JAX."""
    rng = np.random.RandomState(2)
    F, B, n = 6, 32, 4
    g = rng.normal(size=(n, F, B)).astype(np.float32)
    h = rng.uniform(0.5, 2.0, size=(n, F, B)).astype(np.float32)
    g[:, :, 20:] = h[:, :, 20:] = 0.0
    cnt = h * 10.0
    hist = np.stack([g, h, cnt], axis=1)
    sg, sh = g[:, 0].sum(-1), h[:, 0].sum(-1)
    sc = cnt[:, 0].sum(-1)
    nb = np.full(F, 20, np.int32)
    rb = rng.randint(0, 18, size=(n, F)).astype(np.int32)
    hp = dict(min_data_in_leaf=1.0, min_sum_hessian_in_leaf=1e-3,
              lambda_l1=0.0, lambda_l2=0.1, max_delta_step=0.0,
              min_gain_to_split=0.0, path_smooth=0.0)
    zeros = np.zeros(F, np.int32)
    mt = tsplit.FeatureMeta(
        num_bins=torch.from_numpy(nb), missing_type=torch.from_numpy(zeros),
        default_bin=torch.from_numpy(zeros),
        is_categorical=torch.zeros(F, dtype=torch.bool))
    mj = jsplit.FeatureMeta(
        num_bins=jnp.asarray(nb), missing_type=jnp.asarray(zeros),
        default_bin=jnp.asarray(zeros), is_categorical=jnp.zeros(F, bool))
    got = tsplit.find_best_split(
        torch.from_numpy(hist), torch.from_numpy(sg), torch.from_numpy(sh),
        torch.from_numpy(sc), torch.zeros(n), mt,
        tsplit.SplitHyperParams(**hp), rand_bins=torch.from_numpy(rb))
    for i in range(n):
        want = jsplit.find_best_split(
            jnp.asarray(hist[i]), sg[i], sh[i], sc[i], jnp.float32(0.0), mj,
            jsplit.SplitHyperParams(**hp), rand_bins=jnp.asarray(rb[i]))
        assert int(got.feature[i]) == int(want.feature)
        assert int(got.threshold[i]) == int(want.threshold) \
            == rb[i, int(want.feature)]
        np.testing.assert_allclose(float(got.gain[i]), float(want.gain),
                                   rtol=1e-5)


def _data(F, seed):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(1500, F)).astype(np.float32)
    w = rng.normal(size=F) * 2
    y = (X @ w + rng.normal(scale=0.5, size=1500) > 0).astype(np.float32)
    return X, y


@pytest.mark.parametrize("over", [{"feature_fraction_bynode": 0.5},
                                  {"extra_trees": True}])
@pytest.mark.parametrize("F,route", [(8, "mega"), (34, "apply")])
def test_training_matches_jax(over, F, route):
    X, y = _data(F, F)
    p = dict(objective="binary", num_leaves=7, max_bin=63, verbose=-1,
             seed=3, **over)
    bj = lj.train(p, lj.Dataset(X, label=y), 3)
    bt = lt.train({**p, "device_type": "cpu"}, lt.Dataset(X, label=y), 3)
    assert bt._gbdt.grow_route == route
    for a, b in zip(bt._gbdt.models, bj._gbdt.models):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.threshold_in_bin, b.threshold_in_bin)
        np.testing.assert_array_equal(a.left_child, b.left_child)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=0,
                                   atol=1e-5)
    assert len(bt._gbdt.models) == len(bj._gbdt.models) == 3
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), atol=1e-5)
    # the regime changed the trees: no draw keeps every feature and
    # threshold
    plain = lt.train({**p, "feature_fraction_bynode": 1.0,
                      "extra_trees": False, "device_type": "cpu"},
                     lt.Dataset(X, label=y), 1)
    assert not np.array_equal(plain._gbdt.models[0].threshold_in_bin,
                              bt._gbdt.models[0].threshold_in_bin)


@pytest.mark.parametrize("over,reason", [
    ({"feature_fraction_bynode": 0.5}, "feature_fraction_bynode"),
    ({"extra_trees": True}, "extra_trees")])
@pytest.mark.parametrize("F,route", [(8, "mega"), (34, "apply")])
def test_fused_is_vetoed(over, reason, F, route):
    X, y = _data(F, 1)
    p = dict(objective="binary", num_leaves=15, max_bin=63, verbose=-1,
             histogram_impl="fused", device_type="cpu", **over)
    bst = lt.Booster(p, lt.Dataset(X, label=y))
    assert bst._gbdt.fused_veto_reasons == [reason]
    assert bst._gbdt.grow_route == route
