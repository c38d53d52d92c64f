"""Best-split search of the port against the JAX package's
ops/split.py:find_best_split on the same histogram.

The selection (feature, threshold bin, default_left) must be equal; gains,
child sums and outputs agree within rtol=1e-5 (the same f32 formulas,
evaluated with another operation order by XLA and by PyTorch). Histograms
hold values on a 1/64 grid, so their cumulative sums are exact in f32 in
any order and the two argmaxes see the same candidates. Random f32 values
are compared on (feature, threshold), and on default_left where the chosen
feature has a missing bin: without one, both directions give the same
split up to rounding and the flag is a coin toss of the last bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lightgbm_tpu.ops import split as js
from lightgbm_tpu_torch.ops import split as ts

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

HP = dict(min_data_in_leaf=20.0, min_sum_hessian_in_leaf=1e-3,
          lambda_l1=0.0, lambda_l2=0.0, max_delta_step=0.0,
          min_gain_to_split=0.0, path_smooth=0.0)


def _case(seed, F=12, B=64, n=4000, grid=True):
    rng = np.random.RandomState(seed)
    nb = rng.randint(B // 4, B + 1, size=F).astype(np.int32)
    mt = rng.randint(0, 3, size=F).astype(np.int32)
    db = np.minimum(rng.randint(0, B, size=F), nb - 1).astype(np.int32)
    X = (rng.rand(F, n) * nb[:, None]).astype(np.int64)
    w = rng.normal(size=F)
    s = ((X / nb[:, None] - 0.5) * w[:, None]).sum(0)
    g = np.tanh(s) + 0.3 * rng.normal(size=n)
    h = rng.uniform(0.05, 0.25, size=n)
    if grid:
        g, h = np.round(g * 64) / 64, np.round(h * 64) / 64
    hist = np.zeros((2, F, B))
    for f in range(F):
        np.add.at(hist[0, f], X[f], g)
        np.add.at(hist[1, f], X[f], h)
    hist = hist.astype(np.float32)
    sg, sh = np.float32(hist[0, 0].sum()), np.float32(hist[1, 0].sum())
    cnt = np.float32(n)
    out = np.float32(-sg / sh)
    return hist, sg, sh, cnt, out, (nb, mt, db)


def _search_both(hist, sg, sh, cnt, out, meta, hp, fmask=None):
    nb, mt, db = meta
    F = nb.shape[0]
    jm = js.FeatureMeta(num_bins=jnp.asarray(nb), missing_type=jnp.asarray(mt),
                        default_bin=jnp.asarray(db),
                        is_categorical=jnp.zeros(F, bool))
    tm = ts.FeatureMeta(num_bins=torch.tensor(nb), missing_type=torch.tensor(mt),
                        default_bin=torch.tensor(db),
                        is_categorical=torch.zeros(F, dtype=torch.bool))
    jh = js.synth_count_channel(jnp.asarray(hist), jnp.float32(cnt),
                                jnp.float32(sh))
    th = ts.synth_count_channel(torch.tensor(hist), torch.tensor(cnt),
                                torch.tensor(sh))
    rj = js.find_best_split(jh, jnp.float32(sg), jnp.float32(sh),
                            jnp.float32(cnt), jnp.float32(out), jm,
                            js.SplitHyperParams(**hp),
                            None if fmask is None else jnp.asarray(fmask))
    rt = ts.find_best_split(th, torch.tensor(sg), torch.tensor(sh),
                            torch.tensor(cnt), torch.tensor(out), tm,
                            ts.SplitHyperParams(**hp),
                            None if fmask is None else torch.tensor(fmask))
    return rj, rt


def _assert_same(rj, rt, mt, check_dl=True):
    assert int(rj.feature) == int(rt.feature)
    assert int(rj.threshold) == int(rt.threshold)
    if check_dl or mt[int(rt.feature)] != 0:
        assert bool(rj.default_left) == bool(rt.default_left)
    for name in rj._fields[4:]:
        np.testing.assert_allclose(float(getattr(rt, name)),
                                   float(getattr(rj, name)), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(float(rt.gain), float(rj.gain), rtol=1e-5)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("hp_over", [
    {}, {"lambda_l1": 0.5, "lambda_l2": 2.0},
    {"max_delta_step": 0.05}, {"path_smooth": 3.0},
    {"min_gain_to_split": 1.0, "min_sum_hessian_in_leaf": 5.0},
    {"min_data_in_leaf": 400.0}])
def test_best_split_matches_jax(seed, hp_over):
    hist, sg, sh, cnt, out, meta = _case(seed)
    rj, rt = _search_both(hist, sg, sh, cnt, out, meta, {**HP, **hp_over})
    assert np.isfinite(float(rt.gain))
    _assert_same(rj, rt, meta[1])


@pytest.mark.parametrize("seed", range(3))
def test_best_split_random_f32_matches_jax(seed):
    hist, sg, sh, cnt, out, meta = _case(10 + seed, F=28, grid=False)
    rj, rt = _search_both(hist, sg, sh, cnt, out, meta, HP)
    _assert_same(rj, rt, meta[1], check_dl=False)


def test_feature_mask_matches_jax():
    hist, sg, sh, cnt, out, meta = _case(5)
    _, rt_all = _search_both(hist, sg, sh, cnt, out, meta, HP)
    fmask = np.ones(12, bool)
    fmask[int(rt_all.feature)] = False
    rj, rt = _search_both(hist, sg, sh, cnt, out, meta, HP, fmask)
    assert int(rt.feature) != int(rt_all.feature)
    _assert_same(rj, rt, meta[1])


def test_no_valid_split_gives_minus_inf():
    hist, sg, sh, cnt, out, meta = _case(6)
    rj, rt = _search_both(hist, sg, sh, cnt, out, meta,
                          {**HP, "min_data_in_leaf": 1e9})
    assert float(rt.gain) == float("-inf") == float(rj.gain)


def test_batched_search_equals_single_searches():
    """The port searches every child of a wave in one batched call."""
    cases = [_case(s) for s in (7, 8, 9)]
    nb, mt, db = cases[0][5]
    tm = ts.FeatureMeta(num_bins=torch.tensor(nb), missing_type=torch.tensor(mt),
                        default_bin=torch.tensor(db),
                        is_categorical=torch.zeros(12, dtype=torch.bool))
    hp = ts.SplitHyperParams(**HP)

    def stack(i):
        return torch.tensor(np.stack([np.asarray(c[i]) for c in cases]))

    hist3 = ts.synth_count_channel(stack(0), stack(3), stack(2))
    batched = ts.find_best_split(hist3, stack(1), stack(2), stack(3),
                                 stack(4), tm, hp)
    for k in range(3):
        single = ts.find_best_split(hist3[k], stack(1)[k], stack(2)[k],
                                    stack(3)[k], stack(4)[k], tm, hp)
        for a, b in zip(batched, single):
            assert torch.equal(a[k], b)
