"""The port's categorical split search (ops/categorical.py) against
lightgbm_tpu/ops/categorical.py:find_best_split_categorical, batched over a
wave's leaves (the JAX function vmapped).

Histograms are built from rows whose gradients and hessians lie on a 1/64
grid, so every bin and every prefix sum is exact in f32 in any order: the
sort keys, and so the left-sets, are the same in both packages. Compared:
feature and bin bitset exactly; gain, leaf outputs and side sums within
rtol 1e-6 (the two packages' f32 gain formulas may round differently in
the last bit).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lightgbm_tpu.ops import categorical as jc
from lightgbm_tpu.ops import split as js
from lightgbm_tpu_torch.ops import categorical as tc
from lightgbm_tpu_torch.ops import split as ts

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

B = 256


def _leaves(seed, n_leaves, nb, is_cat, N=4000):
    """[n, 3, F, B] histograms of n random row subsets, with their parent
    sums (exact grid values, exact counts)."""
    rng = np.random.RandomState(seed)
    F = len(nb)
    X = np.stack([np.minimum(rng.zipf(1.3, N) - 1, k - 1) if c
                  else rng.randint(0, k, N) for k, c in zip(nb, is_cat)])
    # wide categoricals carry most of the signal, so sorted many-vs-many
    # left-sets win beside one-hot ones
    eff = [rng.normal(size=k) * (2.0 if k > 4 else 0.3) for k in nb]
    s = sum(e[x] for e, x in zip(eff, X))
    g = np.round((np.tanh(s) + 0.5 * rng.normal(size=N)) * 64) / 64
    h = np.round(rng.uniform(0.05, 0.25, N) * 64) / 64
    hists, pg, ph, pc = [], [], [], []
    for _ in range(n_leaves):
        rows = rng.rand(N) < rng.uniform(0.3, 1.0)
        hist = np.zeros((3, F, B), np.float64)
        for f in range(F):
            for ch, v in enumerate((g, h, np.ones(N))):
                np.add.at(hist[ch, f], X[f, rows], v[rows])
        hists.append(hist)
        pg.append(g[rows].sum())
        ph.append(h[rows].sum())
        pc.append(rows.sum())
    out = rng.normal(scale=0.1, size=n_leaves)
    f32 = np.float32
    return (np.asarray(hists, f32), np.asarray(pg, f32), np.asarray(ph, f32),
            np.asarray(pc, f32), out.astype(f32))


def _meta(pkg, nb, is_cat):
    F = len(nb)
    t = jnp.asarray if pkg is js else torch.tensor
    return pkg.FeatureMeta(num_bins=t(np.asarray(nb, np.int32)),
                           missing_type=t(np.zeros(F, np.int32)),
                           default_bin=t(np.zeros(F, np.int32)),
                           is_categorical=t(np.asarray(is_cat)))


def _search_both(nb, is_cat, seed, n_leaves=6, fmask=None, **hp_over):
    hp = dict(min_data_in_leaf=5.0, min_sum_hessian_in_leaf=1e-3,
              lambda_l1=0.0, lambda_l2=0.5, max_delta_step=0.0,
              min_gain_to_split=0.0, path_smooth=0.0)
    cat = dict(max_cat_to_onehot=4, max_cat_threshold=32, cat_l2=10.0,
               cat_smooth=10.0, min_data_per_group=20.0,
               num_bitset_words=B // 32)
    hp.update({k: v for k, v in hp_over.items() if k in hp})
    cat.update({k: v for k, v in hp_over.items() if k in cat})
    hist, pg, ph, pc, out = _leaves(seed, n_leaves, nb, is_cat)
    jm, tm = _meta(js, nb, is_cat), _meta(ts, nb, is_cat)
    jhp, thp = js.SplitHyperParams(**hp), ts.SplitHyperParams(**hp)
    jfm = None if fmask is None else jnp.asarray(fmask)
    tfm = None if fmask is None else torch.tensor(fmask)

    def one(h_, g_, hh_, c_, o_):
        return jc.find_best_split_categorical(h_, g_, hh_, c_, o_, jm, jhp,
                                              jc.CatConfig(**cat), jfm)

    jres, jbits = jax.vmap(one)(*(jnp.asarray(a) for a in
                                  (hist, pg, ph, pc, out)))
    tres, tbits = tc.find_best_split_categorical(
        *(torch.from_numpy(a) for a in (hist, pg, ph, pc, out)), tm, thp,
        tc.CatConfig(**cat), tfm)
    return jres, np.asarray(jbits), tres, tbits.numpy()


def _assert_same(jres, jbits, tres, tbits):
    jg, tg = np.asarray(jres.gain), tres.gain.numpy()
    np.testing.assert_array_equal(np.isfinite(tg), np.isfinite(jg))
    ok = np.isfinite(jg)
    np.testing.assert_allclose(tg[ok], jg[ok], rtol=1e-6)
    np.testing.assert_array_equal(tres.feature.numpy()[ok],
                                  np.asarray(jres.feature)[ok])
    np.testing.assert_array_equal(tbits[ok], jbits[ok].astype(np.int64))
    assert not tres.default_left.any()
    for name in ("left_sum_g", "left_sum_h", "left_count", "right_sum_g",
                 "right_sum_h", "right_count", "left_output",
                 "right_output"):
        np.testing.assert_allclose(getattr(tres, name).numpy()[ok],
                                   np.asarray(getattr(jres, name))[ok],
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    return ok


# features of 3 to 250 categories (bin 0 is the other/missing bin), one
# numeric feature the search must skip
NB = (4, 3, 11, 26, 60, 121, 251, 40)
IS_CAT = (True, True, True, True, True, True, True, False)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_many_vs_many_and_onehot_match_jax(seed):
    jres, jbits, tres, tbits = _search_both(NB, IS_CAT, seed)
    ok = _assert_same(jres, jbits, tres, tbits)
    assert ok.all()
    sizes = [sum(bin(int(x)).count("1") for x in w) for w in tbits]
    assert max(sizes) > 1            # a sorted many-vs-many left-set won
    # a left-set never holds bin 0 and lies inside the feature's bins
    for f, w in zip(tres.feature.numpy(), tbits):
        bins = [b for b in range(B) if (int(w[b >> 5]) >> (b & 31)) & 1]
        assert bins and 0 not in bins and max(bins) < NB[f]


def test_onehot_mode_only():
    """Every feature at or under max_cat_to_onehot bins: left = one
    category, the bitset has exactly one bit."""
    nb, is_cat = (4, 3, 4, 2), (True,) * 4
    jres, jbits, tres, tbits = _search_both(nb, is_cat, 3,
                                            max_cat_to_onehot=4)
    ok = _assert_same(jres, jbits, tres, tbits)
    assert ok.any()
    for w in tbits[ok]:
        assert sum(bin(int(x)).count("1") for x in w) == 1


def test_feature_mask_and_tight_thresholds():
    """Column sampling masks features out; a small max_cat_threshold caps
    the left-set size."""
    fmask = np.array([False, True, True, False, True, True, False, True])
    jres, jbits, tres, tbits = _search_both(NB, IS_CAT, 4, fmask=fmask,
                                            max_cat_threshold=3,
                                            cat_smooth=2.0)
    ok = _assert_same(jres, jbits, tres, tbits)
    assert ok.any() and fmask[tres.feature.numpy()[ok]].all()


def test_no_valid_split_gives_minus_inf():
    """min_data_in_leaf above every leaf's rows: gain -inf in both."""
    jres, jbits, tres, tbits = _search_both(NB, IS_CAT, 5,
                                            min_data_in_leaf=1e7)
    assert not np.isfinite(tres.gain.numpy()).any()
    assert not np.isfinite(np.asarray(jres.gain)).any()
