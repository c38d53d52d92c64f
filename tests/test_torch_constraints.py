"""Monotone (`basic`, with `monotone_penalty`) and interaction constraints
in the port against the JAX package on the CPU.

Whole runs: the same data through `lightgbm_tpu.train` and
`lightgbm_tpu_torch.train` (`device_type="cpu"`, where every kernel wrapper
runs its plain version) on the megakernel route ("mega", numeric, B <= 64),
the apply route (one categorical feature) and, under
histogram_impl="fused", the general fused route ("fused_tiled", kernel
#10's plain version with its monotone operand); the JAX reference is
always its non-fused run (its tiled fused tests fail on this jax version).
num_leaves stays at 15, under every route's wave cap, so the K ladders
agree.

Tolerances:
  * trees: split features, bin thresholds, default-left where a missing
    bin exists (decision_type bit 2 aside), children and categorical
    bitsets exactly; leaf values within 1e-6 absolute; split gains and
    internal values within rtol 1e-4 / atol 1e-5, the tolerance of the
    whole-run tests of tests/test_torch_wide.py (a gain is a difference of
    sums, which the JAX search forms by an f32 cumsum and the port's by an
    f64 one); raw predictions within rtol 1e-5 / atol 1e-6;
  * the split search against JAX's find_best_split: feature, threshold and
    default_left exactly, float fields within rtol 1e-5 / atol 1e-6 (as
    tests/test_torch_split.py); `_scan_plain` against the port's own
    find_best_split bitwise.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.ops import grow as jgrow
from lightgbm_tpu.ops import grow_wave as jgw
from lightgbm_tpu.ops import split as js
from lightgbm_tpu_torch.ops import grow as tgrow
from lightgbm_tpu_torch.ops import grow_fused as gf
from lightgbm_tpu_torch.ops import grow_wave as tgw
from lightgbm_tpu_torch.ops import split as ts

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

PARAMS = dict(objective="binary", num_leaves=15, max_bin=63,
              learning_rate=0.1, min_data_in_leaf=20, verbose=-1,
              bagging_freq=0)
TORCH = {"device_type": "cpu", "binning_impl": "host"}
ROUNDS = 2
MONO = [1, -1, 0, 1, 0, 0, 0, 0]
SETS = {"mega": [[0, 1], [2, 3, 4]], "apply": [[0, 1, 5], [2, 3, 4]]}


def _data(route):
    """3000 rows x 8 features, NaN in feature 3; on "apply" feature 5 is
    categorical (12 categories). Feature 0 enters through a sine, so its
    +1 constraint binds."""
    rng = np.random.RandomState(0)
    N = 3000
    X = rng.normal(size=(N, 8)).astype(np.float32)
    X[rng.rand(N) < 0.1, 3] = np.nan
    z = X[:, 0] - X[:, 1] + 0.5 * X[:, 2] + np.sin(3 * X[:, 0])
    dskw = {}
    if route == "apply":
        X[:, 5] = rng.randint(0, 12, N)
        z = z + 1.5 * (X[:, 5] % 3 == 0)
        dskw = {"categorical_feature": [5]}
    y = (z + rng.normal(scale=0.5, size=N) > 0).astype(np.float32)
    return X, y, dskw


@pytest.fixture(scope="module")
def runs():
    """JAX boosters by (route, constraint) key, trained once."""
    cache = {}

    def get(route, over):
        key = (route, repr(sorted(over.items())))
        if key not in cache:
            X, y, dskw = _data(route)
            cache[key] = lj.train({**PARAMS, **over},
                                  lj.Dataset(X, label=y, **dskw), ROUNDS)
        return cache[key]
    return get


def _port(route, over, **extra):
    X, y, dskw = _data(route)
    return lt.train({**PARAMS, **TORCH, **over, **extra},
                    lt.Dataset(X, label=y, **dskw), ROUNDS)


def _blocks(text):
    body = text.split("end of trees")[0]
    return [dict(ln.split("=", 1) for ln in blk.splitlines()[1:] if "=" in ln)
            for blk in body.split("Tree=")[1:]]


def _nums(s, dtype=float):
    return np.array(s.split(), dtype=dtype)


def _assert_same_model(route, bj, bt):
    X = _data(route)[0]
    tt, tj = _blocks(bt.model_to_string()), _blocks(bj.model_to_string())
    assert len(tt) == len(tj) == ROUNDS
    for a, b in zip(tt, tj):
        for k in ("num_leaves", "num_cat", "split_feature", "threshold",
                  "left_child", "right_child", "cat_boundaries",
                  "cat_threshold"):
            assert a.get(k) == b.get(k), k
        np.testing.assert_array_equal(_nums(a["decision_type"], int) & ~2,
                                      _nums(b["decision_type"], int) & ~2)
        np.testing.assert_allclose(_nums(a["leaf_value"]),
                                   _nums(b["leaf_value"]), rtol=0,
                                   atol=1e-6)
        for k in ("split_gain", "internal_value"):
            np.testing.assert_allclose(_nums(a[k]), _nums(b[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)


def _trees_differ(a, b):
    return a.model_to_string().split("end of trees")[0] \
        != b.model_to_string().split("end of trees")[0]


# ---------------------------------------------------------------------------
# (a) + (d) monotone `basic`; (c) + (d) interaction constraints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("route", ["mega", "apply"])
@pytest.mark.parametrize("kind", ["monotone", "interaction"])
def test_constraints_match_jax_on_every_route(runs, route, kind):
    over = ({"monotone_constraints": MONO} if kind == "monotone"
            else {"interaction_constraints": SETS[route]})
    bj = runs(route, over)
    bt = _port(route, over)
    g = bt._gbdt
    assert g.grow_route == route
    _assert_same_model(route, bj, bt)
    # the constraint binds: the unconstrained trees differ
    assert _trees_differ(bt, _port(route, {}))
    if route == "apply":
        assert sum(t.num_cat for t in g.models) > 0
    # (d) the general fused route, never the narrow one, grows the same
    # trees as JAX's two-pass run
    bf = _port(route, over, histogram_impl="fused")
    assert bf._gbdt.grow_route == "fused_tiled"
    assert bf._gbdt.fused_veto_reasons == []
    _assert_same_model(route, bj, bf)


def _paths(tree):
    """The split features on every root-to-leaf path of a host tree."""
    out = []

    def walk(node, feats):
        if node < 0:
            out.append(feats)
            return
        f = feats | {int(tree.split_feature[node])}
        walk(int(tree.left_child[node]), f)
        walk(int(tree.right_child[node]), f)
    if tree.num_leaves > 1:
        walk(0, frozenset())
    return out


@pytest.mark.parametrize("route", ["mega", "apply"])
def test_interaction_paths_stay_inside_one_set(route):
    """Every branch of every tree uses features of one constraint set."""
    bt = _port(route, {"interaction_constraints": SETS[route]},
               histogram_impl="fused")
    sets = [set(s) for s in SETS[route]]
    paths = [p for t in bt._gbdt.models for p in _paths(t)]
    assert paths and any(len(p) > 1 for p in paths)
    for p in paths:
        assert any(p <= s for s in sets), sorted(p)


# ---------------------------------------------------------------------------
# (b) monotone_penalty, and its fused veto (d)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("penalty", [0.5, 2.0])
def test_monotone_penalty_matches_jax(runs, penalty):
    over = {"monotone_constraints": MONO, "monotone_penalty": penalty}
    bj = runs("mega", over)
    bt = _port("mega", over)
    _assert_same_model("mega", bj, bt)
    assert _trees_differ(bt, _port("mega", {"monotone_constraints": MONO}))
    # the penalty vetoes the fused kernels (grow_wave.py:134-138)
    bf = _port("mega", over, histogram_impl="fused")
    assert bf._gbdt.grow_route == "mega"
    assert bf._gbdt.fused_veto_reasons == ["monotone_penalty"]
    _assert_same_model("mega", bj, bf)


@pytest.mark.parametrize("method,penalty,inter", [
    ("basic", 0.0, False), ("basic", 0.5, True), ("intermediate", 0.0, False),
    ("intermediate", 2.0, False), (None, 0.0, True)])
def test_fused_vetoes_and_routes_match_jax(monkeypatch, method, penalty,
                                           inter):
    """fused_veto_reasons and the fused route of a constrained
    configuration against grow_wave.py:96-139 / :287-309."""
    monkeypatch.delenv("LIGHTGBM_TPU_DISABLE_FUSED", raising=False)
    F = 8
    common = dict(num_leaves=15, max_depth=-1, min_data_in_leaf=20.0,
                  min_sum_hessian_in_leaf=1e-3, lambda_l1=0.0,
                  lambda_l2=0.0, max_delta_step=0.0, min_gain_to_split=0.0,
                  path_smooth=0.0, num_bins_padded=64, hist_impl="fused",
                  monotone_method=method or "basic",
                  monotone_penalty=penalty)
    tc = tgrow.GrowConfig(has_monotone=method is not None,
                          has_interaction=inter, **common)
    jc = jgrow.GrowConfig(**common)
    jm = js.FeatureMeta(
        num_bins=jnp.full(F, 9), missing_type=jnp.zeros(F),
        default_bin=jnp.zeros(F), is_categorical=jnp.zeros(F, bool),
        monotone=(jnp.asarray(np.int8(MONO)) if method else None),
        inter_sets=jnp.ones((2, F), bool) if inter else None)
    reasons = tgw.fused_veto_reasons(tc)
    assert reasons == jgw.fused_veto_reasons(jc, jm, False, True)
    # an eligible constrained configuration takes the general kernel
    assert tgw.wave_routes(tc, F)[0] == ("fused_tiled" if not reasons
                                         else "mega")


# ---------------------------------------------------------------------------
# (e) the split search and the fused scan's plain version
# ---------------------------------------------------------------------------
HP = dict(min_data_in_leaf=5.0, min_sum_hessian_in_leaf=1e-3,
          lambda_l1=0.0, lambda_l2=0.0, max_delta_step=0.0,
          min_gain_to_split=0.0, path_smooth=0.0)


def _search_case(seed, n=6, F=7, B=32):
    """n seeded histograms [n, 3, F, B] on the 1/64 grid with their
    parent scalars, mixed
    directions, bounds that cut the outputs on every other child, and the
    penalty factors of depths 0-3 under monotone_penalty 0.5."""
    rng = np.random.RandomState(seed)
    # on the 1/64 grid every sum is exact in f32, in any order
    g = (np.round(rng.normal(size=(n, F, B)) * 64) / 64).astype(np.float32)
    h = (np.round(rng.uniform(0.5, 2.0, size=(n, F, B)) * 64) / 64) \
        .astype(np.float32)
    c = rng.randint(1, 6, size=(n, F, B)).astype(np.float32)
    nb = rng.randint(B // 2, B + 1, size=F).astype(np.int32)
    past = np.arange(B)[None, :] >= nb[:, None]            # [F, B]
    g, h, c = (np.where(past, np.float32(0), x) for x in (g, h, c))
    hist = np.stack([g, h, c], axis=1)
    # every feature sees all of the parent's rows
    sg, sh, cnt = g[:, 0].sum(-1), h[:, 0].sum(-1), c[:, 0].sum(-1)
    out = (-sg / sh).astype(np.float32)
    mt = rng.randint(0, 3, size=F).astype(np.int32)
    db = rng.randint(0, B // 2, size=F).astype(np.int32)
    mono = rng.choice([-1, 0, 1], size=F).astype(np.int8)
    mono[:2] = [1, -1]
    lo = np.full(n, -np.inf, np.float32)
    hi = np.full(n, np.inf, np.float32)
    lo[1::2], hi[1::2] = out[1::2] - 0.1, out[1::2] + 0.1
    depth = np.arange(n) % 4
    pen = 0.5
    mpf = np.where(pen >= depth + 1.0, 1e-15,
                   1.0 - pen / np.exp2(depth) + 1e-15).astype(np.float32)
    return (hist, sg, sh, cnt, out, (nb, mt, db, mono), lo, hi, mpf)


def _port_meta(meta, mono=True):
    nb, mt, db, mo = meta
    return ts.FeatureMeta(
        num_bins=torch.from_numpy(nb), missing_type=torch.from_numpy(mt),
        default_bin=torch.from_numpy(db),
        is_categorical=torch.zeros(nb.shape[0], dtype=torch.bool),
        monotone=torch.from_numpy(mo) if mono else None)


@jax.jit
def _jax_search(hist, sg, sh, cnt, out, lo, hi, mpf, nb, mt, db, mo):
    """JAX's find_best_split of each child, with its bounds and penalty
    factor."""
    jm = js.FeatureMeta(num_bins=nb, missing_type=mt, default_bin=db,
                        is_categorical=jnp.zeros(nb.shape[0], bool),
                        monotone=mo)
    jhp = js.SplitHyperParams(**HP)

    def one(h, a, b, c, o, bmin, bmax, f):
        return js.find_best_split(h, a, b, c, o, jm, jhp, leaf_min=bmin,
                                  leaf_max=bmax, mono_pen_factor=f)
    return jax.vmap(one)(hist, sg, sh, cnt, out, lo, hi, mpf)


@pytest.mark.parametrize("seed", [0, 1])
def test_split_search_with_bounds_matches_jax(seed):
    hist, sg, sh, cnt, out, meta, lo, hi, mpf = _search_case(seed)
    nb, mt, db, mo = meta
    want = _jax_search(*(jnp.asarray(x) for x in (
        hist, sg, sh, cnt, out, lo, hi, mpf, nb, mt, db, mo)))
    t = torch.from_numpy
    got = ts.find_best_split(t(hist), t(sg), t(sh), t(cnt), t(out),
                             _port_meta(meta), ts.SplitHyperParams(**HP),
                             leaf_min=t(lo), leaf_max=t(hi),
                             mono_pen_factor=t(mpf))
    assert np.isfinite(np.asarray(want.gain)).sum() >= 4
    for name in ("feature", "threshold", "default_left"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ts.SplitResult._fields[4:] + ("gain",):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    # the bounds hold on every chosen split, the directions too
    ok = np.isfinite(got.gain.numpy())
    lout, rout = got.left_output.numpy()[ok], got.right_output.numpy()[ok]
    assert (lout >= lo[ok]).all() and (lout <= hi[ok]).all()
    assert (rout >= lo[ok]).all() and (rout <= hi[ok]).all()
    d = mo[got.feature.numpy()[ok]]
    assert ((d <= 0) | (lout <= rout)).all()
    assert ((d >= 0) | (lout >= rout)).all()


def _scan_operands(seed, K=3, F=7, B=32):
    """A wave's scan operands: smaller-child histograms [K, 2, F, B],
    parents [K, 2 F B] that dominate them, [7, 2K] scalars with bounds on
    every other child and [5, F] metadata with mixed directions."""
    rng = np.random.RandomState(seed)
    small = np.stack([rng.normal(size=(K, F, B)),
                      rng.uniform(0.2, 1.0, size=(K, F, B))], 1)
    extra = np.stack([rng.normal(size=(K, F, B)),
                      rng.uniform(0.2, 1.0, size=(K, F, B))], 1)
    small, extra = (np.round(x * 64) / 64 for x in (small, extra))
    # every feature's bins sum to the same totals: feature 0's, repeated
    small[:] = small[:, :, :1]
    extra[:] = extra[:, :, :1]
    parent = (small + extra).astype(np.float32)
    small = small.astype(np.float32)
    sil = rng.randint(0, 2, K).astype(bool)
    tot_s, tot_p = small[:, :, 0].sum(-1), parent[:, :, 0].sum(-1)
    left = np.where(sil[:, None], tot_s, tot_p - tot_s)
    lr = np.concatenate([left, tot_p - left])             # [2K, 2]
    cnt = np.round(lr[:, 1] * 8)
    out = -lr[:, 0] / (lr[:, 1] + 1.0)
    lo = np.full(2 * K, -np.inf)
    hi = np.full(2 * K, np.inf)
    lo[1::2], hi[1::2] = out[1::2] - 0.05, out[1::2] + 0.05
    scal = np.stack([lr[:, 0], lr[:, 1], cnt, out,
                     np.concatenate([sil, sil]), lo, hi]).astype(np.float32)
    nb = np.full(F, B, np.int32)
    fmeta = np.stack([nb, rng.randint(0, 3, F), rng.randint(0, B // 2, F),
                      np.zeros(F), rng.choice([-1, 0, 1], F)]).astype(
                          np.int32)
    fmeta[4, :2] = [1, -1]
    fmask = (rng.rand(2 * K, F) < 0.9).astype(np.uint8)
    t = torch.from_numpy
    return (t(small), t(parent.reshape(K, -1)), t(scal), t(fmeta),
            t(fmask))


def test_scan_plain_reads_the_monotone_operand():
    """`_scan_plain` with meta row 4 and scalar rows 5 / 6 equals
    find_best_split with the same directions and bounds bitwise; with
    +-inf and zeros it equals the unconstrained records bitwise."""
    hist, parent, scal, fmeta, fmask = _scan_operands(3)
    hp = ts.SplitHyperParams(**HP)
    K = hist.shape[0]
    sil = (scal[4, :K] != 0)[:, None, None, None]
    large = parent.reshape(hist.shape) - hist
    ch = torch.cat([torch.where(sil, hist, large),
                    torch.where(sil, large, hist)])
    h3 = ts.synth_count_channel(ch, scal[2], scal[1])
    meta = ts.FeatureMeta(num_bins=fmeta[0], missing_type=fmeta[1],
                          default_bin=fmeta[2],
                          is_categorical=fmeta[3] != 0, monotone=fmeta[4])
    want = ts.find_best_split(h3, scal[0], scal[1], scal[2], scal[3], meta,
                              hp, fmask != 0, leaf_min=scal[5],
                              leaf_max=scal[6])
    got = gf._scan_plain(hist, parent, scal, fmeta, fmask, hp, None)
    assert torch.equal(got, torch.stack([x.to(torch.float32)
                                         for x in want]))
    assert torch.isfinite(got[0]).sum() >= K
    # off: the unconstrained search's records, bit for bit
    off_scal, off_meta = scal.clone(), fmeta.clone()
    off_scal[5], off_scal[6], off_meta[4] = -np.inf, np.inf, 0
    free = ts.find_best_split(h3, scal[0], scal[1], scal[2], scal[3],
                              meta._replace(monotone=None), hp, fmask != 0)
    off = gf._scan_plain(hist, parent, off_scal, off_meta, fmask, hp, None)
    assert torch.equal(off, torch.stack([x.to(torch.float32)
                                         for x in free]))
    assert not torch.equal(off, got)


# ---------------------------------------------------------------------------
# (f) the predictions follow the constraints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("route,impl", [("mega", "auto"),
                                        ("apply", "fused")])
def test_predictions_are_monotone_along_a_sweep(route, impl):
    """With +1 on features 0 and 3 and -1 on feature 1, the raw score of
    each of 256 fixed rows does not fall (rise) along a 64-point sweep of
    the feature."""
    bt = _port(route, {"monotone_constraints": MONO}, histogram_impl=impl)
    X = _data(route)[0][:256]
    grid = np.linspace(-3.0, 3.0, 64, dtype=np.float32)
    for j, sign in ((0, 1), (1, -1), (3, 1)):
        Xs = np.repeat(X, len(grid), axis=0)
        Xs[:, j] = np.tile(grid, len(X))
        p = bt.predict(Xs, raw_score=True).reshape(len(X), len(grid))
        step = np.diff(p, axis=1) * sign
        assert (step >= 0).all(), (j, step.min())
        # features 0 and 1 carry the signal: the sweep moves the score
        assert j == 3 or (step > 0).any()
