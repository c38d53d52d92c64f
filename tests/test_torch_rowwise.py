"""The port's row-wise multi-value histograms (ops/histogram_rowwise.py)
against lightgbm_tpu/ops/histogram_rowwise.py: the flat layout plans, the
nibble pack, and both plain histograms against the JAX package's flat XLA
lowering (`_build_histogram_slots_rowwise_xla`) and its Pallas kernel in
interpret mode.

Values lie on a 0.25 grid in [-8, 8) (exact in bf16, which the TPU kernel
rounds its inputs to, and summed exactly in any order), so f32 buffers are
compared bitwise like the int8 -> int32 ones. The expanded flat buffer
must equal the col-wise slot histogram bit for bit: both accumulate the
same values in f64.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lightgbm_tpu.ops import histogram_rowwise as jr
from lightgbm_tpu.ops.split import expand_feature_offset_hist as j_expand
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import histogram_cuda as hc
from lightgbm_tpu_torch.ops import histogram_rowwise as tr
from lightgbm_tpu_torch.ops.split import expand_feature_offset_hist

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

MIXED = (33, 256, 12, 100, 256, 8, 64, 7, 3, 16, 2)
WIDE = tuple([256] * 9 + [5, 17, 4] + [64] * 30)    # > one column chunk


def _X(nbins, N, rng):
    return np.stack([rng.randint(0, nb, N) for nb in nbins]).astype(np.uint8)


def _vals(rng, C, N, int8=False):
    if int8:
        return rng.randint(-127, 128, size=(C, N)).astype(np.int8)
    return (rng.randint(-32, 32, size=(C, N)) * 0.25).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("nbins", [MIXED, WIDE, (8,), (256, 256)])
def test_plans_match_jax(nbins):
    assert tuple(tr.build_rowwise_plan(nbins)) \
        == tuple(jr.build_rowwise_plan(nbins))
    pj, pt = jr.build_pack4_plan(nbins), tr.build_pack4_plan(nbins)
    assert tuple(pt) == tuple(pj)
    assert tr.pack4_worthwhile(pt) == jr.pack4_worthwhile(pj)
    assert [tr.rw_width(b) for b in nbins] == [jr.rw_width(b) for b in nbins]


@pytest.mark.parametrize("nbins", [MIXED, WIDE])
def test_pack4_matches_jax(nbins):
    X = _X(nbins, 1000, np.random.RandomState(len(nbins)))
    pplan = tr.build_pack4_plan(nbins)
    Xp, Xu = tr.pack4(_t(X), pplan)
    jp, ju = jr.pack4(jnp.asarray(X), jr.build_pack4_plan(nbins))
    np.testing.assert_array_equal(Xp.numpy(), np.asarray(jp).view(np.uint8))
    np.testing.assert_array_equal(Xu.numpy(), np.asarray(ju).view(np.uint8))
    np.testing.assert_array_equal(tr.unpack4(Xp, Xu, pplan).numpy(), X)


@pytest.mark.parametrize("nbins,K,int8", [
    (MIXED, 1, False), (MIXED, 7, False), (WIDE, 5, False),
    (MIXED, 7, True), (WIDE, 3, True)])
def test_plain_flat_matches_xla(nbins, K, int8):
    rng = np.random.RandomState(K + 3 * int8)
    N, C = 1500, 2
    X = _X(nbins, N, rng)
    vals = _vals(rng, C, N, int8)
    slot = rng.randint(-1, K + 1, size=N).astype(np.int32)
    plan = tr.build_rowwise_plan(nbins)
    ref = np.asarray(jr._build_histogram_slots_rowwise_xla(
        jnp.asarray(X), jnp.asarray(vals), jnp.asarray(slot), K,
        jr.build_rowwise_plan(nbins)))
    got = tr.hist_rowwise_plain(_t(X), _t(vals), _t(slot), K, plan)
    assert got.dtype == (torch.int32 if int8 else torch.float32)
    np.testing.assert_array_equal(got.numpy(), ref)
    pplan = tr.build_pack4_plan(nbins)
    Xp, Xu = tr.pack4(_t(X), pplan)
    gotp = tr.hist_rowwise_packed_plain(Xp, Xu, _t(vals), _t(slot), K, plan,
                                        pplan)
    assert torch.equal(gotp, got)


def test_plain_flat_matches_pallas_interpret():
    rng = np.random.RandomState(21)
    N, C, K = 1100, 2, 4
    X = _X(MIXED, N, rng)
    vals = _vals(rng, C, N)
    slot = rng.randint(-1, K, size=N).astype(np.int32)
    ref = jr.build_histogram_slots_rowwise_flat(
        jnp.asarray(X), jnp.asarray(vals), jnp.asarray(slot), K,
        jr.build_rowwise_plan(MIXED), interpret=True)
    got = tr.hist_rowwise_plain(_t(X), _t(vals), _t(slot), K,
                                tr.build_rowwise_plan(MIXED))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("int8", [False, True])
def test_expanded_equals_slot_histogram(int8):
    """flat -> expand_feature_offset_hist is the uniform [K, C, F, B]
    slot histogram bit for bit, and equals the JAX expansion."""
    rng = np.random.RandomState(8 + int8)
    N, C, K, B = 2000, 2, 6, 256
    X = _X(MIXED, N, rng)
    vals = _vals(rng, C, N, int8)
    slot = rng.randint(-1, K, size=N).astype(np.int32)
    plan = tr.build_rowwise_plan(MIXED)
    flat = tr.hist_rowwise_plain(_t(X), _t(vals), _t(slot), K, plan)
    got = expand_feature_offset_hist(flat, plan.offsets, plan.widths, B)
    want = hc.build_histogram_slots_plain(_t(X), _t(vals), _t(slot), K, B)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_expand(jnp.asarray(flat.numpy()),
                                         plan.offsets, plan.widths, B)))


@pytest.mark.parametrize("impl", ["rowwise", "rowwise_packed"])
def test_dispatch_routes_equal_slots(impl):
    rng = np.random.RandomState(11)
    N, C, K, B = 1200, 2, 5, 256
    X = _t(_X(MIXED, N, rng))
    vals = _t(_vals(rng, C, N))
    slot = _t(rng.randint(-1, K, size=N).astype(np.int32))
    route = th.hist_route(impl, MIXED)
    assert route == impl
    plan = th.make_hist_plan(X, route, MIXED)
    got = th.build_histogram_slots(X, vals, slot, K, B, impl=route,
                                   plan=plan)
    assert torch.equal(got, th.build_histogram_slots(X, vals, slot, K, B))
    root = th.build_histogram(X, vals, B, impl=route, plan=plan)
    assert torch.equal(root, th.build_histogram(X, vals, B))


def test_hist_route_choices():
    assert th.hist_route("auto", MIXED) == "slots"
    assert th.hist_route("tiered_hilo", MIXED) == "slots"
    assert th.hist_route("rowwise", MIXED) == "rowwise"
    # fewer than two columns fit a nibble: the plain row-wise layout
    assert th.hist_route("rowwise_packed", (33, 12, 100)) == "rowwise"
    assert th.hist_route("rowwise", ()) == "slots"


def test_rowwise_kernels_refuse_cpu_tensors():
    X = torch.zeros((3, 10), dtype=torch.uint8)
    vals = torch.zeros((2, 10))
    plan = tr.build_rowwise_plan((4, 4, 4))
    pplan = tr.build_pack4_plan((4, 4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        tr.hist_rowwise_cuda(X, vals, None, 1, plan)
    Xp, Xu = tr.pack4(X, pplan)
    with pytest.raises(ValueError, match="CUDA"):
        tr.hist_rowwise_packed_cuda(Xp, Xu, vals, None, 1, plan, pplan)
