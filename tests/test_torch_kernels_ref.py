"""The plain PyTorch versions of the port's four Hopper kernels against the
JAX package's Pallas kernels (interpret mode on the CPU) and its portable
XLA lowering.

Tolerances:
  * leaf_of_row, int8 -> int32 histograms and the leaf-value gather are
    compared bitwise;
  * f32 histograms against the Pallas kernels use values on a 0.25 grid
    (exact in bf16, which the TPU kernel rounds its inputs to, and summed
    exactly in f32 in any order), so atol=1e-6 holds;
  * f32 histograms of random values against the XLA lowering differ only
    by the order of the f32 additions: rtol=1e-5 of the largest bin.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lightgbm_tpu.ops.histogram import _build_histogram_slots_xla
from lightgbm_tpu.ops.histogram_pallas import (build_histogram_pallas,
                                               build_histogram_slots_pallas,
                                               take_leaf_values_pallas,
                                               wave_pass_pallas,
                                               wave_relabel_pallas)
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import histogram_cuda as hc

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)


def _grid_vals(rng, C, N):
    """Values on a 0.25 grid in [-8, 8): exact in bf16."""
    return (rng.randint(-32, 32, size=(C, N)) * 0.25).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# 1. slot histogram
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("F,N,C,B,K", [
    (28, 3001, 2, 64, 1),      # the main path's root histogram, ragged N
    (7, 2500, 2, 32, 8),
    (5, 1800, 3, 256, 16),     # full 8-bit bin range
])
def test_hist_slots_matches_pallas(F, N, C, B, K):
    rng = np.random.RandomState(F * 7 + N + K)
    X = rng.randint(0, B, size=(F, N)).astype(np.uint8)
    vals = _grid_vals(rng, C, N)
    # inactive rows on both sides of the slot range
    slot = rng.randint(-1, K + 1, size=N).astype(np.int32)
    ref = build_histogram_slots_pallas(jnp.asarray(X), jnp.asarray(vals),
                                       jnp.asarray(slot), K, B,
                                       interpret=True)
    got = th.build_histogram_slots(_t(X), _t(vals), _t(slot), K, B)
    assert got.shape == (K, C, F, B) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("B", [32, 64, 256])
def test_root_histogram_matches_pallas(B):
    rng = np.random.RandomState(B)
    F, N = 28, 2049
    X = rng.randint(0, B, size=(F, N)).astype(np.uint8)
    vals = _grid_vals(rng, 2, N)
    ref = build_histogram_pallas(jnp.asarray(X), jnp.asarray(vals), B,
                                 interpret=True)
    got = th.build_histogram(_t(X), _t(vals), B)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("F,N,B,K", [(28, 4000, 64, 16), (9, 3000, 256, 4),
                                     (3, 700, 32, 128)])
def test_hist_slots_matches_xla_random_f32(F, N, B, K):
    rng = np.random.RandomState(F + N + B + K)
    X = rng.randint(0, B, size=(F, N)).astype(np.uint8)
    vals = rng.normal(size=(2, N)).astype(np.float32)
    vals[1] = np.abs(vals[1]) * 0.25
    slot = rng.randint(-2, K + 2, size=N).astype(np.int32)
    ref = np.asarray(_build_histogram_slots_xla(
        jnp.asarray(X), jnp.asarray(vals), jnp.asarray(slot), K, B))
    got = th.build_histogram_slots(_t(X), _t(vals), _t(slot), K, B).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_hist_slots_int8_exact_matches_pallas():
    rng = np.random.RandomState(8)
    F, N, B, K = 6, 1500, 64, 4
    X = rng.randint(0, B, size=(F, N)).astype(np.uint8)
    vals = rng.randint(-127, 128, size=(2, N)).astype(np.int8)
    slot = rng.randint(-1, K + 1, size=N).astype(np.int32)
    ref = build_histogram_slots_pallas(jnp.asarray(X), jnp.asarray(vals),
                                       jnp.asarray(slot), K, B,
                                       interpret=True)
    got = th.build_histogram_slots(_t(X), _t(vals), _t(slot), K, B)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_hist_bins_past_width_add_nothing():
    """Bins >= B fall outside the one-hot and add nothing, as on the TPU."""
    X = torch.tensor([[0, 5, 40, 3]], dtype=torch.uint8)
    vals = torch.tensor([[1.0, 2.0, 4.0, 8.0]])
    got = hc.build_histogram_slots_plain(X, vals, None, 1, 32)
    assert float(got.sum()) == 11.0
    assert float(got[0, 0, 0, 5]) == 2.0


# ---------------------------------------------------------------------------
# 2. leaf-value gather
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("L,N", [(255, 5000), (31, 300), (2048, 1000)])
def test_take_leaf_values_matches_pallas(L, N):
    rng = np.random.RandomState(L + N)
    values = rng.normal(size=L).astype(np.float32)
    lor = rng.randint(0, L, size=N).astype(np.int32)
    ref = take_leaf_values_pallas(jnp.asarray(values), jnp.asarray(lor),
                                  interpret=True)
    got = th.take_leaf_values(_t(values), _t(lor))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_take_leaf_values_out_of_range_rows_give_zero():
    values = torch.tensor([1.5, -2.0, 3.25])
    lor = torch.tensor([0, -1, 2, 3, 1, 99], dtype=torch.int32)
    got = th.take_leaf_values(values, lor)
    assert got.tolist() == [1.5, 0.0, 3.25, 0.0, -2.0, 0.0]


# ---------------------------------------------------------------------------
# 3. / 5. wave pass and relabel
# ---------------------------------------------------------------------------
def _wave_table(rng, F, B, nl0, app_leaves, cand_leaves):
    """[16, 128] semantic wave table; entries past the given leaves are
    inactive (-1 everywhere, as the grower pads them)."""
    t = np.full((16, 128), -1, np.int64)
    for r0, leaves in ((0, app_leaves), (7, cand_leaves)):
        n = len(leaves)
        t[r0, :n] = leaves
        t[r0 + 1, :n] = rng.randint(0, F, n)              # feature
        t[r0 + 2, :n] = rng.randint(0, B - 1, n)          # threshold bin
        t[r0 + 3, :n] = rng.randint(0, 2, n)              # default_left
        t[r0 + 4, :n] = rng.randint(0, 3, n)              # missing type
        t[r0 + 5, :n] = rng.randint(0, B - 1, n)          # default bin
        t[r0 + 6, :n] = B - rng.randint(0, 2, n)          # num_bins
    t[14, :len(cand_leaves)] = rng.randint(0, 2, len(cand_leaves))
    t[15] = nl0
    return t.astype(np.int32)


WAVE_CASES = [
    # F, N, B, K, nl0, napp, ncand
    (9, 2000, 64, 8, 12, 4, 6),
    (28, 2500, 64, 16, 40, 20, 16),
    (5, 1300, 32, 4, 6, 3, 2),        # more slots than candidates
    (7, 1500, 256, 8, 20, 10, 8),     # wide bins (hi/lo on the TPU)
    (12, 1024, 64, 1, 30, 0, 1),      # nothing applied
]


def _wave_inputs(F, N, B, K, nl0, napp, ncand, seed):
    rng = np.random.RandomState(seed)
    X = rng.randint(0, B, size=(F, N)).astype(np.uint8)
    vals = _grid_vals(rng, 2, N)
    lor = rng.randint(0, nl0, size=N).astype(np.int32)
    app = rng.choice(nl0, napp, replace=False)
    # candidates: surviving leaves and fresh right children nl0 + j
    cand = rng.choice(nl0 + napp, ncand, replace=False)
    tbl = _wave_table(rng, F, B, nl0, app, cand)
    return X, vals, lor, tbl


@pytest.mark.parametrize("F,N,B,K,nl0,napp,ncand", WAVE_CASES)
def test_wave_pass_matches_pallas(F, N, B, K, nl0, napp, ncand):
    X, vals, lor, tbl = _wave_inputs(F, N, B, K, nl0, napp, ncand,
                                     F + N + K)
    ref_lor, ref_hist = wave_pass_pallas(
        jnp.asarray(X), jnp.asarray(vals), jnp.asarray(lor),
        jnp.asarray(tbl), K, B, interpret=True)
    got_lor, got_hist = th.wave_pass(_t(X), _t(vals), _t(lor), _t(tbl), K,
                                     B, 256)
    np.testing.assert_array_equal(got_lor.numpy(), np.asarray(ref_lor))
    np.testing.assert_allclose(got_hist.numpy(), np.asarray(ref_hist),
                               rtol=0, atol=1e-6)


def test_wave_pass_int8_exact_matches_pallas():
    F, N, B, K = 5, 1200, 32, 4
    X, _, lor, tbl = _wave_inputs(F, N, B, K, 6, 2, 4, 4)
    vals = np.random.RandomState(5).randint(-127, 128, size=(2, N)) \
        .astype(np.int8)
    ref_lor, ref_hist = wave_pass_pallas(
        jnp.asarray(X), jnp.asarray(vals), jnp.asarray(lor),
        jnp.asarray(tbl), K, B, interpret=True)
    got_lor, got_hist = th.wave_pass(_t(X), _t(vals), _t(lor), _t(tbl), K,
                                     B, 16)
    assert got_hist.dtype == torch.int32
    np.testing.assert_array_equal(got_lor.numpy(), np.asarray(ref_lor))
    np.testing.assert_array_equal(got_hist.numpy(), np.asarray(ref_hist))


@pytest.mark.parametrize("F,N,B,K,nl0,napp,ncand", WAVE_CASES[:4])
def test_wave_relabel_matches_pallas(F, N, B, K, nl0, napp, ncand):
    X, vals, lor, tbl = _wave_inputs(F, N, B, K, nl0, napp, ncand, N + 1)
    ref = wave_relabel_pallas(jnp.asarray(X), jnp.asarray(vals),
                              jnp.asarray(lor), jnp.asarray(tbl), B,
                              interpret=True)
    got = th.wave_relabel(_t(X), _t(lor), _t(tbl), 256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("N", [3000, 3001, 3003])
def test_wave_relabel_in_place_equals_a_new_tensor(N):
    """out=leaf_of_row (the grower's last wave) relabels in place and gives
    what a new tensor gets; N % 4 != 0 is the kernel's scalar tail."""
    X, vals, lor, tbl = _wave_inputs(28, N, 64, 16, 40, 20, 16, 5)
    ref = th.wave_relabel(_t(X), _t(lor), _t(tbl), 256)
    lor_t = _t(lor.copy())
    got = th.wave_relabel(_t(X), lor_t, _t(tbl), 256, out=lor_t)
    assert got.data_ptr() == lor_t.data_ptr()
    assert torch.equal(got, ref) and not np.array_equal(lor, ref.numpy())


def test_wave_pass_relabel_half_is_wave_relabel():
    X, vals, lor, tbl = _wave_inputs(28, 3000, 64, 16, 40, 20, 16, 9)
    lor_pass, _ = th.wave_pass(_t(X), _t(vals), _t(lor), _t(tbl), 16, 64,
                               256)
    lor_rel = th.wave_relabel(_t(X), _t(lor), _t(tbl), 256)
    assert torch.equal(lor_pass, lor_rel)
