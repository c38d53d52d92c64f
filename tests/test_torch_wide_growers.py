"""The serial growers and wave_exact on uint16 storage (`max_bin` 1023, a
categorical feature of 400 categories) against the JAX package's, on the
CPU: one tree from the same 1/64-grid gradients (ROADMAP C note 9), each
package on its own binned data, meta and config; the structure,
categorical bitsets, counts and leaf_of_row exactly, the float fields
within rtol 1e-5.

tests/test_torch_wide_bins.py holds the bins, whole runs, routes and
plain kernels past 256 bins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.ops.grow import grow_tree as j_masked
from lightgbm_tpu.ops.grow_fast import grow_tree_fast as j_compact
from lightgbm_tpu.ops.grow_wave import grow_tree_wave as j_wave
from lightgbm_tpu_torch.ops.grow import grow_tree as t_masked
from lightgbm_tpu_torch.ops.grow_fast import grow_tree_fast as t_compact
from lightgbm_tpu_torch.ops.grow_wave import grow_tree_wave as t_wave

from test_torch_wide_bins import wide_data

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

TORCH = {"device_type": "cpu", "binning_impl": "host"}
PARAMS = dict(objective="binary", num_leaves=15, max_bin=1023,
              learning_rate=0.1, min_data_in_leaf=10, verbose=-1,
              min_data_per_group=20, cat_smooth=1.0)
# one XLA program a grower
GROWERS = {"masked": (jax.jit(j_masked, static_argnames=("cfg",)),
                      t_masked),
           "compact": (jax.jit(j_compact, static_argnames=("cfg",)),
                       t_compact),
           "wave_exact": (jax.jit(j_wave, static_argnames=("cfg",)),
                          t_wave)}


@pytest.mark.parametrize("grower", list(GROWERS))
def test_one_tree_equals_jax_on_uint16(grower):
    X, y = wide_data()
    rng = np.random.RandomState(4)
    g = (np.round((0.5 - y + 0.1 * rng.normal(size=len(y))) * 64) / 64
         ).astype(np.float32)
    h = (np.round(rng.uniform(0.1, 0.3, size=len(y)) * 64) / 64
         ).astype(np.float32)
    b = (rng.rand(len(y)) < 0.8).astype(np.float32)
    p = {**PARAMS, "tpu_grower": grower}
    dskw = {"categorical_feature": [4]}
    gj = lj.Booster(p, lj.Dataset(X, label=y, **dskw))._gbdt
    gt = lt.Booster({**p, **TORCH}, lt.Dataset(X, label=y, **dskw))._gbdt
    assert gt.X_t.dtype == torch.uint16 and gt.grow_cfg.wide_bins
    assert gt.grow_route == ("apply" if grower == "wave_exact" else grower)
    jfn, tfn = GROWERS[grower]
    tj, lor_j = jfn(gj.X_t, jnp.asarray(g), jnp.asarray(h), jnp.asarray(b),
                    gj.meta, cfg=gj.grow_cfg)
    tt, lor_t = tfn(gt.X_t, torch.from_numpy(g), torch.from_numpy(h),
                    torch.from_numpy(b), gt.meta, gt.grow_cfg,
                    hist_plan=gt.hist_plan)
    n = int(tj.num_leaves)
    m = n - 1
    assert tt.num_leaves == n == 15
    for name in ("split_feature", "threshold_bin", "default_left",
                 "left_child", "right_child", "internal_count",
                 "split_is_cat"):
        np.testing.assert_array_equal(getattr(tt, name)[:m].numpy(),
                                      np.asarray(getattr(tj, name))[:m],
                                      err_msg=name)
    np.testing.assert_array_equal(
        tt.split_cat_bitset[:m].numpy().astype(np.uint32),
        np.asarray(tj.split_cat_bitset)[:m].astype(np.uint32))
    np.testing.assert_array_equal(tt.leaf_count[:n].numpy(),
                                  np.asarray(tj.leaf_count)[:n])
    for name, k in (("leaf_value", n), ("leaf_weight", n), ("split_gain", m),
                    ("internal_value", m), ("internal_weight", m)):
        np.testing.assert_allclose(getattr(tt, name)[:k].numpy(),
                                   np.asarray(getattr(tj, name))[:k],
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(lor_t.numpy(), np.asarray(lor_j))
    # a threshold past bin 255 and a categorical split of the wide feature
    assert int(tt.threshold_bin[:m].max()) > 255
    assert tt.split_is_cat[:m].any()
    assert tt.split_cat_bitset.shape[1] == gt.grow_cfg.cat_words > 8
