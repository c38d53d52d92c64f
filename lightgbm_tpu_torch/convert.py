"""Build a port Booster from a JAX-package model's state.

The JAX package (lightgbm_tpu) keeps a trained model as host `Tree`
objects, one BinMapper per used feature and a parameter dict. Given those
as plain numpy arrays and dicts, `booster_from_state` rebuilds the same
model in this package: the same trees (so the same predictions), the same
feature metadata (so the same model text). Model text
(`Booster.model_to_string` -> `Booster(model_str=...)`) is the public route
for the same transfer.

Typical use, with `jbst` a lightgbm_tpu Booster:

    g = jbst._gbdt
    bst = booster_from_state(
        params=jbst.params,
        trees=[vars(t) for t in g.models],
        mappers=[m.to_dict() for m in g.mappers],
        real_feature_index=g.real_feature_index,
        feature_names=g.feature_names_,
        num_total_features=g.max_feature_idx_ + 1)
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .basic import Booster
from .config import resolve_params
from .data.binning import BinMapper
from .models.gbdt import GBDT
from .models.tree import Tree
from .objectives import create_objective

# Tree fields carried over, with their host dtypes (models/tree.py)
_TREE_FIELDS = {
    "split_feature": np.int32, "split_gain": np.float32,
    "threshold": np.float64, "threshold_in_bin": np.int32,
    "decision_type": np.int8, "left_child": np.int32,
    "right_child": np.int32, "leaf_value": np.float64,
    "leaf_weight": np.float64, "leaf_count": np.int64,
    "internal_value": np.float64, "internal_weight": np.float64,
    "internal_count": np.int64, "cat_boundaries": np.int32,
    "cat_threshold": np.uint32,
}


def tree_from_arrays(d: Dict[str, Any]) -> Tree:
    """A host Tree from a dict of its arrays (the keys of `vars(tree)` of
    the JAX package's Tree)."""
    t = Tree(int(d["num_leaves"]))
    t.num_cat = int(d.get("num_cat", 0))
    for name, dtype in _TREE_FIELDS.items():
        if name in d:
            setattr(t, name, np.array(d[name], dtype=dtype))
    t.shrinkage = float(d.get("shrinkage", 1.0))
    if d.get("is_linear", False):
        # a linear leaf: its constant, and its coefficients on raw columns
        t.is_linear = True
        t.leaf_const = np.array(d["leaf_const"], dtype=np.float64)
        t.leaf_features = [[int(f) for f in fs] for fs in d["leaf_features"]]
        t.leaf_coeff = [[float(c) for c in cs] for cs in d["leaf_coeff"]]
    return t


def booster_from_state(params: Dict[str, Any],
                       trees: Sequence[Dict[str, Any]],
                       mappers: Sequence[Dict[str, Any]],
                       real_feature_index: Sequence[int],
                       feature_names: Optional[List[str]] = None,
                       num_total_features: Optional[int] = None) -> Booster:
    """A port Booster holding the given trees, bin mappers and parameters.

    `mappers[i]` is the BinMapper dict (`BinMapper.to_dict()`) of inner
    feature i, which is original column `real_feature_index[i]`; columns
    without a mapper were trivial. Predictions walk the trees on the host,
    as after training in this package."""
    cfg = resolve_params(params)
    n_cols = (int(num_total_features) if num_total_features is not None
              else max(real_feature_index, default=-1) + 1)
    bms = [BinMapper.from_dict(m) for m in mappers]
    used = [-1] * n_cols
    for inner, real in enumerate(real_feature_index):
        used[int(real)] = inner
    gbdt = GBDT(cfg, None, create_objective(cfg))
    gbdt.mappers = bms
    gbdt.real_feature_index = [int(r) for r in real_feature_index]
    gbdt.max_feature_idx_ = n_cols - 1
    gbdt.feature_names_ = (list(feature_names) if feature_names is not None
                           else [f"Column_{i}" for i in range(n_cols)])
    gbdt.feature_infos_ = ["none" if u < 0 else bms[u].feature_info()
                           for u in used]
    gbdt._models = [tree_from_arrays(d) for d in trees]
    gbdt.iter = len(gbdt._models) // max(gbdt.num_tree_per_iteration, 1)
    bst = Booster.__new__(Booster)
    bst.params = dict(params)
    bst.best_iteration = -1
    bst.best_score = {}
    bst._train_metrics, bst._valid_metrics, bst.name_valid_sets = [], [], []
    bst._gbdt = gbdt
    bst._config = cfg
    return bst
