"""Decision tree model structure.

Host-side tree: flat numpy arrays for split structure, leaf values, and
categorical bitset thresholds, with text/JSON serialization byte-compatible
with the reference format (reference: include/LightGBM/tree.h:27,
src/io/tree.cpp Tree::ToString/Tree::Tree(const char*, size_t*)).

Node numbering follows the reference: internal node k is created by the k-th
split; in `left_child`/`right_child` a non-negative value is an internal node
index and a negative value encodes leaf index ``~leaf`` (i.e. ``-(leaf+1)``).

During training the tree lives on-device as a `TreeArrays` pytree produced by
the grower (ops/grow.py); `Tree.from_arrays` converts it to this host form.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

# decision_type bit layout (reference: include/LightGBM/tree.h:21-22,263-287)
_CATEGORICAL_MASK = 1
_DEFAULT_LEFT_MASK = 2

# MissingType enum (reference: include/LightGBM/meta.h)
MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

_KZERO_THRESHOLD = 1e-35  # reference: include/LightGBM/utils/common.h kZeroThreshold


def _fmt(x: float, high_precision: bool = False) -> str:
    """Format a number the way the reference's ArrayToString does."""
    if high_precision:
        # %.17g equivalent round-trip precision
        s = np.format_float_positional(
            np.float64(x), unique=True, trim="0")
        if s.endswith("."):
            s += "0"
        return s
    if float(x) == int(x) and abs(x) < 1e15:
        return str(int(x))
    return repr(float(x))


def _arr_to_str(arr: Sequence, high_precision: bool = False) -> str:
    return " ".join(_fmt(v, high_precision) if isinstance(v, (float, np.floating))
                    else str(int(v)) for v in arr)


class Tree:
    """A learned decision tree (reference: include/LightGBM/tree.h:27)."""

    def __init__(self, num_leaves: int):
        n = num_leaves
        self.num_leaves = n
        self.num_cat = 0
        m = max(n - 1, 0)
        self.split_feature = np.zeros(m, dtype=np.int32)     # real feature idx
        self.split_gain = np.zeros(m, dtype=np.float32)
        self.threshold = np.zeros(m, dtype=np.float64)       # real-valued
        self.threshold_in_bin = np.zeros(m, dtype=np.int32)  # bin threshold
        self.decision_type = np.zeros(m, dtype=np.int8)
        self.left_child = np.zeros(m, dtype=np.int32)
        self.right_child = np.zeros(m, dtype=np.int32)
        self.leaf_value = np.zeros(n, dtype=np.float64)
        self.leaf_weight = np.zeros(n, dtype=np.float64)
        self.leaf_count = np.zeros(n, dtype=np.int64)
        self.internal_value = np.zeros(m, dtype=np.float64)
        self.internal_weight = np.zeros(m, dtype=np.float64)
        self.internal_count = np.zeros(m, dtype=np.int64)
        self.cat_boundaries = np.zeros(1, dtype=np.int32)    # [num_cat + 1]
        self.cat_threshold = np.zeros(0, dtype=np.uint32)    # bitsets
        # linear leaves (reference: tree.h leaf_const_/leaf_coeff_/
        # leaf_features_; fit by models/linear.py)
        self.is_linear = False
        self.leaf_const = np.zeros(n, dtype=np.float64)
        self.leaf_features: List[List[int]] = [[] for _ in range(n)]
        self.leaf_coeff: List[List[float]] = [[] for _ in range(n)]
        self.shrinkage = 1.0

    # ------------------------------------------------------------------
    # construction from device grower output
    # ------------------------------------------------------------------
    @classmethod
    def from_arrays(
        cls,
        num_leaves: int,
        split_feature: np.ndarray,
        threshold_bin: np.ndarray,
        threshold_real: np.ndarray,
        decision_type: np.ndarray,
        left_child: np.ndarray,
        right_child: np.ndarray,
        split_gain: np.ndarray,
        leaf_value: np.ndarray,
        leaf_weight: np.ndarray,
        leaf_count: np.ndarray,
        internal_value: np.ndarray,
        internal_weight: np.ndarray,
        internal_count: np.ndarray,
        shrinkage: float = 1.0,
        cat_boundaries: Optional[np.ndarray] = None,
        cat_threshold: Optional[np.ndarray] = None,
        num_cat: int = 0,
    ) -> "Tree":
        t = cls(int(num_leaves))
        m = max(int(num_leaves) - 1, 0)
        t.split_feature = np.asarray(split_feature, np.int32)[:m]
        t.threshold_in_bin = np.asarray(threshold_bin, np.int32)[:m]
        t.threshold = np.asarray(threshold_real, np.float64)[:m]
        t.decision_type = np.asarray(decision_type, np.int8)[:m]
        t.left_child = np.asarray(left_child, np.int32)[:m]
        t.right_child = np.asarray(right_child, np.int32)[:m]
        t.split_gain = np.asarray(split_gain, np.float32)[:m]
        n = int(num_leaves)
        t.leaf_value = np.asarray(leaf_value, np.float64)[:n]
        t.leaf_weight = np.asarray(leaf_weight, np.float64)[:n]
        t.leaf_count = np.asarray(leaf_count, np.int64)[:n]
        t.internal_value = np.asarray(internal_value, np.float64)[:m]
        t.internal_weight = np.asarray(internal_weight, np.float64)[:m]
        t.internal_count = np.asarray(internal_count, np.int64)[:m]
        t.shrinkage = float(shrinkage)
        if num_cat:
            t.num_cat = int(num_cat)
            t.cat_boundaries = np.asarray(cat_boundaries, np.int32)
            t.cat_threshold = np.asarray(cat_threshold, np.uint32)
        return t

    # ------------------------------------------------------------------
    # prediction (vectorized host path; device path lives in ops/predict.py)
    # ------------------------------------------------------------------
    def predict(self, X: np.ndarray) -> np.ndarray:
        """Per-row output (reference: Tree::Predict via GetLeaf,
        tree.h:438; linear leaves follow the AddPredictionToScore linear
        path, tree.cpp:130-155 — leaf_const + sum(coeff * raw), falling
        back to the constant leaf_value when any used feature is NaN)."""
        leaf = self.get_leaf_index(X)
        if not self.is_linear:
            return self.leaf_value[leaf]
        out = self.leaf_const[leaf].copy()
        nan_found = np.zeros(X.shape[0], dtype=bool)
        for li in range(self.num_leaves):
            feats = self.leaf_features[li]
            if not feats:
                continue
            rows = leaf == li
            if not rows.any():
                continue
            vals = X[np.ix_(rows, feats)].astype(np.float64)
            bad = np.isnan(vals).any(axis=1)
            contrib = np.where(
                bad[:, None], 0.0,
                vals * np.asarray(self.leaf_coeff[li])[None, :]).sum(axis=1)
            out[rows] += contrib
            nan_idx = np.flatnonzero(rows)[bad]
            nan_found[nan_idx] = True
        return np.where(nan_found, self.leaf_value[leaf], out)

    def get_leaf_index(self, X: np.ndarray) -> np.ndarray:
        n_rows = X.shape[0]
        if self.num_leaves <= 1:
            return np.zeros(n_rows, dtype=np.int32)
        node = np.zeros(n_rows, dtype=np.int32)
        active = np.ones(n_rows, dtype=bool)
        out = np.zeros(n_rows, dtype=np.int32)
        for _ in range(self.num_leaves):  # depth can't exceed num_leaves - 1
            if not active.any():
                break
            nd = node[active]
            fval = X[active, self.split_feature[nd]].astype(np.float64)
            dt = self.decision_type[nd]
            is_cat = (dt & _CATEGORICAL_MASK) != 0
            default_left = (dt & _DEFAULT_LEFT_MASK) != 0
            missing_type = (dt.astype(np.int32) >> 2) & 3

            nan_mask = np.isnan(fval)
            fval_n = np.where(nan_mask & (missing_type != MISSING_NAN), 0.0, fval)
            is_missing = ((missing_type == MISSING_ZERO)
                          & (np.abs(fval_n) <= _KZERO_THRESHOLD)) | \
                         ((missing_type == MISSING_NAN) & nan_mask)
            go_left_num = np.where(is_missing, default_left,
                                   fval_n <= self.threshold[nd])
            if self.num_cat > 0 and is_cat.any():
                go_left_cat = self._cat_decision(fval, nd)
                go_left = np.where(is_cat, go_left_cat, go_left_num)
            else:
                go_left = go_left_num
            nxt = np.where(go_left, self.left_child[nd], self.right_child[nd])
            is_leaf = nxt < 0
            idx_active = np.flatnonzero(active)
            out[idx_active[is_leaf]] = ~nxt[is_leaf]
            node[idx_active] = np.where(is_leaf, 0, nxt)
            new_active = active.copy()
            new_active[idx_active[is_leaf]] = False
            active = new_active
        return out

    def _cat_decision(self, fval: np.ndarray, nodes: np.ndarray) -> np.ndarray:
        """Vectorized categorical bitset test
        (reference: tree.h CategoricalDecision:375)."""
        go_left = np.zeros(fval.shape[0], dtype=bool)
        valid = ~np.isnan(fval) & (fval >= 0)
        iv = np.where(valid, fval, 0).astype(np.int64)
        # called for ALL nodes and masked by the caller: numerical nodes'
        # threshold_in_bin is a bin index, not a cat_idx — clip it
        cat_idx = np.clip(self.threshold_in_bin[nodes].astype(np.int64),
                          0, max(self.num_cat - 1, 0))
        starts = self.cat_boundaries[cat_idx]
        sizes = self.cat_boundaries[cat_idx + 1] - starts
        in_range = valid & (iv < sizes.astype(np.int64) * 32)
        word = starts + np.minimum(iv // 32, np.maximum(sizes - 1, 0))
        bits = self.cat_threshold[word.astype(np.int64)]
        go_left = in_range & (((bits >> (iv % 32).astype(np.uint32)) & 1) == 1)
        return go_left

    def get_leaf_binned(self, Xb: np.ndarray, gbdt) -> np.ndarray:
        """Leaf index per row over BINNED data [N, F_inner] (host analog of
        Tree::GetLeaf with DecisionInner, tree.h:358-372). Requires the
        training-time attributes (`split_feature_inner`, `threshold_in_bin`)
        set by GBDT._device_tree_to_host."""
        n_rows = Xb.shape[0]
        if self.num_leaves <= 1:
            return np.zeros(n_rows, dtype=np.int32)
        inner = np.asarray(self.split_feature_inner, np.int32)
        num_bins = np.array([m.num_bin for m in gbdt.mappers], np.int32)
        default_bin = np.array([m.default_bin for m in gbdt.mappers], np.int32)
        missing_type = np.array([m.missing_type for m in gbdt.mappers],
                                np.int32)
        node = np.zeros(n_rows, dtype=np.int32)
        out = np.full(n_rows, -1, dtype=np.int32)
        active = np.ones(n_rows, dtype=bool)
        for _ in range(self.num_leaves):
            if not active.any():
                break
            idx = np.flatnonzero(active)
            nd = node[idx]
            f = inner[nd]
            bins = Xb[idx, f].astype(np.int32)
            mt = missing_type[f]
            is_missing = ((mt == MISSING_ZERO) & (bins == default_bin[f])) | \
                         ((mt == MISSING_NAN) & (bins == num_bins[f] - 1))
            dl = (self.decision_type[nd] & _DEFAULT_LEFT_MASK) != 0
            go_left = np.where(is_missing, dl,
                               bins <= self.threshold_in_bin[nd])
            # categorical: test the training-time bin bitset
            cat_bits = getattr(self, "split_cat_bitset_bins", None)
            if cat_bits is not None and len(cat_bits):
                nd_cat = (self.decision_type[nd] & _CATEGORICAL_MASK) != 0
                W = cat_bits.shape[1]
                words = cat_bits[nd, np.minimum(bins >> 5, W - 1)]
                go_left_cat = ((words >> (bins & 31).astype(np.uint32)) & 1) == 1
                go_left = np.where(nd_cat, go_left_cat, go_left)
            nxt = np.where(go_left, self.left_child[nd], self.right_child[nd])
            leaf_hit = nxt < 0
            out[idx[leaf_hit]] = ~nxt[leaf_hit]
            node[idx] = np.where(leaf_hit, 0, nxt)
            active[idx[leaf_hit]] = False
        return np.maximum(out, 0)

    def shrink(self, rate: float) -> None:
        """reference: Tree::Shrinkage (tree.h:189) — linear constants
        and coefficients scale with the leaf values."""
        self.leaf_value *= rate
        self.internal_value *= rate
        if self.is_linear:
            self.leaf_const *= rate
            self.leaf_coeff = [[c * rate for c in cs]
                               for cs in self.leaf_coeff]
        self.shrinkage *= rate

    def add_bias(self, val: float) -> None:
        """reference: Tree::AddBias (tree.h:214) — linear constants carry
        the bias too (tree.h:225-229)."""
        self.leaf_value = self.leaf_value + val
        self.internal_value = self.internal_value + val
        if self.is_linear:
            self.leaf_const = self.leaf_const + val
        self.shrinkage = 1.0

    def expected_value(self) -> float:
        """The count-weighted mean output (reference: tree.cpp
        Tree::ExpectedValue): sum over leaves of leaf_count / the root's
        internal_count times the leaf's value; a stump's value itself.
        The JAX package weighs by the leaves' hessian sums (ROADMAP C
        note 18), which TreeSHAP's count fractions do not sum to."""
        if self.num_leaves <= 1:
            return float(self.leaf_value[0])
        total = float(self.internal_count[0])
        return float(sum(float(c) / total * float(v) for c, v in zip(
            self.leaf_count[:self.num_leaves], self.leaf_value)))

    def leaf_depths(self) -> np.ndarray:
        depth = np.zeros(self.num_leaves, dtype=np.int32)
        if self.num_leaves <= 1:
            return depth
        stack = [(0, 0)]
        while stack:
            node, d = stack.pop()
            for child in (self.left_child[node], self.right_child[node]):
                if child < 0:
                    depth[~child] = d + 1
                else:
                    stack.append((int(child), d + 1))
        return depth

    # ------------------------------------------------------------------
    # serialization (reference: src/io/tree.cpp:344 Tree::ToString)
    # ------------------------------------------------------------------
    def to_string(self) -> str:
        n, m = self.num_leaves, max(self.num_leaves - 1, 0)
        buf = [f"num_leaves={n}", f"num_cat={self.num_cat}"]
        buf.append("split_feature=" + _arr_to_str(self.split_feature[:m]))
        buf.append("split_gain=" + _arr_to_str(
            [float(g) for g in self.split_gain[:m]]))
        buf.append("threshold=" + _arr_to_str(
            [float(t) for t in self.threshold[:m]], high_precision=True))
        buf.append("decision_type=" + _arr_to_str(self.decision_type[:m]))
        buf.append("left_child=" + _arr_to_str(self.left_child[:m]))
        buf.append("right_child=" + _arr_to_str(self.right_child[:m]))
        buf.append("leaf_value=" + _arr_to_str(
            [float(v) for v in self.leaf_value[:n]], high_precision=True))
        buf.append("leaf_weight=" + _arr_to_str(
            [float(v) for v in self.leaf_weight[:n]], high_precision=True))
        buf.append("leaf_count=" + _arr_to_str(self.leaf_count[:n]))
        buf.append("internal_value=" + _arr_to_str(
            [float(v) for v in self.internal_value[:m]]))
        buf.append("internal_weight=" + _arr_to_str(
            [float(v) for v in self.internal_weight[:m]]))
        buf.append("internal_count=" + _arr_to_str(self.internal_count[:m]))
        if self.num_cat > 0:
            buf.append("cat_boundaries=" + _arr_to_str(self.cat_boundaries))
            buf.append("cat_threshold=" + _arr_to_str(self.cat_threshold))
        buf.append(f"is_linear={int(self.is_linear)}")
        if self.is_linear:
            # reference: tree.cpp ToString is_linear block (:382-410)
            buf.append("leaf_const=" + _arr_to_str(
                [float(v) for v in self.leaf_const[:n]],
                high_precision=True))
            buf.append("num_features=" + _arr_to_str(
                [len(self.leaf_coeff[i]) for i in range(n)]))
            lf = []
            for i in range(n):
                if self.leaf_coeff[i]:
                    lf.append(_arr_to_str(self.leaf_features[i]) + " ")
                lf.append(" ")
            buf.append("leaf_features=" + "".join(lf).rstrip("\n"))
            lc = []
            for i in range(n):
                if self.leaf_coeff[i]:
                    lc.append(_arr_to_str(
                        [float(c) for c in self.leaf_coeff[i]],
                        high_precision=True) + " ")
                lc.append(" ")
            buf.append("leaf_coeff=" + "".join(lc))
        buf.append("shrinkage=" + _fmt(self.shrinkage))
        buf.append("")
        return "\n".join(buf) + "\n"

    @classmethod
    def from_string(cls, s: str) -> "Tree":
        """Parse one tree block (reference: Tree::Tree(const char*, size_t*),
        src/io/tree.cpp:695)."""
        kv: Dict[str, str] = {}
        for line in s.splitlines():
            line = line.strip()
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k] = v
        n = int(kv["num_leaves"])
        t = cls(n)
        t.num_cat = int(kv.get("num_cat", "0"))
        m = max(n - 1, 0)

        def geta(key: str, dtype, count: int) -> np.ndarray:
            raw = kv.get(key, "")
            vals = raw.split() if raw else []
            if not vals:
                return np.zeros(count, dtype=dtype)
            return np.asarray(vals, dtype=np.float64).astype(dtype)

        t.split_feature = geta("split_feature", np.int32, m)
        t.split_gain = geta("split_gain", np.float32, m)
        t.threshold = geta("threshold", np.float64, m)
        t.decision_type = geta("decision_type", np.int8, m)
        t.left_child = geta("left_child", np.int32, m)
        t.right_child = geta("right_child", np.int32, m)
        t.leaf_value = geta("leaf_value", np.float64, n)
        t.leaf_weight = geta("leaf_weight", np.float64, n)
        t.leaf_count = geta("leaf_count", np.int64, n)
        t.internal_value = geta("internal_value", np.float64, m)
        t.internal_weight = geta("internal_weight", np.float64, m)
        t.internal_count = geta("internal_count", np.int64, m)
        if t.num_cat > 0:
            t.cat_boundaries = geta("cat_boundaries", np.int32, t.num_cat + 1)
            t.cat_threshold = geta(
                "cat_threshold", np.uint32,
                int(t.cat_boundaries[-1]) if len(t.cat_boundaries) else 0)
            # threshold column stores the cat_idx for categorical nodes
            t.threshold_in_bin = t.threshold.astype(np.int32)
        t.is_linear = bool(int(float(kv.get("is_linear", "0"))))
        if t.is_linear:
            t.leaf_const = geta("leaf_const", np.float64, n)
            nf = geta("num_features", np.int64, n)
            feat_toks = kv.get("leaf_features", "").split()
            coef_toks = kv.get("leaf_coeff", "").split()
            t.leaf_features, t.leaf_coeff = [], []
            fpos = cpos = 0
            for i in range(n):
                k = int(nf[i]) if i < len(nf) else 0
                t.leaf_features.append(
                    [int(v) for v in feat_toks[fpos:fpos + k]])
                t.leaf_coeff.append(
                    [float(v) for v in coef_toks[cpos:cpos + k]])
                fpos += k
                cpos += k
        t.shrinkage = float(kv.get("shrinkage", "1"))
        return t

    def to_json(self) -> Dict[str, Any]:
        """reference: Tree::ToJSON (src/io/tree.cpp:418)."""
        out: Dict[str, Any] = {
            "num_leaves": int(self.num_leaves),
            "num_cat": int(self.num_cat),
            "shrinkage": self.shrinkage,
        }
        if self.num_leaves == 1:
            out["tree_structure"] = {"leaf_value": float(self.leaf_value[0])}
        else:
            out["tree_structure"] = self._node_to_json(0)
        return out

    def _node_to_json(self, index: int) -> Dict[str, Any]:
        if index >= 0:
            dt = int(self.decision_type[index])
            is_cat = bool(dt & _CATEGORICAL_MASK)
            node: Dict[str, Any] = {
                "split_index": int(index),
                "split_feature": int(self.split_feature[index]),
                "split_gain": float(self.split_gain[index]),
            }
            if is_cat:
                cat_idx = int(self.threshold_in_bin[index])
                start, end = self.cat_boundaries[cat_idx], self.cat_boundaries[cat_idx + 1]
                cats = []
                for w in range(start, end):
                    bits = int(self.cat_threshold[w])
                    for b in range(32):
                        if bits >> b & 1:
                            cats.append((w - start) * 32 + b)
                node["threshold"] = "||".join(str(c) for c in cats)
                node["decision_type"] = "=="
            else:
                node["threshold"] = float(self.threshold[index])
                node["decision_type"] = "<="
            node["default_left"] = bool(dt & _DEFAULT_LEFT_MASK)
            mt = (dt >> 2) & 3
            node["missing_type"] = {0: "None", 1: "Zero", 2: "NaN"}.get(mt, "None")
            node["internal_value"] = float(self.internal_value[index])
            node["internal_weight"] = float(self.internal_weight[index])
            node["internal_count"] = int(self.internal_count[index])
            node["left_child"] = self._node_to_json(int(self.left_child[index]))
            node["right_child"] = self._node_to_json(int(self.right_child[index]))
            return node
        leaf = ~index
        return {
            "leaf_index": int(leaf),
            "leaf_value": float(self.leaf_value[leaf]),
            "leaf_weight": float(self.leaf_weight[leaf]),
            "leaf_count": int(self.leaf_count[leaf]),
        }


def make_decision_type(is_categorical: bool, default_left: bool,
                       missing_type: int) -> int:
    """Pack the decision_type byte (reference: tree.h SetDecisionType /
    SetMissingType:263-287)."""
    dt = 0
    if is_categorical:
        dt |= _CATEGORICAL_MASK
    if default_left:
        dt |= _DEFAULT_LEFT_MASK
    dt |= (missing_type & 3) << 2
    return dt
