"""Binned-domain predictor: score uint8 bin indices, not floats.

Counterpart of lightgbm_tpu/ops/predict_binned.py. A numerical split
stores ``threshold = bin_upper_bound[t_bin]``, and ``BinMapper.value_to_bin``
assigns ``bin(v) <= t_bin  <=>  v <= bin_upper_bound[t_bin]`` exactly. So
an engine that bins each incoming row ONCE through the frozen mappers and
then compares uint8 bin ids against bin-mapped thresholds routes every row
like the f64 host walk, and like the f32 device walk of
``ops/predict.py`` (whose floored thresholds are routing-exact too).

Missing handling mirrors the training-time walk: ``MISSING_ZERO`` rows are
the ones in the zero bin (``default_bin``), ``MISSING_NAN`` rows sit in the
NaN bin (``num_bin - 1``). Categorical splits translate the raw category
bitset into a BIN-domain bitset (bit b <- raw bit at
``bin_2_categorical[b]``); NaN / negative / unseen raw values, which the
raw walk sends right, are binned to a per-feature SENTINEL bin one past
the real bins, whose bitset bit is never set.

``BinnedUnavailable`` (a ``ValueError``) marks models this engine cannot
serve: linear leaves, a split feature without a frozen mapper (models
loaded from text carry none; pass them explicitly), or bin counts that
overflow uint8.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..models.tree import (MISSING_NAN, MISSING_ZERO, _CATEGORICAL_MASK,
                           _DEFAULT_LEFT_MASK)
from .predict import sum_leaf_values

# uint8 bin storage: numerical features need num_bin ids, categorical
# features need one extra id for the unseen/invalid sentinel
_MAX_NUM_BINS = 256
_MAX_CAT_BINS = 255


class BinnedUnavailable(ValueError):
    """The binned engine cannot serve this model (see message)."""


def mappers_for(gbdt) -> Optional[List]:
    """Per-ORIGINAL-feature BinMapper list of a GBDT that carries its
    mappers (trained in process, or built by ``convert.booster_from_state``):
    ``gbdt.mappers`` is inner-indexed and ``real_feature_index`` maps inner
    -> original. None when the model was loaded from text."""
    mappers = getattr(gbdt, "mappers", None)
    real_idx = getattr(gbdt, "real_feature_index", None)
    if not mappers or real_idx is None:
        return None
    out: List = [None] * (gbdt.max_feature_idx_ + 1)
    for inner, orig in enumerate(real_idx):
        if inner < len(mappers) and 0 <= orig < len(out):
            out[orig] = mappers[inner]
    return out


class BinnedDeviceArrays(NamedTuple):
    """Bin-domain packed-tree arrays on one device (int64 indices, the
    uint32 bitset words in int64). `num_cat` and `W` are Python ints;
    `depth` is the walk's step count."""
    node_start: torch.Tensor      # [T]
    leaf_start: torch.Tensor      # [T]
    split_feature: torch.Tensor   # [M]
    threshold_bin: torch.Tensor   # [M] bin id of the split upper bound
    missing_bin: torch.Tensor     # [M] (-1 = no missing handling)
    default_left: torch.Tensor    # [M] bool
    left_child: torch.Tensor      # [M] (negative = ~leaf)
    right_child: torch.Tensor     # [M]
    leaf_value: torch.Tensor      # [L] f32
    single_leaf: torch.Tensor     # [T] bool
    is_cat: torch.Tensor          # [M] bool
    cat_bitset: torch.Tensor      # [M, W] bin-domain bitsets
    num_cat: int
    W: int
    depth: int


def predict_leaves_binned(pa: BinnedDeviceArrays,
                          Xb: torch.Tensor) -> torch.Tensor:
    """[n, T] int64 ABSOLUTE leaf indices (into the flat ``leaf_value``)
    for Xb [n, F] uint8 bin ids: the lockstep walk, exactly ``pa.depth``
    steps (the JAX package's ``while_loop`` over ``any(node >= 0)``)."""
    n = Xb.shape[0]
    T = pa.node_start.shape[0]
    Xi = Xb.to(torch.int64)
    node = torch.where(pa.single_leaf, -1, 0).to(torch.int64) \
        .expand(n, T).contiguous()
    for _ in range(pa.depth):
        g = node.clamp(min=0) + pa.node_start[None, :]        # [n, T]
        bv = torch.gather(Xi, 1, pa.split_feature[g])
        is_missing = bv == pa.missing_bin[g]
        go_left = torch.where(is_missing, pa.default_left[g],
                              bv <= pa.threshold_bin[g])
        if pa.num_cat > 0:
            words = pa.cat_bitset[g, (bv >> 5).clamp(0, pa.W - 1)]
            gl_cat = ((words >> (bv & 31)) & 1) == 1
            go_left = torch.where(pa.is_cat[g], gl_cat, go_left)
        nxt = torch.where(go_left, pa.left_child[g], pa.right_child[g])
        node = torch.where(node >= 0, nxt, node)
    return pa.leaf_start[None, :] + ~node


def predict_margin_binned(pa: BinnedDeviceArrays, Xb: torch.Tensor,
                          K: int) -> torch.Tensor:
    """[K, n] f32 margins for Xb [n, F] uint8 bin ids. The leaf values are
    summed by ``ops/predict.py sum_leaf_values``, as in the raw walk, so
    the margins are bitwise those of ``predict_margin_packed`` whenever
    the two reach the same leaves (always, for f32 queries)."""
    gl = predict_leaves_binned(pa, Xb)
    return sum_leaf_values(pa.leaf_value[gl], K)


class BinnedModel:
    """Bin-domain twin of a PackedModel: built once per model version from
    the packed arrays + the frozen per-feature BinMappers, then reused for
    every request (bin the rows, walk on bins). Construction raises
    :class:`BinnedUnavailable` for anything it cannot translate exactly."""

    def __init__(self, pm, mappers: List) -> None:
        if getattr(pm, "has_linear", False):
            raise BinnedUnavailable(
                "binned engine does not support linear leaves")
        self.K = pm.K
        self.T = pm.T
        self.num_features = len(mappers)
        self._mappers = mappers
        M = int(pm.node_start[-1])
        self.node_start = pm.node_start
        self.leaf_start = pm.leaf_start
        self.split_feature = pm.split_feature
        self.left_child = pm.left_child
        self.right_child = pm.right_child
        self.leaf_value = pm.leaf_value            # f64, shared
        self.single_leaf = pm.single_leaf
        # the walk's step count, fixed when the model is built
        self.max_depth = pm.max_depth
        self.threshold_bin = np.zeros(M, np.int32)
        self.missing_bin = np.full(M, -1, np.int32)
        dt = pm.decision_type.astype(np.int32)
        self.default_left = (dt & _DEFAULT_LEFT_MASK) != 0
        self.is_cat = (dt & _CATEGORICAL_MASK) != 0
        self.num_cat = int(pm.num_cat)

        # real (visited) node slots: single-leaf trees carry one dummy
        # zeroed node that no row ever reaches
        real = np.zeros(M, bool)
        for t in range(pm.T):
            m = int(pm.leaf_start[t + 1] - pm.leaf_start[t]) - 1
            a = int(pm.node_start[t])
            real[a:a + m] = True

        self.used_features = sorted(
            {int(f) for f in pm.split_feature[real]})
        from ..data.binning import BIN_TYPE_CATEGORICAL
        for f in self.used_features:
            mp = mappers[f] if f < len(mappers) else None
            if mp is None:
                raise BinnedUnavailable(
                    f"no frozen BinMapper for split feature {f} (models "
                    f"loaded from text carry no mappers; pass "
                    f"bin_mappers= explicitly)")
            if getattr(mp, "is_trivial", False):
                raise BinnedUnavailable(
                    f"BinMapper for split feature {f} is trivial — "
                    f"mappers do not match this model")
            cap = (_MAX_CAT_BINS if mp.bin_type == BIN_TYPE_CATEGORICAL
                   else _MAX_NUM_BINS)
            if mp.num_bin > cap:
                raise BinnedUnavailable(
                    f"feature {f} has {mp.num_bin} bins; uint8 binned "
                    f"storage caps at {cap}")

        # W covers every feature's sentinel bin (num_bin for categorical
        # features) so the sentinel's bitset word exists and is zero
        self.W = 1
        mt = (dt >> 2) & 3
        tree_of = np.repeat(np.arange(pm.T),
                            np.diff(pm.node_start).astype(np.int64))
        for i in np.nonzero(real)[0]:
            f = int(pm.split_feature[i])
            mp = mappers[f]
            if self.is_cat[i]:
                self._check_cat_node(pm, int(i), int(tree_of[i]), mp)
                self.W = max(self.W, (int(mp.num_bin) + 1 + 31) // 32)
                continue
            t_bin = int(mp.value_to_bin(
                np.array([pm.threshold[i]], np.float64))[0])
            self.threshold_bin[i] = t_bin
            if mt[i] == MISSING_ZERO:
                self.missing_bin[i] = int(mp.default_bin)
            elif mt[i] == MISSING_NAN:
                self.missing_bin[i] = int(mp.num_bin) - 1

        self.cat_bitset = np.zeros((M, self.W), np.uint32) \
            if self.num_cat > 0 else np.zeros((M, 1), np.uint32)
        if self.num_cat > 0:
            for i in np.nonzero(real & self.is_cat)[0]:
                mp = mappers[int(pm.split_feature[i])]
                self.cat_bitset[i] = self._cat_node_bitset(
                    pm, int(i), int(tree_of[i]), mp)
        self._device_arrays = {}

    # ------------------------------------------------------------------
    @staticmethod
    def _raw_words(pm, node: int, tree: int) -> np.ndarray:
        """The node's raw-category bitset words (PackedModel layout:
        per-tree cat_start/word_start offsets into the concatenations)."""
        ci = int(pm.cat_start[tree] + pm.threshold_in_bin[node])
        a = int(pm.cat_boundaries[ci])
        b = int(pm.cat_boundaries[ci + 1])
        w0 = int(pm.word_start[tree])
        return np.asarray(pm.cat_threshold[w0 + a:w0 + b], np.uint32)

    def _check_cat_node(self, pm, node: int, tree: int, mp) -> None:
        """Every raw category the node sends LEFT must be a mapper-known
        category, else binning loses the distinction (an unseen category
        must go right, and does via the sentinel bin)."""
        words = self._raw_words(pm, node, tree)
        for w, word in enumerate(words.tolist()):
            bit = 0
            while word:
                if word & 1:
                    c = w * 32 + bit
                    if c not in mp.categorical_2_bin:
                        raise BinnedUnavailable(
                            f"categorical split sends unseen category "
                            f"{c} left; mappers do not match this model")
                word >>= 1
                bit += 1

    def _cat_node_bitset(self, pm, node: int, tree: int, mp) -> np.ndarray:
        """Bin-domain bitset: bit b set iff the raw bitset sends
        ``bin_2_categorical[b]`` left. The sentinel bin (num_bin) stays
        clear."""
        words = self._raw_words(pm, node, tree)
        out = np.zeros(self.W, np.uint32)
        size = len(words)
        for b, c in enumerate(mp.bin_2_categorical):
            if 0 <= c < size * 32 and (words[c >> 5] >> (c & 31)) & 1:
                out[b >> 5] |= np.uint32(1) << np.uint32(b & 31)
        return out

    # ------------------------------------------------------------------
    def bin_rows(self, X: np.ndarray) -> np.ndarray:
        """[n, F] raw f64 -> [n, F] uint8 bin ids through the frozen
        mappers on the host (only split-used features are binned; others
        stay 0). Categorical NaN / negative / unseen values map to the
        per-feature sentinel bin (num_bin)."""
        from ..data.binning import (BIN_TYPE_CATEGORICAL,
                                    categorical_to_bin_sentinel)
        n = X.shape[0]
        out = np.zeros((n, self.num_features), np.uint8)
        for f in self.used_features:
            mp = self._mappers[f]
            col = np.asarray(X[:, f], np.float64)
            if mp.bin_type == BIN_TYPE_CATEGORICAL:
                keys = np.array(sorted(mp.categorical_2_bin), np.int64)
                vals = np.array(
                    [mp.categorical_2_bin[k] for k in keys.tolist()],
                    np.int64)
                out[:, f] = categorical_to_bin_sentinel(
                    col, keys, vals, mp.num_bin).astype(np.uint8)
            else:
                out[:, f] = mp.value_to_bin(col).astype(np.uint8)
        return out

    # ------------------------------------------------------------------
    def _leaves(self, Xb: np.ndarray) -> np.ndarray:
        """Leaf VALUE matrix [n, T] (f64): the host lockstep walk on
        bins."""
        n = Xb.shape[0]
        rows = np.arange(n)
        Xi = Xb.astype(np.int32)
        node = np.where(self.single_leaf[None, :], -1, 0).astype(np.int32) \
            * np.ones((n, 1), np.int32)
        ns = self.node_start
        for _ in range(self.max_depth):
            g = np.maximum(node, 0) + ns[:-1][None, :]
            f = self.split_feature[g]
            bv = Xi[rows[:, None], f]
            is_missing = bv == self.missing_bin[g]
            go_left = np.where(is_missing, self.default_left[g],
                               bv <= self.threshold_bin[g])
            if self.num_cat > 0:
                widx = np.clip(bv >> 5, 0, self.W - 1)
                words = self.cat_bitset[g, widx]
                gl_cat = ((words >> (bv & 31).astype(np.uint32)) & 1) == 1
                go_left = np.where(self.is_cat[g], gl_cat, go_left)
            nxt = np.where(go_left, self.left_child[g],
                           self.right_child[g])
            node = np.where(node >= 0, nxt, node)
        gl = self.leaf_start[:-1][None, :] + ~node
        return self.leaf_value[gl]

    def predict_margin(self, Xb: np.ndarray,
                       chunk: int = 8192) -> np.ndarray:
        """[K, N] f64 margins from binned rows: identical leaves and the
        identical f64 reshape-sum as ``PackedModel.predict_margin``, so
        bitwise equal to the host raw walk."""
        N = Xb.shape[0]
        K = self.K
        n_iters = self.T // K
        out = np.zeros((K, N), np.float64)
        for c0 in range(0, N, chunk):
            c1 = min(c0 + chunk, N)
            lv = self._leaves(Xb[c0:c1])
            out[:, c0:c1] = lv.reshape(c1 - c0, n_iters, K).sum(axis=1).T
        return out

    # ------------------------------------------------------------------
    def device_arrays(self, device: torch.device) -> BinnedDeviceArrays:
        """The arrays on `device`, uploaded ONCE per model version and
        device."""
        device = torch.device(device)
        cached = self._device_arrays.get(device)
        if cached is not None:
            return cached

        def i64(a):
            return torch.as_tensor(np.asarray(a, np.int64)).to(device)
        pa = BinnedDeviceArrays(
            node_start=i64(self.node_start[:-1]),
            leaf_start=i64(self.leaf_start[:-1]),
            split_feature=i64(self.split_feature),
            threshold_bin=i64(self.threshold_bin),
            missing_bin=i64(self.missing_bin),
            default_left=torch.from_numpy(self.default_left).to(device),
            left_child=i64(self.left_child),
            right_child=i64(self.right_child),
            leaf_value=torch.from_numpy(
                self.leaf_value.astype(np.float32)).to(device),
            single_leaf=torch.from_numpy(self.single_leaf).to(device),
            is_cat=torch.from_numpy(self.is_cat).to(device),
            cat_bitset=i64(self.cat_bitset),
            num_cat=int(self.num_cat),
            W=int(self.W),
            depth=int(self.max_depth),
        )
        self._device_arrays[device] = pa
        return pa


def build_binned_model(pm, mappers: Optional[List]) -> BinnedModel:
    """BinnedModel or :class:`BinnedUnavailable` (mappers=None when the
    model has no frozen mappers)."""
    if mappers is None:
        raise BinnedUnavailable(
            "model carries no frozen BinMappers (loaded from text?); "
            "pass bin_mappers= to the serving session")
    return BinnedModel(pm, mappers)
