"""Feature binning: raw values -> small integer bins.

Faithful reimplementation of the reference BinMapper
(include/LightGBM/bin.h:86-260, src/io/bin.cpp): sampled quantile-style greedy
binning with zero isolated in its own bin, categorical mapping by descending
frequency, and three missing-value modes (None / Zero / NaN).

The hot sequential loops here run on host over *sampled* values only
(bin_construct_sample_cnt rows); the full-data value->bin push is vectorized
NumPy, or the native OpenMP loop (native/loader.cpp) for columns of 65536
values and more, bitwise the same bins.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

from ..models.tree import MISSING_NAN, MISSING_NONE, MISSING_ZERO

K_ZERO_THRESHOLD = 1e-35     # reference: meta.h kZeroThreshold
K_SPARSE_THRESHOLD = 0.7     # reference: bin.h kSparseThreshold

BIN_TYPE_NUMERICAL = 0
BIN_TYPE_CATEGORICAL = 1


# ----------------------------------------------------------------------
# Canonical bin-assignment kernels: the host binning semantics that
# BinMapper.value_to_bin delegates to. They are kept equal to the JAX
# package's (tests/test_torch_binning.py holds the binned matrices
# bitwise equal).
# ----------------------------------------------------------------------
def numeric_value_to_bin(values: np.ndarray, bin_upper_bound: np.ndarray,
                         missing_type: int) -> np.ndarray:
    """Numeric raw f64 values -> bin ids against inclusive upper bounds
    (reference: BinMapper::ValueToBin, bin.h:613-651). ``num_bin`` ==
    ``len(bin_upper_bound)``; under MISSING_NAN the last bound is the
    NaN sentinel and NaN rows take bin ``num_bin - 1``, otherwise NaN
    collapses to the bin of 0.0."""
    values = np.asarray(values, np.float64)
    nan_mask = np.isnan(values)
    num_bin = len(bin_upper_bound)
    v = np.where(nan_mask, 0.0, values)
    if missing_type == MISSING_NAN:
        # searchsorted over upper bounds: first bound >= value -> bin;
        # the NaN sentinel bound (last) is excluded from the search
        bins = np.searchsorted(bin_upper_bound[:-1], v, side="left")
        # value == bound goes in that bin (upper bounds are inclusive)
        bins = np.minimum(bins, num_bin - 2)
        bins = np.where(nan_mask, num_bin - 1, bins)
    else:
        bins = np.searchsorted(bin_upper_bound, v, side="left")
        bins = np.minimum(bins, num_bin - 1)
    return bins.astype(np.int32)


def categorical_to_bin_sentinel(values: np.ndarray, keys: np.ndarray,
                                vals: np.ndarray,
                                num_bin: int) -> np.ndarray:
    """Serving-side categorical raw f64 values -> bin ids with sentinel
    semantics: NaN / negative / unseen categories map to ``num_bin``
    (the per-feature sentinel bin every bin-domain bitset sends right).
    ``keys`` must be sorted int64; ``vals`` the matching bin ids."""
    col = np.asarray(values, np.float64)
    nanm = np.isnan(col)
    valid = ~nanm & (col >= 0)
    iv = np.where(valid, col, 0).astype(np.int64)
    pos = np.clip(np.searchsorted(keys, iv), 0, len(keys) - 1)
    hit = valid & (keys[pos] == iv)
    return np.where(hit, vals[pos], num_bin).astype(np.int64)


def _next_after(x: float) -> float:
    """std::nextafter(x, +inf) (reference: common.h GetDoubleUpperBound:857)."""
    return math.nextafter(x, math.inf)


def _check_double_equal_ordered(a: float, b: float) -> bool:
    """reference: common.h CheckDoubleEqualOrdered:852."""
    return b <= math.nextafter(a, math.inf)


def greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                    max_bin: int, total_cnt: int,
                    min_data_in_bin: int) -> List[float]:
    """Greedy equal-frequency bin boundary search
    (reference: src/io/bin.cpp GreedyFindBin)."""
    num_distinct = len(distinct_values)
    bin_upper_bound: List[float] = []
    assert max_bin > 0
    if num_distinct <= max_bin:
        cur_cnt_inbin = 0
        for i in range(num_distinct - 1):
            cur_cnt_inbin += int(counts[i])
            if cur_cnt_inbin >= min_data_in_bin:
                val = _next_after((distinct_values[i] + distinct_values[i + 1]) / 2.0)
                if not bin_upper_bound or not _check_double_equal_ordered(
                        bin_upper_bound[-1], val):
                    bin_upper_bound.append(val)
                    cur_cnt_inbin = 0
        bin_upper_bound.append(math.inf)
    else:
        if min_data_in_bin > 0:
            max_bin = min(max_bin, total_cnt // min_data_in_bin)
            max_bin = max(max_bin, 1)
        mean_bin_size = total_cnt / max_bin

        rest_bin_cnt = max_bin
        rest_sample_cnt = int(total_cnt)
        is_big = counts >= mean_bin_size
        rest_bin_cnt -= int(np.count_nonzero(is_big))
        rest_sample_cnt -= int(counts[is_big].sum())
        mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)

        upper_bounds = [math.inf] * max_bin
        lower_bounds = [math.inf] * max_bin
        bin_cnt = 0
        lower_bounds[0] = float(distinct_values[0])
        cur_cnt_inbin = 0
        counts_l = counts.tolist()
        values_l = distinct_values.tolist()
        is_big_l = is_big.tolist()
        for i in range(num_distinct - 1):
            if not is_big_l[i]:
                rest_sample_cnt -= counts_l[i]
            cur_cnt_inbin += counts_l[i]
            if (is_big_l[i] or cur_cnt_inbin >= mean_bin_size or
                    (is_big_l[i + 1] and
                     cur_cnt_inbin >= max(1.0, mean_bin_size * 0.5))):
                upper_bounds[bin_cnt] = values_l[i]
                bin_cnt += 1
                lower_bounds[bin_cnt] = values_l[i + 1]
                if bin_cnt >= max_bin - 1:
                    break
                cur_cnt_inbin = 0
                if not is_big_l[i]:
                    rest_bin_cnt -= 1
                    mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
        bin_cnt += 1
        for i in range(bin_cnt - 1):
            val = _next_after((upper_bounds[i] + lower_bounds[i + 1]) / 2.0)
            if not bin_upper_bound or not _check_double_equal_ordered(
                    bin_upper_bound[-1], val):
                bin_upper_bound.append(val)
        bin_upper_bound.append(math.inf)
    return bin_upper_bound


def find_bin_with_zero_as_one_bin(
        distinct_values: np.ndarray, counts: np.ndarray, max_bin: int,
        total_sample_cnt: int, min_data_in_bin: int) -> List[float]:
    """Split the value range into (neg, zero, pos) and bin each side so that
    zero always occupies its own bin (reference: src/io/bin.cpp
    FindBinWithZeroAsOneBin)."""
    neg_mask = distinct_values <= -K_ZERO_THRESHOLD
    pos_mask = distinct_values > K_ZERO_THRESHOLD
    left_cnt_data = int(counts[neg_mask].sum())
    right_cnt_data = int(counts[pos_mask].sum())
    cnt_zero = int(total_sample_cnt) - left_cnt_data - right_cnt_data

    nz = np.flatnonzero(~neg_mask)
    left_cnt = int(nz[0]) if len(nz) else len(distinct_values)

    bin_upper_bound: List[float] = []
    if left_cnt > 0 and max_bin > 1:
        denom = max(total_sample_cnt - cnt_zero, 1)
        left_max_bin = int(left_cnt_data / denom * (max_bin - 1))
        left_max_bin = max(1, left_max_bin)
        bin_upper_bound = greedy_find_bin(
            distinct_values[:left_cnt], counts[:left_cnt], left_max_bin,
            left_cnt_data, min_data_in_bin)
        if bin_upper_bound:
            bin_upper_bound[-1] = -K_ZERO_THRESHOLD

    ps = np.flatnonzero(pos_mask)
    right_start = int(ps[0]) if len(ps) else -1

    if right_start >= 0 and max_bin > len(bin_upper_bound) + 1:
        right_max_bin = max_bin - 1 - len(bin_upper_bound)
        bin_upper_bound.append(K_ZERO_THRESHOLD)
        bin_upper_bound.extend(greedy_find_bin(
            distinct_values[right_start:], counts[right_start:], right_max_bin,
            right_cnt_data, min_data_in_bin))
    else:
        bin_upper_bound.append(math.inf)
    return bin_upper_bound


def _need_filter(cnt_in_bin: List[int], total_cnt: int, filter_cnt: int,
                 bin_type: int) -> bool:
    """reference: src/io/bin.cpp NeedFilter."""
    if bin_type == BIN_TYPE_NUMERICAL:
        sum_left = 0
        for i in range(len(cnt_in_bin) - 1):
            sum_left += cnt_in_bin[i]
            if sum_left >= filter_cnt and total_cnt - sum_left >= filter_cnt:
                return False
        return True
    else:
        if len(cnt_in_bin) <= 2:
            for c in cnt_in_bin:
                if c >= filter_cnt and total_cnt - c >= filter_cnt:
                    return False
            return True
        return False


class BinMapper:
    """Maps raw feature values to integer bins
    (reference: include/LightGBM/bin.h:86)."""

    def __init__(self) -> None:
        self.num_bin: int = 1
        self.missing_type: int = MISSING_NONE
        self.is_trivial: bool = True
        self.sparse_rate: float = 1.0
        self.bin_type: int = BIN_TYPE_NUMERICAL
        self.bin_upper_bound: np.ndarray = np.array([np.inf])
        self.bin_2_categorical: List[int] = []
        self.categorical_2_bin: Dict[int, int] = {}
        self.min_val: float = 0.0
        self.max_val: float = 0.0
        self.default_bin: int = 0
        self.most_freq_bin: int = 0

    # ------------------------------------------------------------------
    @classmethod
    def find_bin(cls, values: np.ndarray, total_sample_cnt: int, max_bin: int,
                 min_data_in_bin: int, min_split_data: int,
                 pre_filter: bool = False,
                 bin_type: int = BIN_TYPE_NUMERICAL,
                 use_missing: bool = True, zero_as_missing: bool = False,
                 forced_upper_bounds: Sequence[float] = ()) -> "BinMapper":
        """Build a mapper from sampled values
        (reference: BinMapper::FindBin, src/io/bin.cpp).

        `values` are the sampled raw values (may contain NaN); zeros may be
        included (unlike the reference's sparse push, which passes non-zero
        values only — the zero count is recovered from totals either way).
        """
        m = cls()
        values = np.asarray(values, dtype=np.float64)
        num_sample_values = len(values)
        nan_mask = np.isnan(values)
        non_na = values[~nan_mask]
        na_cnt = 0
        if not use_missing:
            m.missing_type = MISSING_NONE
        elif zero_as_missing:
            m.missing_type = MISSING_ZERO
        else:
            if len(non_na) == num_sample_values:
                m.missing_type = MISSING_NONE
            else:
                m.missing_type = MISSING_NAN
                na_cnt = num_sample_values - len(non_na)

        # zeros: pulled out and re-inserted as one distinct value whose count
        # is estimated from the total (reference counts zeros implicitly)
        zero_in_sample = int(np.count_nonzero(np.abs(non_na) <= K_ZERO_THRESHOLD))
        nonzero = non_na[np.abs(non_na) > K_ZERO_THRESHOLD]
        zero_cnt = int(total_sample_cnt - len(nonzero) - na_cnt)

        sv = np.sort(nonzero)
        if len(sv):
            # merge near-equal neighbours (CheckDoubleEqualOrdered): since
            # values are exact doubles here, plain unique is equivalent
            distinct, counts = np.unique(sv, return_counts=True)
        else:
            distinct = np.empty(0)
            counts = np.empty(0, dtype=np.int64)

        # insert zero at its ordered position with its estimated count
        pos = int(np.searchsorted(distinct, 0.0))
        if zero_cnt > 0 or len(distinct) == 0:
            distinct = np.insert(distinct, pos, 0.0)
            counts = np.insert(counts, pos, zero_cnt)

        if len(distinct) == 0:
            return m
        m.min_val = float(distinct[0])
        m.max_val = float(distinct[-1])
        m.bin_type = bin_type

        cnt_in_bin: List[int] = []
        if bin_type == BIN_TYPE_NUMERICAL:
            if m.missing_type == MISSING_NAN:
                ub = find_bin_with_zero_as_one_bin(
                    distinct, counts, max_bin - 1, total_sample_cnt - na_cnt,
                    min_data_in_bin)
                ub.append(math.nan)
            else:
                ub = find_bin_with_zero_as_one_bin(
                    distinct, counts, max_bin, total_sample_cnt,
                    min_data_in_bin)
                if m.missing_type == MISSING_ZERO and len(ub) == 2:
                    m.missing_type = MISSING_NONE
            m.bin_upper_bound = np.asarray(ub, dtype=np.float64)
            m.num_bin = len(ub)
            # count per bin
            cnt_in_bin = [0] * m.num_bin
            i_bin = 0
            for dv, c in zip(distinct.tolist(), counts.tolist()):
                while i_bin < m.num_bin - 1 and dv > m.bin_upper_bound[i_bin]:
                    i_bin += 1
                cnt_in_bin[i_bin] += int(c)
            if m.missing_type == MISSING_NAN:
                cnt_in_bin[m.num_bin - 1] = na_cnt
        else:
            # categorical (reference: FindBin categorical branch)
            di = distinct.astype(np.int64)
            neg = di < 0
            na_cnt += int(counts[neg].sum())
            di2, ci2 = di[~neg], counts[~neg].astype(np.int64)
            # aggregate duplicated int casts
            agg: Dict[int, int] = {}
            for v, c in zip(di2.tolist(), ci2.tolist()):
                agg[v] = agg.get(v, 0) + c
            rest_cnt = int(total_sample_cnt - na_cnt)
            if rest_cnt > 0:
                items = sorted(agg.items(), key=lambda kv: (-kv[1], kv[0]))
                cut_cnt = int(round((total_sample_cnt - na_cnt) * 0.99))
                distinct_cnt = len(items) + (1 if na_cnt > 0 else 0)
                eff_max_bin = min(distinct_cnt, max_bin)
                m.bin_2_categorical = [-1]
                m.categorical_2_bin = {-1: 0}
                cnt_in_bin = [0]
                m.num_bin = 1
                used_cnt = 0
                for idx, (val, c) in enumerate(items):
                    if not (used_cnt < cut_cnt or m.num_bin < eff_max_bin):
                        break
                    if c < min_data_in_bin and idx > 1:
                        break
                    m.bin_2_categorical.append(int(val))
                    m.categorical_2_bin[int(val)] = m.num_bin
                    used_cnt += c
                    cnt_in_bin.append(c)
                    m.num_bin += 1
                if m.num_bin - 1 == len(items) and na_cnt == 0:
                    m.missing_type = MISSING_NONE
                else:
                    m.missing_type = MISSING_NAN
                cnt_in_bin[0] = int(total_sample_cnt - used_cnt)

        m.is_trivial = m.num_bin <= 1
        if not m.is_trivial and pre_filter and _need_filter(
                cnt_in_bin, int(total_sample_cnt), min_split_data, bin_type):
            m.is_trivial = True
        if not m.is_trivial:
            m.default_bin = int(m.value_to_bin(np.array([0.0]))[0])
            m.most_freq_bin = int(np.argmax(cnt_in_bin))
            max_sparse_rate = cnt_in_bin[m.most_freq_bin] / total_sample_cnt
            if (m.most_freq_bin != m.default_bin
                    and max_sparse_rate < K_SPARSE_THRESHOLD):
                m.most_freq_bin = m.default_bin
            m.sparse_rate = cnt_in_bin[m.most_freq_bin] / total_sample_cnt
        else:
            m.sparse_rate = 1.0
        return m

    # ------------------------------------------------------------------
    def value_to_bin(self, values: np.ndarray) -> np.ndarray:
        """Vectorized raw value -> bin id
        (reference: BinMapper::ValueToBin, bin.h:613-651)."""
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == BIN_TYPE_CATEGORICAL:
            out = np.zeros(len(values), dtype=np.int32)
            iv = np.where(np.isnan(values), -1, values).astype(np.int64)
            keys = np.array(sorted(self.categorical_2_bin), dtype=np.int64)
            vals = np.array([self.categorical_2_bin[k] for k in keys.tolist()],
                            dtype=np.int32)
            pos = np.searchsorted(keys, iv)
            pos = np.clip(pos, 0, len(keys) - 1)
            hit = keys[pos] == iv
            out = np.where(hit, vals[pos], 0).astype(np.int32)
            return out
        bins = self._native_value_to_bin(values)
        if bins is not None:
            return bins
        return numeric_value_to_bin(values, self.bin_upper_bound,
                                    self.missing_type)

    def _native_value_to_bin(self, values: np.ndarray):
        """The OpenMP value->bin of native/loader.cpp for large numeric
        columns (JAX binning.py:389-418; the ingestion-side ValueToBin
        loop, bin.h:613), bitwise `numeric_value_to_bin`; None, for the
        NumPy path, under 65536 values, past 256 bins or without the
        library."""
        if len(values) < 65536 or self.num_bin > 256:
            return None
        from .. import native
        if self.missing_type == MISSING_NAN:
            ub = self.bin_upper_bound[:-1]
            nan_bin = self.num_bin - 1
        else:
            ub = self.bin_upper_bound
            # NaN takes the bin of 0.0 (the NumPy path's where(nan, 0.0, v))
            nan_bin = int(min(np.searchsorted(ub, 0.0, side="left"),
                              self.num_bin - 1))
        out = native.value_to_bin(values, ub, nan_bin)
        return None if out is None else out.astype(np.int32)

    def bin_to_value(self, bin_idx: int) -> float:
        """Real-valued threshold for a bin (the model file stores bin upper
        bounds; reference: Dataset::RealThreshold)."""
        if self.bin_type == BIN_TYPE_CATEGORICAL:
            return float(self.bin_2_categorical[bin_idx])
        return float(self.bin_upper_bound[bin_idx])

    def feature_info(self) -> str:
        """String for the model header's feature_infos field
        (reference: Dataset::GetFeatureInfos / dataset.cpp)."""
        if self.is_trivial:
            return "none"
        if self.bin_type == BIN_TYPE_CATEGORICAL:
            return ":".join(str(c) for c in self.bin_2_categorical[1:])
        return f"[{self.min_val:g}:{self.max_val:g}]"

    # serialization for dataset binary cache / distributed allgather
    def to_dict(self) -> dict:
        return {
            "num_bin": self.num_bin,
            "missing_type": self.missing_type,
            "is_trivial": self.is_trivial,
            "sparse_rate": self.sparse_rate,
            "bin_type": self.bin_type,
            "bin_upper_bound": self.bin_upper_bound.tolist(),
            "bin_2_categorical": list(self.bin_2_categorical),
            "min_val": self.min_val,
            "max_val": self.max_val,
            "default_bin": self.default_bin,
            "most_freq_bin": self.most_freq_bin,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BinMapper":
        m = cls()
        m.num_bin = int(d["num_bin"])
        m.missing_type = int(d["missing_type"])
        m.is_trivial = bool(d["is_trivial"])
        m.sparse_rate = float(d["sparse_rate"])
        m.bin_type = int(d["bin_type"])
        m.bin_upper_bound = np.asarray(d["bin_upper_bound"], dtype=np.float64)
        m.bin_2_categorical = [int(x) for x in d["bin_2_categorical"]]
        m.categorical_2_bin = {c: i for i, c in enumerate(m.bin_2_categorical)}
        m.min_val = float(d["min_val"])
        m.max_val = float(d["max_val"])
        m.default_bin = int(d["default_bin"])
        m.most_freq_bin = int(d["most_freq_bin"])
        return m
