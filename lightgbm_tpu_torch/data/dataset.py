"""Binned dataset construction.

Counterpart of lightgbm_tpu/data/dataset.py (the reference's Dataset /
DatasetLoader / Metadata, include/LightGBM/dataset.h:49-1086): sample rows
-> per-feature BinMapper -> dense binned feature matrix, on its host route.

The binned matrix is ONE dense [num_data, num_features] uint8 (uint16 past
256 bins) host array, `X_binned`, and its feature-major [F, N] uint8 copy
`X_t` on the dataset's torch device, which the kernels consume
(ops/histogram.py). The EFB bundle search runs as in the JAX package; a
dataset it bundles is refused at training time (ROADMAP item A9).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..utils.log import log_fatal, log_info, log_warning
from .binning import (BIN_TYPE_CATEGORICAL, BIN_TYPE_NUMERICAL, BinMapper)


class Metadata:
    """Labels, weights, query boundaries, init scores
    (reference: include/LightGBM/dataset.h:49-134, src/io/metadata.cpp)."""

    def __init__(self, num_data: int):
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None  # [num_queries+1]
        self.init_score: Optional[np.ndarray] = None

    def set_label(self, label: Optional[np.ndarray]) -> None:
        if label is None:
            self.label = None
            return
        label = np.asarray(label, dtype=np.float32).reshape(-1)
        if len(label) != self.num_data:
            log_fatal(f"Length of label ({len(label)}) differs from "
                      f"num_data ({self.num_data})")
        self.label = label

    def set_weight(self, weight: Optional[np.ndarray]) -> None:
        if weight is None:
            self.weight = None
            return
        weight = np.asarray(weight, dtype=np.float32).reshape(-1)
        if len(weight) != self.num_data:
            log_fatal(f"Length of weight ({len(weight)}) differs from "
                      f"num_data ({self.num_data})")
        if np.any(weight < 0):
            log_fatal("Weights should be non-negative")
        self.weight = weight

    def set_group(self, group: Optional[np.ndarray]) -> None:
        """`group` is per-query sizes (reference: Metadata::SetQuery)."""
        if group is None:
            self.query_boundaries = None
            return
        group = np.asarray(group, dtype=np.int64).reshape(-1)
        bounds = np.concatenate([[0], np.cumsum(group)])
        if bounds[-1] != self.num_data:
            log_fatal(f"Sum of query counts ({bounds[-1]}) differs from "
                      f"num_data ({self.num_data})")
        self.query_boundaries = bounds.astype(np.int32)

    def set_init_score(self, init_score: Optional[np.ndarray]) -> None:
        if init_score is None:
            self.init_score = None
            return
        init_score = np.asarray(init_score, dtype=np.float64)
        if init_score.ndim == 1 and len(init_score) % self.num_data != 0:
            log_fatal("init_score length is not a multiple of num_data")
        self.init_score = init_score

    @property
    def num_queries(self) -> int:
        return 0 if self.query_boundaries is None else len(self.query_boundaries) - 1


class BinnedDataset:
    """The constructed (binned) dataset
    (reference: Dataset, include/LightGBM/dataset.h:492).

    Attributes
    ----------
    X_binned : np.ndarray [num_data, num_features] uint8|uint16
        Bin index per (row, inner feature).
    mappers : list[BinMapper], one per *inner* (non-trivial) feature.
    real_feature_index : inner feature -> original column index.
    used_feature_map : original column -> inner feature index or -1.
    """

    def __init__(self) -> None:
        self.num_data: int = 0
        self.num_total_features: int = 0
        self.X_binned: Optional[np.ndarray] = None
        self.mappers: List[BinMapper] = []
        self.real_feature_index: List[int] = []
        self.used_feature_map: List[int] = []
        self.feature_names: List[str] = []
        self.metadata: Optional[Metadata] = None
        self.max_bin: int = 255
        self.reference: Optional["BinnedDataset"] = None
        # EFB (Exclusive Feature Bundling, dataset.cpp:112 FindGroups /
        # :251 FastFeatureBundling): sparse features whose non-default
        # rows never (max_conflict_rate=0) or rarely overlap share one
        # uint8 column. None = no bundling applied.
        self.bundles: Optional[List[List[int]]] = None
        self.X_bundled: Optional[np.ndarray] = None   # [N, F_b] uint8
        self.bundle_col: Optional[List[int]] = None   # inner f -> column
        self.bundle_off: Optional[List[int]] = None   # inner f -> offset,
        #                                               -1 = raw singleton
        # feature-major [F, N] uint8 copy of X_binned on the torch device
        self.X_t: Optional[torch.Tensor] = None
        # bin-width tier permutation (docs/PERF.md): tier_perm[new_inner]
        # = pre-sort inner index. Inner features are stably reordered by
        # histogram lane-width class (<=32/<=64/<=128/<=256 bins) at
        # construction so same-width features are contiguous and
        # ops/histogram_tiered.py can size one kernel per class. None =
        # reorder not applied (old binary caches before re-load).
        self.tier_perm: Optional[List[int]] = None

    # -- derived per-feature arrays consumed by device kernels
    @property
    def num_features(self) -> int:
        return len(self.mappers)

    def feature_num_bins(self) -> np.ndarray:
        return np.array([m.num_bin for m in self.mappers], dtype=np.int32)

    def feature_missing_types(self) -> np.ndarray:
        return np.array([m.missing_type for m in self.mappers], dtype=np.int32)

    def feature_default_bins(self) -> np.ndarray:
        return np.array([m.default_bin for m in self.mappers], dtype=np.int32)

    def feature_is_categorical(self) -> np.ndarray:
        return np.array([m.bin_type == BIN_TYPE_CATEGORICAL
                         for m in self.mappers], dtype=bool)

    def feature_infos(self) -> List[str]:
        infos = []
        for orig in range(self.num_total_features):
            inner = self.used_feature_map[orig]
            infos.append("none" if inner < 0 else self.mappers[inner].feature_info())
        return infos

    @property
    def label(self) -> Optional[np.ndarray]:
        return self.metadata.label if self.metadata else None


def _init_ds(num_data: int, num_cols: int, config: Config,
             feature_names: Optional[Sequence[str]]) -> BinnedDataset:
    ds = BinnedDataset()
    ds.num_data = int(num_data)
    ds.num_total_features = int(num_cols)
    ds.max_bin = config.max_bin
    ds.feature_names = (list(feature_names) if feature_names is not None
                        else [f"Column_{i}" for i in range(num_cols)])
    return ds


def _lane_width(num_bin: int) -> int:
    """Histogram lane-width class of a feature (the JAX package's tier
    order; kept so inner feature indices match it)."""
    for w in (32, 64, 128, 256):
        if num_bin <= w:
            return w
    return 512


def _apply_tier_order(ds: BinnedDataset,
                      reorder_binned: bool = False) -> None:
    """Stably reorder inner features by lane-width class (docs/PERF.md)
    and record the permutation in `ds.tier_perm`.

    Runs BEFORE the binning loop in the normal constructors (columns are
    then binned directly into tier order via `real_feature_index`), so
    only the three mapping tables move; `reorder_binned=True` (binary
    cache load) additionally permutes the already-binned columns. All
    consumers address features through `used_feature_map` /
    `real_feature_index`, so the reorder is invisible outside histogram
    kernel-launch grouping — except that equal-gain split ties, which
    resolve by lowest inner index, can pick a different (equally valid)
    feature on mixed-width datasets."""
    F = len(ds.mappers)
    perm = sorted(range(F),
                  key=lambda f: _lane_width(ds.mappers[f].num_bin))
    ds.tier_perm = perm
    if perm == list(range(F)):
        return
    ds.mappers = [ds.mappers[p] for p in perm]
    ds.real_feature_index = [ds.real_feature_index[p] for p in perm]
    for new_inner, orig in enumerate(ds.real_feature_index):
        ds.used_feature_map[orig] = new_inner
    if reorder_binned and ds.X_binned is not None \
            and ds.X_binned.shape[1] == F:
        ds.X_binned = np.ascontiguousarray(ds.X_binned[:, perm])


def _fit_or_adopt_mappers(ds: BinnedDataset, config: Config,
                          reference: Optional[BinnedDataset],
                          sample_col, n_sample: int,
                          categorical_feature: Sequence[int]) -> None:
    """Bin-mapper construction shared by every constructor: adopt the
    reference's mappers (Dataset::CreateValid, dataset.h:721) or fit one
    per column from `sample_col(j)` (DatasetLoader sampling + binning,
    dataset_loader.cpp:653-707)."""
    if reference is not None:
        ds.mappers = reference.mappers
        ds.real_feature_index = reference.real_feature_index
        ds.used_feature_map = reference.used_feature_map
        ds.tier_perm = reference.tier_perm
        ds.reference = reference
        return
    num_cols = ds.num_total_features
    cat_set = set(int(c) for c in categorical_feature)
    max_bins = list(config.max_bin_by_feature) if config.max_bin_by_feature \
        else [config.max_bin] * num_cols
    ds.mappers, ds.real_feature_index, ds.used_feature_map = [], [], []
    for j in range(num_cols):
        bin_type = (BIN_TYPE_CATEGORICAL if j in cat_set
                    else BIN_TYPE_NUMERICAL)
        m = BinMapper.find_bin(
            sample_col(j), total_sample_cnt=n_sample,
            max_bin=max_bins[j],
            min_data_in_bin=config.min_data_in_bin,
            min_split_data=config.min_data_in_leaf,
            pre_filter=config.feature_pre_filter,
            bin_type=bin_type,
            use_missing=config.use_missing,
            zero_as_missing=config.zero_as_missing)
        if m.is_trivial:
            ds.used_feature_map.append(-1)
        else:
            ds.used_feature_map.append(len(ds.mappers))
            ds.mappers.append(m)
            ds.real_feature_index.append(j)
    if not ds.mappers:
        log_warning("There are no meaningful features which satisfy the "
                    "provided configuration. Decrease min_data_in_bin or "
                    "check the data.")
    _apply_tier_order(ds)


def _alloc_binned(ds: BinnedDataset) -> np.ndarray:
    max_num_bin = max((m.num_bin for m in ds.mappers), default=2)
    dtype = np.uint8 if max_num_bin <= 256 else np.uint16
    return np.zeros((ds.num_data, max(len(ds.mappers), 1)), dtype=dtype)


def _finalize(ds: BinnedDataset, config: Config,
              label, weight, group, init_score,
              reference: Optional[BinnedDataset]) -> BinnedDataset:
    """Metadata attach + the EFB bundle gate, shared by every
    constructor."""
    md = Metadata(ds.num_data)
    md.set_label(label)
    md.set_weight(weight)
    md.set_group(group)
    md.set_init_score(init_score)
    ds.metadata = md
    if (reference is None and config.enable_bundle
            and config.boosting in ("gbdt", "gbrt")
            and config.tpu_grower in ("auto", "wave", "wave_exact")):
        _build_bundles(ds, config)
    return ds


def construct_from_matrix(
    data: np.ndarray,
    config: Config,
    label: Optional[np.ndarray] = None,
    weight: Optional[np.ndarray] = None,
    group: Optional[np.ndarray] = None,
    init_score: Optional[np.ndarray] = None,
    categorical_feature: Sequence[int] = (),
    feature_names: Optional[Sequence[str]] = None,
    reference: Optional[BinnedDataset] = None,
    device: Optional[torch.device] = None,
) -> BinnedDataset:
    """Build a BinnedDataset from a raw [num_data, num_features] matrix
    (reference call stack: DatasetLoader::ConstructFromSampleData,
    src/io/dataset_loader.cpp:653-707 sampling + binning, then row push).

    With `reference` given, reuses its bin mappers so validation data aligns
    bin-for-bin with the training set (reference: Dataset::CreateValid,
    dataset.h:721). `device` receives the feature-major `X_t` copy
    (None: host arrays only).
    """
    data = np.asarray(data)
    if data.ndim != 2:
        log_fatal("Training data must be 2-dimensional")
    num_data, num_cols = data.shape
    ds = _init_ds(num_data, num_cols, config, feature_names)

    # sample rows for binning (bin_construct_sample_cnt rows,
    # dataset_loader.cpp:1162)
    sample_cnt = min(config.bin_construct_sample_cnt, num_data)
    rng = np.random.RandomState(config.data_random_seed)
    if sample_cnt < num_data:
        sample_idx = np.sort(rng.choice(num_data, sample_cnt,
                                        replace=False))
        sample = data[sample_idx]
    else:
        sample = data
    sample = np.asarray(sample, dtype=np.float64)
    _fit_or_adopt_mappers(ds, config, reference,
                          lambda j: sample[:, j], len(sample),
                          categorical_feature)

    # push rows: per-feature vectorized value->bin on the host (the
    # device bucketize kernel is not ported yet; ROADMAP item A13)
    X = _alloc_binned(ds)
    for inner, (m, orig) in enumerate(zip(ds.mappers,
                                          ds.real_feature_index)):
        col = np.asarray(data[:, orig], dtype=np.float64)
        X[:, inner] = m.value_to_bin(col).astype(X.dtype)
    ds.X_binned = X
    if device is not None and X.dtype == np.uint8:
        ds.X_t = torch.from_numpy(np.ascontiguousarray(X.T)).to(device)
    return _finalize(ds, config, label, weight, group, init_score,
                     reference)


def _build_bundles(ds: BinnedDataset, config: Config) -> None:
    """Exclusive Feature Bundling (reference: FindGroups dataset.cpp:112,
    FastFeatureBundling :251): greedily pack features whose non-default
    rows (almost) never overlap into shared uint8 columns. Histogram and
    row-scan work then scales with the number of BUNDLES; per-feature
    histograms are recovered at search time by slicing bundle offsets,
    with the default bin reconstructed via histogram fix-up
    (Dataset::FixHistogram, dataset.h:778)."""
    F = len(ds.mappers)
    N = ds.num_data
    if F <= 1 or N == 0 or ds.X_binned.dtype != np.uint8:
        return
    X = ds.X_binned
    # sample rows for conflict counting (the reference counts on its
    # binning sample)
    s_cnt = min(N, 50_000)
    if s_cnt < N:
        rng = np.random.RandomState(config.data_random_seed)
        srows = np.sort(rng.choice(N, s_cnt, replace=False))
        Xs = X[srows]
    else:
        Xs = X
    db = np.array([m.default_bin for m in ds.mappers], np.int64)
    nb = np.array([m.num_bin for m in ds.mappers], np.int64)
    is_cat = np.array([m.bin_type == BIN_TYPE_CATEGORICAL
                       for m in ds.mappers])
    nondef = Xs != db[None, :]
    nz = nondef.sum(axis=0)
    # reference constants (dataset.cpp:118-121)
    max_search_group = 100
    max_bin_per_group = 256
    max_conflict = s_cnt // 10_000
    order = np.argsort(-nz, kind="stable")
    groups: List[dict] = []
    for f in order:
        f = int(f)
        if is_cat[f] or nb[f] >= max_bin_per_group:
            groups.append(dict(members=[f], mask=None, bins=int(nb[f]),
                               conflicts=0))
            continue
        placed = False
        for g in groups[:max_search_group]:
            if g["mask"] is None:
                continue
            if g["bins"] + int(nb[f]) - 1 > max_bin_per_group:
                continue
            conflict = int(np.count_nonzero(nondef[:, f] & g["mask"]))
            if g["conflicts"] + conflict <= max_conflict:
                g["members"].append(f)
                g["mask"] |= nondef[:, f]
                g["bins"] += int(nb[f]) - 1
                g["conflicts"] += conflict
                placed = True
                break
        if not placed:
            groups.append(dict(members=[f], mask=nondef[:, f].copy(),
                               bins=1 + int(nb[f]) - 1, conflicts=0))
    n_bundled = sum(1 for g in groups if len(g["members"]) > 1)
    if n_bundled == 0:
        return
    # stable-sort bundle columns by histogram lane-width class so the
    # bundled storage keeps the tier-contiguity the inner-feature reorder
    # established (docs/PERF.md); g["bins"] is the column's bin count for
    # singletons and multi-bundles alike
    groups.sort(key=lambda g: _lane_width(g["bins"]))
    bundle_col = np.zeros(F, np.int32)
    bundle_off = np.full(F, -1, np.int32)
    cols = []
    bundles = []
    for ci, g in enumerate(groups):
        members = g["members"]
        bundles.append(list(members))
        if len(members) == 1:
            f = members[0]
            bundle_col[f] = ci
            cols.append(X[:, f])
            continue
        col = np.zeros(N, np.uint8)
        off = 1                       # bundle bin 0 = every member default
        for f in members:
            b = X[:, f].astype(np.int64)
            nd = b != db[f]
            rb = b - (b > db[f])      # compact out the default bin
            col[nd] = (off + rb[nd]).astype(np.uint8)
            bundle_col[f] = ci
            bundle_off[f] = off
            off += int(nb[f]) - 1
        cols.append(col)
    ds.bundles = bundles
    ds.X_bundled = np.ascontiguousarray(np.stack(cols, axis=1))
    ds.bundle_col = bundle_col.tolist()
    ds.bundle_off = bundle_off.tolist()
    log_info(f"EFB: bundled {F} features into {len(groups)} columns "
             f"({n_bundled} multi-feature bundles)")
