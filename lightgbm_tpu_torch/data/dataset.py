"""Binned dataset construction.

Counterpart of lightgbm_tpu/data/dataset.py (the reference's Dataset /
DatasetLoader / Metadata, include/LightGBM/dataset.h:49-1086): sample rows
-> per-feature BinMapper -> dense binned feature matrix, from a dense
matrix, a scipy sparse matrix (one column at a time, never densified),
Sequence sources (two rounds, batch by batch) or a binary cache.

The binned matrix is ONE dense [num_data, num_features] uint8 (uint16 past
256 bins) host array, `X_binned`, and its feature-major [F, N] uint8 copy
`X_t` on the dataset's torch device, which the kernels consume
(ops/histogram.py). Rows are binned on one of two routes, recorded in
`binning_route`: "device" (f32 input bucketized by ops/bucketize.py, the
kernel on a CUDA device) or "host" (the per-feature
`BinMapper.value_to_bin` loop). The EFB bundle search runs as in the JAX
package, on the host copy of the bins (both routes keep one); a bundled
dataset also holds `X_bundled` [N, F_b], which training sends to the card
once in place of `X_t`.
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
        # "device" | "host": how the rows were binned (construct_from_matrix)
        self.binning_route: str = "host"
        # the binning probe's decision under autotune with
        # binning_impl=auto (runtime/autotune.py), else None
        self.binning_decision: Optional[dict] = None
        # raw feature values, kept only when config.linear_tree needs them
        # at fit time (the reference keeps its Dataset's raw data the same
        # way, linear_tree_learner.cpp raw_index), whatever free_raw_data
        self.raw_data: Optional[np.ndarray] = None

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

    def storage_num_bins(self) -> List[int]:
        """Per-STORAGE-COLUMN bin counts in storage order: an EFB bundle
        column counts its packed width (1 shared default bin + each
        member's non-default bins), a raw column its mapper's width
        (lightgbm_tpu/data/dataset.py:192)."""
        if self.bundles is not None:
            return [int(self.mappers[members[0]].num_bin)
                    if len(members) == 1
                    else 1 + sum(int(self.mappers[f].num_bin) - 1
                                 for f in members)
                    for members in self.bundles]
        return [int(m.num_bin) for m in self.mappers]

    def feature_infos(self) -> List[str]:
        infos = []
        for orig in range(self.num_total_features):
            inner = self.used_feature_map[orig]
            infos.append("none" if inner < 0 else self.mappers[inner].feature_info())
        return infos

    def schema_signature(self) -> str:
        """sha256 of the binning schema: the column count, `max_bin`, and
        each column's name and bin layout (`feature_infos`), the JAX
        package's digest (data/dataset.py:178-190). The online loop's
        checkpoint guard compares it: a checkpoint taken under other
        mappers is never resumed."""
        import hashlib
        h = hashlib.sha256()
        h.update(f"{self.num_total_features}|{self.max_bin}".encode())
        for name, info in zip(self.feature_names, self.feature_infos()):
            h.update(f"|{name}:{info}".encode())
        return h.hexdigest()

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
    if config.pre_partition and config.num_machines > 1:
        # pre-partitioned multi-rank data: each rank bins a FEATURE SLICE
        # from its local sample, mappers all-gathered so every rank holds
        # the identical set (dataset_loader.cpp:741; JAX dataset.py:383-400)
        from .dist_binning import distributed_find_mappers
        sample_mat = np.column_stack(
            [np.asarray(sample_col(j), np.float64)
             for j in range(num_cols)])
        mappers = distributed_find_mappers(sample_mat, n_sample, config,
                                           sorted(cat_set))
        ds.mappers, ds.real_feature_index, ds.used_feature_map = [], [], []
        for j, m in enumerate(mappers):
            if m.is_trivial:
                ds.used_feature_map.append(-1)
            else:
                ds.used_feature_map.append(len(ds.mappers))
                ds.mappers.append(m)
                ds.real_feature_index.append(j)
        _apply_tier_order(ds)
        return
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


def ingest_bin_table(ds: BinnedDataset, config: Config,
                     device: Optional[torch.device], n_rows: int = 0):
    """Device-ingest gate: resolve ``binning_impl`` for `device` (under
    autotune, "auto" by the binning probe of runtime/autotune.py, cached
    under the `n_rows` shape key; JAX dataset.py:438-470) and pack the
    train-mode bin table over ``ds.mappers``; None keeps the host
    ``value_to_bin`` loop. An explicit "device" whose table cannot be
    packed raises; "auto" falls back to the host route and says so."""
    from ..ops.bucketize import (BinningUnavailable, pack_bin_table,
                                 resolve_binning_impl)
    if not ds.mappers or device is None:
        return None
    impl = None
    if config.binning_impl == "auto" and config.autotune:
        from ..runtime.autotune import autotune_binning_decision
        decision = autotune_binning_decision(
            ds.mappers, n_rows=n_rows, n_features=len(ds.mappers),
            max_bin=config.max_bin, num_leaves=config.num_leaves,
            cache_path=config.autotune_cache, seed=int(config.seed or 0),
            device=device)
        impl = decision.get("binning_impl")
        if impl:
            log_info(f"autotune: binning probe picked binning_impl='{impl}'")
        ds.binning_decision = decision
    if impl is None:
        impl = resolve_binning_impl(config.binning_impl, device)
    if impl != "device":
        return None
    try:
        return pack_bin_table(ds.mappers, mode="train")
    except BinningUnavailable as e:
        if config.binning_impl == "device":
            raise
        log_warning(f"device binning unavailable ({e}); binning_impl=auto "
                    "bins this dataset on the host route")
        return None


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

    # push rows: the bucketize kernel when the raw matrix is f32 and the
    # mapper set packs (bit-identical to the host loop); per-feature
    # vectorized value->bin on the host otherwise
    table = None
    if data.dtype == np.float32:
        table = ingest_bin_table(ds, config, device, num_data)
    elif config.binning_impl == "device":
        raise ValueError(
            f"binning_impl=device bins float32 input; this matrix is "
            f"{data.dtype} (binning it in f32 could round away precision "
            f"the host route keeps)")
    elif device is not None and device.type == "cuda":
        log_info(f"binning_impl=auto: {data.dtype} input bins on the host "
                 "route")
    if table is not None:
        from ..ops.bucketize import bin_rows_device
        ds.X_t = bin_rows_device(data, table, device,
                                 cols=ds.real_feature_index)
        # _finalize's bundle search and the metadata read the host copy:
        # one device-to-host copy of the binned matrix
        X = ds.X_t.t().cpu().numpy()
        ds.binning_route = "device"
    else:
        X = _alloc_binned(ds)
        for inner, (m, orig) in enumerate(zip(ds.mappers,
                                              ds.real_feature_index)):
            col = np.asarray(data[:, orig], dtype=np.float64)
            X[:, inner] = m.value_to_bin(col).astype(X.dtype)
    ds.X_binned = X
    if table is None:
        _to_device(ds, device)
    if config.linear_tree:
        ds.raw_data = np.ascontiguousarray(data, dtype=np.float32)
    return _finalize(ds, config, label, weight, group, init_score,
                     reference)


def _to_device(ds: BinnedDataset, device: Optional[torch.device]) -> None:
    """The feature-major `X_t` copy of a host-binned matrix on `device`,
    as the matrix path's host route makes it: uint8, or uint16 past 256
    bins (`_alloc_binned`)."""
    if device is not None:
        ds.X_t = torch.from_numpy(
            np.ascontiguousarray(ds.X_binned.T)).to(device)


def construct_from_sequences(
    seqs,
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
    """Out-of-core two-round construction from Sequence sources (JAX
    data/dataset.py:554-622; the reference's Sequence, basic.py:841, and
    its two-round loader, dataset_loader.cpp:1162-1213): round one samples
    bin_construct_sample_cnt rows with RandomState(data_random_seed) in
    batches of the first source's `batch_size`, round two streams batches
    through `value_to_bin` on the host. Peak memory is the binned matrix
    plus one raw batch. With `reference` its mappers are adopted."""
    lens = [len(s) for s in seqs]
    num_data = int(sum(lens))
    if num_data == 0:
        log_fatal("Sequence sources are empty")
    probe = np.asarray(seqs[0][0:1], dtype=np.float64)
    ds = _init_ds(num_data, probe.shape[1], config, feature_names)
    starts = np.concatenate([[0], np.cumsum(lens)])
    b = getattr(seqs[0], "batch_size", None) or 65536

    def fetch(global_lo, global_hi):
        """Rows [global_lo, global_hi) across the concatenated sources."""
        parts = []
        for si, s in enumerate(seqs):
            lo = max(global_lo, starts[si])
            hi = min(global_hi, starts[si + 1])
            if lo < hi:
                parts.append(np.asarray(
                    s[int(lo - starts[si]):int(hi - starts[si])],
                    dtype=np.float64))
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    if reference is None:
        sample_cnt = min(config.bin_construct_sample_cnt, num_data)
        rng = np.random.RandomState(config.data_random_seed)
        idx = np.sort(rng.choice(num_data, sample_cnt, replace=False)) \
            if sample_cnt < num_data else np.arange(num_data)
        chunks = []
        for lo in range(0, num_data, b):
            sel = idx[(idx >= lo) & (idx < lo + b)]
            if sel.size:
                batch = fetch(lo, min(lo + b, num_data))
                chunks.append(batch[sel - lo])
        sample = np.concatenate(chunks)
    else:
        sample = probe
    _fit_or_adopt_mappers(ds, config, reference,
                          lambda j: sample[:, j], len(sample),
                          categorical_feature)
    X = _alloc_binned(ds)
    for lo in range(0, num_data, b):
        hi = min(lo + b, num_data)
        batch = fetch(lo, hi)
        for inner, (m, orig) in enumerate(
                zip(ds.mappers, ds.real_feature_index)):
            X[lo:hi, inner] = m.value_to_bin(batch[:, orig]).astype(X.dtype)
    ds.X_binned = X
    _to_device(ds, device)
    return _finalize(ds, config, label, weight, group, init_score,
                     reference)


def construct_from_sparse(
    data,
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
    """Build from a scipy CSR / CSC matrix without densifying it (JAX
    data/dataset.py:625-666): the sample rows and then each raw column
    are materialized one column at a time from CSC on the host (absent
    entries are 0, the reference's sparse semantics, sparse_bin.hpp) and
    binned by `value_to_bin`; the binned matrix reaches the device as the
    matrix path's host route sends it. No raw rows are kept, so
    linear_tree refuses such a Dataset at training time."""
    num_data, num_cols = data.shape
    ds = _init_ds(num_data, num_cols, config, feature_names)
    csc = data.tocsc()
    if reference is None:
        sample_cnt = min(config.bin_construct_sample_cnt, num_data)
        rng = np.random.RandomState(config.data_random_seed)
        idx = np.sort(rng.choice(num_data, sample_cnt, replace=False)) \
            if sample_cnt < num_data else np.arange(num_data)
        sample = data.tocsr()[idx].tocsc()
        n_sample = len(idx)
    else:
        sample, n_sample = None, 0
    _fit_or_adopt_mappers(
        ds, config, reference,
        lambda j: np.asarray(sample[:, j].todense(), np.float64).ravel(),
        n_sample, categorical_feature)
    X = _alloc_binned(ds)
    for inner, (m, orig) in enumerate(zip(ds.mappers,
                                          ds.real_feature_index)):
        col = np.asarray(csc[:, orig].todense(), np.float64).ravel()
        X[:, inner] = m.value_to_bin(col).astype(X.dtype)
    ds.X_binned = X
    _to_device(ds, device)
    return _finalize(ds, config, label, weight, group, init_score,
                     reference)


def load_binary_file(path: str, config: Config,
                     device: Optional[torch.device] = None
                     ) -> BinnedDataset:
    """Load a binary dataset cache that Dataset.save_binary wrote, in this
    package or the JAX one (the same npz keys; JAX data/dataset.py:
    668-703; DatasetLoader::LoadFromBinFile, dataset_loader.h:53): no
    sampling or binning, the mappers ride in the file. The tier order is
    applied again (the identity on a tier-ordered cache) and the EFB
    search runs under the grower condition of the matrix path."""
    import json
    z = np.load(path, allow_pickle=False)
    ds = BinnedDataset()
    ds.X_binned = z["X_binned"]
    ds.num_data = int(ds.X_binned.shape[0])
    ds.mappers = [BinMapper.from_dict(d)
                  for d in json.loads(str(z["mappers"]))]
    ds.real_feature_index = [int(v) for v in z["real_feature_index"]]
    ds.used_feature_map = [int(v) for v in z["used_feature_map"]]
    ds.feature_names = json.loads(str(z["feature_names"]))
    ds.num_total_features = int(z["num_total_features"])
    ds.max_bin = config.max_bin
    md = Metadata(ds.num_data)
    if z["label"].size:
        md.set_label(z["label"])
    if z["weight"].size:
        md.set_weight(z["weight"])
    if z["query_boundaries"].size:
        md.query_boundaries = np.asarray(z["query_boundaries"], np.int64)
    if "init_score" in z.files and z["init_score"].size:
        md.set_init_score(z["init_score"])
    ds.metadata = md
    _apply_tier_order(ds, reorder_binned=True)
    _to_device(ds, device)
    if (config.enable_bundle and config.boosting in ("gbdt", "gbrt")
            and config.tpu_grower in ("auto", "wave", "wave_exact")):
        _build_bundles(ds, config)
    return ds


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
