"""Distributed (pre-partitioned) bin-mapper construction.

Counterpart of lightgbm_tpu/data/dist_binning.py (the reference's
DatasetLoader::ConstructBinMappersFromTextData distributed branch,
src/io/dataset_loader.cpp:741): with pre-partitioned data every rank
samples ITS OWN rows, bins a disjoint FEATURE SLICE from that local sample,
serializes its mappers, and all-gathers them, so every rank ends up with
the identical full mapper set. Bin boundaries are rank-local-sample
approximations of the global quantiles, as the reference's are. The gather
is `DistContext.all_gather` of the f64 rows, put on the context's device,
over the already-initialized process group (parallel/distributed.py).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..utils.log import log_fatal, log_info
from .binning import BIN_TYPE_NUMERICAL, BinMapper

# fixed-size wire row per mapper (the gather needs uniform shapes — the
# array encoding of BinMapper.to_dict / from_dict, numeric features only):
# [num_bin, missing_type, default_bin, most_freq_bin, is_trivial,
#  min_val, max_val, sparse_rate, <num_bin upper bounds>]
_HDR = 8


def _serialize(m: BinMapper, max_bin: int) -> np.ndarray:
    d = m.to_dict()
    row = np.full(_HDR + max_bin, np.nan, np.float64)
    row[0] = d["num_bin"]
    row[1] = d["missing_type"]
    row[2] = d["default_bin"]
    row[3] = d["most_freq_bin"]
    row[4] = 1.0 if d["is_trivial"] else 0.0
    row[5] = d["min_val"]
    row[6] = d["max_val"]
    row[7] = d["sparse_rate"]
    ub = np.asarray(d["bin_upper_bound"], np.float64)
    row[_HDR:_HDR + len(ub)] = ub
    return row


def _deserialize(row: np.ndarray) -> BinMapper:
    num_bin = int(row[0])
    return BinMapper.from_dict({
        "num_bin": num_bin,
        "missing_type": int(row[1]),
        "default_bin": int(row[2]),
        "most_freq_bin": int(row[3]),
        "is_trivial": bool(row[4] > 0.5),
        "min_val": float(row[5]),
        "max_val": float(row[6]),
        "sparse_rate": float(row[7]),
        "bin_type": BIN_TYPE_NUMERICAL,
        "bin_upper_bound": row[_HDR:_HDR + num_bin].tolist(),
        "bin_2_categorical": [],
    })


def distributed_find_mappers(sample: np.ndarray, total_local_rows: int,
                             config, categorical_cols) -> List[BinMapper]:
    """Feature-sliced mapper construction + all-gather merge. `sample` is
    THIS rank's row sample [S, F_total]; returns the full, rank-identical
    mapper list (one per ORIGINAL column). Without a process group (one
    process) this rank bins every feature, as the JAX package's single
    process does."""
    from ..parallel.context import DistContext, world
    nproc, rank, _ = world()
    F = sample.shape[1]
    if categorical_cols:
        log_fatal("pre_partition does not support categorical features "
                  "yet (rank-local category maps cannot be merged)")
    lo = rank * F // nproc
    hi = (rank + 1) * F // nproc
    max_bins = (list(config.max_bin_by_feature)
                if config.max_bin_by_feature
                else [config.max_bin] * F)
    max_bin = max(max_bins)
    rows = np.zeros((F, _HDR + max_bin), np.float64)
    for j in range(lo, hi):
        m = BinMapper.find_bin(
            sample[:, j], total_local_rows, max_bins[j],
            config.min_data_in_bin, config.min_data_in_leaf,
            pre_filter=config.feature_pre_filter,
            use_missing=config.use_missing,
            zero_as_missing=config.zero_as_missing)
        rows[j] = _serialize(m, max_bin)
    gathered = rows[None]
    if nproc > 1:
        ctx = DistContext()
        gathered = ctx.all_gather(torch.from_numpy(rows).to(ctx.device),
                                  tiled=False).cpu().numpy()
    # merge: feature j belongs to the rank whose slice contains it
    merged = np.zeros_like(rows)
    for r in range(nproc):
        rlo, rhi = r * F // nproc, (r + 1) * F // nproc
        merged[rlo:rhi] = gathered[r][rlo:rhi]
    mappers = [_deserialize(merged[j]) for j in range(F)]
    log_info(f"Distributed binning: rank {rank} binned features "
             f"[{lo}, {hi}) of {F}; mappers allgathered over "
             f"{nproc} ranks")
    return mappers
