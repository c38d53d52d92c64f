"""The exporter: freeze a trained model into a standalone artifact.

Counterpart of lightgbm_tpu/export/compile.py. The reference's
``Application::ConvertModel`` (src/application/application.cpp:289) emits
standalone if-else C++ so a model serves with no LightGBM runtime at all;
this is that idea for the card. ``export_model`` specializes the
binned-domain walk (ops/predict_binned.py) to ONE frozen forest with
``torch.export``: the packed tree arrays are folded into the program as
constants, the walk is unrolled to the model's depth, and there is one
program per padded batch bucket (the serving ladder, fixed at export
time). It writes an artifact directory that ``export/runtime.py``'s
:class:`CompiledModel` scores from without importing the port's
``models``, ``engine`` or ``basic``.

The JAX package writes StableHLO (``jax.export``); the port cannot, so its
artifact is a format of its own (``runtime.FORMAT``): each bucket is a
``torch.export.save``d program. ``bucket_<b>.pt2`` maps uint8 bins ``[b,
F]`` to the f32 margins (bitwise ``engine="binned"``) and the int64 leaf
indices (which the loader accumulates against the artifact's f64 leaf
table: bitwise ``Booster.predict``); ``bin_score_<b>.pt2`` takes raw f32
rows and bins them with the plain torch bucketize (``ops/bucketize.py
bin_block_plain``), no custom kernel, as the JAX artifact carries the XLA
lowering and no Pallas call (lightgbm_tpu/export/compile.py:129-156). That
program serves the CPU; on a card :func:`load_compiled` attaches the
bucketize kernel (#6) to the loaded model, which bins raw f32 rows from the
artifact's ``serve_table.npz`` before ``bucket_<b>.pt2``.

Programs are exported on the CPU and moved to the device that loads them
(``runtime.load_program``). ``roundtrip_binned_scorer`` is the in-process
flavor behind ``ServingSession(engine="compiled")``: the same export,
saved to bytes and loaded back, so every compiled-engine score transits
the bytes a converted model would ship.
"""

from __future__ import annotations

import io
import json
import os
from typing import Callable, List, Optional

import numpy as np
import torch

from ..models.predictor import format_tree_indices, linear_tree_indices
from ..ops.bucketize import bin_block_plain
from ..ops.predict import sum_leaf_values
from ..ops.predict_binned import (BinnedDeviceArrays, build_binned_model,
                                  mappers_for, predict_leaves_binned)
from ..runtime.checkpoint import atomic_write_bytes, atomic_write_text
from ..utils.log import log_info
from .runtime import (BIN_TABLE, FORMAT, MANIFEST, SERVE_TABLE,
                      CompiledModel, bucket_for, file_sha256, load_program,
                      program_file)

# transform names the standalone runtime replays in f64 numpy, bitwise each
# objective's convert_output (objectives/__init__.py)
_TRANSFORMS = {
    "binary": "sigmoid",
    "multiclassova": "sigmoid",
    "cross_entropy": "sigmoid",       # sigmoid with slope 1.0
    "multiclass": "softmax",
    "poisson": "exp",
    "gamma": "exp",
    "tweedie": "exp",
    "cross_entropy_lambda": "log1p_exp",
}

_CPU = torch.device("cpu")


def _load_gbdt(model):
    from ..serving.registry import _load_gbdt
    return _load_gbdt(model)


def _check_no_linear_trees(trees, what: str) -> None:
    linear = linear_tree_indices(trees)
    if linear:
        raise ValueError(
            f"{what} is not supported for linear trees: "
            f"{format_tree_indices(linear)} carry fitted linear leaf "
            f"functions of RAW feature values, which the binned domain "
            f"cannot represent; retrain with linear_tree=false")


def _objective_transform(gbdt) -> tuple:
    obj = getattr(gbdt, "objective", None)
    if obj is None or not getattr(obj, "need_convert_output", False):
        return "identity", 0.0
    name = getattr(obj, "name", "custom")
    t = _TRANSFORMS.get(name)
    if t is None:
        # still exportable: raw margins are exact; only the transformed
        # predict path refuses, loudly, in the standalone loader
        return f"unsupported:{name}", 0.0
    sig = float(getattr(obj.config, "sigmoid", 1.0)) \
        if t == "sigmoid" and name != "cross_entropy" else 1.0
    return t, sig


def _bucket_ladder(min_bucket: int, max_batch: int) -> List[int]:
    max_batch = 1 << max(int(max_batch) - 1, 0).bit_length()
    b = bucket_for(1, max(int(min_bucket), 1), max_batch)
    ladder = []
    while b <= max_batch:
        ladder.append(b)
        b *= 2
    return ladder


class _WalkProgram(torch.nn.Module):
    """The binned walk of one frozen forest as a module whose buffers are
    the forest (and, for raw f32 input, the bin table): what
    ``torch.export`` folds into a bucket's program."""

    def __init__(self, pa: BinnedDeviceArrays, K: int, with_leaves: bool,
                 table=None) -> None:
        super().__init__()
        self._static = {f: getattr(pa, f) for f in pa._fields
                        if not isinstance(getattr(pa, f), torch.Tensor)}
        self._tensors = [f for f in pa._fields if f not in self._static]
        for f in self._tensors:
            self.register_buffer(f, getattr(pa, f))
        self.K = K
        self.with_leaves = with_leaves
        self.raw = table is not None
        if self.raw:
            self.register_buffer("bin_table", table.table)
            self.register_buffer("bin_cat_val", table.cat_val)
            self.register_buffer("bin_meta", table.meta)

    def forward(self, X: torch.Tensor):
        pa = BinnedDeviceArrays(**{f: getattr(self, f) for f in self._tensors},
                                **self._static)
        if self.raw:
            X = bin_block_plain(X[:, :self.bin_table.shape[0]],
                                self.bin_table, self.bin_cat_val,
                                self.bin_meta)
        gl = predict_leaves_binned(pa, X)
        margins = sum_leaf_values(pa.leaf_value[gl], self.K)
        return (margins, gl) if self.with_leaves else margins


def _export_bucket(bm, K: int, bucket: int, with_leaves: bool,
                   table=None):
    """``torch.export`` of the binned walk specialized to one bucket shape,
    on the CPU, the forest folded in as constants; `table` (a serve-mode
    DeviceBinTable) makes it take raw f32 rows."""
    tt = None
    if table is not None:
        from ..ops.bucketize import upload_bin_table
        tt = upload_bin_table(table, _CPU)
    mod = _WalkProgram(bm.device_arrays(_CPU), K, with_leaves, tt)
    dtype = torch.float32 if table is not None else torch.uint8
    example = torch.zeros((bucket, bm.num_features), dtype=dtype)
    return torch.export.export(mod, (example,), strict=False)


def _program_bytes(ep) -> bytes:
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def _roundtrip(ep, device) -> Callable:
    return load_program(io.BytesIO(_program_bytes(ep)), device)


def roundtrip_binned_scorer(bm, K: int, bucket: int,
                            device: torch.device = _CPU) -> Callable:
    """Export -> save to bytes -> load on `device` one bucket's program, as
    ``engine="compiled"`` makes each bucket's (serving/session.py): uint8
    [bucket, F] bins -> [K, bucket] f32 margins; every score transits the
    bytes an artifact would ship."""
    return _roundtrip(_export_bucket(bm, K, bucket, with_leaves=False),
                      device)


def roundtrip_raw_scorer(bm, table, K: int, bucket: int,
                         device: torch.device = _CPU) -> Callable:
    """The raw-f32 flavor of :func:`roundtrip_binned_scorer`: one bucket's
    plain bucketize + walk, exported, saved and loaded back; f32 [bucket,
    F] raw rows -> [K, bucket] margins."""
    return _roundtrip(_export_bucket(bm, K, bucket, with_leaves=False,
                                     table=table), device)


def _bin_table_arrays(bm) -> dict:
    """The frozen BinMapper bin-edge tables, flattened into plain numpy
    arrays the standalone runtime's :class:`~.runtime.BinTable` rebuilds
    its searchsorted binning from."""
    from ..data.binning import BIN_TYPE_CATEGORICAL
    num_feats, num_missing, num_bounds, num_offsets = [], [], [], [0]
    cat_feats, cat_num_bin, cat_keys, cat_vals, cat_offsets = \
        [], [], [], [], [0]
    for f in bm.used_features:
        mp = bm._mappers[f]
        if mp.bin_type == BIN_TYPE_CATEGORICAL:
            keys = sorted(mp.categorical_2_bin)
            cat_feats.append(f)
            cat_num_bin.append(int(mp.num_bin))
            cat_keys.extend(int(k) for k in keys)
            cat_vals.extend(int(mp.categorical_2_bin[k]) for k in keys)
            cat_offsets.append(len(cat_keys))
        else:
            num_feats.append(f)
            num_missing.append(int(mp.missing_type))
            num_bounds.extend(np.asarray(mp.bin_upper_bound,
                                         np.float64).tolist())
            num_offsets.append(len(num_bounds))
    return dict(
        num_features=np.int64(bm.num_features),
        num_feats=np.asarray(num_feats, np.int64),
        num_missing=np.asarray(num_missing, np.int64),
        num_bounds=np.asarray(num_bounds, np.float64),
        num_offsets=np.asarray(num_offsets, np.int64),
        cat_feats=np.asarray(cat_feats, np.int64),
        cat_num_bin=np.asarray(cat_num_bin, np.int64),
        cat_keys=np.asarray(cat_keys, np.int64),
        cat_vals=np.asarray(cat_vals, np.int64),
        cat_offsets=np.asarray(cat_offsets, np.int64),
        leaf_value=np.asarray(bm.leaf_value, np.float64),
    )


def export_model(model, out_dir: str, *, bin_mappers: Optional[List] = None,
                 max_batch: int = 256, min_bucket: int = 8,
                 start_iteration: int = 0, num_iteration: int = -1) -> dict:
    """Freeze `model` (Booster / GBDT / model text / path) into a
    standalone artifact at `out_dir`; returns the manifest.

    Raises ``ValueError`` for linear trees (naming the offending tree
    indices) and ``BinnedUnavailable`` when no frozen BinMappers are
    available (models loaded from text: pass ``bin_mappers=``, e.g.
    re-derived from the training data, as cli.py run_convert_model
    does)."""
    gbdt = _load_gbdt(model)
    _check_no_linear_trees(gbdt.models, "convert_model to torch_export")
    K = gbdt.num_tree_per_iteration
    total_iters = len(gbdt.models) // max(K, 1)
    end = total_iters if num_iteration <= 0 else min(
        total_iters, start_iteration + num_iteration)
    start = min(start_iteration, total_iters)
    pm = gbdt._packed_model(start, max(end, start))
    derived = mappers_for(gbdt)
    bm = build_binned_model(
        pm, derived if derived is not None else bin_mappers)
    transform, sigmoid = _objective_transform(gbdt)
    ladder = _bucket_ladder(min_bucket, max_batch)

    os.makedirs(out_dir, exist_ok=True)
    files = {}

    def _write(name: str, data: bytes) -> None:
        atomic_write_bytes(os.path.join(out_dir, name), data)
        files[name] = file_sha256(os.path.join(out_dir, name))

    buf = io.BytesIO()
    np.savez(buf, **_bin_table_arrays(bm))
    _write(BIN_TABLE, buf.getvalue())
    for b in ladder:
        _write(program_file("bucket", b), _program_bytes(
            _export_bucket(bm, K, b, with_leaves=True)))

    # the bin_and_score entry: when the mappers pack into a serve-mode bin
    # table, each bucket also ships a raw-f32 program, so compiled serving
    # consumes raw f32 with no host binning stage
    bin_and_score = False
    from ..ops.bucketize import BinningUnavailable, pack_bin_table
    try:
        table = pack_bin_table(bm._mappers, mode="serve",
                               num_features=bm.num_features,
                               used_features=bm.used_features)
        for b in ladder:
            _write(program_file("bin_score", b), _program_bytes(
                _export_bucket(bm, K, b, with_leaves=True, table=table)))
        buf = io.BytesIO()
        np.savez(buf, table=table.table, cat_val=table.cat_val,
                 meta=table.meta, num_features=np.int64(table.num_features),
                 B=np.int64(table.B))
        _write(SERVE_TABLE, buf.getvalue())
        bin_and_score = True
    except BinningUnavailable as e:
        log_info(f"export: bin_and_score entry point skipped ({e}); "
                 "artifact serves uint8 bins only")

    manifest = {
        "format": FORMAT,
        "K": int(K),
        "T": int(bm.T),
        "num_features": int(bm.num_features),
        "buckets": ladder,
        "min_bucket": int(ladder[0]),
        "max_batch": int(ladder[-1]),
        "avg_div": int(max(end, start) - start) if gbdt.average_output
                   else 0,
        "transform": transform,
        "sigmoid": sigmoid,
        "num_trees": int(bm.T),
        "bin_and_score": bin_and_score,
        "torch_version": torch.__version__,
        "files": files,
    }
    # manifest LAST (atomic): a partially written artifact never loads
    atomic_write_text(os.path.join(out_dir, MANIFEST),
                      json.dumps(manifest, indent=2, sort_keys=True))
    log_info(f"exported model artifact to {out_dir} (buckets={ladder}, "
             f"{len(files)} payload files)")
    return manifest


def attach_bucketize(cm: CompiledModel) -> CompiledModel:
    """Bin `cm`'s raw f32 rows with ``ops/bucketize.py bucketize_rows`` on
    its device (its ``kernel`` route): the bucketize kernel (#6) on a CUDA
    device, built here rather than on a request, which raises if it cannot
    be built; its plain version on the CPU. Bins from the artifact's
    serve-mode table, then the bucket's uint8 program scores them."""
    from ..ops import histogram_cuda as hc
    from ..ops.bucketize import (DeviceBinTable, bucketize_rows,
                                 upload_bin_table)
    a = cm.serve_table()
    dev = torch.device(cm.device)
    t = upload_bin_table(DeviceBinTable(
        table=a["table"], cat_val=a["cat_val"], meta=a["meta"],
        num_features=int(a["num_features"]), B=int(a["B"]), mode="serve"),
        dev)
    if dev.type == "cuda":
        hc._lib("bucketize")
    cm.binner = lambda X: bucketize_rows(X, t)
    return cm


def load_compiled(path: str, verify: bool = True,
                  device="cuda") -> CompiledModel:
    """``runtime.load_compiled`` with the bucketize kernel attached
    (:func:`attach_bucketize`) where `device` is a CUDA device and the
    artifact takes raw f32 rows, so the card bins them with #6."""
    cm = CompiledModel.load(path, verify=verify, device=device)
    if torch.device(device).type == "cuda" and cm.bin_and_score:
        attach_bucketize(cm)
    return cm
