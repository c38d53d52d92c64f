"""Dataset and Booster: the user-facing classes.

Counterpart of lightgbm_tpu/basic.py (the reference python package's
basic.py: Dataset:1692, Booster:3495). Dataset keeps the lazy-construction
semantics: raw data is held until `construct()` bins it, against an
optional reference dataset so validation bins align. The binned matrix
goes to the device named by the `device_type` parameter ("cuda" by
default, "cpu" on request).
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .config import Config, resolve_params
from .data.dataset import (BinnedDataset, Metadata, construct_from_matrix,
                           construct_from_sequences, construct_from_sparse,
                           load_binary_file)
from .data.loader import load_text_file
from .metrics import Metric, create_metric, default_metric_for_objective
from .models import create_boosting
from .models.gbdt import GBDT, _not_ported, check_slice_config
from .models.linear import fit_linear_models
from .models.predictor import format_tree_indices, linear_tree_indices
from .objectives import create_objective
from .runtime.checkpoint import atomic_write_text
from .utils import indexable_bins, resolve_device
from .utils.log import log_fatal, log_warning


def _is_arrow(data: Any) -> bool:
    return type(data).__module__.startswith("pyarrow")


def _is_scipy_sparse(data: Any) -> bool:
    return type(data).__module__.startswith("scipy.sparse")


def _arrow_to_numpy(data: Any) -> np.ndarray:
    """Arrow Table / RecordBatch / Array -> float64 matrix (JAX basic.py:
    39-56; the reference's Arrow ingestion, include/LightGBM/arrow.h:50),
    one column at a time."""
    import pyarrow as pa
    if isinstance(data, pa.RecordBatch):
        data = pa.Table.from_batches([data])
    if isinstance(data, pa.Table):
        cols = [np.asarray(c.to_numpy(zero_copy_only=False), np.float64)
                for c in data.columns]
        return np.column_stack(cols) if cols else np.zeros((0, 0))
    if isinstance(data, (pa.Array, pa.ChunkedArray)):
        return np.asarray(data.to_numpy(zero_copy_only=False),
                          np.float64).reshape(-1, 1)
    raise TypeError(f"Unsupported pyarrow input type {type(data)}")


def _to_1d_numpy(v: Any) -> np.ndarray:
    """Label / weight / group / init_score, Arrow arrays included
    (Metadata's Arrow setters, dataset.h:49-134)."""
    if _is_arrow(v):
        return _arrow_to_numpy(v).reshape(-1)
    return np.asarray(v).reshape(-1)


def _to_2d_numpy(data: Any) -> np.ndarray:
    if _is_arrow(data):
        return _arrow_to_numpy(data)
    if _is_scipy_sparse(data):
        # prediction-sized batches; a Dataset takes sparse input through
        # construct_from_sparse and never densifies it
        return np.asarray(data.todense())
    if hasattr(data, "values"):   # pandas DataFrame
        data = data.values
    arr = np.asarray(data)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    return arr


_EARLY_STOP_KEYS = ("pred_early_stop", "pred_early_stop_freq",
                    "pred_early_stop_margin")


class Sequence:
    """Out-of-core row source (JAX basic.py:82-100; reference basic.py:841).
    Subclass with ``__len__()`` (the number of rows) and
    ``__getitem__(idx)`` (a row for an int, a 2-D batch for a slice), and
    optionally set ``batch_size``, the rows fetched per binning batch.
    Pass one (or a list of them, concatenated in order) as
    ``Dataset(data=...)``: construction samples rows for the bin mappers,
    then bins batch by batch, and never holds the whole raw matrix."""

    batch_size: int = 65536

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx):
        raise NotImplementedError


class Dataset:
    """Dataset container (reference: basic.py:1692)."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List[int]] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = copy.deepcopy(params) if params else {}
        self.free_raw_data = free_raw_data
        self._handle: Optional[BinnedDataset] = None

    def construct(self) -> "Dataset":
        """Bin the data (JAX basic.py:126-262): a path loads a binary cache
        (the npz magic) or a text file (CSV / TSV / LibSVM, through the
        native parser; `header`, `label_column`, `weight_column`,
        `group_column` and `ignore_column` from the params, the feature
        names from the header), whose rows are then binned as a matrix;
        Sequence sources, a scipy sparse matrix, an Arrow table or any 2-D
        array each take their constructor."""
        if self._handle is not None:
            return self
        cfg = resolve_params(self.params)
        device = resolve_device(cfg.device_type)
        if isinstance(self.data, (str, os.PathLike)):
            path = os.fspath(self.data)
            with open(path, "rb") as f:
                magic = f.read(4)
            if magic[:2] == b"PK":
                return self._construct_from_binary(path, cfg, device)
            self._load_text(path, cfg)
        seqs = None
        if isinstance(self.data, Sequence):
            seqs = [self.data]
        elif isinstance(self.data, (list, tuple)) and self.data \
                and all(isinstance(s, Sequence) for s in self.data):
            seqs = list(self.data)
        sparse = _is_scipy_sparse(self.data)
        if seqs is not None or sparse:
            feature_names = (list(self.feature_name)
                             if isinstance(self.feature_name, list)
                             else None)
            build, data = ((construct_from_sequences, seqs)
                           if seqs is not None
                           else (construct_from_sparse, self.data))
        else:
            data = _to_2d_numpy(self.data)
            feature_names = None
            if isinstance(self.feature_name, list):
                feature_names = list(self.feature_name)
            elif _is_arrow(self.data) and hasattr(self.data,
                                                  "column_names"):
                feature_names = list(self.data.column_names)
            elif hasattr(self.data, "columns") and not _is_arrow(self.data):
                feature_names = [str(c) for c in self.data.columns]
            build = construct_from_matrix
        ref_handle = None
        if self.reference is not None:
            self.reference.construct()
            ref_handle = self.reference._handle

        def vec(v):
            return None if v is None else _to_1d_numpy(v)

        self._handle = build(
            data, cfg, label=vec(self.label), weight=vec(self.weight),
            group=vec(self.group), init_score=vec(self.init_score),
            categorical_feature=self._cat_indices(feature_names),
            feature_names=feature_names, reference=ref_handle,
            device=device)
        if self.free_raw_data:
            self.data = None
        return self

    def _load_text(self, path: str, cfg: Config) -> None:
        """A text file's rows become this Dataset's data, and its label,
        weight, group and header names fill what was not given here (JAX
        basic.py:169-196)."""
        if cfg.two_round:
            # the reference's two_round trades a second file pass for
            # lower peak memory (dataset_loader.cpp); this loader parses
            # in one pass with no extra copy, so the flag changes nothing
            log_warning("two_round is accepted for compatibility; the "
                        "loader parses in one pass and results are "
                        "identical")
        X, y, w, g, names = load_text_file(
            path, has_header=cfg.header, label_column=cfg.label_column,
            weight_column=cfg.weight_column, group_column=cfg.group_column,
            ignore_column=cfg.ignore_column)
        self.data = X
        if self.label is None and y is not None:
            self.label = y
        if self.weight is None and w is not None:
            self.weight = w
        if self.group is None and g is not None:
            self.group = g
        if self.feature_name == "auto" and names:
            self.feature_name = names

    def _construct_from_binary(self, path: str, cfg: Config,
                               device) -> "Dataset":
        """A binary cache (npz / zip magic) with its own mappers, which a
        `reference` must equal (its raw rows are gone, so they cannot be
        binned again; Dataset::CheckAlign), and the metadata given here
        over the cached (JAX basic.py:131-168)."""
        self._handle = load_binary_file(path, cfg, device)
        if self.reference is not None:
            self.reference.construct()
            rh = self.reference._handle
            ours = [m.to_dict() for m in self._handle.mappers]
            refs = [m.to_dict() for m in rh.mappers]
            if ours != refs:
                log_fatal(
                    f"binary dataset {path} was saved with bin mappers that "
                    "differ from the reference dataset's; rebuild the cache "
                    "from a Dataset constructed with reference=...")
            self._handle.reference = rh
        md = self._handle.metadata
        for setter, val in ((md.set_label, self.label),
                            (md.set_weight, self.weight),
                            (md.set_group, self.group)):
            if val is not None:
                setter(np.asarray(val))
        if self.init_score is not None:
            md.set_init_score(_to_1d_numpy(self.init_score))
        if self.free_raw_data:
            self.data = None
        return self

    def _cat_indices(self, feature_names: Optional[List[str]]) -> List[int]:
        """Column indices of `categorical_feature`: indices, names of
        `feature_names`, or a comma-separated string; "auto" (there is no
        pandas category dtype here) and None mean none (JAX basic.py:266)."""
        cats = self.categorical_feature
        if cats == "auto" or cats is None:
            return []
        if isinstance(cats, str):
            return [int(c) for c in cats.split(",") if c]
        out: List[int] = []
        for c in cats:
            if isinstance(c, str):
                if feature_names and c in feature_names:
                    out.append(feature_names.index(c))
            else:
                out.append(int(c))
        return out

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        """reference: basic.py Dataset.create_valid."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params if params is not None else self.params)

    def num_data(self) -> int:
        self.construct()
        return self._handle.num_data

    def num_feature(self) -> int:
        self.construct()
        return self._handle.num_total_features

    def get_label(self) -> Optional[np.ndarray]:
        if self._handle is not None:
            return self._handle.metadata.label
        return None if self.label is None else np.asarray(self.label)

    def get_weight(self) -> Optional[np.ndarray]:
        if self._handle is not None:
            return self._handle.metadata.weight
        return None if self.weight is None else np.asarray(self.weight)

    def get_group(self) -> Optional[np.ndarray]:
        """Query sizes (the metadata's boundaries differenced)."""
        if self._handle is not None \
                and self._handle.metadata.query_boundaries is not None:
            return np.diff(self._handle.metadata.query_boundaries)
        return None if self.group is None else np.asarray(self.group)

    def get_init_score(self):
        return self.init_score

    def get_feature_name(self) -> List[str]:
        self.construct()
        return list(self._handle.feature_names)

    # the setters change the constructed metadata too (JAX basic.py:
    # 343-369); a booster already built keeps the copies it took
    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._handle is not None:
            self._handle.metadata.set_label(
                None if label is None else np.asarray(label))
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._handle is not None:
            self._handle.metadata.set_weight(
                None if weight is None else np.asarray(weight))
        return self

    def set_group(self, group) -> "Dataset":
        self.group = group
        if self._handle is not None:
            self._handle.metadata.set_group(
                None if group is None else np.asarray(group))
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._handle is not None:
            self._handle.metadata.set_init_score(
                None if init_score is None else np.asarray(init_score))
        return self

    def subset(self, used_indices, params=None) -> "Dataset":
        """A Dataset of the rows `used_indices` that shares this one's bin
        mappers: the bins are taken, not recomputed (JAX basic.py:371-421;
        Dataset::CopySubrow, dataset.h:674), on the host and, where this
        one has them on a device, there too. Query boundaries survive a
        subset of whole queries in order, and are dropped with a warning
        otherwise."""
        self.construct()
        h = self._handle
        idx = np.asarray(used_indices, np.int64)
        sub = Dataset(None, params=(params if params is not None
                                    else self.params),
                      free_raw_data=self.free_raw_data)
        nh = BinnedDataset()
        nh.num_data = int(len(idx))
        nh.num_total_features = h.num_total_features
        nh.mappers = h.mappers
        nh.real_feature_index = h.real_feature_index
        nh.used_feature_map = h.used_feature_map
        nh.feature_names = list(h.feature_names)
        nh.max_bin = h.max_bin
        nh.reference = h
        nh.X_binned = h.X_binned[idx]
        if h.X_t is not None:
            nh.X_t = indexable_bins(h.X_t)[:, torch.from_numpy(idx).to(
                h.X_t.device)].view(h.X_t.dtype)
        md = Metadata(nh.num_data)
        if h.metadata.label is not None:
            md.set_label(h.metadata.label[idx])
        if h.metadata.weight is not None:
            md.set_weight(h.metadata.weight[idx])
        if h.metadata.init_score is not None:
            ins = np.asarray(h.metadata.init_score).reshape(-1)
            if ins.size == h.num_data:
                md.set_init_score(ins[idx])
            else:   # per-class init scores, class-major
                k = ins.size // h.num_data
                md.set_init_score(
                    ins.reshape(k, h.num_data)[:, idx].reshape(-1))
        if h.metadata.query_boundaries is not None:
            qb = np.asarray(h.metadata.query_boundaries)
            qid = np.searchsorted(qb, idx, side="right") - 1
            sel_q, counts = np.unique(qid, return_counts=True)
            full = np.all(counts == np.diff(qb)[sel_q])
            contiguous = np.all(np.diff(qid) >= 0)
            if full and contiguous:
                md.set_group(counts)
            else:
                log_warning("Dataset.subset dropped query boundaries: "
                            "the row subset does not keep queries whole")
        nh.metadata = md
        sub._handle = nh
        return sub

    def save_binary(self, filename: str) -> "Dataset":
        """The binary dataset cache (LGBM_DatasetSaveBinary, c_api.h:540):
        the JAX package's npz, with the same keys, so either package loads
        the other's (JAX basic.py:566-598)."""
        self.construct()
        # a file object: savez would otherwise append ".npz"
        with open(filename, "wb") as fout:
            self._write_binary(fout, self._handle)
        return self

    @staticmethod
    def _write_binary(fout, h: BinnedDataset) -> None:
        import json
        md = h.metadata

        def arr(a):
            return a if a is not None else np.zeros(0)
        np.savez_compressed(
            fout,
            X_binned=h.X_binned,
            label=arr(md.label),
            weight=arr(md.weight),
            query_boundaries=arr(md.query_boundaries),
            init_score=arr(md.init_score),
            mappers=json.dumps([m.to_dict() for m in h.mappers]),
            real_feature_index=np.asarray(h.real_feature_index),
            used_feature_map=np.asarray(h.used_feature_map),
            feature_names=json.dumps(h.feature_names),
            num_total_features=h.num_total_features,
        )

    def init_streaming(self, *args, **kwargs) -> "Dataset":
        _not_ported("streaming Datasets (init_streaming / push_rows / "
                    "mark_finished)", "A13")

    push_rows = mark_finished = init_streaming

    def add_features_from(self, other: "Dataset") -> "Dataset":
        """Append `other`'s features to this Dataset in place (JAX
        basic.py:423-462; Dataset::AddFeaturesFrom, dataset.h:971). Both
        must hold the same rows; `other`'s bin mappers come along. EFB
        bundles are dropped and not rebuilt, so the result trains
        unbundled."""
        self.construct()
        other.construct()
        h, o = self._handle, other._handle
        if h.num_data != o.num_data:
            log_fatal("Cannot add features from a Dataset with "
                      f"{o.num_data} rows to one with {h.num_data}")
        off = h.num_total_features          # original-column offset
        inner_off = len(h.mappers)          # inner-feature offset
        h.X_binned = np.concatenate([h.X_binned[:, :len(h.mappers)],
                                     o.X_binned[:, :len(o.mappers)]],
                                    axis=1)
        if h.X_t is not None:
            h.X_t = torch.from_numpy(np.ascontiguousarray(
                h.X_binned.T)).to(h.X_t.device)
        h.mappers = list(h.mappers) + list(o.mappers)
        h.real_feature_index = list(h.real_feature_index) + [
            off + r for r in o.real_feature_index]
        h.used_feature_map = list(h.used_feature_map) + [
            (-1 if m < 0 else m + inner_off) for m in o.used_feature_map]
        # default names renumbered, user names made unique, so name-based
        # column specs stay unambiguous
        new_names = []
        existing = set(h.feature_names)
        for r, name in enumerate(o.feature_names):
            if name == f"Column_{r}":
                name = f"Column_{off + r}"
            while name in existing:
                name = name + "_y"
            existing.add(name)
            new_names.append(name)
        h.feature_names = list(h.feature_names) + new_names
        h.num_total_features = off + o.num_total_features
        h.bundles = h.X_bundled = h.bundle_col = h.bundle_off = None
        return self


class Booster:
    """Booster (reference: basic.py:3495)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.params = copy.deepcopy(params) if params else {}
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._train_metrics: List[Metric] = []
        self._valid_metrics: List[List[Metric]] = []
        self.name_valid_sets: List[str] = []

        if train_set is not None:
            cfg = resolve_params(self.params)
            check_slice_config(cfg)
            resolve_device(cfg.device_type)
            if train_set._handle is None:
                train_set.params = {**train_set.params, **self.params}
            train_set.construct()
            objective = create_objective(cfg)
            self._metric_names = cfg.metric or [default_metric_for_objective(
                cfg.objective)]
            self._train_metrics = [
                m for m in (create_metric(n, cfg) for n in self._metric_names)
                if m is not None]
            self._gbdt = create_boosting(cfg, train_set._handle, objective,
                                         self._train_metrics)
            self.train_set = train_set
            self._config = cfg
        elif model_file is not None or model_str is not None:
            if model_file is not None:
                with open(model_file) as f:
                    model_str = f.read()
            # `params` still choose where the loaded model predicts
            # (device_type); the model text brings its own objective
            self._gbdt = GBDT.load_model_from_string(
                model_str, resolve_params(self.params))
            self._config = self._gbdt.config
        else:
            raise ValueError("need at least one of train_set, model_file "
                             "and model_str")

    # ------------------------------------------------------------------
    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Score `data` each round with the training metrics. A valid set
        not constructed yet is binned against the training set and, for
        the parameters it does not set itself, under the booster's (its
        device_type above all), as the reference merges the training
        params into its valid sets."""
        if data.reference is not self.train_set:
            data.reference = self.train_set
        if data._handle is None:
            data.params = {**self.params, **data.params}
        data.construct()
        metrics = [m for m in (create_metric(n, self._config)
                               for n in self._metric_names) if m is not None]
        self._gbdt.add_valid_dataset(data._handle, name, metrics)
        self._valid_metrics.append(metrics)
        self.name_valid_sets.append(name)
        return self

    def update(self, train_set: Optional[Dataset] = None,
               fobj=None) -> bool:
        """One boosting iteration (reference: basic.py:4005). With `fobj`,
        fobj(raw scores, training Dataset) -> (grad, hess) gives the
        iteration's gradients: the scores as NumPy, [N] or class-major
        [K * N]; the arrays it returns (NumPy or tensors on any device) go
        to the scores' device (JAX basic.py:658-668). Returns True when no
        further splits are possible."""
        if fobj is not None:
            grad, hess = fobj(self._inner_raw_score(), self.train_set)
            return self._gbdt.train_one_iter(grad, hess)
        return self._gbdt.train_one_iter()

    def _inner_raw_score(self) -> np.ndarray:
        """The training rows' raw scores, [N] or class-major [K * N]."""
        s = self._gbdt.scores.cpu().numpy()
        return s[0] if s.shape[0] == 1 else s.reshape(-1)

    def update_batch(self, n: int, chunk: Optional[int] = None) -> None:
        """Run `n` boosting iterations in batched chunks of `chunk`
        (batched_chunk_size by default) while can_batch_iters allows them,
        the rest through update() (JAX basic.py:670-710); the model equals
        that of n update() calls. A tail chunk replays its chunk's graphs.
        The stop check runs at power-of-two chunk counts, the first and
        the last chunk exempt."""
        gbdt = self._gbdt
        if gbdt._stopped:
            return
        chunk = max(int(chunk or self._config.batched_chunk_size), 1)
        done = chunks = 0
        if gbdt.can_batch_iters(min(n, chunk)):
            n_chunks = -(-n // chunk)
            while done < n:
                step = min(chunk, n - done)
                if not gbdt.can_batch_iters(step):
                    break
                gbdt.train_iters_batched(step, n_pad=chunk)
                done += step
                chunks += 1
                if 1 < chunks < n_chunks and (chunks & (chunks - 1)) == 0 \
                        and gbdt.batched_stopped():
                    gbdt._stopped = True
                    return
        for _ in range(n - done):
            if self.update():
                break

    def rollback_one_iter(self) -> "Booster":
        """Remove the last iteration's trees and their outputs from the
        training and valid scores (JAX basic.py:719)."""
        self._gbdt.rollback_one_iter()
        return self

    @property
    def current_iteration(self):
        return self._gbdt.iter

    def num_model_per_iteration(self) -> int:
        return self._gbdt.num_tree_per_iteration

    def num_trees(self) -> int:
        return len(self._gbdt.models)

    def get_profile(self) -> Optional[Dict[str, Any]]:
        """The device profile (runtime/profiler.py StageProfiler.to_dict):
        per-stage seconds, the per-iteration ring, row-iters/s, the HBM
        watermark and the init-time extras; None unless trained with
        device_profile=true (JAX basic.py:730-735)."""
        prof = getattr(self._gbdt, "profiler", None)
        return prof.to_dict() if prof is not None else None

    def num_feature(self) -> int:
        return self._gbdt.max_feature_idx_ + 1

    def feature_name(self) -> List[str]:
        return list(self._gbdt.feature_names_)

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        t = 0 if importance_type == "split" else 1
        imp = self._gbdt.feature_importance(t, iteration or -1)
        return imp if t else imp.astype(np.int64)

    # ------------------------------------------------------------------
    def eval_train(self, feval=None) -> List:
        return self._eval("training", feval)

    def eval_valid(self, feval=None) -> List:
        out = []
        for name in self.name_valid_sets:
            out.extend(self._eval(name, feval))
        return out

    def eval(self, data: Dataset, name: str, feval=None) -> List:
        """The metrics of the training set (name "training") or of the
        valid set added under `name` (JAX basic.py:771-774)."""
        if name == "training":
            return self.eval_train(feval)
        return self._eval(name, feval)

    def _eval(self, name: str, feval=None) -> List:
        """The set's metrics, then feval(raw scores, Dataset) -> one
        (name, value, is_higher_better) or a list of them, appended as
        (set name, name, value, is_higher_better); the scores as NumPy, [n]
        or class-major [K * n], the Dataset the training set's or None for
        a valid set (JAX basic.py:776-795)."""
        if name == "training":
            metrics = self._train_metrics
            score, dataset = self._gbdt.scores, self.train_set
        else:
            vi = self.name_valid_sets.index(name)
            metrics = self._valid_metrics[vi]
            score, dataset = self._gbdt._valid_scores[vi], None
        res = self._gbdt.get_eval_result({name: metrics})
        if feval is not None:
            s = score.cpu().numpy()
            ret = feval(s[0] if s.shape[0] == 1 else s.reshape(-1), dataset)
            if ret is not None:
                if isinstance(ret, tuple):
                    ret = [ret]
                for mn, val, hib in ret:
                    res.append((name, mn, val, hib))
        return res

    # ------------------------------------------------------------------
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs) -> np.ndarray:
        """Margins or converted outputs of `data`: the host walk over the
        packed trees, or the device predictor for 100k f32 rows and more
        on a CUDA booster (models/gbdt.py:predict_raw); `[N, K]` for K
        models an iteration. `pred_leaf` gives each row's leaf index in
        every tree, `[N, iterations * K]`, columns in iteration then class
        order; `pred_contrib` each row's TreeSHAP values, `[N, K * (F +
        1)]`, the expected value last of each class's block
        (models/shap.py, on the host). `pred_early_stop` / `_freq` /
        `_margin`, from the keyword arguments or else from the booster's
        params, stop a row's walk once its margin clears the bound (host
        walk only), as the JAX package's Booster.predict. Any other
        keyword (the reference's validate_features, data_has_header, ...)
        is accepted and ignored, as the JAX package does (basic.py:
        795-815). Sparse and Arrow rows are densified."""
        ni = num_iteration if num_iteration is not None else (
            self.best_iteration if self.best_iteration > 0 else -1)
        if pred_leaf:
            return self._gbdt.predict_leaf_index(_to_2d_numpy(data),
                                                 start_iteration, ni)
        if pred_contrib:
            from .models.shap import predict_contrib
            return predict_contrib(self._gbdt, _to_2d_numpy(data),
                                   start_iteration, ni)
        es_kwargs = {}
        for p in _EARLY_STOP_KEYS:
            if p in kwargs:
                es_kwargs[p] = kwargs[p]
            elif p in self.params:
                es_kwargs[p] = self.params[p]
        return self._gbdt.predict(_to_2d_numpy(data), raw_score=raw_score,
                                  start_iteration=start_iteration,
                                  num_iteration=ni, **es_kwargs)

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """reference: basic.py Booster.reset_parameter; the JAX package's
        (basic.py:1072-1079): the booster's config is rebuilt from its
        params updated with `params`, and the learning rate of the trees
        to come changes with it. The grower keeps the configuration it
        was built with, as in the JAX package."""
        self.params.update(params)
        cfg = resolve_params(self.params)
        self._gbdt.config = cfg
        self._gbdt.shrinkage_rate = cfg.learning_rate
        return self

    def refit(self, data, label, decay_rate: float = 0.9, weight=None,
              **kwargs) -> "Booster":
        """A new Booster whose trees keep this model's structures with
        their leaf values refit to `data` (JAX basic.py:890-985; the leaf
        math of GBDT::RefitTree, gbdt.cpp:200-228): each leaf value becomes
        decay_rate * old + (1 - decay_rate) * new, `new` the regularized,
        shrunk output of the gradients of the rows that fall in the leaf.
        The leaves come from predict(pred_leaf=True); the gradients, once
        an iteration before any class's trees, from the objective on the
        device of the booster's (and `kwargs`') device_type; the per-leaf
        sums in f64 on the host, in row order. `weight` scales the rows'
        gradients as at training time. A linear tree's leaves are then
        fitted again on the host over the saved feature sets, blended with
        the old coefficients at decay_rate (JAX basic.py:956-978;
        linear_tree_learner.cpp:139-156, 330-390). This booster is
        unchanged."""
        data = _to_2d_numpy(data)
        new_booster = Booster(model_str=self.model_to_string())
        g = new_booster._gbdt
        if g.objective is None:
            raise ValueError("Cannot refit a model without an objective")
        # the training regularization (the model text carries only the
        # objective); refit-time params override
        cfg = resolve_params({**self.params, **kwargs})
        g.config = cfg
        device = resolve_device(cfg.device_type)
        label = np.asarray(label, np.float32).reshape(-1)
        K = g.num_tree_per_iteration
        N = data.shape[0]
        leaf_preds = self.predict(data, pred_leaf=True).reshape(N, -1)
        md = Metadata(N)
        md.set_label(label)
        if weight is not None:
            md.set_weight(np.asarray(weight, np.float32).reshape(-1))
        g.objective.init(md, N)
        label_dev = torch.from_numpy(label).to(device)
        weight_dev = (None if md.weight is None
                      else torch.from_numpy(md.weight).to(device))
        scores = np.zeros((K, N), dtype=np.float64)
        for it in range(len(g.models) // max(K, 1)):
            if g.objective.runs_on_host:
                gr, he = g.objective.get_gradients_numpy(
                    scores.reshape(-1).astype(np.float64))
            else:
                s = torch.from_numpy(scores.astype(np.float32)).to(device)
                gr, he = g.objective.get_gradients(s[0] if K == 1 else s,
                                                   label_dev, weight_dev)
                gr, he = gr.cpu().numpy(), he.cpu().numpy()
            grads, hesss = gr.reshape(K, N), he.reshape(K, N)
            for k in range(K):
                mi = it * K + k
                tree = g.models[mi]
                leaf = leaf_preds[:, mi]
                nl = tree.num_leaves
                sum_g = np.bincount(leaf, weights=grads[k], minlength=nl)
                sum_h = np.bincount(leaf, weights=hesss[k], minlength=nl)
                reg = np.abs(sum_g) - cfg.lambda_l1
                new_val = -np.sign(sum_g) * np.maximum(reg, 0.0) / (
                    sum_h + cfg.lambda_l2 + 1e-15)
                new_val *= tree.shrinkage
                tree.leaf_value = (decay_rate * tree.leaf_value
                                   + (1.0 - decay_rate) * new_val[:nl])
                if getattr(tree, "is_linear", False):
                    # the saved feature sets are raw column ids; the
                    # gradients carry the weights, so no row is out of bag
                    Ftot = data.shape[1]
                    scores[k] += fit_linear_models(
                        tree, np.asarray(data, np.float32),
                        leaf.astype(np.int32), grads[k], hesss[k],
                        np.ones(N, np.float32),
                        linear_lambda=float(cfg.linear_lambda),
                        shrinkage=tree.shrinkage,
                        numeric_inner=np.ones(Ftot, bool),
                        inner_to_real=np.arange(Ftot, dtype=np.int64),
                        leaf_features_inner=tree.leaf_features,
                        is_refit=True, decay_rate=decay_rate)
                else:
                    scores[k] += tree.leaf_value[leaf]
        return new_booster

    def serve(self, **kwargs) -> Any:
        """Inference session over this model: pinned packed trees, the
        bucket ladder and its scorer cache (serving/session.py). Host-engine
        outputs are bitwise equal to the host walk of :meth:`predict`."""
        from .serving import ServingSession
        return ServingSession.from_booster(self, **kwargs)

    # ------------------------------------------------------------------
    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = "split") -> "Booster":
        # atomic (write-temp -> fsync -> rename): a concurrent reader, a
        # snapshot watcher above all, never sees half a model file
        atomic_write_text(filename,
                          self.model_to_string(num_iteration,
                                               start_iteration,
                                               importance_type))
        return self

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0,
                        importance_type: str = "split") -> str:
        ni = num_iteration if num_iteration is not None else (
            self.best_iteration if self.best_iteration > 0 else -1)
        s = self._gbdt.save_model_to_string(
            start_iteration, ni, 0 if importance_type == "split" else 1)
        return s + "\npandas_categorical:null\n"

    def model_from_string(self, model_str: str) -> "Booster":
        """Replace this booster's model by the one in `model_str`; the
        booster's params still choose where it predicts."""
        self._gbdt = GBDT.load_model_from_string(
            model_str, resolve_params(self.params))
        self._config = self._gbdt.config
        return self

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = "split") -> Dict[str, Any]:
        """The model as JSON (GBDT::DumpModel, gbdt_model_text.cpp:31; JAX
        basic.py:853-888)."""
        g = self._gbdt
        ni = num_iteration if num_iteration is not None else (
            self.best_iteration if self.best_iteration > 0 else -1)
        K = g.num_tree_per_iteration
        total_iters = len(g.models) // K if K else 0
        end = total_iters if ni <= 0 else min(total_iters,
                                              start_iteration + ni)
        trees = []
        for it in range(start_iteration, end):
            for k in range(K):
                d = g.models[it * K + k].to_json()
                d["tree_index"] = len(trees)
                trees.append(d)
        return {
            "name": "tree",
            "version": "v4",
            "num_class": g.num_class,
            "num_tree_per_iteration": K,
            "label_index": g.label_idx_,
            "max_feature_idx": g.max_feature_idx_,
            "objective": (g.objective.to_string() if g.objective else ""),
            "average_output": g.average_output,
            "feature_names": list(g.feature_names_),
            "feature_importances": {
                name: float(v) for name, v in zip(
                    g.feature_names_,
                    g.feature_importance(
                        0 if importance_type == "split" else 1))
                if v > 0},
            "tree_info": trees,
        }

    def dump_model_to_cpp(self) -> str:
        """C++ if-else code of the model (GBDT::SaveModelToIfElse,
        gbdt_model_text.cpp:262; JAX basic.py:982-1070), byte for byte the
        JAX package's: the missing types None / Zero / NaN of
        Tree::NumericalDecision (tree.h:375-407) and the bitsets of
        Tree::CategoricalDecision. Linear trees are fatal, naming them."""
        linear = linear_tree_indices(self._gbdt.models)
        if linear:
            log_fatal("convert_model to C++ is not supported for linear "
                      f"trees: {format_tree_indices(linear)} carry fitted "
                      "linear leaf functions; retrain with "
                      "linear_tree=false")
        g = self._gbdt
        lines = ["#include <cmath>", "#include <cstdint>", "",
                 f"// generated by lightgbm_tpu; {len(g.models)} trees"]
        for i, tree in enumerate(g.models):
            # constant bitset tables of this tree's categorical splits
            for ci in range(tree.num_cat):
                s0 = int(tree.cat_boundaries[ci])
                s1 = int(tree.cat_boundaries[ci + 1])
                words = ", ".join(
                    f"{int(w)}u" for w in tree.cat_threshold[s0:s1])
                lines.append(f"static const uint32_t kCatBits{i}_{ci}[] = "
                             f"{{{words}}};")
            lines.append(f"double PredictTree{i}(const double* arr) {{")
            if tree.num_leaves <= 1:
                lines.append(f"  return {float(tree.leaf_value[0])!r};")
            else:
                _emit_cpp_node(lines, tree, i, 0, 0)
            lines.append("}")
            lines.append("")
        n = len(g.models)
        lines.append("double Predict(const double* arr) {")
        lines.append("  double result = 0.0;")
        for i in range(n):
            lines.append(f"  result += PredictTree{i}(arr);")
        if g.average_output and n:
            lines.append(f"  result /= {n};")
        lines.append("  return result;")
        lines.append("}")
        return "\n".join(lines) + "\n"

    def free_dataset(self) -> "Booster":
        return self

    def free_network(self) -> "Booster":
        return self


def _emit_cpp_node(lines: List[str], tree, i: int, node: int,
                   depth: int) -> None:
    """The if-else of `node` of tree i (a leaf when negative)."""
    ind = "  " * (depth + 1)
    if node < 0:
        lines.append(f"{ind}return {float(tree.leaf_value[~node])!r};")
        return
    f = int(tree.split_feature[node])
    dt = int(tree.decision_type[node])
    if dt & 1:
        # CategoricalDecision: NaN, negative and out-of-range values go
        # right; otherwise bitset membership
        ci = int(tree.threshold_in_bin[node])
        nwords = int(tree.cat_boundaries[ci + 1] - tree.cat_boundaries[ci])
        cond = (f"(!std::isnan(arr[{f}]) && arr[{f}] >= 0 && "
                f"static_cast<int>(arr[{f}]) < {nwords * 32} && "
                f"((kCatBits{i}_{ci}"
                f"[static_cast<int>(arr[{f}]) / 32] >> "
                f"(static_cast<int>(arr[{f}]) % 32)) & 1))")
    else:
        thr = float(tree.threshold[node])
        missing_type = (dt >> 2) & 3
        # NumericalDecision: NaN is 0 unless the missing type is NaN; Zero
        # follows the default direction
        val = f"(std::isnan(arr[{f}]) ? 0.0 : arr[{f}])"
        if missing_type == 2:       # MissingType::NaN
            miss = f"std::isnan(arr[{f}])"
            val = f"arr[{f}]"
        elif missing_type == 1:     # MissingType::Zero
            miss = f"(std::fabs({val}) <= 1e-35)"
        else:
            miss = "false"
        dirn = "true" if dt & 2 else "false"
        cond = f"({miss} ? {dirn} : ({val} <= {thr!r}))"
    lines.append(f"{ind}if {cond} {{")
    _emit_cpp_node(lines, tree, i, int(tree.left_child[node]), depth + 1)
    lines.append(f"{ind}}} else {{")
    _emit_cpp_node(lines, tree, i, int(tree.right_child[node]), depth + 1)
    lines.append(f"{ind}}}")
