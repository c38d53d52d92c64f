"""GBDT training orchestrator, per-iteration path.

Counterpart of lightgbm_tpu/models/gbdt.py (the reference's
src/boosting/gbdt.cpp: TrainOneIter:353, UpdateScore:502, and the model
text of gbdt_model_text.cpp). Scores, gradients, the binned matrix and tree
growth live on the configured torch device; grown trees stay there as
`DeviceTree` records until a caller needs host trees (save, predict).

This slice runs one configuration family: the wave grower's megakernel
route (F <= 32 storage columns, no EFB bundles, no categorical features)
with binary or L2 objectives, no bagging, host binning. Everything else
raises NotImplementedError naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.dataset import BinnedDataset
from ..metrics import Metric
from ..objectives import ObjectiveFunction, create_objective
from ..ops.grow import DeviceTree, GrowConfig
from ..ops.grow_wave import MAX_WAVE_FEATURES, _wave_buckets, grow_tree_wave
from ..ops.histogram import take_leaf_values
from ..ops.histogram_cuda import MAX_LEAVES
from ..ops.predict import predict_leaf_binned
from ..ops.split import FeatureMeta
from ..utils import resolve_device, round_up
from ..utils.log import log_fatal, log_info, log_warning
from .tree import Tree, make_decision_type

_KEPS = 1e-15
MODEL_VERSION = "v4"


def _not_ported(what: str, item: str) -> None:
    raise NotImplementedError(
        f"{what} is not ported to lightgbm_tpu_torch yet (ROADMAP item "
        f"{item})")


def check_slice_config(cfg: Config) -> None:
    """Refuse every configuration outside this slice, naming the ROADMAP
    item that will port it; none may quietly take another route."""
    if cfg.boosting != "gbdt":
        _not_ported(f"boosting={cfg.boosting}", "A10")
    if cfg.linear_tree:
        _not_ported("linear_tree", "A10")
    if cfg.tree_learner != "serial" or cfg.num_machines > 1 \
            or cfg.pre_partition:
        _not_ported("distributed training (tree_learner="
                    f"{cfg.tree_learner})", "A16")
    if cfg.tpu_grower not in ("auto", "wave"):
        _not_ported(f"tpu_grower={cfg.tpu_grower}", "A11")
    if cfg.histogram_impl != "auto" or cfg.force_row_wise:
        _not_ported(f"histogram_impl={cfg.histogram_impl}",
                    "A14/A15")
    if cfg.binning_impl == "device":
        _not_ported("binning_impl=device (the bucketize kernel)", "A13")
    if cfg.use_quantized_grad:
        _not_ported("use_quantized_grad", "A8")
    if cfg.monotone_constraints and any(cfg.monotone_constraints):
        _not_ported("monotone_constraints", "A10")
    if cfg.interaction_constraints:
        _not_ported("interaction_constraints", "A10")
    if cfg.forcedsplits_filename:
        _not_ported("forced splits", "A10")
    if cfg.cegb_penalty_split > 0.0 or cfg.cegb_penalty_feature_coupled \
            or cfg.cegb_penalty_feature_lazy:
        _not_ported("CEGB penalties", "A10")
    bagging = (cfg.bagging_freq > 0 and (
        cfg.bagging_fraction < 1.0 or cfg.pos_bagging_fraction < 1.0
        or cfg.neg_bagging_fraction < 1.0))
    if bagging or cfg.data_sample_strategy == "goss":
        _not_ported("bagging / GOSS", "A10")
    if cfg.feature_fraction_bynode < 1.0 or cfg.extra_trees:
        _not_ported("feature_fraction_bynode / extra_trees", "A10")
    if cfg.num_class > 1:
        _not_ported("multiclass", "A10")
    if cfg.num_leaves > MAX_LEAVES:
        _not_ported(f"num_leaves > {MAX_LEAVES}", "A11")


def _check_slice_data(ds: BinnedDataset) -> None:
    if ds.bundles is not None:
        _not_ported("EFB bundled storage", "A9")
    if bool(ds.feature_is_categorical().any()):
        _not_ported("categorical features", "A9")
    if len(ds.mappers) > MAX_WAVE_FEATURES:
        _not_ported(f"{len(ds.mappers)} storage columns (the wave "
                    f"megakernel takes at most {MAX_WAVE_FEATURES})", "A9")
    if ds.X_binned.dtype != np.uint8:
        _not_ported("more than 256 bins per feature", "A14")


def build_feature_meta(ds: BinnedDataset, device) -> FeatureMeta:
    def t(a):
        return torch.as_tensor(a).to(device)
    return FeatureMeta(
        num_bins=t(ds.feature_num_bins()),
        missing_type=t(ds.feature_missing_types()),
        default_bin=t(ds.feature_default_bins()),
        is_categorical=t(ds.feature_is_categorical()))


class GBDT:
    """Gradient Boosting Decision Trees (reference: src/boosting/gbdt.h:35)."""

    def __init__(self, config: Config, train_set: Optional[BinnedDataset],
                 objective: Optional[ObjectiveFunction],
                 training_metrics: Sequence[Metric] = ()):
        self.config = config
        self.objective = objective
        self.train_set = train_set
        self.training_metrics = list(training_metrics)
        self._models: List[Tree] = []
        # device trees not yet materialized on the host: (DeviceTree, bias)
        self._pending: List[Tuple[DeviceTree, float]] = []
        self._stop_check_interval = 32
        self._stopped = False
        self.iter = 0
        self.num_class = config.num_class
        self.num_tree_per_iteration = (
            objective.num_model_per_iteration if objective else 1)
        self.shrinkage_rate = config.learning_rate
        self.average_output = False
        self.valid_sets: List[BinnedDataset] = []
        self.valid_names: List[str] = []
        self._valid_scores: List[torch.Tensor] = []
        self._valid_Xt: List[torch.Tensor] = []
        self.best_iteration = -1
        self.loaded_parameter = ""
        self.max_feature_idx_ = 0
        self.feature_names_: List[str] = []
        self.feature_infos_: List[str] = []
        self.label_idx_ = 0
        self.mappers = []
        self.real_feature_index: List[int] = []
        if train_set is not None:
            self._init_train(train_set)

    # ------------------------------------------------------------------
    def _init_train(self, ds: BinnedDataset) -> None:
        cfg = self.config
        check_slice_config(cfg)
        _check_slice_data(ds)
        self.device = resolve_device(cfg.device_type)
        self.num_data = ds.num_data
        self.max_feature_idx_ = ds.num_total_features - 1
        self.feature_names_ = list(ds.feature_names)
        self.feature_infos_ = ds.feature_infos()
        self.mappers = ds.mappers
        self.real_feature_index = list(ds.real_feature_index)

        max_bin = max((m.num_bin for m in ds.mappers), default=2)
        self.num_bins_padded = max(round_up(max_bin, 8), 8)
        self.X_t = (ds.X_t if ds.X_t is not None else torch.from_numpy(
            np.ascontiguousarray(ds.X_binned.T))).to(self.device)
        self.meta = build_feature_meta(ds, self.device)
        self.grow_cfg = GrowConfig(
            num_leaves=cfg.num_leaves,
            max_depth=cfg.max_depth,
            min_data_in_leaf=float(cfg.min_data_in_leaf),
            min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
            lambda_l1=cfg.lambda_l1,
            lambda_l2=cfg.lambda_l2,
            max_delta_step=cfg.max_delta_step,
            min_gain_to_split=cfg.min_gain_to_split,
            path_smooth=cfg.path_smooth,
            num_bins_padded=self.num_bins_padded,
            # slack >= 1 would block the top ready leaf forever; clamp
            wave_gain_slack=min(max(cfg.tpu_wave_gain_slack, 0.0), 0.99),
        )
        # tpu_grower=auto picks the wave grower when its two [L, 3, F, B]
        # histogram caches fit histogram_pool_size (gbdt.py:412-427); the
        # serial growers it would fall back to are not ported
        cache_bytes = (cfg.num_leaves * len(ds.mappers)
                       * self.num_bins_padded * 3 * 4)
        wave_bytes = cache_bytes * 2 + (
            _wave_buckets(cfg.num_leaves)[-1] * len(ds.mappers)
            * self.num_bins_padded * 3 * 4) * 2
        pool_limit = (cfg.histogram_pool_size * 1024 * 1024
                      if cfg.histogram_pool_size > 0 else 512 * 1024 * 1024)
        if cfg.tpu_grower == "auto" and wave_bytes > pool_limit:
            _not_ported("the serial growers (wave caches exceed "
                        "histogram_pool_size)", "A11")

        md = ds.metadata
        N = self.num_data

        def dev(a):
            return None if a is None else torch.as_tensor(
                np.asarray(a, np.float32)).to(self.device)

        self.label_dev = dev(md.label)
        self.weight_dev = dev(md.weight)
        scores = np.zeros((1, N), dtype=np.float32)
        self._has_init_score = md.init_score is not None
        if self._has_init_score:
            scores += np.asarray(md.init_score, np.float64).reshape(1, N)
        self.scores = torch.from_numpy(scores).to(self.device)
        self._in_bag = torch.ones(N, dtype=torch.float32, device=self.device)
        if self.objective is not None:
            self.objective.init(md, N)
        for m in self.training_metrics:
            m.init(md, N)

    # ------------------------------------------------------------------
    def add_valid_dataset(self, ds: BinnedDataset, name: str,
                          metrics: Sequence[Metric]) -> None:
        if self._models or self._pending:
            _not_ported("adding a valid set after training started "
                        "(continued training)", "A10")
        self._valid_Xt.append(torch.from_numpy(
            np.ascontiguousarray(ds.X_binned.T)).to(self.device))
        scores = np.zeros((1, ds.num_data), dtype=np.float32)
        if ds.metadata.init_score is not None:
            scores += np.asarray(ds.metadata.init_score,
                                 np.float64).reshape(1, -1)
        self._valid_scores.append(torch.from_numpy(scores).to(self.device))
        self.valid_sets.append(ds)
        self.valid_names.append(name)
        for m in metrics:
            m.init(ds.metadata, ds.num_data)

    # ------------------------------------------------------------------
    @property
    def models(self) -> List[Tree]:
        """Host trees; materializes any pending device trees first."""
        if self._pending:
            pending, self._pending = self._pending, []
            for tree_dev, bias in pending:
                tree = self._device_tree_to_host(tree_dev)
                if abs(bias) > _KEPS:
                    tree.add_bias(bias)
                self._models.append(tree)
        return self._models

    def _check_stopped(self) -> bool:
        """Report whether the last iteration produced only stumps
        (reference stop condition, gbdt.cpp:376-384)."""
        counts = [t.num_leaves for t, _ in self._pending[-1:]] \
            or [t.num_leaves for t in self._models[-1:]]
        if counts and all(int(c) <= 1 for c in counts):
            log_warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            return True
        return False

    def _boost_from_average(self) -> float:
        """gbdt.cpp:328: initial score from the objective's average."""
        if (self.objective is None or self._has_init_score
                or not self.config.boost_from_average):
            return 0.0
        init = float(self.objective.boost_from_score(0))
        if abs(init) > _KEPS:
            self.scores[0] += float(np.float32(init))
            for vs in self._valid_scores:
                vs[0] += float(np.float32(init))
            log_info(f"Start training from score {init:.6f}")
        return init

    def _feature_mask_for_iter(self) -> Optional[torch.Tensor]:
        frac = self.config.feature_fraction
        F = len(self.mappers)
        if frac >= 1.0:
            return None
        used = max(1, int(round(F * frac)))
        rng = np.random.RandomState(self.config.feature_fraction_seed
                                    + self.iter)
        mask = np.zeros(F, dtype=bool)
        mask[rng.choice(F, used, replace=False)] = True
        return torch.from_numpy(mask).to(self.device)

    def train_one_iter(self) -> bool:
        """One boosting iteration (GBDT::TrainOneIter, gbdt.cpp:353).
        Returns True if training should stop (no splits possible)."""
        if self.objective is None:
            log_fatal("No objective function provided for boosting")
        init_score = self._boost_from_average() if self.iter == 0 else 0.0
        g, h = self.objective.get_gradients(self.scores[0], self.label_dev,
                                            self.weight_dev)
        tree, leaf_of_row = grow_tree_wave(self.X_t, g, h, self._in_bag,
                                           self.meta, self.grow_cfg,
                                           self._feature_mask_for_iter())
        lr = self.shrinkage_rate
        self.scores[0] += take_leaf_values(tree.leaf_value * lr, leaf_of_row)
        # valid scores update BEFORE the bias fold (the reference updates
        # scores before AddBias, gbdt.cpp:424-428)
        for vi, Xv in enumerate(self._valid_Xt):
            leaf = predict_leaf_binned(
                tree.split_feature, tree.threshold_bin, tree.default_left,
                tree.left_child, tree.right_child, tree.num_leaves, Xv,
                self.meta)
            self._valid_scores[vi][0] += (tree.leaf_value * lr)[leaf]
        self._pending.append((tree, init_score if self.iter == 0 else 0.0))
        self.iter += 1
        # the stop check is evaluated at the JAX package's iterations
        # (powers of two, then every 32), so both grow the same number of
        # trees
        if self._stopped:
            return True
        it = self.iter
        if (it & (it - 1)) == 0 or it % self._stop_check_interval == 0:
            self._stopped = self._check_stopped()
        return self._stopped

    # ------------------------------------------------------------------
    def _device_tree_to_host(self, t: DeviceTree) -> Tree:
        """Pull a DeviceTree into a host Tree with real thresholds and real
        feature indices (gbdt.py:_device_tree_to_host)."""
        n = int(t.num_leaves)
        m = max(n - 1, 0)

        def host(a, k):
            return a[:k].cpu().numpy()

        sf_inner = host(t.split_feature, m).astype(np.int32)
        thr_bin = host(t.threshold_bin, m).astype(np.int32)
        dleft = host(t.default_left, m).astype(bool)
        thr_real = np.zeros(m, dtype=np.float64)
        dtype_arr = np.zeros(m, dtype=np.int8)
        for i in range(m):
            mp = self.mappers[sf_inner[i]]
            thr_real[i] = mp.bin_to_value(int(thr_bin[i]))
            dtype_arr[i] = make_decision_type(False, bool(dleft[i]),
                                              mp.missing_type)
        real_feat = np.asarray([self.real_feature_index[f] for f in sf_inner],
                               np.int32)
        lr = self.shrinkage_rate
        tree = Tree.from_arrays(
            num_leaves=n,
            split_feature=real_feat,
            threshold_bin=thr_bin,
            threshold_real=thr_real,
            decision_type=dtype_arr,
            left_child=host(t.left_child, m),
            right_child=host(t.right_child, m),
            split_gain=host(t.split_gain, m),
            leaf_value=host(t.leaf_value, n).astype(np.float64) * lr,
            leaf_weight=host(t.leaf_weight, n).astype(np.float64),
            leaf_count=host(t.leaf_count, n).astype(np.int64),
            internal_value=host(t.internal_value, m).astype(np.float64) * lr,
            internal_weight=host(t.internal_weight, m).astype(np.float64),
            internal_count=host(t.internal_count, m).astype(np.int64),
            shrinkage=lr,
        )
        tree.split_feature_inner = sf_inner
        return tree

    # ------------------------------------------------------------------
    def get_eval_result(self, metrics_per_set: Dict[str, Sequence[Metric]]
                        ) -> List[Tuple[str, str, float, bool]]:
        """[(dataset_name, metric_name, value, is_higher_better)]"""
        out = []
        for name, metrics in metrics_per_set.items():
            if name == "training":
                score = self.scores
            else:
                score = self._valid_scores[self.valid_names.index(name)]
            s = score[0].cpu().numpy()
            for metric in metrics:
                for mn, val, hib in metric.eval(s, self.objective):
                    out.append((name, mn, val, hib))
        return out

    # ------------------------------------------------------------------
    # prediction (host trees, raw features)
    # ------------------------------------------------------------------
    def _packed_model(self, start_iteration: int, end: int):
        key = (start_iteration, end, len(self.models))
        cached = getattr(self, "_packed_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        from .predictor import PackedModel
        K = self.num_tree_per_iteration
        pm = PackedModel(self.models[start_iteration * K:end * K], K)
        self._packed_cache = (key, pm)
        return pm

    def predict_raw(self, X: np.ndarray, start_iteration: int = 0,
                    num_iteration: int = -1) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        K = self.num_tree_per_iteration
        total_iters = len(self.models) // K
        end = total_iters if num_iteration <= 0 else min(
            total_iters, start_iteration + num_iteration)
        if end <= start_iteration:
            return np.zeros((K, X.shape[0]), dtype=np.float64)
        return self._packed_model(start_iteration, end).predict_margin(X)

    def predict(self, X: np.ndarray, raw_score: bool = False,
                start_iteration: int = 0,
                num_iteration: int = -1) -> np.ndarray:
        raw = self.predict_raw(X, start_iteration, num_iteration)
        if not raw_score and self.objective is not None \
                and self.objective.need_convert_output:
            raw = self.objective.convert_output(raw)
        return raw[0] if raw.shape[0] == 1 else raw.T

    # ------------------------------------------------------------------
    # model serialization (gbdt_model_text.cpp)
    # ------------------------------------------------------------------
    def save_model_to_string(self, start_iteration: int = 0,
                             num_iteration: int = -1,
                             importance_type: int = 0) -> str:
        K = self.num_tree_per_iteration
        total_iters = len(self.models) // K if K else 0
        start_iteration = max(0, min(start_iteration, total_iters))
        if num_iteration > 0:
            num_used = min((start_iteration + num_iteration) * K,
                           len(self.models))
        else:
            num_used = len(self.models)
        start_model = start_iteration * K

        lines = ["tree", f"version={MODEL_VERSION}",
                 f"num_class={self.num_class}",
                 f"num_tree_per_iteration={K}",
                 f"label_index={self.label_idx_}",
                 f"max_feature_idx={self.max_feature_idx_}"]
        if self.objective is not None:
            lines.append(f"objective={self.objective.to_string()}")
        if self.average_output:
            lines.append("average_output")
        lines.append("feature_names=" + " ".join(self.feature_names_))
        lines.append("feature_infos=" + " ".join(self.feature_infos_))
        tree_strs = [f"Tree={i - start_model}\n"
                     + self.models[i].to_string() + "\n"
                     for i in range(start_model, num_used)]
        lines.append("tree_sizes=" + " ".join(str(len(s)) for s in tree_strs))
        lines.append("")
        body = "\n".join(lines) + "\n" + "".join(tree_strs)
        body += "end of trees\n"

        imp = self.feature_importance(importance_type, num_iteration)
        pairs = [(int(v), self.feature_names_[i]) for i, v in enumerate(imp)
                 if v > 0]
        pairs.sort(key=lambda p: -p[0])
        body += "\nfeature_importances:\n"
        for v, name in pairs:
            body += f"{name}={v}\n"
        body += "\nparameters:\n" + (self.loaded_parameter
                                     or self.config.to_string()) + "\n"
        body += "end of parameters\n"
        return body

    def feature_importance(self, importance_type: int = 0,
                           num_iteration: int = -1) -> np.ndarray:
        """reference: GBDT::FeatureImportance (gbdt.cpp)."""
        K = self.num_tree_per_iteration
        end = len(self.models) if num_iteration <= 0 else min(
            len(self.models), num_iteration * K)
        imp = np.zeros(self.max_feature_idx_ + 1, dtype=np.float64)
        for tree in self.models[:end]:
            for i in range(tree.num_leaves - 1):
                if tree.split_gain[i] > 0:
                    imp[tree.split_feature[i]] += (
                        1.0 if importance_type == 0 else tree.split_gain[i])
        return imp

    @classmethod
    def load_model_from_string(cls, model_str: str,
                               config: Optional[Config] = None) -> "GBDT":
        """reference: GBDT::LoadModelFromString (gbdt_model_text.cpp:590)."""
        config = config or Config()
        gbdt = cls(config, None, None)
        header: Dict[str, str] = {}
        for line in model_str.split("\n"):
            line = line.strip()
            if line.startswith("Tree="):
                break
            if "=" in line:
                k, v = line.split("=", 1)
                header[k] = v
            elif line == "average_output":
                gbdt.average_output = True
        gbdt.num_class = int(header.get("num_class", "1"))
        gbdt.num_tree_per_iteration = int(
            header.get("num_tree_per_iteration", "1"))
        gbdt.label_idx_ = int(header.get("label_index", "0"))
        gbdt.max_feature_idx_ = int(header.get("max_feature_idx", "0"))
        gbdt.feature_names_ = header.get("feature_names", "").split()
        gbdt.feature_infos_ = header.get("feature_infos", "").split()
        if "objective" in header:
            cfg2 = _config_from_objective_string(header["objective"], config)
            gbdt.objective = create_objective(cfg2)
            gbdt.config = cfg2
        for blk in model_str.split("Tree=")[1:]:
            body = blk.split("\n\n")[0]
            if "end of trees" in body:
                body = body.split("end of trees")[0]
            gbdt._models.append(Tree.from_string(body))
        gbdt.iter = len(gbdt._models) // max(gbdt.num_tree_per_iteration, 1)
        return gbdt


def _config_from_objective_string(obj_str: str, base: Config) -> Config:
    """Parse 'binary sigmoid:1' style objective strings from model files."""
    parts = obj_str.split()
    cfg = dataclasses.replace(base, objective=parts[0])
    for tok in parts[1:]:
        if ":" in tok:
            k, v = tok.split(":", 1)
            if k == "num_class":
                cfg = dataclasses.replace(cfg, num_class=int(v))
            elif k == "sigmoid":
                cfg = dataclasses.replace(cfg, sigmoid=float(v))
    return cfg
