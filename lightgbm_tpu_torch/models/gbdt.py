"""GBDT training orchestrator: the per-iteration path and batched chunks.

Counterpart of lightgbm_tpu/models/gbdt.py (the reference's
src/boosting/gbdt.cpp: TrainOneIter:353, UpdateScore:502, and the model
text of gbdt_model_text.cpp). Scores, gradients, the binned matrix and tree
growth live on the configured torch device; grown trees stay there as
`DeviceTree` records until a caller needs host trees (save, predict).

Training runs the wave grower with every objective of the JAX package
(objectives/, objectives/rank.py; K trees an iteration on [K, N] scores
for the multiclass objectives, leaf renewal for l1 / quantile / mape),
host or device binning, on the route the JAX package's accelerator takes
(`wave_routes`): the megakernel route for at most 32 dense numeric storage
columns, the wave-apply route for wider, categorical or EFB-bundled data
and for the row-wise histogram layouts, and under histogram_impl=fused the
fused routes, whose kernels also search the children's splits; monotone
constraints (method `basic` with `monotone_penalty`, and `intermediate`)
and interaction constraints on every route, forced splits and CEGB
penalties on the two-pass routes, quantized gradients
(use_quantized_grad), feature_fraction_bynode and extra_trees, and
uniform, class-stratified, by-query or GOSS row sampling
(models/sample_strategy.py), and linear leaves fitted on the host
(models/linear.py); or, as tpu_grower and the histogram_pool_size ladder
choose (`_select_grower`), strict leaf-wise order on the wave grower
(wave_exact) or a serial grower: masked (ops/grow.py) or compact
(ops/grow_fast.py). The loop around it: continued training from an
existing model (`load_init_model`, its trees replayed onto the scores on
the device), valid sets added at any time, iterations on caller-given
gradients (`train_one_iter(grad, hess)`) and `rollback_one_iter`; random
forests (models/rf.py) and DART (models/dart.py) subclass it. The runtime
(runtime/): device_profile's stage spans, batched chunks' records and
init-time extras (`profiler`), autotune's probes of the grower and the
histogram route at init (`autotune_decision`), and the fault plan's
hooks and the step watchdog (`faults`, `_grow_step`; engine.train
checkpoints and resumes through `checkpoint`). Everything else raises
NotImplementedError naming the ROADMAP item that ports it. Prediction
covers every tree the JAX package writes except linear leaves on the
device routes.

Batched training (`can_batch_iters`, `train_iters_batched`, JAX gbdt.py:
1108-1418) runs chunks of iterations with no host round trip per
iteration on every wave route ("mega", "apply", "fused", "fused_tiled"),
with monotone intermediate, wave_exact and forced splits, and on the
serial growers masked and compact (models/batched.py, ops/grow_batched.py),
md5-equal to train_one_iter's models; a chunk's trees reach the model
through a worker thread (`start_drain`). The JAX package's vetoes keep the
per-iteration path; `batched_veto` names the reason. Past 256 bins a
feature the storage is uint16 and every wave takes the apply route
(`wave_routes`), as the JAX package's Pallas-free path does.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import json
import os
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.dataset import BinnedDataset
from ..metrics import Metric
from ..objectives import (ObjectiveFunction, create_objective,
                          percentile_ref, weighted_percentile_ref)
from ..ops.grow import (DeviceTree, GrowConfig, grow_tree,
                        serial_hist_route)
from ..ops.grow_fast import grow_tree_fast
from ..ops.grow_wave import (_wave_buckets, fused_veto_reasons,
                             grow_tree_wave, wave_routes)
from ..ops.histogram import add_leaf_values_, make_hist_plan
from ..ops.histogram_cuda import MAX_LEAVES
from ..ops.predict import predict_leaf_binned
from ..ops.split import FeatureMeta
from ..runtime.profiler import global_timer
from ..utils import resolve_device, round_up
from ..utils.log import log_fatal, log_info, log_warning
from .batched import AsyncTreeDrain, ChunkRunner
from .linear import fit_linear_models, linear_output_for_leaves
from .sample_strategy import create_sample_strategy
from .tree import (_CATEGORICAL_MASK, _DEFAULT_LEFT_MASK, Tree,
                   make_decision_type)

_KEPS = 1e-15
MODEL_VERSION = "v4"


def _not_ported(what: str, item: str) -> None:
    raise NotImplementedError(
        f"{what} is not ported to lightgbm_tpu_torch yet (ROADMAP item "
        f"{item})")


def check_slice_config(cfg: Config) -> None:
    """Refuse every configuration outside this slice, naming the ROADMAP
    item that will port it; none may quietly take another route. Linear
    trees with a distributed learner are fatal first, as in the JAX package
    (gbdt.py:494-496)."""
    distributed = (cfg.tree_learner != "serial" or cfg.num_machines > 1
                   or cfg.pre_partition)
    if cfg.linear_tree and distributed:
        log_fatal("linear_tree is not supported with distributed tree "
                  "learners (matches the reference)")
    if distributed:
        _not_ported("distributed training (tree_learner="
                    f"{cfg.tree_learner})", "A16")
    if cfg.num_leaves > MAX_LEAVES:
        # #2, #3, #5 and #10 stage the leaf tables in shared memory
        _not_ported(f"num_leaves > {MAX_LEAVES} (the kernels' "
                    f"{MAX_LEAVES}-entry leaf tables)", "A11, the leaf cap")


def _parse_interaction_constraints(spec) -> List[List[int]]:
    """'[0,1,2],[2,3]' or a list of lists -> list of real-index groups
    (gbdt.py:51-60; reference: config.h interaction_constraints)."""
    if not spec:
        return []
    if isinstance(spec, str):
        return [[int(x) for x in grp.split(",") if x.strip() != ""]
                for grp in re.findall(r"\[([^\]]*)\]", spec)]
    return [list(map(int, grp)) for grp in spec]


def parse_forced_splits(filename: str,
                        ds: BinnedDataset) -> Optional[np.ndarray]:
    """forcedsplits_filename's JSON -> [4, S] int32 BFS table of (inner
    feature, bin threshold, left id, right id), -1 for no child (gbdt.py:
    63-100; the reference reads the nested {feature, threshold, left,
    right} JSON in SerialTreeLearner::Init and walks it in ForceSplits,
    serial_tree_learner.cpp:628). Real thresholds become bin thresholds
    through the feature's bin mapper. A node on an unused feature is
    dropped with a warning (its branch stops forcing); one on a
    categorical feature is fatal. None when nothing is forced."""
    with open(filename) as f:
        root = json.load(f)
    if not root:
        return None
    real2inner = {r: i for i, r in enumerate(ds.real_feature_index)}
    is_cat = np.asarray(ds.feature_is_categorical())
    rows = []                # (feature, bin_thr, left, right)
    queue = [(root, -1, "")]
    while queue:
        node, parent_idx, side = queue.pop(0)
        real_f = int(node["feature"])
        thr = float(node["threshold"])
        if real_f not in real2inner:
            log_warning(f"forced split on trivial/unused feature {real_f} "
                        "ignored (its branch stops forcing)")
            continue
        inner = real2inner[real_f]
        if bool(is_cat[inner]):
            log_fatal("forced splits on categorical features are not "
                      "supported")
        bin_thr = int(ds.mappers[inner].value_to_bin(
            np.asarray([thr], np.float64))[0])
        idx = len(rows)
        rows.append([inner, bin_thr, -1, -1])
        if parent_idx >= 0:
            rows[parent_idx][2 if side == "left" else 3] = idx
        for s in ("left", "right"):
            if isinstance(node.get(s), dict) and node[s]:
                queue.append((node[s], idx, s))
    if not rows:
        return None
    return np.asarray(rows, np.int32).T          # [4, S]


def build_feature_meta(ds: BinnedDataset, device,
                       monotone: Optional[Sequence[int]] = None,
                       interactions=None) -> FeatureMeta:
    """The per-feature metadata in inner-feature order (gbdt.py:105-150):
    monotone directions and interaction sets come by real feature index
    and map to the used features; None where unconstrained."""
    def t(a):
        return torch.as_tensor(a).to(device)
    mono_t = None
    if monotone:
        # the reference fatals on a size mismatch (config.cpp
        # CheckParamConflict): no silent drops
        if len(monotone) != ds.num_total_features:
            log_fatal(f"monotone_constraints has {len(monotone)} entries "
                      f"but the dataset has {ds.num_total_features} "
                      "features")
        mono = np.zeros(len(ds.mappers), np.int8)
        for inner, real in enumerate(ds.real_feature_index):
            mono[inner] = np.sign(monotone[real])
        if mono.any():
            mono_t = t(mono)
    inter_t = None
    groups = _parse_interaction_constraints(interactions)
    if groups:
        real2inner = {r: i for i, r in enumerate(ds.real_feature_index)}
        sets = np.zeros((len(groups), len(ds.mappers)), bool)
        for s, grp in enumerate(groups):
            for real in grp:
                if real >= ds.num_total_features or real < 0:
                    log_fatal(f"interaction_constraints references feature "
                              f"{real}, but the dataset has "
                              f"{ds.num_total_features} features")
                if real in real2inner:   # unused (trivial) features are
                    sets[s, real2inner[real]] = True  # legitimately absent
        inter_t = t(sets)
    return FeatureMeta(
        num_bins=t(ds.feature_num_bins()),
        missing_type=t(ds.feature_missing_types()),
        default_bin=t(ds.feature_default_bins()),
        is_categorical=t(ds.feature_is_categorical()),
        monotone=mono_t, inter_sets=inter_t)


def bundle_maps(ds: BinnedDataset, B: int) -> Tuple[np.ndarray, np.ndarray]:
    """EFB search-time maps (gbdt.py:316-333): `expand` [F * B] gathers
    each original feature's bins out of the flat bundle histogram (fill
    index len(bundles) * B reads 0), `mfb` [F, B] marks each feature's
    default bin (FixHistogram)."""
    F = len(ds.mappers)
    expand = np.full((F, B), len(ds.bundles) * B, np.int64)
    mfb = np.zeros((F, B), np.float32)
    for f, m in enumerate(ds.mappers):
        ci, off = ds.bundle_col[f], ds.bundle_off[f]
        dbf, nbf = m.default_bin, m.num_bin
        mfb[f, dbf] = 1.0
        for b in range(nbf):
            if off < 0:
                expand[f, b] = ci * B + b
            elif b != dbf:
                expand[f, b] = ci * B + off + b - (1 if b > dbf else 0)
    return expand.reshape(-1), mfb


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
        # device trees not yet materialized on the host: (DeviceTree, bias,
        # the learning rate the tree was grown under)
        self._pending: List[Tuple[DeviceTree, float, float]] = []
        self._stop_check_interval = 32
        self._stopped = False
        self._cegb_used: Optional[torch.Tensor] = None
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
        self._valid_metrics: List[List[Metric]] = []
        # batched training (train_iters_batched): why the last
        # can_batch_iters refused ("" when it allowed), the chunk runners
        # by key, the attached tree drain, the runner calls made
        self.batched_veto = ""
        self._runners: "collections.OrderedDict" = collections.OrderedDict()
        self._drain: Optional[AsyncTreeDrain] = None
        self.drain_lags_ms: List[float] = []
        self._last_chunk_leaves: Optional[torch.Tensor] = None
        self.dispatch_count = 0
        self.best_iteration = -1
        self.loaded_parameter = ""
        self.max_feature_idx_ = 0
        self.feature_names_: List[str] = []
        self.feature_infos_: List[str] = []
        self.label_idx_ = 0
        self.mappers = []
        self.real_feature_index: List[int] = []
        # the runtime (runtime/): the stage profiler of device_profile and
        # the decision of autotune
        self.profiler = None
        self.autotune_decision: Optional[Dict] = None
        # resilience (runtime/faults.py): the fault plan (None, the
        # default, costs one `is None` check an iteration) and the step
        # watchdog's count of collective failures
        self._fault_plan = None
        self._collective_failures = 0
        if train_set is not None:
            self._init_train(train_set)

    # ------------------------------------------------------------------
    def _init_train(self, ds: BinnedDataset) -> None:
        cfg = self.config
        check_slice_config(cfg)
        self.device = resolve_device(cfg.device_type)
        from ..runtime.faults import active_plan
        self._fault_plan = active_plan(cfg.fault_plan)
        if cfg.device_profile:
            from ..runtime.profiler import StageProfiler
            self.profiler = StageProfiler(device=self.device)
            self.profiler.straggler_threshold = float(
                cfg.straggler_skew_threshold)
        self.num_data = ds.num_data
        self.max_feature_idx_ = ds.num_total_features - 1
        self.feature_names_ = list(ds.feature_names)
        self.feature_infos_ = ds.feature_infos()
        self.mappers = ds.mappers
        self.real_feature_index = list(ds.real_feature_index)

        max_bin = max((m.num_bin for m in ds.mappers), default=2)
        # EFB: ship the bundled columns to the device instead of the raw
        # matrix; a bundle column may hold more bins than any feature
        # (gbdt.py:288-300). The serial growers do not unpack bundles, so a
        # forced serial grower trains on the unbundled matrix
        bundled = ds.bundles is not None and cfg.tpu_grower in (
            "auto", "wave", "wave_exact")
        if bundled:
            max_bin = max(max_bin, int(ds.X_bundled.max()) + 1)
        self.num_bins_padded = B = max(round_up(max_bin, 8), 8)
        with self._prof_span("bin"):
            if bundled:
                self.X_t = torch.from_numpy(
                    np.ascontiguousarray(ds.X_bundled.T)).to(self.device)
            else:
                self.X_t = (ds.X_t if ds.X_t is not None
                            else torch.from_numpy(np.ascontiguousarray(
                                ds.X_binned.T))).to(self.device)
        self.meta = build_feature_meta(ds, self.device,
                                       cfg.monotone_constraints,
                                       cfg.interaction_constraints)
        if cfg.forcedsplits_filename:
            forced = parse_forced_splits(cfg.forcedsplits_filename, ds)
            if forced is not None:
                self.meta = self.meta._replace(forced=torch.from_numpy(
                    forced.astype(np.int64)).to(self.device))
        if bundled:
            expand, mfb = bundle_maps(ds, B)
            self.meta = self.meta._replace(
                bundle_expand=torch.from_numpy(expand).to(self.device),
                bundle_mfb=torch.from_numpy(mfb).to(self.device))
        self._select_grower(ds, bundled)
        self._init_cegb(ds, bundled)
        self._init_linear(ds)
        # per-STORAGE-COLUMN bin counts (gbdt.py:345-348); force_row_wise
        # pins the row-wise layout (gbdt.py:353-355)
        hist_tiers = (tuple(ds.storage_num_bins()) if bundled
                      else tuple(int(m.num_bin) for m in ds.mappers))
        hist_impl = str(cfg.histogram_impl)
        if cfg.force_row_wise and hist_impl == "auto":
            hist_impl = "rowwise"
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
            num_bins_padded=B,
            # slack >= 1 would block the top ready leaf forever; clamp
            wave_gain_slack=min(max(cfg.tpu_wave_gain_slack, 0.0), 0.99),
            wave_exact=cfg.tpu_grower == "wave_exact",
            hist_tiers=hist_tiers,
            hist_impl=hist_impl,
            fused_feature_tile=int(cfg.fused_feature_tile),
            fused_relabel_fusion=bool(cfg.fused_relabel_fusion),
            has_categorical=bool(ds.feature_is_categorical().any()),
            max_cat_to_onehot=cfg.max_cat_to_onehot,
            max_cat_threshold=cfg.max_cat_threshold,
            cat_l2=cfg.cat_l2,
            cat_smooth=cfg.cat_smooth,
            min_data_per_group=float(cfg.min_data_per_group),
            has_monotone=self.meta.monotone is not None,
            has_interaction=self.meta.inter_sets is not None,
            monotone_method=str(cfg.monotone_constraints_method),
            monotone_penalty=float(cfg.monotone_penalty),
            has_forced=self.meta.forced is not None,
            cegb_tradeoff=float(cfg.cegb_tradeoff),
            cegb_penalty_split=float(cfg.cegb_penalty_split),
            has_cegb_coupled=self.meta.cegb_coupled is not None,
            feature_fraction_bynode=float(cfg.feature_fraction_bynode),
            extra_trees=bool(cfg.extra_trees),
            extra_seed=int(cfg.extra_seed),
            use_quantized_grad=bool(cfg.use_quantized_grad),
            num_grad_quant_bins=int(cfg.num_grad_quant_bins),
            stochastic_rounding=bool(cfg.stochastic_rounding),
            quant_renew_leaf=bool(cfg.quant_train_renew_leaf),
            bundle_col=tuple(ds.bundle_col) if bundled else (),
            bundle_off=tuple(ds.bundle_off) if bundled else (),
            bundle_nb=(tuple(int(m.num_bin) for m in ds.mappers)
                       if bundled else ()),
            bundle_db=(tuple(int(m.default_bin) for m in ds.mappers)
                       if bundled else ()),
        )
        # autotune=true: the probes may change the grower and the
        # histogram_impl, before anything that follows from them is made
        self._autotune(ds, bundled, max_bin)
        self._set_routes()
        if self.profiler is not None:
            self._profile_init()

        md = ds.metadata
        N = self.num_data

        def dev(a):
            return None if a is None else torch.as_tensor(
                np.asarray(a, np.float32)).to(self.device)

        self.label_dev = dev(md.label)
        self.weight_dev = dev(md.weight)
        # [K, N] class-major scores (score_updater.hpp:27-47)
        self._has_init_score = md.init_score is not None
        self.scores = torch.from_numpy(self._initial_scores(
            md.init_score, N)).to(self.device)
        # bagging / GOSS (sample_strategy.cpp:16); the mask is drawn at
        # the first iteration and again where the strategy resamples
        self.sample_strategy = create_sample_strategy(cfg, N, md,
                                                      self.device)
        self._in_bag: Optional[torch.Tensor] = None
        if self.objective is not None:
            self.objective.init(md, N)
        for m in self.training_metrics:
            m.init(md, N)

    def _set_routes(self) -> None:
        """The route every tree of this run takes, from the grower and
        grow_cfg (recorded, so a run can show it against the kernels'
        launch counts): "fused", "fused_tiled", "mega" or "apply" for the
        wave grower, the serial grower's name otherwise, and the histogram
        route; under histogram_impl=fused, why a fused kernel does not run
        (empty when one does; the profile extras entry of gbdt.py:
        674-687); and the row-wise layouts' plan (and the nibble pack),
        made once. A resumed run calls it again for its pinned grower and
        histogram_impl (runtime/checkpoint.py)."""
        if self.grower in ("masked", "compact"):
            self.grow_route = self.grower
            self.hist_route = serial_hist_route(self.grow_cfg,
                                                self.X_t.shape[0])
        else:
            self.grow_route, self.hist_route = wave_routes(
                self.grow_cfg, self.X_t.shape[0])
        self.fused_veto_reasons = (
            fused_veto_reasons(self.grow_cfg)
            if self.grow_cfg.hist_impl == "fused"
            and self.grower in ("wave", "wave_exact") else [])
        if self.fused_veto_reasons:
            log_warning("histogram_impl=fused: the fused kernels are "
                        f"vetoed ({', '.join(self.fused_veto_reasons)}); "
                        f"route {self.grow_route}")
        self.hist_plan = make_hist_plan(self.X_t, self.hist_route,
                                        self.grow_cfg.hist_tiers)
        log_info(f"grower {self.grower}, route: {self.grow_route} "
                 f"(histogram: {self.hist_route}, {self.X_t.shape[0]} "
                 f"storage columns, B={self.num_bins_padded})")

    def _select_grower(self, ds: BinnedDataset, bundled: bool) -> None:
        """The grower (gbdt.py:404-469): a forced tpu_grower passes through;
        auto walks the histogram_pool_size ladder, "wave" when its two
        [L, 3, F, B] histogram caches and two [KMAX, 3, F, B] wave
        temporaries fit, else "compact" when one [L, 3, F, B] cache fits,
        else "masked" (the reference bounds the analogous structure with
        histogram_pool_size, serial_tree_learner.cpp:40). EFB-bundled
        storage, quantized gradients, constraints, forced splits and the
        per-node draws take the wave grower whatever the ladder said, with
        the JAX package's warnings; CEGB's switch is in `_init_cegb`.
        `_grower_feasible` lists the growers whose caches fit."""
        cfg = self.config
        cache_bytes = (cfg.num_leaves * len(ds.mappers)
                       * self.num_bins_padded * 3 * 4)
        wave_bytes = cache_bytes * 2 + (
            _wave_buckets(cfg.num_leaves)[-1] * len(ds.mappers)
            * self.num_bins_padded * 3 * 4) * 2
        pool_limit = (cfg.histogram_pool_size * 1024 * 1024
                      if cfg.histogram_pool_size > 0 else 512 * 1024 * 1024)
        if cfg.tpu_grower in ("compact", "masked", "wave", "wave_exact"):
            self.grower = cfg.tpu_grower
        elif wave_bytes <= pool_limit:
            self.grower = "wave"
        elif cache_bytes <= pool_limit:
            self.grower = "compact"
        else:
            self.grower = "masked"
        self._ladder_choice = self.grower
        self._grower_feasible = ["masked"]
        if cache_bytes <= pool_limit:
            self._grower_feasible.insert(0, "compact")
        if wave_bytes <= pool_limit:
            self._grower_feasible.insert(0, "wave")
        wave = ("wave", "wave_exact")
        if bundled and self.grower not in wave:
            # the storage is bundled already and the serial growers cannot
            # unpack bundles (histogram_pool_size is a soft hint)
            wave_bytes_b = 2 * (cfg.num_leaves
                                + _wave_buckets(cfg.num_leaves)[-1]) \
                * len(ds.bundles) * self.num_bins_padded * 2 * 4
            if wave_bytes_b > pool_limit:
                log_warning(
                    "EFB wave histogram caches (%.0f MB) exceed "
                    "histogram_pool_size; using the wave grower anyway"
                    % (wave_bytes_b / 1e6))
            self.grower = "wave"
        if cfg.use_quantized_grad and self.grower not in wave:
            log_warning("use_quantized_grad is implemented by the wave "
                        "grower; switching tpu_grower to 'wave'")
            self.grower = "wave"
        if (self.meta.monotone is not None
                or self.meta.inter_sets is not None
                or self.meta.forced is not None
                or cfg.feature_fraction_bynode < 1.0
                or cfg.extra_trees) and self.grower not in wave:
            log_warning("monotone/interaction/forced-split/by-node-"
                        "sampling/extra_trees features are implemented by "
                        "the wave grower; switching tpu_grower to 'wave'")
            self.grower = "wave"

    def _init_linear(self, ds: BinnedDataset) -> None:
        """Linear trees (gbdt.py:491-507; linear_tree_learner.cpp): the fit
        reads the training rows' raw values, which the Dataset keeps only
        under linear_tree; `linear_fit_ms` records each tree's host fit."""
        self._linear = bool(self.config.linear_tree)
        self.linear_fit_ms: List[float] = []
        if not self._linear:
            return
        if ds.raw_data is None:
            log_fatal(
                "linear_tree requires raw feature values at train "
                "time; construct the Dataset from an in-memory "
                "matrix or text file (binary caches, Sequences and "
                "sparse inputs do not retain raw data)")
        self._raw = ds.raw_data
        self._lin_numeric = ~ds.feature_is_categorical()
        self._lin_inner2real = np.asarray(ds.real_feature_index, np.int64)

    def _init_cegb(self, ds: BinnedDataset, bundled: bool) -> None:
        """CEGB's split and coupled penalties (gbdt.py:508-540;
        cost_effective_gradient_boosting.hpp): the coupled vector by inner
        feature, and the [F] state of the features the model has split
        on, which carries over trees and over a round's K trees. The lazy
        penalty, a coupled vector of the wrong length and EFB bundles are
        fatal, with the JAX package's messages; a serial grower switches
        to the wave grower, with its warning."""
        cfg = self.config
        if cfg.cegb_penalty_feature_lazy:
            log_fatal("cegb_penalty_feature_lazy is not implemented in "
                      "lightgbm_tpu yet")
        self._cegb_used = None
        if not (cfg.cegb_penalty_split > 0.0
                or cfg.cegb_penalty_feature_coupled):
            return
        if cfg.cegb_penalty_feature_coupled:
            if len(cfg.cegb_penalty_feature_coupled) \
                    != ds.num_total_features:
                log_fatal("cegb_penalty_feature_coupled should be the "
                          "same size as feature number.")
            cpl = np.zeros(len(ds.mappers), np.float32)
            for inner, real in enumerate(ds.real_feature_index):
                cpl[inner] = cfg.cegb_penalty_feature_coupled[real]
            self.meta = self.meta._replace(
                cegb_coupled=torch.from_numpy(cpl).to(self.device))
        if self.grower not in ("wave", "wave_exact"):
            log_warning("cegb_* is implemented by the wave grower; "
                        "switching tpu_grower to 'wave'")
            self.grower = "wave"
        if bundled:
            log_fatal("cegb_* with EFB bundling (enable_bundle) is "
                      "not supported; set enable_bundle=false")
        self._cegb_used = torch.zeros(len(ds.mappers), dtype=torch.bool,
                                      device=self.device)

    # ------------------------------------------------------------------
    # the runtime: autotune and device_profile (runtime/)
    # ------------------------------------------------------------------
    def _autotune(self, ds: BinnedDataset, bundled: bool,
                  max_bin: int) -> None:
        """autotune=true (gbdt.py:590-672): probe the feasible growers, the
        histogram routes and the fused wave on a row subsample of X_t
        (runtime/autotune.py) and take the winner's grower and
        histogram_impl. Skipped with the JAX package's warning when the
        choice is constrained: a forced tpu_grower, a feature that forced
        the wave grower, or linear trees. On EFB-bundled storage only the
        wave grower is a candidate (the serial growers cannot read bundle
        columns; the JAX package's serial probes fail there and drop out).
        The decision lands in `autotune_decision` and in the profile's
        extras."""
        cfg = self.config
        if not cfg.autotune:
            return
        if cfg.tpu_grower != "auto" or self.grower != self._ladder_choice \
                or self._linear:
            log_warning(
                "autotune=true ignored: the grower choice is constrained "
                "(forced tpu_grower, distributed/linear mode, or a feature "
                "only the wave grower implements)")
            return
        from ..runtime.autotune import (COL_WISE_HIST_IMPLS,
                                        autotune_decision, current_pin)
        cands = ["wave"] if bundled else list(self._grower_feasible)
        pinned = current_pin()
        if pinned:
            # a resumed run takes its checkpoint's decision, unprobed
            decision = dict(pinned, cached="checkpoint")
        else:
            with self._prof_span("autotune"):
                decision = autotune_decision(
                    self.X_t, self.meta, self.grow_cfg, cands,
                    n_rows=self.num_data, n_features=len(ds.mappers),
                    max_bin=max_bin, num_leaves=cfg.num_leaves,
                    rows_per_chunk=cfg.tpu_rows_per_block * 8,
                    cache_path=cfg.autotune_cache, seed=int(cfg.seed or 0),
                    hist_impl_candidates=(COL_WISE_HIST_IMPLS
                                          if cfg.force_col_wise else None))
        self.autotune_decision = decision
        if decision.get("grower") in cands:
            if decision["grower"] != self.grower:
                log_info("autotune: probes picked grower "
                         f"'{decision['grower']}' over ladder choice "
                         f"'{self.grower}'")
            self.grower = decision["grower"]
        hist_impl = decision.get("hist_impl")
        if hist_impl in ("rowwise", "rowwise_packed") and cfg.force_col_wise:
            # a decision cached by an unconstrained run; the layout pin
            # outranks it
            hist_impl = None
        if hist_impl and hist_impl != self.grow_cfg.hist_impl:
            log_info(f"autotune: probes picked histogram impl '{hist_impl}'")
            self.grow_cfg = self.grow_cfg._replace(hist_impl=str(hist_impl))
        if self.profiler is not None:
            self.profiler.extras["autotune"] = decision

    def _prof_span(self, name: str):
        """The active profiler's span, or a no-op context."""
        return (self.profiler.span(name) if self.profiler is not None
                else contextlib.nullcontext())

    def _count_dispatch(self, n: int = 1) -> None:
        """Count a host dispatch of batched training (the chunk's graph
        replays), mirrored into the profiler's `dispatches` counter."""
        self.dispatch_count += n
        if self.profiler is not None:
            self.profiler.add_counter("dispatches", n)

    def _profile_init(self) -> None:
        """The init-time profile extras (gbdt.py:674-690): on the wave
        grower the fused kernels' veto list and, when none vetoes, the
        fused wave's geometry and one probe of it; then the histogram
        routes' record and spans."""
        if self.grower == "wave":
            vetoes = fused_veto_reasons(self.grow_cfg)
            self.profiler.extras["fused_veto_reasons"] = list(vetoes)
            if not vetoes:
                self._profile_fused_wave()
        if self.grow_cfg.hist_tiers:
            self._profile_hist_tiers()

    def _profile_fused_wave(self) -> None:
        """The fused route's launch geometry and one fenced span of the
        kernels it launches (gbdt.py:700-732): #9 on the narrow route, #10
        on the general one, each against its two-pass wave
        (runtime/autotune.py:probe_fused_wave), so the profile carries a
        per-wave fused-launch cost."""
        from ..runtime.autotune import probe_fused_wave
        cfg = self.grow_cfg
        F = int(self.X_t.shape[0])
        narrow = self.grow_route == "fused"
        tile = int(cfg.fused_feature_tile)
        fused = self.profiler.extras["fused"] = {
            "path": "fused" if narrow else "fused_tiled",
            "feature_tile": tile,
            "feature_tiles": 1 if narrow else -(-F // tile),
            "relabel_fusion": bool(cfg.fused_relabel_fusion
                                   and not narrow)}
        with self._prof_span("fused_wave_probe"):
            times = probe_fused_wave(self.X_t, cfg, seed=0)
        fused["probe_s"] = {k: round(float(v), 6) for k, v in times.items()}

    def _profile_hist_tiers(self) -> None:
        """The histogram routes' record and spans (gbdt.py:734-784). The
        JAX package records its tiered TPU kernels' bin-width classes
        (`hist_tiers`) and times one span a class (`hist_class_b{w}`); on
        the card the three col-wise layouts are one launch of #1 at B =
        num_bins_padded (ops/histogram.py), so the port writes no
        `hist_tiers` and no class spans, and times one `hist_slots` span
        of that launch instead. `hist_impl`, `hist_rowwise` and
        `hist_pack4` are recorded as the JAX package computes them, and
        `hist_rowwise` / `hist_rowwise_packed` spans time the row-wise
        kernels (#7, #8) where their routes run. Each span is one call on
        the first 65536 rows after a warm call. Skipped past 256 bins,
        where only the slots route runs."""
        from ..data.dataset import _lane_width
        from ..ops.histogram import build_histogram
        from ..ops.histogram_rowwise import (build_pack4_plan,
                                             build_rowwise_plan,
                                             pack4_worthwhile)
        tiers = tuple(int(t) for t in self.grow_cfg.hist_tiers)
        if max(tiers) > 256:
            return
        extras = self.profiler.extras
        extras["hist_impl"] = self.grow_cfg.hist_impl
        rplan = build_rowwise_plan(tiers)
        extras["hist_rowwise"] = {
            "flat_cols": rplan.total,
            "col_wise_cols": sum(_lane_width(t) for t in tiers),
            "chunks": len(rplan.chunks)}
        pplan = build_pack4_plan(tiers)
        extras["hist_pack4"] = {
            "n_packed": pplan.n_packed,
            "n_rest": pplan.n_rest,
            # binned-operand stream bytes vs the unpacked storage matrix
            "stream_frac": round(
                (((pplan.n_packed + 1) // 2) + max(pplan.n_rest, 1))
                / max(len(tiers), 1), 4)}
        n_probe = int(min(self.num_data, 65536))
        Xs = self.X_t[:, :n_probe].contiguous()
        vals = torch.ones((2, n_probe), dtype=torch.float32,
                          device=self.device)
        B = self.num_bins_padded

        def span(name: str, route: str) -> None:
            plan = make_hist_plan(Xs, route, tiers)
            build_histogram(Xs, vals, B, impl=route, plan=plan)
            with self._prof_span(name):
                build_histogram(Xs, vals, B, impl=route, plan=plan)

        span("hist_slots", "slots")
        if rplan.total > 0:
            span("hist_rowwise", "rowwise")
            if pack4_worthwhile(pplan):
                span("hist_rowwise_packed", "rowwise_packed")

    # ------------------------------------------------------------------
    def add_valid_dataset(self, ds: BinnedDataset, name: str,
                          metrics: Sequence[Metric]) -> None:
        """Score `ds` each round from now on; a model that already has
        trees (a late valid set, continued training) is replayed onto its
        starting scores first, tree by tree in model order, on the device
        (gbdt.py:966-990)."""
        Xv = torch.from_numpy(np.ascontiguousarray(ds.X_binned.T)).to(
            self.device)
        scores = torch.from_numpy(self._initial_scores(
            ds.metadata.init_score, ds.num_data)).to(self.device)
        if self.models:
            self._replay(self.models, Xv, scores, ds.raw_data)
        self._valid_Xt.append(Xv)
        self._valid_scores.append(scores)
        self.valid_sets.append(ds)
        self.valid_names.append(name)
        self._valid_metrics.append(list(metrics))
        for m in metrics:
            m.init(ds.metadata, ds.num_data)

    def _initial_scores(self, init_score, n: int) -> np.ndarray:
        """[K, n] f32 starting scores: zeros plus `init_score` (K * n
        values class-major, or n values for every class)."""
        K = self.num_tree_per_iteration
        scores = np.zeros((K, n), dtype=np.float32)
        if init_score is not None:
            init = np.asarray(init_score, np.float64).reshape(-1)
            scores += init.reshape(K, n) if init.size == K * n \
                else init.reshape(1, n)
        return scores

    # ------------------------------------------------------------------
    @property
    def models(self) -> List[Tree]:
        """Host trees; materializes any pending device trees first."""
        if self._pending:
            pending, self._pending = self._pending, []
            with global_timer.section("GBDT::MaterializeModels"):
                for tree_dev, bias, lr in pending:
                    tree = self._device_tree_to_host(tree_dev, lr)
                    if abs(bias) > _KEPS:
                        tree.add_bias(bias)
                    self._models.append(tree)
        return self._models

    def _check_stopped(self) -> bool:
        """Report whether the last iteration's K trees are all stumps
        (reference stop condition, gbdt.cpp:376-384)."""
        K = self.num_tree_per_iteration
        counts = [p[0].num_leaves for p in self._pending[-K:]] \
            or [t.num_leaves for t in self._models[-K:]]
        if counts and all(int(c) <= 1 for c in counts):
            log_warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            return True
        return False

    def _boost_from_average(self) -> np.ndarray:
        """gbdt.cpp:328: each class's initial score from the objective's
        average (gbdt.py:1818-1840)."""
        K = self.num_tree_per_iteration
        init_scores = np.zeros(K)
        if (self.objective is None or self._has_init_score
                or not self.config.boost_from_average):
            return init_scores
        for k in range(K):
            init_scores[k] = init = float(self.objective.boost_from_score(k))
            if abs(init) > _KEPS:
                self.scores[k] += float(np.float32(init))
                for vs in self._valid_scores:
                    vs[k] += float(np.float32(init))
                log_info(f"Start training from score {init:.6f}")
        return init_scores

    def _feature_mask_np(self, it: int) -> Optional[np.ndarray]:
        """Iteration `it`'s feature_fraction mask [F] bool, drawn from the
        host RandomState(feature_fraction_seed + it); None without one."""
        frac = self.config.feature_fraction
        F = len(self.mappers)
        if frac >= 1.0:
            return None
        used = max(1, int(round(F * frac)))
        rng = np.random.RandomState(self.config.feature_fraction_seed + it)
        mask = np.zeros(F, dtype=bool)
        mask[rng.choice(F, used, replace=False)] = True
        return mask

    def _feature_mask_for_iter(self) -> Optional[torch.Tensor]:
        mask = self._feature_mask_np(self.iter)
        return None if mask is None else torch.from_numpy(mask).to(
            self.device)

    def tree_seed(self, it: int, k: int = 0) -> int:
        """The seed of iteration `it`'s tree of class k,
        (seed + it) * K + k as the int32 the JAX package passes
        (gbdt.py:1488-1498)."""
        K = self.num_tree_per_iteration
        v = ((self.config.seed or 0) + it) * K + k
        return (v + 2 ** 31) % 2 ** 32 - 2 ** 31

    def _gradients(self, scores: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[K, N] gradients and hessians of the current [K, N] scores (or
        of `scores`) (GBDT::Boosting, gbdt.cpp:229): a tensor function on
        the scores' device, or for objectives that run on the host
        (rank_xendcg) the scores pulled once, NumPy, and the result
        uploaded (gbdt.py:1087-1096)."""
        K = self.num_tree_per_iteration
        scores = self.scores if scores is None else scores
        if self.objective.runs_on_host:
            g, h = self.objective.get_gradients_numpy(
                scores.cpu().numpy().reshape(-1))
            return (torch.from_numpy(g.reshape(K, -1)).to(self.device),
                    torch.from_numpy(h.reshape(K, -1)).to(self.device))
        if K > 1:
            return self.objective.get_gradients(scores, self.label_dev,
                                                self.weight_dev)
        g, h = self.objective.get_gradients(scores[0], self.label_dev,
                                            self.weight_dev)
        return g[None], h[None]

    def _custom_rows(self, a) -> torch.Tensor:
        """Caller-given gradients or hessians ([N] or [K * N] values,
        class-major; a NumPy array or a tensor on any device) as [K, N]
        f32 on the scores' device (gbdt.py:1451-1458)."""
        K = self.num_tree_per_iteration
        if isinstance(a, torch.Tensor):
            t = a.detach().to(torch.float32)
        else:
            t = torch.from_numpy(np.ascontiguousarray(
                np.asarray(a, np.float32)))
        return t.reshape(K, -1).to(self.scores.device)

    def train_one_iter(self, grad=None, hess=None) -> bool:
        """One boosting iteration (GBDT::TrainOneIter, gbdt.cpp:353;
        gbdt.py:1437-1530): gradients once for all K classes, then K trees.
        With `grad` and `hess` given (a custom objective's, gbdt.py:
        1447-1458) those are the iteration's gradients, and no score is
        boosted from the average. Sampling, quantization and leaf renewal
        see them as they see the objective's. Returns True if training
        should stop (no splits possible). Under device_profile the
        iteration is one ring record with the JAX package's spans, "boost",
        "bagging" (where the mask is drawn), "grow" and "score-update" a
        tree, and after the first iteration the stage probe."""
        if self._fault_plan is not None:
            self._fault_plan.at_iteration(self.iter)
        K = self.num_tree_per_iteration
        prof = self.profiler
        if prof is not None:
            prof.iter_start()
        init_scores = np.zeros(K)
        with self._prof_span("boost"):
            if grad is None or hess is None:
                if self.iter == 0:
                    init_scores = self._boost_from_average()
                if self.objective is None:
                    log_fatal("No objective function provided for boosting")
                g, h = self.boost()
            else:
                g, h = self._custom_rows(grad), self._custom_rows(hess)
        strat = self.sample_strategy
        if self._in_bag is None or strat.resamples_at(self.iter):
            with self._prof_span("bagging"):
                self._in_bag = strat.sample(self.iter, g, h)
        feat_mask = self._feature_mask_for_iter()
        lr = self.shrinkage_rate
        for k in range(K):
            with global_timer.section("GBDT::TrainOneIter/grow"), \
                    self._prof_span("grow"):
                tree, leaf_of_row = self._grow_step(
                    g[k], h[k], self._in_bag, feat_mask,
                    self.tree_seed(self.iter, k))
            if self._cegb_used is not None and tree.num_leaves > 1:
                # the features this tree split on are paid for: later trees,
                # the round's next class included, use them freely
                # (cost_effective_gradient_boosting.hpp:110; gbdt.py:
                # 912-932)
                self._cegb_used[tree.split_feature[:tree.num_leaves - 1]] \
                    = True
            if self.objective is not None \
                    and self.objective.need_renew_tree_output:
                tree = self._renew_tree_output(k, tree, leaf_of_row)
            if self._linear:
                # scores advance by the trees' linear outputs (gbdt.py:
                # 1504-1510)
                self._fit_and_apply_linear(k, tree, leaf_of_row, g[k], h[k],
                                           float(init_scores[k]))
                continue
            with self._prof_span("score-update"):
                add_leaf_values_(self.scores[k], tree.leaf_value * lr,
                                 leaf_of_row)
                # valid scores update BEFORE the bias fold (the reference
                # updates scores before AddBias, gbdt.cpp:424-428)
                for vi, Xv in enumerate(self._valid_Xt):
                    leaf = predict_leaf_binned(
                        tree.split_feature, tree.threshold_bin,
                        tree.default_left, tree.left_child,
                        tree.right_child, tree.num_leaves, Xv, self.meta,
                        tree.split_is_cat, tree.split_cat_bitset)
                    self._valid_scores[vi][k] += (tree.leaf_value * lr)[leaf]
            self._pending.append((tree, float(init_scores[k]), lr))
        self.iter += 1
        if prof is not None:
            prof.iter_end(n_rows=self.num_data)
            if "stage_probe" not in prof.extras:
                # once: the grow span's decomposition into #1, the split
                # search and a partition (runtime/profiler.py)
                from ..runtime.profiler import probe_stage_breakdown
                prof.extras["stage_probe"] = probe_stage_breakdown(
                    self.X_t, g[0], h[0], self.meta, self.grow_cfg)
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
    # resilience: the step watchdog (JAX gbdt.py:1567-1610)
    # ------------------------------------------------------------------
    def _grow_step(self, g: torch.Tensor, h: torch.Tensor,
                   in_bag: torch.Tensor, feat_mask: Optional[torch.Tensor],
                   seed: int) -> Tuple[DeviceTree, torch.Tensor]:
        """One tree under the step watchdog: a failed grow step is retried
        up to step_max_retries times with exponential backoff, else
        raised. A tree is a pure function of its inputs, so a retry cannot
        change the model. A collective failure (fault plan
        `fail_collective`) is counted; the JAX package's degrade of the
        histogram exchange after two of them needs a mesh, so on one card
        it is retried like any failure, as in the JAX package's serial
        run (the degrade comes with A16)."""
        retries = int(self.config.step_max_retries)
        if self._fault_plan is None and retries == 0:
            return self.grow_one(g, h, in_bag, feat_mask, seed,
                                 cegb_used=self._cegb_used)
        from ..runtime.faults import is_collective_error
        attempt = 0
        while True:
            try:
                if self._fault_plan is not None:
                    self._fault_plan.maybe_fail_collective(self.iter)
                return self.grow_one(g, h, in_bag, feat_mask, seed,
                                     cegb_used=self._cegb_used)
            except Exception as e:
                if is_collective_error(e):
                    self._collective_failures += 1
                    log_warning(
                        f"histogram-exchange failure "
                        f"#{self._collective_failures} at iteration "
                        f"{self.iter}: {e}")
                attempt += 1
                if attempt > retries:
                    raise
                backoff = self.config.step_retry_backoff_s \
                    * (2 ** (attempt - 1))
                log_warning(
                    f"grow step failed at iteration {self.iter} (attempt "
                    f"{attempt}/{retries}): {e}; retrying in "
                    f"{backoff:.3f}s")
                if backoff > 0:
                    time.sleep(backoff)

    # ------------------------------------------------------------------
    # batched training: chunks of iterations with no host round trip per
    # iteration (JAX gbdt.py:1108-1418; models/batched.py)
    # ------------------------------------------------------------------
    _RUNNER_CACHE_MAX = 4     # a bounded LRU, as the JAX _SCAN_CACHE_MAX

    def _batched_sampling_mode(self) -> str:
        """"scan": the in-bag mask is drawn inside the chunk as a function
        of the iteration (bagging, GOSS); "host": a mask that stays
        constant over the chunk is passed in (JAX gbdt.py:1119-1127)."""
        strat = self.sample_strategy
        if strat.supports_scan and (strat.resample_period() > 0
                                    or strat.needs_grad):
            return "scan"
        return "host"

    def _device_metric_layout(self):
        """[(valid index, metric, device fn)] over every valid-set metric,
        or None when one has no device form (JAX gbdt.py:1129-1142)."""
        out = []
        for vi, metrics in enumerate(self._valid_metrics):
            for m in metrics:
                fn = m.device_eval_fn(self.objective)
                if fn is None:
                    return None
                out.append((vi, m, fn))
        return out

    def batched_eval_layout(self):
        """(valid name, metric name, higher better) of each column of a
        chunk's metric values; None when a metric has no device form."""
        lay = self._device_metric_layout()
        if lay is None:
            return None
        return [(self.valid_names[vi], m.result_name(), m.is_higher_better)
                for vi, m, _ in lay]

    def _batched_refusal(self, n: int) -> str:
        """Why `n` iterations from self.iter cannot run batched; "" when
        they can. The JAX package's vetoes (gbdt.py:1155-1204)."""
        if type(self) is not GBDT:
            return f"boosting={self.config.boosting}"
        if not self.config.batched_train:
            return "batched_train=false"
        if os.environ.get("LIGHTGBM_TPU_DISABLE_BATCHED", "") \
                not in ("", "0"):
            return "LIGHTGBM_TPU_DISABLE_BATCHED"
        if self.num_tree_per_iteration != 1:
            return "multiclass (K > 1)"
        if self._linear:
            return "linear_tree"
        if self.objective is None or self.objective.runs_on_host:
            return "an objective on the host"
        if self.objective.need_renew_tree_output:
            return "leaf renewal (objective)"
        if self._cegb_used is not None:
            return "CEGB"
        if self._fault_plan is not None:
            # its kill / raise / collective hooks fire in train_one_iter
            return "fault_plan"
        strat = self.sample_strategy
        if self._batched_sampling_mode() == "host":
            if strat.needs_grad:
                return "gradient-aware sampling off the device"
            p = strat.resample_period()
            if p > 0 and (self.iter + n - 1) // p > self.iter // p:
                return "a resample inside the chunk"
        if self.valid_sets and self._device_metric_layout() is None:
            return "a valid metric without a device form"
        return ""

    def can_batch_iters(self, n: int) -> bool:
        """Whether `n` iterations from self.iter may run as one batched
        chunk (train_iters_batched), with the models of n train_one_iter
        calls. Sets `batched_veto` to the reason when not ("" when so)."""
        self.batched_veto = self._batched_refusal(n)
        return not self.batched_veto

    def _runner(self, chunk: int, mode: str, layout) -> ChunkRunner:
        """The chunk runner (its buffers and captured graphs) of this
        key, from a bounded LRU; a tail chunk reuses its chunk's."""
        metric_sig = tuple((vi, type(m).__name__, m.result_name())
                           for vi, m, _ in (layout or []))
        key = (self.grow_route, self.grow_cfg, self.X_t.shape,
               self.X_t.data_ptr(), chunk, mode, len(self.valid_sets),
               metric_sig)
        runner = self._runners.get(key)
        if runner is not None:
            self._runners.move_to_end(key)
            return runner
        runner = self._runners[key] = ChunkRunner(self, chunk, mode, layout)
        while len(self._runners) > self._RUNNER_CACHE_MAX:
            self._runners.popitem(last=False)
        return runner

    def train_iters_batched(self, n: int, n_pad: Optional[int] = None
                            ) -> Optional[torch.Tensor]:
        """Run `n` boosting iterations as one chunk with no host round
        trip per iteration (JAX gbdt.py:1206-1304); the caller checked
        can_batch_iters. `n_pad` is the chunk the runner is sized for (a
        tail chunk of n < n_pad replays the same graphs). Returns the
        chunk's [n, M] device metric values (columns as
        batched_eval_layout), or None without valid metrics."""
        n_pad = max(n, int(n_pad or n))
        prof = self.profiler
        if prof is not None:
            # one fence before the chunk and one after it, none inside a
            # captured graph
            from ..runtime.profiler import device_barrier
            device_barrier(self.device)
            t0 = time.perf_counter()
        init = 0.0
        if self.iter == 0:
            init = float(self._boost_from_average()[0])
        mode = self._batched_sampling_mode()
        in_bag = None
        if mode == "host":
            strat = self.sample_strategy
            if self._in_bag is None or strat.resamples_at(self.iter):
                self._in_bag = strat.sample(self.iter, None, None)
            in_bag = self._in_bag
        layout = self._device_metric_layout() if self.valid_sets else []
        runner = self._runner(n_pad, mode, layout)
        its = [self.iter + i for i in range(n)]
        masks = None
        if runner.has_fmask:
            masks = np.stack([self._feature_mask_np(it) for it in its])
        lr = self.shrinkage_rate
        with global_timer.section("GBDT::TrainItersBatched/scan"):
            runner.run(n, its, [self.tree_seed(it) for it in its], masks,
                       lr, in_bag)
        self._count_dispatch()
        self._last_chunk_leaves = runner.stack["num_leaves"][n - 1].clone()
        biases = [init if it == 0 else 0.0 for it in its]
        if self._drain is not None:
            self._drain.submit((runner.record(n, True), biases, lr))
        else:
            rec, _ = runner.record(n, False)
            for i in range(n):
                tree = DeviceTree(**{k: rec[k][i] for k in rec})
                self._pending.append((tree, biases[i], lr))
        self.iter += n
        if prof is not None:
            device_barrier(self.device)
            prof.record_batched_chunk(n, time.perf_counter() - t0,
                                      n_rows=self.num_data * n)
        if not runner.metric_fns:
            return None
        return runner.mbuf[:n].clone()

    def _record_to_trees(self, rec: Dict[str, torch.Tensor],
                         biases: List[float], lr: float) -> List[Tree]:
        """Host trees of a chunk record ({field: [n, ...]}), the first
        tree of the model with the boost-from-average bias folded in."""
        trees = []
        for i, bias in enumerate(biases):
            tree = self._device_tree_to_host(
                DeviceTree(**{k: rec[k][i] for k in rec}), lr)
            if abs(bias) > _KEPS:
                tree.add_bias(bias)
            trees.append(tree)
        return trees

    def batched_stopped(self) -> bool:
        """The amortized stop check of batched training (one read): the
        last chunk's last tree is a stump (gbdt.cpp:376-384)."""
        if self._last_chunk_leaves is None \
                or int(self._last_chunk_leaves) > 1:
            return False
        log_warning("Stopped training because there are no more leaves "
                    "that meet the split requirements")
        return True

    def start_drain(self) -> None:
        """Attach a tree drain: chunk records go to a worker thread that
        converts them to host trees while the next chunk runs. The
        pending per-iteration trees are materialized first, so the model
        stays in order. Idempotent."""
        if self._drain is not None:
            return
        _ = self.models
        self._drain = AsyncTreeDrain(self)

    def stop_drain(self) -> None:
        """Join the drain, folding what it converted into the model; safe
        to call repeatedly or without start_drain."""
        drain, self._drain = self._drain, None
        if drain is not None:
            try:
                drain.close()
            finally:
                self.drain_lags_ms.extend(drain.lags_ms)

    def truncate_to_iteration(self, n_iters: int) -> None:
        """Keep the first `n_iters` iterations' trees (the stop of batched
        early stopping: a later tree never changed an earlier iteration's
        metrics, so the model is the one a live stop gives). The scores
        keep the surplus trees' outputs, as in the JAX package
        (gbdt.py:1420-1435)."""
        if self._drain is not None:
            self._drain.flush()
        keep = n_iters * self.num_tree_per_iteration
        models = self.models
        if keep < len(models):
            del models[keep:]
        self.iter = min(self.iter, n_iters)
        self._packed_cache = None
        self._device_tables_cache = None

    def grow_one(self, g: torch.Tensor, h: torch.Tensor,
                 in_bag: torch.Tensor, feat_mask: Optional[torch.Tensor],
                 seed: int, cegb_used: Optional[torch.Tensor] = None,
                 plain: bool = False) -> Tuple[DeviceTree, torch.Tensor]:
        """One tree on this run's grower (gbdt.py:886-893): the wave grower
        (with its seed and CEGB's used features) or a serial one, which
        takes no seed; `plain=True` runs the kernels' plain versions."""
        if self.grower in ("masked", "compact"):
            fn = grow_tree if self.grower == "masked" else grow_tree_fast
            return fn(self.X_t, g, h, in_bag, self.meta, self.grow_cfg,
                      feat_mask, hist_plan=self.hist_plan, plain=plain)
        return grow_tree_wave(self.X_t, g, h, in_bag, self.meta,
                              self.grow_cfg, feat_mask,
                              hist_plan=self.hist_plan, rng_seed=seed,
                              cegb_used=cegb_used, plain=plain)

    def boost(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The iteration's [K, N] gradients and hessians (GBDT::Boosting;
        random forests keep their first ones)."""
        return self._gradients()

    def _fit_and_apply_linear(self, k: int, tree_dev: DeviceTree,
                              leaf_of_row: torch.Tensor, g: torch.Tensor,
                              h: torch.Tensor, bias: float) -> None:
        """Materialize class k's new tree, ridge-fit its leaves on the raw
        branch features on the host (models/linear.py;
        linear_tree_learner.cpp:183-345), advance the training and valid
        scores by its linear outputs, fold the boost-from-average `bias` in
        and keep the host tree (gbdt.py:1737-1781). The first tree of a
        model stays constant."""
        t0 = time.perf_counter()
        lr = self.shrinkage_rate
        tree = self._device_tree_to_host(tree_dev, lr)
        lor, g, h, bag = (t.cpu().numpy() for t in (leaf_of_row, g, h,
                                                    self._in_bag))
        # pending trees first, so the model stays in iteration order
        is_first = len(self.models) < self.num_tree_per_iteration
        delta = fit_linear_models(
            tree, self._raw, lor, g, h, bag,
            linear_lambda=float(self.config.linear_lambda), shrinkage=lr,
            numeric_inner=self._lin_numeric,
            inner_to_real=self._lin_inner2real, is_first_tree=is_first)
        self.scores[k] += torch.from_numpy(
            np.asarray(delta, np.float32)).to(self.device)
        for vi, ds in enumerate(self.valid_sets):
            if ds.raw_data is None:
                log_fatal("linear_tree validation requires raw data on "
                          "the valid Dataset")
            self._valid_scores[vi][k] += torch.from_numpy(np.asarray(
                tree.predict(ds.raw_data), np.float32)).to(self.device)
        if abs(bias) > _KEPS:
            tree.add_bias(bias)
        self._models.append(tree)
        self.linear_fit_ms.append((time.perf_counter() - t0) * 1e3)

    def _renew_tree_output(self, k: int, tree: DeviceTree,
                           leaf_of_row: torch.Tensor,
                           scores: Optional[torch.Tensor] = None
                           ) -> DeviceTree:
        """Leaf-output renewal of l1 / quantile / mape (RenewTreeOutput,
        objective_function.h:58, before shrinkage and the score update;
        gbdt.py:1780-1816): each leaf's value becomes the objective's
        (weighted) percentile of label - score over its in-bag rows
        (`scores`, class k's current scores by default), computed on the
        host, one readback a tree. The rows are grouped by leaf with a
        stable sort, so each leaf's residuals keep their row order, as the
        JAX package's boolean selection gives them."""
        alpha = self.objective.renew_tree_output_quantile()
        if alpha is None:
            return tree
        s_prev = self.scores[k] if scores is None else scores
        lor, s_prev, lv, inb = (t.cpu().numpy() for t in (
            leaf_of_row, s_prev, tree.leaf_value, self._in_bag))
        leaf_vals = lv.astype(np.float64)
        resid = np.asarray(self.objective.label, np.float64) \
            - s_prev.astype(np.float64)
        w = self.objective.renew_sample_weights()
        rows = np.flatnonzero(inb > 0)
        rows = rows[np.argsort(lor[rows], kind="stable")]
        leaves, starts = np.unique(lor[rows], return_index=True)
        for leaf, part in zip(leaves, np.split(rows, starts[1:])):
            leaf_vals[leaf] = (percentile_ref(resid[part], alpha)
                               if w is None else weighted_percentile_ref(
                                   resid[part], w[part], alpha))
        return tree._replace(leaf_value=torch.from_numpy(
            leaf_vals.astype(np.float32)).to(self.device))

    # ------------------------------------------------------------------
    def _device_tree_to_host(self, t: DeviceTree,
                             lr: Optional[float] = None) -> Tree:
        """Pull a DeviceTree into a host Tree with real thresholds and real
        feature indices (gbdt.py:1908-1976), its values shrunk by `lr`, the
        learning rate it was grown under (the current one by default).
        Categorical splits translate the bin bitset into the reference's
        category-value bitsets (cat_boundaries / cat_threshold; tree.cpp
        Tree::Split categorical path)."""
        n = int(t.num_leaves)
        m = max(n - 1, 0)

        def host(a, k):
            return a[:k].cpu().numpy()

        sf_inner = host(t.split_feature, m).astype(np.int32)
        thr_bin = host(t.threshold_bin, m).astype(np.int32)
        dleft = host(t.default_left, m).astype(bool)
        is_cat = host(t.split_is_cat, m).astype(bool)
        cat_bits_bins = host(t.split_cat_bitset, m).astype(np.uint32)
        thr_real = np.zeros(m, dtype=np.float64)
        dtype_arr = np.zeros(m, dtype=np.int8)
        num_cat = 0
        cat_boundaries = [0]
        cat_threshold: List[int] = []
        for i in range(m):
            mp = self.mappers[sf_inner[i]]
            if is_cat[i]:
                # bins in the left set -> raw category values -> value bitset
                bits = cat_bits_bins[i]
                sel_bins = [b for b in range(min(mp.num_bin, 32 * len(bits)))
                            if (int(bits[b >> 5]) >> (b & 31)) & 1]
                cats = [mp.bin_2_categorical[b] for b in sel_bins]
                words = np.zeros(max(cats, default=0) // 32 + 1, np.uint32)
                for v in cats:
                    words[v // 32] |= np.uint32(1 << (v % 32))
                thr_real[i] = num_cat          # threshold stores cat_idx
                thr_bin[i] = num_cat
                cat_boundaries.append(cat_boundaries[-1] + len(words))
                cat_threshold.extend(words.tolist())
                num_cat += 1
                dtype_arr[i] = make_decision_type(True, False,
                                                  mp.missing_type)
            else:
                thr_real[i] = mp.bin_to_value(int(thr_bin[i]))
                dtype_arr[i] = make_decision_type(False, bool(dleft[i]),
                                                  mp.missing_type)
        real_feat = np.asarray([self.real_feature_index[f] for f in sf_inner],
                               np.int32)
        if lr is None:
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
            cat_boundaries=np.asarray(cat_boundaries, np.int32),
            cat_threshold=np.asarray(cat_threshold, np.uint32),
            num_cat=num_cat,
        )
        # the training-time attributes of a binned replay (late valid
        # sets, continued training; gbdt.py:1970-1973)
        tree.split_feature_inner = sf_inner
        tree.split_is_cat = is_cat
        tree.split_cat_bitset_bins = cat_bits_bins
        # diagnostics, not in the text
        tree.num_waves = int(t.num_waves)
        tree.host_reads = int(t.host_reads)
        return tree

    # ------------------------------------------------------------------
    # continued training (engine.py:234-242 -> CreateBoosting(file),
    # boosting.cpp:70-90)
    # ------------------------------------------------------------------
    def load_init_model(self, init) -> None:
        """Adopt an existing model's trees ahead of this run's and replay
        them onto the training scores (gbdt.py:1662-1690). `init` is a GBDT
        or a model file's path or text. Later iterations continue the
        count, so the scores are not boosted from the average again."""
        if isinstance(init, str):
            text = init
            if os.path.exists(init):
                with open(init) as f:
                    text = f.read()
            init = GBDT.load_model_from_string(text, self.config)
        trees = [copy.deepcopy(t) for t in init.models]
        if not trees:
            return
        K = self.num_tree_per_iteration
        add = torch.zeros_like(self.scores)
        self._replay(trees, self._binned_features(), add,
                     self.train_set.raw_data)
        self.scores += add
        self._models = trees + self.models
        self.iter = len(trees) // max(K, 1) + self.iter
        log_info(f"Continued training from {len(trees)} existing trees")

    def _binned_features(self) -> torch.Tensor:
        """The training rows' [F, N] binned original features on the
        scores' device: X_t, or with EFB (whose X_t holds bundle columns) a
        copy made once."""
        if self.train_set.bundles is None:
            return self.X_t
        if getattr(self, "_X_unbundled", None) is None:
            self._X_unbundled = torch.from_numpy(np.ascontiguousarray(
                self.train_set.X_binned.T)).to(self.device)
        return self._X_unbundled

    def _replay(self, trees: Sequence[Tree], X_t: torch.Tensor,
                scores: torch.Tensor, raw: Optional[np.ndarray]) -> None:
        """scores[i % K] += tree i's output at each row, in place, tree by
        tree in model order, as the JAX package's NumPy loop adds them: the
        device binned walk (ops/predict.py) over X_t [F, N] (original
        features), then `_add_tree_output`."""
        K = self.num_tree_per_iteration
        for i, tree in enumerate(trees):
            self._add_tree_output(scores[i % K], tree,
                                  self._tree_leaves_binned(tree, X_t), raw)

    def _add_tree_output(self, row: torch.Tensor, tree: Tree,
                         leaf: torch.Tensor, raw: Optional[np.ndarray],
                         sign: float = 1.0) -> None:
        """row += sign * the tree's f32 output at each row's leaf (gbdt.py:
        1895-1905): the shrunk leaf values through the score update (#2),
        or a linear tree's outputs on the rows' raw values `raw`, computed
        on the host."""
        if not getattr(tree, "is_linear", False):
            values = np.asarray(tree.leaf_value, np.float32) * np.float32(
                sign)
            add_leaf_values_(row, torch.from_numpy(values).to(row.device),
                             leaf)
            return
        if raw is None:
            log_fatal("replaying a linear tree onto scores requires the "
                      "dataset's raw feature values")
        out = np.asarray(linear_output_for_leaves(
            tree, np.asarray(raw), leaf.cpu().numpy()), np.float32)
        row += torch.from_numpy(out * np.float32(sign)).to(row.device)

    def rollback_one_iter(self) -> None:
        """Undo the last iteration (GBDT::RollbackOneIter, gbdt.cpp:463;
        gbdt.py:1859-1890): its K trees leave the model, and their outputs
        leave the training and valid scores (#2 with negated values, a
        linear tree's outputs negated); the predict caches are cleared."""
        if self.iter <= 0:
            return
        self._stopped = False
        self._packed_cache = None
        self._device_tables_cache = None
        K = self.num_tree_per_iteration
        models = self.models
        for k in range(K):
            tree = models.pop()
            kk = K - 1 - k
            self._add_tree_output(
                self.scores[kk], tree,
                self._tree_leaves_binned(tree, self._binned_features()),
                self.train_set.raw_data, -1.0)
            for vi, ds in enumerate(self.valid_sets):
                self._add_tree_output(
                    self._valid_scores[vi][kk], tree,
                    self._tree_leaves_binned(tree, self._valid_Xt[vi]),
                    ds.raw_data, -1.0)
        self.iter -= 1

    def _tree_leaves_binned(self, tree: Tree,
                            X_t: torch.Tensor) -> torch.Tensor:
        """[N] int32 leaf of every row of the binned X_t [F, N] in a host
        tree (Tree.get_leaf_binned's walk, on X_t's device)."""
        self._ensure_binned_traversal(tree)
        m = max(tree.num_leaves - 1, 0)
        dev = X_t.device

        def t(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=dev, dtype=dtype)
        dt = np.asarray(tree.decision_type[:m], np.int64)
        bits = getattr(tree, "split_cat_bitset_bins", None)
        is_cat = cat_bits = None
        if bits is not None and len(bits):
            is_cat = t((dt & _CATEGORICAL_MASK) != 0, torch.bool)
            cat_bits = t(np.asarray(bits, np.int64), torch.int64)
        leaf = predict_leaf_binned(
            t(np.asarray(tree.split_feature_inner, np.int64), torch.int64),
            t(np.asarray(tree.threshold_in_bin, np.int64), torch.int64),
            t((dt & _DEFAULT_LEFT_MASK) != 0, torch.bool),
            t(tree.left_child[:m], torch.int32),
            t(tree.right_child[:m], torch.int32), tree.num_leaves, X_t,
            self.meta, is_cat, cat_bits)
        return leaf.to(torch.int32)

    def _ensure_binned_traversal(self, tree: Tree) -> None:
        """A file-loaded tree carries real thresholds: derive the binned
        attributes of the walk on this Dataset's mappers (gbdt.py:1692-
        1732): inner feature ids, bin thresholds (the mapper's bin of the
        threshold) and, for categorical nodes, bin bitsets (the bins whose
        category is in the node's category bitset)."""
        if getattr(tree, "split_feature_inner", None) is not None:
            return
        real2inner = {r: i for i, r in enumerate(self.real_feature_index)}
        m = max(tree.num_leaves - 1, 0)
        inner = np.zeros(m, np.int32)
        thr_bin = np.zeros(m, np.int32)
        is_cat = np.zeros(m, bool)
        W = max((self.num_bins_padded + 31) // 32, 1)
        bits = np.zeros((m, W), np.uint32)
        for i in range(m):
            real = int(tree.split_feature[i])
            if real not in real2inner:
                log_fatal(
                    f"init_model splits on feature {real} which is unused "
                    "(trivial/constant) in the current training data; "
                    "continued training requires compatible features")
            fi = real2inner[real]
            inner[i] = fi
            mp = self.mappers[fi]
            if tree.num_cat > 0 and (int(tree.decision_type[i]) & 1):
                is_cat[i] = True
                ci = int(tree.threshold[i])   # cat splits store cat_idx
                thr_bin[i] = ci
                s0 = int(tree.cat_boundaries[ci])
                s1 = int(tree.cat_boundaries[ci + 1])
                words = np.asarray(tree.cat_threshold[s0:s1], np.uint32)
                for b in range(min(mp.num_bin, 32 * W)):
                    v = mp.bin_2_categorical[b] \
                        if b < len(mp.bin_2_categorical) else -1
                    if 0 <= v < 32 * len(words) and \
                            (words[v >> 5] >> (v & 31)) & 1:
                        bits[i, b >> 5] |= np.uint32(1 << (b & 31))
            else:
                thr_bin[i] = int(mp.value_to_bin(
                    np.asarray([tree.threshold[i]]))[0])
        tree.split_feature_inner = inner
        tree.threshold_in_bin = thr_bin
        tree.split_is_cat = is_cat
        tree.split_cat_bitset_bins = bits

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
            # [K, N] to the metrics when K > 1 (gbdt.py:1997-2004)
            s = score.cpu().numpy()
            s = s if s.shape[0] > 1 else s[0]
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
                    num_iteration: int = -1,
                    pred_early_stop: bool = False,
                    pred_early_stop_freq: int = 10,
                    pred_early_stop_margin: float = 10.0) -> np.ndarray:
        # f32 inputs may route to the device predictor below: capture the
        # original dtype before the host walk's f64 upcast
        x_was_f32 = getattr(X, "dtype", None) == np.float32
        X32 = X
        X = np.asarray(X, dtype=np.float64)
        K = self.num_tree_per_iteration
        total_iters = len(self.models) // K
        end = total_iters if num_iteration <= 0 else min(
            total_iters, start_iteration + num_iteration)
        if end <= start_iteration:
            return np.zeros((K, X.shape[0]), dtype=np.float64)
        # large FLOAT32 batches score on a CUDA device (models/predictor.py
        # predict_margin_device, gbdt.py:2052-2084 of the JAX package): the
        # device compares in f32 against floored thresholds, which routes
        # f32 values exactly like the host's f64 walk. f64 inputs, small
        # batches, linear leaves and early stop stay on the host walk.
        if (x_was_f32 and X.shape[0] >= 100_000 and not pred_early_stop
                and not any(getattr(t, "is_linear", False)
                            for t in self.models)
                and self.config.device_type == "cuda"):
            from .predictor import (build_device_tables,
                                    device_tables_bytes,
                                    predict_margin_device)
            trees = self.models[start_iteration * K:end * K]
            if device_tables_bytes(trees) <= 300_000_000:
                key = (start_iteration, end, len(self.models))
                cache = getattr(self, "_device_tables_cache", None)
                if cache is None or cache[0] != key:
                    cache = (key, build_device_tables(
                        trees, K, resolve_device(self.config.device_type)))
                    self._device_tables_cache = cache
                out = predict_margin_device(trees, K, X32, tables=cache[1])
                if self.average_output:
                    out /= (end - start_iteration)
                return out
        # early stop is margin-based and meaningless for averaged output;
        # its frequency counts iterations (all K class trees of each)
        margin = (pred_early_stop_margin
                  if pred_early_stop and not self.average_output else None)
        out = self._packed_model(start_iteration, end).predict_margin(
            X, early_stop_margin=margin,
            early_stop_freq=max(1, int(pred_early_stop_freq)))
        if self.average_output:
            out /= (end - start_iteration)
        return out

    def predict(self, X: np.ndarray, raw_score: bool = False,
                start_iteration: int = 0, num_iteration: int = -1,
                **pred_kwargs) -> np.ndarray:
        raw = self.predict_raw(X, start_iteration, num_iteration,
                               **pred_kwargs)
        if not raw_score and self.objective is not None \
                and self.objective.need_convert_output:
            raw = self.objective.convert_output(raw)
        return raw[0] if raw.shape[0] == 1 else raw.T

    def predict_leaf_index(self, X: np.ndarray, start_iteration: int = 0,
                           num_iteration: int = -1) -> np.ndarray:
        """[N, iterations * K] leaf index of every row in every tree, the
        columns in iteration then class order (gbdt.py:2117-2128; the host
        walk of Tree.get_leaf_index)."""
        X = np.asarray(X, dtype=np.float64)
        K = self.num_tree_per_iteration
        total_iters = len(self.models) // K
        end = total_iters if num_iteration <= 0 else min(
            total_iters, start_iteration + num_iteration)
        cols = [self.models[it * K + k].get_leaf_index(X)
                for it in range(start_iteration, end) for k in range(K)]
        return np.stack(cols, axis=1) if cols else np.zeros((X.shape[0], 0))

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
