"""Hyperparameter configuration.

Analog of the reference Config struct (include/LightGBM/config.h:41,
src/io/config.cpp, generated alias table src/io/config_auto.cpp). One dataclass
holds every parameter; `resolve_params` applies the alias table and type
coercion so params flow as {key: value} dicts through every API layer exactly
like the reference's key=value strings.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

from .utils.log import log_fatal, log_warning

# ---------------------------------------------------------------------------
# Alias table: alias -> canonical name. Mirrors the semantics of the
# reference's Config::alias_table (src/io/config_auto.cpp) — many aliases per
# canonical parameter, resolved before type parsing.
# ---------------------------------------------------------------------------
_ALIASES: Dict[str, str] = {}


def _alias(canonical: str, *aliases: str) -> None:
    for a in aliases:
        _ALIASES[a] = canonical


_alias("config", "config_file")
_alias("objective", "objective_type", "app", "application", "loss")
_alias("boosting", "boosting_type", "boost")
_alias("data_sample_strategy", "sample_strategy")
_alias("data", "train", "train_data", "train_data_file", "data_filename")
_alias("valid", "test", "valid_data", "valid_data_file", "test_data",
       "test_data_file", "valid_filenames")
_alias("num_iterations", "num_iteration", "n_iter", "num_tree", "num_trees",
       "num_round", "num_rounds", "nrounds", "num_boost_round", "n_estimators",
       "max_iter")
_alias("learning_rate", "shrinkage_rate", "eta")
_alias("num_leaves", "num_leaf", "max_leaves", "max_leaf", "max_leaf_nodes")
_alias("tree_learner", "tree", "tree_type", "tree_learner_type")
_alias("num_threads", "num_thread", "nthread", "nthreads", "n_jobs")
_alias("device_type", "device")
_alias("seed", "random_seed", "random_state")
_alias("min_data_in_leaf", "min_data_per_leaf", "min_data",
       "min_child_samples", "min_samples_leaf")
_alias("min_sum_hessian_in_leaf", "min_sum_hessian_per_leaf",
       "min_sum_hessian", "min_hessian", "min_child_weight")
_alias("bagging_fraction", "sub_row", "subsample", "bagging")
_alias("pos_bagging_fraction", "pos_sub_row", "pos_subsample", "pos_bagging")
_alias("neg_bagging_fraction", "neg_sub_row", "neg_subsample", "neg_bagging")
_alias("bagging_freq", "subsample_freq")
_alias("bagging_seed", "bagging_fraction_seed")
_alias("feature_fraction", "sub_feature", "colsample_bytree")
_alias("feature_fraction_bynode", "sub_feature_bynode", "colsample_bynode")
_alias("extra_trees", "extra_tree")
_alias("early_stopping_round", "early_stopping_rounds", "early_stopping",
       "n_iter_no_change")
_alias("max_delta_step", "max_tree_output", "max_leaf_output")
_alias("lambda_l1", "reg_alpha", "l1_regularization")
_alias("lambda_l2", "reg_lambda", "lambda", "l2_regularization")
_alias("min_gain_to_split", "min_split_gain")
_alias("drop_rate", "rate_drop")
_alias("uniform_drop", "uniform_dart")
_alias("max_cat_threshold", "max_cat_threshold")
_alias("min_data_per_group", "min_data_per_group")
_alias("monotone_constraints", "mc", "monotone_constraint")
_alias("monotone_constraints_method", "monotone_constraining_method",
       "mc_method")
_alias("monotone_penalty", "monotone_splits_penalty", "ms_penalty",
       "mc_penalty")
_alias("feature_contri", "feature_contrib", "fc", "fp", "feature_penalty")
_alias("forcedsplits_filename", "fs", "forced_splits_filename",
       "forced_splits_file", "forced_splits")
_alias("refit_decay_rate", "refit_decay_rate")
_alias("interaction_constraints", "interaction_constraints")
_alias("verbosity", "verbose")
_alias("input_model", "model_input", "model_in")
_alias("output_model", "model_output", "model_out")
_alias("saved_feature_importance_type", "saved_feature_importance_type")
_alias("snapshot_freq", "save_period")
_alias("max_bin", "max_bins")
_alias("max_bin_by_feature", "max_bin_by_feature")
_alias("min_data_in_bin", "min_data_in_bin")
_alias("bin_construct_sample_cnt", "bin_construct_sample_cnt",
       "subsample_for_bin")
_alias("data_random_seed", "data_seed")
_alias("histogram_impl", "hist_impl", "tpu_histogram_impl")
_alias("binning_impl", "bin_impl", "tpu_binning_impl")
_alias("fused_feature_tile", "fused_tile", "grow_fused_feature_tile")
_alias("fused_relabel_fusion", "fused_wave_fusion", "relabel_fusion")
_alias("parallel_hist_mode", "hist_comm_mode", "parallel_histogram_mode")
_alias("is_enable_sparse", "is_sparse", "enable_sparse", "sparse")
_alias("enable_bundle", "is_enable_bundle", "bundle")
_alias("use_missing", "use_missing")
_alias("zero_as_missing", "zero_as_missing")
_alias("feature_pre_filter", "feature_pre_filter")
_alias("pre_partition", "is_pre_partition")
_alias("two_round", "two_round_loading", "use_two_round_loading")
_alias("header", "has_header")
_alias("label_column", "label")
_alias("weight_column", "weight")
_alias("group_column", "group", "group_id", "query_column", "query",
       "query_id")
_alias("ignore_column", "ignore_feature", "blacklist")
_alias("categorical_feature", "cat_feature", "categorical_column",
       "cat_column", "categorical_features")
_alias("forcedbins_filename", "forcedbins_filename")
_alias("predict_raw_score", "is_predict_raw_score", "predict_rawscore",
       "raw_score")
_alias("predict_leaf_index", "is_predict_leaf_index", "leaf_index")
_alias("predict_contrib", "is_predict_contrib", "contrib")
_alias("predict_disable_shape_check", "predict_disable_shape_check")
_alias("pred_early_stop", "pred_early_stop")
_alias("pred_early_stop_freq", "pred_early_stop_freq")
_alias("pred_early_stop_margin", "pred_early_stop_margin")
_alias("output_result", "predict_result", "prediction_result",
       "predict_name", "prediction_name", "pred_name", "name_pred")
_alias("num_class", "num_classes")
_alias("is_unbalance", "unbalance", "unbalanced_sets", "unbalanced")
_alias("scale_pos_weight", "scale_pos_weight")
_alias("boost_from_average", "boost_from_average")
_alias("reg_sqrt", "reg_sqrt")
_alias("alpha", "alpha")
_alias("fair_c", "fair_c")
_alias("poisson_max_delta_step", "poisson_max_delta_step")
_alias("tweedie_variance_power", "tweedie_variance_power")
_alias("lambdarank_truncation_level", "lambdarank_truncation_level")
_alias("lambdarank_norm", "lambdarank_norm")
_alias("label_gain", "label_gain")
_alias("metric", "metrics", "metric_types")
_alias("metric_freq", "output_freq")
_alias("is_provide_training_metric", "training_metric",
       "is_training_metric", "train_metric")
_alias("eval_at", "ndcg_eval_at", "ndcg_at", "map_eval_at", "map_at")
_alias("num_machines", "num_machine")
_alias("local_listen_port", "local_port", "port")
_alias("time_out", "time_out")
_alias("machine_list_filename", "machine_list_file", "machine_list",
       "mlist")
_alias("machines", "workers", "nodes")
_alias("gpu_platform_id", "gpu_platform_id")
_alias("gpu_device_id", "gpu_device_id")
_alias("gpu_use_dp", "gpu_use_dp")
_alias("num_gpu", "num_gpus")
_alias("device_profile", "profile", "device_profiling")
_alias("profile_output", "profile_out", "profile_file")
_alias("autotune", "auto_tune", "runtime_autotune")
_alias("autotune_cache", "auto_tune_cache", "autotune_cache_filename")
_alias("serve_engine", "serving_engine")
_alias("serve_models", "serving_models", "serve_model_list")
_alias("serve_max_batch", "serving_max_batch")
_alias("serve_batch_wait_ms", "serve_max_wait_ms", "batch_wait_ms")
_alias("serve_request_timeout_ms", "serve_timeout_ms")
_alias("serve_num_shards", "serving_num_shards")
_alias("serve_watch", "snapshot_watch", "watch_model")
_alias("serve_metrics_output", "serve_metrics_out", "serving_metrics_file")
_alias("serve_admission_rate_qps", "serve_rate_qps", "admission_rate_qps")
_alias("serve_admission_burst", "serve_rate_burst", "admission_burst")
_alias("serve_admission_queue_high", "admission_queue_high")
_alias("serve_admission_queue_low", "admission_queue_low")
_alias("serve_admission_p99_slo_ms", "serve_p99_slo_ms",
       "admission_p99_slo_ms")
_alias("serve_admission_shed_class", "serve_shed_class", "shed_class")
_alias("serve_deadline_ms", "serve_default_deadline_ms",
       "request_deadline_ms")
_alias("serve_deadline_header", "deadline_header")
_alias("serve_breaker_failures", "breaker_failures",
       "serve_breaker_failure_threshold")
_alias("serve_breaker_latency_slo_ms", "breaker_latency_slo_ms")
_alias("serve_breaker_latency_trips", "breaker_latency_trips")
_alias("serve_breaker_cooldown_s", "breaker_cooldown_s")
_alias("serve_admission_occupancy_high", "admission_occupancy_high",
       "occupancy_high")
_alias("online_source", "stream_source", "online_data")
_alias("online_window_rows", "online_window", "window_rows")
_alias("online_refresh_rows", "online_refit_rows", "refresh_rows")
_alias("online_max_staleness_s", "online_staleness_s", "max_staleness_s")
_alias("online_continue_every", "continue_every")
_alias("online_continue_trees", "continue_trees", "online_new_trees")
_alias("online_publish_mode", "publish_mode")
_alias("online_max_batches", "max_stream_batches")
_alias("online_idle_timeout_s", "online_idle_timeout",
       "stream_idle_timeout_s")
_alias("online_checkpoint_every", "online_ckpt_every")
_alias("online_serve", "online_colocated_serving")
_alias("checkpoint_interval", "checkpoint_freq", "ckpt_interval")
_alias("checkpoint_dir", "checkpoint_path", "ckpt_dir")
_alias("checkpoint_retention", "checkpoint_keep", "ckpt_retention")
_alias("resume_from_checkpoint", "resume_checkpoint", "resume")
_alias("fault_plan", "fault_injection")
_alias("step_max_retries", "watchdog_retries")
_alias("step_retry_backoff_s", "watchdog_backoff_s")
_alias("straggler_skew_threshold", "straggler_threshold")


def parse_serve_models(spec: str) -> List[tuple]:
    """Parse ``serve_models="name=path,name=path"`` into an ordered
    [(tenant, model_path)] list, failing FAST (log_fatal) on a malformed
    entry, an empty name or path, or a duplicate tenant name — a
    duplicate would silently shadow the earlier deployment, so the
    config echoes the offending entry instead (docs/SERVING.md)."""
    out: List[tuple] = []
    seen: set = set()
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if "=" not in entry:
            log_fatal(
                f"serve_models entry '{entry}' is not 'name=model_path' "
                "(expected e.g. 'alpha=a.txt,beta=b.txt'; docs/SERVING.md)")
        name, path = entry.split("=", 1)
        name, path = name.strip(), path.strip()
        if not name or not path:
            log_fatal(
                f"serve_models entry '{entry}' is not 'name=model_path' "
                "(expected e.g. 'alpha=a.txt,beta=b.txt'; docs/SERVING.md)")
        if name in seen:
            log_fatal(
                f"serve_models entry '{entry}' duplicates tenant "
                f"'{name}' — a duplicate silently shadows the earlier "
                "deployment; tenant names must be unique (docs/SERVING.md)")
        seen.add(name)
        out.append((name, path))
    return out


@dataclass
class Config:
    """All hyperparameters (reference: include/LightGBM/config.h:41).

    Defaults match the reference's documented defaults. `device_type` is
    "cuda" (the default: every tensor and kernel lives on the current CUDA
    device, and a missing card is an error) or "cpu" (the same code on CPU
    tensors, where every kernel wrapper runs its plain PyTorch version).
    """

    # -- core (tpu_grower: "auto" picks the wave grower — gain-ordered
    # batched frontier splits per histogram pass, ops/grow_wave.py — when
    # its histogram caches fit in memory, else compact, else the masked
    # full-scan grower; "wave"/"wave_exact"/"compact"/"masked" force one —
    # the TPU analog of the reference's force_col_wise/force_row_wise
    # histogram-mode switch. "wave" batches the split ORDER (quality ~=
    # leaf-wise, measured on the parity gates); "wave_exact"/"compact"/
    # "masked" reproduce the reference's strict leaf-wise order.)
    tpu_grower: str = "auto"
    task: str = "train"
    data: str = ""
    valid: Union[str, List[str]] = ""
    objective: str = "regression"
    boosting: str = "gbdt"
    data_sample_strategy: str = "bagging"
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    tree_learner: str = "serial"
    num_threads: int = 0
    device_type: str = "cuda"
    seed: Optional[int] = None
    deterministic: bool = False

    # -- learning control
    force_col_wise: bool = False
    force_row_wise: bool = False
    histogram_pool_size: float = -1.0
    max_depth: int = -1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    bagging_fraction: float = 1.0
    pos_bagging_fraction: float = 1.0
    neg_bagging_fraction: float = 1.0
    bagging_freq: int = 0
    bagging_seed: int = 3
    bagging_by_query: bool = False
    feature_fraction: float = 1.0
    feature_fraction_bynode: float = 1.0
    feature_fraction_seed: int = 2
    extra_trees: bool = False
    extra_seed: int = 6
    early_stopping_round: int = 0
    early_stopping_min_delta: float = 0.0
    first_metric_only: bool = False
    max_delta_step: float = 0.0
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    linear_lambda: float = 0.0
    min_gain_to_split: float = 0.0
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    xgboost_dart_mode: bool = False
    uniform_drop: bool = False
    drop_seed: int = 4
    top_rate: float = 0.2
    other_rate: float = 0.1
    min_data_per_group: int = 100
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    top_k: int = 20
    monotone_constraints: List[int] = field(default_factory=list)
    monotone_constraints_method: str = "basic"
    monotone_penalty: float = 0.0
    feature_contri: List[float] = field(default_factory=list)
    forcedsplits_filename: str = ""
    refit_decay_rate: float = 0.9
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    cegb_penalty_feature_lazy: List[float] = field(default_factory=list)
    cegb_penalty_feature_coupled: List[float] = field(default_factory=list)
    path_smooth: float = 0.0
    interaction_constraints: Union[str, List[List[int]]] = ""
    verbosity: int = 1
    input_model: str = ""
    output_model: str = "LightGBM_model.txt"
    saved_feature_importance_type: int = 0
    snapshot_freq: int = -1
    use_quantized_grad: bool = False
    num_grad_quant_bins: int = 4
    quant_train_renew_leaf: bool = False
    stochastic_rounding: bool = True

    # -- dataset
    linear_tree: bool = False
    max_bin: int = 255
    max_bin_by_feature: List[int] = field(default_factory=list)
    min_data_in_bin: int = 3
    bin_construct_sample_cnt: int = 200000
    data_random_seed: int = 1
    is_enable_sparse: bool = True
    enable_bundle: bool = True
    use_missing: bool = True
    zero_as_missing: bool = False
    feature_pre_filter: bool = True
    pre_partition: bool = False
    two_round: bool = False
    header: bool = False
    label_column: str = ""
    weight_column: str = ""
    group_column: str = ""
    ignore_column: str = ""
    categorical_feature: Union[str, List[int], List[str]] = ""
    forcedbins_filename: str = ""
    save_binary: bool = False
    precise_float_parser: bool = False
    parser_config_file: str = ""

    # -- predict
    start_iteration_predict: int = 0
    num_iteration_predict: int = -1
    predict_raw_score: bool = False
    predict_leaf_index: bool = False
    predict_contrib: bool = False
    predict_disable_shape_check: bool = False
    pred_early_stop: bool = False
    pred_early_stop_freq: int = 10
    pred_early_stop_margin: float = 10.0
    output_result: str = "LightGBM_predict_result.txt"

    # -- convert
    convert_model_language: str = ""
    convert_model: str = "gbdt_prediction.cpp"

    # -- serving (task=serve; lightgbm_tpu/serving/, docs/SERVING.md)
    serve_engine: str = "auto"         # auto | host | device | binned
    # multi-tenant fleet: "name=model_path,name=model_path" deploys each
    # model under its tenant key behind one shared scoring worker
    # (serving/fleet.py); empty = single-model serving
    serve_models: str = ""
    serve_max_batch: int = 256         # rounded up to a power of two
    serve_min_bucket: int = 8          # smallest padded batch bucket
    serve_batch_wait_ms: float = 2.0   # micro-batch coalescing window
    serve_queue_depth: int = 1024      # request queue bound (back-pressure)
    serve_request_timeout_ms: float = 1000.0
    serve_port: int = 0                # > 0: HTTP serving; 0: stdin/file
    serve_host: str = "127.0.0.1"
    serve_warmup: bool = True          # pre-compile the bucket ladder
    serve_num_shards: int = 0          # > 1: shard buckets over devices
    # fused drain mode: pack every binned-capable tenant's forest into
    # one cross-tenant supertensor and score mixed-tenant batches in a
    # single launch (export/fusion.py, docs/SERVING.md §Compiled serving)
    serve_fused: bool = False
    serve_fused_shards: int = 0        # > 1: replicate the fused scorer
    serve_watch: str = ""              # model prefix to poll for snapshots
    serve_watch_poll_s: float = 5.0
    serve_metrics_output: str = ""     # write serving metrics JSON here
    # overload protection (docs/SERVING.md §Overload & SLOs):
    # admission control / load shedding in front of the micro-batcher
    serve_admission_rate_qps: float = 0.0    # per-client rows/s; 0 = off
    serve_admission_burst: float = 0.0       # bucket size; 0 = max(rate, 1)
    serve_admission_queue_high: float = 0.8  # shed ENGAGE depth fraction
    serve_admission_queue_low: float = 0.5   # shed DISENGAGE depth fraction
    serve_admission_p99_slo_ms: float = 0.0  # shed when observed p99 > SLO
    serve_admission_shed_class: str = "reject_new"  # | drop_oldest
    # deadline propagation: default per-request budget (HTTP path), and
    # the header a client uses to override it per request
    serve_deadline_ms: float = 0.0           # 0 = no default deadline
    serve_deadline_header: str = "X-Deadline-Ms"
    # circuit breaker: device->host engine degradation
    serve_breaker_failures: int = 3          # consecutive failures; 0 = off
    serve_breaker_latency_slo_ms: float = 0.0  # per-batch SLO; 0 = off
    serve_breaker_latency_trips: int = 3     # consecutive SLO misses
    serve_breaker_cooldown_s: float = 5.0    # OPEN -> half-open probe delay
    # occupancy-keyed shedding: engage when the live batch-occupancy
    # fraction (profiler metric: mean rows per scored batch / max_batch)
    # reaches this threshold — the device itself, not the queue, is the
    # bottleneck. 0 disables (docs/SERVING.md §Overload & SLOs).
    serve_admission_occupancy_high: float = 0.0

    # -- online learning loop (task=online; lightgbm_tpu/online/,
    # docs/ONLINE.md). The loop consumes micro-batches from
    # online_source, maintains a bounded sliding window binned against
    # the FROZEN base-model BinMapper, alternates Booster.refit leaf
    # refreshes with warm-continued boosting, and publishes every
    # refreshed snapshot atomically under <output_model>.snapshot_iter_*.
    online_source: str = ""            # directory to tail, or a .npz trace
    online_window_rows: int = 4096     # sliding training window bound
    online_refresh_rows: int = 1024    # pending rows that trigger a refresh
    online_max_staleness_s: float = 0.0  # also refresh when the oldest
    #                                    pending batch is this old; 0 = off
    online_continue_every: int = 4     # every k-th refresh warm-continues
    #                                    (k new trees); 0 = refit-only
    online_continue_trees: int = 5     # boosting rounds per continue
    online_publish_mode: str = "files"  # files | direct | both
    online_max_batches: int = 0        # stop after N batches; 0 = stream end
    online_idle_timeout_s: float = 10.0  # stop after this long idle
    online_checkpoint_every: int = 1   # refreshes between loop checkpoints
    #                                    (active when checkpoint_dir is set)
    online_serve: bool = False         # co-located ServingSession hot-swap
    #                                    (direct promotion into a registry)

    # -- objective
    objective_seed: int = 5
    num_class: int = 1
    is_unbalance: bool = False
    scale_pos_weight: float = 1.0
    sigmoid: float = 1.0
    boost_from_average: bool = True
    reg_sqrt: bool = False
    alpha: float = 0.9
    fair_c: float = 1.0
    poisson_max_delta_step: float = 0.7
    tweedie_variance_power: float = 1.5
    lambdarank_truncation_level: int = 30
    lambdarank_norm: bool = True
    label_gain: List[float] = field(default_factory=list)
    lambdarank_position_bias_regularization: float = 0.0

    # -- metric
    metric: List[str] = field(default_factory=list)
    metric_freq: int = 1
    is_provide_training_metric: bool = False
    eval_at: List[int] = field(default_factory=lambda: [1, 2, 3, 4, 5])
    multi_error_top_k: int = 1
    auc_mu_weights: List[float] = field(default_factory=list)

    # -- network
    num_machines: int = 1
    local_listen_port: int = 12400
    time_out: int = 120
    machine_list_filename: str = ""
    machines: str = ""

    # -- device-specific
    gpu_platform_id: int = -1
    gpu_device_id: int = -1
    gpu_use_dp: bool = False
    num_gpu: int = 1
    # TPU-specific knobs (new in this framework)
    tpu_hist_dtype: str = "float32"    # float32 | bfloat16 | int8 (quantized)
    tpu_rows_per_block: int = 1024     # pallas histogram kernel row block
    # wave grower: a ready leaf splits only if its gain >= slack * (best
    # frontier gain); raises order fidelity vs strict leaf-wise (see
    # ops/grow.py GrowConfig.wave_gain_slack)
    tpu_wave_gain_slack: float = 0.3
    tpu_num_shards: int = 0            # 0 = use all local devices for data ||
    # runtime subsystem (lightgbm_tpu/runtime/): per-iteration stage
    # profiling with device fencing (--profile on the CLI) and init-time
    # grower/layout autotuning via timed probes (the reference's
    # TrainingShareStates row-vs-col timing dance, train_share_states.cpp)
    device_profile: bool = False
    profile_output: str = ""           # write profile JSON here ("" = stdout
    #                                    only via CLI/bench consumers)
    autotune: bool = False             # probe grower strategies at init;
    #                                    false = hard-coded ladder, bit-for-bit
    autotune_cache: str = ""           # decision cache path ("" = env
    #                                    LIGHTGBM_TPU_AUTOTUNE_CACHE or
    #                      ~/.cache/lightgbm_tpu_torch/autotune.json)
    # histogram construction layout (docs/PERF.md):
    #   auto        col-wise, tiered by width class with the hi/lo
    #               wide-bin variant; autotune (autotune=true) may
    #               override per device/shape — including to rowwise
    #   legacy      uniform widest-feature kernel (pre-tiering behavior)
    #   tiered      per-class kernels, legacy 128-wide hi/lo split
    #   tiered_hilo per-class kernels + 64-wide hi/lo wide-bin variant
    #   rowwise     row-wise multi-value kernel: one launch, per-feature
    #               8-aligned widths into the flat offset buffer
    #               (ops/histogram_rowwise.py, MultiValDenseBin analog)
    #   rowwise_packed  rowwise + 4-bit storage pack: two <=16-bin
    #               storage columns per byte, nibble-unpacked in-kernel
    #               (halves the binned-operand stream; same flat buffer)
    #   fused       wave megakernel with the split scan fused into the
    #               histogram epilogue — per-leaf histograms stay VMEM-
    #               resident, no HBM round-trip before the best-split
    #               search (ops/grow_fused.py; wave grower only — plain
    #               histogram builds treat it as "auto")
    # force_row_wise/force_col_wise (the reference's knobs) map onto this:
    # force_row_wise pins rowwise, force_col_wise restricts autotune to
    # the col-wise candidates; setting both is an error.
    histogram_impl: str = "auto"

    # -- raw-value -> bin-id assignment (ops/bucketize.py;
    # docs/PERF.md §8). Host mappers always FIND the bin edges; this
    # knob picks where the value->bin push runs:
    #   auto    device on TPU backends (autotune may refine by probing
    #           both arms), host elsewhere
    #   host    per-feature numpy searchsorted (the reference path)
    #   device  packed bin table + Pallas/XLA bucketize, bit-identical
    #           to host for f32 inputs (f64 inputs always stay host)
    # Engages at Dataset ingest, online window refresh, and the
    # raw-f32 serving entry (bucketize fused into the tree-walk
    # launch). LIGHTGBM_TPU_DISABLE_DEVICE_BINNING=1 vetoes the device
    # path everywhere without a config edit.
    binning_impl: str = "auto"

    # -- fused wave-grower geometry (ops/grow_fused.py; docs/PERF.md §6).
    # fused_feature_tile: lane width of one feature tile in the tiled
    # megakernel — the grid dimension that lifted the old F<=32 gate.
    # Each tile holds a (2*tile, num_bins) VMEM accumulator per leaf, so
    # larger tiles trade leaf capacity (kcap) for fewer grid steps.
    # fused_relabel_fusion: fold the RELABEL pass of applies-only waves
    # into the next wave's SPECULATE launch (tiled path only), roughly
    # halving Pallas launches per tree. Both knobs are orchestration
    # only — the fused scan is bitwise-identical to the two-pass wave
    # (tests/test_grow_fused.py), so they never perturb model files.
    # LIGHTGBM_TPU_DISABLE_FUSED=1 in the environment vetoes the fused
    # path entirely and makes both knobs inert (the veto is recorded in
    # device_profile extras as fused_veto_reasons).
    fused_feature_tile: int = 32
    fused_relabel_fusion: bool = True

    # -- data-parallel histogram exchange (docs/PERF.md §Communication;
    # reference: data_parallel_tree_learner.cpp ReduceScatter +
    # SyncUpGlobalBestSplit):
    #   auto            each grower's default exchange; the runtime
    #                   autotuner may probe and pin a mode per mesh/shape
    #   allreduce       full-histogram psum to every rank (every rank
    #                   searches every feature — debugging escape hatch)
    #   reduce_scatter  psum_scatter feature-slice ownership + sliced
    #                   split search + broadcast-free pmax winner sync;
    #                   int32-packed-int16 payloads under quantized grads
    # Only meaningful for tree_learner=data; any explicit (non-auto)
    # value with another learner is a config contradiction.
    parallel_hist_mode: str = "auto"

    # -- resilience (runtime/checkpoint.py + runtime/faults.py,
    # docs/ROBUSTNESS.md). All off by default: checkpoint_interval=0
    # leaves the training hot path byte-for-byte unchanged.
    checkpoint_interval: int = 0       # iterations between checkpoints
    checkpoint_dir: str = ""           # where ckpt_iter_*.pkl land
    checkpoint_retention: int = 3      # newest checkpoints kept on disk
    resume_from_checkpoint: str = ""   # checkpoint file or directory
    fault_plan: str = ""               # injection spec (tests/smoke only;
    #                                    env LIGHTGBM_TPU_FAULT_PLAN also
    #                                    works for subprocess harnesses)
    step_max_retries: int = 2          # watchdog retries per grow step
    step_retry_backoff_s: float = 0.05  # base backoff, doubles per retry
    straggler_skew_threshold: float = 1.5  # flag ranks slower than this
    #                                    multiple of the median grow span

    # -- batched training (models/gbdt.py:train_iters_batched,
    # docs/PERF.md §7): run boosting in host-free lax.scan chunks with
    # device-side bagging/GOSS and in-scan valid-set scoring; the engine
    # replays callbacks per chunk and truncates surplus trees on early
    # stop, so models stay md5-identical to the per-iteration path.
    # Env LIGHTGBM_TPU_DISABLE_BATCHED=1 overrides batched_train at
    # runtime (escape hatch, no config edit needed).
    batched_train: bool = True
    batched_chunk_size: int = 32       # iterations per scan launch; tail
    #                                    chunks pad to this so the scan fn
    #                                    compiles once per (chunk, shape)

    def __post_init__(self) -> None:
        self._validate()

    # -- parity with reference Config::CheckParamConflict (src/io/config.cpp)
    def _validate(self) -> None:
        if self.num_leaves < 2:
            log_fatal(f"num_leaves must be >= 2, got {self.num_leaves}")
        if not (0.0 < self.bagging_fraction <= 1.0):
            log_fatal("bagging_fraction should be in (0.0, 1.0]")
        if not (0.0 < self.feature_fraction <= 1.0):
            log_fatal("feature_fraction should be in (0.0, 1.0]")
        if not (0.0 < self.feature_fraction_bynode <= 1.0):
            log_fatal("feature_fraction_bynode should be in (0.0, 1.0]")
        if self.max_bin <= 1:
            log_fatal("max_bin should be > 1")
        if self.num_class < 1:
            log_fatal("num_class should be >= 1")
        if self.learning_rate <= 0.0:
            log_fatal("learning_rate should be > 0.0")
        if self.boosting == "rf":
            if self.bagging_freq <= 0 or self.bagging_fraction >= 1.0 or self.bagging_fraction <= 0.0:
                log_fatal(
                    "Random forest (boosting=rf) requires 0 < bagging_fraction < 1 "
                    "and bagging_freq > 0")
        # the reference silently treats unknown values as "basic"
        # (monotone_constraints.hpp); failing fast is kinder — "advanced"
        # in particular is NOT implemented here (docs/PARITY.md)
        if self.monotone_constraints_method not in ("basic",
                                                    "intermediate"):
            log_fatal(
                "Unknown/unsupported monotone_constraints_method "
                f"'{self.monotone_constraints_method}' (supported: "
                "'basic', 'intermediate'; the reference's 'advanced' "
                "method is not implemented — see docs/PARITY.md)")
        if self.histogram_impl not in ("auto", "legacy", "tiered",
                                       "tiered_hilo", "rowwise",
                                       "rowwise_packed", "fused"):
            log_fatal(
                f"Unknown histogram_impl '{self.histogram_impl}' "
                "(supported: 'auto', 'legacy', 'tiered', 'tiered_hilo', "
                "'rowwise', 'rowwise_packed', 'fused'; see docs/PERF.md)")
        if self.device_type not in ("cuda", "cpu"):
            log_fatal(f"Unknown device_type '{self.device_type}' "
                      "(supported: 'cuda', 'cpu')")
        if self.binning_impl not in ("auto", "host", "device"):
            log_fatal(
                f"Unknown binning_impl '{self.binning_impl}' "
                "(supported: 'auto', 'host', 'device'; see "
                "docs/PERF.md §8)")
        # the reference rejects the contradictory pair the same way
        # (config.cpp CheckParamConflict)
        if self.force_col_wise and self.force_row_wise:
            log_fatal("Cannot set both force_col_wise and force_row_wise "
                      "to true (pick one histogram layout, or neither "
                      "for the autotuned choice — docs/PERF.md)")
        if self.force_row_wise and self.histogram_impl not in (
                "auto", "rowwise", "rowwise_packed"):
            log_fatal(
                f"force_row_wise conflicts with histogram_impl="
                f"'{self.histogram_impl}' (a col-wise layout); drop one")
        if self.force_col_wise and self.histogram_impl in (
                "rowwise", "rowwise_packed"):
            log_fatal("force_col_wise conflicts with histogram_impl="
                      f"'{self.histogram_impl}'; drop one")
        if self.fused_feature_tile not in (32, 64, 128):
            log_fatal(
                f"fused_feature_tile={self.fused_feature_tile} is not a "
                "supported tile width (choose 32, 64 or 128: one VMEM "
                "feature tile per grid step — docs/PERF.md §6)")
        # customizing the fused geometry while pinning a non-fused
        # histogram layout is the same contradiction class as
        # force_row_wise + a col-wise impl: the knobs would silently do
        # nothing (config.cpp CheckParamConflict analog)
        if ((self.fused_feature_tile != 32
             or not self.fused_relabel_fusion)
                and self.histogram_impl not in ("auto", "fused")):
            log_fatal(
                "fused_feature_tile/fused_relabel_fusion conflict with "
                f"histogram_impl='{self.histogram_impl}' (the fused wave "
                "kernel is never taken under that pin); drop one")
        if self.parallel_hist_mode not in ("auto", "allreduce",
                                           "reduce_scatter"):
            log_fatal(
                f"Unknown parallel_hist_mode '{self.parallel_hist_mode}' "
                "(supported: 'auto', 'allreduce', 'reduce_scatter'; see "
                "docs/PERF.md)")
        # histogram exchange modes only exist for the data-parallel
        # learner: feature/voting learners never move full histograms
        # (their collectives are record merges / voted columns), and the
        # serial learner has no mesh axis at all — an explicit mode there
        # is a contradiction, not a no-op (CheckParamConflict style)
        if self.parallel_hist_mode != "auto" \
                and self.tree_learner not in ("data", "data_parallel"):
            log_fatal(
                f"parallel_hist_mode='{self.parallel_hist_mode}' requires "
                f"tree_learner=data (got tree_learner="
                f"'{self.tree_learner}'); the histogram exchange only "
                "exists for the data-parallel learner — docs/PERF.md")
        if self.checkpoint_interval < 0:
            log_fatal("checkpoint_interval should be >= 0 (0 disables "
                      "checkpointing)")
        if self.checkpoint_interval > 0 and not self.checkpoint_dir:
            log_fatal("checkpoint_interval > 0 requires checkpoint_dir "
                      "(where ckpt_iter_*.pkl snapshots are written — "
                      "docs/ROBUSTNESS.md)")
        if self.checkpoint_retention < 1:
            log_fatal("checkpoint_retention should be >= 1")
        if self.step_max_retries < 0:
            log_fatal("step_max_retries should be >= 0")
        if self.batched_chunk_size < 1:
            log_fatal("batched_chunk_size should be >= 1 (iterations per "
                      "host-free scan launch — docs/PERF.md §7)")
        if self.step_retry_backoff_s < 0.0:
            log_fatal("step_retry_backoff_s should be >= 0.0")
        if self.straggler_skew_threshold <= 1.0:
            log_fatal("straggler_skew_threshold should be > 1.0 (it is a "
                      "ratio over the median rank span)")
        # serving overload-protection knobs fail fast at config time so a
        # bad flag can't surface mid-traffic (docs/SERVING.md)
        if self.serve_admission_shed_class not in ("reject_new",
                                                   "drop_oldest"):
            log_fatal(
                "Unknown serve_admission_shed_class "
                f"'{self.serve_admission_shed_class}' (supported: "
                "'reject_new', 'drop_oldest'; docs/SERVING.md)")
        if not (0.0 < self.serve_admission_queue_high <= 1.0):
            log_fatal("serve_admission_queue_high should be in (0.0, 1.0]")
        if not (0.0 < self.serve_admission_queue_low
                <= self.serve_admission_queue_high):
            log_fatal("serve_admission_queue_low should be in "
                      "(0.0, serve_admission_queue_high]")
        if self.serve_admission_rate_qps < 0.0 \
                or self.serve_admission_burst < 0.0:
            log_fatal("serve_admission_rate_qps / serve_admission_burst "
                      "should be >= 0 (0 disables)")
        if self.serve_admission_p99_slo_ms < 0.0:
            log_fatal("serve_admission_p99_slo_ms should be >= 0 "
                      "(0 disables the latency watermark)")
        if self.serve_deadline_ms < 0.0:
            log_fatal("serve_deadline_ms should be >= 0 (0 = no default "
                      "request deadline)")
        if self.serve_breaker_failures < 0:
            log_fatal("serve_breaker_failures should be >= 0 (0 disables "
                      "the consecutive-failure trip)")
        if self.serve_breaker_latency_slo_ms < 0.0:
            log_fatal("serve_breaker_latency_slo_ms should be >= 0 "
                      "(0 disables the latency trip)")
        if self.serve_breaker_latency_trips < 1:
            log_fatal("serve_breaker_latency_trips should be >= 1")
        if self.serve_breaker_cooldown_s <= 0.0:
            log_fatal("serve_breaker_cooldown_s should be > 0")
        if not (0.0 <= self.serve_admission_occupancy_high <= 1.0):
            log_fatal("serve_admission_occupancy_high should be in "
                      "[0.0, 1.0] (0 disables occupancy shedding)")
        if self.serve_models:
            parse_serve_models(self.serve_models)
        if self.serve_fused_shards < 0:
            log_fatal("serve_fused_shards should be >= 0 (0 = no "
                      "replication of the fused scorer)")
        if self.convert_model_language not in ("", "cpp", "stablehlo",
                                               "torch_export"):
            log_fatal(
                f"Unknown convert_model_language "
                f"'{self.convert_model_language}' (supported: 'cpp' — "
                "standalone C++ source, '' defaults to it — and "
                "'torch_export' — the exported serving artifact, "
                "export/compile.py; 'stablehlo' is the JAX package's)")
        # online-loop knobs fail fast so a bad flag can't surface
        # mid-stream (docs/ONLINE.md)
        if self.online_window_rows < 1:
            log_fatal("online_window_rows should be >= 1")
        if self.online_refresh_rows < 1:
            log_fatal("online_refresh_rows should be >= 1")
        if self.online_refresh_rows > self.online_window_rows:
            log_fatal("online_refresh_rows should be <= online_window_rows "
                      "(a refresh can never see more rows than the window "
                      "holds)")
        if self.online_max_staleness_s < 0.0:
            log_fatal("online_max_staleness_s should be >= 0 (0 disables "
                      "the staleness trigger)")
        if self.online_continue_every < 0:
            log_fatal("online_continue_every should be >= 0 (0 = "
                      "refit-only policy)")
        if self.online_continue_trees < 1:
            log_fatal("online_continue_trees should be >= 1")
        if self.online_publish_mode not in ("files", "direct", "both"):
            log_fatal(
                f"Unknown online_publish_mode '{self.online_publish_mode}' "
                "(supported: 'files', 'direct', 'both'; docs/ONLINE.md)")
        if self.online_max_batches < 0:
            log_fatal("online_max_batches should be >= 0 (0 = run to "
                      "stream end)")
        if self.online_idle_timeout_s <= 0.0:
            log_fatal("online_idle_timeout_s should be > 0")
        if self.online_checkpoint_every < 1:
            log_fatal("online_checkpoint_every should be >= 1")
        if self.online_publish_mode in ("direct", "both") \
                and self.task == "online" and not self.online_serve:
            log_fatal("online_publish_mode='" + self.online_publish_mode
                      + "' promotes into a co-located serving registry; "
                      "set online_serve=true (or publish_mode=files)")

    def max_depth_effective(self) -> int:
        return self.max_depth if self.max_depth > 0 else 10**9

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    # run-orchestration knobs excluded from the model-file parameter echo:
    # they describe how one particular run was EXECUTED (where it
    # checkpointed, what it resumed from, what faults were injected), not
    # what model it produces — and a resumed run must emit byte-identical
    # model files to the uninterrupted run it replaces (docs/ROBUSTNESS.md)
    _NON_MODEL_FIELDS = frozenset((
        "checkpoint_interval", "checkpoint_dir", "checkpoint_retention",
        "resume_from_checkpoint", "fault_plan", "step_max_retries",
        "step_retry_backoff_s", "straggler_skew_threshold",
        # batched-training knobs describe dispatch ORCHESTRATION only:
        # chunked scans are md5-identical to the per-iteration loop
        # (tests/test_batched.py), so they must not perturb model files
        "batched_train", "batched_chunk_size",
        # fused wave-grower geometry: tile width and relabel fusion are
        # launch-scheduling choices with a bitwise-parity contract vs the
        # two-pass wave (tests/test_grow_fused.py), so they must not
        # perturb model files either
        "fused_feature_tile", "fused_relabel_fusion",
        # binning_impl picks WHERE the value->bin push runs; the device
        # bucketize is bit-identical to the host searchsorted
        # (tests/test_predict_binned.py parity suites), so it must not
        # perturb model files
        "binning_impl",
        # serving overload-protection knobs describe the SERVING process,
        # not the model; keeping them out preserves the byte-identical
        # model-file contract across config changes
        "serve_admission_rate_qps", "serve_admission_burst",
        "serve_admission_queue_high", "serve_admission_queue_low",
        "serve_admission_p99_slo_ms", "serve_admission_shed_class",
        "serve_deadline_ms", "serve_deadline_header",
        "serve_breaker_failures", "serve_breaker_latency_slo_ms",
        "serve_breaker_latency_trips", "serve_breaker_cooldown_s",
        "serve_admission_occupancy_high", "serve_models",
        "serve_fused", "serve_fused_shards",
        # online-loop knobs describe the refresh ORCHESTRATION, not the
        # model: every published snapshot must stay byte-identical to
        # the offline one-shot refit/continue on the same data
        # (tests/test_online.py md5 parity)
        "online_source", "online_window_rows", "online_refresh_rows",
        "online_max_staleness_s", "online_continue_every",
        "online_continue_trees", "online_publish_mode",
        "online_max_batches", "online_idle_timeout_s",
        "online_checkpoint_every", "online_serve"))

    def to_string(self) -> str:
        """Serialize `[key: value]` lines, the reference's Config::ToString
        layout used inside model files (gbdt_model_text.cpp parameters
        section)."""
        lines = []
        for f in dataclasses.fields(self):
            if f.name in self._NON_MODEL_FIELDS:
                continue
            v = getattr(self, f.name)
            if isinstance(v, bool):
                v = int(v)
            elif isinstance(v, list):
                v = ",".join(str(x) for x in v)
            elif v is None:
                v = ""
            lines.append(f"[{f.name}: {v}]")
        return "\n".join(lines)


_FIELD_TYPES = {f.name: f for f in dataclasses.fields(Config)}

_BOOSTING_VALUES = {"gbdt", "gbrt", "dart", "rf", "random_forest", "goss"}
_TREE_LEARNER_VALUES = {
    "serial", "feature", "feature_parallel", "data", "data_parallel",
    "voting", "voting_parallel",
}


def _coerce(name: str, value: Any) -> Any:
    """Parse a raw param value (possibly a string) into the field's type."""
    f = _FIELD_TYPES[name]
    ftype = f.type
    if value is None:
        return None
    is_list = str(ftype).startswith("typing.List") or "List" in str(ftype)
    if is_list and name not in ("categorical_feature", "interaction_constraints"):
        if isinstance(value, str):
            value = [v for v in value.replace(",", " ").split() if v]
        elif not isinstance(value, (list, tuple)):
            value = [value]
        if name in ("monotone_constraints", "max_bin_by_feature", "eval_at"):
            return [int(v) for v in value]
        if name in ("metric", "valid"):
            # valid files are paths (the JAX package's _coerce takes them
            # for floats and fails; ROADMAP C note 19)
            return [str(v) for v in value]
        return [float(v) for v in value]
    default = f.default if f.default is not dataclasses.MISSING else None
    if isinstance(default, bool):
        if isinstance(value, str):
            return value.lower() in ("true", "1", "yes", "+")
        return bool(value)
    if isinstance(default, int) or name == "seed":
        return int(value)
    if isinstance(default, float):
        return float(value)
    return value


def canonical_name(key: str) -> str:
    """Resolve a parameter alias to its canonical name."""
    return _ALIASES.get(key, key)


def resolve_params(
    params: Optional[Dict[str, Any]],
    **overrides: Any,
) -> Config:
    """Apply the alias table and build a Config.

    Mirrors Config::Set (src/io/config.cpp): aliases resolve to canonical
    names; when both an alias and the canonical name are given the canonical
    one wins and a warning is emitted.
    """
    params = dict(params or {})
    params.update(overrides)
    canonical: Dict[str, Any] = {}
    for key, value in params.items():
        name = _ALIASES.get(key, key)
        if name in canonical and canonical[name] != value:
            log_warning(f"{name} is set multiple times (alias conflict); "
                        f"keeping {name}={canonical[name]!r}")
            continue
        canonical[name] = value

    # normalize enum-ish values
    if "boosting" in canonical:
        b = str(canonical["boosting"])
        if b == "gbrt":
            b = "gbdt"
        if b == "random_forest":
            b = "rf"
        if b == "goss":  # legacy spelling: boosting=goss
            b = "gbdt"
            canonical.setdefault("data_sample_strategy", "goss")
        canonical["boosting"] = b
    if "tree_learner" in canonical:
        t = str(canonical["tree_learner"]).replace("_parallel", "")
        if t not in {"serial", "feature", "data", "voting"}:
            log_fatal(f"Unknown tree_learner type {canonical['tree_learner']}")
        canonical["tree_learner"] = t

    kwargs: Dict[str, Any] = {}
    unknown: Dict[str, Any] = {}
    for name, value in canonical.items():
        if name in _FIELD_TYPES:
            kwargs[name] = _coerce(name, value)
        else:
            unknown[name] = value
    cfg = Config(**kwargs)
    if unknown:
        log_warning(f"Unknown parameters: {sorted(unknown)}")
    return cfg
