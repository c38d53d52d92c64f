"""The command-line application.

Counterpart of lightgbm_tpu/cli.py, which mirrors the reference CLI
(src/main.cpp + src/application/application.cpp):

    python -m lightgbm_tpu_torch config=train.conf [key=value ...]

with task = train | predict | refit | convert_model. Config files are
`key = value` lines with `#` comments (Application::LoadParameters,
application.cpp:54); the command line overrides the file, GNU switches
(`--profile`, `--key=value`) and aliases included. The run takes
`device_type` like any other parameter: "cuda" by default, "cpu" on
request. Training reads text files (data/loader.py, through the native
parser), takes valid files, `input_model`, `snapshot_freq` snapshots with
checksum manifests, checkpoints and resume (runtime/checkpoint.py), and
`device_profile` with `profile_output` (runtime/profiler.py).
`task=serve` and `convert_model_language=stablehlo` raise naming ROADMAP
item A18(b) (admission, breaker, fleet; export), `task=online` A13.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset
from .config import canonical_name, resolve_params
from .data.loader import load_text_file
from .engine import train as engine_train
from .models.gbdt import _not_ported
from .runtime.checkpoint import atomic_write_text, write_manifest
from .utils.log import log_fatal, log_info


def parse_config_file(path: str) -> Dict[str, str]:
    """reference: Application::LoadParameters reads key=value lines."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def parse_args(argv: List[str]) -> Dict[str, str]:
    """The run's params, canonical names, the command line over the
    config file (application.cpp:64-68)."""
    params: Dict[str, str] = {}
    for arg in argv:
        # GNU-style switches map onto config params: `--profile` ->
        # device_profile=true (through the alias table), `--key=value` ->
        # key=value
        if arg.startswith("--"):
            arg = arg[2:]
            if "=" not in arg:
                arg += "=true"
        if "=" not in arg:
            log_fatal(f"Unknown CLI argument: {arg} (expected key=value)")
        k, v = arg.split("=", 1)
        params[canonical_name(k.strip().replace("-", "_"))] = v.strip()
    if "config" in params:
        file_params = {canonical_name(k): v for k, v in
                       parse_config_file(params.pop("config")).items()}
        # canonical keys, so an aliased argument beats its file twin
        file_params.update(params)
        params = file_params
    return params


def _load_text(cfg, path: str):
    return load_text_file(
        path, has_header=cfg.header, label_column=cfg.label_column,
        weight_column=cfg.weight_column, group_column=cfg.group_column,
        ignore_column=cfg.ignore_column)


def _load_dataset_from_config(cfg, path: str,
                              reference: Optional[Dataset] = None
                              ) -> Dataset:
    X, y, w, group, names = _load_text(cfg, path)
    if reference is not None:
        return reference.create_valid(X, label=y, weight=w, group=group)
    return Dataset(X, label=y, weight=w, group=group,
                   feature_name=list(names))


def _snapshot_callback(cfg):
    """Model snapshots every snapshot_freq iterations (GBDT::Train,
    gbdt.cpp:259-263): `<output_model>.snapshot_iter_<k>.txt`, written
    atomically, with a checksum manifest beside it."""
    def _snapshot(env):
        it = env.iteration + 1
        if it % cfg.snapshot_freq == 0:
            path = f"{cfg.output_model}.snapshot_iter_{it}.txt"
            env.model.save_model(path)
            write_manifest(path)
    return _snapshot


def run_train(params: Dict[str, Any], cfg) -> None:
    train_set = _load_dataset_from_config(cfg, cfg.data)
    valid_sets, valid_names = [], []
    valid_paths = cfg.valid if isinstance(cfg.valid, list) else (
        [v for v in str(cfg.valid).split(",") if v])
    for vp in valid_paths:
        valid_sets.append(_load_dataset_from_config(cfg, vp, train_set))
        valid_names.append(vp.rsplit("/", 1)[-1])
    callbacks = ([_snapshot_callback(cfg)] if cfg.snapshot_freq > 0
                 else None)
    booster = engine_train(params, train_set,
                           num_boost_round=cfg.num_iterations,
                           valid_sets=valid_sets, valid_names=valid_names,
                           init_model=cfg.input_model or None,
                           callbacks=callbacks)
    booster.save_model(cfg.output_model)
    if cfg.device_profile:
        profile = booster.get_profile()
        if profile is not None:
            text = json.dumps(profile, indent=2)
            if cfg.profile_output:
                atomic_write_text(cfg.profile_output, text + "\n")
                log_info(f"Device profile saved to {cfg.profile_output}")
            print(text)
    log_info(f"Finished training; model saved to {cfg.output_model}")


def _input_booster(params: Dict[str, Any], cfg, task: str) -> Booster:
    """The input_model, predicting on the run's device_type."""
    if not cfg.input_model:
        log_fatal(f"task={task} requires input_model")
    return Booster(params=params, model_file=cfg.input_model)


def run_predict(params: Dict[str, Any], cfg) -> None:
    booster = _input_booster(params, cfg, "predict")
    # drop the same non-feature columns as training, or features shift
    X, _, _, _, _ = _load_text(cfg, cfg.data)
    pred = booster.predict(
        X, raw_score=cfg.predict_raw_score,
        pred_leaf=cfg.predict_leaf_index, pred_contrib=cfg.predict_contrib,
        start_iteration=cfg.start_iteration_predict,
        num_iteration=cfg.num_iteration_predict)
    out = np.asarray(pred)
    if out.ndim == 1:
        out = out[:, None]
    np.savetxt(cfg.output_result, out, delimiter="\t", fmt="%.18g")
    log_info(f"Finished prediction; results saved to {cfg.output_result}")


# IO and task keys: `data` collides with refit's positional argument, and
# the rest are CLI plumbing that must not reach the refit's params
_CLI_ONLY = frozenset((
    "task", "data", "valid", "decay_rate", "refit_decay_rate",
    "input_model", "output_model", "snapshot_freq", "header",
    "label_column", "weight_column", "group_column", "ignore_column",
    "save_binary", "start_iteration_predict", "num_iteration_predict",
    "predict_raw_score", "predict_leaf_index", "predict_contrib",
    "output_result", "convert_model",
))


def run_refit(params: Dict[str, Any], cfg) -> None:
    booster = _input_booster(params, cfg, "refit")
    X, y, _, _, _ = _load_text(cfg, cfg.data)
    refit_params = {k: v for k, v in params.items() if k not in _CLI_ONLY}
    booster = booster.refit(X, y, decay_rate=cfg.refit_decay_rate,
                            **refit_params)
    booster.save_model(cfg.output_model)
    log_info(f"Finished refit; model saved to {cfg.output_model}")


def run_convert_model(params: Dict[str, Any], cfg) -> None:
    """task=convert_model: `convert_model_language=cpp` (or "") writes the
    standalone if-else C++ (Application::ConvertModel)."""
    if cfg.convert_model_language == "stablehlo":
        _not_ported("convert_model_language=stablehlo (the compiled "
                    "serving artifact, export)", "A18(b)")
    booster = _input_booster(params, cfg, "convert_model")
    out = cfg.convert_model or "gbdt_prediction.cpp"
    atomic_write_text(out, booster.dump_model_to_cpp())
    log_info(f"Finished converting model; saved to {out}")


def main(argv: Optional[List[str]] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    params = parse_args(argv)
    cfg = resolve_params(dict(params))
    task = cfg.task
    log_info(f"lightgbm_tpu_torch CLI: task={task}")
    if task == "train":
        run_train(params, cfg)
    elif task in ("predict", "prediction", "test"):
        run_predict(params, cfg)
    elif task == "refit":
        run_refit(params, cfg)
    elif task == "convert_model":
        run_convert_model(params, cfg)
    elif task == "serve":
        _not_ported("task=serve (the HTTP front-end with admission "
                    "control, the circuit breaker and the fleet)", "A18(b)")
    elif task == "online":
        _not_ported("task=online (the streaming refit loop)", "A13")
    else:
        log_fatal(f"Unknown task: {task}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
