"""Training callbacks.

Copy of lightgbm_tpu/callback.py, API-compatible with the reference python
package (python-package/lightgbm/callback.py): log_evaluation:109,
record_evaluation:183, reset_parameter:254, early_stopping:278, and the
JAX package's record_profile. The evaluation result list entries are
(dataset_name, metric_name, value, is_higher_better) tuples.

`batched_replay = True` marks a callback that is a function of its
CallbackEnv alone: the batched trainer replays it row by row from a
chunk's device metric values after the chunk (JAX callback.py:48-50).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from .utils.log import log_info

EvalEntry = Tuple[str, str, float, bool]


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score: List[EvalEntry]):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


@dataclass
class CallbackEnv:
    model: Any
    params: Dict[str, Any]
    iteration: int
    begin_iteration: int
    end_iteration: int
    evaluation_result_list: Optional[List[EvalEntry]]


def log_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    """reference: callback.py:109."""

    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            result = "\t".join(
                f"{name}'s {metric}: {value:g}"
                for name, metric, value, _ in env.evaluation_result_list)
            log_info(f"[{env.iteration + 1}]\t{result}")

    _callback.order = 10  # type: ignore
    _callback.batched_replay = True  # type: ignore
    return _callback


def record_evaluation(eval_result: Dict[str, Dict[str, List[float]]]) -> Callable:
    """reference: callback.py:183."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")

    def _init(env: CallbackEnv) -> None:
        eval_result.clear()
        for name, metric, _, _ in env.evaluation_result_list or []:
            eval_result.setdefault(name, {}).setdefault(metric, [])

    def _callback(env: CallbackEnv) -> None:
        if not eval_result:
            _init(env)
        for name, metric, value, _ in env.evaluation_result_list or []:
            eval_result.setdefault(name, {}).setdefault(metric, []).append(value)

    _callback.order = 20  # type: ignore
    _callback.batched_replay = True  # type: ignore
    return _callback


def record_profile(profile_result: Dict[str, Any]) -> Callable:
    """Collect per-iteration device-profile stage timings into
    ``profile_result`` (JAX callback.py:75-101; record_evaluation-style;
    training needs ``device_profile=true`` so the booster carries a
    StageProfiler, otherwise the dict stays empty).

    After training, ``profile_result["stages_s"]`` maps stage name to the
    list of per-iteration seconds, ``profile_result["wall_s"]`` is the
    per-iteration wall time and ``profile_result["profile"]`` the full
    final export (runtime/profiler.py to_dict). It reads the ring after
    every iteration, so it has no `batched_replay`: lt.train takes the
    per-iteration path when it is passed."""
    if not isinstance(profile_result, dict):
        raise TypeError("profile_result should be a dictionary")

    def _callback(env: CallbackEnv) -> None:
        gbdt = getattr(env.model, "_gbdt", env.model)
        prof = getattr(gbdt, "profiler", None)
        if prof is None or not prof.ring:
            return
        last = prof.ring[-1]
        profile_result.setdefault("wall_s", []).append(last["wall_s"])
        stages = profile_result.setdefault("stages_s", {})
        for name, v in last["stages_s"].items():
            stages.setdefault(name, []).append(v)
        profile_result["profile"] = prof.to_dict()

    _callback.order = 25  # type: ignore
    return _callback


def reset_parameter(**kwargs: Union[list, Callable]) -> Callable:
    """reference: callback.py:254. Each keyword's value is a list (one
    value per iteration of this training call) or a callable of the
    iteration counted from its beginning; a value that differs from the
    current parameter goes to Booster.reset_parameter before the
    iteration."""

    def _callback(env: CallbackEnv) -> None:
        new_parameters = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(
                        f"Length of list {key!r} has to equal to "
                        f"'num_boost_round'.")
                new_param = value[env.iteration - env.begin_iteration]
            else:
                new_param = value(env.iteration - env.begin_iteration)
            if new_param != env.params.get(key, None):
                new_parameters[key] = new_param
        if new_parameters:
            env.model.reset_parameter(new_parameters)
            env.params.update(new_parameters)

    _callback.before_iteration = True  # type: ignore
    _callback.order = 10  # type: ignore
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True, min_delta: Union[float, List[float]] = 0.0
                   ) -> Callable:
    """reference: callback.py:278 (_EarlyStoppingCallback)."""
    if stopping_rounds <= 0:
        raise ValueError("stopping_rounds should be greater than zero.")

    state: Dict[str, Any] = {}

    def _init(env: CallbackEnv) -> None:
        if not env.evaluation_result_list:
            raise ValueError(
                "For early stopping, at least one dataset and eval metric "
                "is required for evaluation")
        state["enabled"] = True
        n_metrics = len({m for _, m, _, _ in env.evaluation_result_list})
        n_datasets = len({d for d, _, _, _ in env.evaluation_result_list})
        if isinstance(min_delta, list):
            deltas = min_delta * n_datasets
        else:
            deltas = [min_delta] * n_datasets * n_metrics
        state["best_score"] = []
        state["best_iter"] = []
        state["best_score_list"] = []
        state["cmp_op"] = []
        state["first_metric"] = env.evaluation_result_list[0][1]
        for i, (ds, metric, _, higher_better) in enumerate(
                env.evaluation_result_list):
            state["best_iter"].append(0)
            state["best_score_list"].append(None)
            d = deltas[i % len(deltas)]
            if higher_better:
                state["best_score"].append(float("-inf"))
                state["cmp_op"].append(lambda x, y, d=d: x > y + d)
            else:
                state["best_score"].append(float("inf"))
                state["cmp_op"].append(lambda x, y, d=d: x < y - d)

    def _callback(env: CallbackEnv) -> None:
        if not state:
            _init(env)
        if not state.get("enabled", False):
            return
        for i, (ds, metric, value, _) in enumerate(
                env.evaluation_result_list or []):
            if state["best_score_list"][i] is None \
                    or state["cmp_op"][i](value, state["best_score"][i]):
                state["best_score"][i] = value
                state["best_iter"][i] = env.iteration
                state["best_score_list"][i] = list(
                    env.evaluation_result_list)
            if first_metric_only and state["first_metric"] != metric:
                continue
            if ds == "training":
                continue
            if env.iteration - state["best_iter"][i] >= stopping_rounds:
                if verbose:
                    log_info(
                        f"Early stopping, best iteration is:\n"
                        f"[{state['best_iter'][i] + 1}]")
                raise EarlyStopException(state["best_iter"][i],
                                         state["best_score_list"][i])
            if env.iteration == env.end_iteration - 1:
                if verbose:
                    log_info(
                        f"Did not meet early stopping. Best iteration is:\n"
                        f"[{state['best_iter'][i] + 1}]")
                raise EarlyStopException(state["best_iter"][i],
                                         state["best_score_list"][i])

    _callback.order = 30  # type: ignore
    # replay-safe: the stop depends on the evaluation lists alone, and a
    # later tree never changes an earlier iteration's metrics; the engine
    # cuts the surplus trees back to the stop (JAX callback.py:201-204)
    _callback.batched_replay = True  # type: ignore
    return _callback
