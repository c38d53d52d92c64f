"""Training entry point.

Counterpart of lightgbm_tpu/engine.py:train (the reference python
package's engine.py:109) on the per-iteration loop: the booster starts
from `init_model`'s trees when one is given, then each iteration runs the
before-iteration callbacks (reset_parameter), updates the booster (on
`fobj`'s gradients when given), evaluates the training set where it is
also a valid set and the valid sets (with `feval`), then runs the other
callbacks; early stopping ends the loop.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional, Union

from .basic import Booster, Dataset
from .callback import CallbackEnv, EarlyStopException, early_stopping
from .config import resolve_params
from .utils.log import log_warning


def train(
    params: Dict[str, Any],
    train_set: Dataset,
    num_boost_round: int = 100,
    valid_sets: Optional[List[Dataset]] = None,
    valid_names: Optional[List[str]] = None,
    feval: Optional[Callable] = None,
    init_model: Optional[Union[str, Booster]] = None,
    keep_training_booster: bool = False,
    callbacks: Optional[List[Callable]] = None,
    fobj: Optional[Callable] = None,
) -> Booster:
    """Train a gradient-boosted model (reference: engine.py:109; JAX
    engine.py:22-140). `init_model`, a Booster or a model file's path or
    text, is continued: its trees come first, replayed onto the training
    and valid scores, and `num_boost_round` more iterations follow.
    `keep_training_booster` is accepted; the booster returned can always
    train on."""
    params = copy.deepcopy(params)
    cfg = resolve_params(params)
    if cfg.num_iterations != 100 and num_boost_round == 100:
        num_boost_round = cfg.num_iterations
    if cfg.objective in ("none", "custom") and fobj is None:
        log_warning("Using custom objective requires fobj")

    booster = Booster(params=params, train_set=train_set)
    if init_model is not None:
        booster._gbdt.load_init_model(
            init_model._gbdt if isinstance(init_model, Booster)
            else init_model)
    valid_contain_train = False
    train_data_name = "training"
    for i, vs in enumerate(valid_sets or []):
        name = (valid_names[i] if valid_names and i < len(valid_names)
                else f"valid_{i}")
        if vs is train_set:
            valid_contain_train = True
            train_data_name = name
            continue
        booster.add_valid(vs, name)

    callbacks = list(callbacks) if callbacks else []
    if cfg.early_stopping_round and cfg.early_stopping_round > 0:
        callbacks.append(early_stopping(
            cfg.early_stopping_round, cfg.first_metric_only,
            verbose=cfg.verbosity >= 1,
            min_delta=cfg.early_stopping_min_delta))
    before = sorted((cb for cb in callbacks
                     if getattr(cb, "before_iteration", False)),
                    key=lambda cb: getattr(cb, "order", 0))
    after = sorted((cb for cb in callbacks
                    if not getattr(cb, "before_iteration", False)),
                   key=lambda cb: getattr(cb, "order", 0))

    for it in range(num_boost_round):
        for cb in before:
            cb(CallbackEnv(model=booster, params=params, iteration=it,
                           begin_iteration=0, end_iteration=num_boost_round,
                           evaluation_result_list=None))
        finished = booster.update(fobj=fobj)
        evals = []
        if valid_contain_train:
            evals.extend((train_data_name, m, v, h)
                         for _, m, v, h in booster.eval_train(feval))
        if booster.name_valid_sets:
            evals.extend(booster.eval_valid(feval))
        try:
            for cb in after:
                cb(CallbackEnv(model=booster, params=params, iteration=it,
                               begin_iteration=0,
                               end_iteration=num_boost_round,
                               evaluation_result_list=evals))
        except EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            for ds, metric, value, _ in e.best_score:
                booster.best_score.setdefault(ds, {})[metric] = value
            break
        if finished:
            break
    if booster.best_iteration <= 0:
        booster.best_iteration = booster.current_iteration
    return booster
