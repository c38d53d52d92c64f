"""Training entry points: train() and cv().

Counterpart of lightgbm_tpu/engine.py (the reference python package's
engine.py: train:109, cv:626, CVBooster:356). train() runs batched by
default, as the JAX package does (`_try_batched_train`): chunks of
`batched_chunk_size` iterations with no host round trip per iteration,
the valid sets evaluated on the device, and the callbacks that declare
`batched_replay` replayed row by row after each chunk. Otherwise it runs
the per-iteration loop: the booster starts from `init_model`'s trees when
one is given, then each iteration runs the before-iteration callbacks
(reset_parameter), updates the booster (on `fobj`'s gradients when
given), evaluates the training set where it is also a valid set and the
valid sets (with `feval`), then runs the other callbacks; early stopping
ends the loop. Both paths save a checkpoint every `checkpoint_interval`
of the booster's iterations into `checkpoint_dir`, and
`resume_from_checkpoint` (a checkpoint or its directory) starts a run at
its save point, so a run killed and resumed writes the same model bytes
as one never interrupted (runtime/checkpoint.py). cv() trains one
booster a fold in lockstep and reports each metric's mean and standard
deviation over the folds every round.
"""

from __future__ import annotations

import collections
import copy
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from .basic import Booster, Dataset, _to_2d_numpy
from .callback import CallbackEnv, EarlyStopException, early_stopping
from .config import resolve_params
from .runtime.autotune import pinned_decision
from .runtime.checkpoint import (CheckpointManager, capture_trainer_state,
                                 load_checkpoint, restore_trainer_state)
from .runtime.faults import active_plan
from .utils.log import log_info, log_warning


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

    # resilience (JAX engine.py:77-101): the state is read first, so the
    # trainer is built on the checkpoint's autotune decision, unprobed
    state = None
    if cfg.resume_from_checkpoint:
        state = load_checkpoint(cfg.resume_from_checkpoint)
    with pinned_decision(state and state.get("autotune_decision")):
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

    ckpt = None
    if cfg.checkpoint_interval > 0:
        ckpt = CheckpointManager(cfg.checkpoint_dir,
                                 retention=cfg.checkpoint_retention,
                                 fault_plan=active_plan(cfg.fault_plan))
    begin = 0
    if state is not None:
        restore_trainer_state(booster._gbdt, state)
        if int(state.get("best_iteration", -1)) > 0:
            booster.best_iteration = int(state["best_iteration"])
        begin = booster._gbdt.iter
        if begin >= num_boost_round:
            log_info(f"checkpoint already holds {begin} iterations "
                     f">= num_boost_round={num_boost_round}; nothing to do")

    if _try_batched_train(booster, cfg, params, num_boost_round, begin,
                          before, after, fobj, feval, valid_contain_train,
                          ckpt):
        if booster.best_iteration <= 0:
            booster.best_iteration = booster.current_iteration
        return booster

    for it in range(begin, num_boost_round):
        for cb in before:
            cb(CallbackEnv(model=booster, params=params, iteration=it,
                           begin_iteration=begin,
                           end_iteration=num_boost_round,
                           evaluation_result_list=None))
        finished = booster.update(fobj=fobj)
        if ckpt is not None \
                and booster._gbdt.iter % cfg.checkpoint_interval == 0:
            _save(ckpt, booster)
        evals = []
        if valid_contain_train:
            evals.extend((train_data_name, m, v, h)
                         for _, m, v, h in booster.eval_train(feval))
        if booster.name_valid_sets:
            evals.extend(booster.eval_valid(feval))
        try:
            for cb in after:
                cb(CallbackEnv(model=booster, params=params, iteration=it,
                               begin_iteration=begin,
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


def _save(ckpt: CheckpointManager, booster: Booster) -> None:
    """Checkpoint the booster at its current iteration."""
    ckpt.save(capture_trainer_state(booster._gbdt,
                                    best_iteration=booster.best_iteration),
              booster._gbdt.iter)


def _try_batched_train(booster: Booster, cfg, params: Dict[str, Any],
                       num_boost_round: int, begin: int,
                       before: List[Callable], after: List[Callable], fobj,
                       feval, valid_contain_train: bool,
                       ckpt: Optional[CheckpointManager]) -> bool:
    """Train iterations begin..num_boost_round in chunks with callback
    replay (JAX engine.py:158-278). Each chunk's valid metrics come back
    as one [n, M] read; the callbacks then run row by row from them, early
    stopping included: its stop is exact in retrospect (a later tree never
    changes an earlier iteration's metrics), and the trees past it are
    cut. Chunks end at multiples of the checkpoint interval in the
    booster's own iterations, so each save point closes a chunk and
    captures the per-iteration loop's state; a resumed run's chunks end
    where the uninterrupted run's did. Returns False, training nothing,
    where the per-iteration loop must run: fobj / feval, before-iteration
    callbacks (reset_parameter), a callback without `batched_replay`, the
    training set as a valid set, a metric with no device form, or a
    `can_batch_iters` veto (gbdt.batched_veto)."""
    gbdt = booster._gbdt
    if fobj is not None or feval is not None or valid_contain_train:
        return False
    if before or any(not getattr(cb, "batched_replay", False)
                     for cb in after):
        return False
    if begin >= num_boost_round:
        return False
    chunk = max(int(cfg.batched_chunk_size), 1)
    interval = cfg.checkpoint_interval if ckpt is not None else 0
    # a resample that the chunk cannot draw on the device cuts the
    # chunks at its period: a chunk start resamples as update() would
    strat = gbdt.sample_strategy
    host_period = (strat.resample_period()
                   if gbdt._batched_sampling_mode() == "host" else 0)

    # the booster's iteration at loop iteration `it` is base + it: an
    # init_model's iterations come first; a resumed run starts at
    # begin = gbdt.iter
    base = gbdt.iter - begin

    def boundary(it: int) -> int:
        b = min(it + chunk, num_boost_round)
        for period in (interval, host_period):
            if period > 0:
                b = min(b, ((base + it) // period + 1) * period - base)
        return b

    # the first chunk's verdict holds for every later one, cut the same
    if not gbdt.can_batch_iters(boundary(begin) - begin):
        return False
    layout = gbdt.batched_eval_layout() if booster.name_valid_sets else []
    if layout is None:
        return False
    gbdt.start_drain()
    try:
        it, chunks = begin, 0
        while it < num_boost_round:
            end = boundary(it)
            mvals = gbdt.train_iters_batched(end - it, n_pad=chunk)
            chunks += 1
            rows = (mvals.cpu().numpy() if mvals is not None and after
                    else None)
            for j in range(it, end):
                if interval > 0 and (base + j + 1) % interval == 0:
                    # only the chunk's end can be a save point, where
                    # gbdt.iter == base + j + 1: the per-iteration loop
                    # saves after update(j), before callbacks(j)
                    _save(ckpt, booster)
                evals = []
                if rows is not None:
                    evals = [(name, mname, float(rows[j - it][c]), hib)
                             for c, (name, mname, hib) in enumerate(layout)]
                try:
                    for cb in after:
                        cb(CallbackEnv(model=booster, params=params,
                                       iteration=j, begin_iteration=begin,
                                       end_iteration=num_boost_round,
                                       evaluation_result_list=evals))
                except EarlyStopException as e:
                    booster.best_iteration = e.best_iteration + 1
                    for ds, metric, value, _ in e.best_score:
                        booster.best_score.setdefault(ds, {})[metric] = \
                            value
                    gbdt.truncate_to_iteration(base + j + 1)
                    return True
            it = end
            # the amortized stop check (one read) at power-of-two chunk
            # counts, the first chunk exempt
            if it < num_boost_round and chunks > 1 \
                    and (chunks & (chunks - 1)) == 0 \
                    and gbdt.batched_stopped():
                gbdt._stopped = True
                break
    finally:
        gbdt.stop_drain()
    return True


class CVBooster:
    """The boosters of a cross-validation, one a fold (reference:
    engine.py:356): a method called on it is called on each, and the
    results come back as a list."""

    def __init__(self) -> None:
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name: str):
        def handler_function(*args: Any, **kwargs: Any) -> List[Any]:
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler_function


def _make_n_folds(full_data: Dataset, nfold: int, params: Dict[str, Any],
                  stratified: bool, shuffle: bool, seed: int):
    """(train rows, test rows, test queries) a fold (JAX engine.py:
    324-362): whole queries where the Dataset has groups, else rows taken
    in label order every nfold-th (stratified) or split after an optional
    shuffle by RandomState(seed)."""
    full_data.construct()
    num_data = full_data.num_data()
    label = full_data.get_label()
    group = full_data.get_group()
    rng = np.random.RandomState(seed)

    if group is not None:
        gidx = np.arange(len(group))
        if shuffle:
            rng.shuffle(gidx)
        boundaries = np.concatenate([[0], np.cumsum(group)])
        for fg in np.array_split(gidx, nfold):
            test_rows = np.concatenate(
                [np.arange(boundaries[g], boundaries[g + 1]) for g in fg]) \
                if len(fg) else np.array([], dtype=np.int64)
            mask = np.zeros(num_data, dtype=bool)
            mask[test_rows.astype(np.int64)] = True
            yield np.flatnonzero(~mask), np.flatnonzero(mask), fg
        return

    idx = np.arange(num_data)
    if stratified and label is not None:
        order = np.argsort(label, kind="stable")
        folds = [order[i::nfold] for i in range(nfold)]
    else:
        if shuffle:
            rng.shuffle(idx)
        folds = np.array_split(idx, nfold)
    for f in folds:
        mask = np.zeros(num_data, dtype=bool)
        mask[f] = True
        yield np.flatnonzero(~mask), np.flatnonzero(mask), None


def cv(params: Dict[str, Any], train_set: Dataset,
       num_boost_round: int = 100, folds=None, nfold: int = 5,
       stratified: bool = True, shuffle: bool = True,
       metrics: Optional[Union[str, List[str]]] = None,
       feval: Optional[Callable] = None, init_model=None,
       fpreproc: Optional[Callable] = None, seed: int = 0,
       callbacks: Optional[List[Callable]] = None,
       eval_train_metric: bool = False,
       return_cvbooster: bool = False) -> Dict[str, Any]:
    """Cross-validation (reference: engine.py:626; JAX engine.py:365-473):
    each fold's rows binned anew from `train_set`'s raw rows (so it needs
    free_raw_data=False), a booster a fold with the held-out rows as its
    valid set "valid", and per round "valid <metric>-mean" / "-stdv" (and
    "train ..." with eval_train_metric) over the folds. Stratified folds
    only for binary and multiclass objectives. `init_model` and `fpreproc`
    are accepted and unused, as in the JAX package."""
    params = copy.deepcopy(params)
    if metrics is not None:
        params["metric"] = metrics
    cfg = resolve_params(params)
    if cfg.num_iterations != 100 and num_boost_round == 100:
        num_boost_round = cfg.num_iterations
    if cfg.objective not in ("binary", "multiclass", "multiclassova"):
        stratified = False

    # bin under the caller's params (device_type above all), as
    # Booster.__init__ does
    if train_set._handle is None:
        train_set.params = {**train_set.params, **params}
    train_set.construct()
    if train_set.data is None:
        raise ValueError("cv() needs the Dataset constructed with "
                         "free_raw_data=False")
    full_X = _to_2d_numpy(train_set.data)
    label = train_set.get_label()
    weight = train_set.get_weight()
    group = train_set.get_group()
    if folds is None:
        folds = _make_n_folds(train_set, nfold, params, stratified, shuffle,
                              seed)

    cvbooster = CVBooster()
    for train_idx, test_idx, _ in folds:
        tr_kwargs: Dict[str, Any] = {}
        va_kwargs: Dict[str, Any] = {}
        if group is not None:
            row2q = np.repeat(np.arange(len(group)), group.astype(np.int64))
            trq, vaq = row2q[train_idx], row2q[test_idx]
            tr_kwargs["group"] = np.bincount(
                trq, minlength=len(group))[np.unique(trq)]
            va_kwargs["group"] = np.bincount(
                vaq, minlength=len(group))[np.unique(vaq)]
        dtrain = Dataset(full_X[train_idx],
                         label=None if label is None else label[train_idx],
                         weight=None if weight is None else weight[train_idx],
                         params=train_set.params, free_raw_data=False,
                         **tr_kwargs)
        dvalid = dtrain.create_valid(
            full_X[test_idx],
            label=None if label is None else label[test_idx],
            weight=None if weight is None else weight[test_idx],
            **va_kwargs)
        bst = Booster(params=params, train_set=dtrain)
        bst.add_valid(dvalid, "valid")
        cvbooster.append(bst)

    callbacks = list(callbacks) if callbacks else []
    es_cb = None
    if cfg.early_stopping_round and cfg.early_stopping_round > 0:
        es_cb = early_stopping(cfg.early_stopping_round,
                               cfg.first_metric_only, verbose=False)
    results = collections.defaultdict(list)
    for it in range(num_boost_round):
        agg: Dict[str, List] = collections.defaultdict(list)
        for bst in cvbooster.boosters:
            bst.update()
            for _, m, v, h in bst.eval_valid(feval):
                agg[f"valid {m}"].append((v, h))
            if eval_train_metric:
                for _, m, v, h in bst.eval_train(feval):
                    agg[f"train {m}"].append((v, h))
        merged = []
        for key, vals in agg.items():
            vs = [v for v, _ in vals]
            results[f"{key}-mean"].append(float(np.mean(vs)))
            results[f"{key}-stdv"].append(float(np.std(vs)))
            merged.append(("cv_agg", key, float(np.mean(vs)), vals[0][1]))
        try:
            for cb in callbacks + ([es_cb] if es_cb is not None else []):
                cb(CallbackEnv(model=cvbooster, params=params, iteration=it,
                               begin_iteration=0,
                               end_iteration=num_boost_round,
                               evaluation_result_list=merged))
        except EarlyStopException as e:
            cvbooster.best_iteration = e.best_iteration + 1
            for k in list(results.keys()):
                results[k] = results[k][:cvbooster.best_iteration]
            break

    out = dict(results)
    if return_cvbooster:
        out["cvbooster"] = cvbooster
    return out
