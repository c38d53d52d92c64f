"""Checkpoints, resume and fault plans in the port on the CPU, against the
JAX package where both run: the plan grammar (`FaultPlan.parse`), atomic
writes and manifests, retention and the fall-back past a corrupt
checkpoint, resumes md5-equal to the run never interrupted and to the
run without checkpoints (per iteration and batched; bagging, GOSS,
quantized gradients, a valid set with early stopping), a `kill@iter` run
in a subprocess (exit code 17), a JAX checkpoint refused without importing
the JAX package, no orchestration parameter in the model text, a resumed
model's trees equal the JAX package's resumed trees, and
`fail_collective` under the step watchdog with the JAX package's serial
outcome. Trees compare structure exactly and leaf values within 1e-5
(the JAX search sums in f32, the port in f64: ROADMAP C note 9)."""

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
from lightgbm_tpu.runtime import faults as jfaults
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.runtime.checkpoint import (CheckpointManager,
                                                   atomic_write_text,
                                                   capture_trainer_state,
                                                   load_checkpoint,
                                                   verify_manifest,
                                                   write_manifest)
from lightgbm_tpu_torch.runtime.faults import (CollectiveFault, FaultPlan,
                                               InjectedFault, active_plan,
                                               corrupt_file)
from lightgbm_tpu_torch.utils.log import FatalError

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
N_ROWS, N_COLS, N_ROUNDS, FAULT_AT = 320, 8, 8, 7
BASE = dict(objective="binary", num_leaves=7, min_data_in_leaf=5,
            learning_rate=0.2, bagging_freq=3, bagging_fraction=0.7,
            feature_fraction=0.8, seed=3, verbose=-1)
TORCH = {"device_type": "cpu", "binning_impl": "host"}


def _data(n=N_ROWS):
    rng = np.random.RandomState(0)
    X = rng.normal(size=(n, N_COLS)).astype(np.float32)
    y = (X[:, 0] + 0.5 * rng.normal(size=n) > 0).astype(np.float32)
    return X, y


X, Y = _data()


def _md5(b):
    return hashlib.md5(b.model_to_string().encode()).hexdigest()


def _blocks(text):
    body = text.split("end of trees")[0]
    return [dict(ln.split("=", 1) for ln in blk.splitlines()[1:] if "=" in ln)
            for blk in body.split("Tree=")[1:]]


def _assert_same_trees(text_t, text_j, n_trees):
    tt, tj = _blocks(text_t), _blocks(text_j)
    assert len(tt) == len(tj) == n_trees
    for a, b in zip(tt, tj):
        for k in ("num_leaves", "split_feature", "threshold", "left_child",
                  "right_child"):
            assert a.get(k) == b.get(k), k
        np.testing.assert_allclose(np.array(a["leaf_value"].split(), float),
                                   np.array(b["leaf_value"].split(), float),
                                   rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the plan grammar, manifests, retention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec", [
    "kill@iter=7; raise@iter=3:times=2, sleep@iter=2:rank=1:ms=5;"
    "corrupt_snapshot@iter=8 ; fail_collective@iter=2:times=3",
    "slow_score@batch=0:ms=50:times=8,fail_score@batch=1:times=3",
    "wedge_worker@batch=0:ms=800;stall_source@batch=2:ms=400;"
    "corrupt_batch@batch=1:times=2",
    "kill@iter=4:code=9", "", "  ", "explode@iter=1", "raise"])
def test_fault_plan_grammar_matches_jax(spec):
    def parse(mod):
        try:
            plan = mod.FaultPlan.parse(spec)
        except ValueError as e:
            return ("error", str(e))
        if plan is None:
            return None
        return (plan.spec, [(d.action, d.params, d.remaining, repr(d))
                            for d in plan.directives])
    assert parse(sys.modules[FaultPlan.__module__]) == parse(jfaults)


def test_fault_plan_hooks_and_env(monkeypatch):
    plan = FaultPlan.parse(
        "raise@iter=3:times=2;corrupt_snapshot@iter=8;"
        "fail_collective@iter=2:times=2")
    for _ in range(2):
        with pytest.raises(InjectedFault):
            plan.at_iteration(3)
    plan.at_iteration(3)                      # times=2 exhausted
    plan.maybe_fail_collective(1)             # before its iteration
    for _ in range(2):
        with pytest.raises(CollectiveFault):
            plan.maybe_fail_collective(5)
    plan.maybe_fail_collective(5)
    assert plan.should_corrupt_snapshot(8) is True
    assert plan.should_corrupt_snapshot(8) is False   # consumed once
    assert active_plan("") is None
    monkeypatch.setenv("LIGHTGBM_TPU_FAULT_PLAN", "raise@iter=1")
    assert active_plan("").spec == "raise@iter=1"
    assert active_plan("kill@iter=2").spec == "kill@iter=2"


def test_atomic_write_manifest_and_config(tmp_path):
    path = str(tmp_path / "f.txt")
    atomic_write_text(path, "hello world\n")
    assert open(path).read() == "hello world\n"
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    write_manifest(path)
    assert verify_manifest(path) == (True, "ok")
    corrupt_file(path)
    ok, reason = verify_manifest(path)
    assert not ok and "sha256" in reason
    assert verify_manifest(str(tmp_path / "nope"))[0] is False
    with open(path, "a") as f:
        f.write("x")
    assert "size mismatch" in verify_manifest(path)[1]
    # the JAX package's validation and aliases
    with pytest.raises(FatalError):
        lt.resolve_params({"checkpoint_interval": 5})    # no directory
    cfg = lt.resolve_params({"checkpoint_freq": 5, "ckpt_dir": "/tmp/x",
                             "resume": "/tmp/y"})
    assert (cfg.checkpoint_interval, cfg.checkpoint_dir,
            cfg.resume_from_checkpoint) == (5, "/tmp/x", "/tmp/y")


def _train(tmp_path, tag, rounds=N_ROUNDS, **over):
    p = {**BASE, **TORCH, **over}
    for k in ("checkpoint_dir", "resume_from_checkpoint"):
        if k in p:
            p[k] = str(tmp_path / p[k])
    valid = p.pop("_valid", None)
    ds = lt.Dataset(X[:240], label=Y[:240]) if valid else \
        lt.Dataset(X, label=Y)
    vs = [ds.create_valid(X[240:], label=Y[240:])] if valid else None
    return lt.train(p, ds, rounds, valid_sets=vs)


def test_retention_corrupt_fallback_and_best_iteration(tmp_path):
    """corrupt_snapshot@iter=8 fails iteration 8's manifest; the resume
    falls back to iteration 4 and still reaches the uninterrupted model;
    retention keeps the newest two; best_iteration rides the state."""
    _train(tmp_path, "faulty", rounds=10, checkpoint_interval=4,
           checkpoint_dir="faulty", fault_plan="corrupt_snapshot@iter=8")
    mgr = CheckpointManager(str(tmp_path / "faulty"))
    assert [it for it, _ in mgr.checkpoints()] == [4, 8]
    ok, reason = verify_manifest(mgr.path_for(8))
    assert not ok and "sha256" in reason
    assert mgr.load_latest()["iteration"] == 4
    base = _train(tmp_path, "base", rounds=12, checkpoint_interval=4,
                  checkpoint_dir="base")
    resumed = _train(tmp_path, "resumed", rounds=12, checkpoint_interval=4,
                     checkpoint_dir="resumed",
                     resume_from_checkpoint="faulty")
    assert _md5(resumed) == _md5(base)
    kept = _train(tmp_path, "kept", rounds=12, checkpoint_interval=2,
                  checkpoint_dir="kept", checkpoint_retention=2)
    assert [it for it, _ in CheckpointManager(
        str(tmp_path / "kept")).checkpoints()] == [10, 12]
    state = capture_trainer_state(kept._gbdt, best_iteration=5)
    CheckpointManager(str(tmp_path / "best")).save(state, 12)
    done = _train(tmp_path, "done", rounds=12,
                  resume_from_checkpoint="best")
    assert done.best_iteration == 5
    assert done.model_to_string(num_iteration=-1) == \
        kept.model_to_string()
    with pytest.raises(FatalError, match="does not match"):
        lt.train({**BASE, **TORCH, "resume_from_checkpoint":
                  str(tmp_path / "best")},
                 lt.Dataset(X[:100], label=Y[:100]), N_ROUNDS)


# ---------------------------------------------------------------------------
# resume: md5-equal to the uninterrupted run and to the run without
# checkpoints
# ---------------------------------------------------------------------------
REGIMES = {
    "bagging": {},
    "goss": dict(data_sample_strategy="goss", bagging_freq=0),
    "quantized": dict(use_quantized_grad=True),
    "valid_early_stopping": dict(_valid=True, metric="binary_logloss",
                                 early_stopping_round=5,
                                 learning_rate=0.05),
}


@pytest.mark.parametrize("batched", [False, True],
                         ids=["per_iteration", "batched"])
@pytest.mark.parametrize("regime", list(REGIMES))
def test_resume_md5_equal(tmp_path, monkeypatch, regime, batched):
    monkeypatch.setenv("LIGHTGBM_TPU_DISABLE_BATCHED", "" if batched
                       else "1")
    over = REGIMES[regime]
    plain = _train(tmp_path, "plain", **over)
    full = _train(tmp_path, "full", checkpoint_interval=4,
                  checkpoint_dir="full", **over)
    assert full._gbdt.batched_veto == ("" if batched
                                       else "LIGHTGBM_TPU_DISABLE_BATCHED")
    with pytest.raises(InjectedFault, match=f"iteration {FAULT_AT}"):
        _train(tmp_path, "cut", checkpoint_interval=4,
               checkpoint_dir="cut", fault_plan=f"raise@iter={FAULT_AT}",
               **over)
    resumed = _train(tmp_path, "resumed", checkpoint_interval=4,
                     checkpoint_dir="resumed", resume_from_checkpoint="cut",
                     **over)
    assert resumed.num_trees() == full.num_trees() == N_ROUNDS
    assert _md5(resumed) == _md5(full) == _md5(plain)
    assert resumed.best_iteration == full.best_iteration
    if over.get("_valid"):
        np.testing.assert_array_equal(
            resumed._gbdt._valid_scores[0].numpy(),
            full._gbdt._valid_scores[0].numpy())
    np.testing.assert_array_equal(resumed._gbdt.scores.numpy(),
                                  full._gbdt.scores.numpy())


def test_no_orchestration_params_in_model_text(tmp_path):
    b = _train(tmp_path, "c", rounds=3, checkpoint_interval=4,
               checkpoint_dir="c", step_max_retries=1)
    text = b.model_to_string()
    for knob in ("checkpoint_dir", "resume_from_checkpoint", "fault_plan",
                 "step_max_retries"):
        assert knob not in text


_WORKER = """\
import json, sys
import numpy as np
import lightgbm_tpu_torch as lt
spec = json.load(open(sys.argv[1]))
rng = np.random.RandomState(0)
X = rng.normal(size=({n}, {c})).astype(np.float32)
y = (X[:, 0] + 0.5 * rng.normal(size={n}) > 0).astype(np.float32)
lt.train(spec["params"], lt.Dataset(X, label=y), spec["rounds"])
""".format(n=N_ROWS, c=N_COLS)


def test_kill_subprocess_exits_17_and_resumes(tmp_path):
    """kill@iter is a hard os._exit(17): in a subprocess, which leaves
    iteration 4's checkpoint; the resume equals the uninterrupted run."""
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"params": {
        **BASE, **TORCH, "checkpoint_interval": 4,
        "checkpoint_dir": str(tmp_path / "killed"),
        "fault_plan": f"kill@iter={FAULT_AT}"}, "rounds": N_ROUNDS}))
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    env.pop("LIGHTGBM_TPU_FAULT_PLAN", None)
    r = subprocess.run([sys.executable, str(worker), str(spec)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 17, r.stdout[-2000:] + r.stderr[-2000:]
    assert [it for it, _ in CheckpointManager(
        str(tmp_path / "killed")).checkpoints()] == [4]
    resumed = _train(tmp_path, "r", checkpoint_interval=4,
                     checkpoint_dir="r", resume_from_checkpoint="killed")
    assert _md5(resumed) == _md5(_train(tmp_path, "p"))


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Two JAX package runs: A trains N_ROUNDS under
    fail_collective@iter=2:times=2 with two retries and checkpoints every
    4; B resumes from A's directory to 12 rounds. (A's directory, A's
    collective failures, A's model text, B's model text)."""
    d = tmp_path_factory.mktemp("jax_ckpt")
    a = lj.train(dict(BASE, checkpoint_interval=4,
                      checkpoint_dir=str(d / "a"), fault_plan=FAIL,
                      step_max_retries=2, step_retry_backoff_s=0.0),
                 lj.Dataset(X, label=Y), N_ROUNDS)
    b = lj.train(dict(BASE, checkpoint_interval=4,
                      checkpoint_dir=str(d / "b"),
                      resume_from_checkpoint=str(d / "a")),
                 lj.Dataset(X, label=Y), 12)
    return (d / "a", a._gbdt._collective_failures, a.model_to_string(),
            b.model_to_string())


FAIL = "fail_collective@iter=2:times=2"


def test_watchdog_and_resumed_trees_equal_jax(tmp_path, jax_runs):
    """fail_collective@iter=2:times=2 on one device: the watchdog counts
    two collective failures and, with two retries, trains on to the JAX
    package's trees; a resume from that run's checkpoints grows the JAX
    package's resumed trees."""
    a = lt.train({**BASE, **TORCH, "checkpoint_interval": 4,
                  "checkpoint_dir": str(tmp_path / "a"), "fault_plan": FAIL,
                  "step_max_retries": 2, "step_retry_backoff_s": 0.0},
                 lt.Dataset(X, label=Y), N_ROUNDS)
    assert a._gbdt._collective_failures == jax_runs[1] == 2
    _assert_same_trees(a.model_to_string(), jax_runs[2], N_ROUNDS)
    b = lt.train({**BASE, **TORCH, "checkpoint_interval": 4,
                  "checkpoint_dir": str(tmp_path / "b"),
                  "resume_from_checkpoint": str(tmp_path / "a")},
                 lt.Dataset(X, label=Y), 12)
    _assert_same_trees(b.model_to_string(), jax_runs[3], 12)


def test_fail_collective_without_retries_raises_as_jax():
    p = dict(BASE, fault_plan="fail_collective@iter=0", step_max_retries=0)
    with pytest.raises(CollectiveFault, match="iteration 0"):
        lt.train({**p, **TORCH}, lt.Dataset(X, label=Y), 4)
    with pytest.raises(jfaults.CollectiveFault, match="iteration 0"):
        lj.train(p, lj.Dataset(X, label=Y), 4)


def test_jax_checkpoint_refused_without_importing_jax(jax_runs):
    """The port names the JAX package's format and refuses it, importing
    neither jax nor lightgbm_tpu (a fresh interpreter)."""
    code = (
        "import sys\n"
        "from lightgbm_tpu_torch.runtime.checkpoint import load_checkpoint\n"
        "from lightgbm_tpu_torch.utils.log import FatalError\n"
        "try:\n"
        f"    load_checkpoint({str(jax_runs[0])!r})\n"
        "except FatalError as e:\n"
        "    print('REFUSED', e)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'lightgbm_tpu')]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                       env={**os.environ, "PYTHONPATH": str(ROOT)},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "REFUSED" in r.stdout and "format 1" in r.stdout \
        and "JAX package" in r.stdout
    # a single file too, and in process
    path = sorted(jax_runs[0].glob("ckpt_iter_*.pkl"))[-1]
    with pytest.raises(FatalError, match="JAX package"):
        load_checkpoint(str(path))
