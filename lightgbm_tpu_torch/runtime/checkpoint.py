"""Iteration-level deterministic checkpoint / resume.

Counterpart of lightgbm_tpu/runtime/checkpoint.py. A checkpoint captures
the trainer's whole state at an iteration boundary: the host trees (each
pending device tree materialized under the learning rate it grew with),
the exact f32 bytes of the training and valid scores, CEGB's paid
features, the objective's identity (and its host RNG's position, where
it draws one: rank_xendcg) and the pins of the grower, the routes and
the autotune decision. Sampling needs no carried state: every mask is a
function of the iteration (models/sample_strategy.py), so restore derives
the in-bag mask live at the save point again. A run killed at iteration
k and resumed gives the same model bytes as a run never interrupted
(tests/test_torch_resilience.py, per iteration and batched).

On-disk layout (the JAX package's names, docs/ROBUSTNESS.md):

    <dir>/ckpt_iter_0000010.pkl                the state
    <dir>/ckpt_iter_0000010.pkl.manifest.json  {"sha256", "bytes", ...}

The state file is `MAGIC` and then a pickle of numpy arrays, builtins and
this package's classes, read back through an unpickler that admits
nothing else, so loading a checkpoint imports neither jax nor the JAX
package. A JAX checkpoint (a pickle of its own classes, format 1) is
refused, naming its format, before a byte of it is unpickled. Every
write is atomic (same-directory temp -> flush -> fsync -> os.replace) and
the manifest is written last, from the in-memory payload's hash: a torn
or corrupted payload fails its checksum and the loader falls back to the
next-older checkpoint. Retention is bounded (newest N kept).

Stdlib + numpy at the top level (imported eagerly by runtime/__init__);
torch and the model classes are imported inside the functions.
"""

import hashlib
import io
import json
import os
import pickle
import re
import tempfile
from typing import Any, Dict, List, Optional, Tuple

from ..utils.log import log_fatal, log_info, log_warning

STATE_FORMAT = "lightgbm_tpu_torch/1"
MAGIC = b"LGBT-TORCH-CKPT/1\n"
_CKPT_RE = re.compile(r"ckpt_iter_(\d+)\.pkl$")


class CheckpointError(RuntimeError):
    """A checkpoint file is missing, truncated, or fails its checksum."""


# ---------------------------------------------------------------------------
# atomic writes + checksum manifests (shared with Booster.save_model and
# the CLI's snapshots: no reader may ever observe a half-written file)

def _atomic_write(path: str, data: bytes) -> None:
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_bytes(path: str, data: bytes) -> None:
    """write-temp -> fsync -> rename; the destination either holds the
    old content or the complete new content, never a prefix."""
    _atomic_write(path, data)


def atomic_write_text(path: str, text: str) -> None:
    _atomic_write(path, text.encode("utf-8"))


def manifest_path(path: str) -> str:
    return path + ".manifest.json"


def _write_manifest_for_bytes(path: str, payload: bytes,
                              extra: Optional[Dict[str, Any]] = None) -> None:
    manifest = {"sha256": hashlib.sha256(payload).hexdigest(),
                "bytes": len(payload)}
    if extra:
        manifest.update(extra)
    atomic_write_text(manifest_path(path),
                      json.dumps(manifest, indent=2, sort_keys=True))


def write_manifest(path: str,
                   extra: Optional[Dict[str, Any]] = None) -> None:
    """Sidecar checksum for an already-written file (model snapshots)."""
    with open(path, "rb") as f:
        _write_manifest_for_bytes(path, f.read(), extra)


def verify_manifest(path: str) -> Tuple[bool, str]:
    """(ok, reason). Fails on a missing or unreadable manifest, a size
    mismatch (truncation) or a checksum mismatch (corruption)."""
    mpath = manifest_path(path)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        return False, "missing manifest"
    except Exception as e:
        return False, f"unreadable manifest: {e!r}"
    try:
        with open(path, "rb") as f:
            payload = f.read()
    except Exception as e:
        return False, f"unreadable payload: {e!r}"
    if len(payload) != int(manifest.get("bytes", -1)):
        return False, (f"size mismatch: {len(payload)} != "
                       f"{manifest.get('bytes')} (truncated?)")
    if hashlib.sha256(payload).hexdigest() != manifest.get("sha256"):
        return False, "sha256 mismatch (corrupted)"
    return True, "ok"


# ---------------------------------------------------------------------------
# the state payload

_NUMPY_MODULES = ("numpy", "numpy.core.multiarray", "numpy._core.multiarray",
                  "numpy.core.numeric", "numpy._core.numeric")
_NUMPY_NAMES = ("ndarray", "dtype", "_reconstruct", "scalar", "_frombuffer")


class _StateUnpickler(pickle.Unpickler):
    """Admits numpy's array and scalar reconstructors and this package's
    classes, nothing else: a state never imports another module."""

    def find_class(self, module: str, name: str):
        if module in _NUMPY_MODULES and name in _NUMPY_NAMES:
            return super().find_class(module, name)
        if module.startswith("lightgbm_tpu_torch."):
            obj = super().find_class(module, name)
            if isinstance(obj, type):
                return obj
        raise pickle.UnpicklingError(
            f"checkpoint state names {module}.{name}, which a "
            f"{STATE_FORMAT} state never holds")


def _refuse_foreign(path: str, fmt: Any) -> None:
    log_fatal(
        f"checkpoint {path} has format {fmt!r}, not {STATE_FORMAT!r}: "
        + ("it was written by the JAX package (lightgbm_tpu; format 1, a "
           "pickle of its own classes), which lightgbm_tpu_torch does not "
           "load" if fmt in (1, "1") else "this build cannot read it")
        + "; train again with lightgbm_tpu_torch to resume")


# ---------------------------------------------------------------------------
# checkpoint store

class CheckpointManager:
    """Bounded store of ``ckpt_iter_*.pkl`` snapshots in one directory.

    ``fault_plan`` is the test-only hook that corrupts a just-written
    payload (runtime/faults.py ``corrupt_snapshot``); the manifest hash is
    computed from the in-memory payload, so the corruption is detected at
    load time and the loader falls back."""

    def __init__(self, directory: str, retention: int = 3,
                 fault_plan: Optional[Any] = None):
        if not directory:
            log_fatal("CheckpointManager needs a checkpoint_dir")
        self.directory = directory
        self.retention = max(int(retention), 1)
        self.fault_plan = fault_plan

    def path_for(self, iteration: int) -> str:
        return os.path.join(self.directory,
                            f"ckpt_iter_{int(iteration):07d}.pkl")

    def checkpoints(self) -> List[Tuple[int, str]]:
        """(iteration, path) ascending by iteration."""
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        for name in names:
            m = _CKPT_RE.search(name)
            if m:
                out.append((int(m.group(1)),
                            os.path.join(self.directory, name)))
        return sorted(out)

    def save(self, state: Dict[str, Any], iteration: int) -> str:
        os.makedirs(self.directory, exist_ok=True)
        path = self.path_for(iteration)
        payload = MAGIC + pickle.dumps(state, protocol=4)
        atomic_write_bytes(path, payload)
        if self.fault_plan is not None and \
                self.fault_plan.should_corrupt_snapshot(iteration):
            from .faults import corrupt_file
            corrupt_file(path)
        # the manifest hash comes from the in-memory payload, not a
        # re-read: anything that mangles the file after the write
        # (injected or real) fails verification at load time
        _write_manifest_for_bytes(path, payload,
                                  {"iteration": int(iteration),
                                   "format": STATE_FORMAT})
        self._prune()
        return path

    def _prune(self) -> None:
        for _, path in self.checkpoints()[:-self.retention]:
            for p in (path, manifest_path(path)):
                try:
                    os.unlink(p)
                except OSError:
                    pass

    def load(self, path: str) -> Dict[str, Any]:
        try:
            with open(manifest_path(path)) as f:
                fmt = json.load(f).get("format", STATE_FORMAT)
        except (OSError, ValueError):
            fmt = STATE_FORMAT        # verify_manifest says what is wrong
        if fmt != STATE_FORMAT:
            _refuse_foreign(path, fmt)
        ok, reason = verify_manifest(path)
        if not ok:
            raise CheckpointError(f"checkpoint {path} rejected: {reason}")
        with open(path, "rb") as f:
            payload = f.read()
        if not payload.startswith(MAGIC):
            _refuse_foreign(path, 1 if payload[:1] == b"\x80" else "unknown")
        state = _StateUnpickler(io.BytesIO(payload[len(MAGIC):])).load()
        if state.get("format") != STATE_FORMAT:
            _refuse_foreign(path, state.get("format"))
        return state

    def load_latest(self) -> Optional[Dict[str, Any]]:
        """Newest checkpoint that passes verification; corrupt ones are
        skipped with a warning (the bounded-retention ladder is the
        recovery path for a fault during the checkpoint write itself). A
        checkpoint of another format is fatal, not skipped."""
        for it, path in reversed(self.checkpoints()):
            try:
                return self.load(path)
            except (CheckpointError, pickle.UnpicklingError,
                    EOFError) as e:
                log_warning(f"skipping checkpoint at iteration {it}: {e}")
        return None


def load_checkpoint(path: str) -> Dict[str, Any]:
    """``resume_from_checkpoint`` accepts a checkpoint file or a
    checkpoint directory (the newest valid snapshot wins)."""
    if os.path.isdir(path):
        state = CheckpointManager(path).load_latest()
        if state is None:
            log_fatal(f"no valid checkpoint found under {path}")
        return state
    if not os.path.exists(path):
        log_fatal(f"resume_from_checkpoint: {path} does not exist")
    return CheckpointManager(os.path.dirname(path) or ".").load(path)


# ---------------------------------------------------------------------------
# trainer state capture / restore

def _check_gbdt(gbdt, what: str) -> None:
    from ..models.gbdt import GBDT
    if type(gbdt) is not GBDT:
        log_fatal(f"{what} supports boosting=gbdt only (DART/RF carry "
                  "per-iteration drop state that is not captured; "
                  "docs/ROBUSTNESS.md escape hatches)")


def capture_trainer_state(gbdt, best_iteration: int = -1) -> Dict[str, Any]:
    """Snapshot the live trainer (JAX checkpoint.py:235-291). The trees a
    batched chunk left in the drain are folded in and the pending device
    trees materialized first, each under the learning rate it grew with;
    a materialized tree is the one the end of training would write. The
    scores are their exact f32 bytes."""
    import numpy as np
    _check_gbdt(gbdt, "checkpointing")
    if gbdt._drain is not None:
        gbdt._drain.flush()
    models = gbdt.models

    def host(t):
        return None if t is None else t.detach().cpu().numpy()
    rng = getattr(gbdt.objective, "_rng", None)
    return {
        "format": STATE_FORMAT,
        "iteration": int(gbdt.iter),
        "stopped": bool(gbdt._stopped),
        "best_iteration": int(best_iteration),
        "num_data": int(gbdt.num_data),
        "num_class": int(gbdt.num_class),
        "num_tree_per_iteration": int(gbdt.num_tree_per_iteration),
        "objective": (gbdt.objective.to_string()
                      if gbdt.objective is not None else ""),
        "objective_rng": (rng.get_state()
                          if isinstance(rng, np.random.RandomState)
                          else None),
        "shrinkage_rate": float(gbdt.shrinkage_rate),
        "models": list(models),
        "scores": host(gbdt.scores),
        "valid_scores": [host(v) for v in gbdt._valid_scores],
        "cegb_used": host(gbdt._cegb_used),
        "grower": str(gbdt.grower),
        "grow_pins": {"hist_impl": str(gbdt.grow_cfg.hist_impl)},
        "routes": [str(gbdt.grow_route), str(gbdt.hist_route)],
        "autotune_decision": gbdt.autotune_decision,
    }


def restore_trainer_state(gbdt, state: Dict[str, Any]) -> None:
    """Bring a freshly initialized trainer to the save point (JAX
    checkpoint.py:294-385):

      * the scores (training, valid) and CEGB's paid features are copied
        byte for byte into the trainer's own tensors, on its device;
      * the grower, the histogram_impl and the autotune decision are
        pinned from the state, never probed again (engine.train hands
        the decision to the trainer's init through
        `runtime.autotune.pinned_decision`); a route that differs is
        built again from the pins;
      * the in-bag mask live at the save point is derived again from its
        iteration (bagging floors the iteration to its window's start;
        GOSS draws anew from the next iteration's gradients).
    """
    import numpy as np
    import torch
    _check_gbdt(gbdt, "resume_from_checkpoint")
    if state.get("format") != STATE_FORMAT:
        _refuse_foreign("<state>", state.get("format"))
    for key in ("num_data", "num_class", "num_tree_per_iteration"):
        if int(state[key]) != int(getattr(gbdt, key)):
            log_fatal(f"checkpoint {key}={state[key]} does not match the "
                      f"training set ({getattr(gbdt, key)}); resume needs "
                      "the identical dataset and params")
    obj = gbdt.objective.to_string() if gbdt.objective is not None else ""
    if str(state.get("objective", "")) != obj:
        log_fatal(f"checkpoint objective {state.get('objective')!r} does "
                  f"not match configured objective {obj!r}")

    gbdt._models = list(state["models"])
    gbdt._pending = []
    gbdt.iter = int(state["iteration"])
    gbdt._stopped = bool(state["stopped"])
    gbdt.shrinkage_rate = float(state["shrinkage_rate"])
    gbdt._packed_cache = None
    gbdt._device_tables_cache = None

    def put(dst: torch.Tensor, src) -> None:
        src = torch.from_numpy(np.ascontiguousarray(src))
        if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
            log_fatal(f"checkpoint tensor {tuple(src.shape)} {src.dtype} "
                      f"does not match the trainer's {tuple(dst.shape)} "
                      f"{dst.dtype}")
        dst.copy_(src)
    put(gbdt.scores, state["scores"])
    vs = state.get("valid_scores") or []
    if gbdt._valid_scores:
        if len(vs) == len(gbdt._valid_scores):
            for dst, src in zip(gbdt._valid_scores, vs):
                put(dst, src)
        else:
            log_warning(f"checkpoint holds {len(vs)} valid-score sets but "
                        f"{len(gbdt._valid_scores)} valid sets are "
                        "registered; keeping replayed valid scores")
    if state.get("cegb_used") is not None and gbdt._cegb_used is not None:
        put(gbdt._cegb_used, state["cegb_used"])
    rng = getattr(gbdt.objective, "_rng", None)
    if state.get("objective_rng") is not None \
            and isinstance(rng, np.random.RandomState):
        rng.set_state(state["objective_rng"])

    pins = state.get("grow_pins") or {}
    grower = str(state.get("grower") or gbdt.grower)
    hist_impl = str(pins.get("hist_impl") or gbdt.grow_cfg.hist_impl)
    if grower != gbdt.grower or hist_impl != gbdt.grow_cfg.hist_impl:
        gbdt.grower = grower
        gbdt.grow_cfg = gbdt.grow_cfg._replace(hist_impl=hist_impl)
        gbdt._set_routes()
    if state.get("autotune_decision") is not None:
        gbdt.autotune_decision = state["autotune_decision"]
    routes = state.get("routes")
    if routes and list(routes) != [gbdt.grow_route, gbdt.hist_route]:
        log_fatal(f"checkpoint routes {routes} differ from the pinned "
                  f"trainer's {[gbdt.grow_route, gbdt.hist_route]}; "
                  "resume needs the identical dataset and params")

    strat = gbdt.sample_strategy
    gbdt._in_bag = None
    if strat.resample_period() > 0 and not strat.needs_grad \
            and gbdt.iter > 0:
        # sample() floors the iteration to its window's start: the mask
        # the saving run held, whether it trained per iteration or in
        # batched chunks (whose edges are cut at checkpoint intervals)
        gbdt._in_bag = strat.sample(gbdt.iter, None, None)
    log_info(f"resumed from checkpoint at iteration {gbdt.iter}")
