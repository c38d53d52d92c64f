"""The PyTorch port stands alone: it imports neither jax nor lightgbm_tpu,
and its entry points refuse to run on the CPU unless asked to."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "lightgbm_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return any(module == m or module.startswith(m + ".")
               for m in ("jax", "jaxlib", "lightgbm_tpu"))


def _imports(path: Path):
    """Every absolute module name imported anywhere in `path`."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, lightgbm_tpu_torch, lightgbm_tpu_torch.convert\n"
            "import lightgbm_tpu_torch.ops.histogram_cuda\n"
            "import lightgbm_tpu_torch.ops.bucketize\n"
            "import lightgbm_tpu_torch.ops.predict_binned\n"
            "import lightgbm_tpu_torch.ops.categorical\n"
            "import lightgbm_tpu_torch.ops.histogram_rowwise\n"
            "import lightgbm_tpu_torch.ops.grow_wave\n"
            "import lightgbm_tpu_torch.ops.grow_fused\n"
            "import lightgbm_tpu_torch.utils.synthetic\n"
            "import lightgbm_tpu_torch.utils.random\n"
            "import lightgbm_tpu_torch.models.sample_strategy\n"
            "import lightgbm_tpu_torch.objectives.rank\n"
            "import lightgbm_tpu_torch.metrics.rank_utils\n"
            "import lightgbm_tpu_torch.serving\n"
            "import lightgbm_tpu_torch.runtime.profiler\n"
            "import lightgbm_tpu_torch.runtime.autotune\n"
            "import lightgbm_tpu_torch.models.shap\n"
            "import lightgbm_tpu_torch.sklearn\n"
            "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', "
            "'lightgbm_tpu') or m.startswith(('jax.', 'jaxlib.', "
            "'lightgbm_tpu.'))]\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _data():
    rng = np.random.RandomState(0)
    X = rng.normal(size=(200, 4)).astype(np.float32)
    return X, (X[:, 0] > 0).astype(np.float32)


def test_booster_default_device_raises_without_card(monkeypatch):
    _no_card(monkeypatch)
    X, y = _data()
    assert lt.Config().device_type == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lt.Booster(params={"objective": "binary", "verbose": -1},
                   train_set=lt.Dataset(X, label=y))


def test_dataset_default_device_raises_without_card(monkeypatch):
    _no_card(monkeypatch)
    X, y = _data()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lt.Dataset(X, label=y).construct()


def test_train_default_device_raises_without_card(monkeypatch):
    _no_card(monkeypatch)
    X, y = _data()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lt.train({"objective": "binary", "verbose": -1},
                 lt.Dataset(X, label=y), num_boost_round=2)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches its kernel or raises: handed CPU tensors
    it raises instead of computing on the host."""
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    X = torch.zeros((3, 10), dtype=torch.uint8)
    vals = torch.zeros((2, 10))
    lor = torch.zeros(10, dtype=torch.int32)
    tbl = torch.full((16, 128), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        hc.build_histogram_slots_cuda(X, vals, None, 1, 32)
    with pytest.raises(ValueError, match="CUDA"):
        hc.take_leaf_values_cuda(torch.zeros(4), lor)
    with pytest.raises(ValueError, match="CUDA"):
        hc.wave_pass_cuda(X, vals, lor, tbl, 1, 32, 4)
    with pytest.raises(ValueError, match="CUDA"):
        hc.wave_relabel_cuda(X, lor, tbl, 4)
    with pytest.raises(ValueError, match="CUDA"):
        hc.wave_relabel_cuda(X, lor, tbl, 4, out=lor)
    with pytest.raises(ValueError, match="CUDA"):
        hc.wave_apply_cuda(X, lor, tbl, None, None, 4, 4)
    from lightgbm_tpu_torch.ops import grow_fused as gf
    from lightgbm_tpu_torch.ops.split import SplitHyperParams
    hp = SplitHyperParams(20.0, 1e-3, 0.0, 0.0, 0.0, 0.0, 0.0)
    scan = (torch.zeros((1, 192)), torch.zeros((7, 2)),
            torch.zeros((5, 3), dtype=torch.int32),
            torch.ones(3, dtype=torch.uint8))
    with pytest.raises(ValueError, match="CUDA"):
        gf.wave_pass_fused_cuda(X, vals, lor, tbl, *scan, 1, 32, 4, hp)
    with pytest.raises(ValueError, match="CUDA"):
        gf.wave_pass_fused_tiled_cuda(
            X, vals, X[:1].clone(), lor, tbl,
            torch.full((128,), -1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), *scan, 1, 32, 4, hp)
