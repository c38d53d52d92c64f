"""The port's command line (`python -m lightgbm_tpu_torch key=value ...`)
on the CPU, against the JAX package's: `parse_args` / `parse_config_file`
equal on the same argv, the CLI's model md5-equal to `lt.train` on
`load_text_file`'s arrays with the same params, train and predict through
both CLIs giving equal trees (structure exact, leaf values within 1e-5:
the JAX search sums in f32, the port in f64, ROADMAP C note 9) and
prediction files within 1e-5, refit and convert_model (the C++ byte-equal
to the JAX CLI's), the refusals naming their ROADMAP items, and one
`python -m lightgbm_tpu_torch` subprocess with snapshots and checkpoints."""

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lightgbm_tpu import cli as jcli
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import cli as tcli
from lightgbm_tpu_torch import native
from lightgbm_tpu_torch.data.loader import load_text_file
from lightgbm_tpu_torch.runtime.checkpoint import (CheckpointManager,
                                                   verify_manifest)

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _blocks(text):
    body = text.split("end of trees")[0]
    return [dict(ln.split("=", 1) for ln in blk.splitlines()[1:] if "=" in ln)
            for blk in body.split("Tree=")[1:]]


@pytest.fixture
def workdir(tmp_path):
    """A TSV training file (label first, 6 features, %.9g) and a config;
    every tree of 10 rounds is the same in both packages."""
    rng = np.random.RandomState(0)
    n = 500
    X = rng.normal(size=(n, 6))
    X[rng.rand(n) < 0.05, 3] = np.nan
    y = (X[:, 0] + X[:, 1] + 0.3 * rng.normal(size=n) > 0).astype(int)
    path = tmp_path / "train.tsv"
    np.savetxt(path, np.column_stack([y, X]), delimiter="\t", fmt="%.9g")
    conf = tmp_path / "train.conf"
    conf.write_text(
        "task = train\n"
        "objective = binary\n"
        f"data = {path}\n"
        "num_iterations = 10   # comment\n"
        "num_leaves = 7\n"
        "metric = auc\n"
        "verbosity = -1\n"
        f"output_model = {tmp_path / 'model.txt'}\n")
    return tmp_path, path, conf


ARGV = ["num_trees=3", "--profile", "--learning-rate=0.3", "eta=0.05",
        "min_child_samples=4", "device_type=cpu"]


def test_parse_args_matches_jax(workdir):
    tmp_path, _, conf = workdir
    assert tcli.parse_config_file(str(conf)) == \
        jcli.parse_config_file(str(conf))
    argv = [f"config={conf}"] + ARGV
    got = tcli.parse_args(argv)
    assert got == jcli.parse_args(argv)
    # the command line over the file, aliases canonical
    assert got["num_iterations"] == "3" and got["device_profile"] == "true"
    assert got["learning_rate"] == "0.05" and got["objective"] == "binary"
    with pytest.raises(lt.FatalError, match="expected key=value"):
        tcli.parse_args(["oops"])


def test_cli_model_equals_lt_train(workdir):
    """The CLI's model file is md5-equal to lt.train with the same params
    on load_text_file's arrays (the native parser ran)."""
    tmp_path, path, conf = workdir
    argv = [f"config={conf}", "device_type=cpu", "snapshot_freq=5"]
    assert tcli.main(argv) == 0
    assert native.LAST_PARSER == "native"
    params = tcli.parse_args(argv)
    X, y, _, _, names = load_text_file(str(path))
    bst = lt.train(params, lt.Dataset(X, label=y, feature_name=names), 10)
    text = (tmp_path / "model.txt").read_text()
    assert hashlib.md5(text.encode()).hexdigest() == \
        hashlib.md5(bst.model_to_string().encode()).hexdigest()
    for it in (5, 10):
        snap = f"{tmp_path / 'model.txt'}.snapshot_iter_{it}.txt"
        assert verify_manifest(snap) == (True, "ok")


def test_cli_train_predict_matches_jax(workdir):
    tmp_path, path, conf = workdir
    out = {}
    for name, mod in (("torch", tcli), ("jax", jcli)):
        model = tmp_path / f"model_{name}.txt"
        pred = tmp_path / f"pred_{name}.tsv"
        extra = ["device_type=cpu"] if name == "torch" else []
        assert mod.main([f"config={conf}", f"output_model={model}"]
                        + extra) == 0
        assert mod.main(["task=predict", f"data={path}",
                         f"input_model={model}", f"output_result={pred}",
                         "verbosity=-1"] + extra) == 0
        out[name] = (model.read_text(), np.loadtxt(pred))
    tt, tj = _blocks(out["torch"][0]), _blocks(out["jax"][0])
    assert len(tt) == len(tj) == 10
    for a, b in zip(tt, tj):
        # decision_type's default-left bit of a feature without missing
        # values is decided by rounding (ROADMAP C note 5)
        for k in ("num_leaves", "split_feature", "threshold", "left_child",
                  "right_child"):
            assert a[k] == b[k], k
        np.testing.assert_allclose(np.array(a["leaf_value"].split(), float),
                                   np.array(b["leaf_value"].split(), float),
                                   rtol=0, atol=1e-5)
    assert out["torch"][1].shape == (500,)
    np.testing.assert_allclose(out["torch"][1], out["jax"][1], rtol=0,
                               atol=1e-5)
    # the prediction file is Booster.predict of the same rows
    X, _, _, _, _ = load_text_file(str(path))
    bst = lt.Booster(params={"device_type": "cpu"},
                     model_file=str(tmp_path / "model_torch.txt"))
    np.testing.assert_array_equal(out["torch"][1], bst.predict(X))


def test_cli_refit_and_convert(workdir):
    tmp_path, path, conf = workdir
    model = tmp_path / "model.txt"
    assert tcli.main([f"config={conf}", "device_type=cpu"]) == 0
    refit = tmp_path / "refit.txt"
    assert tcli.main(["task=refit", f"data={path}", f"input_model={model}",
                      f"output_model={refit}", "verbosity=-1",
                      "device_type=cpu", "refit_decay_rate=0.5"]) == 0
    X, y, _, _, _ = load_text_file(str(path))
    want = lt.Booster(params={"device_type": "cpu"},
                      model_file=str(model)).refit(X, y, decay_rate=0.5)
    # the trees; the parameters echo each booster's own params
    assert refit.read_text().split("end of trees")[0] == \
        want.model_to_string().split("end of trees")[0]
    cpp = {}
    for name, mod in (("torch", tcli), ("jax", jcli)):
        out = tmp_path / f"model_{name}.cpp"
        assert mod.main(["task=convert_model", f"input_model={model}",
                         f"convert_model={out}", "verbosity=-1"]) == 0
        cpp[name] = out.read_text()
    assert cpp["torch"] == cpp["jax"]
    assert "double Predict(const double* arr)" in cpp["torch"]


@pytest.mark.parametrize("argv,item", [
    (["task=serve"], r"A18\(b\)"),
    (["task=online"], "A13"),
    (["task=convert_model", "convert_model_language=stablehlo"],
     r"A18\(b\)"),
])
def test_refusals_name_their_items(argv, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        tcli.main(argv + ["device_type=cpu", "input_model=m.txt"])
    with pytest.raises(lt.FatalError, match="Unknown task"):
        tcli.main(["task=explode", "device_type=cpu"])


def test_python_m_subprocess(workdir):
    """`python -m lightgbm_tpu_torch` with checkpoints and a profile: rc 0,
    the checkpoints and the profile's records; then a resume in process
    reaches the same model."""
    tmp_path, path, conf = workdir
    ckpt = tmp_path / "ckpt"
    prof = tmp_path / "profile.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    r = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch", f"config={conf}",
         "device_type=cpu", "checkpoint_interval=4",
         f"checkpoint_dir={ckpt}", "device_profile=true",
         f"profile_output={prof}"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert [it for it, _ in CheckpointManager(str(ckpt)).checkpoints()] \
        == [4, 8]
    assert json.loads(prof.read_text())["n_iters"] == 10
    # the model text echoes output_model and the profile params, so the
    # resume writes the same path under the same flags
    first = (tmp_path / "model.txt").read_text()
    assert tcli.main([f"config={conf}", "device_type=cpu",
                      "checkpoint_interval=4",
                      f"checkpoint_dir={tmp_path / 'ckpt2'}",
                      f"resume_from_checkpoint={ckpt}",
                      "device_profile=true",
                      f"profile_output={prof}"]) == 0
    assert (tmp_path / "model.txt").read_text() == first
