"""Exported serving in the port (lightgbm_tpu_torch/export/compile.py and
runtime.py) on the CPU: tests/test_export.py's cases, ported.

Each model is built in both packages from the same model text and the same
bin mappers. The bitwise contracts:
  * CompiledModel.predict / score_margin == the port's Booster.predict
    (the programs' leaf indices accumulated against the artifact's f64
    leaf table) == the JAX artifact's predict;
  * CompiledModel.score_margin_f32 == ServingSession("binned");
  * ServingSession(engine="compiled") == ServingSession("binned");
for f64 rows (host binning) and f32 rows (the bin_score programs), plus the
standalone loader in a subprocess by file path (no jax and none of the
port's models / engine / basic imported), sha256 tamper detection, the
refusal of a JAX artifact by name, the linear-tree refusal and the
task=convert_model convert_model_language=torch_export CLI.
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
from lightgbm_tpu.data.binning import BinMapper as JBinMapper
from lightgbm_tpu.export import export_model as j_export_model
from lightgbm_tpu.export import load_compiled as j_load_compiled
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import cli as tcli
from lightgbm_tpu_torch.export import (attach_bucketize, export_model,
                                       load_compiled, roundtrip_raw_scorer)
from lightgbm_tpu_torch.export import runtime as rt
from lightgbm_tpu_torch.ops.predict_binned import (BinnedUnavailable,
                                                   mappers_for)
from lightgbm_tpu_torch.serving import ServingSession
from lightgbm_tpu_torch.utils.log import FatalError

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

COLS = 8
CPU = {"device_type": "cpu", "verbose": -1}
LADDER = dict(max_batch=16, min_bucket=8)
# the parity cases export one bucket a program kind (each torch.export
# takes about a second on the CPU); the ladder of two buckets is held by
# the compiled engine's warmup and the CLI case
ONE_BUCKET = dict(max_batch=8, min_bucket=8)


def _md5(a) -> str:
    return hashlib.md5(np.ascontiguousarray(np.asarray(a))
                       .tobytes()).hexdigest()


def _train(seed, n=600, objective="regression", rounds=6, cat_cols=(),
           **params):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, COLS))
    for c in cat_cols:
        X[:, c] = rng.randint(0, 12, size=n)
    X[rng.rand(n, COLS) < 0.05] = np.nan
    X[rng.rand(n, COLS) < 0.05] = 0.0
    x0, x1 = np.nan_to_num(X[:, 0]), np.nan_to_num(X[:, 1])
    if objective == "multiclass":
        y = (x0 > 0).astype(int) + (x1 > 0.5)
        params.setdefault("num_class", 3)
    elif objective == "binary":
        y = (x0 + x1 > 0).astype(float)
    else:
        y = x0 * 2 + 0.1 * rng.normal(size=n)
    p = dict(objective=objective, num_leaves=12, min_data_in_leaf=5,
             **CPU, **params)
    if cat_cols:
        p["categorical_feature"] = list(cat_cols)
    return lt.train(p, lt.Dataset(X, label=y), num_boost_round=rounds), X


def _query(seed, X, n=37, cat_cols=()):
    rng = np.random.RandomState(seed)
    q = rng.normal(scale=2.0, size=(n, COLS))
    q[rng.rand(n, COLS) < 0.08] = np.nan
    q[rng.rand(n, COLS) < 0.08] = 0.0
    q[:10] = X[:10]
    for c in cat_cols:
        q[:, c] = rng.randint(-2, 14, size=n)
        q[10:14, c] = [np.nan, 99.0, -3.0, 2.7]
    return q


MODELS = {
    "regression_cat": dict(seed=3, cat_cols=(2, 6)),
    "binary": dict(seed=4, objective="binary", sigmoid=1.7),
    "multiclass": dict(seed=5, objective="multiclass"),
    "rf": dict(seed=6, boosting="rf", bagging_freq=1, bagging_fraction=0.7,
               feature_fraction=0.9),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_artifact_bitwise_booster_and_jax_artifact(name, tmp_path):
    """The port's artifact against the port's Booster.predict, its binned
    and compiled sessions, and the JAX artifact exported from the same
    model text and mappers."""
    kw = dict(MODELS[name])
    cat = kw.get("cat_cols", ())
    bst, X = _train(**kw)
    text = bst.model_to_string()
    mappers = mappers_for(bst._gbdt)
    loaded = lt.Booster(params=CPU, model_str=text)
    manifest = export_model(loaded, str(tmp_path / "art"),
                            bin_mappers=mappers, **ONE_BUCKET)
    assert manifest["format"] == rt.FORMAT and manifest["bin_and_score"]
    assert manifest["buckets"] == [8]
    cm = load_compiled(str(tmp_path / "art"), device="cpu")
    jbst = lj.Booster(model_str=text)
    j_export_model(jbst, str(tmp_path / "jart"), bin_mappers=[
        None if m is None else JBinMapper.from_dict(m.to_dict())
        for m in mappers], **ONE_BUCKET)
    jcm = j_load_compiled(str(tmp_path / "jart"))
    s_bin = ServingSession(bst._gbdt, engine="binned", binning_impl="device",
                           **ONE_BUCKET)
    s_cmp = ServingSession(bst._gbdt, engine="compiled",
                           binning_impl="device", **ONE_BUCKET)
    assert s_cmp.engine == "compiled"
    # the kernel route (attach_bucketize; on the CPU the binner is #6's
    # plain version) beside the bin_score program route
    cmk = attach_bucketize(rt.CompiledModel.load(str(tmp_path / "art"),
                                                 device="cpu"))
    assert (cm.raw_route, cmk.raw_route) == ("program", "kernel")
    binned_rows = []
    binner = cmk.binner
    cmk.binner = lambda Xt: binned_rows.append(len(Xt)) or binner(Xt)
    q = _query(kw["seed"] + 10, X, cat_cols=cat)
    for Xq in (q, q.astype(np.float32)):
        want = bst.predict(Xq)
        assert _md5(cm.predict(Xq)) == _md5(want)
        assert _md5(cmk.predict(Xq)) == _md5(want)
        assert _md5(cmk.score_margin_f32(Xq)) == _md5(cm.score_margin_f32(Xq))
        assert _md5(cm.predict(Xq, raw_score=True)) == \
            _md5(bst.predict(Xq, raw_score=True))
        assert _md5(cm.predict(Xq)) == _md5(jcm.predict(Xq))
        assert _md5(cm.score_margin_f32(Xq)) == _md5(s_bin.score_margin(Xq))
        assert _md5(s_cmp.score_margin(Xq)) == _md5(s_bin.score_margin(Xq))
        assert _md5(s_cmp.predict(Xq)) == _md5(s_bin.predict(Xq))
    assert sum(binned_rows) >= 2 * len(q)      # f32 rows, twice
    if name == "binary":
        assert cm.transform == "sigmoid" and cm.sigmoid == pytest.approx(1.7)
    if name == "multiclass":
        assert cm.transform == "softmax" and cm.K == 3
    if name == "rf":
        assert cm.avg_div == 6


def test_raw_scorer_and_compiled_warmup():
    """roundtrip_raw_scorer (the bin_score program) equals the binned
    session's raw-f32 route; the compiled engine's warmup runs the whole
    ladder, and without mappers it raises as the binned engine does."""
    bst, X = _train(7, rounds=4)
    s = ServingSession(bst._gbdt, engine="compiled", binning_impl="device",
                       **LADDER)
    assert s.warmup() == [8, 16]
    info = s.cache_info()
    assert info["engine"] == "compiled" and info["entries"] == 4
    s_bin = ServingSession(bst._gbdt, engine="binned",
                           binning_impl="device", **LADDER)
    fn = roundtrip_raw_scorer(s._bm, s._bin_table, 1, 16)
    q = _query(8, X, n=16).astype(np.float32)
    got = fn(torch.from_numpy(q)).numpy().astype(np.float64)
    assert _md5(got) == _md5(s_bin.score_margin(q))
    with pytest.raises(BinnedUnavailable, match="compiled engine"):
        ServingSession.from_model_string(bst.model_to_string(),
                                         engine="compiled",
                                         device_type="cpu")


def test_standalone_loader_no_model_stack(tmp_path):
    """A subprocess scores from the artifact through runtime.py loaded BY
    FILE PATH: neither jax nor the port's models / engine / basic is
    imported, and the predictions are Booster.predict's bits."""
    bst, X = _train(9, rounds=4)
    q = _query(11, X, n=23)
    export_model(bst, str(tmp_path / "art"), **ONE_BUCKET)
    np.save(tmp_path / "q.npy", q)
    expect = _md5(bst.predict(q))
    script = f"""
import importlib.util, sys
import numpy as np
spec = importlib.util.spec_from_file_location(
    "export_runtime", {str(rt.__file__)!r})
runtime = importlib.util.module_from_spec(spec)
spec.loader.exec_module(runtime)
model = runtime.CompiledModel.load({str(tmp_path / 'art')!r}, device="cpu")
preds = model.predict(np.load({str(tmp_path / 'q.npy')!r}))
forbidden = [m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m in ("lightgbm_tpu_torch.models", "lightgbm_tpu_torch.engine",
                      "lightgbm_tpu_torch.basic", "lightgbm_tpu")
             or m.startswith(("lightgbm_tpu_torch.models.",
                              "lightgbm_tpu.", "lightgbm_tpu_torch.engine.",
                              "lightgbm_tpu_torch.basic."))]
assert not forbidden, f"training stack leaked into the loader: {{forbidden}}"
import hashlib
print(hashlib.md5(np.ascontiguousarray(preds).tobytes()).hexdigest())
"""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)      # the loader needs numpy and torch only
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == expect


def test_tamper_and_jax_artifact_refused(tmp_path):
    bst, X = _train(12, rounds=3)
    art = tmp_path / "art"
    export_model(bst, str(art), max_batch=8, min_bucket=8)
    manifest = json.loads((art / "manifest.json").read_text())
    victim = sorted(f for f in manifest["files"] if f.endswith(".pt2"))[0]
    blob = bytearray((art / victim).read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    (art / victim).write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="sha256 mismatch"):
        load_compiled(str(art), device="cpu")
    load_compiled(str(art), verify=False, device="cpu")   # explicit opt-out
    manifest["format"] = "not-a-real-format"
    (art / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="unknown artifact format"):
        load_compiled(str(art), device="cpu")
    # a real JAX artifact of the same model is refused by its name
    jbst = lj.Booster(model_str=bst.model_to_string())
    j_export_model(jbst, str(tmp_path / "jart"), max_batch=8, min_bucket=8,
                   bin_mappers=[None if m is None else
                                JBinMapper.from_dict(m.to_dict())
                                for m in mappers_for(bst._gbdt)])
    with pytest.raises(ValueError, match="lightgbm-tpu-stablehlo-v1.*JAX"):
        load_compiled(str(tmp_path / "jart"), device="cpu")


def test_linear_tree_and_text_model_refusals(tmp_path):
    """Linear trees are refused naming their indices; a text model needs
    its mappers, and with them exports the same artifact bits."""
    rng = np.random.RandomState(13)
    X = rng.normal(size=(300, COLS))
    y = X[:, 0] * 2 + 0.1 * rng.normal(size=300)
    lin = lt.train(dict(objective="regression", num_leaves=8,
                        linear_tree=True, min_data_in_leaf=10, **CPU),
                   lt.Dataset(X, label=y), num_boost_round=3)
    with pytest.raises(ValueError, match=r"tree\(s\) \[0") as ei:
        export_model(lin, str(tmp_path / "lin"))
    assert "linear_tree=false" in str(ei.value)
    bst, X = _train(14, rounds=4)
    loaded = lt.Booster(params=CPU, model_str=bst.model_to_string())
    with pytest.raises(BinnedUnavailable):
        export_model(loaded, str(tmp_path / "art"))
    export_model(loaded, str(tmp_path / "art"),
                 bin_mappers=mappers_for(bst._gbdt), **LADDER)
    q = _query(15, X, n=19)
    assert _md5(load_compiled(str(tmp_path / "art"), device="cpu")
                .predict(q)) == _md5(bst.predict(q))


def test_cli_convert_model_torch_export(tmp_path):
    """task=convert_model convert_model_language=torch_export: train by
    the CLI, convert with the same data and params, score the artifact
    bitwise Booster.predict; without data= it is fatal, and stablehlo is
    fatal naming torch_export."""
    rng = np.random.RandomState(16)
    X = rng.normal(size=(400, 5))
    y = X[:, 0] * 2 + 0.1 * rng.normal(size=400)
    train = tmp_path / "train.tsv"
    np.savetxt(train, np.column_stack([y, X]), delimiter="\t", fmt="%.10g")
    model = tmp_path / "model.txt"
    common = ["num_leaves=8", "verbosity=-1", "min_data_in_leaf=5",
              "device_type=cpu"]
    assert tcli.main(["task=train", f"data={train}", "objective=regression",
                      "num_iterations=5", f"output_model={model}"]
                     + common) == 0
    art = tmp_path / "exported"
    assert tcli.main(["task=convert_model", f"input_model={model}",
                      "convert_model_language=torch_export",
                      f"data={train}", f"convert_model={art}",
                      "serve_max_batch=16"] + common) == 0
    booster = lt.Booster(params=CPU, model_file=str(model))
    cm = load_compiled(str(art), device="cpu")
    Xq = rng.normal(size=(21, 5))
    assert _md5(cm.predict(Xq)) == _md5(booster.predict(Xq))
    with pytest.raises(FatalError, match="requires data="):
        tcli.main(["task=convert_model", f"input_model={model}",
                   "convert_model_language=torch_export"] + common)
