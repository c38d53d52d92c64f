"""Text-file input in the port against the JAX package on the CPU: the
loader (`load_text_file`: format detection, `name:` column specs, label /
weight / group / ignore columns, the missing tokens, prefix-permissive
floats, LibSVM with `qid:` groups), the native parser against the Python
fallback in both packages, `Dataset(path)` against the JAX package's
(mappers' `to_dict()` and bins bitwise), and the native value->bin against
the NumPy path. Every comparison is exact."""

import json

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu.native as jnative
from lightgbm_tpu.data import loader as jloader
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import native as tnative
from lightgbm_tpu_torch.data import loader as tloader
from lightgbm_tpu_torch.data.binning import BinMapper, numeric_value_to_bin
from lightgbm_tpu_torch.models.tree import MISSING_NAN, MISSING_ZERO

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

TORCH = {"device_type": "cpu", "binning_impl": "host", "verbose": -1}


def _matrix(n=400, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 6))
    X[rng.rand(n) < 0.1, 2] = np.nan
    X[:, 4] = rng.randint(0, 5, n)
    y = (X[:, 0] - X[:, 1] + rng.normal(scale=0.5, size=n) > 0).astype(float)
    return X, y


def _fmt(v):
    return "" if np.isnan(v) else f"{v:.9g}"


def _write_delimited(path, rows, sep, header=None):
    lines = [sep.join(header)] if header else []
    lines += [sep.join(_fmt(v) for v in r) for r in rows]
    path.write_text("\n".join(lines) + "\n")


def _files(tmp_path):
    """name -> (path, load_text_file keyword arguments)."""
    X, y = _matrix()
    rng = np.random.RandomState(1)
    w = rng.uniform(0.5, 2.0, len(y))
    q = np.repeat(np.arange(40), 10)
    out = {}
    p = tmp_path / "plain.csv"
    _write_delimited(p, np.column_stack([y, X]), ",")
    out["csv"] = (p, {})
    # a header, the label by name, weight and group columns and an ignored
    # one, tab separated
    names = ["w", "qid", "lab", "junk"] + [f"f{i}" for i in range(6)]
    p = tmp_path / "named.tsv"
    _write_delimited(p, np.column_stack([w, q, y, rng.normal(size=len(y)),
                                         X]), "\t", header=names)
    out["tsv_named"] = (p, dict(has_header=True, label_column="name:lab",
                                weight_column="name:w",
                                group_column="name:qid",
                                ignore_column="name:junk"))
    # the missing tokens, a prefix-permissive float, blank lines, CRLF
    p = tmp_path / "tokens.csv"
    p.write_bytes(b"1,1.5x,na,2\r\n\n0,NaN,?,3e2\n  \n1,null,NULL,-0.25\n"
                  b"0,NA,nan,\n1,,7 ,abc\n")
    out["tokens"] = (p, {})
    # LibSVM with qid: groups
    p = tmp_path / "rank.svm"
    p.write_text("".join(
        f"{int(y[i])} qid:{q[i]} " + " ".join(
            f"{j}:{X[i, j]:.9g}" for j in range(6)
            if not np.isnan(X[i, j]) and X[i, j] > -0.5) + "\n"
        for i in range(len(y))))
    out["libsvm"] = (p, {})
    return out


def _assert_same(a, b):
    assert len(a) == len(b) == 5
    for x, z in zip(a[:4], b[:4]):
        if x is None or z is None:
            assert x is None and z is None
        else:
            assert x.dtype == z.dtype
            np.testing.assert_array_equal(x, z)
    assert list(a[4]) == list(b[4])


@pytest.mark.parametrize("name", ["csv", "tsv_named", "tokens", "libsvm"])
def test_load_text_file_bitwise_jax(tmp_path, name):
    path, kw = _files(tmp_path)[name]
    got = tloader.load_text_file(str(path), **kw)
    _assert_same(got, jloader.load_text_file(str(path), **kw))
    if name == "tokens":
        assert got[0][0, 0] == 1.5 and np.isnan(got[0][0, 1])
        assert np.isnan(got[0][4, 2]) and got[0][4, 1] == 7.0
    if name in ("tsv_named", "libsvm"):
        assert list(got[3]) == [10] * 40
    if name != "libsvm":
        assert tnative.LAST_PARSER == "native"


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_native_parser_bitwise_python_fallback(tmp_path, monkeypatch, pkg):
    """Each package's native parser gives its Python loop's arrays."""
    files = _files(tmp_path)
    mod = tloader if pkg == "torch" else jloader
    native = {n: mod.load_text_file(str(p), **kw)
              for n, (p, kw) in files.items() if n != "libsvm"}
    if pkg == "torch":
        monkeypatch.setenv("LIGHTGBM_TPU_DISABLE_NATIVE", "1")
    else:
        monkeypatch.setattr(jnative, "parse_text", lambda data, sep: None)
    for n, want in native.items():
        p, kw = files[n]
        _assert_same(mod.load_text_file(str(p), **kw), want)
    if pkg == "torch":
        assert tnative.LAST_PARSER == "python" and tnative.get_lib() is None


def test_dataset_from_path_matches_jax(tmp_path):
    """Dataset(path): the header's names, the column params, a valid file
    binned against the training file with reference=; mappers and bins
    equal to the JAX package's, and a model trained from the file equals
    one trained from the same arrays."""
    files = _files(tmp_path)
    path, _ = files["tsv_named"]
    params = dict(header=True, label_column="name:lab",
                  weight_column="name:w", group_column="name:qid",
                  ignore_column="name:junk", max_bin=31, two_round=True)
    dt = lt.Dataset(str(path), params={**params, **TORCH}).construct()
    dj = lj.Dataset(str(path), params=params).construct()
    ht, hj = dt._handle, dj._handle
    # through JSON: a NaN bound never equals itself in a list
    assert json.dumps([m.to_dict() for m in ht.mappers]) == \
        json.dumps([m.to_dict() for m in hj.mappers])
    np.testing.assert_array_equal(ht.X_binned, hj.X_binned)
    np.testing.assert_array_equal(ht.X_t.numpy(), hj.X_binned.T)
    assert ht.feature_names == hj.feature_names == [f"f{i}"
                                                    for i in range(6)]
    np.testing.assert_array_equal(ht.metadata.weight, hj.metadata.weight)
    np.testing.assert_array_equal(ht.metadata.query_boundaries,
                                  hj.metadata.query_boundaries)
    # a valid file with reference=
    vpath, _ = files["csv"]
    vt = lt.Dataset(str(vpath), reference=lt.Dataset(
        str(files["csv"][0]), params=TORCH), params=TORCH).construct()
    vj = lj.Dataset(str(vpath), reference=lj.Dataset(
        str(files["csv"][0]))).construct()
    np.testing.assert_array_equal(vt._handle.X_binned, vj._handle.X_binned)
    assert vt._handle.reference is not None
    # the file trains the model its arrays train
    X, y, w, g, names = tloader.load_text_file(str(vpath))
    p = {**TORCH, "objective": "binary", "num_leaves": 7}
    a = lt.train(p, lt.Dataset(str(vpath), params=p), 3)
    b = lt.train(p, lt.Dataset(X, label=y, feature_name=names), 3)
    assert a.model_to_string() == b.model_to_string()


@pytest.mark.parametrize("missing", [MISSING_NAN, MISSING_ZERO])
def test_native_value_to_bin_bitwise_numpy(monkeypatch, missing):
    """At 65536 values the mapper takes the native loop: NaN, +-0, +-inf,
    every bound and its neighbours, bitwise the NumPy path (and the JAX
    package's mapper on the same values)."""
    rng = np.random.RandomState(2)
    ub = np.unique(np.round(rng.normal(size=40), 3))
    ub = np.append(ub, [np.inf] if missing != MISSING_NAN
                   else [np.inf, np.nan])
    fin = ub[np.isfinite(ub)]
    special = np.concatenate([fin, np.nextafter(fin, -np.inf),
                              np.nextafter(fin, np.inf),
                              [np.nan, 0.0, -0.0, np.inf, -np.inf, 1e-300]])
    vals = np.concatenate([special, rng.normal(size=65536)])
    vals[rng.rand(len(vals)) < 0.05] = np.nan
    m = BinMapper()
    m.bin_upper_bound = ub
    m.num_bin = len(ub)
    m.missing_type = missing
    assert tnative.get_lib() is not None
    got = m.value_to_bin(vals)
    want = numeric_value_to_bin(vals, ub, missing)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    monkeypatch.setenv("LIGHTGBM_TPU_DISABLE_NATIVE", "1")
    np.testing.assert_array_equal(m.value_to_bin(vals), want)
    from lightgbm_tpu.data.binning import BinMapper as JBinMapper
    jm = JBinMapper()
    jm.bin_upper_bound, jm.num_bin, jm.missing_type = ub, len(ub), missing
    np.testing.assert_array_equal(jm.value_to_bin(vals), want)
