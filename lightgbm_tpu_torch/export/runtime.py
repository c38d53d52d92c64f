"""Standalone loader of the port's exported model artifacts.

Counterpart of lightgbm_tpu/export/runtime.py. An artifact directory
(written by ``export/compile.py``) is a frozen, self-describing serving
unit:

 * ``manifest.json``       format tag, model metadata (K, T, feature count,
   bucket ladder, output transform) and a sha256 per payload file, written
   LAST so a partially written directory never validates;
 * ``bin_table.npz``       the frozen BinMapper bin-edge tables (numeric
   upper bounds, categorical key / value maps) and the f64 leaf values;
 * ``bucket_<b>.pt2``      one ``torch.export`` program per padded batch
   bucket (``torch.export.save``): uint8 bins ``[b, F]`` in, ``([K, b]``
   f32 margins, ``[b, T]`` int64 leaf indices``)`` out, the forest folded
   in as constants and the walk unrolled to the model's depth;
 * ``bin_score_<b>.pt2``   the same from raw f32 rows ``[b, F]``: the bin
   table's plain torch bucketize (no custom kernel, so a box without the
   port's compiled kernels runs it) before the walk. Present when the
   mappers pack into a serve-mode bin table (``bin_and_score``), with
 * ``serve_table.npz``     that serve-mode table (``ops/bucketize.py``
   ``DeviceBinTable``), which the bucketize kernel (#6) bins from.

Raw f32 rows take one of three routes (``CompiledModel.raw_route``):
``kernel`` when a ``binner`` is attached (the port's
``lightgbm_tpu_torch.export.load_compiled`` attaches #6 on a CUDA device:
the kernel bins, then ``bucket_<b>`` scores, the compiled engine's
route); ``program`` (``bin_score_<b>``) on the CPU; ``host`` otherwise,
the numpy ``BinTable`` of f64 rows, so a card never runs the plain
bucketize. All three give the same bins.

The port writes no StableHLO: its format tag is its own, and a JAX
artifact (``lightgbm-tpu-stablehlo-v1``) is refused by name.

This module is STANDALONE: it imports only numpy, json, hashlib and os,
and torch lazily to execute, never the port's ``models``, ``engine`` or
``basic``. A serving box loads it by file path::

    spec = importlib.util.spec_from_file_location(
        "export_runtime", ".../lightgbm_tpu_torch/export/runtime.py")
    runtime = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runtime)
    model = runtime.CompiledModel.load("artifact_dir/", device="cuda")
    preds = model.predict(rows)

(tests/test_torch_export.py checks that the training stack stays out of
``sys.modules``). The programs run on the device the caller names,
``cuda`` unless the caller asks for the CPU.

Parity: ``predict`` / ``score_margin`` accumulate the programs' leaf
INDICES against the artifact's f64 leaf table with the host walk's numpy
reshape-sum, bitwise ``Booster.predict``'s host walk;
``score_margin_f32`` returns the programs' own f32 margins, bitwise
``ServingSession(engine="binned")`` and ``engine="compiled"``.
"""

import hashlib
import json
import os

import numpy as np

FORMAT = "lightgbm-tpu-torch-export-v1"
JAX_FORMAT = "lightgbm-tpu-stablehlo-v1"
MANIFEST = "manifest.json"
BIN_TABLE = "bin_table.npz"
SERVE_TABLE = "serve_table.npz"

# MissingType (models/tree.py; reference include/LightGBM/meta.h)
_MISSING_NONE, _MISSING_ZERO, _MISSING_NAN = 0, 1, 2


def bucket_for(n, min_bucket, max_bucket):
    """Smallest power-of-two >= n, clamped (serving/session.py twin)."""
    b = 1 << max(int(n) - 1, 0).bit_length()
    return max(min_bucket, min(b, max_bucket))


def file_sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def program_file(kind, bucket):
    """The file of one bucket's program: kind "bucket" (uint8 bins in) or
    "bin_score" (raw f32 rows in)."""
    return f"{kind}_{bucket}.pt2"


def load_program(f, device):
    """A ``torch.export.save``d program (a path or a file object) as a
    callable module on `device`. Example inputs and constants fix a
    program's device when it is exported, so the program is moved: by
    ``torch.export.passes.move_to_device_pass`` where this torch has it,
    else by moving the unlifted module's buffers."""
    import torch
    dev = torch.device(device)
    ep = torch.export.load(f)
    try:
        from torch.export.passes import move_to_device_pass
    except ImportError:
        return ep.module().to(dev)
    return move_to_device_pass(ep, dev).module()


# ----------------------------------------------------------------------
# Vendored bin assignment: copies of data/binning.py numeric_value_to_bin
# and categorical_to_bin_sentinel (this module must stay import-standalone,
# so it cannot import them; tests/test_torch_export.py holds the artifact's
# bins to the binned engine's).
# ----------------------------------------------------------------------
def _numeric_value_to_bin(values, bin_upper_bound, missing_type):
    """Numeric raw f64 values -> bin ids against inclusive upper bounds
    (reference: BinMapper::ValueToBin, bin.h:613-651). ``num_bin`` ==
    ``len(bin_upper_bound)``; under MISSING_NAN the last bound is the NaN
    sentinel and NaN rows take bin ``num_bin - 1``, otherwise NaN
    collapses to the bin of 0.0."""
    values = np.asarray(values, np.float64)
    nan_mask = np.isnan(values)
    num_bin = len(bin_upper_bound)
    v = np.where(nan_mask, 0.0, values)
    if missing_type == _MISSING_NAN:
        bins = np.searchsorted(bin_upper_bound[:-1], v, side="left")
        bins = np.minimum(bins, num_bin - 2)
        bins = np.where(nan_mask, num_bin - 1, bins)
    else:
        bins = np.searchsorted(bin_upper_bound, v, side="left")
        bins = np.minimum(bins, num_bin - 1)
    return bins.astype(np.int32)


def _categorical_to_bin_sentinel(values, keys, vals, num_bin):
    """Serving-side categorical raw f64 values -> bin ids with sentinel
    semantics: NaN / negative / unseen categories map to ``num_bin``.
    ``keys`` must be sorted int64; ``vals`` the matching bin ids."""
    col = np.asarray(values, np.float64)
    nanm = np.isnan(col)
    valid = ~nanm & (col >= 0)
    iv = np.where(valid, col, 0).astype(np.int64)
    pos = np.clip(np.searchsorted(keys, iv), 0, len(keys) - 1)
    hit = valid & (keys[pos] == iv)
    return np.where(hit, vals[pos], num_bin).astype(np.int64)


class BinTable:
    """Frozen per-feature binning tables: raw f64 rows -> uint8 bin
    indices, replicating ``BinnedModel.bin_rows`` without importing it."""

    def __init__(self, npz) -> None:
        self.num_features = int(npz["num_features"])
        self.numeric = {}            # feat -> (upper_bounds, missing_type)
        for i, f in enumerate(npz["num_feats"].tolist()):
            a, b = int(npz["num_offsets"][i]), int(npz["num_offsets"][i + 1])
            self.numeric[int(f)] = (npz["num_bounds"][a:b],
                                    int(npz["num_missing"][i]))
        self.categorical = {}        # feat -> (keys, vals, num_bin)
        for i, f in enumerate(npz["cat_feats"].tolist()):
            a, b = int(npz["cat_offsets"][i]), int(npz["cat_offsets"][i + 1])
            self.categorical[int(f)] = (npz["cat_keys"][a:b],
                                        npz["cat_vals"][a:b],
                                        int(npz["cat_num_bin"][i]))

    def bin_rows(self, X):
        """[n, F] raw f64 -> [n, F] uint8 bins (split-used features only;
        unused columns stay 0, as in the in-process binned engine)."""
        n = X.shape[0]
        out = np.zeros((n, self.num_features), np.uint8)
        for f, (ub, missing_type) in self.numeric.items():
            out[:, f] = _numeric_value_to_bin(
                X[:, f], ub, missing_type).astype(np.uint8)
        for f, (keys, vals, num_bin) in self.categorical.items():
            out[:, f] = _categorical_to_bin_sentinel(
                X[:, f], np.asarray(keys, np.int64),
                np.asarray(vals, np.int64), num_bin).astype(np.uint8)
        return out


class CompiledModel:
    """A loaded artifact: scores from the exported programs with no Python
    model layer at all."""

    def __init__(self, path, manifest, bin_table, leaf_value,
                 device="cuda", binner=None) -> None:
        self.path = path
        self.manifest = manifest
        self.bins = bin_table
        self.leaf_value = leaf_value                   # [L] f64
        self.device = device
        self.K = int(manifest["K"])
        self.T = int(manifest["T"])
        self.num_features = int(manifest["num_features"])
        self.avg_div = int(manifest["avg_div"])
        self.transform = manifest["transform"]
        self.sigmoid = float(manifest["sigmoid"])
        self.buckets = [int(b) for b in manifest["buckets"]]
        self.min_bucket = int(manifest["min_bucket"])
        self.max_batch = int(manifest["max_batch"])
        self.bin_and_score = bool(manifest.get("bin_and_score", False))
        # raw f32 [b, F] tensor on `device` -> [b, F] uint8 bins
        self.binner = binner
        self._fns = {}                         # (kind, bucket) -> module

    # ------------------------------------------------------------------
    @classmethod
    def load(cls, path, verify=True, device="cuda", binner=None):
        """Load an artifact directory onto `device`, verifying the sha256
        manifest (a tampered or truncated payload fails loudly, not with
        wrong scores). `binner` bins raw f32 rows on `device` (the
        ``kernel`` route)."""
        mpath = os.path.join(path, MANIFEST)
        with open(mpath) as f:
            manifest = json.load(f)
        fmt = manifest.get("format")
        if fmt == JAX_FORMAT:
            raise ValueError(
                f"{mpath}: {JAX_FORMAT!r} is a StableHLO artifact of the JAX "
                f"package (lightgbm_tpu.export); this loader reads "
                f"{FORMAT!r} (lightgbm_tpu_torch.export.export_model)")
        if fmt != FORMAT:
            raise ValueError(f"{mpath}: unknown artifact format {fmt!r} "
                             f"(expected {FORMAT!r})")
        if verify:
            for name, digest in manifest["files"].items():
                got = file_sha256(os.path.join(path, name))
                if got != digest:
                    raise ValueError(
                        f"artifact file {name!r} sha256 mismatch "
                        f"(manifest {digest[:12]}..., file {got[:12]}...)"
                        " — corrupt or tampered artifact")
        npz = np.load(os.path.join(path, BIN_TABLE))
        return cls(path, manifest, BinTable(npz),
                   np.asarray(npz["leaf_value"], np.float64), device, binner)

    def serve_table(self):
        """The serve-mode bin table's arrays (``table``, ``cat_val``,
        ``meta``, ``num_features``, ``B``) of a ``bin_and_score``
        artifact."""
        with np.load(os.path.join(self.path, SERVE_TABLE)) as npz:
            return {k: npz[k] for k in npz.files}

    @property
    def raw_route(self):
        """How raw f32 rows are binned: "kernel", "program" or "host"."""
        if not self.bin_and_score:
            return "host"
        if self.binner is not None:
            return "kernel"
        return "program" if str(self.device).startswith("cpu") else "host"

    # ------------------------------------------------------------------
    def _fn(self, kind, bucket):
        """The bucket's program on this model's device, loaded once."""
        key = (kind, bucket)
        fn = self._fns.get(key)
        if fn is None:
            fn = load_program(os.path.join(self.path,
                                           program_file(kind, bucket)),
                              self.device)
            self._fns[key] = fn
        return fn

    def _call(self, kind, Xp):
        import torch
        Xt = torch.from_numpy(Xp).to(self.device)
        if kind == "kernel":
            kind, Xt = "bucket", self.binner(Xt)
        m32, gl = self._fn(kind, Xp.shape[0])(Xt)
        return m32.cpu().numpy(), gl.cpu().numpy()

    def warmup(self):
        """Run every bucket once so no live request pays a load; returns
        the bucket ladder."""
        for b in self.buckets:
            self._call("bucket", np.zeros((b, self.num_features), np.uint8))
            if self.raw_route != "host":
                self._call("kernel" if self.raw_route == "kernel"
                           else "bin_score",
                           np.zeros((b, self.num_features), np.float32))
        return list(self.buckets)

    # ------------------------------------------------------------------
    def _run(self, X):
        """Chunk / bucket / pad as the serving session does; yields (c0,
        c1, margins_f32 [K, m], leaves [m, T]). f32 rows against a
        ``bin_and_score`` artifact ship raw and bin on the device by
        ``raw_route`` (the binner, or the ``bin_score`` program on the
        CPU); everything else bins on the host."""
        X = np.asarray(X)
        route = self.raw_route if X.dtype == np.float32 else "host"
        raw_f32 = route != "host"
        X = np.ascontiguousarray(X if raw_f32
                                 else np.asarray(X, np.float64))
        if X.ndim == 1:
            X = X.reshape(1, -1)
        n = X.shape[0]
        for c0 in range(0, n, self.max_batch):
            c1 = min(c0 + self.max_batch, n)
            m = c1 - c0
            b = bucket_for(m, self.min_bucket, self.max_batch)
            if raw_f32:
                Xp = np.zeros((b, self.num_features), np.float32)
                Xp[:m] = X[c0:c1, :self.num_features]
                m32, gl = self._call("kernel" if route == "kernel"
                                     else "bin_score", Xp)
            else:
                Xp = np.zeros((b, self.num_features), np.uint8)
                Xp[:m] = self.bins.bin_rows(X[c0:c1])
                m32, gl = self._call("bucket", Xp)
            yield c0, c1, m32[:, :m], gl[:m]

    def score_margin(self, X):
        """[K, n] f64 raw margins: the programs route (leaf indices), the
        f64 leaf table accumulates; bitwise
        ``Booster.predict(raw_score=True)``'s host walk."""
        X = np.asarray(X)
        n = X.shape[0] if X.ndim > 1 else 1
        out = np.empty((self.K, n), np.float64)
        for c0, c1, _m32, gl in self._run(X):
            lv = self.leaf_value[gl]                       # [m, T] f64
            out[:, c0:c1] = lv.reshape(
                c1 - c0, self.T // self.K, self.K).sum(axis=1).T
        if self.avg_div:
            out /= self.avg_div
        return out

    def score_margin_f32(self, X):
        """[K, n] f64-cast f32 margins straight from the programs; bitwise
        the ``engine="binned"`` / ``engine="compiled"`` sessions."""
        X = np.asarray(X)
        n = X.shape[0] if X.ndim > 1 else 1
        out = np.empty((self.K, n), np.float64)
        for c0, c1, m32, _gl in self._run(X):
            out[:, c0:c1] = m32.astype(np.float64)
        if self.avg_div:
            out /= self.avg_div
        return out

    def predict(self, X, raw_score=False):
        """Output shape and values match ``Booster.predict`` bitwise."""
        raw = self.score_margin(X)
        if not raw_score:
            raw = self._convert(raw)
        return raw[0] if raw.shape[0] == 1 else raw.T

    def _convert(self, raw):
        t = self.transform
        if t == "identity":
            return raw
        if t == "sigmoid":
            return 1.0 / (1.0 + np.exp(-self.sigmoid * raw))
        if t == "softmax":
            e = np.exp(raw - np.max(raw, axis=0, keepdims=True))
            return e / np.sum(e, axis=0, keepdims=True)
        if t == "exp":
            return np.exp(raw)
        if t == "log1p_exp":
            return np.log1p(np.exp(raw))
        raise ValueError(
            f"artifact objective transform {t!r} is not supported "
            f"standalone; score with raw_score=True")


def load_compiled(path, verify=True, device="cuda"):
    return CompiledModel.load(path, verify=verify, device=device)
