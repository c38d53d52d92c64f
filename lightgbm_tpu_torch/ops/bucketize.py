"""Device binning: raw f32 rows -> uint8 bin ids on the card.

Counterpart of lightgbm_tpu/ops/bucketize.py. A frozen ``BinMapper`` set
is packed into a padded bin table (``pack_bin_table``, the JAX package's
layout and rules), and the bucketize kernel (``csrc/bucketize.cu``) maps
raw f32 values to bins BIT-IDENTICALLY to the host path. It replaces the
Pallas kernel ``_bucketize_pallas`` on the two paths that run it: Dataset
ingest (train-mode table, feature-major ``X_t`` written directly) and the
raw-f32 route of the binned serving engine (serve-mode table, row-major
bins).

Bit-identity with the host f64 searchsorted comes from one invariant: for
an f32 value ``v`` and an f64 inclusive upper bound ``b``,

    v <= b   <=>   v <= floor32(b)

where ``floor32(b)`` is the largest f32 <= ``b``. So the f64
``searchsorted(bounds, v, side="left")`` equals the count of
``floor32(bounds) < v`` for every f32 ``v``, ±0, subnormals and ±inf
included. Categorical features compare ``trunc(v)`` against the mapper's
keys (refused at pack time unless f32-exact).

Two table modes mirror the two host semantics:

 * ``mode="train"``: ``BinMapper.value_to_bin``; categorical NaN /
   negative / unseen values land in bin 0 (the mapper's ``-1`` key);
 * ``mode="serve"``: ``BinnedModel.bin_rows``; categorical NaN / negative
   / unseen values land in the per-feature sentinel bin ``num_bin``, and
   only split-used features are binned (the others stay 0).

``pack_bin_table`` raises :class:`BinningUnavailable` for anything the
table cannot represent exactly (bin counts over the uint8 cap, categorical
keys that are not f32-exact). ``bucketize_rows`` sends a CUDA tensor to
the kernel and a CPU tensor to its plain version, ``bucketize_plain``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..models.tree import MISSING_NAN
from ..utils import round_up as _round_up
from . import histogram_cuda as hc

# meta row layout ([F, 8] f32, one row per feature)
_M_IS_CAT = 0     # 1.0 = categorical feature
_M_CLAMP = 1      # numeric: max bin id after the bound count
_M_NAN_BIN = 2    # numeric: bin id NaN rows take
_M_NAN_KEY = 3    # categorical: key substituted for NaN values
_M_MISS_BIN = 4   # categorical: bin id for unseen/invalid values
_M_NEG_INV = 5    # categorical: 1.0 = negative values are invalid (serve)
_META_COLS = 8

_LANES = 128              # bin-table lane quantum
_SUBLANES = 32            # feature-axis padding quantum

# largest integer magnitude where every int is f32-exact
_F32_EXACT_INT = 1 << 24

# csrc/bucketize.cu: rows per tile, shared tile pitch, and the shared
# memory one launch may take (the kernel opts in above 48 KB)
_TILE_PITCH = 132
_MAX_SMEM = 200 * 1024


class BinningUnavailable(ValueError):
    """The device bin table cannot represent this mapper set exactly (see
    message)."""


class DeviceBinTable(NamedTuple):
    """Packed host-side bin table (numpy).

    ``table``/``cat_val``/``meta`` are padded to ``[F_pad, B]`` /
    ``[F_pad, 8]`` with inert rows (all-+inf bounds, clamp 0), the JAX
    package's layout; ``num_features`` is the true feature count."""
    table: np.ndarray        # [F_pad, B] f32: floored bounds / cat keys
    cat_val: np.ndarray      # [F_pad, B] f32: cat bin values (0 numeric)
    meta: np.ndarray         # [F_pad, 8] f32 per-feature scalars
    num_features: int
    B: int
    mode: str                # "train" | "serve"


class BinTableTensors(NamedTuple):
    """A DeviceBinTable's first ``num_features`` rows as contiguous
    tensors on one device (``upload_bin_table``)."""
    table: torch.Tensor      # [F, B] f32
    cat_val: torch.Tensor    # [F, B] f32
    meta: torch.Tensor       # [F, 8] f32
    num_features: int
    B: int


def resolve_binning_impl(knob: str, device: torch.device) -> str:
    """Resolve the ``binning_impl`` knob to "host" or "device": "auto" is
    "device" when the data's device is CUDA and "host" on the CPU."""
    if knob in ("host", "device"):
        return knob
    if knob != "auto":
        raise ValueError(f"unknown binning_impl {knob!r}")
    return "device" if torch.device(device).type == "cuda" else "host"


# ----------------------------------------------------------------------
# packing
# ----------------------------------------------------------------------
def _floor_f32(bounds: np.ndarray) -> np.ndarray:
    """Largest f32 <= each f64 bound: f32 round-to-nearest, then step DOWN
    one ulp wherever rounding went up. ``v <= b  <=>  v <= floor32(b)``
    for every f32 ``v``."""
    b64 = np.asarray(bounds, np.float64)
    b32 = b64.astype(np.float32)
    went_up = b32.astype(np.float64) > b64
    stepped = np.nextafter(b32, np.float32(-np.inf))
    return np.where(went_up, stepped, b32).astype(np.float32)


def pack_bin_table(mappers: Sequence, *, mode: str = "train",
                   num_features: Optional[int] = None,
                   used_features: Optional[Sequence[int]] = None,
                   ) -> DeviceBinTable:
    """Pack a frozen BinMapper list into a :class:`DeviceBinTable`.

    ``mappers`` is indexed by storage column (ingest: the dataset's inner
    mapper order) or by original feature with ``None`` holes (serving:
    pass ``used_features``; unbinned columns pack as inert rows that
    always produce bin 0, exactly like the host path). Raises
    :class:`BinningUnavailable` when the table cannot reproduce the host
    path bit for bit."""
    from ..data.binning import BIN_TYPE_CATEGORICAL
    if mode not in ("train", "serve"):
        raise ValueError(f"unknown bin-table mode {mode!r}")
    F = int(num_features) if num_features is not None else len(mappers)
    used = set(int(f) for f in used_features) \
        if used_features is not None else None

    width = 1
    active: List = [None] * F
    for f in range(F):
        mp = mappers[f] if f < len(mappers) else None
        if mp is None or (used is not None and f not in used) \
                or getattr(mp, "is_trivial", False):
            continue
        if mp.bin_type == BIN_TYPE_CATEGORICAL:
            cap = 255 if mode == "serve" else 256
            if mp.num_bin > cap:
                raise BinningUnavailable(
                    f"feature {f}: {mp.num_bin} categorical bins exceed "
                    f"the uint8 {mode} cap ({cap})")
            keys = sorted(mp.categorical_2_bin)
            for k in keys:
                if abs(int(k)) > _F32_EXACT_INT \
                        or float(np.float32(k)) != float(k):
                    raise BinningUnavailable(
                        f"feature {f}: categorical key {k} is not "
                        f"f32-exact; device binning cannot match the "
                        f"host int64 compare")
            width = max(width, len(keys))
        else:
            if mp.num_bin > 256:
                raise BinningUnavailable(
                    f"feature {f}: {mp.num_bin} bins overflow uint8 "
                    f"storage")
            width = max(width, len(mp.bin_upper_bound))
        active[f] = mp

    B = max(_round_up(width, _LANES), _LANES)
    F_pad = max(_round_up(F, _SUBLANES), _SUBLANES)
    table = np.full((F_pad, B), np.inf, np.float32)
    cat_val = np.zeros((F_pad, B), np.float32)
    meta = np.zeros((F_pad, _META_COLS), np.float32)

    for f, mp in enumerate(active):
        if mp is None:
            continue                      # inert: count 0, clamp 0 -> bin 0
        if mp.bin_type == BIN_TYPE_CATEGORICAL:
            keys = sorted(mp.categorical_2_bin)
            vals = [mp.categorical_2_bin[k] for k in keys]
            table[f, :] = np.nan          # NaN pad: never equal to any vi
            table[f, :len(keys)] = np.asarray(keys, np.float32)
            cat_val[f, :len(vals)] = np.asarray(vals, np.float32)
            meta[f, _M_IS_CAT] = 1.0
            if mode == "serve":
                meta[f, _M_NAN_KEY] = -2.0        # matches no key
                meta[f, _M_MISS_BIN] = float(mp.num_bin)   # sentinel
                meta[f, _M_NEG_INV] = 1.0
            else:
                meta[f, _M_NAN_KEY] = -1.0        # the mapper's NaN key
                meta[f, _M_MISS_BIN] = 0.0
        else:
            ub = np.asarray(mp.bin_upper_bound, np.float64)
            if mp.missing_type == MISSING_NAN:
                bounds = ub[:-1]          # exclude the NaN sentinel bound
                meta[f, _M_CLAMP] = float(mp.num_bin - 2)
                meta[f, _M_NAN_BIN] = float(mp.num_bin - 1)
            else:
                bounds = ub
                meta[f, _M_CLAMP] = float(mp.num_bin - 1)
                # NaN takes the bin of 0.0 (the host where(nan, 0.0, v))
                meta[f, _M_NAN_BIN] = float(
                    mp.value_to_bin(np.array([np.nan]))[0])
            table[f, :len(bounds)] = _floor_f32(bounds)
    return DeviceBinTable(table=table, cat_val=cat_val, meta=meta,
                          num_features=F, B=B, mode=mode)


def upload_bin_table(t: DeviceBinTable,
                     device: torch.device) -> BinTableTensors:
    """The table's ``num_features`` real rows on `device`."""
    F = t.num_features

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a[:F])).to(device)
    return BinTableTensors(table=up(t.table), cat_val=up(t.cat_val),
                           meta=up(t.meta), num_features=F, B=t.B)


# ----------------------------------------------------------------------
# the kernel and its plain version
# ----------------------------------------------------------------------
def _smem_bytes(F: int, B: int) -> int:
    """Shared memory of one kernel launch over F features (the sum in
    csrc/bucketize.cu bucketize_smem)."""
    return F * (B + 1) * 8 + F * _META_COLS * 4 + F * 4 + F * _TILE_PITCH


def _check_args(X, t: BinTableTensors, out, cols):
    F = t.num_features
    if X.dim() != 2 or X.dtype != torch.float32:
        raise ValueError("X must be a [n, >=F] float32 tensor (got "
                         f"{X.dtype} {tuple(X.shape)})")
    n = X.shape[0]
    if cols is None and X.shape[1] < F:
        raise ValueError(f"X has {X.shape[1]} columns, the table {F}")
    if cols is not None and (cols.dtype != torch.int32
                             or tuple(cols.shape) != (F,)):
        raise ValueError(f"cols must be [{F}] int32")
    if out is not None and (out.dtype != torch.uint8
                            or tuple(out.shape) != (n, F)):
        raise ValueError(f"out must be a [{n}, {F}] uint8 view, got "
                         f"{out.dtype} {tuple(out.shape)}")
    return n, F


def bucketize_cuda(X: torch.Tensor, t: BinTableTensors,
                   out: Optional[torch.Tensor] = None,
                   cols: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[n, F] uint8 bins of X [n, >=F] f32 (rows may be strided, columns
    unit-stride) through the kernel. ``cols`` [F] int32 names the column
    of X each table row reads (default: the first F). ``out`` may be any
    [n, F] uint8 view (e.g. ``X_t[:, c0:c1].t()`` of a feature-major
    matrix): the kernel writes through its two strides. One launch per
    feature group that fits the kernel's shared memory."""
    dev = hc._cuda_device(X)
    n, F = _check_args(X, t, out, cols)
    if X.shape[1] > 1 and X.stride(1) != 1:
        raise ValueError("X must have unit column stride")
    for name, a in (("table", t.table), ("cat_val", t.cat_val),
                    ("meta", t.meta)):
        hc._check(a, name, (torch.float32,), tuple(a.shape), dev)
    if cols is not None:
        hc._check(cols, "cols", (torch.int32,), (F,), dev)
    if out is None:
        out = torch.empty((n, F), dtype=torch.uint8, device=dev)
    elif out.device != dev:
        raise ValueError(f"out is on {out.device}, expected {dev}")
    per = max(1, min(F, _MAX_SMEM // _smem_bytes(1, t.B)))
    if _smem_bytes(1, t.B) > _MAX_SMEM:
        raise ValueError(f"a {t.B}-lane bin table does not fit the "
                         "kernel's shared memory")
    sms, stream = hc._launch_env(dev)
    fn = hc._lib("bucketize")
    esz_t, esz_m = t.table.stride(0), t.meta.stride(0)
    s_row, s_feat = out.stride()
    for f0 in range(0, F, per):
        g = min(per, F - f0)
        rc = fn(X.data_ptr(), n, X.stride(0),
                cols.data_ptr() + 4 * f0 if cols is not None else None, g,
                t.table.data_ptr() + 4 * f0 * esz_t,
                t.cat_val.data_ptr() + 4 * f0 * esz_t,
                t.meta.data_ptr() + 4 * f0 * esz_m, t.B,
                out.data_ptr() + f0 * s_feat, s_row, s_feat, sms, stream)
        hc._raise_on(rc, "bucketize")
        hc.LAUNCHES["bucketize"] += 1
    return out


def bucketize_plain(X: torch.Tensor, t: BinTableTensors,
                    out: Optional[torch.Tensor] = None,
                    cols: Optional[torch.Tensor] = None,
                    chunk: int = 8192) -> torch.Tensor:
    """Plain PyTorch version of bucketize_cuda: the _bin_block predicate
    form of the JAX package, a count of floored bounds below each value
    and a key-equality probe over every table lane, in row chunks."""
    n, F = _check_args(X, t, out, cols)
    Xs = X[:, :F] if cols is None else X[:, cols.to(torch.int64)]
    if out is None:
        out = torch.empty((n, F), dtype=torch.uint8, device=X.device)
    m = t.meta
    is_cat = m[:, _M_IS_CAT] > 0
    clamp, nan_bin = m[:, _M_CLAMP], m[:, _M_NAN_BIN]
    nan_key, miss_bin = m[:, _M_NAN_KEY], m[:, _M_MISS_BIN]
    neg_inv = m[:, _M_NEG_INV] > 0
    for c0 in range(0, n, chunk):
        x = Xs[c0:c0 + chunk]                                  # [r, F]
        nanm = torch.isnan(x)
        cnt = (t.table[None] < x[:, :, None]).sum(-1).to(torch.float32)
        num_out = torch.where(nanm, nan_bin, torch.minimum(cnt, clamp))
        vi = torch.where(nanm, nan_key.expand_as(x), torch.trunc(x))
        vi = torch.where((x < 0) & neg_inv, torch.full_like(x, -2.0), vi)
        eq = t.table[None] == vi[:, :, None]                   # [r, F, B]
        catv = torch.where(eq, t.cat_val[None], 0.0).sum(-1)
        cat_out = torch.where(eq.any(-1), catv, miss_bin)
        out[c0:c0 + chunk] = torch.where(is_cat, cat_out,
                                         num_out).to(torch.uint8)
    return out


def bucketize_rows(X: torch.Tensor, t: BinTableTensors,
                   out: Optional[torch.Tensor] = None,
                   cols: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[n, F] uint8 bins of raw f32 rows, bit-identical to the host path
    the table was packed from: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if X.device.type == "cuda":
        return bucketize_cuda(X, t, out, cols)
    return bucketize_plain(X, t, out, cols)


# ----------------------------------------------------------------------
# ingest: chunked upload of a host matrix
# ----------------------------------------------------------------------
def bin_rows_device(X: np.ndarray, t: DeviceBinTable, device: torch.device,
                    cols: Optional[Sequence[int]] = None,
                    chunk: int = 1 << 18) -> torch.Tensor:
    """Bin a host f32 matrix on `device` into the feature-major [F, n]
    uint8 matrix training consumes. Row chunks of X are uploaded one at a
    time (the device never holds a second full f32 copy), and the kernel
    writes each chunk's bins straight into its columns of the result.
    ``cols`` selects X's column for each table row (the dataset's
    ``real_feature_index``) without a host copy of the selection."""
    n = X.shape[0]
    F = t.num_features
    tt = upload_bin_table(t, device)
    ci = None if cols is None else torch.as_tensor(
        np.asarray(cols, np.int32)).to(device)
    X_t = torch.empty((F, n), dtype=torch.uint8, device=device)
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        xc = torch.from_numpy(np.ascontiguousarray(X[c0:c1], np.float32))
        bucketize_rows(xc.to(device), tt, out=X_t[:, c0:c1].t(), cols=ci)
    return X_t
