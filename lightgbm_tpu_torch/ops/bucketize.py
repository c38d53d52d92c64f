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

The fleet's fused drain bins a mixed-tenant batch in one launch:
``stack_bin_tables`` stacks the tenants' serve tables (the JAX package's
layout), and ``bucketize_rows_stacked`` bins each row against its own
tenant's rows of it, through ``csrc/bucketize_stacked.cu`` on the card
(the JAX function is XLA) or ``bucketize_stacked_plain`` on the CPU,
bitwise each tenant's own bins.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

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
_M_DEPTH = 6      # device copy only: probes of a key's in-bucket search
_M_COUNT = 7      # device copy only: searchable lanes of the row
_META_COLS = 8

_LANES = 128              # bin-table lane quantum
_SUBLANES = 32            # feature-axis padding quantum

# largest integer magnitude where every int is f32-exact
_F32_EXACT_INT = 1 << 24

# csrc/bucketize.cu: rows per tile, the most features of a block (a lane
# each), the value and bin tile pitches, and the shared memory of an SM
_TILE_ROWS = 128
_GROUP_MAX = 32
_X_PITCH = _TILE_ROWS + 1
_OUT_PITCH = _TILE_ROWS + 4
_SM_SMEM = 228 * 1024
_BLOCK_RESERVED = 1024     # shared memory CUDA reserves per resident block
_MAX_BLOCKS_PER_SM = 8     # 2048 threads of 256


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
    tensors on one device (``upload_bin_table``); the meta rows carry
    each row's search depth and searchable lanes, and ``grids`` the
    kernel's bucket grid of each row (``search_grids``)."""
    table: torch.Tensor      # [F, B] f32
    cat_val: torch.Tensor    # [F, B] f32
    meta: torch.Tensor       # [F, 8] f32
    num_features: int
    B: int
    grids: torch.Tensor      # [F, 2 + NB] int32


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


def search_counts(table: np.ndarray) -> np.ndarray:
    """[F] int: the lanes that lead each table row before its +inf
    (numeric) or NaN (categorical) pads, which no key's search passes."""
    stop = ~(np.asarray(table, np.float32) < np.inf)
    count = np.where(stop.any(axis=1), stop.argmax(axis=1), stop.shape[1])
    return count.astype(np.int64)


def grid_buckets(x: np.ndarray, lo: np.float32, scale: np.float32,
                 nb: int) -> np.ndarray:
    """The kernel's bucket of each f32 x: clamp(floor((x - lo) * scale),
    0, nb - 1) in f32 with round-to-nearest, NaN to bucket 0 (fmax/fmin
    skip a NaN, as CUDA's fmaxf/fminf do). Monotone in x."""
    x = np.asarray(x, np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        t = np.floor((x - np.float32(lo)) * np.float32(scale))
        t = np.fmin(np.fmax(t, np.float32(0)), np.float32(nb - 1))
    return t.astype(np.int64)


def search_grids(table: np.ndarray, count: np.ndarray,
                 nb: int) -> Tuple[np.ndarray, np.ndarray]:
    """(grids [F, 2 + nb] int32, depth [F]) of the kernel's search: each
    row's lo and scale (f32 bits; scale nb / (last - first bound), 0 when
    the bounds span no finite range: one bucket), then per bucket its
    bounds [first, end) packed first | end << 16; depth = ceil(log2(the
    largest bucket's bounds + 1)), the probes a key's search takes."""
    table = np.asarray(table, np.float32)
    F = table.shape[0]
    grids = np.zeros((F, 2 + nb), np.int32)
    depth = np.zeros(F, np.int64)
    for f in range(F):
        c = int(count[f])
        t = table[f, :c]
        lo = scale = np.float32(0)
        if c >= 2 and np.isfinite(t[0]) and np.isfinite(t[-1]) \
                and t[-1] > t[0]:
            with np.errstate(over="ignore"):
                sc = np.float32(nb) / (t[-1] - t[0])
            if np.isfinite(sc) and sc > 0:
                lo, scale = t[0], sc
        first = np.searchsorted(grid_buckets(t, lo, scale, nb),
                                np.arange(nb + 1), side="left")
        grids[f, 0] = np.float32(lo).view(np.int32)
        grids[f, 1] = np.float32(scale).view(np.int32)
        grids[f, 2:] = first[:-1] | (first[1:] << 16)
        depth[f] = int(np.diff(first).max(initial=0)).bit_length()
    return grids, depth


def upload_bin_table(t: DeviceBinTable,
                     device: torch.device) -> BinTableTensors:
    """The table's ``num_features`` real rows on `device`, with the
    kernel's search grids (``search_grids``, B buckets a row) and, in meta
    columns 6 and 7, each row's search depth and searchable lanes."""
    F = t.num_features
    meta = np.array(t.meta[:F], np.float32)
    count = search_counts(t.table[:F])
    grids, depth = search_grids(t.table[:F], count, t.B)
    meta[:, _M_DEPTH], meta[:, _M_COUNT] = depth, count

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a[:F])).to(device)
    return BinTableTensors(table=up(t.table), cat_val=up(t.cat_val),
                           meta=up(meta), num_features=F, B=t.B,
                           grids=up(grids))


# ----------------------------------------------------------------------
# the kernel and its plain version
# ----------------------------------------------------------------------
def _smem_bytes(Fg: int, B: int, NB: int) -> int:
    """Shared memory of a block over Fg features of a B-lane table with
    grids of NB buckets (the sum in csrc/bucketize.cu bk_smem): the table
    rows, the grids, the value tile, the meta rows, the cat_val bytes and
    the bin tile."""
    return Fg * (4 * B + 4 * (2 + NB) + 4 * _X_PITCH + 4 * _META_COLS + B
                 + _OUT_PITCH)


class BucketizePlan(NamedTuple):
    """One launch of the bucketize kernel: `groups` feature groups of
    `group` features (the last may be short), `grid` blocks (a multiple of
    `groups`: each group walks the row tiles over grid / groups blocks),
    `smem` bytes of shared memory per block."""
    group: int
    groups: int
    grid: int
    smem: int


def plan_bucketize(n: int, F: int, B: int, NB: int,
                   sms: int) -> BucketizePlan:
    """The launch of n rows x F features over a B-lane table with grids of
    NB buckets on `sms` SMs. Features split into groups of at most 32 (a
    lane each) whose tables let four blocks share an SM; when there are
    fewer (group, tile) items than two per SM, as for a served chunk, the
    groups narrow (to 4 features at the least) so that the chunk spreads
    over more blocks, each staging only its own rows. The blocks of a
    group are as many as fit on the card at once, at most one per row
    tile, so each resident block stages its rows once (the kernel's entry
    cuts the grid to the blocks its registers let fit)."""
    tiles = max(-(-n // _TILE_ROWS), 1)
    want = -(-F * tiles // (2 * sms))
    fit4 = (_SM_SMEM // 4 - _BLOCK_RESERVED) // _smem_bytes(1, B, NB)
    cap = min(_GROUP_MAX, max(4, want), max(fit4, 1))
    groups = -(-F // cap)
    group = -(-F // groups)
    smem = _smem_bytes(group, B, NB)
    per_sm = min(_MAX_BLOCKS_PER_SM, _SM_SMEM // (smem + _BLOCK_RESERVED))
    if per_sm < 1:
        raise ValueError(f"a {B}-lane bin table does not fit the kernel's "
                         "shared memory")
    per_group = min(tiles, max(1, per_sm * sms // groups))
    return BucketizePlan(group, groups, groups * per_group, smem)


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
    matrix): the kernel writes through its two strides. One launch
    (``plan_bucketize``); ``t`` must come from ``upload_bin_table``."""
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
    if t.B % _LANES or t.B > 2 * _LANES:
        raise ValueError(f"the kernel takes 128 or 256 table lanes, not "
                         f"{t.B}")
    NB = t.grids.shape[1] - 2
    hc._check(t.grids, "grids", (torch.int32,), (F, NB + 2), dev)
    if t.table.data_ptr() % 16 or t.cat_val.data_ptr() % 16:
        raise ValueError("table and cat_val must be 16-byte aligned")
    if n == 0:
        return out
    sms, stream = hc._launch_env(dev)
    plan = plan_bucketize(n, F, t.B, NB, sms)
    s_row, s_feat = out.stride()
    vec4 = s_row == 1 and s_feat % 4 == 0 and out.data_ptr() % 4 == 0
    rc = hc._lib("bucketize")(
        X.data_ptr(), n, X.stride(0),
        cols.data_ptr() if cols is not None else None, F, plan.group,
        plan.groups, plan.grid, t.table.data_ptr(), t.grids.data_ptr(), NB,
        t.cat_val.data_ptr(), t.meta.data_ptr(), t.B, out.data_ptr(), s_row,
        s_feat, int(vec4), stream)
    hc._raise_on(rc, "bucketize")
    hc.LAUNCHES["bucketize"] += 1
    return out


def bin_block_plain(x: torch.Tensor, table: torch.Tensor,
                    cat_val: torch.Tensor, meta: torch.Tensor
                    ) -> torch.Tensor:
    """[r, F] uint8 bins of x [r, F] against table / cat_val [F, B] and meta
    [F, 8]: the _bin_block predicate form of the JAX package, a count of
    floored bounds below each value and a key-equality probe over every
    table lane. Plain tensor operations only (no device of its own), so the
    exported raw-f32 programs (export/compile.py) carry it as it is."""
    is_cat = meta[:, _M_IS_CAT] > 0
    clamp, nan_bin = meta[:, _M_CLAMP], meta[:, _M_NAN_BIN]
    nan_key, miss_bin = meta[:, _M_NAN_KEY], meta[:, _M_MISS_BIN]
    neg_inv = meta[:, _M_NEG_INV] > 0
    nanm = torch.isnan(x)
    cnt = (table[None] < x[:, :, None]).sum(-1).to(torch.float32)
    num_out = torch.where(nanm, nan_bin, torch.minimum(cnt, clamp))
    vi = torch.where(nanm, nan_key.expand_as(x), torch.trunc(x))
    vi = torch.where((x < 0) & neg_inv, torch.full_like(x, -2.0), vi)
    eq = table[None] == vi[:, :, None]                       # [r, F, B]
    catv = torch.where(eq, cat_val[None], 0.0).sum(-1)
    cat_out = torch.where(eq.any(-1), catv, miss_bin)
    return torch.where(is_cat, cat_out, num_out).to(torch.uint8)


def bucketize_plain(X: torch.Tensor, t: BinTableTensors,
                    out: Optional[torch.Tensor] = None,
                    cols: Optional[torch.Tensor] = None,
                    chunk: int = 8192) -> torch.Tensor:
    """Plain PyTorch version of bucketize_cuda: ``bin_block_plain`` in row
    chunks."""
    n, F = _check_args(X, t, out, cols)
    Xs = X[:, :F] if cols is None else X[:, cols.to(torch.int64)]
    if out is None:
        out = torch.empty((n, F), dtype=torch.uint8, device=X.device)
    for c0 in range(0, n, chunk):
        out[c0:c0 + chunk] = bin_block_plain(Xs[c0:c0 + chunk], t.table,
                                             t.cat_val, t.meta)
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
# the fleet's fused drain: many tenants' tables, one launch
# ----------------------------------------------------------------------
def stack_bin_tables(tables: Sequence[DeviceBinTable]) -> DeviceBinTable:
    """Stack per-tenant serve tables into one ``[C, F_pad, B]`` super table
    (the JAX package's stack_bin_tables): every table is re-padded to the
    common feature and lane width; tenant columns beyond a tenant's own
    feature count are inert (bin 0, matching the fused supertensor's
    zero-padded uint8 columns)."""
    F = max(t.num_features for t in tables)
    F_pad = max(t.table.shape[0] for t in tables)
    B = max(t.B for t in tables)
    tab = np.full((len(tables), F_pad, B), np.inf, np.float32)
    cv = np.zeros((len(tables), F_pad, B), np.float32)
    meta = np.zeros((len(tables), F_pad, _META_COLS), np.float32)
    for c, t in enumerate(tables):
        if t.mode != "serve":
            raise ValueError("stack_bin_tables expects serve-mode tables")
        fp, b = t.table.shape
        # NaN-padded categorical rows must keep NaN in the widened lanes
        pad = np.where(np.isnan(t.table[:, :1]), np.nan, np.inf)
        tab[c, :fp, :] = pad
        tab[c, :fp, :b] = t.table
        cv[c, :fp, :b] = t.cat_val
        meta[c, :fp, :] = t.meta
    return DeviceBinTable(table=tab, cat_val=cv, meta=meta,
                          num_features=F, B=B, mode="serve")


class StackedTableTensors(NamedTuple):
    """A stacked table's first ``num_features`` rows of each tenant as
    ``[C * F, ...]`` tensors on one device (``upload_stacked_table``): row
    ``c * F + f`` is tenant c's feature f, with #6's meta columns 6 / 7 and
    search grids of one common ``NB`` = B buckets."""
    table: torch.Tensor      # [C * F, B] f32
    cat_val: torch.Tensor    # [C * F, B] f32
    meta: torch.Tensor       # [C * F, 8] f32
    grids: torch.Tensor      # [C * F, 2 + B] int32
    num_tenants: int
    num_features: int
    B: int


def upload_stacked_table(t: DeviceBinTable,
                         device: torch.device) -> StackedTableTensors:
    """A ``stack_bin_tables`` table on `device`, each tenant's rows with the
    search grids and meta columns that ``upload_bin_table`` gives #6."""
    C, F = t.table.shape[0], t.num_features
    table = np.ascontiguousarray(t.table[:, :F].reshape(C * F, t.B))
    meta = np.array(t.meta[:, :F].reshape(C * F, _META_COLS), np.float32)
    count = search_counts(table)
    grids, depth = search_grids(table, count, t.B)
    meta[:, _M_DEPTH], meta[:, _M_COUNT] = depth, count

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return StackedTableTensors(
        table=up(table), cat_val=up(t.cat_val[:, :F].reshape(C * F, t.B)),
        meta=up(meta), grids=up(grids), num_tenants=C, num_features=F,
        B=t.B)


def _check_stacked_args(X, tid, t: StackedTableTensors):
    if X.dim() != 2 or X.dtype != torch.float32 \
            or X.shape[1] < t.num_features:
        raise ValueError(f"X must be a [n, >={t.num_features}] float32 "
                         f"tensor (got {X.dtype} {tuple(X.shape)})")
    if tid.dtype != torch.int32 or tuple(tid.shape) != (X.shape[0],):
        raise ValueError(f"tid must be [{X.shape[0]}] int32 (got "
                         f"{tid.dtype} {tuple(tid.shape)})")
    return X.shape[0], t.num_features


def bucketize_stacked_cuda(X: torch.Tensor, tid: torch.Tensor,
                           t: StackedTableTensors) -> torch.Tensor:
    """[n, F] uint8 bins of X [n, >=F] f32 (unit column stride), row i
    against tenant ``tid[i]``'s table (``csrc/bucketize_stacked.cu``, one
    launch): bitwise ``bucketize_cuda`` on that tenant's own table. A row
    whose tenant id is outside [0, C) bins to 0."""
    dev = hc._cuda_device(X)
    n, F = _check_stacked_args(X, tid, t)
    if X.shape[1] > 1 and X.stride(1) != 1:
        raise ValueError("X must have unit column stride")
    CF = t.num_tenants * F
    for name, a, dt, shape in (
            ("tid", tid, torch.int32, (n,)),
            ("table", t.table, torch.float32, (CF, t.B)),
            ("cat_val", t.cat_val, torch.float32, (CF, t.B)),
            ("meta", t.meta, torch.float32, (CF, _META_COLS)),
            ("grids", t.grids, torch.int32, (CF, 2 + t.B))):
        hc._check(a, name, (dt,), shape, dev)
    out = torch.empty((n, F), dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    _, stream = hc._launch_env(dev)
    rc = hc._lib("bucketize_stacked")(
        X.data_ptr(), n, X.stride(0), tid.data_ptr(), t.num_tenants, F,
        t.table.data_ptr(), t.grids.data_ptr(), t.B, t.cat_val.data_ptr(),
        t.meta.data_ptr(), t.B, out.data_ptr(), stream)
    hc._raise_on(rc, "bucketize_stacked")
    hc.LAUNCHES["bucketize_stacked"] += 1
    return out


def bucketize_stacked_plain(X: torch.Tensor, tid: torch.Tensor,
                            t: StackedTableTensors) -> torch.Tensor:
    """Plain PyTorch version of bucketize_stacked_cuda: each (row, feature)
    value's tenant table row gathered by tid, then ``bin_block_plain``
    over the n * F values as one row."""
    n, F = _check_stacked_args(X, tid, t)
    C = t.num_tenants
    ok = (tid >= 0) & (tid < C)
    rows = (tid.clamp(0, max(C - 1, 0)).to(torch.int64)[:, None] * F
            + torch.arange(F, device=X.device)[None, :]).reshape(-1)
    out = bin_block_plain(X[:, :F].reshape(1, n * F), t.table[rows],
                          t.cat_val[rows], t.meta[rows]).reshape(n, F)
    return torch.where(ok[:, None], out, torch.zeros_like(out))


def bucketize_rows_stacked(X: torch.Tensor, tid: torch.Tensor,
                           t: StackedTableTensors) -> torch.Tensor:
    """Cross-tenant bucketize of the fleet's fused drain: X [n, >=F] raw
    f32 rows, tid [n] int32 tenant ids, against a stacked table; [n, F]
    uint8, bit-identical to each tenant's own ``bucketize_rows``. The
    kernel for a CUDA tensor, the plain version for a CPU tensor (the JAX
    package's bucketize_rows_stacked is XLA)."""
    if X.device.type == "cuda":
        return bucketize_stacked_cuda(X, tid, t)
    return bucketize_stacked_plain(X, tid, t)


# ----------------------------------------------------------------------
# ingest: chunked upload of a host matrix
# ----------------------------------------------------------------------
def bin_rows_device(X: np.ndarray, t, device: torch.device,
                    cols: Optional[Sequence[int]] = None,
                    chunk: int = 1 << 18,
                    out: Optional[torch.Tensor] = None,
                    col0: int = 0) -> torch.Tensor:
    """Bin a host f32 matrix on `device` into the feature-major [F, n] uint8
    matrix training consumes. Row chunks of X are uploaded one at a time
    (the device never holds a second full f32 copy), and the kernel writes
    each chunk's bins straight into its columns of the result. ``cols``
    selects X's column for each table row (the dataset's
    ``real_feature_index``) without a host copy of the selection. `t` is a
    DeviceBinTable, or its ``upload_bin_table`` tensors on `device`. With
    ``out``, an [F, >= col0 + n] uint8 matrix on `device` (a streaming
    Dataset's ``X_t``), the bins land in its columns [col0, col0 + n) and
    ``out`` is returned."""
    n = X.shape[0]
    F = t.num_features
    tt = t if isinstance(t, BinTableTensors) else upload_bin_table(t, device)
    ci = None if cols is None else torch.as_tensor(
        np.asarray(cols, np.int32)).to(device)
    if out is None:
        out, col0 = torch.empty((F, n), dtype=torch.uint8,
                                device=device), 0
    elif (out.dtype != torch.uint8 or out.dim() != 2 or out.shape[0] != F
          or out.shape[1] < col0 + n):
        raise ValueError(f"out must be an [{F}, >= {col0 + n}] uint8 "
                         f"matrix, got {out.dtype} {tuple(out.shape)}")
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        xc = torch.from_numpy(np.ascontiguousarray(X[c0:c1], np.float32))
        bucketize_rows(xc.to(device), tt,
                       out=out[:, col0 + c0:col0 + c1].t(), cols=ci)
    return out
