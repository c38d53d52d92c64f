"""Row-wise multi-value histogram construction.

Counterpart of lightgbm_tpu/ops/histogram_rowwise.py (the reference's
`MultiValDenseBin` row-wise path, multi_val_dense_bin.hpp:21): every
storage column owns its own 8-aligned width in ONE flat per-feature-offset
buffer, and one pass over the rows accumulates a row's full feature set.
The flat [K, C, total] buffer expands to the uniform [K, C, F, B] grid with
`split.expand_feature_offset_hist`, so the split search is untouched.

Two Hopper kernels (``csrc/hist_rowwise.cu``) replace the JAX package's two
Pallas kernels:

  hist_rowwise_cuda         <- build_histogram_slots_rowwise_flat
  hist_rowwise_packed_cuda  <- build_histogram_slots_rowwise_packed_flat
                               (<= 16-bin columns read from 4-bit nibbles
                               made by `pack4`, the rest from an unpacked
                               remainder)

each with its plain PyTorch version (``*_plain``). Both kernels sweep
their rows with the tiled accumulation engine of the col-wise slot
histogram (``csrc/hist_tiles.cuh``), its tiles cut as column ranges of
the flat buffer (``histogram_cuda.plan_flat_tiles``). Float channels
accumulate in float64 and are rounded once, as the col-wise slot histogram
does, so the expanded buffer equals `build_histogram_slots` bit for bit;
int8 channels accumulate exactly in int32. The plans are the JAX package's
(the same offsets, widths and nibble positions), so the flat buffers of the
two packages have one layout.

The TPU-only VMEM residency gate `rowwise_eligible` chooses a kernel, not a
result, and has no counterpart here; `pack4_worthwhile` decides which
layout the packed kernel reads and is kept.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils import round_up as _round_up
from . import histogram_cuda as hc

# the JAX plan's column-chunk size: offsets depend on it
CHUNK_COLS = 2048


def rw_width(num_bin: int) -> int:
    """Flat columns a feature owns: its bin count rounded up to 8."""
    if num_bin > 256:
        raise ValueError(f"num_bin {num_bin} exceeds 256 (8-bit storage)")
    return max(_round_up(int(num_bin), 8), 8)


class RowWisePlan(NamedTuple):
    """Static flat-buffer layout (hashable): ``chunks`` as the JAX
    package's plan (``(col0, cols, ((f0, count, width), ...))``, 128-aligned
    column chunks of at most CHUNK_COLS columns), per-feature ``offsets``
    and ``widths``, and the flat ``total`` width."""
    chunks: tuple
    offsets: tuple
    widths: tuple
    total: int


@functools.lru_cache(maxsize=256)
def build_rowwise_plan(feature_num_bins: tuple) -> RowWisePlan:
    """Lay out the flat multi-value buffer: per-feature 8-aligned widths
    packed into 128-aligned column chunks of <= CHUNK_COLS columns
    (lightgbm_tpu/ops/histogram_rowwise.py:89)."""
    offsets, widths, chunks = [], [], []
    runs: list = []
    col0 = used = 0
    for f, nb in enumerate(feature_num_bins):
        w = rw_width(int(nb))
        if used and used + w > CHUNK_COLS:
            chunks.append((col0, _round_up(used, 128),
                           tuple(tuple(r) for r in runs)))
            col0 += _round_up(used, 128)
            runs, used = [], 0
        if runs and runs[-1][2] == w:
            runs[-1][1] += 1
        else:
            runs.append([f, 1, w])
        offsets.append(col0 + used)
        widths.append(w)
        used += w
    if runs:
        chunks.append((col0, _round_up(used, 128),
                       tuple(tuple(r) for r in runs)))
        col0 += _round_up(used, 128)
    return RowWisePlan(tuple(chunks), tuple(offsets), tuple(widths), col0)


class Pack4Plan(NamedTuple):
    """Static nibble layout (hashable): ``pack_pos[f]`` is storage column
    f's nibble index among the packed columns (byte ``pack_pos // 2``, low
    nibble for an even index), or -1 when it is too wide and lives in the
    remainder at row ``rest_pos[f]``."""
    pack_pos: tuple
    rest_pos: tuple
    n_packed: int     # packable columns (num_bins <= 16)
    n_rest: int       # remainder columns


@functools.lru_cache(maxsize=256)
def build_pack4_plan(feature_num_bins: tuple) -> Pack4Plan:
    """Every <= 16-bin storage column gets a nibble, in storage order."""
    pack_pos, rest_pos = [], []
    np_, nr = 0, 0
    for nb in feature_num_bins:
        if int(nb) <= 16:
            pack_pos.append(np_)
            rest_pos.append(-1)
            np_ += 1
        else:
            pack_pos.append(-1)
            rest_pos.append(nr)
            nr += 1
    return Pack4Plan(tuple(pack_pos), tuple(rest_pos), np_, nr)


def pack4_worthwhile(pplan: Pack4Plan) -> bool:
    """Packing saves bytes only when at least one byte carries two
    columns; below that the plain row-wise kernel runs."""
    return pplan.n_packed >= 2


def pack4(X_t: torch.Tensor, pplan: Pack4Plan
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[F, N] uint8 storage -> (Xp [ceil(P / 2), N] uint8 nibble pairs,
    Xu [max(n_rest, 1), N] uint8 remainder), the JAX package's `pack4`
    (its int8 bytes as uint8). Done once per training run."""
    F, N = X_t.shape
    if len(pplan.pack_pos) != F:
        raise ValueError("the pack plan does not match X_t's columns")
    dev = X_t.device
    lo_f = [f for f in range(F) if pplan.pack_pos[f] >= 0
            and pplan.pack_pos[f] % 2 == 0]
    hi_f = [f for f in range(F) if pplan.pack_pos[f] >= 0
            and pplan.pack_pos[f] % 2 == 1]
    rest_f = [f for f in range(F) if pplan.rest_pos[f] >= 0]

    def rows(fs):
        return X_t[torch.tensor(fs, dtype=torch.int64, device=dev)] & 15

    lo = rows(lo_f)
    hi = rows(hi_f) if hi_f else X_t.new_zeros((0, N))
    if lo.shape[0] > hi.shape[0]:        # odd count: the hi nibble stays 0
        hi = torch.cat([hi, X_t.new_zeros((lo.shape[0] - hi.shape[0], N))])
    Xp = (lo | (hi << 4)).contiguous()
    if rest_f:
        Xu = X_t[torch.tensor(rest_f, dtype=torch.int64,
                              device=dev)].contiguous()
    else:
        Xu = X_t.new_zeros((1, N))
    return Xp, Xu


def unpack4(Xp: torch.Tensor, Xu: torch.Tensor,
            pplan: Pack4Plan) -> torch.Tensor:
    """The [F, N] uint8 storage back from `pack4`'s operands."""
    rows = []
    for p, r in zip(pplan.pack_pos, pplan.rest_pos):
        rows.append((Xp[p // 2] >> (4 * (p % 2))) & 15 if p >= 0 else Xu[r])
    return torch.stack(rows)


def flat_plan(plan: RowWisePlan, K: int, C: int,
              quantized: bool) -> "hc.FlatTilePlan":
    """The engine's tile plan of a [K, C, total] flat histogram."""
    return hc.plan_flat_tiles(K, C, plan.offsets, plan.widths, plan.total,
                              quantized=quantized)


@functools.lru_cache(maxsize=64)
def _desc(plan: RowWisePlan, pplan: Optional[Pack4Plan], cuts: tuple,
          device: torch.device) -> torch.Tensor:
    """The flat reader's descriptors (csrc/hist_tiles.cuh FlatBins), int32:
    [4, F] rows offset, width, nibble index (-1: a whole byte) and byte row
    (of the storage, or of the remainder when packed), then the tile cuts
    [nft + 1]."""
    F = len(plan.widths)
    if pplan is None:
        rows = [plan.offsets, plan.widths, (-1,) * F, tuple(range(F))]
    else:
        rows = [plan.offsets, plan.widths, pplan.pack_pos, pplan.rest_pos]
    flat = [v for r in rows for v in r] + list(cuts)
    return torch.tensor(flat, dtype=torch.int32, device=device)


def _check_rowwise(vals, slot, num_slots, plan, F, N, dev):
    C = vals.shape[0] if vals.dim() == 2 else -1
    if not 1 <= C <= hc.MAX_CHANNELS:
        raise ValueError(f"vals must be [C, N] with 1 <= C <= "
                         f"{hc.MAX_CHANNELS}, got {tuple(vals.shape)}")
    hc._check(vals, "vals", (torch.float32, torch.int8), (C, N), dev)
    if slot is not None:
        hc._check(slot, "slot", (torch.int32,), (N,), dev)
    if len(plan.widths) != F:
        raise ValueError(f"the plan has {len(plan.widths)} columns, the "
                         f"storage {F}")
    if num_slots < 1 or num_slots * C * plan.total >= 2 ** 31:
        raise ValueError(f"num_slots={num_slots} is out of range")
    return C


def _rowwise_launch(name, X, Xu, vals, slot, K, plan, pplan, tp=None):
    """Launch `name` (csrc/hist_rowwise.cu) on checked operands, under the
    tile plan `tp` (None: flat_plan's)."""
    dev = X.device
    N = X.shape[1]
    F, C = len(plan.widths), vals.shape[0]
    quant = vals.dtype == torch.int8
    if tp is None:
        tp = flat_plan(plan, K, C, quant)
    sms, stream = hc._launch_env(dev)
    tb = hc.tile_buffers(tp, (K, C, plan.total), N, slot is not None, quant,
                         dev, sms)
    args = [X.data_ptr()] + ([Xu.data_ptr()] if Xu is not None else [])
    rc = hc._lib(name)(
        *args, vals.data_ptr(), int(quant), hc._ptr(slot),
        _desc(plan, pplan, tp.col_cuts, dev).data_ptr(), hc._ptr(tb.scratch),
        tb.out.data_ptr(), hc._ptr(tb.acc), N, F, C, K, plan.total,
        tp.slots_per_tile, tp.slot_tiles, tp.feat_tiles, tp.max_cols,
        tb.segs, hc.MIN_SEGMENT_ROWS, int(tp.merge), int(tp.paired), tb.W,
        tp.smem_bytes, stream)
    hc._raise_on(rc, name)
    hc.LAUNCHES[name] += 1
    return tb.out


def hist_rowwise_cuda(X: torch.Tensor, vals: torch.Tensor,
                      slot: Optional[torch.Tensor], num_slots: int,
                      plan: RowWisePlan) -> torch.Tensor:
    """Flat row-wise slot histogram [K, C, total] of X [F, N] uint8 (f32
    vals give f32 sums, int8 vals exact int32); slot None: every row in
    slot 0."""
    dev = hc._cuda_device(X)
    if X.dim() != 2:
        raise ValueError("X must be [F, N]")
    F, N = X.shape
    hc._check(X, "X", (torch.uint8,), (F, N), dev)
    _check_rowwise(vals, slot, num_slots, plan, F, N, dev)
    return _rowwise_launch("hist_rowwise", X, None, vals, slot, num_slots,
                           plan, None)


def hist_rowwise_packed_cuda(Xp: torch.Tensor, Xu: torch.Tensor,
                             vals: torch.Tensor,
                             slot: Optional[torch.Tensor], num_slots: int,
                             plan: RowWisePlan,
                             pplan: Pack4Plan) -> torch.Tensor:
    """hist_rowwise_cuda reading `pack4`'s operands: the same buffer."""
    dev = hc._cuda_device(Xp)
    if Xp.dim() != 2 or Xu.dim() != 2:
        raise ValueError("Xp and Xu must be [rows, N]")
    N = Xp.shape[1]
    F = len(pplan.pack_pos)
    if pplan.n_packed < 1:
        raise ValueError("no packable columns: use hist_rowwise_cuda")
    hc._check(Xp, "Xp", (torch.uint8,), ((pplan.n_packed + 1) // 2, N), dev)
    hc._check(Xu, "Xu", (torch.uint8,), (max(pplan.n_rest, 1), N), dev)
    _check_rowwise(vals, slot, num_slots, plan, F, N, dev)
    return _rowwise_launch("hist_rowwise_packed", Xp, Xu, vals, slot,
                           num_slots, plan, pplan)


def hist_rowwise_plain(X: torch.Tensor, vals: torch.Tensor,
                       slot: Optional[torch.Tensor], num_slots: int,
                       plan: RowWisePlan) -> torch.Tensor:
    """Plain PyTorch version of hist_rowwise_cuda: one index_add_ per
    (column, channel) into f64 (int32 for int8 vals) accumulators; rows
    outside [0, K) and bins past a column's width land in a discarded
    trailing cell."""
    F, N = X.shape
    C = vals.shape[0]
    K, total = num_slots, plan.total
    quant = vals.dtype == torch.int8
    acc_dtype = torch.int32 if quant else torch.float64
    trash = K * C * total
    acc = torch.zeros(trash + 1, dtype=acc_dtype, device=X.device)
    s = (torch.zeros(N, dtype=torch.int64, device=X.device) if slot is None
         else slot.to(torch.int64))
    ok = (s >= 0) & (s < K)
    base = s.clamp(0, K - 1) * C
    v = vals.to(acc_dtype)
    for f in range(F):
        b = X[f].to(torch.int64)
        okf = ok & (b < plan.widths[f])
        col = plan.offsets[f] + b
        for c in range(C):
            idx = torch.where(okf, (base + c) * total + col, trash)
            acc.index_add_(0, idx, v[c])
    hist = acc[:trash].view(K, C, total)
    return hist if quant else hist.to(torch.float32)


def hist_rowwise_packed_plain(Xp: torch.Tensor, Xu: torch.Tensor,
                              vals: torch.Tensor,
                              slot: Optional[torch.Tensor], num_slots: int,
                              plan: RowWisePlan,
                              pplan: Pack4Plan) -> torch.Tensor:
    """Plain PyTorch version of hist_rowwise_packed_cuda."""
    return hist_rowwise_plain(unpack4(Xp, Xu, pplan), vals, slot, num_slots,
                              plan)
