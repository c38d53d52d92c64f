"""Packed-integer collective payloads and order-encoded split keys.

Counterpart of lightgbm_tpu/parallel/packed.py, bitwise: the same lanes
and the same key integers for the same inputs. Two devices of the
data-parallel growers' histogram exchange (docs/PERF.md §Communication):

1. **int32-packed-int16 histogram payloads** under quantized gradients
   (the reference's int32-packed-int16 reducers, include/LightGBM/bin.h:
   49-82): the int32 grad and hess channels fold into ONE int32 lane,
   ``packed = g * 2^16 + h``, exact while the summed hess stays in
   [0, 2^16) and the summed grad within +-2^15 (`pack_safe`, decided from
   the quantization ranges before the tree grows).

2. **Order-encoded best-split keys** for broadcast-free winner recovery
   (SyncUpGlobalBestSplit, parallel_tree_learner.h:210-233): each rank
   searches the features it owns; the winner is elected with a max over an
   order-preserving encoding of the gain bits plus a second tie-break lane,
   and its record recovered with one masked sum. The JAX keys are uint32
   lanes; torch's collectives have no uint32 max, so the port carries the
   same uint32 values in int64 tensors, whose max is then the uint32 order.
"""

from __future__ import annotations

from typing import Any

import torch

# key_lo bit layouts (uint32 values, complement fields so LOWER wins):
#
# merge order (default) — [31:12] ~feature (20 bits), [11:2] threshold
# bin (10 bits), [1] default_left, [0] is_cat. Gain ties resolve toward the
# LOWEST feature id: the wave grower's record-gather merge (lowest rank =>
# lowest owned feature slice).
#
# scan order — [31] ~is_cat, [30] ~default_left, [29:10] ~feature, [9:0]
# ~threshold bin: the single-device full scan's tie order (numerical over
# categorical, then the d = 0 direction block, then feature, then bin),
# which the leaf grower's reduce-scatter merge keeps.
_FEAT_BITS = 20
_BIN_BITS = 10
FEAT_MAX = (1 << _FEAT_BITS) - 1
_BIN_MAX = (1 << _BIN_BITS) - 1
_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# packed int16-pair histogram lanes
# ---------------------------------------------------------------------------

def pack_safe(n_rows_global: int, num_grad_quant_bins: int) -> bool:
    """Can the summed quantized grad / hess of any bin carry past bit 15
    of the packed lane? Per-row magnitudes are bounded by the
    discretizer's scales plus one unit of stochastic rounding, clipped at
    127 (gradient_discretizer.cpp); the per-bin sum over all rows of all
    ranks by n_rows_global times that bound."""
    qb = int(num_grad_quant_bins)
    per_row = min(127, qb + 1)
    return int(n_rows_global) * per_row < (1 << 15)


def pack_gh(hist: torch.Tensor, axis: int) -> torch.Tensor:
    """Fold the (grad, hess) int32 channel pair along `axis` into one
    packed int32 lane, ``g * 2^16 + h``; the axis stays, of length 1."""
    g = hist.narrow(axis, 0, 1).to(torch.int32)
    h = hist.narrow(axis, 1, 1).to(torch.int32)
    return (g << 16) + h


def unpack_gh(packed: torch.Tensor, axis: int) -> torch.Tensor:
    """Inverse of `pack_gh` after the collective: hess is the low 16 bits
    (non-negative, so the mask is exact), grad the arithmetic right shift
    (floor division by 2^16, exact because the hess residue is
    non-negative)."""
    h = packed & 0xFFFF
    g = packed >> 16
    return torch.cat([g, h], dim=axis)


# ---------------------------------------------------------------------------
# order-encoded split keys
# ---------------------------------------------------------------------------

def encode_gain_key(gain: torch.Tensor) -> torch.Tensor:
    """Order-preserving uint32 encoding of the f32 gain bits, as int64:
    the sign bit of non-negative floats set, every bit of negative floats
    flipped, so integer order is float order (-inf lowest)."""
    u = gain.to(torch.float32).contiguous().view(torch.int32) \
        .to(torch.int64) & _U32
    neg = (u >> 31) == 1
    return torch.where(neg, ~u & _U32, u | 0x80000000)


def encode_split_key(feature: torch.Tensor, threshold: torch.Tensor,
                     default_left: torch.Tensor, is_cat=None,
                     scan_order: bool = False) -> torch.Tensor:
    """The low key word (the layouts above), as int64 uint32 values."""
    f = feature.to(torch.int64).clamp(0, FEAT_MAX)
    b = threshold.to(torch.int64).clamp(0, _BIN_MAX)
    dl = default_left.to(torch.int64) & 1
    ic = (is_cat.to(torch.int64) & 1) if is_cat is not None \
        else torch.zeros_like(dl)
    if scan_order:
        return ((1 - ic) << 31) | ((1 - dl) << 30) \
            | ((FEAT_MAX - f) << _BIN_BITS) | (_BIN_MAX - b)
    return ((FEAT_MAX - f) << (_BIN_BITS + 2)) | (b << 2) | (dl << 1) | ic


def decode_key_feature(key_lo: torch.Tensor,
                       scan_order: bool = False) -> torch.Tensor:
    """The winning global feature id from the low key word."""
    shift = _BIN_BITS if scan_order else _BIN_BITS + 2
    return FEAT_MAX - ((key_lo.to(torch.int64) >> shift) & FEAT_MAX)


def pmax_winner_mask(dist, gain: torch.Tensor, feature: torch.Tensor,
                     threshold: torch.Tensor, default_left: torch.Tensor,
                     is_cat=None, scan_order: bool = False) -> torch.Tensor:
    """Broadcast-free best-split election over per-rank candidates of any
    matching shape: True on the one rank whose candidate won each slot
    (feature slices are disjoint across ranks). Two max rounds; recover the
    record with `masked_psum_record`."""
    key_hi = encode_gain_key(gain)
    hi_max = dist.pmax(key_hi)
    key_lo = torch.where(key_hi == hi_max,
                         encode_split_key(feature, threshold, default_left,
                                          is_cat, scan_order=scan_order),
                         torch.zeros_like(key_hi))
    lo_max = dist.pmax(key_lo)
    win_feat = decode_key_feature(lo_max, scan_order=scan_order)
    return (key_hi == hi_max) & (feature.to(torch.int64) == win_feat)


def _leaves(rec: Any, out: list) -> None:
    if isinstance(rec, torch.Tensor):
        out.append(rec)
    else:
        for r in rec:
            _leaves(r, out)


def map_record(fn, rec: Any) -> Any:
    """`fn` over every tensor of a nested tuple / NamedTuple, in order."""
    if isinstance(rec, torch.Tensor):
        return fn(rec)
    items = [map_record(fn, r) for r in rec]
    return type(rec)(*items) if hasattr(rec, "_fields") else type(rec)(items)


def _rebuild(rec: Any, it) -> Any:
    return map_record(lambda _: next(it), rec)


def masked_psum_record(dist, mask: torch.Tensor, record: Any) -> Any:
    """Exact winner-record recovery: every non-winning rank's contribution
    set to the additive identity, then summed; one rank contributes per
    slot, so the floats come back bit for bit. A float's identity is
    -0.0, not 0.0: x + (-0.0) is x for every x, where -0.0 + 0.0 is 0.0,
    so a winner's -0.0 (a leaf output of a zero gradient sum) keeps its
    sign and the record equals the gather merge's (the JAX package fills
    0 and loses it). `record` is a nested tuple / NamedTuple of tensors
    whose leading dims match `mask`'s; one sum per dtype."""
    leaves: list = []
    _leaves(record, leaves)
    groups: dict = {}
    for i, a in enumerate(leaves):
        m = mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim()))
        if a.dtype == torch.bool:
            v = torch.where(m, a, False).to(torch.int32)
        else:
            ident = -0.0 if a.is_floating_point() else 0
            v = torch.where(m, a, torch.full((), ident, dtype=a.dtype,
                                             device=a.device))
        groups.setdefault(v.dtype, []).append((i, v))
    out = [None] * len(leaves)
    for dtype, items in groups.items():
        flat = torch.cat([v.reshape(-1) for _, v in items])
        summed = dist.psum(flat)
        o = 0
        for i, v in items:
            n = v.numel()
            s = summed[o:o + n].reshape(v.shape)
            o += n
            out[i] = s > 0 if leaves[i].dtype == torch.bool else s
    return _rebuild(record, iter(out))


def gather_records(dist, record: Any) -> Any:
    """Every rank's `record` (a nested tuple / NamedTuple of tensors),
    each tensor with a new leading rank axis [W, ...]: the record gather
    of the wave grower's merge, one all-gather per dtype."""
    leaves: list = []
    _leaves(record, leaves)
    groups: dict = {}
    for i, a in enumerate(leaves):
        v = a.to(torch.int32) if a.dtype == torch.bool else a
        groups.setdefault(v.dtype, []).append((i, v))
    out = [None] * len(leaves)
    for dtype, items in groups.items():
        flat = torch.cat([v.reshape(-1) for _, v in items])
        allf = dist.all_gather(flat, axis=0, tiled=False)    # [W, total]
        o = 0
        for i, v in items:
            n = v.numel()
            g = allf[:, o:o + n].reshape((allf.shape[0],) + tuple(v.shape))
            o += n
            out[i] = g != 0 if leaves[i].dtype == torch.bool else g
    return _rebuild(record, iter(out))
