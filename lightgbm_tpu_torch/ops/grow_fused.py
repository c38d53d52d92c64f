"""Fused growth waves: one wave's smaller-child slot histogram and the best
splits of both children of every candidate, in one call.

Counterpart of lightgbm_tpu/ops/grow_fused.py. Two Hopper kernels replace
its two Pallas kernels, both with the numeric split scan of
``csrc/split_scan.cuh``:

  wave_pass_fused_cuda        <- wave_pass_fused_pallas (pallas_call at
                                 :356): the megakernel route's membership
                                 pass and slot histogram (kernel #3's; at
                                 most 32 storage columns, the 16-row wave
                                 table, f32 values) and the scan;
                                 ``csrc/wave_pass_fused.cu``
  wave_pass_fused_tiled_cuda  <- wave_pass_fused_tiled_pallas (:656):
                                 membership from decision bits with a
                                 pending relabel first, any number of
                                 storage columns, f32 or int8 values (exact
                                 int32 sums, descaled after the parent-minus-
                                 small subtraction), per-child feature
                                 masks, and the scan;
                                 ``csrc/wave_pass_fused_tiled.cu``

The JAX package defines the fused path as bit-identical to the two-pass one
(grow_fused.py:30-32), so each kernel's plain version is the two-pass
computation: the wave's relabel and slot histogram by the plain versions of
the two-pass kernels, then `synth_count_channel` + `find_best_split` of each
child (small, or parent - small).

The scan reads per-child parent statistics and monotone bounds
(`pack_fused_scalars`, the counterpart of grow_fused.py:pack_fused_scalars),
per-feature metadata with the monotone direction (`pack_fused_meta`) and a
feature mask of [F] or [2K, F] (column sampling and interaction sets); as
the JAX scan (_fused_scan_tiled, grow_fused.py:402-449) it clips each
cell's child outputs into the child's bounds and rejects a split on a
+-1 feature whose clipped outputs go the wrong way. It writes one
record per child, [12, 2K] f32 in SplitResult field order with left
children in columns [0, K) and right children in [K, 2K) (feature,
threshold and default_left are exact small floats). `unpack_fused_records`
turns the columns of the wave's live candidates into a SplitResult. The
GPU scan gives every (child, feature) a warp and reduces each child's
winner across all F features, so the TPU kernel's cross-tile merge
(merge_tile_records) has no counterpart. Both kernels' slot histograms are
the tiled accumulation engine of the col-wise slot histogram, on its plan
(``histogram_cuda.plan_hist_tiles``), and its scan the tail they share
(``csrc/fused_tail.cuh``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import histogram_cuda as hc
from .split import (SYNTH_COUNT_SLACK, FeatureMeta, SplitHyperParams,
                    SplitResult, find_best_split, synth_count_channel)

REC_FIELDS = 12


def pack_fused_scalars(bs: SplitResult, smaller_is_left: torch.Tensor,
                       leaf_min_lr: Optional[torch.Tensor] = None,
                       leaf_max_lr: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """[7, 2K] f32 per-child parent statistics of K candidates' best splits
    `bs` (rows sum_g, sum_h, count, output, smaller_is_left as 0 / 1, then
    each child's monotone bounds min and max, +-inf when unconstrained;
    left children in columns [0, K), right in [K, 2K)), the scalar block
    of grow_fused.py:pack_fused_scalars without its quantized row 7."""
    sil = smaller_is_left.to(torch.float32)
    K = sil.shape[0]
    if leaf_min_lr is None:
        leaf_min_lr = torch.full((2 * K,), float("-inf"), device=sil.device)
        leaf_max_lr = torch.full((2 * K,), float("inf"), device=sil.device)
    rows = [torch.cat([bs.left_sum_g, bs.right_sum_g]),
            torch.cat([bs.left_sum_h, bs.right_sum_h]),
            torch.cat([bs.left_count, bs.right_count]),
            torch.cat([bs.left_output, bs.right_output]),
            torch.cat([sil, sil]), leaf_min_lr, leaf_max_lr]
    return torch.stack([r.to(torch.float32) for r in rows]).contiguous()


def pack_fused_meta(meta: FeatureMeta) -> torch.Tensor:
    """[5, F] int32: num_bins, missing_type, default_bin, is_categorical
    and the monotone direction (zeros when unconstrained)."""
    mono = (torch.zeros_like(meta.num_bins) if meta.monotone is None
            else meta.monotone)
    return torch.stack([meta.num_bins.to(torch.int32),
                        meta.missing_type.to(torch.int32),
                        meta.default_bin.to(torch.int32),
                        meta.is_categorical.to(torch.int32),
                        mono.to(torch.int32)]).contiguous()


def fused_feature_mask(feature_mask: Optional[torch.Tensor], F: int,
                       device, children: int = 0) -> torch.Tensor:
    """The scan's uint8 feature mask: [F], or one row per child
    ([children, F]) when `children` > 0; all ones without column
    sampling."""
    fm = (torch.ones(F, dtype=torch.uint8, device=device)
          if feature_mask is None else feature_mask.to(torch.uint8))
    if children:
        fm = fm.expand(children, F)
    return fm.contiguous()


def unpack_fused_records(rec: torch.Tensor, n: int) -> SplitResult:
    """SplitResult of [2n]: the left then the right children of the first
    n candidates of a [12, 2K] record block."""
    K = rec.shape[1] // 2
    r = torch.cat([rec[:, :n], rec[:, K:K + n]], dim=1)
    return SplitResult(
        gain=r[0], feature=r[1].to(torch.int64),
        threshold=r[2].to(torch.int64), default_left=r[3] > 0.5,
        left_sum_g=r[4], left_sum_h=r[5], left_count=r[6],
        right_sum_g=r[7], right_sum_h=r[8], right_count=r[9],
        left_output=r[10], right_output=r[11])


def _scan_plain(hist: torch.Tensor, parent: torch.Tensor,
                scal: torch.Tensor, fmeta: torch.Tensor, fmask: torch.Tensor,
                hp: SplitHyperParams,
                scale: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain version of the split scan: the [12, 2K] records of the 2K
    children of the smaller-child histograms `hist` [K, 2, F, B] and the
    candidates' parent histograms `parent` [K, 2 * F * B]."""
    K = hist.shape[0]
    sil = (scal[4, :K] != 0)[:, None, None, None]
    large = parent.reshape(hist.shape) - hist
    ch = torch.cat([torch.where(sil, hist, large),
                    torch.where(sil, large, hist)])          # [2K, 2, F, B]
    if scale is not None:
        # int32 sums subtract exactly, then descale (grow_fused.py:437-439)
        ch = ch.to(torch.float32) * scale[:, None, None]
    # the monotone operand: directions and bounds clip and reject as in
    # find_best_split; zeros and +-inf leave the records unchanged
    meta = FeatureMeta(num_bins=fmeta[0], missing_type=fmeta[1],
                       default_bin=fmeta[2], is_categorical=fmeta[3] != 0,
                       monotone=fmeta[4])
    res = find_best_split(synth_count_channel(ch, scal[2], scal[1]), scal[0],
                          scal[1], scal[2], scal[3], meta, hp, fmask != 0,
                          leaf_min=scal[5], leaf_max=scal[6])
    return torch.stack([x.to(torch.float32) for x in res])


def _hp_args(hp: SplitHyperParams) -> list:
    """The scan's hyperparameter arguments, rounded to f32 as torch rounds
    a Python scalar against an f32 tensor."""
    f = ctypes.c_float
    return [f(hp.min_data_in_leaf - SYNTH_COUNT_SLACK),
            f(hp.min_sum_hessian_in_leaf), f(hp.lambda_l1), f(hp.lambda_l2),
            f(hp.max_delta_step), f(hp.path_smooth), f(hp.min_gain_to_split),
            int(hp.max_delta_step > 0), int(hp.path_smooth > 1e-15)]


def _check_scan_args(parent, scal, fmeta, fmask, K, F, B, parent_dtype,
                     dev):
    hc._check(parent, "parent", (parent_dtype,), (K, 2 * F * B), dev)
    hc._check(scal, "scal", (torch.float32,), (7, 2 * K), dev)
    hc._check(fmeta, "fmeta", (torch.int32,), (5, F), dev)
    shape = (F,) if fmask.dim() == 1 else (2 * K, F)
    hc._check(fmask, "fmask", (torch.uint8,), shape, dev)
    return 0 if fmask.dim() == 1 else F


def _scan_scratch(K: int, F: int, device) -> torch.Tensor:
    """The scan's [2K] u64 best keys and [2K] u32 completion counters
    (zeroed by the launch), then its [2K, F, 8] f32 cells."""
    return torch.empty(3 * K + 8 * K * F, dtype=torch.int64, device=device)


def _check_slots(num_slots: int) -> None:
    if not 1 <= num_slots <= hc.MAX_SLOTS:
        raise ValueError(f"num_slots must be in [1, {hc.MAX_SLOTS}], got "
                         f"{num_slots}")


# ---------------------------------------------------------------------------
# 9. the narrow fused wave
# ---------------------------------------------------------------------------
def wave_pass_fused_cuda(X: torch.Tensor, vals: torch.Tensor,
                         leaf_of_row: torch.Tensor, table: torch.Tensor,
                         parent: torch.Tensor, scal: torch.Tensor,
                         fmeta: torch.Tensor, fmask: torch.Tensor,
                         num_slots: int, num_bins: int, num_leaves: int,
                         hp: SplitHyperParams, *,
                         gmap: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused wave of the megakernel route: returns (new leaf_of_row [N]
    int32, smaller-child histogram [K, 2, F, B] f32, records [12, 2K]).
    X [F <= 32, N] uint8, vals [2, N] f32, `table` the [16, 128] wave table
    of wave_pass_cuda, `parent` [K, 2 * F * B] f32 the candidates' own
    histograms, `scal` from pack_fused_scalars, `fmeta` from
    pack_fused_meta, `fmask` uint8 [F] or [2K, F], `gmap` the caller's
    hc.new_leaf_map past hc.LEAF_CAP leaves (None: one for this launch)."""
    dev = hc._cuda_device(X)
    F, N = hc._check_wave_args(X, leaf_of_row, table, num_leaves, dev)
    _check_slots(num_slots)
    K, B = num_slots, num_bins
    hc._check_hist_args(X, vals, F, N, K, B, dev)
    hc._check(vals, "vals", (torch.float32,), (2, N), dev)
    stride = _check_scan_args(parent, scal, fmeta, fmask, K, F, B,
                              torch.float32, dev)
    sms, stream = hc._launch_env(dev)
    lay = hc.wave_hist_layout(K, 2, F, B, N, False, sms)
    new_lor = torch.empty_like(leaf_of_row)
    tb = hc._alloc_tiles(lay.sizes, (K, 2, F, B), False, dev)
    rec = torch.empty((REC_FIELDS, 2 * K), dtype=torch.float32, device=dev)
    rc = hc._lib("wave_pass_fused")(
        X.data_ptr(), vals.data_ptr(), leaf_of_row.data_ptr(),
        table.data_ptr(), new_lor.data_ptr(), tb.out.data_ptr(),
        hc._ptr(tb.acc), hc._ptr(tb.scratch), parent.data_ptr(),
        scal.data_ptr(), fmeta.data_ptr(), fmask.data_ptr(), stride,
        rec.data_ptr(), _scan_scratch(K, F, dev).data_ptr(), N, F, K, B,
        num_leaves, hc._ptr(hc._gmap(gmap, dev, num_leaves)),
        *hc._wave_hist_args(lay), *_hp_args(hp), sms, stream)
    hc._raise_on(rc, "wave_pass_fused")
    hc.LAUNCHES["wave_pass_fused"] += 1
    return new_lor, tb.out, rec


def wave_pass_fused_plain(X: torch.Tensor, vals: torch.Tensor,
                          leaf_of_row: torch.Tensor, table: torch.Tensor,
                          parent: torch.Tensor, scal: torch.Tensor,
                          fmeta: torch.Tensor, fmask: torch.Tensor,
                          num_slots: int, num_bins: int, num_leaves: int,
                          hp: SplitHyperParams
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of wave_pass_fused_cuda: the two-pass wave
    (wave_pass_plain, then the search of every child)."""
    new_lor, hist = hc.wave_pass_plain(X, vals, leaf_of_row, table,
                                       num_slots, num_bins, num_leaves)
    return new_lor, hist, _scan_plain(hist, parent, scal, fmeta, fmask, hp,
                                      None)


# ---------------------------------------------------------------------------
# 10. the general (feature-tiled on the TPU) fused wave
# ---------------------------------------------------------------------------
def wave_pass_fused_tiled_cuda(X: torch.Tensor, vals: torch.Tensor,
                               dec: torch.Tensor, leaf_of_row: torch.Tensor,
                               table: torch.Tensor, pend_leaf: torch.Tensor,
                               pend_nl0: torch.Tensor, parent: torch.Tensor,
                               scal: torch.Tensor, fmeta: torch.Tensor,
                               fmask: torch.Tensor, num_slots: int,
                               num_bins: int, num_leaves: int,
                               hp: SplitHyperParams,
                               scale: Optional[torch.Tensor] = None, *,
                               gmap: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """One fused wave from decision bits: returns (new leaf_of_row [N]
    int32, smaller-child histogram [K, 2, F, B], records [12, 2K]).

    `dec` [Kd, N] uint8: bit 0 = goes left under applied entry k, bit 1 =
    in candidate k's smaller child, bit 2 = goes left under pending entry
    k. `table` is the [16, 128] wave table (rows 0, 7 and 15 read, as
    wave_apply_cuda), `pend_leaf` [128] int32 the pending (deferred)
    applies' leaves, -1 = inactive, whose right children are leaves
    pend_nl0 + k (`pend_nl0` [1] int32). int8 `vals` accumulate in int32
    and take an int32 `parent`; `scale` [2] f32 = the (grad, hess) descale
    factors. Both live in device memory, so a captured graph replays each
    wave's own. Every leaf id is below `num_leaves`; K <= Kd. `gmap` as in
    wave_pass_fused_cuda."""
    dev = hc._cuda_device(X)
    if X.dim() != 2:
        raise ValueError("X must be [F, N]")
    F, N = X.shape
    Kd, _ = hc._check_apply_args(dec, leaf_of_row, table, num_leaves, dev)
    _check_slots(num_slots)
    K, B = num_slots, num_bins
    if K > Kd:
        raise ValueError(f"num_slots={K} exceeds the {Kd} rows of dec")
    hc._check_hist_args(X, vals, F, N, K, B, dev)
    hc._check(vals, "vals", (torch.float32, torch.int8), (2, N), dev)
    hc._check(pend_leaf, "pend_leaf", (torch.int32,), (hc.MAX_SLOTS,), dev)
    hc._check(pend_nl0, "pend_nl0", (torch.int32,), (1,), dev)
    quant = vals.dtype == torch.int8
    if quant == (scale is None):
        raise ValueError("int8 vals take the descale factors `scale`, f32 "
                         "vals none")
    if quant:
        hc._check(scale, "scale", (torch.float32,), (2,), dev)
    stride = _check_scan_args(parent, scal, fmeta, fmask, K, F, B,
                              torch.int32 if quant else torch.float32, dev)
    new_lor = torch.empty_like(leaf_of_row)
    plan = hc.plan_hist_tiles(K, 2, F, B, quantized=quant, rows=N)
    sms, stream = hc._launch_env(dev)
    # the scratch leads with the membership pass's [N] slots
    tb = hc.tile_buffers(plan, (K, 2, F, B), N, True, quant, dev, sms,
                         lead=N)
    rec = torch.empty((REC_FIELDS, 2 * K), dtype=torch.float32, device=dev)
    rc = hc._lib("wave_pass_fused_tiled")(
        X.data_ptr(), vals.data_ptr(), int(quant), dec.data_ptr(),
        leaf_of_row.data_ptr(), table.data_ptr(), pend_leaf.data_ptr(),
        pend_nl0.data_ptr(), new_lor.data_ptr(), tb.out.data_ptr(),
        hc._ptr(tb.acc), hc._ptr(tb.scratch), parent.data_ptr(),
        scal.data_ptr(), fmeta.data_ptr(), fmask.data_ptr(), stride,
        rec.data_ptr(), _scan_scratch(K, F, dev).data_ptr(), N, F, K, B, Kd,
        num_leaves, hc._ptr(hc._gmap(gmap, dev, num_leaves)),
        plan.slots_per_tile, plan.feats_per_tile,
        plan.slot_tiles, plan.feat_tiles, tb.segs, hc.MIN_SEGMENT_ROWS,
        int(plan.merge), int(plan.paired), int(plan.direct), tb.W,
        scale.data_ptr() if quant else None, *_hp_args(hp), sms, stream)
    hc._raise_on(rc, "wave_pass_fused_tiled")
    hc.LAUNCHES["wave_pass_fused_tiled"] += 1
    return new_lor, tb.out, rec


def wave_pass_fused_tiled_plain(X: torch.Tensor, vals: torch.Tensor,
                                dec: torch.Tensor, leaf_of_row: torch.Tensor,
                                table: torch.Tensor, pend_leaf: torch.Tensor,
                                pend_nl0: torch.Tensor, parent: torch.Tensor,
                                scal: torch.Tensor, fmeta: torch.Tensor,
                                fmask: torch.Tensor, num_slots: int,
                                num_bins: int, num_leaves: int,
                                hp: SplitHyperParams,
                                scale: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Plain PyTorch version of wave_pass_fused_tiled_cuda: the pending
    pass and the apply pass as wave_apply_plain applies them, the slot
    histogram of the smaller children, then the search of every child."""
    K = num_slots
    tp = torch.full_like(table, -1)
    tp[0] = pend_leaf
    tp[15] = pend_nl0
    lor, _ = hc.wave_apply_plain((dec >> 2) & 1, leaf_of_row, tp,
                                 num_leaves)
    t = table.clone()
    t[7, K:].fill_(-1)                  # the kernel maps candidates k < K
    new_lor, slot = hc.wave_apply_plain(dec, lor, t, num_leaves)
    hist = hc.build_histogram_slots_plain(X, vals, slot, K, num_bins)
    return new_lor, hist, _scan_plain(hist, parent, scal, fmeta, fmask, hp,
                                      scale)
