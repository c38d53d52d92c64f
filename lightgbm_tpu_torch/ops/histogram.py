"""Histogram, wave and gather dispatch.

Counterpart of lightgbm_tpu/ops/histogram.py. A CUDA tensor goes to the
Hopper kernel (ops/histogram_cuda.py), a CPU tensor to the kernel's plain
PyTorch version; ``plain=True`` asks for the plain version on any device
(chip_smoke.py grows a reference tree with it on the card). There is no
fallback: a kernel that cannot take its inputs raises.

Layouts (channel-major, as in the JAX package):
  X_t   [F, N]      uint8 (uint16 past 256 bins), feature-major
  vals  [C, N]      f32 (gradient / hessian channels) or int8
  hist  [C, F, B] (single set) or [K, C, F, B] (wave of K slots)

Histogram routes (`hist_route`, the counterpart of the JAX package's
`_tier_route`, ops/histogram.py:69): "slots" is one launch of the K-slot
kernel at B = num_bins_padded over all storage columns, for
histogram_impl auto / legacy / tiered / tiered_hilo (the TPU lane-width
layouts of the same sums, which histogram_tiered.py:36-40 states are equal
bit for bit); "rowwise" and "rowwise_packed" build the flat
per-feature-offset buffer (ops/histogram_rowwise.py) and expand it to the
uniform grid. Every route returns the same [K, C, F, B] histogram.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import grow_fused as gf
from . import histogram_cuda as hc
from . import histogram_rowwise as hr
from .split import SplitHyperParams, expand_feature_offset_hist

ROWWISE_IMPLS = ("rowwise", "rowwise_packed")


class HistPlan(NamedTuple):
    """What a row-wise route reads besides the storage: the flat layout
    and, for "rowwise_packed", the nibble plan and the operands `pack4`
    made once from X_t."""
    rplan: hr.RowWisePlan
    pplan: Optional[hr.Pack4Plan] = None
    Xp: Optional[torch.Tensor] = None
    Xu: Optional[torch.Tensor] = None


def hist_route(impl: str, tiers: tuple) -> str:
    """The histogram route of histogram_impl `impl` over storage columns
    of bin counts `tiers`: "rowwise_packed" falls back to "rowwise" when
    fewer than two columns fit a nibble (histogram.py:104-108); without
    per-column bin counts (or past 256 bins) every impl is "slots"."""
    if not tiers or max(tiers) > 256:
        return "slots"
    if impl == "rowwise_packed" and hr.pack4_worthwhile(
            hr.build_pack4_plan(tuple(int(t) for t in tiers))):
        return "rowwise_packed"
    return "rowwise" if impl in ROWWISE_IMPLS else "slots"


def make_hist_plan(X_t: torch.Tensor, route: str,
                   tiers: tuple) -> Optional[HistPlan]:
    """The plan of `route` for storage X_t [F, N] (None for "slots")."""
    if route == "slots":
        return None
    tiers = tuple(int(t) for t in tiers)
    rplan = hr.build_rowwise_plan(tiers)
    if route == "rowwise":
        return HistPlan(rplan)
    pplan = hr.build_pack4_plan(tiers)
    Xp, Xu = hr.pack4(X_t, pplan)
    return HistPlan(rplan, pplan, Xp, Xu)


def _use_kernel(t: torch.Tensor, plain: bool) -> bool:
    return not plain and t.device.type != "cpu"


def build_histogram_slots(X_binned_t: torch.Tensor, vals: torch.Tensor,
                          slot: Optional[torch.Tensor], num_slots: int,
                          num_bins: int, *, impl: str = "slots",
                          plan: Optional[HistPlan] = None,
                          plain: bool = False) -> torch.Tensor:
    """Wave histogram: [K, C, F, B] on every route; rows whose slot is
    outside [0, K) contribute nothing (slot None: every row in slot 0).
    `impl` is a `hist_route`, `plan` its `make_hist_plan`."""
    kern = _use_kernel(X_binned_t, plain)
    if impl == "slots":
        if kern:
            return hc.build_histogram_slots_cuda(X_binned_t, vals, slot,
                                                 num_slots, num_bins)
        return hc.build_histogram_slots_plain(X_binned_t, vals, slot,
                                              num_slots, num_bins)
    rp = plan.rplan
    if impl == "rowwise":
        fn = hr.hist_rowwise_cuda if kern else hr.hist_rowwise_plain
        flat = fn(X_binned_t, vals, slot, num_slots, rp)
    elif impl == "rowwise_packed":
        fn = (hr.hist_rowwise_packed_cuda if kern
              else hr.hist_rowwise_packed_plain)
        flat = fn(plan.Xp, plan.Xu, vals, slot, num_slots, rp, plan.pplan)
    else:
        raise ValueError(f"unknown histogram route {impl!r}")
    return expand_feature_offset_hist(flat, rp.offsets, rp.widths, num_bins)


def build_histogram(X_binned_t: torch.Tensor, vals: torch.Tensor,
                    num_bins: int, *, impl: str = "slots",
                    plan: Optional[HistPlan] = None,
                    plain: bool = False) -> torch.Tensor:
    """Single-set histogram [C, F, B]: the K=1 slot histogram with every
    row active (build_histogram_pallas in the JAX package)."""
    return build_histogram_slots(X_binned_t, vals, None, 1, num_bins,
                                 impl=impl, plan=plan, plain=plain)[0]


def build_histogram_window(X_binned_t: torch.Tensor, vals: torch.Tensor,
                           rows: torch.Tensor, win: torch.Tensor,
                           num_bins: int, *, plain: bool = False
                           ) -> torch.Tensor:
    """[C, F, B] histogram of the rows rows[win[0] .. win[1]) (the compact
    grower's window, `win` [2] int32 on the device): #1 over the window's
    ids, its work following the window."""
    fn = (hc.build_histogram_window_cuda if _use_kernel(X_binned_t, plain)
          else hc.build_histogram_window_plain)
    return fn(X_binned_t, vals, rows, win, num_bins)


def window_partition(X_binned_t: torch.Tensor, order: torch.Tensor,
                     leaf_of_row: torch.Tensor, rec: torch.Tensor, *,
                     plain: bool = False) -> torch.Tensor:
    """The stable partition of one leaf's window of `order` under its split
    record `rec`, in place (the right rows relabelled in leaf_of_row);
    returns the left count, [1] int32 on the device."""
    fn = (hc.window_partition_cuda if _use_kernel(X_binned_t, plain)
          else hc.window_partition_plain)
    return fn(X_binned_t, order, leaf_of_row, rec)


def take_leaf_values(values: torch.Tensor, leaf_of_row: torch.Tensor, *,
                     plain: bool = False) -> torch.Tensor:
    """values[leaf_of_row], exact; out-of-range leaf ids give 0."""
    if _use_kernel(values, plain):
        return hc.take_leaf_values_cuda(values, leaf_of_row)
    return hc.take_leaf_values_plain(values, leaf_of_row)


def add_leaf_values_(scores: torch.Tensor, values: torch.Tensor,
                     leaf_of_row: torch.Tensor, *,
                     plain: bool = False) -> torch.Tensor:
    """The score update, in place: scores += values[leaf_of_row], bitwise
    the f32 add of the gather-then-add; out-of-range leaf ids add 0."""
    if _use_kernel(values, plain):
        return hc.add_leaf_values_cuda(scores, values, leaf_of_row)
    return hc.add_leaf_values_plain(scores, values, leaf_of_row)


def wave_pass(X_binned_t: torch.Tensor, vals: torch.Tensor,
              leaf_of_row: torch.Tensor, table: torch.Tensor, num_slots: int,
              num_bins: int, num_leaves: int, *, plain: bool = False,
              gmap: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused relabel + candidate membership + slot histogram of one wave.
    `gmap`: the booster's hc.new_leaf_map, which the kernels take past
    hc.LEAF_CAP leaves (the same below for every wave)."""
    if _use_kernel(X_binned_t, plain):
        return hc.wave_pass_cuda(X_binned_t, vals, leaf_of_row, table,
                                 num_slots, num_bins, num_leaves, gmap=gmap)
    return hc.wave_pass_plain(X_binned_t, vals, leaf_of_row, table,
                              num_slots, num_bins, num_leaves)


def wave_apply(X_binned_t: torch.Tensor, leaf_of_row: torch.Tensor,
               table: torch.Tensor, cats: Optional[torch.Tensor],
               bundle: Optional[torch.Tensor], num_entries: int,
               num_leaves: int, *, plain: bool = False,
               gmap: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Relabel + candidate slot of one wave of the wide / categorical /
    EFB route, each row decided from the wave's split records."""
    if _use_kernel(X_binned_t, plain):
        return hc.wave_apply_cuda(X_binned_t, leaf_of_row, table, cats,
                                  bundle, num_entries, num_leaves, gmap=gmap)
    return hc.wave_apply_rows_plain(X_binned_t, leaf_of_row, table, cats,
                                    bundle, num_entries, num_leaves)


def wave_relabel(X_binned_t: torch.Tensor, leaf_of_row: torch.Tensor,
                 table: torch.Tensor, num_leaves: int, *,
                 out: Optional[torch.Tensor] = None,
                 plain: bool = False,
                 gmap: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Relabel-only wave (a tree's last wave), into `out` (None: a new
    tensor; leaf_of_row itself: in place)."""
    if _use_kernel(X_binned_t, plain):
        return hc.wave_relabel_cuda(X_binned_t, leaf_of_row, table,
                                    num_leaves, out, gmap=gmap)
    return hc.wave_relabel_plain(X_binned_t, leaf_of_row, table, num_leaves,
                                 out)


def wave_pass_fused(X_binned_t: torch.Tensor, vals: torch.Tensor,
                    leaf_of_row: torch.Tensor, table: torch.Tensor,
                    parent: torch.Tensor, scal: torch.Tensor,
                    fmeta: torch.Tensor, fmask: torch.Tensor, num_slots: int,
                    num_bins: int, num_leaves: int, hp: SplitHyperParams, *,
                    plain: bool = False, gmap: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused wave of the megakernel route: relabel, slot histogram and the
    split records of both children of every candidate."""
    args = (X_binned_t, vals, leaf_of_row, table, parent, scal, fmeta,
            fmask, num_slots, num_bins, num_leaves, hp)
    if _use_kernel(X_binned_t, plain):
        return gf.wave_pass_fused_cuda(*args, gmap=gmap)
    return gf.wave_pass_fused_plain(*args)


def wave_pass_fused_tiled(X_binned_t: torch.Tensor, vals: torch.Tensor,
                          dec: torch.Tensor, leaf_of_row: torch.Tensor,
                          table: torch.Tensor, pend_leaf: torch.Tensor,
                          pend_nl0: torch.Tensor, parent: torch.Tensor,
                          scal: torch.Tensor, fmeta: torch.Tensor,
                          fmask: torch.Tensor, num_slots: int, num_bins: int,
                          num_leaves: int, hp: SplitHyperParams,
                          scale: Optional[torch.Tensor] = None, *,
                          plain: bool = False,
                          gmap: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Fused wave from decision bits (any width, categorical data): the
    pending relabel, this wave's relabel, the slot histogram and the split
    records of both children of every candidate."""
    args = (X_binned_t, vals, dec, leaf_of_row, table, pend_leaf, pend_nl0,
            parent, scal, fmeta, fmask, num_slots, num_bins, num_leaves, hp,
            scale)
    if _use_kernel(X_binned_t, plain):
        return gf.wave_pass_fused_tiled_cuda(*args, gmap=gmap)
    return gf.wave_pass_fused_tiled_plain(*args)
