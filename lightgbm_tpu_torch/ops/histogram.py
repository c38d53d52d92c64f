"""Histogram, wave and gather dispatch.

Counterpart of lightgbm_tpu/ops/histogram.py. A CUDA tensor goes to the
Hopper kernel (ops/histogram_cuda.py), a CPU tensor to the kernel's plain
PyTorch version; ``plain=True`` asks for the plain version on any device
(chip_smoke.py grows a reference tree with it on the card). There is no
fallback: a kernel that cannot take its inputs raises.

Layouts (channel-major, as in the JAX package):
  X_t   [F, N]      uint8, feature-major
  vals  [C, N]      f32 (gradient / hessian channels) or int8
  hist  [C, F, B] (single set) or [K, C, F, B] (wave of K slots)
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import histogram_cuda as hc


def _use_kernel(t: torch.Tensor, plain: bool) -> bool:
    return not plain and t.device.type != "cpu"


def build_histogram_slots(X_binned_t: torch.Tensor, vals: torch.Tensor,
                          slot: Optional[torch.Tensor], num_slots: int,
                          num_bins: int, *, plain: bool = False
                          ) -> torch.Tensor:
    """Wave histogram: [K, C, F, B]; rows whose slot is outside [0, K)
    contribute nothing (slot None: every row in slot 0)."""
    if _use_kernel(X_binned_t, plain):
        return hc.build_histogram_slots_cuda(X_binned_t, vals, slot,
                                             num_slots, num_bins)
    return hc.build_histogram_slots_plain(X_binned_t, vals, slot, num_slots,
                                          num_bins)


def build_histogram(X_binned_t: torch.Tensor, vals: torch.Tensor,
                    num_bins: int, *, plain: bool = False) -> torch.Tensor:
    """Single-set histogram [C, F, B]: the K=1 slot histogram with every
    row active (build_histogram_pallas in the JAX package)."""
    return build_histogram_slots(X_binned_t, vals, None, 1, num_bins,
                                 plain=plain)[0]


def take_leaf_values(values: torch.Tensor, leaf_of_row: torch.Tensor, *,
                     plain: bool = False) -> torch.Tensor:
    """values[leaf_of_row], exact; out-of-range leaf ids give 0."""
    if _use_kernel(values, plain):
        return hc.take_leaf_values_cuda(values, leaf_of_row)
    return hc.take_leaf_values_plain(values, leaf_of_row)


def wave_pass(X_binned_t: torch.Tensor, vals: torch.Tensor,
              leaf_of_row: torch.Tensor, table: torch.Tensor, num_slots: int,
              num_bins: int, num_leaves: int, *, plain: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused relabel + candidate membership + slot histogram of one wave."""
    if _use_kernel(X_binned_t, plain):
        return hc.wave_pass_cuda(X_binned_t, vals, leaf_of_row, table,
                                 num_slots, num_bins, num_leaves)
    return hc.wave_pass_plain(X_binned_t, vals, leaf_of_row, table,
                              num_slots, num_bins, num_leaves)


def wave_relabel(X_binned_t: torch.Tensor, leaf_of_row: torch.Tensor,
                 table: torch.Tensor, num_leaves: int, *,
                 plain: bool = False) -> torch.Tensor:
    """Relabel-only wave (a tree's last wave)."""
    if _use_kernel(X_binned_t, plain):
        return hc.wave_relabel_cuda(X_binned_t, leaf_of_row, table,
                                    num_leaves)
    return hc.wave_relabel_plain(X_binned_t, leaf_of_row, table, num_leaves)
