"""Shared small utilities (reference: include/LightGBM/utils/common.h)."""

import torch


def round_up(x: int, m: int) -> int:
    """Smallest multiple of `m` that is >= `x`."""
    return (x + m - 1) // m * m


def indexable_bins(X: torch.Tensor) -> torch.Tensor:
    """A bin matrix as torch can index it: uint8 as it is, uint16 (past 256
    bins) as its int16 view, since torch has no CUDA indexing of uint16
    tensors. Read what is gathered from it through `bin_values`, or view
    it back with `.view(X.dtype)`."""
    return X.view(torch.int16) if X.dtype == torch.uint16 else X


def bin_values(t: torch.Tensor, dtype=torch.int64) -> torch.Tensor:
    """Bins gathered from `indexable_bins(X)` as `dtype`: an int16 view's
    values back in 0 .. 65535."""
    if t.dtype == torch.int16:
        return t.to(dtype) & 0xFFFF
    return t.to(dtype)


def resolve_device(device_type: str) -> torch.device:
    """The torch device of `device_type` ("cuda": the current CUDA device,
    and an error when there is none; "cpu")."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"unknown device_type {device_type!r} "
                         "(supported: 'cuda', 'cpu')")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device_type='cuda' but torch finds no CUDA device; pass "
            "device_type='cpu' to run the port on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
