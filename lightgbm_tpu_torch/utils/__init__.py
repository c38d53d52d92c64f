"""Shared small utilities (reference: include/LightGBM/utils/common.h)."""

import torch


def round_up(x: int, m: int) -> int:
    """Smallest multiple of `m` that is >= `x`."""
    return (x + m - 1) // m * m


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
