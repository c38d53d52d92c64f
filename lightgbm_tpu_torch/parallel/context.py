"""Distributed context: the collectives of multi-device training over the
default `torch.distributed` process group.

Counterpart of lightgbm_tpu/parallel/context.py (the reference's Network
layer, include/LightGBM/network.h:90). The JAX package shards one
process's arrays over a `jax.sharding.Mesh` and its collectives are XLA's
inside `shard_map`; the port runs one process per rank (PyTorch's idiom),
so its "mesh" is the process group: rank r of W owns a contiguous block of
rows and runs on `cuda:(r % device_count)`, or on the CPU.

Every float sum is taken in rank order, ((x_0 + x_1) + x_2) + ..., on
every rank and by both histogram exchanges: `psum` is an all-to-all of
W chunks, each rank summing its chunk in rank order, then an all-gather
of the sums (the ring allreduce's 2 (W - 1) / W of the buffer on the
wire); `psum_scatter` is the same all-to-all over the scattered axis
without the all-gather ((W - 1) / W). So every rank holds the same bits,
and `allreduce` and `reduce_scatter` grow the same trees, whatever order
the backend's own reductions would take. Max / min are exact and use the
backend's all-reduce.

Collectives take tensors on the rank's device and return tensors there;
every buffer a collective allocates lies on its input's device (or on the
host buffer it was staged to). The gloo backend moves CUDA tensors through
host buffers here and nowhere else (copy down, run the collective, copy
up): gloo's own CUDA support is partial. Under NCCL (every rank with a
card of its own; the group is "cpu:gloo,cuda:nccl", parallel/
distributed.py) the tensors stay on the card. `DistContext.device` is
where a caller that starts from host data (data/dist_binning.py) puts it.

`psum` is the exchange that `parallel_hist_mode=allreduce` names, and in
this module it is `psum_scatter`'s all-to-all plus an all-gather, so it
always moves more than `psum_scatter`: the wave grower's allreduce, which
then keeps only the rank's feature slice (as the JAX package's does,
grow_wave.py:1727-1736), is reduce_scatter's exchange plus that
all-gather. The two modes also merge the per-leaf bests differently
(ops/grow_wave.py `_DistHooks.merge`).

`comm_seconds` / `comm_bytes` / `comm_calls` add up the wall time (host
staging included), the bytes this rank sends and the calls of every
collective, the span that `models/gbdt.py` reports as the exchange's share
of a round.
"""

from __future__ import annotations

import time
import warnings
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as tdist

DATA_AXIS = "data"
FEATURE_AXIS = "feature"


def world() -> "Layout":
    """This process's place in the default group: (world size, rank);
    (1, 0) when no group is initialized."""
    if tdist.is_available() and tdist.is_initialized():
        return Layout(tdist.get_world_size(), tdist.get_rank(), None)
    return Layout(1, 0, None)


class Layout(NamedTuple):
    """The rank layout of `make_data_mesh`: the group's size, this rank,
    and the torch device the rank runs on."""
    size: int
    rank: int
    device: Optional[torch.device]


def make_data_mesh(num_devices: int = 0,
                   devices: Optional[Sequence] = None,
                   device_type: str = "cuda") -> Layout:
    """The 1-D data layout of the group (rows sharded, model replicated;
    the reference's tree_learner=data, SURVEY.md §3.4): (world size, rank,
    device). The device is `devices[rank]` when a list is given, else
    `cuda:(rank % device_count)` for device_type "cuda", or the CPU.
    `num_devices`, when given, must equal the group's size."""
    size, rank, _ = world()
    if num_devices and num_devices != size:
        raise ValueError(f"make_data_mesh: {num_devices} devices asked, the "
                         f"process group has {size} ranks")
    if devices is not None:
        dev = torch.device(devices[rank % len(devices)])
    elif device_type == "cuda" and torch.cuda.is_available():
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    else:
        dev = torch.device("cpu")
    return Layout(size, rank, dev)


def _gather_into(out: torch.Tensor, x: torch.Tensor) -> None:
    fn = getattr(tdist, "all_gather_single", None)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        if fn is not None:
            fn(out, x)
        else:
            tdist.all_gather_into_tensor(out, x)


class DistContext:
    """The collectives of one process group (network.h analogues). A rank's
    methods must be called by every rank in the same order, with tensors of
    the same shape and dtype, as the reference's Network calls are."""

    def __init__(self, axis_name: str = DATA_AXIS):
        if not (tdist.is_available() and tdist.is_initialized()):
            raise RuntimeError("DistContext needs an initialized "
                               "torch.distributed process group "
                               "(parallel.init_distributed)")
        self.axis_name = axis_name
        self.size = tdist.get_world_size()
        self.rank = tdist.get_rank()
        self.backend = str(tdist.get_backend())
        # gloo takes host tensors only, as far as this module relies on it;
        # a group with NCCL in it takes CUDA tensors there and host ones
        # through its gloo half
        self.staged = "nccl" not in self.backend
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if not self.staged else torch.device("cpu"))
        self.comm_seconds = 0.0
        self.comm_bytes = 0
        self.comm_calls = 0

    # -- plumbing ----------------------------------------------------------
    def _down(self, x: torch.Tensor) -> torch.Tensor:
        x = x.detach()
        if x.dtype == torch.bool:
            x = x.to(torch.int32)
        if self.staged and x.device.type != "cpu":
            x = x.to("cpu")
        return x.contiguous()

    def _up(self, y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if like.dtype == torch.bool:
            y = y != 0
        return y.to(like.device)

    def _account(self, t0: float, sent: int) -> None:
        self.comm_seconds += time.perf_counter() - t0
        self.comm_bytes += int(sent)
        self.comm_calls += 1

    def _ordered_chunk_sums(self, flat: torch.Tensor) -> torch.Tensor:
        """[W * c] -> this rank's chunk [c] summed over ranks in rank
        order (one all-to-all)."""
        W = self.size
        recv = torch.empty_like(flat)
        tdist.all_to_all_single(recv, flat)
        parts = recv.reshape(W, -1)
        acc = parts[0].clone()
        for r in range(1, W):
            acc += parts[r]
        return acc

    # -- Network::Allreduce(SUM) analog (network.h:117) -------------------
    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks, in rank order, on every rank."""
        t0 = time.perf_counter()
        W = self.size
        h = self._down(x)
        n = h.numel()
        if n == 0:
            return x.clone()
        c = -(-n // W)
        flat = h.new_zeros(W * c)
        flat[:n] = h.reshape(-1)
        mine = self._ordered_chunk_sums(flat)
        out = torch.empty_like(flat)
        _gather_into(out, mine)
        y = out[:n].reshape(h.shape)
        self._account(t0, 2 * (W - 1) * c * h.element_size())
        return self._up(y, x)

    # -- Network::GlobalSyncUpByMax / Min / Mean (network.h:170-241) ------
    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        t0 = time.perf_counter()
        h = self._down(x).clone()
        tdist.all_reduce(h, op)
        self._account(t0, 2 * h.numel() * h.element_size())
        return self._up(h, x)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, tdist.ReduceOp.MAX)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, tdist.ReduceOp.MIN)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        return self.psum(x) / self.size

    # -- Network::Allgather (network.h:139) -------------------------------
    def all_gather(self, x: torch.Tensor, axis: int = 0,
                   tiled: bool = True) -> torch.Tensor:
        """Every rank's `x`, in rank order: concatenated along `axis`
        (`tiled`) or stacked as a new axis `axis`."""
        t0 = time.perf_counter()
        W = self.size
        h = self._down(x)
        out = h.new_empty((W,) + tuple(h.shape))
        _gather_into(out.reshape(-1), h.reshape(-1))
        self._account(t0, (W - 1) * h.numel() * h.element_size())
        if tiled:
            y = torch.cat(list(out.unbind(0)), dim=axis) if h.dim() \
                else out
        else:
            y = out.movedim(0, axis)
        return self._up(y, x)

    # -- Network::ReduceScatter (network.h:165) ---------------------------
    def psum_scatter(self, x: torch.Tensor, axis: int = 0,
                     tiled: bool = True) -> torch.Tensor:
        """This rank's slice of the sum over ranks along `axis` (whose
        length the group size divides), summed in rank order: rank r
        receives [r * n / W, (r + 1) * n / W). `tiled=False` drops the
        scattered axis (its length must then be W)."""
        t0 = time.perf_counter()
        W = self.size
        h = self._down(x)
        n = h.shape[axis]
        if n % W:
            raise ValueError(f"psum_scatter: axis {axis} of length {n} does "
                             f"not split over {W} ranks")
        moved = h.movedim(axis, 0).contiguous()
        mine = self._ordered_chunk_sums(moved.reshape(-1))
        y = mine.reshape((n // W,) + tuple(moved.shape[1:])).movedim(0, axis)
        self._account(t0, (W - 1) * mine.numel() * h.element_size())
        if not tiled:
            y = y.squeeze(axis)
        return self._up(y, x)

    def axis_index(self) -> int:
        return self.rank

    def axis_size(self) -> int:
        return self.size
