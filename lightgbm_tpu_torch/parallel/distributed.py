"""Multi-process bring-up.

Counterpart of lightgbm_tpu/parallel/distributed.py. The reference builds a
TCP mesh from a `machines` list (src/network/linkers_socket.cpp:26) or uses
MPI; the JAX package hands its processes to `jax.distributed.initialize`.
The port joins its ranks with `torch.distributed.init_process_group` over a
TCP rendezvous at the coordinator, keeping the reference's API shape
(machines / num_machines, Config fields of the same names, python-package
basic.py:3531-3563) and the JAX launcher's environment
(LIGHTGBM_TPU_RANK / LIGHTGBM_TPU_NPROC / LIGHTGBM_TPU_COORDINATOR,
launch.py).

The backend is gloo when the ranks train on the CPU or share a card (more
ranks than this host's cards, e.g. W ranks on one H100), NCCL only when
every rank has a card of its own; NCCL refuses two ranks on one device.
An NCCL group is "cpu:gloo,cuda:nccl": CUDA tensors cross by NCCL, and a
host tensor handed to a collective by gloo rather than failing.
The group's timeout is the config's `time_out` (seconds, as the
reference's): a dead peer surfaces on the survivors as an error within it,
never as a hang.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

from ..utils.log import log_fatal, log_info

_initialized = False


def pick_backend(num_machines: int, device_type: str) -> str:
    """"cpu:gloo,cuda:nccl" when every rank of this host gets a card of its
    own, else "gloo" (the CPU, or ranks sharing a card)."""
    if device_type == "cuda" and torch.cuda.is_available() \
            and torch.distributed.is_nccl_available() \
            and torch.cuda.device_count() >= int(num_machines):
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def init_distributed(machines: str = "",
                     num_machines: int = 1,
                     machine_rank: Optional[int] = None,
                     coordinator_address: Optional[str] = None,
                     device_type: str = "cuda",
                     time_out: int = 120) -> None:
    """Join the process group (reference: Network::Init, network.cpp:34).

    `machines` is the reference-style comma-separated "ip:port,ip:port,..."
    list; its first entry becomes the coordinator. Alternatively pass
    `coordinator_address` directly. No-op for num_machines <= 1 or when the
    group is already initialized (e.g. by an earlier Booster). On
    device_type "cuda" the rank's current device becomes
    `cuda:(rank % device_count)`."""
    global _initialized
    dist = torch.distributed
    if _initialized or num_machines <= 1 and not machines:
        return
    if coordinator_address is None and machines:
        entries = [m.strip() for m in machines.split(",") if m.strip()]
        num_machines = max(num_machines, len(entries))
        coordinator_address = entries[0]
    if coordinator_address is None:
        # launcher-provided environment (lightgbm_tpu_torch.launch)
        coordinator_address = os.environ.get("LIGHTGBM_TPU_COORDINATOR")
    env_n = os.environ.get("LIGHTGBM_TPU_NPROC")
    if env_n:
        num_machines = max(num_machines, int(env_n))
    if num_machines <= 1:
        return
    if machine_rank is None:
        rank_env = os.environ.get("LIGHTGBM_TPU_RANK")
        if rank_env is None:
            # defaulting every host to rank 0 would deadlock the rendezvous
            # (all processes claiming rank 0); the reference fatals on
            # network-init failure (linkers_socket.cpp bind/connect)
            log_fatal(
                "num_machines > 1 but no machine rank given: set the "
                "LIGHTGBM_TPU_RANK env var (0..num_machines-1) or pass "
                "machine_rank")
        machine_rank = int(rank_env)
    if coordinator_address is None:
        log_fatal("num_machines > 1 but no coordinator: pass machines= or "
                  "set LIGHTGBM_TPU_COORDINATOR (host:port)")
    if device_type == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(machine_rank % torch.cuda.device_count())
    if dist.is_initialized():
        # benign: the caller (or an earlier Booster) joined the group
        _initialized = True
        log_info("torch.distributed already initialized: rank "
                 f"{dist.get_rank()}/{dist.get_world_size()}")
        return
    backend = pick_backend(num_machines, device_type)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_machines), rank=int(machine_rank),
        timeout=datetime.timedelta(seconds=max(int(time_out), 1)))
    _initialized = True
    log_info(f"Distributed init: rank {machine_rank}/{num_machines} "
             f"coordinator {coordinator_address}; backend {backend}")
