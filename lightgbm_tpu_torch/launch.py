"""Multi-process training launcher — the dask.py analog.

Counterpart of lightgbm_tpu/launch.py. The reference's Dask integration
(python-package/lightgbm/dask.py:196-260) finds open ports, builds the
`machines` list and runs `_train_part` once per worker. Here the launcher
spawns N worker processes that join one torch.distributed group, and each
worker's `lt.train(params, ...)` with `num_machines=N` and a distributed
`tree_learner` joins it (parallel/distributed.py reads the launcher's
environment):

    python -m lightgbm_tpu_torch.launch -n 4 -- python train_rank.py

Each worker gets LIGHTGBM_TPU_RANK / LIGHTGBM_TPU_NPROC /
LIGHTGBM_TPU_COORDINATOR. Rank r trains on `cuda:(r % device_count)`
(several ranks share a card when there are fewer cards, over gloo) or, with
device_type=cpu, on the CPU. Every rank produces the identical model (the
data-parallel invariant). On several hosts, start one process per rank
yourself with the same three variables, or pass `machines=` in params.

With pre_partition=true each rank loads only its own rows and its
per-iteration metrics are computed on them (the reference syncs rank sums
for exact global metrics); evaluate the saved model globally for exact
numbers.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
from typing import List, Optional, Sequence


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch_local(num_machines: int, argv: Sequence[str],
                 coordinator_port: Optional[int] = None,
                 env_extra: Optional[dict] = None,
                 timeout: Optional[float] = None) -> List[int]:
    """Spawn `num_machines` copies of `argv` as one process group on this
    machine. Returns the exit codes; raises RuntimeError when a worker
    failed (the survivors are killed at once: they would block in a
    collective waiting for it) or when `timeout` seconds pass first."""
    port = coordinator_port or _free_port()
    procs = []
    for rank in range(num_machines):
        env = dict(os.environ)
        env.update(env_extra or {})
        env["LIGHTGBM_TPU_RANK"] = str(rank)
        env["LIGHTGBM_TPU_NPROC"] = str(num_machines)
        env["LIGHTGBM_TPU_COORDINATOR"] = f"127.0.0.1:{port}"
        procs.append(subprocess.Popen(list(argv), env=env))
    deadline = time.monotonic() + timeout if timeout else None
    try:
        # poll ALL workers: one crashed rank must bring the group down
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (0, None) for c in codes):
                break
            if all(c == 0 for c in codes):
                break
            if deadline and time.monotonic() > deadline:
                raise RuntimeError("launch_local timed out; worker "
                                   f"states: {codes}")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        codes = [p.wait() for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"worker exit codes: {codes}")
    return codes


def main() -> None:
    ap = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.launch",
        description="Run a training script as N coordinated processes")
    ap.add_argument("-n", "--num-machines", type=int, required=True)
    ap.add_argument("--port", type=int, default=None,
                    help="coordinator port (default: auto)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="command to run, e.g. -- python train.py")
    args = ap.parse_args()
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given")
    try:
        launch_local(args.num_machines, cmd, coordinator_port=args.port)
    except RuntimeError as e:
        print(f"lightgbm_tpu_torch.launch: {e}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
