#!/usr/bin/env python3
"""The port's multi-device training over NCCL, held to the same group over
gloo: one rank a card, W = every card of the host (at least 2).

    python3 scripts/torch_nccl_check.py [--rows N] [--timeout S]

Builds the port's kernels once, then launches W rank processes
(lightgbm_tpu_torch.launch.launch_local) twice: first the group that
`init_distributed` picks when every rank has a card of its own
("cpu:gloo,cuda:nccl"), then the same ranks on the same cards in a gloo
group (host-staged). Each rank trains bench.py's model (binary, 255 leaves,
max_bin 63) on N rows x 28 f32 features (numpy seed 42) for two rounds in
every configuration: data-parallel under allreduce, under reduce_scatter
and quantized under reduce_scatter, voting (top_k 20), feature-parallel,
pre_partition (each rank its N / W rows), and reduce_scatter with
`fail_collective` planted in rank 1's parameters only.

The port sums every float in rank order whatever the backend
(parallel/context.py), so the script requires: within a group every
rank's model text (without its parameter lines) md5-equal; allreduce and
reduce_scatter md5-equal; the one-rank fault degrading every rank to
allreduce, md5-equal to reduce_scatter; each run's model md5-equal under
NCCL and under gloo; the NCCL group unstaged, with a collective's output
on the rank's card. It prints one JSON object a group (per-round ms,
the exchange's seconds, the card's name and power limit) and a last line
{"ok": true|false, ...}; it exits 1 when a check fails.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
N_FEAT = 28
ROUNDS = 2
RUNS = ("allreduce", "reduce_scatter", "quantized_reduce_scatter", "voting",
        "feature", "pre_partition", "fault_one_rank")


def _md5_trees(bst) -> str:
    text = "\n".join(ln for ln in bst.model_to_string().splitlines()
                     if not ln.startswith("["))
    return hashlib.md5(text.encode()).hexdigest()


def rank_main(spec_path: str) -> int:
    """One rank: join the group of the spec's backend, train every
    configuration, write rank<r>.json into the spec's directory."""
    import datetime
    import torch
    import torch.distributed as tdist
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    from lightgbm_tpu_torch.parallel import DistContext, init_distributed
    with open(spec_path) as f:
        spec = json.load(f)
    rank = int(os.environ["LIGHTGBM_TPU_RANK"])
    W = int(os.environ["LIGHTGBM_TPU_NPROC"])
    torch.set_num_threads(2)
    if spec["backend"] == "gloo":
        # the group is made here; the boosters' init_distributed finds it
        torch.cuda.set_device(rank % torch.cuda.device_count())
        tdist.init_process_group(
            "gloo", init_method="tcp://"
            + os.environ["LIGHTGBM_TPU_COORDINATOR"], world_size=W,
            rank=rank, timeout=datetime.timedelta(seconds=60))
    else:
        init_distributed(num_machines=W, device_type="cuda", time_out=60)
    ctx = DistContext()
    dev = torch.device("cuda", torch.cuda.current_device())
    probe = ctx.psum(torch.full((5,), float(rank + 1), device=dev))
    out = {"rank": rank, "backend": ctx.backend, "staged": ctx.staged,
           "device": str(dev), "psum_device": str(probe.device),
           "psum": probe.tolist()}
    n = int(spec["rows"])
    rng = np.random.RandomState(42)
    X = rng.normal(size=(n, N_FEAT)).astype(np.float32)
    w = rng.normal(size=N_FEAT)
    y = (X @ w + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    base = dict(objective="binary", num_leaves=255, max_bin=63,
                learning_rate=0.1, metric="auc", verbose=-1,
                device_type="cuda", num_machines=W, tree_learner="data",
                time_out=60, autotune_cache=spec["cache"])
    ds = lt.Dataset(X, label=y, params=base)
    half = n // W
    dpp = lt.Dataset(X[rank * half:(rank + 1) * half],
                     label=y[rank * half:(rank + 1) * half],
                     params={**base, "pre_partition": True})
    overs = {
        "allreduce": {"parallel_hist_mode": "allreduce"},
        "reduce_scatter": {"parallel_hist_mode": "reduce_scatter"},
        "quantized_reduce_scatter": {"parallel_hist_mode": "reduce_scatter",
                                     "use_quantized_grad": True},
        "voting": {"tree_learner": "voting", "top_k": 20},
        "feature": {"tree_learner": "feature"},
        "pre_partition": {"pre_partition": True},
        "fault_one_rank": {
            "parallel_hist_mode": "reduce_scatter",
            "fault_plan": "fail_collective@iter=0:times=2" if rank == 1
            else ""},
    }
    runs = {}
    for name in RUNS:
        ends = []

        def stamp(env):
            torch.cuda.synchronize()
            ends.append(time.perf_counter())
        torch.cuda.synchronize()
        hc.reset_launch_counts()
        t0 = time.perf_counter()
        bst = lt.train({**base, **overs[name]},
                       dpp if name == "pre_partition" else ds, ROUNDS,
                       callbacks=[stamp])
        g = bst._gbdt
        runs[name] = {
            "md5": _md5_trees(bst),
            "ms_per_round": [(b - a) * 1e3
                             for a, b in zip([t0] + ends[:-1], ends)],
            "comm_s": g.dist.comm_seconds, "comm_calls": g.dist.comm_calls,
            "mode": g.grow_cfg.parallel_hist_mode, "route": g.grow_route,
            "collective_failures": g._collective_failures,
            "train_auc": float(bst.eval_train()[0][2]),
            "launches": dict(hc.LAUNCHES)}
        del bst, g
    out["runs"] = runs
    with open(os.path.join(spec["dir"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _group(d: str, backend: str, W: int, rows: int, timeout: float):
    from lightgbm_tpu_torch.launch import launch_local
    sub = os.path.join(d, backend)
    os.makedirs(sub)
    spec = os.path.join(sub, "spec.json")
    with open(spec, "w") as f:
        json.dump({"backend": backend, "dir": sub, "rows": rows,
                   "cache": os.path.join(sub, "autotune.json")}, f)
    t0 = time.perf_counter()
    launch_local(W, [sys.executable, os.path.abspath(__file__), "--rank",
                     spec],
                 env_extra={"PYTHONPATH": HERE,
                            "LIGHTGBM_TPU_FAULT_PLAN": ""},
                 timeout=timeout)
    res = [json.load(open(os.path.join(sub, f"rank{r}.json")))
           for r in range(W)]
    return res, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rows", type=int, default=1 << 18)
    ap.add_argument("--timeout", type=float, default=600)
    a = ap.parse_args()
    if a.rank is not None:
        return rank_main(a.rank)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("needs two or more CUDA devices", file=sys.stderr)
        return 2
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    W = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    t0 = time.perf_counter()
    hc.build_kernels()
    build_s = time.perf_counter() - t0
    fails = []
    out = {}
    with tempfile.TemporaryDirectory(prefix="lgbt_nccl_") as d:
        for backend in ("nccl", "gloo"):
            res, secs = _group(d, backend, W, a.rows, a.timeout)
            r0 = res[0]
            summ = {"group": backend, "ranks": W, "rows": a.rows,
                    "nvidia_smi": smi, "seconds": secs,
                    "backend": r0["backend"], "staged": r0["staged"],
                    "psum_device": [r["psum_device"] for r in res],
                    "runs": {}}
            want = [float(W * (W + 1) // 2)] * 5
            if any(r["psum"] != want for r in res):
                fails.append(f"{backend}: psum {r0['psum']} != {want}")
            for name in RUNS:
                md5s = {r["runs"][name]["md5"] for r in res}
                if len(md5s) != 1:
                    fails.append(f"{backend} {name}: ranks differ")
                rr = r0["runs"][name]
                summ["runs"][name] = {
                    k: rr[k] for k in ("md5", "ms_per_round", "comm_s",
                                       "comm_calls", "mode", "route",
                                       "train_auc")}
                summ["runs"][name]["collective_failures"] = [
                    r["runs"][name]["collective_failures"] for r in res]
                summ["runs"][name]["launches_rank0"] = rr["launches"]
            runs = r0["runs"]
            if runs["allreduce"]["md5"] != runs["reduce_scatter"]["md5"]:
                fails.append(f"{backend}: allreduce != reduce_scatter")
            fo = summ["runs"]["fault_one_rank"]
            if fo["md5"] != runs["reduce_scatter"]["md5"] \
                    or fo["mode"] != "allreduce" \
                    or fo["collective_failures"] != [2] * W:
                fails.append(f"{backend}: the one-rank fault {fo}")
            for name in ("allreduce", "voting", "pre_partition"):
                if runs[name]["launches"].get("wave_pass", 0) == 0:
                    fails.append(f"{backend} {name}: no wave_pass launch")
            out[backend] = summ
            print(json.dumps(summ), flush=True)
    nc = out["nccl"]
    if "nccl" not in nc["backend"] or nc["staged"] \
            or not all(p.startswith("cuda") for p in nc["psum_device"]):
        fails.append(f"the NCCL group: backend {nc['backend']} staged "
                     f"{nc['staged']} outputs {nc['psum_device']}")
    if not out["gloo"]["staged"]:
        fails.append("the gloo group is not host-staged")
    for name in RUNS:
        if nc["runs"][name]["md5"] != out["gloo"]["runs"][name]["md5"]:
            fails.append(f"{name}: NCCL and gloo grew different models")
    print(json.dumps({"ok": not fails, "fails": fails, "ranks": W,
                      "build_s": build_s}))
    return 0 if not fails else 1


if __name__ == "__main__":
    sys.exit(main())
