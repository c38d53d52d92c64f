#!/usr/bin/env python3
"""Where one training iteration of the PyTorch/CUDA port spends its time.

    python3 scripts/profile_torch_port.py [--rows N] [--iters K] [--trace F]

Trains bench.py's model (binary, 255 leaves, max_bin 63, 28 features,
numpy seed 42) with lightgbm_tpu_torch on the first CUDA device and prints
JSON lines:

  steady     wall ms per iteration over K iterations after two warm-up
             iterations (host clock around work that ends in a synchronize)
  profile    torch.profiler over K iterations: device-busy ms per iteration
             (the sum of GPU kernel and memcpy/memset times: one stream, so
             they do not overlap), the device idle share, GPU launches per
             iteration, and the top device-time entries by name
  stages     a second pass with the grower's stages wrapped in synchronized
             host timers (so the stages do not overlap, and the iteration
             runs a little slower than in `steady`): ms per iteration in the
             root histogram, the wave kernels, the split search, the
             objective, the score update, and everything else

`--trace F` writes the chrome trace of the profiled window to F. Exits 2
without a CUDA device.
"""

import argparse
import json
import os
import sys
import time
from collections import defaultdict

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def emit(obj):
    print(json.dumps(obj), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--trace", help="write the profiled window's chrome "
                    "trace to this file")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_port: torch finds no CUDA device",
              file=sys.stderr)
        return 2
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.models import gbdt as gbdt_mod
    from lightgbm_tpu_torch.ops import grow_wave

    rng = np.random.RandomState(42)
    X = rng.normal(size=(args.rows, 28)).astype(np.float32)
    w = rng.normal(size=28)
    y = (X @ w + rng.normal(scale=0.5, size=args.rows) > 0) \
        .astype(np.float32)
    params = dict(objective="binary", num_leaves=255, max_bin=63,
                  learning_rate=0.1, min_data_in_leaf=20, verbose=-1,
                  bagging_freq=0, binning_impl="host", device_type="cuda")
    bst = lt.Booster(params, lt.Dataset(X, label=y, params=params))
    for _ in range(2):
        bst.update()
    torch.cuda.synchronize()

    # ---- steady wall time
    t0 = time.perf_counter()
    for _ in range(args.iters):
        bst.update()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters
    emit({"phase": "steady", "rows": args.rows, "iters": args.iters,
          "wall_ms_per_iter": wall_ms,
          "device": torch.cuda.get_device_name(0)})

    # ---- profiler window
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            bst.update()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters
    dev_by_name = defaultdict(float)
    n_dev = defaultdict(int)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev_by_name[ev.name] += ev.time_range.elapsed_us() / 1e3
            n_dev[ev.name] += 1
    busy_ms = sum(dev_by_name.values()) / args.iters
    top = sorted(dev_by_name.items(), key=lambda kv: -kv[1])[:15]
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)
    emit({"phase": "profile", "wall_ms_per_iter": prof_wall_ms,
          "device_busy_ms_per_iter": busy_ms,
          "device_idle_share": 1.0 - busy_ms / prof_wall_ms,
          "gpu_ops_per_iter": sum(n_dev.values()) / args.iters,
          "top_device_ms_per_iter": [
              {"name": k[:80], "ms": v / args.iters,
               "count": n_dev[k] / args.iters} for k, v in top]})

    # ---- stage decomposition (synchronized host timers)
    spent = defaultdict(float)

    def timed(stage, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[stage] += time.perf_counter() - t
            return out
        return run

    patches = [(grow_wave, "build_histogram", "root histogram"),
               (grow_wave, "wave_pass", "wave_pass kernel"),
               (grow_wave, "wave_relabel", "wave_relabel kernel"),
               (grow_wave, "find_best_split", "split search"),
               (gbdt_mod, "take_leaf_values", "score update")]
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    obj = bst._gbdt.objective
    saved_grad = obj.get_gradients
    try:
        for m, n, stage in patches:
            setattr(m, n, timed(stage, getattr(m, n)))
        obj.get_gradients = timed("objective", saved_grad)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            bst.update()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
        obj.get_gradients = saved_grad
    stages = {k: v * 1e3 / args.iters for k, v in spent.items()}
    stages["other (wave bookkeeping, host syncs, tree records)"] = \
        (total - sum(spent.values())) * 1e3 / args.iters
    emit({"phase": "stages", "wall_ms_per_iter": total * 1e3 / args.iters,
          "ms_per_iter": stages})
    return 0


if __name__ == "__main__":
    sys.exit(main())
