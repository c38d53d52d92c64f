#!/usr/bin/env python3
"""The port's iteration sum, torch.sum against the pairwise tree, on the
card.

    python3 scripts/sum_iterations_ab.py [--rows N] [--rounds R] [--reps K]

Every engine of lightgbm_tpu_torch sums a row's leaf values over the
iterations with ``ops/predict.py:sum_leaf_values``. It once reduced with
``torch.sum(dim=1)`` ("sum"); it now calls ``sum_iterations``, a pairwise
tree of elementwise adds ("tree"), whose bits do not depend on the batch
or on a padded tail of iterations. This script builds bench.py's data (28
f32 features, numpy seed 42, N rows), trains bench.py's model (binary,
255 leaves, max_bin 63) for R rounds on the first CUDA device, and times
each variant, patched into ``ops/predict.py`` and ``ops/predict_binned.py``
in turn, in the order sum, tree, tree, sum, K times each:

  walk_rows     ops/predict.py predict_margin_packed (the device
                engine's walk: gather, leaf values, sum) of the N rows on
                the card, CUDA-event ms
  serve         ServingSession(engine="binned").score_margin of 256 f32
                rows (one chunk: #6, the binned walk, the sum), host ms
  serve_device  the same through engine="device", host ms
  reduce_rows   the sum alone of [N, R] leaf values, CUDA-event ms
  reduce_256    the same of [256, R], CUDA-event ms

Booster.predict's device predictor (models/predictor.py
predict_margin_device) adds the trees one at a time and calls neither.

It prints one JSON line with the card's name and power limit and the
median of each, and writes it to chiprun_out/sum_iterations_ab.json.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import lightgbm_tpu_torch as lt  # noqa: E402
from lightgbm_tpu_torch.ops import predict as P  # noqa: E402
from lightgbm_tpu_torch.ops import predict_binned as PB  # noqa: E402
from lightgbm_tpu_torch.ops.predict_binned import mappers_for  # noqa: E402
from lightgbm_tpu_torch.serving import ServingSession  # noqa: E402


def sum_by_torch_sum(lv, K):
    n, T = lv.shape
    return lv.reshape(n, T // K, K).sum(dim=1).t()


VARIANTS = {"sum": sum_by_torch_sum, "tree": P.sum_leaf_values}


def use(variant):
    P.sum_leaf_values = PB.sum_leaf_values = VARIANTS[variant]


def host_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def event_ms(fn, reps=20):
    fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()
    rng = np.random.RandomState(42)
    X = rng.normal(size=(args.rows, 28)).astype(np.float32)
    w = rng.normal(size=28)
    y = (X @ w + rng.normal(scale=0.5, size=args.rows) > 0) \
        .astype(np.float32)
    params = dict(objective="binary", num_leaves=255, max_bin=63,
                  learning_rate=0.1, min_data_in_leaf=20, verbose=-1,
                  device_type="cuda")
    bst = lt.train(params, lt.Dataset(X, label=y, params=params),
                   num_boost_round=args.rounds)
    mappers = mappers_for(bst._gbdt)
    sess = ServingSession(bst._gbdt, engine="binned", max_batch=256,
                          binning_impl="device", bin_mappers=mappers)
    sdev = ServingSession(bst._gbdt, engine="device", max_batch=256)
    pa = sdev._pa
    Xd = torch.from_numpy(X).cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    lv_rows = torch.randn((args.rows, args.rounds), generator=g,
                          device="cuda")
    lv_256 = lv_rows[:256].contiguous()
    Xs = X[:256]
    got = {}
    names = ("walk_rows", "serve", "serve_device", "reduce_rows",
             "reduce_256")
    times = {v: {k: [] for k in names} for v in VARIANTS}
    for v in ["sum", "tree", "tree", "sum"] * args.reps:
        use(v)
        got[v] = (P.predict_margin_packed(pa, Xd, 1).cpu().numpy(),
                  sess.score_margin(Xs), sdev.score_margin(Xs))
        t = times[v]
        t["walk_rows"].append(event_ms(
            lambda: P.predict_margin_packed(pa, Xd, 1), 3))
        t["serve"].append(host_ms(lambda: sess.score_margin(Xs)))
        t["serve_device"].append(host_ms(lambda: sdev.score_margin(Xs)))
        t["reduce_rows"].append(event_ms(
            lambda: VARIANTS[v](lv_rows, 1)))
        t["reduce_256"].append(event_ms(lambda: VARIANTS[v](lv_256, 1)))
    use("tree")
    out = {"nvidia_smi": smi, "rows": args.rows, "rounds": args.rounds,
           "reps": 2 * args.reps,
           "median_ms": {v: {k: float(np.median(x)) for k, x in t.items()}
                         for v, t in times.items()},
           "sum_vs_tree_max_abs_diff": {
               k: float(np.max(np.abs(a - b))) for k, a, b in zip(
                   ("walk_rows", "serve", "serve_device"), got["sum"],
                   got["tree"])}}
    line = json.dumps(out)
    print(line)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "sum_iterations_ab.json"),
              "w") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()
