#!/usr/bin/env python3
"""Time the K-slot histogram kernel (lightgbm_tpu_torch/csrc/hist_slots.cu)
at the training path's shapes on one CUDA device, under each variant of
its tile plan.

    python3 scripts/hist_slots_bench.py [--root DIR] [--reps N]
        [--segment-rows R ...] [--storage {bench,narrow,criteo} ...]

--root DIR imports lightgbm_tpu_torch from DIR (default: the checkout this
script lives in), so that two checkouts can be timed in turns on one card:
a checkout whose histogram_cuda has no tile planner times its one launch
("default"); one with the planner times the plan the planner picks
("auto") and the plans with the row grouping, the warp merge, the
channel pairing and the direct sweep each turned the other way. --segment-rows R ... times
"auto" and, at K > 1, "grouping flipped" only, once for each R as the
least rows per block in place of the planner's rule.

Storages: bench (2^20 x 28, 63 random bins, B = 64); narrow (2^20 x 9, 63
random bins, B = 64: several slots share a tile); and Criteo
(lightgbm_tpu_torch/utils/synthetic.py's criteo_like, 2^20 rows, numpy
seed 7, ingested at max_bin 255 with its 26 categorical columns: 39
storage columns, B = 256); --storage times the named ones only. Cases: K = 1 with every row (the root); K = 16
and 128 with every row in a random slot ("full"); and with about half of
the rows in a random slot, the rest -1 ("half", the shape of a wave's
smaller children); then the root and the "half" waves again on the first
2^14 and 2^16 rows (a small dataset, or the deep waves of a large one).
Values are f32 on a 1/1024 grid, so every variant must equal the plain
version bitwise; a mismatch raises.

Per case and variant one JSON line: `ms` (CUDA events, mean of --reps
back-to-back calls), `device_ms` (the sum of the device's kernel and
memset times per call under torch.profiler over the same number of
calls) and `device_ms_by_kernel` (the same per kernel name), the plan and
the rows in a slot. Exits 2 without a CUDA device.
"""

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORAGES = ("bench", "narrow", "criteo")


def emit(obj):
    print(json.dumps(obj), flush=True)


def timed(torch, fn, reps):
    """(events ms, profiler device ms, {kernel name: device ms}) per call
    of fn over `reps` calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    for _ in range(3):   # a session now and then records no device time
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                name = ev.name.split("<")[0].split("(")[0]
                by[name] = by.get(name, 0.0) \
                    + ev.time_range.elapsed_us() / 1e3 / reps
        if by:
            break
    if not by:
        raise RuntimeError("torch.profiler saw no device activity")
    return ms, sum(by.values()), by


def storages(torch, lt, dev, names):
    gen = torch.Generator(device=dev).manual_seed(7)
    N = 1 << 20
    bench = torch.randint(0, 63, (28, N), generator=gen, device=dev,
                          dtype=torch.uint8)
    narrow = torch.randint(0, 63, (9, N), generator=gen, device=dev,
                           dtype=torch.uint8)
    if "bench" in names:
        yield "bench", bench, 64
    if "narrow" in names:
        yield "narrow", narrow, 64
    if "criteo" not in names:
        return
    from lightgbm_tpu_torch.utils.synthetic import (CRITEO_CAT_COLUMNS,
                                                    criteo_like)
    X, y = criteo_like(N)
    params = dict(objective="binary", max_bin=255, verbose=-1,
                  binning_impl="auto", device_type="cuda")
    ds = lt.Dataset(X, label=y, categorical_feature=list(CRITEO_CAT_COLUMNS),
                    params=params).construct()
    bst = lt.Booster(params, ds)
    yield "criteo", bst._gbdt.X_t, bst._gbdt.num_bins_padded


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--segment-rows", type=int, nargs="*", default=[])
    ap.add_argument("--storage", nargs="*", default=STORAGES,
                    choices=STORAGES)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("hist_slots_bench: torch finds no CUDA device", file=sys.stderr)
        return 2
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    dev = torch.device("cuda", 0)
    planned = hasattr(hc, "plan_hist_tiles")
    gen = torch.Generator(device=dev).manual_seed(9)
    cases = [(K, active, None) for K, active in (
        (1, "all"), (16, "full"), (16, "half"), (128, "full"),
        (128, "half"))]
    cases += [(K, active, n) for n in (1 << 14, 1 << 16)
              for K, active in ((1, "all"), (16, "half"), (128, "half"))]
    for name, X_all, B in storages(torch, lt, dev, args.storage):
        F, N_all = X_all.shape
        vals_all = torch.randint(-8192, 8192, (2, N_all), generator=gen,
                                 device=dev, dtype=torch.int32
                                 ).to(torch.float32) / 1024.0
        vals_all[1] = vals_all[1].abs()
        for K, active, n in cases:
            X, vals = X_all, vals_all
            if n is not None:
                X = X_all[:, :n].contiguous()
                vals = vals_all[:, :n].contiguous()
            N = X.shape[1]
            slot = None
            if K > 1:
                slot = torch.randint(0, K, (N,), generator=gen, device=dev,
                                     dtype=torch.int32)
                if active == "half":
                    off = torch.rand(N, generator=gen, device=dev) < 0.5
                    slot[off] = -1
            rows = N if slot is None else int((slot >= 0).sum())
            ref = hc.build_histogram_slots_plain(X, vals, slot, K, B)
            # variant name: (plan, least rows per block)
            variants = {"default": (None, None)}
            if planned:
                auto = hc.plan_hist_tiles(K, 2, F, B, rows=N)
                rows_min = None                # the planner's rule
            if args.segment_rows:
                variants = {f"auto, {r} rows per block": (auto, r)
                            for r in args.segment_rows}
                if K > 1:
                    variants.update({
                        f"grouping flipped, {r} rows per block":
                        (auto._replace(grouped=not auto.grouped), r)
                        for r in args.segment_rows})
            elif planned:
                variants = {
                    "auto": (auto, rows_min),
                    "merge flipped": (auto._replace(merge=not auto.merge),
                                      rows_min),
                    "pairing flipped": (auto._replace(
                        paired=not auto.paired), rows_min)}
                # the direct sweep at K = 1 needs the histogram in one tile
                if auto.direct or K > 1 or auto.feat_tiles == 1:
                    variants["direct flipped"] = (auto._replace(
                        direct=not auto.direct), rows_min)
                if K > 1:
                    variants["grouping flipped"] = (auto._replace(
                        grouped=not auto.grouped), rows_min)
                    variants["both flipped"] = (auto._replace(
                        grouped=not auto.grouped, merge=not auto.merge),
                        rows_min)
            for vname, (plan, min_rows) in variants.items():
                if plan is None:
                    def fn():
                        return hc.build_histogram_slots_cuda(X, vals, slot,
                                                             K, B)
                else:
                    def fn(plan=plan, min_rows=min_rows):
                        return hc._hist_slots_launch(X, vals, slot, K, B,
                                                     plan, min_rows)
                got = fn()
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    raise AssertionError(f"{name} K={K} {active} {vname}: "
                                         f"not bitwise equal to the plain "
                                         f"version")
                ms, dms, by = timed(torch, fn, args.reps)
                emit({"storage": name, "N": N, "F": F, "B": B, "K": K,
                      "active": active, "rows": rows, "variant": vname,
                      "plan": plan._asdict() if plan is not None else None,
                      "ms": ms, "device_ms": dms,
                      "device_ms_by_kernel": by})
    return 0


if __name__ == "__main__":
    sys.exit(main())
