#!/usr/bin/env python3
"""Where the PyTorch/CUDA port spends its time: ingest, a training
iteration, and a served batch.

    python3 scripts/profile_torch_port.py
        [--config bench|criteo|criteo_rowwise|bench_fused|criteo_fused|
                  bench_quant|bench_masked|bench_compact]
        [--rows N] [--iters K] [--trace F] [--root DIR]

--config bench (the default) builds bench.py's data (28 f32 features,
numpy seed 42) and trains bench.py's model (binary, 255 leaves, max_bin
63) on the wave megakernel route. --config criteo builds the Criteo-shaped
table of lightgbm_tpu_torch/utils/synthetic.py (13 count and 26
categorical columns, numpy seed 7) and trains the same model at max_bin
255 with those columns categorical: the wave-apply route;
--config criteo_rowwise the same under force_row_wise, whose histograms
are the row-wise flat kernel's (#7). The *_fused
configs train the same data under histogram_impl=fused: the narrow fused
route (kernel #9) on bench, the general one (kernel #10) on Criteo.
--config bench_quant trains bench.py's model with quantized gradients
(use_quantized_grad, 4 bins, stochastic rounding): int8 values through
the megakernel route, whose stages add the discretizer (scales, int8
values) and, inside it, the threefry draws of its stochastic rounding. --config bench_masked and
bench_compact train bench.py's model on the serial growers
(tpu_grower=masked / compact), one split at a time; no stage of theirs
is wrapped, so their `stages` line holds the score update and the rest.
Either is ingested with binning_impl=auto, trained with lightgbm_tpu_torch
on the first CUDA device and served, and the script prints JSON lines:

  ingest     Dataset construction on the device route, with its stages
             wrapped in synchronized host timers: bin mappers (row sample
             and find_bin), the chunked upload + bucketize (and the
             kernel launches inside it), the bundle search and metadata,
             and the rest (the one copy of the binned matrix back to the
             host among it)
  steady     wall ms per iteration over K iterations after two warm-up
             iterations (host clock around work that ends in a synchronize)
  profile    torch.profiler over K iterations: device-busy ms per iteration
             (the sum of GPU kernel and memcpy/memset times: one stream, so
             they do not overlap), the device idle share, GPU launches per
             iteration, the top device-time entries by name, the device ms
             per iteration of every kernel of the port (lightgbm_tpu_torch/
             csrc), and the device ms per iteration spent under each stage
             of the `stages` line below (its calls wrapped in
             torch.profiler.record_function, no synchronize)
  stages     a second pass with the grower's stages wrapped in synchronized
             host timers (so the stages do not overlap, and the iteration
             runs a little slower than in `steady`): ms per iteration in the
             root histogram, the wave kernels, the split search, the
             objective, the score update, and everything else. On the
             apply route the wave stages are the decision-bit build
             (`dec_go_left`, plain PyTorch: a checkout whose wave_apply
             kernel decides each row itself never calls it), the
             wave_apply kernel and the wave histogram, and the split
             search is split into its numeric and categorical parts. On the fused routes the wave
             stage is the fused kernel (histogram and the children's
             numeric search), the numeric search outside it is the root's,
             and on "fused_tiled" the decision-bit build, the categorical
             search and the wave_apply flushes of deferred relabels are
             stages of their own

  serve      after the iterations: the binned engine (max_batch 256) on
             raw f32 requests of 1, 32 and 256 rows, and the device engine
             on 256 rows; per request size the host-clock ms per request
             and, under torch.profiler, the device-busy ms, the device
             idle share, GPU operations per request and the bucketize
             kernel's device ms

`--trace F` writes the chrome trace of the profiled training window to F.
`--root DIR` imports lightgbm_tpu_torch from DIR instead of this checkout,
so that two checkouts can be profiled in turns on one card. Exits 2
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
# the __global__ functions of lightgbm_tpu_torch/csrc (this checkout's and
# the earlier ones'), whose device times the profile line lists by name
PORT_KERNELS = ("hist_slots_kernel", "hist_tiles_kernel", "hist_direct_kernel",
                "group_pass_kernel", "group_scan_kernel", "acc_to_f32_kernel",
                "take_leaf_values_kernel", "leaf_values_kernel",
                "wave_pass_kernel", "wave_relabel_kernel",
                "wave_apply_kernel", "bucketize_kernel",
                "hist_rowwise_kernel", "lgbt_split_scan_kernel",
                "fused_tiled_hist_kernel", "fused_member_kernel",
                "wave_member_kernel", "hist_direct_round_kernel")


def emit(obj):
    print(json.dumps(obj), flush=True)


def ingest_phase(torch, lt, X, y, params, cats=()):
    """Dataset construction with its stages timed (synchronized)."""
    from lightgbm_tpu_torch.data import dataset as ds_mod
    from lightgbm_tpu_torch.ops import bucketize as bk
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

    patches = [(ds_mod, "_fit_or_adopt_mappers", "bin mappers"),
               (ds_mod, "_finalize", "bundle search + metadata"),
               (bk, "bin_rows_device", "upload + bucketize"),
               (bk, "bucketize_rows", "bucketize kernel launches")]
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    try:
        for m, n, stage in patches:
            setattr(m, n, timed(stage, getattr(m, n)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ds = lt.Dataset(X, label=y, categorical_feature=list(cats),
                        params=params).construct()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    ms = {k: v * 1e3 for k, v in spent.items()}
    ms["other (row sample, copy back, allocation)"] = total * 1e3 - sum(
        v for k, v in ms.items() if k != "bucketize kernel launches")
    emit({"phase": "ingest", "route": ds._handle.binning_route,
          "total_ms": total * 1e3, "ms": ms})
    return ds


def serve_phase(torch, bst, X):
    """Per request size: host-clock ms per request, and device time under
    the profiler."""
    from torch.profiler import ProfilerActivity, profile
    out = []
    for engine, sizes in (("binned", (1, 32, 256)), ("device", (256,))):
        sess = bst.serve(engine=engine, max_batch=256, warmup=True)
        for b in sizes:
            rows = [X[i * b:(i + 1) * b] for i in range(50)]
            for r in rows[:5]:
                sess.predict(r)
            t0 = time.perf_counter()
            for r in rows:
                sess.predict(r)
            wall = (time.perf_counter() - t0) * 1e3 / len(rows)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for r in rows:
                    sess.predict(r)
                pwall = (time.perf_counter() - t0) * 1e3 / len(rows)
            busy = kern = 0.0
            n_ops = 0
            for ev in prof.events():
                if ev.device_type == torch.autograd.DeviceType.CUDA:
                    t = ev.time_range.elapsed_us() / 1e3
                    busy += t
                    n_ops += 1
                    if "bucketize" in ev.name:
                        kern += t
            out.append({"engine": engine, "rows": b,
                        "ms_per_request": wall,
                        "profiled_ms_per_request": pwall,
                        "device_busy_ms": busy / len(rows),
                        "device_idle_share": 1.0 - busy / len(rows) / pwall,
                        "gpu_ops_per_request": n_ops / len(rows),
                        "bucketize_kernel_ms": kern / len(rows),
                        "walk_steps": sess._pa.depth})
    emit({"phase": "serve", "requests": out})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=("bench", "criteo", "criteo_rowwise",
                                         "bench_fused", "criteo_fused",
                                         "bench_quant", "bench_masked",
                                         "bench_compact"),
                    default="bench")
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--trace", help="write the profiled window's chrome "
                    "trace to this file")
    ap.add_argument("--root", default=ROOT, help="the checkout whose "
                    "lightgbm_tpu_torch is profiled")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_port: torch finds no CUDA device",
              file=sys.stderr)
        return 2
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.models import gbdt as gbdt_mod
    from lightgbm_tpu_torch.ops import grow_wave

    params = dict(objective="binary", num_leaves=255, max_bin=63,
                  learning_rate=0.1, min_data_in_leaf=20, verbose=-1,
                  bagging_freq=0, binning_impl="auto", device_type="cuda")
    if args.config.endswith("_fused"):
        params["histogram_impl"] = "fused"
    if args.config.endswith("_rowwise"):
        params["force_row_wise"] = True
    if args.config.endswith("_quant"):
        params.update(use_quantized_grad=True, num_grad_quant_bins=4)
    if args.config in ("bench_masked", "bench_compact"):
        params["tpu_grower"] = args.config[len("bench_"):]
    if args.config.startswith("criteo"):
        from lightgbm_tpu_torch.utils.synthetic import (CRITEO_CAT_COLUMNS,
                                                        criteo_like)
        X, y = criteo_like(args.rows)
        params["max_bin"] = 255
        cats = CRITEO_CAT_COLUMNS
    else:
        rng = np.random.RandomState(42)
        X = rng.normal(size=(args.rows, 28)).astype(np.float32)
        w = rng.normal(size=28)
        y = (X @ w + rng.normal(scale=0.5, size=args.rows) > 0) \
            .astype(np.float32)
        cats = ()
    ingest_phase(torch, lt, X[:1 << 16], y[:1 << 16], params,
                 cats)                                         # warm-up
    bst = lt.Booster(params, ingest_phase(torch, lt, X, y, params, cats))
    g = bst._gbdt
    emit({"phase": "route", "config": args.config,
          "grow_route": g.grow_route, "hist_route": g.hist_route,
          "fused_veto_reasons": g.fused_veto_reasons,
          "storage_columns": int(g.X_t.shape[0]),
          "num_bins_padded": g.num_bins_padded})
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

    # the score update: in place since the leaf-value kernel gained that
    # form, a gather before it (a checkout given by --root may predate it)
    score_fn = ("add_leaf_values_" if hasattr(gbdt_mod, "add_leaf_values_")
                else "take_leaf_values")
    if g.grow_route == "fused":
        patches = [(grow_wave, "build_histogram", "root histogram"),
                   (grow_wave, "wave_pass_fused", "fused kernel #9 "
                    "(histogram + children's search)"),
                   (grow_wave, "wave_relabel", "wave_relabel kernel"),
                   (grow_wave, "find_best_split", "split search, root"),
                   (gbdt_mod, score_fn, "score update")]
    elif g.grow_route == "fused_tiled":
        patches = [(grow_wave, "build_histogram", "root histogram"),
                   (grow_wave, "dec_go_left", "dec build (plain PyTorch)"),
                   (grow_wave, "wave_pass_fused_tiled", "fused kernel #10 "
                    "(histogram + children's numeric search)"),
                   (grow_wave, "wave_apply", "wave_apply kernel (flushes)"),
                   (grow_wave, "find_best_split", "split search, root"),
                   (grow_wave, "find_best_split_categorical",
                    "split search, categorical"),
                   (gbdt_mod, score_fn, "score update")]
    elif g.grow_route == "apply":
        patches = [(grow_wave, "build_histogram", "root histogram"),
                   (grow_wave, "dec_go_left", "dec build (plain PyTorch)"),
                   (grow_wave, "wave_apply", "wave_apply kernel"),
                   (grow_wave, "build_histogram_slots", "wave histogram"),
                   (grow_wave, "find_best_split", "split search, numeric"),
                   (grow_wave, "find_best_split_categorical",
                    "split search, categorical"),
                   (gbdt_mod, score_fn, "score update")]
    else:
        patches = [(grow_wave, "build_histogram", "root histogram"),
                   (grow_wave, "wave_pass", "wave_pass kernel"),
                   (grow_wave, "wave_relabel", "wave_relabel kernel"),
                   (grow_wave, "find_best_split", "split search"),
                   (gbdt_mod, score_fn, "score update")]
    # stages timed inside another stage: left out of the "other" sum
    nested = set()
    if params.get("use_quantized_grad"):
        patches += [(grow_wave, "discretize_gradients",
                     "quantize (scales, draws, int8 values)"),
                    (grow_wave, "uniform", "threefry draws")]
        nested.add("threefry draws")
    # ---- profiler window
    from torch.profiler import ProfilerActivity, profile
    from torch.profiler import record_function

    def ranged(stage, fn):
        def run(*a, **kw):
            with record_function(stage):
                return fn(*a, **kw)
        return run

    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    try:
        for m, n, stage in patches:
            setattr(m, n, ranged(stage, getattr(m, n)))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.iters):
                bst.update()
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    # device activity by name; the stages' ranges also show on the device
    # timeline (as spans over their kernels) and are left out of it. A
    # stage's device ms is the kernel time the profiler attributes to its
    # host range.
    stages = {stage for _, _, stage in patches}
    dev_by_name = defaultdict(float)
    n_dev = defaultdict(int)
    stage_dev = defaultdict(float)
    for ev in prof.events():
        if ev.name in stages:
            if ev.device_type == torch.autograd.DeviceType.CPU:
                stage_dev[ev.name] += ev.device_time_total / 1e3 / args.iters
        elif ev.device_type == torch.autograd.DeviceType.CUDA:
            dev_by_name[ev.name] += ev.time_range.elapsed_us() / 1e3
            n_dev[ev.name] += 1
    busy_ms = sum(dev_by_name.values()) / args.iters
    top = sorted(dev_by_name.items(), key=lambda kv: -kv[1])[:15]
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)
    port = sorted(k for k in dev_by_name if k.split("(")[0].split("<")[0]
                  .split()[-1] in PORT_KERNELS)
    emit({"phase": "profile", "wall_ms_per_iter": prof_wall_ms,
          "device_busy_ms_per_iter": busy_ms,
          "device_idle_share": 1.0 - busy_ms / prof_wall_ms,
          "gpu_ops_per_iter": sum(n_dev.values()) / args.iters,
          "top_device_ms_per_iter": [
              {"name": k[:80], "ms": v / args.iters,
               "count": n_dev[k] / args.iters} for k, v in top],
          "port_kernels_device_ms_per_iter": [
              {"name": k[:80], "ms": dev_by_name[k] / args.iters,
               "count": n_dev[k] / args.iters} for k in port],
          "stage_device_ms_per_iter": dict(stage_dev)})

    # ---- stage decomposition (synchronized host timers)
    spent = defaultdict(float)

    def timed(stage, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[stage] += time.perf_counter() - t
            n_calls[stage] += 1
            return out
        return run

    n_calls = defaultdict(int)
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
        (total - sum(v for k, v in spent.items() if k not in nested)) \
        * 1e3 / args.iters
    emit({"phase": "stages", "wall_ms_per_iter": total * 1e3 / args.iters,
          "ms_per_iter": stages,
          "calls_per_iter": {k: v / args.iters for k, v in n_calls.items()}})
    serve_phase(torch, bst, X)
    return 0


if __name__ == "__main__":
    sys.exit(main())
