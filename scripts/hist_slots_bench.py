#!/usr/bin/env python3
"""Time the port's tiled histogram kernels at the training path's shapes on
one CUDA device, under each variant of their tile plans.

    python3 scripts/hist_slots_bench.py [--kernel KERNEL] [--root DIR]
        [--reps N] [--segment-rows R ...] [--variants NAME ...]
        [--storage {bench,narrow,criteo} ...]

--kernel picks what is timed (default slots):
  slots           the K-slot histogram, kernel #1 (csrc/hist_slots.cu);
  rowwise         the row-wise flat histogram, kernel #7
                  (csrc/hist_rowwise.cu), over the storage's own flat
                  layout (ops/histogram_rowwise.py's build_rowwise_plan);
  rowwise_packed  kernel #8, the same from the nibble-packed storage (the
                  storages with two or more columns of <= 16 bins: Criteo);
  fused_tiled     the general fused wave, kernel #10
                  (csrc/wave_pass_fused_tiled.cu): a mid-tree wave of the
                  case's K candidates among 120 leaves, random decision
                  bits, parents and child statistics from the real rows;
  wave_pass       the wave megakernel, kernel #3 (csrc/wave_pass.cu), on
                  the bench storage: chip_smoke.py's waves, "few" (64
                  applied splits among 120 leaves, K candidates among the
                  184 after them: a few percent of the rows land in a
                  smaller child) and "half" (every leaf after K / 2 splits
                  of K / 2 leaves a candidate: about half of the rows), K
                  in {1, 16, 128}, and "half" K = 16 on 2^16 rows;
  wave_pass_fused the narrow fused wave, kernel #9 (csrc/wave_pass_fused.cu),
                  the same waves at K in {1, 16, 64}, parents and child
                  statistics from the real rows.
The wave kernels are timed through their wrappers ("auto"; "default" in
a checkout without the membership pass, such as a parent given by
--root), and kernel #3 also under its layout's variants: the bins of
the other number of columns (1 or 4) loaded ahead of a row's adds, 32
and 512 rows a piece, the row grouping and the direct route each turned
over;
their `device_ms_by_kernel` splits a call by device operation (memsets,
membership, grouping, tiles, rounding, scan).

--root DIR imports lightgbm_tpu_torch from DIR (default: the checkout this
script lives in), so that two checkouts can be timed in turns on one card:
run it with the parent's --root and without, parent, change, change,
parent. A checkout whose kernel has no tile planner (the slot histogram
before its planner, the row-wise kernels before the tiled engine) times
its one launch ("default"); one with the planner times the plan the
planner picks ("auto") and the plans with the row grouping, the warp
merge, the channel pairing and, for the slot histogram, the direct sweep
each turned the other way; the fused
wave times "auto" only. --variants NAME ... times the named variants
only ("default" stands for "auto" in a checkout without the planner).
--segment-rows R ... (slots) times "auto" and, at
K > 1, "grouping flipped" only, once for each R as the least rows per
block in place of the planner's rule.

Storages (their columns' bin counts give the row-wise flat layout):
bench (2^20 x 28, 63 random bins, B = 64); narrow (2^20 x 9, 63
random bins, B = 64: several slots share a tile); and Criteo
(lightgbm_tpu_torch/utils/synthetic.py's criteo_like, 2^20 rows, numpy
seed 7, ingested at max_bin 255 with its 26 categorical columns: 39
storage columns, B = 256); --storage times the named ones only. Cases: K = 1 with every row (the root); K = 16
and 128 with every row in a random slot ("full"); and with about half of
the rows in a random slot, the rest -1 ("half", the shape of a wave's
smaller children); then the root and the "half" waves again on the first
2^14 and 2^16 rows (a small dataset, or the deep waves of a large one).
The fused wave takes K = 1 and 16 (its cap at B = 256): "few", a
mid-tree wave whose candidates hold a few percent of the rows, and
"half", every leaf a candidate so that about half of the rows land in a
smaller child (a real wave's shape; at K = 1 the root's children), the
latter also on 2^16 and 2^14 rows. Values are
f32 on a 1/1024 grid, so every variant must equal the plain version
bitwise (the fused wave's histogram and records); a mismatch raises.

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
KERNELS = ("slots", "rowwise", "rowwise_packed", "fused_tiled", "wave_pass",
           "wave_pass_fused")


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


def wanted(args, vname):
    """Whether --variants names this variant ("default" stands for
    "auto")."""
    if args.variants is None:
        return True
    return vname in args.variants or (vname == "default"
                                      and "auto" in args.variants)


def storages(torch, lt, dev, names):
    gen = torch.Generator(device=dev).manual_seed(7)
    N = 1 << 20
    bench = torch.randint(0, 63, (28, N), generator=gen, device=dev,
                          dtype=torch.uint8)
    narrow = torch.randint(0, 63, (9, N), generator=gen, device=dev,
                           dtype=torch.uint8)
    if "bench" in names:
        yield "bench", bench, 64, (63,) * 28
    if "narrow" in names:
        yield "narrow", narrow, 64, (63,) * 9
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
    yield "criteo", bst._gbdt.X_t, bst._gbdt.num_bins_padded, \
        tuple(ds._handle.storage_num_bins())


def rowwise_variants(hc, tp, K):
    """The row-wise kernels' plan variants: the planner's, and the merge,
    the pairing and (K > 1) the grouping flipped."""
    out = {"auto": tp,
           "merge flipped": tp._replace(merge=not tp.merge)}
    out["pairing flipped"] = tp._replace(paired=not tp.paired)
    if K > 1:
        out["grouping flipped"] = tp._replace(grouped=not tp.grouped)
    return out


def fused_case(torch, hc, gf, X, B, K, active, gen, rng):
    """The operands of one wave of kernel #10 (chip_smoke.py's
    fused_tiled_phase without a pending table): "few", a mid-tree wave of
    min(K, 12) applied splits among 120 leaves whose K candidates hold a
    few percent of the rows; "half", every leaf after the applied splits a
    candidate (the root's children at K = 1), so about half of the rows
    land in a smaller child. Returns the argument tuple of
    wave_pass_fused_tiled_cuda / _plain and the smaller children's rows."""
    F, N = X.shape
    dev = X.device
    half = active == "half"
    nl0, L = (max(K // 2, 1) if half else 120), 255
    lor = torch.randint(0, nl0, (N,), generator=gen, device=dev,
                        dtype=torch.int32)
    pend = torch.full((128,), -1, dtype=torch.int32, device=dev)
    napp = K // 2 if half else min(K, 12)
    t = np.full((16, 128), -1, np.int32)
    t[0, :napp] = rng.choice(nl0, napp, replace=False)
    t[7, :K] = rng.choice(nl0 + napp, K, replace=False)
    t[15] = nl0
    tbl = torch.from_numpy(t).to(dev)
    Kd = max(K, napp, 1)
    dec = torch.randint(0, 4, (Kd, N), generator=gen, device=dev,
                        dtype=torch.int32).to(torch.uint8)
    _, slot_all = hc.wave_apply_plain(dec | 2, lor, tbl, L)
    _, slot_small = hc.wave_apply_plain(dec, lor, tbl, L)
    vals = torch.randint(-8192, 8192, (2, N), generator=gen, device=dev,
                         dtype=torch.int32).to(torch.float32) / 1024.0
    vals[1] = vals[1].abs()
    v3 = torch.cat([vals, torch.ones((1, N), device=dev)])
    par3 = hc.build_histogram_slots_plain(X, v3, slot_all, K, B)
    sm3 = hc.build_histogram_slots_plain(X, v3, slot_small, K, B)
    sil = torch.from_numpy(rng.randint(0, 2, K).astype(bool)).to(dev)
    ptot, stot = par3[:, :, 0].sum(-1), sm3[:, :, 0].sum(-1)
    ltot = torch.where(sil[:, None], stot, ptot - stot)
    lr = torch.cat([ltot, ptot - ltot])
    scal = torch.stack([lr[:, 0], lr[:, 1], lr[:, 2],
                        -lr[:, 0] / (lr[:, 1] + 1.0),
                        torch.cat([sil, sil]).float()]).contiguous()
    fmeta = torch.tensor(np.stack([np.full(F, B - 1), rng.randint(0, 3, F),
                                   rng.randint(0, B - 1, F), np.zeros(F)]),
                         dtype=torch.int32, device=dev)
    fmask = torch.ones(F, dtype=torch.uint8, device=dev)
    from lightgbm_tpu_torch.ops.split import SplitHyperParams
    hp = SplitHyperParams(min_data_in_leaf=20.0,
                          min_sum_hessian_in_leaf=1e-3, lambda_l1=0.0,
                          lambda_l2=0.0, max_delta_step=0.0,
                          min_gain_to_split=0.0, path_smooth=0.0)
    args = (X, vals, dec, lor, tbl, pend, 0,
            par3[:, :2].reshape(K, -1).contiguous(), scal, fmeta, fmask, K,
            B, L, hp, None)
    return args, int((slot_small >= 0).sum())


def wave_table(rng, F, B, nl0, napp, K):
    """[16, 128] int32 wave table (chip_smoke.py's): `napp` applied splits
    among leaves [0, nl0), K candidates among the nl0 + napp leaves after
    them, thresholds among the B - 1 bins in use."""
    t = np.full((16, 128), -1, np.int64)
    t[0, :napp] = rng.choice(nl0, napp, replace=False)
    t[7, :K] = rng.choice(nl0 + napp, K, replace=False)
    nb = B - 1
    for r0 in (1, 8):
        n = napp if r0 == 1 else K
        t[r0, :n] = rng.randint(0, F, n)
        t[r0 + 1, :n] = rng.randint(0, nb - 1, n)
        t[r0 + 2, :n] = rng.randint(0, 2, n)
        t[r0 + 3, :n] = rng.randint(0, 3, n)
        t[r0 + 4, :n] = rng.randint(0, nb, n)
        t[r0 + 5, :n] = nb
    t[14, :K] = rng.randint(0, 2, K)
    t[15] = nl0
    return t.astype(np.int32)


def wave_kernel(args, torch, hc, dev):
    """--kernel wave_pass / wave_pass_fused: kernels #3 and #9 through
    their wrappers, bitwise against their plain versions."""
    from lightgbm_tpu_torch.ops import grow_fused as gf
    from lightgbm_tpu_torch.ops.split import SplitHyperParams
    fused = args.kernel == "wave_pass_fused"
    gen = torch.Generator(device=dev).manual_seed(9)
    rng = np.random.RandomState(9)
    F, B, L, N_all = 28, 64, 255, 1 << 20
    kmax = 64 if fused else 128
    X_all = torch.randint(0, 63, (F, N_all), generator=gen, device=dev,
                          dtype=torch.uint8)
    N_all = X_all.shape[1]
    vals_all = torch.randint(-8192, 8192, (2, N_all), generator=gen,
                             device=dev, dtype=torch.int32
                             ).to(torch.float32) / 1024.0
    vals_all[1] = vals_all[1].abs()
    hp = SplitHyperParams(min_data_in_leaf=20.0,
                          min_sum_hessian_in_leaf=1e-3, lambda_l1=0.0,
                          lambda_l2=0.0, max_delta_step=0.0,
                          min_gain_to_split=0.0, path_smooth=0.0)
    fmeta = torch.tensor(np.stack([np.full(F, 63), rng.randint(0, 3, F),
                                   rng.randint(0, 63, F), np.zeros(F)]),
                         dtype=torch.int32, device=dev)
    fmask = torch.ones(F, dtype=torch.uint8, device=dev)
    cases = [(K, active, N_all) for active in ("few", "half")
             for K in (1, 16, kmax)] + [(16, "half", 1 << 16)]
    for K, active, N in cases:
        X = X_all if N == N_all else X_all[:, :N].contiguous()
        vals = vals_all if N == N_all else vals_all[:, :N].contiguous()
        nl0, napp = (120, 64) if active == "few" else (max(K // 2, 1),
                                                       K // 2)
        lor = torch.randint(0, nl0, (N,), generator=gen, device=dev,
                            dtype=torch.int32)
        tbl = torch.from_numpy(wave_table(rng, F, B, nl0, napp, K)).to(dev)
        t64 = tbl.to(torch.int64)
        slot_all = hc._entry_of(hc.wave_relabel_plain(X, lor, tbl, L)
                                .to(torch.int64), t64[7, :K])
        pe = hc._pack_entries(t64, 8, t64[14] & 1)[:K][slot_all.clamp(min=0)]
        small = (slot_all >= 0) & (hc._go_left(pe, X)
                                   == (((pe >> 23) & 1) == 1))
        rows = int(small.sum())
        if fused:
            slot_small = torch.where(small, slot_all, -1).to(torch.int32)
            slot_all = slot_all.to(torch.int32)
            v3 = torch.cat([vals, torch.ones((1, N), device=dev)])
            par3 = hc.build_histogram_slots_plain(X, v3, slot_all, K, B)
            sm3 = hc.build_histogram_slots_plain(X, v3, slot_small, K, B)
            sil = (t64[14, :K] & 1) == 1
            ptot, stot = par3[:, :, 0].sum(-1), sm3[:, :, 0].sum(-1)
            ltot = torch.where(sil[:, None], stot, ptot - stot)
            lr = torch.cat([ltot, ptot - ltot])
            scal = torch.stack([lr[:, 0], lr[:, 1], lr[:, 2],
                                -lr[:, 0] / (lr[:, 1] + 1.0),
                                torch.cat([sil, sil]).float()]).contiguous()
            wargs = (X, vals, lor, tbl,
                     par3[:, :2].reshape(K, -1).contiguous(), scal, fmeta,
                     fmask, K, B, L, hp)
            ref = gf.wave_pass_fused_plain(*wargs)

            def fn():
                return gf.wave_pass_fused_cuda(*wargs)
        else:
            ref = hc.wave_pass_plain(X, vals, lor, tbl, K, B, L)

            def fn():
                return hc.wave_pass_cuda(X, vals, lor, tbl, K, B, L)
        variants = {"default": (fn, None)}
        if hasattr(hc, "wave_hist_layout"):
            sms = hc._sm_count(dev.index or 0)
            auto = hc.wave_hist_layout(K, 2, F, B, N, False, sms)
            variants = {"auto": (fn, auto)}
            if not fused:
                # kernel #3 under the plan's variants: rows per piece,
                # the row grouping and the direct route turned over
                p = auto.plan
                q = hc.WAVE_PREFETCH if auto.prefetch == 1 else 1
                lays = {f"prefetch {q}": hc.wave_hist_layout(
                    K, 2, F, B, N, False, sms, p, auto.min_rows, q)}
                lays.update({f"{r} rows a piece": hc.wave_hist_layout(
                    K, 2, F, B, N, False, sms, p, r) for r in (32, 512)})
                lays["grouping flipped"] = hc.wave_hist_layout(
                    K, 2, F, B, N, False, sms,
                    p._replace(grouped=not (auto.sizes.W > 0),
                               direct=False))
                lays["direct flipped"] = hc.wave_hist_layout(
                    K, 2, F, B, N, False, sms,
                    p._replace(direct=not p.direct))
                for v, lay in lays.items():
                    variants[v] = ((lambda lay=lay: hc._wave_pass_launch(
                        X, vals, lor, tbl, K, B, L, lay)), lay)
        for vname, (f, lay) in variants.items():
            if not wanted(args, vname):
                continue
            got = f()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise AssertionError(f"{args.kernel} K={K} {active} N={N} "
                                     f"{vname}: not bitwise equal to the "
                                     f"plain version")
            ms, dms, by = timed(torch, f, args.reps)
            emit({"kernel": args.kernel, "storage": "bench", "N": N,
                  "F": F, "B": B, "K": K, "active": active, "rows": rows,
                  "variant": vname,
                  "plan": lay.plan._asdict() if lay is not None else None,
                  "min_rows": lay.min_rows if lay is not None else None,
                  "ms": ms, "device_ms": dms, "device_ms_by_kernel": by})
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--segment-rows", type=int, nargs="*", default=[])
    ap.add_argument("--storage", nargs="*", default=STORAGES,
                    choices=STORAGES)
    ap.add_argument("--kernel", default="slots", choices=KERNELS)
    ap.add_argument("--variants", nargs="*", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("hist_slots_bench: torch finds no CUDA device", file=sys.stderr)
        return 2
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    dev = torch.device("cuda", 0)
    if args.kernel in ("wave_pass", "wave_pass_fused"):
        return wave_kernel(args, torch, hc, dev)
    if args.kernel != "slots":
        return other_kernel(args, torch, lt, hc, dev)
    planned = hasattr(hc, "plan_hist_tiles")
    gen = torch.Generator(device=dev).manual_seed(9)
    cases = [(K, active, None) for K, active in (
        (1, "all"), (16, "full"), (16, "half"), (128, "full"),
        (128, "half"))]
    cases += [(K, active, n) for n in (1 << 14, 1 << 16)
              for K, active in ((1, "all"), (16, "half"), (128, "half"))]
    for name, X_all, B, _ in storages(torch, lt, dev, args.storage):
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
                if not wanted(args, vname):
                    continue
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


def other_kernel(args, torch, lt, hc, dev):
    """--kernel rowwise / rowwise_packed / fused_tiled."""
    from lightgbm_tpu_torch.ops import grow_fused as gf
    from lightgbm_tpu_torch.ops import histogram_rowwise as hr
    gen = torch.Generator(device=dev).manual_seed(9)
    rng = np.random.RandomState(9)
    planned = hasattr(hr, "flat_plan")
    if args.kernel == "fused_tiled":
        cases = [(1, "few", None), (16, "few", None), (1, "half", None),
                 (16, "half", None), (16, "half", 1 << 16),
                 (16, "half", 1 << 14)]
    else:
        cases = [(K, active, None) for K, active in (
            (1, "all"), (16, "full"), (16, "half"), (128, "full"),
            (128, "half"))]
        cases += [(K, active, n) for n in (1 << 14, 1 << 16)
                  for K, active in ((1, "all"), (16, "half"),
                                    (128, "half"))]
    for name, X_all, B, bins in storages(torch, lt, dev, args.storage):
        F, N_all = X_all.shape
        plan = hr.build_rowwise_plan(bins)
        pplan = hr.build_pack4_plan(bins)
        if args.kernel == "rowwise_packed" and not hr.pack4_worthwhile(pplan):
            emit({"storage": name, "kernel": args.kernel,
                  "skipped": "fewer than two columns of <= 16 bins"})
            continue
        if args.kernel == "fused_tiled" and B != 256:
            continue                       # the Criteo storage only
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
            if args.kernel == "fused_tiled":
                fargs, rows = fused_case(torch, hc, gf, X, B, K, active, gen,
                                         rng)
                ref = gf.wave_pass_fused_tiled_plain(*fargs)
                variants = {"auto" if planned else "default":
                            lambda: gf.wave_pass_fused_tiled_cuda(*fargs)}
                pl_of = {}
            else:
                slot = None
                if K > 1:
                    slot = torch.randint(0, K, (N,), generator=gen,
                                         device=dev, dtype=torch.int32)
                    if active == "half":
                        off = torch.rand(N, generator=gen, device=dev) < 0.5
                        slot[off] = -1
                rows = N if slot is None else int((slot >= 0).sum())
                ref = hr.hist_rowwise_plain(X, vals, slot, K, plan)
                packed = args.kernel == "rowwise_packed"
                if packed:
                    Xp, Xu = hr.pack4(X, pplan)
                name_k = "hist_" + args.kernel
                if planned:
                    pl_of = rowwise_variants(
                        hc, hr.flat_plan(plan, K, 2, False), K)
                    variants = {
                        v: (lambda tp=tp: hr._rowwise_launch(
                            name_k, Xp if packed else X,
                            Xu if packed else None, vals, slot, K, plan,
                            pplan if packed else None, tp))
                        for v, tp in pl_of.items()}
                else:
                    pl_of = {}
                    variants = {"default": (
                        (lambda: hr.hist_rowwise_packed_cuda(
                            Xp, Xu, vals, slot, K, plan, pplan)) if packed
                        else (lambda: hr.hist_rowwise_cuda(
                            X, vals, slot, K, plan)))}
            for vname, fn in variants.items():
                if not wanted(args, vname):
                    continue
                got = fn()
                torch.cuda.synchronize()
                same = (all(torch.equal(a, b) for a, b in zip(got, ref))
                        if isinstance(got, tuple) else torch.equal(got, ref))
                if not same:
                    raise AssertionError(f"{args.kernel} {name} K={K} "
                                         f"{active} {vname}: not bitwise "
                                         f"equal to the plain version")
                ms, dms, by = timed(torch, fn, args.reps)
                tp = pl_of.get(vname)
                emit({"kernel": args.kernel, "storage": name, "N": N,
                      "F": F, "B": B, "total": plan.total, "K": K,
                      "active": active, "rows": rows, "variant": vname,
                      "plan": tp._asdict() if tp is not None else None,
                      "ms": ms, "device_ms": dms,
                      "device_ms_by_kernel": by})
    return 0


if __name__ == "__main__":
    sys.exit(main())
