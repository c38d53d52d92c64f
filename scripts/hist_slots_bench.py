#!/usr/bin/env python3
"""Time the port's tiled histogram kernels at the training path's shapes on
one CUDA device, under each variant of their tile plans.

    python3 scripts/hist_slots_bench.py [--kernel KERNEL] [--root DIR]
        [--reps N] [--segment-rows R ...] [--variants NAME ...]
        [--storage {bench,narrow,criteo,efb} ...]

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
                  statistics from the real rows;
  bucketize       device binning, kernel #6 (csrc/bucketize.cu), on
                  chip_smoke.py's three tables (train: bench.py's data and
                  mappers with the dataset's column selection; serve: the
                  serve-mode table of the same mappers; synthetic: the
                  adversarial categorical / NaN / zero-missing table) at
                  2^20 and 2^18 rows (ingest: the feature-major X_t) and
                  at 256 and 8 rows (served chunks: row-major bins), each
                  layout timed and held bitwise to bucketize_plain; and,
                  in the layout the main path writes at that shape, under
                  variants built from the kernel's own source (BK_VARIANTS:
                  "stage only", "no loads", "no stores", "no search", "6
                  blocks an SM"), so that a call splits into staging (with
                  the launch), loads and stores, and the search;
  wave_apply      the apply route's per-wave row pass, kernel #4
                  (csrc/wave_apply.cu), at N = 2^20, L = 255, Kd in {16,
                  128} (min(Kd, 64) applied splits among 120 leaves, Kd
                  candidates among the leaves after them) on three
                  storages: bench (bench.py's data, max_bin 63, numeric),
                  criteo (criteo_like, max_bin 255, B = 256, categorical
                  bitsets) and efb (efb_like, max_bin 63, bundled). The
                  split records are drawn from each storage's own feature
                  metadata (features, thresholds inside their bins, every
                  missing type the data has, bitsets over a categorical
                  feature's bins, EFB unpacking). Timed apart: the
                  decision build the parent's route ran (dec_go_left for
                  the applied entries and for the candidates with the
                  land bit: a [Kd, N] byte matrix) and the kernel; in a
                  checkout whose kernel decides each row itself, the
                  kernel is also held bitwise to the decision build +
                  wave_apply_plain and to its own plain version, and
                  timed under WA_VARIANTS too ("8 blocks an SM");
  wave_relabel    the relabel of a tree's last wave, kernel #5
                  (csrc/wave_relabel.cu), through its wrapper at N = 2^20
                  (and 2^20 - 3: the scalar tail), L = 255, F = 28, B =
                  64 on chip_smoke.py's wave tables, "few" (64 applied
                  splits among 120 leaves) and "half" (64 splits of 64
                  leaves: every row reads a bin), and "few" on 2^16 rows:
                  into a new tensor each call and, where the wrapper takes
                  `out`, into a preallocated one (the in-place call's
                  work), bitwise against wave_relabel_plain; and, in a
                  checkout whose source has them, under RL_VARIANTS built
                  from it (threads a block, blocks an SM, 16-byte loads a
                  thread in flight) and two diagnostics that are not the
                  function ("no bin loads": split rows read bin 0; "copy
                  only": every row keeps its leaf), which split a call
                  into the table's decode and the copy, the leaf map, and
                  the bin loads.
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
           "wave_pass_fused", "bucketize", "wave_apply", "wave_relabel")


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
    inf = torch.full((2 * K,), float("inf"), device=dev)
    # the scan's [7, 2K] scalars and [5, F] metadata: no monotone bounds
    scal = torch.stack([lr[:, 0], lr[:, 1], lr[:, 2],
                        -lr[:, 0] / (lr[:, 1] + 1.0),
                        torch.cat([sil, sil]).float(), -inf, inf]
                       ).contiguous()
    fmeta = torch.tensor(np.stack([np.full(F, B - 1), rng.randint(0, 3, F),
                                   rng.randint(0, B - 1, F), np.zeros(F),
                                   np.zeros(F)]),
                         dtype=torch.int32, device=dev)
    fmask = torch.ones(F, dtype=torch.uint8, device=dev)
    from lightgbm_tpu_torch.ops.split import SplitHyperParams
    hp = SplitHyperParams(min_data_in_leaf=20.0,
                          min_sum_hessian_in_leaf=1e-3, lambda_l1=0.0,
                          lambda_l2=0.0, max_delta_step=0.0,
                          min_gain_to_split=0.0, path_smooth=0.0)
    args = (X, vals, dec, lor, tbl, pend,
            torch.zeros(1, dtype=torch.int32, device=dev),
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


def _rl(threads, blocks, unroll):
    return [(r"LGBT_RELABEL_THREADS \d+", f"LGBT_RELABEL_THREADS {threads}"),
            (r"LGBT_RELABEL_BLOCKS_PER_SM \d+",
             f"LGBT_RELABEL_BLOCKS_PER_SM {blocks}"),
            (r"LGBT_RELABEL_UNROLL \d+", f"LGBT_RELABEL_UNROLL {unroll}")]


RL_VARIANTS = {"256 threads x 8 blocks an SM": _rl(256, 8, 1),
               "1024 threads x 2 blocks an SM": _rl(1024, 2, 1),
               "512 threads x 2 blocks an SM": _rl(512, 2, 1),
               "unroll 2": _rl(512, 4, 2),
               # diagnostics, not the function: the split rows' bin bytes
               # read as 0; every row keeps its leaf (the table's decode
               # and the leaf ids' copy only)
               "no bin loads": [(r"\(int\)X\[\(long long\)feat \* N \+ r \+ j\]",
                                 "0")],
               "copy only": [(r"out\[j\] = \(ka\[j\] >= 0 && !left\) \? "
                              r"nl0 \+ ka\[j\] : lor\[j\];",
                              "out[j] = lor[j];")]}
RL_DIAGNOSTIC = ("no bin loads", "copy only")


def relabel_kernel(args, torch, hc, dev):
    """--kernel wave_relabel: kernel #5 through its wrapper, bitwise
    against its plain version."""
    import inspect
    gen = torch.Generator(device=dev).manual_seed(9)
    rng = np.random.RandomState(9)
    F, B, L, N_all = 28, 64, 255, 1 << 20
    X_all = torch.randint(0, 63, (F, N_all), generator=gen, device=dev,
                          dtype=torch.uint8)
    takes_out = "out" in inspect.signature(hc.wave_relabel_cuda).parameters
    srcs = {"auto": None}
    for vname, patches in RL_VARIANTS.items():
        if wanted(args, vname):
            fn = variant_fn(hc, "wave_relabel", patches, vname)
            if fn is not None:
                srcs[vname] = fn
    for case, N in (("few", N_all), ("half", N_all), ("few", N_all - 3),
                    ("few", 1 << 16)):
        X = X_all if N == N_all else X_all[:, :N].contiguous()
        nl0, napp = (120, 64) if case == "few" else (64, 64)
        lor = torch.randint(0, nl0, (N,), generator=gen, device=dev,
                            dtype=torch.int32)
        tbl = torch.from_numpy(wave_table(rng, F, B, nl0, napp, 1)).to(dev)
        ref = hc.wave_relabel_plain(X, lor, tbl, L)
        app_rows = int(torch.isin(lor, tbl[0, :napp]).sum())
        out = torch.empty_like(lor)
        forms = {"new tensor": lambda: hc.wave_relabel_cuda(X, lor, tbl, L)}
        if takes_out:
            forms["preallocated"] = lambda: hc.wave_relabel_cuda(
                X, lor, tbl, L, out=out)
        for vname, lib in srcs.items():
            if not wanted(args, vname):
                continue
            for form, f in forms.items():
                with patched(hc, "wave_relabel", lib):
                    got = f()
                    torch.cuda.synchronize()
                    if vname not in RL_DIAGNOSTIC \
                            and not torch.equal(got, ref):
                        raise AssertionError(
                            f"wave_relabel {case} N={N} {vname} {form}: "
                            f"not bitwise equal to the plain version")
                    ms, dms, by = timed(torch, f, args.reps)
                emit({"kernel": "wave_relabel", "storage": "bench", "N": N,
                      "F": F, "L": L, "case": case, "applied_rows": app_rows,
                      "variant": vname, "form": form, "ms": ms,
                      "device_ms": dms, "device_ms_by_kernel": by,
                      "bound_ms": (8 * N + app_rows + 16 * 128 * 4)
                      / 3.35e12 * 1e3})
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--segment-rows", type=int, nargs="*", default=[])
    ap.add_argument("--storage", nargs="*", default=None,
                    choices=STORAGES + ("efb",))
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
    if args.kernel == "bucketize":
        return bucketize_kernel(args, torch, lt, dev)
    if args.kernel == "wave_apply":
        return wave_apply_kernel(args, torch, lt, hc, dev)
    if args.kernel in ("wave_pass", "wave_pass_fused"):
        return wave_kernel(args, torch, hc, dev)
    if args.kernel == "wave_relabel":
        return relabel_kernel(args, torch, hc, dev)
    if args.kernel != "slots":
        return other_kernel(args, torch, lt, hc, dev)
    planned = hasattr(hc, "plan_hist_tiles")
    gen = torch.Generator(device=dev).manual_seed(9)
    cases = [(K, active, None) for K, active in (
        (1, "all"), (16, "full"), (16, "half"), (128, "full"),
        (128, "half"))]
    cases += [(K, active, n) for n in (1 << 14, 1 << 16)
              for K, active in ((1, "all"), (16, "half"), (128, "half"))]
    for name, X_all, B, _ in storages(torch, lt, dev,
                                      args.storage or STORAGES):
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
    for name, X_all, B, bins in storages(torch, lt, dev,
                                         args.storage or STORAGES):
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


# ---------------------------------------------------------------------------
# kernel #6: device binning
# ---------------------------------------------------------------------------
# patches of the kernel's source that cut one part out or change one
# choice; each pattern names the parent's form and the redesigned one,
# whichever the source has ("stage only": no tile is binned; "no loads":
# a value made from its row index stands in for the read one; "no
# stores": nothing is written out; "no search": a value's low bits stand
# in for its bin, or for its search's result; "6 blocks an SM": the
# registers capped so that six blocks fit)
BK_VARIANTS = {
    "stage only": [(r"\bt < n_tiles", "t < 0")],
    "no loads": [(r"v\[k\] = X\[\(r0 \+ r\) \* ldx \+ s_col\[f\]\];",
                  "v[k] = (float)((r0 + r) & 1023) - 512.0f;"),
                 (r"\? \*p : 0\.0f;",
                  "? (float)((r0 + i * LGBT_BK_WARPS) & 1023) - 512.0f "
                  ": 0.0f;")],
    "no stores": [(r"if \(r0 \+ r < n\) out\[", "if (false) out["),
                  (r"if \(feat_major\) \{", "if (false) {"),
                  (r"\} else if \(mine\) \{", "} else if (false) {")],
    "6 blocks an SM": [(r"__launch_bounds__\(LGBT_THREADS\)"
                        r"\nbucketize_kernel",
                        "__launch_bounds__(LGBT_THREADS, 6)\n"
                        "bucketize_kernel")],
    "no search": [(r"bin_one\(v\[k\],[^;]*\)",
                   "(unsigned char)__float_as_uint(v[k])"),
                  (r"const int g = bk_bucket\([^;]*\);",
                   "const int g = __float_as_uint(q[i]) & 15;"),
                  (r"int step = D > 0 \? 1 << \(D - 1\) : 0;",
                   "int step = 0;")],
}


# the same for kernel #4's source (the redesigned one only)
WA_VARIANTS = {
    "8 blocks an SM": [(r"lgbt_grid\(quads, num_sms, 4\)",
                        "lgbt_grid(quads, num_sms, 8)")],
}


def variant_fn(hc, kernel, patches, tag):
    """The C entry point of kernel `kernel`'s source with `patches`
    applied, built into the package's _build directory; None when the
    source has none of the patterns."""
    import ctypes
    import re
    import subprocess
    src_name, entry = hc.KERNELS[kernel]
    src = (hc.CSRC / src_name).read_text()
    hits = 0
    for pat, rep in patches:
        src, k = re.subn(pat, rep, src)
        hits += k
    if not hits:
        return None
    hc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{kernel}_{tag.replace(' ', '_')}"
    cu = hc.BUILD_DIR / f"{tag}.cu"
    so = hc.BUILD_DIR / f"{tag}.so"
    cu.write_text(src)
    subprocess.run([hc._nvcc(), *hc.NVCC_FLAGS, "-I", str(hc.CSRC), "-o",
                    str(so), str(cu)], check=True, capture_output=True)
    fn = getattr(ctypes.CDLL(str(so)), entry)
    ref = hc._lib(kernel)
    fn.argtypes, fn.restype = ref.argtypes, ref.restype
    return fn


def patched(hc, kernel, fn):
    """Context: hc._lib(kernel) returns fn (None: unchanged)."""
    import contextlib
    lib = hc._lib

    @contextlib.contextmanager
    def ctx():
        if fn is not None:
            hc._lib = lambda k: fn if k == kernel else lib(k)
        try:
            yield
        finally:
            hc._lib = lib
    return ctx()


def bucketize_tables(torch, lt, bk, dev):
    """chip_smoke.py's three tables: [(name, DeviceBinTable, rows [2^20,
    F] f32 on the card, cols or None)]."""
    sys.path.insert(1, HERE)
    import chip_smoke as cs
    N, F = 1 << 20, 28
    rng = np.random.RandomState(42)
    X = rng.normal(size=(N, F)).astype(np.float32)
    w = rng.normal(size=F)
    y = (X @ w + rng.normal(scale=0.5, size=N) > 0).astype(np.float32)
    params = dict(objective="binary", max_bin=63, verbose=-1,
                  binning_impl="auto", device_type="cuda")
    h = lt.Dataset(X, label=y, params=params).construct()._handle
    syn_mappers, Xs = cs._synthetic_bucketize_case(
        np.random.RandomState(44), N, F)
    Xd = torch.from_numpy(X).to(dev)
    cols = torch.as_tensor(np.asarray(h.real_feature_index,
                                      np.int32)).to(dev)
    return [
        ("train", bk.pack_bin_table(h.mappers, mode="train"), Xd, cols),
        ("serve", bk.pack_bin_table(cs._mappers_by_feature(h), mode="serve",
                                    used_features=range(F)), Xd, None),
        ("synthetic", bk.pack_bin_table(syn_mappers, mode="serve"),
         torch.from_numpy(Xs).to(dev), None)]


def bucketize_kernel(args, torch, lt, dev):
    """--kernel bucketize: kernel #6 through its wrapper, both output
    layouts bitwise against bucketize_plain at 2^20, 2^18, 256 and 8 rows;
    the layout a shape takes on the main path (feature-major at ingest,
    row-major when serving) also under BK_VARIANTS."""
    from lightgbm_tpu_torch.ops import bucketize as bk
    hc = bk.hc
    variants = {v: variant_fn(hc, "bucketize", pats, v)
                for v, pats in BK_VARIANTS.items() if wanted(args, v)}
    for name, table, X_all, cols in bucketize_tables(torch, lt, bk, dev):
        tt = bk.upload_bin_table(table, dev)
        F = tt.num_features
        for n in (1 << 20, 1 << 18, 256, 8):
            X = X_all[:n]
            ref = bk.bucketize_plain(X, tt, cols=cols)
            X_t = torch.empty((F, n), dtype=torch.uint8, device=dev)
            layouts = {"feature-major": lambda: bk.bucketize_cuda(
                X, tt, out=X_t.t(), cols=cols),
                "row-major": lambda: bk.bucketize_cuda(X, tt, cols=cols)}
            main = "feature-major" if n >= 1 << 18 else "row-major"
            for lay, fn in layouts.items():
                got = fn()
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    raise AssertionError(f"bucketize {name} n={n} {lay}: "
                                         f"not bitwise equal to the plain "
                                         f"version")
                runs = {"full": None}
                if lay == main:
                    runs.update({v: f for v, f in variants.items()
                                 if f is not None})
                for vname, vfn in runs.items():
                    if not wanted(args, vname):
                        continue
                    with patched(hc, "bucketize", vfn):
                        ms, dms, by = timed(torch, fn, args.reps)
                    emit({"kernel": "bucketize", "table": name,
                          "mode": table.mode, "n": n, "F": F, "B": tt.B,
                          "layout": lay, "variant": vname,
                          "bytes": n * F * 5 + F * tt.B * 8 + F * 32,
                          "ms": ms, "device_ms": dms,
                          "device_ms_by_kernel": by})
    return 0


# ---------------------------------------------------------------------------
# kernel #4: the apply route's row pass
# ---------------------------------------------------------------------------
def apply_storages(torch, lt, dev, names):
    """(name, gbdt) of the bench, criteo and efb storages at 2^20 rows,
    ingested on the card."""
    from lightgbm_tpu_torch.utils.synthetic import (CRITEO_CAT_COLUMNS,
                                                    criteo_like, efb_like)
    N = 1 << 20
    base = dict(objective="binary", num_leaves=255, verbose=-1,
                binning_impl="auto", device_type="cuda")
    for name in names:
        cats = None
        if name == "bench":
            rng = np.random.RandomState(42)
            X = rng.normal(size=(N, 28)).astype(np.float32)
            y = (X @ rng.normal(size=28) > 0).astype(np.float32)
            params = dict(base, max_bin=63)
        elif name == "criteo":
            X, y = criteo_like(N)
            cats = list(CRITEO_CAT_COLUMNS)
            params = dict(base, max_bin=255)
        else:
            X, y = efb_like(N)
            params = dict(base, max_bin=63)
        ds = lt.Dataset(X, label=y, categorical_feature=cats,
                        params=params).construct()
        yield name, lt.Booster(params, ds)._gbdt


def apply_records(torch, rng, g, n, dev):
    """n split records drawn from the storage's feature metadata:
    (feature, threshold, default_left, is_cat, bitset [n, W] int64)."""
    meta, cfg = g.meta, g.grow_cfg
    nb = meta.num_bins.cpu().numpy().astype(np.int64)
    cat_f = meta.is_categorical.cpu().numpy() & cfg.has_categorical
    W = cfg.cat_words
    feat = rng.randint(0, len(nb), n)
    thr = np.array([rng.randint(0, max(nb[f] - 1, 1)) for f in feat])
    dl = rng.randint(0, 2, n).astype(bool)
    iscat = cat_f[feat]
    bits = np.zeros((n, W), np.int64)
    for i in np.flatnonzero(iscat):
        on = np.flatnonzero(rng.rand(nb[feat[i]]) < 0.3)
        for b in on:
            bits[i, b >> 5] |= 1 << (b & 31)
    t = [torch.from_numpy(a).to(dev) for a in (feat, thr, dl, iscat, bits)]
    return t


def wave_apply_kernel(args, torch, lt, hc, dev):
    """--kernel wave_apply: the parent's decision build and kernel #4,
    timed apart; the redesigned kernel also held to the parent's
    composition (bitwise)."""
    from lightgbm_tpu_torch.ops import grow_wave as tw
    from lightgbm_tpu_torch.ops import histogram as th
    per_row = hasattr(hc, "wave_apply_rows_plain")
    wa_variants = {}
    if per_row:
        wa_variants = {v: variant_fn(hc, "wave_apply", pats, v)
                       for v, pats in WA_VARIANTS.items()
                       if wanted(args, v)}
    gen = torch.Generator(device=dev).manual_seed(9)
    rng = np.random.RandomState(9)
    L, nl0 = 255, 120
    names = [s for s in ("bench", "criteo", "efb")
             if args.storage is None or s in args.storage]
    for name, g in apply_storages(torch, lt, dev, names):
        X_t, meta, cfg = g.X_t, g.meta, g.grow_cfg
        N = X_t.shape[1]
        lor = torch.randint(0, nl0, (N,), generator=gen, device=dev,
                            dtype=torch.int32)
        for Kd in (16, 128):
            napp = min(Kd, 64)
            fa, ta, da, ca, ba = apply_records(torch, rng, g, napp, dev)
            fc, tc, dc, cc, bc = apply_records(torch, rng, g, Kd, dev)
            sil = torch.from_numpy(rng.randint(0, 2, Kd).astype(bool)) \
                .to(dev)
            t = np.full((16, 128), -1, np.int32)
            t[0, :napp] = rng.choice(nl0, napp, replace=False)
            t[7, :Kd] = rng.choice(nl0 + napp, Kd, replace=False)
            t[15] = nl0
            tbl = torch.from_numpy(t).to(dev)

            def dec_build():
                dec = torch.zeros((Kd, N), dtype=torch.uint8, device=dev)
                dec[:napp] = tw.dec_go_left(X_t, fa, ta, da, ca, ba, meta,
                                            cfg)
                glc = tw.dec_go_left(X_t, fc, tc, dc, cc, bc, meta, cfg)
                dec |= (glc == sil[:, None]).to(torch.uint8) << 1
                return dec
            dec = dec_build()
            ref = hc.wave_apply_plain(dec, lor, tbl, L)
            rec = {"kernel": "wave_apply", "storage": name, "N": N,
                   "F": int(X_t.shape[0]), "B": cfg.num_bins_padded,
                   "Kd": Kd, "napp": napp,
                   "cat_entries": int(ca.sum() + cc.sum()),
                   "bundled": cfg.bundled,
                   "rows_applied": int(torch.isin(lor, tbl[0, :napp]).sum()),
                   "rows_candidate": int(torch.isin(
                       ref[0], tbl[7, :Kd]).sum()),
                   "slots": int((ref[1] >= 0).sum())}
            ms, dms, by = timed(torch, dec_build, args.reps)
            emit({**rec, "part": "decision build", "ms": ms,
                  "device_ms": dms, "device_ms_by_kernel": by})
            if per_row:
                full = tbl.clone()
                full[1:7, :napp] = torch.stack([
                    fa, ta, da.long(), meta.missing_type.long()[fa],
                    meta.default_bin.long()[fa],
                    meta.num_bins.long()[fa]]).to(torch.int32)
                full[8:15, :Kd] = torch.stack([
                    fc, tc, dc.long(), meta.missing_type.long()[fc],
                    meta.default_bin.long()[fc], meta.num_bins.long()[fc],
                    sil.long()]).to(torch.int32)
                cats = (tw.pack_wave_cats(ca, ba, cc, bc, cfg.cat_words)
                        if cfg.has_categorical else None)
                bmap = tw.wave_bundle_map(cfg, dev)
                kargs = (X_t, lor, full, cats, bmap, Kd, L)
                got = hc.wave_apply_cuda(*kargs)
                plain = hc.wave_apply_rows_plain(*kargs)
                torch.cuda.synchronize()
                for a, b, c in zip(got, ref, plain):
                    if not (torch.equal(a, b) and torch.equal(a, c)):
                        raise AssertionError(
                            f"wave_apply {name} Kd={Kd}: not bitwise "
                            f"equal to the decision build + "
                            f"wave_apply_plain / the plain version")

                def fn():
                    return th.wave_apply(*kargs)
                for vname, vfn in wa_variants.items():
                    with patched(hc, "wave_apply", vfn):
                        ms, dms, by = timed(torch, fn, args.reps)
                    emit({**rec, "part": "kernel", "per_row": per_row,
                          "variant": vname, "ms": ms, "device_ms": dms,
                          "device_ms_by_kernel": by})
            else:
                got = hc.wave_apply_cuda(dec, lor, tbl, L)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    raise AssertionError(f"wave_apply {name} Kd={Kd}: not "
                                         f"bitwise equal")

                def fn():
                    return hc.wave_apply_cuda(dec, lor, tbl, L)
            ms, dms, by = timed(torch, fn, args.reps)
            emit({**rec, "part": "kernel", "per_row": per_row,
                  "variant": "full", "ms": ms, "device_ms": dms,
                  "device_ms_by_kernel": by})
            del dec
        del g
    return 0


if __name__ == "__main__":
    sys.exit(main())
