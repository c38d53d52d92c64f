#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lightgbm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. device   the card (nvidia-smi name and power limit) and the build of
              every kernel from lightgbm_tpu_torch/csrc (nvcc, in parallel)
  2. kernels  each kernel against its plain PyTorch version at the main
              path's shapes (N = 2^20 rows, F = 28, B = 64, C = 2; K in
              {1, 16, 128}; L = 255), with kernel / plain / library times
              and the bytes bound; then, untimed, the int8 (exact int32)
              and 256-bin modes of the histogram and wave kernels
  3. train    bench.py's data (numpy seed 42, 2^20 x 28) and model (binary,
              255 leaves, max_bin 63) trained 8 rounds through
              lightgbm_tpu_torch.train on the card; every kernel's launch
              count must be > 0 and train AUC > 0.88, and the first tree
              must equal the one grown from the same gradients by the plain
              versions on the card
  4. serve    4096 held-out rows predicted by the trained Booster, and again
              after a model_to_string -> Booster(model_str=...) round trip:
              the two must be bitwise equal
  5. train on 8 more rounds of the same Booster through update_batch must
              lift train AUC past 0.9

then a {"kernels": [...]} line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failed check raises before the last
line and the exit code is not 0. Without a CUDA device, or without the
package beside this script, it exits with 2 and prints no result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
N_ROWS, N_FEAT, N_BINS, N_CH, N_LEAVES = 1 << 20, 28, 64, 2, 255


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def time_ms(fn, reps, warmup=2):
    """Mean device time of fn() over `reps` back-to-back calls (CUDA
    events; L2 is not flushed between calls)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, nops):
    """Least time for the work: bytes over HBM rate vs f32 operations over
    the f32 peak, whichever is larger."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def kernel_phase(hc, torch, dev):
    """Phase 2: every kernel against its plain version at the main path's
    shapes; returns {kernel name: record for the final kernels line}."""
    gen = torch.Generator(device=dev).manual_seed(7)
    N, F, B, C, L = N_ROWS, N_FEAT, N_BINS, N_CH, N_LEAVES
    X = torch.randint(0, 63, (F, N), generator=gen, device=dev,
                      dtype=torch.uint8)
    vals = torch.randn((C, N), generator=gen, device=dev)
    vals[1] = vals[1].abs() * 0.25            # hessian-like channel
    out = {}

    # -- 1. slot histogram: K=1 is the main path's root histogram
    for K in (1, 16, 128):
        slot = (None if K == 1 else torch.randint(
            -1, K, (N,), generator=gen, device=dev, dtype=torch.int32))
        got = hc.build_histogram_slots_cuda(X, vals, slot, K, B)
        ref = hc.build_histogram_slots_plain(X, vals, slot, K, B)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        # both accumulate in f64 and round once to f32: they may differ by
        # the last f32 bit where the f64 sums of the two addition orders
        # straddle a rounding boundary
        tol = 1e-6 * float(ref.abs().max()) + 1e-6
        check(err <= tol, f"build_histogram_slots K={K}: max |err| {err}")
        rows = N if slot is None else int((slot >= 0).sum())
        s64 = (torch.zeros(N, dtype=torch.int64, device=dev) if slot is None
               else slot.to(torch.int64))
        keep = s64 >= 0
        f_ix = torch.arange(F, device=dev)[:, None]
        c_ix = torch.arange(C, device=dev)[:, None, None]
        flat = (((s64[None, None, :] * C + c_ix) * F + f_ix[None])
                * B + X.to(torch.int64)[None])[:, :, keep].reshape(-1)
        lvals = vals[:, None, keep].expand(C, F, rows).reshape(-1)
        acc = torch.zeros(K * C * F * B, device=dev)
        ms = time_ms(lambda: hc.build_histogram_slots_cuda(
            X, vals, slot, K, B), 20)
        plain_ms = time_ms(lambda: hc.build_histogram_slots_plain(
            X, vals, slot, K, B), 3, 1)
        lib_ms = time_ms(lambda: acc.index_add_(0, flat, lvals), 20)
        nbytes = (0 if slot is None else 4 * N) + rows * (F + 4 * C) \
            + K * C * F * B * 4
        bms, by = bound_ms(nbytes, rows * F * C)
        rec = dict(name="build_histogram_slots", K=K, max_abs_err=err,
                   tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=bms, bound_by=by, bound_us=bms * 1e3)
        emit({"phase": "kernels", "kernel_ms": rec["ms"], **rec})
        if K == 1:
            out["build_histogram_slots"] = rec
        del flat, lvals, acc

    # -- 2. leaf-value gather, L = 255
    values = torch.randn(L, generator=gen, device=dev)
    lor = torch.randint(-2, L + 2, (N,), generator=gen, device=dev,
                        dtype=torch.int32)
    got = hc.take_leaf_values_cuda(values, lor)
    ref = hc.take_leaf_values_plain(values, lor)
    check(torch.equal(got, ref), "take_leaf_values: not bitwise equal")
    lor_ok = lor.clamp(0, L - 1)
    ms = time_ms(lambda: hc.take_leaf_values_cuda(values, lor), 50)
    plain_ms = time_ms(lambda: hc.take_leaf_values_plain(values, lor), 20)
    lib_ms = time_ms(lambda: values[lor_ok], 50)
    bms, by = bound_ms(8 * N + 4 * L, 0)
    rec = dict(name="take_leaf_values", L=L, max_abs_err=0.0, tol=0.0,
               ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
               bound_by=by, bound_us=bms * 1e3)
    emit({"phase": "kernels", "kernel_ms": rec["ms"], **rec})
    out["take_leaf_values"] = rec

    # -- 3. / 5. wave pass and relabel: a mid-tree wave, 120 leaves, 64 of
    # them split, K candidates among the 184 leaves after the split
    nl0, napp = 120, 64
    lor = torch.randint(0, nl0, (N,), generator=gen, device=dev,
                        dtype=torch.int32)
    rng = np.random.RandomState(11)
    for K in (1, 16, 128):
        tbl = _wave_table(torch, rng, F, B - 1, nl0, napp, K, dev)
        got_l, got_h = hc.wave_pass_cuda(X, vals, lor, tbl, K, B, L)
        ref_l, ref_h = hc.wave_pass_plain(X, vals, lor, tbl, K, B, L)
        torch.cuda.synchronize()
        check(torch.equal(got_l, ref_l), f"wave_pass K={K}: leaf_of_row")
        err = float((got_h - ref_h).abs().max())
        tol = 1e-6 * float(ref_h.abs().max()) + 1e-6
        check(err <= tol, f"wave_pass K={K}: max |err| {err}")
        # bytes this data needs: leaf ids in and out, one bin byte per row
        # tested against an applied or candidate split, and the bins and
        # values of the rows that land in a smaller child
        app_rows = int(torch.isin(lor, tbl[0, :napp]).sum())
        cand_rows = int(torch.isin(ref_l, tbl[7, :K]).sum())
        small = _small_rows(hc, torch, X, lor, tbl, K, B, L)
        nbytes = 8 * N + app_rows + cand_rows + small * (F + 4 * C) \
            + K * C * F * B * 4 + 16 * 128 * 4
        bms, by = bound_ms(nbytes, small * F * C)
        ms = time_ms(lambda: hc.wave_pass_cuda(X, vals, lor, tbl, K, B, L),
                     20)
        plain_ms = time_ms(lambda: hc.wave_pass_plain(
            X, vals, lor, tbl, K, B, L), 3, 1)
        rec = dict(name="wave_pass", K=K, max_abs_err=err, tol=tol, ms=ms,
                   plain_ms=plain_ms, library_ms=None, bound_ms=bms,
                   bound_by=by, bound_us=bms * 1e3)
        emit({"phase": "kernels", "kernel_ms": rec["ms"], **rec})
        if K == 16:
            out["wave_pass"] = rec
        if K == 128:
            got = hc.wave_relabel_cuda(X, lor, tbl, L)
            check(torch.equal(got, hc.wave_relabel_plain(X, lor, tbl, L)),
                  "wave_relabel: leaf_of_row not bitwise equal")
            ms = time_ms(lambda: hc.wave_relabel_cuda(X, lor, tbl, L), 50)
            plain_ms = time_ms(lambda: hc.wave_relabel_plain(
                X, lor, tbl, L), 5)
            bms, by = bound_ms(8 * N + app_rows + 16 * 128 * 4, 0)
            rec = dict(name="wave_relabel", max_abs_err=0.0, tol=0.0,
                       ms=ms, plain_ms=plain_ms, library_ms=None,
                       bound_ms=bms, bound_by=by, bound_us=bms * 1e3)
            emit({"phase": "kernels", "kernel_ms": rec["ms"], **rec})
            out["wave_relabel"] = rec
    return out


def _wave_table(torch, rng, F, num_bins, nl0, napp, K, dev):
    """[16, 128] wave table: `napp` applied splits among leaves [0, nl0),
    K candidates among the nl0 + napp leaves after them, the rest
    inactive."""
    t = np.full((16, 128), -1, np.int64)
    t[0, :napp] = rng.choice(nl0, napp, replace=False)
    t[7, :K] = rng.choice(nl0 + napp, K, replace=False)
    for r0 in (1, 8):
        n = napp if r0 == 1 else K
        t[r0, :n] = rng.randint(0, F, n)                     # feature
        t[r0 + 1, :n] = rng.randint(0, num_bins - 1, n)      # threshold
        t[r0 + 2, :n] = rng.randint(0, 2, n)                 # default_left
        t[r0 + 3, :n] = rng.randint(0, 3, n)                 # missing type
        t[r0 + 4, :n] = rng.randint(0, num_bins, n)          # default bin
        t[r0 + 5, :n] = num_bins
    t[14, :K] = rng.randint(0, 2, K)                         # smaller left
    t[15] = nl0
    return torch.from_numpy(t.astype(np.int32)).to(dev)


def variant_phase(hc, torch, dev):
    """The kernels' modes that later slices need, not timed: int8 value
    channels (exact int32 sums, bitwise) and 256 bins (f32, within the
    same tolerance as the main shapes)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    N, F, L = N_ROWS, N_FEAT, N_LEAVES
    rng = np.random.RandomState(12)
    lor = torch.randint(0, 120, (N,), generator=gen, device=dev,
                        dtype=torch.int32)
    res = {}
    for B, dtype in ((64, torch.int8), (256, torch.float32)):
        X = torch.randint(0, B, (F, N), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
        if dtype == torch.int8:
            vals = torch.randint(-127, 128, (2, N), generator=gen,
                                 device=dev, dtype=torch.int32).to(dtype)
        else:
            vals = torch.randn((2, N), generator=gen, device=dev)
        slot = torch.randint(-1, 17, (N,), generator=gen, device=dev,
                             dtype=torch.int32)
        tbl = _wave_table(torch, rng, F, B, 120, 64, 16, dev)
        pairs = [(hc.build_histogram_slots_cuda(X, vals, slot, 16, B),
                  hc.build_histogram_slots_plain(X, vals, slot, 16, B))]
        gl, gh = hc.wave_pass_cuda(X, vals, lor, tbl, 16, B, L)
        rl, rh = hc.wave_pass_plain(X, vals, lor, tbl, 16, B, L)
        torch.cuda.synchronize()
        check(torch.equal(gl, rl), f"wave_pass B={B}: leaf_of_row")
        check(torch.equal(hc.wave_relabel_cuda(X, lor, tbl, L),
                          hc.wave_relabel_plain(X, lor, tbl, L)),
              f"wave_relabel B={B}: leaf_of_row")
        pairs.append((gh, rh))
        for (got, ref), name in zip(pairs, ("build_histogram_slots",
                                            "wave_pass")):
            key = f"{name} B={B} {str(dtype).split('.')[-1]}"
            if dtype == torch.int8:
                check(got.dtype == torch.int32 and torch.equal(got, ref),
                      f"{key}: not bitwise equal")
                res[key] = 0.0
            else:
                err = float((got - ref).abs().max())
                check(err <= 1e-6 * float(ref.abs().max()) + 1e-6,
                      f"{key}: max |err| {err}")
                res[key] = err
    emit({"phase": "kernel_variants", "max_abs_err": res})


def _small_rows(hc, torch, X, lor, tbl, K, B, L):
    """Rows that land in a candidate's smaller child: the plain wave pass
    with one unit value channel counts each such row once per feature."""
    ones = torch.ones((1, X.shape[1]), device=X.device)
    _, h = hc.wave_pass_plain(X, ones, lor, tbl, K, B, L)
    return int(h[:, 0, 0, :].sum())


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    try:
        import lightgbm_tpu_torch as lt
        from lightgbm_tpu_torch.ops import histogram_cuda as hc
    except ImportError as e:
        print(f"chip_smoke: the lightgbm_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    kind = torch.cuda.get_device_name(0)

    # ---- 1. device and build
    t0 = time.perf_counter()
    built = hc.build_kernels()
    build_s = time.perf_counter() - t0
    regs = {n: [ln.strip() for ln in b["log"].splitlines()
                if "registers" in ln] for n, b in built.items()}
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "ptxas": regs})

    # ---- 2. kernels against their plain versions
    krec = kernel_phase(hc, torch, dev)
    variant_phase(hc, torch, dev)

    # ---- 3. train bench.py's model on bench.py's data
    rng = np.random.RandomState(42)
    X = rng.normal(size=(N_ROWS, N_FEAT)).astype(np.float32)
    w = rng.normal(size=N_FEAT)
    y = (X @ w + rng.normal(scale=0.5, size=N_ROWS) > 0).astype(np.float32)
    params = dict(objective="binary", num_leaves=N_LEAVES, max_bin=63,
                  learning_rate=0.1, min_data_in_leaf=20, verbose=-1,
                  bagging_freq=0, binning_impl="host", device_type="cuda",
                  metric="auc")
    t0 = time.perf_counter()
    ds = lt.Dataset(X, label=y, params=params).construct()
    ingest_s = time.perf_counter() - t0
    iter_ends = []

    def stamp(env):
        torch.cuda.synchronize()
        iter_ends.append(time.perf_counter())
    stamp.order = 5

    hc.reset_launch_counts()
    torch.cuda.synchronize()
    t_train = time.perf_counter()
    bst = lt.train(params, ds, num_boost_round=8, callbacks=[stamp])
    torch.cuda.synchronize()
    launches = dict(hc.LAUNCHES)
    starts = [t_train] + iter_ends[:-1]
    iter_ms = [(b - a) * 1e3 for a, b in zip(starts, iter_ends)]
    gbdt = bst._gbdt
    auc = bst.eval_train()[0][2]
    trees = gbdt.models
    leaves = [t.num_leaves for t in trees]
    emit({"phase": "train", "rows": N_ROWS, "features": N_FEAT,
          "iterations": len(iter_ms), "ingest_s": ingest_s,
          "iter_ms": iter_ms,
          "steady_ms_per_iter": float(np.mean(iter_ms[1:])),
          "launches": launches, "train_auc": auc, "leaves": leaves})
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the main path")
    # 8 rounds on 2^20 rows reach a train AUC near 0.886 (both packages
    # agree on smaller cuts of this data); 8 more rounds through
    # update_batch, after the serve phase, must pass 0.9
    check(len(leaves) == 8 and auc > 0.88, f"train AUC {auc} <= 0.88")

    # the first tree again, from the same gradients, with the plain
    # versions on the card: kernels and plain versions accumulate in f64,
    # so the histograms and therefore the trees must agree
    from lightgbm_tpu_torch.ops.grow_wave import grow_tree_wave
    init = float(gbdt.objective.boost_from_score(0))
    s0 = torch.full((N_ROWS,), float(np.float32(init)), device=dev)
    g, h = gbdt.objective.get_gradients(s0, gbdt.label_dev, gbdt.weight_dev)
    tp, _ = grow_tree_wave(gbdt.X_t, g, h, gbdt._in_bag, gbdt.meta,
                           gbdt.grow_cfg, None, plain=True)
    t_plain = gbdt._device_tree_to_host(tp)
    t_plain.add_bias(init)
    t_kern = trees[0]
    same = (t_plain.num_leaves == t_kern.num_leaves
            and all(np.array_equal(getattr(t_plain, a), getattr(t_kern, a))
                    for a in ("split_feature", "threshold_in_bin",
                              "left_child", "right_child")))
    lv_err = float(np.max(np.abs(t_plain.leaf_value - t_kern.leaf_value))) \
        if same else None
    emit({"phase": "first_tree", "same_structure": same,
          "leaves": t_kern.num_leaves, "leaf_value_max_abs_err": lv_err})
    check(same, "first tree differs from the plain versions' tree")
    # leaf values come from the same f32 split statistics: 1e-6 absolute
    check(lv_err <= 1e-6, f"first tree leaf values differ by {lv_err}")

    # ---- 4. serve held-out rows, then again after a model text round trip
    rng_t = np.random.RandomState(43)
    Xt = rng_t.normal(size=(4096, N_FEAT)).astype(np.float32)
    yt = (Xt @ w + rng_t.normal(scale=0.5, size=4096) > 0)
    t0 = time.perf_counter()
    p1 = bst.predict(Xt)
    serve_ms = (time.perf_counter() - t0) * 1e3
    text = bst.model_to_string()
    p2 = lt.Booster(model_str=text).predict(Xt)
    check(p1.shape == (4096,) and np.all(np.isfinite(p1)),
          "predictions are not 4096 finite values")
    check(np.array_equal(p1, p2), "predictions changed over a model text "
                                  "round trip")
    # raw predictions of training rows reproduce the trainer's f32 scores
    raw = bst.predict(X[:4096], raw_score=True)
    sc = gbdt.scores[0, :4096].cpu().numpy().astype(np.float64)
    score_err = float(np.max(np.abs(raw - sc)))
    check(score_err < 1e-4, f"raw predictions differ from the trainer's "
                            f"scores by {score_err}")
    order = np.argsort(p1)
    ranks = np.empty(len(p1))
    ranks[order] = np.arange(1, len(p1) + 1)
    npos = int(yt.sum())
    test_auc = (ranks[yt].sum() - npos * (npos + 1) / 2) \
        / (npos * (len(yt) - npos))
    emit({"phase": "serve", "rows": 4096, "predict_ms": serve_ms,
          "roundtrip_bitwise": True, "score_max_abs_err": score_err,
          "heldout_auc": float(test_auc), "model_text_bytes": len(text)})

    # ---- 5. train on: 8 more rounds of the same booster
    bst.update_batch(8)
    auc16 = bst.eval_train()[0][2]
    emit({"phase": "train_on", "iterations": bst.current_iteration,
          "train_auc": auc16})
    check(bst.current_iteration == 16 and auc16 > 0.9,
          f"train AUC after 16 rounds {auc16} <= 0.9")

    src = {"build_histogram_slots": "hist_slots.cu",
           "take_leaf_values": "take_leaf_values.cu",
           "wave_pass": "wave_pass.cu", "wave_relabel": "wave_relabel.cu"}
    replaces = {
        "build_histogram_slots":
            "lightgbm_tpu/ops/histogram_pallas.py:280",
        "take_leaf_values": "lightgbm_tpu/ops/histogram_pallas.py:340",
        "wave_pass": "lightgbm_tpu/ops/histogram_pallas.py:562",
        "wave_relabel": "lightgbm_tpu/ops/histogram_pallas.py:718"}
    kernels = []
    for name in hc.KERNELS:
        r = krec[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"lightgbm_tpu_torch/csrc/{src[name]}",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": {k: r[k] for k in ("K", "L") if k in r},
            "pass": True})
    emit({"kernels": kernels})
    for line in smi:
        print(line)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
