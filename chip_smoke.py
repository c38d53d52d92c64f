#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lightgbm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. device    the card (nvidia-smi name and power limit) and the build of
               every kernel from lightgbm_tpu_torch/csrc (nvcc, in parallel)
  2. kernels   each training kernel against its plain PyTorch version at
               the main path's shapes (N = 2^20 rows, F = 28, B = 64, C = 2;
               K in {1, 16, 128}, the slot histogram also with half of the
               rows active, the wave pass on a mid-tree wave ("few"), on a
               wave whose smaller children hold about half of the rows
               ("half") and on 2^16 rows (the direct route), bitwise on
               grid values; L = 255, the score update in place and the
               gather), with kernel / plain / library times, the bytes
               bound and the wave pass's launches per call; then, untimed,
               the int8 (exact int32) and 256-bin (wave pass at its K cap
               of 32) modes of the histogram and wave kernels, the slot
               histogram on narrow storage, where several slots share a
               tile (bitwise, both channel layouts), and the wave pass and
               relabel on a table naming a leaf twice (the lowest entry
               wins, as in the plain versions; bitwise). Every kernel and
               library time is given twice: `ms`, the mean call time by CUDA
               events over back-to-back calls (the host's issue rate where
               that is the slower side), and `device_ms`, the device's own
               time per call (kernels and memsets) under torch.profiler;
               the score update's calls rotate over operands of twice L2,
               so that each reads HBM
  3. ingest    bench.py's data (numpy seed 42, 2^20 x 28 f32) constructed
               with binning_impl=auto, which must take the device route
               (the bucketize kernel, launch count > 0) and give X_t
               bitwise equal to a host-route construct of the same data
  4. bucketize the bucketize kernel against its plain version at 2^20,
               2^18 (an ingest chunk), 256 and 8 rows (served buckets) x
               28 features, bitwise in both output layouts, on three
               tables: train mode from the bench data's mappers, serve
               mode, and a synthetic table of categorical, NaN-missing and
               zero-missing features fed adversarial values (NaN, +-0,
               subnormals, +-inf, every bound and one ulp either side);
               timed at each shape in the layout the main path writes
               there, with the bound and the launch plan; and with a
               permuted column selection at 2^18 and 256 rows, bitwise
  5. train     bench.py's model (binary, 255 leaves, max_bin 63) trained 8
               rounds through lightgbm_tpu_torch.train on the card; every
               training kernel's launch count must be > 0 and train AUC >
               0.88, the score update must launch once per tree, and the
               first tree must equal the one grown from the same gradients
               by the plain versions on the card
  6. predict   4096 held-out rows predicted by the trained Booster, and
               again after a model text round trip: bitwise equal
  7. serve     Booster.serve(engine="binned", max_batch=256, warmup=True)
               scores the held-out f32 rows on the raw-f32 route (bucketize
               launches > 0), bitwise equal to the f64 route and to
               engine="device", within 1e-5 of Booster.predict; then a
               ModelRegistry + MicroBatcher answers 512 single-row f32
               requests from 4 threads, each equal to its batch score, with
               host_fallbacks == 0; then Booster.predict of the 2^20
               training rows takes the device route, within 1e-5 of the
               host walk
  8. train on  8 more rounds of the same Booster through update_batch must
               lift train AUC past 0.9
  9. the wave-apply route (wide, categorical and EFB data):
     criteo          the Criteo-shaped table (lightgbm_tpu_torch/utils/
                     synthetic.py: 2^20 x 39, 26 categorical columns,
                     max_bin 255) ingested on the device route (X_t
                     bitwise equal to the host route) and trained 8 rounds
                     on the apply route: wave_apply and the slot histogram
                     launch, wave_pass and wave_relabel do not, and no
                     dec_go_left decision matrix is built; train AUC
                     never falls between rounds and passes CRITEO_AUC_MIN;
                     the first tree equals the plain versions' tree
     row-wise        the slot histogram and the row-wise kernels (plain
                     and nibble-packed, both on the tiled engine) against
                     their plain versions, bitwise, on the Criteo storage
                     at K in {1, 16, 128}, also with half of the rows
                     active, and K = 16 "half" on 2^16 rows, timed; the
                     row-wise buffers also against the col-wise slot
                     kernel; then 2 rounds under force_row_wise and 2
                     under histogram_impl=rowwise_packed grow the col-wise
                     run's first two trees
     criteo serve    the Criteo model through the binned engine on raw f32
                     rows with unseen, negative and NaN categories:
                     bitwise equal to the f64 route and the device engine,
                     within 1e-5 of Booster.predict
     efb             2^19 rows of 30 one-hot sparse and 30 dense columns,
                     4 rounds: bundles form, the apply route runs without
                     a decision matrix, the first tree equals the plain
                     versions'; then 2 rounds
                     under histogram_impl=fused: vetoed (efb_bundled), the
                     apply route, the same trees
     narrow_cat      2^19 rows of 4 count and 8 categorical Criteo-shaped
                     columns at max_bin 63, 2 rounds on the apply route,
                     whose slot histograms put several slots in a tile: the
                     first tree equals the plain versions'
     wave_apply      the wave_apply kernel, which decides each row under
                     the wave's split records, at 2^20 rows, L = 255, Kd
                     in {16, 128}, on split records drawn from three
                     storages (the bench storage with every missing type,
                     the Criteo storage with 8-word bitsets, the EFB
                     storage): bitwise against its plain version and
                     against dec_go_left + wave_apply_plain, timed beside
                     that decision build
 10. the fused routes (histogram_impl="fused"), whose kernels also run the
     best-split search of every candidate's two children:
     fused_kernels   kernel #9 (wave_pass_fused) against its plain version
                     at the bench storage (2^20 x 28, B = 64), K in
                     {1, 16, 64}, "few" and "half" waves as the wave pass's,
                     K = 16 "half" on 2^16 rows (the direct route) and on a
                     table naming a leaf twice; kernel #10
                     (wave_pass_fused_tiled) at the
                     Criteo storage (K in {1, 16}; K = 16 with about half
                     of the rows in a smaller child, a real wave's shape,
                     on 2^20 rows and, on the direct route, 2^16), at
                     F = 100 / B = 64 with a live pending relabel, and with
                     int8 values: leaf_of_row, histogram and split records
                     bitwise on grid values, the chosen splits equal on
                     continuous ones (their largest float differences
                     printed); both under the warp-per-feature scan, with
                     their kernel launches per call
     fused_train     bench.py's model under histogram_impl=fused, 8 rounds:
                     route "fused", kernel #9 launched and wave_pass not,
                     AUC > 0.88, first tree equal to the plain versions'
     criteo_fused    the Criteo table under histogram_impl=fused, 8 rounds:
                     route "fused_tiled", kernel #10 launched, AUC never
                     falls and passes CRITEO_AUC_MIN, first tree equal to
                     the plain versions', 2 rounds with
                     fused_relabel_fusion=false grow the same trees; and
                     the first tree of the plain versions with the f32
                     prefix scan the search used before against the f64
                     one (printed, not checked)
 11. the constraints (monotone `basic`, interaction sets):
     constraints_kernel  kernel #10 with its monotone operand live (every
                     odd child bounded, the features' directions mixed) on
                     the Criteo storage at K in {1, 16}: records bitwise
                     equal to its plain version on grid values, chosen
                     splits equal on continuous ones, some records changed
                     by the operand; timed beside the same call with the
                     operand off
     constraints_train   bench.py's model with features 0-3 constrained
                     in their weights' directions (+1 / +1 / +1 / -1), 4
                     rounds on the megakernel route and 4 under
                     histogram_impl=fused (route "fused_tiled"): first
                     tree equal to the plain versions' and unlike the
                     unconstrained run's, AUC > 0.75, and the raw score of
                     4096 rows never moves against a constraint along a
                     32-point sweep of its feature and moves along some
                     (the device predictor); then the Criteo table with two
                     interaction sets, 2 rounds on the apply route and 2
                     under fused: first tree equal to the plain versions',
                     every branch inside one set

 11b. the rest of the constraints, on the two-pass routes (each line with
     the card's nvidia-smi name and power limit):
     intermediate    monotone_constraints_method=intermediate: bench.py's
                     model with features 0-3 constrained, 2 rounds on
                     "mega" (#1, #3, #5, #2) beside 2 of `basic`, and the
                     Criteo table with its two heaviest count columns
                     constrained, 2 rounds on "apply" (#4, #1): first tree
                     equal to the plain versions', raw scores never against
                     a constraint along a 32-point sweep, histogram_impl=
                     fused vetoed naming monotone_intermediate; waves per
                     tree, ms per round, train logloss beside basic's
     forced_cegb     a forced root and both its children (bench, "mega", 2
                     rounds): trees 0 and 1 carry them in BFS order with
                     the forced bin thresholds, first tree equal to the
                     plain versions'; CEGB split and coupled penalties on
                     the Criteo table ("apply", 4 rounds) beside the run
                     without: trees 0 and 1 equal the plain versions'
                     (tree 1 grown with tree 0's features paid), no more
                     distinct features; the fused vetoes forced_splits and
                     cegb

 13. objectives, multiclass, ranking and per-node sampling (each line
     with the card's nvidia-smi name and power limit):
     multiclass      bench's 28 columns, labels in 5 classes from a seeded
                     projection, 255 leaves: 4 rounds of softmax on
                     "mega", 2 under fused (#9), 2 of multiclassova; the
                     first iteration's 5 trees equal the plain versions',
                     multi_logloss falls every round, launches per round;
                     for softmax: probabilities sum to 1 within 1e-6, the
                     device predictor within 1e-5 of the host walk on
                     [N, 5], pred_leaf [n, 20] equal to the device walk's
                     leaves, a bitwise model-text trip, serving margins
                     [5, n] equal to Booster.predict(raw_score=True), and
                     #2 on a row view of the [5, N] scores bitwise its
                     plain version
     objectives      the bench table, 2 rounds each of l1, huber, fair,
                     quantile, mape, poisson, gamma, tweedie, xentropy
                     and xentlambda: each one's metric falls; the first
                     trees of l1 (renewed) and poisson equal the plain
                     versions'; the renewal's host ms a tree
     bynode_xt       the bench model, 4 rounds each with
                     feature_fraction_bynode=0.5 and extra_trees: the
                     card's draws bitwise the CPU's, the first tree equal
                     to the plain versions', AUC > 0.85, and under fused
                     the veto naming the parameter
     rank            MSLR-WEB30K's schema (136 numeric features, relevance
                     0-4, queries of 64-256 documents), 2^20 documents,
                     max_bin 255, the apply route: 2 rounds of lambdarank
                     (ndcg@1,3,5,10) and 2 of rank_xendcg; the first tree
                     equal to the plain versions', the card's lambdarank
                     gradients at iterations 0 and 1 within rtol 1e-5 of
                     a CPU copy's, ndcg@10 above the initial scores'; the
                     gradient's device ms

 14. the training loop (its line with the card's name and power limit):
     continued       bench.py's model, 4 rounds saved as text, then
                     lt.train(init_model=text) for 4 more: the replayed
                     training scores (the device binned walk, #2 once a
                     tree) within 1e-6 of predict(raw_score) and bitwise
                     the CPU replay's, 8 trees; a valid set of 2^18 rows
                     added after training within 1e-5 of predict; an fobj
                     of binary logloss in torch on the card grows the
                     built-in objective's first tree, feval reported each
                     round; reset_parameter's rates are the trees'
                     shrinkage; refit of the 2^18 rows at decay 0.9 within
                     1e-6 of the CPU refit, at 1.0 the model text unchanged
 15. the other boosting modes (one line, with the card's name and power
     limit):
     boosting_modes  bench.py's model: boosting=rf with bagging 0.8 every
                     round, 4 rounds (first tree as the plain versions',
                     average_output in the text, predict(raw_score) of the
                     training rows within 1e-5 of scores / iterations, AUC
                     rising over the rounds, > 0.83); boosting=dart with
                     drop_rate 0.3, skip_drop 0, 8 rounds and a 2^18-row
                     valid set (the drop sets those of a CPU run of the
                     same RandomState, training and
                     valid scores within 1e-5 of predict(raw_score), #2
                     launched once a tree and three times a dropped tree);
                     linear_tree=True beside constant leaves, 4 rounds each
                     (tree 0 constant, later trees linear, the training
                     scores within 1e-4 of the host walk's predict, a lower
                     train logloss, the host fit's ms a tree); then
                     rollback_one_iter on the dart and linear boosters,
                     their scores within 1e-5 of the rolled-back model's
                     predict(raw_score); ms a round and launches of each
                     run
 16. the serial growers and strict leaf-wise order (one line, with the
     card's name and power limit):
     serial_growers  bench.py's model and table, 2 rounds each of
                     tpu_grower=masked (#1 at K = 2 a split), compact (#1
                     over each split's window), wave_exact on
                     "mega" and under histogram_impl=fused; then the
                     Criteo table, 2 rounds of wave_exact on "apply": each
                     first tree equal to the same grower's with the plain
                     versions, masked's leaf counts equal to a bincount of
                     its leaf_of_row, tree 0 of masked, compact and
                     wave_exact compared split by split (a divergence
                     must be a float tie, gains within 1e-5 relative),
                     train AUC within 0.01 of the batched wave run's after
                     2 rounds, training scores within 1e-5 of
                     predict(raw_score); then tpu_grower=auto under two
                     histogram_pool_size values, which pick compact and
                     masked; launches, waves and host reads per tree and
                     ms a round recorded
     batched         masked and compact batched (a split graph replayed
                     four at a time), 2 rounds each beside their
                     per-iteration runs: model text md5 equal, the start,
                     split and finish graphs captured once, #1 (and for
                     compact the window partition) inside the split
                     graph, at most ceil(splits / 4) + 1 reads a tree;
                     one more round of each path under torch.profiler:
                     device-busy ms and share, device ms a split

 17. batched training, lt.train's default path (one line a case, with
     the card's name and power limit; every earlier line passes
     batched_train=False and runs per iteration):
     batched         bench 37 rounds (a chunk of 32 and a tail of 5),
                     bench with bagging 0.8 every round and with quantized
                     gradients, 16 rounds each, bench with a 2^18-row
                     valid set (auc, binary_logloss) 32 rounds, the Criteo
                     table 16 rounds on "apply" and 2 under force_row_wise,
                     each beside the same configuration per iteration: the
                     model text md5 equal, batched_veto empty, the start,
                     wave and finish graphs captured once each (none on
                     the tail), at most ceil(waves / 4) + 1 blocking reads
                     a tree; the replayed metric values within 1e-5
                     relative of the host evaluation with the same
                     best_iteration; bench's first tree through the
                     fixed-shape step equal to the bucketed grower's; ms a
                     round and device-busy share of both paths, graph
                     replays and launches a round, inert waves a tree and
                     the drain's lag recorded; then the regimes of the
                     extended step, each beside its per-iteration run with
                     the same checks: bench under histogram_impl=fused 16
                     rounds (#9), Criteo under it 8 (#10) and with
                     quantized gradients 4 (#10's descale factors from
                     device memory), bench with features 0-3 monotone
                     intermediate 2, wave_exact on bench 4 and Criteo 2,
                     bench with a forced root and both children 4; the
                     route kernel's launches a round above 0 (it ran in
                     the replayed graphs), the wave graph's launches and
                     one replay's device operations and ms recorded
 18. the runtime, the estimators and SHAP values (one line a case, with
     the card's name and power limit):
     profile         device_profile=true on bench.py's model, 4 rounds
                     per iteration and one batched chunk of 8, each beside
                     the unprofiled run: per-stage ms a round with
                     `other`, the init-time spans, the run's HBM peak, the
                     stage probe (#1, the split search, a partition on
                     16384 rows), profiled and unprofiled ms a round;
                     every record's stages within 20% of its wall, X_t's
                     bytes <= the HBM peak <= the card's memory, the model
                     md5 equal to the unprofiled run's; then the binned
                     ServingSession with a profiler: margins bitwise those
                     without one, bin_rows_rows the rows served, one
                     bin_rows span a bucketize launch
     autotune        autotune=true with a fresh cache file, bench (the
                     narrow fused arm, #3 + search against #9) and Criteo
                     (39 columns, the tiled arm, #4 + #1 + search against
                     #10), 2 rounds each: the decision and every timing,
                     the autotune span's seconds; a second construction
                     cached "memory", a third after the in-process cache
                     is cleared "disk"; the model md5 equal to the run
                     pinned to the decision; the fused-wave probe called
                     directly where a row-wise layout won first, so both
                     arms run; batched steady ms a round untuned, tuned
                     and pinned row-wise (order untuned, tuned, rowwise,
                     rowwise, tuned, untuned); then
                     the binning decision at bench's shape with #6's ms
                     and the host loop's
     sklearn         LGBMClassifier 8 rounds on bench's table (the
                     fallback base where scikit-learn is missing): md5
                     equal to lt.train's with its parameters, held-out
                     AUC; LGBMRanker 2 rounds on the ranking table
                     (2^18 documents); pred_contrib of 1024 held-out
                     rows (both cut so that the cli and resilience
                     lines fit the run's time), each row's sum within
                     1e-6 of predict(raw_score=True)
 19. more than 256 bins a feature (uint16 storage; one line a case):
     wide_bins       bench.py's table at max_bin=1023, 4 rounds; the
                     Criteo schema with six categorical columns of
                     300-1000 categories at 1023, 2 rounds; the ranking
                     table (2^17 documents) at 1023, 1
                     round, where the histogram_pool_size ladder picks
                     compact: each per
                     iteration and batched (md5 equal; bench and Criteo
                     beside a max_bin=255 run), the host
                     binning route, the apply route (compact for
                     ranking), the first tree equal to the plain versions'
                     (bench, Criteo), train AUC at least the 255 run's
                     less 0.01 (ranking: ndcg@10 above the initial
                     scores'), ingest seconds and launches a round
     wide_kernels    #1 on the uint16 storages at K = 1 and 128 (bitwise
                     on grid values), timed beside its plain version and
                     index_add_; then #4 on the Criteo one (kernels lines,
                     Kd 16 / 128, bitwise)
     kernels         the compact grower's window operations on the bench
                     storage and its uint16 one: #1 over a window of the row
                     order and the partition kernel, windows of half the
                     rows and of 2^14 rows, bitwise against their plain
                     versions and timed

 20. text files, the command line, checkpoints (one line each, with the
     card's name and power limit):
     cli             bench.py's table cut to 2^18 training rows and a
                     2^16-row valid file (a 2^20-row text file would cost
                     most of the line's time), written as TSV with %.9g
                     (f32 round-trips); `python -m lightgbm_tpu_torch
                     config=train.conf` on the card, 8 rounds, metric=auc,
                     snapshot_freq=4, device_profile with profile_output;
                     then task=predict on the valid file, task=refit and
                     task=convert_model (cpp), these three side by side
                     (each reads the model only): every exit code 0, the
                     model file md5-equal to an in-process lt.train with
                     the same params on load_text_file's arrays, the
                     prediction file equal to Booster.predict of the same
                     rows, the snapshots' manifests at 4 and 8 verified,
                     8 profile records, the native parser named in the
                     run's log; parse seconds native and Python on the
                     valid file, seconds from the file to the first round,
                     each command's wall seconds
     resilience      the bench table (2^20 x 28, 255 leaves) on
                     lt.train's batched default, bagging 0.8 every round,
                     16 rounds, checkpoint_interval=4: (a) uninterrupted
                     with checkpoints; (b) a child process under
                     fault_plan=kill@iter=10 exits 17 leaving
                     ckpt_iter_0000008; (c) resumed from (b); (d) 10
                     rounds under corrupt_snapshot@iter=8, iteration 8's
                     manifest failing, resumed to 16 from iteration 4:
                     (a), (c), (d) and a run without checkpoints md5-equal;
                     ms and bytes a save, ms to load and to restore a
                     state, batched ms a round with and without
                     checkpoints

then a {"kernels": [...]} line (the eleven kernels, #1 and #4 with their
uint16 times), the nvidia-smi line,
and last
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
L2_BYTES = 50 << 20           # H100 SXM L2 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
N_ROWS, N_FEAT, N_BINS, N_CH, N_LEAVES = 1 << 20, 28, 64, 2, 255
# ndcg@10 of one lambdarank round at max_bin=1023 may sit this far below
# the max_bin=255 round's (wide_bins_phase's ranking case): on the CPU, the
# JAX package's compact grower reads 0.6333 against 0.6487 on the ranking
# table cut to 2^14 documents, and the port 0.5237 against 0.5506 (the JAX
# package's own 255-bin value) at 2^16; about twice the larger gap
RANK_WIDE_GAP = 0.05
# train AUC after 8 rounds of the Criteo-shaped table at 2^20 rows: the
# port on the CPU reaches CRITEO_AUC_CPU (plain versions); the card must
# pass CRITEO_AUC_MIN
CRITEO_AUC_CPU = 0.7982
CRITEO_AUC_MIN = 0.79


def _ptxas(log):
    """{entry function (mangled): its spill, register and shared-memory
    lines} from nvcc's -Xptxas -v output."""
    out, fn = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif fn and ("registers" in ln or "spill" in ln):
            out.setdefault(fn, []).append(ln.split(":", 1)[-1].strip())
    return out


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


def timings(fn, reps, warmup=2, stats=None):
    """(ms, device_ms) of fn(): `ms` is time_ms's mean call time over
    `reps` back-to-back calls, which includes the host's issue rate where
    that is the slower side; `device_ms` is the sum of the device's
    activity (kernels and memsets) per call under torch.profiler over
    another `reps` calls. A session now and then records no device
    activity, or only part of it, so two sessions that saw some are run
    (at most eight in all) and the larger is kept; with `stats` (a dict)
    its kernel launches per call, memsets not counted, are stored under
    "kernels_per_call"."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    ms = time_ms(fn, reps, warmup)
    best_us, best_n, seen = 0.0, 0, 0
    for _ in range(8):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [ev for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
        us = sum(ev.time_range.elapsed_us() for ev in dev)
        if us > best_us:
            best_us = us
            best_n = sum("memset" not in ev.name.lower() for ev in dev)
        seen += us > 0
        if seen == 2:
            break
    check(best_us > 0, "torch.profiler saw no device activity in 8 sessions")
    if stats is not None:
        stats["kernels_per_call"] = best_n / reps
    return ms, best_us / 1e3 / reps


def _slot_case(torch, gen, N, K, active, dev):
    """The slot array of a histogram case: None at K = 1; "random": slots
    uniform in [-1, K) (94% of rows active at K = 16); "half": about half
    of the rows in a slot uniform in [0, K), the rest -1, as a wave's
    smaller children."""
    if K == 1:
        return None
    if active == "random":
        return torch.randint(-1, K, (N,), generator=gen, device=dev,
                             dtype=torch.int32)
    slot = torch.randint(0, K, (N,), generator=gen, device=dev,
                         dtype=torch.int32)
    slot[torch.rand(N, generator=gen, device=dev) < 0.5] = -1
    return slot


def _flat_index_add(torch, X, vals, slot, K, B, width=None, offs=None):
    """The library yardstick of a slot histogram: (flat indices, values,
    zeroed f32 accumulators) for one index_add_ over the active rows' (slot,
    channel, feature, bin) cells; `width` / `offs` give the row-wise flat
    layout (per-feature bin widths and offsets), else the uniform grid."""
    F, N = X.shape
    C = vals.shape[0]
    dev = X.device
    s64 = (torch.zeros(N, dtype=torch.int64, device=dev) if slot is None
           else slot.to(torch.int64))
    keep = s64 >= 0
    rows = int(keep.sum())
    b = X[:, keep].to(torch.int64)
    c_ix = torch.arange(C, device=dev)[:, None, None]
    lv = vals[:, None, keep].expand(C, F, rows).reshape(C, -1)
    if width is None:
        f_ix = torch.arange(F, device=dev)[:, None]
        flat = ((s64[keep][None, None, :] * C + c_ix) * F + f_ix[None]) \
            * B + b[None]
        total = K * C * F * B
        return flat.reshape(-1), lv.reshape(-1), torch.zeros(total,
                                                               device=dev)
    ok = (b < width).reshape(-1)
    tot = int(offs[-1] + width[-1])
    flat = ((s64[keep][None, None, :] * C + c_ix) * tot
            + (offs + b)[None]).reshape(C, -1)[:, ok].reshape(-1)
    return flat, lv[:, ok].reshape(-1), torch.zeros(K * C * tot, device=dev)


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

    # -- 1. slot histogram: K=1 is the main path's root histogram; the
    # "half" cases have the row count of a wave's smaller children
    grid = _grid_vals(torch, gen, C, N, dev)
    for K, active in ((1, "all"), (16, "random"), (128, "random"),
                      (16, "half"), (128, "half")):
        slot = _slot_case(torch, gen, N, K, active, dev)
        got = hc.build_histogram_slots_cuda(X, vals, slot, K, B)
        ref = hc.build_histogram_slots_plain(X, vals, slot, K, B)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        # both accumulate in f64 and round once to f32: they may differ by
        # the last f32 bit where the f64 sums of the two addition orders
        # straddle a rounding boundary
        tol = 1e-6 * float(ref.abs().max()) + 1e-6
        check(err <= tol, f"build_histogram_slots K={K} {active}: max |err| "
                          f"{err}")
        check(torch.equal(hc.build_histogram_slots_cuda(X, grid, slot, K, B),
                          hc.build_histogram_slots_plain(X, grid, slot, K,
                                                         B)),
              f"build_histogram_slots K={K} {active}: not bitwise on grid "
              f"values")
        rows = N if slot is None else int((slot >= 0).sum())
        flat, lvals, acc = _flat_index_add(torch, X, vals, slot, K, B)
        ms, dms = timings(lambda: hc.build_histogram_slots_cuda(
            X, vals, slot, K, B), 20)
        plain_ms = time_ms(lambda: hc.build_histogram_slots_plain(
            X, vals, slot, K, B), 3, 1)
        lib_ms, lib_dms = timings(lambda: acc.index_add_(0, flat, lvals), 20)
        nbytes = (0 if slot is None else 4 * N) + rows * (F + 4 * C) \
            + K * C * F * B * 4
        bms, by = bound_ms(nbytes, rows * F * C)
        rec = dict(name="build_histogram_slots", shape="bench", K=K,
                   active=active, rows=rows, max_abs_err=err, tol=tol,
                   ms=ms, device_ms=dms, plain_ms=plain_ms,
                   library_ms=lib_ms, library_device_ms=lib_dms,
                   bound_ms=bms, bound_by=by, bound_us=bms * 1e3,
                   plan=hc.plan_hist_tiles(K, C, F, B)._asdict())
        emit({"phase": "kernels", "kernel_ms": rec["ms"], **rec})
        if K == 1:
            out["build_histogram_slots"] = rec
        del flat, lvals, acc

    # -- 2. leaf values, L = 255: the in-place score update of the main
    # path and the gather, each bitwise equal to its plain version
    values = torch.randn(L, generator=gen, device=dev)
    lor = torch.randint(-2, L + 2, (N,), generator=gen, device=dev,
                        dtype=torch.int32)
    got = hc.take_leaf_values_cuda(values, lor)
    ref = hc.take_leaf_values_plain(values, lor)
    check(torch.equal(got, ref), "take_leaf_values: not bitwise equal")
    scores = torch.randn(N, generator=gen, device=dev)
    s_k = hc.add_leaf_values_cuda(scores.clone(), values, lor)
    s_p = hc.add_leaf_values_plain(scores.clone(), values, lor)
    check(torch.equal(s_k, s_p), "add_leaf_values: not bitwise equal")
    # timed over a rotation of (scores, leaf ids) pairs whose bytes exceed
    # L2 twice over, so that each call reads its operands from HBM, as the
    # main path's one update per tree does; back-to-back calls on one pair
    # would keep its 8 MB in L2
    rot = [(torch.randn(N, generator=gen, device=dev),
            torch.randint(-2, L + 2, (N,), generator=gen, device=dev,
                          dtype=torch.int32))
           for _ in range(-(-2 * L2_BYTES // (8 * N)))]
    rot_ok = [lr.clamp(0, L - 1) for _, lr in rot]
    turn = [0]

    def rotating(fn):
        def call():
            turn[0] = (turn[0] + 1) % len(rot)
            return fn(*rot[turn[0]], rot_ok[turn[0]])
        return call
    ms, dms = timings(rotating(
        lambda sc, lr, _: hc.add_leaf_values_cuda(sc, values, lr)), 50)
    g_ms, g_dms = timings(rotating(
        lambda _, lr, __: hc.take_leaf_values_cuda(values, lr)), 50)
    plain_ms = time_ms(rotating(
        lambda sc, lr, _: hc.add_leaf_values_plain(sc, values, lr)), 20)
    lib_ms, lib_dms = timings(rotating(
        lambda sc, _, lo: sc.add_(values[lo])), 50)
    g_lib_ms, g_lib_dms = timings(rotating(lambda _, __, lo: values[lo]),
                                  50)
    del rot, rot_ok
    # in place: a leaf id and a score read and the score written per row
    bms, by = bound_ms(12 * N + 4 * L, 0)
    g_bms, _ = bound_ms(8 * N + 4 * L, 0)
    rec = dict(name="take_leaf_values", form="in-place score update", L=L,
               max_abs_err=0.0, tol=0.0, ms=ms, device_ms=dms,
               plain_ms=plain_ms, library_ms=lib_ms,
               library_device_ms=lib_dms,
               library_call="scores += values[lor] (gather, then add)",
               bound_ms=bms, bound_by=by, bound_us=bms * 1e3,
               rotation_bytes=-(-2 * L2_BYTES // (8 * N)) * 8 * N,
               gather_ms=g_ms, gather_device_ms=g_dms,
               gather_library_ms=g_lib_ms,
               gather_library_device_ms=g_lib_dms, gather_bound_ms=g_bms)
    emit({"phase": "kernels", "kernel_ms": rec["ms"], **rec})
    out["take_leaf_values"] = rec

    # -- 3. / 5. wave pass and relabel. "few": a mid-tree wave, 120
    # leaves, 64 of them split, K candidates among the 184 leaves after
    # the split, whose smaller children hold a few percent of the rows;
    # "half": every leaf after the split a candidate (K / 2 leaves, K / 2
    # of them split; at K = 1 the root), so that about half of the rows
    # land in a smaller child, a real wave's shape; "half_2^16" the same on
    # the first 2^16 rows (the direct route)
    rng = np.random.RandomState(11)
    cases = [(1, "few", N), (16, "few", N), (128, "few", N),
             (1, "half", N), (16, "half", N), (128, "half", N),
             (16, "half_2^16", 1 << 16)]
    for K, case, n in cases:
        nl0, napp = (120, 64) if case == "few" else (max(K // 2, 1), K // 2)
        Xw, vw, gw = ((X, vals, grid) if n == N else
                      (X[:, :n].contiguous(), vals[:, :n].contiguous(),
                       grid[:, :n].contiguous()))
        lor = torch.randint(0, nl0, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
        tbl = _wave_table(torch, rng, F, B - 1, nl0, napp, K, dev)
        got_l, got_h = hc.wave_pass_cuda(Xw, vw, lor, tbl, K, B, L)
        ref_l, ref_h = hc.wave_pass_plain(Xw, vw, lor, tbl, K, B, L)
        torch.cuda.synchronize()
        key = f"wave_pass K={K} {case}"
        check(torch.equal(got_l, ref_l), f"{key}: leaf_of_row")
        err = float((got_h - ref_h).abs().max())
        tol = 1e-6 * float(ref_h.abs().max()) + 1e-6
        check(err <= tol, f"{key}: max |err| {err}")
        check(torch.equal(hc.wave_pass_cuda(Xw, gw, lor, tbl, K, B, L)[1],
                          hc.wave_pass_plain(Xw, gw, lor, tbl, K, B, L)[1]),
              f"{key}: not bitwise on grid values")
        # bytes this data needs: leaf ids in and out, one bin byte per row
        # tested against an applied or candidate split, and the bins and
        # values of the rows that land in a smaller child
        app_rows = int(torch.isin(lor, tbl[0, :napp]).sum())
        cand_rows = int(torch.isin(ref_l, tbl[7, :K]).sum())
        small = _small_rows(hc, torch, Xw, lor, tbl, K, B, L)
        nbytes = 8 * n + app_rows + cand_rows + small * (F + 4 * C) \
            + K * C * F * B * 4 + 16 * 128 * 4
        bms, by = bound_ms(nbytes, small * F * C)
        st = {}
        ms, dms = timings(lambda: hc.wave_pass_cuda(Xw, vw, lor, tbl, K, B,
                                                    L), 20, stats=st)
        plain_ms = time_ms(lambda: hc.wave_pass_plain(
            Xw, vw, lor, tbl, K, B, L), 3, 1)
        lay = hc.wave_hist_layout(K, C, F, B, n, False, hc._sm_count(0))
        rec = dict(name="wave_pass", K=K, case=case, N=n, small_rows=small,
                   max_abs_err=err, tol=tol, ms=ms, device_ms=dms,
                   plain_ms=plain_ms, library_ms=None, bound_ms=bms,
                   bound_by=by, bound_us=bms * 1e3,
                   launches_per_call=st["kernels_per_call"],
                   plan=lay.plan._asdict())
        emit({"phase": "kernels", "kernel_ms": rec["ms"], **rec})
        if case == "half_2^16":
            check(lay.plan.direct, f"{key}: not on the direct route")
        if K == 16 and case == "few":
            out["wave_pass"] = rec
        if K == 128 and case == "few":
            ref = hc.wave_relabel_plain(X, lor, tbl, L)
            got = hc.wave_relabel_cuda(X, lor, tbl, L)
            check(torch.equal(got, ref),
                  "wave_relabel: leaf_of_row not bitwise equal")
            # in place, as the grower runs it
            lor_ip = lor.clone()
            got = hc.wave_relabel_cuda(X, lor_ip, tbl, L, out=lor_ip)
            check(got.data_ptr() == lor_ip.data_ptr()
                  and torch.equal(got, ref),
                  "wave_relabel in place: leaf_of_row not bitwise equal")
            # timed into a preallocated tensor: the work of the in-place
            # call (which would relabel its own output on the next call)
            # without an allocation; and into a new tensor each call
            out_t = torch.empty_like(lor)
            st = {}
            ms, dms = timings(lambda: hc.wave_relabel_cuda(
                X, lor, tbl, L, out=out_t), 50, stats=st)
            new_ms, new_dms = timings(lambda: hc.wave_relabel_cuda(
                X, lor, tbl, L), 50)
            plain_ms = time_ms(lambda: hc.wave_relabel_plain(
                X, lor, tbl, L), 5)
            bms, by = bound_ms(8 * N + app_rows + 16 * 128 * 4, 0)
            rec = dict(name="wave_relabel", N=N, applied_rows=app_rows,
                       max_abs_err=0.0, tol=0.0, ms=ms, device_ms=dms,
                       new_tensor_ms=new_ms, new_tensor_device_ms=new_dms,
                       plain_ms=plain_ms, library_ms=None,
                       launches_per_call=st["kernels_per_call"],
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


def _dup_wave_table(torch, rng, F, num_bins, nl0, napp, K, dev):
    """_wave_table with applied entry 1 naming entry 0's leaf and, at
    K > 1, candidate entry 1 naming candidate 0's leaf, each with a split
    of its own."""
    t = _wave_table(torch, rng, F, num_bins, nl0, napp, K, dev)
    t[0, 1] = t[0, 0]
    t[1, 1] = (t[1, 0] + 1) % F
    if K > 1:
        t[7, 1] = t[7, 0]
        t[8, 1] = (t[8, 0] + 1) % F
        t[14, 1] = 1 - t[14, 0]
    return t


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
        # the wave pass at its K cap for B = 256 (32), else 16
        Kw = 32 if B == 256 else 16
        tbl = _wave_table(torch, rng, F, B, 120, 64, Kw, dev)
        pairs = [(hc.build_histogram_slots_cuda(X, vals, slot, 16, B),
                  hc.build_histogram_slots_plain(X, vals, slot, 16, B))]
        gl, gh = hc.wave_pass_cuda(X, vals, lor, tbl, Kw, B, L)
        rl, rh = hc.wave_pass_plain(X, vals, lor, tbl, Kw, B, L)
        torch.cuda.synchronize()
        check(torch.equal(gl, rl), f"wave_pass B={B}: leaf_of_row")
        check(torch.equal(hc.wave_relabel_cuda(X, lor, tbl, L),
                          hc.wave_relabel_plain(X, lor, tbl, L)),
              f"wave_relabel B={B}: leaf_of_row")
        pairs.append((gh, rh))
        for (got, ref), name in zip(pairs, ("build_histogram_slots K=16",
                                            f"wave_pass K={Kw}")):
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
    # narrow storage (a categorical or EFB table of few columns at a low
    # max_bin): several slots share a tile, the planner's plan and the one
    # with the channel pairing turned over, on grid values and int8 values
    for F_n, B_n in ((9, 64), (40, 32)):
        Xn = torch.randint(0, B_n, (F_n, N), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.uint8)
        grid = _grid_vals(torch, gen, 2, N, dev)
        v8 = torch.randint(-127, 128, (2, N), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
        for K, active in ((16, "random"), (128, "half")):
            slot = _slot_case(torch, gen, N, K, active, dev)
            plan = hc.plan_hist_tiles(K, 2, F_n, B_n)
            key = (f"build_histogram_slots F={F_n} B={B_n} K={K} {active} "
                   f"{plan.slots_per_tile} slots a tile")
            check(plan.slots_per_tile > 1, f"{key}: one slot a tile")
            ref = hc.build_histogram_slots_plain(Xn, grid, slot, K, B_n)
            for p in (plan, plan._replace(paired=not plan.paired)):
                check(torch.equal(hc._hist_slots_launch(Xn, grid, slot, K,
                                                        B_n, p), ref),
                      f"{key} paired={p.paired}: not bitwise on grid "
                      f"values")
            got = hc.build_histogram_slots_cuda(Xn, v8, slot, K, B_n)
            check(got.dtype == torch.int32 and torch.equal(
                got, hc.build_histogram_slots_plain(Xn, v8, slot, K, B_n)),
                f"{key} int8: not bitwise equal")
            res[key] = 0.0
    # few rows (a small table, or the deep waves of one): the direct sweep
    # at K > 1 and at K = 1 where one tile holds the histogram (B = 64),
    # the tiled one at K = 1, B = 256; grid values and int8 values
    n = 1 << 14
    Xs = X[:, :n].contiguous()
    grid = _grid_vals(torch, gen, 2, n, dev)
    v8 = torch.randint(-127, 128, (2, n), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.int8)
    for B_s in (64, 256):
        Xb = Xs & (B_s - 1)
        for K in (1, 16, 128):
            slot = _slot_case(torch, gen, n, K, "half", dev)
            plan = hc.plan_hist_tiles(K, 2, F, B_s, rows=n)
            key = f"build_histogram_slots N={n} F={F} B={B_s} K={K}"
            check(plan.direct == (K > 1 or B_s == 64),
                  f"{key}: direct={plan.direct}")
            for v in (grid, v8):
                check(torch.equal(
                    hc.build_histogram_slots_cuda(Xb, v, slot, K, B_s),
                    hc.build_histogram_slots_plain(Xb, v, slot, K, B_s)),
                    f"{key} {v.dtype}: not bitwise equal")
            res[f"{key} direct={plan.direct}"] = 0.0
    # a leaf named by two applied entries and one named by two candidate
    # entries, with other splits: the kernels' maps keep the lowest entry,
    # as the plain versions' first match does (the grower never names a
    # leaf twice); bitwise on grid values, on the tiled and direct routes
    grid = _grid_vals(torch, gen, 2, N, dev)
    X = torch.randint(0, 63, (F, N), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.uint8)
    for K, n in ((16, N), (16, 1 << 16), (1, N)):
        tbl = _dup_wave_table(torch, rng, F, 63, 120, 64, K, dev)
        Xn, vn, ln = X[:, :n].contiguous(), grid[:, :n].contiguous(), lor[:n]
        key = f"duplicated leaves K={K} N={n}"
        gl, gh = hc.wave_pass_cuda(Xn, vn, ln, tbl, K, 64, L)
        rl, rh = hc.wave_pass_plain(Xn, vn, ln, tbl, K, 64, L)
        check(torch.equal(gl, rl) and torch.equal(gh, rh),
              f"wave_pass {key}: not bitwise equal")
        check(torch.equal(hc.wave_relabel_cuda(Xn, ln, tbl, L),
                          hc.wave_relabel_plain(Xn, ln, tbl, L)),
              f"wave_relabel {key}: not bitwise equal")
        lip = ln.clone()
        hc.wave_relabel_cuda(Xn, lip, tbl, L, out=lip)
        check(torch.equal(lip, hc.wave_relabel_plain(Xn, ln, tbl, L)),
              f"wave_relabel in place {key}: not bitwise equal")
        res[f"wave_pass + wave_relabel {key}"] = 0.0
    # #5's scalar tail (N % 4 != 0) and its row-at-a-time path (leaf ids
    # not 16-byte aligned), in place and into a new tensor
    tbl = _wave_table(torch, rng, F, 63, 120, 64, 16, dev)
    for n, off in ((N - 3, 0), (N - 1, 1), (1 << 16, 3)):
        Xn = X[:, :n].contiguous()
        ln = lor[off:off + n]
        ref = hc.wave_relabel_plain(Xn, ln, tbl, L)
        lip = ln.clone()
        key = f"wave_relabel N={n} offset={off}"
        check(torch.equal(hc.wave_relabel_cuda(Xn, ln, tbl, L), ref)
              and torch.equal(hc.wave_relabel_cuda(Xn, lip, tbl, L,
                                                   out=lip), ref),
              f"{key}: not bitwise equal")
        res[key] = 0.0
    emit({"phase": "kernel_variants", "max_abs_err": res})


def _small_rows(hc, torch, X, lor, tbl, K, B, L):
    """Rows that land in a candidate's smaller child: the plain wave pass
    with one unit value channel counts each such row once per feature."""
    ones = torch.ones((1, X.shape[1]), device=X.device)
    _, h = hc.wave_pass_plain(X, ones, lor, tbl, K, B, L)
    return int(h[:, 0, 0, :].sum())


def _mappers_by_feature(ds):
    """Per-original-feature BinMappers of a constructed dataset."""
    out = [None] * ds.num_total_features
    for m, orig in zip(ds.mappers, ds.real_feature_index):
        out[orig] = m
    return out


def _synthetic_bucketize_case(rng, n, F):
    """Mappers and raw rows for the adversarial table: every fourth
    feature categorical (codes -3..60 in the fit sample), the others
    numeric with NaN-missing, zero-missing or no missing type, fed NaN,
    +-0, subnormals, +-inf, huge values, every floored bound and one f32
    ulp either side of it, and fractional, negative and unseen codes."""
    from lightgbm_tpu_torch.data.binning import (BIN_TYPE_CATEGORICAL,
                                                 BinMapper)
    from lightgbm_tpu_torch.ops.bucketize import _floor_f32

    def edge(m):
        v = rng.normal(scale=50.0, size=m).astype(np.float32)
        v[rng.rand(m) < 0.06] = np.nan
        v[rng.rand(m) < 0.06] = 0.0
        v[rng.rand(m) < 0.03] = -0.0
        return v

    mappers, cols = [], []
    s = 20000
    for f in range(F):
        if f % 4 == 3:
            fit = rng.randint(-3, 60, size=s).astype(np.float64)
            m = BinMapper.find_bin(fit, s, 255, 3, 20,
                                   bin_type=BIN_TYPE_CATEGORICAL)
            c = rng.randint(-5, 70, size=n).astype(np.float32)
            c[rng.rand(n) < 0.05] = np.nan
            c[:12] = [np.inf, -np.inf, -0.5, 2.7, -1.0, 1e30, -0.0, 3e38,
                      2.0 ** 24, 1e-45, -1e-45, 59.0]
        else:
            fit = edge(s).astype(np.float64)
            m = BinMapper.find_bin(fit, s, 63 if f % 2 else 255, 3, 20,
                                   zero_as_missing=f % 4 == 1,
                                   use_missing=f % 8 != 6)
            c = edge(n)
            c[:10] = [1e-45, -1e-45, 1e-40, -1e-40, 3e38, -3e38, np.inf,
                      -np.inf, np.nan, -0.0]
            ub = np.asarray(m.bin_upper_bound, np.float64)
            b = _floor_f32(ub[np.isfinite(ub)])
            e = np.concatenate([b, np.nextafter(b, np.float32(-np.inf)),
                                np.nextafter(b, np.float32(np.inf))])
            c[10:10 + len(e)] = e
        mappers.append(m)
        cols.append(c)
    return mappers, np.ascontiguousarray(np.stack(cols, axis=1))


BUCKETIZE_ROWS = (1 << 20, 1 << 18, 256, 8)


def bucketize_phase(bk, torch, dev, X, train_ds, rng):
    """Phase 4: the bucketize kernel against its plain version on three
    tables, at the ingest shape (2^20 rows), an ingest chunk (2^18) and
    the served buckets of 256 and 8 rows, bitwise in both output layouts;
    times the kernel in the layout the main path writes at that shape
    (the feature-major X_t at ingest, row-major bins when serving), its
    plain version and, on the numeric-only train table at 2^20 rows,
    torch.searchsorted over the pre-transposed rows as the library
    yardstick. Returns the 2^20-row records by table."""
    n_all, F = X.shape
    serve_mappers = _mappers_by_feature(train_ds)
    syn_mappers, Xs = _synthetic_bucketize_case(rng, n_all, F)
    train_table = bk.pack_bin_table(train_ds.mappers, mode="train")
    cases = [
        ("train", train_table, X,
         torch.as_tensor(np.asarray(train_ds.real_feature_index,
                                    np.int32)).to(dev)),
        ("serve", bk.pack_bin_table(serve_mappers, mode="serve",
                                    used_features=range(F)), X, None),
        ("synthetic", bk.pack_bin_table(syn_mappers, mode="serve"), Xs,
         None),
    ]
    # a column selection that is not the identity (each table row reads
    # another column of X): bitwise too
    tt = bk.upload_bin_table(train_table, dev)
    perm = torch.from_numpy(rng.permutation(F).astype(np.int32)).to(dev)
    Xp = torch.from_numpy(X[:1 << 18]).to(dev)
    for n in (1 << 18, 256):
        check(torch.equal(bk.bucketize_cuda(Xp[:n], tt, cols=perm),
                          bk.bucketize_plain(Xp[:n], tt, cols=perm)),
              f"bucketize with permuted columns n={n}: not bitwise equal")
    del Xp
    recs = {}
    for name, table, Xh, cols in cases:
        tt = bk.upload_bin_table(table, dev)
        Xa = torch.from_numpy(Xh).to(dev)
        for n in BUCKETIZE_ROWS:
            Xd = Xa[:n]
            ref = bk.bucketize_plain(Xd, tt, cols=cols)
            got = bk.bucketize_cuda(Xd, tt, cols=cols)
            X_t = torch.empty((F, n), dtype=torch.uint8, device=dev)
            bk.bucketize_cuda(Xd, tt, out=X_t.t(), cols=cols)
            torch.cuda.synchronize()
            check(torch.equal(got, ref),
                  f"bucketize {name} n={n}: not bitwise equal "
                  f"({int((got != ref).sum())} of {got.numel()} bins "
                  f"differ)")
            check(torch.equal(X_t.t(), ref),
                  f"bucketize {name} n={n}: feature-major output differs")
            layout = "feature-major" if n >= 1 << 18 else "row-major"
            if layout == "feature-major":
                def call():
                    return bk.bucketize_cuda(Xd, tt, out=X_t.t(), cols=cols)
            else:
                def call():
                    return bk.bucketize_cuda(Xd, tt, cols=cols)
            ms, dms = timings(call, 20)
            plain_ms = time_ms(lambda: bk.bucketize_plain(Xd, tt, cols=cols),
                               2, 1)
            lib_ms = lib_dms = None
            if name == "train" and n == n_all:
                # numeric-only table: searchsorted of each feature's rows
                # against its floored bounds is the same count (before the
                # clamp), one library call over the pre-transposed rows
                XT = Xd[:, cols.long()].t().contiguous()
                lib_ms, lib_dms = timings(lambda: torch.searchsorted(
                    tt.table, XT, side="left"), 20)
                del XT
            nbytes = n * F * 4 + n * F + F * tt.B * 8 + F * 32
            bms, by = bound_ms(nbytes, 0)
            plan = bk.plan_bucketize(n, F, tt.B, tt.grids.shape[1] - 2,
                                     _sms(torch, dev))
            rec = dict(name="bucketize", table=name, mode=table.mode, n=n,
                       F=F, B=tt.B, layout=layout, max_abs_err=0.0, tol=0.0,
                       ms=ms, device_ms=dms, plain_ms=plain_ms,
                       library_ms=lib_ms, library_device_ms=lib_dms,
                       bound_ms=bms, bound_by=by, bound_us=bms * 1e3,
                       plan=plan._asdict())
            emit({"phase": "bucketize", "kernel_ms": ms, **rec})
            if n == n_all:
                recs[name] = rec
            del got, ref, X_t
        del Xa
    return recs


def _sms(torch, dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _auc(p, y):
    order = np.argsort(p)
    ranks = np.empty(len(p))
    ranks[order] = np.arange(1, len(p) + 1)
    npos = int(y.sum())
    return float((ranks[y].sum() - npos * (npos + 1) / 2)
                 / (npos * (len(y) - npos)))


def serve_phase(lt, hc, torch, bst, X, Xt):
    """Phase 7: the binned engine on the raw-f32 route, the registry and
    micro-batcher under 4 client threads, and Booster.predict's device
    route on the 2^20 training rows."""
    import threading
    from lightgbm_tpu_torch.serving import MicroBatcher, ModelRegistry

    hc.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess = bst.serve(engine="binned", max_batch=256, warmup=True)
    warm_s = time.perf_counter() - t0
    info = sess.cache_info()
    check(sess.engine == "binned" and info["device_binning"],
          f"binned engine without its device bin table: {info}")
    t0 = time.perf_counter()
    raw = sess.predict(Xt, raw_score=True)
    raw_ms = (time.perf_counter() - t0) * 1e3
    serve_launches = dict(hc.LAUNCHES)
    check(serve_launches["bucketize"] > 0,
          "the raw-f32 route never launched the bucketize kernel")
    f64 = sess.predict(Xt.astype(np.float64), raw_score=True)
    dev = bst.serve(engine="device", max_batch=256).predict(
        Xt, raw_score=True)
    host = bst.predict(Xt, raw_score=True)
    check(np.array_equal(raw, f64), "raw-f32 route differs from the f64 "
                                    "route")
    check(np.array_equal(raw, dev), "binned engine differs from the device "
                                    "engine")
    err_host = float(np.max(np.abs(raw - host)))
    check(err_host <= 1e-5, f"binned engine vs Booster.predict: {err_host}")
    chunks = -(-len(Xt) // sess.max_batch)

    # registry + micro-batcher: 512 single-row f32 requests, 4 threads
    reg = ModelRegistry(engine="binned", max_batch=256)
    reg.register("bench", bst, warmup=True)
    # the batch scores, from the first session (its own metrics)
    expect = sess.predict(Xt[:512])
    got = np.full(512, np.nan)
    errors = []
    with MicroBatcher(lambda Xb: reg.predict(Xb, name="bench"),
                      max_batch=256, max_wait_ms=2.0, timeout_ms=10000.0,
                      metrics=reg.metrics) as mb:
        def client(k):
            try:
                for i in range(k, 512, 4):
                    got[i] = mb.predict(Xt[i])[0]
            except Exception as e:       # reported below, fails the run
                errors.append(repr(e))
        ts = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        wall = time.perf_counter() - t0
        sizes = list(mb.batch_sizes)
    check(not errors and not any(t.is_alive() for t in ts),
          f"batcher clients failed: {errors[:3]}")
    check(np.array_equal(got, expect), "batched single-row answers differ "
                                       "from the batch scores")
    summ = reg.metrics.summary()
    check(summ["counters"]["host_fallbacks"] == 0
          and sess.metrics.counters["host_fallbacks"] == 0,
          "a serving chunk fell back to the host")
    emit({"phase": "serve", "engine": "binned", "route": "raw_f32",
          "rows": len(Xt), "max_batch": sess.max_batch, "chunks": chunks,
          "warmup_s": warm_s, "predict_ms": raw_ms,
          "launches": serve_launches,
          "bucketize_launches_per_chunk":
              serve_launches["bucketize"] / chunks,
          "bitwise_f64_route": True, "bitwise_device_engine": True,
          "max_abs_err_vs_predict": err_host,
          "heldout_cache": sess.cache_info(),
          "batcher_requests": 512, "batcher_threads": 4,
          "batcher_wall_s": wall, "batcher_batches": len(sizes),
          "batcher_mean_rows": float(np.mean(sizes)),
          "request_latency": summ["request_latency"],
          "batch_latency": summ["batch_latency"],
          "host_fallbacks": summ["counters"]["host_fallbacks"]})

    # Booster.predict of 2^20 f32 rows: the device route
    g = bst._gbdt
    t0 = time.perf_counter()
    p_dev = bst.predict(X, raw_score=True)
    dev_s = time.perf_counter() - t0
    check(getattr(g, "_device_tables_cache", None) is not None,
          "Booster.predict of 2^20 f32 rows did not take the device route")
    t0 = time.perf_counter()
    p_host = bst.predict(X.astype(np.float64), raw_score=True)
    host_s = time.perf_counter() - t0
    err = float(np.max(np.abs(p_dev - p_host)))
    emit({"phase": "predict_device", "rows": len(X), "device_s": dev_s,
          "host_walk_s": host_s, "max_abs_err": err})
    check(err <= 1e-5, f"device-route predict vs host walk: {err}")
    return serve_launches


# ---------------------------------------------------------------------------
# the wave-apply route (wide / categorical / EFB data)
# ---------------------------------------------------------------------------
def _grid_vals(torch, gen, C, N, dev):
    """f32 values on a 1/1024 grid in [-8, 8): every f64 sum of up to 2^20
    of them is exact, so kernel and plain version agree bitwise whatever
    the order of the atomics."""
    v = torch.randint(-8192, 8192, (C, N), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.float32) / 1024.0
    v[1] = v[1].abs()
    return v


def _apply_records(torch, rng, meta, cfg, n, dev):
    """n split records drawn from a storage's feature metadata: features,
    thresholds inside their bins, default_left, and bitsets over the bins
    of the categorical ones."""
    nb = meta.num_bins.cpu().numpy().astype(np.int64)
    cat_f = meta.is_categorical.cpu().numpy() & cfg.has_categorical
    feat = rng.randint(0, len(nb), n)
    thr = np.array([rng.randint(0, max(nb[f] - 1, 1)) for f in feat])
    dl = rng.randint(0, 2, n).astype(bool)
    iscat = cat_f[feat]
    bits = np.zeros((n, cfg.cat_words), np.int64)
    for i in np.flatnonzero(iscat):
        for b in np.flatnonzero(rng.rand(nb[feat[i]]) < 0.3):
            bits[i, b >> 5] |= 1 << (b & 31)
    return [torch.from_numpy(a).to(dev)
            for a in (feat, thr, dl, iscat, bits)]


def wave_apply_phase(hc, torch, dev, storages, want="criteo"):
    """The wave_apply kernel (#4), which decides each row under the wave's
    split records, at N = 2^20 rows, L = 255 leaves, Kd in {16, 128}: a
    mid-tree wave of min(Kd, 64) applied splits among 120 leaves and Kd
    candidates among the leaves after them, on each storage of
    `storages` ([(name, X_t, meta, cfg)]: numeric with every missing type,
    Criteo with 8-word categorical bitsets at B = 256, and EFB-bundled).
    Bitwise against its plain version and against the parent's
    composition, the decision matrix of dec_go_left + wave_apply_plain;
    timed beside that decision build (`parent_path_ms`: dec_go_left for
    the applied entries and for the candidates with the land bit, which
    the parent's route ran before its kernel, whose own dec-reading
    kernel is no longer in the tree). Returns the Kd = 128 record of the
    storage named `want`."""
    from lightgbm_tpu_torch.ops import grow_wave as tw
    gen = torch.Generator(device=dev).manual_seed(9)
    rng = np.random.RandomState(13)
    L, nl0 = N_LEAVES, 120
    out = None
    for name, X_t, meta, cfg in storages:
        N = X_t.shape[1]
        lor = torch.randint(0, nl0, (N,), generator=gen, device=dev,
                            dtype=torch.int32)
        for Kd in (16, 128):
            napp = min(Kd, 64)
            fa, ta, da, ca, ba = _apply_records(torch, rng, meta, cfg, napp,
                                                dev)
            fc, tc, dc, cc, bc = _apply_records(torch, rng, meta, cfg, Kd,
                                                dev)
            sil = torch.from_numpy(rng.randint(0, 2, Kd).astype(bool)) \
                .to(dev)
            tbl = torch.full((16, 128), -1, dtype=torch.int32, device=dev)
            tbl[0, :napp] = torch.from_numpy(
                rng.choice(nl0, napp, replace=False)).to(dev)
            tbl[1:7, :napp] = tw._split_rows(fa, ta, da, meta)
            tbl[7, :Kd] = torch.from_numpy(
                rng.choice(nl0 + napp, Kd, replace=False)).to(dev)
            tbl[8:14, :Kd] = tw._split_rows(fc, tc, dc, meta)
            tbl[14, :Kd] = sil.to(torch.int32)
            tbl[15] = nl0
            cats = (tw.pack_wave_cats(ca, ba, cc, bc, cfg.cat_words)
                    if cfg.has_categorical else None)
            bmap = tw.wave_bundle_map(cfg, dev)
            args = (X_t, lor, tbl, cats, bmap, Kd, L)

            def dec_build():
                dec = torch.zeros((Kd, N), dtype=torch.uint8, device=dev)
                dec[:napp] = tw.dec_go_left(X_t, fa, ta, da, ca, ba, meta,
                                            cfg)
                glc = tw.dec_go_left(X_t, fc, tc, dc, cc, bc, meta, cfg)
                dec |= (glc == sil[:, None]).to(torch.uint8) << 1
                return dec
            got = hc.wave_apply_cuda(*args)
            ref = hc.wave_apply_rows_plain(*args)
            dec = dec_build()
            par = hc.wave_apply_plain(dec, lor, tbl, L)
            torch.cuda.synchronize()
            del dec
            check(all(torch.equal(a, b) for a, b in zip(got, ref)),
                  f"wave_apply {name} Kd={Kd}: not bitwise equal to its "
                  f"plain version")
            check(all(torch.equal(a, b) for a, b in zip(got, par)),
                  f"wave_apply {name} Kd={Kd}: not bitwise equal to "
                  f"dec_go_left + wave_apply_plain")
            # bytes this data needs: leaf ids in, new leaf ids and slots
            # out, one storage byte per row in an applied leaf and per row
            # in a candidate leaf after the relabel, the tables
            app_rows = int(torch.isin(lor, tbl[0, :napp]).sum())
            cand_rows = int(torch.isin(ref[0], tbl[7, :Kd]).sum())
            nbytes = 12 * N + app_rows + cand_rows + 16 * 128 * 4 \
                + (0 if cats is None else cats.numel() * 4)
            bms, by = bound_ms(nbytes, 0)
            ms, dms = timings(lambda: hc.wave_apply_cuda(*args), 50)
            parent_ms, parent_dms = timings(dec_build, 10)
            plain_ms = time_ms(lambda: hc.wave_apply_rows_plain(*args), 5)
            rec = dict(name="wave_apply", storage=name, Kd=Kd, L=L, N=N,
                       categorical_entries=int(ca.sum() + cc.sum()),
                       bundled=cfg.bundled, max_abs_err=0.0, tol=0.0,
                       ms=ms, device_ms=dms, plain_ms=plain_ms,
                       library_ms=None, parent_path_ms=parent_ms,
                       parent_path_device_ms=parent_dms, bound_ms=bms,
                       bound_by=by, bound_us=bms * 1e3,
                       rows_applied=app_rows, rows_candidate=cand_rows,
                       slots=int((ref[1] >= 0).sum()))
            emit({"phase": "kernels", "kernel_ms": ms, **rec})
            if name == want and Kd == 128:
                out = rec
            del got, ref, par
    check(out is not None, f"wave_apply: no {want} Kd = 128 case")
    return out


def _numeric_storage(torch, X_t, dev):
    """The bench storage with every missing type: feature metadata of 63
    bins whose missing type cycles None / Zero / NaN, default bins spread
    over the bins."""
    from lightgbm_tpu_torch.ops.grow import GrowConfig
    from lightgbm_tpu_torch.ops.split import FeatureMeta
    F = X_t.shape[0]
    f = torch.arange(F, device=dev)
    meta = FeatureMeta(num_bins=torch.full((F,), 63, dtype=torch.int32,
                                           device=dev),
                       missing_type=(f % 3).to(torch.int32),
                       default_bin=((f * 7) % 63).to(torch.int32),
                       is_categorical=torch.zeros(F, dtype=torch.bool,
                                                  device=dev))
    cfg = GrowConfig(num_leaves=N_LEAVES, max_depth=-1, min_data_in_leaf=20.0,
                     min_sum_hessian_in_leaf=1e-3, lambda_l1=0.0,
                     lambda_l2=0.0, max_delta_step=0.0,
                     min_gain_to_split=0.0, path_smooth=0.0,
                     num_bins_padded=N_BINS)
    return "numeric", X_t, meta, cfg


class _CallCount:
    """Counts the calls of a module function while installed."""

    def __init__(self, mod, name):
        self.mod, self.name, self.n = mod, name, 0
        self.fn = getattr(mod, name)

    def __enter__(self):
        def counted(*a, **k):
            self.n += 1
            return self.fn(*a, **k)
        setattr(self.mod, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.fn)


def rowwise_phase(hc, hr, torch, dev, X_t, tiers, B):
    """The row-wise histogram kernels against their plain versions at the
    Criteo storage (X_t [39, 2^20], its own bin counts), K in {1, 16, 128}
    with every row in a random slot, K in {16, 128} with about half of the
    rows active (a wave's smaller children), and K = 16 "half" on the
    first 2^16 rows, bitwise: f32 values on an exact grid, and int8 values
    (exact int32). The packed kernel is also held to the unpacked one, and
    the expanded flat buffer to the col-wise slot kernel at B, which the
    apply route launches on the same storage; the slot kernel is held to
    its plain version there too, and timed. Times each kernel, its plain
    version and one index_add_ over the flat indices; a record carries the
    engine's tile plan (`tiles`)."""
    from lightgbm_tpu_torch.ops.split import expand_feature_offset_hist
    gen = torch.Generator(device=dev).manual_seed(10)
    F, N = X_t.shape
    C = 2
    plan = hr.build_rowwise_plan(tuple(tiers))
    pplan = hr.build_pack4_plan(tuple(tiers))
    check(hr.pack4_worthwhile(pplan), "Criteo storage has < 2 nibble columns")
    Xp, Xu = hr.pack4(X_t, pplan)
    check(torch.equal(hr.unpack4(Xp, Xu, pplan), X_t),
          "pack4 / unpack4 do not round-trip the storage")
    vals = _grid_vals(torch, gen, C, N, dev)
    vals8 = torch.randint(-127, 128, (C, N), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int8)
    offs = torch.tensor(plan.offsets, device=dev)[:, None]
    wid = torch.tensor(plan.widths, device=dev)[:, None]
    recs = {"hist_rowwise": {}, "hist_rowwise_packed": {}}
    X_full, Xp_full, Xu_full = X_t, Xp, Xu
    vals_full, vals8_full = vals, vals8
    for K, active, n in ((1, "all", N), (16, "random", N),
                         (128, "random", N), (16, "half", N),
                         (128, "half", N), (16, "half", 1 << 16)):
        X_t, Xp, Xu = (x[:, :n].contiguous()
                       for x in (X_full, Xp_full, Xu_full))
        vals, vals8 = vals_full[:, :n].contiguous(), \
            vals8_full[:, :n].contiguous()
        slot = _slot_case(torch, gen, n, K, active, dev)
        rows = n if slot is None else int((slot >= 0).sum())
        slot_bytes = 0 if slot is None else 4 * n
        args = (slot, K, plan)
        cw = hc.build_histogram_slots_cuda(X_t, vals, slot, K, B)
        check(torch.equal(cw, hc.build_histogram_slots_plain(
            X_t, vals, slot, K, B)),
            f"build_histogram_slots criteo K={K} {active}: not bitwise "
            f"equal to the plain version")
        # the col-wise slot kernel at the apply route's shape, against one
        # index_add_ over the uniform grid
        flat, lv, acc = _flat_index_add(torch, X_t, vals, slot, K, B)
        lib_ms, lib_dms = timings(lambda: acc.index_add_(0, flat, lv), 20)
        del flat, lv, acc
        ms, dms = timings(lambda: hc.build_histogram_slots_cuda(
            X_t, vals, slot, K, B), 20)
        bms, by = bound_ms(slot_bytes + rows * (F + 4 * C)
                           + K * C * F * B * 4, rows * F * C)
        emit({"phase": "kernels", "kernel_ms": ms,
              "name": "build_histogram_slots", "shape": "criteo", "K": K,
              "active": active, "N": n, "rows": rows, "F": F, "B": B,
              "max_abs_err": 0.0, "ms": ms, "device_ms": dms,
              "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
              "library_device_ms": lib_dms,
              "plan": hc.plan_hist_tiles(K, C, F, B, rows=n)._asdict()})
        got = hr.hist_rowwise_cuda(X_t, vals, *args)
        ref = hr.hist_rowwise_plain(X_t, vals, *args)
        gotp = hr.hist_rowwise_packed_cuda(Xp, Xu, vals, *args, pplan)
        refp = hr.hist_rowwise_packed_plain(Xp, Xu, vals, *args, pplan)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"hist_rowwise K={K}: not bitwise")
        check(torch.equal(gotp, refp) and torch.equal(gotp, got),
              f"hist_rowwise_packed K={K}: not bitwise")
        check(torch.equal(expand_feature_offset_hist(
            got, plan.offsets, plan.widths, B), cw),
            f"hist_rowwise K={K}: expanded buffer differs from the col-wise "
            f"slot histogram")
        g8 = hr.hist_rowwise_cuda(X_t, vals8, *args)
        check(g8.dtype == torch.int32 and torch.equal(
            g8, hr.hist_rowwise_plain(X_t, vals8, *args)) and torch.equal(
            hr.hist_rowwise_packed_cuda(Xp, Xu, vals8, *args, pplan), g8),
            f"hist_rowwise int8 K={K}: not bitwise")
        # library yardstick: one index_add_ over the flat indices
        flat, lv, acc = _flat_index_add(torch, X_t, vals, slot, K, B,
                                        wid, offs)
        lib_ms, lib_dms = timings(lambda: acc.index_add_(0, flat, lv), 20)
        del flat, lv, acc
        out_bytes = K * C * plan.total * 4
        for name, fn, pfn, xin in (
                ("hist_rowwise", lambda: hr.hist_rowwise_cuda(
                    X_t, vals, *args),
                 lambda: hr.hist_rowwise_plain(X_t, vals, *args), F),
                ("hist_rowwise_packed", lambda: hr.hist_rowwise_packed_cuda(
                    Xp, Xu, vals, *args, pplan),
                 lambda: hr.hist_rowwise_packed_plain(
                     Xp, Xu, vals, *args, pplan),
                 Xp.shape[0] + pplan.n_rest)):
            ms, dms = timings(fn, 20)
            plain_ms = time_ms(pfn, 3, 1)
            bms, by = bound_ms(slot_bytes + rows * (xin + 4 * C)
                               + out_bytes, rows * F * C)
            rec = dict(name=name, K=K, active=active, N=n, F=F,
                       total=plan.total, max_abs_err=0.0, tol=0.0, ms=ms,
                       device_ms=dms, plain_ms=plain_ms, library_ms=lib_ms,
                       library_device_ms=lib_dms, bound_ms=bms, bound_by=by,
                       bound_us=bms * 1e3,
                       tiles=hr.flat_plan(plan, K, C, False)._asdict())
            emit({"phase": "kernels", "kernel_ms": ms, **rec})
            recs[name][(K, active, n)] = rec
    return {name: r[(16, "random", N)] for name, r in recs.items()}


def _same_host_tree(a, b):
    """Structure, thresholds and categorical bitsets equal; leaf values'
    largest difference (None when the structure differs)."""
    keys = ("split_feature", "threshold_in_bin", "decision_type",
            "left_child", "right_child", "cat_boundaries", "cat_threshold")
    same = a.num_leaves == b.num_leaves and a.num_cat == b.num_cat and all(
        np.array_equal(getattr(a, k), getattr(b, k)) for k in keys)
    return (float(np.max(np.abs(a.leaf_value - b.leaf_value)))
            if same else None)


def _plain_trees(torch, gbdt, n, scores=None, it=0, cegb_used=None,
                 lors=None):
    """Iteration `it`'s K trees again (from the [N] or [K, N] `scores`
    before it; at iteration 0 the boost-from-average start), from the same
    gradients, sample mask and seeds (and CEGB's used features
    `cegb_used`, none by default), grown on the run's grower with the
    kernels' plain versions on the card, each renewed where the objective
    renews leaves; `lors`, a list, receives each tree's leaf_of_row."""
    K = gbdt.num_tree_per_iteration
    init = [float(gbdt.objective.boost_from_score(k)) for k in range(K)]
    if scores is None:
        scores = torch.tensor([[float(np.float32(v))] for v in init],
                              device=gbdt.X_t.device).repeat(1, n)
    scores = scores.reshape(K, n)
    g, h = gbdt._gradients(scores)
    bag = gbdt.sample_strategy.sample(it, g, h)
    out = []
    for k in range(K):
        tp, lor = gbdt.grow_one(g[k], h[k], bag, None, gbdt.tree_seed(it, k),
                                cegb_used=cegb_used, plain=True)
        if lors is not None:
            lors.append(lor)
        if gbdt.objective.need_renew_tree_output:
            tp = gbdt._renew_tree_output(k, tp, lor, scores[k])
        t = gbdt._device_tree_to_host(tp)
        if it == 0 and abs(init[k]) > 1e-15:
            t.add_bias(init[k])
        out.append(t)
    return out


def criteo_phase(lt, hc, torch, dev):
    """Ingest the Criteo-shaped table on the device route, train 8 rounds
    on the wave-apply route (no dec_go_left decision matrix: each row is
    decided inside wave_apply), and hold the first tree to the plain
    versions'. Returns (booster, dataset, launches)."""
    from lightgbm_tpu_torch.ops import grow_wave as tw
    from lightgbm_tpu_torch.utils.synthetic import (CRITEO_CAT_COLUMNS,
                                                    criteo_like)
    X, y = criteo_like(N_ROWS)
    params = dict(objective="binary", num_leaves=N_LEAVES, max_bin=255,
                  learning_rate=0.1, min_data_in_leaf=20, verbose=-1,
                  bagging_freq=0, binning_impl="auto", device_type="cuda",
                  metric="auc",
                  batched_train=False)
    cats = list(CRITEO_CAT_COLUMNS)
    hc.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = lt.Dataset(X, label=y, categorical_feature=cats,
                    params=params).construct()
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    ingest_launches = dict(hc.LAUNCHES)
    hh = lt.Dataset(X, label=y, categorical_feature=cats, params={
        **params, "binning_impl": "host"}).construct()._handle
    h = ds._handle
    same_xt = torch.equal(h.X_t, hh.X_t) and np.array_equal(h.X_binned,
                                                            hh.X_binned)
    emit({"phase": "criteo_ingest", "rows": N_ROWS, "features": X.shape[1],
          "categorical": len(cats), "route": h.binning_route,
          "ingest_s": ingest_s, "launches": ingest_launches,
          "bundled": h.bundles is not None,
          "storage_num_bins": h.storage_num_bins(),
          "X_t_bitwise_host_route": same_xt})
    check(h.binning_route == "device" and ingest_launches["bucketize"] > 0,
          "the Criteo ingest did not take the device route")
    check(same_xt, "Criteo device-route X_t differs from the host route")
    del hh

    ends, resumes, aucs = [], [], []

    def stamp(env):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        aucs.append(env.model.eval_train()[0][2])
        resumes.append(time.perf_counter())
    stamp.order = 5

    hc.reset_launch_counts()
    torch.cuda.synchronize()
    t_train = time.perf_counter()
    with _CallCount(tw, "dec_go_left") as dec_calls:
        bst = lt.train(params, ds, num_boost_round=8, callbacks=[stamp])
    torch.cuda.synchronize()
    launches = dict(hc.LAUNCHES)
    iter_ms = [(b - a) * 1e3 for a, b in zip([t_train] + resumes[:-1],
                                             ends)]
    g = bst._gbdt
    trees = g.models
    emit({"phase": "criteo_train", "rows": N_ROWS, "iterations": len(trees),
          "grow_route": g.grow_route, "hist_route": g.hist_route,
          "num_bins_padded": g.num_bins_padded, "iter_ms": iter_ms,
          "steady_ms_per_iter": float(np.mean(iter_ms[1:])),
          "launches": launches, "dec_go_left_calls": dec_calls.n,
          "train_auc_per_round": aucs,
          "leaves": [t.num_leaves for t in trees],
          "categorical_splits": [t.num_cat for t in trees]})
    check(g.grow_route == "apply" and g.hist_route == "slots",
          f"Criteo trained on route {g.grow_route}/{g.hist_route}")
    check(launches["wave_apply"] > 0 and launches["build_histogram_slots"]
          > 0, "the apply route never launched wave_apply / the histogram")
    check(dec_calls.n == 0, f"the apply route built a decision matrix "
                            f"({dec_calls.n} dec_go_left calls)")
    check(launches["wave_pass"] == 0 and launches["wave_relabel"] == 0,
          "the apply route launched the megakernel")
    check(all(b >= a for a, b in zip(aucs, aucs[1:])),
          f"train AUC fell between rounds: {aucs}")
    # 2^20 rows on the CPU reach a train AUC of CRITEO_AUC_CPU after 8
    # rounds; the card must reach the same level
    check(len(trees) == 8 and aucs[-1] > CRITEO_AUC_MIN,
          f"Criteo train AUC {aucs[-1]} <= {CRITEO_AUC_MIN}")
    check(sum(t.num_cat for t in trees) > 0, "no categorical split grown")

    t_plain = _plain_trees(torch, g, N_ROWS)[0]
    lv_err = _same_host_tree(t_plain, trees[0])
    emit({"phase": "criteo_first_tree", "same_structure": lv_err is not None,
          "leaves": trees[0].num_leaves, "num_cat": trees[0].num_cat,
          "leaf_value_max_abs_err": lv_err})
    check(lv_err is not None, "Criteo first tree differs from the plain "
                              "versions' tree")
    check(lv_err <= 1e-6, f"Criteo first tree leaf values differ by {lv_err}")
    return bst, ds, launches


def rowwise_runs_phase(lt, hc, torch, bst, ds):
    """2 rounds with force_row_wise=true and 2 with
    histogram_impl=rowwise_packed on the Criteo dataset: their trees are
    the col-wise run's first two. Returns the launches of each run."""
    base = bst._gbdt.models[:2]
    out = {}
    for over, route, kern in (
            ({"force_row_wise": True}, "rowwise", "hist_rowwise"),
            ({"histogram_impl": "rowwise_packed"}, "rowwise_packed",
             "hist_rowwise_packed")):
        params = {**bst.params, **over}
        hc.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b2 = lt.train(params, ds, num_boost_round=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(hc.LAUNCHES)
        g2 = b2._gbdt
        errs = [_same_host_tree(a, b) for a, b in zip(g2.models, base)]
        emit({"phase": "criteo_" + route, "grow_route": g2.grow_route,
              "hist_route": g2.hist_route, "rounds": len(g2.models),
              "wall_s": wall, "launches": launches,
              "same_trees_as_colwise": all(e is not None for e in errs),
              "leaf_value_max_abs_err": errs})
        check(g2.grow_route == "apply" and g2.hist_route == route,
              f"{over} trained on route {g2.grow_route}/{g2.hist_route}")
        check(launches[kern] > 0 and launches["wave_apply"] > 0,
              f"{over}: {kern} / wave_apply never launched")
        check(launches["build_histogram_slots"] == 0
              and launches["wave_pass"] == 0,
              f"{over}: a col-wise histogram kernel launched")
        check(len(g2.models) == 2 and all(e is not None and e <= 1e-6
                                          for e in errs),
              f"{over}: trees differ from the col-wise run ({errs})")
        out[kern] = launches
        del b2, g2
    return out


def criteo_serve_phase(hc, torch, bst):
    """The Criteo model served by the binned engine on raw f32 rows that
    hold unseen, negative and NaN categories: bitwise equal to the f64
    route and the device engine, within 1e-5 of Booster.predict."""
    from lightgbm_tpu_torch.utils.synthetic import (CRITEO_CAT_COLUMNS,
                                                    criteo_like)
    Xs, _ = criteo_like(4096, seed=8)
    rng = np.random.RandomState(18)
    cats = np.asarray(CRITEO_CAT_COLUMNS)
    for vals in ((1000.0, 5000.0, 251.0), (-1.0, -7.0, -0.5), (np.nan,)):
        m = rng.rand(len(Xs), len(cats)) < 0.03
        pick = rng.choice(np.asarray(vals, np.float32), size=m.shape)
        sub = Xs[:, cats]
        sub[m] = pick[m]
        Xs[:, cats] = sub
    hc.reset_launch_counts()
    sess = bst.serve(engine="binned", max_batch=256, warmup=True)
    check(sess.cache_info()["device_binning"],
          "the Criteo binned session has no device bin table")
    raw = sess.predict(Xs, raw_score=True)
    launches = dict(hc.LAUNCHES)
    f64 = sess.predict(Xs.astype(np.float64), raw_score=True)
    devp = bst.serve(engine="device", max_batch=256).predict(
        Xs, raw_score=True)
    host = bst.predict(Xs, raw_score=True)
    err = float(np.max(np.abs(raw - host)))
    emit({"phase": "criteo_serve", "rows": len(Xs), "launches": launches,
          "bitwise_f64_route": bool(np.array_equal(raw, f64)),
          "bitwise_device_engine": bool(np.array_equal(raw, devp)),
          "max_abs_err_vs_predict": err,
          "host_fallbacks": sess.metrics.counters["host_fallbacks"]})
    check(launches["bucketize"] > 0, "Criteo serving never bucketized")
    check(np.array_equal(raw, f64), "Criteo raw-f32 route differs from f64")
    check(np.array_equal(raw, devp), "Criteo binned engine differs from the "
                                     "device engine")
    check(err <= 1e-5, f"Criteo binned engine vs Booster.predict: {err}")
    check(sess.metrics.counters["host_fallbacks"] == 0,
          "a Criteo serving chunk fell back to the host")


def efb_phase(lt, hc, torch):
    """2^19 rows of 30 one-hot sparse and 30 dense columns, max_bin 63, 4
    rounds: bundles form, the apply route runs without a decision matrix,
    and the first tree equals the plain versions'; 2 rounds under
    histogram_impl=fused are vetoed (efb_bundled), take the apply route
    and grow the same trees. Returns the bundled storage (name, X_t of
    2^20 rows, meta, grower configuration)."""
    from lightgbm_tpu_torch.ops import grow_wave as tw
    from lightgbm_tpu_torch.utils.synthetic import efb_like
    n = N_ROWS // 2
    X, y = efb_like(n)
    params = dict(objective="binary", num_leaves=N_LEAVES, max_bin=63,
                  learning_rate=0.1, min_data_in_leaf=20, verbose=-1,
                  bagging_freq=0, binning_impl="auto", device_type="cuda",
                  metric="auc",
                  batched_train=False)
    hc.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _CallCount(tw, "dec_go_left") as dec_calls:
        bst = lt.train(params, lt.Dataset(X, label=y, params=params),
                       num_boost_round=4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(hc.LAUNCHES)
    g = bst._gbdt
    ds = bst.train_set._handle
    lv_err = _same_host_tree(_plain_trees(torch, g, n)[0], g.models[0])
    emit({"phase": "efb", "rows": n, "features": X.shape[1],
          "storage_columns": int(g.X_t.shape[0]),
          "bundles": len(ds.bundles or []),
          "multi_feature_bundles": sum(len(b) > 1 for b in ds.bundles or []),
          "grow_route": g.grow_route, "hist_route": g.hist_route,
          "wall_s": wall, "launches": launches,
          "dec_go_left_calls": dec_calls.n,
          "train_auc": bst.eval_train()[0][2],
          "first_tree_same": lv_err is not None,
          "leaf_value_max_abs_err": lv_err})
    check(ds.bundles is not None and g.X_t.shape[0] < X.shape[1],
          "EFB formed no bundles")
    check(g.grow_route == "apply" and launches["wave_apply"] > 0,
          "the EFB run did not take the apply route")
    check(dec_calls.n == 0, f"the EFB apply route built a decision matrix "
                            f"({dec_calls.n} dec_go_left calls)")
    check(lv_err is not None and lv_err <= 1e-6,
          f"EFB first tree differs from the plain versions' ({lv_err})")
    # histogram_impl=fused on bundled storage: vetoed, the apply route
    hc.reset_launch_counts()
    bf = lt.train({**params, "histogram_impl": "fused"}, bst.train_set,
                  num_boost_round=2)
    gf_ = bf._gbdt
    errs = [_same_host_tree(a, b) for a, b in zip(gf_.models, g.models)]
    emit({"phase": "efb_fused", "grow_route": gf_.grow_route,
          "fused_veto_reasons": gf_.fused_veto_reasons,
          "launches": dict(hc.LAUNCHES),
          "same_trees_as_auto": all(e is not None and e == 0.0
                                    for e in errs)})
    check(gf_.grow_route == "apply"
          and gf_.fused_veto_reasons == ["efb_bundled"],
          f"EFB under histogram_impl=fused: route {gf_.grow_route}, vetoes "
          f"{gf_.fused_veto_reasons}")
    check(len(errs) == 2 and all(e is not None and e == 0.0 for e in errs),
          f"EFB under histogram_impl=fused grew other trees ({errs})")
    # its rows twice over: the 2^20 rows of the wave_apply phase
    return "efb", torch.cat([g.X_t, g.X_t], dim=1), g.meta, g.grow_cfg


def narrow_cat_phase(lt, hc, torch):
    """2^19 rows of 4 count and 8 categorical columns of the Criteo-shaped
    table at max_bin 63, 2 rounds: the apply route, whose waves put several
    slots in one tile of the slot histogram (12 storage columns, B = 64);
    the first tree equals the plain versions'."""
    from lightgbm_tpu_torch.utils.synthetic import (CRITEO_CAT_COLUMNS,
                                                    criteo_like)
    n = N_ROWS // 2
    X, y = criteo_like(n)
    X = np.ascontiguousarray(X[:, list(range(4))
                               + list(CRITEO_CAT_COLUMNS[:8])])
    params = dict(objective="binary", num_leaves=N_LEAVES, max_bin=63,
                  learning_rate=0.1, min_data_in_leaf=20, verbose=-1,
                  bagging_freq=0, binning_impl="auto", device_type="cuda",
                  metric="auc",
                  batched_train=False)
    hc.reset_launch_counts()
    bst = lt.train(params, lt.Dataset(X, label=y,
                                      categorical_feature=list(range(4, 12)),
                                      params=params), num_boost_round=2)
    torch.cuda.synchronize()
    launches = dict(hc.LAUNCHES)
    g = bst._gbdt
    F, B = int(g.X_t.shape[0]), g.num_bins_padded
    plans = {K: hc.plan_hist_tiles(K, 2, F, B).slots_per_tile
             for K in (16, 128)}
    lv_err = _same_host_tree(_plain_trees(torch, g, n)[0], g.models[0])
    emit({"phase": "narrow_cat", "rows": n, "storage_columns": F, "B": B,
          "grow_route": g.grow_route, "hist_route": g.hist_route,
          "slots_per_tile": plans, "launches": launches,
          "categorical_splits": [t.num_cat for t in g.models],
          "train_auc": bst.eval_train()[0][2],
          "first_tree_same": lv_err is not None,
          "leaf_value_max_abs_err": lv_err})
    check(g.grow_route == "apply" and g.hist_route == "slots"
          and launches["build_histogram_slots"] > 0,
          f"narrow categorical run on route {g.grow_route}/{g.hist_route}")
    check(min(plans.values()) > 1, f"one slot a tile at F={F}, B={B}")
    check(sum(t.num_cat for t in g.models) > 0, "no categorical split grown")
    check(lv_err is not None and lv_err <= 1e-6,
          f"narrow categorical first tree differs from the plain versions' "
          f"({lv_err})")


# ---------------------------------------------------------------------------
# the fused routes (histogram_impl="fused")
# ---------------------------------------------------------------------------
FUSED_FIELDS = ("gain", "feature", "threshold", "default_left", "left_sum_g",
                "left_sum_h", "left_count", "right_sum_g", "right_sum_h",
                "right_count", "left_output", "right_output")


def _fused_operands(torch, hc, X, vals, slot_all, slot_small, sil, K, B):
    """What the fused scan reads, from real rows: each candidate's parent
    histogram [K, 2 * F * B] over the rows of its leaf (`slot_all`), and
    per-child scalars [7, 2K] whose sums and counts are those of its two
    children (the smaller one's rows in `slot_small`), with the monotone
    bounds off (-inf, +inf)."""
    v3 = torch.cat([vals.to(torch.float32),
                    torch.ones((1, X.shape[1]), device=X.device)])
    par3 = hc.build_histogram_slots_cuda(X, v3, slot_all, K, B)
    sm3 = hc.build_histogram_slots_cuda(X, v3, slot_small, K, B)
    ptot = par3[:, :, 0, :].sum(-1)                # feature 0 holds every row
    stot = sm3[:, :, 0, :].sum(-1)
    ltot = torch.where(sil[:, None], stot, ptot - stot)
    rtot = ptot - ltot
    lr = torch.cat([ltot, rtot])                   # [2K, 3]
    out = -lr[:, 0] / (lr[:, 1] + 1.0)
    inf = torch.full_like(out, float("inf"))
    scal = torch.stack([lr[:, 0], lr[:, 1], lr[:, 2], out,
                        torch.cat([sil, sil]).to(torch.float32), -inf, inf])
    parent = par3[:, :2]
    if vals.dtype == torch.int8:
        parent = hc.build_histogram_slots_cuda(X, vals, slot_all, K, B)
    return parent.reshape(K, -1).contiguous(), scal.contiguous()


def _rec_diffs(torch, a, b):
    """Largest |difference| of each record field (selection fields as
    counts of differing children)."""
    out = {}
    for i, name in enumerate(FUSED_FIELDS):
        if name in ("feature", "threshold", "default_left"):
            out[name] = int((a[i] != b[i]).sum())
        else:
            fin = torch.isfinite(a[i]) & torch.isfinite(b[i])
            d = (a[i] - b[i]).abs()[fin]
            out[name] = float(d.max()) if d.numel() else 0.0
    return out


def _fused_hp():
    from lightgbm_tpu_torch.ops.split import SplitHyperParams
    return SplitHyperParams(min_data_in_leaf=20.0,
                            min_sum_hessian_in_leaf=1e-3, lambda_l1=0.0,
                            lambda_l2=0.0, max_delta_step=0.0,
                            min_gain_to_split=0.0, path_smooth=0.0)


def _scan_nbytes(K, F, B):
    """Bytes the split scan must move: the parent histograms read, the
    per-child scalars, the feature metadata and the records."""
    return K * 2 * F * B * 4 + 7 * 2 * K * 4 + 5 * F * 4 + 12 * 2 * K * 4


def fused_narrow_phase(hc, gf, torch, dev):
    """Kernel #9 against its plain version at the bench storage shape
    (N = 2^20, F = 28, B = 64) for K in {1, 16, 64}: "few", a mid-tree wave
    of 64 applied splits among 120 leaves, K candidates among the leaves
    after it; "half", every leaf after K / 2 applied splits among K / 2
    leaves a candidate (about half of the rows in a smaller child), also
    on the first 2^16 rows (the direct route); "dup" (K = 16, untimed), a
    leaf named by two applied entries and one by two candidate entries.
    Parents and child statistics from the real rows. leaf_of_row, the
    histogram and every record field bitwise on 1/1024-grid values (at
    K = 16 "few" also with every split regularizer set); on continuous
    values the chosen (feature, threshold, default_left) of every child,
    and the largest difference of each float field."""
    gen = torch.Generator(device=dev).manual_seed(21)
    N, F, B, L = N_ROWS, N_FEAT, N_BINS, N_LEAVES
    X_all = torch.randint(0, 63, (F, N), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    rng = np.random.RandomState(22)
    hp = _fused_hp()
    hp_reg = hp._replace(lambda_l1=0.5, lambda_l2=2.0, max_delta_step=0.75,
                         min_gain_to_split=0.25, path_smooth=3.0)
    fmeta = torch.tensor(np.stack([np.full(F, 63), rng.randint(0, 3, F),
                                   rng.randint(0, 63, F), np.zeros(F),
                                   np.zeros(F)]),
                         dtype=torch.int32, device=dev)
    fmask = torch.ones(F, dtype=torch.uint8, device=dev)
    recs = {}
    cases = [(1, "few", N), (16, "few", N), (64, "few", N), (1, "half", N),
             (16, "half", N), (64, "half", N), (16, "half_2^16", 1 << 16),
             (16, "dup", N)]
    for K, case, n in cases:
        nl0, napp = ((max(K // 2, 1), K // 2) if "half" in case
                     else (120, 64))
        X = X_all if n == N else X_all[:, :n].contiguous()
        lor = torch.randint(0, nl0, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
        tbl = (_dup_wave_table if case == "dup" else _wave_table)(
            torch, rng, F, B - 1, nl0, napp, K, dev)
        t64 = tbl.to(torch.int64)
        new_lor = hc.wave_relabel_plain(X, lor, tbl, L)
        # each row's candidate entry, the first match (the kernels' rule)
        slot_all = hc._entry_of(new_lor.to(torch.int64), t64[7, :K])
        p = hc._pack_entries(t64, 8, t64[14] & 1)[:K]
        pe = p[slot_all.clamp(min=0)]
        small = (slot_all >= 0) & (hc._go_left(pe, X)
                                   == (((pe >> 23) & 1) == 1))
        slot_small = torch.where(small, slot_all, -1).to(torch.int32)
        slot_all = slot_all.to(torch.int32)
        sil = (t64[14, :K] & 1) == 1
        res = {}
        # at K = 16 also the regularizers' arithmetic of the scan (l1, l2,
        # max_delta_step, path_smooth, min_gain_to_split), on grid values
        kinds = ((("regularized",) if (K, case) == (16, "few") else ())
                 + ("grid",) + (() if case == "dup" else ("continuous",)))
        for kind in kinds:
            vals = (torch.randn((2, n), generator=gen, device=dev)
                    if kind == "continuous"
                    else _grid_vals(torch, gen, 2, n, dev))
            vals[1] = vals[1].abs()
            parent, scal = _fused_operands(torch, hc, X, vals, slot_all,
                                           slot_small, sil, K, B)
            args = (X, vals, lor, tbl, parent, scal, fmeta, fmask, K, B, L,
                    hp_reg if kind == "regularized" else hp)
            gl, gh, gr = gf.wave_pass_fused_cuda(*args)
            rl, rh, rr = gf.wave_pass_fused_plain(*args)
            torch.cuda.synchronize()
            key = f"wave_pass_fused K={K} {case} {kind}"
            check(torch.equal(gl, rl), f"{key}: leaf_of_row")
            d = _rec_diffs(torch, gr, rr)
            check(d["feature"] == d["threshold"] == d["default_left"] == 0,
                  f"{key}: chosen splits differ {d}")
            check(bool(torch.isfinite(gr[0]).any()),
                  f"{key}: no child found a split")
            if kind != "continuous":
                check(torch.equal(gh, rh) and torch.equal(gr, rr),
                      f"{key}: not bitwise equal ({d})")
            res[kind] = d
        if case == "dup":
            emit({"phase": "fused_kernels", "name": "wave_pass_fused",
                  "K": K, "case": case, "N": n, "bitwise": True})
            continue
        lay = hc.wave_hist_layout(K, 2, F, B, n, False, hc._sm_count(0))
        if case == "half_2^16":
            check(lay.plan.direct, "the 2^16-row case of kernel #9 is not "
                                   "on the direct route")
        cand_rows = int((slot_all >= 0).sum())
        app_rows = int(torch.isin(lor, tbl[0, :napp]).sum())
        small_rows = int(small.sum())
        nbytes = 8 * n + app_rows + cand_rows + small_rows * (F + 8) \
            + K * 2 * F * B * 4 + 16 * 128 * 4 + _scan_nbytes(K, F, B)
        bms, by = bound_ms(nbytes, small_rows * F * 2 + 2 * K * 2 * F * B
                           * 40)
        st = {}
        ms, dms = timings(lambda: gf.wave_pass_fused_cuda(*args), 20,
                          stats=st)
        plain_ms = time_ms(lambda: gf.wave_pass_fused_plain(*args), 3, 1)
        rec = dict(name="wave_pass_fused", K=K, case=case, N=n, F=F, B=B,
                   small_rows=small_rows, max_abs_err=0.0,
                   tol=0.0, ms=ms, device_ms=dms, plain_ms=plain_ms,
                   library_ms=None,
                   bound_ms=bms, bound_by=by, bound_us=bms * 1e3,
                   launches_per_call=st["kernels_per_call"],
                   plan=lay.plan._asdict(),
                   continuous_max_diff=res["continuous"])
        emit({"phase": "fused_kernels", "kernel_ms": ms, **rec})
        recs[(K, case)] = rec
    return recs[(16, "few")]


def fused_tiled_phase(hc, gf, torch, dev, X_c):
    """Kernel #10 against its plain version: at the Criteo storage X_c
    ([39, 2^20], B = 256) for K in {1, 16}, a mid-tree wave of 12 applied
    splits whose K candidates hold a few percent of the rows; a real
    wave's shape, K = 16 candidates that are all the leaves after 8
    applied splits, so that about half of the rows land in a smaller
    child ("half"), on 2^20 rows (the tiled route) and on the first 2^16
    (the direct route); at F = 100, B = 64 with a live pending table
    (K = 16); and with int8 values (exact int32 sums, descaled after the
    subtraction). Random decision bits; parents and child statistics from
    the real rows; per-child feature masks. Bitwise on grid values; on
    continuous values the chosen splits equal. A record carries the
    histogram's plan and the kernels launched per call (profiler)."""
    gen = torch.Generator(device=dev).manual_seed(23)
    rng = np.random.RandomState(24)
    hp = _fused_hp()
    L = N_LEAVES
    recs = []
    cases = [("criteo", X_c, 256, 1, False, False),
             ("criteo", X_c, 256, 16, False, False),
             ("criteo_half", X_c, 256, 16, False, False),
             ("criteo_half_2^16", X_c[:, :1 << 16].contiguous(), 256, 16,
              False, False),
             ("wide_pending", None, 64, 16, True, False),
             ("criteo_int8", X_c, 256, 16, True, True)]
    for name, X, B, K, pending, quant in cases:
        if X is None:
            X = torch.randint(0, 63, (100, N_ROWS), generator=gen,
                              device=dev, dtype=torch.int32).to(torch.uint8)
        F, N = X.shape
        half = "half" in name
        # "half": leaves 0-7 split into 0-15, every row a candidate's
        nl0 = 8 if half else 120
        lor = torch.randint(0, nl0, (N,), generator=gen, device=dev,
                            dtype=torch.int32)
        pend = torch.full((128,), -1, dtype=torch.int32, device=dev)
        pnl0 = 0
        if pending:
            # a deferred wave split 8 leaves into new leaves 120-127
            pend[:8] = torch.from_numpy(rng.choice(nl0, 8, replace=False))
            pnl0, nl0 = nl0, nl0 + 8
        napp = 8 if half else min(K, 12)
        t = np.full((16, 128), -1, np.int32)
        t[0, :napp] = rng.choice(nl0, napp, replace=False)
        t[7, :K] = rng.choice(nl0 + napp, K, replace=False)
        t[15] = nl0
        tbl = torch.from_numpy(t).to(dev)
        Kd = max(K, napp, 8 if pending else 1)
        dec = torch.randint(0, 8, (Kd, N), generator=gen, device=dev,
                            dtype=torch.int32).to(torch.uint8)
        every = dec | 2                     # all candidate rows in slot
        lor1, _ = hc.wave_apply_plain((dec >> 2) & 1, lor, torch.cat(
            [pend[None], torch.full((14, 128), -1, dtype=torch.int32,
                                    device=dev),
             torch.full((1, 128), pnl0, dtype=torch.int32, device=dev)]), L)
        _, slot_all = hc.wave_apply_plain(every, lor1, tbl, L)
        _, slot_small = hc.wave_apply_plain(dec, lor1, tbl, L)
        sil = torch.from_numpy(rng.randint(0, 2, K).astype(bool)).to(dev)
        fmeta = torch.tensor(np.stack([np.full(F, B - 1),
                                       rng.randint(0, 3, F),
                                       rng.randint(0, B - 1, F),
                                       np.zeros(F), np.zeros(F)]),
                             dtype=torch.int32, device=dev)
        fmask = torch.from_numpy((rng.rand(2 * K, F) < 0.9).astype(
            np.uint8)).to(dev)
        res = {}
        for kind in (("int8",) if quant else ("grid", "continuous")):
            if quant:
                vals = torch.randint(-127, 128, (2, N), generator=gen,
                                     device=dev, dtype=torch.int32) \
                    .to(torch.int8)
                vals[1] = vals[1].abs()
                scale = torch.tensor([0.0078125, 0.00390625], device=dev)
            else:
                vals = (_grid_vals(torch, gen, 2, N, dev) if kind == "grid"
                        else torch.randn((2, N), generator=gen, device=dev))
                vals[1] = vals[1].abs()
                scale = None
            parent, scal = _fused_operands(torch, hc, X, vals, slot_all,
                                           slot_small, sil, K, B)
            args = (X, vals, dec, lor, tbl, pend,
                    torch.full((1,), pnl0, dtype=torch.int32, device=dev),
                    parent, scal, fmeta, fmask, K, B, L, hp, scale)
            gl, gh, gr = gf.wave_pass_fused_tiled_cuda(*args)
            rl, rh, rr = gf.wave_pass_fused_tiled_plain(*args)
            torch.cuda.synchronize()
            check(torch.equal(gl, rl),
                  f"wave_pass_fused_tiled {name} K={K}: leaf_of_row")
            d = _rec_diffs(torch, gr, rr)
            check(d["feature"] == d["threshold"] == d["default_left"] == 0,
                  f"wave_pass_fused_tiled {name} K={K} {kind}: chosen "
                  f"splits differ {d}")
            if kind != "continuous":
                check(torch.equal(gh, rh) and torch.equal(gr, rr),
                      f"wave_pass_fused_tiled {name} K={K} {kind}: not "
                      f"bitwise equal ({d})")
            res[kind] = d
        if pending:
            check(not torch.equal(lor1, lor), "the pending table moved no row")
        live = int(((slot_all >= 0) | torch.isin(lor, tbl[0, :napp])
                    | torch.isin(lor, pend)).sum())
        small_rows = int((slot_small >= 0).sum())
        C_bytes = 2 if quant else 8
        # leaf ids in and out; one to three dec bytes per row of a live
        # entry's leaf; the smaller children's bins and values
        nbytes = 8 * N + 3 * live + small_rows * (F + C_bytes) \
            + K * 2 * F * B * 4 + 16 * 128 * 4 + 128 * 4 \
            + _scan_nbytes(K, F, B) + 2 * K * F
        bms, by = bound_ms(nbytes, small_rows * F * 2 + 2 * K * 2 * F * B
                           * 40)
        st = {}
        ms, dms = timings(lambda: gf.wave_pass_fused_tiled_cuda(*args), 20,
                          stats=st)
        plain_ms = time_ms(lambda: gf.wave_pass_fused_tiled_plain(*args), 3,
                           1)
        plan = hc.plan_hist_tiles(K, 2, F, B, quantized=quant, rows=N)
        if name == "criteo_half_2^16":
            check(plan.direct, "the 2^16-row fused case is not on the "
                               "direct route")
        rec = dict(name="wave_pass_fused_tiled", case=name, K=K, N=N, F=F,
                   B=B, Kd=Kd, max_abs_err=0.0, tol=0.0, ms=ms,
                   device_ms=dms, plain_ms=plain_ms, library_ms=None,
                   bound_ms=bms, bound_by=by, bound_us=bms * 1e3,
                   small_rows=small_rows, plan=plan._asdict(),
                   launches_per_call=st["kernels_per_call"],
                   continuous_max_diff=res.get("continuous"))
        emit({"phase": "fused_kernels", "kernel_ms": ms, **rec})
        recs.append(rec)
        del dec, every
    return recs[1]


def _train_timed(lt, hc, torch, params, ds, rounds, callbacks=(),
                 evals=None, valid_sets=()):
    """Train `rounds` rounds (with `callbacks` besides the timing one, and
    `valid_sets`); (booster, launches, per-round ms, train AUC (the first
    metric) per round). `evals`, a list, receives every round's whole
    evaluation."""
    ends, resumes, aucs = [], [], []

    def stamp(env):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        res = env.model.eval_train()
        aucs.append(res[0][2])
        if evals is not None:
            evals.append({m: float(v) for _, m, v, _ in res})
        resumes.append(time.perf_counter())
    stamp.order = 5
    hc.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = lt.train(params, ds, num_boost_round=rounds,
                   valid_sets=list(valid_sets),
                   callbacks=[stamp, *callbacks])
    torch.cuda.synchronize()
    iter_ms = [(b - a) * 1e3 for a, b in zip([t0] + resumes[:-1], ends)]
    return bst, dict(hc.LAUNCHES), iter_ms, aucs


def fused_train_phase(lt, hc, torch, params, ds):
    """bench.py's model on the bench data under histogram_impl=fused, 8
    rounds: the narrow fused route with kernel #9, AUC > 0.88, and the
    first tree equal to the plain versions'."""
    p = {**params, "histogram_impl": "fused"}
    bst, launches, iter_ms, aucs = _train_timed(lt, hc, torch, p, ds, 8)
    g = bst._gbdt
    trees = g.models
    lv_err = _same_host_tree(_plain_trees(torch, g, N_ROWS)[0], trees[0])
    emit({"phase": "fused_train", "rows": N_ROWS, "grow_route": g.grow_route,
          "fused_veto_reasons": g.fused_veto_reasons, "iter_ms": iter_ms,
          "steady_ms_per_iter": float(np.mean(iter_ms[1:])),
          "launches": launches, "train_auc_per_round": aucs,
          "leaves": [t.num_leaves for t in trees],
          "first_tree_same": lv_err is not None,
          "leaf_value_max_abs_err": lv_err})
    check(g.grow_route == "fused" and g.fused_veto_reasons == [],
          f"bench under histogram_impl=fused took route {g.grow_route}")
    check(launches["wave_pass_fused"] > 0 and launches["wave_pass"] == 0,
          "the fused route did not run kernel #9 alone")
    check(len(trees) == 8 and aucs[-1] > 0.88,
          f"fused train AUC {aucs[-1]} <= 0.88")
    check(lv_err is not None and lv_err <= 1e-6,
          f"fused first tree differs from the plain versions' ({lv_err})")
    return launches


class _F32Cumsum:
    """A stand-in for the torch module in ops/split.py that gives its f64
    prefix sums the f32 CUDA scan the port used before (the `before` of
    the criteo_fused phase's cumsum comparison)."""

    def __init__(self, torch):
        self._torch = torch

    def __getattr__(self, name):
        return getattr(self._torch, name)

    def cumsum(self, x, dim):
        return self._torch.cumsum(x.to(self._torch.float32), dim=dim) \
            .to(self._torch.float64)


def criteo_fused_phase(lt, hc, torch, params, ds):
    """The Criteo table under histogram_impl=fused, 8 rounds: the general
    fused route with kernel #10, AUC never falls and passes CRITEO_AUC_MIN,
    the first tree equals the plain versions'; 2 rounds with
    fused_relabel_fusion=false grow the same trees. Then the search's
    cumsum on the card: the first tree of the plain versions with an f32
    prefix scan against the f64 one."""
    from lightgbm_tpu_torch.ops import split as ts
    p = {**params, "histogram_impl": "fused"}
    bst, launches, iter_ms, aucs = _train_timed(lt, hc, torch, p, ds, 8)
    g = bst._gbdt
    trees = g.models
    t_plain = _plain_trees(torch, g, N_ROWS)[0]
    lv_err = _same_host_tree(t_plain, trees[0])
    off, _, off_ms, _ = _train_timed(
        lt, hc, torch, {**p, "fused_relabel_fusion": False}, ds, 2)
    off_errs = [_same_host_tree(a, b) for a, b in zip(off._gbdt.models,
                                                      trees[:2])]
    saved = ts.torch
    ts.torch = _F32Cumsum(torch)
    try:
        t_f32 = _plain_trees(torch, g, N_ROWS)[0]
    finally:
        ts.torch = saved
    cum_err = _same_host_tree(t_f32, t_plain)
    emit({"phase": "criteo_fused", "rows": N_ROWS,
          "grow_route": g.grow_route,
          "fused_veto_reasons": g.fused_veto_reasons, "iter_ms": iter_ms,
          "steady_ms_per_iter": float(np.mean(iter_ms[1:])),
          "launches": launches, "train_auc_per_round": aucs,
          "leaves": [t.num_leaves for t in trees],
          "categorical_splits": [t.num_cat for t in trees],
          "first_tree_same": lv_err is not None,
          "leaf_value_max_abs_err": lv_err,
          "fusion_off_ms": off_ms,
          "fusion_off_same_trees": all(e is not None for e in off_errs),
          "fusion_off_leaf_value_max_abs_err": off_errs,
          "cumsum_f32_vs_f64_first_tree": {
              "same_structure": cum_err is not None,
              "leaf_value_max_abs_err": cum_err,
              "split_gain_max_abs_err": (
                  float(np.max(np.abs(t_f32.split_gain - t_plain.split_gain)))
                  if cum_err is not None else None)}})
    check(g.grow_route == "fused_tiled" and g.fused_veto_reasons == [],
          f"Criteo under histogram_impl=fused took route {g.grow_route}")
    check(launches["wave_pass_fused_tiled"] > 0
          and launches["wave_pass_fused"] == 0,
          "the Criteo fused run did not launch kernel #10")
    check(all(b >= a for a, b in zip(aucs, aucs[1:])),
          f"Criteo fused train AUC fell between rounds: {aucs}")
    check(len(trees) == 8 and aucs[-1] > CRITEO_AUC_MIN,
          f"Criteo fused train AUC {aucs[-1]} <= {CRITEO_AUC_MIN}")
    check(lv_err is not None and lv_err <= 1e-6,
          f"Criteo fused first tree differs from the plain versions' "
          f"({lv_err})")
    check(all(e is not None and e <= 1e-6 for e in off_errs),
          f"fused_relabel_fusion=false grew other trees ({off_errs})")
    return launches


# ---------------------------------------------------------------------------
# the constraints: monotone `basic` and interaction sets
# ---------------------------------------------------------------------------
def constraints_kernel_phase(hc, gf, torch, dev, X_c):
    """Kernel #10 with its monotone operand live, against its plain version,
    at the Criteo storage X_c ([39, 2^20], B = 256) for K in {1, 16}: the
    mid-tree wave of fused_tiled_phase's "criteo" case, every odd child
    bounded to a window of a quarter of its output around it, the features'
    directions drawn from {-1, 0, +1}. Records bitwise on grid values,
    chosen splits equal on continuous ones; the operand must change some
    records. Then the same call with the operand off (+-inf, zeros), the
    unconstrained kernel's input, timed beside it."""
    gen = torch.Generator(device=dev).manual_seed(25)
    rng = np.random.RandomState(26)
    hp = _fused_hp()
    L, B = N_LEAVES, 256
    F, N = X_c.shape
    recs = []
    for K in (1, 16):
        nl0, napp = 120, min(K, 12)
        lor = torch.randint(0, nl0, (N,), generator=gen, device=dev,
                            dtype=torch.int32)
        pend = torch.full((128,), -1, dtype=torch.int32, device=dev)
        t = np.full((16, 128), -1, np.int32)
        t[0, :napp] = rng.choice(nl0, napp, replace=False)
        t[7, :K] = rng.choice(nl0 + napp, K, replace=False)
        t[15] = nl0
        tbl = torch.from_numpy(t).to(dev)
        Kd = max(K, napp)
        # bits 0 and 1 only: no pending entry is live
        dec = torch.randint(0, 4, (Kd, N), generator=gen, device=dev,
                            dtype=torch.int32).to(torch.uint8)
        _, slot_all = hc.wave_apply_plain(dec | 2, lor, tbl, L)
        _, slot_small = hc.wave_apply_plain(dec, lor, tbl, L)
        sil = torch.from_numpy(rng.randint(0, 2, K).astype(bool)).to(dev)
        mono = rng.choice([-1, 0, 1], F)
        meta = np.stack([np.full(F, B - 1), rng.randint(0, 3, F),
                         rng.randint(0, B - 1, F), np.zeros(F), mono])
        fmeta = torch.tensor(meta, dtype=torch.int32, device=dev)
        fmeta_off = fmeta.clone()
        fmeta_off[4] = 0
        fmask = torch.from_numpy((rng.rand(2 * K, F) < 0.9).astype(
            np.uint8)).to(dev)
        res, changed = {}, {}
        for kind in ("grid", "continuous"):
            vals = (_grid_vals(torch, gen, 2, N, dev) if kind == "grid"
                    else torch.randn((2, N), generator=gen, device=dev))
            vals[1] = vals[1].abs()
            parent, scal_off = _fused_operands(torch, hc, X_c, vals,
                                               slot_all, slot_small, sil, K,
                                               B)
            scal = scal_off.clone()
            out = scal[3, 1::2]
            scal[5, 1::2] = out - 0.25 * out.abs()
            scal[6, 1::2] = out + 0.25 * out.abs()
            args = (X_c, vals, dec, lor, tbl, pend,
                    torch.zeros(1, dtype=torch.int32, device=dev), parent,
                    scal, fmeta, fmask, K, B, L, hp, None)
            args_off = args[:8] + (scal_off, fmeta_off) + args[10:]
            gl, gh, gr = gf.wave_pass_fused_tiled_cuda(*args)
            rl, rh, rr = gf.wave_pass_fused_tiled_plain(*args)
            _, _, gr_off = gf.wave_pass_fused_tiled_cuda(*args_off)
            _, _, rr_off = gf.wave_pass_fused_tiled_plain(*args_off)
            torch.cuda.synchronize()
            key = f"wave_pass_fused_tiled monotone K={K} {kind}"
            check(torch.equal(gl, rl), f"{key}: leaf_of_row")
            d = _rec_diffs(torch, gr, rr)
            check(d["feature"] == d["threshold"] == d["default_left"] == 0,
                  f"{key}: chosen splits differ {d}")
            check(bool(torch.isfinite(gr[0]).any()),
                  f"{key}: no child found a split")
            d_off = _rec_diffs(torch, gr_off, rr_off)
            check(d_off["feature"] == d_off["threshold"]
                  == d_off["default_left"] == 0,
                  f"{key}, operand off: chosen splits differ {d_off}")
            if kind == "grid":
                check(torch.equal(gh, rh) and torch.equal(gr, rr),
                      f"{key}: not bitwise equal ({d})")
                check(torch.equal(gr_off, rr_off),
                      f"{key}, operand off: not bitwise equal ({d_off})")
            changed[kind] = int((gr != gr_off).any(0).sum())
            res[kind] = d
        check(K == 1 or changed["grid"] > 0,
              f"the monotone operand changed no record at K={K}")
        small_rows = int((slot_small >= 0).sum())
        live = int(((slot_all >= 0) | torch.isin(lor, tbl[0, :napp])).sum())
        nbytes = 8 * N + 2 * live + small_rows * (F + 8) \
            + K * 2 * F * B * 4 + 16 * 128 * 4 + 128 * 4 \
            + _scan_nbytes(K, F, B) + 2 * K * F
        bms, by = bound_ms(nbytes, small_rows * F * 2 + 2 * K * 2 * F * B
                           * 44)
        ms, dms = timings(lambda: gf.wave_pass_fused_tiled_cuda(*args), 20)
        ms_off, dms_off = timings(
            lambda: gf.wave_pass_fused_tiled_cuda(*args_off), 20)
        ms2, dms2 = timings(lambda: gf.wave_pass_fused_tiled_cuda(*args), 20)
        plain_ms = time_ms(lambda: gf.wave_pass_fused_tiled_plain(*args), 3,
                           1)
        rec = dict(name="wave_pass_fused_tiled", operand="monotone", K=K,
                   N=N, F=F, B=B, Kd=Kd, max_abs_err=0.0, tol=0.0,
                   ms=[ms, ms2], device_ms=[dms, dms2], ms_off=ms_off,
                   device_ms_off=dms_off, plain_ms=plain_ms,
                   bound_ms=bms, bound_by=by, small_rows=small_rows,
                   bounded_children=K, records_changed=changed,
                   continuous_max_diff=res["continuous"])
        emit({"phase": "constraints_kernel", **rec})
        recs.append(rec)
    return recs


def _sweep_monotone(bst, rows, feats, grids=None):
    """Raw scores of `rows` along a 32-point sweep of each feature j of
    `feats` ((j, direction) pairs; over grids[j] where given, else
    [-3, 3]), through Booster.predict, whose batches of 100k rows and more
    take the device predictor: (worst step against the direction, steps
    that moved with it) per feature."""
    out = {}
    for j, sign in feats:
        grid = (grids or {}).get(j)
        if grid is None:
            grid = np.linspace(-3.0, 3.0, 32, dtype=np.float32)
        Xs = np.repeat(rows, len(grid), axis=0)
        Xs[:, j] = np.tile(grid, len(rows))
        p = bst.predict(Xs, raw_score=True).reshape(len(rows), len(grid))
        step = np.diff(p, axis=1) * sign
        out[j] = (float(step.min()), int((step > 0).sum()))
    return out


def constraints_train_phase(lt, hc, torch, params, ds, w, t_free):
    """bench.py's model with features 0-3 constrained in the directions of
    their weights `w` in the label (+1 / +1 / +1 / -1 for the bench data),
    monotone `basic`, 4 rounds on the megakernel route and 4 under
    histogram_impl=fused (the general fused kernel, #10, with its
    monotone operand): the first tree equals the plain versions' and
    differs from the unconstrained run's first tree `t_free` (the
    constraints bind), and the raw score of 4096 rows never moves against
    a constraint along a sweep of its feature (the device predictor), and
    moves along some. Returns the launches of the fused run."""
    mono = [int(np.sign(x)) for x in w[:4]] + [0] * (N_FEAT - 4)
    rows = np.random.RandomState(45).normal(size=(4096, N_FEAT)) \
        .astype(np.float32)
    fused_launches = None
    for impl, route in (("auto", "mega"), ("fused", "fused_tiled")):
        p = {**params, "monotone_constraints": mono, "histogram_impl": impl}
        bst, launches, iter_ms, aucs = _train_timed(lt, hc, torch, p, ds, 4)
        g = bst._gbdt
        trees = g.models
        lv_err = _same_host_tree(_plain_trees(torch, g, N_ROWS)[0],
                                 trees[0])
        free_err = _same_host_tree(t_free, trees[0])
        g._device_tables_cache = None
        sweep = _sweep_monotone(bst, rows,
                                [(j, mono[j]) for j in range(4)])
        emit({"phase": "constraints_train", "model": "bench",
              "monotone_constraints": mono[:4], "rows": N_ROWS,
              "grow_route": g.grow_route,
              "fused_veto_reasons": g.fused_veto_reasons,
              "iter_ms": iter_ms,
              "steady_ms_per_iter": float(np.mean(iter_ms[1:])),
              "launches": launches, "train_auc_per_round": aucs,
              "leaves": [t.num_leaves for t in trees],
              "first_tree_same": lv_err is not None,
              "leaf_value_max_abs_err": lv_err,
              "unconstrained_first_tree_leaf_value_max_abs_diff": free_err,
              "sweep_rows": len(rows), "sweep_worst_step": sweep,
              "sweep_device_route":
                  g._device_tables_cache is not None})
        check(g.grow_route == route and g.fused_veto_reasons == [],
              f"monotone bench under {impl} took route {g.grow_route}")
        kernels = (("wave_pass", "wave_relabel", "build_histogram_slots",
                    "take_leaf_values") if route == "mega"
                   else ("wave_pass_fused_tiled", "build_histogram_slots",
                         "take_leaf_values"))
        for name in kernels:
            check(launches[name] > 0,
                  f"{name} never launched on the monotone {route} run")
        if route == "fused_tiled":
            check(launches["wave_pass_fused"] == 0
                  and launches["wave_pass"] == 0,
                  "the monotone fused run launched a narrow kernel")
            fused_launches = launches
        check(len(trees) == 4 and aucs[-1] > 0.75,
              f"monotone bench ({route}) train AUC {aucs[-1]} <= 0.75")
        check(lv_err is not None and lv_err <= 1e-6,
              f"monotone bench ({route}) first tree differs from the plain "
              f"versions' ({lv_err})")
        check(free_err is None or free_err > 0.0,
              f"monotone bench ({route}): the constraints changed nothing")
        check(g._device_tables_cache is not None,
              "the sweep did not take the device predictor")
        check(all(w >= 0.0 for w, _ in sweep.values()),
              f"monotone bench ({route}): a score moved against its "
              f"constraint {sweep}")
        check(sum(m for _, m in sweep.values()) > 0,
              f"monotone bench ({route}): no constrained feature moved the "
              f"score {sweep}")
    return fused_launches


def _paths_in_sets(tree, sets):
    """Whether every root-to-leaf path of a host tree splits on features
    of one interaction set."""
    def walk(node, feats):
        if node < 0:
            return any(feats <= s for s in sets)
        f = feats | {int(tree.split_feature[node])}
        return (walk(int(tree.left_child[node]), f)
                and walk(int(tree.right_child[node]), f))
    return tree.num_leaves <= 1 or walk(0, frozenset())


def constraints_criteo_phase(lt, hc, torch, params, ds):
    """The Criteo table with two interaction sets (count columns 0-6 with
    categorical columns 13-25, and 7-12 with 26-38), 2 rounds on the apply
    route and 2 under histogram_impl=fused (#10 with per-child feature
    masks): the first tree equals the plain versions', and every branch
    stays inside one set. Returns the launches of the fused run."""
    sets = [list(range(0, 7)) + list(range(13, 26)),
            list(range(7, 13)) + list(range(26, 39))]
    set_ids = [set(s) for s in sets]
    fused_launches = None
    for impl, route in (("auto", "apply"), ("fused", "fused_tiled")):
        p = {**params, "interaction_constraints": sets,
             "histogram_impl": impl}
        bst, launches, iter_ms, aucs = _train_timed(lt, hc, torch, p, ds, 2)
        g = bst._gbdt
        trees = g.models
        lv_err = _same_host_tree(_plain_trees(torch, g, N_ROWS)[0],
                                 trees[0])
        # host trees name real feature indices, as the sets do
        in_sets = all(_paths_in_sets(t, set_ids) for t in trees)
        emit({"phase": "constraints_train", "model": "criteo",
              "interaction_constraints": sets, "rows": N_ROWS,
              "grow_route": g.grow_route,
              "fused_veto_reasons": g.fused_veto_reasons,
              "iter_ms": iter_ms,
              "steady_ms_per_iter": float(np.mean(iter_ms[1:])),
              "launches": launches, "train_auc_per_round": aucs,
              "leaves": [t.num_leaves for t in trees],
              "categorical_splits": [t.num_cat for t in trees],
              "first_tree_same": lv_err is not None,
              "leaf_value_max_abs_err": lv_err,
              "branches_inside_one_set": in_sets})
        check(g.grow_route == route and g.fused_veto_reasons == [],
              f"Criteo with interaction sets under {impl} took route "
              f"{g.grow_route}")
        name = "wave_apply" if route == "apply" else "wave_pass_fused_tiled"
        check(launches[name] > 0,
              f"{name} never launched on the interaction {route} run")
        if route == "fused_tiled":
            fused_launches = launches
        check(lv_err is not None and lv_err <= 1e-6,
              f"Criteo interaction ({route}) first tree differs from the "
              f"plain versions' ({lv_err})")
        check(in_sets, f"Criteo interaction ({route}): a branch left its "
                       "set")
    return fused_launches


# ---------------------------------------------------------------------------
# quantized gradients and row sampling
# ---------------------------------------------------------------------------
class _Int8Calls:
    """Counts, while installed, the calls of the histogram kernels'
    wrappers whose values are int8 (the quantized modes), by kernel."""

    def __init__(self, torch, hc, hr, gf):
        self.torch = torch
        # (module, wrapper, index of its values argument, kernel)
        self.spots = [(hc, "build_histogram_slots_cuda", 1,
                       "build_histogram_slots"),
                      (hc, "wave_pass_cuda", 1, "wave_pass"),
                      (hr, "hist_rowwise_cuda", 1, "hist_rowwise"),
                      (hr, "hist_rowwise_packed_cuda", 2,
                       "hist_rowwise_packed"),
                      (gf, "wave_pass_fused_tiled_cuda", 1,
                       "wave_pass_fused_tiled")]
        self.n = {k: 0 for *_, k in self.spots}

    def __enter__(self):
        self.saved = []
        for mod, name, arg, key in self.spots:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def counted(*a, _fn=fn, _arg=arg, _key=key, **k):
                if a[_arg].dtype == self.torch.int8:
                    self.n[_key] += 1
                return _fn(*a, **k)
            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def quantized_phase(lt, hc, hr, gf, torch, dev, params, ds, params_c,
                    ds_c):
    """use_quantized_grad (4 bins, stochastic rounding) on every wave
    route: the bench model 8 rounds on "mega", 4 under
    histogram_impl=fused ("fused_tiled") and 4 with quant_train_renew_leaf;
    the Criteo table 2 rounds each on "apply", under force_row_wise,
    rowwise_packed and fused. Each run: its route, its kernels launched
    with int8 values, the first tree equal to the plain versions' (int
    sums are exact: structure bitwise, leaf values within 1e-6), train AUC
    above the float run of the same configuration and rounds - 0.01. Then
    the discretizer on the card against its CPU run, bitwise, and its
    time per tree with and without the draws."""
    from lightgbm_tpu_torch.ops.grow_wave import discretize_gradients
    from lightgbm_tpu_torch.utils.random import PRNGKey, split, uniform
    qp = dict(use_quantized_grad=True, num_grad_quant_bins=4,
              stochastic_rounding=True)
    cases = [
        ("bench", params, ds, {}, 8, "mega", "wave_pass"),
        ("bench", params, ds, {"histogram_impl": "fused"}, 4, "fused_tiled",
         "wave_pass_fused_tiled"),
        ("bench", params, ds, {"quant_train_renew_leaf": True}, 4, "mega",
         "wave_pass"),
        ("criteo", params_c, ds_c, {}, 2, "apply", "build_histogram_slots"),
        ("criteo", params_c, ds_c, {"force_row_wise": True}, 2, "apply",
         "hist_rowwise"),
        ("criteo", params_c, ds_c, {"histogram_impl": "rowwise_packed"}, 2,
         "apply", "hist_rowwise_packed"),
        ("criteo", params_c, ds_c, {"histogram_impl": "fused"}, 2,
         "fused_tiled", "wave_pass_fused_tiled")]
    out = {}
    for model, base, d, over, rounds, route, k8 in cases:
        p = {**base, **over}
        fb, _, f_ms, f_aucs = _train_timed(lt, hc, torch, p, d, rounds)
        del fb
        with _Int8Calls(torch, hc, hr, gf) as q8:
            bst, launches, iter_ms, aucs = _train_timed(
                lt, hc, torch, {**p, **qp}, d, rounds)
        g = bst._gbdt
        trees = g.models
        lv_err = _same_host_tree(_plain_trees(torch, g, N_ROWS)[0],
                                 trees[0])
        key = f"{model} {route}" + "".join(f" {k}={v}"
                                           for k, v in over.items())
        emit({"phase": "quantized", "model": model, "case": key,
              "rows": N_ROWS, "grow_route": g.grow_route,
              "hist_route": g.hist_route, "rounds": rounds,
              "iter_ms": iter_ms,
              "steady_ms_per_iter": float(np.mean(iter_ms[1:])),
              "float_iter_ms": f_ms, "launches": launches,
              "int8_launches": q8.n, "train_auc_per_round": aucs,
              "float_train_auc_per_round": f_aucs,
              "leaves": [t.num_leaves for t in trees],
              "first_tree_same": lv_err is not None,
              "leaf_value_max_abs_err": lv_err})
        check(g.grow_route == route, f"quantized {key} took route "
                                     f"{g.grow_route}")
        check(q8.n[k8] > 0 and launches["wave_pass_fused"] == 0,
              f"quantized {key}: {k8} never launched on int8 values")
        check(launches["take_leaf_values"] == rounds,
              f"quantized {key}: {launches['take_leaf_values']} score "
              f"updates in {rounds} rounds")
        if over.get("quant_train_renew_leaf"):
            # the leaf renewal's exact float sums: #1 on f32 values
            check(launches["build_histogram_slots"]
                  > q8.n["build_histogram_slots"],
                  f"quantized {key}: no float leaf sums on kernel #1")
        check(lv_err is not None and lv_err <= 1e-6,
              f"quantized {key}: first tree differs from the plain "
              f"versions' ({lv_err})")
        check(len(trees) == rounds and aucs[-1] > f_aucs[-1] - 0.01,
              f"quantized {key}: train AUC {aucs[-1]} <= the float run's "
              f"{f_aucs[-1]} - 0.01")
        out[key] = dict(launches=launches, int8_launches=dict(q8.n))
        del bst, g, trees

    # the discretizer on the card against its CPU run, and its cost
    gen = torch.Generator(device=dev).manual_seed(9)
    g = torch.randn(N_ROWS, generator=gen, device=dev)
    h = torch.rand(N_ROWS, generator=gen, device=dev) * 0.25
    for stoch in (True, False):
        v8, sc = discretize_gradients(g, h, 4, stoch, -7)
        v8c, scc = discretize_gradients(g.cpu(), h.cpu(), 4, stoch, -7)
        check(torch.equal(v8.cpu(), v8c) and torch.equal(sc.cpu(), scc),
              f"discretizer (stochastic={stoch}): the card's int8 values "
              f"differ from the CPU's")
    key = split(PRNGKey(-7))[0]
    check(torch.equal(uniform(key, (N_ROWS,), dev).cpu(),
                      uniform(key, (N_ROWS,))),
          "threefry uniform: the card's draws differ from the CPU's")
    rec = {}
    for name, fn in (
            ("discretizer", lambda: discretize_gradients(g, h, 4, True, 7)),
            ("discretizer_no_draws",
             lambda: discretize_gradients(g, h, 4, False, 7)),
            ("uniform", lambda: uniform(key, (N_ROWS,), dev))):
        st = {}
        ms, dms = timings(fn, 20, stats=st)
        rec[name] = dict(ms=ms, device_ms=dms,
                         kernels_per_call=st["kernels_per_call"])
    emit({"phase": "quantized_draws", "rows": N_ROWS,
          "draws_per_tree": 2, "bitwise_cpu": True, **rec})
    return out


def sampling_phase(lt, hc, torch, params, ds):
    """Row sampling on the megakernel route: bagging_fraction 0.8 with
    bagging_freq 1 for 8 rounds, and GOSS for 12 (its warm-up at
    learning_rate 0.1 is 10 rounds). The first sampled tree (0 for
    bagging, 10 for GOSS) equals the plain versions' tree from the same
    scores, mask and seed; the mask counts are exact (int(0.8 N) rows in
    bag; top_k rows kept at 1, the sampled rest amplified; both counted
    again by NumPy from the CPU's draws, ties at the threshold kept as the
    JAX package keeps them); train AUC > 0.85. The mask's time a draw is
    printed."""
    from lightgbm_tpu_torch.utils.random import PRNGKey, fold_in, uniform
    cases = (("bagging", dict(bagging_fraction=0.8, bagging_freq=1), 8, 0),
             ("goss", dict(data_sample_strategy="goss"), 12, 10))
    out = {}
    for name, over, rounds, first in cases:
        snap = {}

        def keep(env, _first=first, _snap=snap):
            if env.iteration == _first:
                _snap["scores"] = env.model._gbdt.scores[0].clone()
        keep.before_iteration = True
        bst, launches, iter_ms, aucs = _train_timed(
            lt, hc, torch, {**params, **over}, ds, rounds, [keep])
        g = bst._gbdt
        trees = g.models
        scores = snap["scores"] if first else None
        lv_err = _same_host_tree(_plain_trees(torch, g, N_ROWS, scores,
                                              first)[0], trees[first])
        strat = g.sample_strategy
        if scores is None:
            scores = torch.full((N_ROWS,), float(np.float32(
                g.objective.boost_from_score(0))), device=g.X_t.device)
        gg, hh = g.objective.get_gradients(scores, g.label_dev,
                                           g.weight_dev)
        mask = strat.sample(first, gg, hh)
        in_bag = int((mask > 0).sum())
        ones = int((mask == 1.0).sum())
        amplified = int((mask > 1.0).sum())
        # the same rule in NumPy over the CPU's threefry draws
        cfg = g.config
        if name == "bagging":
            u = uniform(fold_in(PRNGKey(cfg.bagging_seed), first),
                        (N_ROWS,)).numpy()
            cnt = int(N_ROWS * cfg.bagging_fraction)
            want_ones, want_amp = int((u <= np.sort(u)[cnt - 1]).sum()), 0
        else:
            ga = np.abs((gg * hh).cpu().numpy())
            top_k = int(N_ROWS * cfg.top_rate)
            top = ga >= np.sort(ga)[N_ROWS - top_k]
            u = uniform(fold_in(PRNGKey(cfg.data_random_seed), first),
                        (N_ROWS,)).numpy()
            p_acc = np.float32(int(N_ROWS * cfg.other_rate)
                               / (N_ROWS - top_k))
            want_ones = int(top.sum())
            want_amp = int((~top & (u < p_acc)).sum())
        st = {}
        ms, dms = timings(lambda: strat.sample(first, gg, hh), 20, stats=st)
        emit({"phase": "sampling", "case": name, "rows": N_ROWS,
              "grow_route": g.grow_route, "rounds": rounds,
              "first_sampled_tree": first, "iter_ms": iter_ms,
              "steady_ms_per_iter": float(np.mean(iter_ms[1:])),
              "launches": launches, "train_auc_per_round": aucs,
              "leaves": [t.num_leaves for t in trees],
              "in_bag_rows": in_bag, "rows_at_1": ones,
              "rows_amplified": amplified, "numpy_rows_at_1": want_ones,
              "numpy_rows_amplified": want_amp,
              "first_sampled_tree_same": lv_err is not None,
              "leaf_value_max_abs_err": lv_err,
              "mask_ms": ms, "mask_device_ms": dms,
              "mask_kernels_per_call": st["kernels_per_call"]})
        check(g.grow_route == "mega", f"{name} took route {g.grow_route}")
        check(ones == want_ones and amplified == want_amp
              and in_bag == ones + amplified,
              f"{name} mask: {ones} rows at 1 and {amplified} amplified, "
              f"NumPy counts {want_ones} and {want_amp}")
        check(0 < in_bag < N_ROWS and int(trees[first].internal_count[0])
              == in_bag, f"{name}: the first sampled tree did not grow on "
                         f"the {in_bag} sampled rows")
        check(lv_err is not None and lv_err <= 1e-6,
              f"{name}: first sampled tree differs from the plain "
              f"versions' ({lv_err})")
        check(len(trees) == rounds and aucs[-1] > 0.85,
              f"{name}: train AUC {aucs[-1]} <= 0.85")
        out[name] = launches
        del bst, g, trees
    return out


# ---------------------------------------------------------------------------
# objectives, multiclass, ranking, per-node sampling
# ---------------------------------------------------------------------------
def _first_iteration_err(torch, gbdt, n, trees):
    """The largest leaf-value difference of the first iteration's trees
    against the plain versions' (None when a structure differs)."""
    errs = [_same_host_tree(a, b) for a, b in
            zip(_plain_trees(torch, gbdt, n), trees)]
    return None if any(e is None for e in errs) else max(errs)


def multiclass_phase(lt, hc, torch, dev, X, w, smi):
    """bench's 28 columns at 2^20 rows with labels in 5 classes from a
    seeded projection (the reference's examples/multiclass_classification:
    objective=multiclass, num_class=5, metric=multi_logloss), at bench's
    255 leaves and max_bin=63: 4 rounds of softmax on the megakernel
    route, 2 under histogram_impl=fused (#9), 2 of multiclassova. Checks:
    the first iteration's 5 trees equal the plain versions'; multi_logloss
    falls every round; probabilities sum to 1 within 1e-6; the device
    predictor is within 1e-5 of the host walk on [N, 5]; pred_leaf is
    [n, 20] and equals the device walk's leaves; a model-text round trip
    predicts bitwise; a serving session's [5, n] margins equal
    Booster.predict(raw_score=True) (bitwise on the host engine, within
    1e-5 on the binned one); #2 on a row view of the [5, N] scores equals
    its plain version."""
    K = 5
    rng = np.random.RandomState(51)
    proj = X @ np.stack([w] + [rng.normal(size=N_FEAT)
                               for _ in range(K - 1)], axis=1)
    y = np.argmax(proj + rng.normal(scale=0.5, size=proj.shape),
                  axis=1).astype(np.float32)
    params = dict(objective="multiclass", num_class=K, num_leaves=N_LEAVES,
                  max_bin=63, learning_rate=0.1, min_data_in_leaf=20,
                  verbose=-1, binning_impl="auto", device_type="cuda",
                  metric="multi_logloss",
                  batched_train=False)
    ds = lt.Dataset(X, label=y, params=params).construct()
    names = ("build_histogram_slots", "take_leaf_values", "wave_pass",
             "wave_relabel", "wave_pass_fused")
    out = {}
    for case, over, rounds, route in (
            ("softmax", {}, 4, "mega"),
            ("softmax fused", {"histogram_impl": "fused"}, 2, "fused"),
            ("multiclassova", {"objective": "multiclassova"}, 2, "mega")):
        bst, launches, iter_ms, loss = _train_timed(
            lt, hc, torch, {**params, **over}, ds, rounds)
        g = bst._gbdt
        trees = g.models
        lv_err = _first_iteration_err(torch, g, N_ROWS, trees[:K])
        rec = {"phase": "multiclass", "case": case, "rows": N_ROWS,
               "classes": K, "card": smi, "grow_route": g.grow_route,
               "rounds": rounds, "iter_ms": iter_ms,
               "steady_ms_per_iter": float(np.mean(iter_ms[1:])),
               "launches": launches,
               "launches_per_round": {k: launches[k] / rounds
                                      for k in names},
               "multi_logloss_per_round": loss,
               "leaves": [t.num_leaves for t in trees],
               "first_iteration_same": lv_err is not None,
               "leaf_value_max_abs_err": lv_err}
        check(g.grow_route == route, f"multiclass {case} took route "
                                     f"{g.grow_route}")
        check(len(trees) == rounds * K and g.scores.shape == (K, N_ROWS),
              f"multiclass {case}: {len(trees)} trees, scores "
              f"{tuple(g.scores.shape)}")
        kern = "wave_pass_fused" if route == "fused" else "wave_pass"
        check(launches["take_leaf_values"] == rounds * K
              and launches[kern] > 0 and launches["build_histogram_slots"]
              >= rounds * K, f"multiclass {case}: launches {launches}")
        check(all(b < a for a, b in zip(loss, loss[1:])),
              f"multiclass {case}: multi_logloss did not fall every round "
              f"{loss}")
        check(lv_err is not None and lv_err <= 1e-6,
              f"multiclass {case}: the first iteration's trees differ from "
              f"the plain versions' ({lv_err})")
        if case == "softmax":
            rec.update(_multiclass_outputs(lt, hc, torch, dev, bst, X, K))
        emit(rec)
        out[case] = launches
        del bst, g, trees
    return out


def _multiclass_outputs(lt, hc, torch, dev, bst, X, K):
    """The softmax model's outputs on the card: probabilities, the device
    predictor, pred_leaf, a model-text trip, serving, and #2 on a row view
    of [K, N] scores."""
    from lightgbm_tpu_torch.ops.histogram import add_leaf_values_
    from lightgbm_tpu_torch.ops.predict import predict_leaves_packed
    g = bst._gbdt
    prob = bst.predict(X)                            # device route, f32
    check(getattr(g, "_device_tables_cache", None) is not None,
          "multiclass predict of 2^20 f32 rows did not take the device "
          "route")
    host = bst.predict(X.astype(np.float64))
    dev_err = float(np.max(np.abs(prob - host)))
    sum_err = float(np.max(np.abs(prob.sum(axis=1) - 1.0)))
    check(prob.shape == (N_ROWS, K) and dev_err <= 1e-5,
          f"multiclass device predictor vs host walk: {prob.shape}, "
          f"{dev_err}")
    check(sum_err <= 1e-6, f"multiclass probabilities sum to 1 +- {sum_err}")
    q = X[:4096]
    leaves = bst.predict(q, pred_leaf=True)
    pa = g._packed_model(0, g.iter).device_arrays(dev)
    walk = (predict_leaves_packed(pa, torch.from_numpy(q).to(dev))
            - pa.leaf_start[None, :]).cpu().numpy()
    check(leaves.shape == (4096, 4 * K) and np.array_equal(leaves, walk),
          "pred_leaf differs from the device walk's leaves")
    text = bst.model_to_string()
    back = lt.Booster(model_str=text)
    check(np.array_equal(back.predict(q), bst.predict(q)),
          "multiclass predictions changed over a model text round trip")
    raw = bst.predict(q, raw_score=True)
    host_m = bst.serve(engine="host").score_margin(q)
    sess = bst.serve(engine="binned", max_batch=256)
    bin_m = sess.score_margin(q)
    serve_err = float(np.max(np.abs(bin_m - raw.T)))
    check(host_m.shape == (K, 4096) and np.array_equal(host_m, raw.T),
          "the host serving engine's [K, n] margins differ from "
          "Booster.predict(raw_score=True)")
    check(serve_err <= 1e-5, f"binned serving margins vs Booster.predict: "
                             f"{serve_err}")
    # #2 on a row view of the [K, N] scores, against its plain version
    gen = torch.Generator(device=dev).manual_seed(12)
    vals = torch.randn(N_LEAVES, generator=gen, device=dev)
    lor = torch.randint(0, N_LEAVES, (N_ROWS,), generator=gen, device=dev,
                        dtype=torch.int32)
    a, b = g.scores.clone(), g.scores.clone()
    hc.reset_launch_counts()
    add_leaf_values_(a[2], vals, lor)
    check(hc.LAUNCHES["take_leaf_values"] == 1, "#2 did not launch")
    add_leaf_values_(b[2], vals, lor, plain=True)
    check(torch.equal(a, b), "#2 on a row view of [K, N] differs from its "
                             "plain version")
    return {"predict_device_max_abs_err": dev_err,
            "prob_sum_max_abs_err": sum_err, "pred_leaf_shape":
            list(leaves.shape), "pred_leaf_equals_walk": True,
            "roundtrip_bitwise": True, "serve_host_bitwise": True,
            "serve_binned_max_abs_err": serve_err,
            "row_view_update_bitwise": True}


def _mslr_like(rng, n):
    """MSLR-WEB30K's schema: 136 numeric features, relevance 0-4 (most
    documents 0), queries of 64-256 documents; synthetic from `rng`."""
    sizes = rng.randint(64, 257, size=n // 64 + 1)
    sizes = sizes[:np.searchsorted(np.cumsum(sizes), n)]
    sizes = np.append(sizes, n - sizes.sum())
    if sizes[-1] < 64:
        sizes[-2] += sizes[-1]
        sizes = sizes[:-1]
    X = rng.normal(size=(n, 136)).astype(np.float32)
    qid = np.repeat(np.arange(len(sizes)), sizes)
    q_eff = rng.normal(size=len(sizes))[qid]
    s = X[:, :20] @ rng.normal(size=20) / 4.0 + q_eff \
        + rng.normal(scale=0.7, size=n)
    y = np.digitize(s, np.quantile(s, [0.55, 0.8, 0.93, 0.98]))
    return X, y.astype(np.float32), sizes


def rank_phase(lt, hc, torch, dev, smi):
    """MSLR-WEB30K's schema (136 numeric features, relevance 0-4, queries
    of 64-256 documents), synthetic from a seed, 2^20 documents,
    max_bin=255, 255 leaves: the apply route (#4). 2 rounds of lambdarank
    (ndcg@1,3,5,10), then 2 of rank_xendcg (host gradients). Checks: the
    first tree equals the plain versions'; the card's lambdarank
    gradients at iterations 0 and 1 are within rtol 1e-5 (atol 1e-6 of
    the largest, the cancellation of f32 pair sums in another order) of
    the same function on a CPU copy; ndcg@10 after 2 rounds is above the
    initial scores'. Records the gradient's device ms a round."""
    from lightgbm_tpu_torch.config import resolve_params
    from lightgbm_tpu_torch.metrics import create_metric
    rng = np.random.RandomState(61)
    X, y, sizes = _mslr_like(rng, N_ROWS)
    params = dict(objective="lambdarank", num_leaves=N_LEAVES, max_bin=255,
                  learning_rate=0.1, min_data_in_leaf=20, verbose=-1,
                  binning_impl="auto", device_type="cuda", metric="ndcg",
                  eval_at=[1, 3, 5, 10],
                  batched_train=False)
    t0 = time.perf_counter()
    ds = lt.Dataset(X, label=y, group=sizes, params=params).construct()
    ingest_s = time.perf_counter() - t0
    md = ds._handle.metadata
    m0 = create_metric("ndcg", resolve_params(params))
    m0.init(md, N_ROWS)
    ndcg0 = {k: float(v) for k, v, _ in m0.eval(np.zeros(N_ROWS), None)}
    snaps = []

    def keep(env):
        snaps.append(env.model._gbdt.scores.clone())
    keep.before_iteration = True
    out = {}
    for obj in ("lambdarank", "rank_xendcg"):
        snaps.clear()
        evals = []
        bst, launches, iter_ms, _ = _train_timed(
            lt, hc, torch, {**params, "objective": obj}, ds, 2, [keep],
            evals)
        g = bst._gbdt
        trees = g.models
        rec = {"phase": "rank", "objective": obj, "rows": N_ROWS,
               "queries": len(sizes), "features": 136, "card": smi,
               "ingest_s": ingest_s, "grow_route": g.grow_route,
               "hist_route": g.hist_route, "iter_ms": iter_ms,
               "launches": launches, "ndcg_initial": ndcg0,
               "ndcg_per_round": evals,
               "leaves": [t.num_leaves for t in trees]}
        check(g.grow_route == "apply" and launches["wave_apply"] > 0,
              f"rank {obj}: route {g.grow_route}, launches {launches}")
        check(evals[-1]["ndcg@10"] > ndcg0["ndcg@10"],
              f"rank {obj}: ndcg@10 {evals[-1]['ndcg@10']} after 2 rounds "
              f"<= {ndcg0['ndcg@10']} of the initial scores")
        if obj == "lambdarank":
            lv_err = _first_iteration_err(torch, g, N_ROWS, trees[:1])
            check(lv_err is not None and lv_err <= 1e-6,
                  f"rank: first tree differs from the plain versions' "
                  f"({lv_err})")
            errs = []
            for sc in snaps[:2]:
                gd, hd = g.objective.get_gradients(sc[0], g.label_dev, None)
                gc, hcpu = g.objective.get_gradients(
                    sc[0].cpu(), g.label_dev.cpu(), None)
                for a, b in ((gd.cpu(), gc), (hd.cpu(), hcpu)):
                    tol = 1e-5 * b.abs() + 1e-6 * float(b.abs().max())
                    errs.append(float(((a - b).abs() / tol).max()))
            check(max(errs) <= 1.0, f"rank: the card's lambdarank gradients "
                                    f"differ from the CPU's ({errs})")
            st = {}
            ms, dms = timings(lambda: g.objective.get_gradients(
                snaps[1][0], g.label_dev, None), 10, stats=st)
            rec.update(first_tree_same=True, leaf_value_max_abs_err=lv_err,
                       gradient_err_over_tol=errs, gradient_ms=ms,
                       gradient_device_ms=dms,
                       gradient_kernels_per_call=st["kernels_per_call"])
        emit(rec)
        out[obj] = launches
        del bst, g, trees
    return out


def objectives_phase(lt, hc, torch, X, w, ds, smi):
    """The bench table at 2^20 rows, 2 rounds of each regression,
    cross-entropy objective: l1, huber, fair, quantile, mape (labels
    shifted away from 0), poisson, gamma and tweedie (a positive label
    made from the bench margin), xentropy and xentlambda (its sigmoid).
    Checks: each run's own metric falls (for poisson, gamma and tweedie
    on the exp of the scores: the JAX package, and so the port, leaves
    their outputs and metrics on the raw scores, need_convert_output
    unset); the first trees of l1 (renewed) and poisson equal the plain
    versions'. Records the renewal's host ms a tree."""
    from lightgbm_tpu_torch.ops.grow_wave import grow_tree_wave
    rng = np.random.RandomState(71)
    m = (X @ w).astype(np.float64)
    m = m / m.std()
    noisy = m + rng.normal(scale=0.3, size=len(m))
    labels = {"real": noisy.astype(np.float32),
              "shifted": (noisy - noisy.min() + 1.0).astype(np.float32),
              "positive": np.exp(0.5 * noisy).astype(np.float32),
              "unit": (1.0 / (1.0 + np.exp(-noisy))).astype(np.float32)}
    cases = (("regression_l1", "real"), ("huber", "real"),
             ("fair", "real"), ("quantile", "real"), ("mape", "shifted"),
             ("poisson", "positive"), ("gamma", "positive"),
             ("tweedie", "positive"), ("xentropy", "unit"),
             ("xentlambda", "unit"))
    params = dict(num_leaves=N_LEAVES, max_bin=63, learning_rate=0.1,
                  min_data_in_leaf=20, verbose=-1, device_type="cuda")
    out = {}
    for obj, kind in cases:
        d = lt.Dataset(X, label=labels[kind], reference=ds,
                       params=params).construct()
        snaps = []

        def keep(env, _snaps=snaps):
            _snaps.append(env.model._gbdt.scores[0].cpu().numpy().copy())
        keep.before_iteration = True
        bst, launches, iter_ms, _ = _train_timed(
            lt, hc, torch, {**params, "objective": obj}, d, 2, [keep])
        g = bst._gbdt
        # from the boost-from-average start, then after each round
        snaps[0] = np.full(N_ROWS, np.float32(
            g.objective.boost_from_score(0)), np.float32)
        snaps.append(g.scores[0].cpu().numpy().copy())
        start, *metric = [_own_metric(g, sc) for sc in snaps]
        rec = {"phase": "objectives", "objective": obj, "rows": N_ROWS,
               "card": smi, "grow_route": g.grow_route,
               "metric": g.training_metrics[0].name, "metric_initial": start,
               "metric_per_round": metric, "iter_ms": iter_ms,
               "launches": launches,
               "leaves": [t.num_leaves for t in g.models]}
        check(metric[0] < start and metric[1] < metric[0],
              f"objective {obj}: its metric did not fall {start} -> "
              f"{metric}")
        if obj in ("regression_l1", "poisson"):
            lv_err = _first_iteration_err(torch, g, N_ROWS, g.models[:1])
            check(lv_err is not None and lv_err <= 1e-6,
                  f"objective {obj}: first tree differs from the plain "
                  f"versions' ({lv_err})")
            rec.update(first_tree_same=True, leaf_value_max_abs_err=lv_err)
        if obj == "regression_l1":
            gg, hh = g._gradients()
            tp, lor = grow_tree_wave(g.X_t, gg[0], hh[0], g._in_bag, g.meta,
                                     g.grow_cfg, None,
                                     hist_plan=g.hist_plan, rng_seed=1)
            t0 = time.perf_counter()
            for _ in range(3):
                g._renew_tree_output(0, tp, lor)
            rec["renewal_host_ms_per_tree"] = \
                (time.perf_counter() - t0) * 1e3 / 3
        emit(rec)
        out[obj] = launches
        del bst, g, d
    return out


def _own_metric(g, score):
    """The training metric of [N] scores through the objective's output
    transform, which the JAX package applies only where
    need_convert_output is set."""
    obj = g.objective
    if not obj.need_convert_output:
        score, obj = obj.convert_output(score.astype(np.float64)), None
    return g.training_metrics[0].eval(score, obj)[0][1]


def bynode_xt_phase(lt, hc, torch, dev, params, ds, smi):
    """The bench model, 4 rounds with feature_fraction_bynode=0.5, then 4
    with extra_trees=true, on the megakernel route. Checks: the masks and
    thresholds drawn on the card equal the CPU's bitwise; the first tree
    equals the plain versions'; train AUC after 4 rounds > 0.85; under
    histogram_impl=fused the route is "mega" and the veto reasons name the
    parameter."""
    from lightgbm_tpu_torch.ops.grow_wave import node_masks, xt_bins
    from lightgbm_tpu_torch.utils.random import PRNGKey, fold_in
    out = {}
    for name, over in (("feature_fraction_bynode",
                        {"feature_fraction_bynode": 0.5}),
                       ("extra_trees", {"extra_trees": True})):
        bst, launches, iter_ms, aucs = _train_timed(
            lt, hc, torch, {**params, **over}, ds, 4)
        g = bst._gbdt
        trees = g.models
        lv_err = _first_iteration_err(torch, g, N_ROWS, trees[:1])
        fused = lt.Booster({**params, **over, "histogram_impl": "fused"},
                           ds)._gbdt
        key = fold_in(PRNGKey(g.tree_seed(0) + 0x5EED), 3)
        same_draws = (
            torch.equal(node_masks(key, 256, N_FEAT, 0.5, dev).cpu(),
                        node_masks(key, 256, N_FEAT, 0.5, "cpu"))
            and torch.equal(xt_bins(key, 256, g.meta.num_bins).cpu(),
                            xt_bins(key, 256, g.meta.num_bins.cpu())))
        emit({"phase": "bynode_xt", "case": name, "rows": N_ROWS,
              "card": smi, "grow_route": g.grow_route, "iter_ms": iter_ms,
              "steady_ms_per_iter": float(np.mean(iter_ms[1:])),
              "launches": launches, "train_auc_per_round": aucs,
              "leaves": [t.num_leaves for t in trees],
              "first_tree_same": lv_err is not None,
              "leaf_value_max_abs_err": lv_err,
              "draws_bitwise_cpu": same_draws,
              "fused_route": fused.grow_route,
              "fused_veto_reasons": fused.fused_veto_reasons})
        check(g.grow_route == "mega", f"{name} took route {g.grow_route}")
        check(same_draws, f"{name}: the card's draws differ from the CPU's")
        check(lv_err is not None and lv_err <= 1e-6,
              f"{name}: first tree differs from the plain versions' "
              f"({lv_err})")
        check(len(trees) == 4 and aucs[-1] > 0.85,
              f"{name}: train AUC {aucs[-1]} <= 0.85 after 4 rounds")
        check(fused.grow_route == "mega"
              and fused.fused_veto_reasons == [name],
              f"{name} under histogram_impl=fused: route "
              f"{fused.grow_route}, vetoes {fused.fused_veto_reasons}")
        out[name] = launches
        del bst, g, trees, fused
    return out


# ---------------------------------------------------------------------------
# the rest of the constraints: monotone `intermediate`, forced splits, CEGB
# ---------------------------------------------------------------------------
def _criteo_count_weights():
    """The label weights of criteo_like's 13 count columns (its seed 7,
    drawn after their means, spreads and NaN rates)."""
    from lightgbm_tpu_torch.utils.synthetic import CRITEO_NUM_COUNTS as k
    rng = np.random.RandomState(7)
    for lo, hi in ((0.0, 4.0), (0.5, 1.5), (0.0, 0.4)):
        rng.uniform(lo, hi, k)
    return rng.normal(0.0, 0.3, k)


def _waves(trees):
    return [int(getattr(t, "num_waves", -1)) for t in trees]


def _logloss(evals):
    return [e["binary_logloss"] for e in evals]


def intermediate_phase(lt, hc, torch, smi, params, ds, w, params_c, ds_c):
    """monotone_constraints_method=intermediate: bench.py's model with
    features 0-3 constrained in their weights' directions, 2 rounds on
    "mega" (#1 the root, #3 the waves, #5 the last relabel, #2 the score
    update), beside the same 2 rounds of `basic`; then the Criteo table
    with its two heaviest count columns constrained, 2 rounds on "apply"
    (#4, #1). Each: first tree equal to the plain versions', raw scores
    never against a constraint along a 32-point sweep, histogram_impl=
    fused vetoed naming monotone_intermediate; waves per tree, ms per
    round, train logloss beside basic's."""
    from lightgbm_tpu_torch.utils.synthetic import criteo_like
    mono_b = [int(np.sign(x)) for x in w[:4]] + [0] * (N_FEAT - 4)
    wc = _criteo_count_weights()
    cols = [int(j) for j in np.argsort(-np.abs(wc))[:2]]
    mono_c = [0] * 39
    for j in cols:
        mono_c[j] = int(np.sign(wc[j]))
    Xc_rows = criteo_like(4096, seed=8)[0]
    cases = (
        ("bench", params, ds, mono_b, "mega",
         np.random.RandomState(45).normal(size=(4096, N_FEAT))
         .astype(np.float32), {},
         ("build_histogram_slots", "wave_pass", "wave_relabel",
          "take_leaf_values")),
        ("criteo", params_c, ds_c, mono_c, "apply", Xc_rows,
         {j: np.floor(np.expm1(np.linspace(
             0.0, np.log1p(np.nanmax(Xc_rows[:, j])), 32)))
          .astype(np.float32) for j in cols},
         ("wave_apply", "build_histogram_slots", "take_leaf_values")))
    out = {}
    for model, base, dset, mono, route, rows, grids, kernels in cases:
        runs = {}
        for method in ("basic", "intermediate"):
            evals = []
            p = {**base, "metric": ["binary_logloss", "auc"],
                 "monotone_constraints": mono,
                 "monotone_constraints_method": method}
            runs[method] = (_train_timed(lt, hc, torch, p, dset, 2,
                                         evals=evals), evals, p)
        (bst, launches, iter_ms, _), evals, p = runs["intermediate"]
        (bb, _, basic_ms, _), basic_evals, _ = runs["basic"]
        g = bst._gbdt
        trees = g.models
        lv_err = _same_host_tree(_plain_trees(torch, g, N_ROWS)[0],
                                 trees[0])
        g._device_tables_cache = None
        feats = [(j, m) for j, m in enumerate(mono) if m]
        sweep = _sweep_monotone(bst, rows, feats, grids)
        veto = lt.Booster({**p, "histogram_impl": "fused"}, dset)._gbdt
        emit({"phase": "intermediate", "model": model, "rows": N_ROWS,
              "nvidia_smi": smi, "monotone_constraints":
                  {str(j): m for j, m in feats},
              "grow_route": g.grow_route,
              "waves_per_tree": _waves(trees),
              "basic_waves_per_tree": _waves(bb._gbdt.models),
              "iter_ms": iter_ms, "ms_per_round": float(np.mean(iter_ms)),
              "basic_iter_ms": basic_ms,
              "train_logloss_per_round": _logloss(evals),
              "basic_train_logloss_per_round": _logloss(basic_evals),
              "launches": launches,
              "leaves": [t.num_leaves for t in trees],
              "first_tree_same": lv_err is not None,
              "leaf_value_max_abs_err": lv_err,
              "sweep_worst_step": sweep,
              "sweep_device_route": g._device_tables_cache is not None,
              "fused_route": veto.grow_route,
              "fused_veto_reasons": veto.fused_veto_reasons})
        check(g.grow_route == route, f"intermediate {model} took route "
                                     f"{g.grow_route}")
        for name in kernels:
            check(launches[name] > 0,
                  f"{name} never launched on the intermediate {model} run")
        check(lv_err is not None and lv_err <= 1e-6,
              f"intermediate {model}: first tree differs from the plain "
              f"versions' ({lv_err})")
        check(all(s >= 0.0 for s, _ in sweep.values()),
              f"intermediate {model}: a score moved against its "
              f"constraint {sweep}")
        check(sum(m for _, m in sweep.values()) > 0,
              f"intermediate {model}: no constrained feature moved the "
              f"score {sweep}")
        check(veto.grow_route == route
              and veto.fused_veto_reasons == ["monotone_intermediate"],
              f"intermediate {model} under fused: {veto.grow_route} "
              f"{veto.fused_veto_reasons}")
        ll = _logloss(evals)
        check(len(trees) == 2 and all(np.isfinite(ll)) and ll[1] < ll[0],
              f"intermediate {model}: train logloss {ll}")
        out[model] = launches
        del veto, bst, bb, runs
    return out


def forced_cegb_phase(lt, hc, torch, smi, params, ds, X, params_c, ds_c):
    """Forced splits: bench.py's model with a forced root and both its
    children (numeric features 0, 1, 2 at data quantiles), 2 rounds on
    "mega": trees 0 and 1 carry the forced nodes with the forced bin
    thresholds in BFS order, the first tree equals the plain versions'.
    CEGB: the Criteo table with cegb_penalty_split and a coupled penalty on
    all 39 columns, 4 rounds on "apply", beside the same run without
    penalties: the first tree equals the plain versions', the second tree
    the plain versions' grown with the features of the first marked paid
    (so each coupled feature is charged in at most one tree), and the
    penalized run uses no more distinct features. histogram_impl=fused is
    vetoed naming forced_splits, and cegb."""
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    spec = {"feature": 0, "threshold": float(np.quantile(X[:, 0], 0.5)),
            "left": {"feature": 1,
                     "threshold": float(np.quantile(X[:, 1], 0.3))},
            "right": {"feature": 2,
                      "threshold": float(np.quantile(X[:, 2], 0.7))}}
    with tempfile.TemporaryDirectory(dir=here) as tmp:
        path = os.path.join(tmp, "forced.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        p = {**params, "forcedsplits_filename": path}
        bst, launches, iter_ms, aucs = _train_timed(lt, hc, torch, p, ds, 2)
        veto = lt.Booster({**p, "histogram_impl": "fused"}, ds)._gbdt
    g = bst._gbdt
    trees = g.models
    table = g.meta.forced.cpu().numpy()
    bfs = [bool(np.array_equal(t.split_feature_inner[:3], table[0])
                and np.array_equal(t.threshold_in_bin[:3], table[1])
                and t.left_child[0] == 1 and t.right_child[0] == 2)
           for t in trees]
    lv_err = _same_host_tree(_plain_trees(torch, g, N_ROWS)[0], trees[0])
    emit({"phase": "forced_cegb", "model": "bench", "rows": N_ROWS,
          "nvidia_smi": smi, "forced": spec,
          "forced_table": table.tolist(), "grow_route": g.grow_route,
          "iter_ms": iter_ms, "launches": launches,
          "train_auc_per_round": aucs,
          "leaves": [t.num_leaves for t in trees],
          "forced_nodes_in_bfs_order": bfs,
          "first_tree_same": lv_err is not None,
          "leaf_value_max_abs_err": lv_err,
          "fused_route": veto.grow_route,
          "fused_veto_reasons": veto.fused_veto_reasons})
    check(g.grow_route == "mega" and table.shape == (4, 3),
          f"forced bench: route {g.grow_route}, table {table.shape}")
    for name in ("build_histogram_slots", "wave_pass", "wave_relabel",
                 "take_leaf_values"):
        check(launches[name] > 0, f"{name} never launched on the forced "
                                  "run")
    check(len(trees) == 2 and all(bfs),
          f"forced bench: the trees do not carry the forced nodes {bfs}")
    check(lv_err is not None and lv_err <= 1e-6,
          f"forced bench: first tree differs from the plain versions' "
          f"({lv_err})")
    check(veto.grow_route == "mega"
          and veto.fused_veto_reasons == ["forced_splits"],
          f"forced under fused: {veto.grow_route} {veto.fused_veto_reasons}")
    del bst, veto

    pen = {"cegb_penalty_split": 1e-5,
           "cegb_penalty_feature_coupled": [20.0] * 39}
    res = {}
    for name, over in (("free", {}), ("cegb", pen)):
        after = []

        def keep(env):
            after.append(env.model._gbdt.scores.clone())
        keep.order = 6
        res[name] = _train_timed(lt, hc, torch, {**params_c, **over}, ds_c,
                                 4, callbacks=[keep]) + (after,)
    bst, launches, iter_ms, aucs, after = res["cegb"]
    g = bst._gbdt
    trees = g.models

    def feats(ts):
        return sorted({int(f) for t in ts
                       for f in t.split_feature_inner[:t.num_leaves - 1]})
    used0 = torch.zeros(len(g.mappers), dtype=torch.bool, device=g.X_t.device)
    used0[feats(trees[:1])] = True
    err0 = _same_host_tree(_plain_trees(torch, g, N_ROWS)[0], trees[0])
    err1 = _same_host_tree(_plain_trees(torch, g, N_ROWS, scores=after[0],
                                        it=1, cegb_used=used0)[0], trees[1])
    new_feats = []
    seen = set()
    for t in trees:
        f = set(feats([t]))
        new_feats.append(sorted(f - seen))
        seen |= f
    free_feats = feats(res["free"][0]._gbdt.models)
    veto = lt.Booster({**params_c, **pen, "histogram_impl": "fused"},
                      ds_c)._gbdt
    emit({"phase": "forced_cegb", "model": "criteo", "rows": N_ROWS,
          "nvidia_smi": smi, "penalties": {
              "cegb_penalty_split": pen["cegb_penalty_split"],
              "cegb_penalty_feature_coupled": 20.0},
          "grow_route": g.grow_route, "iter_ms": iter_ms,
          "free_iter_ms": res["free"][2], "launches": launches,
          "train_auc_per_round": aucs,
          "free_train_auc_per_round": res["free"][3],
          "leaves": [t.num_leaves for t in trees],
          "free_leaves": [t.num_leaves
                          for t in res["free"][0]._gbdt.models],
          "features_first_used_per_tree": new_feats,
          "distinct_features": len(seen),
          "free_distinct_features": len(free_feats),
          "used_state": int(g._cegb_used.sum()),
          "first_tree_same": err0 is not None,
          "first_tree_leaf_value_max_abs_err": err0,
          "second_tree_same_with_paid_state": err1 is not None,
          "second_tree_leaf_value_max_abs_err": err1,
          "fused_route": veto.grow_route,
          "fused_veto_reasons": veto.fused_veto_reasons})
    check(g.grow_route == "apply" and launches["wave_apply"] > 0
          and launches["build_histogram_slots"] > 0,
          f"CEGB Criteo: route {g.grow_route}, launches {launches}")
    check(err0 is not None and err0 <= 1e-6,
          f"CEGB Criteo: first tree differs from the plain versions' "
          f"({err0})")
    check(err1 is not None and err1 <= 1e-6,
          f"CEGB Criteo: second tree differs from the plain versions' "
          f"with the first tree's features paid ({err1})")
    check(sorted(seen) == sorted(np.flatnonzero(
        g._cegb_used.cpu().numpy()).tolist()),
          "CEGB Criteo: the used-feature state is not the model's features")
    check(len(seen) <= len(free_feats),
          f"CEGB Criteo: {len(seen)} distinct features against "
          f"{len(free_feats)} without penalties")
    check(veto.grow_route == "apply" and veto.fused_veto_reasons == ["cegb"],
          f"CEGB under fused: {veto.grow_route} {veto.fused_veto_reasons}")
    return launches


# ---------------------------------------------------------------------------
# the training loop: continued training, late valid sets, fobj / feval,
# reset_parameter, refit
# ---------------------------------------------------------------------------
def continued_phase(lt, hc, torch, dev, smi, params, ds, X, y, w):
    """bench.py's model: 4 rounds saved as model text, then lt.train(
    init_model=text) for 4 more (the replay on the card: the device binned
    walk and #2 a tree), the replayed scores against predict(raw_score)
    within 1e-6 and bitwise the CPU replay of the same text; a valid set
    added after training against predict within 1e-5; an fobj of binary
    logloss in torch on the card growing the built-in objective's first
    tree, feval reported each round; the reset_parameter callback's rates
    as each tree's shrinkage; refit of 2^18 held-out rows at decay 0.9
    against the CPU refit within 1e-6, and at 1.0 an unchanged model."""
    p = {**params, "metric": "binary_logloss"}
    b4 = lt.train(p, ds, 4)
    text = b4.model_to_string()
    grab = {}

    def at_start(env):
        if env.iteration == 0:
            torch.cuda.synchronize()
            grab["scores"] = env.model._gbdt.scores.clone()
            grab["launches"] = dict(hc.LAUNCHES)
    at_start.before_iteration = True
    hc.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b8 = lt.train(p, ds, 4, init_model=text, callbacks=[at_start])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(hc.LAUNCHES)
    replayed = grab["scores"]
    pred = b4.predict(X, raw_score=True)
    replay_err = float(np.max(np.abs(replayed[0].cpu().numpy() - pred)))
    gc = lt.Booster({**p, "device_type": "cpu"}, ds)._gbdt
    t1 = time.perf_counter()
    gc.load_init_model(text)
    cpu_replay_s = time.perf_counter() - t1
    replay_bitwise = torch.equal(gc.scores, replayed.cpu())
    del gc
    # the card's replay alone (the text parsed, 4 trees walked and added)
    gd = lt.Booster(p, ds)._gbdt
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    gd.load_init_model(text)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t1
    del gd
    rng = np.random.RandomState(46)
    Xh = rng.normal(size=(1 << 18, N_FEAT)).astype(np.float32)
    yh = (Xh @ w + rng.normal(scale=0.5, size=1 << 18) > 0) \
        .astype(np.float32)
    hc.reset_launch_counts()
    b8.add_valid(lt.Dataset(Xh, label=yh), "late")
    late_launches = dict(hc.LAUNCHES)
    late = b8._gbdt._valid_scores[0][0].cpu().numpy()
    late_err = float(np.max(np.abs(
        late - b8.predict(Xh, raw_score=True, num_iteration=8))))

    # fobj in torch on the card, against the built-in objective
    lab = torch.from_numpy(y).to(dev)

    def fobj(score, dset):
        pr = torch.sigmoid(torch.from_numpy(score).to(dev))
        return pr - lab, pr * (1.0 - pr)

    def feval(score, dset):
        pr = 1.0 / (1.0 + np.exp(-score.astype(np.float64)))
        return ("logloss_np", float(-np.mean(
            y * np.log(pr) + (1 - y) * np.log(1 - pr))), False)
    rec = {}
    pf = {**p, "boost_from_average": False}
    bf = lt.train({**pf, "objective": "none", "metric": "none"}, ds, 2,
                  valid_sets=[ds], fobj=fobj, feval=feval,
                  callbacks=[lt.record_evaluation(rec)])
    bb = lt.train(pf, ds, 1)
    fobj_err = _same_host_tree(bf._gbdt.models[0], bb._gbdt.models[0])
    feval_rounds = rec.get("valid_0", {}).get("logloss_np", [])

    # learning-rate schedule
    lrs = [0.3, 0.2, 0.1]
    br = lt.train(pf, ds, 3, callbacks=[lt.reset_parameter(
        learning_rate=lrs)])
    shrink = [float(blk.split("shrinkage=")[1].split("\n")[0])
              for blk in br.model_to_string().split("Tree=")[1:]]
    sched_err = float(np.max(np.abs(
        br.predict(X[:4096], raw_score=True)
        - br._gbdt.scores[0, :4096].cpu().numpy())))

    # refit on held-out rows, on the card and on the CPU
    t2 = time.perf_counter()
    rc = b4.refit(Xh, yh, decay_rate=0.9)
    refit_s = time.perf_counter() - t2
    rcpu = lt.Booster(model_str=text, params={**p, "device_type": "cpu"}) \
        .refit(Xh, yh, decay_rate=0.9)
    refit_err = max(float(np.max(np.abs(a.leaf_value - b.leaf_value)))
                    for a, b in zip(rc._gbdt.models, rcpu._gbdt.models))
    refit_moved = max(float(np.max(np.abs(a.leaf_value - b.leaf_value)))
                      for a, b in zip(rc._gbdt.models, b4._gbdt.models))
    same_at_1 = b4.refit(Xh, yh, decay_rate=1.0).model_to_string() == text
    emit({"phase": "continued", "model": "bench", "rows": N_ROWS,
          "nvidia_smi": smi, "trees": b8.num_trees(),
          "iterations": b8.current_iteration, "train_s": train_s,
          "replay_launches": grab["launches"], "launches": launches,
          "replay_vs_predict_max_abs_err": replay_err,
          "replay_bitwise_cpu": replay_bitwise,
          "replay_s": replay_s, "cpu_replay_s": cpu_replay_s,
          "late_valid_rows": len(yh), "late_valid_launches": late_launches,
          "late_valid_vs_predict_max_abs_err": late_err,
          "fobj_first_tree_same": fobj_err is not None,
          "fobj_leaf_value_max_abs_err": fobj_err,
          "feval_per_round": feval_rounds,
          "reset_parameter_rates": lrs, "tree_shrinkage": shrink,
          "schedule_predict_vs_scores_max_abs_err": sched_err,
          "refit_rows": len(yh), "refit_s": refit_s,
          "refit_vs_cpu_max_abs_err": refit_err,
          "refit_leaf_value_max_abs_change": refit_moved,
          "refit_decay_1_text_unchanged": same_at_1})
    check(b8.num_trees() == 8 and b8.current_iteration == 8,
          f"continued training holds {b8.num_trees()} trees")
    check(grab["launches"]["take_leaf_values"] == 4
          and launches["take_leaf_values"] == 8,
          f"the replay did not launch #2 once a tree: {grab['launches']}, "
          f"{launches}")
    check(replay_err <= 1e-6, f"replayed scores differ from predict by "
                              f"{replay_err}")
    check(replay_bitwise, "the card's replay differs from the CPU's")
    check(late_launches["take_leaf_values"] == 8,
          f"the late valid set's replay launched #2 "
          f"{late_launches['take_leaf_values']} times for 8 trees")
    check(late_err <= 1e-5, f"late valid scores differ from predict by "
                            f"{late_err}")
    check(fobj_err is not None and fobj_err <= 1e-6,
          f"fobj's first tree differs from the built-in objective's "
          f"({fobj_err})")
    check(len(feval_rounds) == 2 and feval_rounds[1] < feval_rounds[0],
          f"feval per round {feval_rounds}")
    check(shrink == lrs, f"tree shrinkage {shrink} against rates {lrs}")
    check(sched_err <= 1e-5, f"the scheduled model's predictions differ "
                             f"from its training scores by {sched_err}")
    check(refit_err <= 1e-6, f"the card's refit differs from the CPU's "
                             f"by {refit_err}")
    check(refit_moved > 0.0, "refit at decay 0.9 changed no leaf value")
    check(same_at_1, "refit at decay 1.0 changed the model text")
    return grab["launches"], late_launches


def _scores_err(bst, scores, X, avg=False):
    """Largest |kept score - predict(raw_score)| over the rows of X that
    the [n] `scores` keep (the first n); the scores divided by the
    iterations where the model averages (rf)."""
    s = scores.cpu().numpy().astype(np.float64)
    if avg:
        s /= bst._gbdt.iter
    return float(np.max(np.abs(
        bst.predict(X[:len(s)], raw_score=True) - s)))


def boosting_modes_phase(lt, hc, torch, smi, params, ds, X, y, w):
    """boosting=rf, boosting=dart and linear_tree on bench.py's model and
    the device-ingested table, then rollback_one_iter (phase 15)."""
    out = {"phase": "boosting_modes", "model": "bench", "rows": N_ROWS,
           "nvidia_smi": smi}
    checks = []         # run after the line is printed
    # -- random forest: gradients once, trees averaged
    p_rf = {**params, "boosting": "rf", "bagging_fraction": 0.8,
            "bagging_freq": 1}
    b_rf, l_rf, ms_rf, auc_rf = _train_timed(lt, hc, torch, p_rf, ds, 4)
    g = b_rf._gbdt
    first = _same_host_tree(_plain_trees(torch, g, N_ROWS)[0], g.models[0])
    rf_err = _scores_err(b_rf, g.scores[0], X, avg=True)
    rf_avg = "\naverage_output\n" in b_rf.model_to_string()
    out["rf"] = {"rounds": 4, "ms_per_round": ms_rf, "launches": l_rf,
                 "auc_per_round": auc_rf,
                 "first_tree_same": first is not None,
                 "first_tree_leaf_value_max_abs_err": first,
                 "average_output": rf_avg,
                 "predict_vs_scores_over_iterations_max_abs_err": rf_err}
    checks += [
        (first is not None and first <= 1e-6,
         f"rf's first tree differs from the plain versions' ({first})"),
        (rf_avg, "the rf model text has no average_output"),
        (rf_err <= 1e-5, f"rf predictions differ from its averaged scores "
                         f"by {rf_err}"),
        # every tree fits the same gradients, so averaging bags lifts the
        # AUC above the first tree's, not to a boosted model's
        (auc_rf[-1] > auc_rf[0] and auc_rf[-1] > 0.83,
         f"rf train AUC per round {auc_rf}")]
    del b_rf, g

    # -- DART with a valid set; its drop sets against a CPU run's
    rng = np.random.RandomState(47)
    Xv = rng.normal(size=(1 << 18, N_FEAT)).astype(np.float32)
    yv = (Xv @ w + rng.normal(scale=0.5, size=1 << 18) > 0) \
        .astype(np.float32)
    p_dart = {**params, "boosting": "dart", "drop_rate": 0.3,
              "skip_drop": 0.0}

    def drop_log(sink):
        def keep(env):
            sink.append(list(env.model._gbdt._drop_index))
        return keep
    drops, drops_cpu = [], []
    dv = lt.Dataset(Xv, label=yv, reference=ds)
    b_d, l_d, ms_d, auc_d = _train_timed(lt, hc, torch, p_dart, ds, 8,
                                         callbacks=[drop_log(drops)],
                                         valid_sets=[dv])
    # the drop sets depend on the RandomState and the drop sets before
    # them only: a small CPU run draws the same
    lt.train({**p_dart, "device_type": "cpu", "binning_impl": "host",
              "num_leaves": 15}, lt.Dataset(X[:20000], label=y[:20000]), 8,
             callbacks=[drop_log(drops_cpu)])
    n_drop = sum(len(d) for d in drops)
    want_2 = 8 + 3 * n_drop     # new trees; each drop out, back, valid
    d_err = _scores_err(b_d, b_d._gbdt.scores[0], X)
    dv_err = _scores_err(b_d, b_d._gbdt._valid_scores[0][0], Xv)
    out["dart"] = {"rounds": 8, "ms_per_round": ms_d, "launches": l_d,
                   "auc_per_round": auc_d, "drop_sets": drops,
                   "drop_sets_equal_cpu": drops == drops_cpu,
                   "take_leaf_values_expected": want_2,
                   "valid_rows": len(yv),
                   "predict_vs_scores_max_abs_err": d_err,
                   "valid_predict_vs_scores_max_abs_err": dv_err}
    checks += [
        (drops == drops_cpu, f"DART drop sets {drops} differ from the CPU "
                             f"run's {drops_cpu}"),
        (n_drop > 0, "DART dropped no tree in 8 rounds"),
        (l_d["take_leaf_values"] == want_2,
         f"DART launched #2 {l_d['take_leaf_values']} times, {want_2} "
         f"expected"),
        (d_err <= 1e-5 and dv_err <= 1e-5,
         f"DART scores differ from predict by {d_err} (train), {dv_err} "
         f"(valid)")]

    # -- linear trees beside constant leaves; a Dataset that keeps the raw
    # rows
    p_lin = {**params, "metric": ["binary_logloss", "auc"]}
    ds_lin = lt.Dataset(X, label=y,
                        params={**p_lin, "linear_tree": True}).construct()
    ev_c, ev_l = [], []
    _, l_c, ms_c, _ = _train_timed(lt, hc, torch, p_lin, ds, 4, evals=ev_c)
    b_l, l_l, ms_l, _ = _train_timed(lt, hc, torch,
                                     {**p_lin, "linear_tree": True},
                                     ds_lin, 4, evals=ev_l)
    trees = b_l._gbdt.models
    shape_ok = (not any(trees[0].leaf_features)
                and all(t.is_linear for t in trees)
                and all(any(t.leaf_features) for t in trees[1:]))
    n_chk = 1 << 18
    l_err = _scores_err(b_l, b_l._gbdt.scores[0, :n_chk], X)
    ll_c, ll_l = _logloss(ev_c), _logloss(ev_l)
    out["linear"] = {"rounds": 4, "ms_per_round": ms_l, "launches": l_l,
                     "constant_ms_per_round": ms_c, "constant_launches": l_c,
                     "logloss_per_round": ll_l,
                     "constant_logloss_per_round": ll_c,
                     "fit_host_ms_per_tree": b_l._gbdt.linear_fit_ms,
                     "tree0_constant_later_linear": shape_ok,
                     "checked_rows": n_chk,
                     "host_predict_vs_scores_max_abs_err": l_err}
    checks += [
        (shape_ok, "linear trees: tree 0 is not constant or a later tree "
                   "has no linear leaf"),
        (l_err <= 1e-4, f"linear scores differ from the host walk's "
                        f"predict by {l_err}"),
        (ll_l[-1] < ll_c[-1], f"linear train logloss {ll_l[-1]} not below "
                              f"the constant run's {ll_c[-1]}")]

    # -- rollback_one_iter on the dart and linear boosters
    hc.reset_launch_counts()
    b_d.rollback_one_iter()
    rb_d_launches = dict(hc.LAUNCHES)
    rb_d = _scores_err(b_d, b_d._gbdt.scores[0], X)
    rb_dv = _scores_err(b_d, b_d._gbdt._valid_scores[0][0], Xv)
    b_l.rollback_one_iter()
    rb_l = _scores_err(b_l, b_l._gbdt.scores[0, :n_chk], X)
    out["rollback"] = {
        "dart_iterations": b_d.current_iteration,
        "dart_launches": rb_d_launches,
        "dart_predict_vs_scores_max_abs_err": rb_d,
        "dart_valid_predict_vs_scores_max_abs_err": rb_dv,
        "linear_iterations": b_l.current_iteration,
        "linear_predict_vs_scores_max_abs_err": rb_l}
    emit(out)
    checks += [
        (b_d.current_iteration == 7 and b_l.current_iteration == 3,
         "rollback_one_iter left the wrong iteration count"),
        (rb_d_launches["take_leaf_values"] == 2,
         f"DART's rollback launched #2 {rb_d_launches['take_leaf_values']}"
         f" times for one tree on two score sets"),
        (max(rb_d, rb_dv, rb_l) <= 1e-5,
         f"scores after rollback differ from predict by {rb_d} (dart), "
         f"{rb_dv} (dart valid), {rb_l} (linear)")]
    for ok, what in checks:
        check(ok, what)
    return {"rf": l_rf, "dart": l_d, "linear": l_l}


def _split_divergence(a, b):
    """Tree 0 of two runs node by node: (equal leading splits, the first
    diverging node or None, its two gains)."""
    m = min(a.num_leaves, b.num_leaves) - 1
    for i in range(m):
        if (a.split_feature[i] != b.split_feature[i]
                or a.threshold_in_bin[i] != b.threshold_in_bin[i]
                or a.decision_type[i] != b.decision_type[i]
                or a.left_child[i] != b.left_child[i]
                or a.right_child[i] != b.right_child[i]):
            return i, i, (float(a.split_gain[i]), float(b.split_gain[i]))
    if a.num_leaves != b.num_leaves:
        return m, m, (None, None)
    return m, None, (None, None)


def serial_growers_phase(lt, hc, torch, smi, params, ds, X, params_c,
                         ds_c):
    """tpu_grower=masked, compact and wave_exact on the bench table, then
    wave_exact on the Criteo table, then the histogram_pool_size ladder
    (phase 16)."""
    from lightgbm_tpu_torch.utils.synthetic import criteo_like
    t_phase = time.perf_counter()
    out = {"phase": "serial_growers", "model": "bench", "rows": N_ROWS,
           "nvidia_smi": smi}
    checks = []         # run after the line is printed
    n_chk = 1 << 16
    _, _, ms_w, auc_w = _train_timed(lt, hc, torch, params, ds, 2)
    _, _, ms_wc, auc_wc = _train_timed(lt, hc, torch, params_c, ds_c, 2)
    out["wave"] = {"ms_per_round": ms_w, "auc_per_round": auc_w,
                   "criteo_ms_per_round": ms_wc,
                   "criteo_auc_per_round": auc_wc}
    Xc = criteo_like(N_ROWS)[0][:n_chk]
    exact = {**params, "tpu_grower": "wave_exact"}
    runs = {
        "masked": ({**params, "tpu_grower": "masked"}, ds, X, auc_w,
                   "masked"),
        "compact": ({**params, "tpu_grower": "compact"}, ds, X, auc_w,
                    "compact"),
        "wave_exact": (exact, ds, X, auc_w, "mega"),
        "wave_exact_fused": ({**exact, "histogram_impl": "fused"}, ds, X,
                             auc_w, "fused"),
        "wave_exact_criteo": ({**params_c, "tpu_grower": "wave_exact"},
                              ds_c, Xc, auc_wc, "apply")}
    tree0 = {}
    for name, (p, d, Xr, auc_ref, route) in runs.items():
        b, l, ms, auc = _train_timed(lt, hc, torch, p, d, 2)
        g = b._gbdt
        trees = g.models
        lors = []
        first = _same_host_tree(_plain_trees(torch, g, N_ROWS,
                                             lors=lors)[0], trees[0])
        err = _scores_err(b, g.scores[0, :n_chk], Xr)
        serial = g.grower in ("masked", "compact")
        splits = sum(t.num_leaves - 1 for t in trees)
        rec = {"grower": g.grower, "grow_route": g.grow_route,
               "rounds": 2, "ms_per_round": ms, "launches": l,
               "auc_per_round": auc, "wave_auc_per_round": auc_ref,
               "leaves": [t.num_leaves for t in trees],
               "waves_per_tree": _waves(trees),
               "host_reads_per_tree": [t.host_reads for t in trees],
               "first_tree_same": first is not None,
               "first_tree_leaf_value_max_abs_err": first,
               "predict_vs_scores_max_abs_err": err}
        if serial:
            # #1: the root, then one launch a split; #2 one a tree
            rec["launches_expected"] = {
                "build_histogram_slots": len(trees) + splits,
                "take_leaf_values": len(trees)}
            nl = trees[0].num_leaves
            cnt = torch.bincount(lors[0].long(), minlength=nl)[:nl].cpu()
            rec["leaf_count_vs_bincount_max_abs_diff"] = int(np.max(np.abs(
                np.asarray(trees[0].leaf_count[:nl], np.int64)
                - cnt.numpy())))
        out[name] = rec
        tree0[name] = trees[0]
        checks += [
            (g.grow_route == route,
             f"{name} trained on route {g.grow_route}, not {route}"),
            (first is not None and first <= 1e-6,
             f"{name}'s first tree differs from the plain versions' "
             f"({first})"),
            (abs(auc[-1] - auc_ref[-1]) <= 0.01,
             f"{name}'s train AUC {auc[-1]} is not within 0.01 of the wave "
             f"run's {auc_ref[-1]}"),
            (err <= 1e-5, f"{name}'s scores differ from predict by {err}")]
        if g.grower == "masked":
            # masked counts each child's in-bag rows exactly at split time
            checks.append((rec["leaf_count_vs_bincount_max_abs_diff"] == 0,
                           "masked's leaf counts are not its rows'"))
        if serial:
            checks += _serial_batched(lt, hc, torch, smi, name, p, d, b,
                                      ms, l)
        del b, g, trees, lors
    pairs = {}
    for a, b in (("masked", "compact"), ("compact", "wave_exact"),
                 ("masked", "wave_exact")):
        n_eq, div, gains = _split_divergence(tree0[a], tree0[b])
        pairs[f"{a}_vs_{b}"] = {"equal_splits": n_eq,
                                "first_divergence": div,
                                "gains_at_divergence": gains}
        tie = (div is None or (gains[0] is not None and abs(
            gains[0] - gains[1]) <= 1e-5 * max(abs(gains[0]),
                                               abs(gains[1]))))
        checks.append((tie, f"tree 0 of {a} and {b} diverge at node {div} "
                            f"with gains {gains}, not a float tie"))
    out["tree0_split_by_split"] = pairs
    # the ladder: pools between the wave grower's two [L, 3, F, B] caches
    # plus two [KMAX, 3, F, B] temporaries and one cache, then below one
    # cache (5.2 and 15.7 MB at F = 28, B = 64, 255 leaves)
    from lightgbm_tpu_torch.ops.grow_wave import _wave_buckets
    L = params["num_leaves"]
    cache = L * N_FEAT * N_BINS * 3 * 4
    wave = 2 * cache + 2 * _wave_buckets(L)[-1] * N_FEAT * N_BINS * 3 * 4
    ladder = []
    for pool, want in (((cache + wave) / 2 / 2 ** 20, "compact"),
                       (cache / 2 / 2 ** 20, "masked")):
        g = lt.Booster({**params, "histogram_pool_size": pool}, ds)._gbdt
        ladder.append({"histogram_pool_size": pool, "grower": g.grower,
                       "feasible": g._grower_feasible})
        checks.append((g.grower == want,
                       f"histogram_pool_size={pool} picked {g.grower}, "
                       f"not {want}"))
        del g
    out["ladder"] = ladder
    # one masked split's histogram: #1 at K = 2 over every row, a leaf of
    # half the rows split in two
    X_t = ds._handle.X_t
    gen = torch.Generator(device=X_t.device).manual_seed(5)
    slot = torch.randint(-2, 2, (N_ROWS,), generator=gen,
                         device=X_t.device, dtype=torch.int32)
    slot = torch.where(slot < 0, -1, slot).to(torch.int32)
    vals = torch.rand((2, N_ROWS), generator=gen, device=X_t.device)
    ms, dms = timings(lambda: hc.build_histogram_slots_cuda(
        X_t, vals, slot, 2, N_BINS), 20)
    out["masked_split_hist"] = {"K": 2, "rows": N_ROWS, "F": N_FEAT,
                                "B": N_BINS, "ms": ms, "device_ms": dms}
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    for ok, what in checks:
        check(ok, what)


def _serial_batched(lt, hc, torch, smi, name, p, d, bi, ms_i, li):
    """The serial grower `name` batched (ops/grow_batched.py:SerialStepper)
    beside its per-iteration run `bi` (ms a round `ms_i`, launches `li`):
    2 rounds, then one more round under torch.profiler. Emits a `batched`
    line; returns its checks."""
    import hashlib
    from lightgbm_tpu_torch.models.batched import LAG

    def md5(b):
        return hashlib.md5(b.model_to_string().encode()).hexdigest()
    hc.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bb = lt.train({**p, "batched_train": True}, d, num_boost_round=2)
    torch.cuda.synchronize()
    ms_b = (time.perf_counter() - t0) * 1e3 / 2
    lb = dict(hc.LAUNCHES)
    g = bb._gbdt
    runner = next(iter(g._runners.values()))
    trees = g.models
    splits = [t.num_leaves - 1 for t in trees]
    reads = runner.tree_reads[:len(trees)]
    captured = runner.captured.get("split", {})
    same = md5(bi) == md5(bb)
    replays = sum(runner.replays.values())
    # one more batched round under torch.profiler: the device's busy ms,
    # and over the new tree's splits the device ms a split
    busy_b, wall_b = _device_busy(torch, lambda: bb.update_batch(1))
    n3 = g.models[-1].num_leaves - 1
    out = {"phase": "batched", "case": name, "nvidia_smi": smi,
           "rows": g.num_data, "rounds": 2, "grow_route": g.grow_route,
           "hist_route": g.hist_route, "batched_veto": g.batched_veto,
           "md5_equal": same, "ms_per_round": ms_b,
           "per_iteration_ms_per_round": ms_i,
           "steady_ms_per_round": wall_b,
           "device_busy_ms_per_round": busy_b,
           "device_busy_share": (None if busy_b is None
                                 else busy_b / wall_b),
           "device_ms_per_split": (None if busy_b is None
                                   else busy_b / max(n3, 1)),
           "splits_per_tree": splits, "steady_round_splits": n3,
           "captures": dict(runner.captures), "capture_s": runner.capture_s,
           "graph_replays_per_round": replays / 2,
           "split_graph_launches": captured,
           "launches_per_round": {k: v / 2 for k, v in lb.items() if v},
           "per_iteration_launches_per_round": {
               k: v / 2 for k, v in li.items() if v},
           "reads_per_tree": reads,
           "per_iteration_reads_per_tree": [t.host_reads
                                            for t in bi._gbdt.models[:2]],
           "drain_lag_ms": g.drain_lags_ms}
    emit(out)
    want = ["build_histogram_slots"] + (["window_partition"]
                                        if name == "compact" else [])
    checks = [
        (same, f"batched {name}: the model differs from the per-iteration "
               "run's"),
        (g.batched_veto == "", f"batched {name} vetoed: {g.batched_veto}"),
        (dict(runner.captures) == {"start": 1, "split": 1, "finish": 1},
         f"batched {name}: captures {dict(runner.captures)}"),
        (all(r <= -(-a // LAG) + 1 for r, a in zip(reads, splits)),
         f"batched {name}: reads {reads} for splits {splits}")]
    checks += [(captured.get(k, 0) > 0 and lb.get(k, 0) > 0,
                f"batched {name}: {k} never ran in the replayed split graph")
               for k in want]
    del bb, g, runner
    return checks


# ---------------------------------------------------------------------------
# batched training: the default lt.train path
# ---------------------------------------------------------------------------
def _device_busy(torch, fn):
    """(device-busy ms, wall ms) of fn() under torch.profiler: the union of
    the device's activity intervals, and the host clock around the call
    and a synchronize; (None, wall) when the profiler saw no device
    activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    # the device's activity only: host op events of the per-iteration
    # rounds would cost seconds to collect
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    iv = sorted((ev.time_range.start, ev.time_range.end)
                for ev in prof.events()
                if ev.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in iv:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return (busy / 1e3 if iv else None), wall


def _wave_graph_device(torch, runner):
    """(device operations, device ms) of one replay of a runner's wave
    graph under torch.profiler; the tree has ended, so the wave is inert
    and changes nothing. (None, None) when the profiler sees nothing."""
    from torch.profiler import ProfilerActivity, profile
    graph = runner.graphs.get("wave")
    if graph is None:
        return None, None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CUDA]
    if not evs:
        return None, None
    return len(evs), sum(ev.time_range.end - ev.time_range.start
                         for ev in evs) / 1e3


def batched_phase(lt, hc, torch, smi, params, ds, X, w, params_c, ds_c):
    """lt.train's default path, batched (models/batched.py), beside the
    per-iteration path on the same configuration: bench 37 rounds (a chunk
    of 32 and a tail of 5), bench with bagging 0.8 every round and with
    quantized gradients (4 bins), 16 rounds each, bench with a 2^18-row
    valid set (auc, binary_logloss, record_evaluation, early_stopping(10))
    32 rounds, the Criteo table on the apply route 16 rounds, then 2 under
    force_row_wise; then the regimes of the extended step: bench under
    histogram_impl=fused 16 rounds (#9), Criteo under it 8 (#10) and with
    quantized gradients 4 (#10's device descale factors), bench with
    features 0-3 monotone `intermediate` 2, wave_exact on bench 4 and on
    Criteo 2, bench with a forced root and both children 4. Each: the
    model text md5 equal to the per-iteration
    run's, batched_veto empty, every graph captured once (none on the
    tail), at most ceil(waves / 4) + 1 blocking reads a tree; the valid
    run's metric values within 1e-5 relative of the host evaluation, row
    by row, and the same best_iteration. Recorded: ms a round of both
    paths over the run (the batched one with its three captures) and
    over 4 more steady rounds, the device-busy share of both on bench and
    Criteo (torch.profiler over those rounds), graph replays and launches
    a round, inert waves a tree, the drain's lag, and on bench a chunk of
    32 steady rounds without and with the drain; bench's first tree
    through the fixed-shape step equal to the bucketed grower's from the
    same gradients, array by array. The regimes' lines skip the steady
    rounds; they record the wave graph's launches (the route kernel's
    and every device operation of one replay, with its device ms), and
    on the fused routes the route kernel's launches a round, which must
    be above 0 (it ran inside the replayed graphs)."""
    import hashlib
    import tempfile
    from lightgbm_tpu_torch.models.batched import LAG
    from lightgbm_tpu_torch.ops.grow_batched import grow_tree_wave_batched
    from lightgbm_tpu_torch.ops.grow_wave import grow_tree_wave

    def md5(b):
        return hashlib.md5(b.model_to_string().encode()).hexdigest()

    def timed(p, d, rounds, **kw):
        hc.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = lt.train(p, d, num_boost_round=rounds, **kw)
        torch.cuda.synchronize()
        return b, (time.perf_counter() - t0) * 1e3 / rounds, \
            dict(hc.LAUNCHES)

    # the first tree, wave by wave: the fixed-shape step against the
    # bucketed grower, same gradients, eagerly
    g0 = lt.Booster({**params, "batched_train": False}, ds)._gbdt
    g0._boost_from_average()
    gg, hh = g0._gradients()
    ones = torch.ones(N_ROWS, device=gg.device)
    t_b, l_b = grow_tree_wave(g0.X_t, gg[0], hh[0], ones, g0.meta,
                              g0.grow_cfg, rng_seed=g0.tree_seed(0))
    t_f, l_f, _, _ = grow_tree_wave_batched(
        g0.X_t, gg[0], hh[0], ones, g0.meta, g0.grow_cfg,
        hist_plan=g0.hist_plan, rng_seed=g0.tree_seed(0))
    first_diff = [f for f in t_b._fields
                  if isinstance(getattr(t_b, f), torch.Tensor)
                  and not torch.equal(getattr(t_b, f), getattr(t_f, f))]
    first_same = not first_diff and torch.equal(l_b, l_f)
    del g0, gg, hh, t_b, t_f, l_b, l_f

    rv = np.random.RandomState(45)
    Xv = rv.normal(size=(1 << 18, N_FEAT)).astype(np.float32)
    yv = (Xv @ w + rv.normal(scale=0.5, size=1 << 18) > 0).astype(
        np.float32)
    dv = lt.Dataset(Xv, label=yv, reference=ds).construct()
    pv = {**params, "metric": ["auc", "binary_logloss"]}
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.TemporaryDirectory(dir=here)
    forced_path = os.path.join(tmp.name, "forced.json")
    with open(forced_path, "w") as f:
        json.dump({"feature": 0, "threshold": float(np.quantile(X[:, 0],
                                                                0.5)),
                   "left": {"feature": 1, "threshold": float(
                       np.quantile(X[:, 1], 0.3))},
                   "right": {"feature": 2, "threshold": float(
                       np.quantile(X[:, 2], 0.7))}}, f)
    mono_b = [int(np.sign(x)) for x in w[:4]] + [0] * (N_FEAT - 4)
    fused_c = {**params_c, "histogram_impl": "fused"}
    # (name, params, dataset, rounds, valid set, the regime's route and
    # kernel; None for the A12(a) cases)
    cases = (
        ("bench", params, ds, 37, False, None),
        ("bagging", {**params, "bagging_fraction": 0.8,
                     "bagging_freq": 1}, ds, 16, False, None),
        ("quantized", {**params, "use_quantized_grad": True,
                       "num_grad_quant_bins": 4}, ds, 16, False, None),
        ("valid", pv, ds, 32, True, None),
        ("criteo", params_c, ds_c, 16, False, None),
        ("criteo_rowwise", {**params_c, "force_row_wise": True}, ds_c, 2,
         False, None),
        ("fused", {**params, "histogram_impl": "fused"}, ds, 16, False,
         ("fused", "wave_pass_fused")),
        ("criteo_fused", fused_c, ds_c, 8, False,
         ("fused_tiled", "wave_pass_fused_tiled")),
        ("criteo_fused_quantized", {**fused_c, "use_quantized_grad": True,
                                    "num_grad_quant_bins": 4}, ds_c, 4,
         False, ("fused_tiled", "wave_pass_fused_tiled")),
        ("intermediate", {**params, "monotone_constraints": mono_b,
                          "monotone_constraints_method": "intermediate"},
         ds, 2, False, ("mega", "wave_pass")),
        ("wave_exact", {**params, "tpu_grower": "wave_exact"}, ds, 4, False,
         ("mega", "wave_pass")),
        ("wave_exact_criteo", {**params_c, "tpu_grower": "wave_exact"},
         ds_c, 2, False, ("apply", "wave_apply")),
        ("forced", {**params, "forcedsplits_filename": forced_path}, ds, 4,
         False, ("mega", "wave_pass")))
    for name, p, d, rounds, valid, regime in cases:
        t_case = time.perf_counter()
        runs = []
        for batched in (False, True):
            kw = {}
            rec = {}
            if valid:
                kw = dict(valid_sets=[dv], callbacks=[
                    lt.record_evaluation(rec),
                    lt.early_stopping(10, verbose=False)])
            b, ms, launches = timed({**p, "batched_train": batched}, d,
                                    rounds, **kw)
            runs.append((b, ms, launches, rec))
        (bi, ms_i, li, rec_i), (bb, ms_b, lb, rec_b) = runs
        g = bb._gbdt
        runner = next(iter(g._runners.values()))
        trees = g.models
        waves = [t.num_waves for t in trees]
        reads = runner.tree_reads[:len(trees)]
        ran = runner.tree_waves[:len(trees)]
        inert = [r - a for r, a in zip(ran, waves)]
        replays = sum(runner.replays.values())
        # the steady round: 4 more rounds of each booster (the batched
        # one replays its captured graphs), with the device-busy share
        # under torch.profiler on bench and Criteo (a profiled window
        # costs some 3 s)
        t_prof = time.perf_counter()
        wall_b = busy_i = busy_b = wall_i = None
        if name in ("bench", "criteo"):
            busy_i, wall_i = _device_busy(
                torch, lambda: [bi.update() for _ in range(4)])
            busy_b, wall_b = _device_busy(torch, lambda: bb.update_batch(4))
        elif regime is None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bb.update_batch(4)
            torch.cuda.synchronize()
            wall_b = (time.perf_counter() - t0) * 1e3
        t_prof = time.perf_counter() - t_prof
        out = {"phase": "batched", "case": name, "nvidia_smi": smi,
               "rows": g.num_data, "rounds": rounds,
               "grow_route": g.grow_route, "hist_route": g.hist_route,
               "batched_veto": g.batched_veto, "md5_equal": md5(bi) == md5(bb),
               "ms_per_round": ms_b, "per_iteration_ms_per_round": ms_i,
               "steady_ms_per_round": None if wall_b is None else wall_b / 4,
               "per_iteration_steady_ms_per_round": (
                   None if wall_i is None else wall_i / 4),
               "device_busy_ms_per_round": (None if busy_b is None
                                            else busy_b / 4),
               "device_busy_share": (None if busy_b is None
                                     else busy_b / wall_b),
               "per_iteration_device_busy_ms_per_round": (
                   None if busy_i is None else busy_i / 4),
               "per_iteration_device_busy_share": (
                   None if busy_i is None else busy_i / wall_i),
               "captures": dict(runner.captures),
               "capture_s": runner.capture_s,
               "graph_replays_per_round": replays / rounds,
               "launches_per_round": {k: v / rounds for k, v in lb.items()
                                      if v},
               "per_iteration_launches_per_round": {
                   k: v / rounds for k, v in li.items() if v},
               "waves_per_tree": waves, "reads_per_tree": reads,
               "inert_waves_per_tree": float(np.mean(inert)),
               "drain_lag_ms": g.drain_lags_ms,
               "case_s": time.perf_counter() - t_case, "profile_s": t_prof}
        if regime is not None:
            ops, dms = _wave_graph_device(torch, runner)
            out.update(wave_graph_launches=runner.captured.get("wave"),
                       wave_graph_device_ops=ops, wave_graph_device_ms=dms,
                       route_kernel=regime[1],
                       route_kernel_launches_per_round=(
                           lb.get(regime[1], 0) / rounds))
        if name == "bench":
            # a chunk of 32 more rounds without the drain (the trees stay
            # on the card), then with it (converted on its thread)
            drain_ms = []
            for drain in (False, True):
                if drain:
                    g.start_drain()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                bb.update_batch(32)
                g.stop_drain()
                torch.cuda.synchronize()
                drain_ms.append((time.perf_counter() - t0) * 1e3 / 32)
            out.update(first_tree_same=first_same,
                       first_tree_diff=first_diff,
                       steady_ms_per_round_without_drain=drain_ms[0],
                       steady_ms_per_round_with_drain=drain_ms[1])
        if valid:
            hv, bv = rec_i["valid_0"], rec_b["valid_0"]
            rel = max(abs(a - c) / max(abs(a), 1e-12) for m in hv
                      for a, c in zip(hv[m], bv[m]))
            out.update(metric_rows=len(bv["auc"]), metric_max_rel_err=rel,
                       best_iteration=[bi.best_iteration, bb.best_iteration],
                       valid_auc=bv["auc"][-1])
            check(len(hv["auc"]) == len(bv["auc"]) and rel <= 1e-5,
                  f"batched valid metrics differ by {rel} relative")
            check(bi.best_iteration == bb.best_iteration,
                  "batched best_iteration differs")
        emit(out)
        check(out["md5_equal"], f"batched {name}: the model differs from "
                                "the per-iteration run's")
        check(g.batched_veto == "", f"batched {name} vetoed: "
                                    f"{g.batched_veto}")
        check(len(g._runners) == 1 and dict(runner.captures) == {
            "start": 1, "wave": 1, "finish": 1},
            f"batched {name}: captures {dict(runner.captures)}")
        check(all(r <= -(-a // LAG) + 1 for r, a in zip(reads, waves)),
              f"batched {name}: reads {reads} for waves {waves}")
        if name == "bench":
            check(first_same, f"the fixed-shape first tree differs in "
                              f"{first_diff}")
        if regime is not None:
            check(g.grow_route == regime[0],
                  f"batched {name}: route {g.grow_route}")
            check(out["route_kernel_launches_per_round"] > 0,
                  f"batched {name}: {regime[1]} never ran in the replayed "
                  "graphs")
        del bi, bb, g, runner, trees, runs
    tmp.cleanup()
    del dv


# ---------------------------------------------------------------------------
# more than 256 bins a feature: uint16 storage on the apply route
# ---------------------------------------------------------------------------
def _wide_hist_records(hc, torch, dev, storages):
    """Kernel #1 on uint16 storages ([(name, X_t, B)]): the root (K = 1)
    and a wave's smaller children (K = 128, about half the rows in a
    slot), bitwise against the plain version on grid values and within
    1e-6 on float values, timed beside the plain version and one
    index_add_ (the library call, CUDA events only), with the byte
    bound. Returns {name:
    the K = 1 record}."""
    from lightgbm_tpu_torch.utils import indexable_bins
    gen = torch.Generator(device=dev).manual_seed(17)
    out = {}
    for name, X, B in storages:
        F, N = X.shape
        C = N_CH
        vals = torch.randn((C, N), generator=gen, device=dev)
        vals[1] = vals[1].abs() * 0.25
        grid = _grid_vals(torch, gen, C, N, dev)
        for K, active in ((1, "all"), (128, "half")):
            slot = _slot_case(torch, gen, N, K, active, dev)
            got = hc.build_histogram_slots_cuda(X, vals, slot, K, B)
            ref = hc.build_histogram_slots_plain(X, vals, slot, K, B)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            tol = 1e-6 * float(ref.abs().max()) + 1e-6
            check(err <= tol, f"build_histogram_slots {name} K={K}: max "
                              f"|err| {err}")
            check(torch.equal(
                hc.build_histogram_slots_cuda(X, grid, slot, K, B),
                hc.build_histogram_slots_plain(X, grid, slot, K, B)),
                f"build_histogram_slots {name} K={K}: not bitwise on grid "
                "values")
            del got, ref
            rows = N if slot is None else int((slot >= 0).sum())
            s64 = (torch.zeros(N, dtype=torch.int64, device=dev)
                   if slot is None else slot.to(torch.int64))
            keep = torch.nonzero(s64 >= 0).flatten()
            b = indexable_bins(X).index_select(1, keep).to(torch.int64) \
                & 0xFFFF
            c_ix = torch.arange(C, device=dev)[:, None, None]
            f_ix = torch.arange(F, device=dev)[None, :, None]
            flat = (((s64[keep][None, None, :] * C + c_ix) * F + f_ix) * B
                    + b[None]).reshape(-1)
            lvals = vals[:, None, keep].expand(C, F, rows).reshape(-1)
            acc = torch.zeros(K * C * F * B, device=dev)
            del b
            ms, dms = timings(lambda: hc.build_histogram_slots_cuda(
                X, vals, slot, K, B), 20)
            plain_ms = time_ms(lambda: hc.build_histogram_slots_plain(
                X, vals, slot, K, B), 2, 1)
            lib_ms = time_ms(lambda: acc.index_add_(0, flat, lvals), 10)
            nbytes = (0 if slot is None else 4 * N) + rows * (2 * F + 4 * C) \
                + K * C * F * B * 4
            bms, by = bound_ms(nbytes, rows * F * C)
            rec = dict(name="build_histogram_slots", shape=name, K=K,
                       active=active, rows=rows, F=F, B=B, bin_bytes=2,
                       max_abs_err=err, tol=tol, ms=ms, device_ms=dms,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                       bound_by=by, bound_us=bms * 1e3,
                       plan=hc.plan_hist_tiles(K, C, F, B)._asdict())
            emit({"phase": "wide_kernels", "kernel_ms": ms, **rec})
            if K == 1:
                out[name] = rec
            del flat, lvals, acc
    return out


def window_phase(hc, torch, dev, storages):
    """The compact grower's two window operations on each storage of
    `storages` ([(name, X_t, B)]): #1 over a window of the row order (its
    id list and bounds in device memory) and the partition kernel, on a
    leaf of half the rows and one of 2^14 rows, each bitwise against its
    plain version (grid values for #1), timed beside it, with the byte
    bound and, for #1, one index_add_ over the window's rows. Returns the
    partition record of the first storage's half-rows window (the kernels
    line's)."""
    from lightgbm_tpu_torch.ops.grow_batched import partition_record
    from lightgbm_tpu_torch.ops.split import SplitResult
    from lightgbm_tpu_torch.utils import indexable_bins
    gen = torch.Generator(device=dev).manual_seed(23)
    out = None
    for name, X, B in storages:
        F, N = X.shape
        bb = 1 if X.dtype == torch.uint8 else 2
        order = torch.randperm(N, generator=gen, device=dev).to(torch.int32)
        grid = _grid_vals(torch, gen, 2, N, dev)
        lor = torch.zeros(N, dtype=torch.int32, device=dev)
        for count in (N // 2, 1 << 14):
            start = (N - count) // 3
            win = torch.tensor([start, start + count], dtype=torch.int32,
                               device=dev)
            got = hc.build_histogram_window_cuda(X, grid, order, win, B)
            ref = hc.build_histogram_window_plain(X, grid, order, win, B)
            check(torch.equal(got, ref), f"window histogram {name} "
                                         f"{count} rows: not bitwise")
            rows = order[start:start + count].long()
            b = indexable_bins(X).index_select(1, rows).to(torch.int64) \
                & 0xFFFF
            flat = ((torch.arange(2, device=dev)[:, None, None] * F
                     + torch.arange(F, device=dev)[None, :, None]) * B
                    + b[None]).reshape(-1)
            lvals = grid[:, None, rows].expand(2, F, count).reshape(-1)
            acc = torch.zeros(2 * F * B, device=dev)
            del b
            ms, dms = timings(lambda: hc.build_histogram_window_cuda(
                X, grid, order, win, B), 20)
            plain_ms = time_ms(lambda: hc.build_histogram_window_plain(
                X, grid, order, win, B), 2, 1)
            lib_ms = time_ms(lambda: acc.index_add_(0, flat, lvals), 10)
            bms, by = bound_ms(count * (4 + bb * F + 8) + 2 * F * B * 4,
                               count * F * 2)
            emit({"phase": "kernels", "name": "build_histogram_slots",
                  "shape": f"{name}_window", "rows": count, "F": F, "B": B,
                  "max_abs_err": 0.0, "ms": ms, "device_ms": dms,
                  "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                  "bound_ms": bms, "bound_by": by, "bound_us": bms * 1e3})
            del flat, lvals, acc, got, ref
            # a numeric split of feature 3 at its middle bin, the missing
            # bin to the left
            one = torch.ones(1, dtype=torch.int64, device=dev)
            bs = SplitResult(*([torch.zeros(1, device=dev)] * 12))._replace(
                feature=3 * one, threshold=(B // 2) * one,
                default_left=one.bool())
            meta = _window_meta(torch, F, B, dev)
            rec = partition_record(start * one, count * one, bs,
                                   torch.zeros(1, dtype=torch.bool,
                                               device=dev),
                                   torch.zeros((1, (B + 31) // 32),
                                               dtype=torch.int64,
                                               device=dev), 7 * one, meta)
            o1, l1 = order.clone(), lor.clone()
            o2, l2 = order.clone(), lor.clone()
            n1 = hc.window_partition_cuda(X, o1, l1, rec)
            n2 = hc.window_partition_plain(X, o2, l2, rec)
            check(torch.equal(o1, o2) and torch.equal(l1, l2)
                  and torch.equal(n1, n2),
                  f"window_partition {name} {count} rows: not bitwise")
            n_left = int(n1)
            # timed in place: a partitioned window partitions again into
            # the same sides
            ms, dms = timings(lambda: hc.window_partition_cuda(X, o1, l1,
                                                               rec), 20)
            plain_ms = time_ms(lambda: hc.window_partition_plain(
                X, o2, l2, rec), 2, 1)
            del o1, l1, o2, l2
            # the window's ids and bins read, ids written to the scratch and
            # back, the right rows' leaf ids written
            bms, by = bound_ms(count * (4 + bb) + 8 * count
                               + 4 * (count - n_left), 0)
            r = dict(name="window_partition", shape=name, rows=count,
                     n_left=n_left, max_abs_err=0.0, ms=ms, device_ms=dms,
                     plain_ms=plain_ms, library_ms=None, bound_ms=bms,
                     bound_by=by, bound_us=bms * 1e3)
            emit({"phase": "kernels", "kernel_ms": r["ms"], **r})
            if out is None and count == N // 2:
                out = r
    return out


def _window_meta(torch, F, B, dev):
    """Feature metadata of F numeric features of B bins, NaN missing."""
    from lightgbm_tpu_torch.models.tree import MISSING_NAN
    from lightgbm_tpu_torch.ops.split import FeatureMeta
    z = torch.zeros(F, dtype=torch.int64, device=dev)
    return FeatureMeta(num_bins=z + B, missing_type=z + MISSING_NAN,
                       default_bin=z, is_categorical=z.bool())


def wide_bins_phase(lt, hc, torch, dev, smi, X, y):
    """max_bin past 255 (uint16 storage, the apply route): bench.py's table
    at max_bin=1023, 4 rounds batched and per iteration, beside a
    max_bin=255 run of the same rounds; the Criteo schema with its last
    six categorical columns at 300-1000 categories, max_bin=1023, 2 rounds
    of each path beside max_bin=255; the MSLR-shaped ranking table (2^17
    documents) at max_bin=1023, where the histogram_pool_size ladder
    picks compact, 1 round of each path beside a max_bin=255 round on
    compact. Each: ingest seconds, model text md5 equal across the paths,
    the first tree equal to the plain versions', the train metric against
    the max_bin=255 run's (AUC less 0.01; ranking: ndcg@10 less
    RANK_WIDE_GAP, and above the initial scores'), #1 and #4 (the
    partition kernel on ranking) launches a round. Then #1 and #4 on the
    uint16 storages against their plain versions (`_wide_hist_records`,
    wave_apply_phase, on the Criteo storage), #1 also on bench's shape at
    4096 bins, where a tile holds a range of one column's bins. Returns
    (#1 records, #4 record, the uint16 storages [(name, X_t, B)], the
    4096-bin one last, the compact run's launches)."""
    import hashlib
    from lightgbm_tpu_torch.config import resolve_params
    from lightgbm_tpu_torch.metrics import create_metric
    from lightgbm_tpu_torch.utils.synthetic import (
        CRITEO_CAT_COLUMNS, CRITEO_WIDE_CARDINALITIES, criteo_like)

    def md5(b):
        return hashlib.md5(b.model_to_string().encode()).hexdigest()
    Xc, yc = criteo_like(N_ROWS, cardinalities=CRITEO_WIDE_CARDINALITIES)
    # the ranking table cut to 2^17 documents: the ladder's choice depends
    # on L, F and B alone, host binning of 136 columns at 1023 bins takes
    # 39 s at 2^20, and at 2^18 the whole run passed 900 s
    Xr, yr, sizes = _mslr_like(np.random.RandomState(61), N_ROWS // 8)
    base = dict(objective="binary", num_leaves=N_LEAVES, learning_rate=0.1,
                min_data_in_leaf=20, verbose=-1, binning_impl="auto",
                device_type="cuda", metric="auc")
    cases = (
        ("bench", X, y, {}, {}, 4),
        ("criteo", Xc, yc, {"categorical_feature": list(CRITEO_CAT_COLUMNS)},
         {}, 2),
        ("rank", Xr, yr, {"group": sizes},
         {"objective": "lambdarank", "metric": "ndcg", "eval_at": [10]}, 1))
    storages, records = [], {}
    compact_launches = None
    for name, Xd, yd, dskw, over, rounds in cases:
        t_case = time.perf_counter()
        res = {}
        for mb in (255, 1023):
            p = {**base, **over, "max_bin": mb}
            if name == "rank" and mb == 255:
                # at 255 bins the ladder picks the wave grower; the
                # comparison holds the grower
                p["tpu_grower"] = "compact"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ds = lt.Dataset(Xd, label=yd, params=p, **dskw).construct()
            torch.cuda.synchronize()
            ingest_s = time.perf_counter() - t0
            runs = []
            for batched in ((False, True) if mb == 1023 else (True,)):
                hc.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                b = lt.train({**p, "batched_train": batched}, ds, rounds)
                torch.cuda.synchronize()
                runs.append((b, (time.perf_counter() - t0) * 1e3 / rounds,
                             dict(hc.LAUNCHES)))
            res[mb] = (ds, ingest_s, runs)
        ds, ingest_s, ((bi, ms_i, li), (bb, ms_b, lb)) = res[1023]
        _, ingest_255, ((b255, ms_255, _),) = res[255]
        g = bb._gbdt
        h = ds._handle
        metric = bb.eval_train()[0][2]
        metric_255 = b255.eval_train()[0][2]
        first = _same_host_tree(_plain_trees(torch, bi._gbdt, len(yd))[0],
                                bi._gbdt.models[0])
        rec = {"phase": "wide_bins", "case": name, "nvidia_smi": smi,
               "rows": len(yd), "features": Xd.shape[1], "rounds": rounds,
               "max_bin": 1023, "num_bins_padded": g.num_bins_padded,
               "storage_dtype": str(g.X_t.dtype),
               "max_num_bin": int(max(m.num_bin for m in h.mappers)),
               "binning_route": h.binning_route, "ingest_s": ingest_s,
               "ingest_s_max_bin_255": ingest_255,
               "grower": g.grower, "grow_route": g.grow_route,
               "hist_route": g.hist_route, "batched_veto": g.batched_veto,
               "md5_equal": md5(bi) == md5(bb),
               "first_tree_same": first is not None,
               "first_tree_leaf_value_max_abs_err": first,
               "ms_per_round": ms_b, "per_iteration_ms_per_round": ms_i,
               "max_bin_255_ms_per_round": ms_255,
               "train_metric": metric, "train_metric_max_bin_255":
               metric_255, "max_bin_255_grower": b255._gbdt.grower,
               "launches_per_round": {k: v / rounds for k, v in lb.items()
                                      if v},
               "per_iteration_launches_per_round": {
                   k: v / rounds for k, v in li.items() if v},
               "leaves": [t.num_leaves for t in g.models],
               "categorical_splits": [t.num_cat for t in g.models],
               "case_s": time.perf_counter() - t_case}
        if name == "rank":
            m0 = create_metric("ndcg", resolve_params(
                {**base, **over, "max_bin": 1023}))
            m0.init(h.metadata, len(yd))
            rec["ndcg_initial"] = float(m0.eval(np.zeros(len(yd)),
                                                None)[0][1])
        if name == "bench":
            fused = lt.Booster({**base, "max_bin": 1023,
                                "histogram_impl": "fused"}, ds)._gbdt
            rec["fused_veto_reasons"] = fused.fused_veto_reasons
            check(fused.fused_veto_reasons == [
                f"wide_bins (B={g.num_bins_padded} > 256)"],
                f"wide bins: fused veto {fused.fused_veto_reasons}")
            del fused
        emit(rec)
        want = "compact" if name == "rank" else "wave"
        check(g.grower == want, f"wide {name}: grower {g.grower}, not {want}")
        check(g.X_t.dtype == torch.uint16 and g.num_bins_padded > 256,
              f"wide {name}: storage {g.X_t.dtype} B={g.num_bins_padded}")
        check(h.binning_route == "host", f"wide {name}: binning route "
                                         f"{h.binning_route}")
        check(g.grow_route == ("compact" if name == "rank" else "apply")
              and g.hist_route == "slots",
              f"wide {name}: route {g.grow_route}/{g.hist_route}")
        check(rec["md5_equal"] and g.batched_veto == "",
              f"wide {name}: batched model differs ({g.batched_veto})")
        check(first is not None,
              f"wide {name}: first tree differs from the plain versions'")
        check(first <= 1e-6,
              f"wide {name}: first tree leaf values differ by {first}")
        if name == "rank":
            # one round of 255 leaves may fit ndcg@10 less well at 1023
            # bins than at 255 (RANK_WIDE_GAP)
            check(metric > rec["ndcg_initial"],
                  f"wide rank: ndcg@10 {metric} not above the initial "
                  f"{rec['ndcg_initial']}")
            check(metric >= metric_255 - RANK_WIDE_GAP,
                  f"wide rank: ndcg@10 {metric} below the max_bin=255 "
                  f"run's {metric_255} less {RANK_WIDE_GAP}")
        else:
            check(metric >= metric_255 - 0.01,
                  f"wide {name}: train metric {metric} below the "
                  f"max_bin=255 run's {metric_255} less 0.01")
        kern = (("build_histogram_slots", "window_partition")
                if name == "rank" else ("build_histogram_slots",
                                        "wave_apply"))
        check(all(lb.get(k, 0) > 0 for k in kern),
              f"wide {name}: {kern} not all launched")
        if name == "rank":
            compact_launches = lb
        else:
            storages.append((f"{name}_u16", g.X_t, g.meta, g.grow_cfg))
        del bi, bb, b255, res, g, h
    wide = [(n, X_t, cfg.num_bins_padded) for n, X_t, _, cfg in storages]
    # past 3072 bins at C = 2 one column's bins do not fit a tile: a tile
    # holds a range of them (HistTilePlan.bins_per_tile); bench's shape
    # with 4096 bins drawn uniformly
    gen = torch.Generator(device=dev).manual_seed(29)
    X4 = torch.randint(0, 4096, (N_FEAT, N_ROWS), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.uint16)
    for K in (1, 128):
        plan = hc.plan_hist_tiles(K, N_CH, N_FEAT, 4096)
        check(plan.bins_per_tile < 4096,
              f"B = 4096, K = {K}: the plan cuts no bin range ({plan})")
    wide.append(("grid4096_u16", X4, 4096))
    hist = _wide_hist_records(hc, torch, dev, wide)
    apply_rec = wave_apply_phase(hc, torch, dev, storages[1:],
                                 want="criteo_u16")
    return hist, apply_rec, wide, compact_launches


def _params_text(b, *flags):
    """A model text with the runtime parameters `flags` normalized to 0
    (a profiled run's trees, not its parameter record, are compared)."""
    text = b.model_to_string()
    for f in flags:
        text = text.replace(f"[{f}: 1]", f"[{f}: 0]")
    return text


def _md5(text):
    import hashlib
    return hashlib.md5(text.encode()).hexdigest()


def profile_phase(lt, hc, torch, smi, params, ds, bst, Xt):
    """device_profile=true (runtime/profiler.py) on bench.py's model: 4
    rounds per iteration, then one batched chunk of 8 rounds, each beside
    the same run without the profiler. Prints the per-stage ms a round
    (the ring's mean, `other` included), the init-time spans, the HBM
    watermark of the run (the peak is reset before it), the stage probe
    and the profiled against the unprofiled ms a round. Checks: every
    ring record's stages sum to its wall within 20%; X_t's bytes <=
    hbm_peak_bytes <= the card's memory; the model text's md5 equals the
    unprofiled run's (the parameters' device_profile flag normalized).
    Then the main booster's binned ServingSession with a profiler scores
    the 4096 held-out f32 rows bitwise as one without, its bin_rows span
    around the bucketize launch, bin_rows_rows equal to the rows served."""
    from lightgbm_tpu_torch.runtime.profiler import StageProfiler
    total_mem = torch.cuda.get_device_properties(0).total_memory
    xt = bst._gbdt.X_t
    xt_bytes = xt.numel() * xt.element_size()

    def run(p, rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = lt.train(p, ds, num_boost_round=rounds)
        torch.cuda.synchronize()
        return b, (time.perf_counter() - t0) * 1e3 / rounds

    for mode, extra, rounds in (
            ("per_iteration", {"batched_train": False}, 4),
            ("batched", {"batched_train": True, "batched_chunk_size": 8},
             8)):
        plain, ms_plain = run({**params, **extra}, rounds)
        plain_md5 = _md5(_params_text(plain))
        del plain
        torch.cuda.reset_peak_memory_stats()
        prof, ms_prof = run({**params, **extra, "device_profile": True},
                            rounds)
        p = prof.get_profile()
        ring = p["ring"]
        names = sorted({k for r in ring for k in r["stages_s"]})
        per_round = {k: float(np.mean([r["stages_s"].get(k, 0.0)
                                       for r in ring])) * 1e3 for k in names}
        init = {k: v for k, v in p["stages_s"].items() if k not in names}
        worst = max(abs(sum(r["stages_s"].values()) - r["wall_s"])
                    / r["wall_s"] for r in ring)
        hbm = p.get("hbm_peak_bytes")
        same = _md5(_params_text(prof, "device_profile")) == plain_md5
        emit({"phase": "profile", "mode": mode, "rows": N_ROWS,
              "rounds": rounds, "n_iters": p["n_iters"],
              "stage_ms_per_round": per_round, "init_spans_s": init,
              "stage_counts": p["stage_counts"],
              "counters": p.get("counters"),
              "hbm_peak_bytes": hbm, "X_t_bytes": xt_bytes,
              "card_bytes": total_mem,
              "stage_probe": p.get("stage_probe"),
              "fused_veto_reasons": p.get("fused_veto_reasons"),
              "hist_rowwise": p.get("hist_rowwise"),
              "ms_per_round_profiled": ms_prof,
              "ms_per_round_unprofiled": ms_plain,
              "ring_sum_worst_rel_err": worst, "md5_equal": same,
              "nvidia_smi": smi})
        check(p["n_iters"] == rounds and len(ring) == rounds,
              f"profile {mode}: {p['n_iters']} records in {rounds} rounds")
        check(worst <= 0.2, f"profile {mode}: a record's stages miss its "
                            f"wall by {worst:.3f}")
        check(hbm is not None and xt_bytes <= hbm <= total_mem,
              f"profile {mode}: hbm_peak_bytes {hbm} outside "
              f"[{xt_bytes}, {total_mem}]")
        check(same, f"profile {mode}: the profiled model differs")
        if mode == "per_iteration":
            check(set(p["stage_probe"]) == {"probe_rows", "histogram_s",
                                            "split_search_s",
                                            "partition_s"},
                  "profile: no stage probe")
        else:
            check(all(r.get("batched") for r in ring)
                  and p["counters"]["dispatches"] >= 1,
                  "profile batched: the chunk was not recorded as batched")
        del prof

    # the serving stage profiler on the binned engine (raw-f32 route)
    kw = dict(engine="binned", max_batch=256)
    ref = bst.serve(**kw).score_margin(Xt)
    sp = StageProfiler()
    sess = bst.serve(profiler=sp, **kw)
    hc.reset_launch_counts()
    got = sess.score_margin(Xt)
    launches = dict(hc.LAUNCHES)
    d = sp.to_dict()
    emit({"phase": "profile", "mode": "serve", "rows": len(Xt),
          "bitwise": bool(np.array_equal(got, ref)),
          "counters": d.get("counters"),
          "bin_rows_s": d["stages_s"].get("bin_rows"),
          "bin_rows_spans": d["stage_counts"].get("bin_rows"),
          "bucketize_launches": launches["bucketize"],
          "hbm_samples": len(d.get("hbm_watermark", [])),
          "hbm_peak_bytes": d.get("hbm_peak_bytes"), "nvidia_smi": smi})
    check(np.array_equal(got, ref), "serving profiler changed the margins")
    check(d["counters"]["bin_rows_rows"] == len(Xt),
          f"bin_rows_rows {d['counters']['bin_rows_rows']} != {len(Xt)}")
    check(launches["bucketize"] == d["stage_counts"]["bin_rows"] > 0,
          "the bin_rows spans are not the bucketize launches")


def autotune_phase(lt, hc, torch, smi, params, ds, params_c, ds_c):
    """autotune=true (runtime/autotune.py) with a fresh cache file under a
    temporary directory: bench.py's model (28 columns, the narrow fused
    arm: #3 + search against #9) and the Criteo table (39 columns, the
    tiled arm: #4 + #1 + search against #10), each 2 rounds per iteration
    with device_profile on. Prints the decision (grower, hist_impl, every
    timing) and the autotune span's seconds. Checks: a second
    construction reports cached "memory", a third after _MEM_CACHE is
    cleared "disk"; the model's md5 (parameters left out) equals a run
    with tpu_grower and histogram_impl pinned to the decision. Where the
    decision skipped the fused-wave probe (a row-wise layout won first),
    probe_fused_wave runs directly on the same storage, so both arms run
    on the card; on Criteo it must time the tiled arm. Then lt.train's
    default path, batched (chunks of 8), untuned, tuned and pinned to the
    row-wise layout (the probe's other outcome) in the order untuned,
    tuned, rowwise, rowwise, tuned, untuned: each trains one chunk (its
    captures) and times a second, steady, chunk; the ms a round of each
    and the routes taken are printed, each batched with no veto, the
    tuned one on the decision's histogram route. Then the binning decision at bench's
    shape, #6 against the host loop."""
    import tempfile
    from lightgbm_tpu_torch.ops.histogram_cuda import MAX_WAVE_FEATURES
    from lightgbm_tpu_torch.runtime import autotune as at
    tmp = tempfile.TemporaryDirectory()
    cache = os.path.join(tmp.name, "autotune.json")

    def trees(b):
        return _md5(b.model_to_string().split("\nparameters:")[0])

    for name, p0, d in (("bench", params, ds), ("criteo", params_c, ds_c)):
        at._MEM_CACHE.clear()
        p = {**p0, "autotune": True, "autotune_cache": cache,
             "device_profile": True, "batched_train": False}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = lt.train(p, d, num_boost_round=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        g = b._gbdt
        dec = dict(g.autotune_decision)
        span_s = b.get_profile()["stages_s"]["autotune"]
        route = (g.grower, g.grow_route, g.hist_route)
        cols = int(g.X_t.shape[0])
        tuned = trees(b)
        fw = dec["fused_wave_timings"]
        direct = None if fw else at.probe_fused_wave(g.X_t, g.grow_cfg)
        del b, g
        second = lt.Booster(params=p, train_set=d)._gbdt.autotune_decision
        at._MEM_CACHE.clear()
        third = lt.Booster(params=p, train_set=d)._gbdt.autotune_decision
        pinned = {**p0, "batched_train": False, "tpu_grower": dec["grower"],
                  "histogram_impl": dec["hist_impl"] or "auto"}
        same = trees(lt.train(pinned, d, num_boost_round=2)) == tuned
        steady = {"untuned": [], "tuned": [], "rowwise": []}
        batched_routes = {}
        for tag in ("untuned", "tuned", "rowwise", "rowwise", "tuned",
                    "untuned"):
            q = {**p0, "batched_train": True, "batched_chunk_size": 8}
            if tag == "tuned":
                q.update(autotune=True, autotune_cache=cache)
            elif tag == "rowwise":
                q["histogram_impl"] = "rowwise"
            bt = lt.train(q, d, num_boost_round=8)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bt.update_batch(8)
            torch.cuda.synchronize()
            steady[tag].append((time.perf_counter() - t0) * 1e3 / 8)
            gt = bt._gbdt
            batched_routes[tag] = (gt.grow_route, gt.hist_route,
                                   gt.batched_veto)
            del bt, gt
        emit({"phase": "autotune", "case": name, "rows": N_ROWS,
              "storage_columns": cols,
              "grower": dec["grower"], "hist_impl": dec["hist_impl"],
              "grow_route": route[1], "hist_route": route[2],
              "timings": dec["timings"],
              "hist_impl_timings": dec["hist_impl_timings"],
              "fused_wave_timings": fw,
              "fused_wave_arm": ("tiled" if cols > MAX_WAVE_FEATURES
                                 else "narrow"),
              "fused_wave_timings_direct": direct,
              "probe_rows": dec["probe_rows"], "key": dec["key"],
              "autotune_span_s": span_s, "train_2_rounds_s": wall,
              "cached_second": second["cached"],
              "cached_third": third["cached"], "md5_equal_pinned": same,
              "batched_steady_ms_per_round": steady,
              "batched_routes": batched_routes, "nvidia_smi": smi})
        check(dec["cached"] is False and dec["grower"] in
              ("wave", "compact", "masked"), f"autotune {name}: {dec}")
        check(second["cached"] == "memory" and third["cached"] == "disk",
              f"autotune {name}: cached {second['cached']} / "
              f"{third['cached']}")
        check(same, f"autotune {name}: the model differs from the run "
                    "pinned to the decision")
        check(set(fw or direct) == {"two_pass", "fused"},
              f"autotune {name}: the fused-wave probe did not run")
        check(name != "criteo" or cols > MAX_WAVE_FEATURES,
              f"autotune criteo: {cols} storage columns take the narrow "
              "fused arm")
        check(all(r[2] == "" for r in batched_routes.values())
              and batched_routes["tuned"][1] == route[2],
              f"autotune {name}: batched routes {batched_routes}, the "
              f"decision's {route}")

    at._MEM_CACHE.clear()
    h = ds._handle
    bd = at.autotune_binning_decision(
        h.mappers, n_rows=N_ROWS, n_features=N_FEAT, max_bin=63,
        num_leaves=N_LEAVES, cache_path=cache,
        device=torch.device("cuda", 0))
    emit({"phase": "autotune", "case": "binning", "rows_probed": 16384,
          "binning_impl": bd["binning_impl"],
          "device_ms": bd["binning_timings"].get("device", 0.0) * 1e3,
          "host_ms": bd["binning_timings"].get("host", 0.0) * 1e3,
          "key": bd["key"], "nvidia_smi": smi})
    check(bd["binning_impl"] in ("host", "device")
          and set(bd["binning_timings"]) == {"host", "device"},
          f"autotune binning: {bd}")
    tmp.cleanup()


def sklearn_phase(lt, hc, torch, smi, X, y, Xt, yt):
    """The scikit-learn estimators (sklearn.py) on the card, through the
    fallback base where scikit-learn is missing: LGBMClassifier 8 rounds
    on bench's table (its model text's md5 equal to lt.train's with the
    same parameters; predict_proba's held-out AUC printed), LGBMRanker 2
    rounds on the ranking table (MSLR-WEB30K's schema, 2^18 documents);
    then pred_contrib (models/shap.py) on 1024 of the held-out rows of the
    classifier's model: each row's sum equals predict(raw_score=True)
    within 1e-6. (Both cut from 2^20 documents and 4096 rows, so that
    the whole run stays under 900 s.)"""
    from lightgbm_tpu_torch import sklearn as tsk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clf = lt.LGBMClassifier(n_estimators=8, num_leaves=N_LEAVES,
                            max_bin=63, learning_rate=0.1,
                            min_child_samples=20)
    clf.fit(X, y)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    bp = dict(clf.booster_.params)
    ref = lt.train(bp, lt.Dataset(X, label=y, params=bp), num_boost_round=8)
    same = _md5(clf.booster_.model_to_string()) == _md5(
        ref.model_to_string())
    del ref
    proba = clf.predict_proba(Xt)
    auc = _auc(proba[:, 1], yt)
    Xs = Xt[:1024]
    t0 = time.perf_counter()
    contrib = clf.predict(Xs, pred_contrib=True)
    contrib_s = time.perf_counter() - t0
    raw = clf.predict(Xs, raw_score=True)
    err = float(np.max(np.abs(contrib.sum(axis=1) - raw)))
    rx, ry, sizes = _mslr_like(np.random.RandomState(61), N_ROWS // 4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rk = lt.LGBMRanker(n_estimators=2, num_leaves=N_LEAVES, max_bin=255,
                       min_child_samples=20)
    rk.fit(rx, ry, group=sizes)
    torch.cuda.synchronize()
    rank_s = time.perf_counter() - t0
    ndcg = {m: v for _, m, v, _ in rk.booster_.eval_train()}
    emit({"phase": "sklearn", "sklearn_present": tsk._SKLEARN,
          "classifier_fit_s": fit_s, "classes": clf.classes_.tolist(),
          "md5_equal_lt_train": same, "heldout_auc": auc,
          "grow_route": clf.booster_._gbdt.grow_route,
          "pred_contrib_rows": len(Xs), "pred_contrib_s": contrib_s,
          "pred_contrib_shape": list(contrib.shape),
          "contrib_sum_max_abs_err": err, "ranker_fit_s": rank_s,
          "ranker_rows": len(rx), "ranker_train_metrics": ndcg,
          "nvidia_smi": smi})
    check(same, "LGBMClassifier's model differs from lt.train's")
    check(auc > 0.85, f"LGBMClassifier held-out AUC {auc}")
    check(contrib.shape == (len(Xs), N_FEAT + 1) and err <= 1e-6,
          f"pred_contrib rows miss their raw scores by {err}")
    check(rk.booster_.current_iteration == 2 and all(
        np.isfinite(v) for v in ndcg.values()), "LGBMRanker did not train")


def _run_cli(here, cwd, *commands, timeout=300):
    """`python -m lightgbm_tpu_torch args...` in `cwd` for each argument
    list of `commands`, all started together: [(exit code, wall seconds,
    stdout + stderr)] in order."""
    env = {**os.environ, "PYTHONPATH": here}
    env.pop("LIGHTGBM_TPU_FAULT_PLAN", None)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch", *args], cwd=cwd,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for args in commands]
    out = []
    for proc in procs:
        try:
            log, _ = proc.communicate(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out.append((proc.returncode, time.perf_counter() - t0, log))
    return out


def cli_phase(lt, torch, smi, here, X, y):
    """The command line on text files (cli.py, data/loader.py, the native
    parser): see the module docstring's `cli` entry."""
    import tempfile
    from lightgbm_tpu_torch import native
    from lightgbm_tpu_torch.cli import parse_args
    from lightgbm_tpu_torch.data.loader import load_text_file
    from lightgbm_tpu_torch.runtime.checkpoint import verify_manifest
    n_tr, n_va = 1 << 18, 1 << 16
    with tempfile.TemporaryDirectory(prefix="lgbt_cli_") as d:
        t0 = time.perf_counter()
        tr, va = os.path.join(d, "train.tsv"), os.path.join(d, "valid.tsv")
        np.savetxt(tr, np.column_stack([y[:n_tr], X[:n_tr]]),
                   delimiter="\t", fmt="%.9g")
        np.savetxt(va, np.column_stack([y[n_tr:n_tr + n_va],
                                        X[n_tr:n_tr + n_va]]),
                   delimiter="\t", fmt="%.9g")
        write_s = time.perf_counter() - t0
        # the parsers on the valid file: native, then the Python loop
        t0 = time.perf_counter()
        Xv, yv, _, _, _ = load_text_file(va)
        parse_native_s = time.perf_counter() - t0
        parser = native.LAST_PARSER
        os.environ["LIGHTGBM_TPU_DISABLE_NATIVE"] = "1"
        try:
            t0 = time.perf_counter()
            Xp, yp, _, _, _ = load_text_file(va)
            parse_python_s = time.perf_counter() - t0
        finally:
            del os.environ["LIGHTGBM_TPU_DISABLE_NATIVE"]
        check(parser == "native", f"the {parser} parser ran on the card's "
                                  "machine, not the native one")
        check(np.array_equal(Xv, Xp) and np.array_equal(yv, yp),
              "the native parser's arrays differ from the Python loop's")
        check(np.array_equal(Xv.astype(np.float32), X[n_tr:n_tr + n_va]),
              "the text file does not give back the f32 rows")
        model = os.path.join(d, "model.txt")
        prof = os.path.join(d, "profile.json")
        conf = os.path.join(d, "train.conf")
        with open(conf, "w") as f:
            f.write("task = train\nobjective = binary\n"
                    f"data = {tr}\nvalid = {va}\n"
                    f"num_iterations = 8\nnum_leaves = {N_LEAVES}\n"
                    "max_bin = 63\nlearning_rate = 0.1\n"
                    "min_data_in_leaf = 20\nmetric = auc\n"
                    "snapshot_freq = 4\ndevice_profile = true\n"
                    f"profile_output = {prof}\noutput_model = {model}\n"
                    "verbosity = 1\n")
        [(rc_train, train_s, log)] = _run_cli(here, d, [f"config={conf}"])
        check(rc_train == 0, f"CLI training exited {rc_train}: {log[-3000:]}")
        # predict, refit and convert read the model only: side by side
        pred = os.path.join(d, "pred.tsv")
        refit = os.path.join(d, "refit.txt")
        cpp = os.path.join(d, "model.cpp")
        runs = _run_cli(
            here, d,
            ["task=predict", f"data={va}", f"input_model={model}",
             f"output_result={pred}", "verbosity=-1"],
            ["task=refit", f"data={tr}", f"input_model={model}",
             f"output_model={refit}", "verbosity=-1"],
            ["task=convert_model", f"input_model={model}",
             f"convert_model={cpp}", "verbosity=-1"])
        for task, (rc, _, out) in zip(("predict", "refit", "convert"),
                                      runs):
            check(rc == 0, f"CLI {task} exited {rc}: {out[-3000:]}")
        (rc_pred, pred_s, _), (rc_refit, refit_s, _), \
            (rc_conv, conv_s, _) = runs

        # the same run in process, on load_text_file's arrays
        params = parse_args([f"config={conf}"])
        first = []

        def stamp(env):
            if not first:
                torch.cuda.synchronize()
                first.append(time.perf_counter())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Xt, yt, _, _, names = load_text_file(tr)
        ds = lt.Dataset(Xt, label=yt, feature_name=names)
        dv = ds.create_valid(Xv, label=yv)
        bst = lt.train(params, ds, num_boost_round=8, valid_sets=[dv],
                       valid_names=["valid.tsv"], callbacks=[stamp])
        file_to_first_round_s = first[0] - t0
        with open(model) as f:
            text = f.read()
        same_model = _md5(text) == _md5(bst.model_to_string())
        got = np.loadtxt(pred)
        same_pred = got.shape == (n_va,) and np.array_equal(
            got, bst.predict(Xv))
        snaps = {it: verify_manifest(f"{model}.snapshot_iter_{it}.txt")
                 for it in (4, 8)}
        with open(prof) as f:
            profile = json.load(f)
        with open(refit) as f:
            refit_trees = f.read().count("Tree=")
        with open(cpp) as f:
            cpp_bytes = len(f.read())
        auc = [v for _, m, v, _ in bst.eval_valid() if m == "auc"]
    emit({"phase": "cli", "train_rows": n_tr, "valid_rows": n_va,
          "features": N_FEAT, "reduced": "2^18 training rows of the 2^20 "
          "(writing a 2^20-row text file costs most of the line's time)",
          "write_s": write_s, "parse_rows": n_va,
          "parse_native_s": parse_native_s, "parse_python_s": parse_python_s,
          "parser": parser, "file_to_first_round_s": file_to_first_round_s,
          "cli_train_wall_s": train_s, "cli_predict_wall_s": pred_s,
          "cli_refit_wall_s": refit_s, "cli_convert_wall_s": conv_s,
          "concurrent": ["predict", "refit", "convert"],
          "exit_codes": [rc_train, rc_pred, rc_refit, rc_conv],
          "md5_equal_lt_train": same_model, "prediction_file_equal": same_pred,
          "snapshot_manifests": {str(k): v[0] for k, v in snaps.items()},
          "profile_records": len(profile.get("ring", [])),
          "profile_n_iters": profile.get("n_iters"),
          "native_parser_in_log": "native parser" in log,
          "grow_route": bst._gbdt.grow_route,
          "binning_route": ds._handle.binning_route, "valid_auc": auc,
          "refit_trees": refit_trees, "cpp_bytes": cpp_bytes,
          "nvidia_smi": smi})
    check(same_model, "the CLI's model differs from lt.train's")
    check(same_pred, "the prediction file differs from Booster.predict")
    check(all(ok for ok, _ in snaps.values()),
          f"a snapshot manifest failed: {snaps}")
    check(profile.get("n_iters") == 8 and len(profile.get("ring", [])) == 8,
          "the profile does not hold 8 iteration records")
    check("native parser" in log, "the CLI's log does not name the native "
                                  "parser")
    check(refit_trees == 8 and cpp_bytes > 0, "refit or convert wrote no "
                                              "model")


_RESILIENCE_CHILD = """\
import json, sys
import numpy as np
import lightgbm_tpu_torch as lt
X = np.load(sys.argv[1])
y = np.load(sys.argv[2])
params = json.loads(sys.argv[3])
lt.train(params, lt.Dataset(X, label=y, params=params), 16)
"""


def resilience_phase(lt, torch, smi, here, params, ds, X, y):
    """Checkpoints, a killed and a corrupted run resumed (runtime/
    checkpoint.py, runtime/faults.py): see the module docstring's
    `resilience` entry."""
    import tempfile
    from lightgbm_tpu_torch.runtime.checkpoint import (
        CheckpointManager, capture_trainer_state, load_checkpoint,
        restore_trainer_state, verify_manifest)
    p = dict(params, batched_train=True, bagging_fraction=0.8,
             bagging_freq=1)

    def timed(over, rounds=16):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = lt.train({**p, **over}, ds, num_boost_round=rounds)
        torch.cuda.synchronize()
        return b, (time.perf_counter() - t0) * 1e3 / rounds

    with tempfile.TemporaryDirectory(prefix="lgbt_ckpt_") as d:
        def ck(name, **kw):
            return dict(checkpoint_interval=4,
                        checkpoint_dir=os.path.join(d, name), **kw)
        plain, plain_ms = timed({})
        full, full_ms = timed(ck("a"))
        md5_plain, md5_a = _md5(plain.model_to_string()), _md5(
            full.model_to_string())
        veto_a = full._gbdt.batched_veto
        # one save, timed: the state's capture and its atomic write
        mgr = CheckpointManager(os.path.join(d, "timed"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = mgr.save(capture_trainer_state(full._gbdt), 16)
        save_ms = (time.perf_counter() - t0) * 1e3
        save_bytes = os.path.getsize(path)
        del plain
        # (b) a child killed at iteration 10
        xp, yp = os.path.join(d, "X.npy"), os.path.join(d, "y.npy")
        np.save(xp, X)
        np.save(yp, y)
        child = os.path.join(d, "child.py")
        with open(child, "w") as f:
            f.write(_RESILIENCE_CHILD)
        env = {**os.environ, "PYTHONPATH": here}
        env.pop("LIGHTGBM_TPU_FAULT_PLAN", None)
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, child, xp, yp,
             json.dumps({**p, **ck("b", fault_plan="kill@iter=10")})],
            env=env, capture_output=True, text=True, timeout=600)
        kill_s = time.perf_counter() - t0
        left = [it for it, _ in CheckpointManager(
            os.path.join(d, "b")).checkpoints()]
        check(r.returncode == 17, f"the killed child exited {r.returncode}:"
                                  f" {(r.stdout + r.stderr)[-3000:]}")
        check(left[-1:] == [8], f"the killed run left checkpoints {left}")
        # resume costs: load the state, restore it into a fresh trainer
        t0 = time.perf_counter()
        state = load_checkpoint(os.path.join(d, "b"))
        load_ms = (time.perf_counter() - t0) * 1e3
        fresh = lt.Booster(params=p, train_set=ds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore_trainer_state(fresh._gbdt, state)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        del fresh, state
        # (c) resumed from (b)
        resumed, _ = timed(ck("c", resume_from_checkpoint=os.path.join(
            d, "b")))
        md5_c = _md5(resumed.model_to_string())
        veto_c = resumed._gbdt.batched_veto
        del resumed
        # (d) iteration 8's checkpoint corrupted, resumed from 4
        timed(ck("d", fault_plan="corrupt_snapshot@iter=8"), rounds=10)
        ok8, why8 = verify_manifest(CheckpointManager(
            os.path.join(d, "d")).path_for(8))
        fallback = load_checkpoint(os.path.join(d, "d"))["iteration"]
        d2, _ = timed(ck("d2", resume_from_checkpoint=os.path.join(d, "d")))
        md5_d = _md5(d2.model_to_string())
        del d2, full
    emit({"phase": "resilience", "rows": N_ROWS, "features": N_FEAT,
          "leaves": N_LEAVES, "rounds": 16, "checkpoint_interval": 4,
          "bagging": [0.8, 1], "md5_equal": {
              "uninterrupted_vs_plain": md5_a == md5_plain,
              "killed_resumed_vs_uninterrupted": md5_c == md5_a,
              "corrupt_resumed_vs_uninterrupted": md5_d == md5_a},
          "batched_veto": [veto_a, veto_c], "kill_exit_code": r.returncode,
          "kill_child_s": kill_s, "checkpoints_left_by_kill": left,
          "corrupt_manifest_ok": ok8, "corrupt_reason": why8,
          "corrupt_fallback_iteration": fallback, "save_ms": save_ms,
          "save_bytes": save_bytes, "load_ms": load_ms,
          "restore_ms": restore_ms,
          "batched_ms_per_round_plain": plain_ms,
          "batched_ms_per_round_checkpointed": full_ms,
          "nvidia_smi": smi})
    check(veto_a == "" and veto_c == "", "a checkpointed run did not batch")
    check(md5_a == md5_plain, "checkpoints changed the model")
    check(md5_c == md5_a, "the killed run's resume differs")
    check(not ok8 and fallback == 4, "the corrupt checkpoint was not "
                                     "skipped")
    check(md5_d == md5_a, "the corrupt run's resume differs")


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    try:
        import lightgbm_tpu_torch as lt
        from lightgbm_tpu_torch.ops import bucketize as bk
        from lightgbm_tpu_torch.ops import grow_fused as gf
        from lightgbm_tpu_torch.ops import histogram_cuda as hc
        from lightgbm_tpu_torch.ops import histogram_rowwise as hr
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
    regs = {n: _ptxas(b["log"]) for n, b in built.items()}
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "ptxas": regs})

    # ---- 2. training kernels against their plain versions
    krec = kernel_phase(hc, torch, dev)
    variant_phase(hc, torch, dev)

    # ---- 3. ingest bench.py's data: binning_impl=auto -> device route
    rng = np.random.RandomState(42)
    X = rng.normal(size=(N_ROWS, N_FEAT)).astype(np.float32)
    w = rng.normal(size=N_FEAT)
    y = (X @ w + rng.normal(scale=0.5, size=N_ROWS) > 0).astype(np.float32)
    params = dict(objective="binary", num_leaves=N_LEAVES, max_bin=63,
                  learning_rate=0.1, min_data_in_leaf=20, verbose=-1,
                  bagging_freq=0, binning_impl="auto", device_type="cuda",
                  metric="auc",
                  batched_train=False)
    hc.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = lt.Dataset(X, label=y, params=params).construct()
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    ingest_launches = dict(hc.LAUNCHES)
    t0 = time.perf_counter()
    ds_host = lt.Dataset(X, label=y, params={
        **params, "binning_impl": "host"}).construct()
    torch.cuda.synchronize()
    ingest_host_s = time.perf_counter() - t0
    h, hh = ds._handle, ds_host._handle
    same_xt = torch.equal(h.X_t, hh.X_t)
    emit({"phase": "ingest", "rows": N_ROWS, "features": N_FEAT,
          "route": h.binning_route, "ingest_s": ingest_s,
          "ingest_host_route_s": ingest_host_s,
          "bucketize_launches": ingest_launches["bucketize"],
          "launches": ingest_launches, "X_t_bitwise_host_route": same_xt})
    check(h.binning_route == "device", "binning_impl=auto did not take the "
                                       "device route on the card")
    check(ingest_launches["bucketize"] > 0,
          "ingest never launched the bucketize kernel")
    check(same_xt and np.array_equal(h.X_binned, hh.X_binned),
          "device-route X_t differs from the host route")
    del ds_host, hh

    # ---- 4. the bucketize kernel against its plain version
    brec = bucketize_phase(bk, torch, dev, X, h, np.random.RandomState(44))

    # ---- 5. train bench.py's model
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
          "iterations": len(iter_ms), "iter_ms": iter_ms,
          "steady_ms_per_iter": float(np.mean(iter_ms[1:])),
          "launches": launches, "train_auc": auc, "leaves": leaves})
    for name in ("build_histogram_slots", "take_leaf_values", "wave_pass",
                 "wave_relabel"):
        check(launches[name] > 0, f"{name} never launched on the main path")
    # the score update is one launch of the in-place kernel per tree
    check(launches["take_leaf_values"] == len(iter_ms),
          f"take_leaf_values launched {launches['take_leaf_values']} times "
          f"in {len(iter_ms)} rounds")
    # 8 rounds on 2^20 rows reach a train AUC near 0.886 (both packages
    # agree on smaller cuts of this data); 8 more rounds through
    # update_batch, after the serve phase, must pass 0.9
    check(len(leaves) == 8 and auc > 0.88, f"train AUC {auc} <= 0.88")

    # the first tree again, from the same gradients, with the plain
    # versions on the card: kernels and plain versions accumulate in f64,
    # so the histograms and therefore the trees must agree
    t_kern = trees[0]
    lv_err = _same_host_tree(_plain_trees(torch, gbdt, N_ROWS)[0], t_kern)
    emit({"phase": "first_tree", "same_structure": lv_err is not None,
          "leaves": t_kern.num_leaves, "leaf_value_max_abs_err": lv_err})
    check(lv_err is not None, "first tree differs from the plain versions' "
                              "tree")
    # leaf values come from the same f32 split statistics: 1e-6 absolute
    check(lv_err <= 1e-6, f"first tree leaf values differ by {lv_err}")

    # ---- 6. predict held-out rows, then again after a model text trip
    rng_t = np.random.RandomState(43)
    Xt = rng_t.normal(size=(4096, N_FEAT)).astype(np.float32)
    yt = (Xt @ w + rng_t.normal(scale=0.5, size=4096) > 0)
    t0 = time.perf_counter()
    p1 = bst.predict(Xt)
    predict_ms = (time.perf_counter() - t0) * 1e3
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
    emit({"phase": "predict", "rows": 4096, "predict_ms": predict_ms,
          "roundtrip_bitwise": True, "score_max_abs_err": score_err,
          "heldout_auc": _auc(p1, yt), "model_text_bytes": len(text)})

    # ---- 7. serve on the card
    serve_launches = serve_phase(lt, hc, torch, bst, X, Xt)

    # ---- 8. train on: 8 more rounds of the same booster
    bst.update_batch(8)
    auc16 = bst.eval_train()[0][2]
    emit({"phase": "train_on", "iterations": bst.current_iteration,
          "train_auc": auc16})
    check(bst.current_iteration == 16 and auc16 > 0.9,
          f"train AUC after 16 rounds {auc16} <= 0.9")

    # ---- 10. the fused routes, bench half: kernel #9, then bench.py's
    # model under histogram_impl=fused
    krec["wave_pass_fused"] = fused_narrow_phase(hc, gf, torch, dev)
    fused_launches = fused_train_phase(lt, hc, torch, params, ds)

    # ---- 9. the wave-apply route: the wave_apply kernel, the Criteo
    # table trained col-wise, row-wise and nibble-packed, served, and EFB;
    # and the fused routes' Criteo half: kernel #10 and the Criteo table
    # under histogram_impl=fused
    bst_c, ds_c, c_launches = criteo_phase(lt, hc, torch, dev)
    g_c = bst_c._gbdt
    apply_storages = [_numeric_storage(torch, gbdt.X_t, dev),
                      ("criteo", g_c.X_t, g_c.meta, g_c.grow_cfg)]
    krec["wave_pass_fused_tiled"] = fused_tiled_phase(hc, gf, torch, dev,
                                                      bst_c._gbdt.X_t)
    cf_launches = criteo_fused_phase(lt, hc, torch, bst_c.params, ds_c)

    # ---- 11. the constraints: kernel #10 with its monotone operand live,
    # then the bench model under monotone constraints and the Criteo table
    # under interaction sets, each on its non-fused and its fused route
    constraints_kernel_phase(hc, gf, torch, dev, bst_c._gbdt.X_t)
    constraints_train_phase(lt, hc, torch, params, ds, w, trees[0])
    constraints_criteo_phase(lt, hc, torch, bst_c.params, ds_c)
    # monotone intermediate, then forced splits and CEGB, on the two-pass
    # routes ("mega" for bench, "apply" for Criteo)
    intermediate_phase(lt, hc, torch, smi, params, ds, w, bst_c.params,
                       ds_c)
    forced_cegb_phase(lt, hc, torch, smi, params, ds, X, bst_c.params, ds_c)

    # ---- 12. quantized gradients on every wave route, and row sampling
    quantized_phase(lt, hc, hr, gf, torch, dev, params, ds, bst_c.params,
                    ds_c)
    sampling_phase(lt, hc, torch, params, ds)
    h_c = ds_c._handle
    krec.update(rowwise_phase(hc, hr, torch, dev, bst_c._gbdt.X_t,
                              h_c.storage_num_bins(),
                              bst_c._gbdt.num_bins_padded))
    rw_launches = rowwise_runs_phase(lt, hc, torch, bst_c, ds_c)
    criteo_serve_phase(hc, torch, bst_c)
    params_criteo, ds_criteo = bst_c.params, ds_c
    del bst_c, ds_c, h_c, g_c
    apply_storages.append(efb_phase(lt, hc, torch))
    narrow_cat_phase(lt, hc, torch)
    krec["wave_apply"] = wave_apply_phase(hc, torch, dev, apply_storages)
    del apply_storages

    # ---- 13. every objective, multiclass [K, N] scores, ranking, and
    # per-node sampling
    multiclass_phase(lt, hc, torch, dev, X, w, smi)
    objectives_phase(lt, hc, torch, X, w, ds, smi)
    bynode_xt_phase(lt, hc, torch, dev, params, ds, smi)
    rank_phase(lt, hc, torch, dev, smi)

    # ---- 14. the training loop: init_model, a late valid set, fobj /
    # feval, reset_parameter, refit
    continued_phase(lt, hc, torch, dev, smi, params, ds, X, y, w)

    # ---- 15. random forests, DART, linear trees, rollback_one_iter
    boosting_modes_phase(lt, hc, torch, smi, params, ds, X, y, w)

    # ---- 16. the serial growers, strict leaf-wise order, the ladder
    serial_growers_phase(lt, hc, torch, smi, params, ds, X, params_criteo,
                         ds_criteo)

    # ---- 17. batched training, lt.train's default path, beside the
    # per-iteration path
    batched_phase(lt, hc, torch, smi, params, ds, X, w, params_criteo,
                  ds_criteo)

    # ---- 18. the runtime: device_profile and autotune; the estimators
    # and SHAP values
    profile_phase(lt, hc, torch, smi, params, ds, bst, Xt)
    autotune_phase(lt, hc, torch, smi, params, ds, params_criteo, ds_criteo)
    del ds_criteo
    sklearn_phase(lt, hc, torch, smi, X, y, Xt, yt)

    # ---- 19. more than 256 bins a feature: uint16 storage through #1 and
    # #4 on the apply route and the compact grower; the compact grower's
    # window operations (#1 over a window, the partition kernel)
    wide_hist, wide_apply, wide, rank_launches = wide_bins_phase(
        lt, hc, torch, dev, smi, X, y)
    krec["window_partition"] = window_phase(
        hc, torch, dev, [("bench", gbdt.X_t, gbdt.num_bins_padded)]
        + wide[:1] + wide[-1:])
    del wide

    # ---- 20. text files through the command line; checkpoints, resume
    # and fault plans
    cli_phase(lt, torch, smi, here, X, y)
    resilience_phase(lt, torch, smi, here, params, ds, X, y)

    src = {"build_histogram_slots": "hist_slots.cu",
           "take_leaf_values": "take_leaf_values.cu",
           "wave_pass": "wave_pass.cu", "wave_relabel": "wave_relabel.cu",
           "bucketize": "bucketize.cu", "wave_apply": "wave_apply.cu",
           "hist_rowwise": "hist_rowwise.cu",
           "hist_rowwise_packed": "hist_rowwise.cu",
           "wave_pass_fused": "wave_pass_fused.cu",
           "wave_pass_fused_tiled": "wave_pass_fused_tiled.cu",
           "window_partition": "window_partition.cu"}
    replaces = {
        "build_histogram_slots":
            "lightgbm_tpu/ops/histogram_pallas.py:280",
        "take_leaf_values": "lightgbm_tpu/ops/histogram_pallas.py:340",
        "wave_pass": "lightgbm_tpu/ops/histogram_pallas.py:562",
        "wave_relabel": "lightgbm_tpu/ops/histogram_pallas.py:718",
        "bucketize": "lightgbm_tpu/ops/bucketize.py:351",
        "wave_apply": "lightgbm_tpu/ops/histogram_pallas.py:658",
        "hist_rowwise": "lightgbm_tpu/ops/histogram_rowwise.py:213",
        "hist_rowwise_packed": "lightgbm_tpu/ops/histogram_rowwise.py:431",
        "wave_pass_fused": "lightgbm_tpu/ops/grow_fused.py:356",
        "wave_pass_fused_tiled": "lightgbm_tpu/ops/grow_fused.py:656",
        # an XLA partition there, no pallas_call: the port's kernel for the
        # batched compact step
        "window_partition": "lightgbm_tpu/ops/grow_fast.py:218"}
    krec["bucketize"] = brec["train"]
    # the bucketize kernel's main-path launches: ingest plus serving
    launches["bucketize"] = ingest_launches["bucketize"] \
        + serve_launches["bucketize"]
    # the apply route's kernels: launches on the Criteo run that takes them
    launches["wave_apply"] = c_launches["wave_apply"]
    for name in ("hist_rowwise", "hist_rowwise_packed"):
        launches[name] = rw_launches[name][name]
    # the fused routes' kernels: launches on the runs that take them
    launches["wave_pass_fused"] = fused_launches["wave_pass_fused"]
    launches["wave_pass_fused_tiled"] = cf_launches["wave_pass_fused_tiled"]
    # the partition kernel's launches on the ranking table's compact run
    launches["window_partition"] = rank_launches["window_partition"]
    # uint16 storage past 256 bins: #1 at the bench and Criteo roots, #4 on
    # the Criteo storage at Kd = 128
    wide_rec = {"build_histogram_slots": wide_hist,
                "wave_apply": {"criteo_u16": wide_apply}}
    kernels = []
    for name in hc.KERNELS:
        r = krec[name]
        uint16 = {n: {k: w[k] for k in ("ms", "device_ms", "plain_ms",
                                        "bound_ms", "bound_by", "library_ms",
                                        "K", "Kd", "F", "B", "rows", "N")
                      if k in w}
                  for n, w in wide_rec.get(name, {}).items()}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"lightgbm_tpu_torch/csrc/{src[name]}",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_device_ms": r.get("library_device_ms"),
            "launches_per_call": r.get("launches_per_call"),
            "shape": {k: r[k] for k in ("K", "Kd", "L", "n", "F", "B",
                                        "total", "rows") if k in r},
            "uint16": uint16 or None, "pass": True})
    emit({"kernels": kernels})
    for line in smi:
        print(line)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
