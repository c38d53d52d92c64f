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
                     tree, ms per round, train logloss beside basic's;
                     63 leaves (the serialized waves' depth cut)
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
                     0-4, queries of 64-256 documents), 2^19 documents
                     (cut from 2^20 so that the run fits its time),
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
     serial_growers  bench.py's model and table at 127 leaves (cut from
                     255), 2 rounds each of
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
                     (2^17 documents); pred_contrib of 512 held-out
                     rows (both cut so that the later lines fit the
                     run's time), each row's sum within
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
     cli             bench.py's table cut to 2^17 training rows and a
                     2^15-row valid file (a 2^20-row text file would cost
                     most of the line's time), written as TSV with %.9g
                     (f32 round-trips); `python -m lightgbm_tpu_torch
                     config=train.conf` on the card, 8 rounds, metric=auc,
                     snapshot_freq=4, device_profile with profile_output;
                     then task=predict on the valid file, task=refit and
                     task=convert_model (cpp) and task=serve with its
                     defaults (the device engine behind the default
                     breaker, the valid file through the micro-batcher),
                     these four side by side (each reads the model only):
                     every exit code 0, the serve file within 1e-6 of
                     Booster.predict with no host fallback and the breaker
                     closed in its metrics file, the
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

 21. past the leaf cap (after the batched lines):
     leaf_cap_kernels  #2, #3, #4, #5, #9 and #10 (their global leaf
                     maps) on a mid-tree wave of 2^20 rows whose leaf ids
                     are spread over [0, L), L = 8192 and 131072:
                     bitwise against their plain versions on grid values
                     and against the same wave under L = 255 (the shared
                     maps), timed beside it (`ms_255`)
     leaf_cap        bench at 16384 leaves on the wave grower, 2 rounds
                     per iteration and batched (md5 equal, more than 4096
                     leaves a tree); Criteo at 8192 on apply and bench at
                     8192 under fused, 1 round each; every first tree
                     equal to the plain versions'

 22. overload: bench.py's model behind the registry, batcher,
     admission and breaker with fail_score / slow_score / wedge_worker
     and the HTTP server on 127.0.0.1:0 (overload_phase)

 23. A18(b)'s rest (last): bench.py's model, the Criteo model and the
     5-class softmax model as serving tenants, from their model texts
     and mappers (one line each, with the card's name and power limit):
     stacked_bucketize  the stacked bucketize kernel on 4096 Zipf-mixed
                     rows of the three tenants against their stacked serve
                     tables: bitwise its plain version and each tenant's
                     own #6 bins; device / call / plain ms, the bound, and
                     torch.searchsorted over the gathered table rows
     fleet           ModelFleet (binned sessions, max_batch 256) under 8
                     client threads of 400 Zipf-mixed single f32 rows,
                     unfused then fused=True: every answer bitwise its
                     tenant's session, fused equal to unfused, no host
                     fallback, #6 launched unfused and the stacked kernel
                     fused; one hot swap republishes the supertensor;
                     per-tenant p50 / p99, batches, tenant switches, the
                     rebuild seconds
     export          the bench and Criteo models exported (torch.export
                     programs of 128 and 256 rows) and loaded on the card:
                     predict of 4096 rows bitwise Booster.predict, the
                     compiled engine (#6, then the program) bitwise the
                     binned engine; export and load seconds, artifact
                     bytes, a 256-row bucket's ms beside the binned walk's
     fleet_cli       `python -m lightgbm_tpu_torch task=serve
                     serve_models=...` on 127.0.0.1: both tenants' routes
                     within 1e-6 of Booster.predict, /metrics, /healthz,
                     404 for an unknown tenant, a clean exit on SIGINT

 24. A13, streaming and the online loop (last; bench's table, model and
     Dataset, 28 features, 255 leaves, max_bin 63):
     streaming       2^20 f32 rows pushed in 16 chunks of 2^16 (one out
                     of order) into a streaming Dataset: #6 once a chunk,
                     X_t and X_binned bitwise the bulk Dataset(X,
                     reference=...); the f64 copy on the host route
                     bitwise too; warm_continue of 2 trees on a 2^18-row
                     f32 window launches #6 and the route's kernels; push
                     seconds beside the bulk ingest's
     online          a 2^18-row trace in 64 batches, a 2^17-row window
                     refreshed every 32768 rows (6 refits, 2 continues of
                     4 trees) published into a co-located binned session
                     under 4 client threads: summary, manifests, md5 of
                     every snapshot against its offline arm, every answer
                     within 1e-6 of a live generation's Booster.predict,
                     no failed request or host fallback, the first
                     continued tree the plain versions'; a child killed
                     at kill@iter=5 (exit 17) resumed to the same bytes;
                     stall_source / corrupt_batch; task=online by the CLI
                     (online_phase's docstring has the details)

 25. A16, multi-device training (last; bench's model at full width):
     distributed     two rank processes (launch_local; this script's
                     `dist_rank`) of one gloo group on cuda:0, the
                     collectives staged through host buffers, each
                     ingesting bench's 2^20 x 28 table through #6 and
                     keeping its row block: data-parallel 4 rounds under
                     allreduce and under reduce_scatter, quantized 2 under
                     each (and on 4096 rows, where the (grad, hess) pair
                     crosses as one packed lane), feature 2, voting
                     (top_k 20) 2, pre_partition 2 (each rank its 2^19
                     rows, binning its 14 features), and
                     fail_collective@iter=1:times=2 in rank 1's parameters
                     only, under reduce_scatter 4
                     (device_profile: the straggler report). Checks: every
                     rank's model text (minus its parameter lines)
                     md5-equal; the modes md5-equal (float, quantized,
                     packed); the degraded run md5-equal to reduce_scatter,
                     every rank's mode allreduce after 2 failures and a pinned
                     _mesh2 decision in its autotune cache; tree 0 of the
                     data- and feature-parallel runs the single process's
                     or parting from it only at gains within 1e-5
                     relative; the plain versions' first tree over the
                     group equal to the kernels'; train AUC after 4 rounds
                     within 1e-3 of the single process's; #1 / #2 / #3 /
                     #5 (#4 under feature) launched on every rank, #6 in
                     every rank's ingest. Then a group whose rank 1 runs
                     kill@iter=2: the launcher raises naming exit code 17
                     within time_out + 30 s of the last round, no worker
                     left; and a two-shard device session on the one card
                     warns, runs unsharded and scores bitwise its twin.
                     Records ms a round beside the single process's, the
                     exchange's share of a round (this rank's seconds in
                     collectives over the run's), bytes a tree, the comm
                     probe's two timings

then a {"kernels": [...]} line (the twelve kernels, #1 and #4 with their
uint16 times, the six changed by the leaf cap with their `leaf_cap`
times, the stacked bucketize with its fused-fleet launches), the
nvidia-smi line,
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


_T0 = time.perf_counter()


def emit(obj):
    """Print one JSON line; a phase's line carries the seconds since the
    script started (`at_s`), so the run's time splits by phase."""
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - _T0, 1)}
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


def timings(fn, reps, warmup=2, stats=None, floor_ms=None):
    """(ms, device_ms) of fn(): `ms` is time_ms's mean call time over
    `reps` back-to-back calls, which includes the host's issue rate where
    that is the slower side; `device_ms` is the sum of the device's
    activity (kernels and memsets) per call under torch.profiler over
    another `reps` calls. A session now and then records no device
    activity, or only part of it, so two sessions that saw some are run
    (at most eight in all) and the larger is kept; with `floor_ms` (the
    work's bound) a session counts only where its time a call reaches
    the floor, and none doing so fails the run. With `stats` (a dict)
    the kept session's kernel launches per call, memsets not counted,
    are stored under "kernels_per_call"."""
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
        if floor_ms is not None and us / 1e3 / reps < floor_ms:
            continue
        if us > best_us:
            best_us = us
            best_n = sum("memset" not in ev.name.lower() for ev in dev)
        seen += us > 0
        if seen == 2:
            break
    check(best_us > 0, "torch.profiler saw no device activity"
          + ("" if floor_ms is None else f" reaching the bound {floor_ms} "
             "ms a call") + " in 8 sessions")
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
    its plain version. Returns the launches by case and the softmax model
    as (model text, mappers)."""
    from lightgbm_tpu_torch.ops.predict_binned import mappers_for
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
            tenant = (bst.model_to_string(), mappers_for(g))
        emit(rec)
        out[case] = launches
        del bst, g, trees
    return out, tenant


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
    of 64-256 documents), synthetic from a seed, 2^19 documents (cut from
    2^20 so that the run fits its time),
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
    n_docs = N_ROWS // 2
    X, y, sizes = _mslr_like(rng, n_docs)
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
    m0.init(md, n_docs)
    ndcg0 = {k: float(v) for k, v, _ in m0.eval(np.zeros(n_docs), None)}
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
        rec = {"phase": "rank", "objective": obj, "rows": n_docs,
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
            lv_err = _first_iteration_err(torch, g, n_docs, trees[:1])
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
    (#4, #1). Both at 63 leaves (cut from 255: intermediate serializes
    the waves, about one a split, and the plain versions' first tree
    walked 255 of them on 2^20 rows, most of the line's time). Each: first
    tree equal to the plain versions', raw scores
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
                 "num_leaves": 63, "monotone_constraints": mono,
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
    (phase 16). Every run of the line, the wave reference and the ladder
    included, grows 127 leaves (cut from 255: the serial growers'
    per-iteration splits and the plain versions' first trees over them
    were most of the line's time, and its batched masked / compact lines'
    too)."""
    from lightgbm_tpu_torch.utils.synthetic import criteo_like
    params = {**params, "num_leaves": 127}
    params_c = {**params_c, "num_leaves": 127}
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
    # cache (L the line's 127 leaves, F = 28, B = 64)
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
    rounds on the ranking table (MSLR-WEB30K's schema, 2^17 documents);
    then pred_contrib (models/shap.py) on 512 of the held-out rows of the
    classifier's model: each row's sum equals predict(raw_score=True)
    within 1e-6. (Both cut from 2^20 documents and 4096 rows, so that
    the whole run stays in its time.)"""
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
    Xs = Xt[:512]
    t0 = time.perf_counter()
    contrib = clf.predict(Xs, pred_contrib=True)
    contrib_s = time.perf_counter() - t0
    raw = clf.predict(Xs, raw_score=True)
    err = float(np.max(np.abs(contrib.sum(axis=1) - raw)))
    rx, ry, sizes = _mslr_like(np.random.RandomState(61), N_ROWS // 8)
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
    n_tr, n_va = 1 << 17, 1 << 15
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
        served = os.path.join(d, "served.tsv")
        serve_m = os.path.join(d, "serve_metrics.json")
        runs = _run_cli(
            here, d,
            ["task=predict", f"data={va}", f"input_model={model}",
             f"output_result={pred}", "verbosity=-1"],
            ["task=refit", f"data={tr}", f"input_model={model}",
             f"output_model={refit}", "verbosity=-1"],
            ["task=convert_model", f"input_model={model}",
             f"convert_model={cpp}", "verbosity=-1"],
            # task=serve with its defaults: the device engine behind the
            # default breaker (serve_breaker_failures=3)
            ["task=serve", f"data={va}", f"input_model={model}",
             f"output_result={served}", f"serve_metrics_output={serve_m}",
             "verbosity=-1"])
        for task, (rc, _, out) in zip(("predict", "refit", "convert",
                                       "serve"), runs):
            check(rc == 0, f"CLI {task} exited {rc}: {out[-3000:]}")
        (rc_pred, pred_s, _), (rc_refit, refit_s, _), \
            (rc_conv, conv_s, _), (rc_serve, serve_s, _) = runs
        with open(serve_m) as f:
            serving = json.load(f)["serving"]
        got_serve = np.loadtxt(served)

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
        serve_err = float(np.abs(got_serve - bst.predict(Xv)).max()) \
            if got_serve.shape == (n_va,) else None
    serve = {"wall_s": serve_s, "rows": n_va,
             # written on a transition only: None = never left closed
             "breaker_state": serving.get("states", {}).get("breaker"),
             "breaker_trips": serving["counters"]["breaker_trips"],
             "host_fallbacks": serving["counters"]["host_fallbacks"],
             "batches": serving["counters"]["batches"],
             "file_equal_predict": bool(np.array_equal(got_serve, got)),
             "max_abs_err_predict": serve_err}
    emit({"phase": "cli", "train_rows": n_tr, "valid_rows": n_va,
          "features": N_FEAT, "reduced": "2^17 training rows of the 2^20 "
          "(writing a 2^20-row text file costs most of the line's time)",
          "write_s": write_s, "parse_rows": n_va,
          "parse_native_s": parse_native_s, "parse_python_s": parse_python_s,
          "parser": parser, "file_to_first_round_s": file_to_first_round_s,
          "cli_train_wall_s": train_s, "cli_predict_wall_s": pred_s,
          "cli_refit_wall_s": refit_s, "cli_convert_wall_s": conv_s,
          "concurrent": ["predict", "refit", "convert", "serve"],
          "exit_codes": [rc_train, rc_pred, rc_refit, rc_conv, rc_serve],
          "serve_default": serve,
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
    check(serve["breaker_state"] in (None, "closed")
          and serve["breaker_trips"] == 0 and serve["host_fallbacks"] == 0
          and serve["batches"] > 0 and serve_err is not None
          and serve_err <= 1e-6,
          f"task=serve with its default breaker: {serve}")


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


def _spread_map(torch, rng, L, first_new, dev):
    """[first_new + 256] int64: a small tree's leaf ids spread over [0, L),
    the old leaves [0, first_new) to distinct ids drawn from [0, L - 256),
    the new leaves first_new + j (right children, consecutive ids) to
    L - 256 + j, so that a relabel commutes with the map."""
    base = L - 256
    old = rng.choice(base, first_new, replace=False)
    return torch.from_numpy(np.concatenate([old, base + np.arange(256)])) \
        .to(dev)


def _spread_leaves(torch, m, leaves):
    """Leaf ids (-1 inactive) through the map m."""
    return torch.where(leaves >= 0, m[leaves.clamp(min=0).long()],
                       -1).to(torch.int32)


def _spread_table(torch, m, t):
    """A wave table whose leaf rows (0, 7) and first new leaf (15) went
    through the map m."""
    t = t.clone()
    for r in (0, 7):
        t[r] = _spread_leaves(torch, m, t[r])
    t[15] = int(m[int(t[15, 0])])
    return t


LEAF_CAP_LS = (8192, 131072)


def leaf_cap_kernels(hc, gf, torch, dev):
    """#2, #3, #4, #5, #9 and #10 past the leaf cap: a mid-tree wave of the
    kernel phases' shapes (2^20 rows, the bench storage; 64 applied splits
    among 120 leaves, K = 16 candidates (#4: Kd = 128; #10 with a pending
    relabel of 8 leaves)) whose leaf ids are spread over [0, L) for L in
    {8192, 131072}, bitwise against the plain versions on grid values, and
    timed beside the same wave on its own leaf ids under L = 255 (the
    shared-memory maps). Returns {kernel: {L: record}}."""
    gen = torch.Generator(device=dev).manual_seed(31)
    rng = np.random.RandomState(32)
    N, F, B, C = N_ROWS, N_FEAT, N_BINS, N_CH
    X = torch.randint(0, 63, (F, N), generator=gen, device=dev,
                      dtype=torch.uint8)
    grid = _grid_vals(torch, gen, C, N, dev)
    hp = _fused_hp()
    S = N_LEAVES
    nl0, napp, K, Kd = 120, 64, 16, 128
    lor = torch.randint(0, nl0, (N,), generator=gen, device=dev,
                        dtype=torch.int32)
    t16 = _wave_table(torch, rng, F, B - 1, nl0, napp, K, dev)
    t128 = _wave_table(torch, rng, F, B - 1, nl0, napp, Kd, dev)
    # #9's operands from the real rows of the small wave
    new_s, slot_small = hc.wave_member_plain(X, lor, t16, K)
    slot_all = hc._entry_of(new_s, t16[7, :K]).to(torch.int32)
    sil = t16[14, :K] != 0
    parent, scal = _fused_operands(torch, hc, X, grid, slot_all, slot_small,
                                   sil, K, B)
    fmeta = torch.tensor(np.stack([np.full(F, B - 1), rng.randint(0, 3, F),
                                   rng.randint(0, B - 1, F), np.zeros(F),
                                   np.zeros(F)]),
                         dtype=torch.int32, device=dev)
    fmask = torch.ones(F, dtype=torch.uint8, device=dev)
    # #10: a deferred wave split 8 of the 120 leaves into 120-127, this
    # wave's applied splits name leaves below 128, its right children 128+
    pend = torch.full((128,), -1, dtype=torch.int32, device=dev)
    pend[:8] = torch.from_numpy(rng.choice(nl0, 8, replace=False)).to(dev)
    tt = torch.full((16, 128), -1, dtype=torch.int32, device=dev)
    tt[0, :12] = torch.from_numpy(rng.choice(nl0 + 8, 12, replace=False))
    tt[7, :K] = torch.from_numpy(rng.choice(nl0 + 20, K, replace=False))
    tt[15] = nl0 + 8
    dec = torch.randint(0, 8, (K, N), generator=gen, device=dev,
                        dtype=torch.int32).to(torch.uint8)
    fmask2 = torch.ones((2 * K, F), dtype=torch.uint8, device=dev)
    # the dec bytes and smaller-child rows #10's wave needs
    tp = torch.full((16, 128), -1, dtype=torch.int32, device=dev)
    tp[0], tp[15] = pend, nl0
    lor1, _ = hc.wave_apply_plain((dec >> 2) & 1, lor, tp, S)
    new10, slot10 = hc.wave_apply_plain(dec & 3, lor1, tt, S)
    dec_bytes = int(torch.isin(lor, pend[:8]).sum()
                    + torch.isin(lor1, tt[0, :12]).sum()
                    + torch.isin(new10, tt[7, :K]).sum())
    small10 = int((slot10 >= 0).sum())
    del tp, lor1, new10, slot10
    values = torch.randint(-64, 64, (max(LEAF_CAP_LS),), generator=gen,
                           device=dev).to(torch.float32) / 64
    scores = torch.randint(-4096, 4096, (N,), generator=gen, device=dev) \
        .to(torch.float32) / 64
    out = {}

    def rec(name, L, ms, dms, ms_s, dms_s, plain_ms, nbytes, map_bytes,
            **kw):
        bms, by = bound_ms(nbytes + map_bytes, 0)
        r = dict(name=name, L=L, N=N, max_abs_err=0.0, tol=0.0, ms=ms,
                 device_ms=dms, ms_255=ms_s, device_ms_255=dms_s,
                 plain_ms=plain_ms, library_ms=None, bound_ms=bms,
                 bound_by=by, map_bytes=map_bytes, **kw)
        emit({"phase": "leaf_cap_kernels", **r})
        out.setdefault(name, {})[L] = r

    for L in LEAF_CAP_LS:
        # one buffer for every launch at L, as a booster holds it
        gm = hc.new_leaf_map(dev, L)
        m = _spread_map(torch, rng, L, nl0, dev)
        lor_L = _spread_leaves(torch, m, lor)
        t16_L, t128_L = (_spread_table(torch, m, t) for t in (t16, t128))
        n_hi = int((lor_L >= hc.LEAF_CAP).sum())
        check(n_hi > N // 2, f"L={L}: leaf ids not spread past the cap")
        # -- 2. the score update and the gather
        vL = values[:L].contiguous()
        lv = torch.randint(0, L, (N,), generator=gen, device=dev,
                           dtype=torch.int32)
        check(torch.equal(hc.add_leaf_values_cuda(scores.clone(), vL, lv),
                          hc.add_leaf_values_plain(scores.clone(), vL, lv))
              and torch.equal(hc.take_leaf_values_cuda(vL, lv),
                              hc.take_leaf_values_plain(vL, lv)),
              f"take_leaf_values L={L}: not bitwise")
        sc = scores.clone()
        ls = lv % S
        ms, dms = timings(lambda: hc.add_leaf_values_cuda(sc, vL, lv), 20)
        ms_s, dms_s = timings(lambda: hc.add_leaf_values_cuda(
            sc, vL[:S], ls), 20)
        pms = time_ms(lambda: hc.add_leaf_values_plain(sc, vL, lv), 3, 1)
        rec("take_leaf_values", L, ms, dms, ms_s, dms_s, pms, 12 * N, 4 * L,
            timing="warm L2 (one operand pair, back to back)")
        # -- 3. the wave pass, 5. the relabel
        gl, gh = hc.wave_pass_cuda(X, grid, lor_L, t16_L, K, B, L, gmap=gm)
        rl, rh = hc.wave_pass_plain(X, grid, lor_L, t16_L, K, B, L)
        sl, sh = hc.wave_pass_cuda(X, grid, lor, t16, K, B, S)
        check(torch.equal(gl, rl) and torch.equal(gh, rh),
              f"wave_pass L={L}: not bitwise")
        check(torch.equal(gl, _spread_leaves(torch, m, sl))
              and torch.equal(gh, sh),
              f"wave_pass L={L}: differs from the same wave under L=255")
        small = int((slot_small >= 0).sum())
        app_rows = int(torch.isin(lor, t16[0, :napp]).sum())
        cand_rows = int(torch.isin(rl, t16_L[7, :K]).sum())
        nbytes = 8 * N + app_rows + cand_rows + small * (F + 4 * C) \
            + K * C * F * B * 4 + 16 * 128 * 4
        ms, dms = timings(lambda: hc.wave_pass_cuda(X, grid, lor_L, t16_L, K,
                                                    B, L, gmap=gm), 20)
        ms_s, dms_s = timings(lambda: hc.wave_pass_cuda(X, grid, lor, t16, K,
                                                        B, S), 20)
        pms = time_ms(lambda: hc.wave_pass_plain(X, grid, lor_L, t16_L, K, B,
                                                 L), 2, 1)
        rec("wave_pass", L, ms, dms, ms_s, dms_s, pms, nbytes,
            2 * 4 * (128 + K), K=K, small_rows=small)
        o = torch.empty_like(lor)
        check(torch.equal(hc.wave_relabel_cuda(X, lor_L, t16_L, L, gmap=gm),
                          hc.wave_relabel_plain(X, lor_L, t16_L, L)),
              f"wave_relabel L={L}: not bitwise")
        ip = lor_L.clone()
        hc.wave_relabel_cuda(X, ip, t16_L, L, out=ip, gmap=gm)
        check(torch.equal(ip, rl), f"wave_relabel L={L} in place")
        ms, dms = timings(lambda: hc.wave_relabel_cuda(X, lor_L, t16_L, L,
                                                       out=o, gmap=gm), 50)
        ms_s, dms_s = timings(lambda: hc.wave_relabel_cuda(X, lor, t16, S,
                                                           out=o), 50)
        pms = time_ms(lambda: hc.wave_relabel_plain(X, lor_L, t16_L, L), 2,
                      1)
        rec("wave_relabel", L, ms, dms, ms_s, dms_s, pms,
            8 * N + app_rows + 16 * 128 * 4, 2 * 4 * 128)
        # -- 4. the decide-and-apply pass, Kd = 128
        ga = hc.wave_apply_cuda(X, lor_L, t128_L, None, None, Kd, L, gmap=gm)
        ra = hc.wave_apply_rows_plain(X, lor_L, t128_L, None, None, Kd, L)
        sa = hc.wave_apply_cuda(X, lor, t128, None, None, Kd, S)
        check(torch.equal(ga[0], ra[0]) and torch.equal(ga[1], ra[1]),
              f"wave_apply L={L}: not bitwise")
        check(torch.equal(ga[0], _spread_leaves(torch, m, sa[0]))
              and torch.equal(ga[1], sa[1]),
              f"wave_apply L={L}: differs from the same wave under L=255")
        tested = int(torch.isin(lor, t128[0, :napp]).sum()
                     + torch.isin(sa[0], t128[7, :Kd]).sum())
        ms, dms = timings(lambda: hc.wave_apply_cuda(X, lor_L, t128_L, None,
                                                     None, Kd, L, gmap=gm), 20)
        ms_s, dms_s = timings(lambda: hc.wave_apply_cuda(X, lor, t128, None,
                                                         None, Kd, S), 20)
        pms = time_ms(lambda: hc.wave_apply_rows_plain(
            X, lor_L, t128_L, None, None, Kd, L), 2, 1)
        rec("wave_apply", L, ms, dms, ms_s, dms_s, pms,
            12 * N + tested + 16 * 128 * 4, 2 * 4 * 2 * Kd, Kd=Kd)
        # -- 9. the narrow fused wave
        a9 = (parent, scal, fmeta, fmask, K, B)
        g9 = gf.wave_pass_fused_cuda(X, grid, lor_L, t16_L, *a9, L, hp,
                                     gmap=gm)
        r9 = gf.wave_pass_fused_plain(X, grid, lor_L, t16_L, *a9, L, hp)
        s9 = gf.wave_pass_fused_cuda(X, grid, lor, t16, *a9, S, hp)
        check(all(torch.equal(a, b) for a, b in zip(g9, r9))
              and torch.equal(g9[2], s9[2]),
              f"wave_pass_fused L={L}: not bitwise")
        ms, dms = timings(lambda: gf.wave_pass_fused_cuda(
            X, grid, lor_L, t16_L, *a9, L, hp, gmap=gm), 20)
        ms_s, dms_s = timings(lambda: gf.wave_pass_fused_cuda(
            X, grid, lor, t16, *a9, S, hp), 20)
        pms = time_ms(lambda: gf.wave_pass_fused_plain(
            X, grid, lor_L, t16_L, *a9, L, hp), 2, 1)
        rec("wave_pass_fused", L, ms, dms, ms_s, dms_s, pms,
            nbytes + _scan_nbytes(K, F, B), 2 * 4 * (128 + K), K=K)
        # -- 10. the general fused wave, with a pending relabel
        m10 = _spread_map(torch, rng, L, nl0, dev)
        tt_L = _spread_table(torch, m10, tt)
        pend_L = _spread_leaves(torch, m10, pend)
        pn_L = torch.tensor([int(m10[nl0])], dtype=torch.int32, device=dev)
        pn_s = torch.tensor([nl0], dtype=torch.int32, device=dev)
        lor10 = _spread_leaves(torch, m10, lor)
        a10 = (parent, scal, fmeta, fmask2, K, B)
        g10 = gf.wave_pass_fused_tiled_cuda(X, grid, dec, lor10, tt_L,
                                            pend_L, pn_L, *a10, L, hp,
                                            gmap=gm)
        r10 = gf.wave_pass_fused_tiled_plain(X, grid, dec, lor10, tt_L,
                                             pend_L, pn_L, *a10, L, hp)
        s10 = gf.wave_pass_fused_tiled_cuda(X, grid, dec, lor, tt, pend,
                                            pn_s, *a10, S, hp)
        check(all(torch.equal(a, b) for a, b in zip(g10, r10))
              and torch.equal(g10[0], _spread_leaves(torch, m10, s10[0]))
              and torch.equal(g10[2], s10[2]),
              f"wave_pass_fused_tiled L={L}: not bitwise")
        check(not torch.equal(g10[0], lor10), "no row moved in #10's wave")
        check(bool((gm == hc.GMAP_NONE).all()),
              f"L={L}: the global leaf maps were not cleared after a wave")
        ms, dms = timings(lambda: gf.wave_pass_fused_tiled_cuda(
            X, grid, dec, lor10, tt_L, pend_L, pn_L, *a10, L, hp, gmap=gm),
            20)
        ms_s, dms_s = timings(lambda: gf.wave_pass_fused_tiled_cuda(
            X, grid, dec, lor, tt, pend, pn_s, *a10, S, hp), 20)
        pms = time_ms(lambda: gf.wave_pass_fused_tiled_plain(
            X, grid, dec, lor10, tt_L, pend_L, pn_L, *a10, L, hp), 2, 1)
        rec("wave_pass_fused_tiled", L, ms, dms, ms_s, dms_s, pms,
            8 * N + dec_bytes + small10 * (F + 8) + K * 2 * F * B * 4
            + _scan_nbytes(K, F, B), 2 * 4 * (8 + 12 + K), K=K, Kd=K,
            small_rows=small10)
    return out


def leaf_cap_phase(lt, hc, gf, torch, dev, params, ds, params_c, ds_c):
    """Past the leaf cap: the kernels (leaf_cap_kernels), then bench.py's
    data at num_leaves = 16384 on the wave grower (tpu_grower="wave": the
    ladder at the default histogram_pool_size picks masked, as the JAX
    package's does) 2 rounds per iteration and batched, md5-equal, more
    than 4096 leaves a tree, the first tree equal to the plain versions';
    one Criteo round at 8192 leaves on the apply route (#4; the wave grower
    named again, the ladder's caches there exceed 512 MB) and one bench
    round at 8192 leaves under histogram_impl=fused (#9), each first tree
    equal to the plain versions'. Returns {kernel: {L: record}}."""
    krec = leaf_cap_kernels(hc, gf, torch, dev)
    runs = [("bench_16384", {**params, "num_leaves": 16384,
                             "tpu_grower": "wave"}, ds, 2, "mega",
             ("wave_pass", "wave_relabel")),
            ("criteo_8192", {**params_c, "num_leaves": 8192,
                             "tpu_grower": "wave"}, ds_c, 1, "apply",
             ("wave_apply",)),
            ("fused_8192", {**params, "num_leaves": 8192,
                            "histogram_impl": "fused"}, ds, 1, "fused",
             ("wave_pass_fused",))]
    for name, p, d, rounds, route, kernels in runs:
        hc.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = lt.train({**p, "batched_train": False}, d, rounds)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / rounds
        launches = dict(hc.LAUNCHES)
        g = b._gbdt
        leaves = [t.num_leaves for t in g.models]
        lv_err = _same_host_tree(_plain_trees(torch, g, N_ROWS)[0],
                                 g.models[0])
        line = {"phase": "leaf_cap", "run": name, "rows": N_ROWS,
                "num_leaves": p["num_leaves"], "grow_route": g.grow_route,
                "grower": g.grower, "ms_per_round": ms, "leaves": leaves,
                "launches": {k: launches[k] for k in kernels
                             + ("take_leaf_values",)},
                "first_tree_same": lv_err is not None,
                "leaf_value_max_abs_err": lv_err}
        check(g.grow_route == route, f"leaf_cap {name}: route "
                                     f"{g.grow_route}")
        for k in kernels + ("take_leaf_values",):
            check(launches[k] > 0, f"leaf_cap {name}: {k} never launched")
        check(lv_err is not None and lv_err <= 1e-6,
              f"leaf_cap {name}: first tree differs from the plain "
              f"versions' ({lv_err})")
        if name == "bench_16384":
            check(min(leaves) > hc.LEAF_CAP, f"leaf_cap {name}: trees of "
                                            f"{leaves} leaves")
            hc.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bb = lt.train({**p, "batched_train": True}, d, rounds)
            torch.cuda.synchronize()
            line["batched_ms_per_round"] = \
                (time.perf_counter() - t0) * 1e3 / rounds
            line["batched_veto"] = bb._gbdt.batched_veto
            line["md5_equal"] = _md5(bb.model_to_string()) \
                == _md5(b.model_to_string())
            check(line["md5_equal"] and bb._gbdt.batched_veto == "",
                  f"leaf_cap {name}: batched model differs "
                  f"({bb._gbdt.batched_veto!r})")
            del bb
        emit(line)
        del b, g
    return krec


def _http(server, method, path, body=None, headers=None):
    """(status, Retry-After, JSON body) of one request to a local server."""
    import http.client
    host, port = server.server_address
    c = http.client.HTTPConnection(host, port, timeout=30)
    try:
        c.request(method, path, body=body, headers=headers or {})
        r = c.getresponse()
        return r.status, r.getheader("Retry-After"), json.loads(r.read())
    finally:
        c.close()


def _start_server(cli, reg, mb, m, adm, br):
    import threading
    import types
    cfg = types.SimpleNamespace(serve_host="127.0.0.1", serve_port=0,
                                serve_deadline_ms=0.0,
                                serve_deadline_header="X-Deadline-Ms")
    server = cli.build_http_server(cfg, reg, mb, m, admission=adm,
                                   breaker=br)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, t


def _stop_server(server, t):
    server.shutdown()
    server.server_close()
    t.join(timeout=10)


def overload_phase(lt, hc, torch, smi, here, bst, X):
    """A18(b)'s overload path on the card: bench.py's model behind the
    registry, the micro-batcher, admission control and the circuit
    breaker (serving/), with a fault plan, the binned engine on raw f32
    rows (#6 and the walk) and the HTTP server on 127.0.0.1:0.

      * task=serve's defaults (cli.build_serving): 1024 one-row requests
        to the model's text on the device engine behind the default
        breaker (3 failures), within 1e-6 of Booster.predict, the
        breaker closed, no host fallback;

      * breaker: fail_score on 3 chunks trips it (failure_threshold 3);
        those chunks and the 2 sent while it is open are scored on the
        host, bitwise Booster.predict, and host_fallbacks counts exactly
        them; after the 0.5 s cooldown the half-open probe runs #6 and the
        walk (bucketize launches) and closes it, its scores bitwise a
        breaker-free session's; then slow_score (80 ms) on 3 chunks trips
        the 50 ms latency SLO and the cooldown recovers it again; trip and
        recovery times from the first faulty chunk;
      * overload: 16 client threads offer 5x the capacity of a session
        slowed by slow_score (5 ms a chunk) for 1 s through admission
        (queue watermarks 0.5 / 0.25, p99 SLO 100 ms): sheds fail at once
        (503, under 100 ms with 16 threads on the host's cores), accepted
        requests' p50 / p99 recorded, no host fallback;
      * HTTP: 200 from /predict (scores equal the session's), 429 with
        Retry-After past a client's token bucket, 504 for a deadline that
        expires in the queue and 503 past the queue watermark while
        wedge_worker stalls the worker 1.5 s, /healthz 503 with
        worker_wedged, then 200 once the stall ends; 400, 413, 404;
      * snapshot watching: a snapshot at iteration 8 whose bytes were
        corrupted after its manifest was written is rejected, with a
        backoff on its path; then one at iteration 4 with its manifest is
        promoted at once, its scores those of a session of its own."""
    import tempfile
    import threading
    from lightgbm_tpu_torch import cli
    from lightgbm_tpu_torch.runtime.checkpoint import write_manifest
    from lightgbm_tpu_torch.runtime.faults import FaultPlan, corrupt_file
    from lightgbm_tpu_torch.serving import (AdmissionController,
                                            CircuitBreaker, MicroBatcher,
                                            ModelRegistry, OverloadedError,
                                            ServingMetrics)
    rows = X[:4096].astype(np.float32)
    line = {"phase": "overload", "nvidia_smi": smi}

    # -- task=serve's defaults (cli.build_serving, as run_serve builds
    # them): the device engine behind the default breaker on healthy
    # traffic, one row a request as the file mode submits them. run_serve
    # registers a model file: bench's text, which holds the trees up to
    # its best_iteration (8 of 16), the ones Booster.predict scores
    from lightgbm_tpu_torch.config import resolve_params
    md, brd, regd, mbd = cli.build_serving(resolve_params(cli.parse_args(
        ["task=serve", "verbosity=-1"])))
    regd.register("default", bst.model_to_string())
    mbd.start()
    try:
        reqs = [mbd.submit(rows[i]) for i in range(1024)]
        got = np.concatenate([np.asarray(mbd.wait(r)).reshape(-1)
                              for r in reqs])
    finally:
        mbd.stop()
    default = {"engine": regd.session("default").engine,
               "breaker": None if brd is None else brd.state,
               "failure_threshold": None if brd is None
               else brd.failure_threshold,
               "host_fallbacks": md.counters["host_fallbacks"],
               "batches": md.counters["batches"],
               "max_abs_err_predict": float(np.abs(
                   got - bst.predict(rows[:1024])).max())}
    line["serve_default"] = default
    check(default["engine"] == "device" and default["breaker"] == "closed"
          and default["failure_threshold"] == 3
          and default["host_fallbacks"] == 0
          and default["max_abs_err_predict"] <= 1e-6,
          f"task=serve's default breaker on healthy traffic: {default}")

    # -- the breaker, by failures then by latency
    m = ServingMetrics(max_batch=256)
    br = CircuitBreaker(failure_threshold=3, latency_slo_ms=50.0,
                        latency_trips=3, cooldown_s=0.5, metrics=m)
    plan = FaultPlan.parse("fail_score@batch=0:times=3;"
                           "slow_score@batch=8:ms=80:times=3")
    reg = ModelRegistry(metrics=m, engine="binned", binning_impl="device",
                        max_batch=256, breaker=br, fault_plan=plan)
    reg.register("bench", bst, warmup=True)
    plain = bst.serve(engine="binned", binning_impl="device", max_batch=256,
                      warmup=True)
    host = [], []
    q = [rows[i * 64:(i + 1) * 64] for i in range(16)]
    want = [bst.predict(b) for b in q]
    t0 = time.perf_counter()
    states, launches = [], []
    trip_ms = recover_ms = None
    for i in range(5):
        got = reg.predict(q[i], name="bench")
        host[0].append(bool(np.array_equal(got, want[i])))
        states.append(br.state)
        if br.state == "open" and trip_ms is None:
            trip_ms = (time.perf_counter() - t0) * 1e3
    fallbacks_open = m.counters["host_fallbacks"]
    time.sleep(0.55)
    hc.reset_launch_counts()
    got = reg.predict(q[5], name="bench")
    launches.append(dict(hc.LAUNCHES))
    recover_ms = (time.perf_counter() - t0) * 1e3
    states.append(br.state)
    probe_bitwise = bool(np.array_equal(got, plain.predict(q[5])))
    check(host[0] == [True] * 5 and states[:5] == ["closed", "closed",
                                                   "open", "open", "open"]
          and fallbacks_open == 5,
          f"breaker by failures: {states} {host[0]} {fallbacks_open}")
    check(states[5] == "closed" and launches[0]["bucketize"] > 0
          and probe_bitwise and m.counters["host_fallbacks"] == 5,
          f"the half-open probe did not run #6 and the walk: {states} "
          f"{launches[0]}")
    # chunks 6-7 on the card, 8-10 slow (80 ms > the 50 ms SLO): open
    t1 = time.perf_counter()
    for i in range(6, 11):
        got = reg.predict(q[i], name="bench")
        states.append(br.state)
    slow_trip_ms = (time.perf_counter() - t1) * 1e3
    got = reg.predict(q[11], name="bench")
    host[1].append(bool(np.array_equal(got, want[11])))
    time.sleep(0.55)
    hc.reset_launch_counts()
    got = reg.predict(q[12], name="bench")
    launches.append(dict(hc.LAUNCHES))
    slow_recover_ms = (time.perf_counter() - t1) * 1e3
    check(states[-1] == "open" and "latency SLO" in br.last_trip_reason
          and host[1] == [True] and br.state == "closed"
          and launches[1]["bucketize"] > 0
          and m.counters["host_fallbacks"] == 6,
          f"breaker by latency: {states} {br.to_dict()} {m.counters}")
    line.update(breaker_states=states, breaker=br.to_dict(),
                host_chunks_bitwise_predict=host[0] + host[1],
                probe_bitwise_binned=probe_bitwise,
                probe_launches=launches[0],
                host_fallbacks=m.counters["host_fallbacks"],
                host_fallbacks_expected=6,
                trip_ms_after_first_failure=trip_ms,
                recover_ms_after_first_failure=recover_ms,
                slow_trip_and_recover_ms=slow_recover_ms,
                slow_chunks_ms=slow_trip_ms,
                breaker_trips=m.counters["breaker_trips"],
                breaker_recoveries=m.counters["breaker_recoveries"])

    # -- overload: 5x capacity through admission
    mo = ServingMetrics(max_batch=8)
    reg_o = ModelRegistry(metrics=mo, engine="binned", binning_impl="device",
                          max_batch=8, fault_plan=FaultPlan.parse(
                              "slow_score@batch=0:ms=5:times=1000000"))
    reg_o.register("bench", bst, warmup=True)
    mb = MicroBatcher(lambda b: reg_o.predict(b, name="bench"), max_batch=8,
                      max_wait_ms=1.0, queue_depth=64, timeout_ms=4000,
                      metrics=mo)
    mb.start()
    adm = AdmissionController(mb, metrics=mo, queue_high=0.5,
                              queue_low=0.25, p99_slo_ms=100.0)
    capacity = 8 / 6e-3
    offered, clients, duration = 5 * capacity, 16, 1.0
    accepted, shed, failed = [], [], []
    lock = threading.Lock()
    import queue as queue_mod
    inflight = queue_mod.Queue()
    gen_done = threading.Event()

    def client(k):
        # submit without waiting (waiter threads collect), so the queue
        # fills as it would under open-loop traffic
        period = clients / offered
        t_end = time.perf_counter() + duration
        i = k
        while time.perf_counter() < t_end:
            ts = time.perf_counter()
            try:
                inflight.put((adm.submit(rows[i % 4096][None],
                                         deadline=ts + 0.2), ts))
            except OverloadedError:
                with lock:
                    shed.append(time.perf_counter() - ts)
            i += clients
            time.sleep(max(0.0, period - (time.perf_counter() - ts)))

    def waiter():
        while True:
            try:
                req, ts = inflight.get(timeout=0.05)
            except queue_mod.Empty:
                if gen_done.is_set():
                    return
                continue
            try:
                mb.wait(req)
                with lock:
                    accepted.append(time.perf_counter() - ts)
            except Exception as e:
                with lock:
                    failed.append(repr(e))

    th = [threading.Thread(target=client, args=(k,))
          for k in range(clients)]
    wt = [threading.Thread(target=waiter) for _ in range(clients)]
    for t in th + wt:
        t.start()
    for t in th:
        t.join(timeout=60)
    gen_done.set()
    for t in wt:
        t.join(timeout=60)
    th += wt
    mb.stop()
    acc = sorted(accepted)
    pct = (lambda q_: acc[min(len(acc) - 1, int(round(q_ * (len(acc) - 1))))]
           * 1e3 if acc else None)
    line.update(overload_offered_per_s=offered, overload_clients=clients,
                overload_accepted=len(acc), overload_shed=len(shed),
                overload_failed=len(failed),
                accepted_p50_ms=pct(0.5), accepted_p99_ms=pct(0.99),
                shed_max_ms=max(shed) * 1e3 if shed else None,
                overload_counters={k: mo.counters[k] for k in (
                    "admitted", "shed_overload", "expired",
                    "host_fallbacks")},
                overload_batches=mo.counters["batches"])
    check(not any(t.is_alive() for t in th) and len(shed) > 0
          and len(acc) > 0 and mo.counters["host_fallbacks"] == 0
          and max(shed) < 0.1,
          f"overload: {len(acc)} accepted, {len(shed)} shed, "
          f"{failed[:2]}")

    # -- HTTP, with a worker stall
    mh = ServingMetrics(max_batch=256)
    reg_h = ModelRegistry(metrics=mh, engine="binned", binning_impl="device",
                          max_batch=256)
    reg_h.register("bench", bst, warmup=True)
    mbh = MicroBatcher(lambda b: reg_h.predict(b, name="bench"),
                       max_batch=256, max_wait_ms=1.0, queue_depth=8,
                       timeout_ms=200, metrics=mh)
    mbh.start()
    # a token a row: two 4-row requests empty a client's bucket
    admh = AdmissionController(mbh, metrics=mh, rate_qps=0.01, burst=8.0,
                               queue_high=0.5, queue_low=0.25)
    server, st = _start_server(cli, reg_h, mbh, mh, admh, None)
    codes = {}
    try:
        body = json.dumps({"rows": rows[:4].astype(np.float64).tolist()})
        c, _, out = _http(server, "POST", "/predict", body, {"X-Client": "a"})
        codes["predict"] = c
        http_equal = np.allclose(out["predictions"],
                                 plain.predict(rows[:4].astype(np.float64)),
                                 rtol=0, atol=0)
        _http(server, "POST", "/predict", body, {"X-Client": "a"})
        c, ra, _ = _http(server, "POST", "/predict", body, {"X-Client": "a"})
        codes["rate_limited"] = (c, ra)
        codes["malformed"] = _http(server, "POST", "/predict", "{x",
                                   {"X-Client": "b"})[0]
        codes["oversize"] = _http(server, "POST", "/predict", "[]", {
            "Content-Length": str(40 << 20)})[0]
        codes["no_route"] = _http(server, "GET", "/nope")[0]
        codes["healthz"] = _http(server, "GET", "/healthz")[0]
    finally:
        mbh.stop()
        _stop_server(server, st)
    # the stalled worker: a fresh batcher whose first loop sleeps 1.5 s
    mw = ServingMetrics(max_batch=256)
    mbw = MicroBatcher(lambda b: reg_h.predict(b, name="bench"),
                       max_batch=256, max_wait_ms=1.0, queue_depth=8,
                       timeout_ms=200, metrics=mw,
                       fault_plan=FaultPlan.parse(
                           "wedge_worker@batch=0:ms=1500"))
    mbw.start()
    admw = AdmissionController(mbw, metrics=mw, queue_high=0.5,
                               queue_low=0.25)
    server, st = _start_server(cli, reg_h, mbw, mw, admw, None)
    try:
        body1 = json.dumps({"rows": rows[:1].astype(np.float64).tolist()})
        c, _, _ = _http(server, "POST", "/predict", body1,
                        {"X-Deadline-Ms": "100"})
        codes["deadline"] = c
        queued = [mbw.submit(rows[i]) for i in range(4)]
        c, ra, _ = _http(server, "POST", "/predict", body1)
        codes["shed"] = (c, ra)
        t_end = time.perf_counter() + 5.0
        while not mbw.wedged() and time.perf_counter() < t_end:
            time.sleep(0.01)
        c, _, hz = _http(server, "GET", "/healthz")
        codes["healthz_wedged"] = (c, hz["worker_wedged"])
        for r in queued:
            try:
                mbw.wait(r, timeout=10)
            except Exception:
                pass
        c, _, _ = _http(server, "GET", "/healthz")
        codes["healthz_after"] = c
        codes["readyz"] = _http(server, "GET", "/readyz")[0]
    finally:
        mbw.stop()
        _stop_server(server, st)
    line.update(http_codes=codes, http_predict_equal_session=bool(http_equal),
                wedge_counters={k: mw.counters[k] for k in (
                    "expired", "shed_overload", "admitted")})
    check(codes["predict"] == 200 and http_equal
          and codes["rate_limited"][0] == 429
          and codes["rate_limited"][1] is not None
          and codes["malformed"] == 400 and codes["oversize"] == 413
          and codes["no_route"] == 404 and codes["healthz"] == 200
          and codes["deadline"] == 504 and codes["shed"][0] == 503
          and codes["shed"][1] is not None
          and codes["healthz_wedged"] == (503, True)
          and codes["healthz_after"] == 200 and codes["readyz"] == 200,
          f"HTTP status codes: {codes}")

    # -- snapshot watching
    tmp = tempfile.TemporaryDirectory(dir=here)
    prefix = os.path.join(tmp.name, "bench.txt")
    good, bad = (f"{prefix}.snapshot_iter_{k}.txt" for k in (4, 8))
    bst.save_model(bad, num_iteration=8)
    write_manifest(bad)
    corrupt_file(bad)
    reg_s = ModelRegistry(engine="binned", binning_impl="device",
                          max_batch=256)
    reg_s.register("bench", bst)
    reg_s.watch_snapshots("bench", prefix)
    w = reg_s._watches["bench"]
    # the corrupted snapshot alone: rejected by its manifest, backoff on
    # its path; then a good one at another path promotes at once
    first = reg_s.poll_snapshots("bench")
    backoff_s = w.backoff_until - time.perf_counter()
    streak = w.reject_streak
    bst.save_model(good, num_iteration=4)
    write_manifest(good)
    promoted = reg_s.poll_snapshots("bench")
    snap_pred = reg_s.predict(rows[:256].astype(np.float64), name="bench")
    ref4 = lt.Booster(params={"device_type":
                              bst._gbdt.config.device_type},
                      model_file=good).serve(
        engine="binned", binning_impl="device", max_batch=256,
        bin_mappers=plain.bin_mappers).predict(
        rows[:256].astype(np.float64))
    line.update(snapshot_promoted=promoted,
                snapshot_rejected=reg_s.metrics.counters.get(
                    "snapshots_rejected", 0),
                snapshot_backoff_s=backoff_s,
                snapshot_version=reg_s.session("bench").version,
                snapshot_scores_equal=bool(np.array_equal(snap_pred, ref4)))
    check(first is None and streak == 1 and backoff_s > 0
          and promoted == 4 and line["snapshot_rejected"] == 1
          and w.reject_streak == 0 and line["snapshot_scores_equal"],
          f"snapshot watch: promoted {promoted}, {line}")
    reg_s.stop_watchers()
    tmp.cleanup()
    emit(line)


# ---------------------------------------------------------------------------
# A18(b)'s rest: the stacked bucketize, the fleet, the export
# ---------------------------------------------------------------------------
def _tenant_queries():
    """4096 f32 query rows a tenant: bench's held-out rows for bench and
    the 5-class model (bench's columns), Criteo-shaped rows with unseen,
    negative and NaN categories for Criteo."""
    from lightgbm_tpu_torch.utils.synthetic import (CRITEO_CAT_COLUMNS,
                                                    criteo_like)
    rng = np.random.RandomState(61)
    Xb = rng.normal(size=(4096, N_FEAT)).astype(np.float32)
    Xc, _ = criteo_like(4096, seed=62)
    cats = np.asarray(CRITEO_CAT_COLUMNS)
    sub = Xc[:, cats]
    for vals in ((1000.0, 5000.0), (-1.0, -0.5), (np.nan,)):
        m = rng.rand(*sub.shape) < 0.03
        sub[m] = rng.choice(np.asarray(vals, np.float32), size=m.shape)[m]
    Xc[:, cats] = sub
    return {"bench": Xb, "criteo": Xc.astype(np.float32), "mc5": Xb}


def _tenant_sessions(tenants):
    from lightgbm_tpu_torch.serving import ServingSession
    return {n: ServingSession.from_model_string(
        text, engine="binned", max_batch=256, bin_mappers=mappers,
        device_type="cuda") for n, (text, mappers) in tenants.items()}


def _zipf_tenants(rng, names, n, s=1.1):
    p = 1.0 / np.arange(1, len(names) + 1) ** s
    return rng.choice(len(names), size=n, p=p / p.sum())


def stacked_bucketize_phase(bk, torch, dev, smi, tenants, qs):
    """The stacked bucketize kernel (csrc/bucketize_stacked.cu) on 4096
    Zipf-mixed rows of the bench, Criteo and 5-class tenants against the
    stacked table of their serve tables: bitwise its plain version and
    each tenant's own #6 bins (bucketize_cuda on its own table); device
    ms, call ms, the bytes bound, the plain version's ms and, as the
    library yardstick, torch.searchsorted over the rows' gathered table
    rows (the numeric count). Returns the kernels-line record."""
    sessions = _tenant_sessions(tenants)
    names = list(tenants)
    st = bk.upload_stacked_table(bk.stack_bin_tables(
        [sessions[n]._bin_table for n in names]), dev)
    F, C, B = st.num_features, st.num_tenants, st.B
    rng = np.random.RandomState(63)
    n = 4096
    tid = _zipf_tenants(rng, names, n).astype(np.int32)
    X = np.zeros((n, F), np.float32)
    for c, name in enumerate(names):
        rows = rng.randint(0, len(qs[name]), size=int((tid == c).sum()))
        X[tid == c, :qs[name].shape[1]] = qs[name][rows]
    Xd = torch.from_numpy(X).to(dev)
    td = torch.from_numpy(tid).to(dev)
    got = bk.bucketize_stacked_cuda(Xd, td, st)
    ref = bk.bucketize_stacked_plain(Xd, td, st)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), "stacked bucketize differs from its plain "
          f"version in {int((got != ref).sum())} bins")
    own_equal = {}
    for c, name in enumerate(names):
        s = sessions[name]
        Fc = s._bm.num_features
        rows = td == c
        own = bk.bucketize_cuda(Xd[rows][:, :Fc].contiguous(),
                                s._bin_tensors)
        own_equal[name] = bool(torch.equal(got[rows][:, :Fc], own)) and \
            bool((got[rows][:, Fc:] == 0).all())
    check(all(own_equal.values()), f"stacked bins differ from a tenant's "
                                   f"own #6 bins: {own_equal}")
    CF = C * F
    nbytes = n * F * 4 + n * 4 + n * F + CF * B * 8 + CF * (2 + B) * 4 \
        + CF * 32
    bms, by = bound_ms(nbytes, 0)
    # a call is a few microseconds: 200 a profiler session, and a session
    # below the bound (a partial capture) is not kept
    ms, dms = timings(lambda: bk.bucketize_stacked_cuda(Xd, td, st), 200,
                      floor_ms=bms)
    plain_ms = time_ms(lambda: bk.bucketize_stacked_plain(Xd, td, st), 3, 1)
    r = (td.long()[:, None] * F + torch.arange(F, device=dev)[None]) \
        .reshape(-1)
    tab_g = st.table[r].contiguous()
    x_g = Xd.reshape(-1, 1).contiguous()
    lib_ms, lib_dms = timings(lambda: torch.searchsorted(tab_g, x_g), 20)
    del tab_g, x_g
    rec = dict(name="bucketize_stacked", n=n, F=F, B=B, tenants=names,
               rows_by_tenant={nm: int((tid == c).sum())
                               for c, nm in enumerate(names)},
               max_abs_err=0.0, ms=ms, device_ms=dms, plain_ms=plain_ms,
               library_ms=lib_ms, library_device_ms=lib_dms, bound_ms=bms,
               bound_by=by, launches_per_call=1)
    emit({"phase": "stacked_bucketize", "nvidia_smi": smi,
          "bitwise_plain": True, "bitwise_own_bins": own_equal, **rec})
    return rec


def _fleet_traffic(fleet, qs, names, threads=8, per_thread=400, seed=64):
    """Zipf-mixed single f32 rows from client threads: {(tenant, row):
    answer} and the wall seconds. Each thread's (tenant, row) sequence is
    drawn from its own seed, the same in every call."""
    import threading
    answers, errors = {}, []

    def client(k):
        rng = np.random.RandomState(seed + k)
        ts = _zipf_tenants(rng, names, per_thread)
        try:
            for t in ts:
                name = names[t]
                i = int(rng.randint(len(qs[name])))
                out = fleet.predict(qs[name][i], tenant=name,
                                    client=f"c{k}")
                answers[(name, i)] = np.asarray(out).reshape(-1)
        except Exception as e:           # reported below, fails the run
            errors.append(repr(e))

    ths = [threading.Thread(target=client, args=(k,))
           for k in range(threads)]
    t0 = time.perf_counter()
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    check(not errors and not any(t.is_alive() for t in ths),
          f"fleet clients failed: {errors[:3]}")
    return answers, wall


def _await_generation(fleet, gen, timeout=120.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if fleet._fused_scorer is not None and fleet.fused_generation > gen:
            return
        time.sleep(0.01)
    raise AssertionError(f"no fused supertensor past generation {gen} in "
                         f"{timeout} s")


def fleet_phase(hc, torch, smi, tenants, qs):
    """The bench, Criteo and 5-class tenants behind ModelFleet on the card
    (binned sessions, max_batch 256, raw f32 rows), Zipf-mixed single rows
    from 8 client threads (400 each): first unfused (each session's #6 then
    its walk), then fused=True (the stacked kernel, then one fused walk a
    mixed batch). Every answer is bitwise its tenant's own session's score
    of the same row, fused equals unfused, no chunk falls back to the
    host, and the fused run launches the stacked kernel; then one hot swap
    (bench promoted to its first 4 iterations) republishes the
    supertensor, whose fused answers are the new session's. Launch counts
    are reset just before each traffic run and read just after. Records
    per-tenant p50 / p99, batches and tenant switches, the rebuild
    seconds."""
    from lightgbm_tpu_torch.serving import ModelFleet
    names = list(tenants)
    sess = _tenant_sessions(tenants)
    refs = {n: sess[n].predict(qs[n]) for n in names}
    line = {"phase": "fleet", "nvidia_smi": smi, "tenants": names,
            "requests": 8 * 400}
    results, launches = {}, {}
    for fused in (False, True):
        fleet = ModelFleet(max_batch=256, max_wait_ms=2.0, queue_depth=1024,
                           timeout_ms=30000.0, fused=fused,
                           session_opts={"engine": "binned",
                                         "device_type": "cuda"})
        for n, (text, mappers) in tenants.items():
            fleet.add_model(n, text, bin_mappers=mappers)
        with fleet:
            if fused:
                _await_generation(fleet, 0)
                check(all(fleet._fused_scorer.can_serve(n) for n in names)
                      and fleet._fused_scorer._stacked is not None,
                      "the fused scorer does not cover every tenant")
            hc.reset_launch_counts()
            torch.cuda.synchronize()
            answers, wall = _fleet_traffic(fleet, qs, names)
            torch.cuda.synchronize()
            lc = dict(hc.LAUNCHES)
            m = fleet.metrics_dict()["fleet"]
            key = "fused" if fused else "unfused"
            rec = {"wall_s": wall, "requests_per_s": 3200 / wall,
                   "launches": {k: v for k, v in lc.items() if v},
                   "batches": m["scheduler"]["batches"],
                   "tenant_switches": m["scheduler"]["tenant_switches"],
                   "fused_batches": m["scheduler"]["fused_batches"],
                   "fused_rows": m["scheduler"]["fused_rows"],
                   "by_tenant": {n: {
                       "requests": t["counters"]["requests"],
                       "p50_ms": t["request_latency"].get("p50_ms"),
                       "p99_ms": t["request_latency"].get("p99_ms"),
                       "host_fallbacks": t["counters"]["host_fallbacks"],
                       "errors": t["counters"]["errors"]}
                       for n, t in m["tenants"].items()}}
            for (n, i), a in answers.items():
                check(np.array_equal(a, np.asarray(refs[n][i]).reshape(-1)),
                      f"fleet {key}: tenant {n} row {i} differs from its "
                      "session's score")
            check(all(t["host_fallbacks"] == 0 and t["errors"] == 0
                      for t in rec["by_tenant"].values()),
                  f"fleet {key}: a host fallback or an error: "
                  f"{rec['by_tenant']}")
            if fused:
                check(rec["fused_batches"] > 0
                      and lc["bucketize_stacked"] > 0,
                      "the fused fleet never launched the stacked kernel")
                launches = lc
                rec["fused_build_s"] = fleet._fused_scorer.build_s
                # one hot swap: bench to its first 4 iterations
                gen = fleet.fused_generation
                text, mappers = tenants["bench"]
                t0 = time.perf_counter()
                fleet.promote("bench", text, bin_mappers=mappers,
                              num_iteration=4)
                _await_generation(fleet, gen)
                rec["rebuild_s"] = time.perf_counter() - t0
                rec["rebuild_build_s"] = fleet._fused_scorer.build_s
                before = fleet.fused_batches
                new = fleet.session("bench")
                got = np.stack([np.asarray(fleet.predict(
                    qs["bench"][i], tenant="bench")).reshape(-1)
                    for i in range(16)])
                check(fleet.fused_batches > before and np.array_equal(
                    got.reshape(-1), new.predict(qs["bench"][:16])),
                      "after the hot swap the fused answers are not the "
                      "new session's")
                rec["swap_generation"] = fleet.fused_generation
            else:
                check(lc["bucketize"] > 0, "the unfused fleet never ran #6")
            results[key] = answers
            line[key] = rec
    check(results["fused"].keys() == results["unfused"].keys() and all(
        np.array_equal(results["fused"][k], results["unfused"][k])
        for k in results["fused"]), "fused answers differ from unfused")
    line["fused_equals_unfused"] = True
    emit(line)
    return launches


def export_phase(lt, hc, torch, smi, here, tenants, qs):
    """The bench and Criteo models exported (export_model: a torch.export
    program a bucket of 128 and 256 rows, uint8 and raw f32; each program
    takes about a second of host time to export and to load) and loaded
    on the card
    (load_compiled, device cuda, which attaches #6): predict of 4096 f32
    rows (#6 once a 256-row chunk, counted from 0 around the call, then
    the bucket's uint8 program) and of their f64 copies bitwise
    Booster.predict of the same model text (the host walk); the compiled
    engine (f32 rows through #6, then the exported
    program) bitwise the binned engine; export seconds, artifact bytes,
    load and warm-up seconds, and the 256-row bucket's ms (CUDA events)
    beside the binned engine's walk."""
    import shutil
    import tempfile
    from lightgbm_tpu_torch.export import export_model, load_compiled
    from lightgbm_tpu_torch.ops.predict_binned import predict_margin_binned
    from lightgbm_tpu_torch.serving import ServingSession
    tmp = tempfile.mkdtemp(dir=here)
    line = {"phase": "export", "nvidia_smi": smi}
    try:
        for name in ("bench", "criteo"):
            text, mappers = tenants[name]
            bst = lt.Booster(model_str=text)
            Xq = qs[name]
            art = os.path.join(tmp, name)
            t0 = time.perf_counter()
            manifest = export_model(bst, art, bin_mappers=mappers,
                                    max_batch=256, min_bucket=128)
            export_s = time.perf_counter() - t0
            nbytes = sum(os.path.getsize(os.path.join(art, f))
                         for f in os.listdir(art))
            t0 = time.perf_counter()
            cm = load_compiled(art, device=torch.device("cuda"))
            cm.warmup()
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            check(cm.raw_route == "kernel", f"export {name}: the loaded "
                  f"artifact bins f32 rows by {cm.raw_route!r}, not #6")
            want = bst.predict(Xq)
            hc.reset_launch_counts()
            got = cm.predict(Xq)
            art_lc = dict(hc.LAUNCHES)
            same_f32 = np.array_equal(got, want)
            same_f64 = np.array_equal(cm.predict(Xq.astype(np.float64)),
                                      bst.predict(Xq.astype(np.float64)))
            s_bin = ServingSession.from_model_string(
                text, engine="binned", max_batch=256, bin_mappers=mappers,
                device_type="cuda")
            s_cmp = ServingSession.from_model_string(
                text, engine="compiled", max_batch=256, bin_mappers=mappers,
                device_type="cuda")
            hc.reset_launch_counts()
            cmp32 = s_cmp.score_margin(Xq)
            lc = dict(hc.LAUNCHES)
            same_engine = np.array_equal(cmp32, s_bin.score_margin(Xq)) \
                and np.array_equal(
                    s_cmp.score_margin(Xq.astype(np.float64)),
                    s_bin.score_margin(Xq.astype(np.float64)))
            same_artifact = np.array_equal(cm.score_margin_f32(Xq), cmp32)
            xb = torch.from_numpy(s_bin._bm.bin_rows(
                Xq[:256].astype(np.float64))).to(s_bin.device)
            prog = cm._fn("bucket", 256)
            bucket_ms = time_ms(lambda: prog(xb), 20)
            binned_ms = time_ms(lambda: predict_margin_binned(
                s_bin._pa, xb, s_bin.K), 20)
            line[name] = {
                "export_s": export_s, "artifact_bytes": nbytes,
                "programs": len([f for f in manifest["files"]
                                 if f.endswith(".pt2")]),
                "buckets": manifest["buckets"],
                "bin_and_score": manifest["bin_and_score"],
                "load_warm_s": load_s,
                "predict_bitwise_f32": same_f32,
                "predict_bitwise_f64": same_f64,
                "compiled_bitwise_binned": same_engine,
                "artifact_f32_bitwise_compiled": same_artifact,
                "compiled_bucketize_launches": lc["bucketize"],
                "artifact_raw_route": cm.raw_route,
                "artifact_bucketize_launches": art_lc["bucketize"],
                "bucket_256_ms": bucket_ms, "binned_256_ms": binned_ms}
            check(same_f32 and same_f64, f"export {name}: artifact predict "
                                         "differs from Booster.predict")
            check(same_engine and same_artifact,
                  f"export {name}: the compiled engine differs from binned")
            check(lc["bucketize"] > 0, f"export {name}: the compiled "
                                       "engine's f32 route never ran #6")
            check(art_lc["bucketize"] == len(Xq) // 256,
                  f"export {name}: the artifact's f32 predict launched #6 "
                  f"{art_lc['bucketize']} times, not one a chunk")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(line)


def fleet_cli_phase(lt, smi, here, tenants, qs):
    """`python -m lightgbm_tpu_torch task=serve serve_models=bench=...,
    criteo=...` on 127.0.0.1 (the fleet's HTTP server; serve_engine=auto,
    the device engine on the card): 64 rows to each tenant's route within
    1e-6 of Booster.predict, /metrics with both tenants, /healthz 200,
    an unknown tenant 404; the process is stopped with SIGINT (its
    finally stops the fleet) and must exit."""
    import signal
    import socket
    import tempfile
    import urllib.error
    import urllib.request
    tmp = tempfile.TemporaryDirectory(dir=here)
    paths = {}
    for name in ("bench", "criteo"):
        paths[name] = os.path.join(tmp.name, f"{name}.txt")
        with open(paths[name], "w") as f:
            f.write(tenants[name][0])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": here}
    env.pop("LIGHTGBM_TPU_FAULT_PLAN", None)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch", "task=serve",
         "serve_models=" + ",".join(f"{n}={p}" for n, p in paths.items()),
         f"serve_port={port}", "serve_host=127.0.0.1", "verbosity=-1"],
        cwd=tmp.name, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)

    def req(path, body=None):
        r = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                   data=body)
        try:
            with urllib.request.urlopen(r, timeout=60) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    line = {"phase": "fleet_cli", "nvidia_smi": smi}
    try:
        ready = None
        while time.perf_counter() - t0 < 180 and proc.poll() is None:
            try:
                ready = req("/readyz")
                if ready[0] == 200:
                    break
            except OSError:
                time.sleep(0.2)
        check(ready is not None and ready[0] == 200,
              f"the fleet server never became ready (exit {proc.poll()})")
        line["ready_s"] = time.perf_counter() - t0
        errs = {}
        for name in ("bench", "criteo"):
            rows = qs[name][:64]
            body = json.dumps({"rows": [[None if np.isnan(v) else float(v)
                                         for v in r] for r in rows]})
            code, out = req(f"/predict/{name}", body.encode())
            check(code == 200, f"fleet CLI /predict/{name}: {code} {out}")
            want = lt.Booster(model_str=tenants[name][0]).predict(rows)
            errs[name] = float(np.max(np.abs(
                np.asarray(out["predictions"]) - want)))
        code_m, met = req("/metrics")
        code_h, _ = req("/healthz")
        code_404, _ = req("/predict/nope", b"[[1.0]]")
        line.update(max_abs_err_vs_predict=errs, metrics_code=code_m,
                    tenants=sorted(met["fleet"]["tenants"]),
                    healthz_code=code_h, unknown_tenant_code=code_404)
        check(all(e <= 1e-6 for e in errs.values()),
              f"fleet CLI answers vs Booster.predict: {errs}")
        check(code_m == 200 and line["tenants"] == ["bench", "criteo"]
              and code_h == 200 and code_404 == 404,
              f"fleet CLI routes: {line}")
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        log = proc.stdout.read() if proc.stdout else ""
        tmp.cleanup()
    line["exit_code"] = proc.returncode
    line["wall_s"] = time.perf_counter() - t0
    emit(line)
    check(proc.returncode == 0, f"the fleet server exited "
                                f"{proc.returncode}: {log[-2000:]}")


STREAM_CHUNK = 1 << 16
# the online line's traffic: a trace of 2^18 rows in 64 batches of 4096,
# a window of 2^17 rows refreshed every 32768 (8 refreshes: 6 refits and
# 2 continues of 4 trees); cut from 2^19 / 2^18 / 65536, which took the
# whole run past 1000 s on a slow host
ONLINE_TRACE, ONLINE_BATCH = 1 << 18, 4096
ONLINE_LOOP = dict(online_window_rows=1 << 17, online_refresh_rows=32768,
                   online_continue_every=4, online_continue_trees=4)


def streaming_phase(lt, hc, torch, smi, params, ds, X, y, anchor):
    """A13's streaming Dataset on the card: bench's 2^20 x 28 f32 table
    pushed in 16 chunks of 2^16 rows (chunk 5 last, by start_row) against
    bench's Dataset as reference: each f32 chunk binned by #6 straight
    into its columns of X_t (16 launches), X_t and X_binned bitwise the
    bulk Dataset(X, reference=...); the same rows as f64 on the host route
    bitwise too; warm_continue of 2 trees onto bench's model on a 2^18-row
    f32 window launches #6 once and the route's training kernels. Push
    seconds beside the bulk ingest's."""
    from lightgbm_tpu_torch.engine import warm_continue
    n, F = X.shape
    order = [c for c in range(n // STREAM_CHUNK) if c != 5] + [5]

    def stream(Xs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = lt.Dataset(None, params=params).init_streaming(n, reference=ds)
        for c in order:
            lo = c * STREAM_CHUNK
            s.push_rows(Xs[lo:lo + STREAM_CHUNK],
                        label=y[lo:lo + STREAM_CHUNK], start_row=lo)
        s.mark_finished()
        torch.cuda.synchronize()
        return s._handle, time.perf_counter() - t0

    hc.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bulk = lt.Dataset(X, label=y, reference=ds, params=params).construct()
    torch.cuda.synchronize()
    bulk_s = time.perf_counter() - t0
    bulk_launches = hc.LAUNCHES["bucketize"]
    hb = bulk._handle
    hc.reset_launch_counts()
    h32, push_s = stream(X)
    push_launches = dict(hc.LAUNCHES)
    h64, push64_s = stream(X.astype(np.float64))
    host_launches = hc.LAUNCHES["bucketize"] - push_launches["bucketize"]
    same32 = (torch.equal(h32.X_t, hb.X_t)
              and np.array_equal(h32.X_binned, hb.X_binned)
              and np.array_equal(h32.metadata.label, hb.metadata.label))
    same64 = (torch.equal(h64.X_t, hb.X_t)
              and np.array_equal(h64.X_binned, hb.X_binned))
    routes = [h32.binning_route, h64.binning_route, hb.binning_route]
    del bulk, hb, h32, h64
    nw = 1 << 18
    hc.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cont = warm_continue(params, X[:nw], y[:nw], 2,
                         lt.Booster(params=params, model_str=anchor), ds)
    torch.cuda.synchronize()
    wc_s = time.perf_counter() - t0
    wc_launches = dict(hc.LAUNCHES)
    n_anchor = lt.Booster(params=params, model_str=anchor).num_trees()
    emit({"phase": "streaming", "rows": n, "features": F,
          "chunk_rows": STREAM_CHUNK, "push_order": order,
          "routes_f32_f64_bulk": routes, "bulk_ingest_s": bulk_s,
          "bulk_bucketize_launches": bulk_launches, "push_s": push_s,
          "push_f64_host_s": push64_s,
          "push_bucketize_launches": push_launches["bucketize"],
          "push_f64_bucketize_launches": host_launches,
          "bitwise_bulk_f32": same32, "bitwise_bulk_f64_host": same64,
          "warm_continue_rows": nw, "warm_continue_s": wc_s,
          "warm_continue_trees": [n_anchor, cont.num_trees()],
          "warm_continue_launches": wc_launches, "nvidia_smi": smi})
    check(routes == ["device", "host", "device"],
          f"streamed / bulk binning routes {routes}")
    check(push_launches["bucketize"] == n // STREAM_CHUNK,
          f"#6 launched {push_launches['bucketize']} times for "
          f"{n // STREAM_CHUNK} f32 chunks")
    check(host_launches == 0, "the f64 chunks launched #6")
    check(same32, "the f32 stream's bins differ from the bulk Dataset's")
    check(same64, "the f64 stream's host bins differ from the bulk "
                  "Dataset's")
    check(cont.num_trees() == n_anchor + 2,
          f"warm_continue holds {cont.num_trees()} trees")
    check(wc_launches["bucketize"] == 1,
          f"warm_continue's f32 window launched #6 "
          f"{wc_launches['bucketize']} times")
    for name in ("build_histogram_slots", "take_leaf_values", "wave_pass",
                 "wave_relabel"):
        check(wc_launches[name] > 0, f"warm_continue never launched {name}")


_ONLINE_CHILD = """\
import json, sys
import numpy as np
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.online import (OnlineTrainer, SnapshotPublisher,
                                       TraceSource)
from lightgbm_tpu_torch.runtime.faults import active_plan
spec = json.load(open(sys.argv[1]))
X, y = np.load(spec["X"]), np.load(spec["y"])
params = spec["params"]
ds = lt.Dataset(X, label=y, params=dict(params))
plan = active_plan(spec["fault_plan"])
OnlineTrainer(params, spec["anchor"], ds,
              TraceSource(spec["trace"], fault_plan=plan),
              SnapshotPublisher(prefix=spec["prefix"], mode="files"),
              fault_plan=plan, checkpoint_dir=spec["ckpt"]).run()
"""


def _popen(here, d, name, argv, **kw):
    """Start `argv` with the package on its path, its output to d/name.log
    (a pipe left unread could fill and stall it)."""
    env = {**os.environ, "PYTHONPATH": here}
    env.pop("LIGHTGBM_TPU_FAULT_PLAN", None)
    with open(os.path.join(d, name + ".log"), "w") as log:
        proc = subprocess.Popen(argv, env=env, stdout=log,
                                stderr=subprocess.STDOUT, **kw)
    proc.log_path = log.name
    return proc


def _spawn(here, d, name, **spec):
    """Start the online child with `spec` (written to d/name.json)."""
    path = os.path.join(d, name + ".json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return _popen(here, d, name,
                  [sys.executable, os.path.join(d, "child.py"), path])


def _finish(proc, timeout=600):
    """(exit code, output) of a child, killed if it outlives `timeout`."""
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(proc.log_path) as f:
        return proc.returncode, f.read()


def _pctl(lat, q):
    return float(np.percentile(lat, q)) if lat else None


def online_phase(lt, hc, cli, torch, smi, here, params, ds, X, y, w,
                 anchor, mappers):
    """A13's online loop on the card (online/, engine.warm_continue):
    bench's model as the anchor and bench's Dataset as the frozen
    reference; a TraceSource of 2^18 new rows in 64 batches of 4096, a
    2^17-row window refreshed every 32768 rows: 6 refits and 2 continues
    of 4 trees, published (mode both) into a co-located binned session of
    task=online's serving stack (cli.build_serving: the registry, the
    micro-batcher, the default breaker), which four client threads query
    with single f32 rows (2 ms apart) through 1 s idle, the loop, 1 s
    idle. Checks: the summary counts; every snapshot's manifest, and its
    md5 equal to its offline arm on the card (anchor.refit /
    warm_continue on the same window); every answer within 1e-6 of
    Booster.predict of a generation live during its request, never older
    than the client's last; no failed request, no host fallback; the
    first continued tree equal to the plain versions'; #6 (the session)
    and the continues' kernels launched in the loop. Then a child process
    under kill@iter=5 with a checkpoint directory exits 17, and resumed
    publishes all 8 snapshots md5-equal to the loop's; a short loop under
    stall_source / corrupt_batch fires a staleness refresh and skips the
    corrupt batch; and `python -m lightgbm_tpu_torch task=online` on a
    small .npz trace exits 0 with output_model its last snapshot. The
    children and the CLI run beside the offline arms and the answers'
    check. Recorded: ms per refit, continue and
    publish; ms from a promote to the first answer of its generation;
    served p50 / p99 during refreshes and idle; the loop's rows a
    second."""
    import tempfile
    import threading
    from lightgbm_tpu_torch.engine import warm_continue
    from lightgbm_tpu_torch.online import (OnlineTrainer, SnapshotPublisher,
                                           TraceSource, save_trace)
    from lightgbm_tpu_torch.runtime.checkpoint import verify_manifest
    from lightgbm_tpu_torch.runtime.faults import FaultPlan
    from lightgbm_tpu_torch.runtime.profiler import StageProfiler
    dev = torch.device("cuda", 0)
    F = X.shape[1]
    rng = np.random.RandomState(47)
    Xs = rng.normal(size=(ONLINE_TRACE, F)).astype(np.float32)
    ys = (Xs @ w + rng.normal(scale=0.5, size=ONLINE_TRACE) > 0) \
        .astype(np.float64)
    Xq = np.random.RandomState(48).normal(size=(4096, F)).astype(np.float32)
    op = dict(params, **ONLINE_LOOP)
    cfg = lt.resolve_params(dict(op, serve_engine="binned",
                                 serve_request_timeout_ms=10000.0,
                                 online_serve=True,
                                 online_publish_mode="both"))
    tmp = tempfile.TemporaryDirectory(dir=here, prefix="lgbt_online_")
    d = tmp.name
    procs = []
    try:
        trace = os.path.join(d, "trace.npz")
        save_trace(trace, Xs, ys,
                   batch_sizes=[ONLINE_BATCH] * (ONLINE_TRACE // ONLINE_BATCH))
        metrics, breaker, registry, batcher = cli.build_serving(cfg)
        registry.register("default", anchor, bin_mappers=mappers)
        batcher.start()
        pub = SnapshotPublisher(prefix=os.path.join(d, "m"), mode="both",
                                registry=registry)
        swap_t, publish_ms = {}, []
        publish = pub.publish

        def timed_publish(text, it, extra=None):
            t0 = time.perf_counter()
            info = publish(text, it, extra)
            swap_t[it] = time.perf_counter()
            publish_ms.append((swap_t[it] - t0) * 1e3)
            return info
        pub.publish = timed_publish
        prof = StageProfiler(device=dev)
        trainer = OnlineTrainer(op, anchor, ds, TraceSource(trace), pub,
                                profiler=prof)
        state = {"tag": "idle"}
        refresh = trainer._refresh

        def tagged_refresh(reason):
            state["tag"] = "refresh"
            try:
                refresh(reason)
            finally:
                state["tag"] = "loop"
        trainer._refresh = tagged_refresh
        seen = [[] for _ in range(4)]
        errors, stop = [], threading.Event()

        def client(c):
            r = np.random.RandomState(100 + c)
            while not stop.is_set():
                i = int(r.randint(len(Xq)))
                tag = state["tag"]
                v0 = registry.session().version
                t0 = time.perf_counter()
                try:
                    p = float(np.asarray(batcher.predict(Xq[i:i + 1]))[0])
                except Exception as e:
                    errors.append(repr(e))
                    continue
                t1 = time.perf_counter()
                seen[c].append((i, v0, registry.session().version, p, t1,
                                (t1 - t0) * 1e3, tag))
                time.sleep(0.002)
        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(4)]
        for th in threads:
            th.start()
        time.sleep(1.0)
        hc.reset_launch_counts()
        torch.cuda.synchronize()
        state["tag"] = "loop"
        t0 = time.perf_counter()
        try:
            summary = trainer.run()
        finally:
            torch.cuda.synchronize()
            loop_s = time.perf_counter() - t0
            loop_launches = dict(hc.LAUNCHES)
            state["tag"] = "idle"
            time.sleep(1.0)
            stop.set()
            for th in threads:
                th.join(timeout=30)
            batcher.stop()
            registry.stop_watchers()
        host_fallbacks = metrics.counters.get("host_fallbacks", 0)
        swaps = metrics.counters.get("swaps", 0)
        snaps = [os.path.join(d, f"m.snapshot_iter_{k}.txt")
                 for k in range(1, 9)]
        gens = [anchor] + [open(p).read() for p in snaps]
        manifests = [verify_manifest(p)[0] for p in snaps]
        kinds = [json.load(open(p + ".manifest.json"))["kind"]
                 for p in snaps]

        # the killed child beside the offline arms
        np.save(os.path.join(d, "X.npy"), X)
        np.save(os.path.join(d, "y.npy"), y)
        with open(os.path.join(d, "child.py"), "w") as f:
            f.write(_ONLINE_CHILD)
        child = dict(X=os.path.join(d, "X.npy"), y=os.path.join(d, "y.npy"),
                     params=op, anchor=anchor, trace=trace,
                     prefix=os.path.join(d, "k"), ckpt=os.path.join(d, "ck"))
        t_kill = time.perf_counter()
        procs.append(_spawn(here, d, "kill", fault_plan="kill@iter=5",
                            **child))
        # task=online through the command line on a small trace
        nb = 1 << 14
        np.savetxt(os.path.join(d, "base.tsv"),
                   np.column_stack([y[:nb], X[:nb]]), delimiter="\t",
                   fmt="%.9g")
        save_trace(os.path.join(d, "small.npz"), Xs[:6 * ONLINE_BATCH],
                   ys[:6 * ONLINE_BATCH], batch_sizes=[ONLINE_BATCH] * 6)
        cli_out = os.path.join(d, "cli_model.txt")
        t_cli = time.perf_counter()
        procs.append(_popen(here, d, "cli", [
            sys.executable, "-m", "lightgbm_tpu_torch", "task=online",
            "data=base.tsv", "header=false", "label_column=0",
            "online_source=small.npz", f"output_model={cli_out}",
            "device_type=cuda", "objective=binary",
            f"num_leaves={N_LEAVES}", "max_bin=63", "num_iterations=4",
            "verbosity=-1", "batched_train=false",
            "online_window_rows=8192", "online_refresh_rows=8192",
            "online_continue_every=2", "online_continue_trees=2",
            "online_publish_mode=both", "online_serve=true",
            "serve_port=0"], cwd=d))

        # the offline arms on the card, and the first continued tree
        # against the plain versions'
        Xw64, anchor_k = Xs.astype(np.float64), anchor
        offline_md5, first_tree_err = [], None
        step, cap = ONLINE_LOOP["online_refresh_rows"], \
            ONLINE_LOOP["online_window_rows"]
        n_anchor = lt.Booster(params=params, model_str=anchor).num_trees()
        for k in range(1, 9):
            sl = slice(max(0, step * k - cap), step * k)
            if k % ONLINE_LOOP["online_continue_every"] == 0:
                b = warm_continue(
                    dict(op), Xw64[sl], ys[sl],
                    ONLINE_LOOP["online_continue_trees"],
                    lt.Booster(params={"device_type": "cuda"},
                               model_str=anchor_k), ds)
                if k == 4:
                    dsw = lt.Dataset(None, params=dict(op)).init_streaming(
                        sl.stop - sl.start, reference=ds)
                    dsw.push_rows(Xw64[sl], label=ys[sl]).mark_finished()
                    g = lt.Booster(params=dict(op), train_set=dsw)._gbdt
                    g.load_init_model(anchor_k)
                    plain = _plain_trees(torch, g, sl.stop - sl.start,
                                         scores=g.scores, it=g.iter)[0]
                    first_tree_err = _same_host_tree(
                        plain, b._gbdt.models[n_anchor])
                    del g, dsw
                anchor_k = b.model_to_string()
                text = anchor_k
            else:
                text = lt.Booster(params={"device_type": "cuda"},
                                  model_str=anchor_k).refit(
                    Xw64[sl], ys[sl], decay_rate=0.9).model_to_string()
            offline_md5.append(_md5(text) == _md5(gens[k]))
        kill_rc, kill_log = _finish(procs[0])
        kill_s = time.perf_counter() - t_kill
        killed_left = [os.path.exists(os.path.join(d, f"k.snapshot_iter_{k}"
                                                   ".txt")) for k in (4, 5)]

        # the resumed child beside the served answers' check and the
        # fault loop
        t_res = time.perf_counter()
        procs.append(_spawn(here, d, "resume", fault_plan="", **child))
        preds = [lt.Booster(params={"device_type": "cuda"},
                            model_str=g).predict(Xq) for g in gens]
        served = {"idle": [], "loop": [], "refresh": []}
        bad, back, first_answer = [], 0, {}
        for rows in seen:
            last = 0
            for i, v0, v1, p, t1, ms, tag in rows:
                served[tag].append(ms)
                ok = [v for v in range(max(v0, last), v1 + 1)
                      if abs(preds[v][i] - p) <= 1e-6]
                if not ok:
                    bad.append((i, v0, v1, p))
                    continue
                back += int(ok[0] < last)
                last = ok[0]
                for v in range(1, ok[0] + 1):
                    if v in swap_t and t1 >= swap_t[v]:
                        first_answer[v] = min(first_answer.get(v, 1e9),
                                              (t1 - swap_t[v]) * 1e3)
        n_req = sum(len(r) for r in seen)
        rec = list(prof.ring)
        refit_ms = [r["stages_s"]["online_refit"] * 1e3 for r in rec
                    if "online_refit" in r["stages_s"]]
        cont_ms = [r["stages_s"]["online_continue"] * 1e3 for r in rec
                   if "online_continue" in r["stages_s"]]

        # stall_source and corrupt_batch on a short loop
        plan = FaultPlan.parse("stall_source@batch=1:ms=500,"
                               "corrupt_batch@batch=2")
        fault = OnlineTrainer(
            dict(op, online_max_staleness_s=0.2, online_continue_every=0),
            anchor, ds, TraceSource((Xs[:4 * ONLINE_BATCH],
                                     ys[:4 * ONLINE_BATCH], None,
                                     [ONLINE_BATCH] * 4), fault_plan=plan),
            SnapshotPublisher(prefix=os.path.join(d, "f"), mode="files"),
            fault_plan=plan)
        fsum = fault.run()

        cli_rc, cli_log = _finish(procs[1])
        cli_s = time.perf_counter() - t_cli
        cli_last = cli_out + ".snapshot_iter_3.txt"
        cli_same = (cli_rc == 0 and os.path.exists(cli_last)
                    and _md5(open(cli_out).read())
                    == _md5(open(cli_last).read()))
        res_rc, res_log = _finish(procs[2])
        res_s = time.perf_counter() - t_res
        resumed_md5 = [os.path.exists(os.path.join(
            d, f"k.snapshot_iter_{k}.txt")) and _md5(open(os.path.join(
                d, f"k.snapshot_iter_{k}.txt")).read()) == _md5(gens[k])
            for k in range(1, 9)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        tmp.cleanup()
    emit({"phase": "online", "rows_trace": ONLINE_TRACE,
          "batch_rows": ONLINE_BATCH, **ONLINE_LOOP, "features": F,
          "leaves": N_LEAVES, "summary": summary, "kinds": kinds,
          "manifests_ok": manifests, "offline_md5_equal": offline_md5,
          "loop_s": loop_s, "loop_rows_per_s": ONLINE_TRACE / loop_s,
          "refit_ms": refit_ms, "continue_ms": cont_ms,
          "publish_ms": publish_ms,
          "promote_to_first_answer_ms": [first_answer.get(v)
                                         for v in range(1, 9)],
          "served_requests": n_req, "failed_requests": len(errors),
          "errors": errors[:5], "answers_off": len(bad),
          "answers_off_first": bad[:3], "generation_went_back": back,
          "served_ms": {t: {"n": len(v), "p50": _pctl(v, 50),
                            "p99": _pctl(v, 99)}
                        for t, v in served.items()},
          "host_fallbacks": host_fallbacks, "swaps": swaps,
          "loop_launches": loop_launches,
          "first_continued_tree_same": first_tree_err is not None,
          "first_continued_tree_leaf_max_abs_err": first_tree_err,
          "kill_exit_code": kill_rc, "kill_child_s": kill_s,
          "killed_left_snapshots_4_5": killed_left,
          "resume_exit_code": res_rc, "resume_child_s": res_s,
          "resumed_md5_equal": resumed_md5, "faults_summary": fsum,
          "corrupted_batches": fault.source.corrupted_batches,
          "cli_exit_code": cli_rc, "cli_s": cli_s,
          "cli_output_equals_last_snapshot": cli_same,
          "hbm_peak_bytes": prof.hbm_peak_bytes, "nvidia_smi": smi})
    check(summary == {"publishes": 8, "last_iteration": 8, "refits": 6,
                      "continues": 2,
                      "consumed_batches": ONLINE_TRACE // ONLINE_BATCH,
                      "consumed_rows": ONLINE_TRACE, "skipped_batches": 0,
                      "stale_refreshes": 0,
                      "window_rows": ONLINE_LOOP["online_window_rows"]},
          f"online summary {summary}")
    check(kinds == ["refit"] * 3 + ["continue"] + ["refit"] * 3
          + ["continue"], f"refresh kinds {kinds}")
    check(all(manifests), f"snapshot manifests {manifests}")
    check(all(offline_md5), f"snapshots against their offline arms "
                            f"{offline_md5}")
    check(not errors and not bad and back == 0,
          f"served answers: {len(errors)} failed, {len(bad)} off, "
          f"{back} older generations ({errors[:2]}, {bad[:2]})")
    check(host_fallbacks == 0 and swaps == 8,
          f"host_fallbacks {host_fallbacks}, swaps {swaps}")
    check(first_tree_err is not None and first_tree_err <= 1e-6,
          f"the first continued tree differs from the plain versions' "
          f"({first_tree_err})")
    for name in ("bucketize", "build_histogram_slots", "take_leaf_values",
                 "wave_pass", "wave_relabel"):
        check(loop_launches[name] > 0, f"the online loop never launched "
                                       f"{name}")
    check(kill_rc == 17 and killed_left == [True, False],
          f"the killed child exited {kill_rc} leaving snapshots 4 / 5 "
          f"{killed_left}: {kill_log[-2000:]}")
    check(res_rc == 0 and all(resumed_md5),
          f"the resumed child exited {res_rc}, md5 {resumed_md5}: "
          f"{res_log[-2000:]}")
    check(fsum["stale_refreshes"] == 1 and fsum["skipped_batches"] == 1
          and fsum["publishes"] == 2 and fault.source.corrupted_batches == 1,
          f"the fault loop's summary {fsum}")
    check(cli_same, f"task=online exited {cli_rc}: {cli_log[-2000:]}")


DIST_W = 2                    # rank processes on the one card
DIST_TIME_OUT = 60            # the group's time_out (s)
DIST_ROUNDS = 4               # data-parallel rounds (2 for the others)
# the kernels of the slice's path (#1-#6)
DIST_KERNELS = ("build_histogram_slots", "take_leaf_values", "wave_pass",
                "wave_apply", "wave_relabel", "bucketize")


def _tree_fields(t):
    """A host tree's structure and values as JSON lists (`_split_divergence`
    and `_same_host_tree` read them back through `_TreeView`)."""
    keys = ("split_feature", "threshold_in_bin", "decision_type",
            "left_child", "right_child", "split_gain", "leaf_value",
            "cat_boundaries", "cat_threshold")
    out = {k: np.asarray(getattr(t, k)).tolist() for k in keys}
    out.update(num_leaves=int(t.num_leaves), num_cat=int(t.num_cat))
    return out


class _TreeView:
    def __init__(self, d):
        for k, v in d.items():
            setattr(self, k, np.asarray(v) if isinstance(v, list) else v)


def _trees_md5(bst):
    """md5 of a model text without its `[...]` parameter lines (the runs
    of one configuration differ there only by the parameters asked)."""
    return _md5("\n".join(ln for ln in bst.model_to_string().splitlines()
                          if not ln.startswith("[")))


def dist_rank(spec_path):
    """One rank of the `distributed` line (a process of `launch_local`):
    joins the gloo group on the card, ingests bench's table through #6,
    keeps its row block, and trains every configuration of the line in
    turn, writing its results to the spec's directory."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    from lightgbm_tpu_torch.parallel import DistContext, init_distributed
    from lightgbm_tpu_torch.runtime.autotune import probe_comm_modes
    with open(spec_path) as f:
        spec = json.load(f)
    rank = int(os.environ["LIGHTGBM_TPU_RANK"])
    W = int(os.environ["LIGHTGBM_TPU_NPROC"])
    # the ranks share the host's cores: a pool of one a core in each
    # would oversubscribe them
    torch.set_num_threads(2)
    out = {"rank": rank, "pid": os.getpid()}
    t_start = time.perf_counter()
    init_distributed(num_machines=W, device_type="cuda",
                     time_out=DIST_TIME_OUT)
    out["device"] = str(torch.device("cuda", torch.cuda.current_device()))
    rng = np.random.RandomState(42)
    X = rng.normal(size=(N_ROWS, N_FEAT)).astype(np.float32)
    w = rng.normal(size=N_FEAT)
    y = (X @ w + rng.normal(scale=0.5, size=N_ROWS) > 0).astype(np.float32)
    base = dict(spec["params"], num_machines=W, tree_learner="data",
                time_out=DIST_TIME_OUT, autotune_cache=spec["cache"])
    if spec["mode"] == "kill":
        # rank 1 dies before iteration 2 (on 2^16 rows: the check is of
        # the group's end, not of its work); the survivor blocks in a
        # collective until the launcher ends it
        with open(os.path.join(spec["dir"], f"pid{rank}.txt"), "w") as f:
            f.write(str(os.getpid()))

        def mark(env):
            with open(os.path.join(spec["dir"], f"iter{rank}.txt"),
                      "w") as f:
                f.write(repr(time.time()))
        n = 1 << 16
        lt.train({**base, "fault_plan": "kill@iter=2" if rank == 1
                  else ""}, lt.Dataset(X[:n], label=y[:n], params=base), 3,
                 callbacks=[mark])
        return 0
    hc.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = lt.Dataset(X, label=y, params=base).construct()
    torch.cuda.synchronize()
    out["ingest_s"] = time.perf_counter() - t0
    out["ingest_launches"] = dict(hc.LAUNCHES)
    out["ready_s"] = time.perf_counter() - t_start
    runs = {}

    def run(name, over, rounds, d=None):
        p = {**base, **over}
        t_run = time.perf_counter()
        bst, launches, iter_ms, aucs = _train_timed(lt, hc, torch, p,
                                                    d or ds, rounds)
        g = bst._gbdt
        train_s = time.perf_counter() - t_run
        rec = {"md5": _trees_md5(bst), "ms_per_round": iter_ms,
               "auc_per_round": aucs, "launches": launches,
               "grow_route": g.grow_route, "use_dist": g.use_dist,
               "mode": g.grow_cfg.parallel_hist_mode,
               "comm": g._comm_profile,
               "comm_s": g.dist.comm_seconds,
               "comm_calls": g.dist.comm_calls,
               "comm_bytes_sent": g.dist.comm_bytes,
               "exchange_share": g.dist.comm_seconds / train_s,
               "tree0": _tree_fields(g.models[0]),
               "leaves": [t.num_leaves for t in g.models]}
        runs[name] = rec
        return bst, rec
    bst, rec = run("allreduce", {"parallel_hist_mode": "allreduce"},
                   DIST_ROUNDS)
    # the first tree again from the same gradients with the plain
    # versions on the card, over the group
    rec["plain_leaf_value_max_abs_err"] = _same_host_tree(
        _plain_trees(torch, bst._gbdt, N_ROWS)[0], bst._gbdt.models[0])
    del bst
    run("reduce_scatter", {"parallel_hist_mode": "reduce_scatter"},
        DIST_ROUNDS)
    for mode in ("allreduce", "reduce_scatter"):
        run(f"quantized_{mode}", {"parallel_hist_mode": mode,
                                  "use_quantized_grad": True}, 2)
    # packed lanes need a global row count pack_safe admits (at most
    # 6553 rows at num_grad_quant_bins=4): the first 4096 rows
    small = lt.Dataset(X[:4096], label=y[:4096], params=base)
    for mode in ("allreduce", "reduce_scatter"):
        run(f"packed_{mode}", {"parallel_hist_mode": mode,
                               "use_quantized_grad": True}, 2, small)
    run("feature", {"tree_learner": "feature"}, 2)
    run("voting", {"tree_learner": "voting", "top_k": 20}, 2)
    # pre_partition: the rank's 2^19 rows only, its 14 features binned
    half = N_ROWS // W
    pp = {**base, "pre_partition": True}
    lo = rank * half
    dpp = lt.Dataset(X[lo:lo + half], label=y[lo:lo + half], params=pp)
    _, rec = run("pre_partition", {"pre_partition": True}, 2, dpp)
    rec["local_rows"] = half
    rec["mappers_md5"] = _md5(json.dumps(
        [m.to_dict() for m in dpp._handle.mappers], sort_keys=True))
    # planted in rank 1's parameters only: every rank learns of it
    bst, rec = run("fail_collective", {
        "parallel_hist_mode": "reduce_scatter",
        "fault_plan": "fail_collective@iter=1:times=2" if rank == 1
        else "",
        "device_profile": True},
        DIST_ROUNDS)
    g = bst._gbdt
    rec.update(collective_failures=g._collective_failures,
               decision=g.autotune_decision,
               stragglers=g.profiler.straggler_report())
    del bst, g
    dist = DistContext()
    out["probe_comm_modes_s"] = probe_comm_modes(dist, N_FEAT, N_BINS)
    out["runs"] = runs
    with open(os.path.join(spec["dir"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _launch_ranks(here, d, mode, params, timeout):
    """launch_local of DIST_W ranks of `dist_rank` in `mode`; (seconds,
    the launcher's error or None, the wall clock when it returned)."""
    from lightgbm_tpu_torch.launch import launch_local
    spec = os.path.join(d, f"{mode}.json")
    with open(spec, "w") as f:
        json.dump({"mode": mode, "dir": d, "params": params,
                   "cache": os.path.join(d, "autotune.json")}, f)
    env = {"PYTHONPATH": here, "LIGHTGBM_TPU_FAULT_PLAN": ""}
    t0 = time.perf_counter()
    err = None
    try:
        launch_local(DIST_W, [sys.executable, "-c",
                              "import sys, chip_smoke; "
                              "sys.exit(chip_smoke.dist_rank(sys.argv[1]))",
                              spec], env_extra=env, timeout=timeout)
    except RuntimeError as e:
        err = str(e)
    return time.perf_counter() - t0, err, time.time()


def distributed_phase(lt, torch, smi, here, params, bst, X, y,
                      single_ms, auc4):
    """A16 on the card: DIST_W = 2 rank processes of one gloo group on
    cuda:0 (host-staged collectives; see the module docstring's
    `distributed` entry), beside the single-process bench run (`bst`, its
    per-iteration ms a round `single_ms`, its train AUC after 4 rounds
    `auc4`); then a group whose rank 1 is killed, and a two-shard serving
    session on the one card."""
    import tempfile
    from lightgbm_tpu_torch.runtime.autotune import load_disk_cache
    p = {k: v for k, v in params.items() if k != "binning_impl"}
    p["binning_impl"] = "auto"
    with tempfile.TemporaryDirectory(prefix="lgbt_dist_") as d:
        group_s, err, _ = _launch_ranks(here, d, "train", p, 600)
        check(err is None, f"the distributed group failed: {err}")
        res = [json.load(open(os.path.join(d, f"rank{r}.json")))
               for r in range(DIST_W)]
        cache = load_disk_cache(os.path.join(d, "autotune.json"))
        kill_s, kill_err, t_end = _launch_ranks(here, d, "kill", p,
                                                DIST_TIME_OUT + 120)

        def read(name):
            paths = [os.path.join(d, f"{name}{r}.txt")
                     for r in range(DIST_W)]
            return [float(open(q).read()) for q in paths
                    if os.path.exists(q)]
        marks, kill_pids = read("iter"), [int(v) for v in read("pid")]
        kill_after_mark_s = t_end - max(marks) if marks else None
    runs = [r["runs"] for r in res]
    names = list(runs[0])
    r0 = runs[0]
    t0 = bst._gbdt.models[0]
    line = {"phase": "distributed", "ranks": DIST_W, "rows": N_ROWS,
            "features": N_FEAT, "leaves": N_LEAVES, "max_bin": 63,
            "backend": "gloo (host-staged, ranks sharing cuda:0)",
            "nvidia_smi": smi, "group_s": group_s,
            "rank_ready_s": [r["ready_s"] for r in res],
            "ingest_s": [r["ingest_s"] for r in res],
            "ingest_bucketize_by_rank": [r["ingest_launches"]["bucketize"]
                                         for r in res],
            "single_process_ms_per_round": single_ms,
            "probe_comm_modes_s": [r["probe_comm_modes_s"] for r in res]}
    checks = []
    for n in names:
        md5s = {rr[n]["md5"] for rr in runs}
        rec = r0[n]
        line[n] = {k: rec[k] for k in (
            "ms_per_round", "auc_per_round", "grow_route", "mode", "comm",
            "exchange_share", "comm_calls", "comm_bytes_sent", "leaves")}
        line[n]["launches_by_rank"] = [
            {k: rr[n]["launches"][k] for k in DIST_KERNELS}
            for rr in runs]
        line[n]["ranks_md5_equal"] = len(md5s) == 1
        checks.append((len(md5s) == 1, f"{n}: the ranks' models differ"))
        checks.append((all(rr[n]["use_dist"] for rr in runs),
                       f"{n}: a rank trained serially"))
        kernels = ["build_histogram_slots", "take_leaf_values"]
        kernels += ["wave_apply"] if n == "feature" else ["wave_pass",
                                                          "wave_relabel"]
        for rr in runs:
            checks.append((all(rr[n]["launches"][k] > 0 for k in kernels),
                           f"{n}: {kernels} not all launched on a rank: "
                           f"{rr[n]['launches']}"))
    for r in res:
        checks.append((r["ingest_launches"]["bucketize"] > 0,
                       "a rank's ingest did not launch bucketize"))
        checks.append((r["runs"]["pre_partition"]["launches"]
                       ["bucketize"] > 0,
                       "a rank's pre-partitioned ingest did not launch "
                       "bucketize"))
    checks += [
        (r0["allreduce"]["md5"] == r0["reduce_scatter"]["md5"],
         "allreduce and reduce_scatter grew different models"),
        (r0["quantized_allreduce"]["md5"]
         == r0["quantized_reduce_scatter"]["md5"],
         "quantized allreduce and reduce_scatter grew different models"),
        (r0["quantized_allreduce"]["comm"]["comm_packed"] is False,
         "packed lanes at 2^20 rows (pack_safe should refuse)"),
        (r0["packed_allreduce"]["md5"] == r0["packed_reduce_scatter"]["md5"]
         and r0["packed_allreduce"]["comm"]["comm_packed"] is True,
         "packed lanes on 4096 rows: modes differ or lanes not packed"),
        (r0["feature"]["grow_route"] == "apply"
         and r0["allreduce"]["grow_route"] == "mega"
         and r0["voting"]["grow_route"] == "mega",
         "routes: feature apply, data and voting mega"),
        (len({rr["pre_partition"]["mappers_md5"] for rr in runs}) == 1,
         "pre_partition: the ranks' merged mappers differ")]
    # the first trees: the single process's, parted only at float ties
    div = {}
    for n in ("allreduce", "feature"):
        n_eq, at, gains = _split_divergence(
            t0, _TreeView(r0[n]["tree0"]))
        div[n] = {"equal_splits": n_eq, "first_divergence": at,
                  "gains_at_divergence": gains}
        tie = (at is None or (gains[0] is not None and abs(
            gains[0] - gains[1]) <= 1e-5 * max(abs(gains[0]),
                                               abs(gains[1]))))
        checks.append((tie, f"{n}: tree 0 parts from the single process's "
                            f"at node {at} with gains {gains}"))
    line["tree0_vs_single_process"] = div
    plain = r0["allreduce"]["plain_leaf_value_max_abs_err"]
    line["plain_first_tree_leaf_value_max_abs_err"] = plain
    checks.append((plain is not None and plain <= 1e-6,
                   f"the plain versions' first tree differs ({plain})"))
    auc_d = r0["allreduce"]["auc_per_round"][-1]
    line["auc_single_4_rounds"] = auc4
    checks.append((abs(auc_d - auc4) <= 1e-3,
                   f"data-parallel AUC {auc_d} vs single process {auc4}"))
    fc = r0["fail_collective"]
    pinned = [k for k, v in cache.items() if k.endswith("_mesh2")
              and v.get("pinned") and v.get("parallel_hist_mode")
              == "allreduce"]
    fails_by_rank = [r["runs"]["fail_collective"]["collective_failures"]
                     for r in res]
    line["fail_collective"].update(
        collective_failures=fails_by_rank,
        pinned_cache_keys=pinned, stragglers=fc["stragglers"])
    checks += [
        (fc["md5"] == r0["reduce_scatter"]["md5"],
         "the degraded run differs from the reduce_scatter run"),
        (all(r["runs"]["fail_collective"]["mode"] == "allreduce"
             for r in res) and fails_by_rank == [2] * DIST_W,
         f"no degrade on every rank: mode {fc['mode']}, failures by rank "
         f"{fails_by_rank}"),
        (bool(pinned), f"no pinned _mesh2 decision in the cache: {cache}")]
    # the kill: the launcher raises, every worker gone, within time_out
    alive = []
    for pid in kill_pids:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except ProcessLookupError:
            pass
    line["kill"] = {"launcher_error": kill_err, "launch_s": kill_s,
                    "raise_after_last_round_s": kill_after_mark_s}
    checks += [
        (kill_err is not None and "worker exit codes" in kill_err
         and "17" in kill_err, f"the killed group: {kill_err}"),
        (kill_after_mark_s is not None
         and kill_after_mark_s <= DIST_TIME_OUT + 30,
         f"the killed group ended {kill_after_mark_s} s after its last "
         "round"),
        (len(kill_pids) == DIST_W and not alive,
         f"workers left alive: {alive} of {kill_pids}")]
    # sharded serving on the one card: rounds to 1, scores as unsharded
    from lightgbm_tpu_torch.utils import log as tlog
    logs, prev, verb = [], tlog._logger, tlog._verbosity
    tlog.register_logger(type("L", (), {"info": logs.append,
                                        "warning": logs.append})())
    tlog.set_verbosity(0)
    try:
        sh = bst.serve(engine="device", num_shards=2)
    finally:
        tlog.register_logger(prev)
        tlog.set_verbosity(verb)
    Xq = X[:4096]
    same = np.array_equal(sh.predict(Xq),
                          bst.serve(engine="device").predict(Xq))
    warned = any("num_shards=2 rounded to 1" in m for m in logs)
    line["serve_num_shards_2"] = {"num_shards": sh.num_shards,
                                  "warned": warned, "bitwise": same}
    checks.append((sh.num_shards == 0 and warned and same,
                   f"num_shards=2 on one card: {line['serve_num_shards_2']}"))
    emit(line)
    for ok, what in checks:
        check(ok, "distributed: " + what)


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
        from lightgbm_tpu_torch.ops.predict_binned import mappers_for
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
    # the Criteo model serves again as a fleet tenant (its text and mappers)
    criteo_tenant = (bst_c.model_to_string(), mappers_for(g_c))
    del bst_c, ds_c, h_c, g_c
    apply_storages.append(efb_phase(lt, hc, torch))
    narrow_cat_phase(lt, hc, torch)
    krec["wave_apply"] = wave_apply_phase(hc, torch, dev, apply_storages)
    del apply_storages

    # ---- 13. every objective, multiclass [K, N] scores, ranking, and
    # per-node sampling
    # the softmax model serves again as the fleet's 5-class tenant
    mc_tenant = multiclass_phase(lt, hc, torch, dev, X, w, smi)[1]
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

    # ---- 21. past the leaf cap: the changed kernels at L = 8192 and
    # 131072, bench at 16384 leaves, Criteo (#4) and fused (#9) at 8192
    lc_rec = leaf_cap_phase(lt, hc, gf, torch, dev, params, ds,
                            params_criteo, ds_criteo)

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

    # ---- 22. the overload path: admission, the breaker with the serving
    # fault hooks, deadlines, the HTTP server, snapshot watching
    overload_phase(lt, hc, torch, smi, here, bst, X)

    # ---- 23. A18(b)'s rest: the bench, Criteo and 5-class models as
    # tenants: the stacked bucketize kernel, the fleet unfused and fused,
    # the exported artifact and the compiled engine, the fleet's CLI server
    tenants = {"bench": (bst.model_to_string(), mappers_for(gbdt)),
               "criteo": criteo_tenant, "mc5": mc_tenant}
    qs = _tenant_queries()
    krec["bucketize_stacked"] = stacked_bucketize_phase(
        bk, torch, dev, smi, tenants, qs)
    fleet_launches = fleet_phase(hc, torch, smi, tenants, qs)
    export_phase(lt, hc, torch, smi, here, tenants, qs)
    fleet_cli_phase(lt, smi, here, tenants, qs)

    # ---- 24. A13: the streaming Dataset through #6, warm_continue, and
    # the online loop with co-located serving, kill / resume and faults
    from lightgbm_tpu_torch import cli
    anchor = tenants["bench"][0]
    streaming_phase(lt, hc, torch, smi, params, ds, X, y, anchor)
    online_phase(lt, hc, cli, torch, smi, here, params, ds, X, y, w, anchor,
                 tenants["bench"][1])

    # ---- 25. A16: data-parallel, feature-parallel and voting training
    # over a gloo group of rank processes on the card, the comm probe, the
    # collective degrade, a killed rank; sharded serving on one card
    auc4 = _auc(bst.predict(X, num_iteration=4, raw_score=True), y > 0.5)
    distributed_phase(lt, torch, smi, here, params, bst, X, y,
                      float(np.mean(iter_ms[1:])), auc4)

    src = {"build_histogram_slots": "hist_slots.cu",
           "take_leaf_values": "take_leaf_values.cu",
           "wave_pass": "wave_pass.cu", "wave_relabel": "wave_relabel.cu",
           "bucketize": "bucketize.cu", "wave_apply": "wave_apply.cu",
           "hist_rowwise": "hist_rowwise.cu",
           "hist_rowwise_packed": "hist_rowwise.cu",
           "wave_pass_fused": "wave_pass_fused.cu",
           "wave_pass_fused_tiled": "wave_pass_fused_tiled.cu",
           "window_partition": "window_partition.cu",
           "bucketize_stacked": "bucketize_stacked.cu"}
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
        "window_partition": "lightgbm_tpu/ops/grow_fast.py:218",
        # all-XLA there, no pallas_call: the port's kernel of the fleet's
        # fused drain
        "bucketize_stacked": "lightgbm_tpu/ops/bucketize.py:448"}
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
    # the stacked bucketize's launches on the fused fleet's traffic
    launches["bucketize_stacked"] = fleet_launches["bucketize_stacked"]
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
            "uint16": uint16 or None,
            "leaf_cap": {str(L): {k: w[k] for k in (
                "ms", "device_ms", "ms_255", "device_ms_255", "plain_ms",
                "bound_ms", "bound_by", "map_bytes")}
                for L, w in lc_rec.get(name, {}).items()} or None,
            "pass": True})
    low = [(k["name"], k["device_ms"], k["bound_ms"]) for k in kernels
           if k["device_ms"] < k["bound_ms"]]
    check(not low, f"device times below their bounds (a partial profiler "
                   f"capture): {low}")
    emit({"kernels": kernels})
    for line in smi:
        print(line)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
