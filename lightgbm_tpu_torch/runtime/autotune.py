"""Init-time strategy autotuning via short timed probes.

Counterpart of lightgbm_tpu/runtime/autotune.py. The reference picks its
histogram layout by measurement (``TrainingShareStates::InitTrain`` times
row-wise against col-wise histogram construction on the real data,
src/io/train_share_states.cpp); this module does the same for the port's
degrees of freedom:

 * the grower — ``wave`` (ops/grow_wave.py), ``compact``
   (ops/grow_fast.py), ``masked`` (ops/grow.py) — by growing one probe tree
   per feasible candidate on a row subsample of the REAL binned matrix with
   synthetic gradients from a fixed seed;
 * the histogram implementation, when config left ``histogram_impl=auto``:
   each distinct route of ops/histogram.py:hist_route ("slots",
   "rowwise", "rowwise_packed") is timed once at a wave's slot count, and
   its time is reported under every candidate name that takes it;
 * the fused wave (histogram_impl="fused"), when the wave grower won: one
   synthetic wave of the two-pass kernels plus the split search against
   the fused kernel (#3 + search against #9 on at most 32 storage
   columns, #4 + #1 + search against #10 past them).

``rows_per_chunk`` has no counterpart: the Hopper kernels plan their own
tiles (ops/histogram_cuda.py:plan_hist_tiles), so a decision carries the
configured value (``tpu_rows_per_block * 8``) and empty ``chunk_timings``.
The communication probes wait for distributed training, which the port
refuses before they could run.

Decisions are cached in-process and on disk under the JAX package's key,
(n_rows, n_features, max_bin, num_leaves, device kind[, fused variant]);
the device kind is ``torch.cuda.get_device_name`` on the card and "cpu"
on the CPU, so the CPU key is the JAX package's. The default cache file is
``~/.cache/lightgbm_tpu_torch/autotune.json`` (the two packages' timings
on one host mean different code); ``LIGHTGBM_TPU_AUTOTUNE_CACHE`` and the
``autotune_cache`` parameter override it.

Determinism: probe gradients come from a fixed ``seed`` and the clock is
injectable (``timer``); each probe calls it as the JAX package's does,
``t0 = timer()`` before the timed call and ``timer() - t0`` after it, so a
fake clock gives both packages the same timings. Ties within ``TIE_TOL``
resolve by ``AUTOTUNE_PREFERENCE``, the ladder's order.

Unlike the JAX package, which drops a candidate whose probe raises (its
Pallas kernels may be missing on a backend), every probe here launches a
built kernel (on the card) or its plain version (on the CPU): an exception
propagates.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

# ladder order (models/gbdt.py grower selection): on a timing tie the
# autotuner must agree with the memory ladder's preference
AUTOTUNE_PREFERENCE = ("wave", "wave_exact", "compact", "masked")

# two timings within 2% are a tie (probe noise floor)
TIE_TOL = 0.02

DEFAULT_PROBE_ROWS = 65536

# histogram implementation candidates, in the JAX package's tie
# preference (the "auto" default's names first, so a tie reproduces the
# untuned route; the row-wise layouts must win outright). The three
# col-wise names are one route on the card ("slots", ops/histogram.py).
HIST_IMPL_CANDIDATES = ("tiered_hilo", "tiered", "legacy", "rowwise",
                        "rowwise_packed")
# force_col_wise restricts the probe to these (models/gbdt.py)
COL_WISE_HIST_IMPLS = ("tiered_hilo", "tiered", "legacy")

# in-process decision cache: key -> decision dict
_MEM_CACHE: Dict[str, Dict[str, Any]] = {}

# the decision a resumed run carries (runtime/checkpoint.py): a trainer
# built inside `pinned_decision` takes it instead of probing
_PINNED: contextvars.ContextVar = contextvars.ContextVar(
    "lightgbm_tpu_torch_autotune_pinned", default=None)


@contextlib.contextmanager
def pinned_decision(decision: Optional[Dict[str, Any]]):
    """Trainers built inside take `decision` (None: probe as usual)."""
    token = _PINNED.set(decision)
    try:
        yield
    finally:
        _PINNED.reset(token)


def current_pin() -> Optional[Dict[str, Any]]:
    return _PINNED.get()


def _device(device: Optional[torch.device]) -> torch.device:
    """`device`, or by default the current CUDA device when there is one,
    else the CPU."""
    if device is not None:
        return torch.device(device)
    return (torch.device("cuda", torch.cuda.current_device())
            if torch.cuda.is_available() else torch.device("cpu"))


def device_kind_of(device: Optional[torch.device] = None) -> str:
    """The device kind of the cache key: the CUDA device's name
    (``NVIDIA H100 80GB HBM3``) or "cpu" (`device` None: `_device`'s
    default)."""
    device = _device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def make_key(n_rows: int, n_features: int, max_bin: int, num_leaves: int,
             device_kind: str = "", variant: str = "") -> str:
    """Cache key over the shape signature that determines kernel choice.

    ``variant`` carries the fused-kernel shape signature (feature tile /
    relabel fusion, ``fused_variant_sig``) so a decision probed under one
    tiling never routes a differently-tiled run."""
    dk = str(device_kind or device_kind_of()).replace(" ", "_")
    suffix = f"_{variant}" if variant else ""
    return f"r{int(n_rows)}_f{int(n_features)}_b{int(max_bin)}" \
           f"_l{int(num_leaves)}_{dk}{suffix}"


# default fused-kernel shape signature: folded into the UNsuffixed key
_DEFAULT_FUSED_SIG = "t32rf1"


def fused_variant_sig(cfg) -> str:
    """Tile / variant signature of the fused kernels' configuration, part
    of the decision-cache key (empty = the default signature)."""
    tile = int(getattr(cfg, "fused_feature_tile", 32))
    rf = int(bool(getattr(cfg, "fused_relabel_fusion", True)))
    sig = f"t{tile}rf{rf}"
    return "" if sig == _DEFAULT_FUSED_SIG else sig


def default_cache_path() -> str:
    env = os.environ.get("LIGHTGBM_TPU_AUTOTUNE_CACHE", "")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "lightgbm_tpu_torch", "autotune.json")


def load_disk_cache(path: str) -> Dict[str, Dict[str, Any]]:
    """The decisions in `path`; {} when the file is missing or not a JSON
    object (a cold cache, never a training failure)."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}


def save_disk_cache(path: str, cache: Dict[str, Dict[str, Any]]) -> None:
    """Write the decisions atomically; a directory that cannot be written
    leaves a cold cache for the next run, never a training failure."""
    try:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(cache, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass


def _subsample(X_t: torch.Tensor, probe_rows: int) -> torch.Tensor:
    n = int(X_t.shape[1])
    m = max(min(int(probe_rows), n), 1)
    return X_t[:, :m].contiguous()


def _best_of_2(fn: Callable[[], Any], timer: Callable[[], float],
               device: torch.device) -> float:
    """One warm call (the kernels' build and first launch), then the best
    of two fenced calls on `timer`."""
    from .profiler import device_barrier
    fn()
    best = float("inf")
    for _ in range(2):
        device_barrier(device)
        t0 = timer()
        fn()
        device_barrier(device)
        best = min(best, timer() - t0)
    return best


def _storage_tiers(cfg, num_cols: int) -> tuple:
    """cfg.hist_tiers when they describe the storage's columns, else ()
    (ops/grow_wave.py:wave_routes' guard)."""
    tiers = tuple(int(t) for t in getattr(cfg, "hist_tiers", ()))
    return tiers if len(tiers) == num_cols else ()


def probe_strategies(X_t: torch.Tensor, meta, cfg,
                     candidates: Sequence[str],
                     probe_rows: int = DEFAULT_PROBE_ROWS, seed: int = 0,
                     timer: Callable[[], float] = time.perf_counter,
                     ) -> Dict[str, float]:
    """Grow one probe tree per candidate grower on the first `probe_rows`
    rows of the real binned matrix; return {candidate: best_of_2_seconds}.

    Gradients are synthetic (fixed ``seed``, binary-like: uniform grad in
    [-0.5, 0.5), constant hessian 0.25), so the probe runs the real split
    math without touching training state. Each probe builds its own
    state for the subsample (the wave grower's buffers, a serial grower's
    windows, a row-wise route's plan and nibble pack); none of the
    training run's is reused."""
    from ..ops.grow import grow_tree, serial_hist_route
    from ..ops.grow_fast import grow_tree_fast
    from ..ops.grow_wave import grow_tree_wave, wave_routes
    from ..ops.histogram import make_hist_plan

    dev = X_t.device
    Xs = _subsample(X_t, probe_rows)
    F, m = Xs.shape
    rng = np.random.RandomState(seed)
    g = torch.from_numpy(
        rng.uniform(-0.5, 0.5, size=m).astype(np.float32)).to(dev)
    h = torch.full((m,), 0.25, dtype=torch.float32, device=dev)
    bag = torch.ones((m,), dtype=torch.float32, device=dev)

    timings: Dict[str, float] = {}
    for name in candidates:
        cfg_c = cfg._replace(wave_exact=(name == "wave_exact"))
        if name in ("wave", "wave_exact"):
            route = wave_routes(cfg_c, F)[1]
            plan = make_hist_plan(Xs, route, cfg_c.hist_tiers)

            def run(_cfg=cfg_c, _plan=plan):
                return grow_tree_wave(Xs, g, h, bag, meta, _cfg, None,
                                      hist_plan=_plan, rng_seed=seed)
        else:
            fn = grow_tree_fast if name == "compact" else grow_tree
            route = serial_hist_route(cfg_c, F)
            plan = make_hist_plan(Xs, route, cfg_c.hist_tiers)

            def run(_fn=fn, _cfg=cfg_c, _plan=plan):
                return _fn(Xs, g, h, bag, meta, _cfg, None, hist_plan=_plan)
        timings[name] = _best_of_2(run, timer, dev)
    return timings


def probe_hist_impls(X_t: torch.Tensor, cfg,
                     impl_candidates: Sequence[str] = HIST_IMPL_CANDIDATES,
                     probe_rows: int = DEFAULT_PROBE_ROWS, seed: int = 0,
                     timer: Callable[[], float] = time.perf_counter,
                     num_slots: int = 8) -> Dict[str, float]:
    """Time the wave-shaped histogram (``build_histogram_slots`` at
    ``num_slots`` slots) on the real binned subsample, once per distinct
    ``hist_route`` of the candidates, and report each route's time under
    every candidate name that takes it: the three col-wise names are the
    one "slots" launch of #1 on the card, and "rowwise_packed" is
    "rowwise" when fewer than two columns fit a nibble. A tie therefore
    resolves by HIST_IMPL_CANDIDATES, as in the JAX package. A row-wise
    candidate whose route would not run the row-wise kernel (no per-column
    bin counts for this storage, or more than 256 bins) is skipped, as
    the JAX package skips the ones its dispatcher would send col-wise.
    ``impl_candidates`` narrows the field (``force_col_wise`` passes
    COL_WISE_HIST_IMPLS).

    The probe's shape is the JAX package's contract (``num_slots`` = 8 on
    at most DEFAULT_PROBE_ROWS rows), not the shape at which the chosen
    route's waves run (up to 128 slots on every row), and the ranking of
    the layouts changes with both: on the H100 the row-wise kernel wins
    this probe on the Criteo table while the slot histogram is the faster
    of the two at 16 and 128 slots on 2^20 rows (PERF.md, section 6). So
    the decision can pick the slower kernel for the run."""
    from ..ops.histogram import (ROWWISE_IMPLS, build_histogram_slots,
                                 hist_route, make_hist_plan)

    dev = X_t.device
    Xs = _subsample(X_t, probe_rows)
    F, m = Xs.shape
    K = max(int(num_slots), 1)
    rng = np.random.RandomState(seed)
    vals = torch.from_numpy(rng.uniform(
        -0.5, 0.5, size=(2, m)).astype(np.float32)).to(dev)
    slot = torch.from_numpy(
        rng.randint(0, K, size=m).astype(np.int32)).to(dev)
    B = int(cfg.num_bins_padded)
    tiers = _storage_tiers(cfg, F)

    by_route: Dict[str, float] = {}
    timings: Dict[str, float] = {}
    for impl in impl_candidates:
        route = hist_route(impl, tiers)
        if impl in ROWWISE_IMPLS and route not in ROWWISE_IMPLS:
            continue          # the route would run col-wise
        if route not in by_route:
            plan = make_hist_plan(Xs, route, tiers)
            by_route[route] = _best_of_2(
                lambda _r=route, _p=plan: build_histogram_slots(
                    Xs, vals, slot, K, B, impl=_r, plan=_p), timer, dev)
        timings[impl] = by_route[route]
    return timings


class _SyntheticWave:
    """The operands of one synthetic wave (JAX autotune.py:379-410,
    :494-529): K = 4 candidate leaves among rows labelled 0..K-1, each
    splitting feature 0 at its mid bin with the left child the smaller,
    no applied entries; parents holding m rows a bin; zero gradient sums
    with hessian m / 4 a child."""

    K = 4

    def __init__(self, Xs: torch.Tensor, cfg, seed: int):
        from ..ops.grow_fused import (fused_feature_mask, pack_fused_meta,
                                      pack_fused_scalars)
        from ..ops.split import FeatureMeta, SplitHyperParams, SplitResult
        dev = Xs.device
        F, m = Xs.shape
        K = self.K
        B = int(cfg.num_bins_padded)
        rng = np.random.RandomState(seed)
        self.vals = torch.from_numpy(rng.uniform(
            -0.5, 0.5, size=(2, m)).astype(np.float32)).to(dev)
        self.lor = torch.from_numpy(
            rng.randint(0, K, size=m).astype(np.int32)).to(dev)
        tiers = tuple(int(t) for t in cfg.hist_tiers[:F])
        nb = np.clip(np.asarray(tiers + (B,) * (F - len(tiers)), np.int64),
                     2, B)
        thr = max(int(nb[0]) // 2 - 1, 0)
        tbl = np.full((16, 128), -1, np.int64)
        tbl[7, :K] = np.arange(K)                  # candidate leaf ids
        tbl[8, :K] = 0                             # feature
        tbl[9, :K] = thr                           # threshold
        tbl[10, :K] = 1                            # default_left
        tbl[11, :K] = 0                            # missing none
        tbl[12, :K] = 0                            # default bin
        tbl[13, :K] = nb[0]                        # num_bin
        tbl[14, :K] = 1                            # smaller is left
        tbl[15, :] = K                             # first new leaf id
        self.table = torch.from_numpy(tbl.astype(np.int32)).to(dev)
        # the precomputed decision bits of the tiled arm: bit 1 = in the
        # candidate's smaller (left) child
        from ..utils import bin_values, indexable_bins
        gl = (bin_values(indexable_bins(Xs)[0]) <= thr).to(torch.uint8)
        self.dec = (gl << 1)[None].expand(K, m).contiguous()
        self.L = max(int(cfg.num_leaves), 2 * K)
        self.hp = SplitHyperParams(20.0, 1e-3, 0.0, 0.0, 0.0, 0.0, 0.0)
        self.meta = FeatureMeta(
            num_bins=torch.from_numpy(nb).to(dev),
            missing_type=torch.zeros(F, dtype=torch.int64, device=dev),
            default_bin=torch.zeros(F, dtype=torch.int64, device=dev),
            is_categorical=torch.zeros(F, dtype=torch.bool, device=dev))
        self.parent = torch.full((K, 2 * F * B), float(m),
                                 dtype=torch.float32, device=dev)

        def full(v):
            return torch.full((K,), float(v), dtype=torch.float32,
                              device=dev)
        zk = full(0.0)
        bs = SplitResult(
            gain=zk, feature=zk.long(), threshold=zk.long(),
            default_left=zk.bool(), left_sum_g=zk,
            left_sum_h=full(m * 0.25), left_count=full(m // K),
            right_sum_g=zk, right_sum_h=full(m * 0.25),
            right_count=full(m // K), left_output=zk, right_output=zk)
        self.scal = pack_fused_scalars(bs, torch.ones(K, dtype=torch.bool,
                                                      device=dev))
        self.fmeta = pack_fused_meta(self.meta)
        self.fmask = fused_feature_mask(None, F, dev)
        self.pend_leaf = torch.full((128,), -1, dtype=torch.int32,
                                    device=dev)
        self.pend_nl0 = torch.zeros(1, dtype=torch.int32, device=dev)

    def search(self, hist: torch.Tensor):
        """The split search of every child of the wave: the smaller
        children from `hist` [K, 2, F, B], the larger ones as parent -
        smaller."""
        from ..ops.split import find_best_split, synth_count_channel
        K = self.K
        par = self.parent.reshape(hist.shape)
        hs = torch.cat([hist, par - hist])                   # [2K, 2, F, B]
        s = self.scal
        h3 = synth_count_channel(hs, s[2], s[1])
        return find_best_split(h3, s[0], s[1], s[2], s[3], self.meta,
                               self.hp, self.fmask != 0)


def probe_fused_wave(X_t: torch.Tensor, cfg,
                     probe_rows: int = DEFAULT_PROBE_ROWS, seed: int = 0,
                     timer: Callable[[], float] = time.perf_counter,
                     ) -> Dict[str, float]:
    """Time one synthetic wave both ways: the two-pass shape against the
    fused kernel, which also searches the children's splits. On at most
    32 storage columns that is the wave pass (#3) then the split search of
    every child against #9 (wave_pass_fused); past 32 columns the wide
    wave, the wave-apply kernel (#4), the slot histogram (#1) and the
    search, against #10 (wave_pass_fused_tiled) on the same decision bits
    (built once, outside the timed calls). histogram_impl="fused" has no
    plain-histogram form, so this is its probe, cached in the same
    decision. Returns ``{"two_pass": s, "fused": s}``, or {} past 256
    bins, where no fused kernel runs."""
    from ..ops.histogram import (build_histogram_slots, wave_apply,
                                 wave_pass, wave_pass_fused,
                                 wave_pass_fused_tiled)
    from ..ops.histogram_cuda import MAX_WAVE_FEATURES

    dev = X_t.device
    B = int(cfg.num_bins_padded)
    if B > 256:
        return {}
    Xs = _subsample(X_t, probe_rows)
    F = int(Xs.shape[0])
    w = _SyntheticWave(Xs, cfg, seed)
    K, L = w.K, w.L

    if F <= MAX_WAVE_FEATURES:
        def two_pass():
            new_lor, hist = wave_pass(Xs, w.vals, w.lor, w.table, K, B, L)
            return new_lor, hist, w.search(hist).gain

        def fused():
            return wave_pass_fused(Xs, w.vals, w.lor, w.table, w.parent,
                                   w.scal, w.fmeta, w.fmask, K, B, L, w.hp)
    else:
        def two_pass():
            new_lor, slot = wave_apply(Xs, w.lor, w.table, None, None, K, L)
            hist = build_histogram_slots(Xs, w.vals, slot, K, B)
            return new_lor, hist, w.search(hist).gain

        def fused():
            return wave_pass_fused_tiled(
                Xs, w.vals, w.dec, w.lor, w.table, w.pend_leaf, w.pend_nl0,
                w.parent, w.scal, w.fmeta, w.fmask, K, B, L, w.hp)

    return {name: _best_of_2(fn, timer, dev)
            for name, fn in (("two_pass", two_pass), ("fused", fused))}


def probe_binning(mappers, *, probe_rows: int = 16384, seed: int = 0,
                  timer: Callable[[], float] = time.perf_counter,
                  device: Optional[torch.device] = None,
                  ) -> Dict[str, float]:
    """Time the two value->bin arms on synthetic f32 rows from a fixed
    seed: ``host`` is the per-feature numpy ``value_to_bin`` loop every
    host site runs, ``device`` the rows' upload to `device` and one launch
    of the bucketize kernel (#6; its plain version on the CPU), as the
    JAX package's jitted arm takes the host rows. Both arms bin the
    same rows and the device arm is bitwise the host's, so the probe only
    decides where the work runs. {} when the mapper set is not
    device-packable."""
    from ..ops.bucketize import (BinningUnavailable, bucketize_rows,
                                 pack_bin_table, upload_bin_table)

    try:
        table = pack_bin_table(mappers, mode="train")
    except BinningUnavailable:
        return {}
    dev = _device(device)
    rng = np.random.RandomState(seed)
    n = max(int(probe_rows), 256)
    X = rng.uniform(-100.0, 100.0,
                    size=(n, len(mappers))).astype(np.float32)

    def host_arm() -> None:
        for f, m in enumerate(mappers):
            if m is not None and not getattr(m, "is_trivial", False):
                m.value_to_bin(np.asarray(X[:, f], np.float64))

    timings: Dict[str, float] = {}
    best = float("inf")
    host_arm()                                 # warm numpy caches
    for _ in range(2):
        t0 = timer()
        host_arm()
        best = min(best, timer() - t0)
    timings["host"] = best

    tt = upload_bin_table(table, dev)
    timings["device"] = _best_of_2(
        lambda: bucketize_rows(torch.from_numpy(X).to(dev), tt), timer, dev)
    return timings


def autotune_binning_decision(mappers, *, n_rows: int, n_features: int,
                              max_bin: int, num_leaves: int,
                              cache_path: str = "", seed: int = 0,
                              timer: Callable[[], float]
                              = time.perf_counter,
                              device: Optional[torch.device] = None,
                              ) -> Dict[str, Any]:
    """Resolve ``binning_impl=auto`` by a timed probe, cached under the
    standard shape key with a ``_binning`` suffix. On a tie the untuned
    "auto" resolution on `device` wins (device on CUDA, host on the CPU),
    so a tie reproduces untuned behavior. Returns ``{"binning_impl",
    "binning_timings", "key", "cached"}``; ``binning_impl`` is None when
    the mapper set is not packable (the caller bins on the host)."""
    from ..ops.bucketize import resolve_binning_impl

    dev = _device(device)
    key = make_key(n_rows, n_features, max_bin, num_leaves,
                   device_kind_of(dev)) + "_binning"
    if key in _MEM_CACHE:
        return dict(_MEM_CACHE[key], cached="memory")
    path = cache_path or default_cache_path()
    disk = load_disk_cache(path)
    hit = disk.get(key)
    if isinstance(hit, dict) and hit.get("binning_impl") in (
            None, "host", "device"):
        _MEM_CACHE[key] = hit
        return dict(hit, cached="disk")

    timings = probe_binning(mappers, seed=seed, timer=timer, device=dev)
    default = resolve_binning_impl("auto", dev)
    preference = (default, "host" if default == "device" else "device")
    impl = _pick_winner(timings, preference)
    decision: Dict[str, Any] = {
        "binning_impl": impl,
        "binning_timings": {n: round(v, 6) for n, v in timings.items()},
        "key": key,
    }
    _MEM_CACHE[key] = decision
    disk[key] = decision
    save_disk_cache(path, disk)
    return dict(decision, cached=False)


def _pick_winner(timings: Dict[str, float],
                 preference: Sequence[str]) -> Optional[str]:
    """Fastest candidate; ties within TIE_TOL resolve by preference order
    (then by insertion order for unlisted names)."""
    if not timings:
        return None
    t_best = min(timings.values())
    tied = [k for k, v in timings.items() if v <= t_best * (1.0 + TIE_TOL)]

    def rank(name: str) -> int:
        try:
            return preference.index(name)
        except ValueError:
            return len(preference) + list(timings).index(name)

    return min(tied, key=rank)


def autotune_decision(X_t: torch.Tensor, meta, cfg,
                      candidates: Sequence[str], *, n_rows: int,
                      n_features: int, max_bin: int, num_leaves: int,
                      rows_per_chunk: int = 8192, cache_path: str = "",
                      probe_rows: int = DEFAULT_PROBE_ROWS, seed: int = 0,
                      timer: Callable[[], float] = time.perf_counter,
                      hist_impl_candidates: Optional[Sequence[str]] = None,
                      ) -> Dict[str, Any]:
    """Full decision: cached if seen, otherwise probe and cache.

    Returns ``{"grower", "rows_per_chunk", "hist_impl", "timings",
    "chunk_timings", "hist_impl_timings", "fused_wave_timings",
    "fused_variant", "key", "probe_rows", "cached"}``, the JAX package's
    decision. ``rows_per_chunk`` is the configured value passed in and
    ``chunk_timings`` stays empty: the kernels plan their own tiles.
    ``hist_impl_candidates`` restricts the histogram-layout probe (e.g.
    COL_WISE_HIST_IMPLS under force_col_wise); None = all candidates."""
    impl_cands = tuple(hist_impl_candidates or HIST_IMPL_CANDIDATES)
    # "fused" never rides the plain-histogram probe list but is a valid
    # cached outcome of the fused-wave probe below
    impl_ok = (None, "fused", *impl_cands)
    key = make_key(n_rows, n_features, max_bin, num_leaves,
                   device_kind_of(X_t.device), variant=fused_variant_sig(cfg))
    if key in _MEM_CACHE \
            and _MEM_CACHE[key].get("hist_impl") in impl_ok:
        return dict(_MEM_CACHE[key], cached="memory")
    path = cache_path or default_cache_path()
    disk = load_disk_cache(path)
    hit = disk.get(key)
    if isinstance(hit, dict) and hit.get("grower") in (None, *candidates) \
            and hit.get("hist_impl") in impl_ok:
        _MEM_CACHE[key] = hit
        return dict(hit, cached="disk")

    timings = probe_strategies(X_t, meta, cfg, candidates,
                               probe_rows=probe_rows, seed=seed, timer=timer)
    winner = _pick_winner(timings, AUTOTUNE_PREFERENCE)

    # histogram implementation: probed only when config left the choice
    # open (histogram_impl=auto) and the dataset published its bin counts
    hist_impl: Optional[str] = None
    hist_impl_timings: Dict[str, float] = {}
    if getattr(cfg, "hist_impl", "auto") == "auto" \
            and getattr(cfg, "hist_tiers", ()):
        hist_impl_timings = probe_hist_impls(
            X_t, cfg, impl_candidates=impl_cands, probe_rows=probe_rows,
            seed=seed, timer=timer)
        hist_impl = _pick_winner(hist_impl_timings, HIST_IMPL_CANDIDATES)

    # the fused wave: only reachable when the wave grower won and the
    # layout choice is open; it must beat the two-pass wave OUTRIGHT (a tie
    # keeps the unfused route)
    fused_timings: Dict[str, float] = {}
    if getattr(cfg, "hist_impl", "auto") == "auto" \
            and getattr(cfg, "hist_tiers", ()) \
            and winner in ("wave", "wave_exact") \
            and hist_impl not in ("rowwise", "rowwise_packed"):
        fused_timings = probe_fused_wave(X_t, cfg, probe_rows=probe_rows,
                                         seed=seed, timer=timer)
        if "fused" in fused_timings and "two_pass" in fused_timings \
                and fused_timings["fused"] \
                < fused_timings["two_pass"] * (1.0 - TIE_TOL):
            hist_impl = "fused"

    decision: Dict[str, Any] = {
        "grower": winner,
        "rows_per_chunk": int(rows_per_chunk),
        "hist_impl": hist_impl,
        "timings": {k: round(v, 6) for k, v in timings.items()},
        "chunk_timings": {},
        "hist_impl_timings": {k: round(v, 6)
                              for k, v in hist_impl_timings.items()},
        "fused_wave_timings": {k: round(v, 6)
                               for k, v in fused_timings.items()},
        "fused_variant": fused_variant_sig(cfg) or _DEFAULT_FUSED_SIG,
        "key": key,
        "probe_rows": min(int(probe_rows), int(X_t.shape[1])),
    }
    _MEM_CACHE[key] = decision
    disk[key] = decision
    save_disk_cache(path, disk)
    return dict(decision, cached=False)
