"""ServingSession: pinned model + scorer cache + bucketing.

Counterpart of lightgbm_tpu/serving/session.py. The reference's online
inference story is the single-row fast path
(``LGBM_BoosterPredictForMatSingleRowFastInit``, c_api.h:1399-1428): per-call
setup is hoisted out of the hot loop. Here:

 * the packed tree arrays (models/predictor.py PackedModel) are built once
   per model version and, for the device engines, uploaded to the device
   once;
 * request batches are padded up to POWER-OF-TWO buckets and the scorer of
   each (model version, engine, bucket) is cached, so every launch runs at
   one of a few shapes; ``warmup()`` runs the whole bucket ladder once
   (building the bucketize kernel and touching every shape) before traffic
   lands.

Engines:

 * ``host``   the PackedModel lockstep walk in f64 numpy, bitwise equal to
   the host walk of ``Booster.predict``;
 * ``device`` the f32 lockstep walk on the session's device
   (ops/predict.py predict_margin_packed) against f32-floored thresholds:
   rows route like the host walk, leaf values add in f32;
 * ``binned`` the bin-domain walk (ops/predict_binned.py): f64 rows are
   binned ONCE on the host through the model's frozen BinMappers, f32 rows
   are bucketized on the device by the bucketize kernel against a
   serve-mode bin table (the raw-f32 route); both then walk uint8 bins on
   the device. The f64 route, the raw-f32 route and the ``device`` engine
   give bitwise equal margins.
 * ``compiled`` the binned engine through exported programs
   (export/compile.py): each bucket's walk is ``torch.export``ed with the
   forest folded in, saved to bytes and loaded back, the in-process twin
   of a ``task=convert_model convert_model_language=torch_export``
   artifact; f32 requests bucketize through the kernel (#6) first, then run
   the uint8 program, bitwise the artifact's ``bin_score`` entry. Its
   margins are bitwise the ``binned`` engine's;
 * ``auto``   ``device`` on a CUDA device, ``host`` on the CPU.

An explicit ``device``, ``binned`` or ``compiled`` engine that cannot be
built raises; so does ``binning_impl="device"`` whose table cannot be
packed.

Engine degradation: with a circuit breaker (serving/breaker.py) each
device or binned chunk first asks ``breaker.allow()``; an open breaker
routes the chunk through the host walk, bitwise ``Booster.predict``'s,
until a half-open probe succeeds, and a device chunk that fails is
recorded with the breaker and re-scored on the host. Each chunk routed
away is counted in ``host_fallbacks`` and logged. Without a breaker a
failing device chunk raises: nothing is re-scored quietly (the JAX
package re-scores on the host with or without a breaker, ROADMAP C note
20). A fault plan (runtime/faults.py) injects ``slow_score`` inside the
timed region and ``fail_score`` before the chunk's scoring call.

With ``num_shards > 1`` the device engine scores each bucket data-parallel
over the local cards (parallel/data_parallel.py:build_sharded_score_fn:
one row block a card, each with its own copy of the model, no
collective): the count rounds to a power of two no larger than the card
count, with the JAX package's warning, and ``min_bucket`` to at least the
shard count. On one card (or the CPU) it rounds to 1 and scores unsharded,
as a JAX session does on one device.

A ``profiler`` (runtime/profiler.py StageProfiler) records the binning
stage of the binned engine: a ``bin_rows`` span around the host
``bin_rows`` of f64 requests and around the bucketize kernel's (#6)
launch of f32 requests on the raw-f32 route (a launch of its own on the
card, where the JAX package fuses it into the scoring program), with
``bin_rows_rows`` / ``bin_rows_bytes_in`` / ``bin_rows_bytes_out``
counters, and an HBM-watermark sample (``serve_score``) a scored chunk.
Profiling changes no margin.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import resolve_device
from ..utils.log import log_info, log_warning
from .metrics import ServingMetrics


def shard_devices(device: torch.device) -> List[torch.device]:
    """The devices a sharded scorer on `device` may spread over: every
    local card on CUDA, the one CPU otherwise."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def resolve_shards(num_shards: int, device: torch.device,
                   what: str = "serving num_shards") -> List[torch.device]:
    """The devices of `num_shards`-way sharded scoring: a power of two no
    larger than `shard_devices(device)`'s count, with the JAX package's
    warning when that rounds (serving/session.py:173-190); [] for one."""
    avail = shard_devices(device)
    shards = 1 << (min(int(num_shards), len(avail)).bit_length() - 1)
    if shards != num_shards:
        log_warning(f"{what}={num_shards} rounded to {shards} (power of "
                    f"two, {len(avail)} devices)")
    return avail[:shards] if shards > 1 else []


def bucket_for(n: int, min_bucket: int, max_bucket: int) -> int:
    """Smallest power-of-two >= n, clamped to [min_bucket, max_bucket]."""
    b = 1 << max(int(n) - 1, 0).bit_length()
    return max(min_bucket, min(b, max_bucket))


class CompiledPredictorCache:
    """(model version, engine, bucket) -> scorer. Thread-safe; hit/miss
    counts feed the serving cache-hit-rate metric."""

    def __init__(self, metrics: Optional[ServingMetrics] = None) -> None:
        self._lock = threading.Lock()
        self._fns: Dict[Tuple, Callable] = {}
        self.hits = 0
        self.misses = 0
        self._metrics = metrics

    def get(self, key: Tuple, builder: Callable[[], Callable]) -> Callable:
        with self._lock:
            fn = self._fns.get(key)
            if fn is not None:
                self.hits += 1
                if self._metrics is not None:
                    self._metrics.record_cache(True)
                return fn
        # build OUTSIDE the lock; a rare duplicate build is benign — last
        # writer wins
        fn = builder()
        with self._lock:
            self._fns[key] = fn
            self.misses += 1
            if self._metrics is not None:
                self._metrics.record_cache(False)
        return fn

    def __len__(self) -> int:
        return len(self._fns)


class ServingSession:
    """One servable model version: immutable once constructed (hot-swap
    builds a NEW session, registry.py), safe to score from any thread."""

    def __init__(self, gbdt, *, engine: str = "auto",
                 max_batch: int = 1024, min_bucket: int = 8,
                 num_shards: int = 0, start_iteration: int = 0,
                 num_iteration: int = -1, warmup: bool = False,
                 metrics: Optional[ServingMetrics] = None,
                 version: int = 0, breaker=None, fault_plan=None,
                 profiler=None, bin_mappers=None,
                 binning_impl: str = "auto",
                 device_type: Optional[str] = None) -> None:
        # graceful-degradation circuit breaker (serving/breaker.py): shared
        # across the versions of one served model (registry.py)
        self.breaker = breaker
        self.fault_plan = fault_plan
        self._n_scored = 0              # chunk counter for fault hooks
        self.profiler = profiler
        self.gbdt = gbdt
        self.version = int(version)
        # where the device engines run: the model's device_type unless the
        # caller names one ("cpu" runs the plain versions)
        self.device_type = device_type or gbdt.config.device_type
        self.device = resolve_device(self.device_type)
        K = gbdt.num_tree_per_iteration
        total_iters = len(gbdt.models) // max(K, 1)
        end = total_iters if num_iteration <= 0 else min(
            total_iters, start_iteration + num_iteration)
        self._start = min(start_iteration, total_iters)
        self._end = max(end, self._start)
        self.K = K
        self.num_features = gbdt.max_feature_idx_ + 1
        # the FastInit analog: pack ONCE, reuse for every request (the
        # gbdt-level cache, so Booster.predict and the session share it)
        self._pm = gbdt._packed_model(self._start, self._end)
        self._avg_div = (self._end - self._start
                         if gbdt.average_output else 0)
        self._has_linear = any(getattr(t, "is_linear", False)
                               for t in gbdt.models)
        # frozen per-feature BinMappers for the binned engine: the model's
        # own when it carries them, else the caller's (carried across
        # hot-swaps, registry.py)
        from ..ops.predict_binned import mappers_for
        derived = mappers_for(gbdt)
        self.bin_mappers = derived if derived is not None else bin_mappers
        self._bm = None

        self.max_batch = 1 << max(int(max_batch) - 1, 0).bit_length()
        self.requested_engine = engine
        self.engine = self._resolve_engine(engine)
        self._pa = None
        # the compiled engine's exported program of each bucket, built
        # under a lock: torch.export traces with process-wide state, and a
        # warmup and a scoring thread may ask for the same bucket
        self._programs: Dict[int, Callable] = {}
        self._programs_lock = threading.Lock()
        if self.engine == "device":
            self._pa = self._pm.device_arrays(self.device)
        elif self.engine == "binned":
            self._pa = self._bm.device_arrays(self.device)
        # raw-f32 serving: a serve-mode bin table lets f32 requests
        # bucketize on the device, with no host bin_rows stage
        self.binning_impl = binning_impl
        self._bin_table = None
        self._bin_tensors = None
        if self._bm is not None:
            self._bin_table = self._serve_bin_table(binning_impl)
        if self._bin_table is not None:
            from ..ops.bucketize import upload_bin_table
            self._bin_tensors = upload_bin_table(self._bin_table,
                                                 self.device)
            if self.device.type == "cuda":
                # build the kernel now: a batcher's worker thread must not
                # be the one that runs a first-use nvcc build
                from ..ops import histogram_cuda as hc
                hc._lib("bucketize")
        self.metrics = metrics if metrics is not None else ServingMetrics(
            max_batch=self.max_batch)
        if self.metrics.max_batch == 0:
            self.metrics.max_batch = self.max_batch
        self._cache = CompiledPredictorCache(self.metrics)
        self.num_shards = 0
        self._shard_devs: List[torch.device] = []
        if num_shards > 1 and self.engine == "device":
            self._shard_devs = resolve_shards(num_shards, self.device)
            self.num_shards = len(self._shard_devs)
        elif num_shards > 1:
            log_warning(f"serving num_shards ignored on engine "
                        f"{self.engine!r}")
        self.min_bucket = bucket_for(
            max(int(min_bucket), self.num_shards or 1), 1, self.max_batch)
        if warmup:
            self.warmup()

    # ------------------------------------------------------------------
    def _resolve_engine(self, engine: str) -> str:
        if engine not in ("auto", "host", "device", "binned", "compiled"):
            raise ValueError(f"unknown serving engine {engine!r}")
        if engine == "host":
            return "host"
        if engine in ("binned", "compiled"):
            from ..ops.predict_binned import (BinnedUnavailable,
                                              build_binned_model)
            try:
                self._bm = build_binned_model(self._pm, self.bin_mappers)
            except BinnedUnavailable as e:
                raise BinnedUnavailable(
                    f"serving: {engine} engine unavailable ({e})") from e
            return engine
        if self._has_linear:
            if engine == "device":
                raise ValueError("serving: model has linear leaves; device "
                                 "engine unavailable")
            return "host"
        if engine == "device":
            return "device"
        return "device" if self.device.type == "cuda" else "host"

    def _serve_bin_table(self, binning_impl: str):
        """The serve-mode table of the binned engine's raw-f32 route, or
        None (host binning of f32 requests) when binning_impl resolves to
        host or, under auto only, when the table cannot be packed."""
        from ..ops.bucketize import (BinningUnavailable, pack_bin_table,
                                     resolve_binning_impl)
        if resolve_binning_impl(binning_impl, self.device) != "device":
            return None
        try:
            return pack_bin_table(
                self._bm._mappers, mode="serve",
                num_features=self._bm.num_features,
                used_features=self._bm.used_features)
        except BinningUnavailable as e:
            if binning_impl == "device":
                raise
            log_warning(f"serving: device binning unavailable ({e}); f32 "
                        "requests bin on host")
            return None

    # ------------------------------------------------------------------
    @classmethod
    def from_booster(cls, booster, **kwargs) -> "ServingSession":
        """Mirror Booster.predict's iteration default: best_iteration when
        early stopping picked one."""
        if "num_iteration" not in kwargs:
            bi = getattr(booster, "best_iteration", -1)
            kwargs["num_iteration"] = bi if bi and bi > 0 else -1
        return cls(booster._gbdt, **kwargs)

    @classmethod
    def from_model_string(cls, model_str: str, **kwargs) -> "ServingSession":
        from ..models.gbdt import GBDT
        return cls(GBDT.load_model_from_string(model_str), **kwargs)

    @classmethod
    def from_file(cls, path: str, **kwargs) -> "ServingSession":
        with open(path) as f:
            return cls.from_model_string(f.read(), **kwargs)

    # ------------------------------------------------------------------
    # scorers
    # ------------------------------------------------------------------
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _build_scorer(self, bucket: int) -> Callable:
        """The scorer of one padded bucket: [b, F] rows (f32 for
        ``device``, uint8 bins for ``binned`` and ``compiled``) -> [K, b]
        f32 margins on the device; the host engine's is the packed host
        walk."""
        K, pa = self.K, self._pa
        if self.engine == "device":
            from ..ops.predict import predict_margin_packed
            if self._shard_devs:
                from ..parallel import build_sharded_score_fn
                fns = [lambda Xp, a=self._pm.device_arrays(d):
                       predict_margin_packed(a, Xp, K)
                       for d in self._shard_devs]
                return build_sharded_score_fn(self._shard_devs, fns)
            return lambda Xp: predict_margin_packed(pa, Xp, K)
        if self.engine == "binned":
            from ..ops.predict_binned import predict_margin_binned
            return lambda Xp: predict_margin_binned(pa, Xp, K)
        if self.engine == "compiled":
            return self._compiled_scorer(bucket)
        return self._pm.predict_margin

    def _compiled_scorer(self, bucket: int) -> Callable:
        """One bucket's exported program: the binned walk through
        ``torch.export``, saved to bytes and loaded back on the session's
        device (export/compile.py roundtrip_binned_scorer, the JAX
        package's serving/session.py:288 twin), built once a bucket and
        shared by the uint8 and raw-f32 routes."""
        with self._programs_lock:
            fn = self._programs.get(bucket)
            if fn is None:
                from ..export.compile import roundtrip_binned_scorer
                fn = roundtrip_binned_scorer(self._bm, self.K, bucket,
                                             self.device)
                self._programs[bucket] = fn
        return fn

    def _raw_scorer(self, bucket: int) -> Callable:
        """Raw-f32 scorer: the bucketize kernel then the bin-domain walk
        (``compiled``: the bucket's uint8 program), f32 [b, F] raw rows ->
        [K, b] margins with no host binning stage. Bitwise equal to host
        bin_rows + the binned walk. Under a profiler the bucketize launch
        is its ``bin_rows`` span."""
        from ..ops.bucketize import bucketize_rows
        t = self._bin_tensors
        walk = self._build_scorer(bucket)

        def score(Xp: torch.Tensor) -> torch.Tensor:
            if self.profiler is None:
                return walk(bucketize_rows(Xp, t))
            with self.profiler.span("bin_rows"):
                bins = bucketize_rows(Xp, t)
            return walk(bins)
        return score

    def warmup(self) -> List[int]:
        """Run every bucket of the ladder (min_bucket..max_batch, powers of
        two) once before traffic lands. Returns the ladder."""
        ladder = []
        b = self.min_bucket
        while b <= self.max_batch:
            ladder.append(b)
            b *= 2
        for b in ladder:
            fn = self._cache.get((self.version, self.engine, b),
                                 lambda b=b: self._build_scorer(b))
            if self.engine == "device":
                fn(self._to_device(np.zeros((b, self.num_features),
                                            np.float32))).cpu()
            elif self._bm is not None:
                fn(self._to_device(np.zeros((b, self._bm.num_features),
                                            np.uint8))).cpu()
                if self._bin_table is not None:
                    # warm the raw-f32 ladder alongside the uint8 one:
                    # live traffic may arrive either way
                    rfn = self._cache.get(
                        (self.version, self.engine + "_raw", b),
                        lambda b=b: self._raw_scorer(b))
                    rfn(self._to_device(np.zeros((b, self.num_features),
                                                 np.float32))).cpu()
        log_info(f"serving warmup: engine={self.engine} buckets={ladder} "
                 f"device={self.device}")
        return ladder

    # ------------------------------------------------------------------
    # scoring
    # ------------------------------------------------------------------
    def _host_fn(self, b: int):
        return self._cache.get((self.version, "host", b),
                               lambda b=b: self._pm.predict_margin)

    def _run(self, fn: Callable, Xp: np.ndarray, m: int) -> np.ndarray:
        out = fn(self._to_device(Xp))
        return out[:, :m].cpu().numpy().astype(np.float64)

    def _score_device(self, X: np.ndarray, c0: int, c1: int,
                      b: int) -> np.ndarray:
        fn = self._cache.get((self.version, "device", b),
                             lambda b=b: self._build_scorer(b))
        m = c1 - c0
        Xp = np.zeros((b, X.shape[1]), np.float32)
        Xp[:m] = X[c0:c1]
        return self._run(fn, Xp, m)

    def _score_binned(self, X: np.ndarray, c0: int, c1: int,
                      b: int) -> np.ndarray:
        """Bin the chunk once through the frozen mappers on the host, then
        walk uint8 bins on the device."""
        fn = self._cache.get((self.version, self.engine, b),
                             lambda b=b: self._build_scorer(b))
        m = c1 - c0
        Xp = np.zeros((b, self._bm.num_features), np.uint8)
        if self.profiler is not None:
            with self.profiler.span("bin_rows"):
                Xp[:m] = self._bm.bin_rows(X[c0:c1])
            self._count_bin_rows(m, X[c0:c1].nbytes, Xp[:m].nbytes)
        else:
            Xp[:m] = self._bm.bin_rows(X[c0:c1])
        return self._run(fn, Xp, m)

    def _count_bin_rows(self, rows: int, bytes_in: int,
                        bytes_out: int) -> None:
        self.profiler.add_counter("bin_rows_rows", rows)
        self.profiler.add_counter("bin_rows_bytes_in", bytes_in)
        self.profiler.add_counter("bin_rows_bytes_out", bytes_out)

    def _score_binned_raw(self, X: np.ndarray, c0: int, c1: int,
                          b: int) -> np.ndarray:
        """Raw-f32 route: the chunk ships as f32 and is bucketized on the
        device by the kernel, then walked on bins."""
        fn = self._cache.get((self.version, self.engine + "_raw", b),
                             lambda b=b: self._raw_scorer(b))
        m = c1 - c0
        Xp = np.zeros((b, self.num_features), np.float32)
        Xp[:m] = X[c0:c1, :self.num_features]
        out = self._run(fn, Xp, m)
        if self.profiler is not None:
            self._count_bin_rows(m, Xp[:m].nbytes, m * self._bm.num_features)
        return out

    def score_margin(self, X: np.ndarray) -> np.ndarray:
        """[K, n] f64 raw margins for X [n, F] (any request size: chunks
        of up to max_batch, each padded to its bucket). f32 requests keep
        their dtype when the session holds a device bin table and score
        through the raw-f32 route, bitwise equal to the f64 route. With a
        breaker, the device chunks are guarded as the module docstring
        says."""
        X = np.asarray(X)
        raw_f32 = X.dtype == np.float32 and self._bin_table is not None
        X = np.ascontiguousarray(X if raw_f32
                                 else np.asarray(X, np.float64))
        n = X.shape[0]
        out = np.empty((self.K, n), np.float64)
        for c0 in range(0, n, self.max_batch):
            c1 = min(c0 + self.max_batch, n)
            m = c1 - c0
            b = bucket_for(m, self.min_bucket, self.max_batch)
            seq, self._n_scored = self._n_scored, self._n_scored + 1
            use_dev = self.engine != "host"
            if use_dev and self.breaker is not None \
                    and not self.breaker.allow():
                use_dev = False
                self.metrics.inc("host_fallbacks")
                log_warning(f"serving: breaker open, chunk {seq} "
                            f"({m} rows) scored on the host")
            t0 = time.perf_counter()
            if self.fault_plan is not None:
                # inside the timed region: the injected delay must show
                # up in batch latency (latency-SLO shed / breaker trip)
                self.fault_plan.slow_score(seq)
            if use_dev and self.breaker is not None:
                try:
                    r = self._score_dev(X, c0, c1, b, raw_f32, seq)
                    self.breaker.record_success(time.perf_counter() - t0)
                except BaseException as e:
                    self.breaker.record_failure(e)
                    self.metrics.inc("host_fallbacks")
                    log_warning(f"serving: {self.engine} scoring failed "
                                f"({e!r}); chunk {seq} re-scored on the "
                                "host (breaker)")
                    r = self._host_fn(b)(np.asarray(X[c0:c1], np.float64))
            elif use_dev:
                r = self._score_dev(X, c0, c1, b, raw_f32, seq)
            else:
                if self.fault_plan is not None:
                    self.fault_plan.fail_score(seq)
                # the host walk scores the exact rows (padding buys
                # nothing there), bitwise equal to Booster.predict's host
                # walk
                r = self._host_fn(b)(np.asarray(X[c0:c1], np.float64))
            self.metrics.record_batch(time.perf_counter() - t0, m)
            if self.profiler is not None:
                self.profiler.sample_hbm("serve_score")
            out[:, c0:c1] = r
        if self._avg_div:
            out /= self._avg_div
        return out

    def _score_dev(self, X: np.ndarray, c0: int, c1: int, b: int,
                   raw_f32: bool, seq: int) -> np.ndarray:
        """One chunk on the device, binned or compiled engine (the fault
        plan's fail_score first)."""
        if self.fault_plan is not None:
            self.fault_plan.fail_score(seq)
        if self._bm is not None:
            return (self._score_binned_raw(X, c0, c1, b) if raw_f32
                    else self._score_binned(X, c0, c1, b))
        return self._score_device(X, c0, c1, b)

    def _postprocess(self, margins: np.ndarray,
                     raw_score: bool) -> np.ndarray:
        obj = self.gbdt.objective
        raw = margins
        if not raw_score and obj is not None and obj.need_convert_output:
            raw = obj.convert_output(raw)
        return raw[0] if raw.shape[0] == 1 else raw.T

    def predict(self, data, raw_score: bool = False) -> np.ndarray:
        """Score a batch; output shape/semantics match Booster.predict
        (and on the host engine, the VALUES match its host walk bitwise)."""
        from ..basic import _to_2d_numpy
        X = _to_2d_numpy(data)
        return self._postprocess(self.score_margin(X), raw_score)

    def predict_single(self, x, raw_score: bool = False) -> Any:
        """One-row host fast path (~depth lockstep [T] steps), bypassing
        bucketing entirely."""
        t0 = time.perf_counter()
        out = self._pm.predict_single(
            np.asarray(x, np.float64).reshape(-1))
        if self._avg_div:
            out = out / self._avg_div
        self.metrics.record_batch(time.perf_counter() - t0, 1)
        out = self._postprocess(out[:, None], raw_score)
        return float(out[0]) if self.K == 1 else out[0]

    # ------------------------------------------------------------------
    def cache_info(self) -> Dict[str, Any]:
        return {"entries": len(self._cache), "hits": self._cache.hits,
                "misses": self._cache.misses, "engine": self.engine,
                "version": self.version, "device": str(self.device),
                "device_binning": self._bin_table is not None}
