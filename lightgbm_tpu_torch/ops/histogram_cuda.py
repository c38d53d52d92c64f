"""Hopper kernels of the port: the build, the launch counts, and the
training path's wrappers and plain versions.

Five CUDA kernels (``lightgbm_tpu_torch/csrc/*.cu``) replace the five
Pallas kernels the JAX package runs on the training path (lightgbm_tpu/ops/
histogram_pallas.py):

  build_histogram_slots_cuda  K-slot histogram
                              <- build_histogram_slots_pallas
  add_leaf_values_cuda        scores += values[leaf_of_row], in place (and
  take_leaf_values_cuda       values[leaf_of_row])  <- take_leaf_values_pallas
  wave_pass_cuda              relabel + candidate membership, then the
                              slot histogram  <- wave_pass_pallas
  wave_relabel_cuda           relabel only          <- wave_relabel_pallas
  wave_apply_cuda             relabel + candidate slot, each row decided
                              from the wave's split records (wide /
                              categorical / EFB route)
                              <- wave_apply_pallas + dec_go_left

Five more are built and counted here, their wrappers and plain versions
living beside the code that calls them: the bucketize kernel of device
binning (``csrc/bucketize.cu`` <- lightgbm_tpu/ops/bucketize.py::
_bucketize_pallas; ``ops/bucketize.py``), the two row-wise multi-value
histograms (``csrc/hist_rowwise.cu`` <- lightgbm_tpu/ops/
histogram_rowwise.py's plain and nibble-packed flat kernels;
``ops/histogram_rowwise.py``) and the two fused waves, histogram plus
split search (``csrc/wave_pass_fused.cu``, ``csrc/
wave_pass_fused_tiled.cu`` <- lightgbm_tpu/ops/grow_fused.py;
``ops/grow_fused.py``). One more replaces no Pallas kernel: the compact
grower's partition of a leaf's window (``csrc/window_partition.cu`` <- the
XLA partition of lightgbm_tpu/ops/grow_fast.py), which the batched compact
step runs with its window in device memory, beside #1's window operand
(``build_histogram_window_cuda``). Another replaces the XLA gather of the
fleet's fused drain: the stacked bucketize (``csrc/bucketize_stacked.cu``
<- lightgbm_tpu/ops/bucketize.py::bucketize_rows_stacked; ``ops/
bucketize.py``), each row of a mixed-tenant batch binned against its own
tenant's table.

The slot histogram, the two row-wise histograms and the three wave
kernels (#3 and the two fused waves) sweep their rows with one tiled
accumulation engine (``csrc/hist_tiles.cuh``), planned here:
``plan_hist_tiles`` for the uniform [F, B] grid, ``plan_flat_tiles`` for
the row-wise flat layout's columns of unequal width; the waves of the
megakernel route first run a membership pass (``csrc/wave_member.cuh``)
and take their launch's shape from ``wave_hist_layout``.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface (one library per source, all built in parallel on
first use into ``lightgbm_tpu_torch/_build/``) and called through
``ctypes`` on PyTorch's current stream. Every wrapper checks device, dtype,
shape and contiguity, allocates the outputs, raises when the launch
reports a CUDA error, and adds one to ``LAUNCHES[name]``.

Beside each kernel stands its plain PyTorch version (``*_plain``): the same
function in ordinary tensor operations. The CPU tests run them, the
dispatchers in ``ops/histogram.py`` take them for CPU tensors, and
``chip_smoke.py`` holds each kernel against its plain version on the card.

Float histograms accumulate in float64 in both versions and are rounded
once to float32, so a bin's value does not depend on the order of the
adds (atomics land in a run-dependent order on the card).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..utils import bin_values, indexable_bins

LAUNCHES: Dict[str, int] = {"build_histogram_slots": 0,
                            "take_leaf_values": 0,
                            "wave_pass": 0,
                            "wave_relabel": 0,
                            "bucketize": 0,
                            "wave_apply": 0,
                            "hist_rowwise": 0,
                            "hist_rowwise_packed": 0,
                            "wave_pass_fused": 0,
                            "wave_pass_fused_tiled": 0,
                            "window_partition": 0,
                            "bucketize_stacked": 0}

# kernel name -> (source file, C entry point)
KERNELS = {
    "build_histogram_slots": ("hist_slots.cu", "lgbt_hist_slots"),
    "take_leaf_values": ("take_leaf_values.cu", "lgbt_take_leaf_values"),
    "wave_pass": ("wave_pass.cu", "lgbt_wave_pass"),
    "wave_relabel": ("wave_relabel.cu", "lgbt_wave_relabel"),
    "bucketize": ("bucketize.cu", "lgbt_bucketize"),
    "wave_apply": ("wave_apply.cu", "lgbt_wave_apply"),
    "hist_rowwise": ("hist_rowwise.cu", "lgbt_hist_rowwise"),
    "hist_rowwise_packed": ("hist_rowwise.cu", "lgbt_hist_rowwise_packed"),
    "wave_pass_fused": ("wave_pass_fused.cu", "lgbt_wave_pass_fused"),
    "wave_pass_fused_tiled": ("wave_pass_fused_tiled.cu",
                              "lgbt_wave_pass_fused_tiled"),
    "window_partition": ("window_partition.cu", "lgbt_window_partition"),
    "bucketize_stacked": ("bucketize_stacked.cu", "lgbt_bucketize_stacked"),
}

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

MAX_CHANNELS = 4        # LGBT_MAX_C in csrc/common.cuh
MAX_WAVE_FEATURES = 32  # the packed table entry holds feat & 31
MAX_SLOTS = 128         # LGBT_T_ENTRIES in csrc/wave_table.cuh
LEAF_CAP = 4096         # LGBT_LEAF_CAP in csrc/common.cuh: leaf
                        # tables staged in shared memory; past it the
                        # kernels take the global leaf maps (new_leaf_map)
MAX_LEAVES = (1 << 31) - 1   # leaf ids are int32
GMAP_NONE = 0x7FFFFFFF  # LGBT_GMAP_NONE: a global leaf map's unset word
GMAP_MAPS = 3           # LGBT_GMAP_MAPS: maps a global buffer holds
T_ROWS = 16             # rows of the semantic wave table

# one build at a time per process: a serving worker thread and the main
# thread must not race the temporary files of a first-use build
_BUILD_LOCK = threading.Lock()


def new_leaf_map(device: torch.device,
                 num_leaves: int) -> Optional[torch.Tensor]:
    """The global leaf -> entry maps of the wave kernels past LEAF_CAP
    leaves ([GMAP_MAPS * L] int32, every word GMAP_NONE), or None for L <=
    LEAF_CAP, where each block keeps its maps in shared memory
    (csrc/wave_table.cuh), and off the card, where the plain versions keep
    no map. A booster allocates one and passes it to every wave launch
    (`gmap=`), so a captured graph (models/batched.py) replays a fixed
    pointer. Each launch writes the wave's entries in a prologue and clears
    them in an epilogue on the caller's stream, so the buffer is back to
    GMAP_NONE after every call; its owner launches on it one wave at a
    time."""
    if num_leaves <= LEAF_CAP or device.type != "cuda":
        return None
    return torch.full((GMAP_MAPS * num_leaves,), GMAP_NONE,
                      dtype=torch.int32, device=device)


def _gmap(gmap: Optional[torch.Tensor], dev: torch.device,
          num_leaves: int) -> Optional[torch.Tensor]:
    """A launch's global leaf maps: the caller's, checked, or (none given)
    a new buffer for this launch alone; None at or below LEAF_CAP."""
    if num_leaves <= LEAF_CAP:
        return None
    if gmap is None:
        return new_leaf_map(dev, num_leaves)
    _check(gmap, "gmap", (torch.int32,), (GMAP_MAPS * num_leaves,), dev)
    return gmap


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's "
                           "kernels are compiled at first use")
    return found


def _source_tag() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:12]


def build_kernels() -> Dict[str, dict]:
    """Compile every kernel source that is not built yet, one ``nvcc`` per
    source, all started together. Returns {kernel name: {"path",
    "seconds", "log"}} where ``log`` is nvcc's output (``-Xptxas -v``
    register and shared-memory counts) for the sources built by this call;
    kernels of one source share its library."""
    with _BUILD_LOCK:
        return _build_kernels()


def _build_kernels() -> Dict[str, dict]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = _source_tag()
    procs, built = {}, {}
    t0 = time.perf_counter()
    for src in dict.fromkeys(s for s, _ in KERNELS.values()):
        so = BUILD_DIR / f"{Path(src).stem}-{tag}.so"
        built[src] = {"path": str(so), "seconds": 0.0, "log": ""}
        if so.exists():
            continue
        tmp = BUILD_DIR / f"{Path(src).stem}-{tag}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, so)
    failed = []
    for src, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        built[src]["log"] = log
        built[src]["seconds"] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return {name: built[src] for name, (src, _) in KERNELS.items()}


@functools.lru_cache(maxsize=None)
def _lib(name: str):
    """The loaded C entry point of kernel `name` (builds on first use)."""
    paths = build_kernels()
    fn = getattr(ctypes.CDLL(paths[name]["path"]), KERNELS[name][1])
    P, I, LL, FL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    HP = [FL] * 7 + [I, I]      # the split hyperparameters of the scan
    fn.restype = I
    fn.argtypes = {
        "build_histogram_slots": [P, I, P, I, P, P, P, P, P, P, LL]
        + [I] * 16 + [P],
        "take_leaf_values": [P, I, P, P, LL, I, I, P],
        "wave_pass": [P, P, I] + [P] * 6 + [LL] + [I] * 5 + [P] + [I] * 10
        + [LL, LL, I, I, P],
        "wave_relabel": [P, P, P, P, LL, I, I, P, I, P],
        "bucketize": [P, LL, LL, P, I, I, I, I, P, P, I, P, P, I, P, LL,
                      LL, I, P],
        "wave_apply": [P, I, P, P, P, I, P, I, P, P, LL, I, I, P, I, P],
        "hist_rowwise": [P, P, I, P, P, P, P, P, LL] + [I] * 14 + [P],
        "hist_rowwise_packed": [P, P, P, I, P, P, P, P, P, LL] + [I] * 14
        + [P],
        "wave_pass_fused": [P] * 12 + [I, P, P, LL] + [I] * 4 + [P]
        + [I] * 10 + [LL, LL, I] + HP + [I, P],
        "wave_pass_fused_tiled": [P, P, I] + [P] * 13
        + [I, P, P, LL] + [I] * 5 + [P] + [I] * 10 + [P] + HP + [I, P],
        "window_partition": [P, I] + [P] * 6 + [LL, I, I, I, P],
        "bucketize_stacked": [P, LL, LL, P, I, I, P, P, I, P, P, I, P, P],
    }[name]
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_env(device: torch.device) -> Tuple[int, int]:
    """(SM count, current stream handle) for a launch on `device`; the SM
    count is read once per device."""
    return _sm_count(device.index), \
        torch.cuda.current_stream(device).cuda_stream


def _check(t: torch.Tensor, what: str, dtypes, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor")
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what} has dtype {t.dtype}, expected one of "
                        f"{list(dtypes)}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _cuda_device(X: torch.Tensor) -> torch.device:
    if not isinstance(X, torch.Tensor) or X.device.type != "cuda":
        raise ValueError("a CUDA kernel takes CUDA tensors (got "
                         f"{getattr(X, 'device', type(X))})")
    return X.device


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


BIN_DTYPES = (torch.uint8, torch.uint16)   # the storage #1 and #4 read
MAX_BINS = 1 << 16                         # bins a uint16 column can hold


def _max_bins(X: torch.Tensor) -> int:
    return 256 if X.dtype == torch.uint8 else MAX_BINS


def _check_hist_args(X, vals, F, N, num_slots, num_bins, dev):
    if F < 1 or N < 0:
        raise ValueError(f"X must be [F, N] with F >= 1, got {tuple(X.shape)}")
    _check(X, "X", BIN_DTYPES, (F, N), dev)
    C = vals.shape[0] if vals.dim() == 2 else -1
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"vals must be [C, N] with 1 <= C <= "
                         f"{MAX_CHANNELS}, got {tuple(vals.shape)}")
    _check(vals, "vals", (torch.float32, torch.int8), (C, N), dev)
    if not 1 <= num_bins <= _max_bins(X):
        raise ValueError(f"num_bins must be in [1, {_max_bins(X)}] for "
                         f"{X.dtype} bins, got {num_bins}")
    if num_slots < 1 or num_slots * C * F * num_bins >= 2 ** 31:
        raise ValueError(f"num_slots={num_slots} is out of range")
    return C


# ---------------------------------------------------------------------------
# 1. K-slot histogram
# ---------------------------------------------------------------------------
# The tile planner of csrc/hist_slots.cu: a fixed rule of the shape, the
# H100's shared memory and the SM count (no option reaches it).
HIST_SMEM_BUDGET = 48 * 1024   # a tile's accumulators: 4+ blocks per SM
SM_SMEM_BYTES = 228 * 1024     # shared memory of one H100 SM
BLOCK_SMEM_RESERVED = 1024     # the system's share of each resident block
MAX_BLOCKS_PER_SM = 5          # LGBT_TILE_BLOCKS_PER_SM: the registers
MIN_SEGMENT_ROWS = 128         # fewer rows per block: the flush dominates
DIRECT_MAX_ROWS = 1 << 16      # the direct sweep at K > 1 up to this many
                               # rows, at K = 1 (one tile) up to
DIRECT_MAX_ADDS = 1 << 24      # this many (row, feature) pairs
MERGE_MIN_BINS = 65            # the warp merge from this bin count up, the
                               # channel pairing below it at K = 1
MAX_GROUP_SLOTS = 1024         # the grouping's per-warp counts in shared mem
GROUP_ROWS = 256               # rows of a grouping warp, at least
MAX_GROUP_WARPS = 1024         # the scan's block width


class HistTilePlan(NamedTuple):
    """How csrc/hist_slots.cu cuts a [K, C, F, B] histogram: tiles of
    `slots_per_tile` slots x `feats_per_tile` features (the last tile of
    each axis may be smaller), each tile's accumulators in `smem_bytes` of
    shared memory, `blocks_per_sm` of them resident per SM. `merge`: the
    warp merge of equal cells before the atomic; `grouped`: rows sorted by
    slot before the sweep (with a slot array); `paired`: the two channels
    of a cell side by side, added by one 128-bit compare-and-swap (f32
    values, C = 2); `direct`: no tiles, a row per thread adds into the
    global accumulators, or at K = 1 into a block's private copy of the
    whole histogram (little work, see plan_hist_tiles). `bins_per_tile`:
    0, or where one column's C * B accumulators exceed HIST_SMEM_BUDGET
    (past 3072 bins in f64 at C = 2, uint16 storage only) the bins of a
    tile: each column cut into feat_tiles / F tiles of a bin range, one
    feature and one slot a tile. On the H100 the merge pays where bins are
    few and popular (B = 256 with Zipf categoricals) and costs at 63
    uniform bins, where the pairing pays instead at the root (K = 1); in
    the waves the pairing was as often slower as faster, and under the
    merge it costs (PERF.md), so the rule turns on the merge by B and the
    pairing only for an unmerged root histogram."""
    slots_per_tile: int
    feats_per_tile: int
    slot_tiles: int
    feat_tiles: int
    smem_bytes: int
    blocks_per_sm: int
    merge: bool
    grouped: bool
    paired: bool
    direct: bool
    bins_per_tile: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def plan_hist_tiles(K: int, C: int, F: int, B: int, *,
                    quantized: bool = False,
                    rows: Optional[int] = None) -> HistTilePlan:
    """The tile plan of a K-slot histogram of C channels over F features of
    B bins (f64 accumulators, int32 with `quantized`) over `rows` rows
    (None: many). A (slot, feature) cell holds C * B accumulators; a tile
    takes as many features as fit HIST_SMEM_BUDGET (balanced over the
    feature tiles) and, when one tile holds every feature, as many slots.
    The direct sweep runs instead at K > 1 over at most DIRECT_MAX_ROWS
    rows, and at K = 1 over at most DIRECT_MAX_ADDS (row, feature) pairs
    when one tile holds the histogram: there the grouping, the tiles'
    zeroing and flush and the pieces cost more than the rows' adds (H100,
    PERF.md). Where one column's cell does not fit the budget, the tiles
    cut its bin range (`bins_per_tile`). Raises on a shape it cannot
    tile."""
    if not (K >= 1 and 1 <= C <= MAX_CHANNELS and F >= 1
            and 1 <= B <= MAX_BINS):
        raise ValueError(f"no tile plan for K={K}, C={C}, F={F}, B={B}")
    if K > MAX_GROUP_SLOTS:
        raise ValueError(f"the slot histogram takes K <= {MAX_GROUP_SLOTS} "
                         f"slots, got {K}")
    acc = 4 if quantized else 8
    cell = C * B * acc
    per_tile = HIST_SMEM_BUDGET // cell
    bpt = 0
    if per_tile == 0:
        # one column's bins exceed a tile: ranges of them, balanced
        nbt = _cdiv(B, HIST_SMEM_BUDGET // (C * acc))
        bpt = _cdiv(B, nbt)
        fpt, nft, nst, spt = 1, F * nbt, K, 1
        smem = bpt * C * acc
    else:
        nft = _cdiv(F, per_tile)
        fpt = _cdiv(F, nft)
        nst = _cdiv(K, max(1, per_tile // fpt) if nft == 1 else 1)
        spt = _cdiv(K, nst)
        smem = spt * fpt * cell
    bps = min(MAX_BLOCKS_PER_SM, SM_SMEM_BYTES // (smem + BLOCK_SMEM_RESERVED))
    merge = B >= MERGE_MIN_BINS
    direct = rows is not None and (
        rows <= DIRECT_MAX_ROWS if K > 1
        else nft == 1 and rows * F <= DIRECT_MAX_ADDS)
    return HistTilePlan(spt, fpt, nst, nft, smem, bps, merge, K > 1,
                        K == 1 and C == 2 and not quantized and not merge,
                        direct, bpt)


def hist_segments(plan: HistTilePlan, N: int, num_sms: int, grouped: bool,
                  min_rows: int = MIN_SEGMENT_ROWS) -> int:
    """Row pieces per feature tile (grouped rows) or per tile (rows of [0,
    N)): as many blocks as one wave of the card holds, of at least
    `min_rows` rows. The kernel cuts the grouped rows, whose count only the
    card knows, into at most this many pieces per feature tile, shared
    among the slot tiles by their rows."""
    wave = num_sms * plan.blocks_per_sm
    if grouped:
        return max(1, wave // plan.feat_tiles)
    tiles = plan.slot_tiles * plan.feat_tiles
    return max(1, min(wave // tiles, N // min_rows))


class FlatTilePlan(NamedTuple):
    """How the engine of csrc/hist_tiles.cuh cuts a flat [K, C, total]
    row-wise histogram whose storage columns have unequal widths (kernels
    #7 and #8): column tiles cut before the columns in `col_cuts` (the
    first column of each tile, then F), each tile's flat span running from
    its first column's offset to the next tile's (the last to `total`), so
    the spans cover the buffer, the padding between column chunks
    included; `slots_per_tile` slots a tile. A block's shared memory is
    `smem_bytes`: the records of at most `max_cols` columns (COL_RECORD
    bytes each), then the [slots_per_tile][C][max_span] accumulators.
    `merge`: the warp merge on every column, where some column is wider
    than 64 (merging only those left the narrow Zipf categorical columns
    of the Criteo storage serialised on their popular cells, PERF.md);
    `paired`: the channel pairing (K = 1, f32, C = 2, no merge);
    `grouped`: rows sorted by slot (K > 1)."""
    slots_per_tile: int
    col_cuts: tuple
    slot_tiles: int
    feat_tiles: int
    max_span: int
    max_cols: int
    smem_bytes: int
    blocks_per_sm: int
    merge: bool
    grouped: bool
    paired: bool


COL_RECORD = 16                # sizeof(FlatCol) in csrc/hist_tiles.cuh
MAX_TILE_COLS = 256            # a flat tile's column records: 4 KB at most


def _flat_cuts(offsets: tuple, total: int, cap: int) -> Optional[list]:
    """Greedy column cuts whose spans (offset of the next tile's first
    column, or `total`, minus the tile's first offset) stay within `cap`
    flat columns and MAX_TILE_COLS columns; None when one column's span
    alone exceeds `cap`."""
    F = len(offsets)
    cuts, f0 = [0], 0
    for f in range(1, F + 1):
        end = offsets[f] if f < F else total
        if end - offsets[f0] > cap or f - f0 > MAX_TILE_COLS:
            if f - 1 == f0:
                return None
            cuts.append(f - 1)
            f0 = f - 1
            if end - offsets[f0] > cap:
                return None
    return cuts + [F]


@functools.lru_cache(maxsize=256)
def plan_flat_tiles(K: int, C: int, offsets: tuple, widths: tuple,
                    total: int, *, quantized: bool = False) -> FlatTilePlan:
    """The tile plan of a K-slot flat histogram of C channels over storage
    columns at `offsets` of `widths` flat columns each, `total` wide (f64
    accumulators, int32 with `quantized`). A tile takes a column range
    whose span x C accumulators fits HIST_SMEM_BUDGET; the fewest tiles,
    with their spans balanced (the least cap that keeps their count);
    when one tile holds every column, as many slots as fit. Raises on a
    layout it cannot tile."""
    F = len(widths)
    if not (K >= 1 and 1 <= C <= MAX_CHANNELS and F >= 1
            and len(offsets) == F and all(1 <= w <= 256 for w in widths)):
        raise ValueError(f"no flat tile plan for K={K}, C={C}, F={F}")
    if K > MAX_GROUP_SLOTS:
        raise ValueError(f"the slot histogram takes K <= {MAX_GROUP_SLOTS} "
                         f"slots, got {K}")
    if offsets[0] != 0 or any(offsets[f] + widths[f] > (
            offsets[f + 1] if f + 1 < F else total) for f in range(F)):
        raise ValueError("the flat columns overlap or leave the buffer")
    acc = 4 if quantized else 8
    cap = HIST_SMEM_BUDGET // (C * acc)
    cuts = _flat_cuts(offsets, total, cap)
    if cuts is None:
        raise ValueError(f"a column's span exceeds the {cap}-column tile")
    nft = len(cuts) - 1
    lo, hi = 1, cap                      # the least cap giving nft tiles
    while lo < hi:
        mid = (lo + hi) // 2
        c = _flat_cuts(offsets, total, mid)
        if c is not None and len(c) - 1 <= nft:
            hi = mid
        else:
            lo = mid + 1
    cuts = _flat_cuts(offsets, total, lo)
    spans = [(offsets[cuts[t + 1]] if cuts[t + 1] < F else total)
             - offsets[cuts[t]] for t in range(nft)]
    span = max(spans)
    cols = max(cuts[t + 1] - cuts[t] for t in range(nft))
    nst = _cdiv(K, max(1, cap // span) if nft == 1 else 1)
    spt = _cdiv(K, nst)
    smem = cols * COL_RECORD + spt * C * span * acc
    bps = min(MAX_BLOCKS_PER_SM, SM_SMEM_BYTES // (smem + BLOCK_SMEM_RESERVED))
    merge = max(widths) >= MERGE_MIN_BINS
    return FlatTilePlan(spt, tuple(cuts), nst, nft, span, cols, smem, bps,
                        merge, K > 1,
                        K == 1 and C == 2 and not quantized and not merge)


def group_warps(N: int) -> int:
    """Warps of the grouping passes: one per GROUP_ROWS rows, at most
    MAX_GROUP_WARPS (then each takes a longer chunk); a warp's chunk is
    ceil(N / warps) rounded up to 32 rows."""
    return min(MAX_GROUP_WARPS, max(1, _cdiv(N, GROUP_ROWS)))


def build_histogram_slots_cuda(X: torch.Tensor, vals: torch.Tensor,
                               slot: Optional[torch.Tensor], num_slots: int,
                               num_bins: int) -> torch.Tensor:
    """[K, C, F, B] histogram of `vals` over the bins of X [F, N] uint8
    (or uint16, past 256 bins), rows routed by `slot` [N] int32 (None:
    every row in slot 0). f32 vals give f32 sums, int8 vals exact int32
    sums."""
    dev = _cuda_device(X)
    F, N = X.shape
    C = _check_hist_args(X, vals, F, N, num_slots, num_bins, dev)
    if slot is not None:
        _check(slot, "slot", (torch.int32,), (N,), dev)
    plan = plan_hist_tiles(num_slots, C, F, num_bins,
                           quantized=vals.dtype == torch.int8, rows=N)
    return _hist_slots_launch(X, vals, slot, num_slots, num_bins, plan)


class TileSizes(NamedTuple):
    """What one launch of the tiled engine (or its direct route) needs
    beside its operands: row pieces per tile `segs`, grouping warps `W` (0:
    rows not grouped), the int32 words of scratch ([lead] for the caller,
    then the grouping's [K*W | K | K+1 | N]; 0: none) and the f64 words of
    the accumulators with the tiles' completion counters (0: unused)."""
    segs: int
    W: int
    scratch: int
    acc: int


def tile_sizes(plan, out_shape: tuple, N: int, has_slot: bool, quant: bool,
               sms: int, min_rows: int = MIN_SEGMENT_ROWS,
               lead: int = 0) -> TileSizes:
    """The sizes of a launch under `plan` (a HistTilePlan or FlatTilePlan)
    of an output `out_shape` = (K, C, row_len...) over N rows on `sms` SMs
    (no allocation, so it runs anywhere)."""
    direct = getattr(plan, "direct", False)
    grouped = plan.grouped and has_slot and not direct
    segs = 1 if direct else hist_segments(plan, N, sms, grouped, min_rows)
    K = out_shape[0]
    W = group_warps(N) if grouped else 0
    n_scratch = lead + (K * W + 2 * K + 1 + N if grouped else 0)
    acc = 0
    if not quant and (grouped or segs > 1 or direct):
        # f64 sums, then one completion counter per tile
        acc = math.prod(out_shape) + _cdiv(plan.slot_tiles
                                           * plan.feat_tiles, 2)
    return TileSizes(segs, W, n_scratch, acc)


class TileBuffers(NamedTuple):
    """The buffers of a launch of tile_sizes' sizes: the int32 `scratch`
    (None when empty), the output and the f64 accumulators (None where
    unused)."""
    segs: int
    W: int
    scratch: Optional[torch.Tensor]
    out: torch.Tensor
    acc: Optional[torch.Tensor]


def tile_buffers(plan, out_shape: tuple, N: int, has_slot: bool,
                 quant: bool, device: torch.device, sms: int,
                 min_rows: int = MIN_SEGMENT_ROWS,
                 lead: int = 0) -> TileBuffers:
    """Allocate for a launch under `plan` (a HistTilePlan or FlatTilePlan)
    of an output `out_shape` = (K, C, row_len...) over N rows."""
    sz = tile_sizes(plan, out_shape, N, has_slot, quant, sms, min_rows, lead)
    return _alloc_tiles(sz, out_shape, quant, device)


def _alloc_tiles(sz: TileSizes, out_shape: tuple, quant: bool,
                 device: torch.device) -> TileBuffers:
    scratch = (torch.empty(sz.scratch, dtype=torch.int32, device=device)
               if sz.scratch else None)
    out = torch.empty(out_shape, device=device,
                      dtype=torch.int32 if quant else torch.float32)
    acc = (torch.empty(sz.acc, dtype=torch.float64, device=device)
           if sz.acc else None)
    return TileBuffers(sz.segs, sz.W, scratch, out, acc)


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _hist_slots_launch(X, vals, slot, K, B, plan: HistTilePlan,
                       min_rows: Optional[int] = None):
    """Launch csrc/hist_slots.cu under `plan` on checked operands, with
    row pieces of at least `min_rows` rows (None: MIN_SEGMENT_ROWS)."""
    if min_rows is None:
        min_rows = MIN_SEGMENT_ROWS
    _check_direct(plan, K)
    dev = X.device
    F, N = X.shape
    C = vals.shape[0]
    quant = vals.dtype == torch.int8
    sms, stream = _launch_env(dev)
    tb = tile_buffers(plan, (K, C, F, B), N, slot is not None, quant, dev,
                      sms, min_rows)
    rc = _lib("build_histogram_slots")(
        X.data_ptr(), int(X.dtype == torch.uint16), vals.data_ptr(),
        int(quant), _ptr(slot), None, None, _ptr(tb.scratch),
        tb.out.data_ptr(), _ptr(tb.acc), N, F, C, K, B,
        plan.slots_per_tile, plan.feats_per_tile, plan.slot_tiles,
        plan.feat_tiles, plan.bins_per_tile or B, tb.segs, min_rows,
        int(plan.merge), int(plan.paired), int(plan.direct), tb.W, sms,
        stream)
    _raise_on(rc, "build_histogram_slots")
    LAUNCHES["build_histogram_slots"] += 1
    return tb.out


def build_histogram_window_cuda(X: torch.Tensor, vals: torch.Tensor,
                                rows: torch.Tensor, win: torch.Tensor,
                                num_bins: int) -> torch.Tensor:
    """[C, F, B] histogram of `vals` over the rows rows[win[0] .. win[1])
    of X [F, N] (uint8 or uint16): `rows` an [N] int32 id list, `win` [2]
    int32 in device memory, so a captured graph replays it for any window.
    One launch of #1's engine on its grouped route with the caller's ids
    (no grouping), planned for N rows: the blocks past the window's pieces
    exit at once, so the work follows the window. f32 sums (int32 for int8
    vals)."""
    dev = _cuda_device(X)
    F, N = X.shape
    C = _check_hist_args(X, vals, F, N, 1, num_bins, dev)
    _check(rows, "rows", (torch.int32,), (N,), dev)
    _check(win, "win", (torch.int32,), (2,), dev)
    quant = vals.dtype == torch.int8
    B = num_bins
    plan = plan_hist_tiles(1, C, F, B, quantized=quant)
    sms, stream = _launch_env(dev)
    segs = hist_segments(plan, N, sms, True)
    n = C * F * B
    out = torch.empty((1, C, F, B), device=dev,
                      dtype=torch.int32 if quant else torch.float32)
    acc = None if quant else torch.empty(
        n + _cdiv(plan.slot_tiles * plan.feat_tiles, 2),
        dtype=torch.float64, device=dev)
    rc = _lib("build_histogram_slots")(
        X.data_ptr(), int(X.dtype == torch.uint16), vals.data_ptr(),
        int(quant), None, rows.data_ptr(), win.data_ptr(), None,
        out.data_ptr(), _ptr(acc), N, F, C, 1, B, plan.slots_per_tile,
        plan.feats_per_tile, plan.slot_tiles, plan.feat_tiles,
        plan.bins_per_tile or B, segs, MIN_SEGMENT_ROWS, int(plan.merge),
        int(plan.paired), 0, 0, sms, stream)
    _raise_on(rc, "build_histogram_slots")
    LAUNCHES["build_histogram_slots"] += 1
    return out[0]


def build_histogram_window_plain(X: torch.Tensor, vals: torch.Tensor,
                                 rows: torch.Tensor, win: torch.Tensor,
                                 num_bins: int) -> torch.Tensor:
    """Plain PyTorch version of build_histogram_window_cuda: the rows
    gathered in id-list order, the positions outside the window in no
    slot (fixed shapes, no read of `win` to the host)."""
    N = rows.shape[0]
    pos = torch.arange(N, device=rows.device)
    inw = (pos >= win[0]) & (pos < win[1])
    r = rows.to(torch.int64)
    slot = torch.where(inw, 0, -1).to(torch.int32)
    Xr = indexable_bins(X).index_select(1, r).view(X.dtype)
    return build_histogram_slots_plain(Xr, vals.index_select(1, r), slot, 1,
                                       num_bins)[0]


def _check_direct(plan: HistTilePlan, K: int) -> None:
    if plan.direct and K == 1 and plan.feat_tiles > 1:
        raise ValueError("the direct sweep at K = 1 keeps the histogram in "
                         "one tile's shared memory; this plan has "
                         f"{plan.feat_tiles} feature tiles")


def build_histogram_slots_plain(X: torch.Tensor, vals: torch.Tensor,
                                slot: Optional[torch.Tensor], num_slots: int,
                                num_bins: int) -> torch.Tensor:
    """Plain PyTorch version of build_histogram_slots_cuda: one index_add_
    per (feature, channel) into f64 (int32 for int8 vals) accumulators;
    rows outside [0, K) and bins >= B land in a discarded trailing cell."""
    F, N = X.shape
    C = vals.shape[0]
    K, B = num_slots, num_bins
    quant = vals.dtype == torch.int8
    acc_dtype = torch.int32 if quant else torch.float64
    trash = K * C * F * B
    acc = torch.zeros(trash + 1, dtype=acc_dtype, device=X.device)
    s = (torch.zeros(N, dtype=torch.int64, device=X.device) if slot is None
         else slot.to(torch.int64))
    ok = (s >= 0) & (s < K)
    base = s.clamp(0, K - 1) * C
    v = vals.to(acc_dtype)
    for f in range(F):
        b = X[f].to(torch.int64)
        okf = ok & (b < B)
        for c in range(C):
            idx = torch.where(okf, ((base + c) * F + f) * B + b, trash)
            acc.index_add_(0, idx, v[c])
    hist = acc[:trash].view(K, C, F, B)
    return hist if quant else hist.to(torch.float32)


def group_rows_by_slot_plain(slot: torch.Tensor, num_slots: int
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain PyTorch version of the kernel's row grouping: (counts [K]
    int64, offsets [K + 1] int64, row ids int32 grouped by slot, ascending
    within each slot); rows whose slot is outside [0, K) are dropped."""
    s = slot.to(torch.int64)
    ids = torch.nonzero((s >= 0) & (s < num_slots)).flatten()
    order = torch.sort(s[ids], stable=True).indices
    counts = torch.bincount(s[ids], minlength=num_slots)
    offsets = torch.zeros(num_slots + 1, dtype=torch.int64,
                          device=slot.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return counts, offsets, ids[order].to(torch.int32)


# ---------------------------------------------------------------------------
# 2. leaf values: the score update and the gather
# ---------------------------------------------------------------------------
def _check_leaf_args(values, leaf_of_row, dev):
    if values.dim() != 1 or leaf_of_row.dim() != 1:
        raise ValueError("values must be [L] and leaf_of_row [N]")
    L, N = values.shape[0], leaf_of_row.shape[0]
    if not 1 <= L <= MAX_LEAVES:
        raise ValueError(f"values must hold 1 <= L <= {MAX_LEAVES} leaves, "
                         f"got {L}")
    _check(values, "values", (torch.float32,), (L,), dev)
    _check(leaf_of_row, "leaf_of_row", (torch.int32,), (N,), dev)
    return L, N


def _leaf_values_launch(values, leaf_of_row, out, accumulate: bool):
    L, N = values.shape[0], leaf_of_row.shape[0]
    sms, stream = _launch_env(values.device)
    rc = _lib("take_leaf_values")(values.data_ptr(), L,
                                  leaf_of_row.data_ptr(), out.data_ptr(), N,
                                  int(accumulate), sms, stream)
    _raise_on(rc, "take_leaf_values")
    LAUNCHES["take_leaf_values"] += 1


def add_leaf_values_cuda(scores: torch.Tensor, values: torch.Tensor,
                         leaf_of_row: torch.Tensor) -> torch.Tensor:
    """scores += values[leaf_of_row] in place ([N] f32, [L] f32, [N]
    int32), one launch; rows whose leaf id is outside [0, L) add 0. The
    scores are bitwise those of `scores += take_leaf_values(values,
    leaf_of_row)`. Returns `scores`."""
    dev = _cuda_device(values)
    _, N = _check_leaf_args(values, leaf_of_row, dev)
    _check(scores, "scores", (torch.float32,), (N,), dev)
    _leaf_values_launch(values, leaf_of_row, scores, True)
    return scores


def add_leaf_values_plain(scores: torch.Tensor, values: torch.Tensor,
                          leaf_of_row: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of add_leaf_values_cuda."""
    scores += take_leaf_values_plain(values, leaf_of_row)
    return scores


def take_leaf_values_cuda(values: torch.Tensor,
                          leaf_of_row: torch.Tensor) -> torch.Tensor:
    """values[leaf_of_row] ([L] f32, [N] int32 -> [N] f32), bitwise; rows
    whose leaf id is outside [0, L) get 0."""
    dev = _cuda_device(values)
    _, N = _check_leaf_args(values, leaf_of_row, dev)
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    _leaf_values_launch(values, leaf_of_row, out, False)
    return out


def take_leaf_values_plain(values: torch.Tensor,
                           leaf_of_row: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of take_leaf_values_cuda."""
    L = values.shape[0]
    lor = leaf_of_row.to(torch.int64)
    ok = (lor >= 0) & (lor < L)
    picked = values[lor.clamp(0, max(L - 1, 0))]
    return torch.where(ok, picked, torch.zeros_like(picked))

# ---------------------------------------------------------------------------
# 3. / 5. wave pass and relabel
# ---------------------------------------------------------------------------
def _check_wave_args(X, leaf_of_row, table, num_leaves, dev):
    if X.dim() != 2:
        raise ValueError("X must be [F, N]")
    F, N = X.shape
    if not 1 <= F <= MAX_WAVE_FEATURES:
        raise ValueError(f"the wave kernels take F <= {MAX_WAVE_FEATURES} "
                         f"storage columns, got {F}")
    _check(X, "X", (torch.uint8,), (F, N), dev)
    _check(leaf_of_row, "leaf_of_row", (torch.int32,), (N,), dev)
    _check(table, "table", (torch.int32,), (T_ROWS, MAX_SLOTS), dev)
    if not 1 <= num_leaves <= MAX_LEAVES:
        raise ValueError(f"num_leaves must be in [1, {MAX_LEAVES}], got "
                         f"{num_leaves}")
    return F, N


class WaveHistLayout(NamedTuple):
    """The host-side choice of a megakernel-route wave's (kernels #3 and
    #9) histogram launch: kernel #1's tile plan, chosen on the N rows (how
    many rows land in the smaller children only the card knows, and the
    wave loop reads nothing back for it), the least rows of a piece, the
    engine's sizes with the membership pass's [N] slots leading the
    scratch, and the bytes of the f64 accumulators and of the output that
    the membership pass zeroes: whatever the histogram launch adds into
    rather than writes."""
    plan: HistTilePlan
    min_rows: int
    prefetch: int
    sizes: TileSizes
    zero_acc_bytes: int
    zero_out_bytes: int


WAVE_PREFETCH = 4       # columns of a row's bins loaded ahead of its adds


@functools.lru_cache(maxsize=1024)
def wave_hist_layout(K: int, C: int, F: int, B: int, N: int,
                     quantized: bool, sms: int,
                     plan: Optional[HistTilePlan] = None,
                     min_rows: int = MIN_SEGMENT_ROWS,
                     prefetch: Optional[int] = None) -> WaveHistLayout:
    """The WaveHistLayout of a wave of K slots over X [F, N] of B bins and
    C value channels (int32 sums with `quantized`) on `sms` SMs, under
    `plan` (None: plan_hist_tiles') with pieces of at least `min_rows`
    rows, the tiles reading a row's bins `prefetch` (1 or WAVE_PREFETCH)
    columns ahead of its adds. None: WAVE_PREFETCH, but 1 under the
    channel pairing (the root-like K = 1 wave, where reading ahead cost
    25% on an H100 while it saved 3-10% on the grouped waves, PERF.md)."""
    if plan is None:
        plan = plan_hist_tiles(K, C, F, B, quantized=quantized, rows=N)
    if prefetch is None:
        prefetch = 1 if plan.paired else WAVE_PREFETCH
    if prefetch not in (1, WAVE_PREFETCH):
        raise ValueError(f"the wave kernels read 1 or {WAVE_PREFETCH} "
                         f"columns ahead, not {prefetch}")
    sz = tile_sizes(plan, (K, C, F, B), N, True, quantized, sms, min_rows,
                    lead=N)
    n = K * C * F * B
    if quantized:
        # the int32 output is the accumulator, unless each tile is one
        # piece that writes its cells
        out_adds = plan.direct or sz.W > 0 or sz.segs > 1
    else:
        # a slot tile without grouped rows takes no block
        out_adds = sz.W > 0
    return WaveHistLayout(plan, min_rows, prefetch, sz, 8 * sz.acc,
                          4 * n if out_adds else 0)


def _wave_hist_args(lay: WaveHistLayout) -> list:
    """The plan and zeroing arguments of lgbt_wave_pass /
    lgbt_wave_pass_fused."""
    p, sz = lay.plan, lay.sizes
    return [p.slots_per_tile, p.feats_per_tile, p.slot_tiles, p.feat_tiles,
            sz.segs, lay.min_rows, int(p.merge), int(p.paired),
            int(p.direct), sz.W, lay.zero_acc_bytes, lay.zero_out_bytes,
            lay.prefetch]


def wave_pass_cuda(X: torch.Tensor, vals: torch.Tensor,
                   leaf_of_row: torch.Tensor, table: torch.Tensor,
                   num_slots: int, num_bins: int, num_leaves: int, *,
                   gmap: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One wave's row sweep: returns (new leaf_of_row [N] int32, smaller-
    child slot histogram [K, C, F, B]). `table` is the [16, 128] int32
    semantic wave table (csrc/wave_table.cuh); every leaf id in it and in
    leaf_of_row is below `num_leaves`; `gmap` the caller's new_leaf_map
    past LEAF_CAP leaves (None: one for this launch). Two steps on the
    card: the membership pass (each row's new leaf and slot), then the slot
    histogram by the tiled engine or its direct route (wave_hist_layout)."""
    dev = _cuda_device(X)
    F, N = _check_wave_args(X, leaf_of_row, table, num_leaves, dev)
    if not 1 <= num_slots <= MAX_SLOTS:
        raise ValueError(f"num_slots must be in [1, {MAX_SLOTS}], got "
                         f"{num_slots}")
    C = _check_hist_args(X, vals, F, N, num_slots, num_bins, dev)
    lay = wave_hist_layout(num_slots, C, F, num_bins, N,
                           vals.dtype == torch.int8, _sm_count(dev.index))
    return _wave_pass_launch(X, vals, leaf_of_row, table, num_slots,
                             num_bins, num_leaves, lay,
                             _gmap(gmap, dev, num_leaves))


def _wave_pass_launch(X, vals, leaf_of_row, table, K, B, L,
                      lay: WaveHistLayout, gmap: Optional[torch.Tensor]):
    """Launch csrc/wave_pass.cu under `lay` on checked operands."""
    dev = X.device
    F, N = X.shape
    C = vals.shape[0]
    quant = vals.dtype == torch.int8
    sms, stream = _launch_env(dev)
    new_lor = torch.empty_like(leaf_of_row)
    tb = _alloc_tiles(lay.sizes, (K, C, F, B), quant, dev)
    rc = _lib("wave_pass")(
        X.data_ptr(), vals.data_ptr(), int(quant), leaf_of_row.data_ptr(),
        table.data_ptr(), new_lor.data_ptr(), tb.out.data_ptr(),
        _ptr(tb.acc), _ptr(tb.scratch), N, F, C, K, B, L,
        _ptr(gmap), *_wave_hist_args(lay), sms, stream)
    _raise_on(rc, "wave_pass")
    LAUNCHES["wave_pass"] += 1
    return new_lor, tb.out


def _relabel_out(leaf_of_row: torch.Tensor,
                 out: Optional[torch.Tensor]) -> torch.Tensor:
    if out is None:
        return torch.empty_like(leaf_of_row)
    if out.shape != leaf_of_row.shape or out.dtype != torch.int32 \
            or out.device != leaf_of_row.device or not out.is_contiguous():
        raise ValueError("out must be a contiguous int32 tensor like "
                         "leaf_of_row")
    return out


def wave_relabel_cuda(X: torch.Tensor, leaf_of_row: torch.Tensor,
                      table: torch.Tensor, num_leaves: int,
                      out: Optional[torch.Tensor] = None, *,
                      gmap: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply the wave table's splits only: new leaf_of_row [N] int32,
    written to `out` (None: a new tensor; `out` may be leaf_of_row
    itself, a relabel in place, as the grower runs it); `gmap` as in
    wave_pass_cuda."""
    dev = _cuda_device(X)
    F, N = _check_wave_args(X, leaf_of_row, table, num_leaves, dev)
    new_lor = _relabel_out(leaf_of_row, out)
    sms, stream = _launch_env(dev)
    rc = _lib("wave_relabel")(X.data_ptr(), leaf_of_row.data_ptr(),
                              table.data_ptr(), new_lor.data_ptr(), N, F,
                              num_leaves,
                              _ptr(_gmap(gmap, dev, num_leaves)), sms,
                              stream)
    _raise_on(rc, "wave_relabel")
    LAUNCHES["wave_relabel"] += 1
    return new_lor


def _pack_entries(t: torch.Tensor, row0: int, sil) -> torch.Tensor:
    """[128] int64 packed entries, the TPU kernel's bit layout
    (feat&31 | thr<<5 | dl<<13 | miss_bin<<14 | sil<<23)."""
    feat, thr, dl, mt, db, nb = (t[row0 + i] for i in range(6))
    mb = torch.where(mt == 1, db, torch.where(mt == 2, nb - 1,
                                              torch.full_like(db, 0x1FF)))
    return (feat & 31) | (thr << 5) | (dl << 13) | (mb << 14) | (sil << 23)


def _go_left(p: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Per-row go-left under per-row packed entries p [N]."""
    F, N = X.shape
    feat = p & 31
    thr = (p >> 5) & 0xFF
    dl = ((p >> 13) & 1) == 1
    mb = (p >> 14) & 0x1FF
    rows = torch.arange(N, device=X.device)
    col = X[feat.clamp(max=F - 1), rows].to(torch.int64)
    col = torch.where(feat < F, col, torch.zeros_like(col))
    return torch.where(col == mb, dl, col <= thr)


def _entry_of(lor: torch.Tensor, leaves: torch.Tensor,
              chunk: int = 1 << 16) -> torch.Tensor:
    """Index of the first active entry whose leaf equals each row's leaf
    ([N] int64, -1 where none): the TPU kernel's leaf-match mask."""
    out = torch.full(lor.shape, -1, dtype=torch.int64, device=lor.device)
    act = leaves >= 0
    for lo in range(0, lor.shape[0], chunk):
        m = (lor[lo:lo + chunk, None] == leaves[None, :]) & act[None, :]
        k = m.to(torch.uint8).argmax(dim=1)
        out[lo:lo + chunk] = torch.where(m.any(dim=1), k, -1)
    return out


def _relabel_plain(X, lor, t):
    app = _pack_entries(t, 1, 0)
    ka = _entry_of(lor, t[0])
    gl = _go_left(app[ka.clamp(min=0)], X)
    nl0 = t[15, 0]
    return torch.where((ka >= 0) & ~gl, nl0 + ka, lor.to(torch.int64))


def wave_member_plain(X: torch.Tensor, leaf_of_row: torch.Tensor,
                      table: torch.Tensor, num_slots: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the wave kernels' membership pass
    (csrc/wave_member.cuh): (new leaf_of_row [N] int32, slot [N] int32,
    the candidate entry k < num_slots whose smaller child the row lands
    in, else -1)."""
    t = table.to(torch.int64)
    new = _relabel_plain(X, leaf_of_row, t)
    K = num_slots
    cand = _pack_entries(t, 8, t[14] & 1)[:K]
    kc = _entry_of(new, t[7, :K])
    p = cand[kc.clamp(min=0)]
    in_small = (kc >= 0) & (_go_left(p, X) == (((p >> 23) & 1) == 1))
    slot = torch.where(in_small, kc, -1).to(torch.int32)
    return new.to(torch.int32), slot


def wave_pass_plain(X: torch.Tensor, vals: torch.Tensor,
                    leaf_of_row: torch.Tensor, table: torch.Tensor,
                    num_slots: int, num_bins: int,
                    num_leaves: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of wave_pass_cuda (`num_leaves` bounds the
    leaf ids for the kernel's lookup table; the plain version compares
    every row against every entry instead): the membership pass, then the
    slot histogram."""
    new, slot = wave_member_plain(X, leaf_of_row, table, num_slots)
    return new, build_histogram_slots_plain(X, vals, slot, num_slots,
                                            num_bins)


def wave_relabel_plain(X: torch.Tensor, leaf_of_row: torch.Tensor,
                       table: torch.Tensor, num_leaves: int,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of wave_relabel_cuda."""
    new = _relabel_plain(X, leaf_of_row, table.to(torch.int64))
    return _relabel_out(leaf_of_row, out).copy_(new)


# ---------------------------------------------------------------------------
# 4. wave apply (wide / categorical / EFB route)
# ---------------------------------------------------------------------------
def _check_apply_args(dec, leaf_of_row, table, num_leaves, dev):
    if dec.dim() != 2 or leaf_of_row.dim() != 1:
        raise ValueError("dec must be [Kd, N] and leaf_of_row [N]")
    Kd, N = dec.shape
    if not 1 <= Kd <= MAX_SLOTS:
        raise ValueError(f"dec must have 1 <= Kd <= {MAX_SLOTS} entry rows, "
                         f"got {Kd}")
    _check(dec, "dec", (torch.int8, torch.uint8), (Kd, N), dev)
    _check(leaf_of_row, "leaf_of_row", (torch.int32,), (N,), dev)
    _check(table, "table", (torch.int32,), (T_ROWS, MAX_SLOTS), dev)
    if not 1 <= num_leaves <= MAX_LEAVES:
        raise ValueError(f"num_leaves must be in [1, {MAX_LEAVES}], got "
                         f"{num_leaves}")
    return Kd, N


MAX_CAT_WORDS = 8       # LGBT_AP_MAX_W in csrc/wave_apply.cu: the bitset
                        # words the uint8 instance stages (the uint16 one
                        # reads any number from `cats`)


def _check_split_args(X, leaf_of_row, table, cats, bundle, num_entries,
                      num_leaves, dev):
    """Check the operands of the decide-and-apply pass; returns (N, F,
    W): rows, the features the table's ids index, bitset words."""
    if X.dim() != 2 or leaf_of_row.dim() != 1:
        raise ValueError("X must be [C, N] and leaf_of_row [N]")
    C, N = X.shape
    _check(X, "X", BIN_DTYPES, (C, N), dev)
    _check(leaf_of_row, "leaf_of_row", (torch.int32,), (N,), dev)
    _check(table, "table", (torch.int32,), (T_ROWS, MAX_SLOTS), dev)
    wide = X.dtype == torch.uint16
    if not 1 <= num_entries <= MAX_SLOTS:
        raise ValueError(f"num_entries must be in [1, {MAX_SLOTS}], got "
                         f"{num_entries}")
    if not 1 <= num_leaves <= MAX_LEAVES:
        raise ValueError(f"num_leaves must be in [1, {MAX_LEAVES}], got "
                         f"{num_leaves}")
    W = 0
    if cats is not None:
        W = cats.shape[-1] - 1 if cats.dim() == 3 else -1
        wmax = MAX_BINS // 32 if wide else MAX_CAT_WORDS
        if not 1 <= W <= wmax:
            raise ValueError(f"cats must be [2, {MAX_SLOTS}, 1 + W] with "
                             f"1 <= W <= {wmax} for {X.dtype} bins")
        _check(cats, "cats", (torch.int32,), (2, MAX_SLOTS, 1 + W), dev)
    F = C
    if bundle is not None:
        if wide:
            raise ValueError("EFB bundles are uint8 columns: no bundle map "
                             "over uint16 storage")
        if bundle.dim() != 2 or bundle.shape[0] != 4:
            raise ValueError("bundle must be [4, F]")
        F = bundle.shape[1]
        _check(bundle, "bundle", (torch.int32,), (4, F), dev)
    return N, F, W


def wave_apply_cuda(X: torch.Tensor, leaf_of_row: torch.Tensor,
                    table: torch.Tensor, cats: Optional[torch.Tensor],
                    bundle: Optional[torch.Tensor], num_entries: int,
                    num_leaves: int, *, gmap: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One wave of the wide / categorical / EFB route, each row decided
    from the split records: returns (new leaf_of_row [N] int32, smaller-
    child slot [N] int32, -1 = none). X [C, N] uint8 (uint16 past 256
    bins, with no bundle map) holds the storage
    columns; `table` is the [16, 128] wave table with rows 0-15 filled
    (csrc/wave_apply.cu), entries at `num_entries` or above inactive;
    `cats` [2, 128, 1 + W] int32 the applied and candidate entries'
    categorical flags and bitset words (None: no categorical entry);
    `bundle` [4, F] int32 the EFB map of each feature (column, offset or
    -1, num_bin, default bin; None: feature f is column f). Every leaf id
    in the table and in leaf_of_row that should match is below
    `num_leaves`; `gmap` as in wave_pass_cuda."""
    dev = _cuda_device(X)
    N, F, W = _check_split_args(X, leaf_of_row, table, cats, bundle,
                                num_entries, num_leaves, dev)
    new_lor = torch.empty_like(leaf_of_row)
    slot = torch.empty_like(leaf_of_row)
    sms, stream = _launch_env(dev)
    rc = _lib("wave_apply")(X.data_ptr(), int(X.dtype == torch.uint16),
                            leaf_of_row.data_ptr(),
                            table.data_ptr(), _ptr(cats), W, _ptr(bundle),
                            F, new_lor.data_ptr(), slot.data_ptr(), N,
                            num_entries, num_leaves,
                            _ptr(_gmap(gmap, dev, num_leaves)), sms, stream)
    _raise_on(rc, "wave_apply")
    LAUNCHES["wave_apply"] += 1
    return new_lor, slot


def _row_go_left(X: torch.Tensor, t: torch.Tensor, row0: int,
                 cat: Optional[torch.Tensor], bundle: Optional[torch.Tensor],
                 k: torch.Tensor) -> torch.Tensor:
    """[N] go-left of each row under entry k[row] (k >= 0) of the split
    rows row0..row0+5 of the int64 wave table `t`: the entry's record
    gathered per row, its feature's byte read, unpacked and tested."""
    C, N = X.shape
    kk = k.clamp(min=0)
    feat, thr, dl, mt, db, nb = (t[row0 + i][kk] for i in range(6))
    F = C if bundle is None else bundle.shape[1]
    f = feat.clamp(0, F - 1)
    rows = torch.arange(N, device=X.device)
    if bundle is None:
        b = bin_values(indexable_bins(X)[f, rows])
    else:
        bm = bundle.to(torch.int64)[:, f]
        src = X[bm[0], rows].to(torch.int64)
        rb = src - bm[1]
        unp = torch.where((rb >= 0) & (rb < bm[2] - 1),
                          rb + (rb >= bm[3]).to(torch.int64), bm[3])
        b = torch.where(bm[1] < 0, src, unp)
    mb = torch.where(mt == 1, db, torch.where(mt == 2, nb - 1,
                                              torch.full_like(db, -1)))
    gl = torch.where(b == mb, dl != 0, b <= thr)
    if cat is not None:
        c = cat.to(torch.int64)[kk]                    # [N, 1 + W]
        W = c.shape[1] - 1
        word = c.gather(1, 1 + (b >> 5).clamp(max=W - 1)[:, None])[:, 0]
        gl = torch.where(c[:, 0] != 0, ((word >> (b & 31)) & 1) == 1, gl)
    return gl


def wave_apply_rows_plain(X: torch.Tensor, leaf_of_row: torch.Tensor,
                          table: torch.Tensor, cats: Optional[torch.Tensor],
                          bundle: Optional[torch.Tensor], num_entries: int,
                          num_leaves: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of wave_apply_cuda, in the kernel's per-row
    form: each row's entry from the leaf maps (a leaf named by two active
    entries matches neither), its split tested on its own byte."""
    t = table.to(torch.int64)
    cap = num_leaves
    lor = leaf_of_row.to(torch.int64)

    def lookup(ent, leaf):
        return ent[torch.where((leaf >= 0) & (leaf < cap), leaf, cap)]

    ka = lookup(_leaf_entries(t[0], num_entries, cap), lor)
    gl = _row_go_left(X, t, 1, None if cats is None else cats[0], bundle, ka)
    new = torch.where((ka >= 0) & ~gl, t[15, 0] + ka, lor)
    kc = lookup(_leaf_entries(t[7], num_entries, cap), new)
    gl = _row_go_left(X, t, 8, None if cats is None else cats[1], bundle, kc)
    land = gl == ((t[14][kc.clamp(min=0)] & 1) == 1)
    slot = torch.where((kc >= 0) & land, kc, -1)
    return new.to(torch.int32), slot.to(torch.int32)


def _leaf_entries(leaves: torch.Tensor, Kd: int, cap: int) -> torch.Tensor:
    """[cap + 1] int64 map leaf -> the one active entry (k < Kd) naming it,
    -1 where none or several do (the TPU kernel's `inA == 1` rule); slot
    `cap` takes every leaf outside [0, cap)."""
    dev = leaves.device
    k = torch.arange(leaves.shape[0], device=dev)
    act = (leaves >= 0) & (leaves < cap) & (k < Kd)
    idx = torch.where(act, leaves, cap)
    cnt = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    cnt.index_add_(0, idx, torch.ones_like(idx))
    ent = torch.full((cap + 1,), -1, dtype=torch.int64, device=dev)
    ent.scatter_(0, idx, k)
    ent = torch.where(cnt == 1, ent, -1)
    ent[cap:].fill_(-1)
    return ent


def wave_apply_plain(dec: torch.Tensor, leaf_of_row: torch.Tensor,
                     table: torch.Tensor, num_leaves: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Leaf membership of one wave from precomputed decision bits, the TPU
    kernel's form (wave_apply_pallas): returns (new leaf_of_row, slot).
    `dec` [Kd, N]: bit 0 = go left under applied entry k, bit 1 = in
    candidate k's smaller child; table rows 0, 7 and 15 are read, entries
    at Kd or above are inactive. The plain side of the fused waves
    (#10's decision bits) and the reference that wave_apply_cuda, which
    decides each row itself, is held to."""
    Kd = dec.shape[0]
    t = table.to(torch.int64)
    cap = num_leaves
    lor = leaf_of_row.to(torch.int64)

    def lookup(ent, leaf):
        return ent[torch.where((leaf >= 0) & (leaf < cap), leaf, cap)]

    def bits(k):
        return dec.gather(0, k.clamp(min=0)[None, :])[0].to(torch.int64)

    ka = lookup(_leaf_entries(t[0], Kd, cap), lor)
    new = torch.where((ka >= 0) & ((bits(ka) & 1) == 0), t[15, 0] + ka, lor)
    kc = lookup(_leaf_entries(t[7], Kd, cap), new)
    slot = torch.where((kc >= 0) & (((bits(kc) >> 1) & 1) == 1), kc, -1)
    return new.to(torch.int32), slot.to(torch.int32)


# ---------------------------------------------------------------------------
# 11. window partition (the compact grower's split, batched)
# ---------------------------------------------------------------------------
PART_HEAD = 9           # LGBT_WP_HEAD in csrc/window_partition.cu


def _check_partition_args(X, order, leaf_of_row, rec, dev):
    if X.dim() != 2:
        raise ValueError("X must be [F, N]")
    F, N = X.shape
    _check(X, "X", BIN_DTYPES, (F, N), dev)
    _check(order, "order", (torch.int32,), (N,), dev)
    _check(leaf_of_row, "leaf_of_row", (torch.int32,), (N,), dev)
    if rec.dim() != 1 or rec.shape[0] <= PART_HEAD:
        raise ValueError(f"rec must be [{PART_HEAD} + W] with W >= 1")
    _check(rec, "rec", (torch.int32,), (rec.shape[0],), dev)
    return F, N


def window_partition_cuda(X: torch.Tensor, order: torch.Tensor,
                          leaf_of_row: torch.Tensor,
                          rec: torch.Tensor) -> torch.Tensor:
    """Stable partition of the window order[start .. start + count) under
    one split, in place: the rows going left first, each side in its order;
    the rows going right take the new leaf's id in `leaf_of_row`. X [F, N]
    uint8 or uint16, order / leaf_of_row [N] int32, `rec` the int32 record
    (start, count, storage column, threshold, default_left, missing bin or
    -1, is_cat, new leaf, W, then W bitset words; ops/grow_batched.py:
    partition_record) in device memory. Returns the left count, [1] int32
    on the device."""
    dev = _cuda_device(X)
    F, N = _check_partition_args(X, order, leaf_of_row, rec, dev)
    W = group_warps(N)
    wl = torch.empty(W, dtype=torch.int32, device=dev)
    tmp = torch.empty(N, dtype=torch.int32, device=dev)
    n_left = torch.empty(1, dtype=torch.int32, device=dev)
    sms, stream = _launch_env(dev)
    rc = _lib("window_partition")(
        X.data_ptr(), int(X.dtype == torch.uint16), order.data_ptr(),
        leaf_of_row.data_ptr(), rec.data_ptr(), wl.data_ptr(),
        tmp.data_ptr(), n_left.data_ptr(), N, F, W, sms, stream)
    _raise_on(rc, "window_partition")
    LAUNCHES["window_partition"] += 1
    return n_left


def window_partition_plain(X: torch.Tensor, order: torch.Tensor,
                           leaf_of_row: torch.Tensor,
                           rec: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of window_partition_cuda: every position's
    row decided, then a stable sort of the positions by (before the window,
    left, right, after it), at fixed shapes with no read to the host."""
    F, N = X.shape
    dev = X.device
    r = rec.to(torch.int64)
    start, count = r[0], r[1]
    pos = torch.arange(N, device=dev)
    inw = (pos >= start) & (pos < start + count)
    rows = order.to(torch.int64)
    b = bin_values(indexable_bins(X).index_select(
        0, r[2].clamp(0, F - 1).reshape(1))[0])[rows]
    words = r[PART_HEAD:] & 0xFFFFFFFF
    W = words.shape[0]
    bit = (words[(b >> 5).clamp(max=W - 1)] >> (b & 31)) & 1
    gl = torch.where(r[6] != 0, bit == 1,
                     torch.where(b == r[5], r[4] != 0, b <= r[3]))
    key = torch.where(pos < start, 0,
                      torch.where(inw, torch.where(gl, 1, 2), 3))
    perm = torch.sort(key, stable=True).indices
    right = inw & ~gl
    leaf_of_row.index_put_((rows,), torch.where(
        right, r[7].to(torch.int32), leaf_of_row[rows]))
    order.copy_(order[perm])
    return (inw & gl).sum().to(torch.int32).reshape(1)
