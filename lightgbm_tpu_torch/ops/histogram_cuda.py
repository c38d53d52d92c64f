"""Hopper kernels of the training path, their wrappers and plain versions.

Four CUDA kernels (``lightgbm_tpu_torch/csrc/*.cu``) replace the four Pallas
kernels the JAX package runs on this path (lightgbm_tpu/ops/
histogram_pallas.py):

  build_histogram_slots_cuda  K-slot histogram      <- build_histogram_slots_pallas
  take_leaf_values_cuda       values[leaf_of_row]   <- take_leaf_values_pallas
  wave_pass_cuda              relabel + candidate membership + slot
                              histogram in one row sweep <- wave_pass_pallas
  wave_relabel_cuda           relabel only          <- wave_relabel_pallas

Each kernel is compiled by ``nvcc`` for ``sm_90a`` into a shared library
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
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

LAUNCHES: Dict[str, int] = {"build_histogram_slots": 0,
                            "take_leaf_values": 0,
                            "wave_pass": 0,
                            "wave_relabel": 0}

# kernel name -> (source file, C entry point)
KERNELS = {
    "build_histogram_slots": ("hist_slots.cu", "lgbt_hist_slots"),
    "take_leaf_values": ("take_leaf_values.cu", "lgbt_take_leaf_values"),
    "wave_pass": ("wave_pass.cu", "lgbt_wave_pass"),
    "wave_relabel": ("wave_relabel.cu", "lgbt_wave_relabel"),
}

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

MAX_CHANNELS = 4        # LGBT_MAX_C in csrc/common.cuh
MAX_WAVE_FEATURES = 32  # the packed table entry holds feat & 31
MAX_SLOTS = 128         # LGBT_T_ENTRIES in csrc/wave_table.cuh
MAX_LEAVES = 4096       # LGBT_LEAF_CAP in csrc/wave_table.cuh
T_ROWS = 16             # rows of the semantic wave table


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
    source, all started together. Returns {name: {"path", "seconds",
    "log"}} where ``log`` is nvcc's output (``-Xptxas -v`` register and
    shared-memory counts) for the sources built by this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = _source_tag()
    procs, out = {}, {}
    t0 = time.perf_counter()
    for name, (src, _) in KERNELS.items():
        so = BUILD_DIR / f"{name}-{tag}.so"
        out[name] = {"path": str(so), "seconds": 0.0, "log": ""}
        if so.exists():
            continue
        tmp = BUILD_DIR / f"{name}-{tag}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        out[name]["log"] = log
        out[name]["seconds"] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def _lib(name: str):
    """The loaded C entry point of kernel `name` (builds on first use)."""
    paths = build_kernels()
    fn = getattr(ctypes.CDLL(paths[name]["path"]), KERNELS[name][1])
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.restype = I
    fn.argtypes = {
        "build_histogram_slots": [P, P, I, P, P, P, LL, I, I, I, I, I, P],
        "take_leaf_values": [P, I, P, P, LL, I, P],
        "wave_pass": [P, P, I, P, P, P, P, P, LL, I, I, I, I, I, I, P],
        "wave_relabel": [P, P, P, P, LL, I, I, I, P],
    }[name]
    return fn


def _launch_env(device: torch.device) -> Tuple[int, int]:
    """(SM count, current stream handle) for a launch on `device`."""
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count, \
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


def _check_hist_args(X, vals, F, N, num_slots, num_bins, dev):
    if F < 1 or N < 0:
        raise ValueError(f"X must be [F, N] with F >= 1, got {tuple(X.shape)}")
    _check(X, "X", (torch.uint8,), (F, N), dev)
    C = vals.shape[0] if vals.dim() == 2 else -1
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"vals must be [C, N] with 1 <= C <= "
                         f"{MAX_CHANNELS}, got {tuple(vals.shape)}")
    _check(vals, "vals", (torch.float32, torch.int8), (C, N), dev)
    if not 1 <= num_bins <= 256:
        raise ValueError(f"num_bins must be in [1, 256], got {num_bins}")
    if num_slots < 1 or num_slots * C * F * num_bins >= 2 ** 31:
        raise ValueError(f"num_slots={num_slots} is out of range")
    return C


def _hist_buffers(K, C, F, B, quantized, dev):
    """(out, f64 accumulators or None) for a histogram launch."""
    if quantized:
        return torch.zeros((K, C, F, B), dtype=torch.int32, device=dev), None
    return (torch.empty((K, C, F, B), dtype=torch.float32, device=dev),
            torch.zeros((K * C * F * B,), dtype=torch.float64, device=dev))


# ---------------------------------------------------------------------------
# 1. K-slot histogram
# ---------------------------------------------------------------------------
def build_histogram_slots_cuda(X: torch.Tensor, vals: torch.Tensor,
                               slot: Optional[torch.Tensor], num_slots: int,
                               num_bins: int) -> torch.Tensor:
    """[K, C, F, B] histogram of `vals` over the bins of X [F, N] uint8,
    rows routed by `slot` [N] int32 (None: every row in slot 0). f32 vals
    give f32 sums, int8 vals exact int32 sums."""
    dev = _cuda_device(X)
    F, N = X.shape
    C = _check_hist_args(X, vals, F, N, num_slots, num_bins, dev)
    if slot is not None:
        _check(slot, "slot", (torch.int32,), (N,), dev)
    quant = vals.dtype == torch.int8
    out, acc = _hist_buffers(num_slots, C, F, num_bins, quant, dev)
    sms, stream = _launch_env(dev)
    rc = _lib("build_histogram_slots")(
        X.data_ptr(), vals.data_ptr(), int(quant),
        slot.data_ptr() if slot is not None else None, out.data_ptr(),
        acc.data_ptr() if acc is not None else None, N, F, C, num_slots,
        num_bins, sms, stream)
    _raise_on(rc, "build_histogram_slots")
    LAUNCHES["build_histogram_slots"] += 1
    return out


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


# ---------------------------------------------------------------------------
# 2. leaf-value gather
# ---------------------------------------------------------------------------
def take_leaf_values_cuda(values: torch.Tensor,
                          leaf_of_row: torch.Tensor) -> torch.Tensor:
    """values[leaf_of_row] ([L] f32, [N] int32 -> [N] f32), bitwise; rows
    whose leaf id is outside [0, L) get 0."""
    dev = _cuda_device(values)
    if values.dim() != 1 or leaf_of_row.dim() != 1:
        raise ValueError("values must be [L] and leaf_of_row [N]")
    L, N = values.shape[0], leaf_of_row.shape[0]
    _check(values, "values", (torch.float32,), (L,), dev)
    _check(leaf_of_row, "leaf_of_row", (torch.int32,), (N,), dev)
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    sms, stream = _launch_env(dev)
    rc = _lib("take_leaf_values")(values.data_ptr(), L,
                                  leaf_of_row.data_ptr(), out.data_ptr(), N,
                                  sms, stream)
    _raise_on(rc, "take_leaf_values")
    LAUNCHES["take_leaf_values"] += 1
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


def wave_pass_cuda(X: torch.Tensor, vals: torch.Tensor,
                   leaf_of_row: torch.Tensor, table: torch.Tensor,
                   num_slots: int, num_bins: int,
                   num_leaves: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One wave's row sweep: returns (new leaf_of_row [N] int32, smaller-
    child slot histogram [K, C, F, B]). `table` is the [16, 128] int32
    semantic wave table (csrc/wave_table.cuh); every leaf id in it and in
    leaf_of_row is below `num_leaves`."""
    dev = _cuda_device(X)
    F, N = _check_wave_args(X, leaf_of_row, table, num_leaves, dev)
    if not 1 <= num_slots <= MAX_SLOTS:
        raise ValueError(f"num_slots must be in [1, {MAX_SLOTS}], got "
                         f"{num_slots}")
    C = _check_hist_args(X, vals, F, N, num_slots, num_bins, dev)
    quant = vals.dtype == torch.int8
    new_lor = torch.empty_like(leaf_of_row)
    out, acc = _hist_buffers(num_slots, C, F, num_bins, quant, dev)
    sms, stream = _launch_env(dev)
    rc = _lib("wave_pass")(
        X.data_ptr(), vals.data_ptr(), int(quant), leaf_of_row.data_ptr(),
        table.data_ptr(), new_lor.data_ptr(), out.data_ptr(),
        acc.data_ptr() if acc is not None else None, N, F, C, num_slots,
        num_bins, num_leaves, sms, stream)
    _raise_on(rc, "wave_pass")
    LAUNCHES["wave_pass"] += 1
    return new_lor, out


def wave_relabel_cuda(X: torch.Tensor, leaf_of_row: torch.Tensor,
                      table: torch.Tensor, num_leaves: int) -> torch.Tensor:
    """Apply the wave table's splits only: new leaf_of_row [N] int32."""
    dev = _cuda_device(X)
    F, N = _check_wave_args(X, leaf_of_row, table, num_leaves, dev)
    new_lor = torch.empty_like(leaf_of_row)
    sms, stream = _launch_env(dev)
    rc = _lib("wave_relabel")(X.data_ptr(), leaf_of_row.data_ptr(),
                              table.data_ptr(), new_lor.data_ptr(), N, F,
                              num_leaves, sms, stream)
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


def wave_pass_plain(X: torch.Tensor, vals: torch.Tensor,
                    leaf_of_row: torch.Tensor, table: torch.Tensor,
                    num_slots: int, num_bins: int,
                    num_leaves: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of wave_pass_cuda (`num_leaves` bounds the
    leaf ids for the kernel's lookup table; the plain version compares
    every row against every entry instead)."""
    t = table.to(torch.int64)
    new = _relabel_plain(X, leaf_of_row, t)
    K = num_slots
    cand = _pack_entries(t, 8, t[14] & 1)[:K]
    kc = _entry_of(new, t[7, :K])
    p = cand[kc.clamp(min=0)]
    in_small = (kc >= 0) & (_go_left(p, X) == (((p >> 23) & 1) == 1))
    slot = torch.where(in_small, kc, -1).to(torch.int32)
    hist = build_histogram_slots_plain(X, vals, slot, K, num_bins)
    return new.to(torch.int32), hist


def wave_relabel_plain(X: torch.Tensor, leaf_of_row: torch.Tensor,
                       table: torch.Tensor, num_leaves: int) -> torch.Tensor:
    """Plain PyTorch version of wave_relabel_cuda."""
    return _relabel_plain(X, leaf_of_row,
                          table.to(torch.int64)).to(torch.int32)
