"""Native (C++) host components, built on demand with the system
toolchain and loaded through ctypes (no pybind11 dependency).

Counterpart of lightgbm_tpu/native/. The reference keeps its ingestion
stack in C++ because text parsing is the CPU-bound half of training
start-up (src/io/dataset_loader.cpp, src/io/parser.cpp + vendored
fast_double_parser). `loader.cpp` carries the same hot loops: an OpenMP
two-pass CSV/TSV parser and a batch value->bin binary search. They run on
the host; no device kernel is involved.

The library is compiled with ``g++`` at first use into
``lightgbm_tpu_torch/_build/``, never beside its source, under a name
that carries the source's hash (an edit rebuilds), through a
process-unique temporary file and ``os.replace`` (a concurrent process
never loads a truncated library). Everything falls back to the Python
implementations when no compiler is available, and
LIGHTGBM_TPU_DISABLE_NATIVE=1 forces the fallback. `LAST_PARSER` names
the parser the last `load_text_file` ran ("native" or "python").
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_SRC = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

# which parser the last load_text_file ran: "native" or "python"
LAST_PARSER: Optional[str] = None


def _library_path() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lgbt_native-{tag}.so"


def _build(so: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", "-O3", "-fopenmp", "-shared", "-fPIC", "-o", str(tmp),
           str(_SRC)]
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=120)
        if r.returncode != 0:
            return False
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def get_lib():
    """The loaded native library, or None (disabled / no toolchain). The
    switch is read on every call, so a process may turn the fallback on
    and off."""
    global _LIB, _TRIED
    if os.environ.get("LIGHTGBM_TPU_DISABLE_NATIVE", "").lower() in (
            "1", "true", "yes"):
        return None
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        so = _library_path()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.lgbtpu_scan.restype = ctypes.c_int
        lib.lgbtpu_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_void_p, ctypes.c_int64]
        lib.lgbtpu_line_starts.restype = ctypes.c_int64
        lib.lgbtpu_line_starts.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64]
        lib.lgbtpu_parse.restype = ctypes.c_int
        lib.lgbtpu_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p]
        lib.lgbtpu_value_to_bin.restype = None
        lib.lgbtpu_value_to_bin.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_void_p]
        _LIB = lib
        return _LIB


def parse_text(data: bytes, sep: str) -> Optional[np.ndarray]:
    """Parse separated numeric text -> [rows, cols] f64 (NaN for missing
    fields). Returns None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(data)
    nr = ctypes.c_int64()
    nc = ctypes.c_int64()
    # upper-bound the line count from the newline count so the offsets
    # fill in the same serial pass as the row/column scan
    cap = data.count(b"\n") + 1
    starts = np.zeros(max(cap, 1), np.int64)
    lib.lgbtpu_scan(data, n, sep.encode()[0], ctypes.byref(nr),
                    ctypes.byref(nc), starts.ctypes.data, cap)
    rows, cols = nr.value, nc.value
    if rows == 0:
        return np.zeros((0, 0))
    out = np.empty((rows, cols), np.float64)
    lib.lgbtpu_parse(data, n, sep.encode()[0], starts.ctypes.data,
                     rows, cols, out.ctypes.data)
    return out


def value_to_bin(values: np.ndarray, uppers: np.ndarray,
                 nan_bin: int) -> Optional[np.ndarray]:
    """[n] uint8 bins of f64 `values` against sorted upper bounds (the
    first bound >= the value, capped at the last), NaN to `nan_bin`;
    None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    vals = np.ascontiguousarray(values, np.float64)
    ub = np.ascontiguousarray(uppers, np.float64)
    out = np.empty(len(vals), np.uint8)
    lib.lgbtpu_value_to_bin(vals.ctypes.data, len(vals), ub.ctypes.data,
                            len(ub), int(nan_bin), 0, 0, out.ctypes.data)
    return out
