"""Text data loading: CSV / TSV / LibSVM with format autodetection.

Counterpart of lightgbm_tpu/data/loader.py, the reference parser layer
(src/io/parser.cpp Parser::CreateParser autodetection,
include/LightGBM/dataset.h:406) and the loader's label / weight / group /
ignore column handling (src/io/dataset_loader.cpp:200-320). CSV and TSV
parse through the native OpenMP parser (native/loader.cpp) when it builds,
else through the Python loop here, which gives the same arrays;
`native.LAST_PARSER` records which one ran. Parsing is host work: the
rows reach the card when a Dataset bins them.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import numpy as np

from ..utils.log import log_fatal, log_info

# leading-float matcher for the prefix-permissive fallback parser
_FLOAT_PREFIX = re.compile(
    r"^[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?")


def _detect_format(first_lines: List[str]) -> str:
    """'libsvm' | 'csv' | 'tsv' (reference: Parser::CreateParser samples the
    first lines and counts separators)."""
    for ln in first_lines:
        toks = ln.split()
        if len(toks) >= 2 and all(":" in t for t in toks[1:3] if t):
            return "libsvm"
    head = first_lines[0] if first_lines else ""
    if head.count("\t") >= head.count(","):
        return "tsv" if "\t" in head else "csv"
    return "csv"


def _parse_column_spec(spec: str, header_names: Optional[List[str]]) -> int:
    """'0' | 'name:<col>' (reference: config column specifiers)."""
    if spec.startswith("name:"):
        name = spec[5:]
        if not header_names or name not in header_names:
            log_fatal(f"Column name {name} not found in header")
        return header_names.index(name)
    return int(spec)


def load_text_file(path: str, has_header: bool = False,
                   label_column: str = "", weight_column: str = "",
                   group_column: str = "", ignore_column: str = "",
                   ) -> Tuple[np.ndarray, Optional[np.ndarray],
                              Optional[np.ndarray], Optional[np.ndarray],
                              List[str]]:
    """Returns (X, label, weight, group_sizes, feature_names)."""
    if not os.path.exists(path):
        log_fatal(f"Data file {path} does not exist")
    # sniff the format from the head of the file only; the full read
    # stays as bytes so the native parser can consume it zero-copy
    with open(path, "rb") as f:
        raw = f.read()
    if not raw.strip():
        log_fatal(f"Data file {path} is empty")

    def _pop_line(buf: bytes):
        """(first non-blank line decoded IN FULL, rest) — no 64KB
        truncation, leading blank/whitespace-only lines dropped."""
        while True:
            nl = buf.find(b"\n")
            first = buf if nl < 0 else buf[:nl]
            rest = b"" if nl < 0 else buf[nl + 1:]
            if first.strip():
                return first.decode(errors="replace").rstrip("\r"), rest
            if nl < 0:
                return "", b""
            buf = rest

    head = [ln for ln in raw[:65536].decode(errors="replace").splitlines()
            if ln.strip()]

    header_names: Optional[List[str]] = None
    fmt = _detect_format(head[1 if has_header else 0:][:3] or head[:1])
    if has_header:
        sep_h = {"csv": ",", "tsv": "\t"}.get(fmt, None)
        header_line, raw = _pop_line(raw)
        header_names = (header_line.split(sep_h) if sep_h
                        else header_line.split())

    if fmt == "libsvm":
        lines = [ln for ln in raw.decode(errors="replace").splitlines()
                 if ln.strip()]
        return _load_libsvm(lines)

    sep = "," if fmt == "csv" else "\t"
    # native OpenMP parser (native/loader.cpp, the reference's C++
    # Parser / fast_double_parser analog); falls back to the Python loop
    # without a toolchain
    from .. import native
    data = native.parse_text(raw, sep)
    native.LAST_PARSER = "python" if data is None else "native"
    if data is None:
        lines = [ln for ln in raw.decode(errors="replace").splitlines()
                 if ln.strip()]
        rows = [ln.split(sep) for ln in lines]
        ncol = max(len(r) for r in rows)
        data = np.full((len(rows), ncol), np.nan, dtype=np.float64)
        for i, r in enumerate(rows):
            for j, tok in enumerate(r):
                tok = tok.strip()
                if tok in ("", "na", "NA", "nan", "NaN", "null", "NULL",
                           "?"):
                    continue
                try:
                    data[i, j] = float(tok)
                except ValueError:
                    # prefix-parse like the native strtod path and the
                    # reference's Common::Atof ('1.5x' -> 1.5), so the
                    # same file loads identically with or without the
                    # C++ toolchain; fully unparseable -> NaN
                    m = _FLOAT_PREFIX.match(tok)
                    if m:
                        data[i, j] = float(m.group(0))
    ncol = data.shape[1]

    label_idx = _parse_column_spec(label_column, header_names) \
        if label_column else 0
    weight_idx = _parse_column_spec(weight_column, header_names) \
        if weight_column else -1
    group_idx = _parse_column_spec(group_column, header_names) \
        if group_column else -1
    ignored = set()
    if ignore_column:
        for spec in ignore_column.split(","):
            ignored.add(_parse_column_spec(spec, header_names))

    label = data[:, label_idx]
    weight = data[:, weight_idx] if weight_idx >= 0 else None
    group_sizes = None
    if group_idx >= 0:
        qid = data[:, group_idx].astype(np.int64)
        # group sizes from file-order change points (queries are contiguous)
        change = np.flatnonzero(np.diff(qid)) + 1
        bounds = np.concatenate([[0], change, [len(qid)]])
        group_sizes = np.diff(bounds)
    drop = {label_idx} | ignored
    if weight_idx >= 0:
        drop.add(weight_idx)
    if group_idx >= 0:
        drop.add(group_idx)
    feat_cols = [j for j in range(ncol) if j not in drop]
    X = data[:, feat_cols]
    names = ([header_names[j] for j in feat_cols] if header_names
             else [f"Column_{k}" for k in range(len(feat_cols))])
    log_info(f"Loaded {X.shape[0]} rows x {X.shape[1]} features from {path} "
             f"({fmt}, {native.LAST_PARSER} parser)")
    return X, label, weight, group_sizes, names


def _load_libsvm(lines: List[str]):
    """LibSVM sparse format, incl. ranking `qid:` tokens
    (reference: parser.hpp SVM parser + qid handling)."""
    labels = np.zeros(len(lines), dtype=np.float64)
    qids: List[int] = []
    entries: List[List[Tuple[int, float]]] = []
    max_idx = -1
    for i, ln in enumerate(lines):
        toks = ln.split()
        labels[i] = float(toks[0])
        row = []
        for t in toks[1:]:
            if ":" not in t:
                continue
            k, v = t.split(":", 1)
            if k == "qid":
                qids.append(int(v))
                continue
            idx = int(k)
            row.append((idx, float(v)))
            max_idx = max(max_idx, idx)
        entries.append(row)
    X = np.zeros((len(lines), max_idx + 1), dtype=np.float64)
    for i, row in enumerate(entries):
        for idx, v in row:
            X[i, idx] = v
    group_sizes = None
    if len(qids) == len(lines) and qids:
        q = np.asarray(qids)
        change = np.flatnonzero(np.diff(q)) + 1
        bounds = np.concatenate([[0], change, [len(q)]])
        group_sizes = np.diff(bounds)
    names = [f"Column_{k}" for k in range(max_idx + 1)]
    log_info(f"Loaded {X.shape[0]} rows x {X.shape[1]} features (libsvm)")
    return X, labels, None, group_sizes, names
