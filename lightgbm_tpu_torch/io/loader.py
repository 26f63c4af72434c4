"""Text-file helpers of the shard store's ingest (a copy of part of the
JAX package's ``io/loader.py``): format detection, the raw row count
and the column plan (label / weight / group / ignore / categorical
columns).  File input through ``Dataset`` is not ported yet
(ROADMAP A4).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..config import Config


def detect_format(path: str, has_header: bool) -> str:
    """CSV vs TSV vs LibSVM auto-detection (reference
    ``Parser::CreateParser`` format sniffing)."""
    with open(path) as f:
        lines = []
        for _ in range(32):
            ln = f.readline()
            if not ln:
                break
            lines.append(ln.rstrip("\n"))
    if has_header and lines:
        lines = lines[1:]
    if not lines:
        return "csv"
    sample = lines[0]
    if ":" in sample.split(",")[0].split("\t")[0].split(" ")[-1] \
            and any(":" in tok for tok in sample.split()[1:2]):
        return "libsvm"
    n_tab = sample.count("\t")
    n_comma = sample.count(",")
    if any(":" in tok for tok in sample.split()[1:]):
        return "libsvm"
    if n_tab >= n_comma and n_tab > 0:
        return "tsv"
    if n_comma > 0:
        return "csv"
    if " " in sample:
        return "libsvm" if ":" in sample else "tsv"
    return "csv"


def _parse_column_spec(spec: str, header_names: Optional[List[str]]) -> int:
    """Column spec: integer index or ``name:colname``."""
    if spec.startswith("name:"):
        name = spec[5:]
        if not header_names:
            raise ValueError(f"column {spec!r} needs a header")
        return header_names.index(name)
    return int(spec)


def _parse_multi_spec(spec: str, header_names) -> List[int]:
    if not spec:
        return []
    if spec.startswith("name:"):
        names = spec[5:].split(",")
        return [header_names.index(n) for n in names]
    return [int(s) for s in spec.replace(";", ",").split(",") if s != ""]


def column_plan(ncol: int, config: Config, header_names):
    """Row-independent column bookkeeping of a delimited file: -> (label
    index, weight index, group index, kept columns, feature names,
    categorical columns among the kept ones)."""
    label_idx = (_parse_column_spec(config.label_column, header_names)
                 if config.label_column else 0)
    drop = {label_idx}
    weight_idx = query_idx = None
    if config.weight_column:
        weight_idx = _parse_column_spec(config.weight_column, header_names)
        drop.add(weight_idx)
    if config.group_column:
        query_idx = _parse_column_spec(config.group_column, header_names)
        drop.add(query_idx)
    for ig in _parse_multi_spec(config.ignore_column, header_names):
        drop.add(ig)
    keep = [i for i in range(ncol) if i not in drop]
    if header_names:
        names = [header_names[i] for i in keep]
    else:
        names = [f"Column_{i}" for i in range(len(keep))]
    cat_cols = []
    if config.categorical_column:
        cat_orig = _parse_multi_spec(config.categorical_column, header_names)
        remap = {orig: j for j, orig in enumerate(keep)}
        cat_cols = [remap[c] for c in cat_orig if c in remap]
    return label_idx, weight_idx, query_idx, keep, names, cat_cols


def raw_data_row_count(path: str, skip: int) -> int:
    """Data row count by a raw byte scan (no parsing; bounded reads).
    Blank lines are not rows: the chunk parser skips them, and the
    ingest's global sample indices need every file's exact count before
    any file is parsed."""
    n = 0
    pending = False      # the current line has non-whitespace content
    with open(path, "rb") as f:
        while True:
            chunk = f.read(4 << 20)
            if not chunk:
                break
            filtered = chunk.translate(None, delete=b"\r \t")
            arr = np.frombuffer(filtered, np.uint8)
            nls = np.flatnonzero(arr == 10)
            if len(nls):
                gaps = np.diff(np.concatenate([[-1], nls])) > 1
                if nls[0] == 0 and pending:
                    gaps[0] = True   # a line continued from the prior chunk
                n += int(gaps.sum())
                pending = bool(len(arr) - 1 - nls[-1] > 0)
            else:
                pending = pending or len(arr) > 0
    if pending:
        n += 1                      # an unterminated final line
    return n - skip
