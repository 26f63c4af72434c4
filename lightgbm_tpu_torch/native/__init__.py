"""The native text parser and TreeSHAP (``parser.cpp``, C++ through
ctypes; a copy of the JAX package's ``native/``).

``parser.cpp`` is compiled at first use with ``g++ -O3 -shared -fPIC``
(and ``-fopenmp`` where that links) into ``lightgbm_tpu_torch/_build/``,
through a temporary file and an atomic rename, so concurrent processes
never load a half-written library; a library older than its source is
built again.  Where no library can be built every entry point returns
``None`` and the loader takes its numpy path, after one warning.

Entry points: :func:`parse_delimited` (a whole CSV/TSV file),
:func:`parse_delimited_chunks` (bounded chunks), :func:`scan_libsvm`
(rows and columns of a libsvm file), :func:`parse_libsvm_chunks`,
:func:`parse_libsvm` (a whole libsvm file) and :func:`treeshap_patterns`
(the exact TreeSHAP recursion of ``boosting/contrib.py``).  Every buffer the library
allocates is copied into numpy and released with ``ltpu_free``.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..utils.log import log_warning

SRC = Path(__file__).resolve().parent / "parser.cpp"
LIB = SRC.parent.parent / "_build" / "ltpu_parser.so"

_lib: Optional[ctypes.CDLL] = None
_tried = False

_D = ctypes.c_double
_PD = ctypes.POINTER(_D)
_PPD = ctypes.POINTER(_PD)
_PI = ctypes.POINTER(ctypes.c_int)
_L, _LL = ctypes.c_long, ctypes.c_longlong
_SIGNATURES = {
    "ltpu_parse_delimited": (_L, [ctypes.c_char_p, ctypes.c_char, _L, _PPD,
                                  ctypes.POINTER(_L)]),
    "ltpu_parse_libsvm": (_L, [ctypes.c_char_p, _L, _PPD,
                               ctypes.POINTER(_L), _PPD]),
    "ltpu_parse_delimited_chunk": (_L, [ctypes.c_char_p, ctypes.c_char, _LL,
                                        _L, _L, _L, _PPD, ctypes.POINTER(_L),
                                        ctypes.POINTER(_LL)]),
    "ltpu_scan_libsvm": (_L, [ctypes.c_char_p, _L, ctypes.POINTER(_L)]),
    "ltpu_parse_libsvm_chunk": (_L, [ctypes.c_char_p, _LL, _L, _L, _L, _PPD,
                                     ctypes.POINTER(_LL)]),
    "ltpu_treeshap": (_L, [_L, _L, _L, _L, ctypes.POINTER(ctypes.c_uint8),
                           _PI, _PI, _PI, _PD, _PD, _PD, _PD]),
    "ltpu_free": (None, [_PD]),
}


def _build() -> None:
    """Compile ``SRC`` into ``LIB`` through a private temporary file and
    an atomic rename; without OpenMP when ``-fopenmp`` does not link or
    load."""
    LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = f"{LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-fopenmp", "-o", tmp,
           str(SRC)]
    try:
        subprocess.check_call(cmd, stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL)
        ctypes.CDLL(tmp)
    except (subprocess.CalledProcessError, OSError):
        cmd.remove("-fopenmp")
        subprocess.check_call(cmd, stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL)
    os.replace(tmp, LIB)
    from ..obs.trace_contract import compile_event
    compile_event("native", LIB.name)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        lib = None
        if LIB.exists() and LIB.stat().st_mtime >= SRC.stat().st_mtime:
            try:
                lib = ctypes.CDLL(str(LIB))
            except OSError:
                lib = None              # a foreign library: build again
        if lib is None:
            _build()
            lib = ctypes.CDLL(str(LIB))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
    except (OSError, subprocess.CalledProcessError, AttributeError) as exc:
        log_warning(f"the native parser could not be built or loaded "
                    f"({exc}); text files are parsed with numpy")
        _lib = None
    return _lib


def available() -> bool:
    """Whether the native library is built and loaded."""
    return _load() is not None


def _take(lib, ptr, shape) -> np.ndarray:
    """Copy a buffer the library allocated into numpy, then free it."""
    n = int(np.prod(shape)) if shape else 0
    arr = np.ctypeslib.as_array(ptr, shape=(max(n, 1),))[:n].copy()
    lib.ltpu_free(ptr)
    return arr.reshape(shape)


def parse_delimited(path: str, delim: str, skip: int) -> Optional[np.ndarray]:
    """A whole delimited file -> ``[rows, cols]`` float64 (a missing field
    is NaN), or None when the library is unavailable or the parse
    fails."""
    lib = _load()
    if lib is None:
        return None
    data = _PD()
    cols = _L()
    rows = lib.ltpu_parse_delimited(path.encode(), delim.encode(), skip,
                                    ctypes.byref(data), ctypes.byref(cols))
    if rows < 0:
        return None
    if rows == 0 or cols.value == 0:
        return np.zeros((0, max(cols.value, 0)), np.float64)
    return _take(lib, data, (int(rows), int(cols.value)))


def parse_delimited_chunks(path: str, delim: str, skip: int,
                           chunk_bytes: int = 8 << 20):
    """Bounded-memory ``[rows, cols]`` float64 chunks of a delimited file
    (reference ``pipeline_reader.h:26+``); a row longer than a chunk
    grows the chunk.  Yields nothing when the library is unavailable:
    check :func:`available` first."""
    lib = _load()
    if lib is None:
        return
    offset = 0
    expect_cols = -1
    size = os.path.getsize(path)
    while offset < size:
        data = _PD()
        cols = _L()
        nxt = _LL()
        rows = lib.ltpu_parse_delimited_chunk(
            path.encode(), delim.encode(), offset, skip, chunk_bytes,
            expect_cols, ctypes.byref(data), ctypes.byref(cols),
            ctypes.byref(nxt))
        if rows == -4:
            chunk_bytes *= 4
            continue
        if rows < 0:
            raise ValueError(
                f"native chunked parse failed on {path!r} (code {rows})")
        if rows > 0:
            expect_cols = int(cols.value)
            yield _take(lib, data, (int(rows), expect_cols))
        if int(nxt.value) <= offset:
            break
        offset = int(nxt.value)


def scan_libsvm(path: str, skip: int) -> Optional[Tuple[int, int]]:
    """A bounded-memory libsvm scan -> ``(data rows, feature columns)``,
    or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    max_idx = _L()
    rows = lib.ltpu_scan_libsvm(path.encode(), skip, ctypes.byref(max_idx))
    if rows < 0:
        return None
    return int(rows), int(max_idx.value) + 1


def parse_libsvm_chunks(path: str, skip: int, cols: int,
                        chunk_bytes: int = 8 << 20):
    """Bounded-memory ``[rows, 1 + cols]`` float64 chunks of a libsvm
    file, the label in column 0 (the libsvm twin of
    :func:`parse_delimited_chunks`)."""
    lib = _load()
    if lib is None:
        return
    offset = 0
    size = os.path.getsize(path)
    while offset < size:
        data = _PD()
        nxt = _LL()
        rows = lib.ltpu_parse_libsvm_chunk(
            path.encode(), offset, skip, chunk_bytes, cols,
            ctypes.byref(data), ctypes.byref(nxt))
        if rows == -4:
            chunk_bytes *= 4
            continue
        if rows < 0:
            raise ValueError(
                f"native chunked libsvm parse failed on {path!r} "
                f"(code {rows})")
        if rows > 0:
            yield _take(lib, data, (int(rows), cols + 1))
        if int(nxt.value) <= offset:
            break
        offset = int(nxt.value)


def parse_libsvm(path: str, skip: int
                 ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """A whole libsvm file -> ``(X [rows, max index + 1] float64, labels
    [rows] float32)``, or None."""
    lib = _load()
    if lib is None:
        return None
    X = _PD()
    y = _PD()
    cols = _L()
    rows = lib.ltpu_parse_libsvm(path.encode(), skip, ctypes.byref(X),
                                 ctypes.byref(cols), ctypes.byref(y))
    if rows < 0:
        return None
    Xa = _take(lib, X, (int(rows), int(cols.value)))
    ya = _take(lib, y, (int(rows),)).astype(np.float32)
    return Xa, ya


def treeshap_patterns(D: np.ndarray, split_feature: np.ndarray,
                      left_child: np.ndarray, right_child: np.ndarray,
                      leaf_value: np.ndarray, internal_count: np.ndarray,
                      leaf_count: np.ndarray,
                      num_features: int) -> Optional[np.ndarray]:
    """Exact TreeSHAP phis of ``P`` decision patterns of one tree
    (``D``: ``[P, m]`` go-left decisions of its ``m`` internal nodes) ->
    ``[P, F + 1]`` float64, or None when the library is unavailable or
    the call fails.  The recursion of ``boosting/contrib.py``, in C++
    with the patterns spread over OpenMP threads: the Python recursion
    costs about a millisecond a (pattern, tree)."""
    lib = _load()
    if lib is None:
        return None
    P, m = D.shape
    Du = np.ascontiguousarray(D, np.uint8)
    ints = [np.ascontiguousarray(a, np.int32)
            for a in (split_feature, left_child, right_child)]
    lv, ic, lc = (np.ascontiguousarray(a, np.float64)
                  for a in (leaf_value, internal_count, leaf_count))
    phi = np.zeros((P, num_features + 1), np.float64)
    code = lib.ltpu_treeshap(
        P, m, len(lv), num_features,
        Du.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        *(a.ctypes.data_as(_PI) for a in ints),
        *(a.ctypes.data_as(_PD) for a in (lv, ic, lc, phi)))
    return phi if code == 0 else None
