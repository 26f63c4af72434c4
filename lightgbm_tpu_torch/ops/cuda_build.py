"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with ``ctypes``; pointers travel as
``c_void_p``, floats as ``c_float``, and every entry point launches on
the stream it is given and returns ``cudaGetLastError()``.  Libraries
land in
``lightgbm_tpu_torch/_build/`` under a name that carries a hash of the
sources and flags, so an edited source rebuilds at its next use.
:func:`build_all` starts one ``nvcc`` per source at once.

Nothing here runs at import: the first wrapper that launches a kernel
builds what it needs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# one library per kernel source; the value lists its C entry points as
# (name, argtypes) with pointers and the stream as c_void_p
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
LIBRARIES = {
    "route": {
        "lgbm_route_plan": [_I, _I, _I, _P],
        "lgbm_route_rows": [_P, _LL, _P, _P, _P, _I, _P, _I, _P, _I, _I,
                            _P],
        "lgbm_route_rows_values": [_P, _LL, _P, _P, _P, _I, _P, _I, _P, _P,
                                   _P, _I, _I, _P],
        "lgbm_route_rows_i32": [_P, _LL, _P, _P, _P, _I, _P, _I, _P, _I, _I,
                                _P],
        "lgbm_route_rows_values_i32": [_P, _LL, _P, _P, _P, _I, _P, _I, _P,
                                       _P, _P, _I, _I, _P],
    },
    "hist_route": {
        "lgbm_hist_route": [_P, _LL, _I, _P, _I, _P, _P, _P, _I, _P, _I,
                            _P, _P, _I, _I, _I, _I, _I, _LL, _P, _P, _P],
    },
    "hist_compact": {
        "lgbm_hist_compact": [_P, _LL, _I, _P, _I, _P, _I, _P, _P, _I, _I,
                              _I, _I, _I, _LL, _P, _P, _P],
    },
    "hist_active": {
        "lgbm_hist_active": [_P, _LL, _I, _P, _I, _P, _I, _P, _P, _I, _I,
                             _I, _I, _I, _LL, _P, _P, _P],
    },
    "hist_float": {
        "lgbm_hist_float_partial": [_P, _LL, _I, _P, _I, _P, _I, _P, _I, _I,
                                    _I, _I, _I, _P, _P, _P],
        "lgbm_hist_float_fold": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
        "lgbm_hist_float": [_P, _LL, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I,
                            _I, _I, _P, _P, _P, _P],
    },
    "hist_route_float": {
        "lgbm_hist_route_float": [_P, _LL, _LL, _I, _P, _I, _P, _P, _P, _I,
                                  _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _P, _P, _P, _P],
    },
    "hist_compact_float": {
        "lgbm_hist_compact_float": [_P, _LL, _LL, _I, _P, _I, _P, _I, _P,
                                    _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                                    _P, _P, _P, _P, _P],
    },
    "hist_wide": {
        "lgbm_hist_wide": [_P, _I, _LL, _LL, _I, _P, _P, _P, _P, _I, _I, _I,
                           _P, _P, _P],
        "lgbm_hist_wide_seeded": [_P, _I, _LL, _LL, _I, _P, _P, _P, _P, _I,
                                  _I, _I, _P, _P, _P],
        "lgbm_hist_wide_scratch": [_LL, _I, _I, _I],
    },
    "split": {
        "lgbm_split_scan": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _F,
                            _F, _F, _F, _I, _P, _I, _P],
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "lightgbm_tpu_torch build only where the CUDA "
                           "toolkit is installed")
    return found


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def compile_event(kind: str, name: str) -> None:
    """A build or load into the trace contract's trackers
    (``obs/trace_contract.py``)."""
    from ..obs.trace_contract import compile_event as event
    event(kind, name)


def build_all(names: List[str] = None) -> float:
    """Compile every (or the named) library that is not built yet, one
    ``nvcc`` process per source, all started together.  -> seconds."""
    t0 = time.time()
    names = list(LIBRARIES) if names is None else list(names)
    todo = [(n, _library_path(n)) for n in names]
    todo = [(n, p) for n, p in todo if not p.exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name, path in todo:
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for name, path, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}.cu:\n{out.decode(errors='replace')}")
            continue
        os.replace(tmp, path)
        compile_event("nvcc", name)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return time.time() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed)."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = _library_path(name)
    if not path.exists():
        build_all([name])
    lib = ctypes.CDLL(str(path))
    compile_event("load", name)
    for fn, argtypes in LIBRARIES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _loaded[name] = lib
    return lib


def check_launch(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {code}")


def multiprocessor_count(device) -> int:
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count
