"""Build the port's C shim (and, on request, its R shim) at first use.

``g++`` compiles ``capi/lightgbm_tpu_torch_c.cpp`` (with ``r=True`` also
``rpkg/src/lightgbm_tpu_torch_R.cpp``) against this interpreter's
headers and ``libpython`` into ``lightgbm_tpu_torch/_build/``, under a
name that carries a hash of the sources and the command, through a
private temporary file and an atomic rename: a changed source builds a
new library, and processes that build at once never load a
half-written one.  The shim's rpath names ``libpython``'s directory, so
a host program links the shim alone (:func:`link_args`), and runs with
:func:`host_env`.

    python -m lightgbm_tpu_torch.capi.build [--r]

prints the library's path.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import sysconfig
from pathlib import Path
from typing import Dict, List

PKG = Path(__file__).resolve().parent.parent
C_SRC = PKG / "capi" / "lightgbm_tpu_torch_c.cpp"
R_SRC = PKG / "rpkg" / "src" / "lightgbm_tpu_torch_R.cpp"
HEADERS = (PKG / "capi" / "lightgbm_tpu_torch_c.h",
           PKG / "rpkg" / "src" / "r_object.h")
BUILD_DIR = PKG / "_build"


def python_link() -> List[str]:
    """The flags that link ``libpython`` of this interpreter, its
    directory in the rpath."""
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = f"python{sys.version_info.major}.{sys.version_info.minor}"
    return [f"-L{libdir}", f"-l{ver}", f"-Wl,-rpath,{libdir}"]


def build(r: bool = False) -> Path:
    """The shim library (with the R entry points when ``r``), built when
    no library of these sources exists yet."""
    sources = [C_SRC] + ([R_SRC] if r else [])
    cmd = (["g++", "-O2", "-shared", "-fPIC"] + [str(s) for s in sources]
           + [f"-I{sysconfig.get_path('include')}"] + python_link())
    h = hashlib.sha256(" ".join(cmd).encode())
    for path in sources + list(HEADERS):
        h.update(path.read_bytes())
    name = "liblightgbm_tpu_torch_R" if r else "liblightgbm_tpu_torch_c"
    lib = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    res = subprocess.run(cmd + ["-o", tmp], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ could not build {lib.name}:\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


def link_args(lib: Path) -> List[str]:
    """The flags that link a host program against ``lib``: the library,
    its directory in the rpath, and ``libpython`` (for a program that
    also calls the Python C API)."""
    return [str(lib), f"-Wl,-rpath,{lib.parent}"] + python_link()


def host_env(cpu: bool = False) -> Dict[str, str]:
    """A host program's environment: this checkout importable (by the
    shim's embedded interpreter and by ``python -m``), this
    interpreter's venv as the embedded one's home, none of the caller's
    ``LGBM_TPU_`` switches, and with ``cpu`` the CPU request for models
    loaded without a parameter string."""
    from ..capi_bridge import DEVICE_ENV
    root = str(PKG.parent)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LGBM_TPU_")}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    env["LGBM_TPU_PYPATH"] = root
    if sys.prefix != sys.base_prefix:
        env["LGBM_TPU_PYHOME"] = sys.prefix
    if cpu:
        env[DEVICE_ENV] = "cpu"
    return env


def main(argv: List[str]) -> int:
    print(build(r="--r" in argv))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
