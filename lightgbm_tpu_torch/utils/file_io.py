"""File IO of the shard store, model files and snapshots (copied from
the JAX package's ``utils/file_io.py``).

* :func:`open_read` / :func:`open_write` / :func:`exists` — local paths,
  or a scheme registered with :func:`register_scheme`.
* :func:`atomic_write` — the payload lands in ``path + ".tmp"``, is
  flushed and fsynced, and is published with one ``os.replace``:
  readers never see a half-written file under the final name.  With
  ``chunks > 1`` the ``snapshot.write`` fault point sits between the
  chunks, so a test can tear a write mid-file.
* :func:`localize` / :func:`release` — a real OS path for a source:
  identity for local files; a scheme registered with
  :func:`register_scheme` (``hdfs://``, ``gs://``, ...) is copied to a
  temporary file, which :func:`release` (or the interpreter's exit)
  deletes.
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from typing import Callable, Dict, List, Optional

# scheme prefix -> opener(path, mode) -> file-like
_OPENERS: Dict[str, Callable] = {}
_TEMPS: List[str] = []


@atexit.register
def _cleanup_temps() -> None:
    for t in _TEMPS:
        try:
            os.unlink(t)
        except OSError:
            pass


def register_scheme(prefix: str, opener: Callable) -> None:
    """Register ``opener(path, mode)`` for paths starting with ``prefix``."""
    _OPENERS[prefix] = opener


def _find_opener(path: str) -> Optional[Callable]:
    for prefix, opener in _OPENERS.items():
        if path.startswith(prefix):
            return opener
    if "://" in path and "/" not in path.split("://", 1)[0]:
        scheme = path.split("://", 1)[0]
        raise ValueError(
            f"no opener registered for scheme {scheme!r} (register one "
            f"with lightgbm_tpu_torch.utils.file_io.register_scheme)")
    return None


def open_read(path: str, binary: bool = False):
    opener = _find_opener(path)
    mode = "rb" if binary else "r"
    if opener is not None:
        return opener(path, mode)
    return open(path, mode)


def open_write(path: str, binary: bool = False):
    opener = _find_opener(path)
    mode = "wb" if binary else "w"
    if opener is not None:
        return opener(path, mode)
    return open(path, mode)


def exists(path: str) -> bool:
    opener = _find_opener(path)
    if opener is not None:
        try:
            with opener(path, "rb"):
                return True
        except OSError:
            return False
    return os.path.exists(path)


def release(path: str) -> None:
    """Delete a temporary copy made by :func:`localize` (no-op for paths
    it does not own)."""
    if path in _TEMPS:
        _TEMPS.remove(path)
        try:
            os.unlink(path)
        except OSError:
            pass


def atomic_write(path: str, payload, binary: bool = False,
                 chunks: int = 1) -> None:
    """Crash-safe local write: ``path + ".tmp"``, fsync, ``os.replace``.

    ``chunks > 1`` writes exactly that many slices with a
    ``snapshot.write`` fault point between two slices (``chunks - 1``
    calls a write, whatever the payload's length): an injected fault
    leaves the torn bytes in the ``.tmp`` file and never touches the
    published name.  A registered remote scheme has no rename and gets
    a plain streamed write."""
    from .faults import fault_point
    opener = _find_opener(path)
    if opener is not None:
        with opener(path, "wb" if binary else "w") as f:
            f.write(payload)
        return
    tmp = path + ".tmp"
    with open(tmp, "wb" if binary else "w") as f:
        bounds = [len(payload) * i // max(chunks, 1)
                  for i in range(max(chunks, 1) + 1)]
        for i in range(len(bounds) - 1):
            if i:
                f.flush()
                fault_point("snapshot.write")
            f.write(payload[bounds[i]:bounds[i + 1]])
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def localize(path: str) -> str:
    """A real OS path for ``path``: identity for local files, a temporary
    copy for a registered remote scheme."""
    opener = _find_opener(path)
    if opener is None:
        return path
    suffix = os.path.splitext(path)[1]
    fd, tmp = tempfile.mkstemp(suffix=suffix)
    _TEMPS.append(tmp)
    with os.fdopen(fd, "wb") as dst, opener(path, "rb") as src:
        shutil.copyfileobj(src, dst)
    return tmp
