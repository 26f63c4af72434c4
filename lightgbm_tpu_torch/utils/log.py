"""Logging (reference: include/LightGBM/utils/log.h).

The reference has a static ``Log`` class with Fatal/Warning/Info levels
plus CHECK macros.  Here they route through the stdlib logging module
under the ``lightgbm_tpu_torch`` logger.  ``log_once(key, msg)``
dedupes a warning that a hot path can raise again and again to one line
per process and key.
"""
from __future__ import annotations

import logging
from typing import Set

_logger = logging.getLogger("lightgbm_tpu_torch")
if not _logger.handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(
        logging.Formatter("[LightGBM-Torch] [%(levelname)s] %(message)s"))
    _logger.addHandler(_handler)
    _logger.setLevel(logging.INFO)


def _named_lock(name: str):
    # lazy: lock_contract imports only the stdlib, so even this
    # bottom-of-the-graph module can take a contract-named lock
    from ..obs.lock_contract import named_lock
    return named_lock(name)


_once_lock = _named_lock("log_once")
_once_seen: Set[str] = set()


def log_fatal(msg: str) -> None:
    _logger.critical(msg)
    raise RuntimeError(msg)


def log_warning(msg: str) -> None:
    _logger.warning(msg)


def log_info(msg: str) -> None:
    _logger.info(msg)


def log_debug(msg: str) -> None:
    _logger.debug(msg)


def set_verbosity(verbose: int) -> None:
    """The reference's ``verbose``: < 0 fatal only, 0 warnings, 1 info,
    > 1 debug (the command-line application sets it from its
    configuration)."""
    if verbose < 0:
        _logger.setLevel(logging.CRITICAL)
    elif verbose == 0:
        _logger.setLevel(logging.WARNING)
    elif verbose == 1:
        _logger.setLevel(logging.INFO)
    else:
        _logger.setLevel(logging.DEBUG)


def log_once(key: str, msg: str, level: str = "warning") -> bool:
    """Log ``msg`` at ``level`` the first time ``key`` is seen in this
    process; later calls with the same key are dropped.  -> whether the
    line was written."""
    with _once_lock:
        if key in _once_seen:
            return False
        _once_seen.add(key)
    {"warning": log_warning, "info": log_info,
     "debug": log_debug}.get(level, log_warning)(msg)
    return True


def reset_log_once() -> None:
    """Forget the dedupe state (tests)."""
    with _once_lock:
        _once_seen.clear()


def check(cond: bool, msg: str = "") -> None:
    """CHECK macro equivalent (reference utils/log.h:22-34)."""
    if not cond:
        log_fatal(f"Check failed: {msg}")
