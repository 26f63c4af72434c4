"""Logging (reference: include/LightGBM/utils/log.h).

The reference has a static ``Log`` class with Fatal/Warning/Info levels
plus CHECK macros.  Here they route through the stdlib logging module
under the ``lightgbm_tpu_torch`` logger.
"""
from __future__ import annotations

import logging

_logger = logging.getLogger("lightgbm_tpu_torch")
if not _logger.handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(
        logging.Formatter("[LightGBM-Torch] [%(levelname)s] %(message)s"))
    _logger.addHandler(_handler)
    _logger.setLevel(logging.INFO)


def log_fatal(msg: str) -> None:
    _logger.critical(msg)
    raise RuntimeError(msg)


def log_warning(msg: str) -> None:
    _logger.warning(msg)


def log_info(msg: str) -> None:
    _logger.info(msg)


def check(cond: bool, msg: str = "") -> None:
    """CHECK macro equivalent (reference utils/log.h:22-34)."""
    if not cond:
        log_fatal(f"Check failed: {msg}")
