"""Structured, level-gated logger for the port.

One shared ``logging`` logger (``"repro_torch"``): messages are an event
name plus ``key=value`` fields, as the reference's ``repro.obs.log``
writes them.

Level resolution (first match wins):
  * ``REPRO_LOG_LEVEL`` env var (``DEBUG``/``INFO``/``WARNING``/...),
  * quiet (``WARNING``) under pytest (``PYTEST_CURRENT_TEST`` or
    ``PYTEST_VERSION`` in the environment),
  * ``INFO`` otherwise.

Usage::

    from repro_torch.obs import log
    log.info("train_eval", step=120, loss=2.31)
    # stderr: [repro_torch I] train_eval step=120 loss=2.31
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Any

_LOGGER_NAME = "repro_torch"
_configured = False


def _default_level() -> int:
    env = os.environ.get("REPRO_LOG_LEVEL", "").upper()
    if env:
        return getattr(logging, env, logging.INFO)
    if "PYTEST_CURRENT_TEST" in os.environ or "PYTEST_VERSION" in os.environ:
        return logging.WARNING
    return logging.INFO


def get_logger() -> logging.Logger:
    """The process-wide ``repro_torch`` logger, configured on first use."""
    global _configured
    logger = logging.getLogger(_LOGGER_NAME)
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("[%(name)s %(levelname).1s] %(message)s"))
        logger.addHandler(handler)
        logger.propagate = False
        logger.setLevel(_default_level())
        _configured = True
    return logger


def set_level(level) -> None:
    """Override the log level (``logging`` ints or name strings)."""
    if isinstance(level, str):
        level = getattr(logging, level.upper())
    get_logger().setLevel(level)


def enabled(level: int) -> bool:
    return get_logger().isEnabledFor(level)


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    s = str(v)
    return repr(s) if " " in s else s


def _emit(level: int, event: str, fields: dict) -> None:
    logger = get_logger()
    if not logger.isEnabledFor(level):
        return
    logger.log(level, event + "".join(f" {k}={_fmt(v)}"
                                      for k, v in fields.items()))


def debug(event: str, **fields) -> None:
    _emit(logging.DEBUG, event, fields)


def info(event: str, **fields) -> None:
    _emit(logging.INFO, event, fields)


def warning(event: str, **fields) -> None:
    _emit(logging.WARNING, event, fields)
