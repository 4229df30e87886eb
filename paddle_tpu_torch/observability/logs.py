"""The port's logger entry point (the counterpart of
``paddle_tpu/observability/logs.py``).

``get_logger`` namespaces a logger under ``paddle_tpu_torch``.  Importing
this module configures nothing (no handler, no level, no file): the
application owns the logging tree.  ``PT_LOG_LEVEL`` is applied on the
first ``get_logger`` call, and a handler is added only when no logger
above would show the records.
"""
from __future__ import annotations

import logging
import os

__all__ = ["get_logger", "ROOT_LOGGER_NAME"]

ROOT_LOGGER_NAME = "paddle_tpu_torch"

_level_applied = False


def _apply_env_level():
    global _level_applied
    if _level_applied:
        return
    _level_applied = True
    level = os.environ.get("PT_LOG_LEVEL", "").strip().upper()
    if not level:
        return
    root = logging.getLogger(ROOT_LOGGER_NAME)
    try:
        root.setLevel(level)
    except ValueError:
        return
    if not root.handlers and not logging.getLogger().handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        root.addHandler(h)


def get_logger(name: str | None = None) -> logging.Logger:
    """A logger under the ``paddle_tpu_torch`` namespace: ``name`` a
    module's ``__name__`` (kept when it is already under the namespace)
    or a suffix."""
    _apply_env_level()
    if not name:
        return logging.getLogger(ROOT_LOGGER_NAME)
    if name == ROOT_LOGGER_NAME or name.startswith(ROOT_LOGGER_NAME + "."):
        return logging.getLogger(name)
    return logging.getLogger(ROOT_LOGGER_NAME + "." + name)
