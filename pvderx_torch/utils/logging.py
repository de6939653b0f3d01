"""Logging utilities: per-instance named loggers with verbosity levels (the
counterpart of `pvderx/utils/logging.py`).

Host-side logging for object construction, config loading and results; the
per-step numbers come back from the batched functions as tensors instead.
"""
from __future__ import annotations

import logging
import sys

_ROOT = "pvderx_torch"

VERBOSITY = {
    "DEBUG": logging.DEBUG,
    "INFO": logging.INFO,
    "WARNING": logging.WARNING,
    "ERROR": logging.ERROR,
}


def get_logger(name: str | None = None, instance: str | None = None,
               verbosity: str = "INFO") -> logging.Logger:
    """A namespaced logger, e.g. get_logger('env', 'PV_DER-1') logs as
    ``pvderx_torch.env.PV_DER-1``. Handlers attach once, at the package
    root."""
    full = _ROOT if name is None else f"{_ROOT}.{name}"
    if instance:
        full = f"{full}.{instance}"
    logger = logging.getLogger(full)
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s: %(message)s", "%H:%M:%S"))
        root.addHandler(h)
        root.setLevel(VERBOSITY[verbosity])
    return logger


def set_verbosity(level: str):
    """Set the package-wide log level ('DEBUG'|'INFO'|'WARNING'|'ERROR')."""
    logging.getLogger(_ROOT).setLevel(VERBOSITY[level.upper()])
