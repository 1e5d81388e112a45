"""``repro``-namespaced logging so library code never calls ``print``.

Everything under the ``repro`` logger hierarchy goes to stdout with a
message-only format by default (so converted call sites look exactly
like the prints they replace), at level ``REPRO_LOG_LEVEL`` (default
``INFO``). Applications that want timestamps/routing can attach their
own handlers to the ``repro`` logger and the defaults step aside.
"""
from __future__ import annotations

import logging
import os
import sys

__all__ = ["get_logger", "setup"]

_CONFIGURED = False


def setup(level: str | int | None = None, stream=None) -> logging.Logger:
    """Idempotently configure the ``repro`` root logger.

    A plain ``StreamHandler(sys.stdout)`` with a ``%(message)s`` format
    keeps example stdout byte-identical to the old prints; the level
    comes from ``REPRO_LOG_LEVEL`` unless given explicitly.
    """
    global _CONFIGURED
    root = logging.getLogger("repro")
    if not _CONFIGURED:
        if not root.handlers:
            handler = logging.StreamHandler(stream or sys.stdout)
            handler.setFormatter(logging.Formatter("%(message)s"))
            root.addHandler(handler)
        root.propagate = False
        _CONFIGURED = True
    if level is None:
        level = os.environ.get("REPRO_LOG_LEVEL", "INFO")
    if isinstance(level, str):
        level = level.upper()
    root.setLevel(level)
    return root


def get_logger(name: str = "") -> logging.Logger:
    """A logger under the configured ``repro`` namespace."""
    setup()
    if not name:
        return logging.getLogger("repro")
    if name == "repro" or name.startswith("repro."):
        return logging.getLogger(name)
    return logging.getLogger(f"repro.{name}")
