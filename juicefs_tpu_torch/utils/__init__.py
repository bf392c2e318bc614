"""Cross-cutting utilities (a copy of juicefs_tpu/utils: the logger). The
txn rerun harness and the lock watchdog are the `txnwatch` and `lockwatch`
submodules; importing them installs neither."""

from __future__ import annotations

import logging
import os
import threading

_LOG_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"
_configured = False
_lock = threading.Lock()


def get_logger(name: str = "juicefs") -> logging.Logger:
    """Process-wide logger (reference pkg/utils/logger.go)."""
    global _configured
    with _lock:
        if not _configured:
            level = os.environ.get("JFS_LOG_LEVEL", "WARNING").upper()
            logging.basicConfig(format=_LOG_FORMAT, level=level)
            _configured = True
    return logging.getLogger(name)
