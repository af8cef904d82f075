"""Leveled logger with a pluggable sink.

Mirrors the reference's logging surface (utility/log.{c,h}: TLOG_* macros,
UNIX syslog levels in c_api.h:104-114, `set_log_level`/`set_log_output`
c_api.h:1227-1238). Thread-safe via the logging module's own locking.
"""

from __future__ import annotations

import logging
import sys
from typing import Callable, Optional

# level constants matching c_api.h:104-114 (syslog order)
LOG_EMERG = 0
LOG_ALERT = 1
LOG_CRIT = 2
LOG_ERR = 3
LOG_WARNING = 4
LOG_NOTICE = 5
LOG_INFO = 6
LOG_DEBUG = 7

_PY_LEVELS = {
    LOG_EMERG: logging.CRITICAL,
    LOG_ALERT: logging.CRITICAL,
    LOG_CRIT: logging.CRITICAL,
    LOG_ERR: logging.ERROR,
    LOG_WARNING: logging.WARNING,
    LOG_NOTICE: logging.INFO,
    LOG_INFO: logging.INFO,
    LOG_DEBUG: logging.DEBUG,
}

logger = logging.getLogger("tengine_tpu_torch")
if not logger.handlers:
    _default = logging.StreamHandler(sys.stderr)
    _default.setFormatter(logging.Formatter("[tengine-tpu] %(levelname)s: %(message)s"))
    logger.addHandler(_default)
    logger.setLevel(logging.WARNING)


def set_log_level(level: int) -> None:
    """set_log_level analog (c_api.h:1227) — takes the syslog-style constant."""
    logger.setLevel(_PY_LEVELS.get(level, logging.WARNING))


def set_log_output(sink: Optional[Callable[[str], None]]) -> None:
    """set_log_output analog (c_api.h:1238): replace the sink with a callable
    receiving formatted lines; None restores stderr."""
    for h in list(logger.handlers):
        logger.removeHandler(h)
    if sink is None:
        h: logging.Handler = logging.StreamHandler(sys.stderr)
    else:

        class _CallableHandler(logging.Handler):
            def emit(self, record):
                sink(self.format(record))

        h = _CallableHandler()
    h.setFormatter(logging.Formatter("[tengine-tpu] %(levelname)s: %(message)s"))
    logger.addHandler(h)
