"""Structured, rate-limited logging for the serving layer (port of
``repro.obs.log``).

One logger tree rooted at ``repro_torch.obs``.  Data outputs (JSON lines,
artifacts) stay on stdout / in files — this logger is for *status*:
progress, warnings, error context.

Level comes from ``REPRO_LOG`` (``debug`` / ``info`` / ``warning`` /
``error``; default ``info``).  A token-bucket filter rate-limits repeated
messages per (template, level) key so a hot loop that logs every iteration
cannot flood the console: after ``burst`` records inside ``interval``
seconds, further repeats are dropped and a one-line suppression notice is
emitted when the window reopens.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Dict, Tuple

_ROOT = "repro_torch.obs"
_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


class RateLimitFilter(logging.Filter):
    """Allow at most ``burst`` records per (msg-template, level) key per
    ``interval`` seconds; repeats inside the window are dropped and counted,
    and the count is prepended to the first record after the window."""

    def __init__(self, interval: float = 1.0, burst: int = 20):
        super().__init__()
        self.interval = interval
        self.burst = burst
        self._state: Dict[Tuple[str, int], list] = {}  # key -> [t0, n, dropped]

    def filter(self, record: logging.LogRecord) -> bool:
        key = (record.msg if isinstance(record.msg, str) else str(record.msg),
               record.levelno)
        now = time.monotonic()
        st = self._state.get(key)
        if st is None or now - st[0] >= self.interval:
            if st is not None and st[2]:
                record.msg = f"[{st[2]} similar suppressed] {record.msg}"
            self._state[key] = [now, 1, 0]
            return True
        if st[1] < self.burst:
            st[1] += 1
            return True
        st[2] += 1
        return False


def _level_from_env() -> int:
    name = os.environ.get("REPRO_LOG", "info").strip().upper()
    return getattr(logging, name, logging.INFO)


_configured = False


def configure(level: int | None = None, interval: float = 1.0,
              burst: int = 20) -> logging.Logger:
    """(Re)configure the ``repro_torch.obs`` root logger.  Idempotent under the
    default call; explicit ``level`` overrides ``REPRO_LOG``."""
    global _configured
    root = logging.getLogger(_ROOT)
    if not _configured:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        handler.addFilter(RateLimitFilter(interval=interval, burst=burst))
        root.addHandler(handler)
        root.propagate = False
        _configured = True
    root.setLevel(level if level is not None else _level_from_env())
    return root


def get_logger(name: str = "") -> logging.Logger:
    """The shared structured logger (``repro_torch.obs`` or a child of it)."""
    configure()
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)
