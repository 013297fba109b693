"""Launch counts of the kernel wrappers, exact across host threads.

The ingest daemon's tenant workers are threads of one process that
launch kernels at once; a bare ``+= 1`` on a module global can lose
counts there. Every wrapper counts through one ``LaunchCount``, whose
updates all take one lock.
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()


class LaunchCount:
    """One kernel's launches since the last ``reset``."""

    def __init__(self):
        self._n = 0

    def add(self) -> None:
        with _LOCK:
            self._n += 1

    def value(self) -> int:
        return self._n

    def reset(self) -> None:
        with _LOCK:
            self._n = 0
