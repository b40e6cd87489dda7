"""Main-thread-only signal installation shared by the pod launcher and the
training workers.

CPython delivers signals to the main thread only, and ``signal.signal``
raises off it — but tests drive launchers/workers from worker threads, so
both call sites need the same install-if-main / restore-in-finally dance.
One helper, one behavior.
"""

from __future__ import annotations

import contextlib
import signal
import threading
from typing import Callable, Iterator

__all__ = ["main_thread_signal"]


@contextlib.contextmanager
def main_thread_signal(signum: int, handler: Callable) -> Iterator[bool]:
    """Install ``handler`` for ``signum`` for the duration of the block.

    Yields True when installed (main thread) and restores the previous
    handler on exit; off the main thread it yields False and does nothing
    — the caller keeps working, just without signal-driven behavior.
    """
    if threading.current_thread() is not threading.main_thread():
        yield False
        return
    prev = signal.signal(signum, handler)
    try:
        yield True
    finally:
        signal.signal(signum, prev)
