"""Signal -> stop-event wiring for long-running processes.

A copy of ``tf_operator_tpu/utils/signals.py``: the first SIGTERM/SIGINT
trips the stop event (a trainer turns it into a forced save and an ack),
a second one hard-exits.
"""

from __future__ import annotations

import os
import signal
import threading

_installed = False


def setup_signal_handler() -> threading.Event:
    """Install once; returns the stop event. Second signal exits(1) hard."""
    global _installed
    stop = threading.Event()

    def _handler(signum: int, frame: object) -> None:
        if stop.is_set():
            os._exit(1)
        stop.set()

    if not _installed and threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _handler)
        signal.signal(signal.SIGINT, _handler)
        _installed = True
    return stop
