"""Preemption-safe training shutdown -- the port of
``weather_unet_tpu/train/preemption.py``.

Cloud GPU instances are preemptible: the scheduler delivers SIGTERM and
the process has a grace window to persist state.  The reference has no
equivalent (its only resilience is auto-resume from the last periodic save,
``t_est_train.py:151-163`` — up to 1000 steps of lost work).  This module
closes the gap: a signal listener flips a flag, training loops poll it at
step boundaries, checkpoint immediately, and exit cleanly; the existing
auto-resume then continues from the *preemption point* instead of the last
cadence save.

Kept deliberately simple (a flag, not a callback): the handler runs on the
main thread between Python bytecodes, so doing the checkpoint *inside* the
handler could re-enter device code mid-step.  Polling at step
boundaries is race-free by construction.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional


class GracefulShutdown:
    """Context manager that records SIGTERM/SIGINT instead of dying.

    >>> with GracefulShutdown() as stop:
    ...     for batch in loader:
    ...         if stop.requested:
    ...             trainer.save(); break
    ...         step(batch)

    Outside the ``with`` block the previous handlers are restored.  A second
    signal while shutdown is pending falls through to the previous handler
    (so a double Ctrl-C still force-kills an interactive run).  Thread-safe
    to read; installation must happen on the main thread (Python restricts
    ``signal.signal`` to it) — off the main thread this becomes an inert
    flag that never fires, which is the right degradation for loops driven
    from worker threads (e.g. the serve CLI).
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = signals
        self._event = threading.Event()
        self._prev: dict = {}
        self._signum: Optional[int] = None

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    @property
    def signum(self) -> Optional[int]:
        return self._signum

    def _handler(self, signum, frame):
        if self._event.is_set():
            # second signal: restore + re-raise through the previous handler
            prev = self._prev.get(signum, signal.SIG_DFL)
            signal.signal(signum, prev)
            raise KeyboardInterrupt
        self._signum = signum
        self._event.set()

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            for s in self.signals:
                self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        return False
