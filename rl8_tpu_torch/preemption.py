"""Preemption-aware training shutdown (counterpart of ``rl8_tpu/preemption.py``).

Machines that host the card receive ``SIGTERM`` with a grace period
before eviction (maintenance, spot reclaims, scheduler moves).
:class:`PreemptionMonitor` latches the signal, and ``Trainer.run`` saves a
final checkpoint at the next step boundary and returns; rerunning the
same command resumes from it. In a multi-process run ``preempted()``
answers for every process: one signalled process makes all of them save
and return.
"""

from __future__ import annotations

import signal
import threading
import warnings
from types import FrameType
from typing import Any

from .parallel import _max_int

__all__ = ["PreemptionMonitor"]


class PreemptionMonitor:
    """Latches ``SIGTERM`` and answers "was this process preempted?".

    Usage::

        with PreemptionMonitor() as monitor:
            while training:
                step()
                if monitor.preempted():
                    save_checkpoint(...)
                    break

    ``install``/``uninstall`` save and restore the previous ``SIGTERM``
    disposition, and a previously installed Python handler is chained
    (still called) so outer supervisors keep observing the signal.
    Installation is skipped with a warning off the main thread, where
    CPython forbids ``signal.signal``; :meth:`request` remains available
    there.
    """

    def __init__(self) -> None:
        self._flag = False
        self._prev: Any = None
        self._installed = False

    def install(self) -> "PreemptionMonitor":
        """Register the ``SIGTERM`` handler (main thread only).

        Off the main thread this warns and installs nothing: SIGTERM will
        then not trigger a final checkpoint; wire your own handler to
        :meth:`request` if you train from a worker thread.
        """
        if self._installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            warnings.warn(
                "PreemptionMonitor.install() skipped: not on the main"
                " thread, so no SIGTERM handler was registered and a"
                " preemption will NOT trigger a final checkpoint. Call"
                " monitor.request() from your own signal handler to keep"
                " the protection.",
                RuntimeWarning,
                stacklevel=2,
            )
            return self
        self._prev = signal.signal(signal.SIGTERM, self._on_signal)
        self._installed = True
        return self

    def uninstall(self) -> None:
        """Restore the ``SIGTERM`` disposition that preceded :meth:`install`.

        A pre-existing handler that was not installed from Python
        (``signal.getsignal`` returned ``None``) cannot be re-installed
        from Python; ``SIG_DFL`` is set instead, with a warning.
        """
        if not self._installed:
            return
        if self._prev is None:
            warnings.warn(
                "The SIGTERM handler that preceded PreemptionMonitor was"
                " not installed from Python and cannot be restored;"
                " setting SIG_DFL instead.",
                RuntimeWarning,
                stacklevel=2,
            )
        signal.signal(signal.SIGTERM, self._prev if self._prev is not None else signal.SIG_DFL)
        self._installed = False

    def _on_signal(self, signum: int, frame: None | FrameType) -> None:
        self._flag = True
        if callable(self._prev):
            self._prev(signum, frame)

    def request(self) -> None:
        """Latch the flag without a signal (manual shutdown requests,
        tests, and callers off the main thread)."""
        self._flag = True

    @property
    def local_flag(self) -> bool:
        """This process's flag."""
        return self._flag

    def preempted(self) -> bool:
        """Whether any process has latched a preemption.

        In a multi-process run this is a collective (a MAX of the flag over
        the default group): every process calls it the same number of
        times, as ``Trainer.run`` does once per step boundary. Alone it is
        this process's flag."""
        return bool(_max_int(int(self._flag)))

    def __enter__(self) -> "PreemptionMonitor":
        return self.install()

    def __exit__(self, *exc: Any) -> None:
        self.uninstall()
