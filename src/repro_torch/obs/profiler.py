"""Bounded ``torch.profiler`` capture window for ``--profile-dir``.

Port of ``repro/obs/profiler.py``.  The window starts a
``torch.profiler`` trace (host, and the card's kernels when there is one)
on construction and stops it after ``max_spans`` instrumented spans have
passed through, or at :meth:`stop`; it then writes a Chrome trace,
``trace.json`` in ``logdir`` (open it in Perfetto or ``chrome://tracing``).
The bound keeps a long run from filling the disk.  If the profiler
cannot start (another trace already active), the window is a no-op
instead of failing the run.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

__all__ = ["ProfileWindow"]

#: the Chrome-trace file a window writes into its ``logdir``
TRACE_FILE = "trace.json"


class ProfileWindow:
    def __init__(self, logdir: str, max_spans: int = 64):
        self.logdir = logdir
        self.max_spans = max_spans
        self.trace_path: Optional[str] = None
        self._spans = 0
        self._lock = threading.Lock()
        self._prof = None
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
            self._prof = prof
        except Exception:
            self._prof = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def annotation(self, name: str):
        """A ``torch.profiler.record_function`` range for *name* while the
        window is open, else None."""
        if self._prof is None:
            return None
        import torch

        return torch.profiler.record_function(name)

    def tick(self) -> None:
        """Count one completed span; close the window at the bound."""
        if self._prof is None:
            return
        with self._lock:
            self._spans += 1
            if self._spans >= self.max_spans:
                self._stop_locked()

    def stop(self) -> None:
        with self._lock:
            self._stop_locked()

    def _stop_locked(self) -> None:
        prof, self._prof = self._prof, None
        if prof is None:
            return
        prof.stop()
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, TRACE_FILE)
        prof.export_chrome_trace(path)
        self.trace_path = path
