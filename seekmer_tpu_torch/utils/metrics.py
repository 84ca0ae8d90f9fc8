"""Named counters and accumulated stage timings, reported in ``run_info.json``
(reads/s of the map stage, EM iterations/s): the port's copy of
``seekmer_tpu/utils/metrics.py``, plus ``span``, a timer that is also a
named range in a trace (``utils/profiling.annotate``). The prefetch
thread times its stages beside the main thread's, so every update takes
a lock. ``Metrics.active`` makes a run's metrics the current ones of its
thread for code that is not handed them (``Metrics.current``)."""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Dict, Optional

from .profiling import annotate

log = logging.getLogger(__name__)

_CURRENT: ContextVar[Optional["Metrics"]] = ContextVar("metrics",
                                                       default=None)


class Metrics:
    """Named counters and accumulated stage timings of one run; ``wall_s``
    counts from its creation."""

    def __init__(self):
        self.counters: Dict[str, float] = defaultdict(float)
        self.timings: Dict[str, float] = defaultdict(float)
        self._lock = threading.Lock()
        self._start = time.perf_counter()

    def count(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.counters[name] += n

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.timings[name] += dt

    @contextmanager
    def span(self, name: str):
        """``timer(name)`` and a trace range ``name`` around the body."""
        with self.timer(name), annotate(name):
            yield

    @contextmanager
    def active(self):
        """These metrics as ``Metrics.current()`` inside the body."""
        token = _CURRENT.set(self)
        try:
            yield
        finally:
            _CURRENT.reset(token)

    @staticmethod
    def current() -> Optional["Metrics"]:
        """The metrics of the innermost ``active`` body, or None."""
        return _CURRENT.get()

    def rate(self, counter: str, timer: str) -> float:
        dt = self.timings.get(timer, 0.0)
        return self.counters.get(counter, 0.0) / dt if dt > 0 else 0.0

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self.counters)
            out.update({f"{k}_s": v for k, v in self.timings.items()})
        if "reads" in self.counters and "map" in self.timings:
            out["reads_per_s"] = self.rate("reads", "map")
        if "em_iterations" in self.counters and "em" in self.timings:
            out["em_iterations_per_s"] = self.rate("em_iterations", "em")
        out["wall_s"] = time.perf_counter() - self._start
        return out

    def log_summary(self) -> None:
        log.info("metrics: %s", json.dumps(self.snapshot(), default=float))
