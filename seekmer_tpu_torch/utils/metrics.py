"""Named counters and accumulated stage timings, reported in ``run_info.json``
(reads/s of the map stage, EM iterations/s): the port's copy of
``seekmer_tpu/utils/metrics.py``."""

from __future__ import annotations

import json
import logging
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

log = logging.getLogger(__name__)


class Metrics:
    """Process-wide named counters and accumulated stage timings."""

    def __init__(self):
        self.counters: Dict[str, float] = defaultdict(float)
        self.timings: Dict[str, float] = defaultdict(float)
        self._start = time.perf_counter()

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] += n

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[name] += time.perf_counter() - t0

    def rate(self, counter: str, timer: str) -> float:
        dt = self.timings.get(timer, 0.0)
        return self.counters.get(counter, 0.0) / dt if dt > 0 else 0.0

    def snapshot(self) -> Dict[str, float]:
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
