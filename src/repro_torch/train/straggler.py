"""Straggler detection: the twin of ``repro.train.straggler``.

A step-time window with median and p99; a host whose step time exceeds
``threshold x`` the window's median for ``patience`` consecutive steps
is flagged.  The data loader's prefetch (``train/data.py``) keeps a
slow read from stalling the step.
"""

from __future__ import annotations

import collections


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, patience: int = 5,
                 window: int = 128):
        self.threshold = threshold
        self.patience = patience
        self.times = collections.deque(maxlen=window)
        self.strikes = collections.defaultdict(int)

    def record(self, host_id: int, step_time: float) -> None:
        self.times.append(step_time)

    def median(self) -> float:
        if not self.times:
            return 0.0
        s = sorted(self.times)
        return s[len(s) // 2]

    def p99(self) -> float:
        if not self.times:
            return 0.0
        s = sorted(self.times)
        return s[min(int(len(s) * 0.99), len(s) - 1)]

    def check(self, host_id: int, step_time: float) -> bool:
        """Record and return True when host should be evicted."""
        self.record(host_id, step_time)
        med = self.median()
        if med > 0 and step_time > self.threshold * med:
            self.strikes[host_id] += 1
        else:
            self.strikes[host_id] = 0
        return self.strikes[host_id] >= self.patience
