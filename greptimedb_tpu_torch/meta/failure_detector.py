"""Phi-accrual failure detector.

Reference behavior: src/meta-srv/src/failure_detector.rs:17-75 (an Akka
port): heartbeat intervals feed a bounded sample window; `phi(now)` is the
-log10 of the probability that a heartbeat is merely late given the
observed interval distribution (normal approximation with a minimum
standard deviation). phi crosses the threshold ⇒ the node is suspected.

Ported from greptimedb_tpu/meta/failure_detector.py (a copy).
"""

from __future__ import annotations

import math
from collections import deque
from typing import Deque, Optional


class PhiAccrualFailureDetector:
    def __init__(self, *, threshold: float = 8.0,
                 min_std_deviation_ms: float = 100.0,
                 acceptable_heartbeat_pause_ms: float = 3000.0,
                 first_heartbeat_estimate_ms: float = 1000.0,
                 max_sample_size: int = 1000) -> None:
        self.threshold = threshold
        self.min_std_deviation_ms = min_std_deviation_ms
        self.acceptable_heartbeat_pause_ms = acceptable_heartbeat_pause_ms
        self.first_heartbeat_estimate_ms = first_heartbeat_estimate_ms
        self.max_sample_size = max_sample_size
        self._intervals: Deque[float] = deque(maxlen=max_sample_size)
        self._sum = 0.0
        self._sum_sq = 0.0
        self._last_heartbeat_ms: Optional[float] = None

    # ---- sample window ----
    def _push(self, interval: float) -> None:
        if len(self._intervals) == self.max_sample_size:
            old = self._intervals[0]
            self._sum -= old
            self._sum_sq -= old * old
        self._intervals.append(interval)
        self._sum += interval
        self._sum_sq += interval * interval

    @property
    def sample_count(self) -> int:
        return len(self._intervals)

    def _mean(self) -> float:
        n = len(self._intervals)
        return self._sum / n if n else 0.0

    def _std_dev(self) -> float:
        n = len(self._intervals)
        if n == 0:
            return 0.0
        mean = self._mean()
        var = max(self._sum_sq / n - mean * mean, 0.0)
        return max(math.sqrt(var), self.min_std_deviation_ms)

    # ---- protocol ----
    def heartbeat(self, now_ms: float) -> None:
        last = self._last_heartbeat_ms
        if last is not None:
            if now_ms >= last:
                self._push(now_ms - last)
        else:
            # bootstrap with a conservative synthetic distribution
            # (reference: first_heartbeat_estimate seeding)
            est = self.first_heartbeat_estimate_ms
            self._push(est)
            self._push(est + est / 4)
            self._push(max(est - est / 4, 0.0))
        self._last_heartbeat_ms = now_ms

    def phi(self, now_ms: float) -> float:
        if self._last_heartbeat_ms is None or not self._intervals:
            return 0.0
        elapsed = now_ms - self._last_heartbeat_ms
        mean = self._mean() + self.acceptable_heartbeat_pause_ms
        std = self._std_dev()
        y = (elapsed - mean) / std
        # P(X > elapsed) for logistic approximation of the normal CDF
        # (exponent clamped: |y| beyond ~±40 saturates p at 1 / 0)
        e = math.exp(max(min(-y * (1.5976 + 0.070566 * y * y), 700.0),
                         -700.0))
        if elapsed > mean:
            p = e / (1.0 + e)
        else:
            p = 1.0 - 1.0 / (1.0 + e)
        if p <= 0.0:
            return float("inf")
        return -math.log10(p)

    def is_available(self, now_ms: float) -> bool:
        return self.phi(now_ms) < self.threshold

    @property
    def last_heartbeat_ms(self) -> Optional[float]:
        return self._last_heartbeat_ms
