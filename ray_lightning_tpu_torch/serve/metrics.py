"""Serving metrics: queue depth, TTFT, occupancy, tokens/s.

The subset of the JAX package's ``serve/metrics.py:ServeMetrics`` that the
scheduler core records. Metrics are recorded per step and per request
lifecycle event and aggregated over a bounded sliding window.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict


def _pct(sorted_vals, q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class ServeMetrics:
    """Thread-safe counters + sliding-window rates for one engine.

    ``window`` bounds how many recent engine steps and first tokens feed
    the rate/occupancy aggregates.
    """

    def __init__(self, num_slots: int, window: int = 512) -> None:
        self.num_slots = max(1, int(num_slots))
        self._lock = threading.Lock()
        self.submitted = 0
        self.admitted = 0
        self.finished = 0
        self.cancelled = 0
        self.expired = 0
        self._ttft_s: deque = deque(maxlen=window)
        #: (wall_s, active_slots, tokens_emitted) per engine step.
        self._steps: deque = deque(maxlen=window)
        self._queue_depth = 0

    def _set_queue_depth(self, queue_depth) -> None:
        """Under self._lock: every event that can change the queue reports
        the depth it observed, so the stat never goes stale."""
        if queue_depth is not None:
            self._queue_depth = int(queue_depth)

    def record_submit(self, queue_depth: int) -> None:
        with self._lock:
            self.submitted += 1
            self._set_queue_depth(queue_depth)

    def record_admit(self, queue_depth: int) -> None:
        with self._lock:
            self.admitted += 1
            self._set_queue_depth(queue_depth)

    def record_first_token(self, ttft_s: float) -> None:
        with self._lock:
            self._ttft_s.append(float(ttft_s))

    def record_finish(self, n: int = 1, queue_depth=None) -> None:
        with self._lock:
            self.finished += n
            self._set_queue_depth(queue_depth)

    def record_cancel(self, n: int = 1, queue_depth=None) -> None:
        with self._lock:
            self.cancelled += n
            self._set_queue_depth(queue_depth)

    def record_expire(self, n: int = 1, queue_depth=None) -> None:
        with self._lock:
            self.expired += n
            self._set_queue_depth(queue_depth)

    def record_step(
        self, wall_s: float, active_slots: int, tokens_emitted: int,
        queue_depth: int,
    ) -> None:
        with self._lock:
            self._steps.append(
                (float(wall_s), int(active_slots), int(tokens_emitted))
            )
            self._set_queue_depth(queue_depth)

    def snapshot(self) -> Dict[str, Any]:
        """Aggregate view over the sliding window."""
        with self._lock:
            steps = list(self._steps)
            wall = sum(s[0] for s in steps)
            tokens = sum(s[2] for s in steps)
            occ = (
                sum(s[1] for s in steps) / (len(steps) * self.num_slots)
                if steps
                else 0.0
            )
            out: Dict[str, Any] = {
                "num_slots": self.num_slots,
                "queue_depth": self._queue_depth,
                "submitted": self.submitted,
                "admitted": self.admitted,
                "finished": self.finished,
                "cancelled": self.cancelled,
                "expired": self.expired,
                "steps_recorded": len(steps),
                # Mean fraction of slots occupied per step over the window.
                "occupancy": occ,
                "tokens_emitted_window": tokens,
                "tokens_per_sec": tokens / wall if wall > 0 else 0.0,
            }
            ttft = sorted(self._ttft_s)
            if ttft:
                out["ttft_p50_s"] = _pct(ttft, 0.50)
                out["ttft_p95_s"] = _pct(ttft, 0.95)
                out["ttft_max_s"] = ttft[-1]
            return out
