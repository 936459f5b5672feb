"""Serving metrics: queue depth, TTFT and its queue/prefill split,
occupancy, tokens/s, chunks per admission, the prefix cache's tiers, the
KV page pool and speculative decoding's accept rate.

The subset of the JAX package's ``serve/metrics.py:ServeMetrics`` that the
ported scheduler records (no metrics registry: ROADMAP queue 1 item 9).
Metrics are recorded per step and per request lifecycle event and
aggregated over a bounded sliding window.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, Optional

#: The prefix cache's per-tier event counters.
TIER_COUNTERS = ("hits", "misses", "spills", "promotions", "evictions")


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
        #: TTFT split: time queued (submit -> slot) and time prefilling
        #: (slot -> first token). With chunked prefill the two diverge,
        #: and only the second is the prefill path's to improve.
        self._ttft_queue_s: deque = deque(maxlen=window)
        self._ttft_prefill_s: deque = deque(maxlen=window)
        #: Chunk dispatches per admission (1 on the monolithic path).
        self._prefill_chunks: deque = deque(maxlen=window)
        #: (prefix_hit_tokens, prompt_tokens) per admission.
        self._prefix_tokens: deque = deque(maxlen=window)
        #: Cumulative prefix-cache tier counters (device/host/disk),
        #: accumulated from the scheduler's per-step deltas.
        self._prefix_tiers: Dict[str, Dict[str, int]] = {}
        #: The paged engine's latest ``kv_page_stats`` block (None until a
        #: paged engine reports).
        self._kv_pages: Optional[Dict[str, Any]] = None
        #: (verifies, drafted, accepted) per engine step with spec on.
        self._spec: deque = deque(maxlen=window)
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

    def record_admit(self, queue_s: float, queue_depth: int) -> None:
        """A request entered a slot after ``queue_s`` in the queue (its
        prefill may still be running: see record_first_token)."""
        with self._lock:
            self.admitted += 1
            self._ttft_queue_s.append(float(queue_s))
            self._set_queue_depth(queue_depth)

    def record_first_token(
        self,
        ttft_s: float,
        prefill_s: float,
        chunks: int,
        prefix_hit_tokens: int,
        prompt_tokens: int,
    ) -> None:
        """A request produced its first token: full TTFT, its prefill
        component, chunk dispatches spent, and the prefix-cache hit."""
        with self._lock:
            self._ttft_s.append(float(ttft_s))
            self._ttft_prefill_s.append(float(prefill_s))
            self._prefill_chunks.append(int(chunks))
            self._prefix_tokens.append(
                (int(prefix_hit_tokens), int(prompt_tokens))
            )

    def record_prefix_tiers(self, deltas: Dict[str, Dict[str, int]]) -> None:
        """One step's prefix-cache tier delta (the engine's cumulative
        counters diffed by the scheduler), accumulated for the snapshot's
        ``prefix_tiers`` block."""
        with self._lock:
            for tier, kv in deltas.items():
                cum = self._prefix_tiers.setdefault(
                    tier, {k: 0 for k in TIER_COUNTERS}
                )
                for k in TIER_COUNTERS:
                    cum[k] += int(kv.get(k, 0))

    def record_kv_pages(self, stats: Dict[str, Any]) -> None:
        """The page pool's state block (``DecodeEngine.kv_page_stats``:
        pages by state, fragmentation and the cumulative alloc, free and
        alias counters), recorded by the scheduler at each step whose
        counters moved and kept for the snapshot's ``kv_pages``. The JAX
        package also feeds the step's deltas to its metrics registry,
        which is not ported yet (ROADMAP queue 1 item 9)."""
        with self._lock:
            self._kv_pages = dict(stats)

    def record_spec(self, verifies: int, drafted: int, accepted: int) -> None:
        """One step's speculative-decoding delta: ``verifies`` (verify,
        slot) pairs proposed ``drafted`` draft tokens, of which
        ``accepted`` matched."""
        if not verifies:
            return
        with self._lock:
            self._spec.append((int(verifies), int(drafted), int(accepted)))

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
            # A long queue wait wants more slots; a long prefill wants
            # chunking and the prefix cache.
            for name, window in (("queue", self._ttft_queue_s),
                                 ("prefill", self._ttft_prefill_s)):
                vals = sorted(window)
                if vals:
                    out[f"ttft_{name}_p50_s"] = _pct(vals, 0.50)
                    out[f"ttft_{name}_p95_s"] = _pct(vals, 0.95)
            if self._prefill_chunks:
                out["prefill_chunks_per_admit"] = (
                    sum(self._prefill_chunks) / len(self._prefill_chunks)
                )
            if self._prefix_tokens:
                hit = sum(h for h, _ in self._prefix_tokens)
                tot = sum(p for _, p in self._prefix_tokens)
                # Fraction of prompt tokens served from the prefix cache
                # instead of prefill compute (0.0 with the cache off).
                out["prefix_hit_rate"] = hit / tot if tot else 0.0
            # Per-tier probe counters with each tier's share of all block
            # probes (the walk probes the device first, so its hits +
            # misses are the probe total).
            if self._prefix_tiers:
                dev = self._prefix_tiers.get("device", {})
                probes = dev.get("hits", 0) + dev.get("misses", 0)
                out["prefix_tiers"] = {
                    tier: {
                        **kv,
                        "hit_rate": kv["hits"] / probes if probes else 0.0,
                    }
                    for tier, kv in self._prefix_tiers.items()
                }
            # Paged KV: the pool's latest state (occupancy, fragmentation,
            # the cumulative counters); absent on dense engines.
            if self._kv_pages is not None:
                out["kv_pages"] = dict(self._kv_pages)
            # Speculative decoding, when it ran in the window: accepted
            # draft tokens per proposed one, and draft tokens per verify.
            if self._spec:
                v = sum(x[0] for x in self._spec)
                d = sum(x[1] for x in self._spec)
                a = sum(x[2] for x in self._spec)
                out["spec_accept_rate"] = round(a / d, 4) if d else 0.0
                out["draft_tokens_per_verify"] = round(d / v, 4) if v else 0.0
            return out
