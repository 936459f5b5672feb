"""Structured event log: a bounded, process-wide ring of typed events.

The PyTorch port keeps its own copy of ``ray_lightning_tpu/obs/events.py``
(stdlib only).

The forensic substrate of the ACTIVE observability half (obs.health
consumes it for verdict transitions, obs.blackbox ships its tail in
every flight-recorder bundle): serve, trainer, and fabric code record
discrete happenings — admission bursts, cancels, epoch boundaries,
actor deaths, heartbeat gaps, health verdict changes — as
``(ts, level, subsystem, name, kv)`` tuples in one ring buffer.

Recording is a tuple append under one lock (the same hot-path budget as
:class:`obs.trace.RequestTracer`), so the scheduler's fold loop can emit
without measurable cost; rendering (dicts, JSONL) happens at read time.
Unlike the tracer — which answers "what happened to request X" — the
event log answers "what happened to the PROCESS": it is keyed by
subsystem, carries a severity level, and uses wall-clock timestamps so
an exported tail lines up with external logs.

One process-global log (:func:`get_event_log`) mirrors the registry's
process-global default: each process (driver, replica actor, training
worker) accumulates its own and exports it whole.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

#: Severity levels, mildest first (no filtering on the record path —
#: the ring is small and the reader filters).
LEVELS = ("info", "warn", "error")


class EventLog:
    """Bounded ring of ``(ts, level, subsystem, name, kv)`` events."""

    def __init__(self, capacity: int = 4096, enabled: bool = True) -> None:
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=self.capacity)
        # Monotonic per-ring sequence: every recorded event gets the
        # next number, surviving ring rotation — the `/events?since=`
        # cursor external tails (rlt alerts --follow, sinks) resume
        # from without re-downloading the ring.
        self._seq = 0

    # -- hot path ---------------------------------------------------------
    def record(
        self, subsystem: str, name: str, level: str = "info", **kv: Any
    ) -> None:
        """Append one event; ``kv`` must be JSON-serializable scalars
        (they ride into bundles and the JSONL export verbatim)."""
        if not self.enabled:
            return
        with self._lock:
            self._seq += 1
            self._events.append(
                (time.time(), level, subsystem, name, kv or None, self._seq)
            )

    # -- read side --------------------------------------------------------
    def tail(
        self,
        n: Optional[int] = None,
        subsystem: Optional[str] = None,
        name: Optional[str] = None,
    ) -> List[Dict[str, Any]]:
        """The newest ``n`` matching events (oldest first, as dicts)."""
        with self._lock:
            events = list(self._events)
        out = []
        for row in events:
            ts, level, sub, nm, kv = row[:5]
            seq = row[5] if len(row) > 5 else None
            if subsystem is not None and sub != subsystem:
                continue
            if name is not None and nm != name:
                continue
            ev: Dict[str, Any] = {
                "ts": ts, "level": level, "subsystem": sub, "name": nm,
            }
            if seq is not None:
                ev["seq"] = seq
            if kv:
                ev.update(kv)
            out.append(ev)
        return out if n is None else out[-int(n):]

    def to_jsonl(self, n: Optional[int] = None) -> str:
        """JSONL export (one event per line) — the bundle format."""
        return "\n".join(
            json.dumps(ev, default=str) for ev in self.tail(n)
        ) + ("\n" if len(self) else "")

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


#: Process-global default log (mirrors obs.registry.get_registry()).
_LOG = EventLog()


def get_event_log() -> EventLog:
    return _LOG
