"""Preemption signal plane: turn scheduled kills into one pending state.

The PyTorch port's copy of ``ray_lightning_tpu/serve/preempt.py``.

On preemptible infrastructure the dominant failure is not the random
crash but the *scheduled* one: spot reclamation and
host maintenance arrive with advance notice — a SIGTERM plus a grace
window, or a metadata endpoint flipping to a maintenance event — and a
process that treats that notice like a crash wastes it (blackout,
restart, failover replay, a trainer losing everything since its last
periodic checkpoint). This module is the per-process funnel that turns
every notice source into ONE state the rest of the stack can consume:

- :class:`PreemptionMonitor` — the process singleton
  (:func:`get_monitor`). Three sources feed :meth:`notice`:

  * **SIGTERM** (:meth:`install_sigterm`): the handler records the
    notice and does NOT exit — the grace window is for draining, and
    the reclamation's own SIGKILL (or the fabric's escalation) is the
    actual end of life. Clean shutdown paths are unaffected: fabric
    ``kill()`` breaks the worker loop with its "shutdown" message
    before any signal matters.
  * **metadata poller** (:meth:`start_metadata_poller`): a background
    thread polling a GCE-maintenance-shaped fetcher
    (:func:`gce_maintenance_fetcher`; tests pass a fake) — any
    non-``NONE`` event is a notice.
  * **fault injection**: ``serve.faults``' ``preempt`` action calls
    :meth:`notice` with the rule's grace window and schedules the hard
    kill at the deadline, so chaos tests exercise a real reclamation
    shape (drain in time or die).

- Consumers read :meth:`pending` / :meth:`remaining` / :meth:`state`:
  ``ServeReplica.health()`` ships the state to the supervisor (which
  flips the replica to PREEMPTING and drives the graceful drain),
  fabric worker heartbeats carry it for processes with no RPC surface
  (gang followers), and ``TrainingLoop`` checkpoints at the next step
  boundary and exits cleanly.

The first notice wins: later sources see the existing deadline instead
of extending it (a maintenance event followed by the SIGTERM it
predicted must not double the window). Everything is stdlib-only and
clock-injectable — no torch, no fabric — so the trainer and the worker
entrypoint can import it for free.
"""
from __future__ import annotations

import os
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional

#: Default grace window (s) when a notice source carries none —
#: conservative for CPU replicas; GCE spot gives 30s, TPU maintenance
#: typically more.
DEFAULT_GRACE_S = 30.0

#: The GCE metadata maintenance-event endpoint (the shape
#: :func:`gce_maintenance_fetcher` speaks; fakes mimic it in tests).
GCE_MAINTENANCE_URL = (
    "http://metadata.google.internal/computeMetadata/v1/instance/"
    "maintenance-event"
)


class PreemptionMonitor:
    """One process's preemption state: pending + deadline + source.

    Thread-safe; ``clock`` is injectable so deadline math is testable
    without sleeping. ``events`` (obs.events.EventLog-shaped) receives a
    ``preemption_notice`` record on the first notice.
    """

    def __init__(
        self,
        grace_s: float = DEFAULT_GRACE_S,
        events: Optional[Any] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.grace_s = float(grace_s)
        self.events = events
        self._clock = clock
        self._lock = threading.Lock()
        self._pending = False
        self._deadline: Optional[float] = None
        self._source: Optional[str] = None
        self._callbacks: List[Callable[["PreemptionMonitor"], None]] = []
        self._prev_sigterm: Any = None
        self._poller: Optional[threading.Thread] = None
        self._poller_stop = threading.Event()

    # -- the notice funnel -------------------------------------------------
    def notice(
        self, grace_s: Optional[float] = None, source: str = "manual"
    ) -> float:
        """Record a preemption notice; returns the (monotonic) deadline.
        Idempotent: the FIRST notice fixes the deadline — a later source
        reporting the same reclamation must not extend the window."""
        with self._lock:
            if self._pending:
                return float(self._deadline)
            self._pending = True
            self._source = source
            self._deadline = self._clock() + float(
                self.grace_s if grace_s is None else grace_s
            )
            deadline = self._deadline
            callbacks = list(self._callbacks)
        if self.events is not None:
            try:
                self.events.record(
                    "preempt", "preemption_notice", level="warn",
                    source=source,
                    grace_s=round(deadline - self._clock(), 3),
                )
            except Exception:  # noqa: BLE001 - forensics never block it
                pass
        for fn in callbacks:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 - a consumer's bug must not
                pass  # mask the notice for the others
        return deadline

    def add_callback(
        self, fn: Callable[["PreemptionMonitor"], None]
    ) -> None:
        """Run ``fn(monitor)`` on the first notice (e.g. wake a serve
        loop so the drain starts without waiting out an idle tick)."""
        with self._lock:
            self._callbacks.append(fn)

    # -- read side ---------------------------------------------------------
    def pending(self) -> bool:
        with self._lock:
            return self._pending

    def deadline(self) -> Optional[float]:
        """Monotonic deadline of the grace window (None = no notice)."""
        with self._lock:
            return self._deadline

    def remaining(self) -> Optional[float]:
        """Seconds of grace left (clamped at 0), None when not pending."""
        with self._lock:
            if not self._pending:
                return None
            return max(0.0, self._deadline - self._clock())

    def state(self) -> Dict[str, Any]:
        """The wire form health()/heartbeats carry."""
        with self._lock:
            if not self._pending:
                return {"pending": False}
            return {
                "pending": True,
                "remaining_s": round(
                    max(0.0, self._deadline - self._clock()), 3
                ),
                "source": self._source,
                "grace_s": self.grace_s,
            }

    def clear(self) -> None:
        """Forget the notice (a resumed in-process fit stands in for the
        replacement process; a maintenance event that was cancelled)."""
        with self._lock:
            self._pending = False
            self._deadline = None
            self._source = None

    # -- signal + poller sources -------------------------------------------
    def install_sigterm(self) -> bool:
        """Route SIGTERM into :meth:`notice` (graceful-drain semantics:
        record, don't exit — the killer's SIGKILL ends the process).
        Returns False when not on the main thread (signal handlers can
        only install there; e.g. an in-process replica built from a test
        worker thread just skips the hook)."""
        if threading.current_thread() is not threading.main_thread():
            return False

        def _handler(signum, frame):  # noqa: ARG001 - signal signature
            self.notice(source="sigterm")

        self._prev_sigterm = signal.signal(signal.SIGTERM, _handler)
        return True

    def uninstall_sigterm(self) -> None:
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except ValueError:  # not the main thread
                pass
            self._prev_sigterm = None

    def start_metadata_poller(
        self,
        fetch_fn: Optional[Callable[[], Optional[str]]] = None,
        interval_s: float = 1.0,
    ) -> "PreemptionMonitor":
        """Poll ``fetch_fn`` (default: the GCE maintenance endpoint) on
        a daemon thread; a truthy event string is a notice. Idempotent
        while a poller is running."""
        if self._poller is not None and self._poller.is_alive():
            return self
        fetch = fetch_fn or gce_maintenance_fetcher()
        self._poller_stop.clear()

        def _loop() -> None:
            while not self._poller_stop.is_set():
                try:
                    event = fetch()
                except Exception:  # noqa: BLE001 - a flaky endpoint is
                    event = None  # not a preemption
                if event:
                    self.notice(source=f"metadata:{event}")
                    return  # one notice is the whole job
                self._poller_stop.wait(interval_s)

        self._poller = threading.Thread(
            target=_loop, name="preempt-metadata-poller", daemon=True
        )
        self._poller.start()
        return self

    def stop_metadata_poller(self) -> None:
        self._poller_stop.set()
        if self._poller is not None:
            self._poller.join(timeout=5.0)
            self._poller = None


def gce_maintenance_fetcher(
    url: str = GCE_MAINTENANCE_URL, timeout_s: float = 1.0
) -> Callable[[], Optional[str]]:
    """A fetcher for :meth:`PreemptionMonitor.start_metadata_poller`
    speaking the GCE maintenance-event shape: the body is ``NONE`` until
    a migration/termination is scheduled. Any error reads as no event
    (the poller must not invent preemptions on flaky metadata)."""
    import urllib.request

    def fetch() -> Optional[str]:
        req = urllib.request.Request(
            url, headers={"Metadata-Flavor": "Google"}
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                body = resp.read().decode("utf-8", "replace").strip()
        except Exception:  # noqa: BLE001 - unreachable metadata = no event
            return None
        return None if body in ("", "NONE") else body

    return fetch


# -- the process singleton --------------------------------------------------
_monitor: Optional[PreemptionMonitor] = None
_monitor_lock = threading.Lock()


def get_monitor(
    grace_s: Optional[float] = None, events: Optional[Any] = None
) -> PreemptionMonitor:
    """The process's PreemptionMonitor (created on first use). Explicit
    ``grace_s``/``events`` update the existing singleton — the last
    configurer (usually the replica/trainer that owns the process) wins."""
    global _monitor
    with _monitor_lock:
        if _monitor is None:
            env_grace = os.environ.get("RLT_PREEMPT_GRACE_S")
            default = DEFAULT_GRACE_S
            if env_grace:
                try:
                    default = float(env_grace)
                except ValueError:
                    pass
            _monitor = PreemptionMonitor(
                grace_s=default if grace_s is None else float(grace_s),
                events=events,
            )
        else:
            if grace_s is not None:
                _monitor.grace_s = float(grace_s)
            if events is not None:
                _monitor.events = events
        return _monitor


def peek_state() -> Optional[Dict[str, Any]]:
    """The monitor's state WITHOUT creating one — the heartbeat hook's
    read (a process that never armed preemption pays one None check)."""
    m = _monitor
    return None if m is None else m.state()


def reset_monitor() -> None:
    """Drop the singleton (tests; a fit retry standing in for the
    replacement process). Stops any running poller first."""
    global _monitor
    with _monitor_lock:
        if _monitor is not None:
            _monitor.stop_metadata_poller()
            _monitor.uninstall_sigterm()
        _monitor = None
