"""Deterministic fault injection for the serving fleet.

The PyTorch port's copy of ``ray_lightning_tpu/serve/faults.py``. The
port's scheduler hits the four scheduler points below and the replica
(``serve/server.py:ServeReplica``) the RPC points; the follower and fleet
points belong to the gang and the fleet KV plane (ROADMAP queue 1 items 11
and 9). The ``preempt`` action funnels into the process's preemption
monitor (``serve/preempt.py``).

Chaos testing a serving stack with `kill -9` + sleeps is flaky by
construction: the kill lands at an arbitrary point in the request
lifecycle, so every run exercises a different interleaving and the
interesting ones (die BETWEEN the journal outcome flush and the client
ack) almost never happen on demand. This module replaces wall-clock
chaos with *named points*: the scheduler, the replica RPC surface, and
the gang-follower op loop each call :meth:`FaultInjector.hit` at fixed
places in their control flow, and an armed rule fires its action on the
Nth hit of its point — the same fault lands at the same logical step
every run, so recovery behavior (supervisor restart, journal-backed
failover, bit-exact resubmission) is test-assertable instead of
observable-if-lucky.

Points (where the hooks live):

- ``post_admit`` — scheduler step, after an admission burst dispatched
  (requests hold slots; chunked admissions have no first token yet);
- ``mid_prefill_chunk`` — scheduler step, after prefill chunks advanced
  (a multi-chunk prompt is part-way through its prefill);
- ``fold_boundary`` — scheduler step, after a decode fold harvested
  (tokens emitted and journaled, step not yet returned);
- ``post_finish_pre_ack`` — scheduler step, after a request's terminal
  ledger/journal flush but BEFORE the step returns its events (the
  replica dies having *recorded* the finish that the client never saw);
- ``rpc_submit`` / ``rpc_result`` — top of the replica's submit/result
  RPC handlers (fabric RPC delay/drop);
- ``follower_op`` — gang follower, before executing a replayed engine
  op (wedge a follower mid-stream);
- ``kvfleet_fetch`` — fleet KV plane, as a fetched peer/store payload
  is about to import into the pool (a ``delay`` here lands entirely
  inside the anatomy ledger's ``kv_fetch`` phase — the latency-
  attribution demo's knob).

Actions: ``kill`` (``os._exit`` — a hard crash, no flushes, exactly
what a torn JSONL tail looks like), ``delay`` (sleep ``seconds``),
``drop`` (raise ``ConnectionError`` — the RPC fails, the process
lives), ``wedge`` (block ``seconds``, default effectively forever —
a hung thread), ``preempt`` (a SCHEDULED kill: the process's
:mod:`serve.preempt` monitor records a notice with a ``seconds`` grace
window NOW, and the hard ``os._exit`` lands at the deadline — the spot
reclamation shape the graceful-drain path exists for: drain in time or
die like a crash).

Gating: everything is off unless a plan is supplied — via the
``faults=`` kwarg on ``ServeReplica``/``Scheduler``, the
``inject_fault`` RPC on a live replica (how the chaos tests and the
``failover_blackout`` bench arm ONE replica of a fleet), or the
``RLT_FAULTS`` env var (JSON; applied at process start, so it rides
``start_replicas(env=...)``). A hit on an unarmed injector is one dict
lookup; no injector is a ``None`` check.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Union

#: Every named point a hook calls; plans naming anything else are
#: rejected up front (a typo'd point would otherwise silently never
#: fire and the chaos test would assert recovery from nothing).
FAULT_POINTS = frozenset((
    "post_admit",
    "mid_prefill_chunk",
    "fold_boundary",
    "post_finish_pre_ack",
    "rpc_submit",
    "rpc_result",
    "follower_op",
    "kvfleet_fetch",
))

FAULT_ACTIONS = frozenset(("kill", "delay", "drop", "wedge", "preempt"))

#: Grace window (s) a ``preempt`` rule uses when ``seconds`` is 0.
PREEMPT_DEFAULT_GRACE_S = 30.0

#: Exit code a fault-injected kill dies with (distinguishable from a
#: real crash in the fabric's actor_death event / exitcode).
KILL_EXIT_CODE = 43

#: Env var carrying a JSON fault plan applied at process start.
FAULTS_ENV = "RLT_FAULTS"


class FaultDropError(ConnectionError):
    """The injected form of a dropped fabric RPC."""


class FaultRule:
    """One armed fault: fire ``action`` on the ``after``-th hit of
    ``point`` (1-based), then disarm (one-shot — chaos plans stay
    enumerable)."""

    def __init__(
        self,
        point: str,
        action: str = "kill",
        after: int = 1,
        seconds: float = 0.0,
    ) -> None:
        if point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {point!r}; valid points: "
                f"{sorted(FAULT_POINTS)}"
            )
        if action not in FAULT_ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r}; valid actions: "
                f"{sorted(FAULT_ACTIONS)}"
            )
        self.point = point
        self.action = action
        self.after = max(1, int(after))
        self.seconds = float(seconds)
        self.hits = 0
        self.fired = False

    def describe(self) -> Dict[str, Any]:
        return {
            "point": self.point,
            "action": self.action,
            "after": self.after,
            "seconds": self.seconds,
            "hits": self.hits,
            "fired": self.fired,
        }


PlanLike = Union[None, str, Dict[str, Any], Sequence[Dict[str, Any]]]


class FaultInjector:
    """Holds armed :class:`FaultRule`\\ s and fires them at named points.

    Thread-safe: hit counting happens under a lock (the scheduler loop,
    the RPC threads, and a follower loop may all hold hooks); the
    ACTION runs outside it so a wedge/delay never blocks other points.
    """

    def __init__(
        self, rules: Sequence[FaultRule], events: Optional[Any] = None
    ) -> None:
        self._rules = list(rules)
        self._points = {r.point for r in self._rules}
        self._events = events
        self._lock = threading.Lock()

    # -- construction -----------------------------------------------------
    @classmethod
    def parse(
        cls, plan: PlanLike, events: Optional[Any] = None
    ) -> Optional["FaultInjector"]:
        """Build an injector from a plan (a rule dict, a list of rule
        dicts, or their JSON encoding). None/empty plans return None —
        the uninjected fast path stays a ``None`` check."""
        if plan is None:
            return None
        if isinstance(plan, FaultInjector):
            return plan
        if isinstance(plan, str):
            plan = json.loads(plan)
        if isinstance(plan, dict):
            plan = [plan]
        rules = [
            FaultRule(
                point=str(p["point"]),
                action=str(p.get("action", "kill")),
                after=int(p.get("after", 1)),
                seconds=float(p.get("seconds", 0.0)),
            )
            for p in plan
        ]
        if not rules:
            return None
        return cls(rules, events=events)

    @classmethod
    def from_env(
        cls, events: Optional[Any] = None
    ) -> Optional["FaultInjector"]:
        """The process-start gate: ``RLT_FAULTS`` as a JSON plan (rides
        ``start_replicas(env=...)`` into a replica/follower process)."""
        raw = os.environ.get(FAULTS_ENV)
        if not raw:
            return None
        return cls.parse(raw, events=events)

    # -- read side --------------------------------------------------------
    def describe(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [r.describe() for r in self._rules]

    # -- the hook ---------------------------------------------------------
    def hit(self, point: str) -> None:
        """Record one occurrence of ``point``; fire any rule whose count
        just reached ``after``. Called from hot-ish paths — bail on one
        set lookup when no rule names the point."""
        if point not in self._points:
            return
        fire: List[FaultRule] = []
        with self._lock:
            for rule in self._rules:
                if rule.fired or rule.point != point:
                    continue
                rule.hits += 1
                if rule.hits >= rule.after:
                    rule.fired = True
                    fire.append(rule)
        for rule in fire:
            self._fire(rule)

    def _fire(self, rule: FaultRule) -> None:
        if self._events is not None:
            try:
                self._events.record(
                    "faults", "fault_fired", level="warn",
                    point=rule.point, action=rule.action,
                    after=rule.after,
                )
            except Exception:  # noqa: BLE001 - forensics must not mask
                pass  # the fault being injected
        if rule.action == "kill":
            # A CRASH, not a shutdown: no atexit, no journal flush, no
            # gang sentinel — the failure mode the supervisor/failover
            # machinery exists for (and the source of torn JSONL tails).
            os._exit(KILL_EXIT_CODE)
        elif rule.action == "delay":
            time.sleep(rule.seconds)
        elif rule.action == "drop":
            raise FaultDropError(
                f"fault-injected RPC drop at {rule.point!r}"
            )
        elif rule.action == "wedge":
            # A hung thread (not a dead process): heartbeats keep
            # flowing, the RPC surface may keep answering — only THIS
            # call path stops. Bounded so an orphaned wedge cannot
            # outlive a long test session's process reuse.
            threading.Event().wait(rule.seconds or 3600.0)
        elif rule.action == "preempt":
            # A reclamation, not a crash: the notice lands now (the
            # monitor flips preemption_pending, health/heartbeats carry
            # it, the drain machinery gets the grace window) and the
            # kill honors its own deadline — an undrained process dies
            # exactly like a ``kill`` at grace end. The calling thread
            # continues immediately: the whole point is that serving
            # keeps running through the window.
            from ray_lightning_tpu_torch.serve.preempt import get_monitor

            grace = rule.seconds or PREEMPT_DEFAULT_GRACE_S
            get_monitor(events=self._events).notice(
                grace_s=grace, source="fault"
            )
            timer = threading.Timer(
                grace, os._exit, args=(KILL_EXIT_CODE,)
            )
            timer.daemon = True
            timer.start()
