"""FleetSupervisor: the driver-side detect -> decide -> recover loop
(PyTorch port of ``ray_lightning_tpu/serve/supervisor.py``).

Every replica has a watchdog that *detects* failure (``health()``
verdicts) and the client fails a lost replica's requests over; this
module brings the capacity back.

One :class:`FleetSupervisor` per :class:`serve.client.ServeClient`
drives a per-replica state machine on a daemon thread (or via explicit
:meth:`tick` calls — every transition is clock-injectable and
unit-testable without sleeping):

- **healthy**: probed via the replica's ``health()`` RPC (the watchdog
  verdict) plus its fabric heartbeat age (a heartbeat older than
  ``heartbeat_dead_s`` is a death verdict even while an RPC might still
  be queued behind a wedged loop thread).
- **draining**: the verdict came back ``unhealthy`` but the process
  answers — the replica is excluded from NEW submissions
  (``client.exclude``) while its in-flight work keeps streaming; a
  recovered verdict restores it.
- **dead**: the probe failed (actor died / RPC exhausted) or the
  heartbeat flatlined. The supervisor immediately fails the replica's
  incomplete requests over (``client.on_replica_lost`` — journal-backed
  resubmission onto survivors, bit-exact by the seed-chain contract)
  and schedules a restart.
- **preempting**: the probe carries a pending preemption notice
  (serve.preempt) — a SCHEDULED kill with a
  grace window, not a crash. The supervisor consumes the warning:
  traffic is excluded immediately, a replacement is PRE-SPAWNED during
  the grace window (fleet capacity never dips below N), and the replica
  drains — requests that can finish inside the window run to
  completion; the rest live-migrate (``client.preempt_drain``: the
  dying replica's exported prefix KV lands on a survivor, the journal
  submit replays there under the same id/seed, the stream cursor dedups
  — bit-exact, warm). When the routed requests hit zero (or the
  deadline), the replacement swaps in.
- **restarting**: after a capped exponential backoff
  (``restart_backoff_s * 2^attempt``, capped), the replica's original
  spawn recipe is re-run (``client.respawn_replica`` — same resolved
  config, same placement-group bundle, ``build_engine`` reconstructs an
  engine that captures the same graphs from the same checkpoint).
  Success returns it to **healthy** and
  re-includes it in routing; failure re-schedules with the next
  backoff. ``restart_limit`` consecutive failures park it at
  **failed** (a budget, so a poisoned config cannot restart-loop
  forever).

Everything is observable: ``rlt_fleet_replica_restarts_total{replica=}``
and ``rlt_fleet_replica_state{replica=}`` metrics, ``replica_draining``
/ ``replica_restarted`` / ``replica_restart_failed`` /
``replica_restart_giveup`` typed events (``replica_lost`` / ``failover``
come from the client), and :meth:`rows` — the supervisor table.

A tensor-parallel gang is one replica to the supervisor: the client
reads each follower's preemption notice from its heartbeat
(``gang_preempt_state``), which dooms the whole gang (the PREEMPTING path,
the event's ``member`` is ``follower``), and it respawns, pre-spawns and
tears down the gang as a unit.

Not ported yet, and refused naming its ROADMAP queue 1 item: the
``poller=`` feed (``obs.fleet.FleetPoller``, item 14).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

HEALTHY = "healthy"
DRAINING = "draining"
DEAD = "dead"
RESTARTING = "restarting"
FAILED = "failed"
PREEMPTING = "preempting"
RETIRED = "retired"

#: rlt_fleet_replica_state gauge values (renders in dashboards).
_STATE_SCORE = {
    HEALTHY: 0.0, DRAINING: 1.0, DEAD: 2.0, RESTARTING: 3.0, FAILED: 4.0,
    PREEMPTING: 5.0, RETIRED: 6.0,
}


def _default_heartbeat_dead_s() -> float:
    """Mirror obs.health.heartbeat_check's dead threshold: 6x the
    worker push cadence."""
    try:
        interval = float(os.environ.get("RLT_HEARTBEAT_S", "10"))
    except ValueError:
        interval = 10.0
    if interval <= 0:
        interval = 10.0
    return 6.0 * interval


class FleetSupervisor:
    """Supervise one ServeClient's replica fleet (see module docstring).

    ``client`` needs the ServeClient fault surface: ``health_one`` /
    ``replica_is_alive`` / ``replica_heartbeat_age`` / ``exclude`` /
    ``restore`` / ``on_replica_lost`` / ``respawn_replica`` /
    ``can_respawn`` / ``num_replicas``. ``poller`` is accepted as None
    only (ROADMAP queue 1 item 14). ``clock`` is injectable for tests.
    """

    def __init__(
        self,
        client: Any,
        interval_s: float = 1.0,
        restart_limit: int = 3,
        restart_backoff_s: float = 1.0,
        restart_backoff_cap_s: float = 30.0,
        probe_timeout_s: float = 10.0,
        heartbeat_dead_s: Optional[float] = None,
        poller: Optional[Any] = None,
        registry: Optional[Any] = None,
        events: Optional[Any] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        from ray_lightning_tpu_torch.obs.events import get_event_log
        from ray_lightning_tpu_torch.obs.registry import get_registry

        if poller is not None:
            raise NotImplementedError(
                "FleetSupervisor(poller=...) (the FleetPoller feed) is not "
                "ported yet (ROADMAP queue 1 item 14); the supervisor reads "
                "heartbeat ages from the client"
            )
        self.client = client
        self.interval_s = float(interval_s)
        self.restart_limit = max(0, int(restart_limit))
        self.restart_backoff_s = float(restart_backoff_s)
        self.restart_backoff_cap_s = float(restart_backoff_cap_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.heartbeat_dead_s = (
            _default_heartbeat_dead_s()
            if heartbeat_dead_s is None
            else float(heartbeat_dead_s)
        )
        self._clock = clock
        self._events = events if events is not None else get_event_log()
        reg = registry if registry is not None else get_registry()
        self._m_restarts = reg.counter(
            "rlt_fleet_replica_restarts_total",
            "Replica restarts performed by the fleet supervisor",
        )
        self._m_state = reg.gauge(
            "rlt_fleet_replica_state",
            "Supervisor replica state (0 healthy, 1 draining, 2 dead, "
            "3 restarting, 4 failed, 5 preempting)",
        )
        self._m_preempts = reg.counter(
            "rlt_fleet_replica_preemptions_total",
            "Preemption notices the supervisor consumed with a "
            "graceful drain",
        )
        self._lock = threading.RLock()
        #: replica idx -> state record (see _fresh()).
        self._replicas: Dict[int, Dict[str, Any]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- state records -----------------------------------------------------
    @staticmethod
    def _fresh() -> Dict[str, Any]:
        return {
            "state": HEALTHY,
            "verdict": HEALTHY,
            "restarts": 0,        # successful restarts, lifetime
            "attempts": 0,        # consecutive failed/pending attempts
            "next_restart_t": 0.0,
            "last_error": None,
            "preempt_deadline": None,   # monotonic; PREEMPTING only
            "preemptions": 0,           # notices consumed, lifetime
        }

    def _event(self, name: str, level: str = "info", **kv: Any) -> None:
        try:
            self._events.record("supervisor", name, level=level, **kv)
        except Exception:  # noqa: BLE001 - forensics must not stop recovery
            pass

    def _backoff(self, attempts: int) -> float:
        return min(
            self.restart_backoff_cap_s,
            self.restart_backoff_s * (2.0 ** max(0, attempts)),
        )

    # -- signals -----------------------------------------------------------
    def _heartbeat_age(self, idx: int) -> Optional[float]:
        """The client's direct heartbeat view (None when unavailable)."""
        fn = getattr(self.client, "replica_heartbeat_age", None)
        return None if fn is None else fn(idx)

    def _probe(self, idx: int) -> Any:
        """One replica's liveness + verdict + preemption notice: the
        health() RPC (fresh watchdog evaluation) gated by process
        liveness and heartbeat age, plus any pending preemption in its
        health report. Returns ``(verdict, death_reason,
        preempt_info)``; verdict None == dead."""
        alive_fn = getattr(self.client, "replica_is_alive", None)
        if alive_fn is not None and not alive_fn(idx):
            return None, "actor process is not alive", None
        age = self._heartbeat_age(idx)
        if age is not None and age > self.heartbeat_dead_s:
            return None, (
                f"no fabric heartbeat for {age:.1f}s "
                f"(> {self.heartbeat_dead_s:g}s)"
            ), None
        try:
            rep = self.client.health_one(
                idx, timeout=self.probe_timeout_s
            )
        except Exception as exc:  # noqa: BLE001 - any probe failure is
            # a death verdict; the restart path owns recovery.
            return None, f"{type(exc).__name__}: {exc}"[:300], None
        preempt = rep.get("preempt") if isinstance(rep, dict) else None
        if not (isinstance(preempt, dict) and preempt.get("pending")):
            preempt = None
            # A gang follower has no RPC surface: its notice rides its
            # heartbeat, and one preempted member dooms the whole gang.
            gang_fn = getattr(self.client, "gang_preempt_state", None)
            if gang_fn is not None:
                try:
                    p = gang_fn(idx)
                except Exception:  # noqa: BLE001 - advisory signal
                    p = None
                if isinstance(p, dict) and p.get("pending"):
                    preempt = dict(p, member="follower")
        return str(rep.get("verdict", HEALTHY)), None, preempt

    # -- the loop body -----------------------------------------------------
    def tick(self) -> Dict[str, Any]:
        """One detect -> decide -> recover pass over every replica.
        Returns a summary of what happened (tests and callers polling
        without the thread)."""
        now = self._clock()
        summary: Dict[str, Any] = {
            "probed": 0, "failed_over": 0, "restarted": 0,
            "restart_failures": 0, "preempting": 0,
        }
        retired_fn = getattr(self.client, "is_retired", None)
        for idx in range(int(self.client.num_replicas)):
            with self._lock:
                st = self._replicas.setdefault(idx, self._fresh())
                state = st["state"]
            if retired_fn is not None and retired_fn(idx):
                # A scale-down tombstone: deliberately gone — never
                # probed, never restarted (the autoscaler owns
                # capacity; the supervisor owns failures).
                with self._lock:
                    st["state"] = RETIRED
                    st["verdict"] = RETIRED
                continue
            if state in (DEAD, RESTARTING):
                self._try_restart(idx, now, summary)
                continue
            if state == FAILED:
                continue
            if state == PREEMPTING:
                self._continue_preempt(idx, now, summary)
                continue
            verdict, err, preempt = self._probe(idx)
            summary["probed"] += 1
            if verdict is None:
                self._on_dead(idx, err, now)
                summary["failed_over"] += 1
            elif preempt is not None:
                # A scheduled kill outranks an unhealthy verdict: the
                # drain consumes the grace window either way.
                self._begin_preempt(idx, preempt, now)
                summary["preempting"] += 1
            elif verdict == "unhealthy":
                with self._lock:
                    st["verdict"] = verdict
                    if st["state"] != DRAINING:
                        st["state"] = DRAINING
                        self.client.exclude(idx)
                        self._event(
                            "replica_draining", level="warn",
                            replica=idx,
                        )
            else:
                with self._lock:
                    st["verdict"] = verdict
                    if st["state"] == DRAINING:
                        st["state"] = HEALTHY
                        self.client.restore(idx)
                        self._event("replica_recovered", replica=idx)
        self._publish_states()
        return summary

    def _on_dead(self, idx: int, reason: Optional[str], now: float) -> None:
        with self._lock:
            st = self._replicas[idx]
            st["state"] = DEAD
            st["verdict"] = DEAD
            st["last_error"] = reason
            st["attempts"] = 0
            st["next_restart_t"] = now + self._backoff(0)
        # Failover FIRST, restart later: the stranded requests must not
        # wait out the restart backoff — survivors can take them now.
        # (Idempotent: the client's streaming path may already have
        # detected the same death and moved them.)
        try:
            self.client.on_replica_lost(idx, reason=reason or "probe failed")
        except Exception as exc:  # noqa: BLE001 - failover trouble must
            # not stop the restart arm.
            self._event(
                "failover_error", level="error", replica=idx,
                error=f"{type(exc).__name__}: {exc}"[:300],
            )

    # -- preemption: consume the warning ----------------------------------
    def _begin_preempt(
        self, idx: int, info: Dict[str, Any], now: float
    ) -> None:
        """A preemption notice landed: exclude the replica, pre-spawn
        its replacement, and run the graceful drain (finish-in-grace +
        live-migrate) — all inside the grace window."""
        remaining = float(info.get("remaining_s") or 0.0)
        with self._lock:
            st = self._replicas[idx]
            st["state"] = PREEMPTING
            st["verdict"] = PREEMPTING
            st["preempt_deadline"] = now + remaining
            st["preemptions"] += 1
        self._m_preempts.inc(1, replica=idx)
        self._event(
            "replica_preempting", level="warn", replica=idx,
            remaining_s=round(remaining, 3),
            source=str(info.get("source", "")),
            member=str(info.get("member", "replica")),
        )
        try:
            self.client.exclude(idx)
        except Exception:  # noqa: BLE001 - routing is advisory here;
            pass  # the drain below excludes again
        # Drain FIRST (one RPC + one scheduler step: the cheap, urgent
        # move — migrated requests are safe on survivors within
        # milliseconds of the notice), THEN pre-spawn the replacement
        # (slow: a fresh engine build) with the rest of the window —
        # the in-grace finishers keep streaming off the dying replica
        # throughout, and the swap at drain end is instant.
        drain = getattr(self.client, "preempt_drain", None)
        if drain is not None:
            try:
                res = drain(idx, budget_s=remaining)
            except Exception as exc:  # noqa: BLE001 - a failed drain
                # degrades to crash semantics at the deadline, never
                # worse.
                self._event(
                    "preempt_drain_error", level="error", replica=idx,
                    error=f"{type(exc).__name__}: {exc}"[:300],
                )
            else:
                self._event(
                    "replica_preempt_drained", replica=idx,
                    finished_in_grace=len(res.get("finish", [])),
                    migrated=len(res.get("migrated", [])),
                    lost=len(res.get("lost", [])),
                    kv_blocks=int(res.get("kv_blocks", 0)),
                )
        # Pre-spawn DURING the grace window so fleet capacity never
        # dips below N. Failure only costs the pre-spawn (a normal
        # respawn still runs at finalize).
        prespawn = getattr(self.client, "prespawn_replacement", None)
        can = getattr(self.client, "can_respawn", lambda: False)()
        if prespawn is not None and can:
            try:
                prespawn(idx)
            except Exception as exc:  # noqa: BLE001 - see above
                self._event(
                    "replica_prespawn_failed", level="warn", replica=idx,
                    error=f"{type(exc).__name__}: {exc}"[:300],
                )

    def _continue_preempt(
        self, idx: int, now: float, summary: Dict[str, Any]
    ) -> None:
        """PREEMPTING follow-up ticks: wait while in-grace requests
        stream off the dying replica, then swap the replacement in (at
        zero routed requests, early death, or the deadline — whichever
        comes first)."""
        alive_fn = getattr(self.client, "replica_is_alive", None)
        alive = bool(alive_fn(idx)) if alive_fn is not None else True
        open_fn = getattr(self.client, "requests_on", None)
        open_count = int(open_fn(idx)) if open_fn is not None else 0
        with self._lock:
            st = self._replicas[idx]
            deadline = float(st["preempt_deadline"] or 0.0)
        if alive and open_count > 0 and now < deadline:
            return  # still finishing in-grace work
        if not alive or open_count > 0:
            # Died early, or the deadline caught unfinished work: those
            # requests fail over NOW (idempotent — the streaming path
            # may already have moved them).
            try:
                self.client.on_replica_lost(
                    idx, reason="preempted (grace expired)"
                    if alive else "preempted (died in grace window)"
                )
            except Exception as exc:  # noqa: BLE001 - keep replacing
                self._event(
                    "failover_error", level="error", replica=idx,
                    error=f"{type(exc).__name__}: {exc}"[:300],
                )
            summary["failed_over"] += 1
        if not getattr(self.client, "can_respawn", lambda: False)():
            with self._lock:
                st["state"] = FAILED
                st["preempt_deadline"] = None
            self._event(
                "replica_restart_giveup", level="error", replica=idx,
                attempts=0,
            )
            return
        try:
            self.client.respawn_replica(idx)
        except Exception as exc:  # noqa: BLE001 - fall back to the
            # normal dead/backoff machinery.
            with self._lock:
                st["state"] = DEAD
                st["verdict"] = DEAD
                st["last_error"] = f"{type(exc).__name__}: {exc}"[:300]
                st["attempts"] = 0
                st["next_restart_t"] = now + self._backoff(0)
                st["preempt_deadline"] = None
            summary["restart_failures"] += 1
            self._event(
                "replica_restart_failed", level="warn", replica=idx,
                attempt=0, error=str(exc)[:300],
            )
            return
        with self._lock:
            st["state"] = HEALTHY
            st["verdict"] = HEALTHY
            st["restarts"] += 1
            st["attempts"] = 0
            st["last_error"] = None
            st["preempt_deadline"] = None
        summary["restarted"] += 1
        self._m_restarts.inc(1, replica=idx)
        self._event("replica_preempt_replaced", replica=idx)

    def _try_restart(
        self, idx: int, now: float, summary: Dict[str, Any]
    ) -> None:
        can = getattr(self.client, "can_respawn", lambda: False)()
        with self._lock:
            st = self._replicas[idx]
            if not can or self.restart_limit == 0:
                st["state"] = FAILED
                return
            if now < st["next_restart_t"]:
                return
            if st["attempts"] >= self.restart_limit:
                st["state"] = FAILED
                self._event(
                    "replica_restart_giveup", level="error",
                    replica=idx, attempts=st["attempts"],
                )
                return
            st["state"] = RESTARTING
            st["attempts"] += 1
            attempts = st["attempts"]
        try:
            self.client.respawn_replica(idx)
        except Exception as exc:  # noqa: BLE001 - a failed restart is a
            # scheduled event too: back off and try again.
            with self._lock:
                st["state"] = DEAD
                st["last_error"] = f"{type(exc).__name__}: {exc}"[:300]
                st["next_restart_t"] = now + self._backoff(attempts)
            summary["restart_failures"] += 1
            self._event(
                "replica_restart_failed", level="warn", replica=idx,
                attempt=attempts, error=str(exc)[:300],
            )
            return
        with self._lock:
            st["state"] = HEALTHY
            st["verdict"] = HEALTHY
            st["restarts"] += 1
            st["attempts"] = 0
            st["last_error"] = None
        summary["restarted"] += 1
        self._m_restarts.inc(1, replica=idx)
        self._event(
            "replica_restarted", replica=idx, attempt=attempts,
        )

    def _publish_states(self) -> None:
        with self._lock:
            for idx, st in self._replicas.items():
                self._m_state.set(
                    _STATE_SCORE.get(st["state"], 0.0), replica=idx
                )

    # -- read side ---------------------------------------------------------
    def rows(self) -> List[Dict[str, Any]]:
        """The supervisor table (one row per replica). Rows carry the
        replica's ROLE (prefill/decode/mixed) — a respawn re-runs the
        retained per-index recipe, so a restarted prefill replica comes
        back a prefill replica, and the table shows what it is."""
        role_fn = getattr(self.client, "role_of", None)
        with self._lock:
            return [
                {
                    "replica": idx,
                    "state": st["state"],
                    "verdict": st["verdict"],
                    "role": (
                        str(role_fn(idx))
                        if role_fn is not None else "mixed"
                    ),
                    "restarts": st["restarts"],
                    "attempts": st["attempts"],
                    "preemptions": st["preemptions"],
                    "last_error": st["last_error"],
                }
                for idx, st in sorted(self._replicas.items())
            ]

    # -- thread lifecycle --------------------------------------------------
    def start(self) -> "FleetSupervisor":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="serve-supervisor", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception as exc:  # noqa: BLE001 - the recovery loop
                # must outlive anything it recovers from.
                self._event(
                    "tick_error", level="error",
                    error=f"{type(exc).__name__}: {exc}"[:300],
                )
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
