"""Watchdog + SLO engine: passive telemetry in, per-component verdicts out.

The PyTorch port's copy of ``ray_lightning_tpu/obs/health.py``. A :class:`Watchdog` runs a set of CHECK functions —
each returns one or more :class:`ComponentHealth` verdicts
(``healthy | degraded | unhealthy`` with reasons) — and turns the
results into:

- ``rlt_health{component=...}`` gauges (0/1/2) in the metrics registry,
- ``verdict_change`` events in the process event log on every
  transition,
- an ``on_unhealthy`` callback on the healthy→unhealthy edge (the
  flight-recorder trigger, see :mod:`obs.blackbox`),
- a :class:`HealthReport` that backs the real ``/healthz``: 200 while
  nothing is ``unhealthy``, 503 with the JSON report otherwise
  (``degraded`` stays 200 — an LB should not pull a slow-but-serving
  replica).

The built-in check factories only READ state the hot paths already
publish (registry counters, gauges, heartbeat snapshots, engine slot
counts) — the watchdog adds no instrumentation cost to the fold loop.

Stall detection is flatline-based (:class:`Flatline`): a monotonically
advancing reading (tokens emitted, admits, optimizer steps) that stops
advancing while there is work to advance it is a stall. Every check
takes an injectable ``clock`` so the state machine is unit-testable
without sleeping.

SLO rules are declarative upper bounds evaluated against the serve
metrics snapshot (``--serve.slo.ttft_p95_s 0.5`` means "ttft_p95_s must
stay below 0.5"); each breach increments
``rlt_slo_breaches_total{rule=...}``, records an event, and marks the
rule's component unhealthy until the metric recovers.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional

from ray_lightning_tpu_torch.obs.events import EventLog, get_event_log
from ray_lightning_tpu_torch.obs.registry import MetricsRegistry, get_registry

HEALTHY = "healthy"
DEGRADED = "degraded"
UNHEALTHY = "unhealthy"

_RANK = {HEALTHY: 0, DEGRADED: 1, UNHEALTHY: 2}
_LEVEL = {HEALTHY: "info", DEGRADED: "warn", UNHEALTHY: "error"}


@dataclass
class ComponentHealth:
    """One component's verdict with human-readable reasons."""

    component: str
    verdict: str = HEALTHY
    reasons: List[str] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {"verdict": self.verdict, "reasons": list(self.reasons)}


@dataclass
class HealthReport:
    """All components' verdicts at one evaluation instant."""

    components: Dict[str, ComponentHealth]
    ts: float = 0.0

    @property
    def verdict(self) -> str:
        """Worst component verdict (healthy when nothing reported)."""
        worst = HEALTHY
        for ch in self.components.values():
            if _RANK[ch.verdict] > _RANK[worst]:
                worst = ch.verdict
        return worst

    @property
    def healthy(self) -> bool:
        """The /healthz bit: False only on ``unhealthy`` (degraded still
        serves — an LB should not pull it)."""
        return self.verdict != UNHEALTHY

    def reasons(self) -> List[str]:
        return [
            f"{name}: {reason}"
            for name, ch in sorted(self.components.items())
            for reason in ch.reasons
        ]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "verdict": self.verdict,
            "healthy": self.healthy,
            "reasons": self.reasons(),
            "components": {
                name: ch.to_dict()
                for name, ch in sorted(self.components.items())
            },
            "ts": self.ts,
        }


class Flatline:
    """Seconds since a monotonically-advancing reading last changed.

    The stall primitive: ``seconds_flat()`` re-reads the value and
    returns how long it has been unchanged. ``reset()`` restarts the
    clock (used when the precondition for a stall — active work — goes
    away, so idle time never counts toward a stall).
    """

    def __init__(
        self,
        read: Callable[[], Any],
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._read = read
        self._clock = clock
        self._last_val: Any = None
        self._last_change: Optional[float] = None

    def seconds_flat(self) -> float:
        val = self._read()
        now = self._clock()
        if self._last_change is None or val != self._last_val:
            self._last_val = val
            self._last_change = now
        return now - self._last_change

    def reset(self) -> None:
        self._last_change = None


# ---------------------------------------------------------------------------
# Check factories (each returns a zero-arg callable yielding verdicts)
# ---------------------------------------------------------------------------
def heartbeat_check(
    heartbeats_fn: Callable[[], Dict[str, Dict[str, Any]]],
    interval_s: Optional[float] = None,
    suspect_k: float = 3.0,
    dead_k: float = 6.0,
) -> Callable[[], List[ComponentHealth]]:
    """Fabric worker liveness from heartbeat ages: a worker whose last
    push is older than ``suspect_k x interval`` is suspect (degraded),
    older than ``dead_k x interval`` is presumed dead (unhealthy).
    ``interval_s`` defaults to ``RLT_HEARTBEAT_S`` (the push cadence the
    workers actually use)."""
    if interval_s is None:
        try:
            interval_s = float(os.environ.get("RLT_HEARTBEAT_S", "10"))
        except ValueError:
            interval_s = 10.0
        if interval_s <= 0:
            interval_s = 10.0

    def check() -> List[ComponentHealth]:
        out = []
        for actor_id, hb in heartbeats_fn().items():
            age = float(hb.get("age_s", 0.0) or 0.0)
            name = f"fabric:{actor_id}"
            if age > dead_k * interval_s:
                out.append(ComponentHealth(name, UNHEALTHY, [
                    f"no heartbeat for {age:.1f}s "
                    f"(> {dead_k:g}x the {interval_s:g}s interval); "
                    "worker presumed dead or hung"
                ]))
            elif age > suspect_k * interval_s:
                out.append(ComponentHealth(name, DEGRADED, [
                    f"heartbeat is {age:.1f}s old "
                    f"(> {suspect_k:g}x the {interval_s:g}s interval); "
                    "worker suspect"
                ]))
            else:
                out.append(ComponentHealth(name))
        return out

    return check


def engine_stall_check(
    num_active_fn: Callable[[], int],
    tokens_fn: Callable[[], float],
    stall_s: float,
    clock: Callable[[], float] = time.monotonic,
) -> Callable[[], List[ComponentHealth]]:
    """Decode engine stall: active slots but the emitted-token counter
    flat for ``stall_s`` — the device (or the loop driving it) stopped
    making progress. Idle engines reset the flatline."""
    flat = Flatline(tokens_fn, clock)

    def check() -> List[ComponentHealth]:
        stalled = flat.seconds_flat()
        if num_active_fn() <= 0:
            flat.reset()
            return [ComponentHealth("engine")]
        if stalled > stall_s:
            return [ComponentHealth("engine", UNHEALTHY, [
                f"{num_active_fn()} active slot(s) with no fold progress "
                f"for {stalled:.1f}s (stall_s={stall_s:g})"
            ])]
        return [ComponentHealth("engine")]

    return check


def admission_wedge_check(
    queue_depth_fn: Callable[[], int],
    admits_fn: Callable[[], float],
    stall_s: float,
    free_slots_fn: Optional[Callable[[], int]] = None,
    clock: Callable[[], float] = time.monotonic,
) -> Callable[[], List[ComponentHealth]]:
    """Admission wedge: queued requests with a flat admit counter for
    ``stall_s``. ``free_slots_fn`` gates the verdict on capacity being
    available — a full engine legitimately admits nothing while its
    residents decode (that case is the engine-stall check's to judge)."""
    flat = Flatline(admits_fn, clock)

    def check() -> List[ComponentHealth]:
        stalled = flat.seconds_flat()
        depth = queue_depth_fn()
        if depth <= 0 or (
            free_slots_fn is not None and free_slots_fn() <= 0
        ):
            flat.reset()
            return [ComponentHealth("scheduler")]
        if stalled > stall_s:
            return [ComponentHealth("scheduler", UNHEALTHY, [
                f"{depth} queued request(s) with no admission for "
                f"{stalled:.1f}s despite free slots (stall_s={stall_s:g})"
            ])]
        return [ComponentHealth("scheduler")]

    return check


def compile_storm_check(
    compiles_fn: Callable[[], float],
    window_s: float = 60.0,
    clock: Callable[[], float] = time.monotonic,
) -> Callable[[], List[ComponentHealth]]:
    """Compile storm: the steady-state compile counter (a replica's
    ``compiles_since_init``: CUDA graphs captured since its engine was
    built) RISING means a shape leaked into the hot path and every
    occurrence pays a capture. Degraded while the
    counter moved within the last ``window_s`` — a transient flag that
    clears once the storm stops, while the total stays visible in the
    metrics."""
    flat = Flatline(compiles_fn, clock)

    def check() -> List[ComponentHealth]:
        stalled = flat.seconds_flat()
        total = compiles_fn()
        if total > 0 and stalled < window_s:
            return [ComponentHealth("compiler", DEGRADED, [
                f"compile storm: {total:g} steady-state compile(s), "
                f"last within {window_s:g}s — a shape is leaking into "
                "the hot path"
            ])]
        return [ComponentHealth("compiler")]

    return check


def fit_stall_check(
    telemetry: Any,
    stall_s: float,
    clock: Callable[[], float] = time.monotonic,
) -> Callable[[], List[ComponentHealth]]:
    """Trainer stall: mid-fit (telemetry live, fit not done) with no
    chunk recorded for ``stall_s``. Reads the ``TrainTelemetry``
    progress stamps the fit loop already maintains."""

    def check() -> List[ComponentHealth]:
        if getattr(telemetry, "fit_done", False):
            return [ComponentHealth("trainer")]
        last = getattr(telemetry, "last_progress_t", None)
        if last is None:
            last = getattr(telemetry, "created_t", None)
        if last is None:
            return [ComponentHealth("trainer")]
        stalled = clock() - last
        if stalled > stall_s:
            return [ComponentHealth("trainer", UNHEALTHY, [
                f"mid-fit with no optimizer step for {stalled:.1f}s "
                f"(stall_s={stall_s:g})"
            ])]
        return [ComponentHealth("trainer")]

    return check


# ---------------------------------------------------------------------------
# SLO rules
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SLORule:
    """One upper-bound objective: ``metric`` must stay below ``limit``."""

    metric: str
    limit: float

    @property
    def name(self) -> str:
        return f"{self.metric}<{self.limit:g}"


def parse_slo_rules(spec: Dict[str, Any]) -> List[SLORule]:
    """``{metric: limit}`` (the ``--serve.slo.<metric> <limit>`` form)
    into rules. Every SLO is an upper bound — latencies, error rates,
    expire rates all breach by exceeding."""
    return [
        SLORule(str(metric), float(limit))
        for metric, limit in sorted(spec.items())
    ]


def _derived(snap: Dict[str, Any]) -> Dict[str, Any]:
    """Augment a metrics snapshot with the rate metrics SLOs commonly
    bound: error_rate (cancelled+expired over terminal events) and
    expire_rate."""
    out = dict(snap)
    finished = float(snap.get("finished", 0) or 0)
    cancelled = float(snap.get("cancelled", 0) or 0)
    expired = float(snap.get("expired", 0) or 0)
    terminal = finished + cancelled + expired
    if terminal > 0:
        out.setdefault("error_rate", (cancelled + expired) / terminal)
        out.setdefault("expire_rate", expired / terminal)
    return out


def _breach_shares(snap: Dict[str, Any]) -> str:
    """Breach attribution from the snapshot's anatomy ``phases`` block:
    '"kv_fetch 58%, queue 22%" — the verdict names WHERE the breached
    latency went, not just that it breached. Empty when the ledger is
    off or has no window yet."""
    block = snap.get("phases")
    if not block:
        return ""
    from ray_lightning_tpu_torch.obs.anatomy import (
        breach_attribution, format_attribution,
    )

    return format_attribution(breach_attribution(block))


def slo_check(
    rules: Iterable[SLORule],
    snapshot_fn: Callable[[], Dict[str, Any]],
    registry: Optional[MetricsRegistry] = None,
    events: Optional[EventLog] = None,
) -> Callable[[], List[ComponentHealth]]:
    """Evaluate declarative SLO rules against the serve metrics
    snapshot. A breach marks ``slo:<metric>`` unhealthy, increments
    ``rlt_slo_breaches_total{rule=...}``, records an event, and — when
    the anatomy ledger has a ``phases`` window — appends the top
    contributing phases by share to the reason ("ttft_p95 breach:
    kv_fetch 58%, queue 22%"), so the attribution rides the
    ``verdict_change`` event and the ``/healthz`` body for free; a
    metric with no data yet is healthy (no traffic is not a breach)."""
    rules = list(rules)
    reg = registry or get_registry()
    breaches = reg.counter(
        "rlt_slo_breaches_total", "SLO rule breaches observed by the watchdog"
    )

    def check() -> List[ComponentHealth]:
        snap = _derived(snapshot_fn())
        out = []
        for rule in rules:
            observed = snap.get(rule.metric)
            name = f"slo:{rule.metric}"
            if observed is None:
                out.append(ComponentHealth(name))
                continue
            if float(observed) > rule.limit:
                breaches.inc(1, rule=rule.name)
                attribution = ""
                shares = _breach_shares(snap)
                if shares:
                    attribution = f"; top phases: {shares}"
                if events is not None:
                    events.record(
                        "health", "slo_breach", level="warn",
                        rule=rule.name, observed=float(observed),
                        **({"phases": shares} if shares else {}),
                    )
                out.append(ComponentHealth(name, UNHEALTHY, [
                    f"SLO breach: {rule.metric}={float(observed):g} "
                    f"exceeds {rule.limit:g}{attribution}"
                ]))
                continue
            out.append(ComponentHealth(name))
        return out

    return check


# ---------------------------------------------------------------------------
# The watchdog
# ---------------------------------------------------------------------------
class Watchdog:
    """Run checks, publish verdicts, fire the black box on the edge.

    ``evaluate()`` is the whole state machine: run every check, diff the
    verdicts against the previous evaluation, update the
    ``rlt_health{component=...}`` gauges, record ``verdict_change``
    events, and invoke ``on_unhealthy(component, report)`` once per
    transition INTO unhealthy (the flight-recorder hook). It is safe to
    call both from the background thread (``start()``) and on demand
    (an RPC/scrape wanting a fresh verdict) — evaluations serialize on
    an internal lock.
    """

    def __init__(
        self,
        checks: Iterable[Callable[[], List[ComponentHealth]]] = (),
        interval_s: float = 1.0,
        registry: Optional[MetricsRegistry] = None,
        events: Optional[EventLog] = None,
        on_unhealthy: Optional[Callable[[str, HealthReport], Any]] = None,
    ) -> None:
        self._checks: List[Callable[[], List[ComponentHealth]]] = list(checks)
        self.interval_s = float(interval_s)
        self._registry = registry or get_registry()
        self._events = events if events is not None else get_event_log()
        self._on_unhealthy = on_unhealthy
        self._gauge = self._registry.gauge(
            "rlt_health",
            "Component health verdict (0 healthy, 1 degraded, 2 unhealthy)",
        )
        # Re-entrant: an on_unhealthy hook (flight-recorder dump) may
        # legitimately read health while evaluate() holds the lock.
        self._lock = threading.RLock()
        self._last_verdicts: Dict[str, str] = {}
        self._report = HealthReport(components={}, ts=time.time())
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add_check(
        self, check: Callable[[], List[ComponentHealth]]
    ) -> "Watchdog":
        self._checks.append(check)
        return self

    def evaluate(self) -> HealthReport:
        with self._lock:
            components: Dict[str, ComponentHealth] = {}
            for check in self._checks:
                try:
                    results = check()
                except Exception as exc:  # noqa: BLE001 - a broken check
                    # must degrade the watchdog, never crash it.
                    results = [ComponentHealth(
                        "watchdog", DEGRADED, [f"check failed: {exc!r}"]
                    )]
                for ch in results:
                    components[ch.component] = ch
            report = HealthReport(components=components, ts=time.time())
            # Publish BEFORE firing transition hooks: an on_unhealthy
            # flight-recorder dump reads report() and must capture the
            # verdict that fired it, not the previous evaluation's.
            self._report = report
            # Publish gauges + transition events; fire on_unhealthy on
            # the healthy/degraded -> unhealthy edge only.
            for name, ch in components.items():
                self._gauge.set(_RANK[ch.verdict], component=name)
                prev = self._last_verdicts.get(name, HEALTHY)
                if ch.verdict != prev:
                    self._events.record(
                        "health", "verdict_change",
                        level=_LEVEL[ch.verdict],
                        component=name, was=prev, now=ch.verdict,
                        reason="; ".join(ch.reasons)[:300],
                    )
                    if (
                        ch.verdict == UNHEALTHY
                        and self._on_unhealthy is not None
                    ):
                        try:
                            self._on_unhealthy(name, report)
                        except Exception:  # noqa: BLE001 - forensics must
                            pass  # never take down the watchdog
            # Vanished components (dead actor removed from heartbeats):
            # drop their gauge series so the scrape doesn't report stale
            # verdicts forever — the same contract as the heartbeat
            # gauges in obs.telemetry.
            for name in set(self._last_verdicts) - set(components):
                self._gauge.remove(component=name)
            self._last_verdicts = {
                name: ch.verdict for name, ch in components.items()
            }
            return report

    def report(self) -> HealthReport:
        """The most recent evaluation (without forcing a new one)."""
        with self._lock:
            return self._report

    # -- background evaluator --------------------------------------------
    def start(self) -> "Watchdog":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="obs-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate()
            except Exception:  # noqa: BLE001 - keep the evaluator alive
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
