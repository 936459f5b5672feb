"""The port's recovery-plane controllers held against the JAX package's,
with no processes: ``FleetSupervisor`` and ``RouterAutoscaler`` of both
packages run the same script against the same scripted fake client, each
on its own injected clock, and after every tick their outputs, their
``rows()``, the ordered events they recorded, their registries and the
fake's call log must be equal.

The supervisor's fake mirrors ``_FakeClient`` of ``tests/test_failover.py``
and ``tests/test_preempt.py``; the autoscaler's mirrors ``_ScaleClient`` /
``_ViewStub`` of ``tests/test_router.py`` and ``tests/test_kvfleet.py``.
Event timestamps and sequence numbers are dropped from the records.
"""
import types

import pytest

import ray_lightning_tpu.serve.router as j_router
import ray_lightning_tpu.serve.supervisor as j_supervisor
from ray_lightning_tpu.obs.events import EventLog as JEventLog
from ray_lightning_tpu.obs.registry import MetricsRegistry as JRegistry
import ray_lightning_tpu_torch.serve.router as t_router
import ray_lightning_tpu_torch.serve.supervisor as t_supervisor
from ray_lightning_tpu_torch.obs.events import EventLog as TEventLog
from ray_lightning_tpu_torch.obs.registry import MetricsRegistry as TRegistry

PKGS = {
    "jax": types.SimpleNamespace(
        supervisor=j_supervisor, router=j_router, EventLog=JEventLog,
        Registry=JRegistry,
    ),
    "torch": types.SimpleNamespace(
        supervisor=t_supervisor, router=t_router, EventLog=TEventLog,
        Registry=TRegistry,
    ),
}


class ActorDiedError(RuntimeError):
    """The fake's dead-actor error (one class for both packages, so the
    supervisor's recorded reasons compare equal)."""


class _Clock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _events(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "seq")}
            for e in events.tail(512)]


def _both(script):
    """Run ``script(ns)`` (a list of per-tick records) against each
    package; equal tick by tick. Returns the port's records."""
    got = {name: script(ns) for name, ns in PKGS.items()}
    assert len(got["torch"]) == len(got["jax"])
    for k, (t, j) in enumerate(zip(got["torch"], got["jax"])):
        assert t == j, f"tick {k}: port {t} != JAX {j}"
    return got["torch"]


# ---------------------------------------------------------------------------
# FleetSupervisor
# ---------------------------------------------------------------------------
class _FakeClient:
    """Scripted ServeClient fault surface; every call is logged."""

    def __init__(self, n=2):
        self.n = n
        self.verdicts = {i: "healthy" for i in range(n)}
        self.alive = {i: True for i in range(n)}
        self.preempt = {i: None for i in range(n)}
        self.routed = {i: 0 for i in range(n)}
        self.retired = set()
        self.heartbeat_age = None
        self.respawn_fail = 0  # next N respawns raise
        self.drain_raises = None
        #: A gang follower's pending notice per replica (its heartbeat).
        self.gang_preempt = {i: None for i in range(n)}
        self.log = []

    @property
    def num_replicas(self):
        return self.n

    def _actor(self, idx):
        return None

    def is_retired(self, idx):
        return idx in self.retired

    def replica_is_alive(self, idx):
        self.log.append(("replica_is_alive", idx))
        return self.alive[idx]

    def replica_heartbeat_age(self, idx):
        self.log.append(("replica_heartbeat_age", idx))
        return self.heartbeat_age

    def health_one(self, idx, timeout=None):
        self.log.append(("health_one", idx, timeout))
        if not self.alive[idx]:
            raise ActorDiedError("dead")
        rep = {"verdict": self.verdicts[idx],
               "healthy": self.verdicts[idx] == "healthy"}
        if self.preempt[idx] is not None:
            rep["preempt"] = self.preempt[idx]
        return rep

    def gang_preempt_state(self, idx):
        self.log.append(("gang_preempt_state", idx))
        return self.gang_preempt[idx]

    def exclude(self, idx):
        self.log.append(("exclude", idx))

    def restore(self, idx):
        self.log.append(("restore", idx))

    def on_replica_lost(self, idx, reason=""):
        self.log.append(("on_replica_lost", idx, reason))
        return {"resubmitted": [], "lost": []}

    def can_respawn(self):
        return True

    def respawn_replica(self, idx):
        self.log.append(("respawn_replica", idx))
        if self.respawn_fail > 0:
            self.respawn_fail -= 1
            raise RuntimeError("respawn failed")
        self.alive[idx] = True
        self.verdicts[idx] = "healthy"
        self.preempt[idx] = None
        self.gang_preempt[idx] = None

    def prespawn_replacement(self, idx):
        self.log.append(("prespawn_replacement", idx))
        return True

    def preempt_drain(self, idx, budget_s=None):
        self.log.append(("preempt_drain", idx, budget_s))
        if self.drain_raises is not None:
            raise self.drain_raises
        return {"finish": ["f1"], "migrated": ["m1", "m2"], "lost": [],
                "kv_blocks": 3}

    def requests_on(self, idx):
        self.log.append(("requests_on", idx))
        return self.routed[idx]

    def role_of(self, idx):
        return "mixed"


def _run_supervisor(ns, steps, n=2, **kw):
    """Drive one package's supervisor through ``steps``: each a (time,
    mutation of the fake) pair followed by one tick. Records per tick."""
    fake = _FakeClient(n)
    clock = _Clock()
    events = ns.EventLog()
    reg = ns.Registry()
    kw.setdefault("restart_backoff_s", 1.0)
    kw.setdefault("restart_limit", 3)
    sup = ns.supervisor.FleetSupervisor(
        fake, registry=reg, events=events, clock=clock, **kw)
    out = []
    for t, mutate in steps:
        clock.t = t
        if mutate is not None:
            mutate(fake)
        fake.log.clear()
        summary = sup.tick()
        out.append({
            "summary": summary, "rows": sup.rows(), "calls": list(fake.log),
            "events": _events(events), "metrics": reg.to_dict(),
        })
    return out


def _set(**fields):
    """A mutation setting ``fake.<name>[idx] = value`` for each
    ``name=(idx, value)`` (or ``fake.<name> = value``)."""
    def mutate(fake):
        for name, value in fields.items():
            if isinstance(value, tuple):
                getattr(fake, name)[value[0]] = value[1]
            else:
                setattr(fake, name, value)
    return mutate


def _preempt(idx, remaining, source="fault"):
    return _set(preempt=(idx, {"pending": True, "remaining_s": remaining,
                               "source": source}))


SUPERVISOR_SCRIPTS = {
    # tests/test_failover.py::test_supervisor_drains_unhealthy_and_restores_on_recovery
    "unhealthy_then_recovered": dict(steps=[
        (0.0, _set(verdicts=(1, "unhealthy"))),
        (0.5, None),
        (1.0, _set(verdicts=(1, "healthy"))),
    ]),
    # ::test_supervisor_restarts_dead_replica_with_capped_backoff
    "death_capped_backoff": dict(
        steps=[
            (0.0, _set(alive=(0, False))),
            (1.0, None),
            (2.5, _set(respawn_fail=1)),
            (4.0, None),
            (7.0, None),
            (8.0, None),
        ],
        restart_backoff_s=2.0, restart_backoff_cap_s=5.0,
    ),
    # ::test_supervisor_respects_restart_limit_then_gives_up
    "restart_limit": dict(
        steps=[(0.0, _set(alive=(0, False), respawn_fail=10))]
        + [(float(k), None) for k in range(1, 11)],
        n=1, restart_limit=2, restart_backoff_s=0.1,
        restart_backoff_cap_s=0.1,
    ),
    # ::test_supervisor_heartbeat_flatline_is_a_death_verdict
    "heartbeat_flatline": dict(
        steps=[(0.0, _set(heartbeat_age=999.0)), (0.5, None)],
        n=1, heartbeat_dead_s=60.0,
    ),
    # tests/test_preempt.py::test_supervisor_preempting_drains_prespawns_then_replaces
    "preempt_drain_prespawn_replace": dict(steps=[
        (0.0, lambda f: (_preempt(0, 20.0)(f), _set(routed=(0, 2))(f))),
        (5.0, None),
        (6.0, _set(routed=(0, 0))),
        (7.0, None),
    ]),
    # ::test_supervisor_preempt_deadline_fails_over_leftovers
    "preempt_deadline": dict(steps=[
        (0.0, lambda f: (_preempt(0, 3.0, "sigterm")(f),
                         _set(routed=(0, 2))(f))),
        (2.0, None),
        (4.0, None),
    ]),
    # ::test_supervisor_preempt_early_death_degrades_to_crash_semantics
    "preempt_early_death": dict(steps=[
        (0.0, lambda f: (_preempt(0, 30.0)(f), _set(routed=(0, 1))(f))),
        (1.0, _set(alive=(0, False))),
    ]),
    # tests/test_preempt.py::test_supervisor_gang_follower_preempt_drains_the_whole_gang
    "gang_follower_preempt": dict(steps=[
        (0.0, _set(gang_preempt=(0, {"pending": True, "remaining_s": 15.0,
                                     "source": "fault"}))),
        (1.0, _set(routed=(0, 0))),
    ]),
    # A failed drain degrades to crash semantics at the deadline.
    "preempt_drain_raises": dict(steps=[
        (0.0, lambda f: (_preempt(1, 2.0)(f), _set(routed=(1, 1))(f),
                         _set(drain_raises=RuntimeError("no plan"))(f))),
        (3.0, None),
    ]),
    # tests/test_router.py::test_supervisor_skips_retired_replicas
    "retired_is_not_dead": dict(steps=[
        (0.0, lambda f: (f.retired.add(1), _set(alive=(1, False))(f))),
        (5.0, None),
    ]),
}


@pytest.mark.parametrize("script", sorted(SUPERVISOR_SCRIPTS))
def test_supervisor_matches_jax(script):
    kw = dict(SUPERVISOR_SCRIPTS[script])
    steps = kw.pop("steps")
    rec = _both(lambda ns: _run_supervisor(ns, steps, **kw))
    last = rec[-1]["rows"]
    # The JAX suite's own expectations, on the shared record.
    if script == "death_capped_backoff":
        assert [r["calls"].count(("respawn_replica", 0)) for r in rec] == [
            0, 0, 1, 0, 1, 0]
        assert last[0]["state"] == "healthy" and last[0]["restarts"] == 1
    if script == "restart_limit":
        assert sum(r["calls"].count(("respawn_replica", 0))
                   for r in rec) == 2
        assert last[0]["state"] == "failed"
    if script == "heartbeat_flatline":
        assert "no fabric heartbeat" in rec[0]["rows"][0]["last_error"]
    if script == "preempt_drain_prespawn_replace":
        assert rec[0]["rows"][0]["state"] == "preempting"
        assert last[0]["state"] == "healthy" and last[0]["restarts"] == 1
    if script == "gang_follower_preempt":
        assert [r["state"] for r in rec[0]["rows"]] == ["preempting",
                                                        "healthy"]
        assert ("preempt_drain", 0, 15.0) in rec[0]["calls"]
        (ev,) = [e for e in rec[0]["events"]
                 if e["name"] == "replica_preempting"]
        assert ev["member"] == "follower"
        assert ("respawn_replica", 0) in rec[1]["calls"]
    if script == "retired_is_not_dead":
        assert [r["state"] for r in last] == ["healthy", "retired"]


def test_supervisor_thread_and_unported_poller():
    """start()/stop() run ticks on the daemon thread; ``poller=`` raises
    naming its ROADMAP item (the FleetPoller feed)."""
    import threading

    fake = _FakeClient(1)
    ticked = threading.Event()
    sup = t_supervisor.FleetSupervisor(
        fake, interval_s=0.01, registry=TRegistry(), events=TEventLog())
    orig = sup.tick
    sup.tick = lambda: (ticked.set(), orig())[1]
    assert sup.start() is sup and sup.start() is sup
    assert ticked.wait(10.0)
    sup.stop()
    assert sup._thread is None
    with pytest.raises(NotImplementedError, match="item 14"):
        t_supervisor.FleetSupervisor(fake, poller=object())


# ---------------------------------------------------------------------------
# RouterAutoscaler
# ---------------------------------------------------------------------------
class _ScaleClient:
    """The autoscaler's client surface (roles per index), logging every
    scale action."""

    def __init__(self, roles, role_knob=True):
        self.roles = list(roles)
        self.role_knob = role_knob
        self.log = []

    def alive_replicas(self):
        return list(range(len(self.roles)))

    def role_of(self, idx):
        return self.roles[idx]

    def add_replica(self, role=None):
        if not self.role_knob and role is not None:
            raise TypeError("add_replica() takes no role")
        self.log.append(("add_replica", role))
        self.roles.append(role or "mixed")
        return len(self.roles) - 1

    def retire_replica(self, idx, **kw):
        self.log.append(("retire_replica", idx))
        self.roles.pop(idx)
        return {"migrated": ["m"] if idx else [], "lost": []}


class _ViewStub:
    """Router stand-in: per-index views and the shed counter."""

    def __init__(self, rows):
        self.rows = rows
        self.shed_count = 0

    def views(self):
        return {i: dict(r) for i, r in enumerate(self.rows)}


def _run_autoscaler(ns, roles, rows, steps, **kw):
    client = _ScaleClient(roles, role_knob=kw.pop("role_knob", True))
    stub = _ViewStub(rows)
    events = ns.EventLog()
    reg = ns.Registry()
    auto = ns.router.RouterAutoscaler(
        client, router=stub, registry=reg, events=events, **kw)
    out = []
    for mutate in steps:
        if mutate is not None:
            mutate(stub, client)
        client.log.clear()
        res = auto.tick()
        out.append({
            "tick": res, "calls": list(client.log),
            "events": _events(events), "metrics": reg.to_dict(),
            "ups": auto.scale_ups, "downs": auto.scale_downs,
        })
    return out


def _uniform(n, queue, active=0):
    return [{"queue_depth": queue, "active_slots": active}
            for _ in range(n)]


def _queue(q, active=0):
    def mutate(stub, client):
        stub.rows[:] = _uniform(max(8, len(client.roles)), q, active)
    return mutate


def _shed(n):
    def mutate(stub, client):
        stub.shed_count = n
    return mutate


def _breaches(k):
    def mutate(stub, client):
        stub.rows[0]["slo_breaches"] = k
    return mutate


AUTOSCALER_SCRIPTS = {
    # tests/test_router.py::test_autoscaler_scales_up_and_down_within_bounds
    "bounds": dict(
        roles=["mixed"], rows=_uniform(8, 0),
        steps=[_queue(16)] + [None] * 9 + [_queue(0), _shed(5)]
        + [_queue(0)] * 10,
        min_replicas=1, max_replicas=3, sustain_ticks=2,
        down_sustain_ticks=3, role_knob=False,
    ),
    # tests/test_router.py::test_autoscaler_end_to_end_scale_up_then_graceful_retire,
    # its controller half: a burst against one replica (per-replica queue
    # >= 1 on a single sustained tick) adds one, an idle fleet retires it
    # and min_replicas holds afterwards.
    "burst_then_idle": dict(
        roles=["mixed"], rows=_uniform(8, 0),
        steps=[_queue(6, 2), _queue(3, 2), _queue(0, 2), _queue(0),
               None, None, None],
        min_replicas=1, max_replicas=2, sustain_ticks=1,
        down_sustain_ticks=1, up_queue_per_replica=1.0,
    ),
    # tests/test_kvfleet.py::test_autoscaler_scales_role_pools_independently
    "role_pools": dict(
        roles=["prefill", "decode"],
        rows=[{"role": "prefill", "queue_depth": 20, "active_slots": 1},
              {"role": "decode", "queue_depth": 0, "active_slots": 0}],
        steps=[None, None, None, None],
        min_replicas=2, max_replicas=4, sustain_ticks=2,
    ),
    # tests/test_kvfleet.py::test_autoscaler_scales_up_on_slo_breach_rate
    "slo_breaches": dict(
        roles=["mixed"],
        rows=[{"queue_depth": 0, "active_slots": 1, "slo_breaches": 0}],
        steps=[None, _breaches(2), _breaches(4)],
        min_replicas=1, max_replicas=2, sustain_ticks=2,
    ),
}


@pytest.mark.parametrize("script", sorted(AUTOSCALER_SCRIPTS))
def test_autoscaler_matches_jax(script):
    kw = dict(AUTOSCALER_SCRIPTS[script])
    roles, rows, steps = kw.pop("roles"), kw.pop("rows"), kw.pop("steps")
    rec = _both(lambda ns: _run_autoscaler(
        ns, list(roles), [dict(r) for r in rows], steps, **dict(kw)))
    scaled = [r["tick"]["scaled"] for r in rec if r["tick"]["scaled"]]
    # The JAX suites' own expectations, on the shared record.
    if script == "bounds":
        assert scaled == [("up", 1), ("up", 2), ("down", 2), ("down", 1)]
        assert rec[-1]["ups"] == 2 and rec[-1]["downs"] == 2
    if script == "burst_then_idle":
        assert scaled == [("up", 1), ("down", 1)]
        assert rec[-1]["tick"]["replicas"] == 1
    if script == "role_pools":
        assert rec[1]["calls"] == [("add_replica", "prefill")]
    if script == "slo_breaches":
        assert rec[1]["tick"]["slo_breach_delta"] == 2
        assert scaled and scaled[0][0] == "up"


def test_autoscaler_bounds_and_thread():
    with pytest.raises(ValueError, match="min_replicas"):
        t_router.RouterAutoscaler(object(), min_replicas=0)
    with pytest.raises(ValueError, match="max_replicas"):
        t_router.RouterAutoscaler(object(), min_replicas=2, max_replicas=1)
    client = _ScaleClient(["mixed"])
    auto = t_router.RouterAutoscaler(
        client, router=_ViewStub(_uniform(8, 0)), interval_s=0.01,
        registry=TRegistry(), events=TEventLog())
    assert auto.start() is auto
    auto.stop()
    assert auto._thread is None
