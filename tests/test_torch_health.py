"""The port's watchdog, SLO rules, flight recorder and preemption monitor
held against the JAX package's on the same synthetic signals with injected
clocks: every check's verdicts and reasons, the watchdog's gauges, events
and unhealthy hook, the SLO breach counters, a bundle's files and their
contents, the recorder's rate limit and retention, and the monitor's
state transitions. Each scenario runs once against each package and the
two records must be equal.
"""
import json
import os
import signal
import time
import types

import pytest

from ray_lightning_tpu.obs import blackbox as j_blackbox
from ray_lightning_tpu.obs import health as j_health
from ray_lightning_tpu.obs.events import EventLog as JEventLog
from ray_lightning_tpu.obs.registry import MetricsRegistry as JRegistry
from ray_lightning_tpu.obs.trace import RequestTracer as JTracer
from ray_lightning_tpu.serve import preempt as j_preempt
from ray_lightning_tpu_torch.obs import blackbox as t_blackbox
from ray_lightning_tpu_torch.obs import health as t_health
from ray_lightning_tpu_torch.obs.events import EventLog as TEventLog
from ray_lightning_tpu_torch.obs.registry import MetricsRegistry as TRegistry
from ray_lightning_tpu_torch.obs.trace import RequestTracer as TTracer
from ray_lightning_tpu_torch.serve import preempt as t_preempt

PKGS = {
    "jax": types.SimpleNamespace(
        health=j_health, blackbox=j_blackbox, preempt=j_preempt,
        EventLog=JEventLog, Registry=JRegistry, Tracer=JTracer,
    ),
    "torch": types.SimpleNamespace(
        health=t_health, blackbox=t_blackbox, preempt=t_preempt,
        EventLog=TEventLog, Registry=TRegistry, Tracer=TTracer,
    ),
}


def _both(scenario, *args):
    got = {name: scenario(ns, *args) for name, ns in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _report(rep):
    """A health report without its wall-clock stamp."""
    return {k: v for k, v in rep.to_dict().items() if k != "ts"}


def _verdicts(results):
    return [(c.component, c.verdict, list(c.reasons)) for c in results]


def _events(log, name=None):
    return [{k: v for k, v in e.items() if k not in ("ts", "seq")}
            for e in log.tail(64, name=name)]


# ---------------------------------------------------------------------------
# The checks, on a virtual clock
# ---------------------------------------------------------------------------
def _stall_case(ns):
    state = {"active": 0, "tokens": 0, "t": 0.0}
    check = ns.health.engine_stall_check(
        lambda: state["active"], lambda: state["tokens"], stall_s=5.0,
        clock=lambda: state["t"],
    )
    out = [_verdicts(check())]
    for step in ({"t": 100.0, "active": 1}, {"t": 106.0}, {"tokens": 7},
                 {"t": 200.0}, {"active": 0, "t": 300.0}):
        state.update(step)
        out.append(_verdicts(check()))
    return out


def _wedge_case(ns):
    state = {"depth": 0, "admits": 0, "free": 1, "t": 0.0}
    check = ns.health.admission_wedge_check(
        lambda: state["depth"], lambda: state["admits"], stall_s=5.0,
        free_slots_fn=lambda: state["free"], clock=lambda: state["t"],
    )
    out = [_verdicts(check())]
    for step in ({"depth": 3, "t": 10.0}, {"t": 16.0}, {"free": 0},
                 {"free": 1, "admits": 1}, {"t": 40.0}):
        state.update(step)
        out.append(_verdicts(check()))
    return out


def _heartbeat_case(ns):
    hb = {"w0": {"age_s": 0.5}, "w1": {"age_s": 0.5}}
    check = ns.health.heartbeat_check(lambda: hb, interval_s=1.0,
                                      suspect_k=3.0, dead_k=6.0)
    out = [_verdicts(check())]
    hb["w0"]["age_s"] = 4.0
    hb["w1"]["age_s"] = 10.0
    out.append(_verdicts(check()))
    del hb["w1"]
    out.append(_verdicts(check()))
    return out


def _compile_storm_case(ns):
    state = {"compiles": 0, "t": 0.0}
    check = ns.health.compile_storm_check(
        lambda: state["compiles"], window_s=10.0, clock=lambda: state["t"])
    out = [_verdicts(check())]
    for step in ({"compiles": 3, "t": 1.0}, {"t": 5.0}, {"t": 20.0},
                 {"compiles": 4, "t": 21.0}):
        state.update(step)
        out.append(_verdicts(check()))
    return out


def _fit_stall_case(ns):
    tel = types.SimpleNamespace(fit_done=False, last_progress_t=None,
                                created_t=10.0)
    now = {"t": 10.0}
    check = ns.health.fit_stall_check(tel, stall_s=5.0,
                                      clock=lambda: now["t"])
    out = [_verdicts(check())]
    now["t"] = 16.0
    out.append(_verdicts(check()))
    tel.last_progress_t = 15.5
    out.append(_verdicts(check()))
    now["t"] = 80.0
    out.append(_verdicts(check()))
    tel.fit_done = True
    out.append(_verdicts(check()))
    return out


def _slo_case(ns):
    reg = ns.Registry()
    log = ns.EventLog()
    spec = {"ttft_p95_s": 0.1, "error_rate": 0.25, "step_time_p95_s": "2"}
    rules = ns.health.parse_slo_rules(spec)
    snap = {"ttft_p95_s": 0.5, "finished": 1, "cancelled": 2, "expired": 1,
            "phases": {"window": 4, "phases": {
                "queue": {"p95_s": 0.3, "share": 0.6},
                "prefill": {"p95_s": 0.2, "share": 0.4}}}}
    check = ns.health.slo_check(rules, lambda: dict(snap), registry=reg,
                                events=log)
    out = [[(r.metric, r.limit, r.name) for r in rules], _verdicts(check())]
    snap.update(ttft_p95_s=0.05, finished=100)
    out.append(_verdicts(check()))
    out.append(reg.counter("rlt_slo_breaches_total").samples())
    out.append(_events(log, "slo_breach"))
    out.append(_verdicts(ns.health.slo_check(rules, dict, registry=reg)()))
    out.append(_try(lambda: ns.health.parse_slo_rules({"x": "fast"})))
    return out


def _try(fn):
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 - the record compares it
        return type(exc).__name__


def _watchdog_case(ns):
    reg = ns.Registry()
    log = ns.EventLog()
    state = {"verdict": ns.health.HEALTHY, "present": True}
    fired = []

    def check():
        if not state["present"]:
            return []
        return [ns.health.ComponentHealth("engine", state["verdict"],
                                          ["injected"])]

    def broken():
        raise RuntimeError("check blew up")

    wd = ns.health.Watchdog(
        checks=[check], registry=reg, events=log,
        on_unhealthy=lambda comp, rep: fired.append(comp),
    )
    gauge = reg.gauge("rlt_health")
    out = [_report(wd.evaluate()), gauge.value(component="engine")]
    state["verdict"] = ns.health.UNHEALTHY
    rep = wd.evaluate()
    out += [_report(rep), rep.reasons(), gauge.value(component="engine"),
            list(fired)]
    wd.evaluate()
    state["verdict"] = ns.health.DEGRADED
    out.append(_report(wd.evaluate()))
    wd.add_check(broken)
    out.append(_report(wd.evaluate()))
    state["present"] = False
    out.append(_report(wd.evaluate()))
    out += [list(fired), _events(log, "verdict_change"),
            _report(wd.report())]
    return out


CHECK_CASES = {
    "engine_stall": _stall_case,
    "admission_wedge": _wedge_case,
    "heartbeat": _heartbeat_case,
    "compile_storm": _compile_storm_case,
    "fit_stall": _fit_stall_case,
    "slo": _slo_case,
    "watchdog": _watchdog_case,
}


@pytest.mark.parametrize("case", sorted(CHECK_CASES))
def test_health_checks_match_jax(case):
    rec = _both(CHECK_CASES[case])
    if case == "engine_stall":
        assert rec[2][0][1] == "unhealthy"
    if case == "slo":
        assert {v for _, v, _ in rec[1]} == {"unhealthy", "healthy"}


def test_flatline_matches_jax():
    def scenario(ns):
        state = {"v": 0, "t": 0.0}
        flat = ns.health.Flatline(lambda: state["v"], lambda: state["t"])
        out = []
        for step in ({"t": 1.0}, {"t": 3.0}, {"v": 2, "t": 4.0},
                     {"t": 9.5}):
            state.update(step)
            out.append(flat.seconds_flat())
        flat.reset()
        state["t"] = 12.0
        out.append(flat.seconds_flat())
        return out

    assert _both(scenario)[-1] == 0.0


# ---------------------------------------------------------------------------
# The flight recorder
# ---------------------------------------------------------------------------
def _bundle_case(ns, root):
    reg = ns.Registry()
    reg.counter("rlt_bundle_test_total").inc(3)
    log = ns.EventLog()
    log.record("serve", "admit_burst", n=2)
    tracer = ns.Tracer()
    tracer.event("r1", "submit")
    tracer.event("r1", "finish")
    outdir = os.path.join(root, ns.health.__name__.split(".")[0])
    manifest = ns.blackbox.dump_bundle(
        outdir, registry=reg, events=log, tracer=tracer,
        health={"verdict": "unhealthy", "reasons": ["engine: stalled"]},
        heartbeats={"w0": {"age_s": 1.0}}, config={"num_slots": 4},
        reason="test reason!",
    )
    d = manifest["dir"]
    files = ns.blackbox.read_bundle(d)
    same = {}
    for name in ("metrics.prom", "health.json", "heartbeats.json",
                 "config.json"):
        same[name] = files[name]
    same["events"] = [
        {k: v for k, v in json.loads(ln).items() if k not in ("ts", "seq")}
        for ln in files["events.jsonl"].splitlines() if ln.strip()
    ]
    same["trace_names"] = sorted(
        e.get("name") for e in json.loads(files["trace.json"])["traceEvents"]
    )
    same["stacks"] = "most recent call first" in files["stacks.txt"]
    same["versions_keys"] = sorted(
        k for k in json.loads(files["versions.json"])
        if k in ("python", "platform", "pid"))
    return [os.path.basename(d).split("-", 4)[4], sorted(manifest["files"]),
            manifest["errors"], manifest["reason"], same]


def test_dump_bundle_matches_jax(tmp_path):
    import torch  # noqa: F401 - versions.json reads torch once imported

    rec = _both(_bundle_case, str(tmp_path))
    assert rec[0] == "test-reason"
    versions = json.loads(t_blackbox.read_bundle(
        t_blackbox.dump_bundle(str(tmp_path / "v"), reason="v")["dir"]
    )["versions.json"])
    assert "jax" not in versions and "torch" in versions


def _recorder_case(ns, root):
    outdir = os.path.join(root, ns.health.__name__.split(".")[0])
    fr = ns.blackbox.FlightRecorder(outdir=outdir, keep=2,
                                    min_interval_s=3600.0,
                                    registry=ns.Registry())
    out = [fr.maybe_dump("first") is not None,
           fr.maybe_dump("suppressed") is None]
    fr.dump("second")  # on-demand dumps are not rate-limited
    fr.dump("third")
    out.append(len(fr.bundles()))  # pruned to keep=2
    return out


def test_flight_recorder_rate_limit_matches_jax(tmp_path):
    assert _both(_recorder_case, str(tmp_path)) == [True, True, 2]


# ---------------------------------------------------------------------------
# The preemption monitor
# ---------------------------------------------------------------------------
def _monitor_case(ns):
    now = {"t": 100.0}
    log = ns.EventLog()
    mon = ns.preempt.PreemptionMonitor(grace_s=30.0, clock=lambda: now["t"],
                                       events=log)
    fired = []
    mon.add_callback(lambda m: fired.append(m.remaining()))
    out = [mon.pending(), mon.remaining(), mon.state()]
    out.append(mon.notice(source="sigterm"))
    out.append(mon.notice(grace_s=500.0, source="metadata:TERMINATE"))
    now["t"] = 110.0
    out += [mon.state(), mon.remaining(), list(fired)]
    now["t"] = 200.0
    out.append(mon.remaining())
    mon.clear()
    out += [mon.pending(), mon.state()]
    out.append(mon.notice(grace_s=5.0, source="fault"))
    out += [mon.state(), _events(log)]
    return out


def test_preemption_monitor_matches_jax():
    rec = _both(_monitor_case)
    assert rec[3] == 130.0 and rec[4] == 130.0


def test_preemption_singleton_and_sigterm_match_jax():
    def scenario(ns):
        ns.preempt.reset_monitor()
        try:
            out = [ns.preempt.peek_state()]
            mon = ns.preempt.get_monitor(grace_s=3600.0)
            out.append(ns.preempt.get_monitor() is mon)
            out.append(mon.install_sigterm())
            try:
                signal.raise_signal(signal.SIGTERM)
                st = mon.state()
                out += [st["pending"], st["source"]]
            finally:
                mon.uninstall_sigterm()
            return out
        finally:
            ns.preempt.reset_monitor()

    assert _both(scenario) == [None, True, True, True, "sigterm"]


def test_metadata_poller_matches_jax():
    def scenario(ns):
        calls = {"n": 0}

        def fetch():
            calls["n"] += 1
            return None if calls["n"] < 3 else "TERMINATE_ON_HOST_MAINTENANCE"

        mon = ns.preempt.PreemptionMonitor(grace_s=60.0)
        mon.start_metadata_poller(fetch, interval_s=0.01)
        try:
            deadline = time.monotonic() + 10
            while not mon.pending() and time.monotonic() < deadline:
                time.sleep(0.01)
            return [mon.pending(), mon.state()["source"]]
        finally:
            mon.stop_metadata_poller()

    assert _both(scenario) == [True, "metadata:TERMINATE_ON_HOST_MAINTENANCE"]


def _stub_wedge(ns):
    """tests/test_health.py:526-606 on one package's scheduler: a
    host-only engine double (no paged, piggyback or prefill counters)
    admits, refuses while full, then wedges with capacity visible."""

    class _StubEngine:
        num_slots = 2
        max_seq = 1024
        decode_fold = 1
        tracer = None
        events = None

        def __init__(self):
            self._slots = [None, None]
            self.admit_enabled = True

        @property
        def num_active(self):
            return sum(1 for s in self._slots if s is not None)

        def free_slots(self):
            if not self.admit_enabled:
                return []
            return [i for i, s in enumerate(self._slots) if s is None]

        def check_prompt_len(self, n):
            pass

        def admit_many(self, reqs):
            out = []
            for req in reqs:
                slot = self.free_slots()[0]
                self._slots[slot] = [req["request_id"],
                                     req["max_new_tokens"] - 1]
                out.append((slot, 1, req["max_new_tokens"] == 1))
            return out

        def prefill_step(self, budget):
            return []

        def step(self):
            out = []
            for slot, st in enumerate(self._slots):
                if st is None:
                    continue
                st[1] -= 1
                done = st[1] <= 0
                out.append((slot, st[0], 1, done))
                if done:
                    self._slots[slot] = None
            return out

        def release(self, slot):
            self._slots[slot] = None

    reg, log = ns.Registry(), ns.EventLog()
    eng = _StubEngine()
    sched = ns.sched.Scheduler(
        eng, metrics=ns.metrics.ServeMetrics(2, registry=reg), events=log,
        max_prefills_per_step=2,
    )
    clock = {"t": 0.0}
    lifecycle = reg.counter("rlt_serve_requests_total")
    wd = ns.health.Watchdog(registry=reg, events=log)
    wd.add_check(ns.health.admission_wedge_check(
        sched.queue_depth, lambda: lifecycle.value(kind="admitted"),
        stall_s=5.0, free_slots_fn=lambda: len(eng.free_slots()),
        clock=lambda: clock["t"],
    ))
    sp = ns.sched.SamplingParams(max_new_tokens=3)
    rec = []
    sched.submit([1, 2, 3], sp, request_id="a")
    evs = sched.run_until_idle()
    rec += [[(e.request_id, e.token, e.done, e.reason) for e in evs],
            wd.evaluate().healthy, bool(log.tail(name="admit_burst"))]
    eng.admit_enabled = False
    sched.submit([1, 2, 3], sp, request_id="b")
    for _ in range(5):
        sched.step()
    clock["t"] = 10.0
    rec.append(wd.evaluate().healthy)  # full is not wedged
    eng.admit_enabled = True
    rec.append(sched.queue_depth())
    clock["t"] = 11.0
    wd.evaluate()
    clock["t"] = 20.0
    rec.append(wd.evaluate().components["scheduler"].verdict)
    evs = sched.run_until_idle()
    rec += [[(e.request_id, e.token, e.done, e.reason) for e in evs],
            wd.evaluate().healthy]
    return rec


def test_scheduler_admission_wedge_with_stubbed_engine():
    """The port's scheduler runs the JAX suite's host-only engine double
    (it reads ``paged``, ``piggyback_chunks``, ``num_prefilling``,
    ``spec`` and ``prefix_blocks`` with defaults, as the JAX scheduler
    does) and the watchdog's verdicts match the JAX package's."""
    from ray_lightning_tpu.serve import metrics as j_metrics
    from ray_lightning_tpu.serve import scheduler as j_sched
    from ray_lightning_tpu_torch.serve import metrics as t_metrics
    from ray_lightning_tpu_torch.serve import scheduler as t_sched

    spaces = {
        "jax": types.SimpleNamespace(sched=j_sched, metrics=j_metrics,
                                     **vars(PKGS["jax"])),
        "torch": types.SimpleNamespace(sched=t_sched, metrics=t_metrics,
                                       **vars(PKGS["torch"])),
    }
    got = {name: _stub_wedge(ns) for name, ns in spaces.items()}
    assert got["torch"] == got["jax"]
    rec = got["torch"]
    assert rec[1] is True and rec[2] is True and rec[3] is True
    assert rec[4] == 1 and rec[5] == t_health.UNHEALTHY and rec[7] is True
