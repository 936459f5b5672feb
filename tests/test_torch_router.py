"""The port's front-door policy held against the JAX package's, with no
processes: ``Router`` (plans, picks, rejections, rows), ``RetryBudget``,
``DigestChainCache``, ``prompt_block_digests`` and ``FleetKVDirectory`` on
the same synthetic views and op sequences, and ``ServeClient`` over the
same in-memory fake replicas (routes, hedges, retry-budget exhaustion,
failover resubmissions, the driver journal, and the recovery plane:
respawn, prespawn, add, retire and the preemption drain). Each scenario
runs once against each package and the two records must be equal.

Ids and clocks are injected (``request_id=``, the router's ``clock=``, a
retry budget's ``clock=``); journal and event timestamps are dropped from
the records.
"""
import types

import numpy as np
import pytest
import torch

import ray_lightning_tpu.serve.client as j_client
import ray_lightning_tpu.serve.kvfleet as j_kvfleet
import ray_lightning_tpu.serve.router as j_router
from ray_lightning_tpu import fabric as j_fabric
from ray_lightning_tpu.obs.events import EventLog as JEventLog
from ray_lightning_tpu.obs.registry import MetricsRegistry as JRegistry
import ray_lightning_tpu_torch.serve.client as t_client
import ray_lightning_tpu_torch.serve.kvfleet as t_kvfleet
import ray_lightning_tpu_torch.serve.router as t_router
from ray_lightning_tpu_torch import fabric as t_fabric
from ray_lightning_tpu_torch.models import gpt as tgpt
from ray_lightning_tpu_torch.obs.events import EventLog as TEventLog
from ray_lightning_tpu_torch.obs.registry import MetricsRegistry as TRegistry
from ray_lightning_tpu_torch.serve.engine import DecodeEngine

PKGS = {
    "jax": types.SimpleNamespace(
        router=j_router, client=j_client, kvfleet=j_kvfleet,
        fabric=j_fabric, EventLog=JEventLog, Registry=JRegistry,
    ),
    "torch": types.SimpleNamespace(
        router=t_router, client=t_client, kvfleet=t_kvfleet,
        fabric=t_fabric, EventLog=TEventLog, Registry=TRegistry,
    ),
}


def _both(scenario, *args):
    """Run ``scenario(ns, *args)`` against each package; the records must
    be equal. Returns the port's record."""
    got = {name: scenario(ns, *args) for name, ns in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


class _Clock:
    """A clock the scenario advances by hand."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


# ---------------------------------------------------------------------------
# Fake replicas: the client's RPC surface in memory (tests/test_router.py)
# ---------------------------------------------------------------------------
class _RemoteShim:
    def __init__(self, fn):
        self._fn = fn

    def remote(self, *args, **kwargs):
        return self._fn(*args, **kwargs)


def _fake_cls(ns):
    """The in-memory replica class for one package: its death raises that
    package's ``ActorDiedError``."""

    class _FakeReplica:
        def __init__(self, burst=4, stats=None, stall=False, flaky=False):
            self.dead = False
            self.burst = burst
            #: Answer polls but never emit tokens (the gray failure).
            self.stall = stall
            #: Every result poll fails with a transient error.
            self.flaky = flaky
            self.stats_row = dict(stats or {})
            self.submits = []
            self.cancels = []
            self.stopped = False
            self.requests = {}
            self.submit_rpcs = 0
            self.batch_rpcs = 0
            #: The plan begin_drain answers with (a preemption drain).
            self.drain_plan = None
            self.imported = []
            self.peers = []

        @staticmethod
        def tokens_for(prompt, seed, n):
            return [(sum(prompt) + 7 * seed + i) % 97 for i in range(n)]

        def is_alive(self):
            return not self.dead

        def _check(self):
            if self.dead:
                raise ns.fabric.ActorDiedError("fake replica dead")

        def _rpc_submit(self, prompt, request_id=None, **kw):
            self._check()
            self.submit_rpcs += 1
            return self._admit(prompt, request_id, kw)

        def _admit(self, prompt, request_id, kw):
            self.submits.append((request_id, dict(kw)))
            self.requests[request_id] = self.tokens_for(
                prompt, kw.get("seed", 0), kw.get("max_new_tokens", 32)
            )
            return request_id

        def _rpc_submit_many(self, reqs):
            self._check()
            self.batch_rpcs += 1
            rids = []
            for req in reqs:
                req = dict(req)
                prompt = req.pop("prompt")
                rid = req.pop("request_id", None)
                rids.append(self._admit(prompt, rid, req))
            return rids

        def _rpc_result(self, rid, cursor, wait_s=0.0):
            self._check()
            if self.flaky:
                raise ConnectionError("transient forever")
            if self.stall:
                return {"tokens": [], "done": False, "status": "running"}
            toks = self.requests[rid]
            out = toks[cursor: cursor + self.burst]
            return {
                "tokens": out,
                "done": cursor + len(out) >= len(toks),
                "status": "finished",
            }

        def _rpc_cancel(self, rid):
            self._check()
            self.cancels.append(rid)
            return True

        def _rpc_stats(self):
            self._check()
            return dict(self.stats_row)

        def _rpc_health(self):
            self._check()
            return {
                "verdict": self.stats_row.get("health", "healthy"),
                "healthy": self.stats_row.get("health", "healthy")
                == "healthy",
            }

        def _rpc_stop(self):
            self._check()
            self.stopped = True

        def _rpc_ping(self):
            self._check()
            return "ok"

        def _rpc_begin_drain(self, budget_s=None, wait_s=15.0):
            self._check()
            return self.drain_plan

        def _rpc_import_prefix_blocks(self, blocks):
            self._check()
            self.imported.append(blocks)
            return len(blocks)

        def _rpc_register_kv_peer(self, idx, queue):
            self._check()
            self.peers.append((idx, queue))
            return True

        def __getattr__(self, name):
            fn = object.__getattribute__(self, "__dict__").get(name)
            if fn is not None:
                return fn
            try:
                return _RemoteShim(
                    object.__getattribute__(self, f"_rpc_{name}")
                )
            except AttributeError:
                raise AttributeError(name) from None

    return _FakeReplica


def _stats(queue=0, active=0, slots=2, rate=100.0, health="healthy",
           prefix_bytes=0):
    """An idle-healthy stats row (summarize_replica's input schema)."""
    row = {
        "queue_depth": queue,
        "active_slots": active,
        "num_slots": slots,
        "decode_tokens_per_sec": rate,
        "health": health,
    }
    if prefix_bytes:
        row["prefix"] = {
            "tiers": {
                "device": {"hits": 0, "misses": 0, "bytes": prefix_bytes}
            }
        }
    return row


class _StatsClient:
    """Just the pull surface Router.refresh needs."""

    def __init__(self, rows):
        self.rows = rows

    def stats(self):
        return [dict(r) for r in self.rows]

    def health(self):
        return [
            {
                "verdict": r.get("health", "healthy"),
                "healthy": r.get("health", "healthy") == "healthy",
            }
            for r in self.rows
        ]


def _router(ns, client=None, **kw):
    reg = ns.Registry()
    clock = _Clock()
    router = ns.router.Router(
        client=client, registry=reg, events=ns.EventLog(), refresh_s=0.0,
        clock=clock, **kw,
    )
    return router, reg


def _plan_rec(plan):
    return (plan.replica, plan.ship_to, plan.kv_hint, plan.policy,
            None if plan.digests is None else [d.hex() for d in plan.digests])


def _try(fn):
    """A call's result, or its rejection as (type name, reason, hint)."""
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 - the record compares it
        return (type(exc).__name__, getattr(exc, "reason", None),
                getattr(exc, "retry_after_s", None))


def _counters(reg, name, label, values):
    c = reg.counter(name)
    return [c.value(**{label: v}) for v in values]


# ---------------------------------------------------------------------------
# RetryBudget, digests, the directory
# ---------------------------------------------------------------------------
def _retry_budget_scenario(ns):
    clock = _Clock()
    b = ns.router.RetryBudget(ratio=0.5, window_s=10.0, floor=1, clock=clock)
    out = [b.try_spend(), b.try_spend(), b.allowed()]
    for _ in range(6):
        b.note_submit()
    out += [b.allowed(), [b.try_spend() for _ in range(5)]]
    clock.t = 11.0  # the window slides past every sample
    out += [b.allowed(), b.try_spend(), b.try_spend()]
    clock.t = 12.0
    for _ in range(20):
        b.note_submit()
    out += [b.allowed(), [b.try_spend() for _ in range(12)]]
    return out


def test_retry_budget_matches_jax():
    rec = _both(_retry_budget_scenario)
    assert rec[0] is True and rec[1] is False


def _digest_scenario(ns, prompts):
    cache = ns.router.DigestChainCache(4, capacity=16)
    out = []
    for p in prompts:
        out.append([d.hex() for d in ns.router.prompt_block_digests(p, 4)])
        out.append([d.hex() for d in cache.digests(p)])
    out.append(cache.stats())
    return out


def test_digest_chains_match_jax_and_the_engine():
    """``prompt_block_digests`` and the incremental cache equal the JAX
    router's, and equal the chained digests the port's engine keys its
    prefix pool by (``DecodeEngine._block_digests``)."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 97, size=24).tolist()
    prompts = [base, base[:13], base[:8] + [1, 2, 3, 4, 5], base[:3],
               base + base[:9]]
    rec = _both(_digest_scenario, prompts)
    cfg = tgpt.GPTConfig(vocab_size=97, n_layer=1, n_head=2, d_model=16,
                         max_seq=64, attn_impl="reference",
                         compute_dtype="float32")
    params = tgpt.init_gpt_params(torch.Generator().manual_seed(0), cfg)
    eng = DecodeEngine(params, cfg, num_slots=2, prefill_chunk=8,
                       prefix_blocks=8, prefix_block=4, device="cpu")
    for i, p in enumerate(prompts):
        engine_chain = eng._block_digests(np.asarray(p, np.int32))
        assert [d.hex() for d in engine_chain] == rec[2 * i]
        assert rec[2 * i] == rec[2 * i + 1]


def _directory_scenario(ns, shards):
    d = ns.kvfleet.FleetKVDirectory(capacity=32, shards=shards)
    chain = [bytes([i]) * 16 for i in range(12)]
    out = []
    d.observe(chain[:6], 0)
    d.observe(chain[4:9], 1)
    out += [d.chain(chain), d.chain(chain[4:]), d.holder(chain[5]), len(d)]
    d.observe_store(chain[:10])
    out += [d.store_chain(chain), d.store_holds(chain[10])]
    out += [d.forget_digests(chain[2:5], replica=1),
            d.forget_digests(chain[2:5]), d.chain(chain)]
    out += [d.forget_replica(1), len(d), d.store_entries()]
    out += [d.forget_store_digests(chain[8:12]), d.store_chain(chain)]
    d.observe([bytes([100 + i]) * 16 for i in range(40)], 2)
    out += [len(d), d.shard_sizes(), d.store_entries()]
    out.append(ns.kvfleet.blocks_nbytes([
        ("aa", np.zeros((2, 4), np.float32), np.zeros((2, 4), np.float32)),
        ("bb", {"s0": np.zeros(3, np.int8)}, None),
    ]))
    return out


@pytest.mark.parametrize("shards", [1, 4])
def test_fleet_directory_matches_jax(shards):
    rec = _both(_directory_scenario, shards)
    assert rec[0] == (0, 4)
    assert ("mixed", "prefill", "decode") == t_kvfleet.ROLES


# ---------------------------------------------------------------------------
# Router: plans, picks, rejections and rows on synthetic views
# ---------------------------------------------------------------------------
def _states_case(ns):
    rows = [_stats(), _stats(health="unhealthy"), _stats()]
    states = {2: "preempting"}
    router, reg = _router(
        ns, _StatsClient(rows),
        state_fn=lambda: [
            {"replica": i, "state": states.get(i, "healthy")}
            for i in range(3)
        ],
    )
    out = [[router.pick([1, 2, 3], alive=[0, 1, 2]) for _ in range(8)]]
    router.refresh(force=True)
    g = reg.gauge("rlt_router_replica_weight")
    out.append([g.value(replica=i) for i in range(3)])
    rows[1]["health"] = "degraded"
    states.clear()
    router.refresh(force=True)
    out.append(router.pick([1], alive=[0, 1]))
    rows[0].update(queue_depth=8, active_slots=2)
    router.refresh(force=True)
    out.append(router.pick([1], alive=[0, 1]))
    rows[1]["health"] = "unhealthy"
    router.refresh(force=True)
    rows[1]["health"] = "healthy"
    router.refresh(force=True)
    out.append(_counters(reg, "rlt_router_rebalances_total", "reason",
                         ("excluded", "restored")))
    out.append(router.rows())
    return out


def _balance_case(ns):
    router, reg = _router(ns, None)
    out = [[router.pick([1], alive=[0, 1]) for _ in range(4)],
           _counters(reg, "rlt_router_routed_total", "reason",
                     ("weighted", "affinity", "fallback"))]
    router2, _ = _router(ns, _StatsClient([_stats(queue=6, active=2),
                                           _stats()]))
    out.append([router2.pick([1], alive=[0, 1]) for _ in range(4)])
    router3, reg3 = _router(ns, _StatsClient([_stats(health="unhealthy"),
                                              _stats(health="unhealthy")]))
    out.append([router3.pick([1], alive=[0, 1]) for _ in range(3)])
    out.append(_counters(reg3, "rlt_router_routed_total", "reason",
                         ("weighted", "fallback")))
    out.append(_try(lambda: router3.pick([1], alive=[])))
    out += [router.rows(), router3.rows()]
    return out


def _affinity_case(ns):
    router, reg = _router(ns, _StatsClient([_stats(), _stats()]),
                          prefix_block=4)
    prefix = [5, 6, 7, 8, 1, 2, 3, 4]
    router.observe_route(prefix, 1)
    out = [router.affinity_entries()]
    out.append([_plan_rec(router.plan(prefix + [9, 9], alive=[0, 1]))
                for _ in range(3)])
    other = [list(range(10 + i, 20 + i)) for i in range(4)]
    out.append([_plan_rec(router.plan(p, alive=[0, 1])) for p in other])
    # Steered away from the holder by load: the plan carries the
    # warm-peer fetch hint.
    loaded = _router(ns, _StatsClient([_stats(), _stats(queue=9, active=2)]),
                     prefix_block=4)[0]
    loaded.observe_route(prefix, 1)
    out.append(_plan_rec(loaded.plan(prefix + [9], alive=[0, 1])))
    out.append(_counters(reg, "rlt_router_routed_total", "reason",
                         ("weighted", "affinity")))
    router.forget_replica(1)
    out.append(router.affinity_entries())
    out.append(router.rows())
    return out


def _cache_weight_case(ns):
    router, _ = _router(
        ns, _StatsClient([_stats(prefix_bytes=1 << 10),
                          _stats(prefix_bytes=10 << 20)]),
        prefix_block=4,
    )
    prompt = [1, 2, 3, 4, 9, 9]
    router.observe_route(prompt, 0)
    router.observe_route(prompt, 1)
    return [router.pick(prompt, alive=[0, 1]),
            _plan_rec(router.plan([7, 7, 7, 7, 7], alive=[0, 1]))]


def _admission_case(ns):
    router, reg = _router(ns, _StatsClient([_stats(rate=10.0)]))
    out = [_try(lambda: router.plan([1, 2, 3], max_new_tokens=50,
                                    deadline_s=1.0, alive=[0])),
           _plan_rec(router.plan([1, 2, 3], max_new_tokens=4,
                                 deadline_s=30.0, alive=[0]))]
    sat = _stats(queue=20, active=2, slots=2, rate=100.0)
    router2, reg2 = _router(ns, _StatsClient([sat, dict(sat)]),
                            shed_queue_factor=4.0)
    out.append(_try(lambda: router2.plan([1], max_new_tokens=4, priority=1,
                                         alive=[0, 1])))
    out.append(_plan_rec(router2.plan([1], max_new_tokens=4, priority=0,
                                      alive=[0, 1])))
    out.append(_try(lambda: router2.plan([1], max_new_tokens=4,
                                         deadline_s=0.05, alive=[0, 1])))
    router2.shed = False
    out.append(_plan_rec(router2.plan([1], max_new_tokens=4, priority=1,
                                      alive=[0, 1])))
    out.append(_counters(reg, "rlt_router_shed_total", "reason",
                         ("deadline_infeasible", "saturated")))
    out.append(_counters(reg2, "rlt_router_shed_total", "reason",
                         ("deadline_infeasible", "saturated")))
    out += [router.rows(), router2.rows(), router2.describe()]
    return out


def _plan_many_case(ns):
    rows = [_stats(queue=1), _stats(), _stats(queue=3, active=1)]
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8, 9], [1, 2, 3, 4, 5, 6, 7, 8, 1],
               [4, 4, 4, 4], [9] * 12, [1, 2, 3, 4]]
    serial, _ = _router(ns, _StatsClient(rows), prefix_block=4)
    batched, _ = _router(ns, _StatsClient(rows), prefix_block=4)
    for r in (serial, batched):
        r.observe_route(prompts[0], 2)
    out = [[_plan_rec(serial.plan(p, max_new_tokens=8, alive=[0, 1, 2]))
            for p in prompts]]
    out.append([
        _plan_rec(p) for p in batched.plan_many(
            prompts, max_new_tokens=8, alive=[0, 1, 2])
    ])
    rows_b = batched.rows()
    out.append({k: v for k, v in rows_b.items() if k != "plan"})
    out.append({k: rows_b["plan"][k] for k in ("batches", "requests",
                                                "mean_batch")})
    return out


ROUTER_CASES = {
    "states": _states_case,
    "balance": _balance_case,
    "affinity": _affinity_case,
    "cache_weight": _cache_weight_case,
    "admission": _admission_case,
    "plan_many": _plan_many_case,
}


@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
def test_router_decisions_match_jax(case):
    rec = _both(ROUTER_CASES[case])
    if case == "states":
        assert set(rec[0]) == {0}
    if case == "admission":
        assert rec[0][1] == "deadline_infeasible"
        assert rec[2][1] == "saturated"


def test_router_config_from_header_matches_jax():
    header = {"router": {"refresh_s": 0.5, "affinity": False,
                         "prefix_block": 32, "bogus": 1,
                         "hedge_after_s": 2.0}}
    assert (t_router.router_config_from_header(header)
            == j_router.router_config_from_header(header))
    assert t_router.router_config_from_header(None) == {}


# ---------------------------------------------------------------------------
# ServeClient policy over fake replicas
# ---------------------------------------------------------------------------
def _client(ns, replicas, **kw):
    events = ns.EventLog()
    reg = ns.Registry()
    return (ns.client.ServeClient(replicas, registry=reg, events=events,
                                  **kw), reg, events)


def _journal(client):
    return [{k: v for k, v in e.items() if not k.startswith("t_")}
            for e in client.journal.dump()["entries"]]


def _event_names(events, subsystem="serve"):
    return [(e["name"], e.get("level")) for e in events.tail(256)
            if e.get("subsystem") == subsystem]


def _routing_case(ns):
    Fake = _fake_cls(ns)
    reps = [Fake(stats=_stats()), Fake(stats=_stats())]
    client, reg, events = _client(ns, reps)
    out = []
    for k in range(4):
        h = client.submit([k + 1, 2, 3], max_new_tokens=5, seed=k,
                          request_id=f"r{k}")
        out.append((h.replica, list(client.stream_handle(h, timeout_s=10))))
    router, _ = _router(ns, client, prefix_block=4)
    client.router = router
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    for k, p in enumerate([prompt, prompt[:4] + [7, 7, 7, 7], [8, 8]]):
        h = client.submit(p, max_new_tokens=3, request_id=f"a{k}",
                          tenant="t")
        out.append((h.replica, client.generate.__name__,
                    list(client.stream_handle(h, timeout_s=10))))
    out.append(_try(lambda: client.submit([1], bogus=1)))
    out += [[r.submits for r in reps], _journal(client),
            _event_names(events), router.rows()["routed"]]
    return out


def _submit_many_case(ns):
    Fake = _fake_cls(ns)
    reps = [Fake(stats=_stats()), Fake(stats=_stats(rate=10.0))]
    client, reg, events = _client(ns, reps)
    router, rreg = _router(ns, client, prefix_block=4)
    client.router = router
    prompts = [[1, 2, 3, 4, 5], [1, 2, 3, 4, 6], [9, 9], [5, 5, 5, 5, 5]]
    res = client.submit_many(
        prompts,
        sampling=[{"request_id": f"m{k}", "seed": k} for k in range(4)],
        max_new_tokens=6,
    )
    out = []
    for r in res:
        if isinstance(r, Exception):
            out.append((type(r).__name__, getattr(r, "reason", None)))
        else:
            out.append((r.replica,
                        list(client.stream_handle(r, timeout_s=10))))
    res2 = client.submit_many([[1, 2], [3, 4]], max_new_tokens=40,
                              deadline_s=1.0,
                              sampling=[{"request_id": "d0"},
                                        {"request_id": "d1"}])
    out.append([type(r).__name__ for r in res2])
    out += [[(r.submit_rpcs, r.batch_rpcs, r.submits) for r in reps],
            _journal(client), _event_names(events),
            reg.counter("rlt_serve_submit_batches_total").value()]
    return out


def _hedge_case(ns):
    Fake = _fake_cls(ns)
    slow, fast = Fake(stall=True), Fake()
    client, reg, events = _client(ns, [slow, fast], hedge_after_s=0.0)
    h = client.submit([2, 3], max_new_tokens=6, seed=4, replica=0,
                      request_id="h0")
    got = list(client.stream_handle(h, poll_s=0.0, timeout_s=10))
    solo = Fake(stall=True)
    client2, _, _ = _client(ns, [solo], hedge_after_s=0.0)
    h2 = client2.submit([2, 3], max_new_tokens=2, request_id="h1")
    hedged_alone = client2.hedge(h2)
    return [got, slow.cancels, [s[0] for s in fast.submits],
            reg.counter("rlt_router_hedges_total").value(
                reason="slow_stream"),
            _journal(client), _event_names(events), hedged_alone]


def _retry_budget_case(ns):
    Fake = _fake_cls(ns)
    flaky, good = Fake(flaky=True), Fake()
    client, reg, events = _client(
        ns, [flaky, good], rpc_retries=5, backoff_base_s=0.0,
        retry_budget_ratio=0.0, retry_budget_floor=0,
    )
    h = client.submit([2, 3], max_new_tokens=4, seed=1, replica=0,
                      request_id="b0")
    got = list(client.stream_handle(h, timeout_s=10))
    return [got, h.replica,
            reg.counter("rlt_serve_failover_rpc_retries_total").value(),
            reg.counter("rlt_serve_retry_budget_exhausted_total").value(),
            reg.counter("rlt_serve_failover_replicas_lost_total").value(),
            client.excluded(), _journal(client), _event_names(events)]


def _failover_case(ns):
    Fake = _fake_cls(ns)
    reps = [Fake(burst=2), Fake(burst=2), Fake(burst=2)]
    client, reg, events = _client(ns, reps)
    hs = [client.submit([k, 1], max_new_tokens=6, seed=k,
                        request_id=f"f{k}") for k in range(6)]
    firsts = {h.request_id: next(iter(client.stream_handle(h, timeout_s=10)))
              for h in hs[:2]}
    reps[1].dead = True
    moved = client.on_replica_lost(1, reason="test kill")
    again = client.on_replica_lost(1)
    streams = [list(client.stream_handle(h, timeout_s=10)) for h in hs]
    reps[0].dead = reps[2].dead = True
    h_lost = None
    try:
        h_lost = client.submit([5], max_new_tokens=2, request_id="x")
    except Exception as exc:  # noqa: BLE001
        h_lost = type(exc).__name__
    return [firsts, moved, again, streams, client.excluded(),
            client.alive_replicas(), h_lost,
            [[s[0] for s in r.submits] for r in reps],
            reg.counter("rlt_serve_failover_requests_total").value(
                outcome="resubmitted"),
            _journal(client), _event_names(events)]


def _preempt_drain_case(ns):
    """tests/test_preempt.py::
    test_client_preempt_drain_migrates_with_kv_and_keeps_finishers: the
    migrate set resubmits on the survivor under the same id (its blocks
    imported first), the finish set stays on the dying replica, a request
    already terminal is not migrated, and no survivor means lost."""
    Fake = _fake_cls(ns)
    r0, r1 = Fake(), Fake()
    client, reg, events = _client(ns, [r0, r1])
    prompt = [3, 1, 4, 1, 5]
    h_fin = client.submit(prompt, max_new_tokens=6, seed=1, replica=0,
                          request_id="fin")
    h_mig = client.submit(prompt, max_new_tokens=9, seed=2, replica=0,
                          request_id="mig")
    blocks = [("ab" * 16, np.zeros(2), np.zeros(2))]
    r0.drain_plan = {"budget_s": 10.0, "finish": ["fin"], "migrate": [
        {"request_id": "mig", "blocks": blocks},
        {"request_id": "gone", "blocks": []}]}
    res = client.preempt_drain(0, budget_s=10.0)
    routed = [client.requests_on(0), client.requests_on(1)]
    streams = [list(client.stream_handle(h, timeout_s=10))
               for h in (h_mig, h_fin)]
    # The survivor dies too: a second drain's migrant is lost.
    h_last = client.submit([2, 2], max_new_tokens=3, replica=1,
                           request_id="last")
    r0.dead = True
    r1.drain_plan = {"budget_s": 1.0, "finish": [], "migrate": [
        {"request_id": "last", "blocks": []}]}
    res2 = client.preempt_drain(1, budget_s=1.0)
    return [res, routed, client.excluded(), streams, res2, h_last.replica,
            [len(b) for b in r1.imported], [s[0] for s in r1.submits],
            reg.counter("rlt_serve_preempt_drains_total").value(),
            {o: reg.counter("rlt_serve_preempt_requests_total").value(
                outcome=o) for o in ("migrated", "finished_in_grace",
                                     "lost")},
            reg.counter("rlt_serve_preempt_kv_blocks_total").value(),
            _journal(client), _event_names(events)]


def _respawn_case(ns):
    """tests/test_preempt.py::
    test_client_prespawn_replacement_swaps_in_on_respawn, with a respawn
    that spawns, one whose ping fails (the new actor is killed, the old
    index stays lost) and a client without a recipe."""
    Fake = _fake_cls(ns)
    r0, r1 = Fake(), Fake()
    spawned, calls = [], []

    def respawn_fn(i, fresh_capacity=False):
        calls.append((i, fresh_capacity))
        fresh = Fake()
        fresh.dead = len(spawned) == 2  # the third spawn never answers
        spawned.append(fresh)
        return fresh, []

    client, _, events = _client(ns, [r0, r1], respawn_fn=respawn_fn)
    out = [client.can_respawn(), client.prespawn_replacement(0),
           client.prespawn_replacement(0), len(spawned)]
    client.respawn_replica(0)  # the held replacement swaps in
    out += [len(spawned), client._actor(0) is spawned[0]]
    r1.dead = True
    client.on_replica_lost(1, reason="test")
    client.respawn_replica(1)  # no replacement held: a fresh spawn
    out += [client._actor(1) is spawned[1], client.alive_replicas()]
    spawned[1].dead = True
    client.on_replica_lost(1, reason="again")
    out.append(_try(lambda: client.respawn_replica(1)))
    out += [calls, client.alive_replicas(), client._actor(1) is spawned[1]]
    bare, _, _ = _client(ns, [Fake()])
    out += [bare.can_respawn(), bare.prespawn_replacement(0),
            _try(lambda: bare.respawn_replica(0)),
            _try(lambda: bare.add_replica())]
    return out + [_event_names(events)]


def _add_retire_case(ns):
    """tests/test_router.py::test_client_add_and_retire_replica_graceful:
    an added replica at a stable index (fresh capacity, its role, its
    inbox broadcast to the live fleet), a retire that migrates a stalled
    request and leaves a tombstone, an add whose spawn never answers, and
    recipes without the role or fresh-capacity knobs."""
    Fake = _fake_cls(ns)
    r0, r1 = Fake(stats=_stats()), Fake(stats=_stats())
    spawned = []

    def respawn(i, fresh_capacity=False, role=None):
        rep = Fake(stats=_stats())
        rep.dead = len(spawned) == 1  # the second add never answers
        spawned.append((i, fresh_capacity, role))
        return rep, []

    queues = {0: "q0", 1: "q1", 2: "q2", 3: "q3"}
    client, reg, events = _client(ns, [r0, r1], respawn_fn=respawn,
                                  kv_queues=queues, roles=["mixed"] * 2)
    idx = client.add_replica(role="decode")
    out = [idx, spawned, client.alive_replicas(), client.role_of(2),
           r0.peers, r1.peers]
    new_rep = client._actor(2)
    h = client.submit([8, 8], max_new_tokens=3, replica=2,
                      request_id="n0")
    out.append(list(client.stream_handle(h, timeout_s=10)))
    new_rep.stall = True
    h2 = client.submit([6, 1], max_new_tokens=4, seed=5, replica=2,
                       request_id="n1")
    res = client.retire_replica(2, drain_timeout_s=0.05)
    got = list(client.stream_handle(h2, poll_s=0.01, timeout_s=10))
    client.restore(2)  # a tombstone stays a tombstone
    out += [res, got, new_rep.stopped, client.is_retired(2),
            client.alive_replicas(), client.stats()[2],
            client.health()[2]["verdict"],
            client.retire_replica(2)]
    out.append(_try(lambda: client.add_replica()))
    out += [client.num_replicas, client.is_retired(3),
            client.alive_replicas()]

    def no_knobs(i):
        return Fake(stats=_stats()), []

    def no_role(i, fresh_capacity=False):
        spawned.append((i, fresh_capacity))
        return Fake(stats=_stats()), []

    for fn in (no_knobs, no_role):
        c, _, _ = _client(ns, [Fake(stats=_stats())], respawn_fn=fn)
        out += [c.add_replica(role="prefill"), c.role_of(1),
                c.prespawn_replacement(0)]
    return out + [spawned, _journal(client), _event_names(events),
                  reg.counter("rlt_serve_failover_requests_total").value(
                      outcome="resubmitted")]


CLIENT_CASES = {
    "preempt_drain": _preempt_drain_case,
    "respawn": _respawn_case,
    "add_retire": _add_retire_case,
    "routing": _routing_case,
    "submit_many": _submit_many_case,
    "hedge": _hedge_case,
    "retry_budget": _retry_budget_case,
    "failover": _failover_case,
}


@pytest.fixture
def fabrics(monkeypatch):
    """Both packages' fabrics in local mode with one CPU and no card: the
    recovery cases' ``fabric.kill`` of a fake replica needs a session."""
    monkeypatch.setenv("RLT_NUM_GPUS", "0")
    j_fabric.init(num_cpus=1)
    t_fabric.init(num_cpus=1)
    yield
    j_fabric.shutdown()
    t_fabric.shutdown()


@pytest.mark.parametrize("case", sorted(CLIENT_CASES))
def test_client_policy_matches_jax(case, fabrics):
    rec = _both(CLIENT_CASES[case])
    if case == "failover":
        assert rec[1]["lost"] == [] and rec[1]["resubmitted"]
        assert rec[6] == "NoReplicasError"
    if case == "hedge":
        assert rec[0] == [(5 + 28 + i) % 97 for i in range(6)]
    if case == "preempt_drain":
        assert rec[0]["migrated"] == ["mig"] and rec[0]["finish"] == ["fin"]
        assert rec[1] == [1, 1] and rec[4]["lost"] == ["last"]
    if case == "respawn":
        assert rec[:6] == [True, True, True, 1, 1, True]
        assert rec[-5:-3] == [False, False]
        assert [r[0] for r in rec[-3:-1]] == ["RuntimeError"] * 2
    if case == "add_retire":
        assert rec[0] == 2 and rec[1][0] == (2, True, "decode")
        assert rec[4] == [(2, "q2")] and rec[5] == [(2, "q2")]


def _spawned(monkeypatch, n, **kw):
    """``start_replicas(n, **kw)`` over a stand-in fabric: the kwargs each
    replica would be spawned with, and the client."""
    spawned = []

    class _Actor:
        def __init__(self):
            self.ping = _RemoteShim(lambda: "ok")
            self.peers = []
            self.register_kv_peer = _RemoteShim(
                lambda i, q: self.peers.append((i, q)) or True)

    class _Cls:
        def __init__(self, opts=None):
            self.opts = opts or {}

        def options(self, **opts):
            return _Cls(opts)

        def remote(self, **kwargs):
            spawned.append(dict(kwargs, opts=self.opts))
            return _Actor()

    monkeypatch.setattr(t_client.fabric, "remote", lambda cls: _Cls())
    monkeypatch.setattr(t_client.fabric, "get",
                        lambda refs, timeout=None: refs)
    monkeypatch.setattr(t_client.fabric, "kill", lambda handle: None)
    monkeypatch.setattr(t_client.fabric, "placement_group",
                        lambda *a, **k: object())
    monkeypatch.setattr(t_client.fabric, "Queue", lambda: object())
    client = t_client.start_replicas(n, device="cpu", **kw)
    return spawned, client


def test_client_refuses_unported_options(monkeypatch):
    """What belongs to a later slice raises, naming its ROADMAP item (the
    profiler, several cards per worker process). The fleet KV plane and
    the KV object store are ported: the client takes roles, KV queues and
    a store handle, parks a session and seeds the directory, and
    ``start_replicas`` wires every replica's role, inbox, peers and
    budgets (the plane on by default for a cached multi-replica fleet),
    refusing only fleets that cannot serve. The recovery plane is
    ported: ``start_replicas`` retains each index's spawn as the client's
    ``respawn_fn`` (same kwargs, same bundle, same role, same inbox and
    peers; fresh capacity outside the placement group), and an added
    replica's new inbox reaches every live replica. So are gangs: the
    client keeps each replica's followers and respawns them with it."""
    Fake = _fake_cls(PKGS["torch"])
    rep = Fake()
    client, _, _ = _client(PKGS["torch"], [rep])
    h = client.submit([1], max_new_tokens=1, request_id="u")
    with pytest.raises(NotImplementedError, match="item 14"):
        client.profile(h)
    parked = []
    rep._rpc_park_session = (
        lambda tokens, request_id=None, wait_s=15.0: parked.append(
            (tokens, request_id))
        or {"digests": [], "blocks": 0, "stored": 0, "freed": 0})
    assert client.park_session(h)["stored"] == 0
    assert parked == [([1] + Fake.tokens_for([1], 0, 1), "u")]
    assert client.seed_store_directory() == 0  # no store, no router
    assert client.can_respawn() is False
    # Gangs are ported: a client keeps each replica's followers, a dead
    # follower dooms its gang, and a respawn swaps the whole gang in.
    followers = [Fake(), Fake()]
    fc = t_client.ServeClient([Fake(), Fake()], followers=followers,
                              follower_replica=[1, 1])
    assert fc.followers_of(1) == followers and fc.followers_of(0) == []
    assert fc.replica_is_alive(1)
    followers[1].dead = True
    assert not fc.replica_is_alive(1) and fc.replica_is_alive(0)
    assert t_client.ServeClient(
        [Fake()], respawn_fn=lambda i: None).can_respawn() is True
    fresh = (Fake(), [Fake()])
    gang = t_client.ServeClient([Fake()], followers=[Fake()],
                                respawn_fn=lambda i: fresh)
    gang.respawn_replica(0)
    assert gang._actor(0) is fresh[0] and gang.followers_of(0) == fresh[1]
    q, store = object(), object()
    c = t_client.ServeClient([Fake()], kv_queues={0: q}, kvstore=store,
                             roles=["prefill"])
    assert (c._kv_queues, c.kvstore, c.role_of(0)) == ({0: q}, store,
                                                       "prefill")
    with pytest.raises(NotImplementedError, match="item 14"):
        t_router.Router(poller=object())
    # A gang's ranks are model x data, one process per card: anything else
    # is several cards per worker process (item 11b).
    with pytest.raises(NotImplementedError, match="item 11b"):
        t_client.start_replicas(1, device="cpu", hosts_per_replica=2)
    spawned, _ = _spawned(monkeypatch, 1, roles="decode")
    assert spawned[0]["role"] == "decode" and "kv_inbox" not in spawned[0]
    spawned, _ = _spawned(monkeypatch, 1, kvfleet=True,
                          kvfleet_timeout_s=1.0, kvfleet_inflight_mb=1.0,
                          kvfleet_bandwidth_mbps=1.0)
    assert (spawned[0]["kv_self"], spawned[0]["kvfleet_timeout_s"],
            spawned[0]["kvfleet_inflight_mb"],
            spawned[0]["kvfleet_bandwidth_mbps"]) == (0, 1.0, 1.0, 1.0)
    spawned, client = _spawned(monkeypatch, 2, prefix_blocks=8,
                               roles=["prefill", "decode"])
    assert [s["role"] for s in spawned] == ["prefill", "decode"]
    assert [s["kv_self"] for s in spawned] == [0, 1]
    assert spawned[0]["kv_peers"] == spawned[1]["kv_peers"] == {
        0: spawned[0]["kv_inbox"], 1: spawned[1]["kv_inbox"]}
    assert client.role_of(1) == "decode" and client.kvstore is None
    # The retained recipe: a respawn re-runs index 1's spawn (the same
    # kwargs, inbox and peers, placement-group bundle 1); a pre-spawn
    # leaves the placement group (fresh capacity) and keeps index 0's
    # role; an added index gets an inbox of its own, which both live
    # replicas adopt.
    live = [client._actor(0), client._actor(1)]
    client.respawn_replica(1)
    assert spawned[2] == spawned[1]
    assert spawned[1]["opts"]["placement_group_bundle_index"] == 1
    assert client.prespawn_replacement(0) is True
    assert "placement_group" not in spawned[3]["opts"]
    assert {k: v for k, v in spawned[3].items() if k != "opts"} == {
        k: v for k, v in spawned[0].items() if k != "opts"}
    assert client.add_replica(role="decode") == 2
    new = spawned[4]
    assert (new["kv_self"], new["role"], sorted(new["kv_peers"])) == (
        2, "decode", [0, 1, 2])
    assert new["kv_inbox"] not in (spawned[0]["kv_inbox"],
                                   spawned[1]["kv_inbox"])
    assert "placement_group" not in new["opts"]
    assert live[0].peers == [(2, new["kv_inbox"])]
    assert client._actor(1).peers == [(2, new["kv_inbox"])]
    for kw, match in (({"roles": ["prefill"], "prefix_blocks": 8},
                       "never decode"),
                      ({"roles": ["prefill", "decode"]}, "prefix pool"),
                      ({"roles": ["prefill", "decode"], "prefix_blocks": 8,
                        "kvfleet": False}, "fleet KV plane"),
                      ({"roles": ["bogus", "decode"]}, "unknown role")):
        n = len(kw["roles"])
        with pytest.raises(ValueError, match=match):
            t_client.start_replicas(n, device="cpu", **kw)
