"""PyTorch port, the request lifecycle on the CPU: the anatomy ledger
(stitching algebra and a real request's covered ledger), fault points, and
the preemption drain with its cross-replica prefix handoff on dense and
paged engines. The drain plan, the exported chains and the import
decisions (accepted blocks, tiers, the paged engine's page refcounts and
ledger), the cost and phase ledgers and the fault points' hits are held
against the JAX package's scheduler and engine on the same op stream, and
each anatomy function against the JAX package's on the same dumps.
"""
import copy
import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_lightning_tpu.models.gpt as jgpt
from ray_lightning_tpu import obs as jobs
from ray_lightning_tpu.obs import anatomy as janatomy
from ray_lightning_tpu.serve.engine import DecodeEngine as JaxEngine
from ray_lightning_tpu.serve.faults import FaultInjector as JaxInjector
from ray_lightning_tpu.serve.scheduler import SamplingParams as JaxSampling
from ray_lightning_tpu.serve.scheduler import Scheduler as JaxScheduler
from ray_lightning_tpu_torch import obs
from ray_lightning_tpu_torch.obs import anatomy
from ray_lightning_tpu_torch.models import gpt as tgpt
from ray_lightning_tpu_torch.models.weights import params_from_jax
from ray_lightning_tpu_torch.obs import trace as obs_trace
from ray_lightning_tpu_torch.obs.anatomy import PHASES
from ray_lightning_tpu_torch.serve.engine import DecodeEngine, _PoolBlock
from ray_lightning_tpu_torch.serve.faults import (
    KILL_EXIT_CODE, FaultDropError, FaultInjector,
)
from ray_lightning_tpu_torch.serve.preempt import peek_state, reset_monitor
from ray_lightning_tpu_torch.serve.scheduler import SamplingParams, Scheduler

JAX_CFG = jgpt.GPTConfig(
    vocab_size=97, n_layer=1, n_head=4, n_kv_head=2, d_model=32, max_seq=64,
    attn_impl="reference", compute_dtype="float32",
)
CFG = tgpt.GPTConfig(**dataclasses.asdict(JAX_CFG))

#: tests/test_preempt.py's engine, and its paged twin.
KINDS = {
    "dense": dict(num_slots=2, max_seq=64, prefill_chunk=4, prefix_blocks=8,
                  prefix_block=4),
    "paged": dict(num_slots=2, max_seq=64, prefill_chunk=4, kv_page=4,
                  kv_pages=40, pipeline=False),
}


@pytest.fixture(scope="module")
def weights():
    """(JAX params, port params) holding the same numpy weights."""
    rng = np.random.default_rng(0)
    tree = {
        k: (
            {n: 0.1 * rng.standard_normal(s).astype(np.float32)
             for n, s in v.items()}
            if isinstance(v, dict)
            else 0.1 * rng.standard_normal(v).astype(np.float32)
        )
        for k, v in tgpt.param_shapes(CFG).items()
    }
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_jax(tree, CFG, "cpu"))


def _solo(params, prompt, n, seed=0):
    out = tgpt.gpt_generate(params, CFG, [prompt], n, seed=seed, device="cpu")
    return out[0, len(prompt):].tolist()


def _tokens(events, rid):
    return [e.token for e in events if e.request_id == rid
            and e.token is not None]


#: The cost ledger's fields that do not read the host's clock.
COST_KEYS = ("request_id", "tenant", "prompt_tokens", "prefill_chunks",
             "prefix_hit_tokens", "decode_folds", "spec_verifies",
             "spec_accepted_tokens", "emitted_tokens", "outcome")


def _ledgers(sched):
    """The cost records on their clock-free fields and the phase records'
    keys, in the order the requests ended."""
    return ([tuple(r[k] for k in COST_KEYS)
             for r in sched.metrics.cost_records()],
            [sorted(p) for p in sched.metrics.phase_records()])


def _same(name, *args, **kw):
    """The port's anatomy function ``name`` on the arguments, held equal
    to the JAX package's on a deep copy of them."""
    want = getattr(janatomy, name)(*copy.deepcopy(args),
                                   **copy.deepcopy(kw))
    got = getattr(anatomy, name)(*args, **kw)
    assert got == want, name
    return got


# -- anatomy: the stitching algebra ------------------------------------------
def _assert_exact_sum(led):
    assert led["found"], led
    assert led["observed_s"] == pytest.approx(
        led["accounted_s"] + led["unaccounted_s"], abs=2e-6), led
    cursor = 0.0
    for row in led["phases"]:
        assert row["start_s"] + 2e-6 >= cursor, led["phases"]
        cursor = row["start_s"] + row["duration_s"]


def _proc(name, evs, wall_offset=0.0, truncated=()):
    return {"name": name, "wall_offset": wall_offset, "traces": {"r": evs},
            "truncated": list(truncated)}


def _ev(span, t, **attrs):
    return dict({"span": span, "t": t}, **attrs)


def test_synthetic_markers_from_events():
    """tests/test_anatomy.py:245."""
    rep0 = _proc("replica0", [
        _ev(obs_trace.SPAN_SUBMIT, 0.0), _ev(obs_trace.SPAN_ADMITTED, 0.1),
        _ev(obs_trace.SPAN_CANCEL, 0.2)])
    rep1 = _proc("replica1", [
        _ev(obs_trace.SPAN_SUBMIT, 0.3), _ev(obs_trace.SPAN_ADMITTED, 0.4),
        _ev(obs_trace.SPAN_FIRST_TOKEN, 0.5), _ev(obs_trace.SPAN_FINISH, 0.6)])
    events = [
        {"name": "cancel", "request_id": "r", "migrated": True},
        {"name": "failover", "kv": {"request_id": "r"}},
        {"name": "request_hedged", "request_id": "OTHER"},
    ]
    led = _same("assemble_anatomy", "r", [rep0, rep1], events=events)
    _assert_exact_sum(led)
    assert set(led["markers"]) == {"migrated", "failover"}
    assert any(r["phase"] == "client_wait" and r.get("detail") == "re-drive"
               for r in led["phases"])


def test_truncated_ring_reports_provenance_not_misattribution():
    """tests/test_anatomy.py:272."""
    rep0 = _proc("replica0", [
        _ev(obs_trace.SPAN_QUEUED, 0.10, truncated=True),
        _ev(obs_trace.SPAN_ADMITTED, 0.12),
        _ev(obs_trace.SPAN_FIRST_TOKEN, 0.15),
        _ev(obs_trace.SPAN_FINISH, 0.25)])
    journal = [
        {"kind": "submit", "request_id": "r", "t_wall": 0.0},
        {"kind": "outcome", "request_id": "r", "t_wall": 0.26,
         "outcome": "finished"},
    ]
    led = _same("assemble_anatomy", "r", [rep0], journal=journal)
    _assert_exact_sum(led)
    assert led["truncated"] is True
    assert any("ring wrapped" in p for p in led["provenance"])
    assert led["unaccounted_s"] >= 0.10 - 1e-6
    assert "truncated rings" in _same("render_anatomy", led)


def test_journal_only_ledger_and_not_found():
    """tests/test_anatomy.py:296."""
    phases = {"queue": 0.01, "kv_fetch": 0.2, "prefill": 0.05,
              "decode": 0.1, "kv_fetch_source": "store"}
    led = _same("assemble_anatomy", "r", [], journal=[{
        "kind": "outcome", "request_id": "r", "t_wall": 1.0,
        "outcome": "finished", "phases": phases}])
    assert led["found"] and led["coverage"] == 1.0
    fetch = [r for r in led["phases"] if r["phase"] == "kv_fetch"]
    assert fetch and fetch[0]["detail"] == "store"
    assert [r["phase"] for r in led["phases"]] == [
        "queue", "kv_fetch", "prefill", "decode"]
    assert _same("assemble_anatomy", "nope", [])["found"] is False
    assert "not found" in _same("render_anatomy", {"request_id": "nope"})
    assert _same("ledger_from_phase_map", "r", {})["found"] is False


def test_aggregate_phases_percentiles():
    """tests/test_anatomy.py:320."""
    maps = [{"decode": 0.001 * (i + 1), "queue": 0.01,
             "kv_fetch_source": "peer"} for i in range(100)]
    agg = _same("aggregate_phases", maps)
    assert set(agg) == {"decode", "queue"}
    assert agg["decode"]["count"] == 100
    assert agg["decode"]["p50_s"] == pytest.approx(0.051, abs=1e-3)
    assert agg["decode"]["p95_s"] == pytest.approx(0.095, abs=2e-3)
    assert agg["queue"]["mean_s"] == pytest.approx(0.01)
    assert _same("aggregate_phases", []) == {}


def test_breach_attribution_shares_and_format():
    """tests/test_anatomy.py:332."""
    block = {"by_phase": {
        "kv_fetch": {"mean_s": 0.58, "count": 10},
        "queue": {"mean_s": 0.22, "count": 10},
        "decode": {"mean_s": 0.17, "count": 10},
        "route_plan": {"mean_s": 0.03, "count": 10},
    }}
    shares = _same("breach_attribution", block)
    assert [p for p, _ in shares] == ["kv_fetch", "queue", "decode"]
    assert shares[0][1] == pytest.approx(0.58, abs=1e-3)
    assert _same("format_attribution", shares).startswith("kv_fetch 58%")
    assert _same("breach_attribution", block["by_phase"])[0][0] == "kv_fetch"
    assert _same("breach_attribution", None) == []
    assert _same("breach_attribution", {"by_phase": {}}) == []


def _local(sched_cls, sp_cls, eng, tracer, journal, prompt):
    """tests/test_anatomy.py:470's op stream: one chunked request."""
    sched = sched_cls(eng, tracer=tracer, journal=journal)
    sched.submit(prompt, sp_cls(max_new_tokens=6), request_id="local")
    evs = sched.run_until_idle()
    return sched, _tokens(evs, "local"), journal.dump(None)["entries"]


def test_local_request_ledger_and_journal_phases(weights):
    """tests/test_anatomy.py:470: tracer and journal reconstruct a covered
    ledger (queue, prefill, decode), the journal outcome carries the
    compact phase map, the metrics window saw the request, and the
    tokens equal the solo run's. The JAX scheduler on the same op stream
    bills the same cost ledger and phase keys, and its own dumps stitch
    into the same phase rows."""
    j_params, params = weights
    kw = dict(num_slots=3, max_seq=64, prefill_buckets=[16], prefill_chunk=4,
              prefix_blocks=16, prefix_block=4, decode_fold=2)
    prompt = np.random.default_rng(5).integers(0, 97, size=12).tolist()
    tracer = obs.RequestTracer(capacity=256)
    sched, toks, entries = _local(
        Scheduler, SamplingParams, DecodeEngine(params, CFG, device="cpu",
                                                **kw),
        tracer, obs.WorkloadJournal(capacity=64), prompt)
    assert toks == _solo(params, prompt, 6)
    led = _same("assemble_anatomy", "local",
                [dict(tracer.dump(8), name="replica0")], journal=entries)
    _assert_exact_sum(led)
    assert led["covered"] is True, led
    for phase in ("queue", "prefill", "decode"):
        assert led["totals"].get(phase, 0) > 0, led["totals"]
    out = [e for e in entries if e["kind"] == "outcome"][0]
    assert set(out["phases"]) == {"queue", "prefill", "decode"}
    assert all(k in set(PHASES) for k in out["phases"])
    _same("ledger_from_phase_map", "local", out["phases"])
    blk = sched.metrics.snapshot()["phases"]
    assert blk["requests"] == 1 and {"prefill", "decode"} <= set(
        blk["by_phase"])
    assert sched.metrics.phase_records() == [out["phases"]]
    (cost,) = sched.metrics.cost_records()
    assert cost["emitted_tokens"] == 6 and cost["outcome"] == "finished"

    j_tracer = jobs.RequestTracer(capacity=256)
    j_sched, j_toks, j_entries = _local(
        JaxScheduler, JaxSampling, JaxEngine(j_params, JAX_CFG, **kw),
        j_tracer, jobs.WorkloadJournal(capacity=64), prompt)
    assert j_toks == toks
    assert _ledgers(j_sched) == _ledgers(sched)
    j_led = janatomy.assemble_anatomy(
        "local", [dict(j_tracer.dump(8), name="replica0")],
        journal=j_entries)
    rows = [(r["phase"], r.get("detail")) for r in led["phases"]]
    assert rows == [(r["phase"], r.get("detail")) for r in j_led["phases"]]
    assert (led["covered"], led["markers"]) == (j_led["covered"],
                                                j_led["markers"])


# -- fault points -------------------------------------------------------------
def test_fault_points_delay_and_drop(weights, monkeypatch):
    """The scheduler hits its four points; a delay rule fires once at the
    Nth hit of its point (recorded in the event log) without changing the
    tokens, and a drop rule raises out of step() at its point. A
    preempt rule records a notice in the process's preemption monitor
    and arms the kill at its deadline. The JAX scheduler on the same op stream hits each point as
    often (rules that never fire count every hit) and fires the same
    rules in the same order."""
    j_params, params = weights
    points = ("post_admit", "mid_prefill_chunk", "fold_boundary",
              "post_finish_pre_ack")
    plan = ([{"point": p, "action": "delay", "seconds": 0.001, "after": 2}
             for p in ("fold_boundary", "mid_prefill_chunk")]
            + [{"point": "post_admit", "action": "delay", "seconds": 0.001},
               {"point": "post_finish_pre_ack", "action": "delay"}]
            + [{"point": p, "action": "delay", "after": 10 ** 6}
               for p in points])
    prompts = [np.random.default_rng(2).integers(0, 97, size=n).tolist()
               for n in (10, 7)]

    def run(sched_cls, sp_cls, log, inj, eng):
        sched = sched_cls(eng, faults=inj, events=log)
        rids = [sched.submit(p, sp_cls(max_new_tokens=5), request_id=f"f{i}")
                for i, p in enumerate(prompts)]
        evs = sched.run_until_idle()
        fired = [(e["point"], e["after"])
                 for e in log.tail(name="fault_fired")]
        return [_tokens(evs, r) for r in rids], inj.describe(), fired

    log = obs.EventLog(capacity=64)
    toks, rules, fired = run(
        Scheduler, SamplingParams, log, FaultInjector.parse(plan, events=log),
        DecodeEngine(params, CFG, device="cpu", **KINDS["dense"]))
    assert toks == [_solo(params, p, 5) for p in prompts]
    assert all(r["fired"] for r in rules[:4])
    assert not any(r["fired"] for r in rules[4:])
    assert all(r["hits"] > 0 for r in rules[4:])
    assert sorted(p for p, _ in fired) == sorted(points)
    j_log = jobs.EventLog(capacity=64)
    assert run(JaxScheduler, JaxSampling, j_log,
               JaxInjector.parse(plan, events=j_log),
               JaxEngine(j_params, JAX_CFG, **KINDS["dense"])) == (
        toks, rules, fired)
    sched2 = Scheduler(
        DecodeEngine(params, CFG, device="cpu", **KINDS["dense"]),
        faults=FaultInjector.parse({"point": "post_admit", "action": "drop"}))
    sched2.submit(prompts[0], SamplingParams(max_new_tokens=5))
    with pytest.raises(FaultDropError, match="post_admit"):
        sched2.step()
    exits = []
    monkeypatch.setattr(os, "_exit", exits.append)
    reset_monitor()
    try:
        inj = FaultInjector.parse(
            {"point": "fold_boundary", "action": "preempt", "seconds": 0.05})
        inj.hit("fold_boundary")
        state = peek_state()
        assert state["pending"] and state["source"] == "fault"
        deadline = time.monotonic() + 10.0
        while not exits and time.monotonic() < deadline:
            time.sleep(0.01)
        assert exits == [KILL_EXIT_CODE]
    finally:
        reset_monitor()


def test_scheduler_refuses_unported_fleet_and_store_options(weights,
                                                           tmp_path):
    """The fleet KV plane and the KV object store options (item 9) now
    build: the scheduler shares its tracer and fault injector with the
    plane and labels its phases with the role; a park writes the chain to
    the store and frees it; without a plane a ``kv_hint`` is ignored and
    the request prefills here, with the solo run's tokens."""
    import queue

    from ray_lightning_tpu_torch.serve.kvfleet import KVFleetPlane
    from ray_lightning_tpu_torch.serve.kvstore import FleetKVStore

    _, params = weights
    eng = DecodeEngine(params, CFG, device="cpu", **KINDS["dense"])
    tracer, inj = obs.RequestTracer(), FaultInjector.parse([])
    store = FleetKVStore(str(tmp_path / "kv"))
    inbox = queue.Queue()
    plane = KVFleetPlane(index=0, inbox=inbox, peers={0: inbox},
                         min_poll_s=0.0, store=store)
    sched = Scheduler(eng, kvfleet=plane, role="prefill", kvstore=store,
                      kvstore_writethrough=True, tracer=tracer, faults=inj)
    assert plane.tracer is tracer and plane.faults is inj
    assert (sched.role, sched.kvstore, sched.kvstore_writethrough) == (
        "prefill", store, True)
    prompt = list(range(1, 14))
    sched.submit(prompt, SamplingParams(max_new_tokens=3), request_id="r")
    toks = _tokens(sched.run_until_idle(), "r")
    assert toks == _solo(params, prompt, 3)
    assert store.writes == 3  # the write-through of the prefill's chain
    assert sched.park_result(timeout=0.01) is None
    sched.request_park(prompt, request_id="r")
    assert sched.has_work()
    sched.step()
    rec = sched.park_result(timeout=5.0)
    assert rec["blocks"] == rec["stored"] == rec["freed"] == 3
    assert eng.cached_prefix_blocks(prompt) == 0
    plain = Scheduler(eng, kvfleet=None, role="mixed", kvstore=None,
                      kvstore_writethrough=False)
    plain.submit(prompt, SamplingParams(max_new_tokens=3), request_id="h",
                 kv_hint={"peer": 0, "digests": ["ab" * 16]})
    assert _tokens(plain.run_until_idle(), "h") == toks


# -- preemption drain and the prefix handoff ----------------------------------
def _pair(weights, kind, **kw):
    """A port engine and a JAX engine of the same config."""
    j_params, params = weights
    cfg = dict(KINDS[kind], **kw)
    return (DecodeEngine(params, CFG, device="cpu", **cfg),
            JaxEngine(j_params, JAX_CFG, **cfg))


def _pool_state(eng):
    """The pool's decisions: digest -> refcount of every keyed block or
    page, the free list's size and the page ledger."""
    keyed = {m.digest: m.refs for m in eng._pool_meta
             if m is not None and m.digest is not None}
    return keyed, len(eng._pool_free), (eng.page_allocs, eng.page_frees)


def _run_one(sched, prompt, sp):
    rid = sched.submit(prompt, sp, request_id="one")
    return [e.token for e in sched.run_until_idle()
            if e.request_id == rid and e.token is not None]


@pytest.mark.parametrize("kind", list(KINDS))
def test_export_import_gives_the_survivor_a_warm_hit(weights, kind):
    """tests/test_preempt.py:191: engine A exports a request's cached
    prefix, engine B imports it through the scheduler's queue (applied at
    the top of the next step), and B's admission walk hits warm with the
    same tokens; a re-import touches, not rewrites. The exported chain,
    the accepted counts, B's pool (refcounts, free list, page ledger), the
    dropped digests' count and both schedulers' cost and phase ledgers
    equal the JAX engines' and schedulers' on the same op stream."""
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, 97, size=14).tolist()
    a, ja = _pair(weights, kind)
    sa, jsa = Scheduler(a), JaxScheduler(ja)
    out_a = _run_one(sa, prompt, SamplingParams(max_new_tokens=6, seed=3))
    j_out = _run_one(jsa, prompt, JaxSampling(max_new_tokens=6, seed=3))
    assert out_a == j_out == _solo(weights[1], prompt, 6)
    assert _ledgers(sa) == _ledgers(jsa)
    blocks = a.export_prefix_blocks(prompt)
    j_blocks = ja.export_prefix_blocks(prompt)
    assert len(blocks) == 3 and a.prefix_handoff_exports == 3
    assert [b[0] for b in blocks] == [b[0] for b in j_blocks]
    for (_, k, v), (_, jk, jv) in zip(blocks, j_blocks):
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5)

    b, jb = _pair(weights, kind)
    sb, jsb = Scheduler(b), JaxScheduler(jb)
    assert sb.enqueue_prefix_import(blocks) == 3
    assert jsb.enqueue_prefix_import(j_blocks) == 3
    assert sb.has_work()
    sb.step()
    jsb.step()
    assert b.prefix_handoff_imports == jb.prefix_handoff_imports == 3
    assert _pool_state(b) == _pool_state(jb)
    out_b = _run_one(sb, prompt, SamplingParams(max_new_tokens=6, seed=3))
    _run_one(jsb, prompt, JaxSampling(max_new_tokens=6, seed=3))
    assert out_b == out_a
    assert b.prefix_hit_tokens >= 8 and b.tier_counters["device"]["hits"] >= 2
    assert b.prefix_hit_tokens == jb.prefix_hit_tokens
    assert _pool_state(b) == _pool_state(jb)
    assert _ledgers(sb) == _ledgers(jsb)
    (cost,) = _ledgers(sb)[0]
    assert cost[COST_KEYS.index("prefix_hit_tokens")] == b.prefix_hit_tokens
    assert b.import_prefix_blocks(blocks) == jb.import_prefix_blocks(
        j_blocks) == 3
    assert _pool_state(b) == _pool_state(jb)
    assert (a.kv_dropped_total, b.kv_dropped_total) == (
        ja.kv_dropped_total, jb.kv_dropped_total)
    if kind == "paged":
        assert b.kv_page_stats() == jb.kv_page_stats()


def test_import_falls_back_to_host_tier_when_pool_pinned(weights):
    """tests/test_preempt.py:231: with no allocatable device block the
    imports land in the host tier (one promotion from warm)."""
    _, params = weights
    a = DecodeEngine(params, CFG, device="cpu", **KINDS["dense"])
    prompt = np.random.default_rng(1).integers(0, 97, size=14).tolist()
    _run_one(Scheduler(a), prompt, SamplingParams(max_new_tokens=4))
    blocks = a.export_prefix_blocks(prompt)
    b = DecodeEngine(params, CFG, device="cpu",
                     **dict(KINDS["dense"], prefix_blocks=2,
                            prefix_host_mb=8.0))
    for i in range(2):  # pin both pool blocks: _pool_alloc returns None
        b._pool_free.remove(i)
        b._pool_map[bytes([i])] = i
        b._pool_meta[i] = _PoolBlock(digest=bytes([i]), refs=1, stamp=i)
    assert b.import_prefix_blocks(blocks) == len(blocks)
    for hexd, _, _ in blocks:
        assert bytes.fromhex(hexd) in b._host_map
    # Freed from every tier: the host copies go, and are noted as dropped.
    assert b.evict_prefix_chain([h for h, _, _ in blocks]) == len(blocks)
    assert not b._host_map
    assert b.dropped_digests()[-len(blocks):] == [h for h, _, _ in blocks]
    assert b.kv_dropped_total == len(b.dropped_digests()) >= len(blocks)


def _with_rate(sched, rate):
    """A decode-rate sample the drain policy reads, independent of the
    host's timing."""
    snapshot = sched.metrics.snapshot
    sched.metrics.snapshot = lambda: dict(snapshot(),
                                          decode_tokens_per_sec=rate)
    return sched


def _drain_plan(sched_cls, sp_cls, eng, prompts, budget, rate, steps=8):
    sched = sched_cls(eng, max_prefills_per_step=2)
    if rate is not None:
        _with_rate(sched, rate)
    rids = [sched.submit(p, sp_cls(max_new_tokens=20, seed=i),
                         request_id=f"r{i}")
            for i, p in enumerate(prompts)]
    for _ in range(steps):
        sched.step()
    before = (eng.num_active, sched.queue_depth())
    sched.request_drain(budget)
    assert sched.has_work()
    step_events = sched.step()
    plan = sched.drain_result(timeout=5.0)
    rest = sched.run_until_idle()
    summary = dict(
        before=before,
        finish=sorted(plan["finish"]),
        migrate=[(m["request_id"], [b[0] for b in m["blocks"]])
                 for m in plan["migrate"]],
        migrated={e.request_id for e in step_events
                  if e.done and e.reason == "migrated"},
        finished={e.request_id for e in list(step_events) + list(rest)
                  if e.done and e.reason == "finished"},
        active_after=eng.num_active,
        ledgers=_ledgers(sched),
    )
    return rids, summary


@pytest.mark.parametrize("kind", list(KINDS))
def test_drain_finish_vs_migrate_and_queue(weights, kind):
    """tests/test_preempt.py:257: a large budget with a rate sample keeps
    the residents (their estimate fits in half the window) and migrates
    the queue; no rate sample migrates everything, cancelled at the same
    step's boundary with "migrated" events and their exported chains. The
    plans, and the cost and phase ledgers of every request, equal the JAX
    scheduler's on the same op stream."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, size=14).tolist() for _ in range(3)]
    for budget, rate, n in ((10 ** 6, 50.0, 3), (0.0, 50.0, 2),
                            (10 ** 6, 0.0, 2)):
        eng, j_eng = _pair(weights, kind)
        rids, got = _drain_plan(Scheduler, SamplingParams, eng,
                                prompts[:n], budget, rate)
        _, want = _drain_plan(JaxScheduler, JaxSampling, j_eng, prompts[:n],
                              budget, rate)
        assert got == want
        assert got["before"] == (2, n - 2)
        if budget and rate:
            assert got["finish"] == sorted(rids[:2])
            assert got["migrate"] == [(rids[2], [])]  # never prefilled
            assert set(rids[:2]) <= got["finished"]
        else:
            assert got["finish"] == []
            assert sorted(r for r, _ in got["migrate"]) == sorted(rids)
            assert all(len(chain) == 3 for _, chain in got["migrate"])
            assert got["migrated"] == set(rids)
            assert got["active_after"] == 0
        outcomes = {c[0]: c[COST_KEYS.index("outcome")]
                    for c in got["ledgers"][0]}
        assert outcomes == {r: ("finished" if r in got["finished"]
                                else "migrated") for r in rids}
