"""The port's fleet KV plane held against the JAX package's, on the CPU.

Mirrors ``tests/test_kvfleet.py``: the plane alone (fetch round trip,
timeout, staleness, budgets, the bandwidth cap), two in-process schedulers
joined by planes over plain queues (a peer fetch admitted warm, dense and
paged; the stale and dead-peer fallbacks; a disaggregated ship, whole and
layer-wise, dense and paged; a layer-wise ship cut after its first layer;
a shipped outcome journaled as a truncation and replayed), the router's
placement hints, the client following a ship over fake replicas, and an
engine's dropped-digest feed. Every scenario runs the same op stream
through each package, with the same fp32 weights under
``attn_impl="reference"``: the tokens, the planes' counters and the
engines' handoff counters must be equal.

The two-scheduler worlds are built once per module and package and
shared by the scenarios, each on prompts of its own; both packages see
the same op streams in the same order, so their states stay in step.
Their planes read a hand-advanced clock, so a deadline expires only when
a scenario moves it.
"""
import dataclasses
import queue
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_lightning_tpu.models.gpt as jgpt
import ray_lightning_tpu.obs.journal as j_journal
import ray_lightning_tpu.serve.client as j_client
import ray_lightning_tpu.serve.engine as j_engine
import ray_lightning_tpu.serve.kvfleet as j_kvfleet
import ray_lightning_tpu.serve.router as j_router
import ray_lightning_tpu.serve.scheduler as j_sched
from ray_lightning_tpu import fabric as j_fabric
from ray_lightning_tpu.obs.events import EventLog as JEventLog
from ray_lightning_tpu.obs.registry import MetricsRegistry as JRegistry
import ray_lightning_tpu_torch.obs.journal as t_journal
import ray_lightning_tpu_torch.serve.client as t_client
import ray_lightning_tpu_torch.serve.engine as t_engine
import ray_lightning_tpu_torch.serve.kvfleet as t_kvfleet
import ray_lightning_tpu_torch.serve.router as t_router
import ray_lightning_tpu_torch.serve.scheduler as t_sched
from ray_lightning_tpu_torch import fabric as t_fabric
from ray_lightning_tpu_torch.models import gpt as tgpt
from ray_lightning_tpu_torch.models.weights import params_from_jax
from ray_lightning_tpu_torch.obs.events import EventLog as TEventLog
from ray_lightning_tpu_torch.obs.registry import MetricsRegistry as TRegistry

#: The exactness-contract config of the reference's suite.
JAX_CFG = jgpt.GPTConfig(
    vocab_size=97, n_layer=2, n_head=4, d_model=32, max_seq=64,
    attn_impl="reference", compute_dtype="float32",
)
CFG = tgpt.GPTConfig(**dataclasses.asdict(JAX_CFG))
BLOCK = 4  # prefix_block == kv_page everywhere below

KINDS = {
    "dense": dict(num_slots=3, max_seq=64, prefill_buckets=[16],
                  prefill_chunk=4, prefix_blocks=16, prefix_block=BLOCK,
                  decode_fold=2),
    "paged": dict(num_slots=3, max_seq=64, prefill_buckets=[16],
                  prefill_chunk=4, kv_page=BLOCK, kv_pages=48, decode_fold=2),
}
#: The dense engine with n-gram speculation (the reference's SPEC_KW).
KINDS["spec"] = dict(KINDS["dense"], spec="ngram", spec_depth=2)

#: The plane's counters a scenario compares (as deltas).
PLANE_KEYS = (
    "fetches", "fetch_blocks", "fetch_bytes", "fetch_timeouts",
    "fetch_stale", "fetch_refused", "served_fetches", "ships",
    "ship_blocks", "ship_bytes", "layer_ships", "layer_ship_messages",
    "ship_partial_drops", "imports", "store_fetches", "store_fetch_blocks",
    "store_fetch_misses", "pending_fetches",
)
#: The engine's handoff counters a scenario compares (as deltas).
ENGINE_KEYS = (
    "prefix_handoff_imports", "prefix_handoff_exports", "prefix_hit_tokens",
    "layer_block_imports", "layer_import_aborts", "kv_dropped_total",
)


def _numpy_tree(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {
        k: (
            {n: 0.1 * rng.standard_normal(s).astype(np.float32)
             for n, s in v.items()}
            if isinstance(v, dict)
            else 0.1 * rng.standard_normal(v).astype(np.float32)
        )
        for k, v in tgpt.param_shapes(cfg).items()
    }


_TREE = _numpy_tree(CFG)

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", sched=j_sched, kvfleet=j_kvfleet, journal=j_journal,
        router=j_router, client=j_client, fabric=j_fabric,
        EventLog=JEventLog, Registry=JRegistry,
        engine=lambda params, **kw: j_engine.DecodeEngine(params, JAX_CFG,
                                                          **kw),
    ),
    "torch": types.SimpleNamespace(
        name="torch", sched=t_sched, kvfleet=t_kvfleet, journal=t_journal,
        router=t_router, client=t_client, fabric=t_fabric,
        EventLog=TEventLog, Registry=TRegistry,
        engine=lambda params, **kw: t_engine.DecodeEngine(
            params, CFG, device="cpu", **kw),
    ),
}


@pytest.fixture(scope="module")
def params():
    return {
        "jax": jax.tree_util.tree_map(jnp.asarray, _TREE),
        "torch": params_from_jax(_TREE, CFG, "cpu"),
    }


class _Clock:
    """A clock the scenario advances by hand."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


class _Duo:
    """Two schedulers of one package joined by fleet KV planes over plain
    queues: the transfer fabric without processes."""

    def __init__(self, ns, params, kind):
        self.ns = ns
        self.clock = _Clock()
        inboxes = {0: queue.Queue(), 1: queue.Queue()}
        self.engines, self.planes, self.scheds = [], [], []
        for i in (0, 1):
            eng = ns.engine(params, **KINDS[kind])
            plane = ns.kvfleet.KVFleetPlane(
                index=i, inbox=inboxes[i], peers=dict(inboxes),
                block_bytes=eng.prefix_block_nbytes, timeout_s=5.0,
                min_poll_s=0.0, clock=self.clock,
            )
            self.engines.append(eng)
            self.planes.append(plane)
            self.scheds.append(ns.sched.Scheduler(eng, kvfleet=plane))

    def drive(self, only=None, max_steps=400):
        """Step the schedulers (``only``: that one) until none has work;
        every TokenEvent per scheduler index."""
        events = ([], [])
        idx = (0, 1) if only is None else (only,)
        for _ in range(max_steps):
            busy = False
            for i in idx:
                if self.scheds[i].has_work():
                    busy = True
                events[i].extend(self.scheds[i].step())
            if not busy:
                break
        return events

    def counters(self):
        return (
            [{k: p.stats()[k] for k in PLANE_KEYS} for p in self.planes],
            [{k: getattr(e, k) for k in ENGINE_KEYS} for e in self.engines],
        )


def _delta(before, after):
    return [
        [{k: a[k] - b[k] for k in a} for b, a in zip(bs, as_)]
        for bs, as_ in zip(before, after)
    ]


_DUOS = {}


@pytest.fixture(scope="module")
def duos(params):
    """(package, kind) -> the module's shared two-scheduler world."""

    def get(pkg, kind):
        key = (pkg, kind)
        if key not in _DUOS:
            _DUOS[key] = _Duo(PKGS[pkg], params[pkg], kind)
        return _DUOS[key]

    yield get
    _DUOS.clear()


def _both(scenario, *args):
    """Run ``scenario(ns, *args)`` against each package; the records must
    be equal. Returns the port's record."""
    got = {name: scenario(ns, *args) for name, ns in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _tokens(events, rid):
    return [e.token for e in events if e.request_id == rid
            and e.token is not None]


def _sp(ns, n=8, seed=0):
    return ns.sched.SamplingParams(max_new_tokens=n, seed=seed)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size,
                                                size=n).tolist()


def _hint(prompt, peer=0):
    digs = [d.hex() for d in t_router.prompt_block_digests(prompt, BLOCK)]
    return {"peer": peer, "digests": digs, "blocks": len(digs)}


def _solo(params, prompt, n):
    return tgpt.gpt_generate(params["torch"], CFG, [prompt], n,
                             device="cpu")[0].tolist()[len(prompt):]


# ---------------------------------------------------------------------------
# The plane alone (tests/test_kvfleet.py:284-378)
# ---------------------------------------------------------------------------
def _fake_blocks(hexes):
    blk = np.zeros((2, 1, 4, 2, 8), np.float32)
    return [(h, blk, blk) for h in hexes]


def _plane_roundtrip(ns):
    inboxes = {0: queue.Queue(), 1: queue.Queue()}
    planes = [
        ns.kvfleet.KVFleetPlane(index=i, inbox=inboxes[i],
                                peers=dict(inboxes), block_bytes=1024,
                                min_poll_s=0.0)
        for i in (0, 1)
    ]
    held = {"aa" * 16, "bb" * 16}
    imported = []
    rec = [planes[0].request_fetch("r1", peer=1,
                                   digests_hex=["aa" * 16, "bb" * 16]),
           planes[0].pending_fetches(),
           planes[0].request_fetch("r1", 1, ["aa" * 16])]
    rec.append(planes[1].service(
        export_fn=lambda ds: _fake_blocks([d for d in ds if d in held]),
        import_fn=lambda blocks: len(blocks),
    ))
    svc0 = planes[0].service(
        export_fn=lambda ds: [],
        import_fn=lambda blocks: imported.append(
            [(h, tuple(k.shape), str(k.dtype).replace("torch.", ""))
             for h, k, _ in blocks]) or len(blocks),
    )
    rec += [svc0, imported, planes[0].fetch_bytes,
            ns.kvfleet.blocks_nbytes(_fake_blocks(["aa" * 16, "bb" * 16])),
            planes[1].served_fetches,
            {k: planes[0].stats()[k] for k in PLANE_KEYS}]
    return rec


def _plane_budgets(ns):
    clock = _Clock()
    inboxes = {0: queue.Queue(), 1: queue.Queue()}
    planes = [
        ns.kvfleet.KVFleetPlane(
            index=i, inbox=inboxes[i], peers=dict(inboxes),
            block_bytes=1 << 20, timeout_s=1.0, max_inflight_mb=3.0,
            min_poll_s=0.0, clock=clock,
        )
        for i in (0, 1)
    ]
    rec = [planes[0].request_fetch("r1", 1, ["aa" * 16])]
    clock.t = 2.0  # the peer died mid-fetch: the deadline passes
    rec.append(planes[0].service(export_fn=lambda ds: [], import_fn=len))
    rec.append(planes[0].request_fetch("r2", 1, ["cc" * 16]))
    planes[1].service(export_fn=lambda ds: [], import_fn=len)  # stale
    rec.append(planes[0].service(export_fn=lambda ds: [], import_fn=len))
    rec += [planes[0].request_fetch("r3", 1, ["dd" * 16]),
            planes[0].request_fetch("r4", 1, ["ee" * 16, "ff" * 16]),
            planes[0].request_fetch("r5", 7, ["aa" * 16]),
            planes[0].request_fetch("r6", 0, ["aa" * 16])]
    rec.append({k: planes[0].stats()[k] for k in PLANE_KEYS})
    return rec


def _plane_bandwidth(ns):
    clock = _Clock()
    inboxes = {0: queue.Queue(), 1: queue.Queue()}
    plane = ns.kvfleet.KVFleetPlane(
        index=0, inbox=inboxes[0], peers=dict(inboxes), block_bytes=64,
        bandwidth_mbps=1.0, bandwidth_window_s=1.0, min_poll_s=0.0,
        clock=clock,
    )
    big = [("aa" * 16, np.zeros(1 << 21, np.uint8), None)]
    rec = [plane.ship(1, "rx", big), plane.request_fetch("r1", 1, ["bb" * 16]),
           plane.fetch_refused]
    clock.t = 5.0  # the window slides: capacity returns
    rec.append(plane.request_fetch("r1", 1, ["bb" * 16]))
    return rec


@pytest.mark.parametrize("case", ["roundtrip", "budgets", "bandwidth"])
def test_plane_accounting_matches_jax(case):
    rec = _both({"roundtrip": _plane_roundtrip, "budgets": _plane_budgets,
                 "bandwidth": _plane_bandwidth}[case])
    if case == "roundtrip":
        assert rec[0] is True and rec[2] is False
        assert rec[4]["fetched"] == [("r1", 2)]
    if case == "budgets":
        assert rec[1]["failed"] == [("r1", "timeout")]
        assert rec[3]["failed"] == [("r2", "stale")]
        assert rec[4:8] == [True, False, False, False]
    if case == "bandwidth":
        assert rec == [True, False, 1, True]


def test_wire_form_carries_no_tensor():
    """A message on a plane's queue holds bytes, dtype names and shapes,
    never a tensor; a bfloat16 block comes back bitwise."""
    inboxes = {0: queue.Queue(), 1: queue.Queue()}
    plane = t_kvfleet.KVFleetPlane(index=0, inbox=inboxes[0],
                                   peers=dict(inboxes), min_poll_s=0.0)
    k = torch.randn(2, 1, 4, 2, 8).to(torch.bfloat16)
    v = torch.randn(2, 1, 4, 2, 8)
    assert plane.ship(1, "r", [("ab" * 16, k, v)])
    kind, body = inboxes[1].get_nowait()
    assert kind == "ship"
    (h, kw, vw), = body["blocks"]
    assert kw[:3] == ("array", "bfloat16", [2, 1, 4, 2, 8])
    assert isinstance(kw[3], bytes) and vw[1] == "float32"
    (_, k2, v2), = t_kvfleet.from_wire(body["blocks"])
    assert torch.equal(k2, k) and torch.equal(v2, v)


# ---------------------------------------------------------------------------
# Cross-replica prefix sharing (tests/test_kvfleet.py:380-462)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_peer_fetch_warm_admit_matches_jax(params, duos, kind):
    """Replica 1 misses locally, fetches the chain from replica 0 over the
    plane and admits warm: its tokens are replica 0's (and the solo
    run's), the blocks came over the wire, and both packages count the
    same transfer."""
    prompt = _prompt(7, 14)

    def scenario(ns):
        duo = duos(ns.name, kind)
        before = duo.counters()
        duo.scheds[0].submit(prompt, _sp(ns), request_id="warm")
        ev_a, _ = duo.drive()
        probe = duo.engines[1].cached_prefix_blocks(prompt)
        duo.scheds[1].submit(prompt, _sp(ns), request_id="fetched",
                             kv_hint=_hint(prompt))
        _, ev_b = duo.drive()
        return (_tokens(ev_a, "warm"), _tokens(ev_b, "fetched"), probe,
                _delta(before, duo.counters()))

    warm, fetched, probe, (planes, engines) = _both(scenario)
    assert warm == fetched == _solo(params, prompt, 8)
    assert probe == 0
    assert planes[1]["fetches"] == 1 and planes[1]["fetch_timeouts"] == 0
    assert planes[1]["fetch_blocks"] == 3 and planes[0]["served_fetches"] == 1
    assert engines[1]["prefix_handoff_imports"] == 3
    assert engines[1]["prefix_hit_tokens"] == 12


def test_fetch_stale_and_dead_peer_fall_back_cold(params, duos):
    """A hint naming digests the peer does not hold comes back as an
    explicit miss; a peer that never answers times out. Both requests
    prefill cold with the solo run's tokens."""
    stale_p, dead_p = _prompt(13, 12), _prompt(14, 12)

    def scenario(ns):
        duo = duos(ns.name, "dense")
        before = duo.counters()
        duo.scheds[1].submit(stale_p, _sp(ns, 6), request_id="stale",
                             kv_hint=_hint(stale_p))
        _, ev_stale = duo.drive()
        mid = duo.counters()
        duo.scheds[1].submit(dead_p, _sp(ns, 6), request_id="dead",
                             kv_hint=_hint(dead_p))
        duo.scheds[1].step()  # parked: the fetch is out
        parked = duo.planes[1].pending_fetches()
        duo.clock.t += 10.0  # nobody answers: the deadline passes
        _, ev_dead = duo.drive(only=1)
        return (_tokens(ev_stale, "stale"), _tokens(ev_dead, "dead"), parked,
                _delta(before, mid), _delta(mid, duo.counters()))

    stale, dead, parked, (p1, _), (p2, e2) = _both(scenario)
    assert stale == _solo(params, stale_p, 6)
    assert dead == _solo(params, dead_p, 6)
    assert p1[1]["fetch_stale"] == 1 and p1[1]["fetch_timeouts"] == 0
    assert parked == 1
    assert p2[1]["fetch_timeouts"] == 1 and e2[1]["prefix_handoff_imports"] == 0


# ---------------------------------------------------------------------------
# Disaggregated prefill/decode (tests/test_kvfleet.py:465-496, :1141-1216)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "kind,layerwise",
    [("dense", False), ("dense", True), ("paged", False), ("paged", True),
     ("spec", False)],
    ids=["dense-whole", "dense-layers", "paged-whole", "paged-layers",
         "spec-whole"],
)
def test_disagg_ship_decode_matches_jax(params, duos, kind, layerwise):
    """Replica 0 prefills and ships to replica 1 (whole, or one message
    per layer): replica 0 emits the first token and a ``shipped``
    terminal naming its target; the resubmission on replica 1 admits warm
    and emits the solo run's stream, first token included."""
    prompt = _prompt(17 + 2 * int(layerwise), 14)

    def scenario(ns):
        duo = duos(ns.name, kind)
        for p in duo.planes:
            p.layerwise_ship = layerwise
        try:
            before = duo.counters()
            duo.scheds[0].submit(prompt, _sp(ns), request_id="r", ship_to=1)
            ev_a, _ = duo.drive()
            landed = duo.counters()
            duo.scheds[1].submit(prompt, _sp(ns), request_id="r")
            _, ev_b = duo.drive()
        finally:
            for p in duo.planes:
                p.layerwise_ship = False
        done = [(e.reason, e.ship_to, e.ship_digests) for e in ev_a if e.done]
        return (done, _tokens(ev_a, "r"), _tokens(ev_b, "r"),
                _delta(before, landed), _delta(landed, duo.counters()))

    done, first, full, (p1, e1), (_, e2) = _both(scenario)
    assert [d[:2] for d in done] == [("shipped", 1)]
    assert done[0][2] == _hint(prompt)["digests"]
    assert len(first) == 1 and full == _solo(params, prompt, 8)
    assert full[0] == first[0]
    assert p1[0]["ships"] == 1 and e1[1]["prefix_handoff_imports"] == 3
    assert p1[0]["layer_ships"] == int(layerwise)
    assert p1[0]["layer_ship_messages"] == (CFG.n_layer if layerwise else 0)
    assert e1[1]["layer_block_imports"] == (3 if layerwise else 0)
    assert e1[1]["layer_import_aborts"] == 0
    assert e2[1]["prefix_hit_tokens"] == 12


def test_layerwise_ship_cut_mid_stream_goes_cold(params, duos):
    """Every layer after the first is lost on the wire: replica 1 stages
    pinned blocks with no digest (nothing hits), the deadline sweep
    aborts them and frees their blocks, and the request decodes cold on
    replica 1 with the solo run's tokens."""
    prompt = _prompt(59, 12)

    def scenario(ns):
        duo = duos(ns.name, "dense")
        for p in duo.planes:
            p.layerwise_ship = True
        try:
            before = duo.counters()
            duo.scheds[0].submit(prompt, _sp(ns, 6), request_id="r",
                                 ship_to=1)
            while duo.scheds[0].has_work():
                duo.scheds[0].step()
            inbox = duo.planes[1].inbox
            kept = []
            while not inbox.empty():
                kind, body = inbox.get_nowait()
                if kind == "ship_layer" and int(body.get("layer", 0)) > 0:
                    continue
                kept.append((kind, body))
            for item in kept:
                inbox.put(item)
            duo.scheds[1].step()  # layer 0 staged
            staged = len(duo.engines[1]._layer_imports)
            mid = _delta(before, duo.counters())
            duo.clock.t += 10.0
            duo.scheds[1].step()  # the sweep aborts the staging
            swept = _delta(before, duo.counters())
            duo.scheds[1].submit(prompt, _sp(ns, 6), request_id="r")
            _, ev_b = duo.drive()
        finally:
            for p in duo.planes:
                p.layerwise_ship = False
        return staged, mid, swept, _tokens(ev_b, "r"), _delta(
            before, duo.counters())

    staged, mid, swept, toks, (_, e_all) = _both(scenario)
    assert staged == 3
    assert mid[1][1]["layer_block_imports"] == 0
    assert mid[1][1]["prefix_hit_tokens"] == 0
    assert swept[0][1]["ship_partial_drops"] == 1
    assert swept[1][1]["layer_import_aborts"] == 3
    assert toks == _solo(params, prompt, 6)
    assert e_all[1]["prefix_hit_tokens"] == 0  # cold, never half warm


def test_shipped_outcome_journals_as_truncation_and_replays(duos):
    """tests/test_kvfleet.py:525: the prefill replica journals a ship as a
    cancel and a ``shipped`` outcome with its one token; a replay of that
    journal on one engine is exact, and the header's kvfleet section
    surfaces."""
    prompt = _prompt(29, 12)

    def scenario(ns):
        duo = duos(ns.name, "dense")
        journal = ns.journal.WorkloadJournal(capacity=64)
        journal.set_header(ns.journal.engine_header(
            duo.engines[0],
            kvfleet={"role": "prefill", "peers": 2, "timeout_s": 5.0,
                     "max_inflight_mb": 64.0, "bandwidth_mbps": 0.0,
                     "secret": 1},
        ))
        duo.scheds[0].journal = journal
        try:
            duo.scheds[0].submit(prompt, _sp(ns), request_id="r", ship_to=1)
            duo.drive()
        finally:
            duo.scheds[0].journal = None
        entries = journal.dump(None)["entries"]
        kinds = [e["kind"] for e in entries if e["request_id"] == "r"]
        out = [e for e in entries if e["kind"] == "outcome"][0]
        verdict = ns.journal.replay_journal(
            journal.dump(None), scheduler=ns.sched.Scheduler(duo.engines[1]))
        return (kinds, out["outcome"], out["tokens"], verdict["exact"],
                verdict["kvfleet_config"])

    kinds, outcome, toks, exact, cfg = _both(scenario)
    assert kinds == ["submit", "cancel", "outcome"]
    assert outcome == "shipped" and len(toks) == 1 and exact is True
    assert cfg == {"role": "prefill", "peers": 2, "timeout_s": 5.0,
                   "max_inflight_mb": 64.0, "bandwidth_mbps": 0.0}


def test_engine_reports_dropped_digests(duos):
    """tests/test_kvfleet.py:1013: an untiered pool evicting under
    pressure reports the dropped digests, the same in both packages (on
    the shared dense world's engine 0: 8 prompts of 3 blocks each churn
    its 16-block pool)."""

    def scenario(ns):
        duo = duos(ns.name, "dense")
        eng = duo.engines[0]
        total0 = eng.kv_dropped_total
        for s in range(8):
            duo.scheds[0].submit(_prompt(41 + s, 12), _sp(ns, 4, seed=s))
            duo.drive(only=0)
        return eng.kv_dropped_total - total0, eng.dropped_digests()

    total, ring = _both(scenario)
    assert total > 0 and len(set(ring[-total:])) == total
    int(ring[-1], 16)


# ---------------------------------------------------------------------------
# The router's hints (tests/test_kvfleet.py:604-676)
# ---------------------------------------------------------------------------
class _RowsClient:
    def __init__(self, rows):
        self.rows = rows

    def stats(self):
        return [dict(r) for r in self.rows]

    def health(self):
        return [{"verdict": r.get("health", "healthy")} for r in self.rows]


def _row(role="mixed", queue_=0, health="healthy", dropped=None):
    row = {"queue_depth": queue_, "active_slots": 0, "num_slots": 2,
           "decode_tokens_per_sec": 100.0, "health": health, "role": role,
           "slo_breaches": 0}
    if dropped is not None:
        row["kv_dropped"] = {"total": len(dropped), "recent": dropped}
    return row


def _mk_router(ns, rows, **kw):
    return ns.router.Router(client=_RowsClient(rows), registry=ns.Registry(),
                            events=ns.EventLog(), refresh_s=0.0,
                            prefix_block=BLOCK, **kw)


def _plan_rec(plan):
    return (plan.replica, plan.ship_to, plan.kv_hint, plan.policy)


def _router_hints(ns):
    prompt = list(range(16))
    digests = ns.router.prompt_block_digests(prompt, BLOCK)
    rec = []
    # Eviction reports prune the directory, the non-holder's do not.
    rows = [_row(), _row()]
    r = _mk_router(ns, rows)
    r.observe_route(prompt, 1)
    rows[1] = _row(dropped=[d.hex() for d in digests])
    r.refresh(force=True)
    rec.append(r.directory.chain(digests))
    r.observe_route(prompt, 1)
    rows[0], rows[1] = _row(dropped=[d.hex() for d in digests]), _row()
    r.refresh(force=True)
    rec.append(r.directory.chain(digests))
    # Steered off the holder: a fetch hint; a dead holder gives none.
    r = _mk_router(ns, [_row(), _row(queue_=40)], shed=False)
    r.observe_route(prompt, 1)
    rec.append(_plan_rec(r.plan(prompt, alive=[0, 1])))
    r = _mk_router(ns, [_row(), _row(health="unreachable")], shed=False)
    r.observe_route(prompt, 1)
    rec.append(_plan_rec(r.plan(prompt, alive=[0])))
    # Disaggregated placement, and the warm shortcut to the decode side.
    r = _mk_router(ns, [_row(role="prefill"), _row(role="decode")],
                   shed=False)
    rec.append(_plan_rec(r.plan(prompt, alive=[0, 1])))
    r.observe_route(prompt, 1)
    rec.append(_plan_rec(r.plan(prompt, alive=[0, 1])))
    return rec


def test_router_fetch_hints_and_disagg_plans_match_jax():
    rec = _both(_router_hints)
    assert rec[0] == (None, 0) and rec[1] == (1, 4)
    assert rec[2][0] == 0 and rec[2][2]["peer"] == 1
    assert rec[3][0] == 0 and rec[3][2] is None
    assert rec[4] == (0, 1, None, "disagg")
    assert rec[5][:2] == (1, None) and rec[5][3] == "warm_direct"


# ---------------------------------------------------------------------------
# The client follows a ship (tests/test_kvfleet.py:877-926)
# ---------------------------------------------------------------------------
class _RemoteShim:
    def __init__(self, fn):
        self._fn = fn

    def remote(self, *args, **kwargs):
        return self._fn(*args, **kwargs)


def _fakes(ns):
    class _FakeReplica:
        def __init__(self):
            self.dead = False
            self.submits = []
            self.requests = {}

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
            self.submits.append((request_id, dict(kw)))
            self.requests[request_id] = self.tokens_for(
                prompt, kw.get("seed", 0), kw.get("max_new_tokens", 32))
            return request_id

        def _rpc_result(self, rid, cursor, wait_s=0.0):
            self._check()
            toks = self.requests[rid]
            out = toks[cursor: cursor + 4]
            return {"tokens": out, "done": cursor + len(out) >= len(toks),
                    "status": "finished"}

        def _rpc_cancel(self, rid):
            self._check()
            return True

        def _rpc_stop(self):
            self._check()

        def _rpc_ping(self):
            self._check()
            return "ok"

        def __getattr__(self, name):
            try:
                return _RemoteShim(
                    object.__getattribute__(self, f"_rpc_{name}"))
            except AttributeError:
                raise AttributeError(name) from None

    class _FakePrefill(_FakeReplica):
        """Serves the first token, then reports ``shipped``."""

        def __init__(self, ship_to):
            super().__init__()
            self.ship_to = ship_to

        def _rpc_result(self, rid, cursor, wait_s=0.0):
            self._check()
            return {"tokens": self.requests[rid][:1][cursor:], "done": True,
                    "status": "shipped", "ship_to": self.ship_to,
                    "ship_digests": ["ab" * 16, "cd" * 16]}

    return _FakeReplica, _FakePrefill


def _follow_case(ns):
    Fake, Prefill = _fakes(ns)
    rec = []
    # The ship target takes the resubmission, with a fetch hint back.
    prefill, decode = Prefill(ship_to=1), Fake()
    client = ns.client.ServeClient(
        [prefill, decode], roles=["prefill", "decode"],
        registry=ns.Registry(), events=ns.EventLog())
    prompt = [3, 1, 4, 1, 5]
    rec.append(list(client.stream(prompt, replica=0, ship_to=1,
                                  max_new_tokens=8, seed=5, timeout_s=30,
                                  request_id="s1")))
    rec += [prefill.submits, decode.submits, client.role_of(0)]
    # The ship names a dead target: a survivor takes it, nothing is lost.
    prefill, dead, survivor = Prefill(ship_to=1), Fake(), Fake()
    dead.dead = True
    client = ns.client.ServeClient(
        [prefill, dead, survivor], roles=["prefill", "decode", "decode"],
        registry=ns.Registry(), events=ns.EventLog())
    prompt = [2, 7, 1, 8]
    rec.append(list(client.stream(prompt, replica=0, ship_to=1,
                                  max_new_tokens=6, seed=3, timeout_s=30,
                                  request_id="s2")))
    rec.append(survivor.submits)
    rec.append(ns.journal.incomplete_requests(client.journal.dump(None)))
    return rec


def test_client_follows_ship_and_fails_over_zero_lost():
    rec = _both(_follow_case)
    assert rec[0] == [(14 + 35 + i) % 97 for i in range(8)]
    (rid0, _), = rec[1]
    (rid1, kw1), = rec[2]
    assert rid0 == rid1 == "s1"
    assert kw1["kv_hint"] == {"peer": 0, "digests": ["ab" * 16, "cd" * 16],
                              "blocks": 2}
    assert rec[3] == "prefill"
    assert rec[4] == [(18 + 21 + i) % 97 for i in range(6)]
    assert rec[5] and not rec[6]


# ---------------------------------------------------------------------------
# End to end on the fabric (tests/test_kvfleet.py:1084), slow as there
# ---------------------------------------------------------------------------
def _fleet_ckpt(tmp_path, params):
    import os

    from ray_lightning_tpu_torch.utils.state_stream import (
        state_stream_to_file,
        to_state_stream,
    )

    path = os.path.join(str(tmp_path), "kvfleet.ckpt")
    state_stream_to_file(to_state_stream({
        "params": params["torch"], "gpt_config": dataclasses.asdict(CFG)}),
        path)
    return path


@pytest.fixture
def cpu_fabric(monkeypatch):
    monkeypatch.setenv("RLT_NUM_GPUS", "0")
    t_fabric.init(num_cpus=4)
    yield t_fabric
    t_fabric.shutdown()


@pytest.mark.slow
def test_e2e_disagg_fleet_bit_exact_with_ships(cpu_fabric, tmp_path, params):
    """A real prefill + decode fleet of the port behind the router: every
    stream equals the solo run, blocks really shipped, the decode replica
    admits warm, nothing lost."""
    client = t_client.start_replicas(
        2, ckpt_path=_fleet_ckpt(tmp_path, params), device="cpu",
        roles=["prefill", "decode"], rpc_timeout_s=60.0,
        **KINDS["dense"])
    client.router = t_router.Router(client=client, refresh_s=0.0,
                                    prefix_block=BLOCK, shed=False)
    try:
        for i in range(3):
            prompt = _prompt(51 + i, 14)
            toks = list(client.stream(prompt, max_new_tokens=8, seed=i,
                                      timeout_s=120))
            assert toks == _solo(params, prompt, 8), f"job {i} diverged"
        stats = client.stats()
        assert [s["role"] for s in stats] == ["prefill", "decode"]
        assert stats[0]["kvfleet"]["ships"] >= 1
        assert stats[1]["kvfleet"]["imports"] >= 1
        assert stats[1]["prefix"]["hit_tokens"] > 0
        assert not t_journal.incomplete_requests(client.journal.dump(None))
    finally:
        client.shutdown()
