"""Tensor-parallel serving gangs: the leader's op stream, the followers'
trace stitching, a gang replica spawned by ``start_replicas`` on the CPU
fabric and recovered as a unit after a follower's preemption, held against
the JAX package's gang (``tests/test_serve_sharded.py:393,446,543``,
``tests/test_preempt.py:650``; the supervisor's gang half against the JAX
supervisor on a fake client is ``tests/test_torch_supervisor.py``'s
``gang_follower_preempt`` script).
"""
import dataclasses
import queue
import threading
import time

import numpy as np
import pytest
import torch

from ray_lightning_tpu.serve.server import _GangLeaderEngine as JGang
from ray_lightning_tpu_torch import fabric
from ray_lightning_tpu_torch.models.gpt import GPTConfig, param_shapes
from ray_lightning_tpu_torch.obs.events import EventLog
from ray_lightning_tpu_torch.obs.trace import (
    SPAN_CLIENT_SUBMIT,
    SPAN_PREFILL_CHUNK,
    RequestTracer,
    merge_chrome_trace,
)
from ray_lightning_tpu_torch.serve.client import start_replicas
from ray_lightning_tpu_torch.serve.engine import DecodeEngine
from ray_lightning_tpu_torch.serve.router import Router
from ray_lightning_tpu_torch.serve.server import (
    ServeReplica,
    _GangLeaderEngine,
)
from ray_lightning_tpu_torch.serve.supervisor import FleetSupervisor

CFG = GPTConfig(vocab_size=97, n_layer=2, n_head=4, d_model=32, max_seq=64,
                attn_impl="reference", compute_dtype="float32")
T = 60.0


@pytest.fixture(scope="module")
def params():
    """Seeded numpy weights (0.3 * N(0, 1), norm gains about 1)."""
    rng = np.random.default_rng(0)

    def leaf(name, shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(1.0 + 0.1 * x if name.endswith("_g")
                                else 0.3 * x)

    return {k: ({n: leaf(n, s) for n, s in v.items()} if isinstance(v, dict)
                else leaf(k, v))
            for k, v in param_shapes(CFG).items()}


class _Chan:
    """A fabric queue stand-in."""

    def __init__(self, sink):
        self.sink = sink

    def put(self, item):
        self.sink.put(item)


def _drain(q):
    ops = []
    while not q.empty():
        ops.append(q.get())
    return ops


def _engine(params, **kw):
    return DecodeEngine(params, CFG, device="cpu", **kw)


class _Stub:
    """An engine double answering every call with a canned value."""

    num_active = 0

    def __getattr__(self, name):
        return lambda *a, **kw: [] if name != "admit" else (0, 1, False)


def test_gang_leader_engine_mirrors_op_stream(params):
    """``test_serve_sharded.py:393``: every device-mutating call the
    scheduler makes is shipped to the followers before it runs; replaying
    the stream on a second engine reproduces the leader's device state
    bit for bit; reads delegate; ``close`` sends the drain sentinel. The
    port's proxy ships the JAX proxy's stream for the same calls, and its
    attribute writes land on the engine (the scheduler's tracer)."""
    kw = dict(num_slots=2, max_seq=48, prefill_buckets=[8], decode_fold=2)
    leader, mirror = _engine(params, **kw), _engine(params, **kw)
    local = queue.Queue()
    gang = _GangLeaderEngine(leader, [_Chan(local)])
    rng = np.random.default_rng(7)
    p1 = rng.integers(0, 97, size=6).tolist()
    p2 = rng.integers(0, 97, size=5).tolist()
    slot, _, _ = gang.admit(p1, request_id="a", max_new_tokens=6)
    gang.admit_many([dict(prompt=p2, request_id="b", max_new_tokens=8)])
    gang.step()
    gang.release(slot)  # a mid-flight cancel rides the same stream
    while gang.num_active:
        gang.step()
    assert gang.free_slots() == leader.free_slots()  # reads delegate
    tracer = RequestTracer()
    gang.tracer = tracer
    assert leader.tracer is tracer
    gang.close()
    ops = _drain(local)
    assert ops[-1] is None  # drain sentinel
    for name, args, kwargs in ops[:-1]:
        getattr(mirror, name)(*args, **kwargs)
    s_lead, s_mirror = leader.device_state(), mirror.device_state()
    assert set(s_lead) == set(s_mirror)
    for k in s_lead:
        np.testing.assert_array_equal(s_lead[k], s_mirror[k], k)
    assert gang.log.ops == len(ops) - 1
    # The JAX proxy ships the same stream for the same calls.
    streams = []
    for cls in (_GangLeaderEngine, JGang):
        q = queue.Queue()
        g = cls(_Stub(), [_Chan(q)])
        g.admit(p1, request_id="a", max_new_tokens=6)
        g.admit_many([dict(prompt=p2, request_id="b", max_new_tokens=8)])
        g.prefill_step(2)
        g.step()
        g.release(0)
        g.import_prefix_blocks([])
        g.export_prefix_blocks(p1)
        g.export_blocks_by_digest(["00"])
        g.evict_prefix_chain(["00"])
        g.free_slots()
        g.close()
        streams.append(_drain(q))
    assert streams[0] == streams[1]


def test_gang_follower_trace_propagation_stitches(params):
    """``test_serve_sharded.py:446``: the replayed op stream carries the
    request ids, so the follower's engine records its spans under the
    leader's ids; the merged export puts them on a track of their own,
    every id resolving to a client submit span, with the leader's chunk
    ladder."""
    kw = dict(num_slots=2, max_seq=48, prefill_buckets=[16],
              prefill_chunk=4, decode_fold=2)
    leader, mirror = _engine(params, **kw), _engine(params, **kw)
    local = queue.Queue()
    client_tracer = RequestTracer()
    leader.tracer = RequestTracer()
    mirror.tracer = RequestTracer()  # what ServeShardFollower wires up
    gang = _GangLeaderEngine(leader, [_Chan(local)])
    rng = np.random.default_rng(11)
    for rid, size, n in (("a", 9, 5), ("b", 6, 4)):
        client_tracer.event(rid, SPAN_CLIENT_SUBMIT, attrs={"replica": 0})
        gang.admit(rng.integers(0, 97, size=size).tolist(), request_id=rid,
                   max_new_tokens=n)
    while gang.num_active or leader._prefills:
        gang.prefill_step(2)
        gang.step()
    gang.close()
    while True:
        op = local.get_nowait()
        if op is None:
            break
        name, args, kwargs = op
        getattr(mirror, name)(*args, **kwargs)
    assert mirror.tracer.request_ids(), "follower recorded no spans"
    merged = merge_chrome_trace([
        {"name": "client", **client_tracer.dump()},
        {"name": "replica0", **leader.tracer.dump()},
        {"name": "follower0", **mirror.tracer.dump()},
    ])
    evs = merged["traceEvents"]
    procs = {e["args"]["name"]: e["pid"] for e in evs
             if e.get("name") == "process_name"}
    assert set(procs) == {"client", "replica0", "follower0"}
    assert len(set(procs.values())) == 3
    assert any(e["ph"] == "i" and e["pid"] == procs["follower0"]
               and e["name"] == SPAN_PREFILL_CHUNK for e in evs)
    client_rids = set(client_tracer.request_ids())
    for e in evs:
        if e["ph"] == "i" and e["pid"] != procs["client"]:
            assert e["args"]["request_id"] in client_rids, e
    for rid in ("a", "b"):
        lead = [ev["index"] for ev in leader.tracer.trace(rid)
                if ev["span"] == SPAN_PREFILL_CHUNK]
        mine = [ev["index"] for ev in mirror.tracer.trace(rid)
                if ev["span"] == SPAN_PREFILL_CHUNK]
        assert lead == mine and len(lead) >= 1


def test_gang_hosts_must_be_the_mesh_ranks():
    """One process per card: a gang's ranks are exactly model x data;
    anything else is several cards per worker process (item 11b)."""
    for hosts, mesh in ((2, None), (1, "2x1"), (2, "2x2"), (4, "2x1")):
        with pytest.raises(NotImplementedError, match="item 11b"):
            start_replicas(1, device="cpu", hosts_per_replica=hosts,
                           mesh=mesh)
    with pytest.raises(ValueError, match="MODELxDATA"):
        start_replicas(1, device="cpu", hosts_per_replica=2, mesh="2y1")


def _generate_all(client, reqs):
    """Each request streamed on a thread of its own: the tokens, as they
    arrive."""
    handles = [client.submit(p, max_new_tokens=n) for p, n in reqs]
    toks, errors = {i: [] for i in range(len(reqs))}, []

    def read(i, h):
        try:
            for tok in client.stream_handle(h, timeout_s=T):
                toks[i].append(tok)
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(repr(exc))

    threads = [threading.Thread(target=read, args=(i, h), daemon=True)
               for i, h in enumerate(handles)]
    for t in threads:
        t.start()
    return threads, toks, errors


def test_gang_replica_serves_and_recovers_as_a_unit(params, monkeypatch,
                                                   tmp_path):
    """``test_serve_sharded.py:543`` and the gang half of the recovery
    plane: ``start_replicas(1, hosts_per_replica=2, mesh="2x1")`` on the
    CPU fabric serves the tokens of a one-rank replica; its stats carry
    the mesh, the gang, the eager gloo dispatch and each rank's half of
    the KV cache; both ranks' token digests are equal; the stitched trace
    has the follower's track; the gang imports a whole block (each rank
    keeping its heads) and exports it back bitwise into the KV store
    (``park_session``: the follower's heads gathered, the leader
    writing). Then a ``preempt`` fault on the follower reaches the
    supervisor through the follower's heartbeat: the gang is drained with
    0 lost and respawned as a unit (a pre-spawned gang swapped in, the old
    follower gone), and the fresh gang serves the same tokens."""
    from ray_lightning_tpu_torch.serve.kvstore import FleetKVStore
    from ray_lightning_tpu_torch.serve.router import prompt_block_digests

    monkeypatch.setenv("RLT_NUM_GPUS", "0")
    monkeypatch.delenv("RLT_REQUIRE_GPU", raising=False)
    kw = dict(params=params, model_config=dataclasses.asdict(CFG),
              num_slots=3, prefill_buckets=[8, 16], decode_fold=2,
              watchdog=False, prefix_blocks=8)
    store = dict(kvstore_dir=str(tmp_path / "store"),
                 kvstore_namespace="0123456789abcdef")
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 97, size=n).tolist(), m)
            for n, m in ((5, 7), (8, 4), (11, 9), (6, 5))]
    one = ServeReplica(device="cpu", **kw)
    try:
        want = []
        for p, n in reqs:
            rid = one.submit(p, max_new_tokens=n)
            got, cur, done = [], 0, False
            while not done:
                res = one.result(rid, cur, wait_s=1.0)
                got += res["tokens"]
                cur += len(res["tokens"])
                done = res["done"]
            want.append(got)
        one_kv = one.stats()["memory"]["kv_cache"]
    finally:
        one.stop()
    fabric.init(num_cpus=4)
    try:
        client = start_replicas(
            1, hosts_per_replica=2, mesh="2x1", device="cpu",
            env={"OMP_NUM_THREADS": "1", "RLT_HEARTBEAT_S": "0.2"},
            init_timeout=T, rpc_timeout_s=T, **kw, **store)
        assert [client.generate(p, max_new_tokens=n)
                for p, n in reqs] == want
        st = client.stats()[0]
        assert (st["mesh"], st["gang_hosts"], st["graphed"], st["backend"],
                st["compiled_count"], st["compiles_since_init"]) == (
            "2x1", 2, False, "gloo", 0, 0)
        (follower,) = client.followers_of(0)
        fs = fabric.get(follower.stats.remote(), timeout=T)
        assert fs["error"] is None and fs["alive"] and fs["mesh"] == "2x1"
        for mem in (st["memory"], fs["memory"]):
            assert mem["kv_cache"]["bytes"] == one_kv["bytes"]
            assert mem["kv_cache"]["per_device_bytes"] == one_kv["bytes"] // 2
        lead_d = client._rpc(0, "token_digest")
        # The follower records an op a moment after the leader's client has
        # seen its tokens: wait (bounded) until it has replayed as many.
        deadline = time.monotonic() + T
        while True:
            fol_d = fabric.get(follower.token_digest.remote(), timeout=T)
            if fol_d["ops"] >= lead_d["ops"] or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        assert lead_d == fol_d
        assert lead_d["tokens"] == sum(len(t) for t in want)
        names = [d["name"] for d in client.trace_dumps()]
        assert names == ["client", "replica0", "follower0"]
        # A whole block in (each rank keeps its heads), the same block
        # out (the export gathers them back) into the store, bitwise.
        tokens = list(range(1, 17))
        (digest,) = [d.hex() for d in prompt_block_digests(tokens, 16)]
        whole = (CFG.n_layer, 1, 16, CFG.kv_head, CFG.head_dim)
        kv = np.random.default_rng(5).standard_normal((2,) + whole).astype(
            np.float32)
        assert client._rpc(0, "import_prefix_blocks",
                           [(digest, kv[0], kv[1])]) == 1
        parked = client._rpc(0, "park_session", tokens)
        assert (parked["blocks"], parked["stored"]) == (1, 1), parked
        (got,), missing = FleetKVStore(
            store["kvstore_dir"],
            namespace=store["kvstore_namespace"]).get_chain([digest])
        assert missing == [] and got[0] == digest
        for want_kv, got_kv in zip(kv, got[1:]):
            np.testing.assert_array_equal(np.asarray(got_kv), want_kv)

        events = EventLog()
        sup = FleetSupervisor(client, events=events)
        threads, toks, errors = _generate_all(client, reqs)
        # The notice lands once every request is admitted: a request still
        # queued, or one the drain judges unable to finish inside half the
        # grace window, migrates, and a gang with no survivor loses it.
        # Under load (a slow decode rate, the last request waiting for a
        # slot) an earlier notice would lose one by chance.
        deadline = time.monotonic() + T
        while (not all(toks[i] for i in range(len(reqs))) and not errors
               and time.monotonic() < deadline):
            time.sleep(0.02)
        client.inject_fault(0, [{"point": "follower_op", "action": "preempt",
                                 "seconds": 120.0}], follower=0)
        deadline = time.monotonic() + T
        while time.monotonic() < deadline:
            sup.tick()
            if (client.followers_of(0) != [follower]
                    and sup.rows()[0]["state"] == "healthy"):
                break
            time.sleep(0.1)
        for t in threads:
            t.join(T)
        names = [e["name"] for e in events.tail(32)]
        assert names[:3] == ["replica_preempting", "replica_preempt_drained",
                             "replica_preempt_replaced"], names
        (ev,) = [e for e in events.tail(32)
                 if e["name"] == "replica_preempting"]
        assert ev["member"] == "follower"
        assert not errors and [toks[i] for i in range(len(reqs))] == want
        (fresh,) = client.followers_of(0)
        assert fresh is not follower and not follower.is_alive()
        assert [client.generate(p, max_new_tokens=n)
                for p, n in reqs] == want
        client.shutdown()
    finally:
        fabric.shutdown()


def test_gang_prefill_and_decode_roles_ship_whole_blocks(params, monkeypatch):
    """Disaggregated serving between two gangs on the CPU fabric:
    ``start_replicas(2, hosts_per_replica=2, mesh="2x1", roles=["prefill",
    "decode"], kvfleet=True)``. The router sends each request to the
    prefill gang, which prefills it and ships its blocks (every rank's
    heads gathered into whole blocks) to the decode gang (each rank keeping
    its heads); the client follows the ship and the decode gang admits
    warm. The streams equal a one-rank replica's."""
    monkeypatch.setenv("RLT_NUM_GPUS", "0")
    monkeypatch.delenv("RLT_REQUIRE_GPU", raising=False)
    kw = dict(params=params, model_config=dataclasses.asdict(CFG),
              num_slots=2, prefill_buckets=[16, 32], decode_fold=2,
              prefill_chunk=8, prefix_blocks=16, prefix_block=4,
              watchdog=False)
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, 97, size=n).tolist(), m)
            for n, m in ((13, 5), (18, 4))]
    one = ServeReplica(device="cpu", **kw)
    try:
        want = []
        for p, n in reqs:
            rid = one.submit(p, max_new_tokens=n)
            got, cur, done = [], 0, False
            while not done:
                res = one.result(rid, cur, wait_s=1.0)
                got += res["tokens"]
                cur += len(res["tokens"])
                done = res["done"]
            want.append(got)
    finally:
        one.stop()
    fabric.init(num_cpus=4)
    try:
        client = start_replicas(
            2, hosts_per_replica=2, mesh="2x1", device="cpu",
            roles=["prefill", "decode"], kvfleet=True,
            env={"OMP_NUM_THREADS": "1"}, init_timeout=T, rpc_timeout_s=T,
            **kw)
        client.router = Router(client=client, refresh_s=0.0, prefix_block=4)
        assert [client.generate(p, max_new_tokens=n, timeout_s=T)
                for p, n in reqs] == want
        st = client.stats()
        assert [s["role"] for s in st] == ["prefill", "decode"]
        assert st[0]["kvfleet"]["ships"] == len(reqs)
        assert st[0]["kv_gather"]["bytes"] > 0
        assert st[1]["prefix"]["hit_tokens"] == sum(
            len(p) // 4 * 4 for p, _ in reqs)
        for idx in (0, 1):
            (follower,) = client.followers_of(idx)
            fs = fabric.get(follower.stats.remote(), timeout=T)
            assert fs["error"] is None and fs["alive"]
        client.shutdown()
    finally:
        fabric.shutdown()
