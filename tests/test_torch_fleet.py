"""A two-replica fleet of the port, end to end on the CPU:
``start_replicas`` -> ``ServeClient`` -> ``Router`` -> ``ServeReplica`` ->
``Scheduler`` -> ``DecodeEngine`` at a tiny width (2 layers, d_model 64),
each replica a fabric actor loading the weights from a checkpoint.

Greedy and sampled tokens equal the port's solo ``gpt_generate``, and
greedy tokens equal the JAX package's ``gpt_generate`` on the same weights
(``attn_impl="reference"``). The module also holds streaming cursors,
cancel, ``submit_many`` batching, the ``stats()``/``health()`` fields,
prefix affinity, the client journal's replay through
``replay_journal_router``, ``anatomy_from_client``, and a replica killed
mid-decode failing its requests over bit-exact onto the survivor (last:
it ends the fleet). One fleet serves the module; every wait is bounded.
"""
import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_lightning_tpu.models.gpt as jgpt
from ray_lightning_tpu_torch import fabric
from ray_lightning_tpu_torch.models import gpt as tgpt
from ray_lightning_tpu_torch.models.weights import params_from_jax
from ray_lightning_tpu_torch.obs.anatomy import anatomy_from_client
from ray_lightning_tpu_torch.obs.journal import (
    load_journal_streams,
    replay_journal_router,
)
from ray_lightning_tpu_torch.serve.client import start_replicas
from ray_lightning_tpu_torch.serve.router import Router
from ray_lightning_tpu_torch.serve.server import ServeReplica
from ray_lightning_tpu_torch.utils.state_stream import (
    state_stream_to_file,
    to_state_stream,
)

JAX_CFG = jgpt.GPTConfig(
    vocab_size=97,
    n_layer=2,
    n_head=4,
    n_kv_head=2,
    d_model=64,
    max_seq=128,
    attn_impl="reference",
    compute_dtype="float32",
)
CFG = tgpt.GPTConfig(**dataclasses.asdict(JAX_CFG))
T = 60.0  # every stream, RPC and spawn in this module is bounded by this
_jax_generate = jax.jit(jgpt.gpt_generate, static_argnums=(1, 3))

#: Prompts of 7, 12, 16 and 21 tokens; the first two share an 8-token
#: prefix, so the router's affinity sees a chain.
PROMPTS = [
    [5, 9, 2, 7, 1, 3, 8],
    [5, 9, 2, 7, 1, 3, 8, 4, 6, 6, 1, 2],
    list(range(3, 19)),
    [11] * 5 + list(range(40, 56)),
]
NEW = 10


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
    return (
        jax.tree_util.tree_map(jnp.asarray, tree),
        params_from_jax(tree, CFG, "cpu"),
    )


@pytest.fixture(scope="module")
def fleet(weights, tmp_path_factory):
    """Two replicas (one CPU each, no card) serving the checkpoint, with a
    router attached; torn down after the module."""
    _, params = weights
    ckpt = str(tmp_path_factory.mktemp("fleet") / "gpt.ckpt")
    state_stream_to_file(
        to_state_stream({"params": params,
                         "gpt_config": dataclasses.asdict(CFG)}), ckpt)
    saved = {k: os.environ.get(k) for k in ("RLT_NUM_GPUS",)}
    os.environ["RLT_NUM_GPUS"] = "0"
    fabric.init(num_cpus=4)
    try:
        client = start_replicas(
            2, ckpt_path=ckpt, num_slots=3, decode_fold=2,
            prefill_buckets=[8, 16, 32], device="cpu", rpc_timeout_s=T,
            init_timeout=T, kvfleet=False, env={"RLT_HEARTBEAT_S": "0.5"},
        )
        client.router = Router(client=client, refresh_s=0.0, prefix_block=4)
        yield client, ckpt
        client.shutdown()
    finally:
        fabric.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _solo(params, prompt, n, **kw):
    out = tgpt.gpt_generate(params, CFG, [prompt], n, device="cpu", **kw)
    return out[0, len(prompt):].tolist()


def _jax_solo(j_params, prompt, n):
    out = _jax_generate(j_params, JAX_CFG, jnp.asarray([prompt], jnp.int32),
                        n)
    return np.asarray(out)[0, len(prompt):].tolist()


def test_fleet_tokens_equal_solo_and_jax(fleet, weights):
    """Greedy through ``submit`` and sampled through ``submit_many``: every
    request's stream equals the solo run with its seed; greedy streams
    equal the JAX package's ``gpt_generate``; both replicas served."""
    client, _ = fleet
    j_params, params = weights
    greedy = [client.submit(p, max_new_tokens=NEW, request_id=f"g{i}")
              for i, p in enumerate(PROMPTS)]
    sampled = client.submit_many(
        PROMPTS, max_new_tokens=NEW, temperature=0.8, top_k=20, top_p=0.9,
        sampling=[{"seed": 100 + i, "request_id": f"s{i}"}
                  for i in range(len(PROMPTS))],
    )
    for p, h in zip(PROMPTS, greedy):
        got = list(client.stream_handle(h, timeout_s=T))
        assert got == _solo(params, p, NEW)
        assert got == _jax_solo(j_params, p, NEW)
    for i, (p, h) in enumerate(zip(PROMPTS, sampled)):
        assert list(client.stream_handle(h, timeout_s=T)) == _solo(
            params, p, NEW, temperature=0.8, top_k=20, top_p=0.9,
            seed=100 + i)
    finished = [s["finished"] for s in client.stats()]
    assert sum(finished) == 2 * len(PROMPTS) and min(finished) > 0


def test_stats_and_health_fields(fleet):
    client, _ = fleet
    for s in client.stats():
        assert s["compiles_since_init"] == 0
        assert s["compiled_count"] == 0  # no graphs on the CPU
        assert s["device"] == "cpu"
        assert s["kernels"] == {"launches": 0, "bwd_dkv_launches": 0,
                                "bwd_dq_launches": 0, "reference": 0,
                                "build_s": {}}
        assert s["health"] == "healthy" and s["preempt"] == {
            "pending": False}
        assert s["memory"]["kv_cache"]["bytes"] > 0
        assert s["fold_k"]["ladder"] == [2]
        assert any(k.startswith("rlt_serve_requests_total{")
                   for k in s["metrics"])
    for h in client.health():
        assert h["verdict"] == "healthy" and h["watchdog"] is True
        assert {"engine", "scheduler", "compiler"} <= set(h["components"])
    assert "rlt_serve_tokens_emitted_total" in client.metrics_text()
    rows = client.router.rows()
    assert [r["routable"] for r in rows["replicas"]] == [True, True]
    assert rows["routed"] >= 2 * len(PROMPTS)


def test_cursors_cancel_and_affinity(fleet, weights):
    _, params = fleet[0], weights[1]
    client, _ = fleet
    h = client.submit(PROMPTS[2], max_new_tokens=NEW, request_id="c0")
    want = _solo(params, PROMPTS[2], NEW)
    got, cursor = [], 0
    deadline = time.monotonic() + T
    while time.monotonic() < deadline:
        res = client.result(h, cursor)
        got += res["tokens"]
        cursor += len(res["tokens"])
        if res["done"]:
            break
        time.sleep(0.01)
    assert got == want and res["status"] == "finished"
    again = client.result(h, 3)  # a cursor re-reads the buffer's tail
    assert again["tokens"] == want[3:]
    long = client.submit(PROMPTS[0], max_new_tokens=100, request_id="c1")
    next(iter(client.stream_handle(long, timeout_s=T)))
    assert client.cancel(long) is True
    # The shared 8-token prefix: both follow the first's replica.
    first = client.submit(PROMPTS[1], max_new_tokens=2, request_id="a0")
    list(client.stream_handle(first, timeout_s=T))
    follow = client.submit(PROMPTS[1][:8] + [1, 1], max_new_tokens=2,
                           request_id="a1")
    assert follow.replica == first.replica
    list(client.stream_handle(follow, timeout_s=T))


def test_journal_replays_through_the_router(fleet, weights):
    """The replicas' journals, as one fleet capture, replay through a
    rebuilt router on one scheduler: every recorded submit planned and
    every compared stream bit-exact."""
    client, _ = fleet
    _, params = weights
    path = os.path.join(os.path.dirname(fleet[1]), "fleet.jsonl")
    with open(path, "w") as f:
        f.write(client.journal_jsonl())
    streams = load_journal_streams(path)
    assert sorted(j["replica"] for j in streams) == [0, 1]
    res = replay_journal_router(streams, params=params, model_config=None,
                                speed=50.0, device="cpu")
    assert res["exact"] is True and res["divergence"] is None
    assert res["lost"] == 0 and res["planned"] == res["requests"]
    assert res["compared"] >= 2 * len(PROMPTS)
    assert res["router"]["plan"]["requests"] == res["requests"]


def test_anatomy_from_client_covers_every_request(fleet):
    client, _ = fleet
    for rid in ("g0", "g3", "s1", "c0"):
        ledger = anatomy_from_client(client, rid)
        assert ledger["request_id"] == rid
        assert ledger["covered"], ledger
        assert ledger["observed_s"] > 0


def test_killed_replica_fails_over_bit_exact(fleet, weights):
    """Replica 1 waits 0.2 s at every fold boundary (fault delays), so its
    requests are mid-decode when it is killed after their first tokens:
    ``on_replica_lost`` resubmits them from the driver journal onto replica
    0, 0 lost, and every stream (the delivered first token deduplicated)
    equals the uninterrupted solo run."""
    client, _ = fleet
    _, params = weights
    client.inject_fault(1, [{"point": "fold_boundary", "action": "delay",
                             "seconds": 0.2, "after": k}
                            for k in range(1, 40)])
    hs = [client.submit(p, max_new_tokens=NEW, seed=i, request_id=f"k{i}",
                        replica=i % 2)
          for i, p in enumerate(PROMPTS)]
    streams = [client.stream_handle(h, timeout_s=T) for h in hs]
    first = [next(st) for st in streams]
    fabric.kill(client._actor(1))
    moved = client.on_replica_lost(1, reason="killed by the test")
    assert moved == {"resubmitted": ["k1", "k3"], "lost": []}
    for p, tok, st in zip(PROMPTS, first, streams):
        assert [tok] + list(st) == _solo(params, p, NEW)
    assert client.excluded() == [1]
    stats = client.stats()
    assert stats[1]["unreachable"] is True
    assert stats[0]["compiles_since_init"] == 0


def test_replica_refuses_unported_options(weights, tmp_path):
    """The gang options (item 11) and the profiler (item 14) still raise
    naming their item. The fleet KV plane and the KV object store options
    (item 9) now build: a replica given an inbox, peers and the plane's
    budgets runs a plane, one given ``kvstore_dir`` a store; a prefill
    role without a prefix pool is refused; without a plane ``ship_to``
    and ``kv_hint`` are ignored and the request decodes here."""
    import queue

    _, params = weights
    for kw, item in (({"dist": {"num_hosts": 2}}, "item 11"),
                     ({"gang_queues": [object()]}, "item 11"),
                     ({"mesh": "2x1"}, "item 11")):
        with pytest.raises(NotImplementedError, match=item):
            ServeReplica(params=params, model_config=CFG, device="cpu",
                         watchdog=False, **kw)
    with pytest.raises(ValueError, match="prefix pool"):
        ServeReplica(params=params, model_config=CFG, device="cpu",
                     watchdog=False, role="prefill")
    with pytest.raises(ValueError, match="unknown replica role"):
        ServeReplica(params=params, model_config=CFG, device="cpu",
                     watchdog=False, role="bogus")
    inbox, peer = queue.Queue(), queue.Queue()
    rep = ServeReplica(
        params=params, model_config=CFG, device="cpu", num_slots=2,
        watchdog=False, prefix_blocks=16, prefix_block=4, prefill_chunk=4,
        role="prefill", kv_self=1, kv_inbox=inbox, kv_peers={0: peer, 1: inbox},
        kvfleet_timeout_s=1.0, kvfleet_inflight_mb=1.0,
        kvfleet_bandwidth_mbps=1.0, kvfleet_layerwise=True,
        kvstore_dir=str(tmp_path / "kv"), kvstore_mb=1.0,
        kvstore_namespace="ns", kvstore_writethrough=True,
    )
    try:
        st = rep.stats()
        plane, store = st["kvfleet"], st["kvstore"]
        assert (st["role"], plane["role"], plane["peers"]) == (
            "prefill", "prefill", 2)
        assert plane["timeout_s"] == 1.0 and plane["max_inflight_mb"] == 1.0
        assert plane["layerwise"] is True
        assert rep.kvfleet.bandwidth_bytes_per_s == 1 << 20
        assert store["path"] == str(tmp_path / "kv")
        assert store["namespace"] == "ns" and store["budget_mb"] == 1.0
        assert rep.scheduler.kvstore_writethrough is True
        assert rep.register_kv_peer(2, queue.Queue()) is True
        assert rep.kvfleet.stats()["peers"] == 3
        header = rep.journal_dump()["header"]
        assert header["kvfleet"]["role"] == "prefill"
        assert header["kvstore"]["writethrough"] is True
        # A submit with a ship target runs the prefill and ships.
        prompt = list(range(1, 10))
        rid = rep.submit(prompt, max_new_tokens=3, ship_to=0)
        deadline = time.monotonic() + T
        res = rep.result(rid, 0, wait_s=0.1)
        while not res["done"] and time.monotonic() < deadline:
            res = rep.result(rid, 0, wait_s=0.1)
        assert res["status"] == "shipped" and res["ship_to"] == 0
        assert res["tokens"] == _solo(params, prompt, 1)
        assert len(res["ship_digests"]) == 2
        kind, body = peer.get(timeout=T)
        assert kind == "ship_layer" and body["request_id"] == rid
        # Parking writes the chain through to the store and frees it.
        parked = rep.park_session(prompt)
        assert parked["stored"] == parked["blocks"] == 2
        # The store's rings go out as bare digests, the router's form.
        writes = rep.stats()["kvstore"]["recent_writes"]
        assert set(res["ship_digests"]) <= set(writes)
        assert all(len(bytes.fromhex(h)) == 16 for h in writes)
    finally:
        rep.stop()
    rep = ServeReplica(params=params, model_config=CFG, device="cpu",
                       num_slots=2, watchdog=False)
    try:
        for call, err, item in (
                (lambda: rep.park_session([1, 2]), RuntimeError, "kvstore_dir"),
                (lambda: rep.profile(1.0), NotImplementedError, "item 14")):
            with pytest.raises(err, match=item):
                call()
        assert rep.register_kv_peer(1, None) is False
        rid = rep.submit([1, 2, 3], max_new_tokens=3, ship_to=1,
                         kv_hint={"peer": 1, "digests": [], "blocks": 0})
        deadline = time.monotonic() + T
        res = rep.result(rid, 0, wait_s=0.1)
        while not res["done"] and time.monotonic() < deadline:
            res = rep.result(rid, 0, wait_s=0.1)
        assert res["tokens"] == _solo(params, [1, 2, 3], 3)
        assert "ship_to" not in res
    finally:
        rep.stop()
