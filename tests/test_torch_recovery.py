"""The port's recovery plane on a tiny CPU fleet: two replicas through
``start_replicas`` (chunked prefill, a prefix pool, the fleet KV plane
on), each a fabric actor loading one checkpoint, and a
``FleetSupervisor`` on its thread.

- A replica killed by a fault at a fold boundary: its requests fail over,
  the supervisor restarts it from the retained spawn recipe (same config,
  bundle, inbox and peers), and every stream and the restarted replica's
  own tokens equal the uninterrupted run, greedy and seeded.
- A ``preempt`` fault with a grace window: the supervisor drains the
  replica (its requests migrate with their exported prefix KV, warm on the
  survivor), pre-spawns the replacement on fresh capacity and swaps it
  in; 0 lost, every stream bitwise the uninterrupted run.
- ``add_replica`` and ``retire_replica``: an added replica serves
  bitwise; retiring it with a request open migrates that request.

The uninterrupted run is the same engine configuration in process, one
request at a time; its greedy tokens equal the JAX package's
``gpt_generate`` on the same weights. One fleet serves the module, in
file order; every wait is bounded.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_lightning_tpu.models.gpt as jgpt
from ray_lightning_tpu_torch import fabric
from ray_lightning_tpu_torch.obs.events import EventLog, get_event_log
from ray_lightning_tpu_torch.obs.registry import MetricsRegistry
from ray_lightning_tpu_torch.serve.client import start_replicas
from ray_lightning_tpu_torch.serve.supervisor import FleetSupervisor
from tests import _torch_tiny_serve as S

T = 60.0  # every stream, RPC, spawn and wait in this module is bounded
ENGINE = dict(num_slots=2, max_seq=64, decode_fold=2, prefill_chunk=8,
              prefix_blocks=8, prefix_block=8)
#: Six requests of 12 prompt tokens, one sampled: the chaos-kill wave
#: (8 new tokens) and the preemption wave (40 new tokens, so a resident
#: request cannot finish inside half the grace window at 0.5 s a fold).
KILL_JOBS = S.jobs(6, seed=3, plen=12, new=8)
PREEMPT_JOBS = S.jobs(6, seed=4, plen=12, new=40)


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    tree = S.numpy_params()
    ckpt = S.write_ckpt(tmp_path_factory.mktemp("recovery"), tree)
    expected = {
        "kill": S.baseline(tree, ENGINE, KILL_JOBS),
        "preempt": S.baseline(tree, ENGINE, PREEMPT_JOBS),
    }
    mp = pytest.MonkeyPatch()
    mp.setenv("RLT_NUM_GPUS", "0")
    mp.delenv("RLT_REQUIRE_GPU", raising=False)
    fabric.init(num_cpus=4)
    try:
        client = start_replicas(
            2, ckpt_path=ckpt, device="cpu", rpc_timeout_s=T,
            init_timeout=T, env={"RLT_HEARTBEAT_S": "0.5"}, **ENGINE)
        yield {"client": client, "tree": tree, "expected": expected}
        client.shutdown()
    finally:
        fabric.shutdown()
        mp.undo()


def _supervisor(client):
    events = EventLog()
    sup = FleetSupervisor(
        client, interval_s=0.2, restart_backoff_s=0.2, restart_limit=3,
        probe_timeout_s=T, registry=MetricsRegistry(), events=events,
    ).start()
    return sup, events


def _wait(cond, what):
    deadline = time.monotonic() + T
    while not cond():
        if time.monotonic() > deadline:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.05)


def _stream_all(client, handles):
    return [list(client.stream_handle(h, timeout_s=T)) for h in handles]


def test_supervisor_restarts_a_killed_replica_bit_exact(fleet):
    """The chaos kill (JAX ``tests/test_failover.py:787``, its
    fold-boundary case): replica 1 dies at its 2nd fold boundary under
    load; its requests fail over and every stream equals the
    uninterrupted run, 0 lost; the supervisor goes dead -> healthy
    through a restart within its backoff; the restarted replica (the same
    recipe: its graphs plan, its inbox) serves bitwise."""
    client, expected = fleet["client"], fleet["expected"]["kill"]
    # The oracle's greedy tokens are the JAX package's.
    j_params = jax.tree_util.tree_map(jnp.asarray, fleet["tree"])
    jcfg = jgpt.GPTConfig(**{k: getattr(S.CFG, k) for k in (
        "vocab_size", "n_layer", "n_head", "n_kv_head", "d_model",
        "max_seq", "attn_impl", "compute_dtype")})
    for (prompt, sampling), want in zip(KILL_JOBS, expected):
        if "temperature" not in sampling:
            out = jgpt.gpt_generate(j_params, jcfg,
                                    jnp.asarray([prompt], jnp.int32), 8)
            assert np.asarray(out)[0, len(prompt):].tolist() == want
    before = client.stats()[1]
    old = client._actor(1)
    sup, events = _supervisor(client)
    try:
        client.inject_fault(1, [{"point": "fold_boundary",
                                 "action": "kill", "after": 2}])
        handles = [client.submit(p, **s) for p, s in KILL_JOBS]
        assert _stream_all(client, handles) == expected
        assert any(h.replica == 1 for h in handles)
        _wait(lambda: (sup.rows()[1]["restarts"] >= 1
                       and sup.rows()[1]["state"] == "healthy"),
              "the supervisor's restart")
        names = [e["name"] for e in events.tail(64)]
        assert "replica_restarted" in names
        client_names = [e["name"] for e in get_event_log().tail(512)]
        assert {"replica_lost", "failover",
                "replica_respawned"} <= set(client_names)
        assert client._actor(1) is not old and client.alive_replicas() == [
            0, 1]
        h = client.submit(KILL_JOBS[0][0], replica=1, **KILL_JOBS[0][1])
        assert list(client.stream_handle(h, timeout_s=T)) == expected[0]
        after = client.stats()[1]
        assert after["compiled_count"] == before["compiled_count"]
        assert after["compiles_since_init"] == 0
        assert after["role"] == before["role"] and after["kvfleet"]
        assert after["startup"]["init_end"] > before["startup"]["init_end"]
    finally:
        sup.stop()


def test_preempt_drains_prespawns_and_swaps_in_bit_exact(fleet):
    """The chaos preemption (JAX ``tests/test_preempt.py:949``): a
    ``preempt`` fault gives replica 0 a 6 s grace window at its 2nd fold
    boundary, and 0.5 s delays at every fold boundary make its decode
    rate so slow that its residents cannot finish inside half the
    window; the supervisor drains it (every
    migrant resubmitted on the survivor with its exported prefix blocks,
    warm there), pre-spawns its replacement on fresh capacity and swaps
    it in once nothing is routed to it. 0 lost; every stream and the
    replacement's own tokens equal the uninterrupted run."""
    client, expected = fleet["client"], fleet["expected"]["preempt"]
    hits0 = client.stats()[1]["prefix"]["hit_tokens"]
    old = client._actor(0)
    sup, events = _supervisor(client)
    try:
        plan = [{"point": "fold_boundary", "action": "preempt",
                 "after": 2, "seconds": 6.0}]
        plan += [{"point": "fold_boundary", "action": "delay",
                  "seconds": 0.5, "after": k} for k in range(1, 40)]
        client.inject_fault(0, plan)
        handles = [client.submit(p, **s) for p, s in PREEMPT_JOBS]
        assert _stream_all(client, handles) == expected
        assert any(h.replica == 0 for h in handles)
        _wait(lambda: any(e["name"] == "replica_preempt_replaced"
                          for e in events.tail(64)), "the swap")
        (drained,) = [e for e in events.tail(64)
                      if e["name"] == "replica_preempt_drained"]
        assert drained["migrated"] >= 1 and drained["lost"] == 0
        assert drained["kv_blocks"] >= 1
        names = [e["name"] for e in get_event_log().tail(512)]
        assert {"replica_prespawned", "preempt_drain"} <= set(names)
        row = sup.rows()[0]
        assert row["state"] == "healthy" and row["preemptions"] == 1
        assert client._actor(0) is not old and not client._prespawned
        # The migrants' imported blocks served warm on the survivor.
        assert client.stats()[1]["prefix"]["hit_tokens"] >= hits0 + 8
        h = client.submit(PREEMPT_JOBS[0][0], replica=0,
                          **PREEMPT_JOBS[0][1])
        assert list(client.stream_handle(h, timeout_s=T)) == expected[0]
    finally:
        sup.stop()


def test_add_and_retire_replica_bit_exact(fleet):
    """Scale up and down on the live fleet (JAX ``tests/test_router.py:
    1051``, its client half): ``add_replica`` spawns index 2 on fresh
    capacity, with an inbox of its own that the fleet adopts, and it
    serves bitwise; ``retire_replica`` with a request still open on it
    migrates the request (0 lost, bitwise) and leaves a tombstone."""
    client, expected = fleet["client"], fleet["expected"]["kill"]
    assert client.add_replica() == 2
    assert client.alive_replicas() == [0, 1, 2]
    s2 = client.stats()[2]
    assert s2["kvfleet"] and s2["compiles_since_init"] == 0
    assert 2 in client._kv_queues
    h = client.submit(KILL_JOBS[1][0], replica=2, **KILL_JOBS[1][1])
    assert list(client.stream_handle(h, timeout_s=T)) == expected[1]
    client.inject_fault(2, [{"point": "fold_boundary", "action": "delay",
                             "seconds": 0.3, "after": k}
                            for k in range(1, 40)])
    hold = client.submit(KILL_JOBS[3][0], replica=2, **KILL_JOBS[3][1])
    res = client.retire_replica(2, drain_timeout_s=0.0)
    assert res == {"migrated": [hold.request_id], "lost": []}
    assert list(client.stream_handle(hold, timeout_s=T)) == expected[3]
    assert client.alive_replicas() == [0, 1] and client.is_retired(2)
    assert client.stats()[2] == {"retired": True, "health": "retired"}
