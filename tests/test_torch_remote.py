"""The port's remote fabric: a head (``python -m
ray_lightning_tpu_torch.fabric.server``) in a subprocess owns the actors,
the object store and the queues; this process connects in client mode
with ``fabric.init(address=..., authkey=...)`` and drives them.

The port of the JAX package's ``tests/test_client.py`` cases (basic
operations, the authkey, placement groups, a worker's exception), plus
what the port adds to the wire: a worker's result of a megabyte or more
(parked in shared memory on the head) comes back as a value; a serving
replica started through ``start_replicas`` in client mode serves tokens
bitwise the uninterrupted run; and a ``RayStrategy`` fit launched through
client mode gives bitwise the same losses and parameters as the same fit
in local mode. One head serves the module; every wait is bounded.
"""
import numpy as np
import pytest
import torch

from ray_lightning_tpu_torch import fabric
from ray_lightning_tpu_torch.fabric import client as fclient
from ray_lightning_tpu_torch.launchers.utils import TrainWorker
from ray_lightning_tpu_torch.strategies import RayStrategy
from ray_lightning_tpu_torch.trainer import Trainer
from tests import _torch_dist_worker as W
from tests import _torch_tiny_serve as S
from tests._torch_fabric_head import fabric_head

T = 60.0


@pytest.fixture(scope="module")
def head():
    with fabric_head(num_cpus=8) as (address, key):
        yield address, key


@pytest.fixture
def connected(head, monkeypatch):
    """Client mode for one test, with the head's key in the environment
    (as an operator would pass it); disconnected afterwards."""
    address, key = head
    monkeypatch.setenv("RLT_FABRIC_AUTHKEY", key)
    fabric.init(address=address)
    yield address
    fabric.shutdown()


def test_client_basic_ops(connected):
    assert fclient.is_connected() and fabric.is_initialized()
    assert fabric.cluster_resources()["CPU"] == 8
    ref = fabric.put({"arr": np.arange(5)})
    np.testing.assert_array_equal(fabric.get(ref)["arr"], np.arange(5))
    actor = fabric.remote(TrainWorker).options(num_cpus=1).remote()
    assert actor.node_id == "node-0" and actor.visible_cards == []

    def add(a, b):
        return a + b

    fut = actor.execute.remote(add, 2, 3)
    done, pending = fabric.wait([fut], timeout=T)
    assert done and not pending
    assert fabric.get(fut) == 5

    # A worker's get of a head ObjectRef (shared memory on the head).
    def load(r):
        from ray_lightning_tpu_torch import fabric as f

        return int(f.get(r)["arr"].sum())

    assert fabric.get(actor.execute.remote(load, ref), timeout=T) == 10
    assert actor.is_alive()
    fabric.kill(actor)
    fabric.free([ref])
    assert fabric.available_resources()["CPU"] == 8
    fabric.shutdown()
    assert not fclient.is_connected()


def test_client_auth_required_and_rejected(head, monkeypatch):
    """Reaching the port is not enough: a missing key fails with guidance,
    a wrong key is rejected by the HMAC challenge, and the head's
    generated key works."""
    address, key = head
    with pytest.raises(RuntimeError, match="rejected the authkey"):
        fclient.FabricClient(address, authkey="wrong-" + key)
    monkeypatch.delenv("RLT_FABRIC_AUTHKEY", raising=False)
    with pytest.raises(RuntimeError, match="needs the server's authkey"):
        fclient.FabricClient(address)
    c = fclient.FabricClient(address, authkey=key)
    assert c.request(("cluster_resources",))["CPU"] == 8
    c.close()


def test_client_placement_group(connected):
    """The reservation lives on the head, actors schedule into bundles by
    id, an exhausted bundle refuses naming itself, removal frees it."""
    total = fabric.available_resources()["CPU"]
    pg = fabric.placement_group([{"CPU": 1}, {"CPU": 2}], strategy="PACK")
    assert len(pg.bundle_node_ids) == 2
    assert fabric.available_resources()["CPU"] == total - 3
    actor = fabric.remote(TrainWorker).options(
        num_cpus=2, placement_group=pg, placement_group_bundle_index=1,
    ).remote()
    assert fabric.available_resources()["CPU"] == total - 3
    assert actor.node_id == pg.bundle_node_ids[1]
    with pytest.raises(fabric.InsufficientResourcesError, match="bundle 1"):
        fabric.remote(TrainWorker).options(
            num_cpus=1, placement_group=pg, placement_group_bundle_index=1
        ).remote()
    fabric.kill(actor)
    fabric.remove_placement_group(pg)
    assert pg.removed and fabric.available_resources()["CPU"] == total


def test_client_exceptions_large_results_and_queues(connected):
    """A worker's exception reaches the client with its type; a result of
    3 MiB, which the worker parks in shared memory on the head, comes
    back over the wire as the value; a queue made in client mode lives on
    the head, where an actor puts to it; ``kill(no_restart=False)`` stays
    rejected."""
    actor = fabric.remote(TrainWorker).options(num_cpus=1).remote()

    def boom():
        raise ValueError("kaboom")

    with pytest.raises(ValueError, match="kaboom"):
        fabric.get(actor.execute.remote(boom), timeout=T)

    def big():
        return bytes(range(256)) * (3 << 12)

    assert fabric.get(actor.execute.remote(big), timeout=T) == big()
    q = fabric.Queue()
    assert isinstance(q, fclient.ClientQueue)

    def put(queue):
        queue.put({"from": "worker"})
        return True

    assert fabric.get(actor.execute.remote(put, q), timeout=T)
    assert q.get(timeout=T) == {"from": "worker"} and q.empty()
    q.shutdown()
    with pytest.raises(ValueError, match="no_restart=False"):
        fabric.kill(actor, no_restart=False)
    fabric.kill(actor)


def test_remote_replica_serves_bit_exact(connected, tmp_path):
    """``start_replicas(1)`` through client mode: the replica runs on the
    head, every request (greedy and seeded sampled) streams bitwise the
    uninterrupted run, and its graphs stay frozen."""
    from ray_lightning_tpu_torch.serve.client import start_replicas

    tree = S.numpy_params()
    ckpt = S.write_ckpt(tmp_path, tree)
    engine = dict(num_slots=2, max_seq=64, decode_fold=2,
                  prefill_buckets=[16])
    jobs = S.jobs(4, seed=5, plen=10, new=8)
    expected = S.baseline(tree, engine, jobs)
    client = start_replicas(1, ckpt_path=ckpt, device="cpu",
                            rpc_timeout_s=T, init_timeout=T, **engine)
    try:
        assert client.can_respawn()
        hs = [client.submit(p, **s) for p, s in jobs]
        assert [list(client.stream_handle(h, timeout_s=T))
                for h in hs] == expected
        stats = client.stats()[0]
        assert stats["finished"] == len(jobs)
        assert stats["compiles_since_init"] == 0
        assert client.replica_is_alive(0)
    finally:
        client.shutdown()
    assert fabric.available_resources()["CPU"] == 8


def _fit(root):
    record = W.Record()
    cfg = dict(vocab_size=64, n_layer=1, n_head=2, d_model=32, max_seq=32,
               attn_impl="reference")
    module = W.SharedGPT(cfg, batch_size=4, n_train=16, warmup_steps=1)
    trainer = Trainer(
        strategy=RayStrategy(num_workers=2, use_gpu=False), seed=0,
        max_epochs=1, log_every_n_steps=1, limit_val_batches=1,
        enable_checkpointing=False, enable_model_summary=False,
        default_root_dir=str(root), callbacks=[record])
    trainer.fit(module)
    assert trainer.state["status"] == "finished"
    return record.losses, module.params


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_ray_strategy_fit_through_client_mode_matches_local(
        head, tmp_path, monkeypatch):
    """The same two-rank ``RayStrategy`` fit (gloo) launched in local mode
    and through client mode, where its workers run on the head: bitwise
    the same losses and parameters."""
    monkeypatch.setenv("RLT_NUM_GPUS", "0")
    monkeypatch.delenv("RLT_REQUIRE_GPU", raising=False)
    fabric.init(num_cpus=4)
    try:
        local = _fit(tmp_path / "local")
    finally:
        fabric.shutdown()
    address, key = head
    fabric.init(address=address, authkey=key)
    try:
        remote = _fit(tmp_path / "remote")
    finally:
        fabric.shutdown()
    assert len(local[0]) == 2 and remote[0] == local[0]
    lp, rp = _flat(local[1]), _flat(remote[1])
    assert lp.keys() == rp.keys()
    assert all(torch.equal(lp[k], rp[k]) for k in lp), [
        k for k in lp if not torch.equal(lp[k], rp[k])]
