"""The port's fabric (``ray_lightning_tpu_torch/fabric``) held to the
contract of the JAX package's ``tests/test_fabric.py`` and
``tests/test_placement.py``: actors, put/get/wait over shared memory,
eager constructor failure, ``InsufficientResourcesError``, ``kill``
releasing resources, placement groups, queues and heartbeats. It also
holds the accelerator resource: the GPU probe under ``RLT_NUM_GPUS``,
``RLT_REQUIRE_GPU=1`` with no card, and the cards an actor sees through
``CUDA_VISIBLE_DEVICES`` (whole cards its own, fractions packed onto one
card).

This module imports neither JAX nor the JAX package: its actor classes are
pickled by reference, so every worker imports it. Every wait is bounded.
"""
import os
import time

import numpy as np
import pytest

from ray_lightning_tpu_torch import fabric
from ray_lightning_tpu_torch.fabric import cluster_utils, core
from ray_lightning_tpu_torch.fabric.core import InsufficientResourcesError

T = 60.0  # every fabric.get in this module is bounded by this


class Counter:
    def __init__(self, start=0):
        self.value = start

    def incr(self, by=1):
        self.value += by
        return self.value

    def get_env(self, key):
        return os.environ.get(key)

    def execute(self, fn, *args, **kwargs):
        return fn(*args, **kwargs)

    def boom(self):
        raise ValueError("intentional")


class BrokenCtor:
    def __init__(self):
        raise RuntimeError("ctor failed on purpose")


class Probe:
    def node(self):
        return os.environ.get("RLT_NODE_ID")


@pytest.fixture
def port_fabric(monkeypatch):
    """Init the port's fabric with no cards (unless a test overrides
    ``RLT_NUM_GPUS``); always shut down after the test."""
    monkeypatch.setenv("RLT_NUM_GPUS", "0")
    monkeypatch.delenv("RLT_REQUIRE_GPU", raising=False)

    def _start(**kwargs):
        fabric.init(**kwargs)
        return fabric

    yield _start
    fabric.shutdown()


def test_actor_roundtrip_exceptions_and_closures(port_fabric):
    f = port_fabric(num_cpus=2)
    actor = f.remote(Counter).options(num_cpus=1).remote(10)
    assert f.get(actor.incr.remote(5), timeout=T) == 15
    with pytest.raises(ValueError, match="intentional"):
        f.get(actor.boom.remote(), timeout=T)
    assert f.get(actor.incr.remote(), timeout=T) == 16  # it survived
    captured = 41
    assert f.get(actor.execute.remote(lambda x: captured + x, 1),
                 timeout=T) == 42
    f.kill(actor)
    assert not actor.is_alive()


def test_object_store_put_get_and_free(port_fabric):
    f = port_fabric(num_cpus=1)
    big = {"w": np.arange(10000, dtype=np.float32), "meta": "hello"}
    ref = f.put(big)
    assert f.get(ref)["meta"] == "hello"
    actor = f.remote(Counter).options(num_cpus=1).remote()

    def load(r):
        obj = fabric.get(r)
        return float(obj["w"].sum()), obj["meta"]

    total, meta = f.get(actor.execute.remote(load, ref), timeout=T)
    assert total == float(big["w"].sum()) and meta == "hello"
    f.free([ref])
    assert ref.id not in core._session.store


@pytest.fixture
def unparked(monkeypatch):
    """The shared-memory segments the driver's readers took frames from."""
    names = []
    real = core._unpark

    def record(name, size):
        names.append(name)
        return real(name, size)

    monkeypatch.setattr(core, "_unpark", record)
    return names


def test_large_results_are_parked_and_never_outlive_their_read(port_fabric,
                                                               unparked):
    """A result of SHM_FRAME_BYTES or more comes back through a segment
    the driver unlinks as it reads it, even when the result loop raises
    afterwards: here "rank 0" returns a parked result and a later call,
    its "peer", fails, so ``process_results`` raises."""
    from ray_lightning_tpu_torch.fabric.worker import SHM_FRAME_BYTES
    from ray_lightning_tpu_torch.launchers.utils import process_results

    f = port_fabric(num_cpus=1)
    actor = f.remote(Counter).options(num_cpus=1).remote()
    blob = np.random.default_rng(0).bytes(3 * SHM_FRAME_BYTES)
    assert f.get(actor.execute.remote(lambda b: b, blob), timeout=T) == blob
    assert f.get(actor.incr.remote(), timeout=T) == 1  # small: the pipe
    assert len(unparked) == 1

    def late_failure():
        time.sleep(0.5)
        raise RuntimeError("peer failed after rank 0 returned")

    futures = [actor.execute.remote(lambda: b"x" * (2 * SHM_FRAME_BYTES)),
               actor.execute.remote(late_failure)]
    with pytest.raises(RuntimeError, match="after rank 0 returned"):
        process_results(futures)
    assert len(unparked) == 2
    for name in unparked:
        assert not os.path.exists(os.path.join("/dev/shm", name))


def test_env_overrides_and_node_identity(port_fabric):
    f = port_fabric(num_cpus=1)
    actor = (f.remote(Counter)
             .options(num_cpus=1, env={"RLT_TEST_MARKER": "xyz"}).remote())
    assert f.get(actor.get_env.remote("RLT_TEST_MARKER"), timeout=T) == "xyz"
    assert f.get(actor.get_env.remote("RLT_NODE_ID"), timeout=T) == "node-0"
    # The worker's import path starts at the checkout that holds the port.
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = f.get(actor.get_env.remote("PYTHONPATH"), timeout=T)
    assert path.split(os.pathsep)[0] == checkout


def test_resource_accounting_and_kill_releases(port_fabric):
    f = port_fabric(num_cpus=2, resources={"extra": 4})
    assert f.cluster_resources()["CPU"] == 2
    assert f.cluster_resources()["extra"] == 4
    a1 = f.remote(Counter).options(num_cpus=1,
                                   resources={"extra": 3}).remote()
    avail = f.available_resources()
    assert avail["CPU"] == 1 and avail["extra"] == 1
    with pytest.raises(InsufficientResourcesError):
        f.remote(Counter).options(num_cpus=1, resources={"extra": 2}).remote()
    f.kill(a1)
    avail = f.available_resources()
    assert (avail["CPU"], avail["extra"]) == (2.0, 4.0)
    with pytest.raises(ValueError, match="no_restart"):
        f.kill(a1, no_restart=False)


def test_eager_ctor_failure_releases_resources(port_fabric):
    f = port_fabric(num_cpus=1)
    with pytest.raises(RuntimeError, match="ctor failed on purpose"):
        f.remote(BrokenCtor).options(num_cpus=1, init_timeout=T).remote()
    assert f.available_resources()["CPU"] == 1.0
    assert core._session.actors == {}


def test_wait_poll_and_queue(port_fabric):
    f = port_fabric(num_cpus=1)
    actor = f.remote(Counter).options(num_cpus=1).remote()

    def slow():
        time.sleep(0.5)
        return "done"

    ref = actor.execute.remote(slow)
    done, pending = f.wait([ref], timeout=0)
    assert done == [] and pending == [ref]
    done, pending = f.wait([ref], timeout=T)
    assert done == [ref] and pending == []
    assert f.get(ref, timeout=T) == "done"
    q = fabric.Queue()

    def produce(queue):
        queue.put((0, "payload"))
        return True

    assert f.get(actor.execute.remote(produce, q), timeout=T)
    assert q.get(timeout=T) == (0, "payload")


def test_actor_death_detected_and_released(port_fabric):
    f = port_fabric(num_cpus=1)
    actor = f.remote(Counter).options(num_cpus=1).remote()

    def die():
        os._exit(17)

    with pytest.raises(fabric.ActorDiedError):
        f.get(actor.execute.remote(die), timeout=T)
    deadline = time.monotonic() + T
    while f.available_resources()["CPU"] < 1 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert f.available_resources()["CPU"] == 1.0


def test_results_cache_bounded_and_evicted_fails_loudly(port_fabric):
    f = port_fabric(num_cpus=1)
    actor = f.remote(Counter).options(num_cpus=1).remote()
    old_cap = core._session.RESULTS_CAP
    core._session.RESULTS_CAP = 4
    try:
        stale = actor.incr.remote()
        f.get(stale, timeout=T)
        for _ in range(12):
            f.get(actor.incr.remote(), timeout=T)
        assert len(core._session.results) <= 4
        with pytest.raises(fabric.FabricError, match="evicted"):
            f.get(stale, timeout=T)
    finally:
        core._session.RESULTS_CAP = old_cap


def test_heartbeats_and_lifecycle_events(port_fabric):
    from ray_lightning_tpu_torch.obs.events import get_event_log

    f = port_fabric(num_cpus=1)
    actor = (f.remote(Counter)
             .options(num_cpus=1, env={"RLT_HEARTBEAT_S": "0.1"}).remote())
    f.get(actor.incr.remote(), timeout=T)
    deadline = time.monotonic() + T
    while (f.heartbeats().get(actor.actor_id, {}).get("calls_handled", 0) < 1
           and time.monotonic() < deadline):
        time.sleep(0.05)
    beat = f.heartbeats()[actor.actor_id]
    assert beat["pid"] > 0 and beat["calls_handled"] >= 1
    assert beat["age_s"] >= 0
    names = [(e["name"], e.get("actor")) for e in
             get_event_log().tail(64, subsystem="fabric")]
    assert ("actor_start", actor.actor_id) in names
    f.kill(actor)
    assert ("actor_kill", actor.actor_id) in [
        (e["name"], e.get("actor")) for e in
        get_event_log().tail(64, subsystem="fabric")]


def test_sigterm_handler_silent_once_exiting():
    from ray_lightning_tpu_torch.fabric import worker as w

    old = w._EXITING
    try:
        w._EXITING = False
        with pytest.raises(SystemExit):
            w._on_sigterm()
        assert w._EXITING
        w._on_sigterm()  # a late delivery mid-finalizer is silent
    finally:
        w._EXITING = old


# -- GPUs -------------------------------------------------------------------
def test_gpu_probe_override_and_require(monkeypatch):
    """``RLT_NUM_GPUS`` sets the count without a probe; an empty
    ``CUDA_VISIBLE_DEVICES`` hides every card; ``RLT_REQUIRE_GPU=1`` with
    no card raises and publishes no session, and a retry with a card
    succeeds."""
    monkeypatch.setenv("RLT_NUM_GPUS", "3")
    assert core._detect_local_capacity()["GPU"] == 3.0
    monkeypatch.delenv("RLT_NUM_GPUS")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert "GPU" not in core._detect_local_capacity()
    monkeypatch.setenv("RLT_REQUIRE_GPU", "1")
    with pytest.raises(fabric.FabricError, match="RLT_REQUIRE_GPU"):
        fabric.init()
    assert core._session is None
    monkeypatch.setenv("RLT_NUM_GPUS", "1")
    fabric.init(num_cpus=1)
    try:
        assert fabric.cluster_resources()["GPU"] == 1.0
    finally:
        fabric.shutdown()


def test_gpu_probe_finds_no_card_here(monkeypatch):
    """With no override the probe runs in a child process (``nvidia-smi
    -L``, else ``torch.cuda.device_count()``): this machine has no card,
    so ``RLT_REQUIRE_GPU=1`` makes ``init`` fail."""
    monkeypatch.delenv("RLT_NUM_GPUS", raising=False)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setenv("RLT_REQUIRE_GPU", "1")
    if core._probe_gpus():
        pytest.skip("this machine has a GPU")
    with pytest.raises(fabric.FabricError, match="no GPU detected"):
        fabric.init()
    assert core._session is None


def test_gpu_actors_see_their_cards(port_fabric, monkeypatch):
    """Whole cards are each actor's own (``CUDA_VISIBLE_DEVICES`` names
    them), fractions pack onto one card, an oversubscribed card refuses
    the spawn, and ``kill`` hands the share back."""
    monkeypatch.setenv("RLT_NUM_GPUS", "2")
    f = port_fabric(num_cpus=4)
    a = f.remote(Counter).options(num_cpus=1, num_gpus=1).remote()
    h1 = f.remote(Counter).options(num_cpus=1, num_gpus=0.5).remote()
    h2 = f.remote(Counter).options(num_cpus=1, num_gpus=0.5).remote()
    seen = [f.get(x.get_env.remote("CUDA_VISIBLE_DEVICES"), timeout=T)
            for x in (a, h1, h2)]
    assert seen == ["0", "1", "1"]
    assert a.visible_cards == ["0"] and h2.visible_cards == ["1"]
    assert f.available_resources()["GPU"] == 0.0
    with pytest.raises(InsufficientResourcesError):
        f.remote(Counter).options(num_cpus=1, num_gpus=0.5).remote()
    f.kill(h1)
    h3 = f.remote(Counter).options(num_cpus=1, num_gpus=0.5).remote()
    assert f.get(h3.get_env.remote("CUDA_VISIBLE_DEVICES"), timeout=T) == "1"
    f.kill(a)
    b = f.remote(Counter).options(num_cpus=1, num_gpus=1).remote()
    assert f.get(b.get_env.remote("CUDA_VISIBLE_DEVICES"), timeout=T) == "0"
    assert core._session.nodes[0].gpus == {"0": 1.0, "1": 1.0}
    for x in (b, h2, h3):
        f.kill(x)
    assert core._session.nodes[0].gpus == {"0": 0.0, "1": 0.0}


def test_client_mode_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 10b"):
        fabric.init(address="127.0.0.1:1")
    assert core._session is None


# -- fake clusters and placement groups ---------------------------------------
@pytest.fixture
def two_nodes(monkeypatch):
    """Fake 2-node cluster: ``make(head_cpus, extra_cpus)``."""
    monkeypatch.setenv("RLT_NUM_GPUS", "0")
    clusters = []

    def make(head_cpus, extra_cpus, extra_gpus=0):
        cluster = cluster_utils.Cluster(
            initialize_head=True, head_node_args={"num_cpus": head_cpus})
        cluster.add_node(num_cpus=extra_cpus, num_gpus=extra_gpus)
        clusters.append(cluster)
        return cluster

    yield make
    for c in clusters:
        c.shutdown()


def _node_avail():
    return {n["NodeID"]: n["Available"].get("CPU", 0.0)
            for n in fabric.nodes()}


def test_fake_cluster_nodes_and_ips(two_nodes):
    two_nodes(2, 2)
    infos = fabric.nodes()
    assert len({i["NodeManagerAddress"] for i in infos}) == 2
    a_head = fabric.remote(Probe).options(num_cpus=2).remote()
    a_second = fabric.remote(Probe).options(num_cpus=2).remote()
    assert {fabric.get(a.node.remote(), timeout=T)
            for a in (a_head, a_second)} == {"node-0", "node-1"}


def test_placement_group_packs_on_one_node(two_nodes):
    two_nodes(4, 8, extra_gpus=1)
    pg = fabric.placement_group(
        [{"CPU": 1}, {"CPU": 2}, {"CPU": 2, "GPU": 1}], strategy="PACK")
    assert pg.bundle_node_ids == ["node-1"] * 3
    assert _node_avail() == {"node-0": 4.0, "node-1": 3.0}
    actor = (fabric.remote(Probe)
             .options(num_cpus=2, num_gpus=1, placement_group=pg,
                      placement_group_bundle_index=2).remote())
    assert fabric.get(actor.node.remote(), timeout=T) == "node-1"
    assert actor.visible_cards == ["0"]
    assert _node_avail() == {"node-0": 4.0, "node-1": 3.0}
    with pytest.raises(InsufficientResourcesError, match="bundle 1"):
        fabric.remote(Probe).options(
            num_cpus=3, placement_group=pg,
            placement_group_bundle_index=1).remote()
    fabric.kill(actor)
    assert _node_avail() == {"node-0": 4.0, "node-1": 3.0}
    fabric.remove_placement_group(pg)
    assert _node_avail() == {"node-0": 4.0, "node-1": 8.0}


def test_strict_pack_and_spread(two_nodes):
    two_nodes(3, 3)
    with pytest.raises(InsufficientResourcesError, match="STRICT_PACK"):
        fabric.placement_group([{"CPU": 1}, {"CPU": 2}, {"CPU": 2}],
                               strategy="STRICT_PACK")
    assert _node_avail() == {"node-0": 3.0, "node-1": 3.0}
    pg = fabric.placement_group([{"CPU": 1}, {"CPU": 2}, {"CPU": 2}],
                                strategy="PACK")
    assert len(set(pg.bundle_node_ids)) == 2  # forced spill
    fabric.remove_placement_group(pg)
    pg = fabric.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="SPREAD")
    assert len(set(pg.bundle_node_ids)) == 2
    fabric.remove_placement_group(pg)
    fabric.remove_placement_group(pg)  # idempotent
    assert _node_avail() == {"node-0": 3.0, "node-1": 3.0}


def test_remove_placement_group_kills_occupants(two_nodes):
    two_nodes(4, 8)
    pg = fabric.placement_group([{"CPU": 8}], strategy="PACK")
    actor = fabric.remote(Probe).options(num_cpus=8,
                                         placement_group=pg).remote()
    assert fabric.get(actor.node.remote(), timeout=T) == "node-1"
    fabric.remove_placement_group(pg)
    deadline = time.monotonic() + T
    while actor.is_alive() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not actor.is_alive()
    assert _node_avail() == {"node-0": 4.0, "node-1": 8.0}
    a2 = fabric.remote(Probe).options(num_cpus=8).remote()
    with pytest.raises(InsufficientResourcesError):
        fabric.remote(Probe).options(num_cpus=8).remote()
    fabric.kill(a2)
