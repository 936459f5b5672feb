"""ray_lightning_tpu_torch.fabric — the actor/process launch fabric
(PyTorch port of ``ray_lightning_tpu/fabric/``, local mode).

A minimal actor system on OS processes, shared-memory object transport and
logical multi-node resource scheduling, with a Ray-like surface
(``remote``, ``get``, ``put``, ``wait``, ``kill``, placement groups,
queues, heartbeats).

- Actors are exec'd worker interpreters; env vars (``CUDA_VISIBLE_DEVICES``
  for the cards an actor was given) are applied in the child *before* any
  heavy import, so each actor owns its own CUDA context.
- Logical nodes carry resource capacities (``{"CPU": n, "GPU": n,
  custom}``); ``cluster_utils.Cluster`` fakes multi-node clusters for
  tests.
- The remote fabric (a head server and its clients) is ROADMAP queue 1
  item 10b.
"""
from ray_lightning_tpu_torch.fabric.core import (
    ActorDiedError,
    ActorHandle,
    FabricError,
    InsufficientResourcesError,
    ObjectRef,
    TaskRef,
    available_resources,
    cluster_resources,
    free,
    get,
    heartbeats,
    init,
    is_initialized,
    kill,
    nodes,
    placement_group,
    PlacementGroup,
    put,
    remote,
    remove_placement_group,
    shutdown,
    wait,
)
from ray_lightning_tpu_torch.fabric.queue import Queue
from ray_lightning_tpu_torch.fabric import cluster_utils

__all__ = [
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "get",
    "heartbeats",
    "put",
    "free",
    "wait",
    "kill",
    "nodes",
    "placement_group",
    "remove_placement_group",
    "PlacementGroup",
    "available_resources",
    "cluster_resources",
    "ObjectRef",
    "TaskRef",
    "ActorHandle",
    "Queue",
    "ActorDiedError",
    "FabricError",
    "InsufficientResourcesError",
    "cluster_utils",
]
