"""ray_lightning_tpu_torch.serve — continuous-batching inference serving
(PyTorch port of ``ray_lightning_tpu/serve``).

- :class:`DecodeEngine` — slot-based decode over CUDA graphs captured at
  construction (engine.py).
- :class:`Scheduler` / :class:`SamplingParams` — continuous batching
  policy: FIFO/priority queue, prefill/decode interleave, deadlines,
  cancellation, the preemption drain (scheduler.py).
- :class:`ServeReplica` / :func:`start_replicas` / :class:`ServeClient`
  — replica actors on the fabric with a blocking + streaming client,
  journal-backed failover and hedged reads (server.py, client.py).
- :class:`ServeMetrics` — queue depth, TTFT, occupancy, tokens/s
  (metrics.py), exposed through the replicas' ``stats()`` endpoint.
- :class:`Router` (router.py) — the front-door routing policy
  ``ServeClient.submit`` consults: health/state-aware weighting, prefix
  affinity over :class:`FleetKVDirectory` (kvfleet.py), admission
  control with :class:`RequestRejectedError`, and the client's shared
  :class:`RetryBudget`.
- :class:`FaultInjector` — deterministic fault injection (faults.py).
- :class:`PreemptionMonitor` (preempt.py) — the per-process preemption
  signal plane.

- :class:`KVFleetPlane` (kvfleet.py) — a replica's side of the fleet KV
  plane: cross-replica prefix fetches, disaggregated prefill/decode ships
  (``start_replicas(roles=...)``) and fetches from the KV object store
  (kvstore.py), which also takes write-through and parked sessions.

Not ported yet: ``FleetSupervisor`` and ``RouterAutoscaler`` (ROADMAP
queue 1 item 10b).

The engine and the replica/client layer import on first attribute
access (torch, the fabric), not at package import.
"""
from ray_lightning_tpu_torch.serve.faults import FaultInjector, FaultRule
from ray_lightning_tpu_torch.serve.kvfleet import (
    FleetKVDirectory,
    KVFleetPlane,
)
from ray_lightning_tpu_torch.serve.metrics import ServeMetrics
from ray_lightning_tpu_torch.serve.preempt import (
    PreemptionMonitor,
    get_monitor,
    reset_monitor,
)
from ray_lightning_tpu_torch.serve.router import (
    RequestRejectedError,
    RetryBudget,
    Router,
)
from ray_lightning_tpu_torch.serve.scheduler import (
    Request,
    SamplingParams,
    Scheduler,
    TokenEvent,
)

__all__ = [
    "DecodeEngine",
    "ServeMetrics",
    "SamplingParams",
    "Request",
    "Scheduler",
    "TokenEvent",
    "ServeReplica",
    "ServeClient",
    "start_replicas",
    "load_serve_params",
    "build_engine",
    "Router",
    "RequestRejectedError",
    "RetryBudget",
    "FleetKVDirectory",
    "KVFleetPlane",
    "FaultInjector",
    "FaultRule",
    "PreemptionMonitor",
    "get_monitor",
    "reset_monitor",
]

_LAZY = {
    # torch-importing (engine) or fabric-importing (server/client) names.
    "DecodeEngine": "ray_lightning_tpu_torch.serve.engine",
    "ServeReplica": "ray_lightning_tpu_torch.serve.server",
    "load_serve_params": "ray_lightning_tpu_torch.serve.server",
    "build_engine": "ray_lightning_tpu_torch.serve.server",
    "ServeClient": "ray_lightning_tpu_torch.serve.client",
    "start_replicas": "ray_lightning_tpu_torch.serve.client",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(
        f"module 'ray_lightning_tpu_torch.serve' has no attribute {name!r}"
    )
