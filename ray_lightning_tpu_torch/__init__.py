"""ray_lightning_tpu_torch — the PyTorch/CUDA port of ray_lightning_tpu.

A second package beside the JAX one, which stays the reference. Ported so
far: serving (GPT prefill and cached decode in ``models/gpt.py``, the slot
decode engine and scheduler core in ``serve/``), training on one device
(``gpt_forward``, the losses and ``GPTLM`` in ``models/gpt.py``;
``Trainer`` and its loop, data, callbacks and optimizer rule in
``trainer/``; ``SingleDeviceStrategy`` in ``strategies/``), the weight
bridge from the JAX parameter tree (``models/weights.py``), and
hand-written Hopper flash-attention kernels, forward and backward
(``ops/``), weight-only int8 (``utils/quantize.py``; the engine entry
point ``serve/server.py:build_engine(int8=True)``), and the request
lifecycle record: tracer, event log, metrics registry, anatomy and
workload journal (``obs/``), fault points (``serve/faults.py``) and the
scheduler's cost ledger and preemption drain, and the serving fleet's
front door: the actor fabric (``fabric/``), replicas, the client and
router (``serve/server.py``, ``serve/client.py``, ``serve/router.py``),
the watchdog, flight recorder and preemption monitor (``obs/health.py``,
``obs/blackbox.py``, ``serve/preempt.py``), the fleet KV plane and store
(``serve/kvfleet.py``, ``serve/kvstore.py``), and the distributed trainer:
``RayStrategy``, ``HorovodRayStrategy`` and ``RayShardedStrategy``
(``strategies/``) launched on the fabric (``launchers/``, ``parallel/``),
with ``Trainer(max_restarts=...)``. It imports ``torch``, never ``jax``,
and nothing of ``ray_lightning_tpu``.
"""
__version__ = "0.1.0"

_LAZY = {
    "GPTConfig": "ray_lightning_tpu_torch.models.gpt",
    "GPTLM": "ray_lightning_tpu_torch.models.gpt",
    "gpt_forward": "ray_lightning_tpu_torch.models.gpt",
    "BoringModule": "ray_lightning_tpu_torch.models.boring",
    "Trainer": "ray_lightning_tpu_torch.trainer",
    "TorchModule": "ray_lightning_tpu_torch.trainer",
    "SingleDeviceStrategy": "ray_lightning_tpu_torch.strategies",
    "RayStrategy": "ray_lightning_tpu_torch.strategies",
    "RayGPUStrategy": "ray_lightning_tpu_torch.strategies",
    "HorovodRayStrategy": "ray_lightning_tpu_torch.strategies",
    "RayShardedStrategy": "ray_lightning_tpu_torch.strategies",
    "init_gpt_params": "ray_lightning_tpu_torch.models.gpt",
    "gpt_generate": "ray_lightning_tpu_torch.models.gpt",
    "params_from_jax": "ray_lightning_tpu_torch.models.weights",
    "DecodeEngine": "ray_lightning_tpu_torch.serve.engine",
    "Scheduler": "ray_lightning_tpu_torch.serve.scheduler",
    "SamplingParams": "ray_lightning_tpu_torch.serve.scheduler",
    "ServeMetrics": "ray_lightning_tpu_torch.serve.metrics",
    "build_engine": "ray_lightning_tpu_torch.serve.server",
    "quantize_params_int8": "ray_lightning_tpu_torch.utils.quantize",
    "RequestTracer": "ray_lightning_tpu_torch.obs.trace",
    "EventLog": "ray_lightning_tpu_torch.obs.events",
    "MetricsRegistry": "ray_lightning_tpu_torch.obs.registry",
    "WorkloadJournal": "ray_lightning_tpu_torch.obs.journal",
    "FaultInjector": "ray_lightning_tpu_torch.serve.faults",
    "flash_attention": "ray_lightning_tpu_torch.ops.flash_attention",
}


def __getattr__(name):
    # Lazy exports keep `import ray_lightning_tpu_torch` light (no torch
    # import until a name is used).
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(
        f"module 'ray_lightning_tpu_torch' has no attribute {name!r}"
    )


__all__ = list(_LAZY)
