"""Data-parallel strategies: ``RayGPUStrategy`` and ``RayStrategy``, the
reference's name (the port of ``ray_lightning_tpu/strategies/ddp.py``).

The reference's ``RayStrategy(DDPSpawnStrategy)``
(``ray_lightning/ray_ddp.py:23-333``): N workers launched on actors, one
card each, sampler sharding, rank bookkeeping, and the driver's recovery
of rank 0's results. The JAX package shards the global batch over its
mesh and XLA inserts one fused gradient all-reduce into the compiled
step; here each rank runs the step on its own rows and the gradients are
averaged by ONE coalesced all-reduce of the flattened gradients, then a
divide by the world size (:meth:`Strategy.reduce_grads`), inside the
step's CUDA graph on NCCL.
"""
from __future__ import annotations

from ray_lightning_tpu_torch.strategies.base import Strategy


class RayGPUStrategy(Strategy):
    """Data parallelism over cards through actor-launched workers, one
    process per card (the counterpart of ``RayTPUStrategy``; ``use_gpu``
    in place of ``use_tpu``). See :class:`Strategy` for the arguments."""

    strategy_name = "ray_gpu"


class RayStrategy(RayGPUStrategy):
    """The reference's name; :class:`Strategy`'s ctor is its surface
    (``ray_ddp.py:69-75``): ``RayStrategy(num_workers=2)`` trains on two
    cards. Unlike the reference, ``use_gpu`` defaults to True: the port
    runs on the card unless the caller asks for the CPU (``use_gpu=False``,
    gloo)."""

    strategy_name = "ddp_ray"
