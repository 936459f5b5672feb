"""Strategies of the port: the in-process ``SingleDeviceStrategy`` and the
launched data-parallel ones (``RayStrategy``, ``HorovodRayStrategy``,
``RayShardedStrategy``). Tensor parallelism (``GSPMDStrategy``) is ROADMAP
queue 1 item 11b."""
from typing import Any

from ray_lightning_tpu_torch.strategies.base import (
    SingleDeviceStrategy,
    Strategy,
    WorkerPlan,
    not_ported,
)
from ray_lightning_tpu_torch.strategies.ddp import RayGPUStrategy, RayStrategy
from ray_lightning_tpu_torch.strategies.ring import (
    HorovodRayStrategy,
    RingGPUStrategy,
)
from ray_lightning_tpu_torch.strategies.sharded import RayShardedStrategy


class GSPMDStrategy(Strategy):
    """Tensor parallelism over a logical mesh (the JAX package's
    ``strategies/gspmd.py``): not ported yet."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        raise not_ported(
            "GSPMDStrategy (DeviceMesh / DTensor tensor parallelism)", "11b")


__all__ = [
    "Strategy",
    "SingleDeviceStrategy",
    "WorkerPlan",
    "RayGPUStrategy",
    "RayStrategy",
    "RingGPUStrategy",
    "HorovodRayStrategy",
    "RayShardedStrategy",
    "GSPMDStrategy",
]
