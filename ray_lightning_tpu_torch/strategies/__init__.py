"""Strategies of the port: the in-process ``SingleDeviceStrategy`` and the
launched data-parallel ones (``RayStrategy``, ``HorovodRayStrategy``,
``RayShardedStrategy``) and tensor parallelism over a data x fsdp x model
mesh (``GSPMDStrategy``)."""
from ray_lightning_tpu_torch.strategies.base import (
    SingleDeviceStrategy,
    Strategy,
    WorkerPlan,
)
from ray_lightning_tpu_torch.strategies.ddp import RayGPUStrategy, RayStrategy
from ray_lightning_tpu_torch.strategies.gspmd import GSPMDStrategy
from ray_lightning_tpu_torch.strategies.ring import (
    HorovodRayStrategy,
    RingGPUStrategy,
)
from ray_lightning_tpu_torch.strategies.sharded import RayShardedStrategy


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
