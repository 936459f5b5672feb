"""Process groups and sharding rules of the port's launched strategies."""
from ray_lightning_tpu_torch.parallel.env import DistEnv

__all__ = ["DistEnv"]
