"""Strategies of the port: the single-device subset (multi-device
strategies are ROADMAP queue 1 item 11)."""
from ray_lightning_tpu_torch.strategies.base import SingleDeviceStrategy, Strategy

__all__ = ["Strategy", "SingleDeviceStrategy"]
