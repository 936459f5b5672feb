"""Launchers: spawn a strategy's workers on the fabric and recover rank
0's results (``GPULauncher``)."""
from ray_lightning_tpu_torch.launchers.gpu_launcher import GPULauncher
from ray_lightning_tpu_torch.launchers.utils import (
    TrainWorker,
    WorkerOutput,
    get_executable_cls,
    process_results,
    set_executable_cls,
)

__all__ = [
    "GPULauncher",
    "TrainWorker",
    "WorkerOutput",
    "get_executable_cls",
    "set_executable_cls",
    "process_results",
]
