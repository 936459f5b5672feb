"""The port's trainer: ``Trainer`` and the pieces it runs, in process or
in each launched worker (see ``trainer/trainer.py`` for the options still
to port)."""
from ray_lightning_tpu_torch.trainer.callbacks import (
    Callback,
    EarlyStopping,
    ModelCheckpoint,
)
from ray_lightning_tpu_torch.trainer.data import (
    ArrayDataset,
    DataLoader,
    Dataset,
    DistributedSampler,
)
from ray_lightning_tpu_torch.trainer.loop import (
    TrainerSpec,
    TrainingLoop,
    TrainingPreempted,
)
from ray_lightning_tpu_torch.trainer.module import DataModule, TorchModule
from ray_lightning_tpu_torch.trainer.trainer import (
    Trainer,
    lr_find,
    scale_batch_size,
)

__all__ = [
    "Trainer",
    "TorchModule",
    "DataModule",
    "TrainerSpec",
    "TrainingLoop",
    "TrainingPreempted",
    "Callback",
    "ModelCheckpoint",
    "EarlyStopping",
    "DataLoader",
    "Dataset",
    "ArrayDataset",
    "DistributedSampler",
    "lr_find",
    "scale_batch_size",
]
