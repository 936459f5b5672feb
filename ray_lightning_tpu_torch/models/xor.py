"""XORModule: deterministic fixture for exact-metric-value assertions (the
port of ``ray_lightning_tpu/models/xor.py``): metrics computed in workers
must arrive in the launching process bit-exact."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_lightning_tpu_torch.trainer.data import ArrayDataset, DataLoader
from ray_lightning_tpu_torch.trainer.module import DataModule, TorchModule

_X = np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 0.0], [1.0, 1.0]], dtype=np.float32)
_Y = np.array([0, 1, 1, 0], dtype=np.int32)


def xor_dataset(repeat: int = 2) -> ArrayDataset:
    return ArrayDataset(np.tile(_X, (repeat, 1)), np.tile(_Y, repeat))


def class_loss_acc(logits: torch.Tensor, y: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean integer-label cross entropy and accuracy of fp32 logits
    (``optax.softmax_cross_entropy_with_integer_labels(...).mean()``): the
    loss of every classifier of the zoo."""
    y = y.long()
    loss = F.cross_entropy(logits.float(), y)
    return loss, (logits.argmax(-1) == y).float().mean()


class XORDataModule(DataModule):
    def __init__(self, batch_size: int = 1, repeat: int = 2) -> None:
        self.batch_size = batch_size
        self.repeat = repeat

    def train_dataloader(self) -> DataLoader:
        return DataLoader(xor_dataset(self.repeat), batch_size=self.batch_size)

    def val_dataloader(self) -> DataLoader:
        return DataLoader(xor_dataset(self.repeat), batch_size=self.batch_size)


class XORModule(TorchModule):
    def __init__(self, lr: float = 0.1, hidden: int = 8, batch_size: int = 1) -> None:
        super().__init__()
        self.lr = lr
        self.hidden = hidden
        self.batch_size = batch_size

    def param_shapes(self) -> Dict[str, Any]:
        h = self.hidden
        return {"w1": (2, h), "b1": (h,), "w2": (h, 2), "b2": (2,)}

    def init_params(self, generator: torch.Generator, batch: Any) -> Any:
        dev = generator.device
        return {
            "w1": torch.randn((2, self.hidden), generator=generator, device=dev) * 0.5,
            "b1": torch.zeros((self.hidden,), device=dev),
            "w2": torch.randn((self.hidden, 2), generator=generator, device=dev) * 0.5,
            "b2": torch.zeros((2,), device=dev),
        }

    def _forward(self, params: Any, x: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(x @ params["w1"] + params["b1"])
        return h @ params["w2"] + params["b2"]

    def training_step(self, params, batch, generator):
        loss, acc = class_loss_acc(self._forward(params, batch[0]), batch[1])
        return loss, {"loss": loss, "acc": acc}

    def validation_step(self, params, batch):
        loss, acc = class_loss_acc(self._forward(params, batch[0]), batch[1])
        return {"val_loss": loss, "val_acc": acc}

    def configure_optimizers(self):
        lr = self.lr
        # optax.adam(lr): the same moments, bias corrections and eps.
        return lambda leaves: torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999),
                                               eps=1e-8)

    def train_dataloader(self) -> DataLoader:
        return DataLoader(xor_dataset(), batch_size=self.batch_size)

    def val_dataloader(self) -> DataLoader:
        return DataLoader(xor_dataset(), batch_size=self.batch_size)
