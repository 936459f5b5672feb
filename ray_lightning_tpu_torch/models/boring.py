"""BoringModule: the minimal end-to-end fixture (the JAX package's
``models/boring.py``): one linear layer over random data, exercising
train/val/test/predict and checkpoint round trips in a second or two.

``batch_size`` (2 in the JAX fixture, per device) is the rows of one
batch on the one device, so a test can match the JAX fixture's host batch.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ray_lightning_tpu_torch.trainer.data import ArrayDataset, DataLoader
from ray_lightning_tpu_torch.trainer.module import TorchModule


class RandomDataset(ArrayDataset):
    def __init__(self, size: int, length: int, seed: int = 0) -> None:
        g = np.random.default_rng(seed)
        super().__init__(g.standard_normal((length, size), dtype=np.float32))


class BoringModule(TorchModule):
    def __init__(
        self, lr: float = 0.1, dataset_length: int = 64, batch_size: int = 2
    ) -> None:
        super().__init__()
        self.lr = lr
        self.dataset_length = dataset_length
        self.batch_size = batch_size
        self.val_epoch = 0  # host-side hook bookkeeping

    def init_params(self, generator: torch.Generator, batch: Any) -> Any:
        x = batch if not isinstance(batch, tuple) else batch[0]
        w = torch.randn(
            (x.shape[-1], 2), generator=generator, device=generator.device
        )
        return {"w": w * 0.1, "b": torch.zeros((2,), device=generator.device)}

    def _forward(self, params: Any, x: torch.Tensor) -> torch.Tensor:
        return x @ params["w"] + params["b"]

    def training_step(
        self, params: Any, batch: Any, generator: torch.Generator
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        loss = torch.mean(self._forward(params, batch) ** 2)
        return loss, {"loss": loss}

    def validation_step(self, params: Any, batch: Any) -> Dict[str, torch.Tensor]:
        return {"val_loss": torch.mean(self._forward(params, batch) ** 2)}

    def test_step(self, params: Any, batch: Any) -> Dict[str, torch.Tensor]:
        return {"test_loss": torch.mean(self._forward(params, batch) ** 2)}

    def predict_step(self, params: Any, batch: Any) -> torch.Tensor:
        return self._forward(params, batch)

    def configure_optimizers(self):
        lr = self.lr
        return lambda leaves: torch.optim.SGD(leaves, lr=lr)

    def _loader(self, seed: int) -> DataLoader:
        return DataLoader(
            RandomDataset(32, self.dataset_length, seed=seed),
            batch_size=self.batch_size,
        )

    def train_dataloader(self) -> DataLoader:
        return self._loader(0)

    def val_dataloader(self) -> DataLoader:
        return self._loader(1)

    def test_dataloader(self) -> DataLoader:
        return self._loader(2)

    def predict_dataloader(self) -> DataLoader:
        return self._loader(3)

    def on_validation_epoch_end(self, metrics: Dict[str, float]) -> None:
        self.val_epoch += 1
