"""MNISTClassifier: the accuracy-bound fixture (the port of
``ray_lightning_tpu/models/mnist.py``), over a synthetic separable "fake
MNIST" by default; real MNIST arrays can be passed in."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ray_lightning_tpu_torch.models.xor import class_loss_acc
from ray_lightning_tpu_torch.trainer.data import ArrayDataset, DataLoader
from ray_lightning_tpu_torch.trainer.module import TorchModule


def make_fake_mnist(
    n: int = 512, seed: int = 0, image_shape: Tuple[int, int] = (28, 28)
) -> ArrayDataset:
    """Synthetic 10-class dataset with class-dependent mean patterns, the
    JAX package's exactly (same numpy draws): separable enough that a
    small MLP exceeds 0.5 accuracy within an epoch."""
    g = np.random.default_rng(seed)
    h, w = image_shape
    labels = g.integers(0, 10, size=n).astype(np.int32)
    # Class prototypes come from a FIXED rng so train/val/test splits (built
    # with different seeds) share the same class structure; only the sample
    # noise varies per split.
    proto = np.random.default_rng(1234).standard_normal((10, h, w)).astype(np.float32)
    images = proto[labels] + 0.5 * g.standard_normal((n, h, w), dtype=np.float32)
    return ArrayDataset(images, labels)


class MNISTClassifier(TorchModule):
    def __init__(
        self,
        lr: float = 1e-3,
        hidden: int = 128,
        batch_size: int = 32,
        dataset: Optional[ArrayDataset] = None,
        n_train: int = 512,
    ) -> None:
        super().__init__()
        self.lr = lr
        self.hidden = hidden
        self.batch_size = batch_size
        self._dataset = dataset
        self.n_train = n_train

    # -- model ----------------------------------------------------------
    def param_shapes(self, in_features: int = 28 * 28) -> Dict[str, Any]:
        h = self.hidden
        return {"w1": (in_features, h), "b1": (h,), "w2": (h, h), "b2": (h,),
                "w3": (h, 10), "b3": (10,)}

    def init_params(self, generator: torch.Generator, batch: Any) -> Any:
        d = int(np.prod(np.shape(batch[0])[1:]))
        dev = generator.device
        s1, s2 = (2.0 / d) ** 0.5, (2.0 / self.hidden) ** 0.5
        scales = {"w1": s1, "w2": s2, "w3": s2}
        return {
            k: (torch.randn(shape, generator=generator, device=dev) * scales[k]
                if k in scales else torch.zeros(shape, device=dev))
            for k, shape in self.param_shapes(d).items()
        }

    def _forward(self, params: Any, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        h = torch.relu(x @ params["w1"] + params["b1"])
        h = torch.relu(h @ params["w2"] + params["b2"])
        return h @ params["w3"] + params["b3"]

    # -- steps ----------------------------------------------------------
    def training_step(self, params, batch, generator):
        loss, acc = class_loss_acc(self._forward(params, batch[0]), batch[1])
        return loss, {"loss": loss, "acc": acc}

    def validation_step(self, params, batch):
        loss, acc = class_loss_acc(self._forward(params, batch[0]), batch[1])
        return {"ptl/val_loss": loss, "ptl/val_accuracy": acc}

    def predict_step(self, params, batch):
        x = batch[0] if isinstance(batch, tuple) else batch
        return self._forward(params, x).argmax(-1)

    def configure_optimizers(self):
        lr = self.lr
        # optax.adam(lr): the same moments, bias corrections and eps.
        return lambda leaves: torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999),
                                               eps=1e-8)

    # -- data -----------------------------------------------------------
    def _data(self) -> ArrayDataset:
        if self._dataset is None:
            self._dataset = make_fake_mnist(self.n_train)
        return self._dataset

    def train_dataloader(self) -> DataLoader:
        return DataLoader(self._data(), batch_size=self.batch_size, shuffle=True)

    def val_dataloader(self) -> DataLoader:
        return DataLoader(make_fake_mnist(128, seed=7), batch_size=self.batch_size)

    def test_dataloader(self) -> DataLoader:
        return DataLoader(make_fake_mnist(128, seed=8), batch_size=self.batch_size)

    def predict_dataloader(self) -> DataLoader:
        return DataLoader(make_fake_mnist(128, seed=8), batch_size=self.batch_size)
