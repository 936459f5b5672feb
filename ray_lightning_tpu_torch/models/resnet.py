"""ResNet-18 for CIFAR-10 and the image classifiers' shared surface: the
port of ``ray_lightning_tpu/models/resnet.py``.

The parameter tree is flax's, ``{"params": {"Conv_0": {"kernel"},
"GroupNorm_0": {"scale", "bias"}, "_Block_0": {...}, ..., "Dense_0":
{"kernel", "bias"}}}`` with HWIO kernels, so the JAX module's initialised
tree crosses over as a copy (``models/weights.py``). The forward runs in
NCHW through ``F.conv2d`` (each kernel permuted to OIHW), ``F.group_norm``
and a dense head: plain PyTorch ops, as the JAX package computes them
outside any Pallas kernel.

Numerics kept from flax: ``"SAME"`` padding, which for a stride-2 3x3
convolution of an even input pads 0 rows before and 1 after (asymmetric:
``padding=1`` would shift every window by one pixel); GroupNorm's epsilon
1e-6; groups ``min(32, channels)``. GroupNorm, not BatchNorm: the step
stays a pure function of (params, batch), with no running statistics.

Batches arrive as uint8 NHWC and are normalised on the device, so the
host-to-device copy moves a quarter of the fp32 bytes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_lightning_tpu_torch.models.xor import class_loss_acc
from ray_lightning_tpu_torch.trainer.data import ArrayDataset, DataLoader
from ray_lightning_tpu_torch.trainer.module import TorchModule

#: flax ``GroupNorm``'s default epsilon (torch's is 1e-5).
GN_EPS = 1e-6


def make_fake_cifar(
    n: int = 512, seed: int = 0, num_classes: int = 10, size: int = 32
) -> ArrayDataset:
    """Synthetic separable CIFAR-shaped dataset (uint8 NHWC), the JAX
    package's exactly (same numpy draws): class-dependent prototype images
    + noise."""
    g = np.random.default_rng(seed)
    labels = g.integers(0, num_classes, size=n).astype(np.int32)
    proto = np.random.default_rng(4321).integers(
        0, 256, size=(num_classes, size, size, 3)
    )
    noise = g.normal(0.0, 32.0, size=(n, size, size, 3))
    images = np.clip(proto[labels] + noise, 0, 255).astype(np.uint8)
    return ArrayDataset(images, labels)


class ImageClassifierModule(TorchModule):
    """Shared surface of the image-classifier families (ResNet, ViT):
    on-device uint8 normalization, cross-entropy/accuracy steps, and
    fake-CIFAR dataloaders sized to the subclass's ``image_size``.
    Subclasses implement ``_forward(params, x)`` on NHWC float images."""

    num_classes: int = 10
    # None = size-agnostic (ResNet's global pool accepts any input size);
    # size-bound models (ViT: positional embeddings) set an int, which
    # also sizes the fake data and enables the dataset check.
    image_size: Optional[int] = None
    batch_size: int = 32
    n_train: int = 512
    _dataset: Optional[ArrayDataset] = None

    def _forward(self, params: Any, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @staticmethod
    def _prep(x: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC -> normalized fp32, on the device."""
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        return (x - 0.5) / 0.25

    def _loss_acc(self, params: Any, batch: Tuple) -> Tuple[torch.Tensor, torch.Tensor]:
        x, y = batch
        return class_loss_acc(self._forward(params, self._prep(x)), y)

    # -- steps -----------------------------------------------------------
    def training_step(self, params, batch, generator):
        loss, acc = self._loss_acc(params, batch)
        return loss, {"loss": loss, "acc": acc}

    def validation_step(self, params, batch):
        loss, acc = self._loss_acc(params, batch)
        return {"val_loss": loss, "val_accuracy": acc}

    def predict_step(self, params, batch):
        x = batch[0] if isinstance(batch, (tuple, list)) else batch
        return self._forward(params, self._prep(x)).argmax(-1)

    # -- data ------------------------------------------------------------
    def _check_dataset(self, ds: ArrayDataset) -> ArrayDataset:
        if self.image_size is None:
            return ds  # size-agnostic model: any image size trains
        shape = np.shape(ds[0][0])
        expect = (self.image_size, self.image_size)
        if shape[:2] != expect:
            raise ValueError(
                f"dataset images are {shape[:2]}, but this model expects "
                f"{expect} (config image_size); resize the data or the "
                "config"
            )
        return ds

    def _fake(self, n: int, seed: int = 0) -> ArrayDataset:
        return make_fake_cifar(
            n,
            seed=seed,
            num_classes=self.num_classes,
            size=self.image_size or 32,
        )

    def _data(self) -> ArrayDataset:
        if self._dataset is None:
            self._dataset = self._fake(self.n_train)
        return self._check_dataset(self._dataset)

    def train_dataloader(self) -> DataLoader:
        return DataLoader(self._data(), batch_size=self.batch_size, shuffle=True)

    def val_dataloader(self) -> DataLoader:
        return DataLoader(self._fake(128, seed=7), batch_size=self.batch_size)

    def test_dataloader(self) -> DataLoader:
        return DataLoader(self._fake(128, seed=8), batch_size=self.batch_size)

    def predict_dataloader(self) -> DataLoader:
        return DataLoader(self._fake(128, seed=9), batch_size=self.batch_size)


def _same_padding(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` (before, after) padding of one spatial dim."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """flax ``nn.Conv(use_bias=False, padding="SAME")`` on NCHW ``x`` with
    an HWIO ``kernel``. Symmetric padding goes to the convolution itself,
    an asymmetric one (stride 2 on an even input) through ``F.pad``."""
    kh, kw = kernel.shape[0], kernel.shape[1]
    ph = _same_padding(x.shape[2], kh, stride)
    pw = _same_padding(x.shape[3], kw, stride)
    w = kernel.permute(3, 2, 0, 1)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)


def _group_norm(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    c = x.shape[1]
    return F.group_norm(x, min(32, c), p["scale"], p["bias"], eps=GN_EPS)


def _lecun_normal(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init, ``lecun_normal``: a normal truncated at
    two standard deviations, scaled to variance 1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    t = torch.empty(shape, device=generator.device)
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                       generator=generator)


@dataclass(frozen=True)
class ResNet18:
    """CIFAR-variant ResNet-18 (the JAX package's flax ``ResNet18``): 3x3
    stem (no maxpool), stages [2,2,2,2] x [w, 2w, 4w, 8w], each block two
    3x3 convolutions with GroupNorm and a 1x1 projection where the shape
    changes, global average pool, linear head. ``init`` and ``apply``
    follow flax's module surface on the flax tree."""

    num_classes: int = 10
    width: int = 64
    stage_sizes: Sequence[int] = (2, 2, 2, 2)

    def block_plan(self) -> Iterator[Tuple[str, int, int, int]]:
        """(name, in channels, filters, stride) of each residual block."""
        c_in, i = self.width, 0
        for stage, n_blocks in enumerate(self.stage_sizes):
            filters = self.width * (2 ** stage)
            for block in range(n_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                yield f"_Block_{i}", c_in, filters, stride
                c_in, i = filters, i + 1

    def param_shapes(self, channels: int = 3) -> Dict[str, Any]:
        """flax's tree of shapes for ``channels`` input channels."""
        w = self.width

        def gn(c):
            return {"scale": (c,), "bias": (c,)}

        tree: Dict[str, Any] = {
            "Conv_0": {"kernel": (3, 3, channels, w)},
            "GroupNorm_0": gn(w),
        }
        for name, c_in, f, stride in self.block_plan():
            blk = {
                "Conv_0": {"kernel": (3, 3, c_in, f)},
                "GroupNorm_0": gn(f),
                "Conv_1": {"kernel": (3, 3, f, f)},
                "GroupNorm_1": gn(f),
            }
            if c_in != f or stride != 1:
                blk["Conv_2"] = {"kernel": (1, 1, c_in, f)}
                blk["GroupNorm_2"] = gn(f)
            tree[name] = blk
        c_out = w * 2 ** (len(self.stage_sizes) - 1)
        tree["Dense_0"] = {"kernel": (c_out, self.num_classes),
                           "bias": (self.num_classes,)}
        return {"params": tree}

    def init(self, generator: torch.Generator, channels: int = 3) -> Dict[str, Any]:
        """A fresh tree on ``generator``'s device: lecun-normal kernels,
        zero biases, unit GroupNorm scales (flax's initialisers; other
        draws)."""

        def walk(node: Any, path: str) -> Any:
            if isinstance(node, dict):
                return {k: walk(v, k) for k, v in node.items()}
            if path == "scale":
                return torch.ones(node, device=generator.device)
            if path == "bias":
                return torch.zeros(node, device=generator.device)
            fan_in = int(np.prod(node[:-1]))
            return _lecun_normal(node, fan_in, generator)

        return walk(self.param_shapes(channels), "")

    def apply(self, params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        """NHWC float images -> (B, num_classes) logits."""
        p = params["params"]
        x = x.permute(0, 3, 1, 2)
        x = F.relu(_group_norm(_conv(x, p["Conv_0"]["kernel"]), p["GroupNorm_0"]))
        for name, _, _, stride in self.block_plan():
            b = p[name]
            r = x
            x = F.relu(_group_norm(_conv(x, b["Conv_0"]["kernel"], stride),
                                   b["GroupNorm_0"]))
            x = _group_norm(_conv(x, b["Conv_1"]["kernel"]), b["GroupNorm_1"])
            if "Conv_2" in b:
                r = _group_norm(_conv(r, b["Conv_2"]["kernel"], stride),
                                b["GroupNorm_2"])
            x = F.relu(x + r)
        x = x.mean(dim=(2, 3))
        return x @ p["Dense_0"]["kernel"] + p["Dense_0"]["bias"]


class CIFARResNet(ImageClassifierModule):
    """ResNet-18/CIFAR-10 module (the JAX package's ``CIFARResNet``):
    SGD with momentum and weight decay."""

    def __init__(
        self,
        lr: float = 0.1,
        batch_size: int = 32,
        n_train: int = 512,
        num_classes: int = 10,
        width: int = 64,
        momentum: float = 0.9,
        weight_decay: float = 5e-4,
        dataset: Optional[ArrayDataset] = None,
    ) -> None:
        super().__init__()
        self.lr = lr
        self.batch_size = batch_size
        self.n_train = n_train
        self.num_classes = num_classes
        self.width = width
        self.momentum = momentum
        self.weight_decay = weight_decay
        self._dataset = dataset
        self.model = ResNet18(num_classes=num_classes, width=width)

    # -- model -----------------------------------------------------------
    def init_params(self, generator: torch.Generator, batch: Any) -> Any:
        return self.model.init(generator, int(np.shape(batch[0])[-1]))

    def _forward(self, params: Any, x: torch.Tensor) -> torch.Tensor:
        return self.model.apply(params, x)

    def configure_optimizers(self):
        lr, momentum, wd = self.lr, self.momentum, self.weight_decay

        def sgd(leaves):
            # optax.chain(add_decayed_weights(wd), sgd(lr, momentum)):
            # the decay joins the gradient before the momentum trace,
            # which starts at the first gradient (no dampening).
            return torch.optim.SGD(leaves, lr=lr, momentum=momentum,
                                   weight_decay=wd, dampening=0.0)

        return sgd
