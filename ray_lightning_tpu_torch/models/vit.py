"""Vision Transformer classifier: the port of
``ray_lightning_tpu/models/vit.py``.

- Patchify is pure reshapes and one matmul (no convolution): images fold
  to ``(B, N, ps*ps*C)`` and hit one large projection.
- The blocks are BERT's pre-LN encoder blocks (``models/bert.py:
  encoder_block``) over stacked per-layer leaves, with non-causal flash
  attention. A ViT's row count is n_patches + 1 = k^2 + 1, never a
  multiple of 8 (squares are 0, 1 or 4 mod 8), so the shape rule shared
  with the JAX package sends every ViT attention to the reference path,
  as in the JAX package.
- Over a mesh's ``"model"`` axis each block splits Megatron-style.
- uint8 NHWC batches are normalised on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ray_lightning_tpu_torch.models.bert import (
    ENCODER_BLOCK_AXES,
    attention_fn,
    block_groups,
    run_blocks,
)
from ray_lightning_tpu_torch.models.gpt import _layernorm, compute_dtype
from ray_lightning_tpu_torch.models.resnet import ImageClassifierModule
from ray_lightning_tpu_torch.trainer.data import ArrayDataset
from ray_lightning_tpu_torch.trainer.optim import warmup_cosine_decay_schedule


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Same field names, defaults and checks as the JAX package's
    ``ViTConfig``."""

    image_size: int = 32
    patch_size: int = 4
    channels: int = 3
    num_classes: int = 10
    n_layer: int = 6
    n_head: int = 4
    d_model: int = 128
    d_ff: int = 512
    compute_dtype: str = "float32"
    attn_impl: str = "flash"  # "flash" | "reference"
    dropout: float = 0.0  # reserved; ViT-S/16-style configs train without

    def __post_init__(self) -> None:
        if self.image_size % self.patch_size:
            raise ValueError(
                f"image_size {self.image_size} not divisible by patch_size "
                f"{self.patch_size}"
            )
        if self.d_model % self.n_head:
            raise ValueError(
                f"d_model {self.d_model} not divisible by n_head {self.n_head}"
            )

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head


def vit_param_shapes(cfg: ViTConfig) -> Dict[str, Any]:
    """The parameter tree's shapes (JAX ``vit.py:98-127``)."""
    L, D, F_, H, hd = cfg.n_layer, cfg.d_model, cfg.d_ff, cfg.n_head, cfg.head_dim
    return {
        "patch_w": (cfg.patch_size * cfg.patch_size * cfg.channels, D),
        "patch_b": (D,),
        "cls": (D,),
        "pos": (cfg.n_patches + 1, D),
        "blocks": {
            "ln1_g": (L, D),
            "ln1_b": (L, D),
            "wqkv": (L, D, 3, H, hd),
            "bqkv": (L, 3, H, hd),
            "wo": (L, H, hd, D),
            "bo": (L, D),
            "ln2_g": (L, D),
            "ln2_b": (L, D),
            "wi": (L, D, F_),
            "bi": (L, F_),
            "wo2": (L, F_, D),
            "bo2": (L, D),
        },
        "head_ln_g": (D,),
        "head_ln_b": (D,),
        "head_w": (D, cfg.num_classes),
        "head_b": (cfg.num_classes,),
    }


def vit_logical_axes(cfg: ViTConfig) -> Dict[str, Any]:
    """Same vocabulary as ``gpt_logical_axes``: heads/mlp -> "model",
    embed -> "fsdp", layers replicated."""
    return {
        "patch_w": (None, "embed"),
        "patch_b": (None,),
        "cls": (None,),
        "pos": (None, "embed"),
        "blocks": dict(ENCODER_BLOCK_AXES),
        "head_ln_g": (None,),
        "head_ln_b": (None,),
        "head_w": ("embed", None),
        "head_b": (None,),
    }


def init_vit_params(generator: torch.Generator, cfg: ViTConfig) -> Dict[str, Any]:
    """A fresh fp32 tree on ``generator``'s device with the JAX package's
    scales: fan-in normal projections, 0.02 for the class token and the
    positions, zero biases, unit norm gains (other draws)."""
    D, F_, H, hd = cfg.d_model, cfg.d_ff, cfg.n_head, cfg.head_dim
    patch_dim = cfg.patch_size * cfg.patch_size * cfg.channels
    scales = {
        "patch_w": patch_dim ** -0.5, "cls": 0.02, "pos": 0.02,
        "wqkv": D ** -0.5, "wo": (H * hd) ** -0.5, "wi": D ** -0.5,
        "wo2": F_ ** -0.5, "head_w": D ** -0.5,
    }
    device = generator.device

    def leaf(name: str, shape) -> torch.Tensor:
        if name in scales:
            return torch.randn(shape, generator=generator,
                               device=device) * scales[name]
        if name.endswith("_g"):
            return torch.ones(shape, device=device)
        return torch.zeros(shape, device=device)

    return {
        k: ({n: leaf(n, s) for n, s in v.items()} if isinstance(v, dict)
            else leaf(k, v))
        for k, v in vit_param_shapes(cfg).items()
    }


def patchify(images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, ps*ps*C) with pure reshapes/permutes."""
    B = images.shape[0]
    ps, n_side = cfg.patch_size, cfg.image_size // cfg.patch_size
    x = images.reshape(B, n_side, ps, n_side, ps, cfg.channels)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (B, nh, nw, ps, ps, C)
    return x.reshape(B, n_side * n_side, ps * ps * cfg.channels)


def vit_forward(
    params: Dict[str, Any], images: torch.Tensor, cfg: ViTConfig,
    mesh: Any = None,
) -> torch.Tensor:
    """(B, H, W, C) float images -> (B, num_classes) fp32 logits. ``mesh``
    splits the blocks over its ``"model"`` axis where ``params`` holds
    this rank's slices (the specs of :func:`vit_logical_axes`)."""
    cdt = compute_dtype(cfg)
    B = images.shape[0]
    x = patchify(images.to(cdt), cfg) @ params["patch_w"].to(cdt)
    x = x + params["patch_b"].to(cdt)
    cls = params["cls"].to(cdt).expand(B, 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1) + params["pos"].to(cdt)
    x = run_blocks(x, params["blocks"], cfg.n_layer,
                   attention_fn(cfg.attn_impl), cdt,
                   block_groups(mesh, params["blocks"], cfg.n_head, cfg.d_ff))
    x = _layernorm(x[:, 0], params["head_ln_g"], params["head_ln_b"])
    return x.float() @ params["head_w"] + params["head_b"]


class ViTClassifier(ImageClassifierModule):
    """ViT image classifier (the JAX package's ``ViTClassifier``): the
    shared image-classifier surface over :func:`vit_forward`, AdamW with
    optax's default decay 1e-4."""

    def __init__(
        self,
        config: Optional[ViTConfig] = None,
        lr: float = 1e-3,
        batch_size: int = 32,
        n_train: int = 512,
        warmup_steps: int = 0,
        dataset: Optional[ArrayDataset] = None,
        **cfg_kwargs: Any,
    ) -> None:
        super().__init__()
        if config is None:
            config = ViTConfig(**cfg_kwargs)
        elif cfg_kwargs:
            config = dataclasses.replace(config, **cfg_kwargs)
        self.config = config
        self.num_classes = config.num_classes
        self.image_size = config.image_size
        self.lr = lr
        self.batch_size = batch_size
        self.n_train = n_train
        self.warmup_steps = warmup_steps
        self._dataset = dataset
        self._mesh: Any = None

    # -- strategy hooks --------------------------------------------------
    def bind_mesh(self, mesh: Any, seq_axis: Optional[str] = None) -> None:
        """Run the forward over ``mesh``'s ``"model"`` axis (the
        strategy's hook). Sequence parallelism raises."""
        if seq_axis is not None:
            raise NotImplementedError(
                "sequence parallelism is not ported yet (ROADMAP queue 1 "
                "item 13)")
        self._mesh = mesh

    def param_logical_axes(self) -> Dict[str, Any]:
        return vit_logical_axes(self.config)

    # -- model -----------------------------------------------------------
    def init_params(self, generator: torch.Generator, batch: Any) -> Any:
        del batch
        return init_vit_params(generator, self.config)

    def _forward(self, params: Any, x: torch.Tensor) -> torch.Tensor:
        return vit_forward(params, x, self.config, mesh=self._mesh)

    def configure_optimizers(self):
        lr = self.lr

        def adamw(leaves):
            # optax.adamw(lr): weight_decay 1e-4 (torch's default is 0.01).
            return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=1e-4)

        if self.warmup_steps:
            sched = warmup_cosine_decay_schedule(
                0.0, self.lr, self.warmup_steps, max(self.warmup_steps * 10, 100)
            )
            return {"optimizer": adamw, "lr_schedule": sched}
        return adamw
