"""Attention ops of the port: the plain reference and the flash forward
(a hand-written CUDA kernel for Hopper, with its plain PyTorch version).

Kernels are built at first use (``_build.py``), never at import.
"""
from ray_lightning_tpu_torch.ops.attention import (
    attention_reference,
    band_allowed,
    causal_mask_allowed,
)
from ray_lightning_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
)

__all__ = [
    "attention_reference",
    "band_allowed",
    "causal_mask_allowed",
    "flash_attention",
    "flash_attention_plain",
]
