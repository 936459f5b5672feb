"""Attention ops of the port: the plain reference and flash attention
(hand-written CUDA kernels for Hopper, forward and backward, each with its
plain PyTorch version).

Kernels are built at first use (``_build.py``), never at import.
"""
from ray_lightning_tpu_torch.ops.attention import (
    attention_reference,
    band_allowed,
    causal_mask_allowed,
)
from ray_lightning_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
)

__all__ = [
    "attention_reference",
    "band_allowed",
    "causal_mask_allowed",
    "flash_attention",
    "flash_attention_bwd_plain",
    "flash_attention_plain",
]
