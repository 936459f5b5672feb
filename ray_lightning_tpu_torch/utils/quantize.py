"""Weight access for the port's GPT paths (subset of the JAX package's
``utils/quantize.py``).

The JAX package consumes weight-only int8 nodes ``{"q": int8, "s": f32}``
through these two functions. The port takes plain float tensors only for
now; int8 trees are ROADMAP queue 1 item 8, and an int8 node is refused rather
than read wrongly.
"""
from __future__ import annotations

from typing import Any

import torch


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and set(w) == {"q", "s"}


def _refuse_int8(w: Any) -> None:
    if is_quantized(w):
        raise NotImplementedError(
            "int8 weight trees are not ported yet (ROADMAP queue 1 item "
            "8); pass float weights"
        )


def dequant(w: Any, dt: torch.dtype) -> torch.Tensor:
    """Dense weights in ``dt``. A tensor already in ``dt`` comes back as
    is (no copy), which is how the engine's compute-dtype copy, made once
    at construction, passes through every step for free."""
    _refuse_int8(w)
    return w.to(dt)


def embed_rows(table: Any, idx: torch.Tensor) -> torch.Tensor:
    """Row gather from a (V, D) table."""
    _refuse_int8(table)
    return table[idx]
