"""Reference scaled-dot-product attention (plain PyTorch).

Ground truth for the flash kernel's checks and the path taken for shapes
the kernel's wrapper does not accept. Layout convention throughout the
port, as in the JAX package: ``(batch, seq, heads, head_dim)``.
"""
from __future__ import annotations

from typing import Optional

import torch


def band_allowed(
    row: torch.Tensor, col: torch.Tensor, window: int = 0, sinks: int = 0
) -> torch.Tensor:
    """The causal (+optional sliding-window) band predicate on position
    index tensors: key ``col`` is visible to query ``row`` iff
    ``col <= row`` and, with ``window=W > 0``, ``col > row - W`` OR
    ``col < sinks`` (attention sinks: the first ``sinks`` positions stay
    visible to every query). One definition shared by the reference mask,
    the flash plain version and the decode mask."""
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if sinks < 0:
        raise ValueError(f"sinks must be >= 0, got {sinks}")
    if sinks and not window:
        # Without a window every query already sees the first positions; a
        # sinks-only config is a no-op the user almost certainly didn't
        # mean — fail identically on every attention path.
        raise ValueError("sinks only apply with a sliding window")
    allowed = col <= row
    if window:
        in_band = col > row - window
        if sinks:
            in_band = in_band | (col < sinks)
        allowed = allowed & in_band
    return allowed


def causal_mask_allowed(
    sq: int,
    sk: int,
    row_offset: int = 0,
    col_offset: int = 0,
    window: int = 0,
    sinks: int = 0,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Bool (sq, sk) matrix, True where attention is allowed.

    With no offsets the diagonal is aligned to the *end* of the key sequence
    (decode-style Sq < Sk: queries are the last Sq positions); otherwise
    the offsets are global row/col positions. ``window=W > 0`` restricts
    each query to its W most recent positions (itself included).
    """
    if row_offset == 0 and col_offset == 0:
        row_offset = sk - sq
    row = torch.arange(sq, device=device)[:, None] + row_offset
    col = torch.arange(sk, device=device)[None, :] + col_offset
    return band_allowed(row, col, window, sinks)


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    window: int = 0,
    sinks: int = 0,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v with optional causal (+sliding-window) mask.

    Shapes: q (B, Sq, H, D); k, v (B, Sk, H, D) -> (B, Sq, H, D). Scores and
    softmax are fp32 whatever the input dtype; the probabilities are cast
    to v's dtype for the second product, as in the JAX reference.
    """
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if window and not causal:
        raise ValueError("window attention requires causal=True")
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        allowed = causal_mask_allowed(
            q.shape[1], k.shape[1], window=window, sinks=sinks,
            device=q.device,
        )
        s = s.masked_fill(~allowed, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)
