"""Device resolution for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device(device)``, raising when it names CUDA and no card is
    present: the entry points run on the card unless the caller asks for
    the CPU (``device="cpu"``), and never fall back on their own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to "
            "run on the CPU"
        )
    return dev


def host_to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Copy the host tensor ``t`` to ``device`` without waiting for the
    stream: on the card it is staged in pinned memory and copied
    non-blocking (a copy from pageable memory blocks the host until the
    stream drains, work queued before it included). PyTorch's pinned
    allocator keeps the staging buffer until the copy has run."""
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
