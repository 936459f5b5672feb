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
