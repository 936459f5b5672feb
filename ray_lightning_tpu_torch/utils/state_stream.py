"""Tree of tensors <-> bytes: the port's checkpoint wire format.

The counterpart of the JAX package's ``utils/state_stream.py``: a
checkpoint is a nested dict/list/tuple tree whose leaves are tensors,
numpy arrays or plain Python values, written with ``torch.save``. Files
written by one package are not read by the other.
"""
import io
import os
from typing import Any, Optional, Union

import torch


def to_state_stream(tree: Any) -> bytes:
    """Serialize a tree of tensors / arrays / plain values to bytes."""
    buf = io.BytesIO()
    torch.save(tree, buf)
    return buf.getvalue()


def load_state_stream(
    stream: bytes, device: Optional[Union[str, torch.device]] = None
) -> Any:
    """Restore a tree from :func:`to_state_stream` bytes; tensor leaves
    land on ``device`` (the CPU by default), numpy leaves stay numpy."""
    # weights_only=False: the tree holds numpy arrays and plain values, and
    # the stream is the trainer's own checkpoint.
    return torch.load(
        io.BytesIO(stream), map_location=device or "cpu", weights_only=False
    )


def state_stream_to_file(stream: bytes, path: str) -> None:
    """Write a state stream to ``path`` atomically (temporary file, then
    rename): a process killed mid-save never leaves a truncated checkpoint
    in place of the previous one."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with io.open(tmp, "wb") as f:
            f.write(stream)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
