"""CUDA graphs: the port's counterpart of a compiled XLA executable.

The JAX package compiles each dispatch once and then only executes it. Here
a dispatch is a *body*, a function that reads its inputs from fixed device
buffers and writes its results into fixed device buffers, with no value
read back to the host. :class:`Program` captures a body once on the card
and replays it; elsewhere (the CPU, or the card when the caller asks for
eager dispatch) it runs the same body directly, so both see the same data
flow.

A capture that fails raises: nothing falls back to eager on its own.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from ray_lightning_tpu_torch.ops.flash_attention import counters

_COUNTS = ("launches", "bwd_dkv_launches", "bwd_dq_launches", "reference")


@dataclass
class CaptureStats:
    """Graphs this process captured (every :meth:`Program.capture`). A
    serving replica reads ``graphs`` once its engine is built: a capture
    after that is the port's counterpart of a steady-state backend
    compile in the JAX package (``compiles_since_init``)."""

    graphs: int = 0


capture_stats = CaptureStats()


def _snapshot() -> tuple:
    return tuple(getattr(counters, n) for n in _COUNTS)


class Program:
    """One body, captured as a CUDA graph when ``capture`` is set (the
    device must be CUDA) and run as is otherwise.

    Capture runs the body once on a side stream first (the kernels'
    one-time set-ups, cuBLAS's workspace and the caching allocator's first
    blocks must not happen under capture), then records it into a graph
    whose intermediates live in ``pool`` (one pool shared by an engine's
    graphs: they replay one at a time on one stream, and every result a
    later dispatch reads is in a buffer allocated outside the pool).
    Every capture of the process runs on the same side stream: the caching
    allocator hands a freed block only to an allocation on the stream that
    freed it, so graphs captured on streams of their own could not reuse
    each other's blocks, and a shared pool would grow to the sum of its
    graphs' working sets instead of the largest.

    The flash kernels' launch counters go up where the Python wrapper
    launches a kernel, which a replay does not run: the launches a capture
    records are taken back off the counters (capture launches nothing) and
    added on every replay, so the counters count what ran on the card."""

    def __init__(
        self,
        body: Callable[[], Any],
        capture: bool = False,
        pool: Any = None,
    ) -> None:
        self.body = body
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches = (0,) * len(_COUNTS)
        if capture:
            self.warm_up()
            self.capture(pool)

    def warm_up(self) -> None:
        """Run the body once on the stream the capture will use."""
        side = side_stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.body()
        torch.cuda.current_stream().wait_stream(side)

    def capture(self, pool: Any = None, generators: tuple = ()) -> None:
        """Record the body into a CUDA graph (it runs nothing)."""
        side = side_stream()
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            # A generator the body draws from: each replay then reads the
            # seed and offset it holds at that moment.
            graph.register_generator_state(g)
        before = _snapshot()
        with torch.cuda.graph(graph, pool=pool, stream=side):
            self.body()
        after = _snapshot()
        self.launches = tuple(a - b for a, b in zip(after, before))
        for name, value in zip(_COUNTS, before):
            setattr(counters, name, value)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = graph
        capture_stats.graphs += 1

    def __call__(self) -> None:
        if self.graph is None:
            self.body()
            return
        self.graph.replay()
        for name, n in zip(_COUNTS, self.launches):
            if n:
                setattr(counters, name, getattr(counters, name) + n)


_SIDE: Dict[int, "torch.cuda.Stream"] = {}


def side_stream() -> "torch.cuda.Stream":
    """The current device's one warm-up and capture stream."""
    dev = torch.cuda.current_device()
    if dev not in _SIDE:
        _SIDE[dev] = torch.cuda.Stream(dev)
    return _SIDE[dev]


def pinned_copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` for a host tensor ``src``: on the card through a
    pinned staging copy, non-blocking, so the host does not wait for the
    stream (PyTorch's pinned allocator keeps the staging buffer until the
    copy has run)."""
    if dst.device.type == "cuda":
        src = src.pin_memory()
    dst.copy_(src, non_blocking=True)
