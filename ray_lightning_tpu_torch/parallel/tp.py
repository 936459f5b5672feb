"""Megatron-style tensor parallelism over the mesh's ``"model"`` axis.

The JAX package has no module for this: XLA's partitioner inserts the
collectives from the parameters' shardings. Here the model's forward
places them itself, through three autograd functions over the model
group (Megatron-LM's ``f``, ``g`` and the gather of a split output):

- :func:`copy_to_model`: identity forward, all-reduce backward. It goes
  in front of a product with a split weight, whose input gradient each
  rank has only a part of;
- :func:`reduce_from_model`: all-reduce forward, identity backward. It
  sums the partial outputs of a product over a split contraction dim;
- :func:`gather_from_model`: all-gather forward along a dim, slice
  backward. It makes an output split along that dim whole.

With no group (a model extent of 1) each is the identity and issues no
collective, so a fit at model extent 1 runs the same operations as one
without a mesh. The all-gather goes through
:func:`~ray_lightning_tpu_torch.parallel.mesh.all_gather`, which stages
CUDA tensors through host memory on gloo.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import torch


@dataclass
class CollectiveStats:
    """The model group's all-reduces this process ran (``calls``) and, for
    those on gloo, their host seconds (``seconds``): each timed from a
    device sync before it to its return (a gloo collective of a CUDA
    tensor stages through the host and waits for the stream anyway). An
    NCCL all-reduce is counted, not timed: it is queued on the stream, and
    inside a CUDA graph it runs at each replay, not at the call."""

    calls: int = 0
    seconds: float = 0.0


collective_stats = CollectiveStats()


def _all_reduce(x: torch.Tensor, group: Any) -> torch.Tensor:
    import torch.distributed as dist

    out = x.contiguous().clone()
    if dist.get_backend(group) != "gloo":
        collective_stats.calls += 1
        dist.all_reduce(out, group=group)
        return out
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    t0 = time.perf_counter()
    dist.all_reduce(out, group=group)
    collective_stats.seconds += time.perf_counter() - t0
    collective_stats.calls += 1
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any) -> torch.Tensor:
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
        import torch.distributed as dist

        from ray_lightning_tpu_torch.parallel.mesh import all_gather

        n = dist.get_world_size(group)
        dim = dim % x.dim()
        ctx.dim, ctx.rank, ctx.size = dim, dist.get_rank(group), x.shape[dim]
        moved = x.movedim(dim, 0).contiguous()
        buf = torch.empty((n * moved.shape[0],) + tuple(moved.shape[1:]),
                          dtype=x.dtype, device=x.device)
        all_gather(buf, moved, group)
        return buf.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


def copy_to_model(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over ``group``."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: Any) -> torch.Tensor:
    """``x`` summed over ``group``; the gradient passes unchanged."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order;
    the gradient is this rank's slice."""
    return x if group is None else _GatherFromModel.apply(x, dim, group)
