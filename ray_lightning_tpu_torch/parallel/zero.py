"""ZeRO-style sharding rules for parameter and optimizer-state trees (the
port of ``ray_lightning_tpu/parallel/zero.py``).

The JAX package annotates each leaf with a ``NamedSharding`` that splits
its largest divisible axis over the mesh's ``"data"`` axis and lets XLA
emit the gathers. Here the same rule picks the dim a leaf is split along
(:func:`shard_dim_for`), each rank keeps its slice of that dim, and the
gathers are explicit ``torch.distributed`` all-gathers
(:func:`all_gather_into`, :func:`gather_to_host`).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from ray_lightning_tpu_torch.utils.tree import tree_leaves, tree_map


def shard_dim_for(shape: Sequence[int], world: int) -> Optional[int]:
    """The dim to split a leaf of ``shape`` along over ``world`` ranks:
    the largest dim divisible by ``world`` and at least ``world`` long
    (the first such on a tie), or None (replicated: scalars, and leaves
    with no such dim) — the rule of JAX ``shard_spec_for``."""
    best_dim: Optional[int] = None
    best_size = 0
    for dim, size in enumerate(shape):
        if size % world == 0 and size > best_size and size >= world:
            best_dim = dim
            best_size = size
    return best_dim


def tree_shard_dims(tree: Any, world: int) -> Any:
    """A tree mirroring ``tree`` with each leaf's :func:`shard_dim_for`."""
    return tree_map(lambda x: shard_dim_for(tuple(x.shape), world), tree)


def shard_slice(full: torch.Tensor, dim: Optional[int], rank: int,
                world: int) -> torch.Tensor:
    """Rank ``rank``'s slice of ``full`` along ``dim`` (a view; the whole
    tensor when ``dim`` is None)."""
    if dim is None:
        return full
    n = full.shape[dim] // world
    return full.narrow(dim, rank * n, n)


@torch.no_grad()
def all_gather_into(full: torch.Tensor, shard: torch.Tensor, dim: int,
                    world: int, group: Any = None) -> None:
    """Write every rank's ``shard`` into ``full`` (split along ``dim``),
    in place, over ``group`` (the world by default): straight into
    ``full`` when ``dim`` is 0, else through a stacked buffer and one
    copy. A CUDA tensor on gloo goes through host memory
    (:func:`~ray_lightning_tpu_torch.parallel.mesh.all_gather`)."""
    from ray_lightning_tpu_torch.parallel.mesh import all_gather

    if dim == 0 and full.is_contiguous():
        all_gather(full, shard.contiguous(), group)
        return
    shape = tuple(shard.shape)
    buf = torch.empty((world * shape[0],) + shape[1:], dtype=shard.dtype,
                      device=shard.device)
    all_gather(buf, shard.contiguous(), group)
    full.copy_(buf.view((world,) + shape).movedim(0, dim).reshape(full.shape))


def gather_full(shard: torch.Tensor, dim: Optional[int], world: int,
                group: Any = None) -> torch.Tensor:
    """A new full tensor from every rank's ``shard`` (collective)."""
    if dim is None:
        return shard
    shape = list(shard.shape)
    shape[dim] *= world
    full = torch.empty(shape, dtype=shard.dtype, device=shard.device)
    all_gather_into(full, shard, dim, world, group)
    return full


def gather_to_host(shards: Any, dims: Any, world: int,
                   group: Any = None) -> Any:
    """All-gather a tree of slices (split as ``dims`` says) over ``group``
    into a tree of full CPU tensors: the checkpoint path of sharded state.
    Every rank of the group must call it."""
    dim_leaves = iter(tree_leaves(dims))
    return tree_map(
        lambda x: gather_full(x, next(dim_leaves), world, group)
        .detach().cpu(),
        shards)


def sharded_bytes_fraction(tree: Any, dims: Any) -> float:
    """Fraction of the tree's elements in leaves that are split (the
    diagnostic of JAX ``sharded_bytes_fraction``, which counts elements
    too)."""
    total = sharded = 0
    for leaf, dim in zip(tree_leaves(tree), tree_leaves(dims)):
        n = 1
        for s in tuple(leaf.shape):
            n *= int(s)
        total += n
        if dim is not None:
            sharded += n
    return sharded / total if total else 0.0
