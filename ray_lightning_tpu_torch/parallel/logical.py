"""Logical-axis sharding rules for multi-axis meshes (the port of
``ray_lightning_tpu/parallel/logical.py``).

Models name each parameter axis ("embed", "heads", "mlp", "vocab", ...)
and a rule list maps logical names to mesh axes ("data", "fsdp",
"model", ...), so the same model runs data-parallel, FSDP, tensor-
parallel or any mix by changing the mesh alone. The JAX package turns the
result into a ``PartitionSpec`` and lets XLA partition the program; here a
spec is a per-dim tuple of mesh-axis names (or None), and each rank keeps
its slice of every leaf (:func:`shard_of`) while the model's forward runs
the collectives itself (``parallel/tp.py``).
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np

#: A tensor's placement: per dim, the mesh axis it is split over, or None.
Spec = Tuple[Optional[str], ...]

# Default rules, checked in order. First rule whose mesh axis exists in the
# mesh *and* divides the tensor dim wins. "embed"->fsdp gives ZeRO-3-style
# parameter sharding; "heads"/"mlp"/"vocab"->model is megatron-style TP.
DEFAULT_RULES: Tuple[Tuple[str, Optional[str]], ...] = (
    ("batch", "data"),
    ("batch", "fsdp"),
    ("vocab", "model"),
    ("heads", "model"),
    ("mlp", "model"),
    ("embed", "fsdp"),
    ("kv", None),
    ("layers", "pp"),  # pipeline stages when the mesh has a pp axis...
    ("layers", None),  # ...replicated otherwise (terminal)
    ("seq", "seq"),
    ("expert", "ep"),
)


def spec_from_logical(
    shape: Sequence[int],
    logical_axes: Sequence[Optional[str]],
    rules: Sequence[Tuple[str, Optional[str]]],
    mesh_shape: Mapping[str, int],
) -> Spec:
    """Resolve one tensor's logical axis names to a per-dim spec.

    Rules are checked in order per logical name. A ``(name, None)`` rule
    is terminal: it pins that logical axis replicated. A rule whose mesh
    axis is absent, has size 1, does not divide the tensor dim, or was
    already used by an earlier tensor axis (a mesh axis appears at most
    once per spec) falls through to the next matching rule.
    """
    if len(shape) != len(logical_axes):
        raise ValueError(
            f"shape {tuple(shape)} has {len(shape)} dims but "
            f"{len(logical_axes)} logical axes {tuple(logical_axes)}"
        )
    used: set = set()
    spec: list = []
    for dim_size, logical in zip(shape, logical_axes):
        assigned = None
        if logical is not None:
            for name, mesh_axis in rules:
                if name != logical:
                    continue
                if mesh_axis is None:
                    break  # explicit replicate: terminal
                size = int(mesh_shape.get(mesh_axis, 1))
                if size <= 1 or mesh_axis in used:
                    continue
                if dim_size % size:
                    continue
                assigned = mesh_axis
                used.add(mesh_axis)
                break
        spec.append(assigned)
    return tuple(spec)


def tree_logical_specs(
    tree: Any,
    logical_tree: Any,
    mesh_shape: Mapping[str, int],
    rules: Optional[Sequence[Tuple[str, Optional[str]]]] = None,
) -> Any:
    """A tree of specs from a matching tree of logical-axis tuples (the
    counterpart of JAX ``tree_logical_shardings``)."""
    rules = tuple(rules) if rules is not None else DEFAULT_RULES

    def walk(x: Any, axes: Any) -> Any:
        if isinstance(x, dict):
            return {k: walk(v, axes[k]) for k, v in x.items()}
        return spec_from_logical(tuple(np.shape(x)), axes, rules, mesh_shape)

    return walk(tree, logical_tree)


def split_dim(spec: Spec, axis: str) -> Optional[int]:
    """The dim ``spec`` splits over mesh axis ``axis``, or None."""
    for dim, ax in enumerate(spec):
        if ax == axis:
            return dim
    return None


def shard_of(full: Any, spec: Spec, coords: Mapping[str, int],
             mesh_shape: Mapping[str, int]) -> Any:
    """The rank at ``coords``' slice of ``full`` (a view): each dim the
    spec splits over an axis of size n keeps its ``coords[axis]``-th of n
    equal blocks. ``full`` is a tensor or a numpy array."""
    index = []
    for dim, axis in enumerate(spec):
        n = int(mesh_shape.get(axis, 1)) if axis is not None else 1
        size = full.shape[dim] // n
        start = int(coords.get(axis, 0)) * size if n > 1 else 0
        index.append(slice(start, start + size))
    return full[tuple(index)]


def unshard(pieces: Mapping[Tuple[int, ...], Any], spec: Spec,
            mesh_shape: Mapping[str, int]) -> Any:
    """Reassemble a full tensor from its pieces: ``pieces`` maps each
    piece's block index along the split dims (in dim order, one entry per
    split dim) to the piece (the inverse of :func:`shard_of`)."""
    import torch

    split = [(dim, axis) for dim, axis in enumerate(spec)
             if axis is not None and int(mesh_shape.get(axis, 1)) > 1]
    if not split:
        (only,) = pieces.values()
        return only

    def join(prefix: Tuple[int, ...], level: int) -> Any:
        if level == len(split):
            return pieces[prefix]
        dim, axis = split[level]
        return torch.cat([join(prefix + (i,), level + 1)
                          for i in range(int(mesh_shape[axis]))], dim=dim)

    return join((), 0)


def block_index(spec: Spec, coords: Mapping[str, int],
                mesh_shape: Mapping[str, int]) -> Tuple[int, ...]:
    """The key of the piece at ``coords`` in :func:`unshard`'s mapping."""
    return tuple(int(coords.get(axis, 0)) for axis in spec
                 if axis is not None and int(mesh_shape.get(axis, 1)) > 1)

