"""Process groups of the launched strategies (the port of
``ray_lightning_tpu/parallel/mesh.py``).

The JAX package rendezvous with ``jax.distributed.initialize`` and builds
a ``Mesh`` over every chip, and XLA routes each collective over the mesh
axes its shardings name. The port does what the reference does
(``ray_ddp.py:192-196``): ``torch.distributed.init_process_group`` on a
TCP store at the coordinator, one rank per process, and then
:func:`build_mesh` lays the ranks out on the six axes of the JAX
strategy, ``("data", "fsdp", "model", "seq", "ep", "pp")``: rank ``r``
sits at ``np.unravel_index(r, sizes)``, row-major, so the data-parallel
axes lead as the JAX device order does. The mesh holds one process group
per axis larger than 1 and one for the data-parallel extent (data x
fsdp), each made once per world with ``new_group``.

Gloo, the only group ranks sharing a card can form, has no all-gather of
CUDA tensors: :func:`all_gather` stages such a tensor through pinned host
memory, on gloo only; on NCCL it is the plain collective, which a CUDA
graph captures.

A serving mesh is ``"MODELxDATA"`` (:func:`parse_mesh_spec`):
:func:`mesh_from_spec` lays the joined world out as ``model`` x ``data``
ranks through :func:`build_mesh`. Each rank of a serving gang holds its
``1/model`` of the heads and MLP columns; the ``data`` ranks hold the same
slices and run the same work (the JAX engine replicates its slots over
``"data"``), so no collective crosses that axis.
"""
from __future__ import annotations

import datetime
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ray_lightning_tpu_torch.parallel.env import DistEnv
from ray_lightning_tpu_torch.utils.ports import find_free_port


def setup_distributed(env: DistEnv,
                      timeout_s: Optional[float] = None) -> None:
    """Join this process to its group: ``env.world_size`` ranks over
    ``env.backend`` at ``env.coordinator_address``. A group of one (which
    the launcher gives no coordinator) rendezvous on a free local port,
    so a one-worker fit runs the same collectives as a larger one."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("this process already belongs to a process group")
    if env.backend is None:
        raise ValueError("DistEnv.backend is not set")
    address = env.coordinator_address
    if address is None:
        if env.world_size != 1:
            raise ValueError(
                f"a group of {env.world_size} ranks needs a coordinator "
                "address")
        address = f"127.0.0.1:{find_free_port('127.0.0.1')}"
    kwargs: dict = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    dist.init_process_group(
        backend=env.backend,
        init_method=f"tcp://{address}",
        world_size=int(env.world_size),
        rank=int(env.host_rank),
        **kwargs,
    )


def teardown_distributed() -> None:
    """Leave the process group, if this process is in one."""
    import torch.distributed as dist

    _MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


#: The mesh axes, in the JAX strategy's order (JAX ``strategies/gspmd.py:21``).
AXES: Tuple[str, ...] = ("data", "fsdp", "model", "seq", "ep", "pp")

#: Meshes of this process's world, by their axis sizes (built once).
_MESHES: Dict[Tuple[int, ...], "Mesh"] = {}


def mesh_coords(rank: int, sizes: Mapping[str, int]) -> Dict[str, int]:
    """Rank ``rank``'s coordinate on each axis: ``np.unravel_index`` of the
    rank over the axis sizes in :data:`AXES` order (row-major)."""
    dims = tuple(int(sizes.get(ax, 1)) for ax in AXES)
    return dict(zip(AXES, (int(c) for c in np.unravel_index(int(rank), dims))))


class Mesh:
    """This rank's place on the six-axis mesh and the groups it belongs
    to. ``shape`` maps every axis to its size; :meth:`group` is None for an
    axis of size 1 (nothing to reduce over)."""

    def __init__(self, sizes: Mapping[str, int], rank: int,
                 groups: Dict[str, Any], backend: Optional[str]) -> None:
        self.shape: Dict[str, int] = {ax: int(sizes.get(ax, 1)) for ax in AXES}
        self.rank = int(rank)
        self.coords = mesh_coords(rank, self.shape)
        self.backend = backend
        self._groups = groups

    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return AXES

    @property
    def dp_size(self) -> int:
        """The data-parallel extent: data x fsdp."""
        return self.shape["data"] * self.shape["fsdp"]

    @property
    def dp_rank(self) -> int:
        """This rank's data-parallel shard."""
        return self.coords["data"] * self.shape["fsdp"] + self.coords["fsdp"]

    @property
    def replica_head(self) -> bool:
        """Whether this rank is the first of the ranks holding its data-
        parallel shard (coordinate 0 on every other axis)."""
        return all(self.coords[ax] == 0 for ax in AXES[2:])

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def group(self, axis: str) -> Any:
        """The group of the ranks that differ from this one on ``axis``
        alone (``"dp"``: on data and fsdp), or None at size 1."""
        return self._groups.get(axis)


def _axis_members(rank: int, sizes: Dict[str, int],
                  axes: Tuple[str, ...]) -> Tuple[int, ...]:
    """The ranks that share ``rank``'s coordinates off ``axes``, in
    ascending order."""
    mine = mesh_coords(rank, sizes)
    world = int(np.prod([sizes[ax] for ax in AXES]))
    return tuple(r for r in range(world)
                 if all(mesh_coords(r, sizes)[ax] == mine[ax]
                        for ax in AXES if ax not in axes))


def build_mesh(sizes: Optional[Mapping[str, int]] = None) -> Mesh:
    """This process's :class:`Mesh` over the world it joined (a collective
    the first time for a given shape: every rank makes every group, in one
    order). ``sizes`` maps axis names to sizes, missing axes 1; None puts
    the whole world on ``"data"``. The sizes must multiply to the world."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    shape = {ax: 1 for ax in AXES}
    shape.update({k: int(v) for k, v in (sizes or {"data": world}).items()})
    unknown = [k for k in shape if k not in AXES]
    if unknown:
        raise ValueError(f"unknown mesh axis {unknown[0]!r}; valid: {AXES}")
    if int(np.prod(list(shape.values()))) != world:
        named = ", ".join(f"{ax}={shape[ax]}" for ax in AXES if shape[ax] > 1)
        raise ValueError(
            f"mesh shape ({named or 'all 1'}) covers "
            f"{int(np.prod(list(shape.values())))} rank(s) but the world "
            f"has {world}: the axis sizes must multiply to exactly the "
            "world size")
    key = tuple(shape[ax] for ax in AXES)
    if key in _MESHES:
        return _MESHES[key]
    groups: Dict[str, Any] = {}
    sets = [(ax, (ax,)) for ax in AXES] + [("dp", ("data", "fsdp"))]
    for name, axes in sets:
        n = int(np.prod([shape[ax] for ax in axes]))
        if n <= 1:
            continue
        if n == world:
            groups[name] = dist.group.WORLD
            continue
        # Every rank makes every group of this kind, lowest member first.
        seen = set()
        for r in range(world):
            members = _axis_members(r, shape, axes)
            if members in seen:
                continue
            seen.add(members)
            g = dist.new_group(list(members))
            if rank in members:
                groups[name] = g
    backend = dist.get_backend() if dist.is_initialized() else None
    mesh = _MESHES[key] = Mesh(shape, rank, groups, backend)
    return mesh


# -- serving meshes -----------------------------------------------------------


def parse_mesh_spec(spec: Union[str, int, None]) -> Tuple[int, int]:
    """Parse a serving mesh spec ``"MODELxDATA"`` into ``(model, data)``
    (JAX ``parallel/mesh.py:21-62``, the same vocabulary and messages):
    ``"1x1"`` (one rank), ``"4x1"`` (4-way tensor parallel), ``"4x2"``, or
    a bare integer / ``"8"`` meaning ``8x1``. Anything else raises naming
    the valid forms. Whether the sizes factor the world is
    :func:`mesh_from_spec`'s check, which needs the joined group."""
    if spec is None:
        return (1, 1)
    if isinstance(spec, bool):  # YAML 1.1: a bare "on"/"off" typo
        raise ValueError(
            f"malformed mesh spec {spec!r}: use 'MODELxDATA' (e.g. '1x1', "
            "'4x1', '4x2') or a bare model-axis size like '8'"
        )
    if isinstance(spec, int):
        parts: Tuple[Union[str, int], ...] = (spec, 1)
    else:
        text = str(spec).strip().lower()
        parts = tuple(text.split("x")) if text else ()
        if len(parts) == 1:
            parts = (parts[0], 1)
    try:
        if len(parts) != 2:
            raise ValueError
        model, data = (int(p) for p in parts)
    except (TypeError, ValueError):
        raise ValueError(
            f"malformed mesh spec {spec!r}: use 'MODELxDATA' with positive "
            "integer axis sizes (e.g. '1x1', '4x1', '4x2'), or a bare "
            "model-axis size like '8'"
        ) from None
    if model < 1 or data < 1:
        raise ValueError(
            f"malformed mesh spec {spec!r}: 'MODELxDATA' axis sizes must "
            "be >= 1 (e.g. '1x1', '4x1', '4x2')"
        )
    return model, data


def mesh_from_spec(spec: Union[str, int, None]) -> Optional[Mesh]:
    """This rank's serving mesh from a ``"MODELxDATA"`` spec: None for
    ``None`` / ``"1x1"`` (the one-card engine), else :func:`build_mesh`
    with ``{"model": model, "data": data}`` over the joined world (a
    collective the first time: every rank calls it together). The port
    runs one rank per card, so the world must be exactly ``model x
    data`` ranks (JAX ``:86-103`` asks the same of the devices)."""
    import torch.distributed as dist

    model, data = parse_mesh_spec(spec)
    if model * data == 1:
        return None
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model * data != world:
        raise ValueError(
            f"mesh shape (model={model}, data={data}) covers {model * data} "
            f"rank(s) but the serving world has {world}: the axis sizes must "
            f"multiply to EXACTLY the number of ranks. Pick sizes that "
            f"factor {world} (e.g. shrink an axis), or start the gang with "
            f"{model * data} ranks (start_replicas(hosts_per_replica="
            f"{model * data}), one process per card)"
        )
    return build_mesh({"model": model, "data": data})


# -- collectives that gloo lacks for CUDA tensors ---------------------------


def _staged(t: torch.Tensor, group: Any) -> bool:
    """Whether a collective of ``t`` over ``group`` goes through host
    memory: a CUDA tensor on a gloo group."""
    import torch.distributed as dist

    return t.is_cuda and dist.get_backend(group) == "gloo"


def _all_gather_single(out: torch.Tensor, inp: torch.Tensor,
                       group: Any) -> None:
    import torch.distributed as dist

    # torch 2.13 names this collective all_gather_single and deprecates
    # all_gather_into_tensor, the only name earlier releases (2.11) have.
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, inp, group=group)


@torch.no_grad()
def all_gather(out: torch.Tensor, inp: torch.Tensor, group: Any = None) -> None:
    """Every rank's ``inp`` into ``out``, stacked along dim 0 in group-
    rank order (the group's ranks ascend, so along the mesh axis). A CUDA
    tensor on gloo goes through pinned host buffers."""
    if not _staged(inp, group):
        _all_gather_single(out, inp.contiguous(), group)
        return
    pin = inp.is_cuda
    host_in = torch.empty(inp.shape, dtype=inp.dtype, pin_memory=pin)
    host_in.copy_(inp)
    host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=pin)
    _all_gather_single(host_out, host_in, group)
    out.copy_(host_out)
