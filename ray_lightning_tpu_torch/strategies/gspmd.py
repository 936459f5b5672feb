"""``GSPMDStrategy``: multi-axis mesh parallelism, data x fsdp x model (the
port of ``ray_lightning_tpu/strategies/gspmd.py``).

The JAX strategy expresses data parallelism, ZeRO/FSDP parameter
sharding, Megatron-style tensor parallelism and sequence parallelism as
axes of one mesh, ``("data", "fsdp", "model", "seq", "ep", "pp")``:
models name their parameter axes (``param_logical_axes``), the rules of
``parallel/logical.py`` map them to mesh axes, and XLA's partitioner
inserts the collectives. Here each rank is one process at its mesh
coordinates (``parallel/mesh.py``) and the collectives are explicit:

- ``"model"``: each rank holds its slices of the leaves the rules split
  over the model axis (heads, MLP columns, a divisible vocab) and the
  model's forward runs the Megatron collectives over the model group
  (``parallel/tp.py``; ``GPTLM.bind_mesh``);
- ``"fsdp"``: the leaves split over fsdp rest as this rank's slices (the
  optimizer's, as ZeRO-3 does, :class:`MeshTrainOptimizer`) and are
  gathered over the fsdp group layer by layer in the step
  (``parallel/zero.py:LayerGather``); a rule may map a parameter axis
  onto ``"data"`` too, and such a leaf is split and gathered over the
  data group the same way (over data x fsdp where both split it);
- ``"data"`` and ``"fsdp"`` together are the data-parallel extent: the
  sampler shards rows over it, ranks that share a data-parallel shard
  load the same rows, and gradients, logs and eval sums are averaged
  over its group only, never over ``"model"``.

``seq``, ``ep`` and ``pp`` larger than 1, and ``sequence_parallel``, need
ring attention, MoE and the pipeline: ROADMAP queue 1 item 13.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_lightning_tpu_torch.parallel.logical import (
    shard_of,
    split_dim,
    tree_logical_specs,
)
from ray_lightning_tpu_torch.parallel.mesh import AXES, Mesh, build_mesh
from ray_lightning_tpu_torch.parallel.zero import (
    Split,
    gather_full,
    shard_dim_for,
)
from ray_lightning_tpu_torch.strategies.base import not_ported, to_host
from ray_lightning_tpu_torch.strategies.ddp import RayGPUStrategy
from ray_lightning_tpu_torch.strategies.sharded import ShardedTrainOptimizer
from ray_lightning_tpu_torch.trainer.optim import global_norm
from ray_lightning_tpu_torch.utils.tree import tree_leaves, tree_map


def _spec_leaves(specs: Any) -> List[Tuple[Optional[str], ...]]:
    """The specs of a spec tree in tree-leaf order (a spec is a tuple, so
    :func:`tree_leaves` would descend into it)."""
    if isinstance(specs, dict):
        return [x for v in specs.values() for x in _spec_leaves(v)]
    return [specs]


def _same_structure(tree: Any, specs: Any) -> bool:
    if isinstance(specs, dict):
        return (isinstance(tree, dict) and tree.keys() == specs.keys()
                and all(_same_structure(tree[k], specs[k]) for k in specs))
    return isinstance(tree, torch.Tensor) and tree.dim() == len(specs)


def zero_split(spec: Tuple[Optional[str], ...], mesh: Any) -> Optional[Split]:
    """How the ranks of a data-parallel shard hold a leaf of ``spec``
    beyond its model slice: the dims split over ``"data"`` and ``"fsdp"``
    (in the mesh's order, the rank order of its ``"dp"`` group), gathered
    over that axis's group, or over ``"dp"`` when both split it; None when
    neither does."""
    found = sorted(((d, ax) for d, ax in enumerate(spec)
                    if ax in ("data", "fsdp") and mesh.size(ax) > 1),
                   key=lambda p: AXES.index(p[1]))
    if not found:
        return None
    axes = tuple(ax for _, ax in found)
    return Split(dims=tuple(d for d, _ in found),
                 sizes=tuple(mesh.size(ax) for ax in axes),
                 index=tuple(mesh.coords[ax] for ax in axes),
                 group=mesh.group(axes[0] if len(axes) == 1 else "dp"),
                 axes=axes)


class MeshTrainOptimizer(ShardedTrainOptimizer):
    """The update of a rank's tensor-parallel slices: each leaf is this
    rank's slice over ``"model"``; a leaf also split over ``"fsdp"`` or
    ``"data"`` (or both: :func:`zero_split`) is stepped as this rank's
    slice of it and gathered layer by layer in the step, its gradient
    reduced into the slice over the data-parallel group (stage 3 of
    :class:`ShardedTrainOptimizer`). Clipping and the logged norm use the
    norm of the whole gradient (:meth:`norm`); AdamW's update is
    elementwise, so stepping slices is stepping the whole."""

    def __init__(self, factory: Callable, leaves: List[torch.Tensor],
                 lr_schedule: Optional[Callable[[int], float]],
                 clip: Optional[float], accumulate: int, *,
                 specs: Sequence[Tuple[Optional[str], ...]],
                 mesh: Any) -> None:
        self.mesh = mesh
        self.specs = list(specs)
        self.model_dims = [split_dim(sp, "model") for sp in self.specs]
        splits = [zero_split(sp, mesh) for sp in self.specs]
        super().__init__(
            factory, leaves, lr_schedule, clip=clip, accumulate=accumulate,
            stage=3 if any(sp is not None for sp in splits) else 1,
            rank=mesh.coords["fsdp"], world=mesh.size("fsdp"),
            group=mesh.group("fsdp"), splits=splits,
            reduce_group=mesh.group("dp"), reduce_size=mesh.dp_size)

    def norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The 2-norm of the whole gradient: the squares of this rank's
        slices summed over the group that splits each (its data/fsdp
        group, then the model group), plus those of the replicated leaves
        once."""
        group = self.mesh.group("model")
        if group is None and all(sp is None for sp in self.splits):
            return global_norm(grads)
        import torch.distributed as dist

        zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        # Per zero group (None: no zero split): [model-split, the rest].
        parts: Dict[Any, List[Any]] = {None: [zero, zero]}
        groups: Dict[Any, Any] = {}
        for g, sp, md in zip(grads, self.splits, self.model_dims):
            sq = (self._slice(g, sp).float() ** 2).sum()
            key = None if sp is None else sp.axes
            part = parts.setdefault(key, [zero, zero])
            part[0 if md is not None else 1] = part[0 if md is not None
                                                    else 1] + sq
            if sp is not None:
                groups[key] = sp.group
        split, whole = parts.pop(None)
        for key, (m, r) in parts.items():
            v = torch.stack([m, r])
            dist.all_reduce(v, group=groups[key])
            split, whole = split + v[0], whole + v[1]
        if group is not None:
            split = split.clone()
            dist.all_reduce(split, group=group)
        return torch.sqrt(split + whole)

    def _model_state(self, state: Dict[str, Any], fn: Callable,
                     shape_of: Callable[[int], tuple]) -> Dict[str, Any]:
        opt = dict(state["optimizer"])
        out = {}
        for idx, st in opt["state"].items():
            i = self._order[int(idx)]
            d = self.model_dims[i]
            out[idx] = {
                k: (fn(v, d) if d is not None and isinstance(v, torch.Tensor)
                    and v.dim() > 0 and tuple(v.shape) == shape_of(i) else v)
                for k, v in st.items()}
        opt["state"] = out
        acc = state.get("acc")
        if acc is not None:
            acc = [a if d is None else fn(a, d)
                   for a, d in zip(acc, self.model_dims)]
        return dict(state, optimizer=opt, acc=acc)

    def _full_shape(self, i: int) -> tuple:
        shape = list(self.leaves[i].shape)
        if self.model_dims[i] is not None:
            shape[self.model_dims[i]] *= self.mesh.size("model")
        return tuple(shape)

    def gathered_state_dict(self) -> Dict[str, Any]:
        """The whole state: the fsdp slices gathered (stage 3's gather),
        then the model slices (collective over both groups)."""
        state = super().gathered_state_dict()
        m, group = self.mesh.size("model"), self.mesh.group("model")
        return self._model_state(
            state, lambda v, d: gather_full(v, d, m, group),
            lambda i: tuple(self.leaves[i].shape))

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Load a whole (single-device format) state: this rank keeps its
        model slices, then its fsdp slices."""
        mesh = self.mesh

        def cut(v: torch.Tensor, d: int) -> torch.Tensor:
            spec = [None] * v.dim()
            spec[d] = "model"
            return shard_of(v, tuple(spec), mesh.coords, mesh.shape).clone()

        super().load_state_dict(self._model_state(state, cut,
                                                  self._full_shape))

    def piece_spec(self, i: int, shape: Sequence[int]) -> tuple:
        spec = list(super().piece_spec(i, shape))
        d = self.model_dims[i]
        if d is not None and tuple(shape) in (tuple(self.leaves[i].shape),
                                              tuple(self.shards[i].shape)):
            spec[d] = "model"
        return tuple(spec)


class GSPMDStrategy(RayGPUStrategy):
    """Args (beyond :class:`Strategy`'s):

    mesh_shape: dict axis-name -> size over {"data", "fsdp", "model",
        "seq", "ep", "pp"}. Sizes must multiply to ``num_workers``.
        Missing axes get size 1; if *no* axis is given, everything lands
        on "data" (pure data parallelism). "seq", "ep" and "pp" larger
        than 1 raise (ROADMAP queue 1 item 13).
    logical_axis_rules: override for ``parallel.logical.DEFAULT_RULES``.
    sequence_parallel: ring attention over "seq" (item 13: raises once
        the JAX package's validation passes).
    """

    strategy_name = "gspmd_ray"
    # The state gathers are collectives over the model and fsdp groups.
    gather_is_collective = True

    def __init__(
        self,
        *args: Any,
        mesh_shape: Optional[Dict[str, int]] = None,
        logical_axis_rules: Optional[Sequence[Tuple[str, Optional[str]]]] = None,
        sequence_parallel: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(*args, **kwargs)
        shape = dict(mesh_shape or {})
        for ax in shape:
            if ax not in AXES:
                raise ValueError(f"unknown mesh axis {ax!r}; valid: {AXES}")
        total = 1
        for ax in AXES:
            total *= shape.get(ax, 1)
        if mesh_shape and total != self.num_workers:
            raise ValueError(
                f"mesh_shape {shape} covers {total} devices but "
                f"num_workers={self.num_workers}"
            )
        if not mesh_shape:
            shape = {"data": self.num_workers}
        if sequence_parallel and shape.get("seq", 1) < 2:
            raise ValueError(
                "sequence_parallel=True needs mesh_shape['seq'] >= 2"
            )
        if sequence_parallel and shape.get("pp", 1) > 1:
            raise ValueError(
                "sequence_parallel cannot be combined with pipeline "
                "parallelism (ring attention inside the pp shard_map)"
            )
        for ax in ("seq", "ep", "pp"):
            if shape.get(ax, 1) > 1:
                raise not_ported(
                    f"GSPMDStrategy over a {ax!r} axis larger than 1 "
                    "(sequence, expert and pipeline parallelism)", "13")
        if sequence_parallel:
            raise not_ported("sequence_parallel (ring attention)", "13")
        self.mesh_shape = shape
        self.logical_axis_rules = logical_axis_rules
        self.sequence_parallel = sequence_parallel
        self._param_specs: Any = None

    # -- mesh -----------------------------------------------------------
    @property
    def mesh(self) -> Any:
        """This rank's six-axis mesh (``parallel/mesh.py``), built on
        first use: a collective, which every rank reaches in
        :meth:`setup_worker`."""
        if self._mesh is None:
            self._mesh = build_mesh(self.mesh_shape)
        return self._mesh

    def setup_worker(self, dist_env: Any) -> None:
        """Join the world, build the mesh's groups, and run one all-reduce
        on each (an NCCL group must have run one before a CUDA graph can
        capture its collectives)."""
        import torch.distributed as dist

        super().setup_worker(dist_env)
        mesh = self.mesh
        for name in ("model", "fsdp", "data", "dp"):
            group = mesh.group(name)
            if group is not None:
                dist.all_reduce(torch.ones(1, device=self.device), group=group)

    def ckpt_layout(self) -> Tuple[Dict[str, int], Dict[str, int]]:
        mesh = self.mesh
        return dict(mesh.shape), dict(mesh.coords)

    # -- module hook ----------------------------------------------------
    def bind_module(self, module: Any) -> None:
        super().bind_module(module)
        if hasattr(module, "bind_mesh"):
            module.bind_mesh(self.mesh, None)

    # -- shardings ------------------------------------------------------
    def param_sharding(self, params: Any) -> Any:
        """The tree of per-leaf specs: the module's logical axes through
        the rules, or, for a module without ``param_logical_axes``,
        FSDP-by-largest-axis over ``"fsdp"`` (the ZeRO rule), replicated
        when the fsdp axis is trivial."""
        module = self._module
        shape = self.mesh_shape
        if module is not None and hasattr(module, "param_logical_axes"):
            specs = tree_logical_specs(params, module.param_logical_axes(),
                                       shape, rules=self.logical_axis_rules)
        else:
            n = shape.get("fsdp", 1)

            def rule(x: Any) -> tuple:
                spec = [None] * len(np.shape(x))
                d = shard_dim_for(tuple(np.shape(x)), n) if n > 1 else None
                if d is not None:
                    spec[d] = "fsdp"
                return tuple(spec)

            specs = tree_map(rule, params)
        # A rule may map a parameter axis onto "data": the optimizer then
        # splits that leaf over the data group as over fsdp (zero_split).
        # seq, ep and pp are 1 here (the constructor raises), so no rule
        # resolves to them.
        return specs

    def opt_sharding(self, opt_state: Dict[str, Any], params: Any) -> Any:
        """The spec of each tensor of a whole optimizer state (torch's
        ``state_dict`` form): a moment takes its parameter's spec, matched
        by the parameter's index, not by shape (same-shape leaves such as
        ``wi`` and ``wo2`` at d_ff == d_model keep their own layouts);
        counts and other scalars replicate."""
        specs = _spec_leaves(self.param_sharding(params))
        shapes = [tuple(np.shape(x)) for x in tree_leaves(params)]
        out = {}
        for idx, st in opt_state["state"].items():
            i = int(idx)
            out[idx] = {k: (specs[i] if tuple(np.shape(v)) == shapes[i]
                            and np.ndim(v) > 0 else (None,) * np.ndim(v))
                        for k, v in st.items()}
        return out

    # -- state movement -------------------------------------------------
    def place_params(self, params: Any) -> Any:
        """This rank's slices of the whole tree, over ``"model"`` (the
        optimizer keeps the fsdp slices): rank 0's values, broadcast, so
        every rank starts from one tree."""
        import torch.distributed as dist

        self._param_specs = self.param_sharding(params)
        full = tree_map(lambda x: torch.as_tensor(x).detach().to(
            self.device, copy=True), params)
        if self.grouped and self.dist_env.world_size > 1:
            for leaf in tree_leaves(full):
                dist.broadcast(leaf, src=0)
        mesh = self.mesh
        specs = iter(_spec_leaves(self._param_specs))

        def local(x: torch.Tensor) -> torch.Tensor:
            spec = tuple(ax if ax == "model" else None for ax in next(specs))
            if all(ax is None for ax in spec):
                return x.requires_grad_(True)
            return shard_of(x, spec, mesh.coords, mesh.shape).clone() \
                .requires_grad_(True)

        return tree_map(local, full)

    def make_optimizer(self, factory, leaves, lr_schedule, clip, accumulate):
        if self._param_specs is None:
            raise RuntimeError("GSPMDStrategy builds its optimizer after "
                               "place_params")
        return MeshTrainOptimizer(
            factory, leaves, lr_schedule, clip, accumulate,
            specs=_spec_leaves(self._param_specs), mesh=self.mesh)

    def gather_state(self, tree: Any) -> Any:
        """The whole tree as a detached CPU copy: the parameter tree's
        model slices all-gathered over the model group (a collective;
        the fsdp slices are whole inside ``full_params()``), any other
        tree (the optimizer's gathered state) copied."""
        specs = self._param_specs
        mesh = self._mesh
        if specs is None or mesh is None or not _same_structure(tree, specs):
            return to_host(tree)
        it = iter(_spec_leaves(specs))

        def whole(x: torch.Tensor) -> torch.Tensor:
            d = split_dim(next(it), "model")
            return gather_full(x.detach(), d, mesh.size("model"),
                               mesh.group("model")).cpu().clone()

        return tree_map(whole, tree)

    # -- collectives ----------------------------------------------------
    def _dp(self) -> Tuple[Any, int]:
        """The data-parallel group and extent (None at extent 1)."""
        mesh = self.mesh
        return mesh.group("dp"), mesh.dp_size

    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the data-parallel group only (one coalesced all-
        reduce per dtype, then a divide), never over ``"model"``: model
        ranks hold different slices, and the replicated leaves' gradients
        are already equal there (``copy_to_model``'s backward)."""
        if not self.grouped:
            return grads
        group, n = self._dp()
        if group is None:
            return grads
        import torch.distributed as dist

        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, g in enumerate(grads):
            by_dtype.setdefault(g.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            dist.all_reduce(flat, group=group)
            flat.div_(float(n))
            for i, piece in zip(idx, flat.split([grads[i].numel()
                                                 for i in idx])):
                out[i] = piece.view_as(grads[i])
        return out  # type: ignore[return-value]

    def reduce_logs(self, logs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The logs averaged over the data-parallel group (model ranks
        already agree)."""
        if not self.grouped or not logs:
            return logs
        group, n = self._dp()
        if group is None:
            return logs
        import torch.distributed as dist

        vals = torch.stack([torch.as_tensor(v).float().reshape(())
                            for v in logs.values()])
        dist.all_reduce(vals, group=group)
        vals.div_(float(n))
        return dict(zip(logs.keys(), vals.unbind(0)))

    def reduce_eval(self, sums: Dict[str, torch.Tensor],
                    count: float) -> Tuple[Dict[str, torch.Tensor], float]:
        """Eval's sums and count over the data-parallel group: model ranks
        evaluated the same rows."""
        if not self.grouped:
            return sums, count
        group, _ = self._dp()
        if group is None:
            return sums, count
        import torch.distributed as dist

        vals = torch.stack(
            [torch.tensor(float(count), device=self.device)]
            + [v.float().reshape(()).to(self.device) for v in sums.values()])
        dist.all_reduce(vals, group=group)
        return dict(zip(sums.keys(), vals[1:].unbind(0))), float(vals[0])

    def gather_predictions(self, out: Any, mask: np.ndarray) -> Tuple[Any, np.ndarray]:
        """The global batch's predictions: one model rank per data-
        parallel shard, in shard order (the others hold duplicates)."""
        if not self.grouped or self.dist_env.world_size == 1:
            return out, mask
        import torch.distributed as dist

        mesh = self.mesh
        parts: List[Any] = [None] * self.dist_env.world_size
        dist.all_gather_object(parts, (mesh.replica_head, mesh.dp_rank,
                                       to_host(out), np.asarray(mask)))
        heads = sorted((p for p in parts if p[0]), key=lambda p: p[1])

        def merge(trees: list) -> Any:
            head = trees[0]
            if isinstance(head, dict):
                return {k: merge([t[k] for t in trees]) for k in head}
            if isinstance(head, (list, tuple)):
                return type(head)(merge([t[i] for t in trees])
                                  for i in range(len(head)))
            return torch.cat(trees, 0)

        return (merge([p[2] for p in heads]),
                np.concatenate([p[3] for p in heads]))

    def prediction_owner(self) -> Tuple[Optional[int], int]:
        if not self.grouped:
            return 0, 1
        mesh = self.mesh
        return (mesh.dp_rank if mesh.replica_head else None), mesh.dp_size

    # -- dp sizing ------------------------------------------------------
    def sampler_kwargs(self) -> Dict[str, int]:
        """Dataset sharding follows the data-parallel extent (JAX
        ``gspmd.py:189-213``): ranks that share a data-parallel shard load
        the same rows. One process per card, so the JAX package's hosts
        are the ranks here, and the rank order puts the data-parallel
        axes first. ``batch_multiplier`` stays 1."""
        env = self.dist_env
        if env is None:
            return {"num_replicas": 1, "rank": 0}
        layout = Mesh(self.mesh_shape, env.host_rank, {}, None)
        return {"num_replicas": layout.dp_size, "rank": layout.dp_rank}
