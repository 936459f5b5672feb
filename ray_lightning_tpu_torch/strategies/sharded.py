"""``RayShardedStrategy``: ZeRO-style sharded data parallelism (the port
of ``ray_lightning_tpu/strategies/sharded.py``).

The reference inherits its sharding from FairScale
(``ray_ddp_sharded.py:11-13``); the JAX package annotates the optimizer
state (ZeRO-1) and the parameters too (ZeRO-3) with shardings that split
each leaf's largest divisible axis, and XLA emits the gathers. Here each
rank keeps its slice of every shardable leaf (the rule of
:func:`~ray_lightning_tpu_torch.parallel.zero.shard_dim_for`) and the
collectives are explicit:

- stages 1 and 2: the gradients are all-reduced (one coalesced
  all-reduce, as data parallelism does), each rank updates only its slice
  of each shardable leaf, with optimizer state for that slice alone, and
  an all-gather writes the full leaves in place. Stage 2 keeps the state
  of stage 1, as in the JAX package (its gradient sharding is a
  reduce-scatter fusion inside XLA).
- stage 3: the parameters at rest are the rank's slices alone: the full
  leaves keep their shapes but no storage, in the step too. The step
  gathers layer by layer, as XLA does inside the JAX package's layer
  scan (:class:`~ray_lightning_tpu_torch.parallel.zero.LayerGather`):
  row ``li`` of each stacked block leaf is all-gathered and cast to the
  compute dtype just before block ``li`` runs, the other leaves where
  they are read; saved-tensor hooks drop each gathered row from what the
  backward keeps and gather it again when the backward reaches its layer
  (under ``remat`` the gather sits inside the recomputed block). Each
  layer's gradient is reduced into this rank's slice as the backward
  leaves the layer (a reduce-scatter on NCCL; gloo, which has none, an
  all-reduce and the slice). So at most two layers' gathered rows and no
  gradient of the whole tree are ever alive, and the step is one CUDA
  graph on a whole-card NCCL rank, the gathers inside it. Outside the
  step, whatever reads the parameters (evaluation, checkpoints, the state
  shipped to the driver, a callback inside ``trainer.full_params()``)
  holds them whole for that long (:meth:`ShardedTrainOptimizer.full_params`);
  after a fit they stay whole.

Clipping and the logged norm use the norm of the rank's slices of the
reduced gradients, summed over the group (at every stage, so the stages
compute one number).

Ranks that share a card join over gloo, which has no all-gather of CUDA
tensors: the gathers there go through pinned host memory
(``parallel/mesh.py:all_gather``).

A checkpoint holds full parameters and full optimizer state, gathered
(:meth:`ShardedTrainOptimizer.gathered_state_dict`), so it has the data-
parallel checkpoint's format and resumes at another world size.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import torch

from ray_lightning_tpu_torch.parallel.zero import (
    GatherStats,
    LayerGather,
    Split,
    shard_dim_for,
)
from ray_lightning_tpu_torch.strategies.ddp import RayGPUStrategy
from ray_lightning_tpu_torch.trainer.optim import TrainOptimizer


class ShardedTrainOptimizer(TrainOptimizer):
    """:class:`TrainOptimizer` whose module optimizer steps the rank's
    slices: the factory gets the slice of each shardable leaf (a tensor of
    its own) and the whole of each replicated one, so per-leaf choices
    (groups, decay masks) are kept. Accumulation and clipping keep the
    single-device semantics: stages 1-2 take the full, already all-reduced
    gradients; stage 3 (:attr:`layered`) gets the reduced slices from the
    step's :class:`LayerGather` and accumulates slices.

    Each shardable leaf is split along its :func:`shard_dim_for` dim over
    ``group``'s ``world`` ranks (the world by default), or as ``splits``
    says (one :class:`Split` or None per leaf); ``reduce_group`` and
    ``reduce_size`` are the data-parallel group the gradients are
    averaged over (``group``'s, by default)."""

    def __init__(
        self,
        factory: Callable[[List[torch.Tensor]], torch.optim.Optimizer],
        leaves: List[torch.Tensor],
        lr_schedule: Optional[Callable[[int], float]] = None,
        clip: Optional[float] = None,
        accumulate: int = 1,
        *,
        stage: int,
        rank: int,
        world: int,
        group: Any = None,
        splits: Optional[Sequence[Optional[Split]]] = None,
        reduce_group: Any = None,
        reduce_size: Optional[int] = None,
    ) -> None:
        self.stage = int(stage)
        self.world = int(world)
        #: The group the slices are gathered over (the world by default).
        self.group = group
        if splits is None:
            splits = [None if d is None else
                      Split((d,), (self.world,), (int(rank),), group)
                      for d in (shard_dim_for(tuple(p.shape), self.world)
                                for p in leaves)]
        self.splits: List[Optional[Split]] = list(splits)
        self.reduce_group = group if reduce_group is None else reduce_group
        self.reduce_size = int(self.world if reduce_size is None
                               else reduce_size)
        #: Stage 3's step gathers layer by layer (:class:`LayerGather`).
        self.layered = self.stage >= 3
        self.gather_stats = GatherStats()
        self._index = {id(p): i for i, p in enumerate(leaves)}
        with torch.no_grad():
            self.shards = [
                p if sp is None else sp.shard(p.detach()).clone()
                for p, sp in zip(leaves, self.splits)
            ]
        super().__init__(factory, leaves, lr_schedule, clip=clip,
                         accumulate=accumulate, stepped=self.shards)
        #: The bytes of each full leaf's storage, allocated again to gather.
        self._nbytes = [p.untyped_storage().nbytes() for p in leaves]
        if self.stage >= 3:
            for p, sp, n in zip(leaves, self.splits, self._nbytes):
                if sp is not None and (not p.is_contiguous()
                                       or p.storage_offset() != 0
                                       or n != p.numel() * p.element_size()):
                    raise ValueError(
                        "ZeRO-3 frees each sharded leaf's storage at rest, "
                        "so each must own the whole of it: a leaf of shape "
                        f"{tuple(p.shape)} is a view")
            self.release_params()

    def index_of(self, t: torch.Tensor) -> int:
        """The position of leaf ``t`` in :attr:`leaves`."""
        return self._index[id(t)]

    def layer_gather(self, cdt: Optional[torch.dtype]) -> Optional[LayerGather]:
        """One micro-batch's per-layer gathers (stage 3), else None."""
        return LayerGather(self, cdt) if self.layered else None

    def _acc_like(self) -> List[torch.Tensor]:
        return self.shards if self.layered else self.leaves

    def _gather(self) -> None:
        """Every rank's slices into the full leaves, in place."""
        for p, s, sp in zip(self.leaves, self.shards, self.splits):
            if sp is not None:
                sp.gather_into(p.data, s)

    def _slice(self, g: torch.Tensor, sp: Optional[Split]) -> torch.Tensor:
        """This rank's slice of gradient ``g`` (already one under
        stage 3)."""
        if sp is None or self.layered:
            return g
        return sp.shard(g).contiguous()

    def _step(self, grads: List[torch.Tensor]) -> None:
        for s, g, sp in zip(self.shards, grads, self.splits):
            s.grad = self._slice(g, sp)
        self.opt.step()
        for s in self.shards:
            s.grad = None
        if self.stage < 3:
            self._gather()

    def norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The 2-norm of the whole reduced gradient, from this rank's
        slices: their squares summed over the group, plus those of the
        replicated leaves once (at world 1, :func:`global_norm`'s sum)."""
        import torch.distributed as dist

        split: Any = 0
        whole: Any = 0
        for g, sp in zip(grads, self.splits):
            sq = (self._slice(g, sp).float() ** 2).sum()
            if sp is None:
                whole = whole + sq
            else:
                split = split + sq
        if isinstance(split, torch.Tensor):
            split = split.clone()
            if self.world > 1:
                dist.all_reduce(split, group=self.group)
        return torch.sqrt(split + whole)

    def _whole(self) -> bool:
        return all(sp is None or p.untyped_storage().nbytes()
                   for p, sp in zip(self.leaves, self.splits))

    def gather_params(self) -> None:
        if self.stage < 3:
            return  # the update gathers
        for p, sp, n in zip(self.leaves, self.splits, self._nbytes):
            if sp is not None and not p.untyped_storage().nbytes():
                p.untyped_storage().resize_(n)
        self._gather()

    def release_params(self, in_use: Sequence[torch.Tensor] = ()) -> None:
        if self.stage < 3:
            return
        used = {t.untyped_storage().data_ptr() for t in in_use
                if isinstance(t, torch.Tensor)}
        for p, sp in zip(self.leaves, self.splits):
            storage = p.untyped_storage()
            if (sp is not None and storage.nbytes()
                    and storage.data_ptr() not in used):
                storage.resize_(0)

    @contextlib.contextmanager
    def full_params(self) -> Iterator[None]:
        if self._whole():
            yield
            return
        self.gather_params()
        try:
            yield
        finally:
            self.release_params()

    def _state_slices(self, state: Dict[int, Any], fn: Callable,
                      shape_of: Callable[[int], tuple]) -> Dict[int, Any]:
        out = {}
        for idx, st in state.items():
            i = self._order[int(idx)]
            sp = self.splits[i]
            out[idx] = {
                k: (fn(v, sp) if sp is not None and isinstance(v, torch.Tensor)
                    and v.dim() > 0 and tuple(v.shape) == shape_of(i) else v)
                for k, v in st.items()
            }
        return out

    def _acc_state(self, acc: Optional[List[torch.Tensor]],
                   fn: Callable, shape_of: Callable[[int], tuple]) -> Any:
        if acc is None or not self.layered:
            return acc
        return [a if sp is None or tuple(a.shape) != shape_of(i)
                else fn(a, sp)
                for i, (a, sp) in enumerate(zip(acc, self.splits))]

    def gathered_state_dict(self) -> Dict[str, Any]:
        """The state with each slice's optimizer state (and, at stage 3,
        accumulation window) all-gathered to the full leaf's shape: the
        single-device format (collective)."""
        state = self.state_dict()
        opt = dict(state["optimizer"])
        gather = lambda v, sp: sp.gather(v)  # noqa: E731
        shard_shape = lambda i: tuple(self.shards[i].shape)  # noqa: E731
        opt["state"] = self._state_slices(opt["state"], gather, shard_shape)
        return dict(state, optimizer=opt,
                    acc=self._acc_state(state.get("acc"), gather,
                                        shard_shape))

    def piece_spec(self, i: int, shape: Sequence[int]) -> tuple:
        spec = [None] * len(shape)
        sp = self.splits[i]
        if sp is not None and tuple(shape) == tuple(self.shards[i].shape):
            for d, ax in zip(sp.dims, sp.axes):
                spec[d] = ax
        return tuple(spec)

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Load a full (single-device format) state: each rank keeps its
        slices."""
        opt = dict(state["optimizer"])
        cut = lambda v, sp: sp.shard(v).clone()  # noqa: E731
        full_shape = lambda i: tuple(self.leaves[i].shape)  # noqa: E731
        opt["state"] = self._state_slices(opt["state"], cut, full_shape)
        super().load_state_dict(dict(
            state, optimizer=opt,
            acc=self._acc_state(state.get("acc"), cut, full_shape)))


class RayShardedStrategy(RayGPUStrategy):
    """Sharded data parallelism (ZeRO).

    Args (beyond :class:`Strategy`'s):
      zero_stage: 1 and 2 shard the optimizer state; 3 also keeps only
        the rank's slices of the parameters, gathered layer by layer in
        the step, and reduces each layer's gradient into the slices.
    """

    strategy_name = "ddp_sharded_ray"
    gather_is_collective = True

    def __init__(self, *args: Any, zero_stage: int = 1, **kwargs: Any) -> None:
        if zero_stage not in (1, 2, 3):
            raise ValueError(f"zero_stage must be 1, 2 or 3, got {zero_stage}")
        self.zero_stage = int(zero_stage)
        super().__init__(*args, **kwargs)

    def make_optimizer(self, factory, leaves, lr_schedule, clip, accumulate):
        if not self.grouped:
            raise RuntimeError(
                "RayShardedStrategy builds its optimizer inside a launched "
                "worker (after setup_worker)")
        return ShardedTrainOptimizer(
            factory, leaves, lr_schedule, clip=clip, accumulate=accumulate,
            stage=self.zero_stage, rank=self.dist_env.host_rank,
            world=self.dist_env.world_size,
        )
