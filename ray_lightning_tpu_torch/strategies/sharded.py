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
  all-reduce, as data parallelism does; gloo has no ``reduce_scatter``, so
  both backends slice after the all-reduce), clipped on the full
  gradients, then each rank updates only its slice of each shardable leaf,
  with optimizer state for that slice alone, and an all-gather writes the
  full leaves in place. Stage 2 keeps the state of stage 1, as in the JAX
  package (its gradient sharding is a reduce-scatter fusion inside XLA).
- stage 3: the parameters at rest are the rank's slices alone: the full
  leaves keep their shapes but no storage. A step allocates them and
  all-gathers the slices into them before its forward, and frees each
  one as soon as the forward no longer reads it: after the mixed-
  precision cast where the forward reads a cast copy, else after the
  backward. Inside a CUDA graph the allocations come from the graph's
  pool: a leaf freed before the forward leaves its memory to the step's
  activations, but one freed after the backward was live at the step's
  peak, so there the peak is stage 1's (gathering layer by layer is
  ROADMAP item 11b). Outside the step, whatever reads the parameters
  (evaluation, checkpoints, the state shipped to the driver, a callback
  inside ``trainer.full_params()``) holds them whole for that long
  (:meth:`ShardedTrainOptimizer.full_params`); after a fit they stay
  whole.

A checkpoint holds full parameters and full optimizer state, gathered
(:meth:`ShardedTrainOptimizer.gathered_state_dict`), so it has the data-
parallel checkpoint's format and resumes at another world size.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import torch

from ray_lightning_tpu_torch.parallel.zero import (
    all_gather_into,
    gather_full,
    shard_dim_for,
    shard_slice,
)
from ray_lightning_tpu_torch.strategies.base import not_ported
from ray_lightning_tpu_torch.strategies.ddp import RayGPUStrategy
from ray_lightning_tpu_torch.trainer.optim import TrainOptimizer


class ShardedTrainOptimizer(TrainOptimizer):
    """:class:`TrainOptimizer` whose module optimizer steps the rank's
    slices: the factory gets the slice of each shardable leaf (a tensor of
    its own) and the whole of each replicated one, so per-leaf choices
    (groups, decay masks) are kept. Accumulation and clipping act on the
    full, already all-reduced gradients, as on one device."""

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
    ) -> None:
        self.stage = int(stage)
        self.rank = int(rank)
        self.world = int(world)
        self.dims = [shard_dim_for(tuple(p.shape), self.world) for p in leaves]
        with torch.no_grad():
            self.shards = [
                p if d is None
                else shard_slice(p.detach(), d, self.rank, self.world).clone()
                for p, d in zip(leaves, self.dims)
            ]
        super().__init__(lambda _: factory(self.shards), leaves, lr_schedule,
                         clip=clip, accumulate=accumulate)
        # The optimizer's state index -> leaf position (torch numbers the
        # params in the order its groups list them).
        pos = {id(s): i for i, s in enumerate(self.shards)}
        self._order = [pos[id(p)] for g in self.opt.param_groups
                       for p in g["params"]]
        #: The bytes of each full leaf's storage, allocated again to gather.
        self._nbytes = [p.untyped_storage().nbytes() for p in leaves]
        if self.stage >= 3:
            for p, d, n in zip(leaves, self.dims, self._nbytes):
                if d is not None and (not p.is_contiguous()
                                      or p.storage_offset() != 0
                                      or n != p.numel() * p.element_size()):
                    raise ValueError(
                        "ZeRO-3 frees each sharded leaf's storage at rest, "
                        "so each must own the whole of it: a leaf of shape "
                        f"{tuple(p.shape)} is a view")
            self.release_params()

    def _gather(self) -> None:
        """Every rank's slices into the full leaves, in place."""
        for p, s, d in zip(self.leaves, self.shards, self.dims):
            if d is not None:
                all_gather_into(p.data, s, d, self.world)

    def _step(self, grads: List[torch.Tensor]) -> None:
        for s, g, d in zip(self.shards, grads, self.dims):
            s.grad = (g if d is None
                      else shard_slice(g, d, self.rank, self.world).contiguous())
        self.opt.step()
        for s in self.shards:
            s.grad = None
        if self.stage < 3:
            self._gather()

    def _whole(self) -> bool:
        return all(d is None or p.untyped_storage().nbytes()
                   for p, d in zip(self.leaves, self.dims))

    def gather_params(self) -> None:
        if self.stage < 3:
            return  # the update gathers
        for p, d, n in zip(self.leaves, self.dims, self._nbytes):
            if d is not None and not p.untyped_storage().nbytes():
                p.untyped_storage().resize_(n)
        self._gather()

    def release_params(self, in_use: Sequence[torch.Tensor] = ()) -> None:
        if self.stage < 3:
            return
        used = {t.untyped_storage().data_ptr() for t in in_use
                if isinstance(t, torch.Tensor)}
        for p, d in zip(self.leaves, self.dims):
            storage = p.untyped_storage()
            if (d is not None and storage.nbytes()
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
            d = self.dims[i]
            out[idx] = {
                k: (fn(v, d) if d is not None and isinstance(v, torch.Tensor)
                    and v.dim() > 0 and tuple(v.shape) == shape_of(i) else v)
                for k, v in st.items()
            }
        return out

    def gathered_state_dict(self) -> Dict[str, Any]:
        """The state with each slice's optimizer state all-gathered to the
        full leaf's shape: the single-device format (collective)."""
        state = self.state_dict()
        opt = dict(state["optimizer"])
        opt["state"] = self._state_slices(
            opt["state"], lambda v, d: gather_full(v, d, self.world),
            lambda i: tuple(self.shards[i].shape))
        return dict(state, optimizer=opt)

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Load a full (single-device format) state: each rank keeps its
        slices."""
        opt = dict(state["optimizer"])
        opt["state"] = self._state_slices(
            opt["state"],
            lambda v, d: shard_slice(v, d, self.rank, self.world).clone(),
            lambda i: tuple(self.leaves[i].shape))
        super().load_state_dict(dict(state, optimizer=opt))


class RayShardedStrategy(RayGPUStrategy):
    """Sharded data parallelism (ZeRO).

    Args (beyond :class:`Strategy`'s):
      zero_stage: 1 and 2 shard the optimizer state; 3 also keeps only
        the rank's slices of the parameters at rest (the fp32 master
        weights; the step's gradients stay whole, all-reduced).
    """

    strategy_name = "ddp_sharded_ray"
    gather_is_collective = True

    def __init__(self, *args: Any, zero_stage: int = 1, **kwargs: Any) -> None:
        if zero_stage not in (1, 2, 3):
            raise ValueError(f"zero_stage must be 1, 2 or 3, got {zero_stage}")
        self.zero_stage = int(zero_stage)
        super().__init__(*args, **kwargs)
        if self.use_gpu and self.gpu_share < 1.0:
            # gloo, the only group ranks sharing a card can form, has no
            # all-gather of CUDA tensors.
            raise not_ported("RayShardedStrategy on ranks that share a card",
                             "11b")

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
