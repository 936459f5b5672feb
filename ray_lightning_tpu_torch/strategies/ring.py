"""Ring strategy: an explicit per-rank collective schedule, the Horovod
flavour (the port of ``ray_lightning_tpu/strategies/ring.py``).

The reference's ``HorovodRayStrategy`` (``ray_horovod.py:32-183``) wraps
the optimizer in Horovod's ring all-reduce. The JAX package builds its
step with ``shard_map``: each device runs a per-rank program and the
gradients are averaged by an explicit ``lax.pmean`` (``ring.py:56``), the
logs too (``:61-63``), and eval's sums by explicit ``psum``s
(``:80-140``). Here the same schedule in ``torch.distributed``: one
all-reduce per gradient leaf, one per log and one per eval key, each a SUM
then a divide, where :class:`~ray_lightning_tpu_torch.strategies.ddp.
RayGPUStrategy` coalesces them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ray_lightning_tpu_torch.strategies.ddp import RayGPUStrategy


class RingGPUStrategy(RayGPUStrategy):
    strategy_name = "horovod_ray"

    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """One all-reduce per gradient leaf, then a divide (the
        ``hvd.DistributedOptimizer`` analog)."""
        if not self.grouped:
            return grads
        import torch.distributed as dist

        world = float(self.dist_env.world_size)
        for g in grads:
            dist.all_reduce(g)
            g.div_(world)
        return grads

    def reduce_logs(self, logs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One all-reduce per log, then a divide (the JAX ``pmean`` of the
        logs)."""
        if not self.grouped:
            return logs
        import torch.distributed as dist

        world = float(self.dist_env.world_size)
        out = {}
        for name, v in logs.items():
            t = torch.as_tensor(v).float().reshape(()).clone()
            dist.all_reduce(t)
            out[name] = t.div_(world)
        return out

    def reduce_eval(self, sums: Dict[str, torch.Tensor],
                    count: float) -> Tuple[Dict[str, torch.Tensor], float]:
        """One all-reduce for the count and one per key (the JAX
        ``psum``s)."""
        if not self.grouped:
            return sums, count
        import torch.distributed as dist

        c = torch.tensor(float(count), device=self.device)
        dist.all_reduce(c)
        out = {}
        for k, v in sums.items():
            t = v.float().reshape(()).to(self.device).clone()
            dist.all_reduce(t)
            out[k] = t
        return out, float(c)


class HorovodRayStrategy(RingGPUStrategy):
    """The ring strategy under the reference's name; :class:`Strategy`'s
    ctor carries its surface (``num_workers``/``num_cpus_per_worker``/
    ``use_gpu``, ``ray_horovod.py:73-91``), ``use_gpu`` True by default."""
