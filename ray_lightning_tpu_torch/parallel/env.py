"""Distributed environment descriptor shared by the launcher and workers
(the port of ``ray_lightning_tpu/parallel/env.py``).

Who this process is (``host_rank``, ``node_rank``), how many of us there
are, and where the rendezvous lives. The port runs one process per card,
as the reference does (``ray_ddp.py``): ``num_hosts == world_size`` and
``local_chips == 1`` for every launched worker, where the JAX package's
process drives several chips. ``backend`` is the ``torch.distributed``
backend the group uses: ``"nccl"`` when each rank owns a whole card,
``"gloo"`` on the CPU or when ranks share a card.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class DistEnv:
    world_size: int = 1  # data-parallel ranks ("num_workers")
    num_hosts: int = 1  # worker processes (one per card)
    host_rank: int = 0  # this process's rank in the group
    node_rank: int = 0  # logical node index
    local_chips: int = 1  # cards this process drives
    coordinator_address: Optional[str] = None  # "ip:port" of the store
    first_chip_rank: int = 0
    # host_rank -> (local_rank, node_rank), computed by the launcher from
    # node IPs (the reference's get_local_ranks, ray_launcher.py:130-157)
    global_to_local: Dict[int, tuple] = field(default_factory=dict)
    backend: Optional[str] = None

    @property
    def is_distributed(self) -> bool:
        return self.num_hosts > 1

    @property
    def global_rank(self) -> int:
        return self.host_rank

    @property
    def local_rank(self) -> int:
        if self.global_to_local and self.host_rank in self.global_to_local:
            return self.global_to_local[self.host_rank][0]
        return 0
