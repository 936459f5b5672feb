"""Fake multi-node clusters for tests (PyTorch port of
``ray_lightning_tpu/fabric/cluster_utils.py``).

Equivalent of ``ray.cluster_utils.Cluster`` as used by the reference's test
suite to simulate two nodes in one process (test_ddp.py:54-61). Nodes are
logical: every actor still runs on this machine, but scheduling, node IPs, and
rank math behave as if the cluster had multiple hosts — which is exactly what
the launcher's global->(local, node) rank mapping needs for coverage.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from ray_lightning_tpu_torch.fabric import core


class Cluster:
    def __init__(
        self,
        initialize_head: bool = True,
        head_node_args: Optional[Dict[str, Any]] = None,
    ) -> None:
        self._nodes: List[core.Node] = []
        if initialize_head:
            args = dict(head_node_args or {})
            if core.is_initialized() and args:
                raise core.FabricError(
                    "fabric is already initialized; head_node_args would be "
                    "ignored — call fabric.shutdown() first"
                )
            core.init(
                num_cpus=args.get("num_cpus"),
                num_gpus=args.get("num_gpus"),
                resources=args.get("resources"),
            )
            sess = core._require_session()
            self._nodes.append(sess.nodes[0])

    def add_node(
        self,
        num_cpus: float = 1,
        num_gpus: float = 0,
        resources: Optional[Dict[str, float]] = None,
        node_ip: Optional[str] = None,
    ) -> core.Node:
        capacity: Dict[str, float] = {"CPU": float(num_cpus)}
        if num_gpus:
            capacity["GPU"] = float(num_gpus)
        for k, v in (resources or {}).items():
            capacity[k] = float(v)
        node = core._add_node(capacity, node_ip=node_ip)
        self._nodes.append(node)
        return node

    def shutdown(self) -> None:
        core.shutdown()
