"""Process-group bootstrap (the subset of ``ray_lightning_tpu/parallel/
mesh.py`` that data parallelism needs).

The JAX package rendezvous with ``jax.distributed.initialize`` and builds
a ``Mesh`` over every chip; the port does what the reference does
(``ray_ddp.py:192-196``): ``torch.distributed.init_process_group`` on a
TCP store at the coordinator, one rank per process. ``build_mesh`` gives
the group as a 1-D ``DeviceMesh`` named ``"data"``, for later slices to
extend; ``parse_mesh_spec`` and ``mesh_from_spec`` (serving meshes) are
ROADMAP queue 1 item 11b.
"""
from __future__ import annotations

import datetime
from typing import Any, Optional

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

    if dist.is_initialized():
        dist.destroy_process_group()


def build_mesh(device: torch.device) -> Any:
    """The group as a 1-D ``DeviceMesh`` named ``"data"``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device.type, (dist.get_world_size(),),
                            mesh_dim_names=("data",))
